"""Command-line tools of the port, each `python -m mvedit_tpu_torch.tools.
<name>` with a `main(argv)`: `train_ssdnerf`, `test_ssdnerf`,
`inception_stat`, `generate_tets`, `glb_to_obj`, `kitti_preproc`,
`checkpoint_cleaner`, `convert_weights` and the endpoint walkthrough
`example_api_local`."""
