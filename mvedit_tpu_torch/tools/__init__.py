"""Command-line tools of the port: `python -m
mvedit_tpu_torch.tools.train_ssdnerf` and `... .test_ssdnerf`."""
