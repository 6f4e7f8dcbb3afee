"""Walkthrough of every public endpoint (counterpart of
`scripts/example_api_local.py`, the reference's
scripts/example_webui_api_local.py). With checkpoints laid out by
`tools/convert_weights.py`, pass --checkpoint-dir; without, the models
run with seeded random weights (a flow demo only).

  python -m mvedit_tpu_torch.tools.example_api_local --tiny --device cpu
  python -m mvedit_tpu_torch.tools.example_api_local \\
      --checkpoint-dir checkpoints/
"""
import argparse
import os

import numpy as np

__all__ = ["main"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out-dir", default="outputs")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def demo_sphere(path):
    """A sphere of radius 0.55 from marching tets on the 16^3 grid,
    written as a GLB at `path`."""
    import torch
    from ..models.mesh import Mesh
    from ..models.mesh.dmtet import build_grid_tets, marching_tets
    grid = build_grid_tets(16, crop_sphere=False)
    sdf = 0.55 - np.linalg.norm(grid.verts, axis=-1)
    mt = marching_tets(grid, torch.from_numpy(sdf.astype(np.float32)))
    fm = mt["face_mask"].numpy()
    f = mt["faces"].numpy()[fm]
    v = mt["verts"].numpy()
    used = np.unique(f)
    remap = np.full(len(v), -1, np.int64)
    remap[used] = np.arange(len(used))
    mesh = Mesh(v=v[used].astype(np.float32), f=remap[f].astype(np.int32))
    mesh.auto_normal()
    mesh.write_glb(path)
    return path


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    from ..apis import Adapter3DRunner

    runner = Adapter3DRunner(checkpoint_dir=args.checkpoint_dir,
                             tiny_models=args.tiny, seed=42,
                             device=args.device)
    out = {}

    # --- a demo sphere mesh ------------------------------------------
    demo_mesh = demo_sphere(os.path.join(args.out_dir, "demo_sphere.glb"))
    print("demo mesh:", demo_mesh)

    # --- text-to-image -----------------------------------------------
    img = runner.run_text_to_img("a red sports car", steps=4)
    out["text_to_img"] = img.shape
    print("text_to_img:", img.shape)

    # --- segmentation --------------------------------------------------
    masks = runner.run_segmentation(img[None])
    out["segmentation"] = tuple(masks.shape)
    print("segmentation:", tuple(masks.shape))

    # --- mesh preproc --------------------------------------------------
    pre = runner.run_mesh_preproc(demo_mesh)
    print("preproc: center", pre["center"], "scale", pre["scale"])

    # --- 3D-to-3D (MVEdit) ---------------------------------------------
    res = runner.run_3d_to_3d(demo_mesh, "a colorful beach ball",
                              out_path=os.path.join(args.out_dir,
                                                    "edited.glb"))
    out["3d_to_3d"] = res["mesh"] is not None
    print("3d_to_3d:", res["mesh"] is not None)

    # --- re-texturing ----------------------------------------------------
    res = runner.run_retex(demo_mesh, "wooden texture",
                           out_path=os.path.join(args.out_dir, "retex.glb"))
    out["retex"] = res["mesh"].albedo.shape
    print("retex:", res["mesh"].albedo.shape)

    # --- texture superres ------------------------------------------------
    res = runner.run_texture_superres(
        os.path.join(args.out_dir, "retex.glb"), "sharp detailed wood",
        out_path=os.path.join(args.out_dir, "retex_sr.glb"))
    out["superres"] = res["mesh"].albedo.shape
    print("superres:", res["mesh"].albedo.shape)

    # --- image-to-3D ------------------------------------------------------
    res = runner.run_zero123plus_to_mesh(
        img, passes=1, out_path=os.path.join(args.out_dir, "img23d.glb"))
    out["zero123plus_to_mesh"] = res["mesh"] is not None
    print("zero123plus_to_mesh:", res["mesh"] is not None)

    # --- text-to-3D (StableSSDNeRF) ----------------------------------------
    res = runner.run_stablessdnerf("a car", steps=4)
    out["stablessdnerf"] = res["preview"].shape
    print("stablessdnerf preview:", res["preview"].shape)

    # --- orbit video --------------------------------------------------------
    path = runner.run_mesh_to_video(
        os.path.join(args.out_dir, "retex.glb"),
        out_path=os.path.join(args.out_dir, "orbit.mp4"), num_frames=12)
    out["video"] = path
    print("video:", path)
    return out


if __name__ == "__main__":
    main()
