"""Per-step debug tiles (counterpart of `mvedit_tpu/utils/debug_viz.py`).

The reference's debugging affordance, `--debug {0,1,2}` per-step tile dumps
(`save_tiled_viz`, mvedit_3d_pipeline.py:392-408, mvedit_texture_pipeline
.py:86-91; enabled through adapter3d_mixin.py:319): each view gets one PNG
a step, targets on the top row [image | mask | target normal], renders on
the bottom [rgb | depth | rendered normal], written to
`<out_dir>/<step>_<view>.png`. Missing channels render black, as the
reference's `torch.zeros_like` fill. Host numpy; a channel whose size
differs is resized with `ops/image.py::resize_bilinear` (the antialiased
bilinear of `jax.image.resize`). Where the JAX package writes a black tile
on any error of that resize, the port lets the error raise.
"""
import os

import numpy as np
import torch

__all__ = ["save_tiled_viz"]


def _chw3(x, h, w):
    """Coerce to (h, w, 3) float [0, 1]; None -> black."""
    if x is None:
        return np.zeros((h, w, 3), np.float32)
    x = np.asarray(x, np.float32)
    if x.ndim == 2:
        x = x[..., None]
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    if x.shape[:2] != (h, w):
        if x.ndim != 3:
            raise ValueError(f"a tile's channel must be (H, W[, C]), got "
                             f"shape {x.shape}")
        from ..ops.image import resize_bilinear
        x = resize_bilinear(torch.from_numpy(np.ascontiguousarray(x)),
                            (h, w)).numpy()
    return np.clip(x, 0.0, 1.0)


def save_tiled_viz(out_dir, step, renders, targets, normals=None):
    """Write one tile PNG per view: 2x3 grid of
    [tgt image, tgt mask, tgt normal] / [render rgb, depth, normal].

    renders: dict with 'rgb' (N,h,w,3), 'depth' (N,h,w), optional 'alpha',
    optional 'normal'. targets: dict with 'images', 'masks', optional
    'normals'. Host arrays. Depths are normalized per view for display.
    """
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    rgb = np.asarray(renders["rgb"], np.float32)
    n_views, h, w = rgb.shape[:3]
    depth = np.asarray(renders.get("depth"), np.float32) \
        if renders.get("depth") is not None else None
    rnormal = renders.get("normal")
    t_img = np.asarray(targets["images"], np.float32)
    t_mask = targets.get("masks")
    t_norm = targets.get("normals")
    for v in range(n_views):
        d = None
        if depth is not None:
            dv = depth[v]
            lo, hi = float(dv.min()), float(dv.max())
            d = (dv - lo) / (hi - lo) if hi > lo else np.zeros_like(dv)
        top = np.concatenate([
            _chw3(t_img[v] if v < len(t_img) else None, h, w),
            _chw3(None if t_mask is None else np.asarray(t_mask)[v], h, w),
            _chw3(None if t_norm is None else np.asarray(t_norm)[v], h, w),
        ], axis=1)
        bot = np.concatenate([
            _chw3(rgb[v], h, w),
            _chw3(d, h, w),
            _chw3(None if rnormal is None else np.asarray(rnormal)[v],
                  h, w),
        ], axis=1)
        tile = np.concatenate([top, bot], axis=0)
        Image.fromarray((tile * 255).astype(np.uint8)).save(
            os.path.join(out_dir, f"{step:03d}_{v:03d}.png"))
