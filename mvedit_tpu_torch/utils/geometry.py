"""Depth utilities (counterpart of `mvedit_tpu/utils/geometry.py`; so far
`normalize_depth`, which the mesh re-render and `load_init_mesh` use)."""
import torch

__all__ = ["normalize_depth"]


def normalize_depth(depths, alphas, far_depth=0.25, alpha_clip=0.5, eps=1e-5):
    """(N, H, W) depths + (N, H, W, 1) alphas -> [0, 1] depth maps for the
    depth ControlNet (ref geometry_utils.py:151-168)."""
    a = alphas[..., 0]
    n = depths.shape[0]
    depths_max = depths.reshape(n, -1).amax(1)[:, None, None]
    depths_fg = depths / a.clamp(min=eps)
    masked = torch.where(a < alpha_clip, torch.full_like(depths_fg, 1.0 / eps),
                         depths_fg)
    fg_min = masked.reshape(n, -1).amin(1)[:, None, None]
    depths_fg = (depths_fg - fg_min) / (depths_max - fg_min).clamp(min=eps)
    depths_fg = depths_fg * (1 - far_depth) + far_depth
    return (depths_fg * a).clamp(0.0, 1.0)
