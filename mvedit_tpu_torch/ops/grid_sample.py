"""Bilinear 2D grid sampling (counterpart of
`mvedit_tpu/ops/grid_sample.py::grid_sample_2d`).

The reference writes the op as gathers and lerps so that `jax.grad`
composes; its semantics are `torch.nn.functional.grid_sample`'s (bilinear,
padding "zeros" or "border", `align_corners`), so the port calls it. The
reference clamps the gathered indices where torch clamps the coordinate
for "border"; the two give the same values (past an edge both corners of
the lerp are the edge texel).

Forward only: `F.grid_sample`'s backward adds into the input's gradient
atomically on the card, so one seed would not give one result. A path
that needs the gradient goes through `ops/segment.py`; this function
raises when asked for one. The reference's `grid_sample_3d` waits for the
SSDNeRF slice, its only user.
"""
import torch
import torch.nn.functional as F

__all__ = ["grid_sample_2d"]


def grid_sample_2d(input, grid, padding_mode="zeros", align_corners=False):
    """input: (N, C, H, W); grid: (N, Hg, Wg, 2) in [-1, 1], x (along W)
    first -> (N, C, Hg, Wg)."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"padding_mode {padding_mode!r}: zeros or border")
    if torch.is_grad_enabled() and (input.requires_grad
                                    or grid.requires_grad):
        raise ValueError("grid_sample_2d is forward only: its backward adds "
                         "atomically on the card")
    return F.grid_sample(input, grid.to(input.dtype), mode="bilinear",
                         padding_mode=padding_mode,
                         align_corners=align_corners)
