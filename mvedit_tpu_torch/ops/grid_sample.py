"""Bilinear 2D and trilinear 3D grid sampling (counterpart of
`mvedit_tpu/ops/grid_sample.py`).

The semantics are `torch.nn.functional.grid_sample`'s (bilinear, padding
"zeros" or "border", `align_corners`), which the reference writes as
corner gathers and lerps: gathered indices are clamped into the input and,
for "zeros", corners outside it are multiplied by 0.

Where no gradient is asked for, `grid_sample_2d` calls `F.grid_sample`
(the inference paths' numbers). Where the input or the grid needs one, both
functions run the reference's gathers and lerps: the corners of every
sample are gathered in one `ops/segment.py::gather_rows` call, whose
backward, the input's gradient, is the fixed-order segment sum; the grid's
gradient comes from the gathered corner values, elementwise. Nothing calls
`F.grid_sample`'s backward, which adds atomically on the card (one seed
would not give one result).
"""
import torch
import torch.nn.functional as F

from .segment import gather_rows

__all__ = ["grid_sample_2d", "grid_sample_3d", "corner_rows"]


def _unnormalize(coord, size, align_corners):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _check(padding_mode):
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"padding_mode {padding_mode!r}: zeros or border")


def _wants_grad(*xs):
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def corner_rows(grid, sizes, padding_mode="zeros", align_corners=False,
                dtype=torch.float32):
    """The corners that sampling an input of spatial sizes `sizes` (slowest
    first) at `grid` (N, *G, k) gathers: (rows (N, P, 2^k) int32 into the
    input's (N * prod(sizes)) rows, weights (N, P, 2^k) in `dtype`, 0 for
    a "zeros" corner outside the input), P = prod(G). Corner c takes offset
    (c >> a) & 1 along axis a (fastest a = 0), the reference's order;
    indices are clamped into the input."""
    N, k = grid.shape[0], len(sizes)
    P = grid[..., 0].numel() // N
    fast = sizes[::-1]                                     # fastest first
    idx = torch.arange(N, dtype=torch.int32, device=grid.device)[:, None]
    idx = idx.expand(N, P)[..., None]
    weight = valid = None
    for a in range(k - 1, -1, -1):                         # slowest first
        g = _unnormalize(grid[..., a].reshape(N, P).to(dtype), fast[a],
                         align_corners)
        g0 = torch.floor(g)
        f = (g - g0)[..., None]
        bit = torch.tensor([(c >> a) & 1 for c in range(2 ** k)],
                           device=grid.device)
        i = g0.to(torch.int32)[..., None] + bit.to(torch.int32)
        wa = torch.where(bit.bool(), f, 1 - f)             # (N, P, 2^k)
        weight = wa if weight is None else weight * wa
        if padding_mode == "zeros":
            ok = (i >= 0) & (i < fast[a])
            valid = ok if valid is None else valid & ok
        idx = idx * fast[a] + i.clamp(0, fast[a] - 1)
    if valid is not None:
        weight = weight * valid.to(weight.dtype)
    return idx, weight


def _sample(input, grid, padding_mode, align_corners):
    """input (N, C, *S), grid (N, *G, k) -> (N, C, P): one gather of all
    2^k corners of all samples, then the corners' weighted sum."""
    N, C, *S = input.shape
    idx, weight = corner_rows(grid, S, padding_mode, align_corners,
                              input.dtype)
    rows = input.reshape(N, C, -1).transpose(1, 2).reshape(-1, C)
    v = gather_rows(rows, idx)                             # (N, P, 2^k, C)
    out = v[:, :, 0] * weight[:, :, 0, None]
    for c in range(1, weight.shape[-1]):
        out = out + v[:, :, c] * weight[:, :, c, None]
    return out.transpose(1, 2)                             # (N, C, P)


def grid_sample_2d(input, grid, padding_mode="zeros", align_corners=False):
    """input: (N, C, H, W); grid: (N, Hg, Wg, 2) in [-1, 1], x (along W)
    first -> (N, C, Hg, Wg). Differentiable in both (see the module doc)."""
    _check(padding_mode)
    if not _wants_grad(input, grid):
        return F.grid_sample(input, grid.to(input.dtype), mode="bilinear",
                             padding_mode=padding_mode,
                             align_corners=align_corners)
    N, C = input.shape[:2]
    return _sample(input, grid, padding_mode, align_corners).reshape(
        N, C, *grid.shape[1:3])


def grid_sample_3d(input, grid, padding_mode="zeros", align_corners=False):
    """input: (N, C, D, H, W); grid: (N, Dg, Hg, Wg, 3) in [-1, 1],
    grid[..., 0] along W, [..., 1] along H, [..., 2] along D -> (N, C, Dg,
    Hg, Wg). Always the reference's gathers and lerps."""
    _check(padding_mode)
    N, C = input.shape[:2]
    return _sample(input, grid, padding_mode, align_corners).reshape(
        N, C, *grid.shape[1:4])
