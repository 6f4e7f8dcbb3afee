"""Dense-grid encode: the hand-written Hopper kernel behind
`ops/dense_grid.py` on CUDA tensors.

`dense_grid(x, tables, resolutions, smooth, gather_dtype)` -> (N, L F)
float32: every level of every point (N, 3) in one launch of
`csrc/dense_grid.cu` (sm_90a), `LIBRARY` (built and bound by `library.py`
at first use). The clip, the cell, the smoothstep (or linear)
weights, the 8 corner rows per level (int32 ids), the rounding of the
rows to `gather_dtype` and the blend are the plain version's operations
in its order, so the output has its bits (`ops/dense_grid.py::
dense_grid_encode_reference`, the oracle of the card tests). No (N, 8)
index, no gathered (N, 8, F) tensor, no stack or cat in device memory. A
NaN coordinate takes the cell index 0, where the plain gather asserts on
its int64 index (-2^63 on the card): the point's features are NaN.

`dense_grid_backward(x, tables, ..., grad, table_grad, x_grad)` recomputes
the corners from x: with `table_grad`, the targets (L, N 8) int32 and the
contributions (L, N 8, F), the output gradient times each corner's weight
rounded to `gather_dtype`, in the plain gather's sample-major, corner-minor
order, for `ops.segment.segment_sum`; with `x_grad`, x's gradient (N, 3),
point by point (another order of the same sums than autograd's).

Supported: F = 8 (every configuration of the port), float32 or bf16
tables, `gather_dtype` bfloat16 (float32 tables rounded in registers) or
float32 (float32 tables), at most `MAX_LEVELS` levels of (R + 1)^3 < 2^31
rows. Anything else raises; nothing falls back.

`dense_grid.launches` counts forward launches, `dense_grid.
backward_launches` backward ones, `dense_grid.points` the points encoded
by the forward, and `dense_grid.staged` the calls whose inputs were copied
first (points not float32 or not contiguous; tables or the output
gradient not contiguous or off a 16-byte boundary; 0 on the paths).
"""
import ctypes

import torch

from .library import Library, nvcc, on_stream

__all__ = ["dense_grid", "dense_grid_backward", "LIBRARY", "MAX_LEVELS"]

MAX_LEVELS = 8        # csrc kMaxLevels
_F = 8                # the rows' width the library is built for
# the library's row modes: bf16 rows; float32 rows rounded to bf16;
# float32 rows read as they are
_MODES = {(torch.bfloat16, torch.bfloat16): 0,
          (torch.float32, torch.bfloat16): 1,
          (torch.float32, torch.float32): 2}


def _bind(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mvedit_dense_grid_forward.argtypes = [p, ll, i, p, p, i, i, i, p, p]
    lib.mvedit_dense_grid_forward.restype = i
    lib.mvedit_dense_grid_backward.argtypes = [p, ll, i, p, p, i, i, i, p,
                                               p, p, p, p]
    lib.mvedit_dense_grid_backward.restype = i


# -fmad=false: no FMA contraction, so the weights and the blend round as
# the plain version's separate ops do (its bits are the kernel's)
LIBRARY = Library("dense_grid", "dense_grid.cu", nvcc("-fmad=false"), _bind)


def _aligned(t):
    """Rows the kernel reads as they are: contiguous, 16-byte aligned."""
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def _levels(x, tables, resolutions, gather_dtype):
    """The checked inputs as the library reads them: (x, tables, the row
    mode, ctypes arrays of the tables' pointers and resolutions)."""
    if x.device.type != "cuda" or any(t.device != x.device for t in tables):
        raise ValueError(f"unsupported devices {x.device}, "
                         f"{[str(t.device) for t in tables]}")
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"x must be (N, 3), got {tuple(x.shape)}")
    L = len(resolutions)
    if not 1 <= L <= MAX_LEVELS or len(tables) != L:
        raise ValueError(f"{len(tables)} tables for {L} resolutions (1 to "
                         f"{MAX_LEVELS} levels)")
    mode = _MODES.get((tables[0].dtype, gather_dtype))
    if mode is None or any(t.dtype != tables[0].dtype for t in tables):
        raise TypeError(f"unsupported table dtypes "
                        f"{[t.dtype for t in tables]} with gather dtype "
                        f"{gather_dtype}")
    for t, r in zip(tables, resolutions):
        if int(r) < 1 or (int(r) + 1) ** 3 >= 2 ** 31:
            raise ValueError(f"unsupported resolution {r}")
        if t.numel() != (int(r) + 1) ** 3 * _F or t.shape[-1] != _F:
            raise ValueError(f"a table of shape {tuple(t.shape)} for "
                             f"resolution {r}: ({r + 1}^3, {_F}) rows "
                             f"needed")
    if x.dtype is not torch.float32 or not x.is_contiguous():
        if not x.is_floating_point():
            raise TypeError(f"x must be floating, got {x.dtype}")
        dense_grid.staged += 1
        x = x.float().contiguous()
    if not all(map(_aligned, tables)):
        dense_grid.staged += 1
        tables = [t if _aligned(t) else
                  t.clone(memory_format=torch.contiguous_format)
                  for t in tables]
    ptrs = (ctypes.c_void_p * L)(*[t.data_ptr() for t in tables])
    res = (ctypes.c_int * L)(*[int(r) for r in resolutions])
    return x, tables, mode, ptrs, res


def dense_grid(x, tables, resolutions, smooth=True,
               gather_dtype=torch.bfloat16):
    """x (N, 3) points (clipped to [0, 1] inside), tables the levels'
    ((R + 1)^3 rows of 8) -> (N, L 8) float32, the plain version's bits."""
    x, tables, mode, ptrs, res = _levels(x, tables, resolutions,
                                         gather_dtype)
    n, L = x.shape[0], len(tables)
    out = torch.empty((n, L * _F), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    err = on_stream(x.device, LIBRARY.load().mvedit_dense_grid_forward,
                    x.data_ptr(), n, L, ptrs, res, mode, _F,
                    int(bool(smooth)), out.data_ptr())
    if err != 0:
        raise RuntimeError(f"dense_grid launch failed: CUDA error {err}")
    dense_grid.launches += 1
    dense_grid.points += n
    return out


def dense_grid_backward(x, tables, resolutions, grad, smooth=True,
                        gather_dtype=torch.bfloat16, table_grad=True,
                        x_grad=False):
    """The backward of `dense_grid` at its output gradient `grad` (N, L 8)
    float32: (targets (L, N 8) int32 and contributions (L, N 8, 8) in
    `gather_dtype`, or None, None without `table_grad`; x's gradient
    (N, 3) float32, or None without `x_grad`)."""
    if not (table_grad or x_grad):
        raise ValueError("neither gradient asked for")
    x, tables, mode, ptrs, res = _levels(x, tables, resolutions,
                                         gather_dtype)
    n, L, dev = x.shape[0], len(tables), x.device
    if grad.shape != (n, L * _F):
        raise ValueError(f"grad must be ({n}, {L * _F}), got "
                         f"{tuple(grad.shape)}")
    if grad.dtype is not torch.float32 or not _aligned(grad):
        dense_grid.staged += 1
        grad = grad.float().clone(memory_format=torch.contiguous_format)
    if n * 8 >= 2 ** 31 - 1:
        raise ValueError(f"too many points ({n}) for int32 contributions")
    targets = contrib = gx = None
    if table_grad:
        targets = torch.empty((L, n * 8), dtype=torch.int32, device=dev)
        contrib = torch.empty((L, n * 8, _F), dtype=gather_dtype,
                              device=dev)
    if x_grad:
        gx = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return targets, contrib, gx

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = on_stream(dev, LIBRARY.load().mvedit_dense_grid_backward,
                    x.data_ptr(), n, L, ptrs, res, mode, _F,
                    int(bool(smooth)), grad.data_ptr(), ptr(targets),
                    ptr(contrib), ptr(gx))
    if err != 0:
        raise RuntimeError(f"dense_grid backward launch failed: CUDA error "
                           f"{err}")
    dense_grid.backward_launches += 1
    return targets, contrib, gx


dense_grid.launches = 0
dense_grid.backward_launches = 0
dense_grid.points = 0
dense_grid.staged = 0
