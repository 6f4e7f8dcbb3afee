"""Row-drop scatter-add (counterpart of `mvedit_tpu/ops/segment.py`) and
the row gather the mesh and field paths differentiate through.

Autograd differentiates `index_add` into a gather, which is the custom VJP
the JAX package writes by hand, so nothing else is needed for
`segment_add`. `gather_rows` is `x[idx]` through `index_select`, whose
backward is an atomic `index_add`: advanced indexing's backward is a
sorted, serialised accumulate that took 21 ms per dense-grid corner gather
and ~1 s per mesh-fit step on an H100 (PERF.md, Findings).
"""
import torch

__all__ = ["segment_add", "gather_rows"]


def gather_rows(x, idx):
    """`x[idx]` for an integer index tensor of any shape, along dim 0."""
    return x.index_select(0, idx.reshape(-1)).reshape(
        *idx.shape, *x.shape[1:])


def segment_add(idx, vals, size):
    """`zeros((size, C)).at[idx].add(vals)` with drop semantics.

    idx: (N,) integer targets; rows with idx outside [0, size) are dropped
    (callers use idx == size as the mask convention). vals: (N, C),
    accumulated in float32. Returns (size, C) float32.
    """
    keep = (idx >= 0) & (idx < size)
    # torch raises on out-of-range indices: send dropped rows to row 0 with
    # a zero payload (no host sync, unlike boolean indexing)
    safe = torch.where(keep, idx, torch.zeros_like(idx))
    v = torch.where(keep[:, None], vals.float(), torch.zeros((), device=vals.device))
    out = torch.zeros((size, vals.shape[-1]), dtype=torch.float32,
                      device=vals.device)
    return out.index_add(0, safe, v)
