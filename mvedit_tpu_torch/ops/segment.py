"""Row-drop scatter-add (counterpart of `mvedit_tpu/ops/segment.py`) and
the row gather the mesh and field paths differentiate through, both
accumulating in a fixed order.

The sums go through `kernels.segment_sum` (one stable sort of the targets,
then each row summed in the contributions' order in float32), so that one
seed gives one result on the card: `index_add`, and the backward of
`index_select` or of advanced indexing, add atomically there and round in
arrival order. `segment_add`'s backward is a gather of the output
gradient; `gather_rows`' backward is a `segment_sum` of it, cast once to
the gathered tensor's dtype (the dense grid's bf16 table sums in f32).
Advanced indexing's own backward is a sorted, serialised accumulate that
took 21 ms per dense-grid corner gather and ~1 s per mesh-fit step on an
H100 (PERF.md, Findings), which is why none of these use it.
"""
import torch

from ..kernels.segment_sum import segment_sum

__all__ = ["segment_add", "gather_rows"]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.dtype = x.shape[0], x.dtype
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        gx = segment_sum(idx, g.reshape(idx.shape[0], -1), ctx.rows)
        return gx.reshape(ctx.rows, *g.shape[1:]).to(ctx.dtype), None


class _SegmentAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, idx, vals, size):
        ctx.save_for_backward(idx)
        ctx.size, ctx.dtype = size, vals.dtype
        return segment_sum(idx, vals, size)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        keep = (idx >= 0) & (idx < ctx.size)
        gv = g.index_select(0, torch.where(keep, idx, torch.zeros_like(idx)))
        gv = torch.where(keep[:, None], gv, torch.zeros((), dtype=g.dtype,
                                                        device=g.device))
        return None, gv.to(ctx.dtype), None


def gather_rows(x, idx):
    """`x[idx]` for an integer index tensor of any shape, along dim 0."""
    flat = idx.reshape(-1)
    if x.requires_grad and torch.is_grad_enabled():
        out = _GatherRows.apply(x, flat)
    else:
        out = x.index_select(0, flat)
    return out.reshape(*idx.shape, *x.shape[1:])


def segment_add(idx, vals, size):
    """`zeros((size, C)).at[idx].add(vals)` with drop semantics.

    idx: (N,) integer targets; rows with idx outside [0, size) are dropped
    (callers use idx == size as the mask convention). vals: (N, C),
    accumulated in float32, each row in the order of idx. Returns (size, C)
    float32."""
    return _SegmentAdd.apply(idx, vals, size)

