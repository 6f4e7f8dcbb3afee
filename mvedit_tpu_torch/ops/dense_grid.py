"""Dense multi-resolution feature volumes (counterpart of
`mvedit_tpu/ops/dense_grid.py`).

The plain 8-corner form: each point gathers its 8 cell corners per level
and blends them with smoothstep (or linear) weights. The JAX package packs
neighbouring corners into channels first (`fold`), a TPU layout trick with
the same values and gradients, which is not ported. The table is cast to
`gather_dtype` (bf16 by default) before the gather and the blend
accumulates in f32, as in the reference: parity depends on that rounding.

Which path runs: CUDA points take the hand-written kernel
(`kernels/dense_grid.py`, `csrc/dense_grid.cu`): one launch encodes every
level, with the plain version's bits; its backward recomputes the corners
and sums the tables' gradients with `ops.segment.segment_sum` in the plain
gather's order (the same bits) and computes the points' gradient point by
point. CPU points take `dense_grid_encode_reference`, the plain version,
which runs on any device and is the oracle of the card tests
(`tests/test_torch_kernels_cuda.py`).
"""
from dataclasses import dataclass
from itertools import product
from typing import Tuple

import torch

from ..kernels import dense_grid as kernel
from . import segment
from .clip import clip
from .segment import gather_rows

__all__ = ["DenseGridConfig", "dense_grid_init", "dense_grid_encode",
           "dense_grid_encode_reference"]


@dataclass(frozen=True)
class DenseGridConfig:
    resolutions: Tuple[int, ...] = (32, 160)
    n_features: int = 8
    interpolation: str = "smoothstep"
    gather_dtype: str = "bfloat16"

    @property
    def out_dim(self):
        return len(self.resolutions) * self.n_features


def dense_grid_init(cfg: DenseGridConfig, generator=None, device=None,
                    scale=1e-4):
    """{'level_i': (R+1, R+1, R+1, F) float32}, uniform in [-scale, scale]."""
    tables = {}
    for i, r in enumerate(cfg.resolutions):
        u = torch.rand((r + 1, r + 1, r + 1, cfg.n_features),
                       generator=generator, device=device)
        tables[f"level_{i}"] = u * (2 * scale) - scale
    return tables


def dense_grid_encode(tables, xyz, cfg: DenseGridConfig):
    """xyz: (..., 3) in [0, 1] -> (..., out_dim) float32: the kernel on
    CUDA points, `dense_grid_encode_reference` elsewhere."""
    if xyz.device.type != "cuda":
        return dense_grid_encode_reference(tables, xyz, cfg)
    if cfg.interpolation not in ("smoothstep", "linear"):
        raise ValueError(f"unsupported interpolation {cfg.interpolation}")
    levels = [tables[f"level_{i}"] for i in range(len(cfg.resolutions))]
    out = _Encode.apply(xyz.reshape(-1, 3).float(), cfg, *levels)
    return out.reshape(*xyz.shape[:-1], cfg.out_dim)


class _Encode(torch.autograd.Function):
    """The kernel both ways. Saved: the points, and the tables (no copy)
    for the points' gradient; no index or gathered rows."""

    @staticmethod
    def forward(ctx, x, cfg, *levels):
        ctx.cfg = cfg
        ctx.save_for_backward(x, *levels)
        return kernel.dense_grid(x, levels, cfg.resolutions,
                                 cfg.interpolation == "smoothstep",
                                 getattr(torch, cfg.gather_dtype))

    @staticmethod
    def backward(ctx, g):
        x, *levels = ctx.saved_tensors
        cfg, need = ctx.cfg, ctx.needs_input_grad
        tab = any(need[2:])
        targets, contrib, gx = kernel.dense_grid_backward(
            x, levels, cfg.resolutions, g, cfg.interpolation == "smoothstep",
            getattr(torch, cfg.gather_dtype), table_grad=tab,
            x_grad=need[0])
        grads = []
        for i, t in enumerate(levels):
            if not need[2 + i]:
                grads.append(None)
                continue
            # the plain gather's gradient: its fixed-order sum, rounded
            # once to the gather dtype, then widened to the table's
            rows = t.numel() // cfg.n_features
            gt = segment.segment_sum(targets[i], contrib[i], rows,
                                     out_dtype=contrib.dtype)
            grads.append(gt.to(t.dtype).view(t.shape))
        return (gx, None, *grads)


def dense_grid_encode_reference(tables, xyz, cfg: DenseGridConfig):
    """The plain version on any device: xyz (..., 3) in [0, 1] ->
    (..., out_dim) float32."""
    batch_shape = xyz.shape[:-1]
    x = clip(xyz.reshape(-1, 3).float(), 0.0, 1.0)
    F = cfg.n_features
    gdt = getattr(torch, cfg.gather_dtype)
    feats = []
    for i, res in enumerate(cfg.resolutions):
        tab = tables[f"level_{i}"].to(gdt).reshape(-1, F)
        pos = x * res
        p0 = torch.floor(pos)
        t = pos - p0
        w = t * t * (3.0 - 2.0 * t) if cfg.interpolation == "smoothstep" \
            else t
        p0i = p0.long()
        side = res + 1
        # corners in the reference's block order (x slowest, z fastest),
        # gathered in one call: one sort of the targets in the backward
        corners = list(product((0, 1), repeat=3))
        idx = torch.stack([
            ((p0i[:, 0] + ox).clamp(max=res) * side
             + (p0i[:, 1] + oy).clamp(max=res)) * side
            + (p0i[:, 2] + oz).clamp(max=res)
            for ox, oy, oz in corners], 1)                     # (N, 8)
        # unbind, not eight slices: its backward is one stack, where each
        # slice's would be a zero-filled (N, 8, F) gradient to accumulate
        vals = gather_rows(tab, idx).unbind(1)                 # 8 x (N, F)
        acc = None
        for (ox, oy, oz), val in zip(corners, vals):
            wc = ((w[:, 0] if ox else 1 - w[:, 0])
                  * (w[:, 1] if oy else 1 - w[:, 1])
                  * (w[:, 2] if oz else 1 - w[:, 2]))
            v = val.float() * wc[:, None]
            acc = v if acc is None else acc + v
        feats.append(acc)
    return torch.cat(feats, -1).reshape(*batch_shape, cfg.out_dim)
