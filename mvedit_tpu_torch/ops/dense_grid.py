"""Dense multi-resolution feature volumes (counterpart of
`mvedit_tpu/ops/dense_grid.py`).

The plain 8-corner form: each point gathers its 8 cell corners per level
and blends them with smoothstep (or linear) weights. The JAX package packs
neighbouring corners into channels first (`fold`), a TPU layout trick with
the same values and gradients, which is not ported. The table is cast to
`gather_dtype` (bf16 by default) before the gather and the blend
accumulates in f32, as in the reference: parity depends on that rounding.
"""
from dataclasses import dataclass
from itertools import product
from typing import Tuple

import torch

from .clip import clip
from .segment import gather_rows

__all__ = ["DenseGridConfig", "dense_grid_init", "dense_grid_encode"]


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
    """xyz: (..., 3) in [0, 1] -> (..., out_dim) float32."""
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
