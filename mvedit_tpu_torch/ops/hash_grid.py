"""Multiresolution hash-grid encoding, instant-NGP style (counterpart of
`mvedit_tpu/ops/hash_grid.py`).

The table of every level lives in one (L, T, F) float32 tensor. Per level
each point gathers its 8 cell corners and blends them with smoothstep (or
linear) weights. A level whose dense grid fits in the table, (res + 1)^3
<= T, takes the linear index; a finer one hashes its corners,
`(x * 1) ^ (y * 2654435761) ^ (z * 805459861)` masked to T - 1. The
reference hashes in uint32; here the products are int64, whose low 32 bits
are the uint32 products' (the coordinates are at most res < 2^31), so the
masked index is the same.

A level's 8 corners are one `ops.segment.gather_rows` call over its (T, F)
rows, so the table's gradient is one fixed-order segment sum per level
(`kernels/segment_sum.py`): on the card, `index_add_` or the backward of
advanced indexing would add atomically, and one seed would give two fits.
The indices are kept as int32 (P x 8 of them per level) for that backward.
"""
import math
from dataclasses import dataclass

import torch

from .clip import clip
from .segment import gather_rows

__all__ = ["HashGridConfig", "hash_grid_init", "hash_grid_encode"]

_PRIMES = (1, 2654435761, 805459861)
# corner c's offsets (dx, dy, dz), x fastest: the reference's order of the
# blend's sum
_CORNERS = [(dx, dy, dz) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]


@dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 12
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    max_resolution: int = 320      # at bound 1
    bound: float = 1.0
    interpolation: str = "smoothstep"  # or "linear"

    @property
    def table_size(self):
        return 1 << self.log2_hashmap_size

    @property
    def per_level_scale(self):
        """exp2(log2(max_res * bound / base_res) / (L - 1))."""
        return 2.0 ** (
            math.log2(self.max_resolution * self.bound / self.base_resolution)
            / max(self.n_levels - 1, 1))

    def level_resolution(self, level):
        return int(math.floor(self.base_resolution
                              * self.per_level_scale ** level))

    @property
    def out_dim(self):
        return self.n_levels * self.n_features


def hash_grid_init(cfg: HashGridConfig, generator=None, device=None,
                   scale=1e-4):
    """(L, T, F) float32, uniform in [-scale, scale]."""
    u = torch.rand((cfg.n_levels, cfg.table_size, cfg.n_features),
                   generator=generator, device=device)
    return u * (2 * scale) - scale


def _level_index(corner, res, table_size):
    """corner: (P, 3) int64 grid coords in [0, res] -> (P,) int64 row."""
    side = res + 1
    if side ** 3 <= table_size:
        return (corner[:, 2] * side + corner[:, 1]) * side + corner[:, 0]
    h = corner[:, 0] * _PRIMES[0]
    h = h ^ (corner[:, 1] * _PRIMES[1])
    h = h ^ (corner[:, 2] * _PRIMES[2])
    return h & (table_size - 1)


def hash_grid_encode(table, xyz, cfg: HashGridConfig):
    """table: (L, T, F) float32; xyz: (..., 3) points in [0, 1] (clipped)
    -> (..., L * F) float32 features."""
    batch_shape = xyz.shape[:-1]
    x = clip(xyz.reshape(-1, 3).float(), 0.0, 1.0)
    levels = table.unbind(0)        # one stack in the backward, not L slices
    off = torch.tensor(_CORNERS, dtype=torch.int64, device=x.device)
    feats = []
    for level, tab in enumerate(levels):
        res = cfg.level_resolution(level)
        pos = x * res
        p0 = torch.floor(pos)
        t = pos - p0
        w = t * t * (3.0 - 2.0 * t) if cfg.interpolation == "smoothstep" \
            else t
        corners = (p0.long()[:, None, :] + off).clamp(max=res)  # (P, 8, 3)
        idx = _level_index(corners.reshape(-1, 3), res, cfg.table_size)
        vals = gather_rows(tab, idx.to(torch.int32).reshape(-1, 8)).unbind(1)
        acc = None
        for (dx, dy, dz), v in zip(_CORNERS, vals):
            wx = w[:, 0] if dx else 1.0 - w[:, 0]
            wy = w[:, 1] if dy else 1.0 - w[:, 1]
            wz = w[:, 2] if dz else 1.0 - w[:, 2]
            term = v * (wx * wy * wz)[:, None]
            acc = term if acc is None else acc + term
        feats.append(acc)
    return torch.cat(feats, -1).reshape(*batch_shape, cfg.out_dim)
