"""Sparse-voxel linear interpolation (counterpart of
`mvedit_tpu/ops/volume_interp.py`, the reference's spconv-backed
`lib/ops/volume_interp.py`).

- A sparse volume is a static-capacity struct: `indices (N, 4)` int32 rows
  of [batch, d, h, w], `features (N, C)`, and an `active (N,)` mask, so
  the row count is fixed while the live count is data.
- Voxel lookup is a packed-integer key search: coordinates bit-pack into
  one int32 key (`encode_coords`), rows are kept sorted by key, and
  queries run one `searchsorted` per corner. The batch field is bounded
  by `batch_size`. The reference asks for int64 keys past 30 bits, but
  runs with JAX's 64-bit types off, where that request gives int32: its
  keys are int32 at every size, wrapping past 31 bits, and so are these,
  bit for bit.
- Interpolation is a (P, 8) gather and a weighted sum. The features'
  gradient of the gather is `ops/segment.py::gather_rows`' fixed-order
  segment sum (never `index_add_`); `dense_from_sparse` scatters through
  `segment_add`.
- Outputs keep their static shape (P, C): points that the reference
  prunes are zero rows, flagged in `valid_pts_mask`.

Dense volumes here are (B, D, H, W, C) with a (B, D, H, W) mask, the
reference's layout (`models/volume_unet.py` computes in NCDHW).
"""
import dataclasses

import torch

from .segment import gather_rows, segment_add

__all__ = [
    "SparseVolume", "sparse_volume", "encode_coords", "coord_to_feat_idx",
    "spvolume_linear_interp", "NeighborData", "build_neighbor",
    "neighbor_spvolume_linear_interp", "dense_from_sparse",
    "sparse_from_dense",
]

# the 8 corner offsets of a unit cell, the reference's grid order
_CORNERS = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
            (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))
_BIG = torch.iinfo(torch.int32).max


def _corners(device):
    return torch.tensor(_CORNERS, dtype=torch.int32, device=device)


def _shifts(spatial_shape):
    """The bit shifts of the batch, d and h fields of a key."""
    bits = [max(int(s - 1).bit_length(), 1) for s in spatial_shape]
    return (bits[0] + bits[1] + bits[2], bits[1] + bits[2], bits[2])


def encode_coords(coords, spatial_shape, batch_size=16):
    """(..., 4) [batch, d, h, w] -> int32 keys, monotone in the coords while
    they fit in 31 bits (`batch_size` bounds the batch field)."""
    s = _shifts(spatial_shape)
    c = coords.to(torch.int32)
    return ((c[..., 0] << s[0]) | (c[..., 1] << s[1]) | (c[..., 2] << s[2])
            | c[..., 3])


@dataclasses.dataclass(frozen=True)
class SparseVolume:
    """Static-capacity sparse voxel tensor; rows sorted by key, inactive
    rows carry the largest key so that they sort last and never match."""
    indices: torch.Tensor     # (N, 4) int32 [batch, d, h, w]
    features: torch.Tensor    # (N, C)
    keys: torch.Tensor        # (N,) int32, sorted
    active: torch.Tensor      # (N,) bool
    spatial_shape: tuple      # (D, H, W)
    batch_size: int

    @property
    def capacity(self):
        return self.indices.shape[0]

    @property
    def num_active(self):
        return self.active.sum()


def sparse_volume(indices, features, spatial_shape, batch_size,
                  active=None):
    """A SparseVolume, its rows sorted by key (stable)."""
    indices = torch.as_tensor(indices).to(torch.int32)
    if active is None:
        active = torch.ones((indices.shape[0],), dtype=torch.bool,
                            device=indices.device)
    keys = encode_coords(indices, spatial_shape, batch_size)
    keys = torch.where(active, keys, torch.full_like(keys, _BIG))
    order = torch.argsort(keys, stable=True)
    return SparseVolume(indices=indices[order],
                        features=gather_rows(features, order),
                        keys=keys[order], active=active[order],
                        spatial_shape=tuple(int(s) for s in spatial_shape),
                        batch_size=int(batch_size))


def _lookup(keys, active, shape, batch_size, q):
    """Row of each [batch, d, h, w] query in the sorted `keys` and whether
    it is there."""
    bound = torch.tensor((batch_size,) + tuple(shape), dtype=torch.int32,
                         device=q.device)
    in_bounds = ((q >= 0) & (q < bound)).all(-1)
    qk = encode_coords(torch.where(in_bounds[..., None], q,
                                   torch.zeros_like(q)), shape, batch_size)
    idx = torch.searchsorted(keys, qk.contiguous()).clamp(
        0, keys.shape[0] - 1)
    return idx, in_bounds & (keys[idx] == qk) & active[idx]


def coord_to_feat_idx(vol, query):
    """Row index of each queried voxel [batch, d, h, w] (clamped), and
    valid=False where the voxel is absent."""
    q = torch.as_tensor(query).to(torch.int32)
    return _lookup(vol.keys, vol.active, vol.spatial_shape, vol.batch_size,
                   q)


def _pt_cell_coords(vol, pts):
    """[-1, 1] points -> continuous voxel coords (half-pixel centres)."""
    s = torch.tensor(vol.spatial_shape, dtype=pts.dtype, device=pts.device)
    return pts * (s / 2) + (s / 2 - 0.5)


def _corner_weights(frac):
    """(P, 8) trilinear weights of the corners for (P, 3) fractions."""
    w = (1.0 - _corners(frac.device).to(frac.dtype)) - frac[:, None, :]
    return (w[..., 0] * w[..., 1] * w[..., 2]).abs()


def _masked_valid(vol, pt_inds, batch_inds):
    """masked=True: a point is valid iff its nearest voxel is active."""
    pr = torch.round(pt_inds).to(torch.int32)
    _, valid = coord_to_feat_idx(
        vol, torch.cat([batch_inds.to(torch.int32), pr], -1))
    return valid


def _interp(vol, idx, cvalid, frac, pt_inds, batch_inds, masked,
            normalize, eps):
    w = _corner_weights(frac) * cvalid.to(frac.dtype)          # (P, 8)
    feats = gather_rows(vol.features, idx)                     # (P, 8, C)
    out = torch.einsum("pk,pkc->pc", w.to(feats.dtype), feats)
    if normalize:
        out = out / (eps + w.to(feats.dtype).sum(1))[:, None]
    if masked:
        valid = _masked_valid(vol, pt_inds, batch_inds)
    else:
        valid = cvalid.any(-1)
    return out * valid[:, None].to(out.dtype), valid


def spvolume_linear_interp(vol, pts, batch_inds, masked=True,
                           normalize=None, eps=1e-6):
    """Trilinear interpolation of sparse voxel features at points.

    pts: (P, 3) in [d, h, w] order, in [-1, 1]; batch_inds: (P, 1) int;
    masked: points whose nearest voxel is empty are invalid; normalize:
    divide by the valid corners' weight sum (default `masked`). Returns
    (out (P, C), valid (P,)); invalid rows are zero."""
    if normalize is None:
        normalize = masked
    pt_inds = _pt_cell_coords(vol, pts)
    floor = torch.floor(pt_inds)
    frac = pt_inds - floor
    corners = floor.to(torch.int32)[:, None, :] + _corners(pts.device)
    b8 = batch_inds.to(torch.int32)[:, None, :].expand(-1, 8, 1)
    idx, cvalid = coord_to_feat_idx(vol, torch.cat([b8, corners], -1))
    return _interp(vol, idx, cvalid, frac, pt_inds, batch_inds, masked,
                   normalize, eps)


@dataclasses.dataclass(frozen=True)
class NeighborData:
    """Per-floor-cell corner rows (static capacity): one key search per
    point instead of eight."""
    keys: torch.Tensor          # (F,) sorted floor-cell keys (D+1 grid)
    corner_idx: torch.Tensor    # (F, 8) feature rows
    corner_valid: torch.Tensor  # (F, 8) bool
    active: torch.Tensor        # (F,) bool
    spatial_shape_p1: tuple
    batch_size: int


def build_neighbor(vol, capacity=None):
    """For every cell of the (D+1, H+1, W+1) grid with an active corner
    voxel (cell f covers voxels f - 1 + g), its 8 corner rows."""
    sp1 = tuple(s + 1 for s in vol.spatial_shape)
    if capacity is None:
        n = vol.batch_size
        for s in sp1:
            n *= s
        capacity = min(8 * vol.capacity, n)
    dev = vol.indices.device
    cells = vol.indices[:, None, 1:] + _corners(dev)           # (N, 8, 3)
    b8 = vol.indices[:, None, :1].expand(-1, 8, 1)
    cell_keys = encode_coords(torch.cat([b8, cells], -1), sp1,
                              vol.batch_size).reshape(-1)
    cell_keys = torch.where(vol.active.repeat_interleave(8), cell_keys,
                            torch.full_like(cell_keys, _BIG))
    sk = torch.sort(cell_keys).values
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       sk[1:] != sk[:-1]]) & (sk != _BIG)
    pos = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32)
    # slot i <- the i-th unique key
    slot = torch.searchsorted(pos, torch.arange(
        1, capacity + 1, dtype=torch.int32, device=dev)).clamp(
            0, sk.shape[0] - 1)
    fkeys = sk[slot]
    factive = torch.arange(capacity, device=dev) < pos[-1]
    fkeys = torch.where(factive, fkeys, torch.full_like(fkeys, _BIG))
    s = _shifts(sp1)
    fcoords = torch.stack([
        fkeys >> s[0], (fkeys >> s[1]) & ((1 << (s[0] - s[1])) - 1),
        (fkeys >> s[2]) & ((1 << (s[1] - s[2])) - 1),
        fkeys & ((1 << s[2]) - 1)], -1).to(torch.int32)
    corn = fcoords[:, None, 1:] - 1 + _corners(dev)
    cb = fcoords[:, None, :1].expand(-1, 8, 1)
    cidx, cvalid = coord_to_feat_idx(vol, torch.cat([cb, corn], -1))
    return NeighborData(keys=fkeys, corner_idx=cidx,
                        corner_valid=cvalid & factive[:, None],
                        active=factive, spatial_shape_p1=sp1,
                        batch_size=vol.batch_size)


def neighbor_spvolume_linear_interp(vol, pts, batch_inds, neighbor=None,
                                    masked=True, normalize=None, eps=1e-6):
    """`spvolume_linear_interp` through a `NeighborData` cache (built here
    when not given)."""
    if neighbor is None:
        neighbor = build_neighbor(vol)
    if normalize is None:
        normalize = masked
    pt_inds = _pt_cell_coords(vol, pts)
    floor = torch.floor(pt_inds)
    frac = pt_inds - floor
    q = torch.cat([batch_inds.to(torch.int32),
                   floor.to(torch.int32) + 1], -1)
    fi, cell_ok = _lookup(neighbor.keys, neighbor.active,
                          neighbor.spatial_shape_p1, neighbor.batch_size, q)
    cvalid = neighbor.corner_valid[fi] & cell_ok[:, None]
    return _interp(vol, neighbor.corner_idx[fi], cvalid, frac, pt_inds,
                   batch_inds, masked, normalize, eps)


def dense_from_sparse(vol):
    """(B, D, H, W, C) features (the active rows added in, through the
    fixed-order `segment_add`) and the (B, D, H, W) bool mask."""
    B, (D, H, W) = vol.batch_size, vol.spatial_shape
    C = vol.features.shape[1]
    idx = torch.where(vol.active[:, None], vol.indices,
                      torch.zeros_like(vol.indices)).long()
    lin = ((idx[:, 0] * D + idx[:, 1]) * H + idx[:, 2]) * W + idx[:, 3]
    feats = vol.features * vol.active[:, None].to(vol.features.dtype)
    n = B * D * H * W
    dense = segment_add(lin, feats, n).to(vol.features.dtype)
    mask = torch.zeros((n,), dtype=torch.int32, device=lin.device)
    mask = mask.scatter_reduce(0, lin, vol.active.to(torch.int32), "amax")
    return dense.reshape(B, D, H, W, C), mask.reshape(B, D, H, W) > 0


def sparse_from_dense(dense, mask, capacity):
    """The active voxels of a (B, D, H, W, C) volume and its mask, in
    raster order, into a static-capacity SparseVolume."""
    B, D, H, W, C = dense.shape
    flat_m = mask.reshape(-1)
    pos = torch.cumsum(flat_m.to(torch.int32), 0, dtype=torch.int32)
    dev = dense.device
    lin = torch.searchsorted(pos, torch.arange(
        1, capacity + 1, dtype=torch.int32, device=dev)).clamp(
            0, flat_m.shape[0] - 1)
    active = torch.arange(capacity, device=dev) < pos[-1]
    indices = torch.stack([lin // (W * H * D), (lin // (W * H)) % D,
                           (lin // W) % H, lin % W], -1).to(torch.int32)
    feats = gather_rows(dense.reshape(-1, C), lin)
    return sparse_volume(indices, feats, (D, H, W), B, active=active)
