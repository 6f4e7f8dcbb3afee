"""Differentiable tile-based triangle rasterizer (counterpart of
`mvedit_tpu/models/mesh/rasterize.py`).

1. **Project** world vertices to pixel space from OpenCV intrinsics.
2. **Bin** triangles to 16x16 screen tiles: each triangle emits one (tile,
   tri) pair per tile of its bounding box, up to span x span; triangles
   spanning more go to a global "big" list that every tile checks. One
   sort and a searchsorted turn the pairs into per-tile candidate lists of
   fixed capacity (`k_per_tile`, `k_big`; candidates past them are dropped,
   as in the reference).
3. **Select**: per pixel, the nearest covering candidate and its face id,
   through `kernels.raster_select` (the hand-written kernel on the card,
   its plain version on the CPU), which reads the bin lists and the big
   list apart. Selection is discrete and carries no gradient. The kernel
   takes 16 x 16 and 32 x 32 tiles (another `RasterConfig.tile` raises on
   the card); the plain version takes any, as the reference does.
4. **Winner outputs**: the winner's perspective-correct barycentrics,
   depth and soft silhouette alpha are recomputed differentiably from
   `pts`, so gradients reach the vertices as nvdiffrast's coverage
   semantics give them.

Only the reference's "pairs" binning is ported (its `bin_mode`, `backend`
and `tile_chunk` are TPU knobs); its XLA tile shader (`shade_tile`) is
the semantics the plain selection is held to.
"""
from dataclasses import dataclass

import torch

from ...kernels.raster_select import raster_select
from ...ops.clip import clip
from ...ops.segment import gather_rows

__all__ = ["RasterConfig", "project_mesh", "candidates", "rasterize",
           "interpolate"]


@dataclass(frozen=True)
class RasterConfig:
    height: int = 512
    width: int = 512
    tile: int = 16          # tile size in pixels (the kernel's: 16, 32)
    span: int = 4           # max tile span per axis before -> big list
    k_per_tile: int = 256   # candidate capacity per tile
    k_big: int = 64         # global big-triangle list capacity
    near: float = 0.01
    cull_backface: bool = False

    @property
    def tiles_x(self):
        return (self.width + self.tile - 1) // self.tile

    @property
    def tiles_y(self):
        return (self.height + self.tile - 1) // self.tile

    @property
    def num_tiles(self):
        return self.tiles_x * self.tiles_y


def project_mesh(verts, pose_w2c, intrinsics, near=0.01):
    """World verts (V, 3) -> pixel-space (V, 3): (u_pix, v_pix, z_cam).
    pose_w2c: (3, 4) world-to-camera (OpenCV); intrinsics: (4,) fx fy cx cy."""
    vc = verts @ pose_w2c[:, :3].T + pose_w2c[:, 3]
    z = clip(vc[:, 2], near)
    u = intrinsics[0] * vc[:, 0] / z + intrinsics[2]
    v = intrinsics[1] * vc[:, 1] / z + intrinsics[3]
    return torch.stack([u, v, vc[:, 2]], -1)


def _edge(p, q, r):
    """2D cross of (q - p, r - p); positive if r is left of p -> q."""
    return ((q[..., 0] - p[..., 0]) * (r[..., 1] - p[..., 1])
            - (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0]))


@torch.no_grad()
def _bin_triangles(pts, faces, face_valid, cfg: RasterConfig):
    """Per-tile candidate lists, "pairs" binning. Returns (tile_tris
    (num_tiles, k_per_tile) int64, tile_valid, big_tris (k_big,),
    big_valid)."""
    F = faces.shape[0]
    dev = pts.device
    p = pts[faces]                                   # (F, 3, 3)
    fmin = p[..., :2].amin(1)
    fmax = p[..., :2].amax(1)
    behind = (p[..., 2] <= cfg.near).any(1)
    offscreen = (fmax[:, 0] < 0) | (fmax[:, 1] < 0) \
        | (fmin[:, 0] >= cfg.width) | (fmin[:, 1] >= cfg.height)
    live = face_valid & ~behind & ~offscreen
    hi = torch.tensor([cfg.tiles_x - 1, cfg.tiles_y - 1], device=dev)
    lo = torch.zeros_like(hi)
    t0 = torch.maximum(torch.minimum(
        torch.floor(fmin / cfg.tile).long(), hi), lo)
    t1 = torch.maximum(torch.minimum(
        torch.floor(fmax / cfg.tile).long(), hi), lo)
    span = t1 - t0 + 1
    is_big = live & ((span[:, 0] > cfg.span) | (span[:, 1] > cfg.span))
    is_small = live & ~is_big

    S = cfg.span
    d = torch.arange(S, device=dev)
    gx = t0[:, 0:1] + d[None]
    gy = t0[:, 1:2] + d[None]
    in_x = d[None] < span[:, 0:1]
    in_y = d[None] < span[:, 1:2]
    tile_id = gy[:, :, None] * cfg.tiles_x + gx[:, None, :]    # (F, S, S)
    pair_valid = is_small[:, None, None] & in_y[:, :, None] & in_x[:, None, :]
    keys = torch.where(pair_valid, tile_id,
                       torch.full_like(tile_id, cfg.num_tiles)).reshape(-1)
    # sort by (tile, tri): pairs of one tile keep ascending tri order
    Fm = max(F, 1)
    packed, _ = torch.sort(
        keys * Fm + torch.arange(F, device=dev).repeat_interleave(S * S))
    keys = packed // Fm
    vals = packed % Fm
    ar = torch.arange(cfg.num_tiles, device=dev)
    starts = torch.searchsorted(keys, ar, right=False)
    ends = torch.searchsorted(keys, ar, right=True)
    idx = starts[:, None] + torch.arange(cfg.k_per_tile, device=dev)[None]
    tile_valid = idx < ends[:, None]
    tile_tris = vals[idx.clamp(0, keys.shape[0] - 1)]

    # the first k_big big triangles in face order, padded with face 0
    pos = torch.cumsum(is_big.long(), 0) - 1
    slot = torch.where(is_big & (pos < cfg.k_big), pos,
                       torch.full_like(pos, cfg.k_big))
    big_tris = torch.zeros(cfg.k_big + 1, dtype=torch.long, device=dev)
    big_tris.scatter_(0, slot, torch.arange(F, device=dev))
    big_tris = big_tris[:cfg.k_big]     # slot k_big collects the rest
    big_valid = is_big[big_tris] & (torch.arange(cfg.k_big, device=dev) < F)
    return tile_tris, tile_valid, big_tris, big_valid


def candidates(pts, faces, face_valid, cfg: RasterConfig):
    """Each tile's candidate list, its bin list then the global big list,
    joined: (cand (num_tiles, k_per_tile + k_big) int64 face ids,
    cand_valid), the one (T, K) list of the TPU kernel's interface
    (`select_reference`). `rasterize` hands the lists over apart."""
    tile_tris, tile_valid, big_tris, big_valid = _bin_triangles(
        pts.detach(), faces.long(), face_valid, cfg)
    T = cfg.num_tiles
    return (torch.cat([tile_tris, big_tris[None].expand(T, -1)], 1),
            torch.cat([tile_valid, big_valid[None].expand(T, -1)], 1))


def _winner_outputs(wt, hit, qp, pts, faces, cull_backface):
    """Differentiable outputs of the selected (winner) triangles.

    wt: (N,) tri ids; hit: (N,) bool; qp: (N, 2) pixel centres; pts (V, 3)
    projected verts; faces (F, 3). The winner's corners are gathered from
    `pts`, so the backward scatters straight into d_pts. Every NaN guard of
    the reference is kept: a degenerate dummy winner (nothing covers the
    pixel) must give finite values and zero gradients, and `where`, not a
    multiply by the mask, keeps 0 * NaN out of the gradient.
    Returns (tri_out, uv, z, hard, soft, winner_faces)."""
    fw = faces[wt]                                    # (N, 3)
    pw = gather_rows(pts, fw)                         # (N, 3, 3)
    aw, bw, cw = pw[:, 0], pw[:, 1], pw[:, 2]
    area_w = _edge(aw[:, :2], bw[:, :2], cw[:, :2])
    sgn_w = torch.ones_like(area_w) if cull_backface \
        else torch.sign(area_w).detach()
    area_w = area_w * sgn_w
    w0w = _edge(bw[:, :2], cw[:, :2], qp) * sgn_w
    w1w = _edge(cw[:, :2], aw[:, :2], qp) * sgn_w
    w2w = _edge(aw[:, :2], bw[:, :2], qp) * sgn_w
    one = torch.ones((), dtype=pts.dtype, device=pts.device)
    inv_area_w = 1.0 / torch.where(area_w.abs() < 1e-12, 1e-12 * one, area_w)
    b0w, b1w, b2w = w0w * inv_area_w, w1w * inv_area_w, w2w * inv_area_w

    # clamp depths away from 0 before inverting: a dummy winner with a
    # vertex at camera z = 0 would give inf and then NaN in the denominator
    def _inv_z(z):
        return 1.0 / torch.where(z.abs() < 1e-6, 1e-6 * one, z)
    iz0, iz1, iz2 = _inv_z(aw[:, 2]), _inv_z(bw[:, 2]), _inv_z(cw[:, 2])
    denom = b0w * iz0 + b1w * iz1 + b2w * iz2
    denom = torch.where(torch.isfinite(denom) & (denom.abs() >= 1e-12),
                        denom, 1e-12 * one)
    u = b1w * iz1 / denom
    v = b2w * iz2 / denom
    zpix = 1.0 / denom

    # soft silhouette: signed pixel distance to the winner's nearest edge
    def edge_dist(pa, pb):
        e = pb[:, :2] - pa[:, :2]
        n = torch.stack([-e[:, 1], e[:, 0]], -1) * sgn_w[:, None]
        # rsqrt(sumsq + eps), not n / clip(norm): norm's gradient at n = 0
        # is 0 / 0 and would NaN the vertex gradient of a dummy winner
        inv_nn = torch.rsqrt((n * n).sum(-1) + 1e-12)
        return ((qp - pa[:, :2]) * n).sum(-1) * inv_nn
    d_edge = torch.minimum(torch.minimum(edge_dist(aw, bw), edge_dist(bw, cw)),
                           edge_dist(cw, aw))
    hitf = hit.to(pts.dtype)
    alpha_soft = clip(0.5 + d_edge, 0.0, 1.0) * hitf
    tri_out = torch.where(hit, wt, torch.full_like(wt, -1))
    zero = torch.zeros((), dtype=pts.dtype, device=pts.device)
    uv = torch.where(hit[:, None], torch.stack([u, v], -1), zero)
    zpix = torch.where(hit, zpix, zero)
    return tri_out, uv, zpix, hitf, alpha_soft, fw


def rasterize(pts, faces, face_valid, cfg: RasterConfig):
    """pts: (V, 3) pixel-space verts (u, v, z); faces (F, 3); face_valid
    (F,) bool. Returns a dict of (H, W) maps: tri_id (int64, -1 on a miss),
    bary (H, W, 2) perspective-correct u, v, z (camera depth), alpha_hard,
    alpha (soft silhouette), winner_faces (H, W, 3)."""
    faces = faces.long()
    ts = cfg.tile
    with torch.no_grad():
        # the bin lists and the big list go to the selection as they are;
        # it returns each pixel's winning face id (-1 on a miss)
        tile_tris, tile_valid, big_tris, big_valid = _bin_triangles(
            pts.detach(), faces, face_valid, cfg)
        _, bkey, wt = raster_select(pts.detach(), faces, tile_tris,
                                    tile_valid, ts, cfg.tiles_x,
                                    cfg.cull_backface, big_tris, big_valid)
        # a miss (-1) takes its tile's first slot as a dummy winner: its
        # outputs are masked, and the backward's scatter of their zero
        # gradients spreads over the tiles instead of piling onto one face
        wt = torch.where(wt >= 0, wt, tile_tris[:, :1])

    def detile(x):
        # (T, ts * ts) -> (H, W)
        x = x.reshape(cfg.tiles_y, cfg.tiles_x, ts, ts).transpose(1, 2)
        return x.reshape(cfg.tiles_y * ts, cfg.tiles_x * ts)[
            :cfg.height, :cfg.width]
    hit = detile(bkey) < 1e38
    wt = detile(wt)
    dev = pts.device
    qy, qx = torch.meshgrid(
        torch.arange(cfg.height, device=dev, dtype=pts.dtype) + 0.5,
        torch.arange(cfg.width, device=dev, dtype=pts.dtype) + 0.5,
        indexing="ij")
    qp = torch.stack([qx, qy], -1)
    flat = _winner_outputs(wt.reshape(-1), hit.reshape(-1), qp.reshape(-1, 2),
                           pts, faces, cfg.cull_backface)
    tri_id, uv, z, hard, soft, fw = (
        x.reshape((cfg.height, cfg.width) + x.shape[1:]) for x in flat)
    return {"tri_id": tri_id, "bary": uv, "z": z, "alpha_hard": hard,
            "alpha": soft, "winner_faces": fw}


def interpolate(attr, rast, faces):
    """Per-vertex attributes (V, C) -> per-pixel (H, W, C) through the
    perspective-correct barycentrics. The face buffer is always the one
    passed in (the reference reuses `rast["winner_faces"]` when present and
    so ignores `faces`; the port takes the buffer explicitly)."""
    tri = rast["tri_id"].clamp(min=0)
    f = faces.long()[tri]                   # (H, W, 3)
    u = rast["bary"][..., 0:1]
    v = rast["bary"][..., 1:2]
    out = gather_rows(attr, f[..., 0]) * (1 - u - v) \
        + gather_rows(attr, f[..., 1]) * u + gather_rows(attr, f[..., 2]) * v
    return out * (rast["tri_id"] >= 0)[..., None].to(out.dtype)
