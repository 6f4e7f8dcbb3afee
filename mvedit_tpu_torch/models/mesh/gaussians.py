"""3D Gaussian splatting renderer, tile-based and differentiable
(counterpart of `mvedit_tpu/models/mesh/gaussians.py`).

The reference's algorithm, step for step: EWA projection of each gaussian
to a 2D screen-space gaussian (3-sigma radius from the larger eigenvalue
of its 2 x 2 covariance), binning to the at most 3 x 3 screen tiles its
radius covers, one sort by (tile, depth rank), the first `k_per_tile`
candidates of each tile, then front-to-back alpha compositing over them.

PyTorch idiom and the port's rules:

- the depth order is a stable `argsort`, and the reference's two-key
  `lax.sort` one stable sort of the int64 key `tile * N + rank`, so the
  candidate lists are the reference's id for id;
- the 2 x 2 eigenvalue and inverse are closed forms;
- the per-candidate attributes (uv, inverse covariance, opacity, colour,
  depth) are gathered from one (N, 10) table through
  `ops.segment.gather_rows`, so their gradient is one fixed-order segment
  sum a render, never an atomic scatter;
- the exclusive transmittance is the reference's `cumprod(1 - a + 1e-10)
  / (1 - a + 1e-10)`, its product a log-step scan, which has one order
  on every device (the card's cumprod backward goes through a cumsum).

The reference shades tiles in `tile_chunk` batches under a `lax.map` to
cap the TPU's working set. The port keeps the field for parity and shades
every tile in one batch: at 512^2, tile 16 and K 256 that is 1024 x 256 x
256 f32 per (pixel, candidate) tensor, 268 MB each, a few GB for a
render with its autograd state.

Selection of the candidate set carries no gradient, as in every
gaussian-splatting implementation.
"""
from dataclasses import dataclass

import torch

from ...ops.clip import clip
from ...ops.segment import gather_rows

__all__ = ["GSRasterConfig", "project_gaussians", "bin_gaussians",
           "render_gaussians", "quaternion_to_matrix"]

SPAN = 3


@dataclass(frozen=True)
class GSRasterConfig:
    height: int = 256
    width: int = 256
    tile: int = 16
    k_per_tile: int = 256
    opacity_thr: float = 0.01
    near: float = 0.05
    tile_chunk: int = 64      # the reference's TPU cap; unused here

    @property
    def tiles_x(self):
        return (self.width + self.tile - 1) // self.tile

    @property
    def tiles_y(self):
        return (self.height + self.tile - 1) // self.tile

    @property
    def num_tiles(self):
        return self.tiles_x * self.tiles_y


def quaternion_to_matrix(q):
    """(..., 4) wxyz -> (..., 3, 3), not normalised (the reference's)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def project_gaussians(means, scales, quats, pose_w2c, intrinsics,
                      cfg: GSRasterConfig):
    """3D gaussians -> screen space: (uv (N, 2), depth (N,) camera z,
    cov2d (N, 2, 2), radius (N,))."""
    R, t = pose_w2c[:, :3], pose_w2c[:, 3]
    pc = means @ R.T + t
    z = clip(pc[:, 2], cfg.near)
    fx, fy, cx, cy = intrinsics.unbind(0)
    u = fx * pc[:, 0] / z + cx
    v = fy * pc[:, 1] / z + cy
    S = quaternion_to_matrix(quats) * scales[:, None, :]
    cov3d = S @ S.transpose(1, 2)
    # the EWA perspective Jacobian
    zero = torch.zeros_like(z)
    J = torch.stack([
        torch.stack([fx / z, zero, -fx * pc[:, 0] / z ** 2], -1),
        torch.stack([zero, fy / z, -fy * pc[:, 1] / z ** 2], -1)], -2)
    W = J @ R[None]
    cov2d = W @ cov3d @ W.transpose(1, 2) \
        + 0.3 * torch.eye(2, dtype=means.dtype, device=means.device)
    # the larger eigenvalue of the symmetrised 2 x 2 (`eigvalsh`)
    a, c = cov2d[:, 0, 0], cov2d[:, 1, 1]
    b = 0.5 * (cov2d[:, 0, 1] + cov2d[:, 1, 0])
    lam = 0.5 * (a + c) + torch.sqrt(0.25 * (a - c) ** 2 + b * b)
    radius = 3.0 * torch.sqrt(clip(lam, 1e-8))
    return torch.stack([u, v], -1), pc[:, 2], cov2d, radius


def _tile_index(x, ts, n):
    # float floor division, clamped before the cast so that no value
    # leaves int32's range
    return torch.floor(x / ts).clamp(-1, n).long().clamp(0, n - 1)


@torch.no_grad()
def bin_gaussians(uv, depth, radius, live, cfg: GSRasterConfig):
    """Each tile's candidates front to back: (cand (T, K) int64 gaussian
    ids, valid (T, K) bool)."""
    N, dev = uv.shape[0], uv.device
    ts = cfg.tile
    t0x = _tile_index(uv[:, 0] - radius, ts, cfg.tiles_x)
    t0y = _tile_index(uv[:, 1] - radius, ts, cfg.tiles_y)
    t1x = _tile_index(uv[:, 0] + radius, ts, cfg.tiles_x)
    t1y = _tile_index(uv[:, 1] + radius, ts, cfg.tiles_y)
    d = torch.arange(SPAN, device=dev)
    gx, gy = t0x[:, None] + d, t0y[:, None] + d              # (N, 3)
    ok = (gy <= t1y[:, None])[:, :, None] & (gx <= t1x[:, None])[:, None, :]
    ok = ok & live[:, None, None]
    tile_id = gy[:, :, None] * cfg.tiles_x + gx[:, None, :]   # (N, 3, 3)
    tile_keys = torch.where(ok, tile_id, cfg.num_tiles).reshape(-1)
    order = torch.argsort(depth, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(N, device=dev)
    key = tile_keys * N + rank.repeat_interleave(SPAN * SPAN)
    perm = torch.sort(key, stable=True).indices
    tile_of_key = tile_keys[perm]
    vals = perm // (SPAN * SPAN)
    tiles = torch.arange(cfg.num_tiles, device=dev)
    starts = torch.searchsorted(tile_of_key, tiles, right=False)
    ends = torch.searchsorted(tile_of_key, tiles, right=True)
    idx = starts[:, None] + torch.arange(cfg.k_per_tile, device=dev)
    valid = idx < ends[:, None]
    return vals[idx.clamp(0, vals.shape[0] - 1)], valid


def _scan_prod(x):
    """`torch.cumprod(x, -1)` as a log-step scan (log2 K shifted
    products)."""
    s = 1
    while s < x.shape[-1]:
        x = x * torch.nn.functional.pad(x[..., :-s], (s, 0), value=1.0)
        s *= 2
    return x


def _detile(x, cfg: GSRasterConfig):
    """(T, ts * ts, ...) -> (H, W, ...)."""
    ts, extra = cfg.tile, x.shape[2:]
    x = x.reshape(cfg.tiles_y, cfg.tiles_x, ts, ts, *extra).transpose(1, 2)
    return x.reshape(cfg.tiles_y * ts, cfg.tiles_x * ts, *extra)[
        :cfg.height, :cfg.width]


def render_gaussians(means, scales, quats, colors, opacities, pose_w2c,
                     intrinsics, cfg: GSRasterConfig, bg_color=1.0):
    """Render one view.

    means (N, 3), scales (N, 3), quats (N, 4) wxyz, colors (N, 3) in [0, 1],
    opacities (N,) in [0, 1]; pose_w2c (3, 4); intrinsics (4,) fx fy cx cy.
    Returns {"rgb" (H, W, 3), "alpha" (H, W), "depth" (H, W)}, differentiable
    w.r.t. the five gaussian attributes.
    """
    uv, depth, cov2d, radius = project_gaussians(
        means, scales, quats, pose_w2c, intrinsics, cfg)
    live = (depth > cfg.near) & (opacities > cfg.opacity_thr)
    cand, valid = bin_gaussians(uv.detach(), depth.detach(),
                                radius.detach(), live, cfg)

    # the closed-form inverse; the reference reads ic[0, 1] only
    a, b = cov2d[:, 0, 0], cov2d[:, 0, 1]
    c, d = cov2d[:, 1, 0], cov2d[:, 1, 1]
    det = a * d - b * c
    table = torch.cat([uv, torch.stack([d / det, -b / det, a / det], -1),
                       opacities[:, None], colors, depth[:, None]], -1)
    g = gather_rows(table, cand)                          # (T, K, 10)
    ts, dev = cfg.tile, means.device
    tiles = torch.arange(cfg.num_tiles, device=dev)
    ar = torch.arange(ts, device=dev, dtype=means.dtype) + 0.5
    px = (tiles % cfg.tiles_x)[:, None] * ts + ar            # (T, ts)
    py = (tiles // cfg.tiles_x)[:, None] * ts + ar
    # pixel p = y * ts + x of each tile: (T, P, 1)
    qx = px[:, None, :].expand(-1, ts, -1).reshape(-1, ts * ts, 1)
    qy = py[:, :, None].expand(-1, -1, ts).reshape(-1, ts * ts, 1)
    d0 = qx - g[:, None, :, 0]                                # (T, P, K)
    d1 = qy - g[:, None, :, 1]
    power = -0.5 * (d0 ** 2 * g[:, None, :, 2]
                    + 2 * d0 * d1 * g[:, None, :, 3]
                    + d1 ** 2 * g[:, None, :, 4])
    alpha_k = clip(g[:, None, :, 5] * torch.exp(power), 0.0, 0.999)
    alpha_k = alpha_k * valid[:, None, :].to(alpha_k.dtype)
    alpha_k = torch.where(alpha_k > (1.0 / 255.0), alpha_k,
                          torch.zeros((), dtype=alpha_k.dtype, device=dev))
    keep = 1.0 - alpha_k + 1e-10
    w = alpha_k * (_scan_prod(keep) / keep)
    rgb = torch.bmm(w, g[..., 6:9])                            # (T, P, 3)
    alpha = w.sum(-1)
    dep = torch.bmm(w, g[..., 9:10])[..., 0]
    rgb, alpha, dep = (_detile(x, cfg) for x in (rgb, alpha, dep))
    rgb = rgb + bg_color * (1 - alpha[..., None])
    return {"rgb": rgb, "alpha": alpha, "depth": dep}
