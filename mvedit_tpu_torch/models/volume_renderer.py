"""Fixed-step volume renderer with masked compositing (counterpart of
`mvedit_tpu/models/volume_renderer.py`).

Every ray gets the same sample count; occupancy and early termination are
masks:
- `ray_aabb`: near / far against [-bound, bound]^3;
- `tighten_interval`: the occupied span of each ray, from 64 occupancy
  probes;
- `sample_rays`: stratified samples in [near, far]; the jitter is an input
  (`jitter`, uniform in [0, 1) of shape (R, S)), None for bin centres;
- `composite`: front-to-back compositing with the exclusive transmittance
  taken as exp of a log-space cumsum with a 1e-10 clip, the reference's
  formula (its gradient differs from `torch.cumprod`'s where an alpha
  nears 1);
- `OccupancyGrid` / `update_density_grid`: the EMA density grid, refreshed
  at (optionally jittered) cell centres; the jitter is an input too.
"""
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops.clip import clip

__all__ = ["RenderConfig", "OccupancyGrid", "ray_aabb", "sample_rays",
           "composite", "render_rays", "update_density_grid",
           "occupancy_at", "tighten_interval"]


@dataclass(frozen=True)
class RenderConfig:
    num_samples: int = 128        # fixed samples per ray
    bound: float = 1.0            # AABB = [-bound, bound]^3
    grid_size: int = 128          # occupancy grid resolution
    density_thresh: float = 0.01  # occupancy threshold
    decay: float = 0.95           # EMA decay of the grid update
    t_thresh: float = 1e-4        # transmittance early stop, as a mask
    stratified: bool = True
    white_bkgd: bool = False


class OccupancyGrid(NamedTuple):
    density: torch.Tensor         # (G, G, G) float32 EMA of sigma
    occ: torch.Tensor             # (G, G, G) bool

    @classmethod
    def create(cls, grid_size, device=None):
        return cls(density=torch.zeros((grid_size,) * 3, device=device),
                   occ=torch.ones((grid_size,) * 3, dtype=torch.bool,
                                  device=device))


def ray_aabb(rays_o, rays_d, bound, min_near=0.05):
    """Slab test against [-bound, bound]^3 -> (near, far); far < near where
    the ray misses."""
    tiny = torch.where(rays_d >= 0, 1e-9, -1e-9).to(rays_d.dtype)
    inv_d = 1.0 / torch.where(rays_d.abs() < 1e-9, tiny, rays_d)
    t0 = (-bound - rays_o) * inv_d
    t1 = (bound - rays_o) * inv_d
    tmin = torch.minimum(t0, t1).amax(-1)
    tmax = torch.maximum(t0, t1).amin(-1)
    return clip(tmin, min_near), tmax


def occupancy_at(grid: OccupancyGrid, xyz, bound):
    """Nearest-cell occupancy of (..., 3) world points."""
    g = grid.occ.shape[0]
    idx = ((xyz + bound) / (2 * bound) * g).to(torch.int32).clamp(0, g - 1)
    idx = idx.long()
    return grid.occ.reshape(-1)[(idx[..., 0] * g + idx[..., 1]) * g
                                + idx[..., 2]]


def tighten_interval(rays_o, rays_d, near, far, grid: OccupancyGrid, bound,
                     probe_samples=64):
    """Shrink [near, far] to each ray's occupied span from occupancy
    probes (no field evaluations). Returns (near, far, any_occupied)."""
    P = probe_samples
    u = (torch.arange(P, dtype=rays_o.dtype, device=rays_o.device) + 0.5) / P
    ts = near[..., None] + (far - near)[..., None] * u
    occ = occupancy_at(grid, rays_o[..., None, :]
                       + rays_d[..., None, :] * ts[..., None], bound)
    any_occ = occ.any(-1)
    occ_i = occ.to(torch.uint8)
    first = occ_i.argmax(-1)
    last = P - 1 - occ_i.flip(-1).argmax(-1)
    step = (far - near) / P
    t0 = near + (first - 1).clamp(min=0) * step
    t1 = near + (last + 2).clamp(max=P) * step
    return (torch.where(any_occ, t0, near),
            torch.where(any_occ, t1, near + 1e-3), any_occ)


def sample_rays(rays_o, rays_d, cfg: RenderConfig, jitter=None, grid=None):
    """Fixed-count samples per ray, on the occupancy grid's support when
    `grid` is given. jitter: (R, S) uniform in [0, 1) for stratified
    samples (used when cfg.stratified), or None for bin centres.
    Returns (xyz (R, S, 3), ts (R, S), deltas (R, S), valid (R, S))."""
    near, far = ray_aabb(rays_o, rays_d, cfg.bound)
    hit = far > near
    far = torch.where(hit, far, near + 1e-3)
    if grid is not None:
        near, far, any_occ = tighten_interval(rays_o, rays_d, near, far,
                                              grid, cfg.bound)
        hit = hit & any_occ
    S = cfg.num_samples
    ar = torch.arange(S, dtype=rays_o.dtype, device=rays_o.device)
    if cfg.stratified and jitter is not None:
        u = (ar[None] + jitter) / S
    else:
        u = (ar + 0.5) / S
    ts = near[..., None] + (far - near)[..., None] * u
    last = ts[..., -1:] + (far - near)[..., None] / S
    deltas = torch.diff(ts, dim=-1, append=last)
    xyz = rays_o[..., None, :] + rays_d[..., None, :] * ts[..., None]
    valid = hit[..., None].expand(ts.shape)
    return xyz, ts, deltas, valid


def composite(sigmas, rgbs, ts, deltas, valid, cfg: RenderConfig,
              bg_color=None):
    """Front-to-back compositing with the early stop as a mask.

    sigmas (R, S), rgbs (R, S, 3). Returns rgb (R, 3), depth, inv_depth,
    alpha (R,), weights, trans, deltas (R, S)."""
    sigmas = torch.where(valid, sigmas, torch.zeros((), dtype=sigmas.dtype,
                                                    device=sigmas.device))
    alpha = 1.0 - torch.exp(-sigmas * deltas)
    # exclusive cumprod of (1 - alpha) through a log-space cumsum
    log_t = torch.cumsum(torch.log(clip(1.0 - alpha, 1e-10)), -1)
    trans = torch.exp(torch.cat([torch.zeros_like(log_t[..., :1]),
                                 log_t[..., :-1]], -1))
    live = trans > cfg.t_thresh
    weights = alpha * trans * live.to(alpha.dtype)
    rgb = (weights[..., None] * rgbs).sum(-2)
    depth = (weights * ts).sum(-1)
    # inverse-distance depth sum(w / t), as the reference's composite
    inv_depth = (weights / clip(ts, 1e-6)).sum(-1)
    acc = weights.sum(-1)
    if bg_color is None and cfg.white_bkgd:
        bg_color = 1.0
    if bg_color is not None:
        rgb = rgb + (1.0 - acc[..., None]) * bg_color
    return {"rgb": rgb, "depth": depth, "inv_depth": inv_depth, "alpha": acc,
            "weights": weights, "trans": trans, "deltas": deltas}


def render_rays(point_decode_fn, rays_o, rays_d, cfg: RenderConfig,
                grid: OccupancyGrid = None, jitter=None, bg_color=None):
    """March + decode + composite for (R, 3) rays.
    point_decode_fn(xyz) -> (sigma, rgb)."""
    xyz, ts, deltas, valid = sample_rays(rays_o, rays_d, cfg, jitter,
                                         grid=grid)
    if grid is not None:
        valid = valid & occupancy_at(grid, xyz, cfg.bound)
    sigmas, rgbs = point_decode_fn(xyz)
    return composite(sigmas, rgbs, ts, deltas, valid, cfg, bg_color)


@torch.no_grad()
def update_density_grid(density_fn, grid: OccupancyGrid, cfg: RenderConfig,
                        jitter=None):
    """EMA-update the density grid from the field at the cell centres,
    each moved by (jitter - 0.5) / G when `jitter` ((G, G, G, 3) uniform in
    [0, 1)) is given, then re-threshold the occupancy at
    min(mean(density), density_thresh)."""
    g = cfg.grid_size
    dev = grid.density.device
    ar = torch.arange(g, device=dev, dtype=torch.float32)
    centers = (torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), -1)
               + 0.5) / g
    if jitter is not None:
        centers = centers + (jitter - 0.5) / g
    xyz = centers * (2 * cfg.bound) - cfg.bound
    sigmas = density_fn(xyz.reshape(-1, 3)).reshape(g, g, g)
    new_density = torch.maximum(grid.density * cfg.decay, sigmas)
    thresh = torch.minimum(new_density.mean(),
                           torch.tensor(cfg.density_thresh, device=dev))
    return OccupancyGrid(density=new_density, occ=new_density > thresh)
