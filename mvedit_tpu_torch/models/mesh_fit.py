"""DMTet mesh optimisation inner loop and the texture refinement of the
decimated mesh (counterpart of `mvedit_tpu/models/mesh_fit.py`).

After progress 0.6 the 3D state is (DMTet sdf + per-vertex deform + the
albedo field). Each step: marching tets on the structured grid -> render
`render_bs` sampled views with Lambertian shading in tonemapped log space
-> pixel L1 + alpha L1 (+ normal TV, + patch LPIPS) + laplacian and
normal-consistency regularisers on a face subsample -> Adam on (field,
sdf, deform).

With `freeze_topology` the marching-tets topology is snapshotted at the
start of each `fit` call and only the vertex positions are re-lerped per
step; the pipeline calls `fit` in chunks of `fit_steps_per_program` steps,
so the topology is refreshed at the same steps as in the reference.

The random draws (the views of each step, the regulariser's face samples,
the LPIPS patch origins) are inputs: `fit` takes them as tensors, or draws
them from a `torch.Generator` when none are given. The unstructured
`TetGrid` path waits for its slice.
"""
import math
from dataclasses import dataclass

import torch

from ..ops.clip import clip
from ..ops.segment import gather_rows, segment_add
from ..ops.tonemapping import Tonemapping
from . import losses as L
from .fields import field_leaves
from .mesh.rasterize import RasterConfig
from .mesh.renderer import render_views
from .mesh.structured_tets import (StructuredTetGrid,
                                   marching_tets_structured,
                                   marching_tets_topology,
                                   marching_tets_verts)

__all__ = ["MeshFitConfig", "init_sdf_from_density", "laplacian_loss",
           "normal_consistency_loss", "make_mesh_fit", "make_texture_refine",
           "default_mesh_schedule_weights", "mesh_caps", "percentiles"]


@dataclass(frozen=True)
class MeshFitConfig:
    raster: RasterConfig
    lr: float = 0.01
    sdf_lr_scale: float = 0.04        # sdf / deform lr = lr * this
    n_steps: int = 80
    render_bs: int = 2
    reg_face_samples: int = 131072    # faces sampled per step for the
                                      # regularisers (0 = all)
    deform_scale: float = 0.5         # deform = tanh(raw) * scale * cell
    pixel_rgb_weight: float = 4.5
    alpha_weight: float = 1.0
    normal_reg_weight: float = 4.0
    patch_rgb_weight: float = 0.0     # patch LPIPS (scheduled)
    patch_normal_weight: float = 0.0
    patch_size: int = 128
    laplacian_weight: float = 0.25
    normal_consistency_weight: float = 0.25
    ambient_light: float = 0.3
    bg_color: float = 1.0
    shaded: bool = True
    ssaa: int = 1
    vert_cap: int = 0                 # 0: the default caps of `mesh_caps`
    face_cap: int = 0
    freeze_topology: bool = False


def default_mesh_schedule_weights(cfg: MeshFitConfig):
    return {"lr": cfg.lr, "sdf_lr_mult": 1.0,
            "normal_reg": cfg.normal_reg_weight,
            "patch_rgb": cfg.patch_rgb_weight,
            "patch_normal": cfg.patch_normal_weight}


def mesh_caps(resolution, vert_cap=0, face_cap=0):
    """(vert_cap, face_cap) of the extraction buffers: 1 << max(9,
    bitlen(16 g^2 - 1)) and 1.5x that (262144 / 393216 at tet 128)."""
    vc = vert_cap or (1 << max(9, (16 * resolution * resolution - 1)
                               .bit_length()))
    return vc, face_cap or vc + (vc >> 1)


def percentiles(x, qs):
    """`jnp.percentile(x, q)` (linear interpolation between the two
    bracketing order statistics) for each q in `qs`, from one sort of the
    flattened x. `torch.quantile` refuses inputs of more than 2^24
    elements, and the tet grid has 257^3 verts at resolution 256."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    out = []
    for q in qs:
        pos = q / 100.0 * (n - 1)
        lo = min(int(math.floor(pos)), n - 1)
        hi = min(lo + 1, n - 1)
        w = pos - lo
        out.append(s[lo] * (1.0 - w) + s[hi] * w)
    return out


@torch.no_grad()
def init_sdf_from_density(density_fn, grid: StructuredTetGrid, thresh=5.0,
                          scale=0.05, adaptive=True, device=None):
    """sdf0 at the lattice verts from a density field: positive inside
    (density > thresh). `adaptive` clamps the threshold below the field's
    95th percentile, and falls back to the 70th percentile when nearly all
    or nearly no verts start inside, so the initial surface has crossings."""
    sigma = density_fn(torch.as_tensor(grid.verts, device=device))
    thresh = torch.tensor(thresh, dtype=sigma.dtype, device=sigma.device)
    p70, p95 = percentiles(sigma, (70.0, 95.0))
    if adaptive:
        thresh = torch.minimum(thresh, p95 * 0.5)
        pos_frac = (sigma > thresh).to(sigma.dtype).mean()
        thresh = torch.where(pos_frac > 0.95, p70, thresh)
    pos_frac = (sigma > thresh).to(sigma.dtype).mean()
    thresh = torch.where(pos_frac < 0.02, p70, thresh)
    return ((sigma - thresh) * scale).clamp(-1.0, 1.0)


def normal_consistency_loss(verts, faces, face_mask):
    """Mean (1 - cos) between each face normal and the mean face normal of
    its three vertices (a static-shape stand-in for edge-paired normal
    consistency)."""
    faces = faces.long()
    v0, v1, v2 = (gather_rows(verts, faces[:, i]) for i in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    # rsqrt(sumsq + eps), not x / clip(norm): masked degenerate faces would
    # otherwise NaN the sdf / deform gradient
    fn = fn * torch.rsqrt((fn * fn).sum(-1, keepdim=True) + 1e-20)
    w = face_mask.to(verts.dtype)
    V = verts.shape[0]
    # the corners of column 0, then 1, then 2: the order of three
    # sequential index_adds, kept by the fixed-order sum
    tgt = faces.t().reshape(-1)
    fw = (fn * w[:, None]).repeat(3, 1)
    vsum = segment_add(tgt, torch.cat([fw, w.repeat(3)[:, None]], 1), V)
    vsum, deg = vsum[:, :3].to(verts.dtype), vsum[:, 3].to(verts.dtype)
    vn = vsum / deg[:, None].clamp(min=1.0)
    vn = vn * torch.rsqrt((vn * vn).sum(-1, keepdim=True) + 1e-20)
    cos = sum((fn * gather_rows(vn, faces[:, i])).sum(-1)
              for i in range(3)) / 3
    return ((1.0 - cos) * w).sum() / w.sum().clamp(min=1.0)


def laplacian_loss(verts, faces, face_mask, vert_mask):
    """Uniform Laplacian smoothing over the extracted mesh: neighbour sums
    accumulated from the (masked) face buffer."""
    faces = faces.long()
    w = face_mask.to(verts.dtype)[:, None]
    # each edge (a, b) adds b's position to a and a's to b, edges in the
    # order of six sequential index_adds, kept by the fixed-order sum
    tgt, src = [], []
    for a, b in ((0, 1), (1, 2), (2, 0)):
        tgt += [faces[:, a], faces[:, b]]
        src += [faces[:, b], faces[:, a]]
    tgt, src = torch.cat(tgt), torch.cat(src)
    ws = w.repeat(6, 1)
    acc = segment_add(tgt, torch.cat([gather_rows(verts, src) * ws, ws], 1),
                      verts.shape[0])
    nsum, deg = acc[:, :3].to(verts.dtype), acc[:, 3].to(verts.dtype)
    lap = verts - nsum / deg[:, None].clamp(min=1.0)
    m = (vert_mask & (deg > 0)).to(verts.dtype)
    # sqrt(sumsq + eps): the plain norm's gradient is NaN at lap == 0
    lap_mag = torch.sqrt((lap * lap).sum(-1) + 1e-20)
    return (lap_mag * m).sum() / m.sum().clamp(min=1.0)


def _shade(out, batch, cfg: MeshFitConfig, tm: Tonemapping):
    """Lambertian shading of the rendered albedo in tonemapped log space,
    composited on the background."""
    alpha, albedo = out["alpha"], out["rgb"]
    if not cfg.shaded:
        return albedo
    lam = clip((batch["cam_lights"][:, None, None, :] * out["normal"]).sum(
        -1, keepdim=True), 0.0)
    shading = lam * (1 - cfg.ambient_light) + cfg.ambient_light
    fg = clip((albedo - cfg.bg_color * (1 - alpha)) / clip(alpha, 1e-6),
              1e-4, 1.0)
    rgb = tm.lut(tm.inverse_lut(fg) + torch.log2(clip(shading, 1e-6)))
    return rgb * alpha + cfg.bg_color * (1 - alpha)


def _crop(img, oy, ox, ps):
    """(B, H, W, C) -> (B, ps, ps, C) windows at (oy, ox) (B,), through
    `gather_rows` (its backward is an index_add)."""
    B, H, W, C = img.shape
    ar = torch.arange(ps, device=img.device)
    b = torch.arange(B, device=img.device)[:, None, None]
    idx = (b * H + (oy[:, None] + ar)[:, :, None]) * W \
        + (ox[:, None] + ar)[:, None, :]
    return gather_rows(img.reshape(-1, C), idx)


def _patch_lpips(lpips_params, cfg: MeshFitConfig, rgb, batch, oy, ox):
    """LPIPS of a ps x ps window of each rendered view against its target,
    weighted by the views' cam weights."""
    ps = min(cfg.patch_size, cfg.raster.height)
    return L.lpips_apply(lpips_params, _crop(rgb, oy, ox, ps),
                         _crop(batch["rgb"], oy, ox, ps),
                         weight=batch["cam_weight"])


def _draw_views(targets, cfg: MeshFitConfig, n_steps, generator):
    """Each step's view ids (categorical over cam_weights > 0) and LPIPS
    window origins."""
    dev = targets["cam_weights"].device
    p = (targets["cam_weights"] > 0).float().clamp(min=1e-9)
    ids = torch.multinomial(p, n_steps * cfg.render_bs, replacement=True,
                            generator=generator).reshape(n_steps, -1)
    hi = cfg.raster.height - min(cfg.patch_size, cfg.raster.height) + 1
    wi = cfg.raster.width - min(cfg.patch_size, cfg.raster.height) + 1
    shape = (n_steps, cfg.render_bs)
    return {"view_ids": ids,
            "patch_oy": torch.randint(0, hi, shape, generator=generator,
                                      device=dev),
            "patch_ox": torch.randint(0, wi, shape, generator=generator,
                                      device=dev)}


def make_mesh_fit(grid: StructuredTetGrid, color_fn, cfg: MeshFitConfig):
    """Build `fit(state, opt, targets, sched=None, draws=None,
    generator=None, lpips_params=None)`, `make_optimizer(state)` and
    `extract(state)`.

    state: {"field": field params, "sdf": (V,), "deform": (V, 3) raw}
    tensors, updated in place. color_fn(field, xyz) -> rgb in [0, 1].
    targets: images (N, H, W, 3), masks (N, H, W, 1), poses (N, 3, 4),
    intrinsics (N, 4), cam_weights (N,), cam_lights (N, 3) [+ normals,
    normal_weights]. draws: {"view_ids", "patch_oy", "patch_ox":
    (n_steps, render_bs), "reg_faces": (n_steps, reg_face_samples)} index
    tensors (the patch origins are read when `lpips_params` is given).
    fit returns (state, opt, {"loss": (n_steps,), "mt": extraction of the
    final state}).
    """
    if not isinstance(grid, StructuredTetGrid):
        raise NotImplementedError("only the structured tet grid is ported")
    tm = Tonemapping()
    cell = 2.0 / grid.resolution
    vert_cap, face_cap = mesh_caps(grid.resolution, cfg.vert_cap,
                                   cfg.face_cap)
    subsample = bool(cfg.reg_face_samples) and cfg.reg_face_samples < face_cap

    def _deform(state):
        return torch.tanh(state["deform"]) * (cfg.deform_scale * cell)

    @torch.no_grad()
    def extract(state):
        sdf = state["sdf"].detach()
        return marching_tets_structured(
            grid, grid.arrays(sdf.device), sdf,
            deform=_deform(state).detach(), vert_cap=vert_cap,
            face_cap=face_cap)

    def make_optimizer(state):
        """Adam(b1 0.9, b2 0.99, eps 1e-15) with two groups, the field and
        (sdf, deform); `fit` sets their lr from the schedule each step."""
        for p in field_leaves(state["field"]) + [state["sdf"],
                                                 state["deform"]]:
            p.requires_grad_(True)
        return torch.optim.Adam(
            [{"params": field_leaves(state["field"])},
             {"params": [state["sdf"], state["deform"]]}],
            lr=cfg.lr, betas=(0.9, 0.99), eps=1e-15)

    def loss_fn(state, batch, reg_ids, sw, topo, lpips_params=None,
                crop=None):
        if topo is not None:
            mt = dict(topo)
            mt["verts"] = marching_tets_verts(grid, topo, state["sdf"],
                                              deform=_deform(state))
        else:
            mt = marching_tets_structured(
                grid, grid.arrays(state["sdf"].device), state["sdf"],
                deform=_deform(state), vert_cap=vert_cap, face_cap=face_cap)
        if reg_ids is not None:
            reg_faces, reg_mask = mt["faces"][reg_ids], mt["face_mask"][reg_ids]
        else:
            reg_faces, reg_mask = mt["faces"], mt["face_mask"]

        def shading_fun(xyz, normal, view_dir):
            return color_fn(state["field"], xyz)

        out = render_views(mt["verts"], mt["faces"], mt["face_mask"],
                           batch["poses"], batch["intrinsics"], cfg.raster,
                           shading_fun=shading_fun, ssaa=cfg.ssaa,
                           bg_color=cfg.bg_color)
        alpha, n_img = out["alpha"], out["normal"]
        rgb = _shade(out, batch, cfg, tm)
        cw = batch["cam_weight"]
        w = (cw / clip(cw.mean(), 1e-6))[:, None, None, None]
        total = L.l1_loss(rgb, batch["rgb"], weight=w) * cfg.pixel_rgb_weight
        total = total + L.l1_loss(alpha, batch["mask"], weight=w) \
            * cfg.alpha_weight
        if "normal" in batch:
            nx = n_img.permute(0, 3, 1, 2)
            nt = batch["normal"].permute(0, 3, 1, 2) * 2 - 1
            if "normal_weight" in batch:
                nw = torch.broadcast_to(
                    batch["normal_weight"][:, None, None, None], nx.shape)
                n_loss = (L.tv_loss(nx, nt, weight=nw, power=1.5)
                          + L.tv_loss(nx, None, weight=1 - nw, power=1.5))
            else:
                n_loss = L.tv_loss(nx, nt, power=1.5)
            total = total + n_loss * sw["normal_reg"]
        if lpips_params is not None:
            total = total + _patch_lpips(lpips_params, cfg, rgb, batch,
                                         *crop) * sw["patch_rgb"]
        total = total + laplacian_loss(mt["verts"], reg_faces, reg_mask,
                                       mt["vert_mask"]) * cfg.laplacian_weight
        if cfg.normal_consistency_weight > 0:
            total = total + normal_consistency_loss(
                mt["verts"], reg_faces, reg_mask) \
                * cfg.normal_consistency_weight
        return total

    def draw(targets, n_steps, generator):
        """`fit`'s draws for n_steps from `generator` (also `fit.draw`)."""
        out = _draw_views(targets, cfg, n_steps, generator)
        if subsample:
            out["reg_faces"] = torch.randint(
                0, face_cap, (n_steps, cfg.reg_face_samples),
                generator=generator, device=targets["cam_weights"].device)
        return out

    def fit(state, opt, targets, sched=None, draws=None, generator=None,
            lpips_params=None):
        sw = default_mesh_schedule_weights(cfg) if sched is None else sched
        if draws is None:
            draws = draw(targets, cfg.n_steps, generator)
        topo = None
        if cfg.freeze_topology:
            sdf = state["sdf"].detach()
            topo = marching_tets_topology(grid, grid.arrays(sdf.device), sdf,
                                          vert_cap=vert_cap,
                                          face_cap=face_cap)
        lr = float(sw["lr"])
        opt.param_groups[0]["lr"] = lr
        opt.param_groups[1]["lr"] = lr * cfg.sdf_lr_scale * float(
            sw["sdf_lr_mult"])
        params = [p for g in opt.param_groups for p in g["params"]]
        losses = []
        for s in range(cfg.n_steps):
            ids = draws["view_ids"][s].long()
            batch = {"poses": targets["poses"][ids],
                     "intrinsics": targets["intrinsics"][ids],
                     "rgb": targets["images"][ids],
                     "mask": targets["masks"][ids],
                     "cam_weight": targets["cam_weights"][ids],
                     "cam_lights": targets["cam_lights"][ids]}
            if "normals" in targets:
                batch["normal"] = targets["normals"][ids]
                if "normal_weights" in targets:
                    batch["normal_weight"] = targets["normal_weights"][ids]
            reg_ids = draws["reg_faces"][s].long() if subsample else None
            opt.zero_grad(set_to_none=True)
            crop = None if lpips_params is None else (
                draws["patch_oy"][s].long(), draws["patch_ox"][s].long())
            loss = loss_fn(state, batch, reg_ids, sw, topo, lpips_params,
                           crop)
            with L.deterministic_convs():
                loss.backward()
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            opt.step()
            losses.append(loss.detach())
        return state, opt, {"loss": torch.stack(losses), "mt": extract(state)}

    fit.draw = draw
    return fit, make_optimizer, extract


def make_texture_refine(color_fn, cfg: MeshFitConfig, n_steps: int = 24):
    """Texture-only refinement on a fixed (decimated) mesh: only the albedo
    field keeps optimising. Returns `refine(field, opt, verts, faces,
    targets, sched=None, lpips_params=None, draws=None, generator=None) ->
    (field, opt, losses (n_steps,))` and `make_optimizer(field)`; draws as
    `make_mesh_fit`'s without "reg_faces" (`refine.draw`)."""
    tm = Tonemapping()

    def make_optimizer(field):
        leaves = field_leaves(field)
        for p in leaves:
            p.requires_grad_(True)
        return torch.optim.Adam(leaves, lr=cfg.lr, betas=(0.9, 0.99),
                                eps=1e-15)

    def loss_fn(field, batch, verts, faces, fmask, sw, lpips_params, crop):
        def shading_fun(xyz, normal, view_dir):
            return color_fn(field, xyz)

        out = render_views(verts, faces, fmask, batch["poses"],
                           batch["intrinsics"], cfg.raster,
                           shading_fun=shading_fun, ssaa=cfg.ssaa,
                           bg_color=cfg.bg_color)
        rgb = _shade(out, batch, cfg, tm)
        cw = batch["cam_weight"]
        w = (cw / clip(cw.mean(), 1e-6))[:, None, None, None]
        total = L.l1_loss(rgb, batch["rgb"], weight=w) * cfg.pixel_rgb_weight
        if lpips_params is not None:
            total = total + _patch_lpips(lpips_params, cfg, rgb, batch,
                                         *crop) * sw["patch_rgb"]
        return total

    def draw(targets, n_steps, generator):
        return _draw_views(targets, cfg, n_steps, generator)

    def refine(field, opt, verts, faces, targets, sched=None,
               lpips_params=None, draws=None, generator=None):
        sw = default_mesh_schedule_weights(cfg) if sched is None else sched
        if draws is None:
            draws = draw(targets, n_steps, generator)
        fmask = torch.ones(faces.shape[0], dtype=torch.bool,
                           device=faces.device)
        for g in opt.param_groups:
            g["lr"] = float(sw["lr"])
        leaves = opt.param_groups[0]["params"]
        losses = []
        for s in range(n_steps):
            ids = draws["view_ids"][s].long()
            batch = {"poses": targets["poses"][ids],
                     "intrinsics": targets["intrinsics"][ids],
                     "rgb": targets["images"][ids],
                     "cam_weight": targets["cam_weights"][ids],
                     "cam_lights": targets["cam_lights"][ids]}
            crop = None if lpips_params is None else (
                draws["patch_oy"][s].long(), draws["patch_ox"][s].long())
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(field, batch, verts, faces, fmask, sw,
                           lpips_params, crop)
            with L.deterministic_convs():
                loss.backward()
            for p in leaves:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            opt.step()
            losses.append(loss.detach())
        return field, opt, torch.stack(losses)

    refine.draw, refine.cfg = draw, cfg
    return refine, make_optimizer
