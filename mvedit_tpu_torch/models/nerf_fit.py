"""NeRF reconstruction inner loop (counterpart of
`mvedit_tpu/models/nerf_fit.py`).

One step: sample a patch of rays from a camera drawn among the views with
weight > 0 -> march / composite -> Lambertian shading in tonemapped log2
space with normals from the rendered inverse depth -> weighted L1 + alpha +
normal TV + entropy (+ depth, + LPIPS) -> Adam (b1 0.9, b2 0.99, eps 1e-15,
lr from the schedule) -> at every `update_extra_interval`-th step of a
`fit` call (its first included), the occupancy-grid refresh.

The random draws are inputs: `fit` takes, per step, the camera ids and
patch origins, the stratified jitter of the rays and the jitter of each
grid refresh (`draws=`), or draws them from a `torch.Generator`
(`fit.draw`). The MVEdit pipeline calls `fit` in chunks of
`fit_steps_per_program` steps, so the grid is refreshed at the first step
of every chunk, as in the reference, whose chained programs restart their
step counter.
"""
from dataclasses import dataclass
from functools import partial
from typing import Callable

import torch

from ..ops.clip import clip
from ..ops.image import erode, gaussian_blur, highpass
from ..ops.tonemapping import Tonemapping
from ..utils.geometry import depth_to_normal, get_ray_directions, get_rays
from ..parallel import sharded as P
from . import losses as L
from .fields import field_leaves
from .volume_renderer import (OccupancyGrid, RenderConfig, render_rays,
                              update_density_grid)

__all__ = ["NerfFitConfig", "make_nerf_fit", "make_image_renderer",
           "make_multiview_renderer", "render_image",
           "default_schedule_weights"]


@dataclass(frozen=True)
class NerfFitConfig:
    render: RenderConfig
    patch_size: int = 128
    patch_bs: int = 1
    lr: float = 0.01
    n_steps: int = 80
    update_extra_interval: int = 16
    pixel_rgb_weight: float = 4.5
    alpha_weight: float = 1.0
    alpha_soften: float = 0.001
    alpha_blur_std: float = 1.5
    normal_reg_weight: float = 4.0
    patch_rgb_weight: float = 0.0       # LPIPS weight (needs lpips params)
    patch_normal_weight: float = 0.0
    entropy_weight: float = 0.0
    depth_weight: float = 0.0
    bg_width: float = 0.125
    ambient_light: float = 0.3
    shaded: bool = True
    bg_color: float = 1.0
    normal_bg: tuple = (0.5, 0.5, 1.0)


def _soften_masks(masks, cfg: NerfFitConfig):
    """Blur + clamp the target alpha masks."""
    m2 = masks[..., 0] ** 2
    if cfg.alpha_blur_std > 0:
        m2 = gaussian_blur(m2, cfg.alpha_blur_std)
    s = cfg.alpha_soften
    return torch.sqrt(m2.clamp(s ** 2, (1 - s) ** 2))[..., None]


def _sample_patch(tgt, cfg: NerfFitConfig, render_size, cam_ids, oy, ox):
    """The patches of cameras `cam_ids` (B,) at origins (oy, ox) (B,):
    target pixels and world rays."""
    ps = cfg.patch_size
    ar = torch.arange(ps, device=cam_ids.device)
    rows = (oy[:, None] + ar)[:, :, None]                  # (B, ps, 1)
    cols = (ox[:, None] + ar)[:, None, :]                  # (B, 1, ps)
    cid = cam_ids[:, None, None]

    def gather(img4):                                      # (N, H, W, C)
        return img4[cid, rows, cols]
    out = {"cam_ids": cam_ids, "rgb": gather(tgt["images"]),
           "mask": gather(tgt["masks_soft"])}
    if "normals" in tgt:
        out["normal"] = gather(tgt["normals"])
    if "depths" in tgt:
        out["depth"] = gather(tgt["depths"])
    intr = tgt["intrinsics"][cam_ids]                      # (B, 4)
    # the patch's part of the full-frame directions (pixel centres + 0.5)
    x = (ox[:, None] + ar).to(intr.dtype) + 0.5
    y = (oy[:, None] + ar).to(intr.dtype) + 0.5
    dx = ((x - intr[:, 2:3]) / intr[:, 0:1])[:, None, :].expand(-1, ps, ps)
    dy = ((y - intr[:, 3:4]) / intr[:, 1:2])[:, :, None].expand(-1, ps, ps)
    dirs = torch.stack([dx, dy, torch.ones_like(dx)], -1)
    rays_o, rays_d = get_rays(dirs, tgt["poses"][cam_ids], norm=True)
    out.update(dirs=dirs, rays_o=rays_o, rays_d=rays_d,
               cam_weight=tgt["cam_weights"][cam_ids],
               cam_light=tgt["cam_lights"][cam_ids])
    if "normal_weights" in tgt:
        out["normal_weight"] = tgt["normal_weights"][cam_ids]
    return out


def _shade(rgb, alpha, normal_fg, light, tm: Tonemapping, cfg: NerfFitConfig):
    """Lambertian shading composed in tonemapped log2 space. normal_fg in
    [0, 1], OpenGL convention."""
    n_opencv = torch.cat([normal_fg[..., :1] * 2 - 1,
                          -normal_fg[..., 1:3] * 2 + 1], -1)
    lam = clip((light[:, None, None, :] * n_opencv).sum(-1, keepdim=True), 0.0)
    shading = lam * (1 - cfg.ambient_light) + cfg.ambient_light
    shaded = tm.lut(tm.inverse_lut(rgb / clip(alpha, 1e-6))
                    + torch.log2(clip(shading, 1e-6)))
    return shaded * alpha + cfg.bg_color * (1 - alpha)


def default_schedule_weights(cfg: NerfFitConfig):
    return {"lr": cfg.lr, "entropy": cfg.entropy_weight,
            "patch_rgb": cfg.patch_rgb_weight,
            "patch_normal": cfg.patch_normal_weight,
            "normal_reg": cfg.normal_reg_weight}


def make_nerf_fit(point_decode_fn: Callable, cfg: NerfFitConfig,
                  render_size: int, use_lpips: bool = False, mesh=None):
    """Build `fit(params, opt, grid, targets, sched=None, lpips_params=None,
    draws=None, generator=None) -> (params, opt, grid, {"loss": (n_steps,)})`
    and `make_optimizer(params)`.

    point_decode_fn(params, xyz) -> (sigma, rgb). params is the field's
    dict of tensors, updated in place. targets: images (N, H, W, 3), masks
    (N, H, W, 1), poses (N, 3, 4), intrinsics (N, 4) at `render_size`,
    cam_weights (N,), cam_lights (N, 3) [+ normals, depths,
    normal_weights]. draws: {"cam_ids", "oy", "ox": (n_steps, patch_bs),
    "jitter": (n_steps, rays, samples), "grid_jitter": (refreshes, G, G,
    G, 3)}, see `fit.draw`.

    mesh: a `parallel.make_mesh` DeviceMesh. Each rank then renders its
    slice of the step's rays (the draws are the whole step's on every
    rank), the ray outputs are gathered back, every rank computes the
    whole loss, and the gradients are all-reduced (`parallel.sharded`).
    """
    tm = Tonemapping()
    refresh_steps = list(range(0, cfg.n_steps, cfg.update_extra_interval))

    def make_optimizer(params):
        leaves = field_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        return torch.optim.Adam(leaves, lr=cfg.lr, betas=(0.9, 0.99),
                                eps=1e-15)

    def loss_fn(params, grid, patch, jitter, sw, lpips_params):
        B, ps = cfg.patch_bs, cfg.patch_size
        rays_o = patch["rays_o"].reshape(-1, 3)
        rays_d = patch["rays_d"].reshape(-1, 3)
        # rays that do not split evenly over the ranks run whole on each
        sharded = mesh is not None and rays_o.shape[0] % mesh.size() == 0
        if sharded:
            rays_o, rays_d, jitter = (None if x is None else P.shard(x, mesh)
                                      for x in (rays_o, rays_d, jitter))
        out = render_rays(partial(point_decode_fn, params), rays_o, rays_d,
                          cfg.render, grid=grid, jitter=jitter)
        if sharded:
            out = {k: P.all_gather_cat(out[k], mesh) for k in
                   ("rgb", "alpha", "inv_depth", "weights", "deltas")}
        rgb = out["rgb"].reshape(B, ps, ps, 3)
        alpha = out["alpha"].reshape(B, ps, ps, 1)
        inv_depth = out["inv_depth"].reshape(B, ps, ps)
        # 1/r -> 1/z, then normals from the depth
        inv_z = inv_depth * torch.linalg.vector_norm(patch["dirs"], dim=-1)
        normal_fg = depth_to_normal(inv_z / clip(alpha[..., 0], 1e-6),
                                    patch["dirs"])
        cw = patch["cam_weight"]
        w = (cw / clip(cw.mean(), 1e-6))[:, None, None, None]
        if cfg.shaded:
            out_rgb = _shade(rgb, alpha, normal_fg, patch["cam_light"], tm,
                             cfg)
        else:
            out_rgb = rgb + cfg.bg_color * (1 - alpha)
        total = L.l1_loss(out_rgb, patch["rgb"], weight=w) \
            * cfg.pixel_rgb_weight
        total = total + L.l1_loss(alpha, patch["mask"], weight=w) \
            * cfg.alpha_weight
        # fg-eroded weight of the normal TV
        n_tv_w = erode(alpha[..., 0].detach(), 3)[:, None]
        tgt_n = patch.get("normal")
        nx = normal_fg.permute(0, 3, 1, 2)
        if tgt_n is not None and "normal_weight" in patch:
            nw = patch["normal_weight"][:, None, None, None]
            n_loss = (L.tv_loss(nx, tgt_n.permute(0, 3, 1, 2),
                                weight=n_tv_w * nw, power=1.5)
                      + L.tv_loss(nx, None, weight=n_tv_w * (1 - nw),
                                  power=1.5))
        else:
            n_loss = L.tv_loss(
                nx, None if tgt_n is None else tgt_n.permute(0, 3, 1, 2),
                weight=n_tv_w, power=1.5)
        total = total + n_loss * (sw["normal_reg"] * 10)
        total = total + L.entropy_loss(
            out["weights"], out["deltas"], out["alpha"], bg_width=cfg.bg_width,
            num_pixels=B * ps * ps) * sw["entropy"]
        if cfg.depth_weight > 0 and "depth" in patch:
            total = total + L.l1_loss(inv_z, patch["depth"],
                                      weight=w[..., 0]) * cfg.depth_weight
        if lpips_params is not None:
            total = total + L.lpips_apply(lpips_params, out_rgb, patch["rgb"],
                                          weight=cw) * sw["patch_rgb"]
            if tgt_n is not None:
                bg = torch.tensor(cfg.normal_bg, device=alpha.device)
                out_n = normal_fg * alpha + bg * (1 - alpha)

                def hp(im):
                    return highpass(im.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                pn_w = cw * patch["normal_weight"] \
                    if "normal_weight" in patch else cw
                total = total + L.lpips_apply(
                    lpips_params, hp(out_n), hp(tgt_n), weight=pn_w) \
                    * sw["patch_normal"]
        return total

    def draw(targets, n_steps, generator):
        """The draws of `n_steps` steps from `generator` (also `fit.draw`):
        camera ids by weight > 0, patch origins, ray jitter, grid jitter."""
        dev = targets["cam_weights"].device
        B, ps, S = cfg.patch_bs, cfg.patch_size, cfg.render.num_samples
        p = (targets["cam_weights"] > 0).float().clamp(min=1e-9)
        ids = torch.multinomial(p, n_steps * B, replacement=True,
                                generator=generator).reshape(n_steps, B)
        hi = render_size - ps + 1
        g = cfg.render.grid_size
        n_ref = len(range(0, n_steps, cfg.update_extra_interval))
        return {"cam_ids": ids,
                "oy": torch.randint(0, hi, (n_steps, B), generator=generator,
                                    device=dev),
                "ox": torch.randint(0, hi, (n_steps, B), generator=generator,
                                    device=dev),
                "jitter": torch.rand((n_steps, B * ps * ps, S),
                                     generator=generator, device=dev),
                "grid_jitter": torch.rand((n_ref, g, g, g, 3),
                                          generator=generator, device=dev)}

    def fit(params, opt, grid: OccupancyGrid, targets, sched=None,
            lpips_params=None, draws=None, generator=None):
        sw = default_schedule_weights(cfg) if sched is None else sched
        if draws is None:
            draws = draw(targets, cfg.n_steps, generator)
        targets = dict(targets)
        with torch.no_grad():
            targets["masks_soft"] = _soften_masks(targets["masks"], cfg)
        for g_ in opt.param_groups:
            g_["lr"] = float(sw["lr"])
        leaves = opt.param_groups[0]["params"]
        losses = []
        for s in range(cfg.n_steps):
            patch = _sample_patch(targets, cfg, render_size,
                                  draws["cam_ids"][s].long(),
                                  draws["oy"][s].long(), draws["ox"][s].long())
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(params, grid, patch, draws["jitter"][s], sw,
                           lpips_params if use_lpips else None)
            with L.deterministic_convs():
                loss.backward()
            for p in leaves:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if mesh is not None:
                P.all_reduce_mean_grads_(leaves, mesh)
            opt.step()
            losses.append(loss.detach())
            if s in refresh_steps:
                grid = update_density_grid(
                    lambda x: point_decode_fn(params, x)[0], grid, cfg.render,
                    jitter=draws["grid_jitter"][refresh_steps.index(s)])
        return params, opt, grid, {"loss": torch.stack(losses)}

    fit.draw = draw
    return fit, make_optimizer


def _frame(point_decode_fn, params, pose, intrinsics, grid, h, w, cfg_inf,
           chunk, bg_color):
    """One full frame in ray chunks of `chunk`."""
    dirs = get_ray_directions(h, w, intrinsics)
    rays_o, rays_d = get_rays(dirs, pose, norm=True)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    outs = [render_rays(partial(point_decode_fn, params),
                        rays_o[i:i + chunk], rays_d[i:i + chunk], cfg_inf,
                        grid=grid, bg_color=bg_color)
            for i in range(0, h * w, chunk)]
    cat = {k: torch.cat([o[k] for o in outs]) for k in
           ("rgb", "depth", "inv_depth", "alpha")}
    return {"rgb": cat["rgb"].reshape(h, w, 3),
            "depth": cat["depth"].reshape(h, w),
            "inv_depth": cat["inv_depth"].reshape(h, w),
            "alpha": cat["alpha"].reshape(h, w), "dirs": dirs}


def _inference_cfg(cfg: RenderConfig):
    return RenderConfig(**{**cfg.__dict__, "stratified": False})


def make_image_renderer(point_decode_fn, h, w, cfg: RenderConfig,
                        chunk=65536, bg_color=1.0, use_grid=True):
    """`render(params, pose (3, 4), intrinsics (4,), grid=None) -> dict` of
    one full frame: rgb (h, w, 3), depth, inv_depth, alpha (h, w), dirs."""
    cfg_inf = _inference_cfg(cfg)

    @torch.no_grad()
    def render(params, pose, intrinsics, grid=None):
        return _frame(point_decode_fn, params, pose, intrinsics,
                      grid if use_grid else None, h, w, cfg_inf, chunk,
                      bg_color)
    return render


def make_multiview_renderer(point_decode_fn, h, w, cfg: RenderConfig,
                            chunk=65536, bg_color=1.0, use_grid=True):
    """`render(params, poses (N, 3, 4), intrinsics (N, 4), grid=None)` ->
    the frames of `make_image_renderer` stacked over the N views, which
    are rendered one after another."""
    one = make_image_renderer(point_decode_fn, h, w, cfg, chunk, bg_color,
                              use_grid)

    def render(params, poses, intrinsics, grid=None):
        frames = [one(params, poses[i], intrinsics[i], grid)
                  for i in range(poses.shape[0])]
        return {k: torch.stack([f[k] for f in frames]) for k in frames[0]}
    return render


def render_image(point_decode_fn, params, pose, intrinsics, h, w,
                 cfg: RenderConfig, grid=None, chunk=65536, bg_color=1.0):
    return make_image_renderer(point_decode_fn, h, w, cfg, chunk, bg_color,
                               use_grid=grid is not None)(
        params, pose, intrinsics, grid)
