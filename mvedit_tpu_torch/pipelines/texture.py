"""Re-texturing pipeline: the geometry is frozen, only an albedo field is
fitted.

Counterpart of `mvedit_tpu/pipelines/texture.py`. The mesh is rendered
once (`_render_geometry`: xyz, alpha, normal, depth per view, through the
rasterizer and its raster-selection kernel); per timestep the 2-pass
denoise gives x0 images, `make_texture_fit` fits the albedo field to them
(pixel L1 weighted by the per-view normal-cosine maps of
`camera_dense_weighting`, plus LPIPS when the models carry its params),
the field's renders become the tile hints of pass 2 and the 3D side of
the eps blend. The field is baked into a 1024^2 UV atlas at the end.

Every random draw comes from a draw source (`GeneratorDraws`'s
`field_init`, `latent_noise` and `texture_fit`), so the tests can hand the
port the reference's draws. The reference's 64-step program cap of the
fit (a TPU workaround) is not ported, and `n_inverse_steps=0` returns the
field unfitted where the reference divides by zero.
"""
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models import losses as L
from ..models.diffusion import schedulers as S
from ..models.fields import FieldColor, INGPConfig, field_leaves
from ..models.mesh import Mesh, RasterConfig, bake_texture, render_views
from ..ops.clip import clip
from ..ops.image import edge_dilation
from ..utils.geometry import normalize_depth
from .mvedit_3d import GeneratorDraws

__all__ = ["TextureConfig", "TexturePipeline", "make_texture_fit",
           "camera_dense_weighting"]


@dataclass(frozen=True)
class TextureConfig:
    num_views: int = 32
    render_size: int = 512
    diffusion_steps: int = 12
    denoising_strength: float = 0.7
    guidance_scale: float = 7.0
    tile_weight: float = 1.0
    depth_weight: float = 0.5
    n_inverse_steps: int = 48
    views_per_step: int = 4   # views drawn per fit step (render_bs)
    lr: float = 0.01
    # LPIPS weight (flat schedule); active when the models carry
    # lpips_params
    patch_rgb_weight: float = 0.1
    blend_mode: str = "dynamic"
    use_reference: bool = True
    # scale of the ControlNets past (tile, depth), e.g. ip2p
    extra_control_scale: float = 1.0
    # progressive view pruning: the view count ramps from num_views to
    # min_num_views with power 2; pruned views leave the fit's draws, and
    # the arrays gather down at the bucket sizes. 0 keeps the whole rig
    min_num_views: int = 0
    mid_num_views: int = 0
    keep_first_views: int = 0
    # views per UNet / VAE call (exact in use_reference mode)
    diff_bs: int = 8
    ingp: INGPConfig = field(default_factory=INGPConfig)
    mode: str = "2-pass"

    def view_buckets(self):
        """The view-array sizes the pruning gathers down to, descending."""
        b = [self.num_views]
        for v in (self.mid_num_views, self.min_num_views):
            if v and v < b[-1]:
                b.append(v)
        return b


def camera_dense_weighting(normal_maps, poses, alpha):
    """Per-pixel weight max(cos(normal, direction to the camera), 0) *
    alpha. normal_maps (N, H, W, 3) world, poses (N, 3, 4) c2w, alpha
    (N, H, W, 1)."""
    cam_dir = poses[:, :3, 3]
    cam_dir = cam_dir / clip(torch.linalg.norm(cam_dir, dim=-1,
                                               keepdim=True), 1e-12)
    cosw = clip((normal_maps * cam_dir[:, None, None, :]).sum(
        -1, keepdim=True), 0.0)
    return cosw * alpha


def make_texture_fit(color_fn, cfg: TextureConfig, lpips_params=None):
    """The albedo-field fit on the frozen mesh. Returns `fit(params, opt,
    geom, targets, draws=None, generator=None) -> (params, opt, losses
    (n_inverse_steps,))` and `make_optimizer(params)` (Adam, betas (0.9,
    0.99), eps 1e-15, as the reference's optax.adam). geom: per-view xyz
    (N, H, W, 3), alpha and weight (N, H, W, 1) of the frozen mesh, so a
    step evaluates the field and rasterizes nothing. targets: images and
    optionally cam_weights (N,); each step draws `views_per_step` views
    uniformly among those with weight > 0, or among all `cfg.num_views`
    views when targets carry no cam_weights (`fit.draw(targets,
    generator)` -> {"view_ids": (n_inverse_steps, views_per_step)})."""

    def make_optimizer(params):
        leaves = field_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        return torch.optim.Adam(leaves, lr=cfg.lr, betas=(0.9, 0.99),
                                eps=1e-15)

    def loss_fn(params, geom, targets, ids):
        alpha = geom["alpha"][ids]
        rgb = color_fn(params, geom["xyz"][ids])
        rgb = rgb * alpha + 1.0 * (1 - alpha)
        tgt = targets["images"][ids]
        total = L.l1_loss(rgb, tgt, weight=geom["weight"][ids]) * 4.5
        if lpips_params is not None and cfg.patch_rgb_weight > 0:
            total = total + L.lpips_apply(lpips_params, rgb, tgt) \
                * cfg.patch_rgb_weight
        return total

    def draw(targets, generator):
        cw = targets.get("cam_weights")
        p = torch.ones(cfg.num_views, device=targets["images"].device) \
            if cw is None else (cw > 0).float().clamp(min=1e-9)
        n = cfg.n_inverse_steps
        vps = min(cfg.views_per_step, p.shape[0])
        ids = torch.multinomial(p, n * vps, replacement=True,
                                generator=generator)
        return {"view_ids": ids.reshape(n, vps)}

    def fit(params, opt, geom, targets, draws=None, generator=None):
        if draws is None:
            draws = draw(targets, generator)
        leaves = opt.param_groups[0]["params"]
        losses = []
        for s in range(cfg.n_inverse_steps):
            ids = draws["view_ids"][s].long()
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(params, geom, targets, ids)
            with L.deterministic_convs():
                loss.backward()
            for p in leaves:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            opt.step()
            losses.append(loss.detach())
        hist = torch.stack(losses) if losses else torch.zeros((0,))
        return params, opt, hist

    fit.draw, fit.cfg = draw, cfg
    return fit, make_optimizer


class TexturePipeline:
    """The denoise <-> albedo fit alternation on a fixed mesh.

    `models` holds unet, controlnets (tile, depth[, extra...]), vae,
    schedule; optionally lpips_params and ip_context (the IP-Adapter's
    [uncond; cond] tokens, (2, T, C))."""

    def __init__(self, models, cfg: TextureConfig):
        self.m = models
        self.cfg = cfg

    def _chunk_views(self, fn):
        from .denoise import chunk_view_batches
        run = chunk_view_batches(fn, self.cfg.diff_bs)

        def call(x):
            with torch.inference_mode():
                out = run(x)
            return out.float().clone()
        return call

    @torch.no_grad()
    def _render_geometry(self, mesh: Mesh, poses, intrinsics):
        """The frozen mesh's xyz, alpha, normal, depth and fit weight per
        view."""
        dev = poses.device
        rc = RasterConfig(height=self.cfg.render_size,
                          width=self.cfg.render_size)
        faces = torch.as_tensor(np.asarray(mesh.f), dtype=torch.int64,
                                device=dev)
        out = render_views(
            torch.as_tensor(np.asarray(mesh.v, np.float32), device=dev),
            faces, torch.ones(faces.shape[0], dtype=torch.bool, device=dev),
            poses, intrinsics, rc)
        weight = camera_dense_weighting(out["normal"], poses, out["alpha"])
        return {"xyz": out["xyz"], "alpha": out["alpha"],
                "normal": out["normal"], "depth": out["depth"],
                "weight": weight}

    def _denoise_fns(self, n_views, ip_tokens):
        from .denoise import (DenoiseModels, make_chunked_noise_pred_2pass,
                              make_noise_pred_2pass)
        cfg = self.cfg
        dm = DenoiseModels(unet=self.m.unet,
                           controlnets=tuple(self.m.controlnets),
                           num_views=n_views,
                           use_reference=cfg.use_reference,
                           ip_tokens=ip_tokens)
        if cfg.use_reference and 0 < cfg.diff_bs < n_views:
            return make_chunked_noise_pred_2pass(dm, cfg.diff_bs)
        return make_noise_pred_2pass(dm)

    def __call__(self, mesh: Mesh, poses, intrinsics, prompt_embeds,
                 negative_embeds, generator=None, draws=None,
                 init_albedo_fn=None, cam_weights=None, ip_context=None,
                 extra_control_images=None):
        """mesh: a `Mesh` (v, f, optional uv); poses (N, 3, 4) and
        intrinsics (N, 4) tensors on the models' device; prompt_embeds /
        negative_embeds (N, L, C). cam_weights: optional (N,) per-view loss
        weights. ip_context: IP-Adapter [uncond; cond] tokens (2, T, C),
        else the models' `ip_context`. extra_control_images: per extra
        ControlNet (N, H, W, 3) hints, by default the initial renders.
        The draws come from `draws` (`GeneratorDraws`' methods), by default
        from `generator`. Returns {"mesh" (with a 1024^2 albedo),
        "field_params", "renders" (N', H, W, 3), "fit_losses" (one per
        timestep)}."""
        cfg, m = self.cfg, self.m
        sch = m.schedule
        N = cfg.num_views
        dev = poses.device
        draws = draws if draws is not None else GeneratorDraws(generator)
        vae_enc = self._chunk_views(m.vae.encode)
        vae_dec = self._chunk_views(m.vae.decode)
        ip_ctx = ip_context if ip_context is not None else \
            getattr(m, "ip_context", None)
        ip_tokens = 0 if ip_ctx is None else int(ip_ctx.shape[1])

        def ip_rows(n):
            if ip_ctx is None:
                return None
            return torch.cat([ip_ctx[:1].expand(n, -1, -1),
                              ip_ctx[1:2].expand(n, -1, -1)], 0)
        ip2 = ip_rows(N)
        p1, p2 = self._denoise_fns(N, ip_tokens)

        geom = self._render_geometry(mesh, poses, intrinsics)
        if cam_weights is not None:
            cw_t = torch.as_tensor(np.asarray(cam_weights, np.float32),
                                   device=dev)
            geom["weight"] = geom["weight"] * cw_t[:, None, None, None]
        ctrl_depths = normalize_depth(geom["depth"], geom["alpha"])[
            ..., None].expand(-1, -1, -1, 3)

        params = draws.field_init(cfg.ingp, dev)
        color_fn = FieldColor(cfg.ingp)
        lpips_params = getattr(m, "lpips_params", None)
        fit, make_optimizer = make_texture_fit(color_fn, cfg, lpips_params)
        opt = make_optimizer(params)

        @torch.no_grad()
        def render_now(params, geom):
            rgb = color_fn(params, geom["xyz"])
            return clip(rgb * geom["alpha"] + (1 - geom["alpha"]), 0.0, 1.0)

        timesteps = S.make_timesteps(cfg.diffusion_steps,
                                     sch.num_train_timesteps, "trailing")
        n_keep = int(len(timesteps) * (1 - cfg.denoising_strength))
        timesteps = timesteps[n_keep:]

        init_rgb = render_now(params, geom) if init_albedo_fn is None \
            else init_albedo_fn(geom)
        n_extra = len(m.controlnets) - 2
        if n_extra > 0 and extra_control_images is None:
            extra_control_images = [init_rgb] * n_extra
        extras = list(extra_control_images or [])
        lat0 = vae_enc(init_rgb * 2 - 1)
        # one noise image shared by every view (the reference's convention)
        noise, ref_noise = draws.latent_noise(lat0.shape[1:], dev)
        t0 = int(timesteps[0])
        latents = S.add_noise(sch, lat0, noise.expand_as(lat0), t0)
        solver_state = S.SolverState.init(latents)
        if cfg.use_reference:
            ref_latents = lat0
            ref_noisy = S.add_noise(sch, lat0, ref_noise.expand_as(lat0), t0)
            ref_solver = S.SolverState.init(latents)
        else:
            ref_latents = ref_noisy = ref_solver = None
        cam_w = np.ones(N) if cam_weights is None else \
            np.asarray(cam_weights, np.float64)
        alive = np.ones(N, bool)
        buckets = cfg.view_buckets()
        cur_n = N
        keep_n = cfg.keep_first_views
        poses_np = poses.cpu().numpy()

        def weights_t():
            return torch.as_tensor(cam_w * alive, dtype=torch.float32,
                                   device=dev)
        targets = {"images": init_rgb, "cam_weights": weights_t()}
        fit_losses = []

        n_steps_total = len(timesteps)
        for i, t in enumerate(timesteps):
            t = int(t)
            progress = i / max(n_steps_total - 1, 1)
            # --- progressive view pruning (power 2) ----------------------
            if cfg.min_num_views and i > 0:
                from ..ops.rotation import prune_cameras
                target_n = max(int(round(
                    (N - cfg.min_num_views) * (1 - progress) ** 2
                    + cfg.min_num_views)), max(keep_n, 1))
                if target_n < int(alive.sum()):
                    alive_ids = np.flatnonzero(alive)
                    kept_local = prune_cameras(
                        poses_np[alive_ids],
                        list(range(min(keep_n, len(alive_ids)))), target_n)
                    kept = set(alive_ids[kept_local].tolist())
                    alive = np.array([j in kept for j in range(cur_n)])
                    targets["cam_weights"] = weights_t()
                n_alive = int(alive.sum())
                for b in buckets:
                    if b < cur_n and n_alive <= b:
                        ids = np.flatnonzero(alive)[:b]
                        if len(ids) < b:        # pad with alive repeats
                            ids = np.concatenate(
                                [ids, np.repeat(ids[-1:], b - len(ids))])
                        jids = torch.as_tensor(ids, device=dev)
                        geom = {k: v[jids] for k, v in geom.items()}
                        ctrl_depths = ctrl_depths[jids]
                        latents = latents[jids]
                        solver_state = solver_state._replace(
                            prev_x0=solver_state.prev_x0[jids])
                        if ref_noisy is not None:
                            ref_latents = ref_latents[jids]
                            ref_noisy = ref_noisy[jids]
                            ref_solver = ref_solver._replace(
                                prev_x0=ref_solver.prev_x0[jids])
                        prompt_embeds = prompt_embeds[jids]
                        negative_embeds = negative_embeds[jids]
                        extras = [e[jids] for e in extras]
                        targets["images"] = targets["images"][jids]
                        poses_np = poses_np[ids]
                        cam_w = cam_w[ids]
                        alive = alive[ids]
                        cur_n = b
                        targets["cam_weights"] = weights_t()
                        p1, p2 = self._denoise_fns(b, ip_tokens)
                        ip2 = ip_rows(b)
                        break

            t_vec = torch.full((2 * cur_n,), t, dtype=torch.int32,
                               device=dev)
            lat2 = torch.cat([latents, latents], 0)
            embeds = torch.cat([negative_embeds, prompt_embeds], 0)
            depths2 = torch.cat([ctrl_depths, ctrl_depths], 0)
            extras2 = tuple(torch.cat([e, e], 0) for e in extras)
            eps, enc_state, p1_res = p1(
                lat2, t_vec, embeds, depths2, cfg.depth_weight,
                cfg.guidance_scale, ip_context=ip2, extra_images=extras2,
                extra_scales=(cfg.extra_control_scale,) * len(extras2),
                ref_noisy=ref_noisy)
            sa, sn = sch.sqrt_acp(t)
            x0_lat = (latents - sn * eps.float()) / sa
            targets["images"] = clip((vae_dec(x0_lat) + 1) / 2, 0.0, 1.0)

            params, opt, losses = fit(params, opt, geom, targets,
                                      draws=draws.texture_fit(fit, targets))
            fit_losses.append(losses)
            renders = render_now(params, geom)

            tiles2 = torch.cat([renders, renders], 0)
            eps_unet = p2(lat2, enc_state, p1_res, t_vec, embeds, tiles2,
                          depths2, cfg.tile_weight, cfg.depth_weight,
                          cfg.guidance_scale, ip_context=ip2,
                          ref_noisy=ref_noisy)
            lat_3d = vae_enc(renders * 2 - 1)
            eps_3d = (latents - sa * lat_3d) / sn
            bw = (1.0 - sa) if cfg.blend_mode == "dynamic" else 0.5
            eps_final = bw * eps_3d + (1 - bw) * eps_unet.float()
            t_prev = int(timesteps[i + 1]) if i + 1 < n_steps_total else -1
            latents, solver_state = S.dpmsolver_step(
                sch, latents, eps_final, t, t_prev, solver_state)
            if ref_noisy is not None:
                ref_eps = (ref_noisy - sa * ref_latents) / sn
                ref_noisy, ref_solver = S.dpmsolver_step(
                    sch, ref_noisy, ref_eps, t, t_prev, ref_solver)

        # --- bake the field into a 1024^2 atlas ---------------------------
        out_mesh = Mesh(v=np.asarray(mesh.v).copy(),
                        f=np.asarray(mesh.f).copy(), vn=mesh.vn, fn=mesh.fn,
                        vt=mesh.vt, ft=mesh.ft)
        if out_mesh.vt is None:
            out_mesh.auto_uv()
        acfg = RasterConfig(height=1024, width=1024, tile=16,
                            k_per_tile=64, k_big=32)

        def t_(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
        faces = t_(out_mesh.f, torch.int64)
        with torch.no_grad():
            rgb, mask = bake_texture(
                t_(out_mesh.v), faces,
                torch.ones(faces.shape[0], dtype=torch.bool, device=dev),
                t_(out_mesh.vt), t_(out_mesh.ft, torch.int64),
                FieldColor(cfg.ingp), acfg, field_params=params)
            rgb = edge_dilation(rgb, mask, n_iters=16)
        out_mesh.albedo = clip(rgb, 0.0, 1.0).cpu().numpy()
        return {"mesh": out_mesh, "field_params": params,
                "renders": render_now(params, geom),
                "fit_losses": fit_losses}
