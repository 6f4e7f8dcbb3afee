"""MVEdit 3D pipeline: the denoise <-> reconstruct alternation, the
product (counterpart of `mvedit_tpu/pipelines/mvedit_3d.py`).

    for t in [None] + timesteps:
      camera schedule: prune to max_num_views(progress), gather the
        denoise-side arrays down to the next view bucket
      P1 denoise (2-pass: encoder once, decoder with the depth / extra
        ControlNets; 1-pass: all ControlNets on the previous renders)
      x0 -> VAE decode -> target views
      3D fuse: progress <= 0.6 -> NeRF fit (render size 128 -> 256 -> 512);
        after it -> DMTet fit
      re-render the views [-> SRVGG enhancer when the render is < 512]
      P2 denoise (2-pass), eps_3d from the VAE-encoded renders, blended
        with eps_unet by 1 - sqrt(acp_t); DPM-Solver++ step of the latents
        and of the reference rows
    decimation + texture-only refinement (tet > 128), UV atlas, bake

`fit_steps_per_program` chained TPU programs in the reference; here it
keeps one role: the fits run in chunks of that many steps, and the frozen
marching-tets topology (mesh fit) and the occupancy grid (NeRF fit) are
refreshed at the start of each chunk, at the same steps as in the
reference. Not ported, as TPU-only: the executable evictions,
`_mem_debug`, the fixed view chunks of the re-render (views render one
after another here).

`debug` >= 1 writes the reference's per-step debug tiles
(`utils/debug_viz.py::save_tiled_viz`: [targets | renders] per view, one
PNG a view a step) into `debug_dir` after each re-render; only then are
the renders and targets copied to the host.

`models.device_mesh` (a `parallel.make_mesh` DeviceMesh) shards a request
over the ranks of a process group, as the reference's over its chips: the
denoise and VAE view batches (`parallel.ShardedViews`: each net call takes
this rank's rows and gathers its outputs back), the NeRF fit's rays, the
mesh fit's and the texture refine's pixel rows and regulariser faces.
Every rank draws the whole request from its generator, and the weights
are broadcast from the first rank at the start of each request.

Every random draw comes from a draw source (`GeneratorDraws`, one
`torch.Generator`), so a caller can inject another one, such as the JAX
package's draws in the parity tests.
"""
import os
import tempfile
from dataclasses import dataclass, field
from functools import partial

import numpy as np
import torch

from ..models import mesh_fit as MF
from ..models import nerf_fit as NF
from ..models.diffusion import schedulers as S
from ..models.fields import (FieldColor, FieldShading, INGPConfig, ingp_init,
                             ingp_point_decode)
from ..models.mesh import (Mesh, RasterConfig, StructuredTetGrid,
                           bake_texture, build_grid_tets, render_views)
from ..models.volume_renderer import OccupancyGrid, RenderConfig
from ..native import decimate_qem, native_available
from ..ops.image import edge_dilation, resize_bilinear
from ..ops.rotation import prune_cameras
from ..parallel.sharded import ShardedViews, replicate_
from ..utils.geometry import normalize_depth
from ..utils.profiling import phase_timer

__all__ = ["MVEdit3DConfig", "MVEdit3DPipeline", "GeneratorDraws",
           "default_max_num_views",
           "default_lr_schedule", "default_render_size_p",
           "default_entropy_weight", "default_patch_rgb_weight",
           "default_patch_normal_weight", "default_normal_reg_weight",
           "default_lr_multiplier"]


# ---- progress schedules (mvedit_3d_pipeline.py:41-78) ---------------------

def default_lr_multiplier(progress, progress_to_dmtet):
    return min((1 - progress) / (1 - progress_to_dmtet), 1)


def default_max_num_views(progress, progress_to_dmtet, start_num=32,
                          mid_num=16, end_num=9, power=3):
    ratio = end_num / mid_num
    a = (start_num - mid_num) * (1 - progress) ** power + mid_num
    b = min((1 - progress) / (1 - progress_to_dmtet), 1) * (1 - ratio) + ratio
    return a * b


def default_render_size_p(progress, full=512):
    if progress <= 0.3:
        return full // 4
    if progress <= 0.6:
        return full // 2
    return full


def default_lr_schedule(progress, start_lr=0.01, end_lr=0.005):
    return start_lr - (start_lr - end_lr) * progress


def default_patch_rgb_weight(progress, start_weight=0.3, end_weight=1.5):
    return start_weight + (end_weight - start_weight) * progress


def default_patch_normal_weight(progress, start_weight=0.0, end_weight=3.0):
    return start_weight + (end_weight - start_weight) * progress


def default_entropy_weight(progress, start_weight=0.0, end_weight=4.0):
    return start_weight - (start_weight - end_weight) * progress


def default_normal_reg_weight(progress, start_weight=4.0, end_weight=0.0):
    return start_weight - (start_weight - end_weight) * progress


@dataclass(frozen=True)
class MVEdit3DConfig:
    num_views: int = 32
    mid_num_views: int = 16
    min_num_views: int = 9
    keep_first_views: int = 0
    render_size: int = 512
    render_size_ramp: bool = True
    diffusion_steps: int = 24
    denoising_strength: float = 1.0
    guidance_scale: float = 7.0
    tile_weight: float = 1.0
    depth_weight: float = 0.5
    extra_control_scale: float = 1.0
    nerf_switch_progress: float = 0.6
    init_inverse_steps: int = 640
    n_inverse_steps: int = 80
    tet_init_inverse_steps: int = 120
    tet_resolution: int = 64
    structured_tets: bool = True
    freeze_mesh_topology: bool = True
    patch_size: int = 128
    patch_bs: int = 1
    diff_bs: int = 8
    # fit steps between topology refreshes (see the module doc)
    fit_steps_per_program: int = 8
    blend_mode: str = "dynamic"
    start_lr: float = 0.01
    end_lr: float = 0.005
    start_entropy_weight: float = 0.0
    end_entropy_weight: float = 4.0
    entropy_d: float = 0.015
    start_patch_rgb_weight: float = 0.3
    end_patch_rgb_weight: float = 1.5
    start_patch_normal_weight: float = 0.0
    end_patch_normal_weight: float = 3.0
    start_normal_reg_weight: float = 4.0
    end_normal_reg_weight: float = 0.0
    mesh_normal_reg_weight: float = 5.0
    mesh_smoothness: float = 1.0
    alpha_soften: float = 0.02
    use_lpips: bool = False
    mesh_reduction: float = 1.0
    mesh_simplify_texture_steps: int = 24
    ingp: INGPConfig = field(default_factory=INGPConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    mode: str = "2-pass"
    use_reference: bool = True
    # per-step tile dumps (the reference's --debug {0,1,2}, mvedit_3d_
    # pipeline.py:392-408): 0 off, >= 1 writes [targets | renders] tiles
    # per view per denoise step into debug_dir
    debug: int = 0
    debug_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "mvedit_debug"))

    def view_buckets(self):
        b = [self.num_views]
        for n in (self.mid_num_views, self.min_num_views):
            n = max(n, max(self.keep_first_views, 1))
            if n < b[-1]:
                b.append(n)
        return tuple(b)

    def render_sizes(self):
        if not self.render_size_ramp:
            return (self.render_size,)
        return tuple(sorted({max(self.render_size // 4, self.patch_size),
                             max(self.render_size // 2, self.patch_size),
                             self.render_size}))


def _ingp_decode(params, xyz, ingp_cfg):
    return ingp_point_decode(params, xyz, ingp_cfg)


def _ingp_color(params, xyz, ingp_cfg):
    return ingp_point_decode(params, xyz, ingp_cfg)[1]


class GeneratorDraws:
    """The pipelines' random draws, all from one `torch.Generator`: the
    field init, the latent noise (shared by the views, or per view for
    texture superres), and the draws of every fit chunk, of the texture
    refinement and of the re-texturing fits (each fit's own `draw`); for
    text-to-3D also the code sample's noise and the distillation's field
    init and points."""

    def __init__(self, generator=None):
        self.generator = generator

    def field_init(self, cfg: INGPConfig, device):
        return ingp_init(cfg, self.generator, device)

    def latent_noise(self, shape, device):
        """(init noise, reference noise), each of `shape` (one view's
        latent: the noise is shared across the views)."""
        return tuple(torch.randn(shape, generator=self.generator,
                                 device=device) for _ in range(2))

    def view_noise(self, shape, device):
        """One noise draw of the whole `shape` (N, h, w, 4): texture
        superres gives every view its own noise."""
        return torch.randn(shape, generator=self.generator, device=device)

    def code_noise(self, shape, device):
        """The initial noise of a text-to-3D code sample."""
        return torch.randn(shape, generator=self.generator, device=device)

    def distill_field_init(self, cfg: INGPConfig, device):
        """The field a triplane is distilled into, before its first step."""
        return ingp_init(cfg, self.generator, device)

    def distill_points(self, n, bound, device):
        """One distillation step's n points, uniform in [-bound, bound]^3."""
        u = torch.rand((n, 3), generator=self.generator, device=device)
        return u * (2 * bound) - bound

    def fit(self, run, targets):
        """The per-chunk draws of a chunked fit (`_nerf_fit_fns` or
        `_mesh_fit_fns`)."""
        return run.draw(targets, self.generator)

    def refine(self, refine, targets, n_steps):
        return refine.draw(targets, n_steps, self.generator)

    def texture_fit(self, fit, targets):
        """The view draws of one `pipelines.texture` albedo fit."""
        return fit.draw(targets, self.generator)


def _take(x, ids):
    return None if x is None else x[ids]


def _host(maps):
    return {k: v.detach().float().cpu().numpy() for k, v in maps.items()}


class MVEdit3DPipeline:
    """Orchestrates the phases from Python, one iteration per timestep.

    `models` holds the modules: unet, controlnets (tile, depth[,
    extra...]), vae, schedule; optionally lpips_params, enhance_fn (SRVGG
    upsampler), segment_fn and ip_context (IP-Adapter [uncond; cond]
    tokens (2, T, C), with the UNet's IP branches). The mesh-phase helpers
    also run with models=None.
    """

    def __init__(self, models, cfg: MVEdit3DConfig):
        self.m = models
        self.cfg = cfg
        self._decode_fn = partial(_ingp_decode, ingp_cfg=cfg.ingp)
        self._color_fn = partial(_ingp_color, ingp_cfg=cfg.ingp)
        self._fit_cache = {}
        self.device_mesh = getattr(models, "device_mesh", None)

    # ---------------- sharding ------------------------------------------

    def _shard_batch(self, fn):
        """fn over this rank's rows of its batch, gathered back."""
        return fn if self.device_mesh is None \
            else ShardedViews(fn, self.device_mesh)

    def _replicate_params(self):
        """The first rank's weights on every rank."""
        if self.device_mesh is None:
            return
        m = self.m
        replicate_([[*n.parameters(), *n.buffers()] for n in
                    (m.unet, m.vae, *m.controlnets)]
                   + [getattr(m, "lpips_params", None)], self.device_mesh)

    # ---------------- phases --------------------------------------------

    def _vae_decode(self):
        return self._chunk_views(self.m.vae.decode)

    def _vae_encode(self):
        return self._chunk_views(self.m.vae.encode)

    def _chunk_views(self, fn):
        """fn over the view axis in chunks of `diff_bs` (the remainder
        padded up to one chunk), in inference mode, as float32."""
        from .denoise import chunk_view_batches
        run = self._shard_batch(chunk_view_batches(fn, self.cfg.diff_bs))

        def call(x):
            with torch.inference_mode():
                out = run(x)
            return out.float().clone()
        return call

    def _denoise(self, num_views):
        from .denoise import (DenoiseModels, make_chunked_noise_pred_1pass,
                              make_chunked_noise_pred_2pass,
                              make_noise_pred_1pass, make_noise_pred_2pass)
        cfg = self.cfg
        # diff_bs view chunking is exact in use_reference mode; under a
        # device mesh each chunk's net calls are split over the ranks, so
        # that one rank does the unsharded arithmetic
        chunked = cfg.use_reference and 0 < cfg.diff_bs < num_views
        key = ("denoise", "chunked" if chunked else num_views, cfg.mode)
        if key not in self._fit_cache:
            ip_ctx = getattr(self.m, "ip_context", None)
            dm = DenoiseModels(unet=self._shard_batch(self.m.unet),
                               controlnets=tuple(self._shard_batch(c) for c
                                                 in self.m.controlnets),
                               num_views=num_views,
                               use_reference=cfg.use_reference,
                               ip_tokens=0 if ip_ctx is None
                               else int(ip_ctx.shape[1]))
            if cfg.mode == "1-pass":
                fns = (make_chunked_noise_pred_1pass(dm, cfg.diff_bs)
                       if chunked else make_noise_pred_1pass(dm)), None
            elif chunked:
                fns = make_chunked_noise_pred_2pass(dm, cfg.diff_bs)
            else:
                fns = make_noise_pred_2pass(dm)
            self._fit_cache[key] = fns
        return self._fit_cache[key]

    def _chunks(self, n_steps):
        L = n_steps if self.cfg.fit_steps_per_program <= 0 \
            else min(n_steps, self.cfg.fit_steps_per_program)
        return [L] * (n_steps // L) + ([n_steps % L] if n_steps % L else [])

    def _nerf_fit_fns(self, rs, n_steps):
        """(fit, make_optimizer) for render size rs; `fit` runs n_steps in
        chunks of `fit_steps_per_program`, the occupancy grid refreshed at
        the first step of each."""
        cfg = self.cfg
        use_lpips = cfg.use_lpips and \
            getattr(self.m, "lpips_params", None) is not None

        def get(steps):
            key = ("nerf", rs, steps)
            if key not in self._fit_cache:
                fit_cfg = NF.NerfFitConfig(
                    render=cfg.render, patch_size=min(cfg.patch_size, rs),
                    patch_bs=cfg.patch_bs, n_steps=steps,
                    alpha_soften=cfg.alpha_soften, bg_width=cfg.entropy_d)
                self._fit_cache[key] = (fit_cfg,) + NF.make_nerf_fit(
                    self._decode_fn, fit_cfg, rs, use_lpips=use_lpips,
                    mesh=self.device_mesh)
            return self._fit_cache[key]

        chunks = self._chunks(n_steps)

        def run(params, opt, grid, tgt, sched=None, lpips_params=None,
                draws=None, generator=None):
            """draws: None, or a list with one `fit` draws dict per chunk."""
            hists = []
            for i, steps in enumerate(chunks):
                params, opt, grid, out = get(steps)[1](
                    params, opt, grid, tgt, sched=sched,
                    lpips_params=lpips_params,
                    draws=None if draws is None else draws[i],
                    generator=generator)
                hists.append(out["loss"])
            return params, opt, grid, {"loss": torch.cat(hists)}
        run.kind, run.chunks, run.render_size = "nerf", chunks, rs
        run.fit_cfg = get(chunks[0])[0]
        run.draw = lambda tgt, generator: [
            get(s)[1].draw(tgt, s, generator) for s in chunks]
        return run, get(chunks[0])[2]

    def _mesh_raster_cfg(self, rs):
        # DMTet soups are many small triangles: tight span, deep per-tile
        # budget (k 1024 at rs >= 256)
        return RasterConfig(height=rs, width=rs, span=2,
                            k_per_tile=1024 if rs >= 256 else 256)

    def _mesh_fit_fns(self, tet_grid, n_steps):
        """(fit, make_optimizer, extract); `fit` runs n_steps in chunks of
        `fit_steps_per_program` steps, refreshing the frozen topology at
        the start of each chunk."""
        cfg = self.cfg

        def get(steps):
            key = ("mesh", steps)
            if key not in self._fit_cache:
                # the extraction caps are `mesh_caps(tet_resolution)` from
                # tet 32 up; below it a TetGrid keeps its full buffers (a
                # structured grid takes the same caps either way)
                res = cfg.tet_resolution
                vert_cap = MF.mesh_caps(res)[0] if res >= 32 else 0
                mcfg = MF.MeshFitConfig(
                    raster=self._mesh_raster_cfg(cfg.render_size),
                    n_steps=steps,
                    normal_reg_weight=cfg.mesh_normal_reg_weight,
                    laplacian_weight=0.25 * cfg.mesh_smoothness,
                    normal_consistency_weight=0.25 * cfg.mesh_smoothness,
                    patch_size=min(cfg.patch_size, cfg.render_size),
                    vert_cap=vert_cap,
                    face_cap=vert_cap + (vert_cap >> 1),
                    freeze_topology=(cfg.freeze_mesh_topology
                                     and cfg.structured_tets))
                self._fit_cache[key] = (mcfg,) + MF.make_mesh_fit(
                    tet_grid, self._color_fn, mcfg, mesh=self.device_mesh)
            return self._fit_cache[key]

        chunks = self._chunks(n_steps)
        _, _, make_opt, extract = get(chunks[0])

        def run(state, opt, tgt, sched=None, draws=None, generator=None,
                lpips_params=None):
            """draws: None, or a list with one `fit` draws dict per chunk."""
            hists, out = [], None
            for i, steps in enumerate(chunks):
                state, opt, out = get(steps)[1](
                    state, opt, tgt, sched=sched,
                    draws=None if draws is None else draws[i],
                    generator=generator, lpips_params=lpips_params)
                hists.append(out["loss"])
            return state, opt, {"loss": torch.cat(hists), "mt": out["mt"]}
        run.kind, run.chunks = "mesh", chunks
        run.fit_cfg = get(chunks[0])[0]
        run.face_cap = get(chunks[0])[1].face_cap
        run.draw = lambda tgt, generator: [
            get(s)[1].draw(tgt, s, generator) for s in chunks]
        return run, make_opt, extract

    # ---------------- schedules -----------------------------------------

    def _sched_weights(self, progress, phase):
        cfg = self.cfg
        lr = default_lr_schedule(progress, cfg.start_lr, cfg.end_lr)
        if phase == "nerf":
            return {
                "lr": lr,
                "entropy": default_entropy_weight(
                    progress, cfg.start_entropy_weight,
                    cfg.end_entropy_weight),
                "patch_rgb": default_patch_rgb_weight(
                    progress, cfg.start_patch_rgb_weight,
                    cfg.end_patch_rgb_weight),
                "patch_normal": default_patch_normal_weight(
                    progress, cfg.start_patch_normal_weight,
                    cfg.end_patch_normal_weight),
                "normal_reg": default_normal_reg_weight(
                    progress, cfg.start_normal_reg_weight,
                    cfg.end_normal_reg_weight),
            }
        return {
            "lr": lr,
            "sdf_lr_mult": default_lr_multiplier(progress,
                                                 cfg.nerf_switch_progress),
            "normal_reg": cfg.mesh_normal_reg_weight,
            "patch_rgb": default_patch_rgb_weight(
                progress, cfg.start_patch_rgb_weight,
                cfg.end_patch_rgb_weight),
            "patch_normal": default_patch_normal_weight(
                progress, cfg.start_patch_normal_weight,
                cfg.end_patch_normal_weight),
        }

    def _resize_targets(self, tgt, rs):
        """The supervision targets at render size rs (bilinear with the
        reference's antialiasing when shrinking)."""
        full = self.cfg.render_size
        if rs == full:
            return tgt
        out = dict(tgt)
        for k in ("images", "masks", "normals"):
            if k in tgt:
                out[k] = resize_bilinear(tgt[k], (rs, rs))
        if "depths" in tgt:
            out["depths"] = resize_bilinear(tgt["depths"][..., None],
                                            (rs, rs))[..., 0]
        out["intrinsics"] = tgt["intrinsics"] * (rs / full)
        return out

    # ---------------- main ----------------------------------------------

    def __call__(self, targets, prompt_embeds, negative_embeds,
                 generator=None, draws=None, init_latents=None,
                 progress_callback=None, init_field_params=None,
                 extra_control_images=None):
        """Run the whole loop.

        targets: tensors on one device: images (N, H, W, 3), masks (N, H,
            W, 1), poses (N, 3, 4), intrinsics (N, 4), cam_weights (N,),
            cam_lights (N, 3) [+ normals, depths, normal_weights];
            N == cfg.num_views.
        prompt_embeds / negative_embeds: (N, L, C) per-view text embeddings.
        generator / draws: the random draws come from `draws` (an object
            with `GeneratorDraws`' methods), by default from `generator`.
        extra_control_images: (N, H, W, 3) hints of the ControlNets past
            tile and depth (default: the initial images).
        Returns {"mesh": Mesh or None, "nerf_params", "mesh_state",
        "renders"}.
        """
        cfg, m = self.cfg, self.m
        sch = m.schedule
        draws = draws if draws is not None else GeneratorDraws(generator)
        self._replicate_params()
        dev = targets["images"].device
        vae_dec, vae_enc = self._vae_decode(), self._vae_encode()
        lpips_params = getattr(m, "lpips_params", None) \
            if cfg.use_lpips else None

        # --- per-view state (the denoise side is gathered at buckets)
        tgt = dict(targets)
        n_extra_nets = max(len(m.controlnets) - 2, 0)
        if extra_control_images is None and n_extra_nets:
            extra_control_images = [tgt["images"]] * n_extra_nets
        extra_ctrl = list(extra_control_images or [])
        init_images, init_masks = tgt["images"], tgt["masks"]
        pos_e, neg_e = prompt_embeds, negative_embeds

        # --- the NeRF state
        nerf_params = draws.field_init(cfg.ingp, dev) \
            if init_field_params is None else init_field_params
        grid = OccupancyGrid.create(cfg.render.grid_size, device=dev)
        _, make_nerf_opt = self._nerf_fit_fns(cfg.render_sizes()[0],
                                              cfg.n_inverse_steps)
        nerf_opt = make_nerf_opt(nerf_params)

        # --- the diffusion state
        timesteps = S.make_timesteps(cfg.diffusion_steps,
                                     sch.num_train_timesteps, "trailing")
        timesteps = timesteps[int(len(timesteps)
                                  * (1 - cfg.denoising_strength)):]
        lat0 = vae_enc(tgt["images"] * 2.0 - 1.0) if init_latents is None \
            else init_latents
        # noise shared across the views (randn_like(latents[0]).expand)
        noise, ref_noise = draws.latent_noise(lat0.shape[1:], dev)
        t0 = int(timesteps[0])
        latents = S.add_noise(sch, lat0, noise.expand_as(lat0), t0)
        solver_state = S.SolverState.init(latents)
        if cfg.use_reference:
            # fixed clean reference latents and their on-schedule noisy
            # counterparts, denoised in lockstep
            ref_latents = lat0
            ref_noisy = S.add_noise(sch, ref_latents,
                                    ref_noise.expand_as(lat0), t0)
            ref_solver_state = S.SolverState.init(latents)
        else:
            ref_latents = ref_noisy = ref_solver_state = None
        del lat0, noise, ref_noise

        mesh_state = mesh_opt = last_mt = tet_grid = None
        ctrl_images = ctrl_depths = renders = None
        keep_n = max(cfg.keep_first_views, 0)
        buckets = cfg.view_buckets()
        cur_n = cfg.num_views                # the denoise buffer's size
        alive = (tgt["cam_weights"] > 0).cpu().numpy()
        # the targets stay full size (pruned views keep weight 0 and are
        # never sampled by the fits); `bsel` maps bucket rows to views
        bsel = np.arange(cur_n)
        one_pass = p1 = p2 = None
        steps = [None] + list(timesteps)
        for i, t in enumerate(steps):
            pt = phase_timer()
            if pt is not None:
                pt.mark()
            progress = i / max(len(steps) - 1, 1)
            in_mesh_phase = progress > cfg.nerf_switch_progress
            rs = default_render_size_p(progress, cfg.render_size) \
                if (cfg.render_size_ramp and not in_mesh_phase) \
                else cfg.render_size

            # ---- camera schedule: prune + bucket gather
            if i > 0:
                target_n = max(int(round(default_max_num_views(
                    progress, cfg.nerf_switch_progress, cfg.num_views,
                    cfg.mid_num_views, cfg.min_num_views))), max(keep_n, 1))
                alive_ids = np.flatnonzero(alive)
                if target_n < len(alive_ids):
                    poses_np = tgt["poses"].cpu().numpy()[bsel[alive_ids]]
                    bonus = None
                    if ctrl_images is not None:
                        diff = ((ctrl_images - init_images) ** 2).mean(
                            (1, 2, 3))
                        mask_mean = init_masks.mean((1, 2, 3))
                        bonus = (diff / (mask_mean + 0.1)).cpu().numpy()
                        # NaN renders (an undertrained field) must not
                        # poison the min-score comparisons
                        bonus = np.nan_to_num(bonus[alive_ids], nan=0.0,
                                              posinf=0.0, neginf=0.0)
                        bonus = bonus[None, :] + bonus[:, None]
                    kept_local = prune_cameras(
                        poses_np, list(range(min(keep_n, len(alive_ids)))),
                        target_n, pixel_dist_bonus=bonus)
                    kept = set(alive_ids[kept_local].tolist())
                    new_alive = np.array([j in kept for j in range(cur_n)])
                    if not np.array_equal(new_alive, alive):
                        # zero the pruned views' weights in the full buffer
                        dead = np.setdiff1d(np.unique(bsel[~new_alive]),
                                            np.unique(bsel[new_alive]))
                        alive = new_alive
                        if len(dead):
                            cw = tgt["cam_weights"].clone()
                            cw[torch.as_tensor(dead, device=dev)] = 0.0
                            tgt["cam_weights"] = cw
                # gather the denoise-side arrays down to the next bucket
                n_alive = int(alive.sum())
                for b in buckets:
                    if b < cur_n and n_alive <= b:
                        ids = np.flatnonzero(alive)[:b]
                        if len(ids) < b:    # pad with alive duplicates
                            ids = np.concatenate(
                                [ids, np.repeat(ids[-1:], b - len(ids))])
                        it = torch.as_tensor(ids, device=dev)
                        init_images, init_masks = init_images[it], \
                            init_masks[it]
                        extra_ctrl = [e[it] for e in extra_ctrl]
                        pos_e, neg_e = pos_e[it], neg_e[it]
                        latents = latents[it]
                        solver_state = solver_state._replace(
                            prev_x0=solver_state.prev_x0[it])
                        if ref_noisy is not None:
                            ref_latents, ref_noisy = ref_latents[it], \
                                ref_noisy[it]
                            ref_solver_state = ref_solver_state._replace(
                                prev_x0=ref_solver_state.prev_x0[it])
                        ctrl_images = _take(ctrl_images, it)
                        ctrl_depths = _take(ctrl_depths, it)
                        one_pass = p1 = p2 = None
                        cur_n = b
                        alive, bsel = alive[ids], bsel[ids]
                        break

            N = cur_n
            if p1 is None and one_pass is None:
                if cfg.mode == "1-pass":
                    one_pass, _ = self._denoise(N)
                else:
                    p1, p2 = self._denoise(N)

            # IP-Adapter tokens [uncond x N; cond x N] (mvedit_3d.py:765)
            ip_ctx = getattr(m, "ip_context", None)
            ip2 = None if ip_ctx is None else torch.cat(
                [ip_ctx[:1].expand(N, -1, -1),
                 ip_ctx[1:2].expand(N, -1, -1)], 0)
            if t is not None:
                # ---- P1 denoise + x0 decode
                t_vec = torch.full((2 * N,), int(t), dtype=torch.int32,
                                   device=dev)
                cfg_lat = torch.cat([latents, latents], 0)
                embeds = torch.cat([neg_e, pos_e], 0)
                extras2 = tuple(torch.cat([e, e], 0) for e in extra_ctrl)
                if cfg.mode == "1-pass":
                    # all nets on the previous step's renders
                    conds = [torch.cat([ctrl_images, ctrl_images], 0),
                             torch.cat([ctrl_depths, ctrl_depths], 0)] \
                        + list(extras2)
                    scales = [cfg.tile_weight, cfg.depth_weight] + \
                        [cfg.extra_control_scale] * len(extras2)
                    eps = one_pass(cfg_lat, t_vec, embeds, conds, scales,
                                   cfg.guidance_scale, ip_context=ip2,
                                   ref_noisy=ref_noisy)
                else:
                    eps, enc_state, p1_res = p1(
                        cfg_lat, t_vec, embeds, None, cfg.depth_weight,
                        cfg.guidance_scale, ip_context=ip2,
                        extra_images=extras2,
                        extra_scales=(cfg.extra_control_scale,)
                        * len(extras2), ref_noisy=ref_noisy)
                eps = eps.float()
                sa, sn = sch.sqrt_acp(int(t))
                dec = ((vae_dec((latents - sn * eps) / sa) + 1) / 2).clamp(
                    0.0, 1.0)
                # the bucket's decoded views into the full target buffer
                bj = torch.as_tensor(bsel, device=dev)
                images = tgt["images"].clone()
                images[bj] = dec
                tgt["images"] = images
                if getattr(m, "segment_fn", None) is not None:
                    masks = tgt["masks"].clone()
                    masks[bj] = m.segment_fn(dec)
                    tgt["masks"] = masks
                if pt is not None:
                    pt.tick("denoise_p1+vae_dec", tgt["images"],
                            sig=(len(bsel), in_mesh_phase))

            # ---- 3D fuse
            if not in_mesh_phase:
                n_steps = cfg.init_inverse_steps if t is None \
                    else cfg.n_inverse_steps
                fit, _ = self._nerf_fit_fns(rs, n_steps)
                tgt_rs = self._resize_targets(tgt, rs)
                nerf_params, nerf_opt, grid, _ = fit(
                    nerf_params, nerf_opt, grid, tgt_rs,
                    sched=self._sched_weights(progress, "nerf"),
                    lpips_params=lpips_params, draws=draws.fit(fit, tgt_rs))
                if pt is not None:
                    pt.tick("nerf_fit", nerf_params, sig=(rs, n_steps))
            else:
                first_mesh_step = mesh_state is None
                if first_mesh_step:
                    # the NeRF phase's Adam moments go before the mesh
                    # phase is built
                    del nerf_opt
                    tet_grid, mesh_state, mesh_opt = self._init_mesh_phase(
                        nerf_params, device=dev)
                # the first DMTet fit runs tet_init_inverse_steps
                n_steps = cfg.tet_init_inverse_steps if first_mesh_step \
                    else cfg.n_inverse_steps
                mfit, _, _ = self._mesh_fit_fns(tet_grid, n_steps)
                mesh_state, mesh_opt, fit_out = mfit(
                    mesh_state, mesh_opt, tgt,
                    sched=self._sched_weights(progress, "mesh"),
                    draws=draws.fit(mfit, tgt), lpips_params=lpips_params)
                last_mt = fit_out["mt"]
                nerf_params = mesh_state["field"]
                if pt is not None:
                    pt.tick("mesh_fit", mesh_state["sdf"], sig=(n_steps,))

            # ---- re-render the bucket's views -> ControlNet inputs, eps_3d
            bj = torch.as_tensor(bsel, device=dev)
            renders = self._render_all(nerf_params, mesh_state, last_mt,
                                       grid, {"poses": tgt["poses"][bj],
                                              "intrinsics":
                                                  tgt["intrinsics"][bj]}, rs)
            ctrl_depths = normalize_depth(renders["depth"], renders["alpha"])[
                ..., None].expand(-1, -1, -1, 3)
            ctrl_rgb = renders["rgb"]
            if rs != cfg.render_size:
                # upsample to the diffusion size: the SRVGG enhancer when
                # present, else bilinear
                full = (cfg.render_size, cfg.render_size)
                enhance = getattr(m, "enhance_fn", None)
                ctrl_rgb = enhance(ctrl_rgb, cfg.render_size) \
                    if enhance is not None \
                    else resize_bilinear(ctrl_rgb, full)
                ctrl_depths = resize_bilinear(ctrl_depths, full)
            ctrl_images = ctrl_rgb.clamp(0.0, 1.0)
            if pt is not None:
                pt.tick("render_all", ctrl_images,
                        sig=(mesh_state is None, rs, len(bsel)))
            if cfg.debug:
                from ..utils.debug_viz import save_tiled_viz
                save_tiled_viz(cfg.debug_dir, i, _host(renders), _host(
                    {k: tgt[k][bj] for k in ("images", "masks", "normals")
                     if tgt.get(k) is not None}))

            if t is not None:
                lat_3d = vae_enc(ctrl_images * 2 - 1)
                eps_3d = (latents - sa * lat_3d) / sn
                if cfg.mode == "1-pass":
                    eps_unet = eps
                else:
                    eps_unet = p2(
                        cfg_lat, enc_state, p1_res, t_vec, embeds,
                        torch.cat([ctrl_images, ctrl_images], 0),
                        torch.cat([ctrl_depths, ctrl_depths], 0),
                        cfg.tile_weight, cfg.depth_weight,
                        cfg.guidance_scale, ip_context=ip2,
                        ref_noisy=ref_noisy).float()
                bw = (1.0 - sa) if cfg.blend_mode == "dynamic" else 0.5
                eps_final = bw * eps_3d + (1 - bw) * eps_unet
                t_prev = int(steps[i + 1]) if i + 1 < len(steps) else -1
                latents, solver_state = S.dpmsolver_step(
                    sch, latents, eps_final, int(t), t_prev, solver_state)
                if ref_noisy is not None:
                    # the reference rows stay on schedule: their eps is the
                    # residual noise of the clean reference latents
                    ref_eps = (ref_noisy - sa * ref_latents) / sn
                    ref_noisy, ref_solver_state = S.dpmsolver_step(
                        sch, ref_noisy, ref_eps, int(t), t_prev,
                        ref_solver_state)
                if pt is not None:
                    pt.tick("denoise_p2+vae_enc+solver", latents,
                            sig=(len(bsel), in_mesh_phase))
            if progress_callback:
                progress_callback(i, len(steps))

        # ---- decimate + texture-only refinement + bake
        pt = phase_timer()
        if pt is not None:
            pt.mark()
        out_mesh = self._extract_and_bake(mesh_state, last_mt, tgt, draws,
                                          lpips_params)
        if pt is not None:
            pt.tick("bake", None if out_mesh is None
                    else torch.as_tensor(out_mesh.albedo, device=dev))
        return {"mesh": out_mesh, "nerf_params": nerf_params,
                "mesh_state": mesh_state, "renders": renders}

    # ---------------- helpers -------------------------------------------

    def _init_mesh_phase(self, nerf_params, device=None):
        """The switch to DMTet (reference `__call__`, mvedit_3d.py:847-862):
        the structured tet grid, or with `structured_tets=False` the
        unstructured one of `build_grid_tets`, sdf from the field's
        density, zero deform, the optimizer. Returns (tet_grid,
        mesh_state, optimizer)."""
        cfg = self.cfg
        tet_grid = (StructuredTetGrid(cfg.tet_resolution)
                    if cfg.structured_tets
                    else build_grid_tets(cfg.tet_resolution))
        sdf0 = MF.init_sdf_from_density(
            lambda x: self._decode_fn(nerf_params, x)[0], tet_grid,
            device=device)
        state = {"field": nerf_params, "sdf": sdf0,
                 "deform": torch.zeros((len(tet_grid.verts), 3),
                                       device=sdf0.device)}
        opt = self._mesh_fit_fns(tet_grid, cfg.n_inverse_steps)[1](state)
        return tet_grid, state, opt

    def _render_all(self, nerf_params, mesh_state, last_mt, grid, tgt, rs):
        """Render the bucket's views (poses, intrinsics at the full render
        size) at rs, one view after another."""
        intr = tgt["intrinsics"] * (rs / self.cfg.render_size)
        return self._render_chunk(nerf_params, mesh_state, last_mt, grid,
                                  tgt["poses"], intr, rs)

    @torch.no_grad()
    def _render_chunk(self, nerf_params, mesh_state, last_mt, grid, poses,
                      intr, rs):
        """Render views of the current 3D state: the volume render of the
        field before the switch, the mesh with the albedo field after it.
        Returns rgb (N, rs, rs, 3), depth (N, rs, rs), alpha (N, rs, rs,
        1)."""
        cfg = self.cfg
        if mesh_state is None:
            render = NF.make_multiview_renderer(
                self._decode_fn, rs, rs, cfg.render, chunk=rs * 128)
            out = render(nerf_params, poses, intr, grid)
            return {"rgb": out["rgb"], "depth": out["depth"],
                    "alpha": out["alpha"][..., None]}
        mt = last_mt
        out = render_views(mt["verts"], mt["faces"], mt["face_mask"],
                           poses, intr, self._mesh_raster_cfg(rs),
                           shading_fun=FieldShading(cfg.ingp),
                           shading_params=mesh_state["field"])
        return {"rgb": out["rgb"], "depth": out["depth"],
                "alpha": out["alpha"]}

    def _compact_mesh(self, mt):
        """Masked extraction buffers -> (verts (V', 3) float32, faces (F', 3)
        int32) numpy over the referenced verts, or (None, None)."""
        verts = mt["verts"].detach().cpu().numpy()
        faces = mt["faces"].cpu().numpy()
        fmask = mt["face_mask"].cpu().numpy()
        faces = faces[fmask]
        if len(faces) == 0:
            return None, None
        used = np.unique(faces)
        remap = np.full(len(verts), -1, np.int64)
        remap[used] = np.arange(len(used))
        return (verts[used].astype(np.float32),
                remap[faces].astype(np.int32))

    def _extract_and_bake(self, mesh_state, last_mt, tgt, draws,
                          lpips_params=None, atlas_size=1024):
        """The final mesh: decimation + texture-only refinement of the
        albedo field when `mesh_reduction` < 1 (the native QEM library;
        skipped, as in the reference, when it is missing), the UV atlas
        (xatlas, or the per-triangle grid atlas) and the bake of the field
        into it. Returns a `Mesh` with `albedo`, or None."""
        cfg = self.cfg
        if mesh_state is None:
            return None
        verts, faces = self._compact_mesh(last_mt)
        if verts is None:
            # a degenerate extraction (e.g. an empty density field)
            return None
        field = mesh_state["field"]
        dev = mesh_state["sdf"].device
        if cfg.mesh_reduction < 1.0 and len(faces) > 64:
            if native_available():
                target = max(int(round(len(faces) * cfg.mesh_reduction)), 16)
                verts_d, faces_d = decimate_qem(verts, faces, target)
                if len(faces_d) >= 16:
                    verts, faces = (verts_d.astype(np.float32),
                                    faces_d.astype(np.int32))
                    mcfg = MF.MeshFitConfig(
                        raster=self._mesh_raster_cfg(cfg.render_size),
                        patch_size=min(cfg.patch_size, cfg.render_size))
                    refine, make_opt = MF.make_texture_refine(
                        self._color_fn, mcfg,
                        n_steps=cfg.mesh_simplify_texture_steps,
                        mesh=self.device_mesh)
                    sw = {**MF.default_mesh_schedule_weights(mcfg),
                          "lr": cfg.end_lr,
                          "patch_rgb": cfg.end_patch_rgb_weight}
                    field, _, _ = refine(
                        field, make_opt(field), torch.as_tensor(
                            verts, device=dev),
                        torch.as_tensor(faces, device=dev).long(), tgt,
                        sched=sw, lpips_params=lpips_params,
                        draws=draws.refine(refine, tgt,
                                           cfg.mesh_simplify_texture_steps))
        mesh = Mesh(v=verts, f=faces)
        mesh.auto_normal()
        mesh.auto_uv()
        acfg = RasterConfig(height=atlas_size, width=atlas_size, tile=16,
                            k_per_tile=64, k_big=32)

        def t(x, dtype=torch.float32):
            return torch.as_tensor(x, dtype=dtype, device=dev)
        f = t(mesh.f, torch.int64)
        rgb, mask = bake_texture(
            t(mesh.v), f, torch.ones(f.shape[0], dtype=torch.bool,
                                     device=dev),
            t(mesh.vt), t(mesh.ft, torch.int64), FieldColor(cfg.ingp), acfg,
            field_params=field)
        rgb = edge_dilation(rgb, mask, n_iters=16)
        mesh.albedo = rgb.clamp(0, 1).cpu().numpy()
        return mesh
