"""MVEdit 3D pipeline (counterpart of `mvedit_tpu/pipelines/mvedit_3d.py`;
so far the config, the progress schedules and the DMTet mesh phase).

What is here is what `MVEdit3DPipeline.__call__` runs on every timestep
after progress `nerf_switch_progress` (0.6): the switch to DMTet
(`_init_mesh_phase`), the mesh fit (`_mesh_fit_fns`) with the mesh
schedule (`_sched_weights(progress, "mesh")`), and the re-render of the
views through the mesh branch of `_render_chunk`. The `__call__` loop, the
NeRF phase and the bake come with later slices.

`fit_steps_per_program` chained TPU programs in the reference; here it
keeps one role: the fit runs in chunks of that many steps and the frozen
marching-tets topology is re-snapshotted at the start of each chunk, at
the same steps as in the reference.
"""
from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import numpy as np
import torch

from ..models import mesh_fit as MF
from ..models.fields import FieldShading, INGPConfig, ingp_point_decode
from ..models.mesh import RasterConfig, StructuredTetGrid, render_views

__all__ = ["MVEdit3DConfig", "MVEdit3DPipeline", "default_max_num_views",
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
    latent_size: int = 64
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
    render_view_chunk: int = 2
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
    # the volume renderer's RenderConfig comes with the NeRF slice
    render: Optional[object] = None
    mode: str = "2-pass"
    use_reference: bool = True
    debug: int = 0
    debug_dir: str = "/tmp/mvedit_debug"

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


class MVEdit3DPipeline:
    """The mesh phase of the MVEdit 3D pipeline (see module doc)."""

    def __init__(self, models, cfg: MVEdit3DConfig):
        self.m = models
        self.cfg = cfg
        self._decode_fn = partial(_ingp_decode, ingp_cfg=cfg.ingp)
        self._color_fn = partial(_ingp_color, ingp_cfg=cfg.ingp)
        self._fit_cache = {}

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
                # the extraction caps are `mesh_caps(tet_resolution)`
                mcfg = MF.MeshFitConfig(
                    raster=self._mesh_raster_cfg(cfg.render_size),
                    n_steps=steps,
                    normal_reg_weight=cfg.mesh_normal_reg_weight,
                    laplacian_weight=0.25 * cfg.mesh_smoothness,
                    normal_consistency_weight=0.25 * cfg.mesh_smoothness,
                    patch_size=min(cfg.patch_size, cfg.render_size),
                    freeze_topology=(cfg.freeze_mesh_topology
                                     and cfg.structured_tets))
                self._fit_cache[key] = MF.make_mesh_fit(
                    tet_grid, self._color_fn, mcfg)
            return self._fit_cache[key]

        L = n_steps if cfg.fit_steps_per_program <= 0 \
            else min(n_steps, cfg.fit_steps_per_program)
        chunks = [L] * (n_steps // L) + ([n_steps % L] if n_steps % L else [])
        _, make_opt, extract = get(L)

        def run(state, opt, tgt, sched=None, draws=None, generator=None):
            """draws: None, or a list with one `fit` draws dict per chunk."""
            hists, out = [], None
            for i, steps in enumerate(chunks):
                state, opt, out = get(steps)[0](
                    state, opt, tgt, sched=sched,
                    draws=None if draws is None else draws[i],
                    generator=generator)
                hists.append(out["loss"])
            return state, opt, {"loss": torch.cat(hists), "mt": out["mt"]}
        run.chunks = chunks
        # the draws of every chunk, from one generator
        run.draw = lambda tgt, generator: [
            get(s)[0].draw(tgt, s, generator) for s in chunks]
        return run, make_opt, extract

    def _sched_weights(self, progress, phase):
        if phase != "mesh":
            raise NotImplementedError("the NeRF phase is not ported yet")
        cfg = self.cfg
        return {
            "lr": default_lr_schedule(progress, cfg.start_lr, cfg.end_lr),
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

    def _init_mesh_phase(self, nerf_params, device=None):
        """The switch to DMTet (reference `__call__`, mvedit_3d.py:847-862):
        the structured tet grid, sdf from the field's density, zero deform,
        the optimizer. Returns (tet_grid, mesh_state, optimizer)."""
        cfg = self.cfg
        if not cfg.structured_tets:
            raise NotImplementedError("only the structured tet grid is "
                                      "ported")
        tet_grid = StructuredTetGrid(cfg.tet_resolution)
        sdf0 = MF.init_sdf_from_density(
            lambda x: self._decode_fn(nerf_params, x)[0], tet_grid,
            device=device)
        state = {"field": nerf_params, "sdf": sdf0,
                 "deform": torch.zeros((len(tet_grid.verts), 3),
                                       device=sdf0.device)}
        opt = self._mesh_fit_fns(tet_grid, cfg.n_inverse_steps)[1](state)
        return tet_grid, state, opt

    @torch.no_grad()
    def _render_chunk(self, nerf_params, mesh_state, last_mt, grid, poses,
                      intr, rs):
        """Render views of the current 3D state: the mesh branch (the NeRF
        branch comes with its slice). Returns rgb (N, rs, rs, 3), depth
        (N, rs, rs), alpha (N, rs, rs, 1)."""
        if mesh_state is None:
            raise NotImplementedError("the NeRF renderer is not ported yet")
        mt = last_mt
        out = render_views(mt["verts"], mt["faces"], mt["face_mask"],
                           poses, intr, self._mesh_raster_cfg(rs),
                           shading_fun=FieldShading(self.cfg.ingp),
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
