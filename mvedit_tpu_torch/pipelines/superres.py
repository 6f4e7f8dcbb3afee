"""Texture super-resolution pipeline (counterpart of
`mvedit_tpu/pipelines/superres.py`).

img2img over 6 fixed surround views and 2 polar regularization poses with
the tile and depth ControlNets (and, when the models carry them,
IP-Adapter tokens of each view's own init render); the albedo field is
fitted once, to the final views, then baked into a 2048^2 atlas (32 x 32
raster tiles) and blended with the original albedo.

The draws come from a draw source (`GeneratorDraws`' `view_noise`,
`field_init` and `texture_fit`): the latent noise, one image per view,
then the field init, which is skipped when a live field is handed over
(the reference splits its key for it all the same and draws nothing after
it).
"""
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.diffusion import schedulers as S
from ..models.fields import FieldColor, INGPConfig
from ..models.mesh import Mesh, RasterConfig, bake_texture, render_views
from ..models.mesh.texture import _sample_level
from ..ops.clip import clip
from ..ops.image import edge_dilation
from ..utils.geometry import normalize_depth
from ..utils.profiling import phase
from .mvedit_3d import GeneratorDraws
from .texture import TextureConfig, camera_dense_weighting, make_texture_fit

__all__ = ["SuperResConfig", "TextureSuperResPipeline"]


@dataclass(frozen=True)
class SuperResConfig:
    num_views: int = 8              # 6 surround + 2 regularization
    render_size: int = 512
    atlas_size: int = 2048
    diffusion_steps: int = 24
    denoising_strength: float = 0.4
    guidance_scale: float = 7.0
    tile_weight: float = 1.0
    depth_weight: float = 0.5
    n_inverse_steps: int = 512
    lr: float = 0.01
    blend_original_weight: float = 0.5
    ingp: INGPConfig = field(default_factory=INGPConfig)


def _views(fn):
    """fn (a VAE half) over all views at once, in inference mode, as a
    float32 tensor that autograd may use."""
    def call(x):
        with torch.inference_mode():
            out = fn(x)
        return out.float().clone()
    return call


class TextureSuperResPipeline:
    """`models` holds unet, controlnets (tile, depth), vae, schedule;
    optionally lpips_params, and the IP-Adapter's ip_context (2, T, C)
    with its ip_encode_fn (the runner's `enable_ip_adapter`)."""

    def __init__(self, models, cfg: SuperResConfig):
        self.m = models
        self.cfg = cfg

    @torch.no_grad()
    def _geometry(self, mesh, poses, intrinsics, with_uv):
        """The frozen mesh's views: xyz, alpha, depth, normal and, with
        `with_uv`, the atlas uv of each pixel (one render of both)."""
        dev = poses.device
        faces = torch.as_tensor(np.asarray(mesh.f), dtype=torch.int64,
                                device=dev)
        attrs = {"uv": torch.as_tensor(np.asarray(mesh.vt, np.float32),
                                       device=dev)} if with_uv else None
        rc = RasterConfig(height=self.cfg.render_size,
                          width=self.cfg.render_size)
        return render_views(
            torch.as_tensor(np.asarray(mesh.v, np.float32), device=dev),
            faces, torch.ones(faces.shape[0], dtype=torch.bool, device=dev),
            poses, intrinsics, rc, vert_attrs=attrs)

    def __call__(self, mesh: Mesh, poses, intrinsics, prompt_embeds,
                 negative_embeds, generator=None, draws=None,
                 init_renders=None, init_field_params=None):
        """mesh: a `Mesh`; poses (N, 3, 4) and intrinsics (N, 4) tensors on
        the models' device; prompt_embeds / negative_embeds (N, L, C).
        init_renders: (N, H, W, 3) views to start from; else the live
        albedo field `init_field_params` (handed over by a preceding stage:
        the fit warm-starts from it), else the mesh's albedo sampled
        through its per-vertex uvs, else white. Returns {"mesh" (with an
        atlas_size^2 albedo), "renders" (N, H, W, 3), "field_params",
        "fit_losses" (n_inverse_steps,)}."""
        cfg, m = self.cfg, self.m
        sch = m.schedule
        N = cfg.num_views
        dev = poses.device
        draws = draws if draws is not None else GeneratorDraws(generator)
        vae_enc, vae_dec = _views(m.vae.encode), _views(m.vae.decode)
        from .denoise import DenoiseModels, make_noise_pred_2pass
        ip_ctx = getattr(m, "ip_context", None)
        p1, p2 = make_noise_pred_2pass(DenoiseModels(
            unet=m.unet, controlnets=tuple(m.controlnets), num_views=N,
            ip_tokens=0 if ip_ctx is None else int(ip_ctx.shape[1])))

        # the frozen-mesh views, with the atlas uvs when the init renders
        # come from the atlas
        with_uv = (init_renders is None and init_field_params is None
                   and mesh.albedo is not None and mesh.vt is not None
                   and len(mesh.vt) == len(mesh.v))
        geo = self._geometry(mesh, poses, intrinsics, with_uv)
        alpha = geo["alpha"]
        geom = {"xyz": geo["xyz"], "alpha": alpha,
                "weight": camera_dense_weighting(geo["normal"], poses,
                                                 alpha)}
        ctrl_depths = normalize_depth(geo["depth"], alpha)[..., None].expand(
            -1, -1, -1, 3)
        color_fn = FieldColor(cfg.ingp)

        # init renders: explicit > live field > the mesh's atlas > white
        if init_renders is None and (init_field_params is not None
                                     or with_uv):
            with torch.no_grad():
                rgb = color_fn(init_field_params, geo["xyz"]) \
                    if init_field_params is not None else _sample_level(
                        torch.as_tensor(np.asarray(mesh.albedo, np.float32),
                                        device=dev), geo["uv"])
            init_renders = clip(rgb * alpha + (1 - alpha), 0.0, 1.0)
        elif init_renders is None:
            init_renders = torch.ones((N, cfg.render_size, cfg.render_size,
                                       3), device=dev)

        # each view's own init render prompts it through IP-Adapter
        # ((2N, T, C), uncond rows first); without an encoder the shared
        # [uncond; cond] tokens
        ip_encode_fn = getattr(m, "ip_encode_fn", None)
        if ip_ctx is not None and ip_encode_fn is not None:
            ip2 = ip_encode_fn(init_renders)
        elif ip_ctx is not None:
            ip2 = torch.cat([ip_ctx[:1].expand(N, -1, -1),
                             ip_ctx[1:2].expand(N, -1, -1)], 0)
        else:
            ip2 = None

        timesteps = S.make_timesteps(cfg.diffusion_steps,
                                     sch.num_train_timesteps, "trailing")
        timesteps = timesteps[int(len(timesteps)
                                  * (1 - cfg.denoising_strength)):]
        for i, t in enumerate(timesteps):
            with phase("superres_denoise", dev, sig=0):
                if i == 0:
                    # the first step's phase carries the encode
                    lat0 = vae_enc(init_renders * 2 - 1)
                    latents = S.add_noise(
                        sch, lat0, draws.view_noise(lat0.shape, dev), int(t))
                    solver_state = S.SolverState.init(latents)
                    embeds = torch.cat([negative_embeds, prompt_embeds], 0)
                    depths2 = torch.cat([ctrl_depths, ctrl_depths], 0)
                t = int(t)
                t_vec = torch.full((2 * N,), t, dtype=torch.int32,
                                   device=dev)
                lat2 = torch.cat([latents, latents], 0)
                eps, enc_state, p1_res = p1(
                    lat2, t_vec, embeds, depths2, cfg.depth_weight,
                    cfg.guidance_scale, ip_context=ip2)
                sa, sn = sch.sqrt_acp(t)
                decoded = clip((vae_dec((latents - sn * eps.float()) / sa)
                                + 1) / 2, 0.0, 1.0)
                eps_unet = p2(lat2, enc_state, p1_res, t_vec, embeds,
                              torch.cat([decoded, decoded], 0), depths2,
                              cfg.tile_weight, cfg.depth_weight,
                              cfg.guidance_scale, ip_context=ip2)
                t_prev = int(timesteps[i + 1]) if i + 1 < len(timesteps) \
                    else -1
                latents, solver_state = S.dpmsolver_step(
                    sch, latents, eps_unet.float(), t, t_prev, solver_state)

        with phase("superres_tex_fit", dev):
            final_views = clip((vae_dec(latents) + 1) / 2, 0.0, 1.0)
            # the albedo field is fitted once, to the final views
            tcfg = TextureConfig(num_views=N, render_size=cfg.render_size,
                                 n_inverse_steps=cfg.n_inverse_steps,
                                 lr=cfg.lr, ingp=cfg.ingp)
            params = init_field_params if init_field_params is not None \
                else draws.field_init(cfg.ingp, dev)
            fit, make_optimizer = make_texture_fit(
                color_fn, tcfg, getattr(m, "lpips_params", None))
            targets = {"images": final_views}
            params, _, losses = fit(params, make_optimizer(params), geom,
                                    targets,
                                    draws=draws.texture_fit(fit, targets))

        with phase("superres_bake", dev):
            out_mesh = self.bake(mesh, params, dev)
        return {"mesh": out_mesh, "renders": final_views,
                "field_params": params, "fit_losses": losses}

    @torch.no_grad()
    def bake(self, mesh, params, device):
        """The field baked into an atlas_size^2 atlas (32 x 32 raster
        tiles, K 64 + 32), edge-dilated 8 texels and blended with the
        mesh's albedo where the shapes match: a copy of the mesh with the
        new albedo (numpy)."""
        cfg = self.cfg
        out_mesh = Mesh(v=np.asarray(mesh.v).copy(),
                        f=np.asarray(mesh.f).copy(), vn=mesh.vn, fn=mesh.fn,
                        vt=mesh.vt, ft=mesh.ft)
        if out_mesh.vt is None:
            out_mesh.auto_uv()
        acfg = RasterConfig(height=cfg.atlas_size, width=cfg.atlas_size,
                            tile=32, k_per_tile=64, k_big=32)

        def t_(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        faces = t_(out_mesh.f, torch.int64)
        rgb, mask = bake_texture(
            t_(out_mesh.v), faces,
            torch.ones(faces.shape[0], dtype=torch.bool, device=device),
            t_(out_mesh.vt), t_(out_mesh.ft, torch.int64),
            FieldColor(cfg.ingp), acfg, field_params=params)
        rgb = edge_dilation(rgb, mask, n_iters=8)
        new_albedo = clip(rgb, 0.0, 1.0).cpu().numpy()
        if mesh.albedo is not None \
                and mesh.albedo.shape == new_albedo.shape:
            w = cfg.blend_original_weight
            new_albedo = new_albedo * (1 - w) + mesh.albedo * w
        out_mesh.albedo = new_albedo
        return out_mesh
