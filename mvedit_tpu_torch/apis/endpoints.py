"""Endpoints (mixed into Adapter3DRunner).

Counterpart of `mvedit_tpu/apis/endpoints.py`; so far `run_text_to_img`,
`load_init_mesh`, `run_3d_to_3d` (mesh editing: init renders -> the MVEdit
loop -> a textured GLB, optionally chained into texture superres) and
texture superres (`proc_texture_superres`, `run_texture_superres`).
"""
import numpy as np
import torch

from . import cameras as C
from ..models.diffusion import schedulers as S
from ..models.mesh import RasterConfig, render_views
from ..ops.tonemapping import Tonemapping
from ..utils import camera as cam_utils
from ..utils.geometry import normalize_depth

__all__ = ["EndpointsMixin"]


class EndpointsMixin:
    @torch.no_grad()
    def load_init_mesh(self, mesh, poses, intrinsics, render_size,
                       cam_lights, ambient=0.3, bg_color=1.0):
        """Render the input mesh with Lambertian point-light shading to
        initialise MVEdit (adapter3d_mixin.py:21-66 load_init_mesh).

        mesh: any object with `.v` (V, 3), `.f` (F, 3) and `.vc` (vertex
        colours or None); poses (N, 3, 4) c2w, intrinsics (N, 4) and
        cam_lights (N, 3), as numpy or tensors. Returns tensors on the
        runner's device: images (N, H, W, 3), masks (N, H, W, 1), depths
        (N, H, W), normals (N, H, W, 3) in [0, 1]."""
        dev = self.device

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
        tm = Tonemapping()
        rc = RasterConfig(height=render_size, width=render_size)
        faces = t(mesh.f, torch.int64)
        out = render_views(t(mesh.v), faces,
                           torch.ones(faces.shape[0], dtype=torch.bool,
                                      device=dev),
                           t(poses), t(intrinsics), rc)
        alpha, n = out["alpha"], out["normal"]
        lam = (t(cam_lights)[:, None, None, :] * n).sum(
            -1, keepdim=True).clamp(min=0.0)
        shading = lam * (1 - ambient) + ambient
        albedo = 0.8 if mesh.vc is None else t(mesh.vc).mean()
        base = albedo * torch.ones_like(n)
        rgb = tm.lut(tm.inverse_lut(base)
                     + torch.log2(shading.clamp(min=1e-6)))
        images = (rgb * alpha + bg_color * (1 - alpha)).clamp(0, 1)
        return {"images": images, "masks": alpha,
                "depths": normalize_depth(out["depth"], alpha),
                "normals": n * 0.5 + 0.5}

    def run_text_to_img(self, prompt, negative_prompt="", seed=42,
                        width=None, height=None, steps=24, cfg_scale=7.0):
        """Plain SD text-to-image -> (H, W, 3) float32 numpy in [0, 1]."""
        m = self.load_stable_diffusion()
        width = width or (64 if self.tiny else 512)
        height = height or (64 if self.tiny else 512)
        ds = 2 ** (len(m.vae.cfg.block_out_channels) - 1)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        lat = torch.randn((1, height // ds, width // ds, 4), generator=gen,
                          device=self.device)
        return self.text_to_img_from_latents(m, prompt, negative_prompt,
                                             lat, steps, cfg_scale)

    @torch.inference_mode()
    def text_to_img_from_latents(self, m, prompt, negative_prompt, lat,
                                 steps, cfg_scale):
        """The sampling loop of `run_text_to_img` from given initial
        latents (1, h, w, 4): CFG DPM-Solver++ over trailing timesteps,
        then a VAE decode."""
        pos, neg = self.encode_prompt(m, [prompt], [negative_prompt])
        sch = m.schedule
        timesteps = S.make_timesteps(steps, sch.num_train_timesteps,
                                     "trailing")
        state = S.SolverState.init(lat)
        e2 = torch.cat([neg, pos], 0)
        for i, t in enumerate(timesteps):
            tp = int(timesteps[i + 1]) if i + 1 < len(timesteps) else -1
            t2 = torch.full((2,), int(t), dtype=torch.int32,
                            device=lat.device)
            eps = m.unet(torch.cat([lat, lat], 0), t2, e2)
            eu, ec = eps.chunk(2, 0)
            g = eu + cfg_scale * (ec - eu)
            lat, state = S.dpmsolver_step(sch, lat, g, int(t), tp, state)
        img = m.vae.decode(lat)
        return ((img[0] + 1) / 2).clamp(0, 1).float().cpu().numpy()

    # ------------------------------------------------------------------
    def _mvedit_cfg(self, num_views, steps, n_inverse_steps,
                    init_inverse_steps, keep_first_views=0, mode="2-pass",
                    **overrides):
        from ..models.fields import INGPConfig
        from ..models.volume_renderer import RenderConfig
        from ..ops.dense_grid import DenseGridConfig
        from ..pipelines.mvedit_3d import MVEdit3DConfig
        tiny = self.tiny
        ingp = INGPConfig(backend="dense", dense=DenseGridConfig(
            resolutions=(8, 32) if tiny else (32, 160)))
        tet_resolution = overrides.pop("tet_resolution", 16 if tiny else 128)
        return MVEdit3DConfig(
            num_views=num_views,
            # view schedule 32 -> 16 -> 9, clamped for small rigs
            mid_num_views=overrides.pop("mid_num_views", min(16, num_views)),
            min_num_views=overrides.pop("min_num_views", min(9, num_views)),
            keep_first_views=keep_first_views,
            render_size=64 if tiny else 512,
            render_size_ramp=overrides.pop("render_size_ramp", not tiny),
            diffusion_steps=steps,
            n_inverse_steps=n_inverse_steps,
            init_inverse_steps=init_inverse_steps,
            tet_init_inverse_steps=overrides.pop(
                "tet_init_inverse_steps", 8 if tiny else 120),
            tet_resolution=tet_resolution,
            # decimation above the reference's 128 grid
            mesh_reduction=min(1.0, 128 / tet_resolution),
            patch_size=16 if tiny else 128,
            mode=mode,
            use_lpips=overrides.pop("use_lpips", not tiny),
            ingp=ingp,
            render=RenderConfig(num_samples=32 if tiny else 128,
                                grid_size=16 if tiny else 128),
            **overrides)

    @staticmethod
    def _join_prompts(prompt, aux):
        return ", ".join(p for p in (prompt, aux) if p)

    def _parse_nerf_mesh(self, kwargs, task_overrides=None):
        """The public nerf_mesh parameter schema: defaults <- per-task
        overrides <- caller kwargs (None keeps the default)."""
        from . import parameters as P
        nk = dict(P.nerf_mesh_defaults)
        nk.update(task_overrides or {})
        for k, v in kwargs.items():
            if k in nk and v is not None:
                nk[k] = v
        return nk

    def _cfg_from_schema(self, nk, num_views, keep_first_views=0,
                         default_init_steps=None):
        """nerf_mesh schema dict -> MVEdit3DConfig."""
        tiny = self.tiny
        return self._mvedit_cfg(
            num_views,
            nk["steps"] or (2 if tiny else 24),
            nk["n_inverse_steps"] or (4 if tiny else 80),
            nk["init_inverse_steps"] or default_init_steps
            or (8 if tiny else 256),
            keep_first_views=keep_first_views,
            mode=nk["mvedit_mode"],
            guidance_scale=float(nk["cfg_scale"]),
            denoising_strength=float(nk["denoising_strength"]
                                     if nk["denoising_strength"]
                                     is not None else 1.0),
            mid_num_views=min(16, num_views),
            min_num_views=min(int(nk["min_num_views"]), num_views),
            patch_bs=int(nk["patch_bs_nerf"]),
            alpha_soften=float(nk["alpha_soften"]),
            start_normal_reg_weight=float(nk["normal_reg_weight"]),
            start_entropy_weight=float(nk["start_entropy_weight"]),
            end_entropy_weight=float(nk["end_entropy_weight"]),
            entropy_d=float(nk["entropy_d"]),
            mesh_smoothness=float(nk["mesh_smoothness"]),
            start_lr=float(nk["start_lr"]),
            end_lr=float(nk["end_lr"]),
            tet_init_inverse_steps=(2 if tiny
                                    else int(nk["tet_init_inverse_steps"])),
            **({"tet_resolution": int(nk["tet_resolution"])}
               if nk["tet_resolution"] else {}))

    def run_3d_to_3d(self, mesh_path, prompt, negative_prompt="", seed=42,
                     steps=None, num_views=None, n_inverse_steps=None,
                     init_inverse_steps=None, instruct=False,
                     front_view_id=None, out_path=None, draws=None,
                     **kwargs):
        """Mesh editing: render the input mesh's views -> the MVEdit
        denoise <-> reconstruct loop -> a textured mesh (GLB at
        `out_path`). Extra kwargs follow the public nerf_mesh parameter
        schema (`apis/parameters.py`); `superres` (True or a dict of
        `proc_texture_superres` overrides) chains texture superres on the
        live field before the vertices are un-normalised. front_view_id (an index into the
        preprocessing turntable) weights the views by a von Mises pdf
        around its azimuth and appends per-view direction prompts. The
        random draws come from a generator seeded with `seed`, or from
        `draws` (see `pipelines.mvedit_3d.GeneratorDraws`)."""
        from ..pipelines.mvedit_3d import MVEdit3DPipeline
        from . import parameters as P
        dev = self.device
        num_views = num_views or (3 if self.tiny else 32)
        m = self.load_stable_diffusion()
        m.controlnets = self.load_controlnets(
            ("tile", "depth", "ip2p") if instruct else ("tile", "depth"))
        m.segment_fn = None
        m.lpips_params = self.load_lpips()
        m.enhance_fn = None if self.tiny else self.load_image_enhancer()
        pre = self.run_mesh_preproc(mesh_path)
        mesh = pre["mesh"]
        c = self.constants
        # instruct mode: 1-pass, cfg 5.0, the ip2p net on the source renders
        nk = self._parse_nerf_mesh(
            dict(kwargs, steps=steps, n_inverse_steps=n_inverse_steps,
                 init_inverse_steps=init_inverse_steps),
            P.instruct_3d_to_3d_params if instruct
            else P.text_3d_to_3d_params)
        prompt = self._join_prompts(prompt, nk["aux_prompt"])
        negative_prompt = self._join_prompts(negative_prompt,
                                             nk["aux_negative_prompt"])
        cfg = self._cfg_from_schema(nk, num_views)
        rng = np.random.default_rng(seed)
        poses, intr = C.surround_rig(
            num_views, c["proc_3d_to_3d_camera_distance"],
            c["proc_3d_to_3d_fov"], c["proc_3d_to_3d_min_elev"],
            c["proc_3d_to_3d_max_elev"], cfg.render_size, rng=rng)
        lights, _ = cam_utils.light_sampling(poses, rng=rng)
        init = self.load_init_mesh(mesh, poses, intr, cfg.render_size,
                                   lights)
        # no normal supervision: the reference passes normal_model=None
        cam_weights = np.ones((num_views,), np.float32)
        prompts = [prompt] * num_views
        if front_view_id is not None and \
                0 <= front_view_id < c["preproc_num_views"]:
            from scipy.stats import vonmises
            front_azi = front_view_id / c["preproc_num_views"] * 2 * np.pi
            cam_azi = np.arctan2(poses[:, 1, 3], poses[:, 0, 3])
            cam_weights = (vonmises.pdf(
                cam_azi, loc=front_azi,
                kappa=c["vonmises_kappa"]) * 2 * np.pi).astype(np.float32)
            prompts = [self._join_prompts(prompt, s_) for s_ in
                       cam_utils.view_prompts(poses, front_azi)]

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)
        targets = {"images": init["images"], "masks": init["masks"],
                   "poses": t(poses), "intrinsics": t(intr),
                   "cam_weights": t(cam_weights), "cam_lights": t(lights)}
        pos, neg = self.encode_prompt(m, prompts,
                                      [negative_prompt] * num_views)
        pipe = MVEdit3DPipeline(m, cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        out = pipe(targets, pos.clone(), neg.clone(), generator=gen,
                   draws=draws)
        # superres before the un-normalisation: the field lives in the
        # normalised space
        out = self._chain_superres(out, "nerf_params", prompt,
                                   negative_prompt, seed,
                                   kwargs.get("superres", False))
        if out_path and out["mesh"] is not None:
            out["mesh"].v = (out["mesh"].v / pre["scale"]
                             + pre["center"]).astype(np.float32)
            out["mesh"].write(out_path, flip_yz=True)
        return out

    # ------------------------------------------------------------------
    def proc_texture_superres(self, mesh, prompt="", negative_prompt="",
                              seed=42, steps=None, use_ip_adapter=True,
                              init_field_params=None, draws=None):
        """Texture superres of a mesh in memory: 6 surround views and 2
        polar regularization poses (`cameras.superres_cameras`), img2img
        with the tile and depth ControlNets, the albedo field fitted at
        the last step only (512 steps, LPIPS), baked at 2048^2. The dense
        field is (32, 160); `init_field_params` is a preceding stage's live
        albedo field, which the fit starts from. With `use_ip_adapter` and
        an albedo, IP-Adapter prompts each view with its own init render.
        The draws come from a generator seeded with `seed`, or from
        `draws`. The reference also loads the SRVGG enhancer here, which
        its pipeline never reads; the port does not."""
        from ..models.fields import INGPConfig
        from ..ops.dense_grid import DenseGridConfig
        from ..pipelines.superres import (SuperResConfig,
                                          TextureSuperResPipeline)
        tiny, dev = self.tiny, self.device
        m = self.load_stable_diffusion()
        m.controlnets = self.load_controlnets()
        m.lpips_params = self.load_lpips()
        # the rig's elevations from the seed (the reference's are unseeded)
        poses, intr, reg_poses = C.superres_cameras(
            rng=np.random.default_rng(seed))
        all_poses = np.concatenate([poses, reg_poses], axis=0)
        size = 64 if tiny else 512
        cfg = SuperResConfig(
            num_views=len(all_poses), render_size=size,
            atlas_size=128 if tiny else 2048,
            diffusion_steps=steps or (2 if tiny else 24),
            n_inverse_steps=8 if tiny else 512,
            ingp=INGPConfig(backend="dense", dense=DenseGridConfig(
                resolutions=(8, 32) if tiny else (32, 160))))
        pos, neg = self.encode_prompt(
            m, [prompt] * cfg.num_views, [negative_prompt] * cfg.num_views)
        if use_ip_adapter and mesh.albedo is not None:
            # installs m.ip_encode_fn: each view is prompted with its own
            # init render; the atlas only gives the shared tokens
            self.enable_ip_adapter(m, mesh.albedo)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return TextureSuperResPipeline(m, cfg)(
            mesh, t(all_poses), t(intr * (size / 512.0)), pos.clone(),
            neg.clone(), generator=gen, draws=draws,
            init_field_params=init_field_params)

    def run_texture_superres(self, mesh_path, prompt="", negative_prompt="",
                             seed=42, steps=None, out_path=None,
                             use_ip_adapter=True, draws=None):
        """Texture superres of a mesh file: `run_mesh_preproc`, then
        `proc_texture_superres`; the GLB at `out_path`."""
        pre = self.run_mesh_preproc(mesh_path)
        out = self.proc_texture_superres(
            pre["mesh"], prompt=prompt, negative_prompt=negative_prompt,
            seed=seed, steps=steps, use_ip_adapter=use_ip_adapter,
            draws=draws)
        if out_path:
            out["mesh"].write(out_path, flip_yz=True)
        return out

    def _chain_superres(self, out, field_key, prompt, negative_prompt,
                        seed, superres):
        """`proc_texture_superres` on a pipeline's result, with its live
        albedo field (`out[field_key]`) handed over in memory. `superres`
        is True or a dict of `proc_texture_superres` overrides (steps,
        use_ip_adapter, draws)."""
        if not superres or out.get("mesh") is None:
            return out
        kw = dict(superres) if isinstance(superres, dict) else {}
        sr = self.proc_texture_superres(
            out["mesh"], prompt=prompt, negative_prompt=negative_prompt,
            seed=seed, init_field_params=out.get(field_key), **kw)
        out["mesh"] = sr["mesh"]
        out["superres_renders"] = sr["renders"]
        out["superres_fit_losses"] = sr["fit_losses"]
        out["field_params"] = sr["field_params"]
        return out
