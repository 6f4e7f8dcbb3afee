"""Endpoints (mixed into Adapter3DRunner).

Counterpart of `mvedit_tpu/apis/endpoints.py`; so far `run_text_to_img`,
`load_init_mesh`, `run_3d_to_3d` (mesh editing: init renders -> the MVEdit
loop -> a textured GLB, optionally chained into texture superres),
texture superres (`proc_texture_superres`, `run_texture_superres`) and
image-to-3D (`load_zero123plus`, `load_zero123plus_normal`,
`run_zero123plus`, `proc_zero123plus`, `run_zero123plus1_2`,
`run_zero123plus_to_mesh`, `run_zero123plus1_2_to_mesh`; v1.2 with its
generated normals by default) and text-to-3D (`run_stablessdnerf`,
`distill_triplane_to_field`, `run_stablessdnerf_to_mesh`).
"""
import numpy as np
import torch

from . import cameras as C
from ..models.diffusion import SD15_UNET, UNet2DCondition
from ..models.diffusion import schedulers as S
from ..models.mesh import RasterConfig, render_views
from ..ops.tonemapping import Tonemapping
from ..pipelines.mvedit_3d import GeneratorDraws
from ..utils import camera as cam_utils
from ..utils.geometry import normalize_depth
from ..utils.profiling import phase_timer

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
        from ..ops.hash_grid import HashGridConfig
        from ..pipelines.mvedit_3d import MVEdit3DConfig
        tiny = self.tiny
        # the dense backend runs; the hash widths are the reference's
        ingp = INGPConfig(
            backend="dense",
            dense=DenseGridConfig(resolutions=(8, 32) if tiny
                                  else (32, 160)),
            hash=HashGridConfig(n_levels=4 if tiny else 12,
                                log2_hashmap_size=12 if tiny else 19,
                                base_resolution=4 if tiny else 16,
                                max_resolution=32 if tiny else 320))
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

    # ------------------------------------------------------------------
    def load_zero123plus(self, version="1.1"):
        """The Zero123++ models on a fresh namespace: the SD1.5 stack (its
        UNet as Zero123++'s, as the reference runs it), a CLIP ViT-L/14
        vision tower with a 768 projection (`zero123plus_vision/` in
        `checkpoint_dir`, else seeded), `ramping` linspace(0, 1, L),
        `text_uncond` zeros (1, L, C) (L = 77, tiny 8) and the
        v-prediction schedule. The namespace is new per call, so the MVEdit
        pass that follows keeps the epsilon schedule."""
        from ..models.diffusion.clip import CLIPVisionConfig, CLIPVisionModel
        from ..models.diffusion.weights import convert_clip_vision
        m = self.load_stable_diffusion()
        if self.tiny:
            vcfg = CLIPVisionConfig(image_size=32, patch_size=8,
                                    hidden_size=32, intermediate_size=64,
                                    num_layers=2, num_heads=4,
                                    projection_dim=32)
        else:
            vcfg = CLIPVisionConfig(projection_dim=768)
        m.vision = self._build(f"z123_vision:{version}",
                               lambda: CLIPVisionModel(vcfg), seed_offset=3,
                               subdir="zero123plus_vision",
                               convert=convert_clip_vision)
        L = 8 if self.tiny else 77
        m.text_uncond = torch.zeros((1, L, m.text_cfg.hidden_size),
                                    device=self.device)
        m.ramping = np.linspace(0, 1, L).astype(np.float32)
        m.schedule = S.sd_schedule(prediction_type="v_prediction")
        return m

    def load_zero123plus_normal(self, version="1.2"):
        """The v1.2 normal-generation models on a fresh namespace: those of
        `load_zero123plus` with a second SD1.5 UNet
        (`zero123plus_normal_unet/` in `checkpoint_dir`, else seeded with
        `seed + 7`) in place of the RGB pass's, and the normal ControlNet
        (`controlnet_z123_normal/`), whose hint is the generated RGB
        grid."""
        m = self.load_zero123plus(version)
        cfg = self._tiny_unet_cfg() if self.tiny else SD15_UNET
        m.unet = self._build(f"z123_normal_unet:{version}",
                             lambda: UNet2DCondition(cfg), seed_offset=7,
                             subdir="zero123plus_normal_unet")
        m.controlnet = self.load_controlnets(kinds=("z123_normal",))[0]
        return m

    def run_zero123plus(self, image, seed=42, num_steps=None,
                        version="1.1", return_normal=False, draws=None,
                        normal_draws=None):
        """Image (H, W, 3) in [0, 1] -> the 6-view grid (960, 640, 3)
        float32 numpy in [0, 1] (tiny (48, 32)), 40 steps (tiny 2); v1.2
        rolls the grid latents. With `return_normal`, a second pass through
        the normal models (`load_zero123plus_normal`) with the grid as the
        ControlNet's hint returns (grid, normal_grid). The draws come from
        a generator seeded with `seed` (the normal pass's with seed +
        1000), or from `draws` / `normal_draws` (`Zero123PlusDraws`'
        methods)."""
        from ..ops.image import resize_bilinear
        from ..pipelines.zero123plus import (Zero123PlusConfig,
                                             Zero123PlusPipeline)
        m = self.load_zero123plus(version)
        cfg = Zero123PlusConfig(
            num_steps=num_steps or (2 if self.tiny else 40),
            grid_hw=(48, 32) if self.tiny else (960, 640),
            shift_views=(version == "1.2"))
        img = torch.as_tensor(np.asarray(image, np.float32),
                              device=self.device)
        if img.dim() == 3:
            img = img[None]
        H, W = cfg.grid_hw
        s = m.vision.cfg.image_size
        img_r, clip_px = resize_bilinear(img, (H, W)), \
            resize_bilinear(img, (s, s))

        def gen(seed_):
            g = torch.Generator(device=self.device)
            g.manual_seed(seed_)
            return g
        out = Zero123PlusPipeline(m, cfg)(img_r, clip_px,
                                          generator=gen(seed), draws=draws)
        grid = out[0].float().cpu().numpy()
        if not return_normal:
            return grid
        nout = Zero123PlusPipeline(self.load_zero123plus_normal(version),
                                   cfg)(img_r, clip_px,
                                        generator=gen(seed + 1000),
                                        draws=normal_draws,
                                        normal_cond=out)
        return grid, nout[0].float().cpu().numpy()

    @staticmethod
    def _split_grid(grid):
        """(3h, 2w, 3) grid -> (6, h, w, 3) views, row-major (the rig's
        order)."""
        gh, gw = grid.shape[:2]
        vh, vw = gh // 3, gw // 2
        return np.stack([grid[r * vh:(r + 1) * vh, c * vw:(c + 1) * vw]
                         for r in range(3) for c in range(2)])

    def proc_zero123plus(self, image, seed=42, passes=None, num_steps=None,
                         version="1.1", return_normals=False,
                         z123_draws=None):
        """`passes` Zero123++ runs (6, tiny 1) of seeds seed + p -> the
        stacked views (6 passes, h, w, 3); odd passes mirror the input and
        un-mirror their views. With `return_normals`, also the normal
        pass's views; a mirrored pass's normals get their x channel
        inverted (1 - n) before the un-mirror. `z123_draws(pass_seed)`
        gives a pass's draw source (default: its seeded generator), also
        for the normal pass at pass_seed + 1000."""
        passes = passes or (1 if self.tiny else 6)
        img = np.asarray(image, np.float32)
        views, normals = [], []

        def draws(seed_):
            return None if z123_draws is None else z123_draws(seed_)
        for p in range(passes):
            mirrored = p % 2 == 1
            src = np.ascontiguousarray(img[:, ::-1]) if mirrored else img
            out = self.run_zero123plus(
                src, seed=seed + p, num_steps=num_steps, version=version,
                return_normal=return_normals, draws=draws(seed + p),
                normal_draws=(draws(seed + p + 1000) if return_normals
                              else None))
            grid, ngrid = out if return_normals else (out, None)
            v6 = self._split_grid(grid)
            views.append(v6[:, :, ::-1] if mirrored else v6)
            if ngrid is not None:
                n6 = self._split_grid(ngrid).copy()
                if mirrored:
                    n6[..., 0] = 1.0 - n6[..., 0]
                    n6 = n6[:, :, ::-1]
                normals.append(n6)
        views = np.ascontiguousarray(np.concatenate(views, axis=0))
        if return_normals:
            return views, np.ascontiguousarray(np.concatenate(normals, 0))
        return views

    def run_zero123plus1_2(self, image, seed=42, num_steps=None):
        """Zero123++ v1.2's 6-view grid (the latent roll; no normals)."""
        return self.run_zero123plus(image, seed=seed, num_steps=num_steps,
                                    version="1.2")

    def run_zero123plus1_2_to_mesh(self, image, seed=42, out_path=None,
                                   passes=None, in_pose=None, **kwargs):
        """v1.2 image-to-3D on the v1.2 rig, with the generated normals
        (unless `use_normals=False` or `gen_normals=False`); see
        `run_zero123plus_to_mesh`."""
        return self.run_zero123plus_to_mesh(
            image, seed=seed, out_path=out_path, passes=passes,
            in_pose=in_pose, version="1.2", **kwargs)

    def run_zero123plus_to_mesh(self, image, seed=42, out_path=None,
                                passes=None, in_pose=None, version="1.1",
                                draws=None, z123_draws=None, **kwargs):
        """Image-to-3D: Zero123++ passes (6, tiny 1; `proc_zero123plus`)
        plus the input image as view 0 (weight 3.0; its pose from LoFTR +
        the epipolar elevation solve, else the rig's front pose) -> the
        MVEdit loop (view 0 never pruned, 640 init inverse steps for v1.1,
        720 for v1.2), with TRACER masks of the initial views and of the
        decoded views at every step, Omnidata normals supervising view 0,
        IP-Adapter on the input image -> a GLB at `out_path`. v1.2 (with
        `use_normals` and `gen_normals`) also runs the normal pass: each
        generated view goes through `preproc.zero123plus_postprocess`, its
        mask becomes min(TRACER, the normal-norm matte) (view 0 keeps
        TRACER's), and its composited normals supervise it (all normal
        weights 1). Extra kwargs follow the nerf_mesh schema
        (`apis/parameters.py`) and `segment`, `use_normals`,
        `gen_normals`, `estimate_pose`, `use_ip_adapter` (all True by
        default), `prompt`, `negative_prompt` and `superres`. The MVEdit
        draws come from a generator seeded with `seed`, or from `draws`;
        Zero123++'s from `z123_draws` (see `proc_zero123plus`). The result
        adds "views" (the generated views), "normals" (the generated
        normals, or None), "in_pose" and "pose_route" ("estimated",
        "given" or "front")."""
        from ..ops.image import resize_bilinear
        from ..pipelines.mvedit_3d import MVEdit3DPipeline
        from ..pipelines.preproc import zero123plus_postprocess
        tiny, dev = self.tiny, self.device
        passes = passes or (1 if tiny else 6)
        gen_normal = (version == "1.2" and kwargs.get("use_normals", True)
                      and kwargs.get("gen_normals", True))
        out = self.proc_zero123plus(image, seed=seed, passes=passes,
                                    version=version,
                                    return_normals=gen_normal,
                                    z123_draws=z123_draws)
        views, gen_normals = out if gen_normal else (out, None)
        poses44, fov, dist = (C.zero123plus_v11_rig() if version == "1.1"
                              else C.zero123plus_v12_rig())
        n_gen = 6 * passes
        gen_poses = poses44[:n_gen, :3]
        route = "given" if in_pose is not None else "front"
        if in_pose is None and kwargs.get("estimate_pose", True):
            n_ref = min(6, len(views))
            in_pose, _ = self.estimate_input_pose(
                image, [views[i] for i in range(n_ref)], poses44[:n_ref],
                fov)
            route = "front" if in_pose is None else "estimated"
        if in_pose is None:
            in_pose = cam_utils.get_pose_from_angles(
                np.asarray([0.0]), np.asarray([0.3]), dist)[0, :3]
        poses = np.concatenate([np.asarray(in_pose)[None], gen_poses], 0)
        num_views = 1 + n_gen

        m = self.load_stable_diffusion()
        m.controlnets = self.load_controlnets()
        m.segment_fn = None
        m.lpips_params = self.load_lpips()
        m.enhance_fn = None if tiny else self.load_image_enhancer()
        nk = self._parse_nerf_mesh(kwargs)
        cfg = self._cfg_from_schema(
            nk, num_views, keep_first_views=1,
            default_init_steps=(8 if tiny
                                else (640 if version == "1.1" else 720)))
        size = cfg.render_size

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)
        views_r = torch.cat([resize_bilinear(t(image)[None], (size, size)),
                             resize_bilinear(t(views), (size, size))], 0)
        focal = size / (2 * np.tan(np.radians(fov / 2)))
        intr = np.tile(np.asarray([focal, focal, size / 2, size / 2],
                                  np.float32), (num_views, 1))
        matte = gen_n = None
        if gen_normals is not None:
            # the normal-norm matte of each view and its composited normals
            posts = [zero123plus_postprocess(v, n)
                     for v, n in zip(views, gen_normals)]
            matte = resize_bilinear(t(np.stack([p[0][..., 3:]
                                                for p in posts])),
                                    (size, size))
            gen_n = resize_bilinear(t(np.stack([p[1] for p in posts])),
                                    (size, size))
        if kwargs.get("segment", True):
            masks = self.run_segmentation(views_r)
            m.segment_fn = self.make_segment_fn()
        else:
            masks = torch.ones((num_views, size, size, 1), device=dev)
        if matte is not None:
            masks = torch.cat([masks[:1], torch.minimum(masks[1:], matte)],
                              0)
        targets = {"images": views_r, "masks": masks, "poses": t(poses),
                   "intrinsics": t(intr)}
        if kwargs.get("use_normals", True):
            # Omnidata on the input view; the generated views get their
            # generated normals (v1.2), else the normal TV only (weight 0)
            n0 = self.predict_normals(views_r[:1])
            if gen_n is not None:
                targets["normals"] = torch.cat([n0, gen_n], 0)
                targets["normal_weights"] = t(np.ones(num_views))
            else:
                targets["normals"] = torch.cat(
                    [n0, torch.zeros((num_views - 1, size, size, 3),
                                     device=dev)], 0)
                targets["normal_weights"] = t([1.0]
                                              + [0.0] * (num_views - 1))
        rng = np.random.default_rng(seed)
        lights, _ = cam_utils.light_sampling(poses, rng=rng)
        wkey = ("zero123plus_cam_weights" if version == "1.1"
                else "zero123plus1_2_cam_weights")
        cam_w = np.asarray(self.constants[wkey][:num_views], np.float32)
        if len(cam_w) < num_views:
            cam_w = np.pad(cam_w, (0, num_views - len(cam_w)),
                           constant_values=1.0)
        targets["cam_weights"] = t(cam_w)
        targets["cam_lights"] = t(lights)
        prompt = self._join_prompts(kwargs.get("prompt", ""),
                                    nk["aux_prompt"])
        negp = self._join_prompts(kwargs.get("negative_prompt", ""),
                                  nk["aux_negative_prompt"])
        pos, neg = self.encode_prompt(m, [prompt] * num_views,
                                      [negp] * num_views)
        if kwargs.get("use_ip_adapter", True):
            self.enable_ip_adapter(m, np.asarray(image, np.float32))
        else:
            m.ip_context = None
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        out = MVEdit3DPipeline(m, cfg)(targets, pos.clone(), neg.clone(),
                                       generator=gen, draws=draws)
        out = self._chain_superres(out, "nerf_params", prompt,
                                   kwargs.get("negative_prompt", ""), seed,
                                   kwargs.get("superres", False))
        out.update(views=views, normals=gen_normals,
                   in_pose=np.asarray(poses[0]), pose_route=route)
        if out_path and out["mesh"] is not None:
            out["mesh"].write(out_path, flip_yz=True)
        return out

    # ------------------------------------------------------------------
    @torch.no_grad()
    def run_stablessdnerf(self, prompt, seed=42, steps=None, cfg_scale=7.0,
                          draws=None):
        """Text -> a triplane code sampled by the SSDNeRF denoiser (50
        DPM-Solver++ steps, tiny 4) -> a preview render of the decoded
        triplane (160^2, tiny 32^2, at the rig's front azimuth, elevation
        0.3). The prompt and `cfg_scale` do not reach the sample: the
        denoiser is unconditional, as the reference's; only
        `run_stablessdnerf_to_mesh`'s MVEdit loop reads the prompt. The
        sample's initial noise comes from a generator seeded with `seed`,
        or from `draws.code_noise`. Returns {"code" (3, C, H, W), "preview"
        (size, size, 3) float32 numpy, "decoder", "ssdnerf_cfg"}."""
        from ..models import gaussian_diffusion as GD
        from ..models.nerf_fit import make_image_renderer
        from ..models.ssdnerf import tanh_code
        dev, pt = self.device, phase_timer()
        if pt is not None:
            pt.mark()
        ss = self.load_ssdnerf()
        cfg = ss.cfg
        draws = draws if draws is not None else GeneratorDraws(
            torch.Generator(device=self.device).manual_seed(seed))
        shape = (1, *cfg.latent_shape)
        code = GD.sample_from_noise(
            ss.schedule, ss.denoiser, shape,
            noise=draws.code_noise(shape, dev),
            num_steps=steps or (4 if self.tiny else 50))[0]
        if pt is not None:
            pt.tick("code_sample", code)
        size = 32 if self.tiny else 160
        c = self.constants
        intr = cam_utils.intrinsics_from_fov(c["ssdnerf_fov"], size, size)
        pose = cam_utils.get_pose_from_angles(
            np.asarray([c["ssdnerf_front_azi"]]), np.asarray([0.3]),
            c["ssdnerf_camera_distance"])[0, :3]
        render = make_image_renderer(self._triplane_decode(cfg), size, size,
                                     cfg.render, chunk=size * size,
                                     use_grid=False)
        img = render({"decoder": ss.decoder, "code": tanh_code(code)},
                     self._f32(pose), self._f32(intr))
        preview = img["rgb"].float().cpu().numpy()
        if pt is not None:
            pt.tick("preview")
        return {"code": code, "preview": preview, "decoder": ss.decoder,
                "ssdnerf_cfg": cfg}

    @staticmethod
    def _triplane_decode(cfg):
        """The renderers' `decode(params, x)` of {"decoder", "code"}: the
        triplane without view directions."""
        from ..models.triplane import triplane_point_decode

        def decode(p, x):
            s, col = triplane_point_decode(p["decoder"], p["code"],
                                           x.reshape(-1, 3), None,
                                           cfg.triplane)
            return s.reshape(x.shape[:-1]), col.reshape(*x.shape[:-1], 3)
        return decode

    def _f32(self, x):
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def distill_triplane_to_field(self, decoder, code_act, ssdnerf_cfg,
                                  ingp_cfg, steps=200, n_points=65536,
                                  seed=0, draws=None):
        """Distil the sampled triplane NeRF into the MVEdit field: `steps`
        Adam(5e-3) steps of the field's (log1p sigma, rgb) regressed on the
        triplane's at `n_points` points a step, uniform in the triplane's
        box. The field's init and the points come from `draws`
        (`distill_field_init`, `distill_points`; the request's draw source
        in `run_stablessdnerf_to_mesh`), else from a generator seeded with
        `seed` (the reference always draws from PRNGKey(0)). Returns the
        field's params."""
        from ..models.fields import field_leaves, ingp_point_decode
        from ..models.triplane import triplane_point_decode
        dev = self.device
        draws = draws if draws is not None else GeneratorDraws(
            torch.Generator(device=self.device).manual_seed(seed))
        params = draws.distill_field_init(ingp_cfg, dev)
        leaves = field_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        opt = torch.optim.Adam(leaves, lr=5e-3)
        bound = ssdnerf_cfg.triplane.bound
        with torch.enable_grad():
            for _ in range(steps):
                pts = draws.distill_points(n_points, bound, dev)
                with torch.no_grad():
                    s_t, c_t = triplane_point_decode(
                        decoder, code_act, pts, None, ssdnerf_cfg.triplane)
                s, c = ingp_point_decode(params, pts, ingp_cfg)
                loss = (((torch.log1p(s) - torch.log1p(s_t)) ** 2).mean()
                        + ((c - c_t) ** 2).mean())
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
        for p in leaves:
            p.requires_grad_(False)
            p.grad = None
        return params

    def run_stablessdnerf_to_mesh(self, prompt, seed=42, steps=None,
                                  out_path=None, draws=None, **kwargs):
        """Text -> a triplane (`run_stablessdnerf`, 50 steps, tiny 4) ->
        the MVEdit loop -> a GLB at `out_path`. The triplane is distilled
        into the MVEdit field (`distill_triplane_to_field`, 200 steps, tiny
        20), which the loop starts from, and rendered at the loop's views
        (32, tiny 3, a surround rig at the SSDNeRF camera distance from the
        front azimuth, 96 samples a ray) as its targets; the loop runs in
        2-pass mode without LPIPS, the enhancer or IP-Adapter, as the
        reference's. kwargs: `num_views`, `n_inverse_steps`,
        `init_inverse_steps`, `negative_prompt`, `superres` (see
        `_chain_superres`). Every random draw comes from a generator seeded
        with `seed`, in order: the code's noise, the distillation's, the
        loop's; or from `draws` (`GeneratorDraws`' methods). The rig and
        the lights come from `np.random.default_rng(seed)`."""
        from ..models.nerf_fit import make_image_renderer
        from ..models.ssdnerf import tanh_code
        from ..pipelines.mvedit_3d import MVEdit3DPipeline
        tiny, dev = self.tiny, self.device
        draws = draws if draws is not None else GeneratorDraws(
            torch.Generator(device=self.device).manual_seed(seed))
        ssd = self.run_stablessdnerf(prompt, seed=seed,
                                     steps=4 if tiny else 50, draws=draws)
        cfg_s = ssd["ssdnerf_cfg"]
        code_act = tanh_code(ssd["code"])
        num_views = kwargs.get("num_views", 3 if tiny else 32)
        cfg = self._mvedit_cfg(
            num_views, steps or (2 if tiny else 24),
            kwargs.get("n_inverse_steps", 4 if tiny else 80),
            kwargs.get("init_inverse_steps", 8 if tiny else 256))
        pt = phase_timer()
        if pt is not None:
            pt.mark()
        field0 = self.distill_triplane_to_field(
            ssd["decoder"], code_act, cfg_s, cfg.ingp,
            steps=20 if tiny else 200, draws=draws)
        if pt is not None:
            pt.tick("distill", field0)
        c = self.constants
        rng = np.random.default_rng(seed)
        poses, intr = C.surround_rig(
            num_views, c["ssdnerf_camera_distance"], c["ssdnerf_fov"],
            c["ssdnerf_min_elev"], c["ssdnerf_max_elev"], cfg.render_size,
            begin_rad=c["ssdnerf_front_azi"], rng=rng)
        render = make_image_renderer(
            self._triplane_decode(cfg_s), cfg.render_size, cfg.render_size,
            cfg_s.render, chunk=cfg.render_size * 64, use_grid=False)
        tp = {"decoder": ssd["decoder"], "code": code_act}
        frames = [render(tp, self._f32(poses[i]), self._f32(intr[i]))
                  for i in range(num_views)]
        images = torch.stack([f["rgb"] for f in frames])
        masks = torch.stack([f["alpha"][..., None] for f in frames])
        if pt is not None:
            pt.tick("init_renders", images)
        lights, _ = cam_utils.light_sampling(poses, rng=rng)
        m = self.load_stable_diffusion()
        m.controlnets = self.load_controlnets()
        m.segment_fn = None
        targets = {"images": images, "masks": masks,
                   "poses": self._f32(poses), "intrinsics": self._f32(intr),
                   "cam_weights": torch.ones(num_views, device=dev),
                   "cam_lights": self._f32(lights)}
        negative_prompt = kwargs.get("negative_prompt", "")
        pos, neg = self.encode_prompt(m, [prompt] * num_views,
                                      [negative_prompt] * num_views)
        out = MVEdit3DPipeline(m, cfg)(targets, pos.clone(), neg.clone(),
                                       draws=draws, init_field_params=field0)
        out = self._chain_superres(out, "nerf_params", prompt,
                                   negative_prompt, seed,
                                   kwargs.get("superres", False))
        if out_path and out["mesh"] is not None:
            out["mesh"].write(out_path, flip_yz=True)
        return out
