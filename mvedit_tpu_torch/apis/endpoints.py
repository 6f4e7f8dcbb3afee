"""Endpoints (mixed into Adapter3DRunner).

Counterpart of `mvedit_tpu/apis/endpoints.py`; so far `run_text_to_img`
and `load_init_mesh` (the init-mesh renders `run_3d_to_3d` starts from).
"""
import numpy as np
import torch

from ..models.diffusion import schedulers as S
from ..models.mesh import RasterConfig, render_views
from ..ops.tonemapping import Tonemapping
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
