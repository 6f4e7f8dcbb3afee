"""Endpoints (mixed into Adapter3DRunner).

Counterpart of `mvedit_tpu/apis/endpoints.py`; so far `run_text_to_img`.
"""
import numpy as np
import torch

from ..models.diffusion import schedulers as S

__all__ = ["EndpointsMixin"]


class EndpointsMixin:
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
