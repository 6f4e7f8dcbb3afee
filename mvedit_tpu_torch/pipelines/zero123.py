"""Legacy Zero123: an input view and a relative camera -> a novel view
(counterpart of `mvedit_tpu/pipelines/zero123.py`; a library pipeline that
no endpoint calls, as in the reference):

- the conditioning token is Linear([the CLIP image embed || the camera
  embed]) through `CLIPCameraProjection`, the camera embed being
  [deg2rad(elevation), sin(deg2rad(azimuth)), cos(deg2rad(azimuth)),
  distance];
- the input view's unscaled VAE mode latent is concatenated onto the noisy
  latents channel-wise (an 8-channel UNet input); the uncond half gets a
  zero image latent and zero tokens (classifier-free guidance);
- DDIM over "leading" timesteps, with `eta`.

The draws (the initial latents, then per step the DDIM noise, drawn only
where eta > 0) come from a draw source (`Zero123Draws`' methods).
"""
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..models.diffusion import AttnMode, schedulers as S

__all__ = ["Zero123Config", "Zero123Pipeline", "Zero123Draws",
           "CLIPCameraProjection", "camera_embedding"]


class CLIPCameraProjection(nn.Module):
    """One linear projection of [clip embed || camera embed] back to the
    CLIP width (`proj`)."""

    def __init__(self, embedding_dim=768, additional_embeddings=4):
        super().__init__()
        self.proj = nn.Linear(embedding_dim + additional_embeddings,
                              embedding_dim)

    def forward(self, embedding):
        return self.proj(embedding)


def camera_embedding(elevation_deg, azimuth_deg, distance, device=None):
    """Angles in degrees and distances (scalars or (B,)) -> (B, 1, 4)
    camera tokens."""
    def t(x):
        return torch.as_tensor(np.atleast_1d(np.asarray(x, np.float32)),
                               device=device)
    el, az, d = torch.deg2rad(t(elevation_deg)), torch.deg2rad(
        t(azimuth_deg)), t(distance)
    return torch.stack([el, torch.sin(az), torch.cos(az), d], -1)[:, None]


@dataclass(frozen=True)
class Zero123Config:
    num_steps: int = 50
    guidance_scale: float = 3.0
    height: int = 256
    width: int = 256
    eta: float = 0.0


class Zero123Draws:
    """The pipeline's draws from a `torch.Generator`: the initial latents,
    then per step the DDIM noise (None where eta is 0)."""

    def __init__(self, generator=None):
        self.generator = generator

    def initial_latents(self, shape, device):
        return torch.randn(tuple(shape), generator=self.generator,
                           device=device)

    def step_noise(self, shape, device, eta):
        if eta <= 0:
            return None
        return torch.randn(tuple(shape), generator=self.generator,
                           device=device)


class Zero123Pipeline:
    """models: unet (8 input channels), vae, vision (CLIPVisionModel with
    its projection), ccp (CLIPCameraProjection), schedule
    (epsilon-prediction)."""

    def __init__(self, models, cfg: Zero123Config = Zero123Config()):
        self.m = models
        self.cfg = cfg
        self.schedule = models.schedule

    def _encode_image(self, clip_pixels, elevation, azimuth, distance):
        """CLIP-normalised pixels (B, S, S, 3) and the relative camera ->
        (2B, 1, C) tokens [zeros; cond]."""
        m = self.m
        emb = m.vision(clip_pixels).float()                     # (B, C)
        cam = camera_embedding(elevation, azimuth, distance,
                               device=emb.device)
        tok = m.ccp(torch.cat([emb[:, None], cam], -1))
        return torch.cat([torch.zeros_like(tok), tok], 0)

    @torch.inference_mode()
    def __call__(self, image, clip_pixels, elevation, azimuth, distance,
                 generator=None, draws=None, latents=None):
        """image: (1, H, W, 3) in [0, 1], the input view (its VAE latent
        is the channel-concat condition); clip_pixels: (1, S, S, 3)
        CLIP-normalised. The draws come from `draws`, by default from
        `generator`. Returns the novel view (1, H, W, 3) in [0, 1]."""
        cfg, m, sch = self.cfg, self.m, self.schedule
        draws = draws if draws is not None else Zero123Draws(generator)
        dev = image.device
        embeds = self._encode_image(clip_pixels, elevation, azimuth,
                                    distance)
        # the VAE returns scaled latents; Zero123 was trained on the
        # unscaled distribution mode
        img_lat = m.vae.encode(image * 2.0 - 1.0).float() \
            / m.vae.cfg.scaling_factor
        img_lat2 = torch.cat([torch.zeros_like(img_lat), img_lat], 0)
        ds = 2 ** (len(m.vae.cfg.block_out_channels) - 1)
        if latents is None:
            latents = draws.initial_latents(
                (1, cfg.height // ds, cfg.width // ds, 4), dev)
        timesteps = S.make_timesteps(cfg.num_steps, sch.num_train_timesteps,
                                     "leading")
        for i, t in enumerate(timesteps):
            t = int(t)
            noise = draws.step_noise(latents.shape, dev, cfg.eta)
            t2 = torch.full((2,), t, dtype=torch.int32, device=dev)
            lat_in = torch.cat([torch.cat([latents] * 2, 0), img_lat2], -1)
            eps = m.unet(lat_in, t2, embeds, mode=AttnMode()).float()
            eps_u, eps_c = eps.chunk(2, 0)
            eps = eps_u + cfg.guidance_scale * (eps_c - eps_u)
            t_prev = int(timesteps[i + 1]) if i + 1 < len(timesteps) else -1
            latents = S.ddim_step(sch, latents, eps, t, t_prev, eta=cfg.eta,
                                  noise=noise)
        img = m.vae.decode(latents)
        return ((img + 1) / 2).clamp(0.0, 1.0)
