"""Zero123++ pipeline: one image -> six novel views in a 3 x 2 grid.

Counterpart of `mvedit_tpu/pipelines/zero123plus.py`:

- reference attention: each step noises the conditioning image's latent
  to the step's t and runs it through the UNet in `reference="write"`
  mode, which stores every self-attention input; the grid's pass then runs
  in `reference="read"` mode with those states concatenated onto its
  self-attentions' keys and values;
- the CLIP vision tower's global embedding, scaled per token by
  `ramping`, added to the encoded empty prompt (`text_uncond`);
- Zero123++'s latent and image rescalings (`scale_latents` & co.);
- `shift_views`: v1.2's roll of the grid latents by half a tile;
- `normal_cond`: v1.2's normal pass, whose UNet reads the ControlNet
  (`m.controlnet`) run on the CFG batch with the generated RGB grid
  as its hint, at `cond_scale`: its down and mid residuals go into the
  read pass beside the reference states.

The random draws come from a draw source (`Zero123PlusDraws`' methods):
the initial latents, then per step the reference noise and the ancestral
noise, in the reference's key order (key -> (key, k0); per step key ->
(key, kr, ks)).

With a `PhaseTimer` installed (`utils/profiling.py`), a call runs in the
phases `z123.cond`, per step `z123.write`, `z123.controlnet` (normal pass),
`z123.read` and `z123.solver`, and `z123.decode`, and counts the stored
reference states' bytes under `z123.ref_bytes`.
"""
from dataclasses import dataclass

import torch

from ..models.diffusion import AttnMode, schedulers as S
from ..utils.profiling import count, phase

__all__ = ["Zero123PlusConfig", "Zero123PlusPipeline", "Zero123PlusDraws",
           "scale_latents", "unscale_latents", "scale_image",
           "unscale_image"]


def scale_latents(latents):
    return (latents - 0.22) * 0.75


def unscale_latents(latents):
    return latents / 0.75 + 0.22


def scale_image(image):
    return image * 0.5 / 0.8


def unscale_image(image):
    return image / 0.5 * 0.8


@dataclass(frozen=True)
class Zero123PlusConfig:
    num_steps: int = 40
    guidance_scale: float = 4.0
    grid_hw: tuple = (960, 640)      # 3 x 2 grid of 320 x 320 views
    cond_scale: float = 1.0          # the normal ControlNet's scale
    shift_views: bool = False        # v1.2 latent roll
    # Euler-ancestral as the reference samples Zero123++; "dpmsolver" is
    # the reference's second-order option
    sampler: str = "euler_ancestral"


class Zero123PlusDraws:
    """The pipeline's draws from a `torch.Generator`, in the reference's
    order: the initial latents, then per step (reference noise, ancestral
    noise)."""

    def __init__(self, generator=None):
        self.generator = generator

    def _randn(self, shape, device):
        return torch.randn(tuple(shape), generator=self.generator,
                           device=device)

    def initial_latents(self, shape, device):
        return self._randn(shape, device)

    def step_noise(self, ref_shape, lat_shape, device):
        return self._randn(ref_shape, device), self._randn(lat_shape, device)


class Zero123PlusPipeline:
    """models: unet, vae, vision (CLIPVisionModel), ramping (L,)
    coefficients, text_uncond (1, L, C), schedule (v-prediction); for the
    normal pass also controlnet."""

    def __init__(self, models, cfg: Zero123PlusConfig):
        self.m = models
        self.cfg = cfg
        self.schedule = models.schedule

    def _encode_condition(self, pixels):
        """pixels: (1, S, S, 3) at the vision tower's size -> the CFG
        batch's prompt embeds (2, L, C): text_uncond, then text_uncond +
        the global embed ramped per token."""
        m = self.m
        emb = m.vision(pixels).float()                          # (1, P)
        ramp = torch.as_tensor(m.ramping, dtype=torch.float32,
                               device=emb.device)[None, :, None]
        return torch.cat([m.text_uncond,
                          m.text_uncond + emb[:, None, :] * ramp], 0)

    def _guided_step(self, latents, out, t, t_prev, noise, state):
        """One sampler step from `t` to `t_prev` (-1: the end) on the
        guided v-prediction of the CFG batch's UNet output `out` (2, ...),
        [uncond; cond] -> (latents, solver state)."""
        cfg, sch = self.cfg, self.schedule
        out_u, out_c = out.float().chunk(2, 0)
        model_out = out_u + cfg.guidance_scale * (out_c - out_u)
        if cfg.sampler == "euler_ancestral":
            return S.euler_ancestral_step(sch, latents, model_out, t, t_prev,
                                          noise=noise), state
        return S.dpmsolver_step(sch, latents, model_out, t, t_prev, state)

    @torch.inference_mode()
    def __call__(self, cond_image, cond_pixels_clip, generator=None,
                 draws=None, normal_cond=None):
        """cond_image: (1, H, W, 3) in [0, 1] at the grid size;
        cond_pixels_clip: (1, S, S, 3) in [0, 1], the input at the vision
        tower's size (the reference feeds it unnormalised); normal_cond:
        (1, H, W, 3) the ControlNet's hint (the normal pass's RGB grid),
        or None. The draws come from `draws`, by default from `generator`.
        Returns the decoded grid (1, H, W, 3) in [0, 1]."""
        cfg, m, sch = self.cfg, self.m, self.schedule
        draws = draws if draws is not None else Zero123PlusDraws(generator)
        dev = cond_image.device
        H, W = cfg.grid_hw
        with phase("z123.cond", dev):
            embeds = self._encode_condition(cond_pixels_clip)   # (2, L, C)
            cond_latent = m.vae.encode(
                scale_image(cond_image * 2 - 1)).float()
        timesteps = S.make_timesteps(cfg.num_steps, sch.num_train_timesteps,
                                     "trailing")
        ds = 2 ** (len(m.vae.cfg.block_out_channels) - 1)
        latents = draws.initial_latents((1, H // ds, W // ds, 4), dev)
        solver_state = S.SolverState.init(latents)
        hint = None
        if normal_cond is not None and getattr(m, "controlnet",
                                               None) is not None:
            hint = torch.cat([normal_cond] * 2, 0)
        for i, t in enumerate(timesteps):
            t = int(t)
            with phase("z123.write", dev):
                ref_noise, anc_noise = draws.step_noise(cond_latent.shape,
                                                        latents.shape, dev)
                t2 = torch.full((2,), t, dtype=torch.int32, device=dev)
                # the conditioning latent noised at the same t for both
                # halves
                ref_lat = S.add_noise(sch, torch.cat([cond_latent] * 2, 0),
                                      torch.cat([ref_noise] * 2, 0), t)
                _, writes = m.unet(ref_lat, t2, embeds,
                                   mode=AttnMode(reference="write"))
            count("z123.ref_bytes", lambda: sum(
                w.numel() * w.element_size() for w in writes))
            lat2 = torch.cat([latents] * 2, 0)
            down = mid = None
            if hint is not None:
                with phase("z123.controlnet", dev):
                    down, mid = m.controlnet(
                        lat2, t2, embeds, hint,
                        conditioning_scale=cfg.cond_scale)
            with phase("z123.read", dev):
                out = m.unet(lat2, t2, embeds,
                             mode=AttnMode(reference="read"), ref_kv=writes,
                             down_block_res=down, mid_block_res=mid)
            del writes, down, mid
            with phase("z123.solver", dev):
                t_prev = int(timesteps[i + 1]) if i + 1 < len(timesteps) \
                    else -1
                latents, solver_state = self._guided_step(
                    latents, out, t, t_prev, anc_noise, solver_state)
        with phase("z123.decode", dev):
            latents = unscale_latents(latents)
            if cfg.shift_views:
                # v1.2: roll the grid latents by half a tile (:330)
                latents = torch.roll(latents, shifts=latents.shape[2] // 4,
                                     dims=2)
            img = unscale_image(m.vae.decode(latents))
            img = ((img + 1) / 2).clamp(0.0, 1.0)
        return img
