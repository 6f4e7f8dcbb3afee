"""Latent diffusion over triplane codes: SSDNeRF's sampling loop
(counterpart of `mvedit_tpu/models/gaussian_diffusion.py`).

`q_sample`, `v_target` and `sample_from_noise`: DPM-Solver++(2M) or DDIM
over trailing timesteps (or the Karras table), CFG on a doubled batch,
x0-space gradient guidance and a Langevin corrector. The denoiser is any
callable `(x, t_vec, cond) -> out`. The random draws are inputs: the
initial noise and the corrector's draws are given, or drawn from a
`torch.Generator`. The training loss waits for the training slice.
"""
from dataclasses import dataclass

import numpy as np
import torch

from .diffusion import schedulers as S

__all__ = ["GaussianDiffusionConfig", "q_sample", "v_target",
           "sample_from_noise"]


@dataclass(frozen=True)
class GaussianDiffusionConfig:
    num_timesteps: int = 1000
    prediction_type: str = "v_prediction"
    timestep_weight_power: float = 0.5
    guidance_scale: float = 1.0


def q_sample(schedule: S.NoiseSchedule, x0, noise, t):
    return S.add_noise(schedule, x0, noise, t)


def v_target(schedule: S.NoiseSchedule, x0, noise, t):
    """v = sqrt(acp) eps - sqrt(1 - acp) x0; t: (B,) tensor."""
    sa, sn = schedule.sqrt_acp(t)
    shape = (-1,) + (1,) * (x0.dim() - 1)
    return sa.reshape(shape) * noise - sn.reshape(shape) * x0


def _timesteps(schedule, num_steps, use_karras):
    if use_karras:
        # the reference reverses the Karras table, which `karras_sigmas`
        # already returns high to low: its Karras loop walks the timesteps
        # upwards
        _, ts = S.karras_sigmas(schedule, num_steps)
        return ts[::-1].copy()
    return S.make_timesteps(num_steps, schedule.num_train_timesteps,
                            "trailing")


def sample_from_noise(schedule, denoise_fn, shape, generator=None,
                      noise=None, num_steps=50, solver="dpmsolver",
                      cond=None, uncond=None, guidance_scale=1.0,
                      use_karras=False, grad_guide_fn=None, guide_gain=1.0,
                      langevin_steps=0, langevin_delta=0.1,
                      langevin_t_range=(0, None), langevin_noise=None):
    """The whole sampling loop -> the final x (shape).

    noise: the initial x, else drawn from `generator` (on its device).
    CFG runs the denoiser on [uncond; cond] when `uncond` is given and
    guidance_scale != 1. grad_guide_fn(x0) -> scalar loss: at every step the x0 estimate
    takes a gradient step of the guide loss (`guide_gain`) and the model
    output is derived again from it. langevin_steps K > 0: K corrector
    updates x <- x - delta/2 sigma eps + sqrt(delta) sigma z before each
    solver step whose t lies strictly inside `langevin_t_range`; z is
    `langevin_noise[step, k]` (a (num_steps, K, *shape) tensor, the
    reference's per-step draws) or drawn from `generator`.
    """
    timesteps = _timesteps(schedule, num_steps, use_karras)
    x = noise if noise is not None else torch.randn(
        shape, generator=generator,
        device=None if generator is None else generator.device)
    state = S.SolverState.init(x)
    lg_lo = langevin_t_range[0]
    lg_hi = (langevin_t_range[1] if langevin_t_range[1] is not None
             else schedule.num_train_timesteps - 1)
    v_pred = schedule.prediction_type == "v_prediction"

    def model_out(x, t):
        t_vec = torch.full((shape[0],), t, dtype=torch.int32,
                           device=x.device)
        if uncond is not None and guidance_scale != 1.0:
            out = denoise_fn(torch.cat([x, x]), torch.cat([t_vec, t_vec]),
                             torch.cat([uncond, cond]))
            o_u, o_c = out.chunk(2)
            return o_u + guidance_scale * (o_c - o_u)
        return denoise_fn(x, t_vec, cond)

    for i, t in enumerate(timesteps):
        t = int(t)
        tp = int(timesteps[i + 1]) if i + 1 < len(timesteps) else -1
        if langevin_steps > 0 and lg_lo < t < lg_hi:
            sa_l, sn_l = schedule.sqrt_acp(t)
            for k in range(langevin_steps):
                o = model_out(x, t)
                eps = sa_l * o + sn_l * x if v_pred else o
                z = (langevin_noise[i, k] if langevin_noise is not None
                     else torch.randn(x.shape, generator=generator,
                                      device=x.device))
                x = (x - 0.5 * langevin_delta * sn_l * eps
                     + np.sqrt(langevin_delta) * sn_l * z)
        out = model_out(x, t)
        if grad_guide_fn is not None:
            sa, sn = schedule.sqrt_acp(t)
            x0 = sa * x - sn * out if v_pred else (x - sn * out) / sa
            with torch.enable_grad():
                z = x0.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(grad_guide_fn(z), z)
            x0 = x0 - guide_gain * g
            sn_c = np.maximum(sn, np.float32(1e-8))
            if v_pred:
                out = sa * ((x - sa * x0) / sn_c) - sn * x0
            else:
                out = (x - sa * x0) / sn_c
        if solver == "ddim":
            x = S.ddim_step(schedule, x, out, t, tp)
        else:
            x, state = S.dpmsolver_step(schedule, x, out, t, tp, state)
    return x
