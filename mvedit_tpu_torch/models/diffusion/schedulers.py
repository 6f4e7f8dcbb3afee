"""Diffusion noise schedules and samplers.

Counterpart of `mvedit_tpu/models/diffusion/schedulers.py`: the SD
scaled-linear schedule, trailing / leading / linspace timesteps, Karras
sigmas, DDIM, Euler-ancestral and DPM-Solver++(2M).

Timesteps `t` / `t_prev` of the step functions are Python ints (t_prev = -1
past the last step), so each step's coefficients are computed on the host
in float32, as the reference computes them. Tensors may live on any device.
Random draws come in as `noise` tensors or from a `torch.Generator`.
"""
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["NoiseSchedule", "sd_schedule", "make_timesteps", "karras_sigmas",
           "ddim_step", "euler_ancestral_step", "dpmsolver_step",
           "add_noise", "get_noise_scales", "pred_x0", "pred_eps",
           "SolverState"]


@dataclass(frozen=True)
class NoiseSchedule:
    num_train_timesteps: int = 1000
    alphas_cumprod: np.ndarray = None  # (T,) float64
    prediction_type: str = "epsilon"   # or "v_prediction"

    def acp32(self):
        return self.alphas_cumprod.astype(np.float32)

    def sqrt_acp(self, t):
        """(sqrt(acp[t]), sqrt(1 - acp[t])) in f32: numpy scalars for an int
        t, tensors on t's device for a tensor t."""
        if isinstance(t, torch.Tensor):
            acp = torch.as_tensor(self.acp32(), device=t.device)[t.long()]
            return torch.sqrt(acp), torch.sqrt(1.0 - acp)
        acp = self.acp32()[int(t)]
        return np.sqrt(acp), np.sqrt(np.float32(1.0) - acp)


def sd_schedule(beta_start=0.00085, beta_end=0.012, num_train_timesteps=1000,
                prediction_type="epsilon"):
    """SD 'scaled_linear' schedule (betas linear in sqrt space)."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                        num_train_timesteps, dtype=np.float64) ** 2
    return NoiseSchedule(num_train_timesteps, np.cumprod(1.0 - betas),
                         prediction_type)


def make_timesteps(num_inference_steps, num_train_timesteps=1000,
                   spacing="trailing"):
    """Discrete timesteps, descending (the reference forces 'trailing')."""
    if spacing == "trailing":
        step = num_train_timesteps / num_inference_steps
        ts = np.round(np.arange(num_train_timesteps, 0, -step)
                      ).astype(np.int64) - 1
    elif spacing == "leading":
        step = num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step)[::-1].copy()
    else:  # linspace
        ts = np.linspace(0, num_train_timesteps - 1,
                         num_inference_steps).round()[::-1].astype(np.int64)
    return np.ascontiguousarray(ts)


def _t_to_sigma(schedule, ts):
    acp = schedule.alphas_cumprod[ts]
    return np.sqrt((1 - acp) / acp)


def karras_sigmas(schedule, num_inference_steps, rho=7.0):
    """Karras sigma spacing mapped back to the nearest discrete timesteps."""
    sig = _t_to_sigma(schedule, np.arange(schedule.num_train_timesteps))
    sigma_min, sigma_max = sig[0], sig[-1]
    ramp = np.linspace(0, 1, num_inference_steps)
    inv_rho = 1.0 / rho
    sigmas = (sigma_max ** inv_rho
              + ramp * (sigma_min ** inv_rho - sigma_max ** inv_rho)) ** rho
    ts = np.interp(np.log(sigmas), np.log(sig), np.arange(len(sig)))
    return sigmas, np.round(ts).astype(np.int64)


def _bcast(c, x):
    """Per-sample coefficient (B,) -> broadcastable against x (B, ...)."""
    return c.reshape((-1,) + (1,) * (x.dim() - 1))


def add_noise(schedule, x0, noise, t):
    """t: int or (B,) tensor."""
    sa, sn = schedule.sqrt_acp(t)
    if isinstance(sa, torch.Tensor):
        sa, sn = _bcast(sa, x0), _bcast(sn, x0)
    return sa * x0 + sn * noise


def get_noise_scales(schedule, t_float):
    """(sqrt_acp, sqrt_1macp) at a fractional timestep, interpolated
    linearly in acp."""
    acp = schedule.acp32()
    t0 = int(np.clip(np.floor(t_float), 0, schedule.num_train_timesteps - 1))
    t1 = min(t0 + 1, schedule.num_train_timesteps - 1)
    w = np.float32(np.clip(t_float - t0, 0.0, 1.0))
    a = acp[t0] * (1 - w) + acp[t1] * w
    return np.sqrt(a), np.sqrt(np.float32(1.0) - a)


def pred_x0(schedule, sample, model_out, t):
    sa, sn = schedule.sqrt_acp(t)
    if schedule.prediction_type == "epsilon":
        return (sample - sn * model_out) / sa
    if schedule.prediction_type == "v_prediction":
        return sa * sample - sn * model_out
    raise ValueError(schedule.prediction_type)


def pred_eps(schedule, sample, model_out, t):
    sa, sn = schedule.sqrt_acp(t)
    if schedule.prediction_type == "epsilon":
        return model_out
    if schedule.prediction_type == "v_prediction":
        return sn * sample + sa * model_out
    raise ValueError(schedule.prediction_type)


class SolverState(NamedTuple):
    """DPM-Solver++(2M) carry: previous x0 estimate and its lambda."""
    prev_x0: torch.Tensor
    prev_lambda: np.float32
    has_prev: bool

    @classmethod
    def init(cls, like):
        return cls(prev_x0=torch.zeros_like(like, dtype=torch.float32),
                   prev_lambda=np.float32(0.0), has_prev=False)


def _noise(sample, noise, generator):
    if noise is not None:
        return noise
    return torch.randn(sample.shape, generator=generator,
                       device=sample.device, dtype=sample.dtype)


def ddim_step(schedule, sample, model_out, t, t_prev, eta=0.0, noise=None,
              generator=None):
    """DDIM; with eta > 0 the added noise is `noise` or drawn from
    `generator` (the reference adds noise only when given a key)."""
    x0 = pred_x0(schedule, sample, model_out, t)
    eps = pred_eps(schedule, sample, model_out, t)
    acp = schedule.acp32()
    a_prev = acp[t_prev] if t_prev >= 0 else np.float32(1.0)
    stochastic = eta > 0 and (noise is not None or generator is not None)
    var = np.float32(0.0)
    if stochastic:
        a_t = acp[t]
        var = np.float32(eta ** 2 * (1 - a_prev) / (1 - a_t)
                         * (1 - a_t / a_prev))
    sn_p = np.sqrt(np.clip(np.float32(1.0) - a_prev - var, 0.0, None))
    prev = np.sqrt(a_prev) * x0 + sn_p * eps
    if stochastic:
        prev = prev + np.sqrt(var) * _noise(sample, noise, generator)
    return prev


def euler_ancestral_step(schedule, sample, model_out, t, t_prev, noise=None,
                         generator=None):
    """Euler-ancestral in sigma space (diffusers EulerAncestralDiscrete).
    The ancestral noise is `noise` or drawn from `generator`."""
    acp = schedule.acp32()
    sig = np.sqrt((1 - acp) / acp)
    s_t = sig[t]
    s_prev = sig[t_prev] if t_prev >= 0 else np.float32(0.0)
    x0 = pred_x0(schedule, sample, model_out, t)
    x_sig = sample / np.sqrt(acp[t])
    sigma_up = np.sqrt(np.clip(
        s_prev ** 2 * (s_t ** 2 - s_prev ** 2)
        / np.clip(s_t ** 2, 1e-12, None), 0.0, None)).astype(np.float32)
    sigma_down = np.sqrt(np.clip(s_prev ** 2 - sigma_up ** 2, 0.0,
                                 None)).astype(np.float32)
    d = (x_sig - x0) / np.float32(np.clip(s_t, 1e-12, None))
    x_sig = x_sig + d * (sigma_down - s_t)
    x_sig = x_sig + _noise(sample, noise, generator) * sigma_up
    a_prev = acp[t_prev] if t_prev >= 0 else np.float32(1.0)
    return x_sig * np.sqrt(a_prev)


def dpmsolver_step(schedule, sample, model_out, t, t_prev,
                   state: SolverState):
    """DPM-Solver++(2M) multistep (diffusers DPMSolverMultistepScheduler,
    algorithm_type='dpmsolver++', solver_order=2). Returns (prev_sample,
    state); see the reference for the formulas."""
    acp = schedule.acp32()
    one = np.float32(1.0)
    a_t = acp[t]
    a_p = acp[t_prev] if t_prev >= 0 else np.float32(1.0 - 1e-7)
    alpha_t, sig_t = np.sqrt(a_t), np.sqrt(one - a_t)
    alpha_p = np.sqrt(a_p)
    sig_p = np.sqrt(np.maximum(one - a_p, np.float32(1e-12)))
    lam_t = np.log(alpha_t / sig_t)
    lam_p = np.log(alpha_p / sig_p)
    h = lam_p - lam_t
    x0 = pred_x0(schedule, sample, model_out, t)
    em1 = np.exp(-h) - one
    out = (sig_p / sig_t) * sample - alpha_p * em1 * x0
    if state.has_prev:
        h_prev = lam_t - state.prev_lambda
        r0 = h_prev / (np.float32(1e-12) if abs(h) < 1e-12 else h)
        r0 = np.float32(1e-12) if abs(r0) < 1e-12 else r0
        d1 = (x0 - state.prev_x0) / r0
        out = out - np.float32(0.5) * alpha_p * em1 * d1
    return out, SolverState(prev_x0=x0, prev_lambda=lam_t, has_prev=True)
