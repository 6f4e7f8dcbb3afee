"""SSDNeRF's code activation and configuration (counterpart of the parts
of `mvedit_tpu/models/ssdnerf.py` that sampling needs; the scene caches
and the train steps wait for the training slice).

The diffusion latent is the raw code; the decoder reads
`tanh_code(code) = tanh(code / 2) * 2`.
"""
from dataclasses import dataclass, field

import torch

from .gaussian_diffusion import GaussianDiffusionConfig
from .triplane import TriPlaneConfig
from .volume_renderer import RenderConfig

__all__ = ["SSDNeRFConfig", "tanh_code", "tanh_code_inverse"]


def tanh_code(code, scale=2.0):
    return torch.tanh(code / scale) * scale


def tanh_code_inverse(act, scale=2.0):
    return torch.atanh((act / scale).clamp(-0.999999, 0.999999)) * scale


@dataclass(frozen=True)
class SSDNeRFConfig:
    code_shape: tuple = (3, 16, 80, 80)    # activated feature triplane
    latent_shape: tuple = (3, 12, 40, 40)  # diffusion latent
    triplane: TriPlaneConfig = field(default_factory=TriPlaneConfig)
    render: RenderConfig = field(default_factory=lambda: RenderConfig(
        num_samples=96, bound=0.5))
    n_rays: int = 4096
    code_lr: float = 0.04
    decoder_lr: float = 1e-3
    denoiser_lr: float = 1e-4
    diffusion: GaussianDiffusionConfig = field(
        default_factory=GaussianDiffusionConfig)
