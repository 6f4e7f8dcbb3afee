"""Shared base of the SSDNeRF paper-config family (the port's copy of
`configs/_ssdnerf_paper_base.py`, which imports JAX).

`make_paper_config`: 6-channel 128 x 128 triplanes decoded by the
18 -> 64 TriPlaneDecoder, 96 samples a ray, 4096 rays a scene, decoder lr
1e-3, denoiser lr 1e-4, per-scene code lr 5e-3 (the paper configs'
values); the recipes under this directory change the dataset keys and the
iteration budget.

`build_denoiser_for(cfg, generator, device, ch, layout)`: the compact
conv denoiser (`ssdnerf_cars.py::LatentDenoiser`) over the config's
(3, C, H, W) latent, in the "stack" layout (the planes fold into
channels, the paper's default) or the "tiled" one (the planes side by
side along the width, in_channels C: the reference's `_tiled` recipe).
Its GroupNorms take min(32, ch) groups where that divides ch; at ch 80
(the tiled recipe) 16, the reference recipe's value: the JAX package asks
flax for 32 groups over 80 channels there, which raises.
"""
import math

import torch

from mvedit_tpu_torch.configs.ssdnerf_cars import LatentDenoiser
from mvedit_tpu_torch.models.ssdnerf import SSDNeRFConfig
from mvedit_tpu_torch.models.triplane import TriPlaneConfig
from mvedit_tpu_torch.models.volume_renderer import RenderConfig

__all__ = ["make_paper_config", "norm_groups", "build_denoiser_for"]


def make_paper_config(code_lr=5e-3):
    return SSDNeRFConfig(
        code_shape=(3, 6, 128, 128),
        latent_shape=(3, 6, 128, 128),
        triplane=TriPlaneConfig(
            n_channels=6,
            plane_cfg=("yx", "yz", "xz"),
            flip_z=True,
            base_layers=(18, 64),
            density_layers=(64, 1),
            color_layers=(64, 3),
            dir_layers=(16, 64),
            bound=0.5),
        render=RenderConfig(num_samples=96, bound=0.5, grid_size=64),
        n_rays=4096,
        code_lr=code_lr,
        decoder_lr=1e-3,
        denoiser_lr=1e-4,
    )


def norm_groups(ch):
    """min(32, ch) where it divides ch, else gcd(32, ch) (16 at ch 80)."""
    g = min(32, ch)
    return g if ch % g == 0 else math.gcd(32, ch)


def build_denoiser_for(cfg, generator=None, device=None, ch=128,
                       layout="stack"):
    """The `LatentDenoiser` over `cfg.latent_shape` on `device`, seeded
    from `generator` (flax's default init)."""
    from mvedit_tpu_torch.apis.runner import init_random_
    P, C, H, W = cfg.latent_shape
    with torch.device(device or "cpu"):
        net = LatentDenoiser(planes=P, channels=C, ch=ch, layout=layout,
                             groups=norm_groups(ch))
    with torch.no_grad():
        return init_random_(net, generator)
