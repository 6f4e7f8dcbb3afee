"""Tiny seeded model bundles for tests and the sharded dry runs
(counterpart of `mvedit_tpu/testing.py`).

The shapes mirror the production SD1.5 stack (UNet + ControlNets + VAE +
schedule) at toy widths, in f32, so that whole pipelines run in seconds on
the CPU.
"""
import types

import torch

from .apis.runner import init_random_
from .models.diffusion import schedulers as S
from .models.diffusion.controlnet import ControlNet
from .models.diffusion.unet import UNet2DCondition, UNetConfig
from .models.diffusion.vae import AutoencoderKL, VAEConfig
from .models.fields import INGPConfig
from .ops.hash_grid import HashGridConfig

__all__ = ["TINY_UNET", "TINY_VAE", "TINY_INGP", "make_tiny_models",
           "make_tiny_mvedit_cfg"]

TINY_UNET = UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                       attn_down=(True, False), cross_attention_dim=32,
                       num_heads=4, dtype=torch.float32)
TINY_VAE = VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                     dtype=torch.float32)
TINY_INGP = INGPConfig(hash=HashGridConfig(
    n_levels=4, base_resolution=4, max_resolution=32, log2_hashmap_size=12))


def make_tiny_models(generator, n_cn=2, hint_strides=1):
    """UNet + n_cn ControlNets + VAE + schedule, seeded from `generator`
    in that order, on the generator's device, frozen in eval mode."""
    def build(module):
        init_random_(module, generator)
        return module.eval().requires_grad_(False)

    with torch.device(generator.device):
        m = types.SimpleNamespace()
        m.unet = build(UNet2DCondition(TINY_UNET))
        m.vae = build(AutoencoderKL(TINY_VAE))
        m.controlnets = tuple(
            build(ControlNet(TINY_UNET, hint_strides=hint_strides))
            for _ in range(n_cn))
    m.schedule = S.sd_schedule()
    m.segment_fn = None
    return m


def make_tiny_mvedit_cfg(num_views=4, render_size=32, steps=3,
                         **overrides):
    from .models.volume_renderer import RenderConfig
    from .pipelines import MVEdit3DConfig
    kw = dict(
        num_views=num_views, mid_num_views=num_views,
        min_num_views=num_views,
        render_size=render_size, render_size_ramp=False,
        diffusion_steps=steps,
        n_inverse_steps=2, init_inverse_steps=2,
        tet_resolution=8, tet_init_inverse_steps=2,
        patch_size=8, patch_bs=1, ingp=TINY_INGP,
        render=RenderConfig(num_samples=8, grid_size=8))
    kw.update(overrides)
    return MVEdit3DConfig(**kw)
