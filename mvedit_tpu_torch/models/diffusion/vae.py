"""AutoencoderKL (the SD VAE).

Counterpart of `mvedit_tpu/models/diffusion/vae.py`, with diffusers'
`AutoencoderKL` parameter names. `encode` / `decode` take and return NHWC.
"""
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import dot_product_attention
from .layers import Conv, Dense
from .norm import GroupNorm
from .unet import ResnetBlock, nchw_to_nhwc, nhwc_to_nchw

__all__ = ["VAEConfig", "AutoencoderKL", "SD_VAE"]


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215
    dtype: torch.dtype = torch.bfloat16


SD_VAE = VAEConfig()


def _resnet(in_ch, out_ch, dt):
    return ResnetBlock(in_ch, out_ch, 0, dt, eps=1e-6)


class VAEAttention(nn.Module):
    """Single-head self-attention over all pixels (D = channels)."""

    def __init__(self, ch, dtype):
        super().__init__()
        self.group_norm = GroupNorm(32, ch, 1e-6)
        self.to_q = Dense(ch, ch, dtype=dtype)
        self.to_k = Dense(ch, ch, dtype=dtype)
        self.to_v = Dense(ch, ch, dtype=dtype)
        self.to_out = nn.ModuleList([Dense(ch, ch, dtype=dtype)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        out = dot_product_attention(q[:, :, None], k[:, :, None],
                                    v[:, :, None]).reshape(B, H * W, C)
        out = self.to_out[0](out)
        return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2)


class _Mid(nn.Module):
    def __init__(self, ch, dt):
        super().__init__()
        self.resnets = nn.ModuleList([_resnet(ch, ch, dt) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, dt)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class _Block(nn.Module):
    def __init__(self, resnets, sampler_name=None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            self.add_module(sampler_name, nn.ModuleList([sampler]))


class _Sampler(nn.Module):
    def __init__(self, ch, stride, dt):
        super().__init__()
        self.conv = Conv(ch, ch, 3, stride=stride,
                         padding=0 if stride == 2 else 1, dtype=dt)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc, dt = cfg.block_out_channels, cfg.dtype
        self.conv_in = Conv(cfg.in_channels, boc[0], 3, padding=1, dtype=dt)
        self.down_blocks = nn.ModuleList()
        prev = boc[0]
        for bi, ch in enumerate(boc):
            last = bi == len(boc) - 1
            self.down_blocks.append(_Block(
                [_resnet(prev if li == 0 else ch, ch, dt)
                 for li in range(cfg.layers_per_block)],
                "downsamplers", None if last else _Sampler(ch, 2, dt)))
            prev = ch
        self.mid_block = _Mid(boc[-1], dt)
        self.conv_norm_out = GroupNorm(32, boc[-1], 1e-6)
        self.conv_out = Conv(boc[-1], 2 * cfg.latent_channels, 3, padding=1,
                             dtype=dt)
        self.dtype = dt

    def forward(self, x):
        h = self.conv_in(x.to(self.dtype))
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                # diffusers' VAE downsample pads asymmetrically (0, 1)
                h = blk.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc, dt = cfg.block_out_channels, cfg.dtype
        self.conv_in = Conv(cfg.latent_channels, boc[-1], 3, padding=1,
                            dtype=dt)
        self.mid_block = _Mid(boc[-1], dt)
        self.up_blocks = nn.ModuleList()
        prev = boc[-1]
        for ui, ch in enumerate(reversed(boc)):
            last = ui == len(boc) - 1
            self.up_blocks.append(_Block(
                [_resnet(prev if li == 0 else ch, ch, dt)
                 for li in range(cfg.layers_per_block + 1)],
                "upsamplers", None if last else _Sampler(ch, 1, dt)))
            prev = ch
        self.conv_norm_out = GroupNorm(32, boc[0], 1e-6)
        # f32 output conv (vae.py:133)
        self.conv_out = Conv(boc[0], 3, 3, padding=1, dtype=torch.float32)
        self.dtype = dt

    def forward(self, z):
        h = self.mid_block(self.conv_in(z.to(self.dtype)))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(
                    F.interpolate(h, scale_factor=2, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = SD_VAE):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        lc = 2 * cfg.latent_channels
        # f32 1x1 convs around the latent (vae.py:104,116)
        self.quant_conv = Conv(lc, lc, 1, dtype=torch.float32)
        self.post_quant_conv = Conv(cfg.latent_channels, cfg.latent_channels,
                                    1, dtype=torch.float32)

    def encode(self, x, noise=None):
        """x: (B, H, W, 3) in [-1, 1] -> scaled latents (B, H/8, W/8, 4) f32.
        With `noise` (N(0, 1), the latents' shape) samples the posterior
        instead of taking its mean."""
        moments = self.quant_conv(self.encoder(nhwc_to_nchw(x)))
        mean, logvar = moments.chunk(2, dim=1)
        logvar = logvar.clamp(-30.0, 20.0)
        z = nchw_to_nhwc(mean)
        if noise is not None:
            z = z + torch.exp(0.5 * nchw_to_nhwc(logvar)) * noise
        return z * self.cfg.scaling_factor

    def decode(self, z):
        """Scaled latents (B, h, w, 4) -> (B, 8h, 8w, 3) in [-1, 1], f32."""
        z = self.post_quant_conv(nhwc_to_nchw(z / self.cfg.scaling_factor))
        return nchw_to_nhwc(self.decoder(z))
