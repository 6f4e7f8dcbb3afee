"""DDPM UNet for triplane-code diffusion (counterpart of
`mvedit_tpu/models/ddpm_unet.py`, the reference's DenoisingUnetMod):
resnet down / up blocks with a time embedding, self-attention at the
configured levels, an optional concatenated condition.

It takes a (B, P, C, H, W) triplane latent (the planes fold into
channels, plane-major) or a (B, C, H, W) image. Built on the diffusion
UNet's `ResnetBlock` / `Downsample` / `Upsample`; GroupNorms outside the
resnets take flax's eps 1e-6, `conv_out` computes in f32, and the
attention goes through `models/diffusion/attention.py::
dot_product_attention`, so a long enough map routes to the flash kernel
exactly where the reference's would. Module names are the flax
module's (`down_0_res_1`, `mid_attn`, `up_2_us`, ...), so
`torch_state_from_flax(params, "ddpm_unet")` bridges its params.
"""
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .diffusion.attention import dot_product_attention
from .diffusion.layers import Conv, Dense
from .diffusion.norm import GroupNorm
from .diffusion.unet import (Downsample, ResnetBlock, Upsample,
                             timestep_embedding)

__all__ = ["DDPMUNetConfig", "DDPMUNet", "SelfAttention2D"]


@dataclass(frozen=True)
class DDPMUNetConfig:
    in_channels: int = 36            # 3 planes x 12 ch
    out_channels: int = 36
    base_channels: int = 128
    channel_mults: Tuple[int, ...] = (1, 2, 2, 4)
    layers_per_block: int = 2
    attn_levels: Tuple[int, ...] = (2, 3)
    num_heads: int = 4
    dtype: torch.dtype = torch.float32


class SelfAttention2D(nn.Module):
    """GroupNorm(32, eps 1e-6) -> one qkv projection -> attention over the
    H * W tokens -> proj, plus the input (NCHW)."""

    def __init__(self, ch, heads=4, dtype=None):
        super().__init__()
        self.heads = heads
        self.norm = GroupNorm(32, ch, 1e-6)
        self.qkv = Dense(ch, 3 * ch, dtype=dtype)
        self.proj = Dense(ch, ch, dtype=dtype)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.qkv(h).chunk(3, dim=-1)
        d = C // self.heads

        def split(t):
            return t.reshape(B, H * W, self.heads, d)

        o = dot_product_attention(split(q), split(k), split(v))
        o = self.proj(o.reshape(B, H * W, C))
        return x + o.reshape(B, H, W, C).permute(0, 3, 1, 2).to(x.dtype)


class DDPMUNet(nn.Module):
    def __init__(self, cfg: DDPMUNetConfig = DDPMUNetConfig(),
                 cond_channels=0):
        """`cond_channels`: the width of the concatenated condition (the
        flax module infers it from its first input)."""
        super().__init__()
        self.cfg = cfg
        dt, base = cfg.dtype, cfg.base_channels
        temb = base * 4
        n = len(cfg.channel_mults)
        self.temb_1 = Dense(base, temb, dtype=dt)
        self.temb_2 = Dense(temb, temb, dtype=dt)
        self.conv_in = Conv(cfg.in_channels + cond_channels, base, 3,
                            padding=1, dtype=dt)
        skips, cur = [base], base
        for li, mult in enumerate(cfg.channel_mults):
            ch = base * mult
            for bi in range(cfg.layers_per_block):
                self.add_module(f"down_{li}_res_{bi}",
                                ResnetBlock(cur, ch, temb, dt))
                cur = ch
                if li in cfg.attn_levels:
                    self.add_module(f"down_{li}_attn_{bi}",
                                    SelfAttention2D(ch, cfg.num_heads, dt))
                skips.append(ch)
            if li != n - 1:
                self.add_module(f"down_{li}_ds", Downsample(ch, dt))
                skips.append(ch)
        self.mid_res_0 = ResnetBlock(cur, cur, temb, dt)
        self.mid_attn = SelfAttention2D(cur, cfg.num_heads, dt)
        self.mid_res_1 = ResnetBlock(cur, cur, temb, dt)
        for li, mult in enumerate(reversed(cfg.channel_mults)):
            lvl = n - 1 - li
            ch = base * mult
            for bi in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{li}_res_{bi}",
                                ResnetBlock(cur + skips.pop(), ch, temb, dt))
                cur = ch
                if lvl in cfg.attn_levels:
                    self.add_module(f"up_{li}_attn_{bi}",
                                    SelfAttention2D(ch, cfg.num_heads, dt))
            if li != n - 1:
                self.add_module(f"up_{li}_us", Upsample(ch, dt))
        self.norm_out = GroupNorm(32, cur, 1e-6)
        self.conv_out = Conv(cur, cfg.out_channels, 3, padding=1,
                             dtype=torch.float32)

    def forward(self, x, t, cond=None):
        """x: (B, P, C, H, W) triplane latent or (B, C, H, W) image; cond:
        optional (B, Cc, H, W) concatenated condition. Returns x's shape
        (f32)."""
        cfg, dt = self.cfg, self.cfg.dtype
        n = len(cfg.channel_mults)
        triplane_in = x.dim() == 5
        if triplane_in:
            B, P, C, H, W = x.shape
            h = x.reshape(B, P * C, H, W)
        else:
            h = x
        if cond is not None:
            h = torch.cat([h, cond.to(h.dtype)], 1)
        temb = self.temb_1(timestep_embedding(t, cfg.base_channels).to(dt))
        temb = self.temb_2(F.silu(temb))
        h = self.conv_in(h)
        skips = [h]
        for li in range(n):
            for bi in range(cfg.layers_per_block):
                h = getattr(self, f"down_{li}_res_{bi}")(h, temb)
                if li in cfg.attn_levels:
                    h = getattr(self, f"down_{li}_attn_{bi}")(h)
                skips.append(h)
            if li != n - 1:
                h = getattr(self, f"down_{li}_ds")(h)
                skips.append(h)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h, temb)), temb)
        for li in range(n):
            for bi in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], 1)
                h = getattr(self, f"up_{li}_res_{bi}")(h, temb)
                if n - 1 - li in cfg.attn_levels:
                    h = getattr(self, f"up_{li}_attn_{bi}")(h)
            if li != n - 1:
                h = getattr(self, f"up_{li}_us")(h)
        out = self.conv_out(F.silu(self.norm_out(h)))
        if triplane_in:
            out = out.reshape(B, P, C, H, W)
        return out
