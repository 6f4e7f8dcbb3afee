"""SD-compatible conditional UNet with the encoder / decoder split.

Counterpart of `mvedit_tpu/models/diffusion/unet.py`. Module names follow
diffusers' `UNet2DConditionModel`, so diffusers-keyed state dicts (and the
weight bridge's output) load with `load_state_dict`. Public tensors are
NHWC; inside, the convs run NCHW.
"""
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import AttnMode, Transformer2D
from .layers import Conv, Dense
from .norm import GroupNorm

__all__ = ["UNetConfig", "UNet2DCondition", "timestep_embedding",
           "SD15_UNET"]


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attn_down: Tuple[bool, ...] = (True, True, True, False)
    num_heads: int = 8
    head_dim: Optional[int] = None   # None -> channels // num_heads
    use_linear_projection: bool = False
    dtype: torch.dtype = torch.bfloat16


SD15_UNET = UNetConfig()


def timestep_embedding(timesteps, dim, max_period=10000.0):
    """Sinusoidal embedding, cos first (diffusers flip_sin_to_cos=True,
    downscale_freq_shift=0). timesteps: (B,) -> (B, dim) f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def nhwc_to_nchw(x):
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x):
    return x.permute(0, 2, 3, 1)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch, out_ch, temb_ch, dtype=None, eps=1e-5):
        super().__init__()
        self.norm1 = GroupNorm(32, in_ch, eps)
        self.conv1 = Conv(in_ch, out_ch, 3, padding=1, dtype=dtype)
        self.time_emb_proj = (Dense(temb_ch, out_ch, dtype=dtype)
                              if temb_ch else None)
        self.norm2 = GroupNorm(32, out_ch, eps)
        self.conv2 = Conv(out_ch, out_ch, 3, padding=1, dtype=dtype)
        self.conv_shortcut = (Conv(in_ch, out_ch, 1, dtype=dtype)
                              if in_ch != out_ch else None)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class _Sampler(nn.Module):
    """Holds `conv` under diffusers' downsamplers.0 / upsamplers.0 name."""

    def __init__(self, ch, stride, dtype):
        super().__init__()
        self.conv = Conv(ch, ch, 3, stride=stride, padding=1, dtype=dtype)


class Downsample(_Sampler):
    def __init__(self, ch, dtype=None):
        super().__init__(ch, 2, dtype)

    def forward(self, x):
        return self.conv(x)


class Upsample(_Sampler):
    def __init__(self, ch, dtype=None):
        super().__init__(ch, 1, dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def _heads(cfg, channels):
    if cfg.head_dim is not None:
        return channels // cfg.head_dim, cfg.head_dim
    return cfg.num_heads, channels // cfg.num_heads


def _transformer(cfg, ch):
    nh, hd = _heads(cfg, ch)
    return Transformer2D(ch, nh, hd, 1, cfg.cross_attention_dim,
                         cfg.use_linear_projection, dtype=cfg.dtype)


class _TimeEmbedding(nn.Module):
    def __init__(self, c0, dtype):
        super().__init__()
        self.linear_1 = Dense(c0, c0 * 4, dtype=dtype)
        self.linear_2 = Dense(c0 * 4, c0 * 4, dtype=dtype)

    def forward(self, t_emb):
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class _DownBlock(nn.Module):
    def __init__(self, cfg, bi, in_ch):
        super().__init__()
        ch = cfg.block_out_channels[bi]
        temb = cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList([
            ResnetBlock(in_ch if li == 0 else ch, ch, temb, cfg.dtype)
            for li in range(cfg.layers_per_block)])
        if cfg.attn_down[bi]:
            self.attentions = nn.ModuleList([
                _transformer(cfg, ch) for _ in range(cfg.layers_per_block)])
        if bi != len(cfg.block_out_channels) - 1:
            self.downsamplers = nn.ModuleList([Downsample(ch, cfg.dtype)])


class _UpBlock(nn.Module):
    def __init__(self, cfg, ui, prev_ch):
        super().__init__()
        boc = cfg.block_out_channels
        n = len(boc)
        bi = n - 1 - ui
        ch, temb = boc[bi], boc[0] * 4
        self.resnets = nn.ModuleList()
        # skip widths, popped in reverse: the block's own resnets, then the
        # previous block's downsample output (or conv_in for the last block)
        for li in range(cfg.layers_per_block + 1):
            skip = boc[bi] if li < cfg.layers_per_block else \
                boc[max(bi - 1, 0)]
            in_ch = prev_ch if li == 0 else ch
            self.resnets.append(ResnetBlock(in_ch + skip, ch, temb,
                                            cfg.dtype))
        if cfg.attn_down[bi]:
            self.attentions = nn.ModuleList([
                _transformer(cfg, ch)
                for _ in range(cfg.layers_per_block + 1)])
        if ui != n - 1:
            self.upsamplers = nn.ModuleList([Upsample(ch, cfg.dtype)])


class _MidBlock(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        ch = cfg.block_out_channels[-1]
        temb = cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList([
            ResnetBlock(ch, ch, temb, cfg.dtype) for _ in range(2)])
        self.attentions = nn.ModuleList([_transformer(cfg, ch)])


def run_encoder(down_blocks, mid_block, h, temb, ehs, mode,
                ip_context=None):
    """Down blocks and mid block (shared by the UNet and the ControlNet,
    which passes no image tokens). Returns (h, skip residuals)."""
    residuals = [h]
    for blk in down_blocks:
        for li, res in enumerate(blk.resnets):
            h = res(h, temb)
            if hasattr(blk, "attentions"):
                h = blk.attentions[li](h, ehs, mode, ip_context)
            residuals.append(h)
        if hasattr(blk, "downsamplers"):
            h = blk.downsamplers[0](h)
            residuals.append(h)
    h = mid_block.resnets[0](h, temb)
    h = mid_block.attentions[0](h, ehs, mode, ip_context)
    return mid_block.resnets[1](h, temb), residuals


class UNet2DCondition(nn.Module):
    """Conditional UNet.

    forward(sample, timesteps, encoder_hidden_states, part='all'|'enc'|'dec',
    mode, down_block_res, mid_block_res, enc_state, ip_context):
    - 'all': epsilon (B, H, W, out) f32;
    - 'enc': dict(h, residuals, temb, ehs), the encoder state;
    - 'dec': consumes `enc_state` plus optional ControlNet residuals
      (NHWC, added to the skips and the mid output);
    - ip_context (B, T, C): IP-Adapter image tokens for every
      cross-attention (given to both parts), with mode.ip_tokens > 0 and
      the branches of `ip_adapter.add_ip_branches`.
    """

    def __init__(self, cfg: UNetConfig = SD15_UNET):
        super().__init__()
        self.cfg = cfg
        boc = cfg.block_out_channels
        dt = cfg.dtype
        self.time_embedding = _TimeEmbedding(boc[0], dt)
        self.conv_in = Conv(cfg.in_channels, boc[0], 3, padding=1, dtype=dt)
        self.down_blocks = nn.ModuleList()
        prev = boc[0]
        for bi, ch in enumerate(boc):
            self.down_blocks.append(_DownBlock(cfg, bi, prev))
            prev = ch
        self.mid_block = _MidBlock(cfg)
        self.up_blocks = nn.ModuleList()
        for ui in range(len(boc)):
            self.up_blocks.append(_UpBlock(cfg, ui, prev))
            prev = boc[len(boc) - 1 - ui]
        self.conv_norm_out = GroupNorm(32, boc[0], 1e-5)
        # conv_out stays f32 while the body runs in cfg.dtype (unet.py:230)
        self.conv_out = Conv(boc[0], cfg.out_channels, 3, padding=1,
                             dtype=torch.float32)

    def encode(self, sample, timesteps, ehs, mode=AttnMode(),
               ip_context=None):
        cfg, dt = self.cfg, self.cfg.dtype
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        temb = self.time_embedding(t_emb.to(dt))
        h = self.conv_in(nhwc_to_nchw(sample).to(dt))
        ehs = ehs.to(dt)
        if ip_context is not None:
            ip_context = ip_context.to(dt)
        h, residuals = run_encoder(self.down_blocks, self.mid_block, h, temb,
                                   ehs, mode, ip_context)
        return {"h": h, "residuals": residuals, "temb": temb, "ehs": ehs}

    def decode(self, enc_state, mode=AttnMode(), down_block_res=None,
               mid_block_res=None, ip_context=None):
        dt = self.cfg.dtype
        if ip_context is not None:
            ip_context = ip_context.to(dt)
        h, temb, ehs = enc_state["h"], enc_state["temb"], enc_state["ehs"]
        residuals = list(enc_state["residuals"])
        if down_block_res is not None:
            residuals = [r + nhwc_to_nchw(c).to(dt)
                         for r, c in zip(residuals, down_block_res)]
        if mid_block_res is not None:
            h = h + nhwc_to_nchw(mid_block_res).to(dt)
        for blk in self.up_blocks:
            for li, res in enumerate(blk.resnets):
                h = res(torch.cat([h, residuals.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[li](h, ehs, mode, ip_context)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        h = F.silu(self.conv_norm_out(h))
        return nchw_to_nhwc(self.conv_out(h))

    def forward(self, sample, timesteps, encoder_hidden_states, part="all",
                mode=AttnMode(), down_block_res=None, mid_block_res=None,
                enc_state=None, ip_context=None):
        if part == "dec":
            if enc_state is None:
                raise ValueError("part='dec' needs enc_state")
        else:
            enc_state = self.encode(sample, timesteps, encoder_hidden_states,
                                    mode, ip_context)
            if part == "enc":
                return enc_state
        return self.decode(enc_state, mode, down_block_res, mid_block_res,
                           ip_context)
