"""ControlNet: the UNet encoder, a hint-image embedding and zero-conv heads.

Counterpart of `mvedit_tpu/models/diffusion/controlnet.py`, with diffusers'
`ControlNetModel` parameter names. Public tensors are NHWC.
"""
import torch.nn.functional as F
from torch import nn

from .attention import AttnMode
from .layers import Conv
from .unet import (SD15_UNET, UNetConfig, _DownBlock, _MidBlock,
                   _TimeEmbedding, nchw_to_nhwc, nhwc_to_nchw,
                   run_encoder, timestep_embedding)

__all__ = ["ControlNet", "apply_multi_controlnet"]

_HINT_CHANNELS = (16, 32, 32, 96, 96, 256)


class _CondEmbedding(nn.Module):
    def __init__(self, cond_ch, out_ch, hint_strides, dtype):
        super().__init__()
        self.conv_in = Conv(cond_ch, 16, 3, padding=1, dtype=dtype)
        self.blocks = nn.ModuleList()
        prev, n_strided = 16, 0
        for i, ch in enumerate(_HINT_CHANNELS):
            # odd blocks stride 2 until `hint_strides` are used
            # (controlnet.py:57)
            stride = 2 if (i % 2 == 1 and n_strided < hint_strides) else 1
            n_strided += stride == 2
            self.blocks.append(Conv(prev, ch, 3, stride=stride, padding=1,
                                    dtype=dtype))
            prev = ch
        self.conv_out = Conv(prev, out_ch, 3, padding=1, dtype=dtype)

    def forward(self, c):
        c = F.silu(self.conv_in(c))
        for blk in self.blocks:
            c = F.silu(blk(c))
        return self.conv_out(c)


class ControlNet(nn.Module):
    """forward(sample, timesteps, ehs, cond_image, conditioning_scale, mode)
    -> (list of down residuals, mid residual), all NHWC in cfg.dtype.

    The hint embedding's `conv_out` and the `controlnet_down_blocks` /
    `controlnet_mid_block` heads are zero-initialised in a fresh model
    (controlnet.py:64,100,104)."""

    def __init__(self, cfg: UNetConfig = SD15_UNET, conditioning_channels=3,
                 hint_strides=3):
        super().__init__()
        self.cfg = cfg
        boc, dt = cfg.block_out_channels, cfg.dtype
        self.time_embedding = _TimeEmbedding(boc[0], dt)
        self.conv_in = Conv(cfg.in_channels, boc[0], 3, padding=1, dtype=dt)
        self.controlnet_cond_embedding = _CondEmbedding(
            conditioning_channels, boc[0], hint_strides, dt)
        self.down_blocks = nn.ModuleList()
        prev = boc[0]
        res_ch = [boc[0]]
        for bi, ch in enumerate(boc):
            self.down_blocks.append(_DownBlock(cfg, bi, prev))
            res_ch += [ch] * cfg.layers_per_block
            if bi != len(boc) - 1:
                res_ch.append(ch)
            prev = ch
        self.mid_block = _MidBlock(cfg)
        self.controlnet_down_blocks = nn.ModuleList(
            [Conv(c, c, 1, dtype=dt) for c in res_ch])
        self.controlnet_mid_block = Conv(boc[-1], boc[-1], 1, dtype=dt)
        for conv in [self.controlnet_cond_embedding.conv_out,
                     self.controlnet_mid_block,
                     *self.controlnet_down_blocks]:
            nn.init.zeros_(conv.weight)
            nn.init.zeros_(conv.bias)

    def forward(self, sample, timesteps, encoder_hidden_states, cond_image,
                conditioning_scale=1.0, mode=AttnMode()):
        cfg, dt = self.cfg, self.cfg.dtype
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        temb = self.time_embedding(t_emb.to(dt))
        h = self.conv_in(nhwc_to_nchw(sample).to(dt))
        h = h + self.controlnet_cond_embedding(
            nhwc_to_nchw(cond_image).to(dt))
        h, residuals = run_encoder(self.down_blocks, self.mid_block, h, temb,
                                   encoder_hidden_states.to(dt), mode)
        downs = [nchw_to_nhwc(conv(r) * conditioning_scale)
                 for conv, r in zip(self.controlnet_down_blocks, residuals)]
        return downs, nchw_to_nhwc(self.controlnet_mid_block(h)
                                   * conditioning_scale)


def apply_multi_controlnet(nets, sample, timesteps, ehs, cond_images,
                           scales, mode=AttnMode()):
    """Sum residuals over several ControlNets (diffusers MultiControlNet)."""
    downs, mid = None, None
    for net, ci, s in zip(nets, cond_images, scales):
        d, m = net(sample, timesteps, ehs, ci, conditioning_scale=s,
                   mode=mode)
        if downs is None:
            downs, mid = list(d), m
        else:
            downs = [a + b for a, b in zip(downs, d)]
            mid = mid + m
    return downs, mid
