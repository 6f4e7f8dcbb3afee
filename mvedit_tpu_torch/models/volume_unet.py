"""Dense and masked-sparse 3D volume UNets (counterpart of
`mvedit_tpu/models/volume_unet.py`, the reference's
`lib/models/architecture/volume.py`), in NCDHW.

The reference's sparse blocks (spconv) run as masked dense compute, as in
the JAX package: a submanifold conv is `conv3d(x * mask) * mask`, the
sparse GroupNorm a group norm with statistics over the active voxels, the
sparse upsample a normalised masked trilinear upsample restricted to the
fine mask. `_MidAttention` flattens D * H * W voxels into a sequence, with
its own f32 softmax and a zero-initialised `to_out` (with
`zero_init_residual`).

Module names are the flax module's; `volume_unet_state_from_flax` bridges
its params (DHWIO conv kernels to OIDHW, the masked blocks'
`norm1_scale` / `norm1_bias` to `norm1.weight` / `.bias`).
"""
import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .diffusion.norm import GroupNorm

__all__ = ["VolumeUNetConfig", "UNetVolume", "ResnetBlockVolume",
           "masked_group_norm", "masked_conv3d_apply",
           "masked_trilinear_upsample", "downsample_mask",
           "volume_unet_state_from_flax", "init_volume_unet_"]


@dataclasses.dataclass(frozen=True)
class VolumeUNetConfig:
    """UNetVolume.__init__'s arguments (volume.py:287-313)."""
    in_channels: int = 4
    out_channels: Optional[int] = None
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: Union[int, Tuple[int, ...]] = 2
    encoder_block_out_channels: Optional[Tuple[int, ...]] = None
    encoder_layers_per_block: Union[int, Tuple[int, ...]] = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    attention_head_dim: Union[int, Tuple[int, ...]] = 8
    conv_in_kernel: int = 3
    conv_out_kernel: int = 3
    zero_init_residual: bool = True
    dtype: torch.dtype = torch.float32


class Conv3d(nn.Conv3d):
    """NCDHW conv computing in `dtype` (None: the weights' own)."""

    def __init__(self, cin, cout, k, stride=1, dtype=None, zero_init=False):
        super().__init__(cin, cout, k, stride=stride, padding=(k - 1) // 2)
        self.compute_dtype = dtype
        self.zero_init = zero_init

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        return F.conv3d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride, self.padding)


class Dense(nn.Linear):
    def __init__(self, cin, cout, dtype=None, zero_init=False):
        super().__init__(cin, cout)
        self.compute_dtype = dtype
        self.zero_init = zero_init

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def masked_group_norm(x, mask, groups, scale, bias, eps=1e-5):
    """Group norm with statistics over the active voxels only.

    x: (B, C, D, H, W); mask: (B, D, H, W) bool; scale / bias: (C,)."""
    B, C = x.shape[:2]
    g = groups
    xf = x.reshape(B, g, C // g, -1).float()
    m = mask.reshape(B, 1, 1, -1).float()
    n = m.sum(-1, keepdim=True) * (C // g) + 1e-12
    mean = (xf * m).sum((2, 3), keepdim=True) / n
    var = ((xf - mean).square() * m).sum((2, 3), keepdim=True) / n
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape).to(x.dtype)
    shape = (1, C, 1, 1, 1)
    y = y * scale.to(x.dtype).reshape(shape) + bias.to(x.dtype).reshape(
        shape)
    return y * mask[:, None].to(x.dtype)


def masked_conv3d_apply(conv, x, mask):
    """Submanifold conv: inputs zeroed off the mask, outputs kept on it."""
    mf = mask[:, None].to(x.dtype)
    return conv(x * mf) * mf


def downsample_mask(mask, stride=2):
    """The active set of a stride-2 sparse conv: any active input in the
    window."""
    return F.max_pool3d(mask[:, None].float(), stride, stride)[:, 0] > 0.5


def _interleave(a, b, axis):
    return torch.stack([a, b], axis + 1).flatten(axis, axis + 1)


def _trilinear2x(x):
    """2x upsampling with half-pixel centres along D, H, W of (B, C, D, H,
    W): fine voxel 2i sits at coarse i - 0.25, 2i + 1 at i + 0.25, border
    corners clamped."""
    for axis in (2, 3, 4):
        n = x.shape[axis]
        idx = torch.arange(n, device=x.device)
        xm1 = x.index_select(axis, (idx - 1).clamp(min=0))
        xp1 = x.index_select(axis, (idx + 1).clamp(max=n - 1))
        x = _interleave(0.25 * xm1 + 0.75 * x, 0.75 * x + 0.25 * xp1, axis)
    return x


def masked_trilinear_upsample(x, mask, fine_mask, eps=1e-6):
    """The coarse masked volume sampled at the fine voxel centres with
    normalised trilinear weights (missing coarse corners renormalised
    away), kept on `fine_mask`.

    x: (B, C, d, h, w); mask: (B, d, h, w); fine_mask: (B, 2d, 2h, 2w).
    Returns (out, the fine mask where some coarse weight reached)."""
    mf = mask[:, None].float()
    num = _trilinear2x(x.float() * mf)
    den = _trilinear2x(mf)
    out = num / (den + eps)
    return ((out * fine_mask[:, None].to(out.dtype)).to(x.dtype),
            fine_mask & (den[:, 0] > eps))


class ResnetBlockVolume(nn.Module):
    """GroupNorm-silu-conv twice plus the shortcut; with a mask, the
    submanifold conv and sparse GroupNorm semantics."""

    def __init__(self, cin, cout, groups=32, eps=1e-5,
                 zero_init_residual=True, dtype=None):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.norm1 = GroupNorm(groups, cin, eps)
        self.conv1 = Conv3d(cin, cout, 3, dtype=dtype)
        self.norm2 = GroupNorm(groups, cout, eps)
        self.conv2 = Conv3d(cout, cout, 3, dtype=dtype,
                            zero_init=zero_init_residual)
        self.conv_shortcut = (Conv3d(cin, cout, 1, dtype=dtype)
                              if cin != cout else None)

    def forward(self, x, mask=None):
        if mask is None:
            h = self.conv1(F.silu(self.norm1(x)))
            h = self.conv2(F.silu(self.norm2(h)))
        else:
            h = masked_group_norm(x, mask, self.groups, self.norm1.weight,
                                  self.norm1.bias, self.eps)
            h = masked_conv3d_apply(self.conv1, F.silu(h), mask)
            h = masked_group_norm(h, mask, self.groups, self.norm2.weight,
                                  self.norm2.bias, self.eps)
            h = masked_conv3d_apply(self.conv2, F.silu(h), mask)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x) if mask is None else \
                masked_conv3d_apply(self.conv_shortcut, x, mask)
        return x + h


class _MidAttention(nn.Module):
    """Voxel self-attention with a residual; scores and softmax in f32."""

    def __init__(self, ch, head_dim, groups, eps, zero_init_residual,
                 dtype):
        super().__init__()
        self.heads = max(ch // head_dim, 1)
        self.group_norm = GroupNorm(groups, ch, eps)
        self.to_q = Dense(ch, ch, dtype)
        self.to_k = Dense(ch, ch, dtype)
        self.to_v = Dense(ch, ch, dtype)
        self.to_out = Dense(ch, ch, dtype, zero_init=zero_init_residual)

    def forward(self, x):
        B, C, D, H, W = x.shape
        L, hd = D * H * W, C // self.heads
        h = self.group_norm(x).flatten(2).transpose(1, 2)       # (B, L, C)

        def heads(t):
            return t.reshape(B, L, self.heads, hd).transpose(1, 2)
        q, k, v = heads(self.to_q(h)), heads(self.to_k(h)), heads(
            self.to_v(h))
        a = torch.einsum("bhqd,bhkd->bhqk", q, k).float()
        a = torch.softmax(a / np.sqrt(hd).astype(np.float32), -1).to(v.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", a, v)
        o = self.to_out(o.transpose(1, 2).reshape(B, L, C))
        return x + o.transpose(1, 2).reshape(B, C, D, H, W).to(x.dtype)


def _per_block(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class UNetVolume(nn.Module):
    """Dense 3D UNet over volume codes: forward(sample (B, Cin, D, H, W))
    -> (out, extra_res), the strided encoder's per-stage activations
    (conv_in's output alone without one)."""

    def __init__(self, cfg: VolumeUNetConfig):
        super().__init__()
        self.cfg = cfg
        dt, gn, eps = cfg.dtype, cfg.norm_num_groups, cfg.norm_eps
        zi = cfg.zero_init_residual
        boc = cfg.block_out_channels
        n = len(boc)
        lpb = _per_block(cfg.layers_per_block, n)
        ahd = _per_block(cfg.attention_head_dim, n)

        def res(name, cin, cout):
            self.add_module(name, ResnetBlockVolume(cin, cout, gn, eps, zi,
                                                    dt))

        ebc = cfg.encoder_block_out_channels
        first = boc[0] if ebc is None else ebc[0]
        self.conv_in = Conv3d(cfg.in_channels, first, cfg.conv_in_kernel,
                              dtype=dt)
        cur = first
        if ebc is not None:
            elpb = _per_block(cfg.encoder_layers_per_block, len(ebc))
            for i, ch in enumerate(ebc):
                for j in range(elpb[i]):
                    res(f"enc_{i}_res_{j}", cur, ch)
                    cur = ch
                self.add_module(f"enc_{i}_down",
                                Conv3d(ch, ch, 3, stride=2, dtype=dt))
        skips = [cur]
        for i, ch in enumerate(boc):
            for j in range(lpb[i]):
                res(f"down_{i}_res_{j}", cur, ch)
                cur = ch
                skips.append(ch)
            if i != n - 1:
                self.add_module(f"down_{i}_downsample",
                                Conv3d(ch, ch, 3, stride=2, dtype=dt))
                skips.append(ch)
        res("mid_res_0", cur, boc[-1])
        self.mid_attn = _MidAttention(boc[-1], ahd[-1], gn, eps, zi, dt)
        res("mid_res_1", boc[-1], boc[-1])
        cur = boc[-1]
        for i, (ch, nl) in enumerate(zip(reversed(boc), reversed(lpb))):
            for j in range(nl + 1):
                res(f"up_{i}_res_{j}", cur + skips.pop(), ch)
                cur = ch
            if i != n - 1:
                self.add_module(f"up_{i}_upsample",
                                Conv3d(ch, ch, 3, dtype=dt))
        self.conv_norm_out = GroupNorm(gn, cur, eps)
        self.conv_out = (Conv3d(cur, cfg.out_channels, cfg.conv_out_kernel,
                                dtype=torch.float32)
                         if cfg.out_channels is not None else None)

    def forward(self, sample):
        cfg = self.cfg
        boc = cfg.block_out_channels
        n = len(boc)
        lpb = _per_block(cfg.layers_per_block, n)
        h = self.conv_in(sample)
        extra_res = (h,)
        ebc = cfg.encoder_block_out_channels
        if ebc is not None:
            elpb = _per_block(cfg.encoder_layers_per_block, len(ebc))
            for i in range(len(ebc)):
                for j in range(elpb[i]):
                    h = getattr(self, f"enc_{i}_res_{j}")(h)
                    extra_res += (h,)
                h = getattr(self, f"enc_{i}_down")(h)
                extra_res += (h,)
        skips = [h]
        for i in range(n):
            for j in range(lpb[i]):
                h = getattr(self, f"down_{i}_res_{j}")(h)
                skips.append(h)
            if i != n - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                skips.append(h)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        for i, nl in enumerate(reversed(lpb)):
            for j in range(nl + 1):
                h = torch.cat([h, skips.pop()], 1)
                h = getattr(self, f"up_{i}_res_{j}")(h)
            if i != n - 1:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"up_{i}_upsample")(h)
        h = F.silu(self.conv_norm_out(h))
        if self.conv_out is not None:
            h = self.conv_out(h)
        return h, extra_res


@torch.no_grad()
def init_volume_unet_(net, generator):
    """Seeded init after the reference's: conv kernels He-normal
    (N(0, 2 / fan_in)), `to_q` / `to_k` / `to_v` N(0, 1 / fan_in), the
    zero-initialised residual convs and `to_out` 0, biases 0, norm
    weights 1."""
    for m in net.modules():
        if isinstance(m, (Conv3d, Dense)):
            if m.zero_init:
                m.weight.zero_()
            else:
                gain = 2.0 if isinstance(m, Conv3d) else 1.0
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(
                    m.weight.shape, generator=generator,
                    device=m.weight.device) * (gain / fan_in) ** 0.5)
            m.bias.zero_()
        elif isinstance(m, GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return net


def volume_unet_state_from_flax(tree):
    """`UNetVolume` / `ResnetBlockVolume` flax params -> the port's state
    dict."""
    from .diffusion.weights import flatten
    state = {}
    for path, val in flatten(tree).items():
        arr = np.array(val)
        module, _, leaf = path.rpartition("/")
        m = {"norm1_scale": ("norm1", "weight"),
             "norm1_bias": ("norm1", "bias"),
             "norm2_scale": ("norm2", "weight"),
             "norm2_bias": ("norm2", "bias")}.get(leaf)
        if m is not None:
            module, leaf = f"{module}/{m[0]}", m[1]
        elif leaf == "kernel":
            leaf = "weight"
            arr = arr.transpose(4, 3, 0, 1, 2) if arr.ndim == 5 else arr.T
        elif leaf == "scale":
            leaf = "weight"
        key = f"{module}/{leaf}".lstrip("/").replace("/", ".")
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state
