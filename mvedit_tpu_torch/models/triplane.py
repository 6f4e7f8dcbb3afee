"""Triplane NeRF decoder, its iNGP hybrid and the triplane latent
upsampler (counterpart of `mvedit_tpu/models/triplane.py`).

- `triplane_point_decode`: code (3, C, H, W) -> each plane sampled
  bilinearly at the point's plane coordinates (planes `plane_cfg`, z
  flipped with `flip_z`, border padding, align_corners False) -> features
  interleaved channel-major (C x 3) -> base MLP -> silu -> density MLP +
  trunc_exp; colour: silu(base + dir MLP(SH4(dirs))) -> colour MLP ->
  saturated sigmoid.
- `triplane_ingp_point_decode`: the same heads on the triplane features
  plus a zero-initialised projection of a hash-grid encoding (a frozen
  triplane with a trainable residual).
- `VAEDecoderPreproc`: 12ch 40x40 -> 48ch 80x80 per plane.

Parameters are dicts of tensors in the JAX pytree's layout
(`triplane_params_from_flax` bridges them). The code is sampled forward
only (`ops.grid_sample.grid_sample_2d`): no path differentiates the code
or the points, and torch's grid-sample backward adds atomically on the
card. Gradients reach the MLPs and the hash table.
"""
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activation import trunc_exp
from ..ops.grid_sample import grid_sample_2d
from ..ops.hash_grid import HashGridConfig, hash_grid_encode, hash_grid_init
from ..ops.sh import sh_encode
from .diffusion.layers import Conv
from .diffusion.norm import GroupNorm
from .diffusion.unet import ResnetBlock
from .fields import mlp_apply, mlp_init

__all__ = ["TriPlaneConfig", "triplane_init", "triplane_point_decode",
           "TriPlaneINGPConfig", "triplane_ingp_init",
           "triplane_ingp_point_decode", "VAEDecoderPreproc",
           "triplane_params_from_flax"]


@dataclass(frozen=True)
class TriPlaneConfig:
    n_channels: int = 16
    plane_cfg: Tuple[str, ...] = ("yx", "yz", "xz")
    flip_z: bool = True
    base_layers: Tuple[int, ...] = (48, 64)
    density_layers: Tuple[int, ...] = (64, 1)
    color_layers: Tuple[int, ...] = (64, 3)
    dir_layers: Optional[Tuple[int, ...]] = (16, 64)
    sigmoid_saturation: float = 0.001
    bound: float = 1.0


def _zero_last(layers):
    layers[-1] = {k: torch.zeros_like(v) for k, v in layers[-1].items()}
    return layers


def triplane_init(cfg: TriPlaneConfig, generator=None, device=None):
    """Xavier-uniform MLPs; the dir MLP's last layer zero (the reference's
    `constant_init(dir_net[-1], 0)`)."""
    params = {
        "base": mlp_init(cfg.base_layers, generator, device),
        "density": mlp_init(cfg.density_layers, generator, device),
        "color": mlp_init(cfg.color_layers, generator, device),
    }
    if cfg.dir_layers is not None:
        params["dir"] = _zero_last(mlp_init(cfg.dir_layers, generator,
                                            device))
    return params


def _plane_coords(xyz, cfg: TriPlaneConfig):
    """xyz (P, 3) in [-bound, bound] -> (3, P, 2) grid coords in [-1, 1]."""
    x, y, z = (xyz[..., i] / cfg.bound for i in range(3))
    if cfg.flip_z:
        z = -z
    axes = {"x": x, "y": y, "z": z}
    return torch.stack([torch.stack([axes[p[0]], axes[p[1]]], -1)
                        for p in cfg.plane_cfg])


def _silu(x):
    return x * torch.sigmoid(x)


def _triplane_features(code, xyz, cfg: TriPlaneConfig):
    """(P, C * 3) features, channel-major (the reference's permute)."""
    P = xyz.shape[0]
    sampled = grid_sample_2d(code.float(), _plane_coords(xyz, cfg)[:, None],
                             padding_mode="border",
                             align_corners=False)          # (3, C, 1, P)
    return sampled[:, :, 0].permute(2, 1, 0).reshape(P, -1)


def _decode_heads(params, feat, dirs, cfg: TriPlaneConfig, density_only):
    base = mlp_apply(params["base"], feat)
    base_act = _silu(base)
    sigma = trunc_exp(mlp_apply(params["density"], base_act)[..., 0])
    if density_only:
        return sigma, None
    if dirs is not None and "dir" in params:
        color_in = _silu(base + mlp_apply(params["dir"],
                                          sh_encode(dirs, degree=4)))
    else:
        color_in = base_act
    rgb = torch.sigmoid(mlp_apply(params["color"], color_in))
    if cfg.sigmoid_saturation > 0:
        rgb = rgb * (1 + 2 * cfg.sigmoid_saturation) - cfg.sigmoid_saturation
    return sigma, rgb


def triplane_point_decode(params, code, xyz, dirs, cfg: TriPlaneConfig,
                          density_only=False):
    """code: (3, C, H, W); xyz: (P, 3); dirs: (P, 3) or None -> (sigma
    (P,), rgb (P, 3) or None with `density_only`)."""
    return _decode_heads(params, _triplane_features(code, xyz, cfg), dirs,
                         cfg, density_only)


@dataclass(frozen=True)
class TriPlaneINGPConfig:
    triplane: TriPlaneConfig = field(default_factory=TriPlaneConfig)
    hash: HashGridConfig = field(default_factory=HashGridConfig)
    ingp_base_hidden: int = 64


def triplane_ingp_init(cfg: TriPlaneINGPConfig, generator=None,
                       device=None):
    """`triplane_init`'s params, the hash table and a zero-initialised
    projection of its features onto the triplane's (the refinement starts
    from the frozen triplane)."""
    params = triplane_init(cfg.triplane, generator, device)
    params["table"] = hash_grid_init(cfg.hash, generator, device)
    params["ingp_base"] = _zero_last(mlp_init(
        (cfg.hash.out_dim, cfg.triplane.base_layers[0]), generator, device))
    return params


def triplane_ingp_point_decode(params, code, xyz, dirs,
                               cfg: TriPlaneINGPConfig, density_only=False):
    tp = cfg.triplane
    feat = _triplane_features(code, xyz, tp)
    enc = hash_grid_encode(params["table"],
                           (xyz + tp.bound) / (2 * tp.bound), cfg.hash)
    feat = feat + mlp_apply(params["ingp_base"], enc)
    return _decode_heads(params, feat, dirs, tp, density_only)


def triplane_params_from_flax(tree, device=None):
    """The JAX triplane (or hybrid) pytree, leaves as numpy or JAX arrays
    -> the port's params, float32 tensors on `device`."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    return {k: (t(v) if k == "table"
                else [{n: t(l[n]) for n in ("w", "b")} for l in v])
            for k, v in tree.items()}


class VAEDecoderPreproc(nn.Module):
    """12ch 40x40 -> 48ch 80x80 per plane: up blocks (256, 128) of 3
    resnets each, one 2x nearest upsample and conv between them, the VAE
    decoder's norm and output conv. Module names are the flax module's
    (`conv_in`, `mid_resnets_i`, `up_b_resnets_i`, `up_b_upsample`,
    `conv_norm_out`, `conv_out`); GroupNorm eps 1e-6 as flax's."""

    def __init__(self, in_channels=12, out_channels=48,
                 block_out_channels=(128, 256), layers_per_block=2,
                 dtype=torch.float32):
        super().__init__()
        ch = block_out_channels[-1]
        self.conv_in = Conv(in_channels, ch, 3, padding=1, dtype=dtype)
        self.mid_resnets_0 = ResnetBlock(ch, ch, 0, dtype, eps=1e-6)
        self.mid_resnets_1 = ResnetBlock(ch, ch, 0, dtype, eps=1e-6)
        self.n_blocks = len(block_out_channels)
        self.layers_per_block = layers_per_block
        prev = ch
        for bi, ch in enumerate(reversed(block_out_channels)):
            for li in range(layers_per_block + 1):
                self.add_module(f"up_{bi}_resnets_{li}",
                                ResnetBlock(prev, ch, 0, dtype, eps=1e-6))
                prev = ch
            if bi != self.n_blocks - 1:
                self.add_module(f"up_{bi}_upsample",
                                Conv(ch, ch, 3, padding=1, dtype=dtype))
        self.conv_norm_out = GroupNorm(32, prev, 1e-6)
        self.conv_out = Conv(prev, out_channels, 3, padding=1,
                             dtype=torch.float32)

    def forward(self, z):
        """z: (3, H, W, Cin) NHWC -> (3, 2H, 2W, Cout)."""
        h = self.conv_in(z.permute(0, 3, 1, 2))
        h = self.mid_resnets_1(self.mid_resnets_0(h))
        for bi in range(self.n_blocks):
            for li in range(self.layers_per_block + 1):
                h = getattr(self, f"up_{bi}_resnets_{li}")(h)
            if bi != self.n_blocks - 1:
                h = getattr(self, f"up_{bi}_upsample")(
                    F.interpolate(h, scale_factor=2, mode="nearest"))
        h = F.silu(self.conv_norm_out(h))
        return self.conv_out(h).permute(0, 2, 3, 1)
