"""GRM: the transformer gaussian-reconstruction network skeleton
(counterpart of `mvedit_tpu/models/grm.py`).

A ViT encoder over posed input views (RGB + Plücker ray embedding, patch
8), a pixel-shuffle `GaussianUpsampler` to per-pixel gaussian parameters,
and `pixels_to_gaussians`, which unprojects the predicted depth into
world-space means for `mesh.gaussians.render_gaussians`. The reference
ships only this skeleton; GRM's weights are unreleased.

Details kept from the reference: flax "SAME" padding of the patch embed
(none at multiples of the patch), LayerNorm eps 1e-6, the exact GELU of
`ViTBlock` against the tanh GELU of the upsampler (`jax.nn.gelu`'s
default), and the upsampler's (V, h, w, r, r, C) -> (V, h, r, w, r, C)
pixel layout, which is not `F.pixel_shuffle`'s channel order. Tensors are
NHWC at the interfaces, as the reference's. `grm_state_from_flax` carries
either module's flax params over.
"""
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.clip import clip
from ..utils.geometry import get_ray_directions, get_rays
from .diffusion.norm import LayerNorm
from .diffusion.weights import torch_state_from_flax
from .segmentors.dpt import ViTBlock, _pad_same
from .segmentors.efficientnet import Conv2d

__all__ = ["GRMConfig", "GRMEncoder", "GaussianUpsampler", "unproject_depth",
           "pixels_to_gaussians", "plucker_rays", "grm_state_from_flax"]


@dataclass(frozen=True)
class GRMConfig:
    patch_size: int = 8
    dim: int = 512
    depth: int = 12
    heads: int = 8
    out_channels: int = 14  # depth(1) + scale(3) + quat(4) + rgb(3) + op(1)
                            # + feat(2)


class GRMEncoder(nn.Module):
    """images (V, H, W, 3), plucker (V, H, W, 6) -> (V, H/ps, W/ps, dim):
    the views' patch tokens attend jointly, as one sequence."""

    def __init__(self, cfg: GRMConfig = GRMConfig()):
        super().__init__()
        self.cfg = cfg
        ps = cfg.patch_size
        self.patch_embed = Conv2d(9, cfg.dim, ps, stride=ps)
        self.blocks = nn.ModuleList([ViTBlock(cfg.dim, cfg.heads)
                                     for _ in range(cfg.depth)])
        self.norm = LayerNorm(cfg.dim)

    def forward(self, images, plucker):
        ps = self.cfg.patch_size
        x = torch.cat([images, plucker], -1).permute(0, 3, 1, 2)
        h = self.patch_embed(_pad_same(x.float(), ps, ps))
        V, C, hp, wp = h.shape
        t = h.permute(0, 2, 3, 1).reshape(1, V * hp * wp, C)
        for blk in self.blocks:
            t = blk(t)
        return self.norm(t).reshape(V, hp, wp, C)


class GaussianUpsampler(nn.Module):
    """Tokens (V, h, w, in_channels) -> per-pixel gaussian parameters
    (V, h * factor, w * factor, out_channels)."""

    def __init__(self, in_channels=512, out_channels=14, factor=8,
                 hidden=256):
        super().__init__()
        self.out_channels, self.factor = out_channels, factor
        self.conv1 = Conv2d(in_channels, hidden, 3, padding=1)
        self.conv2 = Conv2d(hidden, out_channels * factor * factor, 3,
                            padding=1)

    def forward(self, feat):
        V, h, w, _ = feat.shape
        r, C = self.factor, self.out_channels
        x = self.conv1(feat.permute(0, 3, 1, 2))
        x = self.conv2(F.gelu(x, approximate="tanh"))
        x = x.permute(0, 2, 3, 1).reshape(V, h, w, r, r, C)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(V, h * r, w * r, C)


def unproject_depth(depth, poses, intrinsics):
    """Per-pixel depth (V, H, W) along the unnormalised rays of poses
    (V, 3, 4) c2w and intrinsics (V, 4) -> world points (V, H, W, 3)."""
    V, H, W = depth.shape
    rays_o, rays_d = get_rays(get_ray_directions(H, W, intrinsics), poses)
    return rays_o + rays_d * depth[..., None]


def pixels_to_gaussians(params_map, poses, intrinsics,
                        depth_range=(0.1, 4.0)):
    """Split the (V, H, W, 14) upsampler output into flat gaussian
    attributes with world-space means."""
    d = torch.sigmoid(params_map[..., 0])
    depth = depth_range[0] + d * (depth_range[1] - depth_range[0])
    means = unproject_depth(depth, poses, intrinsics)
    scales = torch.exp(clip(params_map[..., 1:4], -8.0, 1.0)) * 0.01
    quats = params_map[..., 4:8]
    quats = quats / clip(torch.linalg.vector_norm(quats, dim=-1,
                                                  keepdim=True), 1e-8)
    colors = torch.sigmoid(params_map[..., 8:11])
    opac = torch.sigmoid(params_map[..., 11])

    def flat(x):
        return x.reshape(-1, *x.shape[3:])
    return {"means": flat(means), "scales": flat(scales),
            "quats": flat(quats), "colors": flat(colors),
            "opacities": flat(opac)}


def plucker_rays(poses, intrinsics, h, w):
    """The (V, h, w, 6) Plücker embedding (o x d, d) of the unit rays of
    poses (V, 3, 4) c2w and intrinsics (V, 4)."""
    rays_o, rays_d = get_rays(get_ray_directions(h, w, intrinsics), poses,
                              norm=True)
    return torch.cat([torch.linalg.cross(rays_o, rays_d), rays_d], -1)


def grm_state_from_flax(params):
    """A `GRMEncoder`'s or a `GaussianUpsampler`'s flax params -> the
    port's state dict."""
    return torch_state_from_flax(params, "grm")
