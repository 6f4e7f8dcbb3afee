"""GroupNorm and LayerNorm with f32 statistics.

Counterpart of `mvedit_tpu/models/diffusion/norm.py::GroupNormNHWC`. The
reference computes moments through ones-vector matmuls, a TPU layout trick;
here `torch.nn.functional.group_norm` runs on an f32 copy and the result is
cast back to the input dtype. Parameters are `weight` and `bias` (the
bridge maps flax's `scale` to `weight`).
"""
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["GroupNorm", "LayerNorm"]


class GroupNorm(nn.Module):
    """GroupNorm over an NCHW (or (N, C, ...)) tensor."""

    def __init__(self, num_groups, channels, eps=1e-5):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"channels {channels} not divisible by "
                             f"groups {num_groups}")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis; eps defaults to flax's 1e-6 (torch's
    default is 1e-5). `dtype` is the output dtype, as flax's."""

    def __init__(self, dim, eps=1e-6, dtype=None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        dt = self.compute_dtype or x.dtype
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                            self.bias.float(), self.eps).to(dt)
