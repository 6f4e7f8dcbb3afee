"""Linear and conv layers with flax's `dtype` semantics.

A flax `nn.Dense(..., dtype=dt)` casts both its input and its parameters to
`dt` before the product. The reference relies on that: its full-size
models store bf16 parameters and still run some layers in f32 (the UNet's
`conv_out`, the VAE's `quant_conv` / `post_quant_conv` / `conv_out`, all of
CLIP). These layers do the same; `dtype=None` computes in the parameters'
own dtype. Parameter names and shapes are torch's (`weight` (O, I) or
(O, I, kh, kw), `bias`), so diffusers-keyed state dicts load unchanged.
"""
import torch.nn.functional as F
from torch import nn

__all__ = ["Dense", "Conv"]


class Dense(nn.Linear):
    def __init__(self, in_features, out_features, bias=True, dtype=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv(nn.Conv2d):
    """NCHW conv; `padding` as torch's (symmetric), matching flax's
    `padding=1` for 3x3 kernels."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0,
                 bias=True, dtype=None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding)
