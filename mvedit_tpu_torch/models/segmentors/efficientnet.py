"""EfficientNet-B7 encoder for TRACER, inference-mode BatchNorm.

Counterpart of `mvedit_tpu/models/segmentors/efficientnet.py`: the MBConv
stack of B0 scaled by width 2.0 and depth 3.1; `EfficientEncoderB7`
returns the four maps TRACER reads (48 / 80 / 224 / 640 channels at
strides 4 / 8 / 16 / 32). Module names are the reference checkpoint's
(EfficientNet-PyTorch: `_conv_stem`, `_bn0`, `_blocks.N._expand_conv`,
...), so its state dict loads with `load_state_dict`.

Also the layers the perception nets share: `Conv2d` / `Linear`, which
compute in f32 whatever their weights' dtype (the reference's flax layers
promote bf16 weights against f32 inputs), and `BN`, BatchNorm with stored
statistics (`running_mean` / `running_var` buffers), computed as the
reference's `(x - mean) * rsqrt(var + eps) * scale + bias`.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Conv2d", "Linear", "BN", "MBConv", "EfficientEncoderB7",
           "b7_stage_config"]


class Conv2d(nn.Conv2d):
    """NCHW conv computing in f32."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.float()
        return self._conv_forward(x.float(), self.weight.float(), b)


class Linear(nn.Linear):
    """Linear layer computing in f32."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.float()
        return F.linear(x.float(), self.weight.float(), b)


class BN(nn.Module):
    """Inference BatchNorm over NCHW (or (N, C)) input. eps is the
    tf-EfficientNet value 1e-3 by default; LoFTR passes torch's 1e-5."""

    def __init__(self, channels, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(self.running_var.float() + self.eps) \
            * self.weight.float()
        return (x.float() - self.running_mean.float().reshape(shape)) \
            * inv.reshape(shape) + self.bias.float().reshape(shape)


def _round_filters(c, width_mult, divisor=8):
    c *= width_mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return int(new_c)


def _round_repeats(r, depth_mult):
    return int(math.ceil(depth_mult * r))


# B0 stages: (expand, channels, repeats, stride, kernel)
_B0 = [(1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
       (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
       (6, 320, 1, 1, 3)]


def b7_stage_config():
    """B0's stages at B7's width (x2.0) and depth (x3.1)."""
    return [(e, _round_filters(c, 2.0), _round_repeats(r, 3.1), s, k)
            for (e, c, r, s, k) in _B0]


class MBConv(nn.Module):
    """Expand 1x1 -> depthwise k x k (symmetric k // 2 padding) ->
    squeeze-excite (a quarter of the INPUT channels) -> project 1x1, with
    the identity skip where the shape is kept."""

    def __init__(self, cin, cout, expand, stride, kernel):
        super().__init__()
        cexp = cin * expand
        self.expand, self.stride = expand, stride
        self.skip = stride == 1 and cin == cout
        if expand != 1:
            self._expand_conv = Conv2d(cin, cexp, 1, bias=False)
            self._bn0 = BN(cexp)
        self._depthwise_conv = Conv2d(cexp, cexp, kernel, stride=stride,
                                      padding=kernel // 2, groups=cexp,
                                      bias=False)
        self._bn1 = BN(cexp)
        se_c = max(1, int(cin * 0.25))
        self._se_reduce = Conv2d(cexp, se_c, 1)
        self._se_expand = Conv2d(se_c, cexp, 1)
        self._project_conv = Conv2d(cexp, cout, 1, bias=False)
        self._bn2 = BN(cout)

    def forward(self, x):
        h = x
        if self.expand != 1:
            h = F.silu(self._bn0(self._expand_conv(h)))
        h = F.silu(self._bn1(self._depthwise_conv(h)))
        s = h.mean((2, 3), keepdim=True)
        s = self._se_expand(F.silu(self._se_reduce(s)))
        h = self._project_conv(h * torch.sigmoid(s))
        h = self._bn2(h)
        return h + x if self.skip else h


class EfficientEncoderB7(nn.Module):
    """NCHW input -> [stage 2 (48, /4), stage 3 (80, /8), stage 5
    (224, /16), stage 7 (640, /32)] feature maps."""

    def __init__(self):
        super().__init__()
        stem = _round_filters(32, 2.0)
        self._conv_stem = Conv2d(3, stem, 3, stride=2, padding=1,
                                 bias=False)
        self._bn0 = BN(stem)
        blocks, self._taps = [], []
        cin = stem
        for si, (e, c, r, s, k) in enumerate(b7_stage_config()):
            for li in range(r):
                blocks.append(MBConv(cin, c, e, s if li == 0 else 1, k))
                cin = c
            if si in (1, 2, 4, 6):
                self._taps.append(len(blocks) - 1)
        self._blocks = nn.ModuleList(blocks)

    def forward(self, x):
        h = F.silu(self._bn0(self._conv_stem(x)))
        feats = []
        for i, blk in enumerate(self._blocks):
            h = blk(h)
            if i in self._taps:
                feats.append(h)
        return feats
