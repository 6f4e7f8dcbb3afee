"""Log2-domain tone curve with forward / inverse LUTs (counterpart of
`mvedit_tpu/ops/tonemapping.py`).

A fixed sigmoid + linear curve in log2 space, discretised to a 16-knot LUT
whose forward and inverse are both piecewise-linear interpolations. The
pipelines compose shading multiplicatively in this log space.
"""
from dataclasses import dataclass, field

import numpy as np
import torch

from .clip import clip

__all__ = ["Tonemapping"]


def _searchsorted_interp(xq, xs, ys):
    """Piecewise-linear interpolation of (xs, ys) at xq with linear
    extrapolation at both ends: segment k = [xs[k], xs[k+1]), the first and
    last segments extrapolate (`searchsorted(right=True)` with clipping, as
    the JAX package's branchless form selects)."""
    xs, ys = xs.to(xq.device), ys.to(xq.device)
    k = (torch.searchsorted(xs, xq.contiguous(), right=True) - 1).clamp(
        0, xs.shape[0] - 2)
    x0, x1 = xs[k], xs[k + 1]
    y0, y1 = ys[k], ys[k + 1]
    t = (xq - x0) / (x1 - x0)
    return y0 + (y1 - y0) * t


@dataclass(frozen=True)
class Tonemapping:
    exposure: float = 0.0
    contrast: float = 0.953
    bias: float = 0.088
    sigmoid_gain: float = 0.943
    log_gain: float = 0.011
    lut_logx_min: float = -9.0
    lut_logx_max: float = 3.0
    lut_steps: int = 16
    lut_x: torch.Tensor = field(init=False, repr=False)
    lut_y: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        lut_x = torch.from_numpy(np.linspace(
            self.lut_logx_min, self.lut_logx_max, self.lut_steps,
            dtype=np.float32))
        object.__setattr__(self, "lut_x", lut_x)
        object.__setattr__(self, "lut_y", self.smooth_forward(lut_x))

    def smooth_forward(self, x, input_mode="log"):
        assert input_mode in ("log", "linear")
        if input_mode == "linear":
            x = torch.log2(clip(x, 1e-6))
        x = (x + self.exposure) * self.contrast
        return (1.0 / (1.0 + torch.exp(-x)) * self.sigmoid_gain
                + x * self.log_gain + self.bias)

    def lut(self, x, input_mode="log"):
        assert input_mode in ("log", "linear")
        dtype = x.dtype
        x = x.to(self.lut_x.dtype)
        if input_mode == "linear":
            x = torch.log2(clip(x, 1e-6))
        return _searchsorted_interp(x, self.lut_x, self.lut_y).to(dtype)

    def inverse_lut(self, y, output_mode="log"):
        assert output_mode in ("log", "linear")
        dtype = y.dtype
        y = y.to(self.lut_y.dtype)
        x = _searchsorted_interp(y, self.lut_y, self.lut_x)
        if output_mode == "linear":
            x = torch.exp2(x)
        return x.to(dtype)
