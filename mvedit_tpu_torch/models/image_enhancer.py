"""SRVGGNetCompact x4 super-resolution, the "image enhancer" (counterpart of
`mvedit_tpu/models/image_enhancer.py`).

Real-ESRGAN's compact VGG net: conv + PReLU stack, a last conv to
3 * upscale^2 channels, `nn.PixelShuffle`, plus the nearest-upsampled input.
The module keeps Real-ESRGAN's own layout (`body.0` conv, `body.1` PReLU,
..., `body.{2n+2}` the last conv; PixelShuffle reads the channels as
(3, r, r)), so a `realesr-general-x4v3.pth` state dict loads with
`load_state_dict` as it is. The JAX module reads the last conv's channels
as (r, r, 3) and names it `conv_up`; `srvgg_state_from_flax` permutes them
so the two packages agree on bridged weights.

Images are NHWC in [0, 1], as in the reference. The convolutions run in
the input's dtype (the JAX module promotes bf16 weights to the f32 input).
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["SRVGGNetCompact", "srvgg_state_from_flax"]


class SRVGGNetCompact(nn.Module):
    def __init__(self, num_feat=64, num_conv=32, upscale=4):
        super().__init__()
        self.upscale = upscale
        body = [nn.Conv2d(3, num_feat, 3, padding=1),
                nn.PReLU(num_feat, init=0.25)]
        for _ in range(num_conv):
            body += [nn.Conv2d(num_feat, num_feat, 3, padding=1),
                     nn.PReLU(num_feat, init=0.25)]
        body.append(nn.Conv2d(num_feat, 3 * upscale ** 2, 3, padding=1))
        self.body = nn.ModuleList(body)
        self.upsampler = nn.PixelShuffle(upscale)

    def forward(self, x):
        """x: (B, H, W, 3) in [0, 1] -> (B, 4H, 4W, 3)."""
        h = x.permute(0, 3, 1, 2)
        base = F.interpolate(h, scale_factor=self.upscale, mode="nearest")
        for m in self.body:
            if isinstance(m, nn.Conv2d):
                h = F.conv2d(h, m.weight.to(h.dtype), m.bias.to(h.dtype),
                             padding=1)
            else:
                a = m.weight.to(h.dtype)[:, None, None]
                h = torch.where(h >= 0, h, a * h)
        return (self.upsampler(h) + base).permute(0, 2, 3, 1)


def srvgg_state_from_flax(params, num_conv, upscale=4):
    """The JAX module's params (`body_{2i}` / `conv_up` HWIO kernels,
    `prelu_{i}`) -> a state dict of `SRVGGNetCompact`. The last conv's
    output channels go from the JAX (r, r, 3) order to PixelShuffle's
    (3, r, r)."""
    def conv(p):
        return (np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1),
                np.asarray(p["bias"], np.float32))
    sd = {}
    for i in range(num_conv + 1):
        w, b = conv(params[f"body_{2 * i}"])
        sd[f"body.{2 * i}.weight"], sd[f"body.{2 * i}.bias"] = w, b
        sd[f"body.{2 * i + 1}.weight"] = np.asarray(params[f"prelu_{i}"],
                                                    np.float32)
    w, b = conv(params["conv_up"])
    r = upscale
    # torch channel (c, i, j) <- JAX channel (i, j, c)
    perm = np.arange(3 * r * r).reshape(r, r, 3).transpose(2, 0, 1).reshape(-1)
    last = 2 * num_conv + 2
    sd[f"body.{last}.weight"], sd[f"body.{last}.bias"] = w[perm], b[perm]
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}
