"""Image-space ops (counterpart of `mvedit_tpu/ops/image.py`; `fill_holes`
waits for its slice).

- `gaussian_blur` / `highpass`: the Gaussian high-pass applied to normal
  maps before LPIPS;
- `erode`: morphological erosion, -maxpool(-x);
- `resize_bilinear`: `jax.image.resize(..., "bilinear")`, which filters
  with a triangle kernel widened by the scale when it shrinks (antialias);
  `F.interpolate(mode="bilinear", antialias=True)` is the same filter;
- `edge_dilation`: iterative fill of the pixels outside a mask from their
  valid 3x3 neighbours, used to pad texture atlases.
"""
import torch
import torch.nn.functional as F

from .clip import clip

__all__ = ["gaussian_kernel1d", "gaussian_blur", "highpass", "erode",
           "resize_bilinear", "edge_dilation"]


def gaussian_kernel1d(sigma, radius=None, device=None):
    if radius is None:
        radius = int(3.0 * sigma + 0.5)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _reflect(x, r, dim):
    """Reflect padding of r along `dim` (the edge not repeated), built
    from flipped slices: its backward adds at most two terms per element,
    in a fixed order, where `F.pad(mode="reflect")`'s CUDA backward adds
    atomically (one seed gave two normal-supervised fits)."""
    n = x.shape[dim]
    lo = x.narrow(dim, 1, r).flip(dim)
    hi = x.narrow(dim, n - 1 - r, r).flip(dim)
    return torch.cat([lo, x, hi], dim)


def gaussian_blur(img, sigma):
    """img: (..., H, W). Separable blur with reflect padding."""
    k = gaussian_kernel1d(sigma, device=img.device).to(img.dtype)
    r = (k.shape[0] - 1) // 2
    h, w = img.shape[-2:]
    x = _reflect(_reflect(img.reshape(-1, 1, h, w), r, 3), r, 2)
    x = F.conv2d(x, k.reshape(1, 1, -1, 1))
    x = F.conv2d(x, k.reshape(1, 1, 1, -1))
    return x.reshape(img.shape)


def highpass(img, sigma=3.0):
    """img - blur(img) + 0.5, clipped to [0, 1]."""
    return clip(img - gaussian_blur(img, sigma) + 0.5, 0.0, 1.0)


def erode(mask, kernel_size=3):
    """mask: (..., H, W); erosion = -maxpool(-x), the window padded with
    -inf (so the border sees only the pixels inside)."""
    h, w = mask.shape[-2:]
    x = -F.max_pool2d(-mask.reshape(-1, 1, h, w), kernel_size, stride=1,
                      padding=kernel_size // 2)
    return x.reshape(mask.shape)


def resize_bilinear(img, shape, antialias=True):
    """img: (..., H, W, C) -> (..., *shape, C), as `jax.image.resize` with
    "bilinear" (half-pixel centres, a triangle filter scaled by the
    shrink factor when `antialias`)."""
    *batch, h, w, c = img.shape
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    if (h, w) != tuple(shape):
        x = F.interpolate(x, size=tuple(shape), mode="bilinear",
                          align_corners=False, antialias=antialias)
    return x.permute(0, 2, 3, 1).reshape(*batch, *shape, c)


@torch.no_grad()
def edge_dilation(img, mask, n_iters=16):
    """img: (H, W, C); mask: (H, W) in {0, 1}. Each iteration, pixels
    outside the mask take the mask-weighted mean of their 3x3 neighbours
    (zero-padded), and join the mask where any neighbour was inside."""
    k = torch.ones((1, 1, 3, 3), dtype=torch.float32, device=img.device)

    def conv(x):                                  # (C, H, W)
        return F.conv2d(x[:, None], k, padding=1)[:, 0]
    im, m = img.float(), mask.float()
    for _ in range(n_iters):
        msum = conv(m[None])[0]
        csum = conv((im * m[..., None]).permute(2, 0, 1))
        filled = csum.permute(1, 2, 0) / msum[..., None].clamp(min=1e-8)
        im = torch.where(m[..., None] > 0, im, filled)
        m = torch.maximum(m, (msum > 0).float())
    return im
