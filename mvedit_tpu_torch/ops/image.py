"""Image-space ops (counterpart of `mvedit_tpu/ops/image.py`).

- `gaussian_blur` / `highpass`: the Gaussian high-pass applied to normal
  maps before LPIPS;
- `erode`: morphological erosion, -maxpool(-x);
- `resize_bilinear`: `jax.image.resize(..., "bilinear")`, which filters
  with a triangle kernel widened by the scale when it shrinks (antialias);
  `F.interpolate(mode="bilinear", antialias=True)` is the same filter;
- `edge_dilation`: iterative fill of the pixels outside a mask from their
  valid 3x3 neighbours, used to pad texture atlases;
- `fill_holes`: grayscale reconstruction by erosion, which raises the dark
  basins that do not touch the border.
"""
import torch
import torch.nn.functional as F

from .clip import clip

__all__ = ["gaussian_kernel1d", "gaussian_blur", "highpass", "erode",
           "resize_bilinear", "edge_dilation", "fill_holes"]

_FILL_CHECK = 16        # fill_holes' steps between two convergence checks


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


@torch.no_grad()
def fill_holes(image, max_iters=None):
    """Fill the dark holes of a grayscale (H, W) image, leaving the border:
    reconstruction by erosion (skimage's `reconstruction(seed, image,
    method="erosion")`) from the seed `image.max()` everywhere but the
    1-pixel border. It iterates `f <- max(minpool3x3(f), image)` to its
    fixed point, at most `max_iters` (default H + W, the longest path a
    value can travel) steps after the first, as the reference does; the
    fixed point is tested every `_FILL_CHECK` steps, so that the card is
    not waited for after each. Returns float32 (H, W)."""
    img = torch.as_tensor(image, dtype=torch.float32)
    H, W = img.shape
    if max_iters is None:
        max_iters = H + W
    f = torch.full_like(img, float(img.max()))
    f[0, :], f[-1, :], f[:, 0], f[:, -1] = img[0, :], img[-1, :], \
        img[:, 0], img[:, -1]

    def step(x):
        # the min-pool pads with +inf, as the reference's reduce_window
        return torch.maximum(-F.max_pool2d(-x[None, None], 3, 1, 1)[0, 0],
                             img)
    left = max_iters + 1
    while left > 0:
        for _ in range(min(_FILL_CHECK, left) - 1):
            f = step(f)
        prev, f = f, step(f)
        left -= min(_FILL_CHECK, left)
        if torch.equal(f, prev):
            break
    return f
