"""Image pre- and post-processing of the endpoints (counterpart of
`mvedit_tpu/pipelines/preproc.py`).

Host numpy code in float64, copied from the reference package:

- `pad_rgba_image`: centre the foreground on a square canvas;
- `guided_filter` / `refine_alpha`: the edge-aware alpha refinement
  (a guided filter over the RGB image, the reference's stand-in for
  closed-form matting);
- `zero123plus_matte_alpha` / `zero123plus_postprocess`: Zero123++ v1.2's
  normal-norm matte of a generated view and its normal map composited on
  0.5 grey;
- `do_segmentation`: the segmenter's masks -> the background-colour
  override -> a box-prompted refinement (SAM) -> erosion.

Two erosions, as in the reference: `_binary_erosion` pads with a constant,
`do_segmentation`'s own pads with the edge values.
"""
import numpy as np
import torch

__all__ = ["pad_rgba_image", "guided_filter", "refine_alpha",
           "zero123plus_matte_alpha", "zero123plus_postprocess",
           "do_segmentation"]


def pad_rgba_image(rgba, ratio=0.75):
    """Crop to the alpha bbox and re-pad so that the object fills `ratio`
    of a square canvas."""
    rgba = np.asarray(rgba)
    alpha = rgba[..., 3] if rgba.shape[-1] == 4 else np.ones(rgba.shape[:2])
    ys, xs = np.nonzero(alpha > 0.5 * alpha.max())
    if len(ys) == 0:
        return rgba
    y0, y1 = ys.min(), ys.max() + 1
    x0, x1 = xs.min(), xs.max() + 1
    crop = rgba[y0:y1, x0:x1]
    h, w = crop.shape[:2]
    size = int(round(max(h, w) / ratio))
    out = np.zeros((size, size, rgba.shape[-1]), rgba.dtype)
    oy = (size - h) // 2
    ox = (size - w) // 2
    out[oy:oy + h, ox:ox + w] = crop
    return out


def _box_filter(x, r):
    """Box filter by cumsum, edge-padded. x: (H, W) or (H, W, C)."""
    def f1(a, axis):
        pad = [(0, 0)] * a.ndim
        pad[axis] = (r + 1, r)
        c = np.cumsum(np.pad(a, pad, mode="edge"), axis=axis)
        hi = np.take(c, np.arange(2 * r + 1, c.shape[axis]), axis=axis)
        lo = np.take(c, np.arange(0, c.shape[axis] - 2 * r - 1), axis=axis)
        return (hi - lo) / (2 * r + 1)
    return f1(f1(np.asarray(x, np.float64), 0), 1)


def guided_filter(guide, src, radius=8, eps=1e-4):
    """He et al.'s guided filter: smoothing of `src` with a local linear
    model of the guide image's mean channel."""
    g = np.asarray(guide, np.float64)
    if g.ndim == 3:
        g = g.mean(-1)
    p = np.asarray(src, np.float64)
    mean_g = _box_filter(g, radius)
    mean_p = _box_filter(p, radius)
    corr_gp = _box_filter(g * p, radius)
    corr_gg = _box_filter(g * g, radius)
    var_g = corr_gg - mean_g ** 2
    cov_gp = corr_gp - mean_g * mean_p
    a = cov_gp / (var_g + eps)
    b = mean_p - a * mean_g
    return _box_filter(a, radius) * g + _box_filter(b, radius)


def refine_alpha(image, alpha, radius=8, eps=1e-4):
    """Edge-aware alpha refinement, clipped to [0, 1], float32."""
    out = guided_filter(image, np.asarray(alpha, np.float64), radius, eps)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def _binary_erosion(mask, k=4, border_value=0):
    """Erosion by a k x k all-ones structuring element, the outside taken
    as `border_value`."""
    m = np.asarray(mask, bool)
    pad = np.pad(m, k // 2 + 1, mode="constant",
                 constant_values=bool(border_value))
    out = np.ones_like(m)
    h, w = m.shape
    o = k // 2 + 1
    for dy in range(k):
        for dx in range(k):
            out &= pad[o + dy - k // 2: o + dy - k // 2 + h,
                       o + dx - k // 2: o + dx - k // 2 + w]
    return out


def zero123plus_matte_alpha(rgb, normal, fg_thresh=0.6, bg_thresh=0.2,
                            erosion=4):
    """Zero123++ v1.2's normal model paints the background 0.5 grey, so
    ||2 n - 1|| is a soft foreground prior. The trimap: eroded foreground
    (norm > 0.6), eroded background (norm < 0.2), the band between
    resolved by the guided filter over the RGB view, the trimap's hard
    values re-imposed.

    rgb, normal: (H, W, 3) in [0, 1]. Returns alpha (H, W) float32."""
    rgb = np.asarray(rgb, np.float32)
    nvec = np.asarray(normal, np.float64) * 2 - 1
    alpha_pred = np.linalg.norm(nvec, axis=-1)
    is_fg = _binary_erosion(alpha_pred > fg_thresh, erosion, 0)
    is_bg = _binary_erosion(alpha_pred < bg_thresh, erosion, 1)
    trimap = np.full(alpha_pred.shape, 0.5, np.float64)
    trimap[is_fg] = 1.0
    trimap[is_bg] = 0.0
    alpha = refine_alpha(rgb, trimap)
    alpha[is_fg] = 1.0
    alpha[is_bg] = 0.0
    return alpha.astype(np.float32)


def zero123plus_postprocess(rgb, normal):
    """One generated view of Zero123++ v1.2: the normal-norm matte -> an
    RGBA cutout, and the normal map renormalised to unit vectors and
    composited by that alpha over 0.5 grey.

    rgb, normal: (H, W, 3) in [0, 1]. Returns (rgba (H, W, 4), normal
    (H, W, 3)) float32 in [0, 1]."""
    rgb = np.asarray(rgb, np.float32)
    normal = np.asarray(normal, np.float64)
    alpha = zero123plus_matte_alpha(rgb, normal)
    rgba = np.concatenate([rgb, alpha[..., None]], axis=-1)
    nvec = normal * 2 - 1
    nvec = nvec / (np.linalg.norm(nvec, axis=-1, keepdims=True) + 1e-8)
    n01 = nvec * 0.5 + 0.5
    n_out = n01 * alpha[..., None] + 0.5 * (1 - alpha[..., None])
    return rgba.astype(np.float32), np.clip(n_out, 0, 1).astype(np.float32)


def do_segmentation(images, segment_fn, refine_fn=None, bg_color=None,
                    color_threshold=0.25, erosion=0):
    """The foreground masks of `images` (N, H, W, 3) in [0, 1], a tensor
    or numpy (then on the CPU): `segment_fn` (the images as a tensor ->
    (N, H, W[, 1]) masks) -> pixels away from `bg_color` by
    more than `color_threshold` in some channel forced foreground -> per
    image, the box of its mask > 0.5 handed to `refine_fn(image_uint8
    (H, W, 3), bbox (4,) xyxy) -> (H, W) mask` (an empty mask is kept)
    and that mask eroded by a (2 erosion + 1)^2 square, edges padded ->
    the background-colour override again. Returns (N, H, W, 1) float32
    where `segment_fn`'s masks were."""
    if torch.is_tensor(images):
        ims_t = images.float()
        images = ims_t.detach().cpu().numpy()
    else:
        images = np.asarray(images, np.float32)
        ims_t = torch.as_tensor(images)
    masks_t = segment_fn(ims_t)
    dev = masks_t.device
    masks = np.array(masks_t.float().cpu().numpy(), np.float32)
    if masks.ndim == 3:
        masks = masks[..., None]
    if bg_color is not None:
        bg = np.asarray(bg_color, np.float32)
        non_fg = np.all((images >= bg - color_threshold)
                        & (images <= bg + color_threshold), axis=-1)
        masks[~non_fg] = 1.0
    if refine_fn is not None:
        out = []
        for img, m in zip(images, masks):
            mb = m[..., 0] > 0.5
            xs = np.flatnonzero(mb.any(axis=0))
            ys = np.flatnonzero(mb.any(axis=1))
            if len(xs) == 0 or len(ys) == 0:
                out.append(m)          # an empty mask: nothing to prompt
                continue
            bbox = np.array([xs[0], ys[0], xs[-1] + 1, ys[-1] + 1])
            refined = np.asarray(
                refine_fn((img * 255).astype(np.uint8), bbox), np.float32)
            if erosion > 0:
                k = erosion
                pad = np.pad(refined > 0.5, k, mode="edge")
                er = np.ones_like(refined, bool)
                for dy in range(-k, k + 1):
                    for dx in range(-k, k + 1):
                        er &= pad[k + dy: k + dy + refined.shape[0],
                                  k + dx: k + dx + refined.shape[1]]
                refined = er.astype(np.float32)
            out.append(refined[..., None])
        masks = np.stack(out)
        if bg_color is not None:
            masks[~non_fg] = 1.0
    return torch.as_tensor(masks, device=dev)
