"""Mip-mapped texture sampling and multi-view texture baking (counterpart
of `mvedit_tpu/models/mesh/texture.py`).

- `build_mipmaps` / `sample_texture`: trilinear sampling across mip levels,
  the level from the screen-space UV derivatives (`uv_screen_derivatives`,
  finite differences of a per-pixel UV map), as the reference does in
  place of nvdiffrast's attribute derivatives;
- `bake_multiview`: view colours scattered into the UV atlas, weighted by
  per-view weights. Its sums go through `ops/segment.py::segment_add`, so
  that the card adds them in a fixed order.

No path differentiates the texture sampling (`ops/grid_sample.py` would
then take its fixed-order gather path).
"""
import torch

from ...ops.grid_sample import grid_sample_2d
from ...ops.segment import segment_add

__all__ = ["build_mipmaps", "sample_texture", "uv_screen_derivatives",
           "bake_multiview"]


def build_mipmaps(tex, num_levels):
    """tex: (H, W, C) -> list of levels, 2x average-pooled each step."""
    mips = [tex]
    for _ in range(num_levels - 1):
        t = mips[-1]
        h, w = t.shape[:2]
        if min(h, w) < 2:
            break
        mips.append(t.reshape(h // 2, 2, w // 2, 2, -1).mean((1, 3)))
    return mips


def _sample_level(tex, uv):
    """Bilinear sample of one mip level (H, W, C) at uv (..., 2) in [0, 1]
    (border padding, texel centres at (i + 0.5) / size)."""
    g = uv * 2.0 - 1.0
    batch = g.shape[:-1]
    out = grid_sample_2d(tex.movedim(-1, 0)[None], g.reshape(1, 1, -1, 2),
                         padding_mode="border", align_corners=False)
    return out[0, :, 0].T.reshape(*batch, tex.shape[-1])


def sample_texture(mips, uv, uv_dx=None, uv_dy=None):
    """Trilinear mip sampling. uv (..., 2); uv_dx / uv_dy: screen-space UV
    derivatives (..., 2) (None: level 0 only)."""
    base = mips[0]
    h, w = base.shape[:2]
    if uv_dx is None or len(mips) == 1:
        return _sample_level(base, uv)
    # the level from the larger texel footprint
    size = torch.tensor([w, h], dtype=uv.dtype, device=uv.device)
    rho = torch.maximum(torch.linalg.norm(uv_dx * size, dim=-1),
                        torch.linalg.norm(uv_dy * size, dim=-1))
    lod = torch.log2(rho.clamp(min=1e-8)).clamp(0.0, len(mips) - 1.0)
    l0 = torch.floor(lod).long()
    frac = (lod - l0)[..., None]
    l1 = (l0 + 1).clamp(max=len(mips) - 1)
    out0 = torch.zeros((*uv.shape[:-1], base.shape[-1]), dtype=base.dtype,
                       device=base.device)
    out1 = torch.zeros_like(out0)
    for li, mip in enumerate(mips):
        s = _sample_level(mip, uv)
        out0 = torch.where((l0 == li)[..., None], s, out0)
        out1 = torch.where((l1 == li)[..., None], s, out1)
    return out0 * (1 - frac) + out1 * frac


def uv_screen_derivatives(uv_map):
    """Finite-difference d(uv)/d(pixel) of an (H, W, 2) uv map; the last
    column's (row's) difference is 0."""
    dx = torch.diff(uv_map, dim=1, append=uv_map[:, -1:])
    dy = torch.diff(uv_map, dim=0, append=uv_map[-1:])
    return dx, dy


def bake_multiview(images, uv_per_view, weight_per_view, atlas_hw):
    """Back-project N view images onto a UV atlas.

    images (N, H, W, 3) view colours; uv_per_view (N, H, W, 2) per-pixel
    atlas uvs; weight_per_view (N, H, W) blending weights (0 where
    invalid). Returns (atlas (Ha, Wa, 3), weight (Ha, Wa)), un-normalised
    sums: the caller divides and edge-dilates. One 4-channel
    `segment_add` carries both of the reference's scatters."""
    Ha, Wa = atlas_hw
    tx = (uv_per_view[..., 0] * Wa).long().clamp(0, Wa - 1)
    ty = (uv_per_view[..., 1] * Ha).long().clamp(0, Ha - 1)
    w = weight_per_view.reshape(-1, 1).float()
    vals = torch.cat([images.reshape(-1, 3).float() * w, w], 1)
    sums = segment_add((ty * Wa + tx).reshape(-1), vals, Ha * Wa)
    return sums[:, :3].reshape(Ha, Wa, 3), sums[:, 3].reshape(Ha, Wa)
