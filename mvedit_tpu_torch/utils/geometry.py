"""Ray generation and depth / normal utilities (counterpart of
`mvedit_tpu/utils/geometry.py`).

Pixel-centre ray directions from [fx, fy, cx, cy] intrinsics (OpenCV
camera: x right, y down, z forward), world rays from (*, 3, 4) c2w poses,
finite-difference normal maps from inverse depth, and the ControlNet depth
normalisation.
"""
import torch

from ..ops.clip import clip

__all__ = ["get_ray_directions", "get_rays", "get_cam_rays",
           "depth_to_normal", "normalize_depth"]


def _normalize(v, eps=1e-12):
    return v * torch.reciprocal(torch.sqrt(clip((v * v).sum(-1, keepdim=True),
                                                eps)))


def get_ray_directions(h, w, intrinsics, norm=False):
    """intrinsics: (*, 4) [fx, fy, cx, cy] -> (*, h, w, 3) camera-space
    directions through the pixel centres (i + 0.5, j + 0.5)."""
    batch = intrinsics.shape[:-1]
    dev, dt = intrinsics.device, intrinsics.dtype
    x = torch.arange(w, device=dev, dtype=dt) + 0.5
    y = torch.arange(h, device=dev, dtype=dt) + 0.5
    dx = (x - intrinsics[..., 2:3]) / intrinsics[..., 0:1]    # (*, w)
    dy = (y - intrinsics[..., 3:4]) / intrinsics[..., 1:2]    # (*, h)
    dx = dx[..., None, :].expand(*batch, h, w)
    dy = dy[..., :, None].expand(*batch, h, w)
    dirs = torch.stack([dx, dy, torch.ones_like(dx)], -1)
    return _normalize(dirs) if norm else dirs


def get_rays(directions, c2w, norm=False):
    """directions: (*, h, w, 3); c2w: (*, 3, 4) -> (rays_o, rays_d)."""
    rot = c2w[..., None, None, :3, :3]                        # (*, 1, 1, 3, 3)
    rays_d = (rot * directions[..., None, :]).sum(-1)
    rays_o = c2w[..., None, None, :3, 3].expand(rays_d.shape)
    if norm:
        rays_d = _normalize(rays_d)
    return rays_o, rays_d


def get_cam_rays(c2w, intrinsics, h, w):
    """World rays (rays_o, rays_d) (*, h, w, 3) through the pixel centres
    of c2w (*, 3, 4) and [fx, fy, cx, cy] `intrinsics` (*, 4), the
    directions normalised."""
    return get_rays(get_ray_directions(h, w, intrinsics), c2w, norm=True)


def _pad_edge(x, dim, before):
    """Repeat the first (`before`) or last slice of `dim` once."""
    edge = x.narrow(dim, 0 if before else x.shape[dim] - 1, 1)
    return torch.cat([edge, x] if before else [x, edge], dim)


def depth_to_normal(depth, directions, format="opengl"):
    """depth: (*, h, w) inverse depth (1/z); directions: unnormalised
    OpenCV camera-space ray directions (*, h, w, 3). Returns (*, h, w, 3)
    normals in [0, 1]."""
    xyz = directions / clip(depth[..., None], 1e-6)
    dx = xyz[..., :, 1:, :] - xyz[..., :, :-1, :]
    dy = xyz[..., 1:, :, :] - xyz[..., :-1, :, :]
    right = _pad_edge(dx, -2, False)
    left = _pad_edge(-dx, -2, True)
    up = _pad_edge(-dy, -3, True)
    down = _pad_edge(dy, -3, False)
    cross = torch.linalg.cross
    n = (_normalize(cross(right, up)) + _normalize(cross(up, left))
         + _normalize(cross(left, down)) + _normalize(cross(down, right)))
    n = _normalize(n)
    if format == "opengl":
        n = n * torch.tensor([1.0, -1.0, -1.0], dtype=n.dtype, device=n.device)
    elif format != "opencv":
        raise ValueError("format should be opengl or opencv")
    return n / 2 + 0.5


def normalize_depth(depths, alphas, far_depth=0.25, alpha_clip=0.5, eps=1e-5):
    """(N, H, W) depths + (N, H, W, 1) alphas -> [0, 1] depth maps for the
    depth ControlNet (ref geometry_utils.py:151-168)."""
    a = alphas[..., 0]
    n = depths.shape[0]
    depths_max = depths.reshape(n, -1).amax(1)[:, None, None]
    depths_fg = depths / a.clamp(min=eps)
    masked = torch.where(a < alpha_clip, torch.full_like(depths_fg, 1.0 / eps),
                         depths_fg)
    fg_min = masked.reshape(n, -1).amin(1)[:, None, None]
    depths_fg = (depths_fg - fg_min) / (depths_max - fg_min).clamp(min=eps)
    depths_fg = depths_fg * (1 - far_depth) + far_depth
    return (depths_fg * a).clamp(0.0, 1.0)
