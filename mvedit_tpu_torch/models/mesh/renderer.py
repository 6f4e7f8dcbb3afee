"""Mesh renderer: rasterize + shade + bake (counterpart of
`mvedit_tpu/models/mesh/renderer.py`; `camera_weights_uv` waits for the
superres / retex slices).

`render_views` renders the views one after another, so the raster working
set stays at one view (the role of the reference's `sequential=True`).
"""
import torch

from ...ops.clip import clip
from ...ops.segment import gather_rows, segment_add
from .rasterize import RasterConfig, interpolate, project_mesh, rasterize

__all__ = ["vertex_normals", "pose_to_w2c", "render_views",
           "bake_texture"]


def vertex_normals(verts, faces, face_mask=None):
    """Differentiable area-weighted vertex normals: one 3F-row
    `segment_add` of the face normals."""
    faces = faces.long()
    v0, v1, v2 = (gather_rows(verts, faces[:, i]) for i in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    if face_mask is not None:
        fn = fn * face_mask.to(fn.dtype)[:, None]
    # each face's normal to its three corners: an expand, whose backward is
    # a sum (repeat_interleave's is an atomic index_add on the card)
    vn = segment_add(faces.reshape(-1),
                     fn[:, None].expand(-1, 3, -1).reshape(-1, 3),
                     verts.shape[0]).to(verts.dtype)
    # rsqrt(sumsq + eps), not x / clip(norm): a zero normal (a vertex no
    # face references) would NaN the gradient through the norm
    return vn * torch.rsqrt((vn * vn).sum(-1, keepdim=True) + 1e-20)


def pose_to_w2c(pose_c2w):
    """(3, 4) c2w -> (3, 4) w2c (R^T, -R^T t)."""
    r = pose_c2w[:3, :3]
    t = pose_c2w[:3, 3]
    return torch.cat([r.T, (-r.T @ t)[:, None]], 1)


def render_views(verts, faces, face_mask, poses_c2w, intrinsics,
                 cfg: RasterConfig, shading_fun=None, ssaa=1, bg_color=1.0,
                 vert_attrs=None, shading_params=None):
    """Render N views of one triangle soup.

    verts (V, 3) world vertices, faces (F, 3), face_mask (F,) bool,
    poses_c2w (N, 3, 4), intrinsics (N, 4) at the target resolution.
    shading_fun(shading_params, xyz, normal, view_dir) -> rgb, or
    shading_fun(xyz, normal, view_dir) when shading_params is None.
    Returns a dict of (N, H, W, ...) maps: rgb (with shading_fun), xyz,
    normal, depth (N, H, W), alpha, alpha_hard (N, H, W, 1) and the
    interpolated vert_attrs.
    """
    if ssaa > 1:
        cfg_r = RasterConfig(**{**cfg.__dict__, "height": cfg.height * ssaa,
                                "width": cfg.width * ssaa})
        intrinsics = intrinsics * ssaa
    else:
        cfg_r = cfg
    vn = vertex_normals(verts, faces, face_mask.to(verts.dtype))
    packed_attr = torch.cat([verts, vn], 1)

    def one_view(pose, intr):
        pts = project_mesh(verts, pose_to_w2c(pose), intr, cfg_r.near)
        rast = rasterize(pts, faces, face_mask, cfg_r)
        # one packed interpolate for xyz + normal
        packed = interpolate(packed_attr, rast, faces)
        xyz, nrm = packed[..., :3], packed[..., 3:]
        nrm = nrm * torch.rsqrt((nrm * nrm).sum(-1, keepdim=True) + 1e-20)
        out = {"xyz": xyz, "normal": nrm, "depth": rast["z"],
               "alpha": rast["alpha"][..., None],
               "alpha_hard": rast["alpha_hard"][..., None]}
        for k, a in (vert_attrs or {}).items():
            out[k] = interpolate(a, rast, faces)
        if shading_fun is not None:
            view_dir = xyz - pose[:3, 3]
            view_dir = view_dir / clip(torch.linalg.norm(
                view_dir, dim=-1, keepdim=True), 1e-12)
            rgb = shading_fun(shading_params, xyz, nrm, view_dir) \
                if shading_params is not None \
                else shading_fun(xyz, nrm, view_dir)
            a = out["alpha"]
            # NaN verts of a degenerate extraction give NaN shading; select
            # rather than multiply so that NaN * 0 cannot reach the composite
            rgb = torch.where(a > 0, rgb, torch.zeros((), device=rgb.device,
                                                      dtype=rgb.dtype))
            out["rgb"] = rgb * a + bg_color * (1 - a)
        return out

    views = [one_view(poses_c2w[i], intrinsics[i])
             for i in range(poses_c2w.shape[0])]
    out = {k: torch.stack([o[k] for o in views]) for k in views[0]}
    if ssaa > 1:
        def pool(x):
            n, h, w = x.shape[:3]
            c = x.shape[3] if x.dim() == 4 else 1
            y = x.reshape(n, h // ssaa, ssaa, w // ssaa, ssaa, c)
            return y.mean((2, 4)).reshape(n, h // ssaa, w // ssaa,
                                          *x.shape[3:])
        out = {k: pool(v) if v.dim() >= 3 else v for k, v in out.items()}
    return out


@torch.no_grad()
def bake_texture(verts, faces, face_mask, uvs, uv_faces, field_fn,
                 cfg: RasterConfig, field_params=None):
    """Bake `field_fn(field_params, xyz) -> rgb` (or `field_fn(xyz)`) into
    a UV atlas: the mesh is rasterized in UV space (screen position = uv x
    atlas size, z = 1), and each texel's world xyz is the UV triangle's
    barycentric blend of its world verts.

    uvs (Vt, 2) in [0, 1]; uv_faces (F, 3) into uvs, in the order of
    `faces`. Returns (atlas rgb (H, W, 3), mask (H, W) float)."""
    H, W = cfg.height, cfg.width
    pts = torch.stack([uvs[:, 0] * W, uvs[:, 1] * H,
                       torch.ones_like(uvs[:, 0])], -1)
    rast = rasterize(pts, uv_faces, face_mask, cfg)
    f_world = faces.long()[rast["tri_id"].clamp(min=0)]       # (H, W, 3)
    u, v = rast["bary"][..., 0:1], rast["bary"][..., 1:2]
    xyz = (gather_rows(verts, f_world[..., 0]) * (1 - u - v)
           + gather_rows(verts, f_world[..., 1]) * u
           + gather_rows(verts, f_world[..., 2]) * v)
    rgb = field_fn(field_params, xyz) if field_params is not None \
        else field_fn(xyz)
    mask = (rast["tri_id"] >= 0).float()
    # NaN * 0 guard
    rgb = torch.where(mask[..., None] > 0, rgb,
                      torch.zeros((), device=rgb.device, dtype=rgb.dtype))
    return rgb, mask
