"""TSDF RGB-D fusion into a coloured mesh (counterpart of
`mvedit_tpu/models/mesh/tsdf.py`, the reference's Open3D
`tsdf_rgbd_to_mesh`).

- `tsdf_integrate` runs on the views' device: a loop over the views, each
  projecting every voxel centre of a dense (G, G, G) grid, reading the
  nearest pixel's depth and colour, and folding the truncated SDF into
  running sums. At G 256 the five accumulator channels take ~350 MB, so a
  view is projected as one whole-grid slab unless `z_chunk` asks for
  thinner ones. The projection keeps the reference's order of operations
  (p @ R^T + t, then fx * x / z + cx, rounded half to even).
- `tsdf_to_mesh` is the reference's host pass in numpy: narrow-band
  marching tets over the cubes whose 8 corners are all observed and mix
  signs, scipy connected components to prune clusters of fewer than
  `prune_thr` faces, QEM decimation through the port's `native` library
  when it is available (an error in it raises: the reference swallows
  every exception there), colours carried to the decimated vertices by
  `cKDTree`.
- `tsdf_rgbd_to_mesh` chains the two.
"""
import numpy as np
import torch

from ...native import decimate_qem, native_available
from .container import Mesh
from .dmtet import BASE_TET_EDGES, TRIANGLE_TABLE

__all__ = ["tsdf_integrate", "tsdf_to_mesh", "tsdf_rgbd_to_mesh"]

# cube corners (dx, dy, dz) and the 6-tet split around the diagonal 0-7
# (the split of `build_grid_tets`)
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.int64)
_TET_CORNER = np.array([
    [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
    [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], np.int64)


@torch.no_grad()
def tsdf_integrate(rgbs, depths, w2cs, intrinsics, bound=1.0,
                   resolution=256, sdf_trunc=None, depth_trunc=10.0,
                   z_chunk=None):
    """Fuse RGB-D views into a dense TSDF grid on their device.

    rgbs (N, H, W, 3) in [0, 1]; depths (N, H, W) camera-space z (0 = no
    reading); w2cs (N, 3 or 4, 4) world-to-camera (OpenCV); intrinsics
    (N, 4) fx fy cx cy. The grid spans [-bound, bound]^3 at G =
    `resolution` voxels a side; sdf_trunc defaults to 2 * bound * 0.02;
    depth readings beyond `depth_trunc` are ignored; `z_chunk` voxel
    layers are projected at a time (default: the whole grid).

    Returns {"tsdf" (G, G, G): +outside / -inside, 1 where unobserved,
    "weight" (G, G, G), "color" (G, G, G, 3)}.
    """
    G = resolution
    dev = depths.device
    if sdf_trunc is None:
        sdf_trunc = 2.0 * bound * 0.02
    n, h, w = depths.shape
    zc_ = z_chunk or G
    xs = (torch.arange(G, device=dev, dtype=torch.float32) + 0.5) / G \
        * (2.0 * bound) - bound
    depths = depths.float()
    rgbs = rgbs.float()
    w2cs = w2cs.float()[:, :3]
    intrinsics = intrinsics.float()
    tsdf_w = torch.zeros((G, G, G), device=dev)
    col_w = torch.zeros((G, G, G, 3), device=dev)
    wsum = torch.zeros((G, G, G), device=dev)
    for i in range(n):
        R, t, intr = w2cs[i, :, :3], w2cs[i, :, 3], intrinsics[i]
        for z0 in range(0, G, zc_):
            zs = xs[z0:z0 + zc_]
            gx, gy, gz = torch.meshgrid(xs, xs, zs, indexing="ij")
            p = torch.stack([gx, gy, gz], -1).reshape(-1, 3)
            cam = p @ R.T + t
            zc = cam[:, 2]
            zsafe = torch.clamp(zc, min=1e-6)
            u = intr[0] * cam[:, 0] / zsafe + intr[2]
            v = intr[1] * cam[:, 1] / zsafe + intr[3]
            # clamped into int32's range before the cast (an off-screen
            # voxel near z = 0 projects arbitrarily far)
            ui = torch.round(u).clamp(-2 ** 30, 2 ** 30).to(torch.int32)
            vi = torch.round(v).clamp(-2 ** 30, 2 ** 30).to(torch.int32)
            inb = (zc > 1e-6) & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
            pix = vi.clamp(0, h - 1).long() * w + ui.clamp(0, w - 1).long()
            d = depths[i].reshape(-1)[pix]
            c = rgbs[i].reshape(-1, 3)[pix]
            sdf = d - zc
            obs = inb & (d > 1e-6) & (d < depth_trunc) & (sdf > -sdf_trunc)
            wt = obs.float()
            shape = (G, G, zs.shape[0])
            tsdf_w[:, :, z0:z0 + zc_] += (
                torch.clamp(sdf / sdf_trunc, max=1.0) * wt).reshape(shape)
            col_w[:, :, z0:z0 + zc_] += (c * wt[:, None]).reshape(*shape, 3)
            wsum[:, :, z0:z0 + zc_] += wt.reshape(shape)
    wc = torch.clamp(wsum, min=1e-8)
    return {"tsdf": torch.where(wsum > 0, tsdf_w / wc, 1.0),
            "weight": wsum, "color": col_w / wc[..., None]}


def _empty_mesh():
    return Mesh(v=np.zeros((0, 3), np.float32), f=np.zeros((0, 3), np.int32))


def tsdf_to_mesh(tsdf, weight, color, bound=1.0, prune_thr=800,
                 mesh_reduction=0.2):
    """The fused grid (numpy or tensors) -> a pruned, decimated, vertex-
    coloured `Mesh`, on the host."""
    tsdf, weight, color = (x.cpu().numpy() if torch.is_tensor(x)
                           else np.asarray(x) for x in (tsdf, weight, color))
    G = tsdf.shape[0]
    occ = tsdf > 0

    def corner(a, dx, dy, dz):
        return a[dx:G - 1 + dx, dy:G - 1 + dy, dz:G - 1 + dz]

    # the narrow band: all 8 corners observed, mixed signs
    obs_all = np.ones((G - 1,) * 3, bool)
    pos_any = np.zeros((G - 1,) * 3, bool)
    neg_any = np.zeros((G - 1,) * 3, bool)
    for dx, dy, dz in _CORNERS:
        obs_all &= corner(weight, dx, dy, dz) > 0
        o = corner(occ, dx, dy, dz)
        pos_any |= o
        neg_any |= ~o
    sel = np.argwhere(obs_all & pos_any & neg_any)          # (S, 3)
    if len(sel) == 0:
        return _empty_mesh()

    cid = (sel[:, None, 0] + _CORNERS[None, :, 0]) * G * G \
        + (sel[:, None, 1] + _CORNERS[None, :, 1]) * G \
        + (sel[:, None, 2] + _CORNERS[None, :, 2])          # (S, 8)
    sval = tsdf.reshape(-1)[cid]
    t_cid = cid[:, _TET_CORNER].reshape(-1, 4)              # (S * 6, 4)
    t_val = sval[:, _TET_CORNER].reshape(-1, 4)
    case = (t_val > 0).astype(np.int64) @ np.array([1, 2, 4, 8])
    tris = TRIANGLE_TABLE[case]                             # (S * 6, 6)
    e_a = t_cid[:, BASE_TET_EDGES[:, 0]]
    e_b = t_cid[:, BASE_TET_EDGES[:, 1]]
    ekey = np.minimum(e_a, e_b).astype(np.int64) * (G ** 3) \
        + np.maximum(e_a, e_b)
    fmask = tris >= 0
    fkeys = np.take_along_axis(ekey, np.where(fmask, tris, 0), axis=1)
    fkeys = fkeys.reshape(-1, 3)[fmask.reshape(-1, 3).all(axis=1)]
    if len(fkeys) == 0:
        return _empty_mesh()
    uniq, faces = np.unique(fkeys.reshape(-1), return_inverse=True)
    # the tables wind faces outward for a positive-outside field, the
    # TSDF's sign
    faces = faces.reshape(-1, 3).astype(np.int32)

    ua = (uniq // (G ** 3)).astype(np.int64)
    ub = (uniq % (G ** 3)).astype(np.int64)
    sa, sb = tsdf.reshape(-1)[ua], tsdf.reshape(-1)[ub]
    denom = sa - sb
    denom = np.where(np.abs(denom) < 1e-10, 1e-10, denom)
    wa = np.clip(sa / denom, 0.0, 1.0)                      # weight of b

    def grid_pos(i):
        xyz = np.stack([i // (G * G), (i // G) % G, i % G], -1)
        return ((xyz + 0.5) / G * (2.0 * bound) - bound).astype(np.float32)

    pa, pb = grid_pos(ua), grid_pos(ub)
    verts = pa * (1 - wa[:, None]) + pb * wa[:, None]
    cgrid = color.reshape(-1, 3)
    vc = (cgrid[ua] * (1 - wa[:, None]) + cgrid[ub] * wa[:, None]).astype(
        np.float32)

    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    faces = faces[good]

    if prune_thr > 0 and len(faces):
        import scipy.sparse as sp
        from scipy.sparse.csgraph import connected_components
        V = len(verts)
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]])
        adj = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                            shape=(V, V))
        _, comp = connected_components(adj, directed=False)
        fcomp = comp[faces[:, 0]]
        counts = np.bincount(fcomp, minlength=comp.max() + 1)
        faces = faces[counts[fcomp] >= prune_thr]

    used = np.unique(faces)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    verts, vc = verts[used], vc[used]
    faces = remap[faces].astype(np.int32)

    if 0 < mesh_reduction < 1 and len(faces) > 16 and native_available():
        from scipy.spatial import cKDTree
        verts2, faces2 = decimate_qem(
            verts, faces, int(round(len(faces) * mesh_reduction)))
        vc = vc[cKDTree(verts).query(verts2)[1]]
        verts, faces = verts2.astype(np.float32), faces2.astype(np.int32)

    mesh = Mesh(v=verts.astype(np.float32), f=faces,
                vc=np.clip(vc, 0.0, 1.0))
    if len(faces):
        mesh.auto_normal()
    return mesh


def tsdf_rgbd_to_mesh(rgbs, depths, poses, intrinsics, bound=1.0,
                      voxel_resolution=256, prune_thr=800,
                      mesh_reduction=0.2, depth_trunc=10.0, device=None):
    """Fuse RGB-D views and extract the mesh (the reference's signature).
    `poses` are (N, 4, 4) camera-to-world, inverted here in float32 on the
    host as the reference does. The integration runs on `device`, by
    default the depths' device when they are a tensor, else the card."""
    poses = (poses.cpu().numpy() if torch.is_tensor(poses)
             else np.asarray(poses)).astype(np.float32)
    if device is None:
        device = depths.device if torch.is_tensor(depths) else "cuda"

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    out = tsdf_integrate(t(rgbs), t(depths), t(np.linalg.inv(poses)),
                         t(intrinsics), bound=bound,
                         resolution=voxel_resolution,
                         depth_trunc=depth_trunc)
    return tsdf_to_mesh(out["tsdf"], out["weight"], out["color"],
                        bound=bound, prune_thr=prune_thr,
                        mesh_reduction=mesh_reduction)
