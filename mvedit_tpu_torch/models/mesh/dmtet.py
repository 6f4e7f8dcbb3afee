"""Marching tetrahedra on an unstructured tet grid (counterpart of
`mvedit_tpu/models/mesh/dmtet.py`).

A `TetGrid` holds its topology precomputed on the host once per grid: the
tets, their full unique-edge list and the tet -> edge index map
(`TetGrid.build`), so the extraction is fixed-shape tensor work:

- `marching_tets`: one interpolated vertex per unique edge (masked where
  the edge does not cross), two triangle slots per tet through the
  marching-tets tables, invalid slots collapsed to (0, 0, 0);
- `marching_tets_compact`: the crossing edges and the valid faces packed
  into `vert_cap` / `face_cap` slots in cumsum order, each slot mapped
  back to its edge or face by `searchsorted`, so the order is fixed;
  crossings past a cap are dropped and faces that reference them masked.

Both are differentiable w.r.t. sdf and the vertex deformation; their
gathers sum their gradients in a fixed order (`ops.segment.gather_rows`).

`build_grid_tets` generates the lattice grid (6 tets per cube, cropped to
a sphere) and caches grids of resolution >= 32 in the port's own
directory. The structured grid (`structured_tets.py`, the pipeline's
default) derives its topology from the same tables, which are the
standard public marching-tetrahedra tables (as in nvdiffrec).
"""
import os
from dataclasses import dataclass

import numpy as np
import torch

from ...ops.clip import clip
from ...ops.segment import gather_rows

__all__ = ["TRIANGLE_TABLE", "NUM_TRIANGLES_TABLE", "BASE_TET_EDGES",
           "TetGrid", "build_grid_tets", "marching_tets",
           "marching_tets_compact", "tet_cache_dir"]

TRIANGLE_TABLE = np.array([
    [-1, -1, -1, -1, -1, -1],
    [1, 0, 2, -1, -1, -1],
    [4, 0, 3, -1, -1, -1],
    [1, 4, 2, 1, 3, 4],
    [3, 1, 5, -1, -1, -1],
    [2, 3, 0, 2, 5, 3],
    [1, 4, 0, 1, 5, 4],
    [4, 2, 5, -1, -1, -1],
    [4, 5, 2, -1, -1, -1],
    [4, 1, 0, 4, 5, 1],
    [3, 2, 0, 3, 5, 2],
    [1, 3, 5, -1, -1, -1],
    [4, 1, 2, 4, 3, 1],
    [3, 0, 4, -1, -1, -1],
    [2, 0, 1, -1, -1, -1],
    [-1, -1, -1, -1, -1, -1]], np.int32)

NUM_TRIANGLES_TABLE = np.array(
    [0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0], np.int32)

BASE_TET_EDGES = np.array([0, 1, 0, 2, 0, 3, 1, 2, 1, 3, 2, 3],
                          np.int32).reshape(6, 2)


@dataclass(frozen=True, eq=False)
class TetGrid:
    """A tet grid with its edge topology: verts (V, 3) float32 rest
    positions, tets (T, 4), unique_edges (E, 2) sorted pairs in the order
    of their packed keys, tet_edge_idx (T, 6) -> unique edge id (int32
    numpy)."""
    verts: np.ndarray
    tets: np.ndarray
    unique_edges: np.ndarray
    tet_edge_idx: np.ndarray

    def arrays(self, device=None):
        """The topology as int64 tensors (verts float32) on `device`,
        cached per device."""
        cache = self.__dict__.setdefault("_arrays", {})
        key = str(torch.device(device) if device is not None else "cpu")
        if key not in cache:
            cache[key] = {
                "verts": torch.from_numpy(self.verts).to(key),
                "tets": torch.from_numpy(self.tets).long().to(key),
                "unique_edges": torch.from_numpy(
                    self.unique_edges).long().to(key),
                "tet_edge_idx": torch.from_numpy(
                    self.tet_edge_idx).long().to(key)}
        return cache[key]

    @classmethod
    def build(cls, verts, tets):
        verts = np.asarray(verts, np.float32)
        tets = np.asarray(tets, np.int32)
        edges = tets[:, BASE_TET_EDGES.reshape(-1)].reshape(-1, 2)  # (T*6, 2)
        edges = np.sort(edges, axis=1)
        # one int64 key per sorted pair: a 1-D unique is much faster than
        # a row-wise one
        nv = np.int64(len(verts))
        keys = edges[:, 0].astype(np.int64) * nv + edges[:, 1]
        uniq, inverse = np.unique(keys, return_inverse=True)
        unique = np.stack([uniq // nv, uniq % nv], axis=1)
        return cls(verts=verts, tets=tets,
                   unique_edges=unique.astype(np.int32),
                   tet_edge_idx=inverse.reshape(-1, 6).astype(np.int32))

    @property
    def num_edge_verts(self):
        return self.unique_edges.shape[0]

    @property
    def max_faces(self):
        return self.tets.shape[0] * 2


def tet_cache_dir():
    """`MVEDIT_TORCH_TET_CACHE`, else the package's `_build/tets`."""
    return os.environ.get("MVEDIT_TORCH_TET_CACHE", os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "_build", "tets"))


def build_grid_tets(resolution, radius=1.0, crop_sphere=True,
                    cache_dir=None):
    """The lattice tet grid on [-1, 1]^3: each of the resolution^3 cubes
    split into 6 tets around its main diagonal, with `crop_sphere` only
    the tets whose centre lies within `radius`, the unused vertices
    dropped. Grids of resolution >= 32 are cached as .npz in `cache_dir`
    (default `tet_cache_dir()`), written under a temporary name and
    renamed, so concurrent builders never read a partial file."""
    cache_dir = cache_dir or tet_cache_dir()
    cache_path = None
    if cache_dir and resolution >= 32:
        tag = f"tets_{resolution}_{radius:g}_{int(crop_sphere)}.npz"
        cache_path = os.path.join(cache_dir, tag)
        if os.path.exists(cache_path):
            try:
                with np.load(cache_path) as d:
                    return TetGrid(verts=d["verts"], tets=d["tets"],
                                   unique_edges=d["unique_edges"],
                                   tet_edge_idx=d["tet_edge_idx"])
            except Exception:
                pass  # a corrupt cache: rebuild
    g = resolution
    xs = np.linspace(-1.0, 1.0, g + 1, dtype=np.float32)
    vv = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)
    verts = vv.reshape(-1, 3)

    def vid(i, j, k):
        return (i * (g + 1) + j) * (g + 1) + k

    i, j, k = np.meshgrid(np.arange(g), np.arange(g), np.arange(g),
                          indexing="ij")
    c = np.stack([vid(i, j, k), vid(i + 1, j, k), vid(i, j + 1, k),
                  vid(i + 1, j + 1, k), vid(i, j, k + 1), vid(i + 1, j, k + 1),
                  vid(i, j + 1, k + 1), vid(i + 1, j + 1, k + 1)],
                 axis=-1).reshape(-1, 8)
    # the 6 tets of a cube around its diagonal 0-7
    tet_corner = np.array([
        [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
        [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], np.int64)
    tets = c[:, tet_corner].reshape(-1, 4)
    if crop_sphere:
        centers = verts[tets].mean(axis=1)
        keep = np.linalg.norm(centers, axis=-1) <= radius
        tets = tets[keep]
        used = np.unique(tets)
        remap = np.full(len(verts), -1, np.int64)
        remap[used] = np.arange(len(used))
        verts = verts[used]
        tets = remap[tets]
    out = TetGrid.build(verts, tets.astype(np.int32))
    if cache_path:
        try:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = f"{cache_path[:-4]}.{os.getpid()}.tmp.npz"
            np.savez(tmp, verts=out.verts, tets=out.tets,
                     unique_edges=out.unique_edges,
                     tet_edge_idx=out.tet_edge_idx)
            os.replace(tmp, cache_path)
        except OSError:
            pass
    return out


def _arrays(grid, device):
    return grid.arrays(device) if isinstance(grid, TetGrid) else grid


def _lerp_weight(s_a, s_b):
    """The weight on vertex a of the zero crossing between sdf values s_a
    and s_b, clipped to [0, 1] so that non-crossing (masked) edges keep
    their junk vertex inside the tet's box."""
    denom = s_a - s_b
    eps = torch.where(denom >= 0, torch.full_like(denom, 1e-10),
                      torch.full_like(denom, -1e-10))
    denom = torch.where(denom.abs() < 1e-10, eps, denom)
    return clip(-s_b / denom, 0.0, 1.0)


def _tet_edge_ids(ga, occ):
    """The six table entries of each tet's two triangles as unique-edge
    ids (6, T) and the tets' triangle counts (T,)."""
    dev = occ.device
    tets, te = ga["tets"], ga["tet_edge_idx"]
    occ_t = occ[tets.t()].long()                               # (4, T)
    tetindex = occ_t[0] + 2 * occ_t[1] + 4 * occ_t[2] + 8 * occ_t[3]
    tri_tab = torch.as_tensor(TRIANGLE_TABLE, dtype=torch.long,
                              device=dev).t()[:, tetindex]    # (6, T)
    ntri = torch.as_tensor(NUM_TRIANGLES_TABLE, dtype=torch.long,
                           device=dev)[tetindex]               # (T,)
    ids = torch.gather(te.t(), 0, tri_tab.clamp(0, 5))         # (6, T)
    return ids, ntri


def marching_tets(grid, sdf, deform=None):
    """The zero isosurface of `sdf` (V,) (positive inside) over a
    `TetGrid` (or its `arrays()` dict), with optional vertex offsets
    `deform` (V, 3). Returns verts (E, 3) (junk where ~vert_mask),
    vert_mask (E,), faces (2T, 3) int64 edge-vertex ids ((0, 0, 0) where
    ~face_mask), face_mask (2T,): the first T slots each tet's first
    triangle, the next T its second."""
    ga = _arrays(grid, sdf.device)
    pos = ga["verts"].to(sdf.dtype)
    if deform is not None:
        pos = pos + deform
    ue0, ue1 = ga["unique_edges"][:, 0], ga["unique_edges"][:, 1]
    occ = sdf > 0
    vert_mask = occ[ue0] != occ[ue1]
    w_a = _lerp_weight(gather_rows(sdf, ue0), gather_rows(sdf, ue1))
    verts = gather_rows(pos, ue0) * w_a[:, None] \
        + gather_rows(pos, ue1) * (1.0 - w_a)[:, None]
    ids, ntri = _tet_edge_ids(ga, occ)
    mask0, mask1 = ntri > 0, ntri > 1
    zero = torch.zeros((), dtype=ids.dtype, device=ids.device)
    faces = torch.cat([torch.where(mask0[None], ids[:3], zero),
                       torch.where(mask1[None], ids[3:], zero)], 1).t()
    return {"verts": verts, "vert_mask": vert_mask,
            "faces": faces.contiguous(),
            "face_mask": torch.cat([mask0, mask1])}


def marching_tets_compact(grid, sdf, deform=None, vert_cap=65536,
                          face_cap=131072):
    """`marching_tets` into fixed-capacity buffers: verts (vert_cap, 3),
    vert_mask, faces (face_cap, 3), face_mask, and the counts n_verts /
    n_faces (0-dim tensors, before the caps). Crossing edges take the
    vertex slots in edge order, valid faces the face slots in the full
    buffer's order; each slot finds its edge or face by a search of the
    running count, so only the kept ones are gathered and interpolated."""
    ga = _arrays(grid, sdf.device)
    dev = sdf.device
    pos = ga["verts"].to(sdf.dtype)
    if deform is not None:
        pos = pos + deform
    ue0, ue1 = ga["unique_edges"][:, 0], ga["unique_edges"][:, 1]
    E = ue0.shape[0]
    occ = sdf > 0
    vert_mask = occ[ue0] != occ[ue1]
    csum = torch.cumsum(vert_mask.long(), 0)
    n_verts = csum[-1]
    vslot = csum - 1
    in_cap = vert_mask & (vslot < vert_cap)
    emap = torch.where(in_cap, vslot, torch.full_like(vslot, vert_cap))

    ar = torch.arange(vert_cap, device=dev)
    slot_edge = torch.searchsorted(csum, ar + 1, right=False).clamp(0, E - 1)
    slot_valid = ar < n_verts
    a, b = ue0[slot_edge], ue1[slot_edge]
    w_a = _lerp_weight(gather_rows(sdf, a), gather_rows(sdf, b))
    verts = gather_rows(pos, a) * w_a[:, None] \
        + gather_rows(pos, b) * (1.0 - w_a)[:, None]
    verts = torch.where(slot_valid[:, None], verts,
                        torch.zeros((), dtype=verts.dtype, device=dev))

    ids, ntri = _tet_edge_ids(ga, occ)
    remap = emap[ids]                                          # (6, T)
    tri0, tri1 = remap[:3], remap[3:]
    mask0 = (ntri > 0) & (tri0 < vert_cap).all(0)
    mask1 = (ntri > 1) & (tri1 < vert_cap).all(0)
    zero = torch.zeros((), dtype=remap.dtype, device=dev)
    faces_t = torch.cat([torch.where(mask0[None], tri0, zero),
                         torch.where(mask1[None], tri1, zero)], 1)  # (3, 2T)
    fmask = torch.cat([mask0, mask1])
    fcsum = torch.cumsum(fmask.long(), 0)
    n_faces = fcsum[-1]
    far = torch.arange(face_cap, device=dev)
    slot_face = torch.searchsorted(fcsum, far + 1, right=False).clamp(
        0, fmask.shape[0] - 1)
    face_valid = far < n_faces
    faces = torch.where(face_valid[None], faces_t[:, slot_face], zero).t()
    return {"verts": verts,
            "vert_mask": ar < torch.clamp(n_verts, max=vert_cap),
            "faces": faces.contiguous(),
            "face_mask": far < torch.clamp(n_faces, max=face_cap),
            "n_verts": n_verts, "n_faces": n_faces}
