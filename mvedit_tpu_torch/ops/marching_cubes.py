"""Marching cubes through marching tetrahedra (counterpart of
`mvedit_tpu/ops/marching_cubes.py`).

Each lattice cube splits into 6 tets (`build_grid_tets(crop_sphere=False)`,
kept in an `lru_cache` by resolution) and `marching_tets` extracts the
isosurface with the DMTet tables: fixed-shape tensor work on the field's
device, differentiable w.r.t. the field, vertices welded through the
grid's unique edges. `extract_geometry` evaluates a density function on
the lattice in chunks on its device, then compacts the mesh on the host.
"""
from functools import lru_cache

import numpy as np
import torch

from ..models.mesh.dmtet import build_grid_tets, marching_tets

__all__ = ["marching_cubes", "extract_geometry"]


@lru_cache(maxsize=4)
def _grid_for(resolution):
    return build_grid_tets(resolution, crop_sphere=False)


def marching_cubes(field, iso=0.0, bound=1.0):
    """field: (R+1, R+1, R+1) samples on the lattice over [-bound, bound]^3.
    Returns (verts (E, 3), faces (2T, 3), vert_mask (E,), face_mask (2T,)),
    fixed shapes; positive (field - iso) is inside."""
    grid = _grid_for(field.shape[0] - 1)
    out = marching_tets(grid, field.reshape(-1) - iso)
    return out["verts"] * bound, out["faces"], out["vert_mask"], \
        out["face_mask"]


@torch.no_grad()
def extract_geometry(density_fn, resolution=128, threshold=10.0, bound=1.0,
                     chunk=262144, device="cuda"):
    """A density field -> a compact numpy mesh (verts (V, 3) float32,
    faces (F, 3) int32): density_fn((n, 3) points on `device`) -> (n,)
    evaluated on the (resolution + 1)^3 lattice in chunks of `chunk`
    points, marched at `threshold`, unused vertices dropped on the host."""
    xs = np.linspace(-bound, bound, resolution + 1, dtype=np.float32)
    pts = torch.from_numpy(np.stack(np.meshgrid(xs, xs, xs, indexing="ij"),
                                    -1).reshape(-1, 3)).to(device)
    field = torch.cat([density_fn(pts[i:i + chunk]).reshape(-1).float()
                       for i in range(0, pts.shape[0], chunk)])
    n = resolution + 1
    verts, faces, _, fmask = marching_cubes(field.reshape(n, n, n),
                                            iso=threshold, bound=bound)
    verts = verts.cpu().numpy()
    faces = faces[fmask].cpu().numpy()
    used = np.unique(faces)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces].astype(np.int32)
