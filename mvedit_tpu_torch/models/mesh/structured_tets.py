"""Structured marching tetrahedra: closed-form topology on the implicit
6-tets-per-cube lattice (counterpart of
`mvedit_tpu/models/mesh/structured_tets.py`).

Every cube of the (g+1)^3 lattice splits into the same 6 tets around its
main diagonal, so the topology is index arithmetic: corner occupancies are
8 slices of the occupancy volume, the edge set is 7 dense classes (3 axis,
3 face-diagonal, 1 body-diagonal) whose crossing masks are slice XORs, and
an edge id maps to (class, anchor) by div/mod. The outputs keep the
reference's static-capacity buffers (`vert_cap`, `face_cap`) and their
overflow semantics: crossings past a cap are dropped and faces that
reference them are masked out.

`marching_tets_topology` is the integer half (from the sign of sdf);
`marching_tets_verts` the differentiable sdf-lerp along the frozen edges.
A fit can refresh the topology less often than the geometry.
"""
from dataclasses import dataclass

import numpy as np
import torch

from ...ops.clip import clip
from ...ops.segment import gather_rows
from .dmtet import BASE_TET_EDGES, NUM_TRIANGLES_TABLE, TRIANGLE_TABLE

__all__ = ["StructuredTetGrid", "marching_tets_structured",
           "marching_tets_topology", "marching_tets_verts"]

# 6-tet decomposition of the unit cube around diagonal 0-7 (corner n has
# coords (n&1, n>>1&1, n>>2&1))
TET_CORNERS = np.array([
    [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
    [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], np.int32)

# edge classes: direction vectors (the order defines the edge-id layout)
EDGE_DIRS = np.array([
    [1, 0, 0], [0, 1, 0], [0, 0, 1],
    [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.int32)


def _corner_bits(n):
    return np.array([n & 1, (n >> 1) & 1, (n >> 2) & 1], np.int32)


def _build_edge_tables():
    """(6, 6) class ids + (6, 6, 3) anchor offsets for (pattern, local
    edge) -> global edge."""
    cls = np.zeros((6, 6), np.int32)
    off = np.zeros((6, 6, 3), np.int32)
    dir_lut = {tuple(d): i for i, d in enumerate(EDGE_DIRS)}
    for p in range(6):
        for l in range(6):
            a, b = TET_CORNERS[p][BASE_TET_EDGES[l]]
            ba, bb = _corner_bits(a), _corner_bits(b)
            cls[p, l] = dir_lut[tuple(np.abs(bb - ba))]
            off[p, l] = np.minimum(ba, bb)
    return cls, off


EDGE_CLASS, EDGE_OFFSET = _build_edge_tables()


@dataclass(frozen=True, eq=False)
class StructuredTetGrid:
    """Implicit 6-tets-per-cube grid on the [-1, 1]^3 lattice. sdf and
    deform live on all (g+1)^3 lattice vertices; `crop_sphere` keeps the
    reference grids' sphere support as a per-cell mask."""
    resolution: int
    radius: float = 1.0
    crop_sphere: bool = True

    @property
    def g(self):
        return self.resolution

    @property
    def num_verts(self):
        return (self.g + 1) ** 3

    @property
    def verts(self):
        """(V, 3) float32 lattice rest positions (numpy)."""
        if not hasattr(self, "_verts"):
            xs = np.linspace(-1.0, 1.0, self.g + 1, dtype=np.float32)
            vv = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)
            object.__setattr__(self, "_verts", vv.reshape(-1, 3))
        return self._verts

    def _np_cell_mask(self):
        xs = np.linspace(-1.0, 1.0, self.g + 1, dtype=np.float32)
        c = (xs[:-1] + xs[1:]) * 0.5
        cc = np.stack(np.meshgrid(c, c, c, indexing="ij"), axis=-1)
        return np.linalg.norm(cc, axis=-1) <= self.radius

    def arrays(self, device=None):
        """{"cell_mask": (g, g, g) bool tensor} on `device` (cached)."""
        cache = self.__dict__.setdefault("_arrays", {})
        key = str(torch.device(device) if device is not None else "cpu")
        if key not in cache:
            mask = (self._np_cell_mask() if self.crop_sphere
                    else np.ones((self.g,) * 3, bool))
            cache[key] = {"cell_mask": torch.from_numpy(mask).to(key)}
        return cache[key]

    def class_dims(self):
        g = self.g
        return [(g + 1 - d[0], g + 1 - d[1], g + 1 - d[2]) for d in EDGE_DIRS]

    def class_bases(self):
        sizes = [d[0] * d[1] * d[2] for d in self.class_dims()]
        return np.concatenate([[0], np.cumsum(sizes)])   # (8,), [7] == E


def _pad_or(m, ax):
    """Edges along the axes other than `ax` are shared by the two cells
    that meet at them across `ax`: OR of the mask and its shift, one longer
    along `ax`."""
    shape = list(m.shape)
    shape[ax] = 1
    z = torch.zeros(shape, dtype=m.dtype, device=m.device)
    return torch.cat([z, m], ax) | torch.cat([m, z], ax)


@torch.no_grad()
def marching_tets_topology(grid: StructuredTetGrid, ga, sdf,
                           vert_cap=65536, face_cap=131072):
    """Integer half of the extraction, from the sign of `sdf`.

    Returns {id_a, id_b (vert_cap,) lattice-vertex ids (int64), vert_mask,
    faces (face_cap, 3) int64, face_mask, n_verts, n_faces} (counts as
    0-dim tensors)."""
    g = grid.resolution
    V1 = g + 1
    dev = sdf.device
    occ3d = (sdf > 0).reshape(V1, V1, V1)
    dims = grid.class_dims()
    bases = grid.class_bases()
    E = int(bases[-1])
    cell_mask = ga["cell_mask"].to(dev)

    # crossing edges: slice XOR per class; an edge yields a vertex only if
    # it borders an active cell
    cross = []
    for d in EDGE_DIRS:
        dx, dy, dz = (int(x) for x in d)
        m = cell_mask
        for ax in range(3):
            if d[ax] == 0:
                m = _pad_or(m, ax)
        o0 = occ3d[:V1 - dx, :V1 - dy, :V1 - dz]
        o1 = occ3d[dx:, dy:, dz:]
        cross.append(((o0 ^ o1) & m).reshape(-1))
    crossing = torch.cat(cross)                                # (E,)
    csum = torch.cumsum(crossing.long(), 0)
    n_verts = csum[-1]
    vslot = csum - 1
    in_cap = crossing & (vslot < vert_cap)
    emap = torch.where(in_cap, vslot, torch.full_like(vslot, vert_cap))

    ar = torch.arange(vert_cap, device=dev)
    slot_edge = torch.searchsorted(csum, ar + 1, right=False).clamp(0, E - 1)
    slot_valid = ar < torch.clamp(n_verts, max=vert_cap)

    # edge id -> (class, anchor coords) by div/mod
    dims_np = np.asarray(dims, np.int64)
    bases_t = torch.as_tensor(bases, dtype=torch.long, device=dev)
    sy_tab = torch.as_tensor(dims_np[:, 1] * dims_np[:, 2], device=dev)
    sz_tab = torch.as_tensor(dims_np[:, 2], device=dev)
    dir_tab = torch.as_tensor(EDGE_DIRS, dtype=torch.long, device=dev)
    cls = torch.searchsorted(bases_t[1:8].contiguous(), slot_edge, right=True)
    local = slot_edge - bases_t[:7][cls]
    sy, sz = sy_tab[cls], sz_tab[cls]
    ax_ = local // sy
    rem = local % sy
    ay_ = rem // sz
    az_ = rem % sz
    dvec = dir_tab[cls]
    id_a = (ax_ * V1 + ay_) * V1 + az_
    id_b = ((ax_ + dvec[:, 0]) * V1 + ay_ + dvec[:, 1]) * V1 + az_ + dvec[:, 2]

    # faces: per-pattern tet indices from the corner slices
    occ_i = occ3d.long()
    oc = [occ_i[b[0]:b[0] + g, b[1]:b[1] + g, b[2]:b[2] + g]
          for b in (_corner_bits(n) for n in range(8))]
    tri_flat_tab = torch.as_tensor(TRIANGLE_TABLE.reshape(-1),
                                   dtype=torch.long, device=dev)
    ntr_tab = torch.as_tensor(NUM_TRIANGLES_TABLE, dtype=torch.long,
                              device=dev)
    tetind_list, ntri_list = [], []
    for p in range(6):
        c0, c1, c2, c3 = (oc[n] for n in TET_CORNERS[p])
        ti = c0 + 2 * c1 + 4 * c2 + 8 * c3
        nt = torch.where(cell_mask, ntr_tab[ti], torch.zeros_like(ti))
        tetind_list.append(ti.reshape(-1))
        ntri_list.append(nt.reshape(-1))
    tetind_flat = torch.cat(tetind_list)                      # (6 g^3,)
    ntri_flat = torch.cat(ntri_list)
    fcsum = torch.cumsum(ntri_flat, 0)
    n_faces = fcsum[-1]
    n_tets = ntri_flat.shape[0]

    f_ids = torch.arange(face_cap, device=dev)
    t_of_f = torch.searchsorted(fcsum, f_ids + 1, right=False).clamp(
        0, n_tets - 1)
    first_slot = fcsum[t_of_f] - ntri_flat[t_of_f]
    r_of_f = f_ids - first_slot                               # 0 or 1
    face_valid = f_ids < n_faces

    g3 = g * g * g
    pattern_f = t_of_f // g3
    cell_f = t_of_f % g3
    cx = cell_f // (g * g)
    cy = (cell_f // g) % g
    cz = cell_f % g
    tetind_f = tetind_flat[t_of_f]

    ecls_tab = torch.as_tensor(EDGE_CLASS, dtype=torch.long, device=dev)
    eoff_tab = torch.as_tensor(EDGE_OFFSET, dtype=torch.long, device=dev)
    vids = []
    for j in range(3):
        # slots past n_faces index past the table; the reference's gathers
        # clamp there, and those faces are masked out below
        l = tri_flat_tab[(tetind_f * 6 + 3 * r_of_f + j).clamp(
            0, tri_flat_tab.shape[0] - 1)].clamp(0, 5)
        c = ecls_tab[pattern_f, l]
        o = eoff_tab[pattern_f, l]
        eid = (bases_t[c] + (cx + o[:, 0]) * sy_tab[c]
               + (cy + o[:, 1]) * sz_tab[c] + cz + o[:, 2])
        vids.append(emap[eid.clamp(0, E - 1)])
    v0, v1, v2 = vids
    face_ok = face_valid & (v0 < vert_cap) & (v1 < vert_cap) \
        & (v2 < vert_cap)
    zero = torch.zeros_like(v0)
    faces = torch.stack([torch.where(face_ok, v, zero) for v in vids], -1)
    return {"id_a": id_a, "id_b": id_b, "vert_mask": slot_valid,
            "faces": faces, "face_mask": face_ok,
            "n_verts": n_verts, "n_faces": n_faces}


def marching_tets_verts(grid: StructuredTetGrid, topo, sdf, deform=None):
    """Differentiable half: crossing-vertex positions by sdf-lerp along the
    (frozen) edges of `topo`; gradients flow to sdf and deform. The clip
    keeps verts on their edge if a sign flipped after the snapshot.
    Returns (vert_cap, 3)."""
    g = grid.resolution
    V1 = g + 1
    id_a, id_b = topo["id_a"], topo["id_b"]
    s_a, s_b = gather_rows(sdf, id_a), gather_rows(sdf, id_b)
    denom = s_a - s_b
    eps = torch.where(denom >= 0, torch.full_like(denom, 1e-10),
                      torch.full_like(denom, -1e-10))
    denom = torch.where(denom.abs() < 1e-10, eps, denom)
    w_a = clip(-s_b / denom, 0.0, 1.0)
    scale = 2.0 / g

    def unflat(i):
        return torch.stack([i // (V1 * V1), (i // V1) % V1, i % V1], -1)

    pos_a = unflat(id_a).to(sdf.dtype) * scale - 1.0
    pos_b = unflat(id_b).to(sdf.dtype) * scale - 1.0
    if deform is not None:
        pos_a = pos_a + gather_rows(deform, id_a)
        pos_b = pos_b + gather_rows(deform, id_b)
    verts = pos_a * w_a[:, None] + pos_b * (1.0 - w_a)[:, None]
    return torch.where(topo["vert_mask"][:, None], verts,
                       torch.zeros((), dtype=verts.dtype, device=verts.device))


def marching_tets_structured(grid: StructuredTetGrid, ga, sdf, deform=None,
                             vert_cap=65536, face_cap=131072):
    """Isosurface of `sdf` (positive inside): verts (vert_cap, 3),
    vert_mask, faces (face_cap, 3), face_mask, n_verts, n_faces."""
    topo = marching_tets_topology(grid, ga, sdf, vert_cap=vert_cap,
                                  face_cap=face_cap)
    return {"verts": marching_tets_verts(grid, topo, sdf, deform=deform),
            "vert_mask": topo["vert_mask"], "faces": topo["faces"],
            "face_mask": topo["face_mask"], "n_verts": topo["n_verts"],
            "n_faces": topo["n_faces"]}
