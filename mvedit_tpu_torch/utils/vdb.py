"""OpenVDB volume export (counterpart of `mvedit_tpu/utils/vdb.py`, host
numpy, the same bytes).

Serializes a dense density volume into a single-grid ``.vdb`` byte blob
(``Tree_float_5_4_3_HalfFloat``, uncompressed, identity transform) that
Blender/Houdini can open: the reference's SSDNeRF GUI "Export volume"
(`lib/core/utils/vdb_utils.py:49`, `lib/core/ssdnerf_gui.py:1058`). The
layout is the OpenVDB file format (magic / grid descriptor / 5-4-3 tree
walk); the construction groups voxels with sorted composite keys and
``np.unique``. Each blob carries a fresh ``uuid.uuid4()``.
"""
import uuid

import numpy as np

__all__ = ["dumps", "save_vdb"]

# node log2 dims of the standard VDB tree: leaf 8^3, internal 16^3, 32^3
_L0, _L1, _L2 = 3, 4, 5


def _lenstr(s: str) -> bytes:
    b = s.encode("ascii")
    return np.uint32(len(b)).tobytes() + b


def _meta(name: str, value: str) -> bytes:
    return _lenstr(name) + _lenstr("string") + _lenstr(value)


def _packed_mask(nbits: int, on_idx) -> bytes:
    m = np.zeros(nbits, np.bool_)
    m[on_idx] = True
    return np.packbits(m, bitorder="little").tobytes()


def _node_header(nbits: int, child_idx) -> bytes:
    """Internal-node record: child mask, (empty) value mask, compression
    tag 6 (no compression, values follow raw), and the inactive-value
    table (all zero, f16 because the grid is saved-as-half-float)."""
    return (_packed_mask(nbits, child_idx)
            + _packed_mask(nbits, [])
            + np.uint8(6).tobytes()
            + np.zeros(nbits, np.uint16).tobytes())


def dumps(density: np.ndarray, sparse_threshold: float = 0.01,
          grid_name: str = "density") -> bytes:
    """Serialize ``density`` ((V, V, V) float, X-Y-Z indexed) to .vdb bytes.

    Voxels with value > ``sparse_threshold`` become active; everything
    else is background (0). The volume must fit one level-2 node
    (V <= 4096) with non-negative indices, which holds for every grid
    this framework produces.
    """
    density = np.asarray(density)
    assert density.ndim == 3 and max(density.shape) <= 1 << (_L0 + _L1 + _L2)
    coords = np.argwhere(density > sparse_threshold)
    vals = density[tuple(coords.T)].astype(np.float16)

    def pack_key(xyz, shift, log2dim):
        c = (xyz >> shift) & ((1 << log2dim) - 1)
        return (c[:, 0] | (c[:, 1] << log2dim)
                | (c[:, 2] << (2 * log2dim))).astype(np.int64)

    k2 = pack_key(coords, _L0 + _L1, _L2)   # child slot in the level-2 node
    k1 = pack_key(coords, _L0, _L1)         # leaf slot in its level-1 node
    k0 = pack_key(coords, 0, _L0)           # voxel slot in its leaf
    order = np.lexsort((k0, k1, k2))
    k2, k1, k0, vals = k2[order], k1[order], k0[order], vals[order]

    # group voxels -> leaves -> level-1 nodes (all sorted, matching the
    # depth-first order the format requires)
    leaf_key = k2 * (1 << (3 * _L1)) + k1
    leaves, leaf_start = np.unique(leaf_key, return_index=True)
    n2 = np.unique(k2)
    n1_of_leaf = leaves >> (3 * _L1)
    k1_of_leaf = leaves & ((1 << (3 * _L1)) - 1)

    out = [
        bytes([0x20, 0x42, 0x44, 0x56, 0, 0, 0, 0]),         # magic
        np.array([224, 8, 1], np.uint32).tobytes(),          # file/lib ver
        b"\x00",                                             # no grid offsets
        str(uuid.uuid4()).encode("ascii"),
        np.array([0, 1], np.uint32).tobytes(),               # 0 meta, 1 grid
        _lenstr(grid_name),
        _lenstr("Tree_float_5_4_3_HalfFloat"),
        np.uint32(0).tobytes(),                              # not an instance
    ]
    # grid stream positions (start/blocks/end) — only start is meaningful
    # for a single uncompressed grid
    here = sum(len(b) for b in out) + 3 * 8
    out += [
        np.array([here, 0, 0], np.uint64).tobytes(),
        np.uint32(0).tobytes(),                              # grid compression
        np.uint32(4).tobytes(),                              # grid metadata
        _meta("class", "unknown"),
        _meta("file_compression", "none"),
        _lenstr("is_saved_as_half_float") + _lenstr("bool")
        + np.uint32(1).tobytes() + b"\x01",
        _meta("name", grid_name),
        _lenstr("AffineMap"),
        np.eye(4, dtype=np.float64).tobytes(),               # transform
        # tree: 1 buffer, f32 background 0, 0 unused, 1 root child at origin
        np.array([1, 0, 0, 1], np.uint32).tobytes(),
        np.zeros(3, np.uint32).tobytes(),
        _node_header(1 << (3 * _L2), n2),
    ]
    # topology: each level-1 node followed by its leaves' value masks
    for c2 in n2:
        sel = n1_of_leaf == c2
        out.append(_node_header(1 << (3 * _L1), k1_of_leaf[sel]))
        for i in np.nonzero(sel)[0]:
            s = leaf_start[i]
            e = leaf_start[i + 1] if i + 1 < len(leaves) else len(k0)
            out.append(_packed_mask(1 << (3 * _L0), k0[s:e]))
    # buffers: per leaf, value mask + compression tag + raw half floats
    for i in range(len(leaves)):
        s = leaf_start[i]
        e = leaf_start[i + 1] if i + 1 < len(leaves) else len(k0)
        dense = np.zeros(1 << (3 * _L0), np.float16)
        dense[k0[s:e]] = vals[s:e]
        out += [_packed_mask(1 << (3 * _L0), k0[s:e]),
                np.uint8(6).tobytes(), dense.tobytes()]
    return b"".join(out)


def save_vdb(path, density, sparse_threshold: float = 0.01, **kw):
    with open(path, "wb") as f:
        f.write(dumps(density, sparse_threshold, **kw))
