"""Multi-texture atlas packing + UV rewrite (a numpy copy of
`mvedit_tpu/models/mesh/atlas.py`).

Merges multi-material scenes into ONE mesh with ONE texture: shelf-packs
the source textures into a single atlas and remaps each submesh's UVs into
its texture's cell (the reference's vendored imagepacker).
"""
from typing import List, Sequence, Tuple

import numpy as np

from .container import Mesh

__all__ = ["pack_rects", "merge_meshes"]


def pack_rects(sizes: Sequence[Tuple[int, int]], max_width=4096):
    """Shelf packing. sizes: [(h, w)...]. Returns (positions [(y, x)...],
    atlas_h, atlas_w)."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i][0])
    positions = [None] * len(sizes)
    x = y = shelf_h = 0
    atlas_w = 0
    for i in order:
        h, w = sizes[i]
        if x + w > max_width and x > 0:
            y += shelf_h
            x = 0
            shelf_h = 0
        positions[i] = (y, x)
        x += w
        shelf_h = max(shelf_h, h)
        atlas_w = max(atlas_w, x)
    atlas_h = y + shelf_h
    return positions, atlas_h, atlas_w


def merge_meshes(meshes: List[Mesh], texture_size=512):
    """Merge submeshes (each with optional albedo/vc) into one textured mesh.

    Submeshes without a texture get a solid-color tile (their mean vertex
    color / gray). Returns a single Mesh with a packed atlas.
    """
    sizes = []
    textures = []
    for m in meshes:
        if m.albedo is not None:
            tex = np.asarray(m.albedo, np.float32)
        else:
            color = (m.vc.mean(0) if m.vc is not None
                     else np.array([0.8, 0.8, 0.8], np.float32))
            tex = np.broadcast_to(color, (16, 16, 3)).copy()
        textures.append(tex)
        sizes.append(tex.shape[:2])
    positions, ah, aw = pack_rects(sizes)
    atlas = np.zeros((ah, aw, 3), np.float32)
    verts, faces, uvs, uv_faces = [], [], [], []
    v_off = vt_off = 0
    for m, tex, (y, x) in zip(meshes, textures, positions):
        th, tw = tex.shape[:2]
        atlas[y:y + th, x:x + tw] = tex
        verts.append(np.asarray(m.v, np.float32))
        faces.append(np.asarray(m.f, np.int32) + v_off)
        if m.vt is not None:
            uv = np.asarray(m.vt, np.float32).copy()
            ft = np.asarray(m.ft if m.ft is not None else m.f, np.int32)
        else:
            uv = np.full((len(m.v), 2), 0.5, np.float32)
            ft = np.asarray(m.f, np.int32)
        # remap into the atlas cell
        uv = np.stack([(x + uv[:, 0] * tw) / aw,
                       (y + uv[:, 1] * th) / ah], axis=-1)
        uvs.append(uv)
        uv_faces.append(ft + vt_off)
        v_off += len(m.v)
        vt_off += len(uv)
    out = Mesh(v=np.concatenate(verts), f=np.concatenate(faces),
               vt=np.concatenate(uvs), ft=np.concatenate(uv_faces),
               albedo=np.clip(atlas, 0, 1))
    out.auto_normal()
    return out
