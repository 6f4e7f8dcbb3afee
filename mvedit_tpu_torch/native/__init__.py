"""Host-side mesh welding and decimation (counterpart of
`mvedit_tpu/native`).

`weld_vertices` (the spatial-hash vertex merge) and `decimate_qem` (the
quadric-error-metric edge collapse) call `csrc/mesh_native.cpp`,
`LIBRARY` (built with g++ and bound by `kernels/library.py` at first
use). `native_available()` says whether the library built. Without it
`weld_vertices` takes the reference's numpy fallback (quantise and
unique), and the pipeline skips decimation, as the reference does.
"""
import ctypes

import numpy as np

from ..kernels.library import BuildError, Library

__all__ = ["weld_vertices", "decimate_qem", "native_available"]


def _bind(lib):
    lib.weld_vertices.restype = ctypes.c_int64
    lib.weld_vertices.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)]
    lib.decimate_qem.restype = ctypes.c_int64
    lib.decimate_qem.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]


LIBRARY = Library("mesh_native", "mesh_native.cpp",
                  ["g++", "-O3", "-fPIC", "-shared", "-std=c++17"], _bind,
                  timeout=300)


def _load():
    """The bound library, or None when it cannot be built or loaded."""
    try:
        return LIBRARY.load()
    except (BuildError, OSError):
        return None


def native_available():
    return _load() is not None


def _ptr(arr, typ):
    return arr.ctypes.data_as(ctypes.POINTER(typ))


def weld_vertices(verts, faces, eps=1e-6):
    """Merge the vertices of (verts (V, 3), faces (F, 3)) that share a cell
    of edge `eps`: the library keeps each cell's first vertex in input
    order (cells at floor(v / eps)); without the library, the reference's
    fallback keeps one vertex per rounded key, in sorted key order.
    Returns (verts', faces') float32 / int32."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    if faces.size and (faces.min() < 0 or faces.max() >= len(verts)):
        raise ValueError("face index out of range")
    lib = _load()
    if lib is None:
        key = np.round(verts / max(eps, 1e-12)).astype(np.int64)
        _, first, remap = np.unique(key, axis=0, return_index=True,
                                    return_inverse=True)
        return verts[first], remap.reshape(-1)[faces].astype(np.int32)
    out_v = np.empty_like(verts)
    remap = np.empty((len(verts),), np.int64)
    n = lib.weld_vertices(_ptr(verts, ctypes.c_float), len(verts),
                          ctypes.c_float(eps), _ptr(out_v, ctypes.c_float),
                          _ptr(remap, ctypes.c_int64))
    return out_v[:n].copy(), remap[faces].astype(np.int32)


def decimate_qem(verts, faces, target_faces):
    """QEM simplification of (verts (V, 3), faces (F, 3)) to about
    target_faces faces. Returns (verts', faces') float32 / int32. Raises
    when the library is not available."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    if faces.size and (faces.min() < 0 or faces.max() >= len(verts)):
        raise ValueError("face index out of range")
    if target_faces >= len(faces):
        return verts.copy(), faces.copy()
    lib = _load()
    if lib is None:
        raise RuntimeError("the mesh decimation library did not build "
                           "(g++ needed)")
    out_v = np.empty_like(verts)
    out_f = np.empty_like(faces)
    packed = lib.decimate_qem(
        _ptr(verts, ctypes.c_float), len(verts),
        _ptr(faces, ctypes.c_int32), len(faces),
        ctypes.c_int64(int(target_faces)),
        _ptr(out_v, ctypes.c_float), _ptr(out_f, ctypes.c_int32))
    nf, nv = packed >> 32, packed & 0xFFFFFFFF
    return out_v[:nv].copy(), out_f[:nf].copy()
