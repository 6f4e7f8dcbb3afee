"""Raster selection: the hand-written Hopper kernel and its plain PyTorch
version.

`raster_select(pts, faces, cand, cand_valid, tile, tiles_x)` is the
counterpart of `mvedit_tpu/models/mesh/select_pallas.py::select_pallas`
together with its coefficient pass `prepare_coeffs`. For every screen tile
(tile x tile pixels, pixel centres at +0.5) and its K candidate triangles
it evaluates three sign-folded edge functions and the screen-space 1/z
plane, affine in the pixel, and keeps per pixel the covering candidate
with the largest 1/z; ties go to the lowest candidate index. It returns
(best (T, tile^2) int32 index into the candidate axis, key (T, tile^2)
float32 = -1/z of the winner, 3e38 and index 0 where nothing covers).
It is not differentiable: gradients come from the winner recompute in
`rasterize._winner_outputs`.

- CUDA tensors launch `csrc/raster_select.cu` (sm_90a), built with nvcc at
  first use into `_build/` and bound through ctypes. A build or launch
  failure raises; nothing falls back.
- CPU tensors take `select_reference`, the plain version.

Both evaluate the coefficients and the affine tests op by op in the same
order with IEEE rounding (the kernel builds without FMA contraction), so on
the card the kernel's ids and keys match the plain version's bit for bit.
`raster_select.launches` counts kernel launches.
"""
import ctypes
import os
import subprocess
import threading

import torch

__all__ = ["raster_select", "select_reference", "prepare_coeffs", "build",
           "BIG"]

BIG = 3.0e38                 # key of a pixel that nothing covers
_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "csrc", "raster_select.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB = os.path.join(_BUILD_DIR, "libmvedit_raster_select.so")
BUILD_LOG = os.path.join(_BUILD_DIR, "raster_select.nvcc.log")
_lib = None
_lib_lock = threading.Lock()


def prepare_coeffs(pts, faces, cand, cand_valid, cull_backface=False):
    """(T, K, 12) affine coefficients of the candidates, as
    `select_pallas.prepare_coeffs` builds them: cols 0-8 = (alpha, beta,
    gamma) of edges 0..2, sign-folded so that covered <=> all three >= 0,
    invalid or degenerate candidates (0, 0, -1); cols 9-11 = (zx, zy, zc)
    of the 1/z plane, divided by the signed area. Every op rounds on its
    own, in the order the kernel evaluates them."""
    p = pts[faces[cand.long()]]                       # (T, K, 3, 3)
    ax, ay, az = p[..., 0, 0], p[..., 0, 1], p[..., 0, 2]
    bx, by, bz = p[..., 1, 0], p[..., 1, 1], p[..., 1, 2]
    cx, cy, cz = p[..., 2, 0], p[..., 2, 1], p[..., 2, 2]
    al0, be0, ga0 = -(cy - by), cx - bx, bx * cy - cx * by
    al1, be1, ga1 = -(ay - cy), ax - cx, cx * ay - ax * cy
    al2, be2, ga2 = -(by - ay), bx - ax, ax * by - bx * ay
    area = ga0 + ga1 + ga2
    if cull_backface:
        ok = cand_valid & (area > 1e-12)
        sgn = torch.ones_like(area)
    else:
        ok = cand_valid & (area.abs() > 1e-12)
        sgn = torch.sign(area)
    tiny = torch.where(area >= 0, torch.full_like(area, 1e-12),
                       torch.full_like(area, -1e-12))
    inv_area = torch.reciprocal(torch.where(area.abs() < 1e-12, tiny, area))
    iza, izb, izc = (torch.reciprocal(z) for z in (az, bz, cz))
    zx = (al0 * iza + al1 * izb + al2 * izc) * inv_area
    zy = (be0 * iza + be1 * izb + be2 * izc) * inv_area
    zc = (ga0 * iza + ga1 * izb + ga2 * izc) * inv_area
    zero = torch.zeros((), dtype=area.dtype, device=area.device)
    rows = []
    for al, be, ga in ((al0, be0, ga0), (al1, be1, ga1), (al2, be2, ga2)):
        rows += [torch.where(ok, al * sgn, zero),
                 torch.where(ok, be * sgn, zero),
                 torch.where(ok, ga * sgn, -1.0 + zero)]
    return torch.stack(rows + [zx, zy, zc], -1)


@torch.no_grad()
def select_reference(pts, faces, cand, cand_valid, tile, tiles_x,
                     cull_backface=False, tile_chunk=64):
    """The plain version of `raster_select`, over chunks of `tile_chunk`
    tiles so that the (tiles, tile^2, K) temporaries stay bounded."""
    T = cand.shape[0]
    P = tile * tile
    dev = pts.device
    pid = torch.arange(P, device=dev)
    best = torch.empty((T, P), dtype=torch.int32, device=dev)
    bkey = torch.empty((T, P), dtype=torch.float32, device=dev)
    for t0 in range(0, T, tile_chunk):
        t = torch.arange(t0, min(T, t0 + tile_chunk), device=dev)
        co = prepare_coeffs(pts.float(), faces, cand[t], cand_valid[t],
                            cull_backface)                  # (C, K, 12)
        qx = ((t[:, None] % tiles_x) * tile + pid % tile).float() + 0.5
        qy = ((t[:, None] // tiles_x) * tile + pid // tile).float() + 0.5
        qx, qy = qx[:, :, None], qy[:, :, None]             # (C, P, 1)

        def aff(i):
            return (co[:, None, :, i] * qx + co[:, None, :, i + 1] * qy
                    + co[:, None, :, i + 2])                # (C, P, K)
        covered = (aff(0) >= 0) & (aff(3) >= 0) & (aff(6) >= 0)
        key = -aff(9)
        # a covered key that is not below BIG (NaN, +inf) is never taken,
        # as the kernel's strict `key < best` scan never takes it
        key = torch.where(covered & (key < BIG), key,
                          torch.full_like(key, BIG))
        k, i = key.min(-1)          # first index of the minimum
        best[t] = i.int()
        bkey[t] = k
    return best, bkey


def build():
    """Compile the kernel (if its library is missing or older than the
    source) and load it. Returns the ctypes library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            from torch.utils.cpp_extension import CUDA_HOME
            if CUDA_HOME is None:
                raise RuntimeError("no CUDA toolkit found to build "
                                   "raster_select.cu")
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{_LIB}.{os.getpid()}.tmp"
            # -fmad=false: no FMA contraction, so the affine tests round
            # as the plain version's separate ops do
            cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"),
                   "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-fmad=false", "-shared",
                   "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", tmp, _SRC]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                   f"{res.stdout}\n{res.stderr}")
            with open(BUILD_LOG, "w") as f:
                f.write(res.stdout + res.stderr)
            os.replace(tmp, _LIB)
        lib = ctypes.CDLL(_LIB)
        fn = lib.mvedit_raster_select
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _lib = lib
        return lib


def raster_select(pts, faces, cand, cand_valid, tile, tiles_x,
                  cull_backface=False):
    """pts (V, 3) pixel-space (u, v, z) float32, faces (F, 3) int, cand
    (T, K) int ids into faces, cand_valid (T, K) bool -> (best (T, P)
    int32, key (T, P) float32), see module doc."""
    T, K = cand.shape
    if cand_valid.shape != (T, K) or pts.dim() != 2 or pts.shape[1] != 3 \
            or faces.dim() != 2 or faces.shape[1] != 3:
        raise ValueError(f"bad shapes: pts {tuple(pts.shape)}, faces "
                         f"{tuple(faces.shape)}, cand {tuple(cand.shape)}, "
                         f"cand_valid {tuple(cand_valid.shape)}")
    if pts.device.type == "cpu":
        return select_reference(pts, faces, cand, cand_valid, tile, tiles_x,
                                cull_backface)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    if not 1 <= tile * tile <= 1024:
        raise ValueError(f"tile {tile}: one thread per pixel, at most 1024")
    dev = pts.device
    pts = pts.detach().float().contiguous()
    faces = faces.to(device=dev, dtype=torch.int32).contiguous()
    cand = cand.to(device=dev, dtype=torch.int32).contiguous()
    valid = cand_valid.to(device=dev, dtype=torch.uint8).contiguous()
    best = torch.empty((T, tile * tile), dtype=torch.int32, device=dev)
    key = torch.empty((T, tile * tile), dtype=torch.float32, device=dev)
    if T == 0:
        return best, key
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mvedit_raster_select(
            pts.data_ptr(), faces.data_ptr(), cand.data_ptr(),
            valid.data_ptr(), T, K, tile, tiles_x, int(cull_backface),
            faces.shape[0], best.data_ptr(), key.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"raster_select launch failed: CUDA error {err}")
    raster_select.launches += 1
    return best, key


raster_select.launches = 0
