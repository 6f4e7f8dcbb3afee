"""Raster selection: the hand-written Hopper kernel and its plain PyTorch
versions.

`raster_select(pts, faces, tile_tris, tile_valid, tile, tiles_x,
cull_backface, big_tris, big_valid)` is the counterpart of
`mvedit_tpu/models/mesh/select_pallas.py::select_pallas` together with its
coefficient pass `prepare_coeffs`. Each screen tile (tile x tile pixels,
pixel centres at +0.5) has a candidate axis: its bin list (tile_tris (T, Kt))
followed by the global big list (big_tris (Kb,), shared by every tile; an
index >= Kt points into it). Per pixel it evaluates three sign-folded edge
functions and the screen-space 1/z plane, affine in the pixel, and keeps
the covering candidate with the largest 1/z; ties go to the lowest
candidate index. It returns (best (T, tile^2) int32 index into the
candidate axis, key (T, tile^2) float32 = -1/z of the winner, face
(T, tile^2) int64 face id of the winner), with 0, 3e38 and -1 where
nothing covers the pixel. It
is not differentiable: gradients come from the winner recompute in
`rasterize._winner_outputs`.

- CUDA tensors launch `csrc/raster_select.cu` (sm_90a), built with nvcc at
  first use into `_build/` and bound through ctypes, at the tiles it takes
  (`TILES`: 16, and 32 for texture superres's 2048^2 bake). A build or
  launch failure, or another tile, raises; nothing falls back.
- CPU tensors take `raster_select_reference`, the plain version of the
  same interface, which concatenates the lists and runs `select_reference`,
  the plain version of the TPU kernel's own interface (one (T, K) list),
  at any tile, as the reference does.

Both evaluate the coefficients and the affine tests op by op in the same
order with IEEE rounding (the kernel builds without FMA contraction), so on
the card the kernel's ids and keys equal the plain version's bit for bit.

`plan(...)` says on the host alone (CPU and `meta` tensors too) whether the
kernel reads the inputs as they are ("direct": float32 pts, int64 faces
and ids, bool masks, each contiguous: what `rasterize` hands it) or from
converted copies ("staged"), and raises for what it does not take (on a
CPU tensor, any tile).
`raster_select.launches` counts kernel launches and `raster_select.staged`
the launches that needed the copies (0 on the paths). `block_masks` is the
plain version of the kernel's per-warp reject, used to count its work.
"""
import ctypes
import functools
import os
import subprocess
import threading

import torch

__all__ = ["raster_select", "raster_select_reference", "select_reference",
           "prepare_coeffs", "block_masks", "plan", "launch", "splits_for",
           "build", "compile_source", "load_library", "BIG", "TILES"]

BIG = 3.0e38                 # key of a pixel that nothing covers
TILES = (16, 32)             # the kernel's tile edges in pixels
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
    """The plain version of `select_pallas` on one (T, K) candidate list
    -> (best, key), over chunks of `tile_chunk` tiles so that the
    (tiles, tile^2, K) temporaries stay bounded."""
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


@torch.no_grad()
def raster_select_reference(pts, faces, tile_tris, tile_valid, tile,
                            tiles_x, cull_backface=False, big_tris=None,
                            big_valid=None):
    """The plain version of `raster_select`: (best, key, face), from
    `select_reference` on the joined (T, Kt + Kb) candidate axis."""
    cand, cval = tile_tris.long(), tile_valid.bool()
    if big_tris is not None:
        T = cand.shape[0]
        cand = torch.cat([cand, big_tris.long()[None].expand(T, -1)], 1)
        cval = torch.cat([cval, big_valid.bool()[None].expand(T, -1)], 1)
    best, key = select_reference(pts, faces.long(), cand, cval, tile,
                                 tiles_x, cull_backface)
    face = torch.where(key < BIG, cand.gather(1, best.long()),
                       torch.full_like(cand[:, :1], -1))
    return best, key, face


def block_masks(co, tiles_x, tile_ids=None, tile=16):
    """The plain version of the kernel's per-warp reject: for coefficients
    `co` (T, K, 12) from `prepare_coeffs`, a (T, K, tile^2 / 32) bool, True
    where candidate k may cover a pixel of warp block b of its tile (8 x 4
    pixels at (8 (b % bx), 4 (b / bx)), bx = tile / 8). Each edge is
    evaluated, with the selection's own rounding, at the block corner where
    it is largest; invalid and degenerate candidates ((0, 0, -1) edges) get
    no block. `tile_ids` (T,) are the tiles' indices (default 0..T-1)."""
    T = co.shape[0]
    t = torch.arange(T, device=co.device) if tile_ids is None else tile_ids
    x0 = ((t % tiles_x) * tile)[:, None]                    # (T, 1)
    y0 = ((t // tiles_x) * tile)[:, None]
    bx = tile // 8
    b = torch.arange(tile * tile // 32, device=co.device)
    out = None
    for e in range(3):
        al, be, ga = (co[..., 3 * e + i, None] for i in range(3))   # (T,K,1)
        cx = (x0 + 8 * (b % bx))[:, None, :] + torch.where(al >= 0, 7, 0)
        cy = (y0 + 4 * (b // bx))[:, None, :] + torch.where(be >= 0, 3, 0)
        w = al * (cx.float() + 0.5) + be * (cy.float() + 0.5) + ga
        out = w >= 0 if out is None else out & (w >= 0)
    return out


def compile_source(src, lib, log):
    """nvcc `src` for sm_90a into the shared library `lib`, and ptxas'
    report (registers, shared memory, spills per instantiation) into
    `log`. -fmad=false: no FMA contraction, so the affine tests round as
    the plain version's separate ops do."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError(f"no CUDA toolkit found to build {src}")
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"),
           "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-fmad=false", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", tmp, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    with open(log, "w") as f:
        f.write(res.stdout + res.stderr)
    os.replace(tmp, lib)


def load_library(lib):
    """Load a library built by `compile_source` and bind its C entry."""
    lib = ctypes.CDLL(lib)
    fn = lib.mvedit_raster_select
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, ctypes.c_longlong, p, p, i, i, p, p, i, i, i, i, i,
                   p, p, p, p]
    fn.restype = i
    return lib


def build():
    """Compile the kernel (if its library is missing or older than the
    source) and load it. Returns the ctypes library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            if (not os.path.exists(_LIB)
                    or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
                compile_source(_SRC, _LIB, BUILD_LOG)
            _lib = load_library(_LIB)
        return _lib


def plan(pts, faces, tile_tris, tile_valid, tile, big_tris=None,
         big_valid=None):
    """"direct" or "staged" for the kernel, decided from shapes, dtypes,
    devices and layouts alone; raises ValueError or TypeError for inputs
    it does not take (a tile outside `TILES` only off the CPU, whose plain
    version takes any). The path's inputs take the first test."""
    big = big_tris is not None
    if big != (big_valid is not None):
        raise ValueError("give both big_tris and big_valid, or neither")
    ps, fs, ts = pts.shape, faces.shape, tile_tris.shape
    if len(ps) != 2 or ps[1] != 3 or len(fs) != 2 or fs[1] != 3 \
            or len(ts) != 2 or tile_valid.shape != ts:
        raise ValueError(f"bad shapes: pts {tuple(ps)}, faces {tuple(fs)}, "
                         f"tile_tris {tuple(ts)}, tile_valid "
                         f"{tuple(tile_valid.shape)}")
    if big and (big_tris.dim() != 1 or big_valid.shape != big_tris.shape):
        raise ValueError(f"bad big list: {tuple(big_tris.shape)}, "
                         f"{tuple(big_valid.shape)}")
    ids = (faces, tile_tris, big_tris) if big else (faces, tile_tris)
    masks = (tile_valid, big_valid) if big else (tile_valid,)
    dev = pts.device
    if tile not in TILES and dev.type != "cpu":
        raise ValueError(f"tile {tile}: the kernel's tiles are {TILES}")
    if any(x.device != dev for x in ids + masks):
        raise ValueError("all inputs must be on one device")
    if ts[1] + (big_tris.shape[0] if big else 0) >= 2 ** 31 \
            or ts[0] >= 2 ** 31:
        raise ValueError("candidate axis or tile count too large")
    if pts.dtype is torch.float32 and pts.is_contiguous() \
            and all(x.dtype is torch.int64 and x.is_contiguous()
                    for x in ids) \
            and all(x.dtype is torch.bool and x.is_contiguous()
                    for x in masks):
        return "direct"
    if not pts.is_floating_point():
        raise TypeError(f"pts must be floating, got {pts.dtype}")
    for x in ids + masks:
        if x.is_floating_point() or x.is_complex():
            raise TypeError(f"ids and masks must be integer or bool, got "
                            f"{x.dtype}")
    return "staged"


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits_for(T, sms, tile=16):
    """Warps per 8 x 4 pixel block, from the tile count T and the card's
    `sms` SMs (measured on the H100 with `chip_smoke.py --ab`, PERF.md):
    1 (8-warp CTAs) at 16 tiles per SM or more (the 1024^2 bake), 2 from
    4 per SM (the 512^2 renders), else 4 (the 128^2 and 256^2 ramp), the
    block's candidates taken in turns. A 32 x 32 tile's CTA has 1024
    threads at one split, the most a CTA may have."""
    if tile == 32 or T >= 16 * sms:
        return 1
    return 2 if T >= 4 * sms else 4


def launch(pts, faces, tile_tris, tile_valid, tile, tiles_x,
           cull_backface=False, big_tris=None, big_valid=None, lib=None,
           splits=None):
    """Launch the kernel on CUDA tensors; returns (best, key, face). Counts
    staged launches in `raster_select.staged`, and no launch: that count
    is `raster_select`'s.
    `lib` is a library of `load_library` to launch instead of the built
    one (an edited source, timed against it); `splits` overrides
    `splits_for`."""
    how = plan(pts, faces, tile_tris, tile_valid, tile, big_tris, big_valid)
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if how == "staged":
        pts = pts.detach().float().contiguous()
        faces, tile_tris = (x.long().contiguous() for x in (faces, tile_tris))
        tile_valid = tile_valid.bool().contiguous()
        if big_tris is not None:
            big_tris = big_tris.long().contiguous()
            big_valid = big_valid.bool().contiguous()
        raster_select.staged += 1
    T, Kt = tile_tris.shape
    Kb = 0 if big_tris is None else big_tris.shape[0]
    best = torch.empty((T, tile * tile), dtype=torch.int32, device=dev)
    key = torch.empty((T, tile * tile), dtype=torch.float32, device=dev)
    face = torch.empty((T, tile * tile), dtype=torch.int64, device=dev)
    if T == 0:
        return best, key, face
    lib = build() if lib is None else lib
    if splits is None:
        splits = splits_for(T, _sm_count(dev.index), tile)
    args = (pts.data_ptr(), faces.data_ptr(), faces.shape[0],
            tile_tris.data_ptr(), tile_valid.data_ptr(), T, Kt,
            None if big_tris is None else big_tris.data_ptr(),
            None if big_valid is None else big_valid.data_ptr(), Kb,
            tiles_x, int(cull_backface), tile, splits, best.data_ptr(),
            key.data_ptr(), face.data_ptr())
    # the launch goes to the runtime's current device: switch only when
    # the tensors lie on another
    if dev.index == torch.cuda.current_device():
        err = lib.mvedit_raster_select(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = lib.mvedit_raster_select(
                *args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"raster_select launch failed: CUDA error {err}")
    return best, key, face


def raster_select(pts, faces, tile_tris, tile_valid, tile, tiles_x,
                  cull_backface=False, big_tris=None, big_valid=None):
    """pts (V, 3) pixel-space (u, v, z) float, faces (F, 3) int, tile_tris
    (T, Kt) int ids into faces, tile_valid (T, Kt) bool, and the optional
    big list big_tris / big_valid (Kb,) -> (best (T, tile^2) int32, key
    (T, tile^2) float32, face (T, tile^2) int64), see module doc."""
    if pts.device.type == "cpu":
        plan(pts, faces, tile_tris, tile_valid, tile, big_tris, big_valid)
        return raster_select_reference(pts, faces, tile_tris, tile_valid,
                                       tile, tiles_x, cull_backface,
                                       big_tris, big_valid)
    out = launch(pts, faces, tile_tris, tile_valid, tile, tiles_x,
                 cull_backface, big_tris, big_valid)
    raster_select.launches += 1
    return out


raster_select.launches = 0
raster_select.staged = 0
