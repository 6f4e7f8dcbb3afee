"""Fixed-order segment sum: the hand-written Hopper kernel and its plain
PyTorch version.

`segment_sum(idx, vals, size)` -> (size, C) float32, row r the sum of the
rows of `vals` (N, C) whose target `idx` (N,) is r, added in their order
along N; targets outside [0, size) are dropped. It is the accumulation
behind the port's row gathers' gradients and its vertex sums
(`ops/segment.py`), written so that one seed gives one result on the card:
`index_add` there adds atomically, in whatever order the adds arrive.

- `segment_order(idx, size)` sorts the targets (a stable sort of int32
  ids keeps each row's contributions in their order) and returns the
  permutation and the row offsets (size + 1,) that the kernel walks.
- CUDA tensors launch `csrc/segment_sum.cu` (sm_90a) on that order, built
  with nvcc at first use into `_build/` and bound through ctypes: one
  thread per (row, channel) sums a row of at most `LONG` contributions in
  order in float32; a longer row (the background pixels of a render all
  gather one dummy face) is summed by one block, 256 strided partial sums
  added in a fixed tree. A build or launch failure raises; nothing falls
  back.
- CPU tensors take `segment_sum_reference`, a float32 `index_add` into
  zeros, which on the CPU adds in order: the kernel's bits for rows of at
  most `LONG`. On the card the plain version is atomic.
- `segment_sum_ordered` is the kernel's order in plain PyTorch on any
  device (the long rows' strided partials and tree included): the
  kernel's bits on every row. `rounding_bound` is how far the kernel's
  order may lie from the exact sum (checked against a float64 sum).

`segment_sum.launches` counts kernel launches and `segment_sum.staged` the
launches whose inputs were copied first (values neither float32 nor
bfloat16, or not contiguous; 0 on the paths).
"""
import ctypes
import os
import threading

import torch

from .raster_select import compile_source

__all__ = ["segment_sum", "segment_sum_reference", "segment_sum_ordered",
           "segment_order", "launch", "rounding_bound", "build",
           "load_library", "LONG", "BLOCK"]

LONG = 1024           # longer rows are summed by a block (csrc kLong)
BLOCK = 256           # the block's threads, its partial sums (csrc kBlock)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "csrc", "segment_sum.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB = os.path.join(_BUILD_DIR, "libmvedit_segment_sum.so")
BUILD_LOG = os.path.join(_BUILD_DIR, "segment_sum.nvcc.log")
_lib = None
_lib_lock = threading.Lock()


def segment_sum_reference(idx, vals, size, dtype=torch.float32):
    """The plain version: `zeros((size, C)).index_add(0, idx, vals)` in
    `dtype` (float32; float64 for an exact reference), rows with idx
    outside [0, size) dropped."""
    keep = (idx >= 0) & (idx < size)
    # index_add raises on out-of-range targets: dropped rows add a zero
    # payload to row 0 (no host sync, unlike boolean indexing)
    safe = torch.where(keep, idx, torch.zeros_like(idx))
    v = torch.where(keep[:, None], vals.to(dtype),
                    torch.zeros((), dtype=dtype, device=vals.device))
    out = torch.zeros((size, vals.shape[-1]), dtype=dtype,
                      device=vals.device)
    return out.index_add(0, safe.long(), v)


def segment_sum_ordered(idx, vals, size, budget=1 << 26):
    """The kernel's order in plain PyTorch, on any device: float32 adds,
    which round alike everywhere, so the result has the kernel's bits. A
    row of at most `LONG` is added one contribution after another (all
    rows' k-th contributions in one step); a longer row as `BLOCK`
    partial sums, partial t adding entries t, t + BLOCK, ... in order,
    then the fixed tree part[t] += part[t + w] for w = BLOCK / 2, ..., 1.
    `budget` caps the elements of one padded batch of long rows."""
    perm, off = segment_order(idx, size)
    C, dev = vals.shape[1], vals.device
    out = torch.zeros((size, C), dtype=torch.float32, device=dev)
    kept = int(off[-1])
    if kept == 0:
        return out
    v = vals.float()[perm[:kept]]                  # by row, in order
    cnt = off[1:] - off[:-1]
    row = torch.repeat_interleave(torch.arange(size, device=dev), cnt,
                                  output_size=kept)
    pos = torch.arange(kept, device=dev) - off[:-1][row]
    short = cnt[row] <= LONG
    if bool(short.any()):
        ps, order = torch.sort(pos[short], stable=True)
        rs, vs = row[short][order], v[short][order]
        start = 0
        # position k of every short row at once; rows are distinct in a
        # step, so the indexed add is exact
        for c in torch.bincount(ps).tolist():
            r = rs[start:start + c]
            out[r] = out[r] + vs[start:start + c]
            start += c
    longs = torch.nonzero(cnt > LONG)[:, 0]
    if longs.numel():
        longs = longs[torch.argsort(cnt[longs])]
        lens = cnt[longs].tolist()
        i = 0
        while i < len(lens):
            # a batch of rows padded to its longest (lengths ascending)
            j = i + 1
            while j < len(lens) and (j + 1 - i) * (
                    -(-lens[j] // BLOCK) * BLOCK) * C <= budget:
                j += 1
            rows = longs[i:j]
            q = -(-lens[j - 1] // BLOCK)
            p = torch.arange(q * BLOCK, device=dev)
            src = off[rows][:, None] + p
            ok = p < cnt[rows][:, None]
            x = torch.where(ok[..., None], v[src.clamp(max=kept - 1)],
                            torch.zeros((), device=dev))
            x = x.view(len(rows), q, BLOCK, C)
            part = torch.zeros((len(rows), BLOCK, C), device=dev)
            for k in range(q):       # adding a padded +0 keeps the bits
                part = part + x[:, k]
            w = BLOCK // 2
            while w:
                part = part[:, :w] + part[:, w:2 * w]
                w //= 2
            out[rows] = part[:, 0]
            i = j
    return out


def rounding_bound(idx, vals, size):
    """(size, C) float64: how far the kernel's float32 sum of each row
    may lie from the exact sum, k u sum|x| (u = 2^-24), k = n for a row of
    n <= `LONG` (added in order) and ceil(n / BLOCK) + log2(BLOCK) for a
    longer one (strided partials, then the tree), plus the rounding of a
    float64 reference sum (n 2^-53 sum|x|)."""
    mag = segment_sum_reference(idx, vals.abs(), size, torch.float64)
    n = segment_sum_reference(idx, torch.ones_like(vals[:, :1]), size,
                              torch.float64)
    depth = BLOCK.bit_length() - 1
    k = torch.where(n <= LONG, n, torch.ceil(n / BLOCK) + depth)
    return (k * 2.0 ** -24 + n * 2.0 ** -53) * mag


def segment_order(idx, size):
    """(perm (N,) int64, off (size + 1,) int64): the contributions sorted
    by target row, stable, so row r's are perm[off[r]:off[r + 1]] in their
    original order; dropped targets sort past off[size]."""
    if size >= 2 ** 31 - 1 or idx.shape[0] >= 2 ** 31:
        raise ValueError(f"too many rows ({size}) or contributions "
                         f"({idx.shape[0]}) for int32 ids")
    key = torch.where((idx >= 0) & (idx < size), idx,
                      torch.full_like(idx, size)).int()
    skey, perm = torch.sort(key, stable=True)
    off = torch.searchsorted(skey, torch.arange(
        size + 1, dtype=torch.int32, device=idx.device))
    return perm, off


def load_library(lib):
    lib = ctypes.CDLL(lib)
    fn = lib.mvedit_segment_sum
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, i, ctypes.c_longlong, ctypes.c_longlong, p,
                   p, p]
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


def launch(vals, perm, off, size, lib=None):
    """The kernel on CUDA tensors in the order of `segment_order`; returns
    (size, C) float32. Counts staged launches, not launches."""
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    if vals.dim() != 2 or perm.dim() != 1 or off.shape != (size + 1,) \
            or perm.shape[0] != vals.shape[0]:
        raise ValueError(f"bad shapes: vals {tuple(vals.shape)}, perm "
                         f"{tuple(perm.shape)}, off {tuple(off.shape)}, "
                         f"size {size}")
    if any(x.device != vals.device for x in (perm, off)):
        raise ValueError("all inputs must be on one device")
    if perm.dtype is not torch.int64 or off.dtype is not torch.int64:
        raise TypeError("perm and off must be int64")
    if vals.dtype not in (torch.float32, torch.bfloat16) \
            or not vals.is_contiguous():
        if not vals.is_floating_point():
            raise TypeError(f"vals must be floating, got {vals.dtype}")
        vals = vals.float().contiguous()
        segment_sum.staged += 1
    perm, off = perm.contiguous(), off.contiguous()
    C, n = vals.shape[1], vals.shape[0]
    out = torch.empty((size, C), dtype=torch.float32, device=vals.device)
    if size * C == 0:
        return out
    lib = build() if lib is None else lib
    dev = vals.device
    # the long rows' count and list (at most n / (LONG + 1) of them)
    scratch = torch.zeros((2 + n // (LONG + 1),), dtype=torch.int32,
                          device=dev)
    args = (vals.data_ptr(), int(vals.dtype is torch.bfloat16),
            perm.data_ptr(), off.data_ptr(), C, size, n, scratch.data_ptr(),
            out.data_ptr())
    # the launch goes to the runtime's current device: switch only when
    # the tensors lie on another
    if dev.index == torch.cuda.current_device():
        err = lib.mvedit_segment_sum(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = lib.mvedit_segment_sum(
                *args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {err}")
    return out


def segment_sum(idx, vals, size):
    """idx (N,) int targets, vals (N, C) float -> (size, C) float32, each
    row summed in the contributions' order (see module doc)."""
    if idx.dim() != 1 or vals.dim() != 2 or vals.shape[0] != idx.shape[0]:
        raise ValueError(f"bad shapes: idx {tuple(idx.shape)}, vals "
                         f"{tuple(vals.shape)}")
    if vals.device.type == "cpu":
        return segment_sum_reference(idx, vals, size)
    out = launch(vals, *segment_order(idx, size), size)
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
segment_sum.staged = 0
