"""Fixed-order segment sum: the hand-written Hopper kernel and its plain
PyTorch versions.

`segment_sum(idx, vals, size)` -> (size, C) float32, row r the sum of the
rows of `vals` (N, C) whose target `idx` (N,) is r; targets outside
[0, size) are dropped. It is the accumulation behind the port's row
gathers' gradients and its vertex sums (`ops/segment.py`), written so that
one seed gives one result on the card: `index_add` there adds atomically,
in whatever order the adds arrive.

- `segment_order(idx, size)` -> (perm (N,), off (size + 1,)), both int32:
  the contributions sorted by target row, stable, so row r's are
  perm[off[r]:off[r + 1]] in their original order; dropped targets take
  the key `size` and sort past off[size]. On the card one C call runs
  `csrc/segment_sum.cu`'s ordering: the keys, CUB's stable radix sort over
  the row bits only (bit_length(size) of them) and the offsets written
  from the sorted keys; on the CPU a stable `torch.sort` of the keys and
  `searchsorted` for the offsets (a stable sort's permutation is unique,
  so both give the same perm and off).
- CUDA tensors launch the sums of `csrc/segment_sum.cu` (sm_90a) on that
  order, `LIBRARY` (built and bound by `library.py` at first use): one
  thread per (row, channel) adds a row of at most `LONG`
  contributions in order in float32; one warp a row of at most `WARP`
  (32 strided partials, then a fixed tree); a longer row (a render's
  background pixels all gather one dummy face; retex's background points
  all fall on one grid cell) is cut into slices of `SLICE` contributions,
  each summed by one CTA as `BLOCK` strided partials and a fixed tree, and
  its slices' partials are added the same way. The output is
  float32 or, with `out_dtype=torch.bfloat16`, the float32 sum rounded
  once. A build or launch failure raises; nothing falls back.
- CPU tensors take `segment_sum_reference`, a float32 `index_add` into
  zeros, which on the CPU adds in order: the kernel's bits for rows of at
  most `LONG`. On the card the plain version is atomic.
- `segment_sum_ordered` is the kernel's order in plain PyTorch on any
  device (the warps' and slices' strided partials and trees included): the
  kernel's bits on every row. `rounding_bound` is how far that order may
  lie from the exact sum (checked against a float64 sum).

`segment_sum.launches` counts the sum kernels' launches (one per call)
and `segment_sum.staged` the calls whose inputs were copied first (values
neither float32 nor bfloat16, or not contiguous, or bf16 rows of 8 off a
16-byte boundary; targets neither int64 nor int32; 0 on the paths). The
targets are read with their stride (a column of the mesh's faces).
"""
import ctypes

import torch

from .library import Library, nvcc, on_stream

__all__ = ["segment_sum", "segment_sum_reference", "segment_sum_ordered",
           "segment_order", "launch", "rounding_bound", "LIBRARY", "LONG",
           "WARP", "SLICE", "BLOCK"]

LONG = 64             # rows summed in order by one thread (csrc kLong)
WARP = 1024           # rows summed by one warp (csrc kWarp)
SLICE = 8192          # longer rows: contributions per slice CTA (kSlice)
BLOCK = 256           # a slice CTA's threads, its partial sums (kBlock)


def _bits(size):
    """The key bits of targets in [0, size] (`size` = dropped)."""
    return max(1, int(size).bit_length())


def _check(n, size):
    if size >= 2 ** 31 - 1 or n >= 2 ** 31 - 1:
        raise ValueError(f"too many rows ({size}) or contributions ({n}) "
                         f"for int32 ids")


def _keys(idx, size):
    _check(idx.shape[0], size)
    return torch.where((idx >= 0) & (idx < size), idx,
                       torch.full_like(idx, size)).int()


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


def _plain_order(idx, size):
    """`segment_order` in plain PyTorch: a stable sort of the keys in
    [0, size] and the offsets of every row by `searchsorted`."""
    key = _keys(idx, size)
    sk, perm = torch.sort(key, stable=True)
    rows = torch.arange(size + 1, dtype=torch.int32, device=key.device)
    off = torch.searchsorted(sk, rows, out_int32=True)
    return perm.int(), off


def _tree(part):
    """The kernel's fixed tree over the partials' dim 1 (a power of two):
    part[t] += part[t + w] for w = half, ..., 1."""
    while part.shape[1] > 1:
        w = part.shape[1] // 2
        part = part[:, :w] + part[:, w:]
    return part[:, 0]


def _strided(x):
    """(rows, k, lanes, C) -> (rows, C): lane t adds x[:, 0, t],
    x[:, 1, t], ... in order, then the tree over the lanes. A padded +0
    keeps the bits (a sum that starts at +0 is never -0)."""
    part = torch.zeros_like(x[:, 0])
    for k in range(x.shape[1]):
        part = part + x[:, k]
    return _tree(part)


def _padded(v, start, cnt, rows, width):
    """(len(rows), width, C): the entries of `rows` in order, +0 past
    each row's end."""
    p = torch.arange(width, device=v.device)
    src = start[rows][:, None] + p
    ok = p < cnt[rows][:, None]
    return torch.where(ok[..., None], v[src.clamp(max=v.shape[0] - 1)],
                       torch.zeros((), device=v.device))


def _batches(rows, cnt, unit, C, budget):
    """`rows` by length, in batches whose padding to a multiple of `unit`
    holds at most `budget` elements: yields (rows, padded length)."""
    rows = rows[torch.argsort(cnt[rows])]
    lens = cnt[rows].tolist()
    i = 0
    while i < len(lens):
        j = i + 1
        while j < len(lens) and (j + 1 - i) * (
                -(-lens[j] // unit) * unit) * C <= budget:
            j += 1
        yield rows[i:j], -(-lens[j - 1] // unit) * unit
        i = j


def segment_sum_ordered(idx, vals, size, budget=1 << 26):
    """The kernel's order in plain PyTorch, on any device: float32 adds,
    which round alike everywhere, so the result has the kernel's bits. A
    row of at most `LONG` is added one contribution after another (all
    rows' k-th contributions in one step). A row of at most `WARP`: lane
    t of 32 adds entries t, t + 32, ... in order, then the tree over the
    lanes. A longer row is cut into slices of `SLICE` from its start;
    slice s's partial t adds entries t, t + BLOCK, ... of the slice in
    order, then the tree; then partial t adds slices t, t + BLOCK, ... in
    order, then the tree. `budget` caps the elements of one padded batch
    of rows."""
    perm, off = _plain_order(idx, size)
    perm, off = perm.long(), off.long()
    C, dev = vals.shape[1], vals.device
    out = torch.zeros((size, C), dtype=torch.float32, device=dev)
    kept = int(off[-1])
    if kept == 0:
        return out
    v = vals.float()[perm[:kept]]                  # by row, in order
    start, cnt = off[:-1], off[1:] - off[:-1]
    row = torch.repeat_interleave(torch.arange(size, device=dev), cnt,
                                  output_size=kept)
    pos = torch.arange(kept, device=dev) - start[row]
    short = cnt[row] <= LONG
    if bool(short.any()):
        ps, order = torch.sort(pos[short], stable=True)
        rs, vs = row[short][order], v[short][order]
        begin = 0
        # position k of every short row at once; rows are distinct in a
        # step, so the indexed add is exact
        for c in torch.bincount(ps).tolist():
            r = rs[begin:begin + c]
            out[r] = out[r] + vs[begin:begin + c]
            begin += c
    mid = torch.nonzero((cnt > LONG) & (cnt <= WARP))[:, 0]
    for rows, width in _batches(mid, cnt, 32, C, budget):
        x = _padded(v, start, cnt, rows, width)
        out[rows] = _strided(x.view(len(rows), width // 32, 32, C))
    longs = torch.nonzero(cnt > WARP)[:, 0]
    for rows, width in _batches(longs, cnt, SLICE, C, budget):
        q = width // SLICE
        x = _padded(v, start, cnt, rows, width)
        # (rows x slices, entries per partial, BLOCK, C) -> slice sums
        x = x.view(len(rows) * q, SLICE // BLOCK, BLOCK, C)
        part = _strided(x).view(len(rows), q, C)
        qq = -(-q // BLOCK)
        part = torch.cat([part, part.new_zeros(
            (len(rows), qq * BLOCK - q, C))], 1)
        out[rows] = _strided(part.view(len(rows), qq, BLOCK, C))
    return out


def rounding_bound(idx, vals, size):
    """(size, C) float64: how far the kernel's float32 sum of each row
    may lie from the exact sum, k u sum|x| (u = 2^-24), plus the rounding
    of a float64 reference sum (n 2^-53 sum|x|). k is the most adds on one
    term's way to the row's sum: k = n for a row of n <= `LONG` (added in
    order); ceil(n / 32) + 5 for n <= `WARP` (a lane, then the warp's
    tree); for a longer row of q = ceil(n / SLICE) slices, k =
    ceil(min(n, SLICE) / BLOCK) + log2(BLOCK) (a partial in the slice,
    then the tree) + ceil(q / BLOCK) + log2(BLOCK) (the slices' partial,
    then the tree)."""
    mag = segment_sum_reference(idx, vals.abs(), size, torch.float64)
    n = segment_sum_reference(idx, torch.ones_like(vals[:, :1]), size,
                              torch.float64)
    depth = BLOCK.bit_length() - 1
    q = torch.ceil(n / SLICE)
    k_long = (torch.ceil(torch.clamp(n, max=SLICE) / BLOCK) + depth
              + torch.ceil(q / BLOCK) + depth)
    k = torch.where(n <= LONG, n, torch.where(
        n <= WARP, torch.ceil(n / 32) + 5, k_long))
    return (k * 2.0 ** -24 + n * 2.0 ** -53) * mag


def _bind(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mvedit_segment_order_temp_bytes.argtypes = [ll, i]
    lib.mvedit_segment_order_temp_bytes.restype = ll
    lib.mvedit_segment_order.argtypes = [p, i, ll, ll, i, i, p, p, ll, p,
                                         ctypes.POINTER(i), p]
    lib.mvedit_segment_order.restype = i
    lib.mvedit_segment_sum_scratch_bytes.argtypes = [ll, i]
    lib.mvedit_segment_sum_scratch_bytes.restype = ll
    lib.mvedit_segment_sum.argtypes = [p, i, p, p, i, i, ll, p, p, i, p]
    lib.mvedit_segment_sum.restype = i
    lib.mvedit_segment_sum_targets_bytes.argtypes = [
        ll, i, i, i, ctypes.POINTER(ll)]
    lib.mvedit_segment_sum_targets_bytes.restype = ll
    lib.mvedit_segment_sum_targets.argtypes = [p, i, ll, p, i, i, i, ll, i,
                                               p, ll, p, i, p]
    lib.mvedit_segment_sum_targets.restype = i
    lib.workspace = {}


# -fmad=false, as the raster and dense-grid kernels: no multiply and add
# ever fuse, so the sums stay the separate float32 adds that
# `segment_sum_ordered` makes
LIBRARY = Library("segment_sum", "segment_sum.cu", nvcc("-fmad=false"),
                  _bind)


def _order_launch(idx, size, lib):
    dev, n = idx.device, idx.shape[0]
    _check(n, size)
    idx = _targets(idx)
    bits = _bits(size)
    temp = lib.mvedit_segment_order_temp_bytes(n, bits)
    if temp < 0:
        raise RuntimeError("segment_order: CUB's temporary size query "
                           "failed")
    # [keys, permutation] x [buffer 0, buffer 1], then CUB's temporary
    pairs = 16 * n + 255 & ~255
    ws = torch.empty((pairs + max(temp, 1),), dtype=torch.uint8, device=dev)
    off = torch.empty((size + 1,), dtype=torch.int32, device=dev)
    sel = ctypes.c_int(0)
    err = on_stream(dev, lib.mvedit_segment_order, idx.data_ptr(),
                    int(idx.dtype is torch.int64), idx.stride(0), n, size,
                    bits, ws.data_ptr(), ws.data_ptr() + pairs, temp,
                    off.data_ptr(), ctypes.byref(sel))
    if err != 0:
        raise RuntimeError(f"segment_order launch failed: CUDA error {err}")
    perm = ws[4 * n * (2 + sel.value):4 * n * (3 + sel.value)]
    return perm.view(torch.int32), off


def segment_order(idx, size):
    """(perm (N,) int32, off (size + 1,) int32) of the targets `idx` (N,)
    (see the module doc): the kernel's ordering on the card,
    a stable `torch.sort` on the CPU."""
    if idx.dim() != 1:
        raise ValueError(f"idx must be 1-D, got {tuple(idx.shape)}")
    if idx.device.type == "cpu":
        return _plain_order(idx, size)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    return _order_launch(idx, size, LIBRARY.load())


def launch(vals, perm, off, size, out_dtype=torch.float32, lib=None):
    """The sum kernels on CUDA tensors in the order of `segment_order`;
    returns (size, C) in `out_dtype` (float32 or bfloat16, the float32 sum
    rounded once). Counts staged inputs, not launches."""
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    if vals.dim() != 2 or perm.dim() != 1 or off.shape != (size + 1,) \
            or perm.shape[0] != vals.shape[0]:
        raise ValueError(f"bad shapes: vals {tuple(vals.shape)}, perm "
                         f"{tuple(perm.shape)}, off {tuple(off.shape)}, "
                         f"size {size}")
    if any(x.device != vals.device for x in (perm, off)):
        raise ValueError("all inputs must be on one device")
    if perm.dtype is not torch.int32 or off.dtype is not torch.int32:
        raise TypeError("perm and off must be int32")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    C, n = vals.shape[1], vals.shape[0]
    vals = _values(vals)
    perm, off = perm.contiguous(), off.contiguous()
    out = torch.empty((size, C), dtype=out_dtype, device=vals.device)
    if size * C == 0:
        return out
    lib = LIBRARY.load() if lib is None else lib
    dev = vals.device
    scratch = torch.empty((lib.mvedit_segment_sum_scratch_bytes(n, C),),
                          dtype=torch.uint8, device=dev)
    err = on_stream(dev, lib.mvedit_segment_sum, vals.data_ptr(),
                    int(vals.dtype is torch.bfloat16), perm.data_ptr(),
                    off.data_ptr(), C, size, n, scratch.data_ptr(),
                    out.data_ptr(), int(out_dtype is torch.bfloat16))
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {err}")
    return out


def _targets(idx):
    """The targets as the kernel reads them: int64 or int32, any stride."""
    if idx.dtype in (torch.int64, torch.int32):
        return idx
    segment_sum.staged += 1
    return idx.long()


def _values(vals):
    """The values as the kernel reads them: float32 or bf16, contiguous,
    bf16 rows of 8 on a 16-byte boundary (its 16-byte loads)."""
    if vals.dtype in (torch.float32, torch.bfloat16) \
            and vals.is_contiguous() and not (
                vals.dtype is torch.bfloat16 and vals.shape[1] == 8
                and vals.data_ptr() % 16):
        return vals
    if not vals.is_floating_point():
        raise TypeError(f"vals must be floating, got {vals.dtype}")
    segment_sum.staged += 1
    return vals.float().contiguous()


def segment_sum(idx, vals, size, out_dtype=torch.float32):
    """idx (N,) int targets, vals (N, C) float -> (size, C), each row
    summed in float32 in the kernel's fixed order (see module doc), in
    `out_dtype` (the float32 sum rounded once). On the card one C call
    orders the targets and sums."""
    if idx.dim() != 1 or vals.dim() != 2 or vals.shape[0] != idx.shape[0]:
        raise ValueError(f"bad shapes: idx {tuple(idx.shape)}, vals "
                         f"{tuple(vals.shape)}")
    if vals.device.type == "cpu":
        return segment_sum_reference(idx, vals, size).to(out_dtype)
    if vals.device.type != "cuda" or idx.device != vals.device:
        raise ValueError(f"unsupported devices {idx.device}, {vals.device}")
    n, C = vals.shape
    _check(n, size)
    lib = LIBRARY.load()
    direct = out_dtype in (torch.float32, torch.bfloat16)
    out = torch.empty((size, C), dtype=out_dtype if direct else
                      torch.float32, device=vals.device)
    if size * C == 0:
        return out.to(out_dtype)
    idx, vals = _targets(idx), _values(vals)
    bits = _bits(size)
    key = (n, size, C)
    if key not in lib.workspace:
        if len(lib.workspace) > 256:
            lib.workspace.clear()
        temp = ctypes.c_longlong(0)
        total = lib.mvedit_segment_sum_targets_bytes(n, size, C, bits,
                                                     ctypes.byref(temp))
        if total < 0:
            raise RuntimeError("segment_sum: CUB's temporary size query "
                               "failed")
        lib.workspace[key] = (total, temp.value)
    total, temp = lib.workspace[key]
    ws = torch.empty((total,), dtype=torch.uint8, device=vals.device)
    err = on_stream(vals.device, lib.mvedit_segment_sum_targets,
                    idx.data_ptr(), int(idx.dtype is torch.int64),
                    idx.stride(0), vals.data_ptr(),
                    int(vals.dtype is torch.bfloat16), C, size, n, bits,
                    ws.data_ptr(), temp, out.data_ptr(),
                    int(out.dtype is torch.bfloat16))
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {err}")
    segment_sum.launches += 1
    return out if direct else out.to(out_dtype)


segment_sum.launches = 0
segment_sum.staged = 0
