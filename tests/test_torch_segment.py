"""The fixed-order segment sum (`kernels/segment_sum.py`) and the ops built
on it (`ops/segment.py`), on the CPU.

The kernel sums a row of at most `LONG` contributions one after another
in the order of a stable sort of the targets, a row of at most `WARP` by
one warp (32 strided partials, a fixed tree), and a longer row in slices
of `SLICE` (strided partials and a fixed tree in each, then the slices'
partials the same way). On the CPU the wrapper takes the plain version, a
float32 `index_add` into zeros, which adds in order; these tests hold the
descriptions to each other exactly:
- the plain version against `index_add`, dropped targets included;
- `segment_order` (on the CPU the plain ordering, which the card's CUB
  sort over the row bits is held to by the gpu tests) against
  `torch.sort(stable=True)` of the int32 keys, at sizes whose bit_length
  is 1, 16, 17 and 22: int32, dropped targets past the last row, equal
  permutation and offsets;
- its permutation and offsets against a sequential, row-by-row float32 sum
  (what the kernel computes for rows of at most `LONG`): equal bits;
- `segment_sum_ordered` (the kernel's order in plain PyTorch, what the
  card's checks require equal bits to): the plain version's bits on rows
  of at most `LONG`; a longer row's warp or slice order emulated here
  entry by entry in numpy float32, equal bits at rows of `LONG`, `LONG +
  1`, `WARP`, `WARP + 1`, `SLICE`, `SLICE + 1` and 3 `SLICE` + 1; every
  row within
  `rounding_bound` of a float64 sum, a bound tight enough that a slice
  dropped or counted twice, a partial lost, a tree stopped early or half
  a row dropped falls outside it;
- `segment_add` and `gather_rows`' backward against the JAX package's
  `segment_add` and `jax.grad` of a `jnp.take`, on one row longer than a
  slice: JAX's CPU scatter adds in order, so the port's CPU bits equal
  JAX's; the kernel's order and JAX's each within their order's rounding
  of a float64 sum;
- `gather_rows`' backward (a segment sum rounded once to the table's
  dtype) and `segment_add`'s (a gather) against autograd of `index_select`
  / `index_add` in float32;
- the mesh fit's normal-consistency and Laplacian sums, now one
  `segment_add` each, against the sequential `index_add`s they replace:
  equal values and gradients;
- the bare `launch` refuses tensors off the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from mvedit_tpu.ops import segment as jax_segment

from mvedit_tpu_torch.kernels import segment_sum as KS
from mvedit_tpu_torch.models import mesh_fit as MF
from mvedit_tpu_torch.ops.segment import gather_rows, segment_add


def _data(seed, N=500, size=37, C=5, drop=True):
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, size + (3 if drop else 0), (N,), generator=g)
    if drop:
        idx[::17] = -1
    vals = torch.randn((N, C), generator=g)
    return idx, vals, size


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_version_is_index_add(seed):
    idx, vals, size = _data(seed)
    keep = (idx >= 0) & (idx < size)
    ref = torch.zeros((size, vals.shape[1])).index_add_(0, idx[keep],
                                                        vals[keep])
    out = KS.segment_sum(idx, vals, size)
    assert out.dtype == torch.float32
    assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_order_gives_the_kernels_sums(dtype):
    """Row r = the float32 sum of vals[perm[off[r]:off[r + 1]]] in order,
    as the kernel adds them: the same bits as the plain version."""
    idx, vals, size = _data(2, N=800, size=23, C=3)
    vals = vals.to(dtype)
    perm, off = KS.segment_order(idx, size)
    assert perm.dtype == off.dtype == torch.int32
    assert off.shape == (size + 1,) and int(off[0]) == 0
    perm = perm.long()
    ks = idx[perm]
    # stable: within a row the original order
    for r in range(size):
        rows = perm[off[r]:off[r + 1]]
        assert torch.equal(ks[off[r]:off[r + 1]], torch.full_like(rows, r))
        assert bool((rows[1:] > rows[:-1]).all())
    out = torch.zeros((size, 3), dtype=torch.float32)
    for r in range(size):
        acc = torch.zeros(3, dtype=torch.float32)
        for j in range(int(off[r]), int(off[r + 1])):
            acc = acc + vals[perm[j]].float()
        out[r] = acc
    assert torch.equal(out, KS.segment_sum_reference(idx, vals, size))
    # the dropped targets sort past the last row
    assert int((~((idx >= 0) & (idx < size))).sum()) == \
        idx.shape[0] - int(off[size])


@pytest.mark.parametrize("size", [1, 40000, 100000, 161 ** 3])
def test_order_matches_a_stable_sort(size):
    """bit_length(size) = 1, 16, 17, 22: `segment_order` keys dropped
    targets `size` and gives `torch.sort(stable=True)`'s permutation of
    the int32 keys and its offsets, as int32 (the gpu test holds CUB's
    sort over the row bits only to the same)."""
    assert {1: 1, 40000: 16, 100000: 17, 161 ** 3: 22}[size] == \
        size.bit_length()
    g = torch.Generator().manual_seed(size % 1009)
    n = 20000
    idx = torch.randint(0, size, (n,), generator=g)
    # dropped targets: negative, the mask convention (== size), beyond
    drop = torch.rand((n,), generator=g)
    idx = torch.where(drop < 0.05, torch.full_like(idx, -1), idx)
    idx = torch.where((drop >= 0.05) & (drop < 0.1),
                      torch.full_like(idx, size), idx)
    idx = torch.where((drop >= 0.1) & (drop < 0.12), idx + size + 7, idx)
    # a few rows with many contributions, so that runs of one key occur
    idx = torch.where(drop > 0.9, idx % 5, idx)
    perm, off = KS.segment_order(idx, size)
    assert perm.dtype == off.dtype == torch.int32
    key = torch.where((idx >= 0) & (idx < size), idx,
                      torch.full_like(idx, size)).int()
    skey, want = torch.sort(key, stable=True)
    assert torch.equal(perm.long(), want)
    want_off = torch.searchsorted(skey, torch.arange(
        size + 1, dtype=torch.int32))
    assert torch.equal(off.long(), want_off)


def _long_row(seed=3, n=5000, C=2):
    g = torch.Generator().manual_seed(seed)
    idx = torch.where(torch.rand((n,), generator=g) < 0.6,
                      torch.zeros((n,), dtype=torch.int64),
                      torch.randint(0, 9, (n,), generator=g))
    vals = torch.randn((n, C), generator=g) * 10
    return idx, vals, 9


def _tree(lanes, stop=1):
    w = lanes.shape[0] // 2
    while w >= stop:
        lanes[:w] = lanes[:w] + lanes[w:2 * w]
        w //= 2
    return lanes[0]


def _kernel_row(row, skip_lane=None, slice_tree_stop=1, skip_slice=None,
                twice_slice=None, finish_tree_stop=1):
    """A row (n, C) in its sorted order as the kernel sums it, entry by
    entry in numpy float32: in order for n <= LONG; for n <= WARP lane
    j % 32 adds entry j in order, then the tree over 32 lanes; else per
    slice of SLICE entries, lane j % BLOCK adds entry j in order, then the
    tree; then lane s % BLOCK adds slice s's sum in order, then the tree.
    The keywords break the slice tier: a lane of every slice lost, a
    slice's tree stopped early, a slice dropped or counted twice, the
    last tree stopped early."""
    row = np.asarray(row, np.float32)
    n, C = row.shape
    if n <= KS.LONG:
        acc = np.zeros(C, np.float32)
        for x in row:
            acc = acc + x
        return acc
    if n <= KS.WARP:
        lanes = np.zeros((32, C), np.float32)
        for j, x in enumerate(row):
            lanes[j % 32] = lanes[j % 32] + x
        return _tree(lanes)
    sums = []
    for s0 in range(0, n, KS.SLICE):
        lanes = np.zeros((KS.BLOCK, C), np.float32)
        for j, x in enumerate(row[s0:s0 + KS.SLICE]):
            if j % KS.BLOCK != skip_lane:
                lanes[j % KS.BLOCK] = lanes[j % KS.BLOCK] + x
        sums.append(_tree(lanes, slice_tree_stop))
    if skip_slice is not None:
        sums[skip_slice] = np.zeros(C, np.float32)
    if twice_slice is not None:
        sums.append(sums[twice_slice])
    lanes = np.zeros((KS.BLOCK, C), np.float32)
    for s, x in enumerate(sums):
        lanes[s % KS.BLOCK] = lanes[s % KS.BLOCK] + x
    return _tree(lanes, finish_tree_stop)


@pytest.mark.parametrize("length", [
    KS.LONG, KS.LONG + 1, KS.WARP, KS.WARP + 1, KS.SLICE, KS.SLICE + 1,
    3 * KS.SLICE + 1])
def test_ordered_sum_at_the_slice_edges(length):
    """Row 0 of `length` contributions (among short rows and dropped
    targets): `segment_sum_ordered` has the entry-by-entry emulation's
    bits there and the plain version's on the short rows."""
    g = torch.Generator().manual_seed(length)
    n_other = 3000
    other = torch.randint(1, 400, (n_other,), generator=g)
    other[::13] = 400                                 # dropped
    idx = torch.cat([torch.zeros(length, dtype=torch.int64), other])
    idx = idx[torch.randperm(idx.shape[0], generator=g)]
    vals = torch.randn((idx.shape[0], 3), generator=g)
    out = KS.segment_sum_ordered(idx, vals, 400, budget=1 << 14)
    row = vals[idx == 0].numpy()                      # in their order
    assert row.shape[0] == length
    assert np.array_equal(out[0].numpy(), _kernel_row(row))
    ref = KS.segment_sum_reference(idx, vals, 400)
    assert int(torch.bincount(other[other < 400]).max()) <= KS.LONG
    assert torch.equal(out[1:], ref[1:])
    if length <= KS.LONG:
        assert torch.equal(out[0], ref[0])
    exact = KS.segment_sum_reference(idx, vals, 400, torch.float64)
    assert bool(((out.double() - exact).abs()
                 <= KS.rounding_bound(idx, vals, 400)).all())


def test_long_row_order_within_rounding():
    """A row of two slices: `segment_sum_ordered`'s bits are the
    emulation's, within `rounding_bound` of a float64 sum, and another
    order than the plain version's."""
    idx, vals, size = _long_row(n=16000)
    perm, off = KS.segment_order(idx, size)
    row = vals[perm[off[0]:off[1]].long()]
    assert KS.SLICE < row.shape[0] <= 2 * KS.SLICE
    part = torch.from_numpy(_kernel_row(row))
    assert torch.equal(part, KS.segment_sum_ordered(idx, vals, size)[0])
    exact = KS.segment_sum_reference(idx, vals, size, torch.float64)
    bound = KS.rounding_bound(idx, vals, size)
    assert bool(((part.double() - exact[0]).abs() <= bound[0]).all())
    ref = KS.segment_sum_reference(idx, vals, size)
    assert not torch.equal(part, ref[0])          # another order indeed


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pile", [0.0, 0.5])
def test_ordered_sum_is_the_plain_sum_on_short_rows(dtype, pile):
    """Rows of at most `LONG`: `segment_sum_ordered` has the bits of the
    sequential `index_add`; every row (a long one with `pile`) lies within
    `rounding_bound` of the float64 sum."""
    g = torch.Generator().manual_seed(11)
    n, size = 6000, 400
    idx = torch.randint(-2, size + 2, (n,), generator=g)
    idx = torch.where(torch.rand((n,), generator=g) < pile,
                      torch.zeros_like(idx), idx)
    vals = torch.randn((n, 3), generator=g).to(dtype)
    out = KS.segment_sum_ordered(idx, vals, size, budget=1 << 12)
    ref = KS.segment_sum_reference(idx, vals, size)
    _, off = KS.segment_order(idx, size)
    short = (off[1:] - off[:-1]) <= KS.LONG
    assert bool(short[1:].all()) and bool(short[0]) == (pile == 0.0)
    assert torch.equal(out[short], ref[short])
    exact = KS.segment_sum_reference(idx, vals, size, torch.float64)
    assert bool(((out.double() - exact).abs()
                 <= KS.rounding_bound(idx, vals, size)).all())


@pytest.mark.parametrize("fault", ["one_partial", "short_tree", "half_row",
                                   "slice_dropped", "slice_twice",
                                   "last_tree_short"])
def test_rounding_bound_catches_a_broken_block_sum(fault):
    """The check the card holds the slice kernels to: a long row's sum
    that loses one partial (one lane of every slice), stops a slice's tree
    a level early, drops half the row, drops a slice, counts a slice
    twice, or stops the slices' tree a level early lies outside
    `rounding_bound` of the float64 sum."""
    idx, vals, size = _long_row(seed=5, n=80000, C=3)
    vals = vals / 10
    perm, off = KS.segment_order(idx, size)
    row = vals[perm[off[0]:off[1]].long()].numpy()
    assert row.shape[0] > 5 * KS.SLICE
    bad = {"one_partial": lambda: _kernel_row(row, skip_lane=37),
           "short_tree": lambda: _kernel_row(row, slice_tree_stop=2),
           "half_row": lambda: _kernel_row(row[: row.shape[0] // 2]),
           "slice_dropped": lambda: _kernel_row(row, skip_slice=3),
           "slice_twice": lambda: _kernel_row(row, twice_slice=3),
           "last_tree_short": lambda: _kernel_row(row, finish_tree_stop=2),
           }[fault]()
    exact = KS.segment_sum_reference(idx, vals, size, torch.float64)[0]
    bound = KS.rounding_bound(idx, vals, size)[0].numpy()
    good = _kernel_row(row)
    assert np.array_equal(good, KS.segment_sum_ordered(idx, vals,
                                                       size)[0].numpy())
    assert bool((np.abs(good - exact.numpy()) <= bound).all())
    assert bool((np.abs(bad.astype(np.float64) - exact.numpy())
                 > bound).any())


def _in_order(idx, vals, size):
    """The float32 sum of each row added in order (numpy's float32
    `cumsum`, which adds one term after another) and that order's running
    error bound: u / (1 - u) sum_k |s_k| over its partial sums s_k, plus
    n 2^-53 sum|x| for the float64 reference. For a long row of random
    signs this is far below the (n - 1) u sum|x| of an arbitrary order."""
    idx, vals = idx.numpy(), vals.numpy()
    out = np.zeros((size, vals.shape[1]), np.float32)
    bound = np.zeros((size, vals.shape[1]))
    u = 2.0 ** -24
    for r in range(size):
        row = vals[idx == r]
        if row.shape[0] == 0:
            continue
        part = np.cumsum(row, axis=0, dtype=np.float32)
        out[r] = part[-1]
        bound[r] = (u / (1 - u) * np.abs(part.astype(np.float64)).sum(0)
                    + row.shape[0] * 2.0 ** -53
                    * np.abs(row.astype(np.float64)).sum(0))
    return out, bound


@pytest.mark.parametrize("C", [3, 8])
def test_segment_sums_match_jax(C):
    """`segment_add` and `gather_rows`' backward against the JAX package's
    `segment_add` and `jax.grad` of a `jnp.take`, on the same numpy
    inputs, with row 0 longer than one slice and dropped targets (==
    size). XLA does not document the order of a scatter's adds; on the
    CPU it adds in order, which the test asserts (JAX's bits equal an
    in-order float32 sum, and so the port's CPU `segment_add`, a float32
    `index_add`). JAX is then held to the float64 sum by that order's
    running error bound (`_in_order`), the kernel's order
    (`segment_sum_ordered`) by `rounding_bound`, and the two to each
    other by the sum of the two bounds."""
    rng = np.random.default_rng(C)
    n, size = 20000, 50
    idx = rng.integers(0, size + 1, n).astype(np.int32)
    idx[rng.random(n) < 0.6] = 0
    assert (idx == 0).sum() > KS.SLICE
    vals = rng.standard_normal((n, C)).astype(np.float32)
    ti, tv = torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(vals)
    exact = KS.segment_sum_reference(ti, tv, size, torch.float64).numpy()
    bound = KS.rounding_bound(ti, tv, size).numpy()
    seq, seq_bound = _in_order(ti, tv, size)
    want = np.asarray(jax_segment.segment_add(jnp.asarray(idx),
                                              jnp.asarray(vals), size))
    assert np.array_equal(want, seq)
    assert (np.abs(want - exact) <= seq_bound).all()
    assert np.array_equal(segment_add(ti, tv, size).numpy(), want)
    got = KS.segment_sum_ordered(ti, tv, size).numpy()
    assert (np.abs(got - exact) <= bound).all()
    assert (np.abs(got - want) <= bound + seq_bound).all()
    # gather_rows' backward: the gradient of sum(x[idx] * w) in x
    keep = idx < size
    gi, w = idx[keep], vals[keep]
    table = rng.standard_normal((size, C)).astype(np.float32)
    jgrad = np.asarray(jax.grad(lambda x: jnp.sum(
        jnp.take(x, jnp.asarray(gi), axis=0) * jnp.asarray(w)))(
            jnp.asarray(table)))
    x = torch.from_numpy(table.copy()).requires_grad_(True)
    (gather_rows(x, torch.from_numpy(gi.astype(np.int64)))
     * torch.from_numpy(w)).sum().backward()
    tgi = torch.from_numpy(gi.astype(np.int64))
    tw = torch.from_numpy(w)
    gexact = KS.segment_sum_reference(tgi, tw, size, torch.float64).numpy()
    gseq, gseq_bound = _in_order(tgi, tw, size)
    assert np.array_equal(jgrad, gseq)
    assert (np.abs(jgrad - gexact) <= gseq_bound).all()
    assert np.array_equal(x.grad.numpy(), jgrad)
    gord = KS.segment_sum_ordered(tgi, tw, size).numpy()
    assert (np.abs(gord - gexact)
            <= KS.rounding_bound(tgi, tw, size).numpy()).all()
    assert (np.abs(gord - jgrad)
            <= KS.rounding_bound(tgi, tw, size).numpy() + gseq_bound).all()


def test_gather_rows_backward():
    g = torch.Generator().manual_seed(3)
    table = torch.randn((40, 6), generator=g, requires_grad=True)
    idx = torch.randint(0, 40, (300, 2), generator=g)
    w = torch.randn((300, 2, 6), generator=g)
    (gather_rows(table, idx) * w).sum().backward()
    ref_t = table.detach().clone().requires_grad_(True)
    (ref_t[idx] * w).sum().backward()
    assert torch.equal(table.grad, ref_t.grad)
    # a bf16 table: its gradient summed in float32, cast once
    tb = table.detach().bfloat16().requires_grad_(True)
    (gather_rows(tb, idx).float() * w).sum().backward()
    gb = (w.bfloat16()).reshape(-1, 6)
    want = torch.zeros((40, 6)).index_add_(0, idx.reshape(-1), gb.float())
    assert tb.grad.dtype == torch.bfloat16
    assert torch.equal(tb.grad, want.bfloat16())


def test_segment_add_backward():
    idx, vals, size = _data(4, N=200, size=19, C=4)
    v1 = vals.clone().requires_grad_(True)
    w = torch.randn((size, 4), generator=torch.Generator().manual_seed(5))
    (segment_add(idx, v1, size) * w).sum().backward()
    keep = (idx >= 0) & (idx < size)
    want = torch.where(keep[:, None], w[idx.clamp(0, size - 1)],
                       torch.zeros(()))
    assert torch.equal(v1.grad, want)


def _mesh(seed=6, V=60, F=90):
    g = torch.Generator().manual_seed(seed)
    verts = torch.randn((V, 3), generator=g)
    # three distinct corners per face: a degenerate face's 1e10-scaled
    # normal gradient would make any two summation orders disagree
    faces = torch.rand((F, V), generator=g).argsort(1)[:, :3]
    fmask = torch.rand((F,), generator=g) > 0.2
    return verts, faces, fmask


def _normal_consistency_index_add(verts, faces, face_mask):
    faces = faces.long()
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    fn = fn * torch.rsqrt((fn * fn).sum(-1, keepdim=True) + 1e-20)
    w = face_mask.to(verts.dtype)
    vsum = torch.zeros_like(verts)
    deg = torch.zeros(verts.shape[0])
    for i in range(3):
        vsum = vsum.index_add(0, faces[:, i], fn * w[:, None])
        deg = deg.index_add(0, faces[:, i], w)
    vn = vsum / deg[:, None].clamp(min=1.0)
    vn = vn * torch.rsqrt((vn * vn).sum(-1, keepdim=True) + 1e-20)
    cos = sum((fn * vn[faces[:, i]]).sum(-1) for i in range(3)) / 3
    return ((1.0 - cos) * w).sum() / w.sum().clamp(min=1.0)


def _laplacian_index_add(verts, faces, face_mask, vert_mask):
    faces = faces.long()
    w = face_mask.to(verts.dtype)
    nsum = torch.zeros_like(verts)
    deg = torch.zeros(verts.shape[0])
    for a, b in ((0, 1), (1, 2), (2, 0)):
        ia, ib = faces[:, a], faces[:, b]
        nsum = nsum.index_add(0, ia, verts[ib] * w[:, None])
        nsum = nsum.index_add(0, ib, verts[ia] * w[:, None])
        deg = deg.index_add(0, ia, w)
        deg = deg.index_add(0, ib, w)
    lap = verts - nsum / deg[:, None].clamp(min=1.0)
    m = (vert_mask & (deg > 0)).to(verts.dtype)
    lap_mag = torch.sqrt((lap * lap).sum(-1) + 1e-20)
    return (lap_mag * m).sum() / m.sum().clamp(min=1.0)


@pytest.mark.parametrize("which", ["normal_consistency", "laplacian"])
def test_mesh_sums_equal_the_index_adds_they_replace(which):
    verts, faces, fmask = _mesh()
    vmask = torch.rand((verts.shape[0],),
                       generator=torch.Generator().manual_seed(7)) > 0.1
    a = verts.clone().requires_grad_(True)
    b = verts.clone().requires_grad_(True)
    if which == "normal_consistency":
        la = MF.normal_consistency_loss(a, faces, fmask)
        lb = _normal_consistency_index_add(b, faces, fmask)
    else:
        la = MF.laplacian_loss(a, faces, fmask, vmask)
        lb = _laplacian_index_add(b, faces, fmask, vmask)
    la.backward()
    lb.backward()
    assert torch.equal(la, lb)
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_launch_takes_only_cuda_tensors(device):
    idx, vals, size = _data(8)
    perm, off = KS.segment_order(idx, size)
    staged = KS.segment_sum.staged
    with pytest.raises(ValueError):
        KS.launch(vals.to(device), perm.to(device), off.to(device), size)
    if device == "meta":
        with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
            KS.segment_sum(idx.to(device), vals.to(device), size)
    assert KS.segment_sum.staged == staged
