"""The fixed-order segment sum (`kernels/segment_sum.py`) and the ops built
on it (`ops/segment.py`), on the CPU.

The kernel sums each target row's contributions one after another in the
order of a stable sort of the targets. On the CPU the wrapper takes the
plain version, a float32 `index_add` into zeros, which adds in the same
order; these tests hold both descriptions to each other exactly:
- the plain version against `index_add`, dropped targets included;
- `segment_order`'s permutation and offsets against a sequential,
  row-by-row float32 sum in that order (what the kernel computes for rows
  of at most `LONG`): equal bits;
- `segment_sum_ordered` (the kernel's order in plain PyTorch, what the
  card's checks require equal bits to): the plain version's bits on rows
  of at most `LONG`, a longer row's blocked order emulated here entry by
  entry; every row within `rounding_bound` of a float64 sum, a bound
  tight enough that a block sum which loses one partial, stops its tree
  early or drops half the row falls outside it;
- `gather_rows`' backward (a segment sum cast once to the table's dtype)
  and `segment_add`'s (a gather) against autograd of `index_select` /
  `index_add` in float32;
- the mesh fit's normal-consistency and Laplacian sums, now one
  `segment_add` each, against the sequential `index_add`s they replace:
  equal values and gradients;
- the bare `launch` refuses tensors off the card.
"""
import pytest
import torch

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
    assert perm.dtype == off.dtype == torch.int64
    assert off.shape == (size + 1,) and int(off[0]) == 0
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


def _long_row(seed=3, n=5000, C=2):
    g = torch.Generator().manual_seed(seed)
    idx = torch.where(torch.rand((n,), generator=g) < 0.6,
                      torch.zeros((n,), dtype=torch.int64),
                      torch.randint(0, 9, (n,), generator=g))
    vals = torch.randn((n, C), generator=g) * 10
    return idx, vals, 9


def _block_sum(row, tree_stop=1, skip=None):
    """A long row as the block kernel sums it: 256 strided partials in
    order, then the tree down to w = tree_stop; `skip` drops a partial."""
    part = torch.zeros((256, row.shape[1]))
    for t in range(256):
        if t == skip:
            continue
        for j in range(t, row.shape[0], 256):
            part[t] = part[t] + row[j]
    w = 128
    while w >= tree_stop:
        part[:w] = part[:w] + part[w:2 * w]
        w //= 2
    return part[0]


def test_long_row_order_within_rounding():
    """A row longer than `LONG` (the block kernel's): 256 strided partial
    sums in order, then a fixed tree over them, emulated here entry by
    entry: `segment_sum_ordered`'s bits, within `rounding_bound` of a
    float64 sum, and another order than the plain version's."""
    idx, vals, size = _long_row()
    perm, off = KS.segment_order(idx, size)
    row = vals[perm[off[0]:off[1]]]
    assert row.shape[0] > KS.LONG
    part = _block_sum(row)
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
    n, size = 6000, 40
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


@pytest.mark.parametrize("fault", ["one_partial", "short_tree", "half_row"])
def test_rounding_bound_catches_a_broken_block_sum(fault):
    """The check the card holds the block kernel to: a long row's sum that
    loses one partial (one thread's strided entries), stops the tree a
    level early, or drops half the row, lies outside `rounding_bound` of
    the float64 sum."""
    idx, vals, size = _long_row(seed=5, n=60000, C=3)
    vals = vals / 10
    perm, off = KS.segment_order(idx, size)
    row = vals[perm[off[0]:off[1]]]
    if fault == "one_partial":
        bad = _block_sum(row, skip=37)
    elif fault == "short_tree":
        bad = _block_sum(row, tree_stop=2)
    else:
        bad = _block_sum(row[: row.shape[0] // 2])
    exact = KS.segment_sum_reference(idx, vals, size, torch.float64)[0]
    bound = KS.rounding_bound(idx, vals, size)[0]
    assert bool(((_block_sum(row).double() - exact).abs() <= bound).all())
    assert bool(((bad.double() - exact).abs() > bound).any())


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
