"""The yardstick on small shapes against hand sums: the bounds, the FLOP
count, the busy-time union, the segment sum's error unit, the range
attribution, and the references of the optimiser step, the UV raster
and the dilation."""
import torch

from portbench.harness.capture import signature
from portbench.harness.trace import union
from portbench.reference import bounds as B
from portbench.reference import diffusion as RD
from portbench.reference.flops import call_flops
from portbench.reference.segment import segment_error


def test_flash_bound_takes_the_largest_of_its_three_floors():
    b, lq, lk, h, d = 2, 4096, 1024, 8, 40
    mma = 4.0 * b * h * lq * lk * d / 989e12
    exp = 1.0 * b * h * lq * lk / 3.9e12
    nbytes = 2.0 * b * h * d * (2 * lq + 2 * lk) / 3.35e12
    assert B.flash_bound_s(b, lq, lk, h, d) == max(mma, exp, nbytes)
    # at D = 40 the exponentials bound it, at D = 128 the tensor cores
    assert B.flash_bound_s(b, lq, lk, h, d) == exp
    assert B.flash_bound_s(b, lq, lk, h, 128) == \
        4.0 * b * h * lq * lk * 128 / 989e12


def test_segment_bound_counts_each_byte_once():
    n, rows, c = 1 << 20, 4096, 8
    want = (4 * n + 2 * n * c + 2 * rows * c) / 3.35e12
    assert B.segment_bound_s(n, rows, c, 2, 4, 2) == want


def test_call_bounds_read_recorded_signatures():
    q = torch.zeros(2, 4096, 8, 40, dtype=torch.bfloat16)
    k = torch.zeros(2, 1024, 8, 40, dtype=torch.bfloat16)
    sig = (signature((q, k, k)), signature({}))
    assert B.attention_call_bound(sig) == B.flash_bound_s(2, 4096, 1024,
                                                          8, 40)
    idx = torch.zeros(1000, dtype=torch.int64)
    vals = torch.zeros(1000, 8, dtype=torch.bfloat16)
    sig = (signature((idx, vals, 77)),
           signature({"out_dtype": torch.bfloat16}))
    assert B.segment_call_bound(sig) == B.segment_bound_s(1000, 77, 8, 2,
                                                          8, 2)


def test_flop_count_of_a_dense_layer_and_of_attention():
    x = torch.zeros(3, 5, 16)
    sig = (signature((x,)), signature({}))
    n = call_flops("dense", lambda: RD.Dense(16, 32), "forward", sig)
    assert n == 2 * 3 * 5 * 16 * 32

    class Att(torch.nn.Module):
        def forward(self, q, k, v):
            return RD.attention(q, k, v)
    q = torch.zeros(2, 64, 4, 8)
    k = torch.zeros(2, 48, 4, 8)
    sig = (signature((q, k, k)), signature({}))
    assert call_flops("att", Att, "forward", sig) == 4 * 2 * 4 * 64 * 48 * 8


def test_union_of_intervals():
    assert union([(0, 2), (1, 3), (5, 6)]) == 4
    assert union([]) == 0.0


def test_segment_error_units():
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 50, (20000,), generator=g)
    vals = torch.randn(20000, 4, generator=g)
    exact = torch.zeros(50, 4, dtype=torch.float64).index_add_(
        0, idx, vals.double())
    # a float32 sum, kept or rounded once to bf16: near 0
    f32 = exact.float()
    assert segment_error(idx, vals, 50, f32) < 1e-3
    assert segment_error(idx, vals, 50, f32.to(torch.bfloat16)) < 1e-3
    # the control, accumulated in bf16 over 400 contributions a row, reads
    # far more
    assert segment_error(idx, vals, 50, None, control=True) > 0.01
    # so does a row dropped, or a sum off by a bf16 unit
    bad = f32.clone()
    bad[3] = 0
    assert segment_error(idx, vals, 50, bad) > 1


def test_innermost_range_however_deep():
    from portbench.harness.trace import innermost
    deep = [(i, 100 - i, f"r{i}") for i in range(12)]
    got = innermost(deep + [(200, 300, "later")],
                    [(50, "in"), (5, "r5"), (150, "gap"), (250, "b")])
    assert got == {"in": "r11", "r5": "r5", "b": "later"}


def test_adam_update_is_torch_adam():
    from portbench.reference.fits import adam_update
    g = torch.Generator().manual_seed(0)
    p = torch.randn(64, generator=g, requires_grad=True)
    opt = torch.optim.Adam([p], lr=0.01, betas=(0.9, 0.99), eps=1e-15)
    m = v = None
    for step in range(3):
        p.grad = torch.randn(64, generator=g)
        before = p.detach().clone()
        st = opt.state.get(p, {})
        m, v = st.get("exp_avg"), st.get("exp_avg_sq")
        ref = adam_update(before, p.grad, m, v, step, 0.01, (0.9, 0.99),
                          1e-15)
        opt.step()
        d, r = p.detach().double() - before.double(), ref - before.double()
        assert float((d - r).norm() / r.norm()) < 1e-5


def test_uv_raster_covers_the_texels_inside():
    from portbench.reference.bake import uv_raster
    # two triangles over the square [0.25, 0.75)^2 of an 8^2 atlas
    uvs = torch.tensor([[0.25, 0.25], [0.75, 0.25], [0.75, 0.75],
                        [0.25, 0.75]])
    faces = torch.tensor([[0, 1, 2], [0, 2, 3]])
    fid, w, inner, outer = uv_raster(uvs, faces, 8, 8)
    want = torch.zeros(8, 8, dtype=torch.bool)
    want[2:6, 2:6] = True
    assert torch.equal(fid >= 0, want)
    assert torch.allclose(w.sum(-1)[want].double(),
                          torch.ones(16, dtype=torch.float64))
    assert not (inner & ~want).any() and not (want & ~outer).any()


def test_dilation_reference_is_the_ports_rule():
    from mvedit_tpu_torch.ops.image import edge_dilation
    from portbench.reference.bake import dilation
    g = torch.Generator().manual_seed(1)
    img = torch.rand(24, 20, 3, generator=g)
    mask = (torch.rand(24, 20, generator=g) > 0.8).float()
    out = edge_dilation(img, mask, n_iters=4)
    ref = dilation(img, mask, 4)
    assert float((out.double() - ref).abs().max()) < 1e-6
