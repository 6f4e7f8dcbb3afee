"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked `gpu`: without a CUDA device each test skips with its
reason (a CUDA kernel has no CPU or interpret mode). On a GPU machine
(`--noconftest`: the suite's conftest pins JAX to the CPU, and the port's
machine needs no JAX):

    python -m pytest tests/test_torch_kernels_cuda.py -q -m gpu --noconftest

Tolerances:
- flash attention (both APIs, `kernels/flash_attention.py` and
  `ops/flash_attention.py`): `FA.agreement`, which bounds max|d| and
  mean|d| relative to the plain version's magnitude (from the same bf16
  inputs): both round P and the output to bf16 (eps 2^-8) at other points
  and sum in another order. The bounds fail a kernel that scales by
  1/sqrt(padded D) or leaves ragged keys unmasked.
- raster selection: exact (winners, face ids and key bits), at the render
  configs, at the UV bake's (1024^2 grid atlas, tile 16, span 4, K 64 +
  32), and on the edge cases of `torch_raster_cases.py` (slivers,
  pixel-centre ties, duplicates, full lists, an empty frame, culling) at
  128^2 and 256^2 (several warps per pixel block) and 512^2. The kernel
  evaluates every coefficient and affine test op by op in the plain
  version's order with IEEE rounding and no FMA contraction, and its
  rejects are exact for those rounded tests, so winners and keys are
  bit-equal.
- raster selection at 32 x 32 tiles (texture superres's 2048^2 bake):
  exact as well, at the bake's config and on the edge cases.
- segment sum (`kernels/segment_sum.py`): the same bits on every run, the
  bits of `segment_sum_ordered` (the kernel's order in plain PyTorch,
  long rows' strided partials and tree included), and within
  `rounding_bound` of a float64 sum (k u sum|x|, k = n for a row of n <=
  `LONG`, ceil(n / 256) + 8 beyond); rows of one contribution to 10^5.
- determinism: two tiny NeRF-fit chunks, and two mesh-fit chunks, from one
  seed give bit-equal parameters, without and with
  `torch.use_deterministic_algorithms(True)` (which raises at any op with
  no deterministic algorithm on the card).
- LPIPS in bf16 (the runner's cast at full size) against f32 on the same
  seeded VGG16 and 128^2 patches: within `LPIPS_BF16_RTOL` (5e-2) of the
  f32 distance.
Dispatch: a CUDA tensor launches the kernel (the launch counters move), a
CPU tensor takes the plain version.
"""
import pytest
import torch

from mvedit_tpu_torch.kernels import flash_attention as FA

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("qk", [1.0, 2.0])
@pytest.mark.parametrize("shape", [(2, 4096, 8, 40), (2, 2048, 8, 80),
                                   (1, 1024, 4, 64), (1, 512, 2, 128),
                                   (1, 1000, 8, 40), (2, 200, 8, 40),
                                   (3, 77, 2, 24)])
def test_flash_attention_matches_plain(cuda, shape, qk):
    """N(0,1) inputs (nearly uniform attention), and q, k scaled by 2 (a
    peaked softmax)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    q, k = q * qk, k * qk
    before = FA.flash_attention.launches
    out = FA.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    r = FA.agreement(out, FA.attention_reference(q, k, v))
    assert r["ok"], r


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_strided(cuda, dtype):
    """Q read through strides (every other head of a wider tensor; bf16
    reaches the kernel as it is) and an f32 caller, which the wrapper
    casts to bf16 and back, as the TPU kernel's caller does."""
    g = torch.Generator(device=cuda).manual_seed(1)
    wide = torch.randn((2, 1152, 16, 40), generator=g, device=cuda,
                       dtype=dtype)
    q = wide[:, :, ::2]
    k, v = (torch.randn((2, 1152, 8, 40), generator=g, device=cuda,
                        dtype=dtype) for _ in range(2))
    out = FA.flash_attention(q, k, v)
    assert out.dtype == dtype and out.shape == q.shape
    ref = FA.attention_reference(*(t.bfloat16() for t in (q, k, v)))
    r = FA.agreement(out, ref)
    assert r["ok"], r


@pytest.mark.parametrize("qk", [1.0, 4.0])
@pytest.mark.parametrize("Lq,Lk,D", [(4096, 1152, 40), (1000, 1000, 40),
                                     (512, 384, 8), (512, 384, 24),
                                     (512, 384, 40), (512, 384, 64),
                                     (512, 384, 80), (512, 384, 128)])
def test_flash_attention_lengths_and_head_dims(cuda, Lq, Lk, D, qk):
    """Lq != Lk, a ragged last tile on both axes (1000 x 1000), every head
    dim instantiation, and q, k scaled by 4 (a very peaked softmax): one
    launch per call, no staged copy, agreement with the plain version."""
    g = torch.Generator(device=cuda).manual_seed(Lq + Lk + D)
    q = torch.randn((2, Lq, 4, D), generator=g, device=cuda,
                    dtype=torch.bfloat16) * qk
    k = torch.randn((2, Lk, 4, D), generator=g, device=cuda,
                    dtype=torch.bfloat16) * qk
    v = torch.randn((2, Lk, 4, D), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    before, staged = FA.flash_attention.launches, FA.launch.staged
    out = FA.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert FA.launch.staged == staged
    assert out.shape == q.shape and out.dtype == q.dtype
    r = FA.agreement(out, FA.attention_reference(q, k, v))
    assert r["ok"], r


def test_flash_attention_staged_offset_view(cuda):
    """A view at storage offset 1 (a base 2 bytes off 16-byte alignment)
    takes the wrapper's aligned copy, counted, and still agrees."""
    g = torch.Generator(device=cuda).manual_seed(5)
    shape = (2, 640, 4, 40)
    n = 2 * 640 * 4 * 40
    q, k, v = (torch.randn(n + 1, generator=g, device=cuda,
                           dtype=torch.bfloat16)[1:].view(shape)
               for _ in range(3))
    assert FA.plan(q, k, v, 40 ** -0.5) == "staged"
    before, staged = FA.flash_attention.launches, FA.launch.staged
    out = FA.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert FA.launch.staged == staged + 1
    r = FA.agreement(out, FA.attention_reference(q, k, v))
    assert r["ok"], r


def test_flash_attention_rejects(cuda):
    q = torch.zeros((1, 128, 2, 136), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q)
    q = torch.zeros((1, 128, 2, 40), device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        FA.flash_attention(q, q, q)


# ---- raster selection ------------------------------------------------------

def _soup(cuda, n_faces, size, seed):
    """A random soup in front of the camera, big and small triangles and
    both windings, projected at `size`^2."""
    from mvedit_tpu_torch.models.mesh import project_mesh
    g = torch.Generator(device=cuda).manual_seed(seed)
    ctr = torch.rand((n_faces, 1, 3), generator=g, device=cuda) * 1.6 - 0.8
    ext = torch.rand((n_faces, 1, 1), generator=g, device=cuda) ** 4 * 0.5
    verts = (ctr + (torch.rand((n_faces, 3, 3), generator=g, device=cuda)
                    * 2 - 1) * ext).reshape(-1, 3)
    faces = torch.arange(3 * n_faces, device=cuda).reshape(-1, 3)
    pose = torch.tensor([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2.5]],
                        dtype=torch.float32, device=cuda)
    f = 1.2 * size
    intr = torch.tensor([f, f, size / 2, size / 2], device=cuda)
    return project_mesh(verts, pose, intr), faces


def _select_both(pts, faces, fv, cfg, splits=None):
    """The kernel on `rasterize`'s split lists against `select_reference`
    on the joined list: winners, faces and key bits equal, one launch, no
    staged copy. `splits` launches through `launch` with that many warps
    per pixel block instead."""
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.models.mesh.rasterize import (_bin_triangles,
                                                        candidates)
    tt, tv, bt, bv = _bin_triangles(pts, faces.long(), fv, cfg)
    before, staged = RS.raster_select.launches, RS.raster_select.staged
    if splits is None:
        bk, kk, fk = RS.raster_select(pts, faces, tt, tv, cfg.tile,
                                      cfg.tiles_x, cfg.cull_backface, bt, bv)
        assert RS.raster_select.launches == before + 1
    else:
        bk, kk, fk = RS.launch(pts, faces, tt, tv, cfg.tile, cfg.tiles_x,
                               cfg.cull_backface, bt, bv, splits=splits)
    torch.cuda.synchronize()
    assert RS.raster_select.staged == staged
    cand, cval = candidates(pts, faces, fv, cfg)
    bp, kp, fp = RS.raster_select_reference(pts, faces, cand, cval, cfg.tile,
                                            cfg.tiles_x, cfg.cull_backface)
    assert torch.equal(bk, bp) and torch.equal(fk, fp)
    assert torch.equal(kk.view(torch.int32), kp.view(torch.int32))
    return bp, kp


@pytest.mark.parametrize("size,span,k", [(512, 2, 1024), (512, 4, 256),
                                         (256, 2, 256), (128, 2, 256)])
def test_raster_select_matches_plain(cuda, size, span, k):
    """Winners equal at every pixel (the kernel rounds every op as the
    plain version does, without FMA contraction) and keys bit-equal."""
    from mvedit_tpu_torch.models.mesh import RasterConfig
    pts, faces = _soup(cuda, 20000, size, size + k)
    cfg = RasterConfig(height=size, width=size, span=span, k_per_tile=k)
    fv = torch.ones(faces.shape[0], dtype=torch.bool, device=cuda)
    bp, kp = _select_both(pts, faces, fv, cfg)
    assert bool((kp < 1e38).any()) and bool((bp >= k).any())


def test_raster_select_bake_config_matches_plain(cuda):
    """The UV bake's config: a 1024^2 per-triangle grid atlas of 60k faces
    (cells ~4 texels), z = 1, tile 16, span 4, K 64 + 32."""
    import numpy as np
    from mvedit_tpu_torch.models.mesh import Mesh, RasterConfig
    n = 60000
    m = Mesh(v=np.zeros((3 * n, 3), np.float32),
             f=np.arange(3 * n, dtype=np.int32).reshape(n, 3))
    m.auto_uv()
    cfg = RasterConfig(height=1024, width=1024, tile=16, span=4,
                       k_per_tile=64, k_big=32)
    uv = torch.as_tensor(m.vt, device=cuda)
    pts = torch.stack([uv[:, 0] * 1024, uv[:, 1] * 1024,
                       torch.ones_like(uv[:, 0])], -1)
    faces = torch.as_tensor(m.ft, device=cuda).long()
    fv = torch.ones(n, dtype=torch.bool, device=cuda)
    _, kp = _select_both(pts, faces, fv, cfg)
    assert float((kp < 1e38).float().mean()) > 0.2


def _case(cuda, name, size, cull=False, seed=2):
    from torch_raster_cases import CASES
    from mvedit_tpu_torch.models.mesh import RasterConfig
    pts, faces, fv, kw = CASES[name](seed, size)
    return (torch.as_tensor(pts, device=cuda),
            torch.as_tensor(faces, device=cuda),
            torch.as_tensor(fv, device=cuda),
            RasterConfig(cull_backface=cull, **kw))


@pytest.mark.parametrize("size", [128, 256, 512])
@pytest.mark.parametrize("name", ["slivers", "pixel_grid", "duplicates",
                                  "full_lists", "empty"])
def test_raster_select_edge_cases(cuda, name, size):
    """Slivers several tiles long, vertices on pixel centres and integer
    edges (rounding ties), duplicate candidates with face 0 big (ties to
    the lowest index, padding of the big list included), overflowing bin
    lists and an empty frame; 128^2 and 256^2 take the small-grid path
    (several warps per pixel block), 512^2 one warp per block."""
    pts, faces, fv, cfg = _case(cuda, name, size)
    bp, kp = _select_both(pts, faces, fv, cfg)
    if name == "empty":
        assert bool((kp == 3e38).all()) and bool((bp == 0).all())
    else:
        assert float((kp < 1e38).float().mean()) > 0.01


@pytest.mark.parametrize("name", ["slivers", "pixel_grid", "duplicates"])
def test_raster_select_culling(cuda, name):
    pts, faces, fv, cfg = _case(cuda, name, 256, cull=True)
    _select_both(pts, faces, fv, cfg)


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("name", ["duplicates", "slivers"])
def test_raster_select_every_split(cuda, name, splits):
    """Each instantiation (1, 2, 4 warps per pixel block) gives the same
    winners, whatever the grid size would pick."""
    pts, faces, fv, cfg = _case(cuda, name, 256)
    _select_both(pts, faces, fv, cfg, splits=splits)


def test_raster_select_staged_inputs(cuda):
    """int32 faces and ids and uint8 masks are staged (counted) and give
    the same result."""
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.models.mesh.rasterize import _bin_triangles
    pts, faces, fv, cfg = _case(cuda, "duplicates", 128)
    tt, tv, bt, bv = _bin_triangles(pts, faces, fv, cfg)
    want = RS.raster_select(pts, faces, tt, tv, 16, cfg.tiles_x, False,
                            bt, bv)
    staged = RS.raster_select.staged
    got = RS.raster_select(pts, faces.int(), tt.int(), tv.to(torch.uint8),
                           16, cfg.tiles_x, False, bt.int(),
                           bv.to(torch.uint8))
    assert RS.raster_select.staged == staged + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


LPIPS_BF16_RTOL = 5e-2


def test_lpips_bf16_against_f32(cuda):
    from mvedit_tpu_torch.models.losses import lpips_apply, lpips_init
    g = torch.Generator(device=cuda).manual_seed(3)
    p32 = lpips_init(g, cuda)
    p16 = {"convs": [{k: v.bfloat16() for k, v in c.items()}
                     for c in p32["convs"]],
           "lins": [v.bfloat16() for v in p32["lins"]]}
    pred, tgt = (torch.rand((4, 128, 128, 3), generator=g, device=cuda)
                 for _ in range(2))
    w = torch.tensor([1.0, 0.5, 2.0, 1.0], device=cuda)
    d32 = float(lpips_apply(p32, pred, tgt, weight=w))
    d16 = float(lpips_apply(p16, pred, tgt, weight=w))
    assert d32 > 0 and abs(d16 - d32) <= LPIPS_BF16_RTOL * d32


def test_rasterize_launches_kernel_and_cpu_takes_plain(cuda):
    """Dispatch: a CUDA tensor launches the kernel (no fallback), a CPU
    tensor takes the plain version and launches nothing; both agree."""
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.models.mesh import RasterConfig, rasterize
    pts, faces = _soup(cuda, 3000, 128, 1)
    fv = torch.ones(faces.shape[0], dtype=torch.bool, device=cuda)
    cfg = RasterConfig(height=128, width=128, span=2)
    before = RS.raster_select.launches
    r_gpu = rasterize(pts, faces, fv, cfg)
    assert RS.raster_select.launches == before + 1
    r_cpu = rasterize(pts.cpu(), faces.cpu(), fv.cpu(), cfg)
    assert RS.raster_select.launches == before + 1
    assert torch.equal(r_gpu["tri_id"].cpu(), r_cpu["tri_id"])
    with pytest.raises(ValueError):
        RS.raster_select(pts[:, :2], faces, faces[:1], fv[:1, None], 16, 8)


# ---- the JAX package's own flash kernel API --------------------------------

@pytest.mark.parametrize("shape,scale", [((8, 1024, 40), 0.1),
                                         ((4, 2048, 64), None),
                                         ((2, 256, 128), 0.05),
                                         ((2, 256, 40), -0.1)])
def test_flash_fwd_matches_plain(cuda, shape, scale):
    from mvedit_tpu_torch.ops import flash_attention as OF
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(shape, generator=g, device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    s = scale if scale is not None else shape[-1] ** -0.5
    before = OF.flash_fwd.launches
    out = OF.flash_fwd(q, k, v, s)
    torch.cuda.synchronize()
    assert OF.flash_fwd.launches == before + 1
    r = FA.agreement(out, OF.flash_reference(q, k, v, s))
    assert r["ok"], r
    # the (B, L, H, D) wrapper too, with its default scale
    q4 = q.reshape(2, -1, *shape[1:]).transpose(1, 2)
    out4 = OF.flash_attention(q4, q4, q4)
    assert out4.shape == q4.shape
    with pytest.raises(ValueError):
        OF.flash_fwd(q[:, :100], k, v, s)


@pytest.mark.parametrize("tile_case", ["bake_2048", "slivers", "pixel_grid",
                                       "duplicates", "empty"])
def test_raster_select_tile_32_matches_plain(cuda, tile_case):
    """32 x 32 tiles: the superres bake's 2048^2 grid atlas (K 64 + 32,
    span 4) and the edge cases at 256^2, bit-equal to the plain version."""
    import numpy as np
    from mvedit_tpu_torch.models.mesh import Mesh, RasterConfig
    if tile_case == "bake_2048":
        n = 60000
        m = Mesh(v=np.zeros((3 * n, 3), np.float32),
                 f=np.arange(3 * n, dtype=np.int32).reshape(n, 3))
        m.auto_uv()
        cfg = RasterConfig(height=2048, width=2048, tile=32, span=4,
                           k_per_tile=64, k_big=32)
        uv = torch.as_tensor(m.vt, device=cuda)
        pts = torch.stack([uv[:, 0] * 2048, uv[:, 1] * 2048,
                           torch.ones_like(uv[:, 0])], -1)
        faces = torch.as_tensor(m.ft, device=cuda).long()
        fv = torch.ones(n, dtype=torch.bool, device=cuda)
    else:
        pts, faces, fv, cfg = _case(cuda, tile_case, 256)
        cfg = RasterConfig(**{**cfg.__dict__, "tile": 32})
    bp, kp = _select_both(pts, faces, fv, cfg)
    assert bp.shape[1] == 1024
    if tile_case != "empty":
        assert float((kp < 1e38).float().mean()) > 0.01


@pytest.mark.parametrize("rows,n,C,dtype,pile", [
    (161 ** 3, 1 << 21, 8, torch.bfloat16, 0.0),  # the dense grid's level 1
    (33 ** 3, 1 << 20, 8, torch.bfloat16, 0.0),   # level 0: rows of ~30
    (40000, 240000, 4, torch.float32, 0.0),       # vertex sums
    (180000, 1 << 18, 6, torch.float32, 0.7),     # a render's background
    (1000, 5000, 3, torch.float32, 0.3),          # one row past LONG
    (1000, 1 << 21, 8, torch.bfloat16, 0.0)])     # surface cells: ~2000 each
def test_segment_sum_matches_plain(cuda, rows, n, C, dtype, pile):
    """`pile`: the share of contributions that go to row 0 (one long row,
    summed by the block kernel)."""
    from mvedit_tpu_torch.kernels import segment_sum as KS
    g = torch.Generator(device=cuda).manual_seed(rows % 97)
    idx = torch.randint(-2, rows + 2, (n,), generator=g, device=cuda)
    idx = torch.where(torch.rand((n,), generator=g, device=cuda) < pile,
                      torch.zeros_like(idx), idx)
    vals = torch.randn((n, C), generator=g, device=cuda).to(dtype)
    before, staged = KS.segment_sum.launches, KS.segment_sum.staged
    a = KS.segment_sum(idx, vals, rows)
    b = KS.segment_sum(idx, vals, rows)
    torch.cuda.synchronize()
    assert KS.segment_sum.launches == before + 2
    assert KS.segment_sum.staged == staged
    assert a.dtype == torch.float32 and a.shape == (rows, C)
    assert torch.equal(a, b)
    assert torch.equal(a, KS.segment_sum_ordered(idx, vals, rows))
    exact = KS.segment_sum_reference(idx, vals, rows, torch.float64)
    bound = KS.rounding_bound(idx, vals, rows)
    assert bool(((a.double() - exact).abs() <= bound).all())


def _fit_pipe(cuda):
    import types
    from mvedit_tpu_torch.models.fields import INGPConfig
    from mvedit_tpu_torch.models.losses import lpips_init
    from mvedit_tpu_torch.ops.dense_grid import DenseGridConfig
    from mvedit_tpu_torch.pipelines.mvedit_3d import (MVEdit3DConfig,
                                                      MVEdit3DPipeline)
    lp = lpips_init(torch.Generator(device=cuda).manual_seed(1), cuda)
    cfg = MVEdit3DConfig(num_views=4, render_size=128, tet_resolution=32,
                         patch_size=32, use_lpips=True,
                         fit_steps_per_program=2,
                         ingp=INGPConfig(backend="dense",
                                         dense=DenseGridConfig(
                                             resolutions=(16, 64))))
    return MVEdit3DPipeline(types.SimpleNamespace(lpips_params=lp), cfg), lp


def _fit_targets(cuda, size):
    import numpy as np
    from mvedit_tpu_torch.apis.cameras import surround_rig
    from mvedit_tpu_torch.utils import camera as cam_utils
    rng = np.random.default_rng(0)
    poses, intr = surround_rig(4, 2.6, 40, -0.3, 0.6, size, rng=rng)
    lights, _ = cam_utils.light_sampling(poses, rng=rng)
    yy, xx = np.mgrid[:size, :size] / size
    masks = np.stack([((xx - 0.5 - 0.05 * i) ** 2 + (yy - 0.5) ** 2 < 0.08)
                      for i in range(4)]).astype(np.float32)[..., None]
    images = np.stack([np.stack([xx, yy, 0.5 + 0.3 * np.sin(6 * xx + i)], -1)
                       for i in range(4)]).astype(np.float32)
    t = {"images": images * masks + (1 - masks), "masks": masks,
         "poses": poses, "intrinsics": intr,
         "cam_weights": np.ones(4), "cam_lights": lights}
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=cuda)
            for k, v in t.items()}


def _two_chunks(cuda, kind):
    """Two fit chunks from seed 0 (field init, the chunks' draws); returns
    the parameters after them."""
    from mvedit_tpu_torch.models.fields import field_leaves, ingp_init
    from mvedit_tpu_torch.models.volume_renderer import OccupancyGrid
    pipe, lp = _fit_pipe(cuda)
    targets = _fit_targets(cuda, 128)
    gen = torch.Generator(device=cuda).manual_seed(0)
    field = ingp_init(pipe.cfg.ingp, gen, cuda)
    if kind == "nerf":
        run, make_opt = pipe._nerf_fit_fns(64, 4)
        opt = make_opt(field)
        grid = OccupancyGrid.create(pipe.cfg.render.grid_size, device=cuda)
        tgt = pipe._resize_targets(targets, 64)
        field, opt, grid, _ = run(field, opt, grid, tgt,
                                  sched=pipe._sched_weights(0.5, "nerf"),
                                  lpips_params=lp, generator=gen)
        return field_leaves(field) + [grid.density]
    with torch.no_grad():
        field["mlp"][-1]["b"][0] = 10.0
    tet_grid, state, opt = pipe._init_mesh_phase(field, device=cuda)
    run, _, _ = pipe._mesh_fit_fns(tet_grid, 4)
    state, opt, _ = run(state, opt, targets,
                        sched=pipe._sched_weights(0.6, "mesh"),
                        generator=gen, lpips_params=lp)
    return [state["sdf"], state["deform"]] + field_leaves(state["field"])


@pytest.mark.parametrize("flag", [False, True])
@pytest.mark.parametrize("kind", ["nerf", "mesh"])
def test_one_seed_gives_one_fit(cuda, monkeypatch, kind, flag):
    """The fits' gradients accumulate in a fixed order (the segment sum,
    deterministic cuDNN for LPIPS's backward, the volume renderer's cumsum
    as a log-step scan): two runs from one seed are bit-equal, and no op
    on the path lacks a deterministic algorithm."""
    from mvedit_tpu_torch.kernels import segment_sum as KS
    if flag:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(flag)
    try:
        before = KS.segment_sum.launches
        a = _two_chunks(cuda, kind)
        b = _two_chunks(cuda, kind)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(prev)
    assert KS.segment_sum.launches > before
    assert all(torch.isfinite(x).all() for x in a)
    assert [torch.equal(x, y) for x, y in zip(a, b)] == [True] * len(a)
