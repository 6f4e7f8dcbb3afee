"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked `gpu`: without a CUDA device each test skips with its
reason (a CUDA kernel has no CPU or interpret mode). On a GPU machine
(`--noconftest`: the suite's conftest pins JAX to the CPU, and the port's
machine needs no JAX):

    python -m pytest tests/test_torch_kernels_cuda.py -q -m gpu --noconftest

Tolerances:
- flash attention (both APIs, `kernels/flash_attention.py` and
  `ops/flash_attention.py`; through `attention.dot_product_attention` at
  each call that only `kernel_takes` routes, one launch and no staged
  copy each; a call that asks for a gradient, at a shape `uses_flash`
  admits, launches nothing and its gradients are within 1e-5 relative
  (L2) of the plain path's on the CPU): `FA.agreement`, which bounds
  max|d| and
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
  exact as well, at the bake's config and on the edge cases; and
  `bake_texture` at that config through the kernel and through the
  plain selection on the card: the same texel mask and colour bits.
- segment sum (`kernels/segment_sum.py`): the same bits on every run, the
  bits of `segment_sum_ordered` (the kernel's order in plain PyTorch, long
  rows' slices, strided partials and trees included), and within
  `rounding_bound` of a float64 sum (k u sum|x|, k = n for a row of n <=
  `LONG`; beyond, the partials' terms and the trees' depths); rows of
  one contribution to 10^6 and at the slice edges; the bf16 output is the
  float32 sum rounded once. Its ordering equals `torch.sort(stable=True)`
  of the keys and `searchsorted` offsets exactly.
- determinism: two tiny NeRF-fit chunks (of the dense and of the
  hash-grid field), and two mesh-fit chunks (on the
  structured and on the unstructured tet grid), from one seed give
  bit-equal parameters, without and with
  `torch.use_deterministic_algorithms(True)` (which raises at any op with
  no deterministic algorithm on the card); two tiny Zero123++ v1.2 RGB +
  normal passes and their postprocess, two at the published widths (the
  SD2 UNets, the normal ControlNet, the ViT-H/14 tower, 2 steps), two SAM
  refinements, two tiny text-to-3D requests, three full-width SSDNeRF
  training steps, two full-width steps of the StableSSDNeRF LoRA recipe
  (its frozen base keeping its bits) and of the paper family's stack and
  tiled recipes
  (all also under `use_deterministic_algorithms`), and the sparse-volume
  interpolation's gradients, from one seed are bit-equal.
- SSDNeRF training's code gradient: the segment sum at a step's own
  targets, in the cars recipe, the LoRA recipe's patches and the paper
  family's (3, 6, 128, 128) code (the checks above); the sparse-volume
  interpolation on the card against the CPU within 1e-5 relative (L2);
  `grid_sample_2d`'s values and gradients on the card within 1e-5
  relative (L2) of the CPU's (sums in another order).
- LPIPS in bf16 (the runner's cast at full size) against f32 on the same
  seeded VGG16 and 128^2 patches: within `LPIPS_BF16_RTOL` (5e-2) of the
  f32 distance.
- GRM, the gaussian renderer, TSDF and sharding: flash attention at
  GRM's (1, 16384, 8, 64), read as it is, and a `ViTBlock` at that
  length through the kernel; the gaussian
  renderer's backward segment sum at a render's own candidate ids (the
  checks above) and a render's gradients bit-equal run to run;
  `tsdf_integrate` on the card against the CPU (weights equal but for at
  most 0.1% of the observed voxels, the rest within 1e-5); the sharded
  CFG and NeRF steps over a 1-rank NCCL group, bit-equal twice.
- the viewer and the Morton codes: a `MeshViewer` frame on the card
  against its CPU frame (the raster's face ids equal, depths within
  1e-5, the shading within 1e-5, with a texture 1e-4); `morton3d`, its
  inverse and `packbits` on the card equal to the CPU's.
- seeded frozen weights: the training CLI's builds for the StableSSDNeRF
  recipe at full width (`train_ssdnerf.init_models`: decoder, SD2.1 UNet,
  LoRA, LPIPS), the recipe's 1024-wide text tower and `inception_stat`'s
  net, built for the card, bit-equal to their CPU builds (CPU generators).
- `render_mesh_attrs` on the card: face ids equal to the CPU's, every map
  within 1e-5, one raster launch.
- dense-grid encode (`kernels/dense_grid.py`): the output and the tables'
  gradients bit-equal to the plain version's on the card
  (`ops/dense_grid.py::dense_grid_encode_reference`, its gather's
  gradient through the segment sum), at the field's (32, 160) grid (a
  render-all chunk's 4.2M points among the cases) and the tiny (8, 32),
  smoothstep and linear, bf16 and float32 gathers, on cell faces, 0, 1,
  -0, outside [0, 1] and at +-inf; the points' gradient within
  `DENSE_GRID_XGRAD_RTOL` (1e-5, L2) of autograd's (another order of the
  same float32 sums); NaN points without a fault (the plain gather asserts
  on their int64 index): NaN features, a NaN coordinate's cell index 0,
  their corners' rows NaN gradients, every other bit the plain version's; two runs the same bits; staged
  inputs; what it is not built for raises; on the fits' path the kernel
  runs both ways and the plain gather never.
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


def test_bake_texture_tile_32_matches_plain(cuda, monkeypatch):
    """Texture superres's bake (`TextureSuperResPipeline.bake`'s config:
    2048^2, 32 x 32 tiles, K 64 + 32) of a 60k-face soup in its grid atlas,
    through the kernel and, on the same card, through the plain selection
    (`raster_select_reference` in `rasterize`): the same texel mask and
    colour bits; one tile-32 launch, no staged copy."""
    import importlib
    import numpy as np
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.models.mesh import Mesh, RasterConfig, bake_texture
    n = 60000
    g = np.random.default_rng(4)
    centres = g.uniform(-0.8, 0.8, (n, 1, 3))
    m = Mesh(v=(centres + g.uniform(-0.02, 0.02, (n, 3, 3))).reshape(
        -1, 3).astype(np.float32),
        f=np.arange(3 * n, dtype=np.int32).reshape(n, 3))
    m.auto_uv()
    cfg = RasterConfig(height=2048, width=2048, tile=32, k_per_tile=64,
                       k_big=32)

    def field(xyz):
        return torch.sigmoid(torch.stack([xyz.sum(-1), xyz[..., 0] * 3,
                                          xyz[..., 1] - xyz[..., 2]], -1))

    def t(x, d=torch.float32):
        return torch.as_tensor(x, dtype=d, device=cuda)

    def bake():
        return bake_texture(t(m.v), t(m.f, torch.int64),
                            torch.ones(n, dtype=torch.bool, device=cuda),
                            t(m.vt), t(m.ft, torch.int64), field, cfg)
    before = (RS.raster_select.launches, RS.raster_select.tile32_launches,
              RS.raster_select.staged)
    rgb, mask = bake()
    torch.cuda.synchronize()
    assert (RS.raster_select.launches, RS.raster_select.tile32_launches,
            RS.raster_select.staged) == (before[0] + 1, before[1] + 1,
                                         before[2])
    monkeypatch.setattr(importlib.import_module(
        "mvedit_tpu_torch.models.mesh.rasterize"), "raster_select",
        RS.raster_select_reference)
    rgb_p, mask_p = bake()
    assert RS.raster_select.launches == before[0] + 1
    assert torch.equal(mask, mask_p) and float(mask_p.mean()) > 0.2
    assert torch.equal(rgb, rgb_p)


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
    (1000, 5000, 3, torch.float32, 0.3),          # one row past WARP
    (1000, 1 << 21, 8, torch.bfloat16, 0.0),      # surface cells: ~2000 each
    (50000, 300000, 6, torch.float32, 0.7),       # one row of ~2 10^5
    (33 ** 3, 1 << 21, 8, torch.bfloat16, 0.5)])  # one row of ~10^6
def test_segment_sum_matches_plain(cuda, rows, n, C, dtype, pile):
    """`pile`: the share of contributions that go to row 0 (one long row,
    cut into slices)."""
    from mvedit_tpu_torch.kernels import segment_sum as KS
    g = torch.Generator(device=cuda).manual_seed(rows % 97)
    idx = torch.randint(-2, rows + 2, (n,), generator=g, device=cuda)
    idx = torch.where(torch.rand((n,), generator=g, device=cuda) < pile,
                      torch.zeros_like(idx), idx)
    vals = torch.randn((n, C), generator=g, device=cuda).to(dtype)
    _check_segment_sum(KS, idx, vals, rows)
    # the targets as a strided column: read in place, the same bits
    col = torch.stack([idx, idx], 1)[:, 1]
    staged = KS.segment_sum.staged
    assert torch.equal(KS.segment_sum(col, vals, rows),
                       KS.segment_sum(idx, vals, rows))
    assert KS.segment_sum.staged == staged


def _check_segment_sum(KS, idx, vals, rows):
    """Two launches give the same bits, `segment_sum_ordered`'s bits,
    within `rounding_bound` of a float64 sum; the bf16 output is the f32
    sum rounded once."""
    before, staged = KS.segment_sum.launches, KS.segment_sum.staged
    a = KS.segment_sum(idx, vals, rows)
    b = KS.segment_sum(idx, vals, rows)
    h = KS.segment_sum(idx, vals, rows, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert KS.segment_sum.launches == before + 3
    assert KS.segment_sum.staged == staged
    assert a.dtype == torch.float32 and a.shape == (rows, vals.shape[1])
    assert torch.equal(a, b)
    assert torch.equal(h, a.to(torch.bfloat16))
    assert torch.equal(a, KS.segment_sum_ordered(idx, vals, rows))
    exact = KS.segment_sum_reference(idx, vals, rows, torch.float64)
    bound = KS.rounding_bound(idx, vals, rows)
    assert bool(((a.double() - exact).abs() <= bound).all())


@pytest.mark.parametrize("extra", [0, 1, 2])
@pytest.mark.parametrize("edge", ["long", "warp", "slice", "3slice"])
def test_segment_sum_slice_edges(cuda, edge, extra):
    """Row 0 of LONG, WARP, SLICE or 3 SLICE contributions, + 0, 1, 2,
    among short rows."""
    from mvedit_tpu_torch.kernels import segment_sum as KS
    length = {"long": KS.LONG, "warp": KS.WARP, "slice": KS.SLICE,
              "3slice": 3 * KS.SLICE}[edge] + extra
    g = torch.Generator(device=cuda).manual_seed(length)
    other = torch.randint(1, 700, (20000,), generator=g, device=cuda)
    idx = torch.cat([torch.zeros(length, dtype=torch.int64, device=cuda),
                     other])
    idx = idx[torch.randperm(idx.shape[0], generator=g, device=cuda)]
    vals = torch.randn((idx.shape[0], 3), generator=g, device=cuda)
    _check_segment_sum(KS, idx, vals, 700)


@pytest.mark.parametrize("size", [1, 40000, 100000, 161 ** 3])
def test_segment_order_matches_a_stable_sort(cuda, size):
    """The kernel's ordering (CUB over the row bits, offsets from the
    sorted keys) against `torch.sort(stable=True)` of the int32 keys and
    `searchsorted`: int64, int32 and strided targets, dropped ones
    included."""
    from mvedit_tpu_torch.kernels import segment_sum as KS
    g = torch.Generator(device=cuda).manual_seed(size % 1009)
    n = 1 << 20
    idx = torch.randint(-3, size + 3, (n,), generator=g, device=cuda)
    idx = torch.where(torch.rand((n,), generator=g, device=cuda) < 0.3,
                      idx % 7, idx)
    key = torch.where((idx >= 0) & (idx < size), idx,
                      torch.full_like(idx, size)).int()
    skey, want = torch.sort(key, stable=True)
    want_off = torch.searchsorted(skey, torch.arange(
        size + 1, dtype=torch.int32, device=cuda))
    # int64, int32, and a strided column (as the mesh's faces give)
    for targets in (idx, idx.int(), torch.stack([idx, -idx], 1)[:, 0]):
        perm, off = KS.segment_order(targets, size)
        assert perm.dtype == off.dtype == torch.int32
        assert torch.equal(perm.long(), want)
        assert torch.equal(off.long(), want_off)


def _fit_pipe(cuda, structured_tets=True):
    import types
    from mvedit_tpu_torch.models.fields import INGPConfig
    from mvedit_tpu_torch.models.losses import lpips_init
    from mvedit_tpu_torch.ops.dense_grid import DenseGridConfig
    from mvedit_tpu_torch.pipelines.mvedit_3d import (MVEdit3DConfig,
                                                      MVEdit3DPipeline)
    lp = lpips_init(torch.Generator(device=cuda).manual_seed(1), cuda)
    cfg = MVEdit3DConfig(num_views=4, render_size=128, tet_resolution=32,
                         structured_tets=structured_tets,
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
    the parameters after them. `kind` "mesh_unstructured" fits on the
    unstructured tet grid (`build_grid_tets`, the compact extraction),
    "nerf_hash" the NeRF fit of a hash-grid field (8 levels of 2^16 rows,
    linear and hashed)."""
    import dataclasses
    from mvedit_tpu_torch.models.fields import field_leaves, ingp_init
    from mvedit_tpu_torch.models.volume_renderer import OccupancyGrid
    from mvedit_tpu_torch.ops.hash_grid import HashGridConfig
    pipe, lp = _fit_pipe(cuda, structured_tets=kind != "mesh_unstructured")
    if kind == "nerf_hash":
        pipe = type(pipe)(pipe.m, dataclasses.replace(
            pipe.cfg, ingp=dataclasses.replace(
                pipe.cfg.ingp, backend="hash", hash=HashGridConfig(
                    n_levels=8, log2_hashmap_size=16, max_resolution=128))))
    targets = _fit_targets(cuda, 128)
    gen = torch.Generator(device=cuda).manual_seed(0)
    field = ingp_init(pipe.cfg.ingp, gen, cuda)
    if kind in ("nerf", "nerf_hash"):
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
@pytest.mark.parametrize("kind", ["nerf", "nerf_hash", "mesh",
                                  "mesh_unstructured"])
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


def _image_to_3d_targets(targets, variant):
    """The fit targets of image-to-3D: view 0 weighted 3.0 and supervised
    by a normal map (normal weights [1, 0, ...]); with "empty", masks of
    zero everywhere (seeded TRACER weights trip its failure rule)."""
    t = dict(targets)
    n = t["images"].shape[0]
    if variant in ("normals", "all"):
        yy, xx = torch.meshgrid(torch.linspace(0, 1, t["images"].shape[1]),
                                torch.linspace(0, 1, t["images"].shape[2]),
                                indexing="ij")
        nm = torch.stack([xx, yy, torch.full_like(xx, 0.8)], -1)
        t["normals"] = torch.cat(
            [nm[None], torch.zeros((n - 1,) + nm.shape)], 0).to(
                t["images"].device)
        t["normal_weights"] = torch.tensor([1.0] + [0.0] * (n - 1),
                                           device=t["images"].device)
        t["cam_weights"] = torch.tensor([3.0, 1.5, 0.95, 0.93][:n],
                                        device=t["images"].device)
    if variant in ("empty", "all"):
        t["masks"] = torch.zeros_like(t["masks"])
        t["images"] = torch.ones_like(t["images"])
    return t


@pytest.mark.parametrize("progress", [0.0, 0.5])
@pytest.mark.parametrize("variant", ["normals", "empty", "all"])
@pytest.mark.parametrize("flag", [False, True])
def test_one_seed_gives_one_nerf_fit_image_to_3d(cuda, monkeypatch,
                                                 variant, flag, progress):
    """Two NeRF-fit chunks on image-to-3D's targets (a normal-supervised
    view, unequal view weights, empty masks) from one seed, at the start of
    the schedule and half way (the normals' patch LPIPS weighted): bit-equal
    (compared as raw bits, so NaNs too), no op without a deterministic
    algorithm."""
    from mvedit_tpu_torch.models.fields import field_leaves, ingp_init
    from mvedit_tpu_torch.models.volume_renderer import OccupancyGrid
    if flag:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    def run_once():
        pipe, lp = _fit_pipe(cuda)
        targets = _image_to_3d_targets(_fit_targets(cuda, 128), variant)
        gen = torch.Generator(device=cuda).manual_seed(0)
        field = ingp_init(pipe.cfg.ingp, gen, cuda)
        run, make_opt = pipe._nerf_fit_fns(64, 4)
        opt = make_opt(field)
        grid = OccupancyGrid.create(pipe.cfg.render.grid_size, device=cuda)
        tgt = pipe._resize_targets(targets, 64)
        field, opt, grid, _ = run(field, opt, grid, tgt,
                                  sched=pipe._sched_weights(progress,
                                                            "nerf"),
                                  lpips_params=lp, generator=gen)
        return field_leaves(field) + [grid.density]
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(flag)
    try:
        a, b = run_once(), run_once()
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(prev)

    def bits(x):
        return x.contiguous().view(torch.uint8)
    assert [torch.equal(bits(x), bits(y)) for x, y in zip(a, b)] == \
        [True] * len(a)


@pytest.mark.parametrize("heads,dim", [(8, 40), (5, 64)])
@pytest.mark.parametrize("Lk", [9600, 19200])
def test_flash_attention_zero123plus_shapes(cuda, Lk, heads, dim):
    """Zero123++'s level-0 self-attention at its 960 x 640 grid: the write
    pass (Lk = Lq = 9600 = 75 x 128) and the read pass, whose keys are the
    grid's and the conditioning image's (Lk = 19200), at the JAX
    package's SD1.5 heads (8 of 40) and the published SD2 UNet's (320
    channels in 5 heads of 64): no tail tile, no staged copy."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((2, 9600, heads, dim), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((2, Lk, heads, dim), generator=g, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    assert FA.plan(q, k, v, dim ** -0.5) == "direct"
    before, staged = FA.flash_attention.launches, FA.launch.staged
    out = FA.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert FA.launch.staged == staged
    r = FA.agreement(out, FA.attention_reference(q, k, v))
    assert r["ok"], r


# ((B, Lq, H, D), Lk) of the calls that only `attention.kernel_takes`
# sends to the kernel: Zero123++'s levels 1-3 at its 960 x 640 grid and
# heads of 64 (the write pass and the normal ControlNet at Lk = Lq, the
# read pass at 2 Lq) and its cross-attentions over the 77 text tokens;
# SD1.5's level 1 self-attention (1024 tokens a view) and cross-attentions
# at levels 0-1 in the batches of mvedit_sd15.3d_to_3d_small's denoise
# (8 views, 16 on the ControlNets' CFG chunk; read from a traced request's
# recorded calls); IP-Adapter's 4 and 16 image tokens
RAGGED_CASES = [((2, 2400, 10, 64), 2400), ((2, 2400, 10, 64), 4800),
                ((2, 600, 20, 64), 600), ((2, 600, 20, 64), 1200),
                ((2, 150, 20, 64), 150), ((2, 150, 20, 64), 300),
                ((2, 9600, 5, 64), 77), ((2, 2400, 10, 64), 77),
                ((2, 600, 20, 64), 77), ((2, 150, 20, 64), 77),
                ((16, 1024, 8, 80), 1024),
                ((8, 4096, 8, 40), 77), ((16, 4096, 8, 40), 77),
                ((8, 1024, 8, 80), 77), ((16, 1024, 8, 80), 77),
                ((16, 4096, 8, 40), 4), ((16, 1024, 8, 80), 16)]


@pytest.mark.parametrize("shape,Lk", RAGGED_CASES)
def test_flash_attention_ragged_path_shapes(cuda, shape, Lk):
    """`dot_product_attention` at each call the kernel's own rule routes
    (lengths off the TPU's 128-row blocks): one launch, no staged copy,
    agreement with the plain version."""
    from mvedit_tpu_torch.models.diffusion import attention as TA
    B, Lq, H, D = shape
    g = torch.Generator(device=cuda).manual_seed(Lq + Lk + D)
    q = torch.randn(shape, generator=g, device=cuda, dtype=torch.bfloat16)
    k, v = (torch.randn((B, Lk, H, D), generator=g, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    assert not TA.uses_flash(Lq, Lk, D) and TA.kernel_takes(q, k, v)
    before, staged = FA.flash_attention.launches, FA.launch.staged
    out = TA.dot_product_attention(q, k, v)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert FA.launch.staged == staged
    assert out.shape == q.shape and out.dtype == q.dtype
    r = FA.agreement(out, FA.attention_reference(q, k, v))
    assert r["ok"], r


def test_attention_gradient_at_a_flash_shape_equals_the_cpu_plain(cuda):
    """`dot_product_attention` at an aligned shape `uses_flash` admits,
    asked for a gradient (the kernel has no backward): no launch, and the
    output and the gradients to q, k and v within 1e-5 relative (L2) of
    the plain path's on the CPU (sums in another order)."""
    from mvedit_tpu_torch.models.diffusion import attention as TA
    shape = (1, 2048, 2, 64)
    assert TA.uses_flash(shape[1], shape[1], shape[-1])
    g = torch.Generator().manual_seed(5)
    qkv = [torch.randn(shape, generator=g) for _ in range(3)]
    w = torch.randn(shape, generator=g)
    results = []
    for dev in (cuda, torch.device("cpu")):
        ts = [t.to(dev).requires_grad_() for t in qkv]
        before = FA.flash_attention.launches
        out = TA.dot_product_attention(*ts)
        (out * w.to(dev)).sum().backward()
        assert FA.flash_attention.launches == before
        results.append([out.detach().cpu()] + [t.grad.cpu() for t in ts])
    for a, b in zip(*results):
        assert float((a - b).norm() / b.norm()) <= 1e-5


def test_one_seed_gives_one_full_width_normal_pass(cuda):
    """Zero123++ v1.2's RGB and normal passes at the published widths (the
    full-size build: SD2 UNets, the normal ControlNet, the ViT-H/14
    tower; 960 x 640 grid, 2 steps), twice from one seed: bit-equal, with
    every UNet and ControlNet attention on the kernel, the self- and the
    cross-attention of each transformer (a UNet 16 transformers: 6 down, 1
    mid, 9 up; the ControlNet 7: 6 down, 1 mid; a step: RGB write + read,
    normal write + read, 4 UNet passes, and one ControlNet call); the
    vision tower (f32) and the VAE's mid-attention (D 512) stay plain."""
    import numpy as np
    from mvedit_tpu_torch.apis import Adapter3DRunner
    runner = Adapter3DRunner(seed=0, device="cuda")
    img = np.random.default_rng(0).random((512, 512, 3)).astype(np.float32)

    def run():
        before = FA.flash_attention.launches
        out = runner.run_zero123plus(img, seed=3, version="1.2",
                                     num_steps=2, return_normal=True)
        torch.cuda.synchronize()
        return list(out), FA.flash_attention.launches - before
    (a, na), (b, nb) = run(), run()
    assert na == nb == 2 * (4 * 2 * 16 + 2 * 7)
    assert all(x.shape == (960, 640, 3) and np.isfinite(x).all()
               for x in a)
    assert [np.array_equal(x, y) for x, y in zip(a, b)] == [True] * len(a)


def test_reference_attention_unet_on_card(cuda):
    """A tiny f32 UNet's reference-attention write and read passes on the
    card (level 0 at 48 x 32 latents: 1536 tokens, the read pass's keys
    3072, both through the flash kernel, which takes bf16) against the
    same passes on the CPU (plain attention): relative L2 <= 2e-2, the
    kernel's bf16 rounding of P and of its output."""
    from mvedit_tpu_torch.apis.runner import init_random_
    from mvedit_tpu_torch.models.diffusion import (AttnMode,
                                                   UNet2DCondition,
                                                   UNetConfig)
    cfg = UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                     attn_down=(True, False), cross_attention_dim=32,
                     num_heads=4, dtype=torch.float32)
    unet = init_random_(UNet2DCondition(cfg),
                        torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    cond, lat = (torch.randn((2, 48, 32, 4), generator=g) for _ in range(2))
    emb = torch.randn((2, 8, 32), generator=g)
    t2 = torch.tensor([500, 500], dtype=torch.int32)

    def run(dev):
        u = unet.to(dev)
        with torch.no_grad():
            _, w = u(cond.to(dev), t2.to(dev), emb.to(dev),
                     mode=AttnMode(reference="write"))
            out = u(lat.to(dev), t2.to(dev), emb.to(dev),
                    mode=AttnMode(reference="read"), ref_kv=w)
        return [x.cpu() for x in w], out.cpu()
    w_cpu, out_cpu = run("cpu")
    before = FA.flash_attention.launches
    w_gpu, out_gpu = run(cuda)
    torch.cuda.synchronize()
    # level 0: the down block's transformer and the up block's two, each
    # pass
    assert FA.flash_attention.launches - before == 6
    for a, b in zip(w_gpu, w_cpu):
        assert ((a - b).norm() / b.norm()).item() <= 2e-2
    assert ((out_gpu - out_cpu).norm() / out_cpu.norm()).item() <= 2e-2


def test_one_seed_gives_one_normal_pass(cuda):
    """Zero123++ v1.2's RGB and normal passes (tiny models on the card,
    the normal ControlNet on the RGB grid) and the postprocess of their
    views, twice from one seed: bit-equal."""
    import numpy as np
    from mvedit_tpu_torch.apis import Adapter3DRunner
    from mvedit_tpu_torch.pipelines.preproc import zero123plus_postprocess
    runner = Adapter3DRunner(tiny_models=True, seed=0, device="cuda")
    img = np.random.default_rng(0).random((40, 40, 3)).astype(np.float32)

    def run():
        grid, ngrid = runner.run_zero123plus(img, seed=3, version="1.2",
                                             return_normal=True)
        posts = [zero123plus_postprocess(v, n) for v, n in zip(
            runner._split_grid(grid), runner._split_grid(ngrid))]
        return [grid, ngrid] + [x for p in posts for x in p]
    a, b = run(), run()
    assert all(np.isfinite(x).all() for x in a)
    assert [np.array_equal(x, y) for x, y in zip(a, b)] == [True] * len(a)


def test_one_seed_gives_one_sam_refinement(cuda):
    """`run_segmentation` with SAM (tiny, f32, on the card), bg_color and
    erosion, twice: SAM prompted once per image, bit-equal masks."""
    import numpy as np
    from mvedit_tpu_torch.apis import Adapter3DRunner
    runner = Adapter3DRunner(tiny_models=True, seed=0, device="cuda")
    images = np.ones((2, 64, 64, 3), np.float32)
    images[0, 10:40, 14:50] = 0.3
    images[1, 20:60, 5:30] = 0.6
    calls = []
    make = runner.make_sam_refine_fn

    def counted():
        refine = make()

        def f(*a):
            calls.append(a[1])
            return refine(*a)
        return f
    runner.make_sam_refine_fn = counted
    a, b = (runner.run_segmentation(images, use_sam=True,
                                    bg_color=(1.0, 1.0, 1.0), erosion=1)
            for _ in range(2))
    assert len(calls) == 4
    assert a.shape == (2, 64, 64, 1) and a.device.type == "cuda"
    assert torch.equal(a, b)


@pytest.mark.parametrize("flag", [False, True])
def test_one_seed_gives_one_text_to_3d(cuda, monkeypatch, flag):
    """A tiny `run_stablessdnerf_to_mesh` on the card (the code sample, the
    distillation's 20 Adam steps, the triplane renders, the MVEdit loop),
    twice from one seed: the code, the distilled loop's field and the mesh
    bit-equal, without and with `torch.use_deterministic_algorithms`."""
    import numpy as np
    from mvedit_tpu_torch.apis import Adapter3DRunner
    from mvedit_tpu_torch.models.fields import field_leaves
    if flag:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    runner = Adapter3DRunner(tiny_models=True, seed=0, device="cuda")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(flag)
    try:
        a, b = (runner.run_stablessdnerf_to_mesh("a red car", seed=1)
                for _ in range(2))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(prev)
    assert a["mesh"] is not None and len(a["mesh"].f) > 0
    assert all(torch.equal(x, y) for x, y in zip(
        field_leaves(a["nerf_params"]), field_leaves(b["nerf_params"])))
    for k in ("v", "f", "albedo"):
        assert np.array_equal(getattr(a["mesh"], k), getattr(b["mesh"], k))


def _triplane_rays(device, B=4, R=4096, seed=0):
    """B scenes x R rays of SRN cars' rig (cameras on a sphere of radius
    1.3 at focal 131.25 and 128^2, as the loader makes the rays)."""
    import numpy as np
    from mvedit_tpu_torch.datasets.loader import pixel_rays
    from mvedit_tpu_torch.utils import camera as cu
    rng = np.random.default_rng(seed)
    poses = cu.get_pose_from_angles(rng.uniform(0, 6.283, 50),
                                    rng.uniform(-0.2, 1.2, 50), 1.3)[:, :3]
    intr = np.tile(np.array([131.25, 131.25, 64, 64], np.float32), (50, 1))
    vi = rng.integers(0, 50, B * R)
    yi, xi = rng.integers(0, 128, (2, B * R))
    o, d = pixel_rays(poses, intr, vi, yi, xi, (128, 128))
    return (torch.as_tensor(o, device=device).reshape(B, R, 3),
            torch.as_tensor(d, device=device).reshape(B, R, 3))


def test_segment_sum_triplane_grad(cuda):
    """SSDNeRF training's code gradient at a step's own targets (4 scenes
    x 4096 rays x 96 samples x 3 planes x 4 corners into 4 x 3 x 40 x 40
    texels, 12 f32): the kernel's checks above."""
    from mvedit_tpu_torch.configs.ssdnerf_cars import ssdnerf_config as cfg
    from mvedit_tpu_torch.kernels import segment_sum as KS
    from mvedit_tpu_torch.models.triplane import _plane_coords
    from mvedit_tpu_torch.models.volume_renderer import sample_rays
    from mvedit_tpu_torch.ops.grid_sample import corner_rows
    ro, rd = _triplane_rays(cuda)
    xyz = sample_rays(ro, rd, cfg.render)[0].reshape(4, -1, 3)
    grid = _plane_coords(xyz, cfg.triplane).transpose(0, 1)
    idx, _ = corner_rows(grid.reshape(12, -1, 2), (40, 40), "border")
    idx = idx.reshape(-1)
    assert idx.dtype == torch.int32 and idx.shape[0] == 4 * 4096 * 96 * 12
    g = torch.Generator(device=cuda).manual_seed(1)
    vals = torch.randn((idx.shape[0], 12), generator=g, device=cuda)
    _check_segment_sum(KS, idx, vals, 4 * 3 * 40 * 40)


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_grid_sample_2d_gradient_on_card_matches_cpu(cuda, padding):
    """`grid_sample_2d`'s values and its gradients to the input (the
    segment-sum kernel on the card, an in-order float32 `index_add` on the
    CPU) and to the grid at the triplane's shapes: within 1e-5 relative
    (L2) of the CPU's; the rows' sums differ in order only."""
    from mvedit_tpu_torch.kernels import segment_sum as KS
    from mvedit_tpu_torch.ops.grid_sample import grid_sample_2d
    g = torch.Generator().manual_seed(2)
    x = torch.randn((3, 12, 40, 40), generator=g)
    grid = torch.rand((3, 1, 200000, 2), generator=g) * 2.2 - 1.1
    w = torch.randn((3, 12, 1, 200000), generator=g)

    def run(dev):
        xs = x.to(dev).requires_grad_(True)
        gs = grid.to(dev).requires_grad_(True)
        out = grid_sample_2d(xs, gs, padding, False)
        (out * w.to(dev)).sum().backward()
        return [t.detach().cpu() for t in (out, xs.grad, gs.grad)]
    before = KS.segment_sum.launches
    card = run(cuda)
    assert KS.segment_sum.launches == before + 1
    for a, b in zip(card, run("cpu")):
        assert float((a - b).norm() / b.norm()) <= 1e-5


def _train_steps(cuda, n_steps=3):
    """`n_steps` of the cars recipe's stage-2 step at full width (4 scenes
    x 4096 rays x 96 samples, the (3, 12, 40, 40) code, the 128-wide
    denoiser) from seed 0 -> the state's tensors."""
    from mvedit_tpu_torch.configs.ssdnerf_cars import (build_denoiser,
                                                       ssdnerf_config as cfg)
    from mvedit_tpu_torch.models import ssdnerf as MS
    from mvedit_tpu_torch.models.diffusion import schedulers as S
    from mvedit_tpu_torch.models.triplane import triplane_init
    gen = torch.Generator(device=cuda).manual_seed(0)
    decoder = triplane_init(cfg.triplane, gen, cuda)
    net = build_denoiser(gen, cuda)
    params = MS.module_params(net)
    codes = torch.randn((4, *cfg.latent_shape), generator=gen,
                        device=cuda) * 0.3
    state = {"decoder": decoder, "decoder_opt": MS.adam_init(decoder),
             "denoiser": params, "denoiser_opt": MS.adam_init(params),
             "codes": codes, "code_m": torch.zeros_like(codes),
             "code_v": torch.zeros_like(codes),
             "code_steps": torch.zeros(4, dtype=torch.int32, device=cuda)}
    step = MS.make_train_step(MS.module_apply(net), cfg.triplane, cfg,
                              S.sd_schedule(prediction_type="v_prediction"))
    ro, rd = _triplane_rays(cuda)
    rgb = torch.rand((4, 4096, 3), generator=gen, device=cuda)
    for _ in range(n_steps):
        state, metrics = step(state, {"rays_o": ro, "rays_d": rd,
                                      "rgb": rgb, "cond": None}, gen)
    return MS.tree_leaves({k: v for k, v in state.items()
                           if not k.endswith("_opt")}) + [
        metrics["loss_render"], metrics["loss_diffusion"]]


@pytest.mark.parametrize("flag", [False, True])
def test_one_seed_gives_one_training_run(cuda, monkeypatch, flag):
    """Three full-width SSDNeRF stage-2 steps, twice from one seed: codes,
    moments, decoder, denoiser and losses bit-equal, without and with
    `torch.use_deterministic_algorithms(True)`; one segment sum a step."""
    from mvedit_tpu_torch.kernels import segment_sum as KS
    if flag:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(flag)
    try:
        before, staged = KS.segment_sum.launches, KS.segment_sum.staged
        a = _train_steps(cuda)
        b = _train_steps(cuda)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(prev)
    assert KS.segment_sum.launches == before + 6
    assert KS.segment_sum.staged == staged
    assert all(torch.isfinite(x).all() for x in a)
    assert [torch.equal(x, y) for x, y in zip(a, b)] == [True] * len(a)


def _patch_rays(device, B=8, ps=32, seed=3):
    """B scenes x one (ps, ps) patch of a view of the SRN rig, as the
    loader's patch mode draws them."""
    import numpy as np
    from mvedit_tpu_torch.datasets.loader import pixel_rays
    from mvedit_tpu_torch.utils import camera as cu
    rng = np.random.default_rng(seed)
    poses = cu.get_pose_from_angles(rng.uniform(0, 6.283, 50),
                                    rng.uniform(-0.2, 1.2, 50), 1.3)[:, :3]
    intr = np.tile(np.array([131.25, 131.25, 64, 64], np.float32), (50, 1))
    vi = np.repeat(rng.integers(0, 50, B), ps * ps)
    oy, ox = rng.integers(0, 128 - ps + 1, (2, B))
    gy, gx = np.meshgrid(np.arange(ps), np.arange(ps), indexing="ij")
    yi = (oy[:, None] + gy.reshape(1, -1)).reshape(-1)
    xi = (ox[:, None] + gx.reshape(1, -1)).reshape(-1)
    o, d = pixel_rays(poses, intr, vi, yi, xi, (128, 128))
    return (torch.as_tensor(o, device=device).reshape(B, ps * ps, 3),
            torch.as_tensor(d, device=device).reshape(B, ps * ps, 3))


@pytest.mark.parametrize("recipe", ["lora", "paper"])
def test_segment_sum_training_recipes(cuda, recipe):
    """The code gradient's sum in the LoRA recipe (8 scenes x a 32^2 patch
    x 96 samples x 12 corners into 8 x 3 x 40 x 40 texels of 4 f32) and in
    the paper family (8 x 4096 rays into 8 x 3 x 128 x 128 texels of 6):
    the kernel's checks above."""
    from mvedit_tpu_torch.configs._ssdnerf_paper_base import \
        make_paper_config
    from mvedit_tpu_torch.configs.stablessdnerf_cars_lpips import \
        ssdnerf_config
    from mvedit_tpu_torch.kernels import segment_sum as KS
    from mvedit_tpu_torch.models.triplane import _plane_coords
    from mvedit_tpu_torch.models.volume_renderer import sample_rays
    from mvedit_tpu_torch.ops.grid_sample import corner_rows
    if recipe == "lora":
        cfg, (ro, rd) = ssdnerf_config, _patch_rays(cuda)
    else:
        cfg, (ro, rd) = make_paper_config(), _triplane_rays(cuda, B=8)
    P, C, H, W = cfg.latent_shape
    xyz = sample_rays(ro, rd, cfg.render)[0].reshape(8, -1, 3)
    grid = _plane_coords(xyz, cfg.triplane).transpose(0, 1)
    idx, _ = corner_rows(grid.reshape(8 * P, -1, 2), (H, W), "border")
    idx = idx.reshape(-1)
    assert idx.shape[0] == 8 * ro.shape[1] * 96 * 12
    g = torch.Generator(device=cuda).manual_seed(4)
    vals = torch.randn((idx.shape[0], C), generator=g, device=cuda)
    _check_segment_sum(KS, idx, vals, 8 * P * H * W)


def _lora_steps(cuda, n_steps=2):
    """`n_steps` of the StableSSDNeRF step at full width (the SD2.1 UNet +
    rank-32 LoRA, 8 scenes x a 32^2 patch x 96 samples, LPIPS, a seeded
    1024-wide text condition) from seed 0 -> the LoRA, codes, decoder and
    losses, and whether the frozen base kept its bits."""
    from mvedit_tpu_torch.configs import stablessdnerf_cars_lpips as SR
    from mvedit_tpu_torch.models import ssdnerf as MS
    from mvedit_tpu_torch.models.diffusion import schedulers as S
    from mvedit_tpu_torch.models.losses import lpips_init
    from mvedit_tpu_torch.models.triplane import triplane_init
    cfg = SR.ssdnerf_config
    gen = torch.Generator(device=cuda).manual_seed(0)
    decoder = triplane_init(cfg.triplane, gen, cuda)
    net = SR.build_denoiser(gen, cuda)
    base = [p.clone() for p in net.unet.parameters()]
    params = MS.module_params(net)
    codes = torch.randn((8, *cfg.latent_shape), generator=gen,
                        device=cuda) * 0.3
    state = {"decoder": decoder, "decoder_opt": MS.adam_init(decoder),
             "denoiser": params, "denoiser_opt": MS.adam_init(params),
             "codes": codes, "code_m": torch.zeros_like(codes),
             "code_v": torch.zeros_like(codes),
             "code_steps": torch.zeros(8, dtype=torch.int32, device=cuda)}
    step = MS.make_train_step(
        MS.module_apply(net), cfg.triplane, cfg,
        S.sd_schedule(prediction_type="v_prediction"),
        lpips_params=lpips_init(torch.Generator(device=cuda).manual_seed(7),
                                cuda), patch_size=32)
    ro, rd = _patch_rays(cuda)
    batch = {"rays_o": ro, "rays_d": rd,
             "rgb": torch.rand((8, 1024, 3), generator=gen, device=cuda),
             "cond": torch.randn((8, 77, 1024), generator=gen,
                                 device=cuda)}
    for _ in range(n_steps):
        state, metrics = step(state, dict(batch), gen)
    kept = all(torch.equal(a, b) for a, b in zip(base,
                                                  net.unet.parameters()))
    return MS.tree_leaves({k: v for k, v in state.items()
                           if not k.endswith("_opt")}) + [
        metrics["loss_render"], metrics["loss_diffusion"]], kept


def _paper_steps(cuda, n_steps=2, config="ssdnerf_cars_recons1v"):
    """`n_steps` of a paper recipe's stage-2 step at full width (8 scenes x
    4096 rays x 96 samples, the (3, 6, 128, 128) code) from seed 0."""
    import importlib
    from mvedit_tpu_torch.models import ssdnerf as MS
    from mvedit_tpu_torch.models.diffusion import schedulers as S
    from mvedit_tpu_torch.models.triplane import triplane_init
    mod = importlib.import_module(f"mvedit_tpu_torch.configs.{config}")
    cfg = mod.ssdnerf_config
    gen = torch.Generator(device=cuda).manual_seed(0)
    decoder = triplane_init(cfg.triplane, gen, cuda)
    net = mod.build_denoiser(gen, cuda)
    params = MS.module_params(net)
    codes = torch.randn((8, *cfg.latent_shape), generator=gen,
                        device=cuda) * 0.3
    state = {"decoder": decoder, "decoder_opt": MS.adam_init(decoder),
             "denoiser": params, "denoiser_opt": MS.adam_init(params),
             "codes": codes, "code_m": torch.zeros_like(codes),
             "code_v": torch.zeros_like(codes),
             "code_steps": torch.zeros(8, dtype=torch.int32, device=cuda)}
    step = MS.make_train_step(MS.module_apply(net), cfg.triplane, cfg,
                              S.sd_schedule(prediction_type="v_prediction"))
    ro, rd = _triplane_rays(cuda, B=8)
    rgb = torch.rand((8, 4096, 3), generator=gen, device=cuda)
    for _ in range(n_steps):
        state, metrics = step(state, {"rays_o": ro, "rays_d": rd,
                                      "rgb": rgb, "cond": None}, gen)
    return MS.tree_leaves({k: v for k, v in state.items()
                           if not k.endswith("_opt")}) + [
        metrics["loss_render"], metrics["loss_diffusion"]]


@pytest.mark.parametrize("flag", [False, True])
@pytest.mark.parametrize("recipe", ["lora", "paper_stack", "paper_tiled"])
def test_one_seed_gives_one_recipe_step(cuda, monkeypatch, recipe, flag):
    """Two full-width steps of the StableSSDNeRF LoRA recipe and of the
    paper family (stack; tiled at ch 80), twice from one seed: LoRA /
    denoiser, codes, decoder and losses bit-equal, without and with
    `torch.use_deterministic_algorithms(True)`; one segment sum a step;
    the LoRA recipe's frozen base keeps its bits."""
    from mvedit_tpu_torch.kernels import segment_sum as KS
    if flag:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(flag)
    try:
        before = KS.segment_sum.launches
        if recipe == "lora":
            (a, kept_a), (b, kept_b) = _lora_steps(cuda), _lora_steps(cuda)
            assert kept_a and kept_b
        else:
            config = "ssdnerf_cars_recons1v" + (
                "_tiled" if recipe == "paper_tiled" else "")
            a = _paper_steps(cuda, config=config)
            b = _paper_steps(cuda, config=config)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(prev)
    assert KS.segment_sum.launches == before + 4
    assert all(torch.isfinite(x).all() for x in a)
    assert [torch.equal(x, y) for x, y in zip(a, b)] == [True] * len(a)


@pytest.mark.parametrize("neighbor", [False, True])
def test_spvolume_interp_gradient_on_card(cuda, neighbor):
    """`spvolume_linear_interp` (and through `build_neighbor`) on a 64^3
    volume ~40% active at 2^18 points: twice on the card bit-equal
    (values and the gradients to the features, a segment sum, and to the
    points); against the CPU: the valid masks equal, values and gradients
    within 1e-5 relative (L2; the features' rows summed in another
    order)."""
    from mvedit_tpu_torch.kernels import segment_sum as KS
    from mvedit_tpu_torch.ops import volume_interp as VI
    g = torch.Generator().manual_seed(5)
    grid = torch.stack(torch.meshgrid(
        *[torch.arange(n) for n in (2, 64, 64, 64)], indexing="ij"),
        -1).reshape(-1, 4)
    keep = torch.rand(grid.shape[0], generator=g) < 0.4
    idx = grid[keep]
    feats = torch.randn((idx.shape[0], 8), generator=g)
    pts = torch.rand((1 << 18, 3), generator=g) * 2.2 - 1.1
    bi = torch.randint(0, 2, (pts.shape[0], 1), generator=g)
    w = torch.randn((pts.shape[0], 8), generator=g)
    fn = VI.neighbor_spvolume_linear_interp if neighbor else \
        VI.spvolume_linear_interp

    def run(dev):
        f = feats.to(dev, copy=True).requires_grad_(True)
        p = pts.to(dev, copy=True).requires_grad_(True)
        vol = VI.sparse_volume(idx.to(dev), f, (64, 64, 64), 2)
        out, valid = fn(vol, p, bi.to(dev))
        (out * w.to(dev)).sum().backward()
        return [t.detach().cpu() for t in (out, valid, f.grad, p.grad)]
    before = KS.segment_sum.launches
    a, b = run(cuda), run(cuda)
    assert KS.segment_sum.launches > before
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    ref = run("cpu")
    assert torch.equal(a[1], ref[1]) and bool(a[1].any())
    for x, y in zip(a[:1] + a[2:], ref[:1] + ref[2:]):
        assert torch.isfinite(x).all()
        assert float((x - y).norm() / y.norm()) <= 1e-5


def test_flash_attention_grm_shape(cuda):
    """GRM's encoder at GRMConfig(): 4 views of 512^2 at patch 8 in one
    sequence, (1, 16384, 8, 64), read as they are (no staged copy), within
    `FA.agreement` of the plain version; and a `ViTBlock` at that length
    takes the kernel with its qkv in bf16."""
    from mvedit_tpu_torch.models.segmentors.dpt import ViTBlock
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn((1, 16384, 8, 64), generator=g, device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    assert FA.plan(q, k, v, 64 ** -0.5) == "direct"
    before, staged = FA.flash_attention.launches, FA.launch.staged
    out = FA.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    r = FA.agreement(out, FA.attention_reference(q, k, v))
    assert r["ok"], r
    blk = ViTBlock(512, 8).to(cuda)
    x = torch.randn((1, 16384, 512), generator=g, device=cuda)
    with torch.no_grad():
        y = blk(x)
    assert FA.flash_attention.launches == before + 2
    assert FA.launch.staged == staged
    assert y.dtype == torch.float32 and torch.isfinite(y).all()


def test_segment_sum_gaussian_backward(cuda):
    """The gaussian renderer's backward at a render's own candidate ids
    (1024 tiles x 256 of 2^20 gaussians, the (N, 10) attribute table):
    the kernel's checks above; and a render's attribute gradients bit-equal
    run to run, through one segment sum."""
    from mvedit_tpu_torch.kernels import segment_sum as KS
    from mvedit_tpu_torch.models.mesh.gaussians import (GSRasterConfig,
                                                        bin_gaussians,
                                                        project_gaussians,
                                                        render_gaussians)
    g = torch.Generator(device=cuda).manual_seed(3)
    N = 1 << 20
    means = torch.rand((N, 3), generator=g, device=cuda) * 1.6 - 0.8
    means[:, 2] += 2.5
    scales = torch.rand((N, 3), generator=g, device=cuda) * 0.01 + 0.002
    quats = torch.randn((N, 4), generator=g, device=cuda)
    colors = torch.rand((N, 3), generator=g, device=cuda)
    opac = torch.rand((N,), generator=g, device=cuda)
    pose = torch.eye(3, 4, device=cuda)
    intr = torch.tensor([700.0, 700.0, 256.0, 256.0], device=cuda)
    cfg = GSRasterConfig(512, 512)
    uv, depth, _, radius = project_gaussians(means, scales, quats, pose,
                                             intr, cfg)
    live = (depth > cfg.near) & (opac > cfg.opacity_thr)
    cand, valid = bin_gaussians(uv, depth, radius, live, cfg)
    assert cand.shape == (1024, 256) and float(valid.float().mean()) > 0.9
    vals = torch.randn((cand.numel(), 10), generator=g, device=cuda)
    _check_segment_sum(KS, cand.reshape(-1), vals, N)

    def grads():
        attrs = [t.clone().requires_grad_(True) for t in
                 (means, scales, quats, colors, opac)]
        out = render_gaussians(*attrs, pose, intr, cfg)
        (out["rgb"].sum() + out["depth"].sum()).backward()
        return [out["rgb"].detach()] + [a.grad for a in attrs]
    before = KS.segment_sum.launches
    a = grads()
    assert KS.segment_sum.launches == before + 1
    b = grads()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_tsdf_integrate_on_card_matches_cpu(cuda):
    """`tsdf_integrate` of 8 analytic-sphere RGB-D views of 64^2 at G 64 on
    the card against the CPU: the weights equal but for voxels whose
    projection lands the other way of a rounding tie (at most 0.1% of the
    observed), the tsdf and colour within 1e-5 elsewhere."""
    import numpy as np
    from mvedit_tpu_torch.apis.cameras import surround_rig
    from mvedit_tpu_torch.models.mesh import tsdf_integrate
    N, hw, r = 8, 64, 0.5
    poses, intr = surround_rig(N, 2.0, 40, -0.6, 0.6, hw,
                               rng=np.random.default_rng(0))
    c2w = np.concatenate([poses, np.tile([[[0, 0, 0, 1.0]]], (N, 1, 1))], 1)
    w2cs = np.linalg.inv(c2w).astype(np.float32)
    u, v = np.meshgrid(np.arange(hw) + 0.5, np.arange(hw) + 0.5,
                       indexing="xy")
    depths = np.zeros((N, hw, hw), np.float32)
    for i in range(N):
        fx, fy, cx, cy = intr[i]
        d = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)
        c = w2cs[i, :3, 3]
        a, b = np.sum(d * d, -1), -2 * np.sum(d * c, -1)
        disc = b * b - 4 * a * (np.sum(c * c) - r * r)
        t = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
        depths[i] = np.where((disc > 0) & (t > 0), t, 0)
    rgbs = np.random.default_rng(1).random((N, hw, hw, 3)).astype(np.float32)
    args = [torch.from_numpy(x) for x in (rgbs, depths, w2cs,
                                          intr.astype(np.float32))]
    cpu = tsdf_integrate(*args, resolution=64)
    gpu = tsdf_integrate(*(x.to(cuda) for x in args), resolution=64)
    gpu = {k: x.cpu() for k, x in gpu.items()}
    differ = gpu["weight"] != cpu["weight"]
    observed = int((cpu["weight"] > 0).sum())
    assert observed > 10000 and int(differ.sum()) <= 0.001 * observed
    keep = ~differ
    for k in ("tsdf", "color"):
        d = (gpu[k] - cpu[k]).abs()[keep]
        assert float(d.max()) <= 1e-5, k


def _nccl_step(cuda):
    """A 1-rank NCCL group: the sharded CFG step of the tiny UNet on 2 x 2
    views and the sharded NeRF step of the tiny field; the group torn
    down after."""
    import socket

    import torch.distributed as dist
    from mvedit_tpu_torch.models.diffusion import AttnMode
    from mvedit_tpu_torch.models.fields import ingp_init, ingp_point_decode
    from mvedit_tpu_torch.models.volume_renderer import RenderConfig
    from mvedit_tpu_torch.parallel import (make_mesh,
                                           make_sharded_denoise_step,
                                           make_sharded_nerf_step)
    from mvedit_tpu_torch.testing import TINY_INGP, make_tiny_models
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        g = torch.Generator(device=cuda).manual_seed(4)
        m = make_tiny_models(g, n_cn=0)
        lat = torch.randn((4, 8, 8, 4), generator=g, device=cuda)
        t = torch.full((4,), 500, dtype=torch.int32, device=cuda)
        ctx = torch.randn((4, 8, 32), generator=g, device=cuda)
        eps = make_sharded_denoise_step(m.unet, mesh, AttnMode(num_views=2),
                                        5.0)(lat, t, ctx)
        p = ingp_init(TINY_INGP, g, cuda)
        step, make_opt = make_sharded_nerf_step(
            lambda q, x: ingp_point_decode(q, x, TINY_INGP),
            RenderConfig(num_samples=16, grid_size=8), mesh)
        ro = torch.rand((256, 3), generator=g, device=cuda) * 0.4 - 0.2
        ro[:, 2] = -2.0
        rd = torch.tensor([[0.0, 0.0, 1.0]], device=cuda).expand(256, 3)
        p, _, loss = step(p, make_opt(p), ro, rd,
                          torch.rand((256, 3), generator=g, device=cuda))
        from mvedit_tpu_torch.models.fields import field_leaves
        return [eps, loss] + [x.detach().clone() for x in field_leaves(p)]
    finally:
        dist.destroy_process_group()


def test_one_rank_nccl_step_bit_equal_twice(cuda):
    """The sharded steps over a 1-rank NCCL group, twice from one seed:
    the same bits."""
    a, b = _nccl_step(cuda), _nccl_step(cuda)
    assert torch.isfinite(a[0]).all() and torch.isfinite(a[1])
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _viewer_torus(nu=48, nv=12, R=0.6, r=0.25):
    import numpy as np
    u, v = np.meshgrid(np.linspace(0, 2 * np.pi, nu, endpoint=False),
                       np.linspace(0, 2 * np.pi, nv, endpoint=False),
                       indexing="ij")
    verts = np.stack([(R + r * np.cos(v)) * np.cos(u),
                      (R + r * np.cos(v)) * np.sin(u),
                      r * np.sin(v)], -1).reshape(-1, 3).astype(np.float32)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a, b = i * nv + j, ((i + 1) % nu) * nv + j
    c, d = ((i + 1) % nu) * nv + (j + 1) % nv, i * nv + (j + 1) % nv
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    vt = np.stack([u.reshape(-1), v.reshape(-1)], -1).astype(
        np.float32) / (2 * np.pi)
    albedo = np.random.default_rng(0).random((64, 64, 3)).astype(np.float32)
    return verts, faces.astype(np.int32), vt, albedo


@pytest.mark.parametrize("textured,tol", [(False, 1e-5), (True, 1e-4)])
def test_mesh_viewer_frame_on_card_matches_cpu(cuda, textured, tol):
    """A `MeshViewer` frame of a torus at 128^2 through the raster kernel
    on the card against the CPU's plain selection: the raster's face ids
    of every pixel equal, its interpolated depths within 1e-5 (plain
    PyTorch after the kernel, rounded as each device rounds), the shaded
    frame within 1e-5
    (normals' lambert shading) or, with a 64^2 albedo sampled through
    the uvs, within 1e-4: the texture's slope (up to 64 a unit of uv)
    turns the devices' last-bit differences in the perspective-correct
    uvs into ~1e-5 (4.4e-5 at most on an H100)."""
    import numpy as np
    from mvedit_tpu_torch.apis.viewer import MeshViewer
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.models.mesh import Mesh
    from mvedit_tpu_torch.models.mesh.rasterize import (project_mesh,
                                                        rasterize)
    from mvedit_tpu_torch.models.mesh.renderer import pose_to_w2c
    from mvedit_tpu_torch.utils.camera import get_pose_from_angles
    verts, faces, vt, albedo = _viewer_torus()
    mesh = Mesh(v=verts, f=faces, vt=vt, ft=faces, albedo=albedo) \
        if textured else Mesh(v=verts, f=faces)
    gpu = MeshViewer(mesh, render_size=128, device="cuda")
    cpu = MeshViewer(mesh, render_size=128, device="cpu")
    before = RS.raster_select.launches
    fg, fc = gpu.frame(0.7, elev=0.3), cpu.frame(0.7, elev=0.3)
    assert RS.raster_select.launches == before + 1
    assert (fc < 1).any(-1).sum() > 2000
    np.testing.assert_array_equal((fg < 1).any(-1), (fc < 1).any(-1))
    assert np.abs(fg - fc).max() <= tol
    pose = get_pose_from_angles(np.array([0.7]), np.array([0.3]),
                                gpu.distance)[0, :3]
    rast = []
    for v in (gpu, cpu):
        p = torch.as_tensor(pose, device=v.verts.device)
        pts = project_mesh(v.verts, pose_to_w2c(p),
                           torch.as_tensor(v.intrinsics,
                                           device=v.verts.device),
                           v.raster_cfg.near)
        fm = torch.ones(v.faces.shape[0], dtype=torch.bool,
                        device=v.verts.device)
        rast.append(rasterize(pts, v.faces, fm, v.raster_cfg))
    # the kernel's face ids bit for bit; the depths PyTorch interpolates
    # from them within rounding (the card's fused multiply-adds)
    assert torch.equal(rast[0]["tri_id"].cpu(), rast[1]["tri_id"])
    torch.testing.assert_close(rast[0]["z"].cpu(), rast[1]["z"], rtol=0,
                               atol=1e-5)


def test_morton3d_on_card_matches_cpu(cuda):
    import numpy as np
    from mvedit_tpu_torch.ops import morton3d, morton3d_invert, packbits
    c = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1 << 12, (100000, 3)))
    code = morton3d(c.cuda())
    assert code.dtype == torch.uint32 and code.is_cuda
    assert torch.equal(code.cpu(), morton3d(c))
    assert torch.equal(morton3d_invert(code).cpu(), morton3d_invert(
        morton3d(c)))
    g = torch.rand(1 << 16, generator=torch.Generator().manual_seed(0))
    assert torch.equal(packbits(g.cuda(), 0.5).cpu(), packbits(g, 0.5))


@pytest.mark.parametrize("part", ["train", "cond", "inception"])
def test_seeded_builds_on_card_equal_cpu_builds(cuda, part):
    """One seed, one set of frozen weights on every device: the builders
    draw from CPU generators and move the weights to the card."""
    from mvedit_tpu_torch.configs import stablessdnerf_cars_lpips as SR
    from mvedit_tpu_torch.models.ssdnerf import module_params, tree_leaves
    from mvedit_tpu_torch.tools import inception_stat, train_ssdnerf
    cpu = torch.device("cpu")

    def build(dev):
        if part == "train":
            dec, net, lp = train_ssdnerf.init_models(SR, 0, dev)
            return [dec, dict(net.unet.named_parameters()),
                    module_params(net), lp]
        if part == "cond":
            return dict(SR.make_cond_fn(dev).net.named_parameters())
        return inception_stat.load_inception(None, dev).state_dict()
    on_card, on_cpu = tree_leaves(build(cuda)), tree_leaves(build(cpu))
    assert len(on_card) == len(on_cpu) > 0
    assert all(a.is_cuda for a in on_card)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu))


def test_render_mesh_attrs_on_card_matches_cpu(cuda):
    """One raster launch; face ids equal to the plain selection's on the
    card's own projected vertices, every map within 1e-5 of the CPU's."""
    import numpy as np
    from mvedit_tpu_torch.kernels import raster_select as RS
    from mvedit_tpu_torch.models.mesh import (RasterConfig, interpolate,
                                              project_mesh, rasterize,
                                              render_mesh_attrs)
    from mvedit_tpu_torch.models.mesh.renderer import pose_to_w2c
    from mvedit_tpu_torch.utils.camera import get_pose_from_angles
    rng = np.random.default_rng(3)
    verts = torch.from_numpy(rng.normal(0, 0.4, (3000, 3)).astype(
        np.float32))
    faces = torch.from_numpy(rng.integers(0, 3000, (5000, 3)))
    valid = torch.ones(5000, dtype=torch.bool)
    w2c = pose_to_w2c(torch.as_tensor(get_pose_from_angles(
        np.array([0.4]), np.array([0.2]), 2.5)[0, :3], dtype=torch.float32))
    intr = torch.tensor([300.0, 300.0, 128.0, 128.0])
    cfg = RasterConfig(256, 256, k_per_tile=1024, k_big=64, span=2)
    before = RS.raster_select.launches
    card = render_mesh_attrs(verts.to(cuda), faces.to(cuda), valid.to(cuda),
                             w2c.to(cuda), intr.to(cuda), cfg,
                             {"xyz": verts.to(cuda)})
    assert RS.raster_select.launches == before + 1
    pts = project_mesh(verts.to(cuda), w2c.to(cuda), intr.to(cuda),
                       cfg.near).cpu()
    ref = rasterize(pts, faces, valid, cfg)
    ref["xyz"] = interpolate(verts, ref, faces)
    assert (ref["tri_id"] >= 0).sum() > 5000
    assert torch.equal(card["tri_id"].cpu(), ref["tri_id"])
    for k in ("bary", "z", "alpha", "xyz"):
        torch.testing.assert_close(card[k].cpu(), ref[k], rtol=0, atol=1e-5)


# the dense-grid encode kernel (`kernels/dense_grid.py`) against the plain
# version on the card (`ops/dense_grid.py::dense_grid_encode_reference`)
# the render-all chunk: 32768 rays x 128 samples at 256^2
RENDER_ALL_POINTS = 32768 * 128
# the points' gradient: another order of the same f32 sums than autograd's
# (per corner dot products, then the weights' products and the levels)
DENSE_GRID_XGRAD_RTOL = 1e-5


def _grid_tables(cuda, resolutions, seed=0, F=8):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return {f"level_{i}": torch.rand((r + 1, r + 1, r + 1, F),
                                     generator=gen, device=cuda) * 2 - 1
            for i, r in enumerate(resolutions)}


def _grid_points(cuda, n, seed=1, nan=False):
    """n uniform points in [0, 1]^3, then the edge points: exactly on the
    cell faces of both levels (multiples of 1/32, and of 1/160), at 0, 1,
    -0, just outside them, well outside, at +-inf (and with `nan`, NaN),
    in each of the three coordinates and in all three at once."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.rand((n, 3), generator=gen, device=cuda)
    faces = torch.cat([torch.arange(33, device=cuda) / 32,
                       torch.arange(161, device=cuda) / 160])
    edge = torch.tensor([0.0, 1.0, -0.0, -1e-7, 1.0000001, -0.25, 1.5,
                         float("inf"), float("-inf")]
                        + [float("nan")] * nan, device=cuda)
    vals = torch.cat([faces, edge])
    rows = [x]
    for d in range(3):
        e = torch.rand((len(vals), 3), generator=gen, device=cuda)
        e[:, d] = vals
        rows.append(e)
    rows.append(vals[:, None].expand(-1, 3))
    rows.append(faces[torch.randint(len(faces), (4096, 3), generator=gen,
                                    device=cuda)])
    return torch.cat(rows)


def _bits(t):
    return t.contiguous().view(torch.int32 if t.element_size() == 4
                               else torch.int16)


def _encode_both(cuda, resolutions, n, interpolation="smoothstep",
                 gather_dtype="bfloat16", x_grad=False, seed=0):
    """The kernel's and the plain version's output, the tables' gradients
    and (with `x_grad`) the points' gradient at one seeded output
    gradient."""
    from mvedit_tpu_torch.ops.dense_grid import (DenseGridConfig,
                                                 dense_grid_encode,
                                                 dense_grid_encode_reference)
    cfg = DenseGridConfig(resolutions=resolutions,
                          interpolation=interpolation,
                          gather_dtype=gather_dtype)
    tables = _grid_tables(cuda, resolutions, seed)
    x = _grid_points(cuda, n, seed + 1)
    gen = torch.Generator(device=cuda).manual_seed(seed + 2)
    g = torch.randn((x.shape[0], cfg.out_dim), generator=gen, device=cuda)
    res = []
    for fn in (dense_grid_encode, dense_grid_encode_reference):
        tab = {k: v.clone().requires_grad_() for k, v in tables.items()}
        xx = x.clone().requires_grad_(x_grad)
        out = fn(tab, xx, cfg)
        out.backward(g)
        res.append((out.detach(), [tab[k].grad for k in sorted(tab)],
                    xx.grad))
    return res


@pytest.mark.parametrize("interpolation", ["smoothstep", "linear"])
@pytest.mark.parametrize("resolutions,n", [((32, 160), RENDER_ALL_POINTS),
                                           ((32, 160), 100000),
                                           ((8, 32), 100000)])
def test_dense_grid_matches_plain(cuda, resolutions, n, interpolation):
    """The forward and the tables' gradients bit-equal to the plain
    version's on the card, at the cell's (32, 160) and the tiny (8, 32)
    grids, on uniform and edge points (cell faces, 0, 1, outside, inf);
    the kernel launched once each way, nothing staged."""
    from mvedit_tpu_torch.kernels import dense_grid as KD
    before = (KD.dense_grid.launches, KD.dense_grid.backward_launches,
              KD.dense_grid.staged)
    (out, grads, _), (ref, ref_grads, _) = _encode_both(
        cuda, resolutions, n, interpolation)
    assert (KD.dense_grid.launches, KD.dense_grid.backward_launches,
            KD.dense_grid.staged) == (before[0] + 1, before[1] + 1,
                                      before[2])
    assert torch.isfinite(out).all()
    assert torch.equal(_bits(out), _bits(ref))
    for a, b in zip(grads, ref_grads):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(_bits(a), _bits(b))


def test_dense_grid_float32_gather_matches_plain(cuda):
    """The float32 gather (rows read as they are; the parity tests' and
    text-to-3D's setting): forward and tables' gradients bit-equal."""
    (out, grads, _), (ref, ref_grads, _) = _encode_both(
        cuda, (8, 32), 50000, gather_dtype="float32")
    assert torch.equal(_bits(out), _bits(ref))
    for a, b in zip(grads, ref_grads):
        assert torch.equal(_bits(a), _bits(b))


def test_dense_grid_nan_points(cuda):
    """NaN points (a degenerate extraction's vertices) run without a fault,
    where the plain version's int64 index of a NaN is out of range on the
    card and its gather asserts: every feature of a point with a NaN
    coordinate is NaN; a NaN coordinate's cell index is 0, and the rows of
    such a point's corners take NaN gradients; the other points' outputs
    and gradients, and the other rows' gradients, have the plain version's
    bits."""
    from mvedit_tpu_torch.ops.dense_grid import (DenseGridConfig,
                                                 dense_grid_encode,
                                                 dense_grid_encode_reference)
    cfg = DenseGridConfig(resolutions=(8, 32))
    tables = _grid_tables(cuda, cfg.resolutions)
    x = _grid_points(cuda, 20000, nan=True)
    bad = torch.isnan(x).any(1)
    gen = torch.Generator(device=cuda).manual_seed(4)
    g = torch.randn((x.shape[0], cfg.out_dim), generator=gen, device=cuda)
    got, want = [], []
    for fn, pts, gg, res in ((dense_grid_encode, x, g, got),
                             (dense_grid_encode_reference, x[~bad], g[~bad],
                              want)):
        tab = {k: v.clone().requires_grad_() for k, v in tables.items()}
        xx = pts.clone().requires_grad_()
        out = fn(tab, xx, cfg)
        out.backward(gg)
        res.extend([out.detach(), [tab[k].grad for k in sorted(tab)],
                    xx.grad])
    torch.cuda.synchronize()
    assert bad.sum() >= 4 and torch.isnan(got[0][bad]).all()
    assert torch.equal(_bits(got[0][~bad]), _bits(want[0]))
    assert torch.equal(_bits(got[2][~bad]),
                       _bits(_point_grad(tables, x[~bad], g[~bad], cfg)))
    for r, a, b in zip(cfg.resolutions, got[1], want[1]):
        p0 = torch.floor(x[bad].clamp(0, 1) * r).nan_to_num(0).long()
        rows = torch.stack([
            ((p0[:, 0] + ox).clamp(max=r) * (r + 1)
             + (p0[:, 1] + oy).clamp(max=r)) * (r + 1)
            + (p0[:, 2] + oz).clamp(max=r)
            for ox in (0, 1) for oy in (0, 1) for oz in (0, 1)]).reshape(-1)
        a, b = a.reshape(-1, 8), b.reshape(-1, 8)
        assert torch.isnan(a[rows]).all()
        keep = torch.ones(len(a), dtype=torch.bool, device=cuda)
        keep[rows] = False
        assert torch.equal(_bits(a[keep]), _bits(b[keep]))


def _point_grad(tables, x, g, cfg):
    from mvedit_tpu_torch.ops.dense_grid import dense_grid_encode
    xx = x.clone().requires_grad_()
    dense_grid_encode(tables, xx, cfg).backward(g)
    return xx.grad


@pytest.mark.parametrize("interpolation", ["smoothstep", "linear"])
@pytest.mark.parametrize("resolutions", [(32, 160), (8, 32)])
def test_dense_grid_point_gradient(cuda, resolutions, interpolation):
    """The points' gradient (the mesh fit's albedo field) within
    DENSE_GRID_XGRAD_RTOL of autograd's through the plain version (L2),
    0 outside [0, 1] and half on a bound as the plain clip's; the tables'
    gradients stay bit-equal."""
    (out, grads, gx), (ref, ref_grads, rgx) = _encode_both(
        cuda, resolutions, 100000, interpolation, x_grad=True)
    assert torch.equal(_bits(out), _bits(ref))
    for a, b in zip(grads, ref_grads):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.isfinite(gx).all() and torch.isfinite(rgx).all()
    err = (gx - rgx).double().norm() / rgx.double().norm()
    assert err <= DENSE_GRID_XGRAD_RTOL, err
    x = _grid_points(cuda, 100000, 1)
    outside = (x < 0) | (x > 1)
    assert (gx[outside] == 0).all() and (rgx[outside] == 0).all()


def test_dense_grid_two_runs_same_bits(cuda):
    """One input, one result: the output and both gradients bit-equal over
    two runs."""
    a = _encode_both(cuda, (32, 160), 200000, x_grad=True)[0]
    b = _encode_both(cuda, (32, 160), 200000, x_grad=True)[0]
    assert torch.equal(_bits(a[0]), _bits(b[0]))
    assert all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a[1], b[1]))
    assert torch.equal(_bits(a[2]), _bits(b[2]))


def test_dense_grid_staged_inputs(cuda):
    """Strided points and a misaligned table are copied (counted as
    staged) and give the same bits."""
    from mvedit_tpu_torch.kernels import dense_grid as KD
    from mvedit_tpu_torch.ops.dense_grid import (DenseGridConfig,
                                                 dense_grid_encode)
    cfg = DenseGridConfig(resolutions=(8, 32))
    tables = _grid_tables(cuda, cfg.resolutions)
    x = _grid_points(cuda, 10000)
    want = dense_grid_encode(tables, x, cfg)
    staged = KD.dense_grid.staged
    strided = torch.stack([x, x], 1)[:, 0]
    assert not strided.is_contiguous()
    flat = torch.cat([torch.zeros(2, device=cuda),
                      tables["level_1"].reshape(-1)])[2:]
    shifted = dict(tables, level_1=flat.view(tables["level_1"].shape))
    assert shifted["level_1"].data_ptr() % 16
    assert torch.equal(_bits(dense_grid_encode(tables, strided, cfg)),
                       _bits(want))
    assert torch.equal(_bits(dense_grid_encode(shifted, x, cfg)),
                       _bits(want))
    assert KD.dense_grid.staged == staged + 2


@pytest.mark.parametrize("case", ["features", "levels", "gather_dtype",
                                  "bf16_to_f32", "interpolation", "device",
                                  "shape"])
def test_dense_grid_rejects(cuda, case):
    """What the kernel is not built for raises; nothing falls back."""
    import dataclasses
    from mvedit_tpu_torch.ops.dense_grid import (DenseGridConfig,
                                                 dense_grid_encode)
    cfg = DenseGridConfig(resolutions=(8, 32))
    tables = _grid_tables(cuda, cfg.resolutions)
    x = _grid_points(cuda, 1000)
    if case == "features":
        cfg = dataclasses.replace(cfg, n_features=4)
        tables = _grid_tables(cuda, cfg.resolutions, F=4)
    elif case == "levels":
        cfg = dataclasses.replace(cfg, resolutions=(2,) * 9)
        tables = _grid_tables(cuda, cfg.resolutions)
    elif case == "gather_dtype":
        cfg = dataclasses.replace(cfg, gather_dtype="float16")
    elif case == "bf16_to_f32":
        cfg = dataclasses.replace(cfg, gather_dtype="float32")
        tables = {k: v.bfloat16() for k, v in tables.items()}
    elif case == "interpolation":
        cfg = dataclasses.replace(cfg, interpolation="cubic")
    elif case == "device":
        tables = {k: v.cpu() for k, v in tables.items()}
    else:
        tables = dict(tables, level_1=tables["level_1"][:-1])
    with pytest.raises((ValueError, TypeError)):
        dense_grid_encode(tables, x, cfg)


@pytest.mark.parametrize("kind", ["nerf", "mesh"])
def test_dense_grid_on_the_fits_path(cuda, monkeypatch, kind):
    """A tiny NeRF-fit chunk and a render of its field (or a mesh-fit
    chunk, whose albedo field takes the points' gradient) on the card:
    the kernel runs both ways, nothing staged, and the plain gather saw no
    dense-grid call."""
    from mvedit_tpu_torch.kernels import dense_grid as KD
    from mvedit_tpu_torch.ops import dense_grid as OD
    calls = []

    def gather_rows(*a, **k):
        calls.append(1)
        raise AssertionError("the plain dense-grid gather on the card")
    monkeypatch.setattr(OD, "gather_rows", gather_rows)
    before = (KD.dense_grid.launches, KD.dense_grid.backward_launches,
              KD.dense_grid.staged)
    _two_chunks(cuda, kind)
    if kind == "nerf":
        pipe, _ = _fit_pipe(cuda)
        from mvedit_tpu_torch.models.fields import ingp_init
        from mvedit_tpu_torch.models.volume_renderer import OccupancyGrid
        t = _fit_targets(cuda, 64)
        field = ingp_init(pipe.cfg.ingp, torch.Generator(
            device=cuda).manual_seed(0), cuda)
        grid = OccupancyGrid.create(pipe.cfg.render.grid_size, device=cuda)
        n0 = KD.dense_grid.launches
        out = pipe._render_chunk(field, None, None, grid, t["poses"],
                                 t["intrinsics"], 64)
        assert KD.dense_grid.launches > n0
        assert torch.isfinite(out["rgb"]).all()
    assert KD.dense_grid.launches > before[0]
    assert KD.dense_grid.backward_launches > before[1]
    assert KD.dense_grid.staged == before[2]
    assert calls == []
