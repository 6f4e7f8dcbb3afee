"""The raster-selection wrapper on the CPU: its host-side plan, the plain
version of its interface, and the plain version of the kernel's per-warp
reject.

- `plan` says "direct" for what `rasterize` hands the kernel (float32 pts,
  int64 faces and ids, bool masks, contiguous, the bin lists and the big
  list apart), "staged" for any other dtype or layout, and raises on bad
  shapes, a tile other than 16, non-integer ids or mixed devices. It looks
  at shapes, dtypes and layouts only, so `meta` tensors exercise it too.
- `raster_select_reference` (the plain version of `raster_select`: split
  lists in, (best, key, face) out) against `select_reference` on the
  joined (T, K) list, exactly, and against the JAX package's
  `select_pallas(interpret=True)` on its own `prepare_coeffs`: the winner
  index and face exactly, the key within 1e-5 relative (interpret mode
  rounds the affine evaluation a few ulps differently). The soups of
  `torch_raster_cases.py` cover slivers, pixel-centre ties, duplicates
  with face 0 big (the big list's padding repeats it, valid), full lists,
  an empty frame, and culling.
- `block_masks` never drops a (pixel, candidate) pair that the selection
  finds covered: the corner evaluation is conservative for the rounded
  tests, slivers included.
"""
import numpy as np
import pytest
import torch

from torch_raster_cases import CASES

from mvedit_tpu_torch.kernels import raster_select as RS
from mvedit_tpu_torch.models.mesh.rasterize import (RasterConfig,
                                                    _bin_triangles,
                                                    candidates)

SIZE = 64


def _path_inputs(T=16, Kt=96, Kb=32, V=50, F=40, device="cpu"):
    z = dict(device=device)
    return dict(pts=torch.zeros((V, 3), **z),
                faces=torch.zeros((F, 3), dtype=torch.int64, **z),
                tile_tris=torch.zeros((T, Kt), dtype=torch.int64, **z),
                tile_valid=torch.zeros((T, Kt), dtype=torch.bool, **z),
                big_tris=torch.zeros((Kb,), dtype=torch.int64, **z),
                big_valid=torch.zeros((Kb,), dtype=torch.bool, **z))


def _plan(a, tile=16):
    return RS.plan(a["pts"], a["faces"], a["tile_tris"], a["tile_valid"],
                   tile, a["big_tris"], a["big_valid"])


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("big", [True, False])
def test_path_dtypes_go_direct(device, big):
    a = _path_inputs(device=device)
    if not big:
        a["big_tris"] = a["big_valid"] = None
    assert _plan(a) == "direct"


def test_rasterize_hands_the_kernel_direct_inputs():
    """What `rasterize` passes: `_bin_triangles`' lists, the big list a
    slice of a longer buffer, faces as int64."""
    pts, faces, fv, kw = CASES["slivers"](0, SIZE)
    pts, faces, fv = (torch.from_numpy(x) for x in (pts, faces, fv))
    cfg = RasterConfig(**kw)
    tt, tv, bt, bv = _bin_triangles(pts, faces, fv, cfg)
    assert RS.plan(pts, faces, tt, tv, cfg.tile, bt, bv) == "direct"


@pytest.mark.parametrize("name,make", [
    ("faces int32", lambda a: a["faces"].int()),
    ("tile ids int32", lambda a: a["tile_tris"].int()),
    ("big ids int32", lambda a: a["big_tris"].int()),
    ("tile mask uint8", lambda a: a["tile_valid"].to(torch.uint8)),
    ("big mask int64", lambda a: a["big_valid"].long()),
    ("pts float64", lambda a: a["pts"].double()),
    ("pts float16", lambda a: a["pts"].half()),
    ("pts strided", lambda a: torch.zeros((a["pts"].shape[0], 4))[:, :3]),
    ("tile ids transposed", lambda a: torch.zeros(
        a["tile_tris"].shape[::-1], dtype=torch.int64).t()),
    ("faces strided", lambda a: torch.zeros(
        (a["faces"].shape[0], 6), dtype=torch.int64)[:, ::2]),
])
def test_other_dtypes_and_layouts_are_staged(name, make):
    a = _path_inputs()
    key = {"faces": "faces", "tile": "tile_tris", "big": "big_tris",
           "pts": "pts"}[name.split()[0]]
    if "mask" in name:
        key = "tile_valid" if name.startswith("tile") else "big_valid"
    a[key] = make(a)
    assert _plan(a) == "staged", name


@pytest.mark.parametrize("name,edit,exc", [
    ("pts (V, 2)", lambda a: a.update(pts=a["pts"][:, :2]), ValueError),
    ("faces (F, 4)", lambda a: a.update(
        faces=torch.zeros((40, 4), dtype=torch.int64)), ValueError),
    ("mask shape", lambda a: a.update(tile_valid=a["tile_valid"][:, :5]),
     ValueError),
    ("tile ids 1-D", lambda a: a.update(tile_tris=a["tile_tris"][0],
                                        tile_valid=a["tile_valid"][0]),
     ValueError),
    ("big list 2-D", lambda a: a.update(big_tris=a["big_tris"][None],
                                        big_valid=a["big_valid"][None]),
     ValueError),
    ("big mask length", lambda a: a.update(big_valid=a["big_valid"][:3]),
     ValueError),
    ("big ids alone", lambda a: a.update(big_valid=None), ValueError),
    ("float ids", lambda a: a.update(tile_tris=a["tile_tris"].float()),
     TypeError),
    ("float mask", lambda a: a.update(big_valid=a["big_valid"].float()),
     TypeError),
    ("integer pts", lambda a: a.update(pts=a["pts"].long()), TypeError),
    ("mixed devices", lambda a: a.update(
        faces=a["faces"].to("meta")), ValueError),
])
def test_unsupported_inputs_raise(name, edit, exc):
    a = _path_inputs()
    edit(a)
    with pytest.raises(exc):
        _plan(a)


def test_tile_other_than_16_raises():
    a = _path_inputs()
    with pytest.raises(ValueError):
        _plan(a, tile=8)
    with pytest.raises(ValueError):
        RS.raster_select(a["pts"], a["faces"], a["tile_tris"],
                         a["tile_valid"], 8, 4)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_launch_takes_only_cuda_tensors(device):
    """The bare `launch` refuses anything but a CUDA tensor, before any
    build; `raster_select` on a `meta` tensor likewise (a CPU tensor takes
    the plain version)."""
    a = _path_inputs(device=device)
    args = (a["pts"], a["faces"], a["tile_tris"], a["tile_valid"], 16, 4,
            False, a["big_tris"], a["big_valid"])
    staged = RS.raster_select.staged
    with pytest.raises(ValueError):
        RS.launch(*args)
    if device == "meta":
        with pytest.raises(ValueError):
            RS.raster_select(*args)
    assert RS.raster_select.staged == staged


def test_splits_fill_small_grids():
    """One warp per pixel block from 16 tiles per SM up (the 1024^2 bake),
    two from 4 (512^2), four below (the 128^2 and 256^2 ramp), on 132
    SMs."""
    assert RS.splits_for(4096, 132) == 1
    assert RS.splits_for(2112, 132) == 1
    assert RS.splits_for(1024, 132) == 2
    assert RS.splits_for(528, 132) == 2
    assert RS.splits_for(256, 132) == 4
    assert RS.splits_for(64, 132) == 4


def _case(name, cull=False):
    pts, faces, fv, kw = CASES[name](1, SIZE)
    cfg = RasterConfig(cull_backface=cull, **kw)
    return (torch.from_numpy(pts), torch.from_numpy(faces),
            torch.from_numpy(fv), cfg)


CASE_PARAMS = [(n, False) for n in CASES] + [("slivers", True),
                                             ("duplicates", True)]


@pytest.mark.parametrize("name,cull", CASE_PARAMS)
def test_split_interface_matches_joined(name, cull):
    """The split lists in, (best, key, face) out, against
    `select_reference` on the joined list and a gather of its winners;
    `raster_select` on a CPU tensor is this plain version and launches
    nothing."""
    pts, faces, fv, cfg = _case(name, cull)
    tt, tv, bt, bv = _bin_triangles(pts, faces, fv, cfg)
    cand, cval = candidates(pts, faces, fv, cfg)
    bj, kj = RS.select_reference(pts, faces, cand, cval, cfg.tile,
                                 cfg.tiles_x, cull)
    fj = torch.where(kj < RS.BIG, cand.gather(1, bj.long()),
                     torch.full_like(cand[:, :1], -1))
    launches, staged = RS.raster_select.launches, RS.raster_select.staged
    b, k, f = RS.raster_select(pts, faces, tt, tv, cfg.tile, cfg.tiles_x,
                               cull, bt, bv)
    assert RS.raster_select.launches == launches
    assert RS.raster_select.staged == staged
    assert torch.equal(b, bj) and torch.equal(f, fj)
    assert torch.equal(k.view(torch.int32), kj.view(torch.int32))
    if name == "empty":
        assert not tv.any() and not bv.any()
        assert (f == -1).all() and (b == 0).all() and (k == RS.BIG).all()
    else:
        assert (f >= 0).float().mean() > 0.05
    if name == "duplicates":
        # face 0 is big, and the big list's padding repeats it as valid
        assert bool(bv.all()) and int((bt == 0).sum()) > 1
        won_big = b >= cfg.k_per_tile
        assert won_big.any()
        # a duplicate never wins over its first copy: not the padding's
        # copies of face 0, nor the second and third copies of the small
        # triangles (faces 405 on)
        assert (b[won_big] - cfg.k_per_tile < int((bt != 0).sum()) + 1).all()
        assert (f[f >= 0] < 405).all()
    if name == "full_lists":
        assert int(tv.all(1).sum()) >= 4        # overflowing bin lists


@pytest.mark.parametrize("name,cull", CASE_PARAMS)
def test_interface_matches_select_pallas(name, cull):
    """The plain version against the JAX package's Pallas kernel (interpret
    mode) on JAX's own coefficients of the joined list."""
    import jax.numpy as jnp
    from mvedit_tpu.models.mesh.select_pallas import (prepare_coeffs,
                                                      select_pallas)
    pts, faces, fv, cfg = _case(name, cull)
    tt, tv, bt, bv = _bin_triangles(pts, faces, fv, cfg)
    cand, cval = candidates(pts, faces, fv, cfg)
    tri_p = jnp.asarray(pts.numpy())[jnp.asarray(faces.numpy())]
    coef = prepare_coeffs(tri_p, jnp.asarray(cand.numpy(), jnp.int32),
                          jnp.asarray(cval.numpy()), cull)
    jb, jk = (np.asarray(x) for x in select_pallas(
        coef, cfg.tile, cfg.tiles_x, interpret=True))
    b, k, f = RS.raster_select(pts, faces, tt, tv, cfg.tile, cfg.tiles_x,
                               cull, bt, bv)
    hit = jk < 1e38
    np.testing.assert_array_equal(k.numpy() < 1e38, hit)
    np.testing.assert_array_equal(b.numpy(), jb)
    # the key within 1e-5 of the size of its terms |zx qx| + |zy qy| +
    # |zc|: JAX's 1/z coefficients differ from the port's by a few ulps
    # (another reciprocal), which a sliver's small area amplifies into its
    # cancelling terms
    co = RS.prepare_coeffs(pts, faces, cand, cval, cull)
    w = co.gather(1, b.long()[..., None].expand(-1, -1, 12))  # (T, P, 12)
    T = cand.shape[0]
    pid, t = torch.arange(256), torch.arange(T)[:, None]
    qx = ((t % cfg.tiles_x) * 16 + pid % 16).float() + 0.5
    qy = ((t // cfg.tiles_x) * 16 + pid // 16).float() + 0.5
    scale = (w[..., 9] * qx).abs() + (w[..., 10] * qy).abs() \
        + w[..., 11].abs()
    err = np.abs(k.numpy() - jk)[hit]
    assert (err <= 1e-5 * scale.numpy()[hit]).all(), err.max()
    want = np.where(hit, np.take_along_axis(cand.numpy(), jb, 1), -1)
    np.testing.assert_array_equal(f.numpy(), want)


@pytest.mark.parametrize("name,cull", CASE_PARAMS)
def test_block_masks_are_conservative(name, cull):
    """Every (pixel, candidate) pair the selection finds covered lies in a
    warp block whose bit the reject keeps; and the reject skips most of
    the pixel tests."""
    pts, faces, fv, cfg = _case(name, cull)
    cand, cval = candidates(pts, faces, fv, cfg)
    co = RS.prepare_coeffs(pts, faces, cand, cval, cull)     # (T, K, 12)
    keep = RS.block_masks(co, cfg.tiles_x)                    # (T, K, 8)
    T = cand.shape[0]
    pid = torch.arange(256)
    t = torch.arange(T)
    qx = ((t[:, None] % cfg.tiles_x) * 16 + pid % 16).float() + 0.5
    qy = ((t[:, None] // cfg.tiles_x) * 16 + pid // 16).float() + 0.5
    qx, qy = qx[:, :, None], qy[:, :, None]

    def aff(i):
        return co[:, None, :, i] * qx + co[:, None, :, i + 1] * qy \
            + co[:, None, :, i + 2]
    covered = (aff(0) >= 0) & (aff(3) >= 0) & (aff(6) >= 0)  # (T, P, K)
    px, py = pid % 16, pid // 16
    blk = (px // 8) + 2 * (py // 4)                           # (P,)
    kept = keep[:, :, blk].permute(0, 2, 1)                   # (T, P, K)
    assert not (covered & ~kept).any()
    if name != "empty":
        assert covered.any()
        # pixel tests the warps still run, against testing every slot
        assert kept.float().mean() < 0.5
