"""The final stage of `run_3d_to_3d` in the port against the JAX package,
on the CPU in fp32: the mesh container and its grid atlas, the UV bake, the
edge dilation, the texture-only refinement of a decimated mesh, and the
GLB written and read back.

- `Mesh.auto_uv`: xatlas is on neither machine, so both packages take the
  per-triangle grid atlas: equal UVs and UV faces.
- `bake_texture` of a bridged dense field into a 64^2 atlas (tile 16,
  K 64 + 32, the bake's raster config at a small size) and
  `edge_dilation` (16 iterations). With the atlas's UVs moved off the
  pixel lattice by up to 0.05 texel: the texel mask equal, rgb within
  1e-5. On the grid atlas itself the 45-degree edges of its cells pass
  exactly through texel centres, where coverage is a tie that rounding
  decides (the JAX package's own XLA and Pallas-interpret selections
  disagree on 89 of 4096 texels there): rgb within 1e-5 where both cover,
  the masks apart on at most 3% of the texels.
- `make_texture_refine`, 4 steps on a 1152-face torus seen from 3 views at
  64^2 with JAX's draws (views, LPIPS patch origins), LPIPS off and on:
  the first step's loss within 1e-4 relative, every step's within 1e-3,
  every field tensor after within 5e-2 relative L2 (measured <= 3.1e-2,
  on an MLP bias that starts at 0, so that its error is relative to its
  4 updates alone: Adam's first updates are lr * sign(gradient), and the
  entries whose gradient nearly cancels take their sign from rounding;
  ROADMAP Queue 3).
- GLB: the port's writer and reader keep faces, UVs and the albedo (8 bit).
- `weld_vertices` and `decimate_qem` (the host library, a copy of the JAX
  package's): vertices and faces equal to JAX's, in the same order; the
  weld also through both packages' numpy fallback.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.apis.cameras import surround_rig
from mvedit_tpu.models import losses as JL
from mvedit_tpu.models import mesh_fit as JMF
from mvedit_tpu.models.fields import FieldColor as JFieldColor
from mvedit_tpu.models.fields import INGPConfig as JINGP
from mvedit_tpu.models.fields import ingp_init as j_ingp_init
from mvedit_tpu.models.mesh import Mesh as JMesh
from mvedit_tpu.models.mesh.rasterize import RasterConfig as JRC
from mvedit_tpu.models.mesh.renderer import bake_texture as j_bake
from mvedit_tpu.ops.dense_grid import DenseGridConfig as JDense
from mvedit_tpu.ops.image import edge_dilation as j_dilate
from mvedit_tpu.utils import camera as cam_utils

from mvedit_tpu_torch.models import losses as TL
from mvedit_tpu_torch.models import mesh_fit as TMF
from mvedit_tpu_torch.models.fields import FieldColor as TFieldColor
from mvedit_tpu_torch.models.fields import INGPConfig as TINGP
from mvedit_tpu_torch.models.fields import (field_leaves,
                                            field_params_from_flax)
from mvedit_tpu_torch.models.mesh import Mesh as TMesh
from mvedit_tpu_torch.models.mesh import RasterConfig as TRC
from mvedit_tpu_torch.models.mesh import bake_texture as t_bake
from mvedit_tpu_torch.ops.dense_grid import DenseGridConfig as TDense
from mvedit_tpu_torch.ops.image import edge_dilation as t_dilate

from torch_jax_draws import refine_draws

torch.set_num_threads(2)
JCFG = JINGP(backend="dense", dense=JDense(resolutions=(8, 32),
                                           gather_dtype="float32"))
TCFG = TINGP(backend="dense", dense=TDense(resolutions=(8, 32),
                                           gather_dtype="float32"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _torus(nu=48, nv=12, R=0.55, r=0.22):
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
    return verts, faces.astype(np.int32)


def _field(seed=0):
    p = j_ingp_init(jax.random.PRNGKey(seed), JCFG)
    p["table"] = jax.tree_util.tree_map(lambda x: x * 1000.0, p["table"])
    return jax.tree_util.tree_map(np.asarray, p)


def _bake_both(v, f, vt, ft, field):
    kw = dict(height=64, width=64, tile=16, k_per_tile=64, k_big=32)
    ones = np.ones(len(f), bool)
    rgb_j, mask_j = j_bake(jnp.asarray(v), jnp.asarray(f), jnp.asarray(ones),
                           jnp.asarray(vt), jnp.asarray(ft),
                           JFieldColor(JCFG), JRC(**kw), field_params=field)
    rgb_t, mask_t = t_bake(_t(v), _t(f).long(), _t(ones), _t(vt),
                           _t(ft).long(), TFieldColor(TCFG), TRC(**kw),
                           field_params=field_params_from_flax(field))
    assert 0.2 < float(mask_j.mean()) < 1
    return rgb_j, mask_j, rgb_t, mask_t


@pytest.mark.parametrize("on_lattice", [False, True])
def test_grid_atlas_bake_and_dilation_match_jax(on_lattice):
    v, f = _torus(24, 8)
    mj, mt = JMesh(v=v, f=f), TMesh(v=v.copy(), f=f.copy())
    for m in (mj, mt):
        m.auto_normal()
        m.auto_uv()
    for k in ("vn", "vt", "ft"):
        np.testing.assert_array_equal(getattr(mt, k), getattr(mj, k))
    vt = mt.vt
    if not on_lattice:
        vt = vt + np.random.default_rng(5).uniform(
            -0.05, 0.05, vt.shape).astype(np.float32) / 64
    rgb_j, mask_j, rgb_t, mask_t = _bake_both(v, f, vt, mt.ft, _field())
    rgb_j, mask_j = np.asarray(rgb_j), np.asarray(mask_j)
    if on_lattice:
        both = (mask_t.numpy() > 0) & (mask_j > 0)
        assert (mask_t.numpy() != mask_j).mean() <= 0.03
        np.testing.assert_allclose(rgb_t.numpy()[both], rgb_j[both],
                                   atol=1e-5)
        return
    np.testing.assert_array_equal(mask_t.numpy(), mask_j)
    np.testing.assert_allclose(rgb_t.numpy(), rgb_j, atol=1e-5)
    np.testing.assert_allclose(
        t_dilate(rgb_t, mask_t, n_iters=16).numpy(),
        np.asarray(j_dilate(rgb_j, mask_j, n_iters=16)), atol=1e-5)


def _views(n=3, rs=64):
    rng = np.random.default_rng(0)
    poses, intr = surround_rig(n, 2.6, 40, -0.3, 0.6, rs, rng=rng)
    lights, _ = cam_utils.light_sampling(poses, rng=rng)
    yy, xx = np.mgrid[:rs, :rs] / rs
    images = np.stack([np.stack([xx, yy, 0.5 + 0.3 * np.sin(6 * xx + i)], -1)
                       for i in range(n)]).astype(np.float32)
    return {"images": images, "poses": poses.astype(np.float32),
            "intrinsics": intr.astype(np.float32),
            "cam_weights": np.array([1.0, 2.0, 0.5], np.float32),
            "cam_lights": lights.astype(np.float32)}


@pytest.mark.parametrize("lpips", [False, True])
def test_texture_refine_matches_jax(lpips):
    steps, rs = 4, 64
    v, f = _torus()
    tg = _views(rs=rs)
    field = _field(1)
    lp_j = JL.lpips_init(jax.random.PRNGKey(2)) if lpips else None
    kw = dict(patch_size=32)
    jcfg = JMF.MeshFitConfig(raster=JRC(height=rs, width=rs, span=2), **kw)
    tcfg = TMF.MeshFitConfig(raster=TRC(height=rs, width=rs, span=2), **kw)
    sched = {"lr": 0.005, "sdf_lr_mult": 1.0, "normal_reg": 5.0,
             "patch_rgb": 1.5, "patch_normal": 3.0}
    key = jax.random.PRNGKey(3)
    refine_j, opt = JMF.make_texture_refine(JFieldColor(JCFG), jcfg, steps)
    p_j = jax.tree_util.tree_map(jnp.array, field)
    p_j, _, loss_j = refine_j(p_j, opt.init(p_j), jnp.asarray(v),
                              jnp.asarray(f),
                              {k: jnp.asarray(x) for k, x in tg.items()},
                              key, sched={k: jnp.float32(x)
                                          for k, x in sched.items()},
                              lpips_params=lp_j)
    refine_t, make_opt = TMF.make_texture_refine(TFieldColor(TCFG), tcfg,
                                                 steps)
    p_t = field_params_from_flax(field)
    p_t, _, loss_t = refine_t(
        p_t, make_opt(p_t), _t(v), _t(f).long(),
        {k: _t(x) for k, x in tg.items()}, sched=sched,
        lpips_params=None if lp_j is None else TL.lpips_params_from_flax(lp_j),
        draws=refine_draws(key, steps, tg["cam_weights"], tcfg, lpips))
    loss_j = np.asarray(loss_j)
    assert np.isfinite(loss_j).all()
    np.testing.assert_allclose(float(loss_t[0]), loss_j[0], rtol=1e-4)
    np.testing.assert_allclose(loss_t.numpy(), loss_j, rtol=1e-3)
    j_leaves = ([p_j["table"][k] for k in sorted(p_j["table"])]
                + [l[n] for l in p_j["mlp"] for n in ("w", "b")])
    for i, (a, b) in enumerate(zip(field_leaves(p_t), j_leaves)):
        assert _rel(a.detach().numpy(), b) <= 5e-2, (i, _rel(a.detach(), b))


def test_glb_round_trip(tmp_path):
    v, f = _torus(16, 6)
    m = TMesh(v=v, f=f)
    m.auto_normal()
    m.auto_uv()
    m.albedo = np.random.default_rng(0).random((32, 32, 3)).astype(
        np.float32)
    path = str(tmp_path / "m.glb")
    m.write(path, flip_yz=True)
    back = TMesh.load(path)
    assert len(back.f) == len(f)
    np.testing.assert_allclose(back.albedo, m.albedo, atol=1 / 255 + 1e-6)
    # the writer unwelds the separate UV topology: one vertex per corner
    np.testing.assert_allclose(back.vt, m.vt[m.ft.reshape(-1)])
    ref = JMesh.load(path)
    np.testing.assert_array_equal(back.v, ref.v)
    np.testing.assert_array_equal(back.f, ref.f)


@pytest.mark.parametrize("ratio", [0.5, 0.1])
def test_decimate_qem_matches_jax(ratio):
    """The port's copy of the QEM decimation gives the JAX package's faces
    and vertices exactly."""
    from mvedit_tpu.native import decimate_qem as j_decimate
    from mvedit_tpu.native import native_available as j_available
    from mvedit_tpu_torch.native import decimate_qem, native_available
    assert native_available() and j_available()
    v, f = _torus(48, 16)
    v = v + 0.01 * np.random.default_rng(0).standard_normal(v.shape).astype(
        np.float32)
    target = int(len(f) * ratio)
    vt, ft = decimate_qem(v, f, target)
    vj, fj = j_decimate(v, f, target)
    assert 0 < len(ft) <= target + 2 and ft.max() < len(vt)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(vt, vj)
    with pytest.raises(ValueError):
        decimate_qem(v, f + len(v), target)


def _duplicated_mesh(n_unique=12000, n_dup=8000, n_faces=30000):
    """20k vertices in [-1, 1]^3, 8000 of them repeats of others (half
    exact, half moved by 1e-8, below the weld's eps), shuffled, and random
    faces over them."""
    rng = np.random.default_rng(8)
    base = rng.uniform(-1, 1, (n_unique, 3)).astype(np.float32)
    dup = base[rng.integers(0, n_unique, n_dup)]
    dup[n_dup // 2:] += np.float32(1e-8)
    v = np.concatenate([base, dup])[rng.permutation(n_unique + n_dup)]
    return v, rng.integers(0, len(v), (n_faces, 3)).astype(np.int32)


@pytest.mark.parametrize("route", ["library", "fallback"])
@pytest.mark.parametrize("mesh", ["test_native", "duplicated"])
def test_weld_vertices_matches_jax(monkeypatch, mesh, route):
    """`tests/test_native.py::test_weld_vertices`'s mesh and a seeded
    20k-vertex mesh with duplicates: the same vertices and remapped faces
    as JAX's, in the same order, through the library and through the
    fallback both packages take without it."""
    import mvedit_tpu.native as JN
    import mvedit_tpu_torch.native as TN
    if route == "fallback":
        monkeypatch.setattr(JN, "_load", lambda: None)
        monkeypatch.setattr(TN, "_load", lambda: None)
    else:
        assert TN.native_available() and JN.native_available()
    if mesh == "test_native":
        v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1e-9, 0, 0],
                      [1, 0, 0]], np.float32)
        f = np.array([[0, 1, 2], [3, 4, 2]], np.int32)
    else:
        v, f = _duplicated_mesh()
    vt, ft = TN.weld_vertices(v, f, eps=1e-6)
    vj, fj = JN.weld_vertices(v, f, eps=1e-6)
    assert vt.dtype == np.float32 and ft.dtype == np.int32
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    if mesh == "test_native":
        assert len(vt) == 3
        np.testing.assert_array_equal(ft[0], ft[1])
    else:
        # merged vertices share a cell (or a rounded key) of edge eps
        assert 12000 <= len(vt) < 16000
        assert np.abs(vt[ft] - v[f]).max() < 1e-6
