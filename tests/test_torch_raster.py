"""The port's rasterizer and renderer against the JAX package's, on the CPU
in fp32, at 64^2.

- `select_reference` (what `raster_select` runs for a CPU tensor) against
  `select_pallas` in interpret mode on JAX's `prepare_coeffs`, on the
  random soup `tests/test_mesh.py` uses for the Pallas backend: the
  coefficients are the same numbers, the winner index must match exactly,
  and the key within 1e-5 relative (interpret mode rounds the affine
  evaluation differently, a few ulps).
- `rasterize` against JAX `rasterize(backend="xla")`, the XLA tile shader:
  `tri_id` may differ on at most 0.2% of the pixels (exact-tie edge
  pixels, where the affine and the direct edge tests round differently);
  where the ids agree, bary, z, alpha and alpha_hard within 1e-5; the
  gradient of the JAX test's loss w.r.t. the vertices within 1e-4
  relative L2 on a soup with no mismatched pixel.
- `render_mesh_attrs` (project, rasterize, interpolate a dict) against
  JAX's with the Pallas selection in interpret mode (as
  `tests/test_mesh.py` runs it on the CPU), on a closed sphere mesh at
  64^2 from a generic pose: face ids equal, every raster map and
  attribute within 1e-5.
- `interpolate`, `vertex_normals` and `render_views` with `FieldShading`
  (field weights bridged from flax) against JAX, within 1e-5 (1e-4 for
  the shaded and soft maps, which pass through the field's MLP).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.models.fields import FieldShading as JFieldShading
from mvedit_tpu.models.fields import INGPConfig as JINGPConfig
from mvedit_tpu.models.fields import ingp_init as j_ingp_init
from mvedit_tpu.models.mesh.select_pallas import prepare_coeffs, select_pallas
from mvedit_tpu.models.mesh.structured_tets import (
    StructuredTetGrid as JGrid, marching_tets_structured as j_mts)
from mvedit_tpu.ops.dense_grid import DenseGridConfig as JDense

from mvedit_tpu_torch.kernels import raster_select as KS
from mvedit_tpu_torch.models import fields as TF
from mvedit_tpu_torch.ops.dense_grid import DenseGridConfig as TDense

# the mesh packages export functions named like their modules
JR = importlib.import_module("mvedit_tpu.models.mesh.rasterize")
JRen = importlib.import_module("mvedit_tpu.models.mesh.renderer")
TR = importlib.import_module("mvedit_tpu_torch.models.mesh.rasterize")
TRen = importlib.import_module("mvedit_tpu_torch.models.mesh.renderer")

torch.set_num_threads(2)

POSE = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2.5]], np.float32)
INTR = np.array([80.0, 80.0, 32.0, 32.0], np.float32)


def _soup(seed, V=400, F=700):
    rng = np.random.default_rng(seed)
    verts = rng.normal(0, 0.4, (V, 3)).astype(np.float32)
    faces = rng.integers(0, V, (F, 3)).astype(np.int32)
    fvalid = rng.random(F) > 0.1
    return verts, faces, fvalid


def _cfgs(**kw):
    kw = dict(height=64, width=64, k_per_tile=96, k_big=32, span=2, **kw)
    return JR.RasterConfig(backend="xla", **kw), TR.RasterConfig(**kw)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_bin_triangles_match_jax():
    verts, faces, fvalid = _soup(3)
    jc, tc = _cfgs()
    pts = JR.project_mesh(jnp.asarray(verts), jnp.asarray(POSE),
                          jnp.asarray(INTR))
    ref = [np.asarray(x) for x in JR._bin_triangles(
        pts, jnp.asarray(faces), jnp.asarray(fvalid), jc)]
    out = [x.numpy() for x in TR._bin_triangles(
        _t(pts), _t(faces).long(), _t(fvalid), tc)]
    np.testing.assert_array_equal(out[1], ref[1])            # tile_valid
    np.testing.assert_array_equal(out[0][ref[1]], ref[0][ref[1]])
    np.testing.assert_array_equal(out[2], ref[2])            # big list
    np.testing.assert_array_equal(out[3], ref[3])
    assert ref[3].sum() > 0 and ref[1].sum() > 0


def test_select_reference_matches_select_pallas():
    verts, faces, fvalid = _soup(3)
    jc, tc = _cfgs()
    pts = JR.project_mesh(jnp.asarray(verts), jnp.asarray(POSE),
                          jnp.asarray(INTR))
    tt, tv, bt, bv = JR._bin_triangles(pts, jnp.asarray(faces),
                                       jnp.asarray(fvalid), jc)
    T = jc.num_tiles
    cand = jnp.concatenate([tt, jnp.broadcast_to(bt, (T, jc.k_big))], 1)
    cval = jnp.concatenate([tv, jnp.broadcast_to(bv, (T, jc.k_big))], 1)
    coef = prepare_coeffs(pts[jnp.asarray(faces)], cand, cval, False)
    best, key = (np.asarray(x) for x in select_pallas(
        coef, jc.tile, jc.tiles_x, interpret=True))
    K = cand.shape[1]
    # the coefficients are the same numbers (the kernel's and the plain
    # version's order of operations is JAX's)
    tco = KS.prepare_coeffs(_t(pts), _t(faces).long(), _t(cand).long(),
                            _t(cval))
    np.testing.assert_array_equal(tco[..., :9].numpy(),
                                  np.asarray(coef)[:, :K, :9])
    np.testing.assert_allclose(tco[..., 9:].numpy(),
                               np.asarray(coef)[:, :K, 9:], rtol=1e-6)
    tb, tk = KS.select_reference(_t(pts), _t(faces).long(), _t(cand).long(),
                                 _t(cval), jc.tile, jc.tiles_x)
    np.testing.assert_array_equal(tb.numpy(), best)
    hit = key < 1e38
    assert hit.sum() > 1000
    np.testing.assert_array_equal(tk.numpy() < 1e38, hit)
    np.testing.assert_allclose(tk.numpy()[hit], key[hit], rtol=1e-5)
    # the wrapper takes the plain version for a CPU tensor, no launch
    before = KS.raster_select.launches
    b2, k2, f2 = KS.raster_select(_t(pts), _t(faces), _t(cand), _t(cval),
                                  jc.tile, jc.tiles_x)
    assert KS.raster_select.launches == before
    np.testing.assert_array_equal(b2.numpy(), tb.numpy())
    np.testing.assert_array_equal(k2.numpy(), tk.numpy())
    # the winner's face id, -1 where nothing covers
    want = np.where(hit, np.take_along_axis(np.asarray(cand), best, 1), -1)
    np.testing.assert_array_equal(f2.numpy(), want)


@pytest.mark.parametrize("tile", [8, 32])
def test_select_reference_other_tiles_match_select_pallas(tile):
    """Tiles other than 16 (32 is superres's 2048^2 bake, 8 one the kernel
    does not take): the plain version on the CPU, through the wrapper,
    against `select_pallas(interpret=True)` on the same candidates; the
    winners exactly, the keys within 1e-5 relative."""
    verts, faces, fvalid = _soup(5)
    jc, tc = _cfgs(tile=tile)
    pts = JR.project_mesh(jnp.asarray(verts), jnp.asarray(POSE),
                          jnp.asarray(INTR))
    tt, tv, bt, bv = JR._bin_triangles(pts, jnp.asarray(faces),
                                       jnp.asarray(fvalid), jc)
    T = jc.num_tiles
    cand = jnp.concatenate([tt, jnp.broadcast_to(bt, (T, jc.k_big))], 1)
    cval = jnp.concatenate([tv, jnp.broadcast_to(bv, (T, jc.k_big))], 1)
    coef = prepare_coeffs(pts[jnp.asarray(faces)], cand, cval, False)
    best, key = (np.asarray(x) for x in select_pallas(
        coef, tile, jc.tiles_x, interpret=True))
    before = KS.raster_select.launches
    tb, tk, tf = KS.raster_select(_t(pts), _t(faces), _t(tt), _t(tv), tile,
                                  jc.tiles_x, False, _t(bt), _t(bv))
    assert KS.raster_select.launches == before
    assert tb.shape == (T, tile * tile)
    np.testing.assert_array_equal(tb.numpy(), best)
    hit = key < 1e38
    assert hit.sum() > 500
    np.testing.assert_array_equal(tk.numpy() < 1e38, hit)
    np.testing.assert_allclose(tk.numpy()[hit], key[hit], rtol=1e-5)
    want = np.where(hit, np.take_along_axis(np.asarray(cand), best, 1), -1)
    np.testing.assert_array_equal(tf.numpy(), want)


def _raster_both(verts, faces, fvalid, **kw):
    jc, tc = _cfgs(**kw)
    jp = JR.project_mesh(jnp.asarray(verts), jnp.asarray(POSE),
                         jnp.asarray(INTR))
    rx = JR.rasterize(jp, jnp.asarray(faces), jnp.asarray(fvalid), jc)
    tp = TR.project_mesh(_t(verts), _t(POSE), _t(INTR))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-5)
    rt = TR.rasterize(tp, _t(faces), _t(fvalid), tc)
    return jc, tc, rx, rt


@pytest.mark.parametrize("seed,cull", [(3, False), (5, False), (3, True)])
def test_rasterize_matches_jax_xla(seed, cull):
    verts, faces, fvalid = _soup(seed)
    _, _, rx, rt = _raster_both(verts, faces, fvalid, cull_backface=cull)
    tid = rt["tri_id"].numpy()
    ref_id = np.asarray(rx["tri_id"])
    assert (ref_id >= 0).sum() > 1000
    assert (tid != ref_id).sum() <= tid.size // 500
    same = tid == ref_id
    for k in ("bary", "z", "alpha", "alpha_hard"):
        a, b = rt[k].numpy(), np.asarray(rx[k])
        m = same if a.ndim == 2 else same[..., None]
        assert np.abs(np.where(m, a - b, 0.0)).max() < 1e-5, k
    hit = (ref_id >= 0) & same
    np.testing.assert_array_equal(rt["winner_faces"].numpy()[hit],
                                  np.asarray(rx["winner_faces"])[hit])


def test_rasterize_gradient_matches_jax():
    """The JAX Pallas-backend test's loss; soup seed 3 has no mismatched
    pixel between the two selections."""
    verts, faces, fvalid = _soup(3)
    jc, tc, rx, rt = _raster_both(verts, faces, fvalid)
    assert (rt["tri_id"].numpy() == np.asarray(rx["tri_id"])).all()

    def jloss(v):
        r = JR.rasterize(JR.project_mesh(v, jnp.asarray(POSE),
                                         jnp.asarray(INTR)),
                         jnp.asarray(faces), jnp.asarray(fvalid), jc)
        return jnp.sum(r["alpha"]) + jnp.sum(r["bary"]) + jnp.sum(r["z"])
    gj = np.asarray(jax.grad(jloss)(jnp.asarray(verts)))
    tv = _t(verts).requires_grad_(True)
    r = TR.rasterize(TR.project_mesh(tv, _t(POSE), _t(INTR)), _t(faces),
                     _t(fvalid), tc)
    (r["alpha"].sum() + r["bary"].sum() + r["z"].sum()).backward()
    gt = tv.grad.numpy()
    assert np.isfinite(gt).all() and np.abs(gj).sum() > 0
    assert np.linalg.norm(gt - gj) <= 1e-4 * np.linalg.norm(gj)


def test_rasterize_empty_frame_finite():
    """Nothing covers any pixel: finite outputs and a finite, zero
    gradient (the dummy winner is degenerate)."""
    verts = torch.zeros((8, 3), requires_grad=True)
    faces = torch.zeros((16, 3), dtype=torch.long)
    tc = TR.RasterConfig(height=32, width=32)
    r = TR.rasterize(TR.project_mesh(verts, _t(POSE), _t(INTR)), faces,
                     torch.zeros(16, dtype=torch.bool), tc)
    assert (r["tri_id"] == -1).all()
    loss = r["alpha"].sum() + r["bary"].sum() + r["z"].sum()
    loss.backward()
    assert torch.isfinite(verts.grad).all() and float(loss) == 0.0


def _sphere_mesh():
    g = JGrid(16)
    v = jnp.asarray(g.verts)
    sdf = 0.6 - jnp.linalg.norm(v, axis=-1) \
        + 0.1 * jnp.sin(3 * v[:, 0]) * jnp.cos(2 * v[:, 1])
    mt = j_mts(g, g.arrays(), sdf, vert_cap=4096, face_cap=6144)
    return (np.asarray(mt["verts"]), np.asarray(mt["faces"]),
            np.asarray(mt["face_mask"]))


def test_interpolate_and_vertex_normals_match_jax():
    verts, faces, fmask = _sphere_mesh()
    vn_j = np.asarray(JRen.vertex_normals(jnp.asarray(verts),
                                          jnp.asarray(faces),
                                          jnp.asarray(fmask, jnp.float32)))
    vn_t = TRen.vertex_normals(_t(verts), _t(faces), _t(fmask).float())
    np.testing.assert_allclose(vn_t.numpy(), vn_j, atol=1e-5)
    _, tc = _cfgs()
    rt = TR.rasterize(TR.project_mesh(_t(verts), _t(POSE), _t(INTR)),
                      _t(faces), _t(fmask), tc)
    attr = np.random.default_rng(0).normal(size=(len(verts), 5)).astype(
        np.float32)
    # the JAX interpolate on the port's raster outputs (faces[tri] form)
    rj = {"tri_id": jnp.asarray(rt["tri_id"].numpy()),
          "bary": jnp.asarray(rt["bary"].numpy())}
    ref = np.asarray(JR.interpolate(jnp.asarray(attr), rj,
                                    jnp.asarray(faces)))
    out = TR.interpolate(_t(attr), rt, _t(faces)).numpy()
    assert (rt["tri_id"] >= 0).sum() > 500
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_render_mesh_attrs_matches_jax():
    """A pose off the sphere's symmetry planes: from the axis-aligned POSE
    the tet grid's x = y faces project edge-on through pixel centres,
    exact ties that each selection's rounding decides. Capacities that
    drop no candidate (K 512 + 32)."""
    from scipy.spatial.transform import Rotation
    verts, faces, fmask = _sphere_mesh()
    pose = POSE.copy()
    pose[:, :3] = Rotation.from_euler("xyz", [0.3, 0.2, 0.1]).as_matrix()
    kw = dict(height=64, width=64, k_per_tile=512, k_big=32, span=2)
    jc = JR.RasterConfig(backend="pallas_interpret", **kw)
    rng = np.random.default_rng(1)
    attrs = {"feat": rng.normal(size=(len(verts), 5)).astype(np.float32),
             "xyz": verts}
    rj = JR.render_mesh_attrs(jnp.asarray(verts), jnp.asarray(faces),
                              jnp.asarray(fmask), jnp.asarray(pose),
                              jnp.asarray(INTR), jc,
                              {k: jnp.asarray(a) for k, a in attrs.items()})
    rt = TR.render_mesh_attrs(_t(verts), _t(faces), _t(fmask), _t(pose),
                              _t(INTR), TR.RasterConfig(**kw),
                              {k: _t(a) for k, a in attrs.items()})
    assert set(rt) == set(rj)
    assert (rt["tri_id"] >= 0).sum() > 1000
    np.testing.assert_array_equal(rt["tri_id"].numpy(),
                                  np.asarray(rj["tri_id"]))
    for k in ("bary", "z", "alpha", "alpha_hard", "feat", "xyz"):
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert rt["feat"].shape == (64, 64, 5)
    plain = TR.render_mesh_attrs(_t(verts), _t(faces), _t(fmask), _t(pose),
                                 _t(INTR), TR.RasterConfig(**kw))
    assert set(plain) == set(rt) - set(attrs)


@pytest.mark.parametrize("ssaa", [1, 2])
def test_render_views_with_field_shading_matches_jax(ssaa):
    from mvedit_tpu.utils import camera as cu
    verts, faces, fmask = _sphere_mesh()
    jcfg = JINGPConfig(backend="dense", dense=JDense(resolutions=(8, 16)),
                       hidden_dim=16)
    tcfg = TF.INGPConfig(backend="dense", dense=TDense(resolutions=(8, 16)),
                         hidden_dim=16)
    jparams = j_ingp_init(jax.random.PRNGKey(0), jcfg)
    # larger table values than the init's 1e-4, so the colours vary
    jparams["table"] = jax.tree_util.tree_map(
        lambda x: x * 3000.0, jparams["table"])
    tparams = TF.field_params_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams))
    poses = cu.get_pose_from_angles(np.array([0.3, 2.0]),
                                    np.array([0.2, -0.1]), 2.5)[:, :3]
    intr = np.tile([130.0, 130.0, 32.0, 32.0], (2, 1)).astype(np.float32)
    jc, tc = _cfgs()
    ref = JRen.render_views(jnp.asarray(verts), jnp.asarray(faces),
                            jnp.asarray(fmask), jnp.asarray(poses),
                            jnp.asarray(intr), jc,
                            shading_fun=JFieldShading(jcfg),
                            shading_params=jparams, bg_color=1.0, ssaa=ssaa)
    out = TRen.render_views(_t(verts), _t(faces), _t(fmask), _t(poses),
                            _t(intr), tc, shading_fun=TF.FieldShading(tcfg),
                            shading_params=tparams, bg_color=1.0, ssaa=ssaa)
    hard_t = out["alpha_hard"].numpy()[..., 0]
    hard_j = np.asarray(ref["alpha_hard"])[..., 0]
    assert hard_j.sum() > 1000
    # with ssaa the maps are pooled: compare where the coverage agrees
    assert (np.abs(hard_t - hard_j) > 1e-6).sum() <= hard_t.size // 500
    same = np.abs(hard_t - hard_j) <= 1e-6
    for k, tol in (("xyz", 1e-5), ("normal", 1e-4), ("depth", 1e-5),
                   ("alpha", 1e-4), ("rgb", 1e-4)):
        a, b = out[k].numpy(), np.asarray(ref[k])
        m = same if a.ndim == 3 else same[..., None]
        assert np.abs(np.where(m, a - b, 0.0)).max() < tol, k
