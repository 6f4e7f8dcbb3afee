"""The unstructured DMTet grid (`models/mesh/dmtet.py`) in the port against
the JAX package's, on the CPU in fp32:

- `build_grid_tets` at tet 8, 12 and 16, sphere crop on and off: verts,
  tets, the unique edges in their order and the tet -> edge map equal; a
  tet-32 grid cached in the port's own directory and read back equal;
- `marching_tets` and `marching_tets_compact` (caps that hold every
  crossing, and caps that overflow): every integer output and both counts
  equal, the vertices equal (the same f32 lerp op by op), and their
  gradients w.r.t. sdf and deform through a fixed random cotangent within
  1e-6 of the largest entry;
- one mesh-fit step on the tet-16 grid, through `marching_tets_compact`
  (caps) and the full buffers (no caps), with JAX's draws injected: the
  loss and the gradients w.r.t. sdf, deform and every field tensor within
  1e-4 relative L2, as `test_torch_mesh_fit.py` holds the structured fit;
  `freeze_topology` refused (ValueError);
- the pipeline's switch with `structured_tets=False` (`_init_mesh_phase`)
  and a 2-step chunk of its fit against JAX's: the grid equal, sdf0
  within 1e-6, the first step's loss within 1e-5 relative, the second's
  within 1e-2 (Adam's eps of 1e-15 parts the chains after a step, as
  `test_torch_mesh_phase.py` measures for the structured grid).
"""
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.models import mesh_fit as JMF
from mvedit_tpu.models.fields import FieldColor as JFieldColor
from mvedit_tpu.models.mesh import dmtet as JD
from mvedit_tpu.models.mesh.rasterize import RasterConfig as JRC
from mvedit_tpu.pipelines.mvedit_3d import MVEdit3DConfig as JCfg
from mvedit_tpu.pipelines.mvedit_3d import MVEdit3DPipeline as JPipe

from mvedit_tpu_torch.models import fields as TF
from mvedit_tpu_torch.models import mesh_fit as TMF
from mvedit_tpu_torch.models.mesh import dmtet as TD
from mvedit_tpu_torch.models.mesh.rasterize import RasterConfig as TRC
from mvedit_tpu_torch.pipelines.mvedit_3d import MVEdit3DConfig as TCfg
from mvedit_tpu_torch.pipelines.mvedit_3d import MVEdit3DPipeline as TPipe

from test_torch_mesh_fit import (_field_cfgs, _jax_leaves, _jfield, _leaves,
                                 _rel, _t, _targets)
from torch_jax_draws import mesh_fit_draws

torch.set_num_threads(2)

_ARRAYS = ("verts", "tets", "unique_edges", "tet_edge_idx")


def _sdf(verts, seed):
    rng = np.random.default_rng(seed)
    sdf = (0.55 - np.linalg.norm(verts, axis=-1)
           + 0.15 * np.sin(4 * verts[:, 0]) * np.cos(3 * verts[:, 1])
           + 0.02 * rng.standard_normal(len(verts))).astype(np.float32)
    deform = (0.01 * rng.standard_normal(verts.shape)).astype(np.float32)
    return sdf, deform


@pytest.mark.parametrize("g,crop", [(8, True), (12, False), (16, True)])
def test_build_grid_tets_matches_jax(g, crop):
    ref = JD.build_grid_tets(g, crop_sphere=crop)
    out = TD.build_grid_tets(g, crop_sphere=crop)
    for k in _ARRAYS:
        np.testing.assert_array_equal(getattr(out, k), getattr(ref, k),
                                      err_msg=k)
    assert out.max_faces == 2 * len(ref.tets)


def test_build_grid_tets_caches_in_its_own_directory(tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("MVEDIT_TORCH_TET_CACHE", str(tmp_path))
    first = TD.build_grid_tets(32)
    assert [p.name for p in tmp_path.iterdir()] == ["tets_32_1_1.npz"]
    again = TD.build_grid_tets(32)
    for k in _ARRAYS:
        np.testing.assert_array_equal(getattr(again, k), getattr(first, k))


@pytest.mark.parametrize("g,caps", [(8, None), (16, None), (16, (4096, 6144)),
                                    (16, (200, 300))])
def test_marching_tets_match_jax(g, caps):
    jg, tg = JD.build_grid_tets(g), TD.build_grid_tets(g)
    sdf, deform = _sdf(jg.verts, g)
    if caps is None:
        def j_run(s, d):
            return JD.marching_tets(jg, s, deform=d)

        def t_run(s, d):
            return TD.marching_tets(tg, s, deform=d)
    else:
        def j_run(s, d):
            return JD.marching_tets_compact(jg, s, d, *caps)

        def t_run(s, d):
            return TD.marching_tets_compact(tg, s, d, *caps)
    ref = j_run(jnp.asarray(sdf), jnp.asarray(deform))
    s = torch.from_numpy(sdf).requires_grad_(True)
    d = torch.from_numpy(deform).requires_grad_(True)
    out = t_run(s, d)
    assert set(out) == set(ref)
    for k in ref:
        if k != "verts":
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                          err_msg=k)
    np.testing.assert_array_equal(out["verts"].detach().numpy(),
                                  np.asarray(ref["verts"]))
    assert np.asarray(ref["face_mask"]).sum() > 0
    if caps == (200, 300):    # overflows both caps
        assert int(ref["n_verts"]) > 200 and int(ref["n_faces"]) > 300
    cot = np.random.default_rng(0).standard_normal(
        out["verts"].shape).astype(np.float32)
    gs_j, gd_j = jax.grad(lambda a, b: jnp.sum(j_run(a, b)["verts"] * cot),
                          argnums=(0, 1))(jnp.asarray(sdf),
                                          jnp.asarray(deform))
    (out["verts"] * torch.from_numpy(cot)).sum().backward()
    for gt, gj in ((s.grad, gs_j), (d.grad, gd_j)):
        gj = np.asarray(gj)
        assert np.abs(gj).max() > 0
        np.testing.assert_allclose(gt.numpy(), gj,
                                   atol=1e-6 * np.abs(gj).max())


G, N_REG = 16, 2048


def _state(jcfg, verts):
    sdf, _ = _sdf(verts, 3)
    rng = np.random.default_rng(4)
    return {"field": _jfield(jcfg, seed=4, table_scale=300.0), "sdf": sdf,
            "deform": (0.3 * rng.standard_normal(verts.shape)).astype(
                np.float32)}


@pytest.mark.parametrize("caps", [(4096, 6144), (0, 0)],
                         ids=["compact", "full"])
def test_one_fit_step_matches_jax(caps):
    jf, tf_ = _field_cfgs("float32")
    kw = dict(n_steps=1, reg_face_samples=N_REG, normal_reg_weight=5.0,
              vert_cap=caps[0], face_cap=caps[1])
    rc = dict(height=64, width=64, span=2, k_per_tile=256)
    jcfg = JMF.MeshFitConfig(raster=JRC(**rc), **kw)
    tcfg = TMF.MeshFitConfig(raster=TRC(**rc), **kw)
    jg, tg = JD.build_grid_tets(G), TD.build_grid_tets(G)
    targets, state = _targets(), _state(jf, jg.verts)
    key = jax.random.PRNGKey(7)
    fit, opt, _ = JMF.make_mesh_fit(jg, JFieldColor(jf), jcfg)
    inner = inspect.getclosurevars(fit).nonlocals["_fit"].__wrapped__
    nl = inspect.getclosurevars(inner).nonlocals
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    js = jax.tree_util.tree_map(jnp.asarray, state)
    k1, k2 = jax.random.split(jax.random.split(key, 1)[0])
    (loss_j, _), grads_j = jax.value_and_grad(nl["loss_fn"], has_aux=True)(
        js, nl["sample_batch"](k1, jt), k2, jg.arrays(),
        JMF.default_mesh_schedule_weights(jcfg), None)

    fit_t, make_opt, _ = TMF.make_mesh_fit(tg, TF.FieldColor(tf_), tcfg)
    face_cap = caps[1] or tg.max_faces
    assert fit_t.face_cap == face_cap
    ts = {"field": TF.field_params_from_flax(state["field"]),
          "sdf": _t(state["sdf"]), "deform": _t(state["deform"])}
    ts, _, out = fit_t(ts, make_opt(ts), {k: _t(v) for k, v in
                                          targets.items()},
                       draws=mesh_fit_draws(key, 1, targets["cam_weights"],
                                            tcfg, face_cap))
    np.testing.assert_allclose(float(out["loss"][0]), float(loss_j),
                               rtol=1e-4)
    for i, (p, gj) in enumerate(zip(_leaves(ts), _jax_leaves(grads_j))):
        assert np.abs(np.asarray(gj)).max() > 0, i
        assert _rel(p.grad.numpy(), gj) <= 1e-4, (i, _rel(p.grad.numpy(), gj))
    assert int(out["mt"]["face_mask"].sum()) > 0
    with pytest.raises(ValueError, match="StructuredTetGrid"):
        TMF.make_mesh_fit(tg, TF.FieldColor(tf_), TMF.MeshFitConfig(
            raster=TRC(**rc), freeze_topology=True))


def test_pipeline_switch_and_chunk_match_jax():
    jf, tf_ = _field_cfgs("float32")
    kw = dict(num_views=3, tet_resolution=G, render_size=64,
              fit_steps_per_program=2, structured_tets=False)
    jp = JPipe(types.SimpleNamespace(schedule=None), JCfg(ingp=jf, **kw))
    tp = TPipe(None, TCfg(ingp=tf_, **kw))
    field_j = _jfield(jf, seed=5, table_scale=1000.0)
    grid_j = JD.build_grid_tets(G)
    sdf0 = JMF.init_sdf_from_density(
        lambda x: jp._decode_fn(field_j, x)[0], grid_j)
    state_j = {"field": field_j, "sdf": sdf0,
               "deform": jnp.zeros((len(grid_j.verts), 3))}
    run_j = jp._mesh_fit_fns(grid_j, 2)[0]
    opt_j = jp._mesh_fit_fns(grid_j, 2)[1].init(state_j)
    grid_t, state_t, opt_t = tp._init_mesh_phase(
        TF.field_params_from_flax(field_j))
    assert isinstance(grid_t, TD.TetGrid)
    for k in _ARRAYS:
        np.testing.assert_array_equal(getattr(grid_t, k), getattr(grid_j, k))
    np.testing.assert_allclose(state_t["sdf"].detach().numpy(),
                               np.asarray(sdf0), atol=1e-6)
    assert 0 < float((state_t["sdf"] > 0).float().mean()) < 1

    targets = _targets()
    key = jax.random.PRNGKey(9)
    # the pipeline's fit at tet 16: the full buffers (no caps below tet
    # 32), no regulariser subsample, so the views are the only draws
    run_t = tp._mesh_fit_fns(grid_t, 2)[0]
    assert run_t.face_cap == grid_t.max_faces
    assert run_t.fit_cfg.reg_face_samples >= run_t.face_cap
    draws = [mesh_fit_draws(key, 2, targets["cam_weights"], run_t.fit_cfg,
                            run_t.face_cap)]
    sw = tp._sched_weights(0.7, "mesh")
    state_j, _, out_j = run_j(state_j, opt_j,
                              {k: jnp.asarray(v) for k, v in targets.items()},
                              key, sched=jp._sched_weights(0.7, "mesh"))
    state_t, _, out_t = run_t(state_t, opt_t,
                              {k: _t(v) for k, v in targets.items()},
                              sched=sw, draws=draws)
    loss_t, loss_j = out_t["loss"].numpy(), np.asarray(out_j["loss"])
    assert loss_t.shape == loss_j.shape == (2,)
    np.testing.assert_allclose(loss_t[0], loss_j[0], rtol=1e-5)
    np.testing.assert_allclose(loss_t[1], loss_j[1], rtol=1e-2)
    assert int(out_t["mt"]["face_mask"].sum()) > 0
