"""The port's field, losses and DMTet mesh fit against the JAX package's, on
the CPU in fp32 (tet 16, 64^2, 3 views).

- Encoder and field: `dense_grid_encode` with the bf16 gather and
  `ingp_point_decode` with params bridged by `field_params_from_flax`,
  within 1e-6 / 1e-5 (the same bf16-rounded table values, blended in f32
  in another summation order).
- Losses: `Tonemapping` lut / inverse, `l1_loss`, `mse_loss`, `tv_loss`,
  `laplacian_loss`, `normal_consistency_loss` and `init_sdf_from_density`
  within 1e-6 .. 1e-5 (f32 reductions in another order).
- One fit step, with JAX's random draws (view ids, regulariser faces)
  injected: the loss and the gradients w.r.t. sdf, deform and every field
  tensor within 1e-4 relative L2, and the state after the Adam step too.
  With the bf16 gather the table gradients are accumulated in bf16 by both
  frameworks, in another order (JAX's differ from the exact f64 gradient
  by ~6e-3 relative L2 on their own), so there the tables are held to
  2e-2 and every other gradient to 1e-4.
- Eight steps with frozen topology (f32 gather): the loss of every step,
  the final sdf and deform within 1e-3 relative. The field tensors are
  held to 2e-2 relative L2: Adam's eps of 1e-15 turns every table entry
  whose gradient nearly cancels into a full +-lr step whose sign rides on
  rounding, so ~0.3% of the table entries end a step apart (measured: max
  |d| 0.03, relative L2 1.3e-2), while loss and geometry stay within 1e-4.
  The final extraction: the same topology, vertices within 5e-3 relative.

JAX's per-step loss is `make_mesh_fit`'s own `loss_fn`, read from the
closure of the function it returns.
"""
import inspect

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
from mvedit_tpu.models.fields import ingp_point_decode as j_decode
from mvedit_tpu.models.mesh.rasterize import RasterConfig as JRC
from mvedit_tpu.models.mesh.structured_tets import StructuredTetGrid as JGrid
from mvedit_tpu.models.mesh.structured_tets import \
    marching_tets_structured as j_mts
from mvedit_tpu.ops.dense_grid import DenseGridConfig as JDense
from mvedit_tpu.ops.dense_grid import dense_grid_encode as j_encode
from mvedit_tpu.ops.tonemapping import Tonemapping as JTM
from mvedit_tpu.utils import camera as cam_utils

from mvedit_tpu_torch.models import fields as TF
from mvedit_tpu_torch.models import losses as TL
from mvedit_tpu_torch.models import mesh_fit as TMF
from mvedit_tpu_torch.models.mesh.rasterize import RasterConfig as TRC
from mvedit_tpu_torch.models.mesh.structured_tets import \
    StructuredTetGrid as TGrid
from mvedit_tpu_torch.ops.dense_grid import DenseGridConfig as TDense
from mvedit_tpu_torch.ops.dense_grid import dense_grid_encode as t_encode
from mvedit_tpu_torch.ops.tonemapping import Tonemapping as TTM

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


def _field_cfgs(gather="bfloat16", res=(8, 32)):
    return (JINGP(backend="dense", dense=JDense(resolutions=res,
                                                gather_dtype=gather)),
            TF.INGPConfig(backend="dense", dense=TDense(resolutions=res,
                                                        gather_dtype=gather)))


def _jfield(jcfg, seed=0, table_scale=1000.0):
    """A JAX field whose tables are scaled up from the init's 1e-4, so the
    colours and densities vary over space."""
    p = j_ingp_init(jax.random.PRNGKey(seed), jcfg)
    p["table"] = jax.tree_util.tree_map(lambda x: x * table_scale, p["table"])
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.mark.parametrize("gather", ["bfloat16", "float32"])
def test_dense_grid_and_field_decode_match_jax(gather):
    jcfg, tcfg = _field_cfgs(gather)
    params = _jfield(jcfg)
    x = np.random.default_rng(0).uniform(-1.05, 1.05, (4000, 3)).astype(
        np.float32)
    enc_j = np.asarray(j_encode(params["table"], (x + 1) / 2, jcfg.dense))
    tp = TF.field_params_from_flax(params)
    enc_t = t_encode(tp["table"], _t((x + 1) / 2), tcfg.dense).numpy()
    np.testing.assert_allclose(enc_t, enc_j, atol=1e-6)
    sj, cj = (np.asarray(a) for a in j_decode(params, jnp.asarray(x), jcfg))
    st, ct = TF.ingp_point_decode(tp, _t(x), tcfg)
    np.testing.assert_allclose(st.numpy(), sj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-5, atol=1e-6)


def test_hash_backend_raises():
    """The hash backend, the field's default, at its full width: it no
    longer raises, and `ingp_init` builds a (12, 2^19, 2) table under an
    MLP over its 24 features. (The name stays from when the backend
    raised; `test_torch_hash_grid.py` holds its values and its leaf order
    against the JAX field at a tiny width.)"""
    cfg = TF.INGPConfig()
    p = TF.ingp_init(cfg, torch.Generator().manual_seed(0))
    assert p["table"].shape == (12, 2 ** 19, 2)
    assert cfg.enc_dim == 24 and p["mlp"][0]["w"].shape == (24, 64)


def test_tonemapping_and_image_losses_match_jax():
    jt, tt = JTM(), TTM()
    # JAX's linspace rounds a few knots one ulp off numpy's
    np.testing.assert_allclose(tt.lut_x.numpy(), np.asarray(jt.lut_x),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tt.lut_y.numpy(), np.asarray(jt.lut_y),
                               rtol=1e-6)
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-12, 6, 3000),
                        np.asarray(jt.lut_x)]).astype(np.float32)
    y = np.concatenate([rng.uniform(-0.2, 1.2, 3000),
                        np.asarray(jt.lut_y)]).astype(np.float32)
    np.testing.assert_allclose(tt.lut(_t(x)).numpy(),
                               np.asarray(jt.lut(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tt.inverse_lut(_t(y)).numpy(),
                               np.asarray(jt.inverse_lut(jnp.asarray(y))),
                               rtol=1e-6, atol=1e-5)
    a, b = (rng.random((2, 3, 16, 16)).astype(np.float32) for _ in range(2))
    w = rng.random((2, 3, 16, 16)).astype(np.float32)
    np.testing.assert_allclose(
        float(TL.l1_loss(_t(a), _t(b), weight=_t(w[:, :1, :1, :1]))),
        float(JL.l1_loss(a, b, weight=w[:, :1, :1, :1])), rtol=1e-6)
    for tgt, wt in ((None, None), (b, None), (b, w)):
        ref = float(JL.tv_loss(a, tgt, weight=wt, power=1.5))
        out = float(TL.tv_loss(_t(a), None if tgt is None else _t(tgt),
                               weight=None if wt is None else _t(wt),
                               power=1.5))
        np.testing.assert_allclose(out, ref, rtol=1e-5)


@pytest.mark.parametrize("weight", ["none", "broadcast", "full"])
def test_mse_loss_matches_jax(weight):
    rng = np.random.default_rng(9)
    a, b = (rng.random((2, 3, 16, 16)).astype(np.float32) for _ in range(2))
    w = {"none": None, "full": rng.random((2, 3, 16, 16)),
         "broadcast": rng.random((2, 1, 1, 1))}[weight]
    w = None if w is None else w.astype(np.float32)
    out = float(TL.mse_loss(_t(a), _t(b), None if w is None else _t(w)))
    ref = float(JL.mse_loss(a, b, w))
    assert out > 0
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def _mesh(g=16):
    jg = JGrid(g)
    v = jnp.asarray(jg.verts)
    sdf = 0.6 - jnp.linalg.norm(v, axis=-1) \
        + 0.1 * jnp.sin(3 * v[:, 0]) * jnp.cos(2 * v[:, 1])
    deform = 0.02 * jax.random.normal(jax.random.PRNGKey(2), v.shape)
    mt = j_mts(jg, jg.arrays(), sdf, deform=deform, vert_cap=4096,
               face_cap=6144)
    return {k: np.asarray(x) for k, x in mt.items()}


def test_regularisers_and_sdf_init_match_jax():
    mt = _mesh()
    args = (mt["verts"], mt["faces"], mt["face_mask"])
    np.testing.assert_allclose(
        float(TMF.laplacian_loss(*(_t(a) for a in args),
                                 _t(mt["vert_mask"]))),
        float(JMF.laplacian_loss(*args, mt["vert_mask"])), rtol=1e-5)
    np.testing.assert_allclose(
        float(TMF.normal_consistency_loss(*(_t(a) for a in args))),
        float(JMF.normal_consistency_loss(*args)), rtol=1e-5)
    jcfg, tcfg = _field_cfgs()
    params = _jfield(jcfg, seed=1)
    tp = TF.field_params_from_flax(params)
    # the field's own density, and two contrived ones that trigger the
    # high- and the low-contrast fallbacks to the 70th percentile
    for f in (lambda s: s, lambda s: s + 100.0, lambda s: s * 1e-3):
        ref = np.asarray(JMF.init_sdf_from_density(
            lambda x: f(j_decode(params, x, jcfg)[0]), JGrid(16)))
        out = TMF.init_sdf_from_density(
            lambda x: f(TF.ingp_point_decode(tp, x, tcfg)[0]),
            TGrid(16)).numpy()
        assert 0 < (ref > 0).mean() < 1
        np.testing.assert_allclose(out, ref, atol=1e-6)


# ---- the fit ---------------------------------------------------------------

RS, G, N_VIEWS, N_REG = 64, 16, 3, 2048


def _targets():
    rng = np.random.default_rng(0)
    poses, intr = surround_rig(N_VIEWS, 3.7, 30, -0.3, 0.6, RS, rng=rng)
    lights, _ = cam_utils.light_sampling(poses, rng=rng)
    yy, xx = np.mgrid[:RS, :RS] / RS
    masks = np.stack([((xx - 0.5 - 0.05 * i) ** 2 + (yy - 0.5) ** 2 < 0.1)
                      for i in range(N_VIEWS)]).astype(np.float32)[..., None]
    images = np.stack([np.stack([xx, yy, 0.5 + 0.3 * np.sin(6 * xx + i)], -1)
                       for i in range(N_VIEWS)]).astype(np.float32)
    images = images * masks + (1 - masks)
    return {"images": images, "masks": masks,
            "poses": poses.astype(np.float32), "intrinsics": intr,
            "cam_weights": np.array([1.0, 0.5, 2.0], np.float32),
            "cam_lights": lights.astype(np.float32)}


def _state(jcfg):
    v = JGrid(G).verts
    rng = np.random.default_rng(3)
    sdf = (0.6 - np.linalg.norm(v, axis=-1)
           + 0.1 * np.sin(3 * v[:, 0]) * np.cos(2 * v[:, 1])).astype(
        np.float32)
    return {"field": _jfield(jcfg, seed=4, table_scale=300.0), "sdf": sdf,
            "deform": (0.3 * rng.standard_normal(v.shape)).astype(np.float32)}


def _fit_cfgs(n_steps):
    kw = dict(n_steps=n_steps, reg_face_samples=N_REG, freeze_topology=True,
              normal_reg_weight=5.0)
    rc = dict(height=RS, width=RS, span=2, k_per_tile=256)
    return (JMF.MeshFitConfig(raster=JRC(**rc), **kw),
            TMF.MeshFitConfig(raster=TRC(**rc), **kw))


def _jax_draws(key, n_steps, cam_weights, render_bs=2, face_cap=6144):
    """The draws of JAX's fit for `key`, made by the same calls in the same
    order as `make_mesh_fit`'s `_fit` / `sample_batch` / `loss_fn`."""
    keys = jax.random.split(key, n_steps)
    p = (jnp.asarray(cam_weights) > 0).astype(jnp.float32)
    logits = jnp.log(jnp.clip(p, 1e-9, None))[None].repeat(render_bs, 0)
    ids, rfs = [], []
    for k in keys:
        k1, k2 = jax.random.split(k)
        ids.append(np.asarray(jax.random.categorical(k1, logits)))
        rfs.append(np.asarray(jax.random.randint(k2, (N_REG,), 0, face_cap)))
    return {"view_ids": _t(np.stack(ids)).long(),
            "reg_faces": _t(np.stack(rfs)).long()}


def _torch_state(state):
    return {"field": TF.field_params_from_flax(state["field"]),
            "sdf": _t(state["sdf"]), "deform": _t(state["deform"])}


def _leaves(state):
    return [state["sdf"], state["deform"]] + TF.field_leaves(state["field"])


def _jax_leaves(state):
    f = state["field"]
    return ([state["sdf"], state["deform"]]
            + [f["table"][k] for k in sorted(f["table"])]
            + [l[n] for l in f["mlp"] for n in ("w", "b")])


def _run_port(tcfg_f, tcfg, state, targets, draws):
    fit, make_opt, _ = TMF.make_mesh_fit(TGrid(G), TF.FieldColor(tcfg_f),
                                         tcfg)
    ts = _torch_state(state)
    opt = make_opt(ts)
    ts, opt, out = fit(ts, opt, {k: _t(v) for k, v in targets.items()},
                       draws=draws)
    return ts, out


@pytest.mark.parametrize("gather", ["float32", "bfloat16"])
def test_one_fit_step_matches_jax(gather):
    jf, tf_ = _field_cfgs(gather)
    jcfg, tcfg = _fit_cfgs(1)
    targets, state = _targets(), _state(jf)
    key = jax.random.PRNGKey(7)
    jgrid = JGrid(G)
    fit, opt, _ = JMF.make_mesh_fit(jgrid, JFieldColor(jf), jcfg)
    inner = inspect.getclosurevars(fit).nonlocals["_fit"].__wrapped__
    loss_fn = inspect.getclosurevars(inner).nonlocals["loss_fn"]
    sample_batch = inspect.getclosurevars(inner).nonlocals["sample_batch"]
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    js = jax.tree_util.tree_map(jnp.asarray, state)
    k1, k2 = jax.random.split(jax.random.split(key, 1)[0])
    topo = _jax_topology(jgrid, js["sdf"])
    (loss_j, _), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        js, sample_batch(k1, jt), k2, jgrid.arrays(),
        JMF.default_mesh_schedule_weights(jcfg), None, topo=topo)
    s1_j, _, out_j = fit(js, opt.init(js), jt, key)
    np.testing.assert_allclose(float(out_j["loss"][0]), float(loss_j),
                               rtol=1e-6)

    ts, out = _run_port(tf_, tcfg, state, targets,
                        _jax_draws(key, 1, targets["cam_weights"]))
    np.testing.assert_allclose(float(out["loss"][0]), float(loss_j),
                               rtol=1e-4)
    n_tables = len(state["field"]["table"])
    for i, (p, gj, sj) in enumerate(zip(_leaves(ts), _jax_leaves(grads_j),
                                        _jax_leaves(s1_j))):
        table = 2 <= i < 2 + n_tables
        tol = 2e-2 if table and gather == "bfloat16" else 1e-4
        assert np.abs(np.asarray(gj)).max() > 0, i
        assert _rel(p.grad.numpy(), gj) <= tol, (i, _rel(p.grad.numpy(), gj))
        assert _rel(p.detach().numpy(), sj) <= tol, i


def _jax_topology(jgrid, sdf):
    from mvedit_tpu.models.mesh.structured_tets import marching_tets_topology
    return marching_tets_topology(jgrid, jgrid.arrays(), sdf,
                                  vert_cap=4096, face_cap=6144)


def test_eight_step_frozen_fit_matches_jax():
    jf, tf_ = _field_cfgs("float32")
    jcfg, tcfg = _fit_cfgs(8)
    targets, state = _targets(), _state(jf)
    key = jax.random.PRNGKey(11)
    fit, opt, _ = JMF.make_mesh_fit(JGrid(G), JFieldColor(jf), jcfg)
    js = jax.tree_util.tree_map(jnp.asarray, state)
    s8_j, _, out_j = fit(js, opt.init(js),
                         {k: jnp.asarray(v) for k, v in targets.items()}, key)
    ts, out = _run_port(tf_, tcfg, state, targets,
                        _jax_draws(key, 8, targets["cam_weights"]))
    np.testing.assert_allclose(out["loss"].numpy(), np.asarray(out_j["loss"]),
                               rtol=1e-3)
    for i, (p, sj) in enumerate(zip(_leaves(ts), _jax_leaves(s8_j))):
        tol = 1e-3 if i < 2 else 2e-2      # sdf, deform | field tensors
        assert _rel(p.detach().numpy(), sj) <= tol, (i, _rel(p.detach().numpy(), sj))
    for k in ("n_verts", "n_faces"):
        assert int(out["mt"][k]) == int(out_j["mt"][k])
    np.testing.assert_array_equal(out["mt"]["faces"].numpy(),
                                  np.asarray(out_j["mt"]["faces"]))
    # a vertex between two nearly equal sdf values slides along its edge
    # with the last bits of sdf: a few of them move by up to ~0.03
    assert _rel(out["mt"]["verts"].numpy(), out_j["mt"]["verts"]) <= 5e-3


# ---- tet 256 and the LPIPS branch ------------------------------------------

@pytest.mark.parametrize("n", [2 ** 24 + 1, 257 ** 3])
def test_percentiles_take_any_size(n):
    """`torch.quantile` refuses more than 2^24 elements; the port's
    percentile takes the 257^3 verts of a tet-256 grid and agrees with
    `np.percentile` (linear interpolation) to 1e-6 relative."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        n).astype(np.float32) ** 2)
    out = TMF.percentiles(x, (70.0, 95.0))
    ref = np.percentile(x.numpy(), [70.0, 95.0])
    np.testing.assert_allclose([float(o) for o in out], ref, rtol=1e-6)


def test_init_sdf_at_tet_256_matches_jax():
    """The switch to DMTet at tet 256 (257^3 = 16,974,593 verts) on an
    analytic density with a surface near radius 0.55: the same sdf as JAX's
    `jnp.percentile` path, within 1e-6."""
    def dens_j(x):
        r = jnp.sqrt(jnp.sum(x * x, -1))
        return 12.0 * jnp.exp(-(r / 0.45) ** 4) + 0.5 * jnp.sin(4 * x[:, 0])

    def dens_t(x):
        r = torch.sqrt((x * x).sum(-1))
        return 12.0 * torch.exp(-(r / 0.45) ** 4) + 0.5 * torch.sin(
            4 * x[:, 0])
    ref = np.asarray(JMF.init_sdf_from_density(dens_j, JGrid(256)))
    out = TMF.init_sdf_from_density(dens_t, TGrid(256)).numpy()
    assert out.shape == (257 ** 3,) and 0.01 < (ref > 0).mean() < 0.5
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_one_fit_step_with_lpips_matches_jax():
    """One mesh-fit step with the patch LPIPS on (VGG16 at its published
    widths, 32^2 windows of the 64^2 renders, their origins from JAX's
    fold_in(k2, 7)): the loss and every gradient within 1e-4 relative,
    the LPIPS term's share of the loss checked non-zero."""
    from mvedit_tpu_torch.models import losses as TLo
    from torch_jax_draws import mesh_fit_draws
    jf, tf_ = _field_cfgs("float32")
    kw = dict(n_steps=1, reg_face_samples=N_REG, freeze_topology=True,
              normal_reg_weight=5.0, patch_size=32)
    rc = dict(height=RS, width=RS, span=2, k_per_tile=256)
    jcfg = JMF.MeshFitConfig(raster=JRC(**rc), **kw)
    tcfg = TMF.MeshFitConfig(raster=TRC(**rc), **kw)
    targets, state = _targets(), _state(jf)
    key = jax.random.PRNGKey(13)
    lp = jax.tree_util.tree_map(np.asarray,
                                JL.lpips_init(jax.random.PRNGKey(1)))
    sw = {**JMF.default_mesh_schedule_weights(jcfg), "patch_rgb": 1.2}
    jgrid = JGrid(G)
    fit, _, _ = JMF.make_mesh_fit(jgrid, JFieldColor(jf), jcfg)
    inner = inspect.getclosurevars(fit).nonlocals["_fit"].__wrapped__
    nl = inspect.getclosurevars(inner).nonlocals
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    js = jax.tree_util.tree_map(jnp.asarray, state)
    k1, k2 = jax.random.split(jax.random.split(key, 1)[0])
    batch = nl["sample_batch"](k1, jt)
    topo = _jax_topology(jgrid, js["sdf"])
    sw_j = {k: jnp.float32(v) for k, v in sw.items()}
    (loss_j, _), grads_j = jax.value_and_grad(nl["loss_fn"], has_aux=True)(
        js, batch, k2, jgrid.arrays(), sw_j, lp, topo=topo)
    loss_off = float(nl["loss_fn"](js, batch, k2, jgrid.arrays(), sw_j,
                                   None, topo=topo)[0])
    assert float(loss_j) - loss_off > 1e-3

    fit_t, make_opt, _ = TMF.make_mesh_fit(TGrid(G), TF.FieldColor(tf_),
                                           tcfg)
    ts = _torch_state(state)
    ts, _, out = fit_t(ts, make_opt(ts), {k: _t(v) for k, v in
                                          targets.items()},
                       sched=sw, lpips_params=TLo.lpips_params_from_flax(lp),
                       draws=mesh_fit_draws(key, 1, targets["cam_weights"],
                                            tcfg, 6144, lpips=True))
    np.testing.assert_allclose(float(out["loss"][0]), float(loss_j),
                               rtol=1e-4)
    for i, (p, gj) in enumerate(zip(_leaves(ts), _jax_leaves(grads_j))):
        assert _rel(p.grad.numpy(), gj) <= 1e-4, (i, _rel(p.grad.numpy(), gj))
