"""The DMTet mesh phase as a whole, port against the JAX package, on the CPU
in fp32 at tiny sizes: 3 views at 64^2, a torus mesh of 1152 faces, tet 16,
a dense field (8, 32) from the JAX init (tables scaled up), bridged.

The sequence is the one `run_3d_to_3d` runs before and after progress 0.6:
`load_init_mesh` on the `run_3d_to_3d` rig -> the switch to DMTet
(`mvedit_3d.py:847-862`: structured grid, sdf from the field's density,
zero deform, the optimizer) -> 4 fit steps in two chunks of 2 (two
topology refreshes) with the `_sched_weights(0.6, "mesh")` schedule and
JAX's draws -> the re-render through the mesh branch of `_render_chunk`
-> `normalize_depth`. Each package runs its own whole chain.

Tolerances:
- init renders, initial sdf, the loss of the first step: within 1e-4
  mean / 1e-6 / 1e-5 (measured: ~1e-8, exact, exact);
- the re-render branch on JAX's final mesh and field: 1e-4 mean, at most
  0.2% of the pixels off by more than 1e-3 (exact-tie edges);
- after four steps, the losses of the last chunk within 1e-2 relative,
  sdf within 4e-2 and deform within 0.16 relative L2, face counts within
  2%, the chains' re-renders within 1.5e-2 (rgb), 3e-2 (alpha, the depth
  map) and 0.15 (depth, in scene units) mean. Measured: 5.0e-3, 1.9e-2,
  8.0e-2, 0.3%, 6.2e-3, 1.3e-2, 1.7e-2, 6.0e-2; the re-render branch on
  JAX's mesh, ~1e-7. The
  chains part after step 1 for a reason of the reference's own: Adam's eps
  is 1e-15, so a table gradient of 1e-15 (a point's position one ulp
  apart, 8 entries of 287496 after step 1) becomes a half-lr step, and
  the fit amplifies it from there. The gradients themselves agree to 1e-6
  at step 1 (`tests/test_torch_mesh_fit.py` holds one step to 1e-4).
"""
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mvedit_tpu.apis.cameras import CONSTANTS, surround_rig
from mvedit_tpu.apis.endpoints import EndpointsMixin as JEndpoints
from mvedit_tpu.models import mesh_fit as JMF
from mvedit_tpu.models.mesh import structured_tets as JS
from mvedit_tpu.models.fields import INGPConfig as JINGP
from mvedit_tpu.models.fields import ingp_init as j_ingp_init
from mvedit_tpu.models.mesh.structured_tets import StructuredTetGrid as JGrid
from mvedit_tpu.ops.dense_grid import DenseGridConfig as JDense
from mvedit_tpu.pipelines.mvedit_3d import MVEdit3DConfig as JCfg
from mvedit_tpu.pipelines.mvedit_3d import MVEdit3DPipeline as JPipe
from mvedit_tpu.utils import camera as cam_utils
from mvedit_tpu.utils.geometry import normalize_depth as j_normalize_depth

from mvedit_tpu_torch.apis import Adapter3DRunner
from mvedit_tpu_torch.models.fields import INGPConfig as TINGP
from mvedit_tpu_torch.models.fields import field_params_from_flax
from mvedit_tpu_torch.ops.dense_grid import DenseGridConfig as TDense
from mvedit_tpu_torch.pipelines.mvedit_3d import MVEdit3DConfig as TCfg
from mvedit_tpu_torch.pipelines.mvedit_3d import MVEdit3DPipeline as TPipe
from mvedit_tpu_torch.utils.geometry import normalize_depth as t_normalize_depth

torch.set_num_threads(2)

RS, N, TET, STEPS, CHUNK = 64, 3, 16, 4, 2


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
    return types.SimpleNamespace(v=verts, f=faces.astype(np.int32), vc=None)


def _view_draws(key, n_steps, n_views, render_bs=2):
    keys = jax.random.split(key, n_steps)
    logits = jnp.zeros((render_bs, n_views))   # log(1) for every view
    ids = [np.asarray(jax.random.categorical(jax.random.split(k)[0], logits))
           for k in keys]
    return {"view_ids": torch.from_numpy(np.stack(ids)).long()}


def _close_maps(a, b, mean_tol, frac_tol, far):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert d.mean() <= mean_tol, d.mean()
    assert (d > far).mean() <= frac_tol, (d > far).mean()


def test_mesh_phase_matches_jax():
    mesh = _torus()
    rng = np.random.default_rng(0)
    c = CONSTANTS
    poses, intr = surround_rig(
        N, c["proc_3d_to_3d_camera_distance"], c["proc_3d_to_3d_fov"],
        c["proc_3d_to_3d_min_elev"], c["proc_3d_to_3d_max_elev"], RS, rng=rng)
    lights, _ = cam_utils.light_sampling(poses, rng=rng)

    # --- init renders
    init_j = {k: np.asarray(v) for k, v in JEndpoints.load_init_mesh(
        None, mesh, poses, intr, RS, lights).items()}
    runner = Adapter3DRunner(device="cpu", tiny_models=True)
    init_t = {k: v.numpy() for k, v in runner.load_init_mesh(
        mesh, poses, intr, RS, lights).items()}
    assert init_j["masks"].mean() > 0.05
    for k in ("images", "masks", "depths", "normals"):
        _close_maps(init_t[k], init_j[k], 1e-4, 2e-3, 1e-3)

    # --- the switch to DMTet
    kw = dict(num_views=N, tet_resolution=TET, render_size=RS,
              fit_steps_per_program=CHUNK)
    jp = JPipe(types.SimpleNamespace(schedule=None), JCfg(
        ingp=JINGP(backend="dense", dense=JDense(resolutions=(8, 32),
                                                 gather_dtype="float32")),
        **kw))
    tp = TPipe(None, TCfg(
        ingp=TINGP(backend="dense", dense=TDense(resolutions=(8, 32),
                                                 gather_dtype="float32")),
        **kw))
    # tables scaled up from the init's 1e-4: a field with some contrast,
    # as the NeRF fit leaves it, so the initial surface is not flat noise
    field_j = j_ingp_init(jax.random.PRNGKey(0), jp.cfg.ingp)
    field_j["table"] = jax.tree_util.tree_map(lambda x: x * 1000.0,
                                              field_j["table"])
    grid_j = JGrid(TET)
    sdf0 = JMF.init_sdf_from_density(
        lambda x: jp._decode_fn(field_j, x)[0], grid_j)
    state_j = {"field": field_j, "sdf": sdf0,
               "deform": jnp.zeros((len(grid_j.verts), 3))}
    opt_j = jp._mesh_fit_fns(grid_j, jp.cfg.n_inverse_steps)[1].init(state_j)
    grid_t, state_t, opt_t = tp._init_mesh_phase(field_params_from_flax(
        jax.tree_util.tree_map(np.asarray, field_j)))
    np.testing.assert_allclose(state_t["sdf"].detach().numpy(),
                               np.asarray(sdf0), atol=1e-6)

    # --- the first DMTet fit: 2 chunks of 2 steps
    def targets(init, as_array):
        return {"images": as_array(init["images"]),
                "masks": as_array(init["masks"]),
                "poses": as_array(poses.astype(np.float32)),
                "intrinsics": as_array(intr),
                "cam_weights": as_array(np.ones(N, np.float32)),
                "cam_lights": as_array(lights.astype(np.float32))}
    key = jax.random.PRNGKey(5)
    draws, k = [], key
    for _ in range(STEPS // CHUNK):          # the chunk keys of JAX's run
        k, kc = jax.random.split(k)
        draws.append(_view_draws(kc if STEPS > CHUNK else key, CHUNK, N))
    run_j = jp._mesh_fit_fns(grid_j, STEPS)[0]
    # JAX's loss of the first step, from `make_mesh_fit`'s own loss_fn (read
    # from the closures) on the first chunk's first draws, before the run
    # donates the initial state
    fit_l = inspect.getclosurevars(run_j).nonlocals.get("fit_l", run_j)
    inner = inspect.getclosurevars(
        inspect.getclosurevars(fit_l).nonlocals["_fit"].__wrapped__).nonlocals
    kc0 = jax.random.split(key)[1] if STEPS > CHUNK else key
    k1, k2 = jax.random.split(jax.random.split(kc0, CHUNK)[0])
    tgt_j = targets(init_j, jnp.asarray)
    loss1_j = float(inner["loss_fn"](
        state_j, inner["sample_batch"](k1, tgt_j), k2, grid_j.arrays(),
        jp._sched_weights(0.6, "mesh"), None,
        topo=JS.marching_tets_topology(grid_j, grid_j.arrays(),
                                       state_j["sdf"], vert_cap=4096,
                                       face_cap=6144))[0])
    state_j, _, out_j = run_j(state_j, opt_j, tgt_j,
                              key, sched=jp._sched_weights(0.6, "mesh"))
    run_t = tp._mesh_fit_fns(grid_t, STEPS)[0]
    assert run_t.chunks == [CHUNK] * (STEPS // CHUNK)
    sw = tp._sched_weights(0.6, "mesh")
    for k_ in sw:
        np.testing.assert_allclose(
            sw[k_], float(jp._sched_weights(0.6, "mesh")[k_]), rtol=1e-6)
    state_t, _, out_t = run_t(state_t, opt_t, targets(init_t, torch.from_numpy),
                              sched=sw, draws=draws)
    loss_t = out_t["loss"].numpy()
    loss_j = np.asarray(out_j["loss"])     # JAX's run: the last chunk's
    assert np.isfinite(loss_t).all() and len(loss_t) == STEPS
    # the first step sees the same inputs: the chain's forward, exactly
    np.testing.assert_allclose(loss_t[0], loss1_j, rtol=1e-5)
    np.testing.assert_allclose(loss_t[-CHUNK:], loss_j, rtol=1e-2)
    for k_, tol in (("sdf", 4e-2), ("deform", 0.16)):
        a, b = state_t[k_].detach().numpy(), np.asarray(state_j[k_])
        assert np.linalg.norm(a - b) <= tol * np.linalg.norm(b), k_
    nf_t, nf_j = int(out_t["mt"]["n_faces"]), int(out_j["mt"]["n_faces"])
    assert nf_t > 0 and abs(nf_t - nf_j) <= 0.02 * nf_j

    # --- the re-render and its depth map, each from its own chain
    r_j = jp._render_chunk(state_j["field"], state_j, out_j["mt"], None,
                           jnp.asarray(poses), jnp.asarray(intr), RS)
    r_t = tp._render_chunk(state_t["field"], state_t, out_t["mt"], None,
                           torch.from_numpy(poses.astype(np.float32)),
                           torch.from_numpy(intr), RS)
    for k_, mean_tol, frac in (("rgb", 1.5e-2, 0.12), ("alpha", 3e-2, 0.12),
                               ("depth", 0.15, 0.08)):
        assert r_t[k_].shape == tuple(r_j[k_].shape)
        _close_maps(r_t[k_].numpy(), r_j[k_], mean_tol, frac, 1e-2)
    _close_maps(t_normalize_depth(r_t["depth"], r_t["alpha"]).numpy(),
                j_normalize_depth(r_j["depth"], r_j["alpha"]), 3e-2, 0.12,
                1e-2)
    # the re-render branch alone, on JAX's final mesh and field
    mt_j = {k_: torch.from_numpy(np.array(v)) for k_, v in out_j["mt"].items()}
    field_j2t = field_params_from_flax(
        jax.tree_util.tree_map(np.asarray, state_j["field"]))
    r_x = tp._render_chunk(field_j2t, {"field": field_j2t}, mt_j, None,
                           torch.from_numpy(poses.astype(np.float32)),
                           torch.from_numpy(intr), RS)
    for k_ in ("rgb", "depth", "alpha"):
        _close_maps(r_x[k_].numpy(), r_j[k_], 1e-4, 2e-3, 1e-3)
    # the masked buffers compacted to the referenced verts, as the bake
    # takes them
    for a, b in zip(tp._compact_mesh(mt_j), jp._compact_mesh(out_j["mt"])):
        np.testing.assert_array_equal(a, b)
    _close_maps(t_normalize_depth(r_x["depth"], r_x["alpha"]).numpy(),
                j_normalize_depth(r_j["depth"], r_j["alpha"]), 1e-4, 2e-3,
                1e-3)
