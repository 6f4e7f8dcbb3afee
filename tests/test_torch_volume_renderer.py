"""The port's volume renderer against the JAX package's, on the CPU in fp32:
the same rays, field (dense backend, JAX init with tables scaled up,
bridged by `field_params_from_flax`) and stratified / grid jitter (JAX's
draws, passed in).

Tolerance 1e-5, absolute on values of order 1 and relative to the largest
magnitude for the gradients of `composite` (f32 sums in another order).
The composite case includes alphas that reach 1 (sigma * delta up to
~60), where the reference's log-space cumsum with its 1e-10 clip and
`torch.cumprod` part ways in the gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.apis.cameras import surround_rig
from mvedit_tpu.models import nerf_fit as JNF
from mvedit_tpu.models import volume_renderer as JV
from mvedit_tpu.models.fields import INGPConfig as JINGP
from mvedit_tpu.models.fields import ingp_init as j_ingp_init
from mvedit_tpu.models.fields import ingp_point_decode as j_decode
from mvedit_tpu.ops.dense_grid import DenseGridConfig as JDense
from mvedit_tpu.utils.geometry import get_cam_rays

from mvedit_tpu_torch.models import nerf_fit as TNF
from mvedit_tpu_torch.models import volume_renderer as TV
from mvedit_tpu_torch.models.fields import INGPConfig as TINGP
from mvedit_tpu_torch.models.fields import field_params_from_flax
from mvedit_tpu_torch.models.fields import ingp_point_decode as t_decode
from mvedit_tpu_torch.ops.dense_grid import DenseGridConfig as TDense

torch.set_num_threads(2)
TOL = 1e-5
JCFG = JINGP(backend="dense", dense=JDense(resolutions=(8, 32),
                                           gather_dtype="float32"))
TCFG = TINGP(backend="dense", dense=TDense(resolutions=(8, 32),
                                           gather_dtype="float32"))
RCFG = dict(num_samples=24, grid_size=16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, tol=TOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    np.testing.assert_allclose(out, np.asarray(ref), rtol=tol, atol=tol)


def j_dec(params, x):
    """The field with a density blob of radius ~0.35 multiplied in, so the
    occupancy grid and the rays see empty and dense space."""
    sigma, rgb = j_decode(params, x, JCFG)
    return sigma * 50.0 * jnp.exp(-8.0 * jnp.sum(x * x, -1)), rgb


def t_dec(params, x):
    sigma, rgb = t_decode(params, x, TCFG)
    return sigma * 50.0 * torch.exp(-8.0 * (x * x).sum(-1)), rgb


def _field(seed=0, scale=1000.0):
    p = j_ingp_init(jax.random.PRNGKey(seed), JCFG)
    p["table"] = jax.tree_util.tree_map(lambda x: x * scale, p["table"])
    return jax.tree_util.tree_map(np.asarray, p)


def _rays(n_views=2, size=12):
    rng = np.random.default_rng(0)
    poses, intr = surround_rig(n_views, 2.6, 40, -0.3, 0.6, size, rng=rng)
    o, d = get_cam_rays(jnp.asarray(poses, jnp.float32),
                        jnp.asarray(intr, jnp.float32), size, size)
    return (np.asarray(o).reshape(-1, 3), np.asarray(d).reshape(-1, 3),
            poses.astype(np.float32), intr.astype(np.float32))


def _grid(params, key=1):
    """A refreshed occupancy grid of the field, in both packages."""
    jc = JV.RenderConfig(**RCFG)
    g_j = JV.update_density_grid(lambda x: j_dec(params, x)[0],
                                 JV.OccupancyGrid.create(16), jc,
                                 key=jax.random.PRNGKey(key))
    return g_j, TV.OccupancyGrid(density=_t(g_j.density), occ=_t(g_j.occ))


def test_aabb_tighten_and_samples_match_jax():
    o, d, _, _ = _rays()
    _close(TV.ray_aabb(_t(o), _t(d), 1.0)[0], JV.ray_aabb(o, d, 1.0)[0])
    _close(TV.ray_aabb(_t(o), _t(d), 1.0)[1], JV.ray_aabb(o, d, 1.0)[1])
    g_j, g_t = _grid(_field())
    assert 0 < float(g_j.occ.mean()) < 1
    xyz = np.random.default_rng(1).uniform(-1.1, 1.1, (500, 3))
    np.testing.assert_array_equal(
        TV.occupancy_at(g_t, _t(xyz.astype(np.float32)), 1.0).numpy(),
        np.asarray(JV.occupancy_at(g_j, jnp.asarray(xyz, jnp.float32), 1.0)))
    near, far = JV.ray_aabb(o, d, 1.0)
    for a, b in zip(TV.tighten_interval(_t(o), _t(d), _t(near), _t(far),
                                        g_t, 1.0),
                    JV.tighten_interval(o, d, near, far, g_j, 1.0)):
        _close(a.float(), np.asarray(b, np.float32))
    key = jax.random.PRNGKey(3)
    jitter = jax.random.uniform(key, (o.shape[0], RCFG["num_samples"]))
    for grid in (None, "grid"):
        ref = JV.sample_rays(o, d, JV.RenderConfig(**RCFG), key=key,
                             grid=None if grid is None else g_j)
        out = TV.sample_rays(_t(o), _t(d), TV.RenderConfig(**RCFG),
                             jitter=_t(jitter),
                             grid=None if grid is None else g_t)
        for a, b in zip(out, ref):
            _close(a.float(), np.asarray(b, np.float32))


def test_composite_forward_and_grad_match_jax():
    rng = np.random.default_rng(2)
    R, S = 64, 24
    sig = (rng.random((R, S)) * 40).astype(np.float32)
    sig[:8] *= 30                          # alphas at 1
    rgb = rng.random((R, S, 3)).astype(np.float32)
    ts = np.sort(rng.uniform(0.5, 3.0, (R, S)), -1).astype(np.float32)
    deltas = np.diff(ts, axis=-1, append=ts[:, -1:] + 0.05).astype(np.float32)
    valid = rng.random((R, S)) > 0.1
    w = [rng.standard_normal(s).astype(np.float32)
         for s in ((R, 3), (R,), (R,), (R,))]
    keys = ("rgb", "depth", "inv_depth", "alpha")
    jcfg, tcfg = JV.RenderConfig(**RCFG), TV.RenderConfig(**RCFG)

    def f_j(s, c):
        out = JV.composite(s, c, ts, deltas, valid, jcfg, bg_color=1.0)
        return sum(jnp.sum(out[k] * wk) for k, wk in zip(keys, w)), out
    (_, ref), (gs_j, gc_j) = jax.value_and_grad(f_j, (0, 1), has_aux=True)(
        jnp.asarray(sig), jnp.asarray(rgb))
    s_t, c_t = _t(sig).requires_grad_(True), _t(rgb).requires_grad_(True)
    out = TV.composite(s_t, c_t, _t(ts), _t(deltas), _t(valid), tcfg,
                       bg_color=1.0)
    for k in keys + ("weights", "trans"):
        _close(out[k], ref[k])
    sum((out[k] * _t(wk)).sum() for k, wk in zip(keys, w)).backward()
    for g_t, g_j in ((s_t.grad, gs_j), (c_t.grad, gc_j)):
        _close(g_t, g_j, TOL * float(np.abs(g_j).max()))


@pytest.mark.parametrize("with_grid", [False, True])
def test_render_rays_and_grid_update_match_jax(with_grid):
    params = _field()
    tp = field_params_from_flax(params)
    o, d, _, _ = _rays()
    g_j, g_t = _grid(params) if with_grid else (None, None)
    key = jax.random.PRNGKey(5)
    jitter = jax.random.uniform(key, (o.shape[0], RCFG["num_samples"]))
    ref = JV.render_rays(lambda x: j_dec(params, x), o, d,
                         JV.RenderConfig(**RCFG), grid=g_j, key=key)
    out = TV.render_rays(lambda x: t_dec(tp, x), _t(o), _t(d),
                         TV.RenderConfig(**RCFG), grid=g_t, jitter=_t(jitter))
    assert float(ref["alpha"].max()) > 0.1
    for k in ("rgb", "depth", "inv_depth", "alpha", "weights"):
        _close(out[k], ref[k], TOL * max(1.0, float(np.abs(ref[k]).max())))
    # the EMA grid update with JAX's cell jitter, from a refreshed grid
    jc, tc = JV.RenderConfig(**RCFG), TV.RenderConfig(**RCFG)
    g0_j, g0_t = _grid(params, key=7)
    k = jax.random.PRNGKey(9)
    g1_j = JV.update_density_grid(lambda x: j_dec(params, x)[0],
                                  g0_j, jc, key=k)
    g1_t = TV.update_density_grid(
        lambda x: t_dec(tp, x)[0], g0_t, tc,
        jitter=_t(jax.random.uniform(k, (16, 16, 16, 3))))
    _close(g1_t.density, g1_j.density,
           TOL * float(np.abs(g1_j.density).max()))
    np.testing.assert_array_equal(g1_t.occ.numpy(), np.asarray(g1_j.occ))


@pytest.mark.parametrize("with_grid", [False, True])
def test_multiview_renderer_matches_jax(with_grid):
    """The NeRF branch of the pipeline's re-render (ray chunks, the
    occupancy grid, a white background), rays made inside each renderer.
    `jnp.linspace` puts the pixel centres a few ulps off i + 0.5 (the port
    uses i + 0.5), so a ray can differ in its last bits. Without the grid
    that moves every map by ~1e-7: all within 1e-5. With the grid, a probe
    on an occupancy cell's boundary can then flip and move that ray's
    sample interval: all but 0.5% of the values within 1e-5, the rest
    within 1e-3."""
    params = _field(seed=3)
    tp = field_params_from_flax(params)
    _, _, poses, intr = _rays(n_views=3, size=16)
    g_j, g_t = _grid(params) if with_grid else (None, None)
    ref = JNF.make_multiview_renderer(j_dec, 16, 16, JV.RenderConfig(**RCFG),
                                      chunk=96, use_grid=with_grid)(
        params, jnp.asarray(poses), jnp.asarray(intr), g_j)
    out = TNF.make_multiview_renderer(
        t_dec, 16, 16, TV.RenderConfig(**RCFG), chunk=96,
        use_grid=with_grid)(tp, _t(poses), _t(intr), g_t)
    assert float(ref["alpha"].max()) > 0.5
    for k in ("rgb", "depth", "inv_depth", "alpha", "dirs"):
        scale = max(1.0, float(np.abs(ref[k]).max()))
        d = np.abs(out[k].numpy() - np.asarray(ref[k])) / scale
        if with_grid:
            assert (d > TOL).mean() <= 5e-3 and d.max() <= 1e-3, k
        else:
            assert d.max() <= TOL, k
