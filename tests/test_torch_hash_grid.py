"""The port's spherical harmonics, hash grid and hash-grid field against
the JAX package's, on the CPU in f32.

- `sh_encode` at degrees 1-4 within 1e-6, and a ValueError outside them;
- `hash_grid_encode` at a tiny config with linear levels ((res + 1)^3 <=
  T) and hashed ones (4 levels, 2^12 rows, base 4, max 32: resolutions 4,
  8, 16, 32, the last two hashed), on random points and points on the
  box's faces and corners (0 and 1 in each coordinate, and just outside):
  values within 1e-6, the gradients to the table and to the points within
  1e-5 (relative L2, against `jax.grad`); the linear and hashed indices
  themselves equal JAX's uint32 ones;
- one 8-step NeRF-fit chunk of an `INGPConfig(backend="hash")` field, as
  `test_torch_nerf_fit.py` runs the dense chunk and with its tolerances:
  the losses within 1e-4 relative, the MLP within 1e-3 and the table
  within 1e-2 relative L2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.models import nerf_fit as JNF
from mvedit_tpu.models import volume_renderer as JV
from mvedit_tpu.models.fields import INGPConfig as JINGP
from mvedit_tpu.models.fields import ingp_init as j_ingp_init
from mvedit_tpu.models.fields import ingp_point_decode as j_decode
from mvedit_tpu.ops import hash_grid as JH
from mvedit_tpu.ops.sh import sh_encode as j_sh

from mvedit_tpu_torch.models import nerf_fit as TNF
from mvedit_tpu_torch.models import volume_renderer as TV
from mvedit_tpu_torch.models.fields import INGPConfig as TINGP
from mvedit_tpu_torch.models.fields import (field_leaves,
                                            field_params_from_flax,
                                            ingp_init, ingp_point_decode)
from mvedit_tpu_torch.ops import hash_grid as TH
from mvedit_tpu_torch.ops.sh import sh_encode as t_sh

from test_torch_nerf_fit import RS, SCHED, STEPS, TOL, _rel, _t, _targets
from torch_jax_draws import nerf_fit_draws

torch.set_num_threads(2)
JCFG = JH.HashGridConfig(n_levels=4, log2_hashmap_size=12,
                         base_resolution=4, max_resolution=32)
TCFG = TH.HashGridConfig(n_levels=4, log2_hashmap_size=12,
                         base_resolution=4, max_resolution=32)


def _points(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3))
    edges = np.array([[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 0.25],
                      [0.5, 1, 0], [-0.01, 0.5, 1.01], [1.02, -0.03, 0.5],
                      [0.25, 0.125, 0.0625]])
    return np.concatenate([x, edges]).astype(np.float32)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode_matches_jax(degree):
    d = np.random.default_rng(degree).normal(size=(500, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    out = t_sh(_t(d), degree).numpy()
    assert out.shape == (500, degree ** 2)
    np.testing.assert_allclose(out, np.asarray(j_sh(jnp.asarray(d), degree)),
                               atol=1e-6)


def test_sh_encode_rejects_degree():
    for degree in (0, 5):
        with pytest.raises(ValueError):
            t_sh(torch.zeros(2, 3), degree)


def test_hash_grid_config_and_indices_match_jax():
    assert TCFG.per_level_scale == JCFG.per_level_scale
    res = [TCFG.level_resolution(i) for i in range(4)]
    assert res == [JCFG.level_resolution(i) for i in range(4)] \
        == [4, 8, 16, 32]
    # levels 0-1 index linearly, 2-3 hash
    assert [(r + 1) ** 3 <= TCFG.table_size for r in res] == \
        [True, True, False, False]
    full = JH.HashGridConfig()
    assert [TH.HashGridConfig().level_resolution(i) for i in range(12)] == \
        [full.level_resolution(i) for i in range(12)]
    rng = np.random.default_rng(3)
    for r in (8, 32, 320, 2047):
        c = rng.integers(0, r + 1, (4000, 3)).astype(np.int32)
        for T in (1 << 12, 1 << 19):
            ref = np.asarray(JH._level_index(jnp.asarray(c), r, T))
            got = TH._level_index(torch.from_numpy(c).long(), r, T).numpy()
            np.testing.assert_array_equal(got, ref)


def test_hash_grid_init_layout():
    t = TH.hash_grid_init(TCFG, torch.Generator().manual_seed(0))
    assert t.shape == (4, 1 << 12, 2) and t.dtype == torch.float32
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 4e-5


def test_hash_grid_encode_values_and_gradients_match_jax():
    table = np.asarray(JH.hash_grid_init(jax.random.PRNGKey(0), JCFG)) * 1e3
    x = _points()
    g_out = np.random.default_rng(1).normal(
        size=(len(x), JCFG.out_dim)).astype(np.float32)

    def j_loss(tab, xx):
        return jnp.sum(JH.hash_grid_encode(tab, xx, JCFG) * g_out)
    enc_j = np.asarray(JH.hash_grid_encode(jnp.asarray(table),
                                           jnp.asarray(x), JCFG))
    gt_j, gx_j = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(table),
                                                  jnp.asarray(x))
    tab_t = _t(table).requires_grad_(True)
    x_t = _t(x).requires_grad_(True)
    enc_t = TH.hash_grid_encode(tab_t, x_t, TCFG)
    assert enc_t.shape == (len(x), 8)
    np.testing.assert_allclose(enc_t.detach().numpy(), enc_j, atol=1e-6)
    (enc_t * _t(g_out)).sum().backward()
    assert _rel(tab_t.grad.numpy(), gt_j) <= 1e-5
    assert _rel(x_t.grad.numpy(), gx_j) <= 1e-5
    # every level's table takes gradient, the hashed ones included
    assert all(np.abs(tab_t.grad.numpy()[lv]).max() > 0 for lv in range(4))


def test_hash_field_decode_matches_jax():
    jcfg, tcfg = JINGP(hash=JCFG), TINGP(hash=TCFG)
    assert tcfg.enc_dim == jcfg.enc_dim == 8
    p = j_ingp_init(jax.random.PRNGKey(2), jcfg)
    p["table"] = p["table"] * 1e3
    p = jax.tree_util.tree_map(np.asarray, p)
    x = _points(seed=2) * 2 - 1
    sj, cj = (np.asarray(a) for a in j_decode(p, jnp.asarray(x), jcfg))
    st, ct = ingp_point_decode(field_params_from_flax(p), _t(x), tcfg)
    np.testing.assert_allclose(st.numpy(), sj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-5, atol=1e-6)
    seeded = ingp_init(tcfg, torch.Generator().manual_seed(0))
    assert seeded["table"].shape == (4, 1 << 12, 2)
    assert len(field_leaves(seeded)) == 1 + 2 * len(seeded["mlp"])


def j_dec(params, x):
    sigma, rgb = j_decode(params, x, JINGP(hash=JCFG))
    return sigma * 50.0 * jnp.exp(-8.0 * jnp.sum(x * x, -1)), rgb


def t_dec(params, x):
    sigma, rgb = ingp_point_decode(params, x, TINGP(hash=TCFG))
    return sigma * 50.0 * torch.exp(-8.0 * (x * x).sum(-1)), rgb


def test_hash_nerf_fit_chunk_matches_jax():
    tg = _targets()
    rcfg = dict(num_samples=16, grid_size=16)
    kw = dict(patch_size=16, n_steps=STEPS, alpha_soften=0.02,
              bg_width=0.015)
    jcfg = JNF.NerfFitConfig(render=JV.RenderConfig(**rcfg), **kw)
    tcfg = TNF.NerfFitConfig(render=TV.RenderConfig(**rcfg), **kw)
    field = j_ingp_init(jax.random.PRNGKey(0), JINGP(hash=JCFG))
    field["table"] = field["table"] * 1000.0
    field = jax.tree_util.tree_map(np.asarray, field)
    key = jax.random.PRNGKey(4)
    fit_j, opt = JNF.make_nerf_fit(j_dec, jcfg, RS)
    p_j = jax.tree_util.tree_map(jnp.array, field)
    p_j, _, g_j, out_j = fit_j(
        p_j, opt.init(p_j), JV.OccupancyGrid.create(16),
        {k: jnp.asarray(v) for k, v in tg.items()}, key,
        sched={k: jnp.float32(v) for k, v in SCHED.items()})
    fit_t, make_opt = TNF.make_nerf_fit(t_dec, tcfg, RS)
    p_t = field_params_from_flax(field)
    p_t, _, g_t, out_t = fit_t(
        p_t, make_opt(p_t), TV.OccupancyGrid.create(16),
        {k: _t(v) for k, v in tg.items()}, sched=SCHED,
        draws=nerf_fit_draws(key, STEPS, tg["cam_weights"], jcfg, RS))
    loss_j = np.asarray(out_j["loss"])
    assert np.isfinite(loss_j).all() and len(loss_j) == STEPS
    np.testing.assert_allclose(out_t["loss"].numpy(), loss_j, rtol=TOL)
    leaves_j = [p_j["table"]] + [l[n] for l in p_j["mlp"] for n in "wb"]
    for i, (a, b) in enumerate(zip(field_leaves(p_t), leaves_j)):
        tol = 1e-2 if i == 0 else 1e-3
        assert _rel(a.detach().numpy(), b) <= tol, (i, _rel(a.detach(), b))
    assert _rel(g_t.density.numpy(), g_j.density) <= 1e-3
