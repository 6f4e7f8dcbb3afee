"""The port's triplane decoder, its iNGP hybrid, the triplane latent
upsampler and the code activation against the JAX package's, on the CPU
in f32, each within 1e-5 relative (L2):

- `triplane_point_decode` at StableSSDNeRF cars' widths (12 channels,
  base 36 -> 64, bound 0.5) with view directions, without, and
  `density_only`, on points inside the box and past it (border padding);
  the dir MLP's last layer is jittered away from its zero init so the
  directions count;
- `triplane_ingp_point_decode` with a tiny hash grid (linear and hashed
  levels) and the zero-initialised residual jittered: the values, and the
  gradients of a loss to the hash table, the residual projection and the
  heads;
- `VAEDecoderPreproc` at narrow widths (block channels (32, 64)), seeded
  flax params bridged through `torch_state_from_flax(..., "vae_preproc")`;
- `tanh_code` and `tanh_code_inverse`, saturated values included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.models import ssdnerf as JS
from mvedit_tpu.models import triplane as JT
from mvedit_tpu.ops.hash_grid import HashGridConfig as JHash

from mvedit_tpu_torch.models import ssdnerf as TS
from mvedit_tpu_torch.models import triplane as TT
from mvedit_tpu_torch.models.diffusion.weights import torch_state_from_flax
from mvedit_tpu_torch.ops.hash_grid import HashGridConfig as THash

torch.set_num_threads(2)
TOL = 1e-5
CARS = dict(n_channels=12, base_layers=(36, 64), bound=0.5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jitter(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(
            x.shape).astype(np.float32), tree)


def _inputs(n=2000, bound=0.5, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.1 * bound, 1.1 * bound, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    code = rng.normal(size=(3, 12, 40, 40)).astype(np.float32)
    return code, xyz, d


@pytest.mark.parametrize("mode", ["dirs", "no_dirs", "density_only"])
def test_triplane_point_decode_matches_jax(mode):
    jcfg, tcfg = JT.TriPlaneConfig(**CARS), TT.TriPlaneConfig(**CARS)
    params = _jitter(JT.triplane_init(jax.random.PRNGKey(0), jcfg), 1)
    code, xyz, d = _inputs()
    dirs = d if mode == "dirs" else None
    only = mode == "density_only"
    sj, cj = JT.triplane_point_decode(
        params, jnp.asarray(code), jnp.asarray(xyz),
        None if dirs is None else jnp.asarray(dirs), jcfg, density_only=only)
    st, ct = TT.triplane_point_decode(
        TT.triplane_params_from_flax(params), _t(code), _t(xyz),
        None if dirs is None else _t(dirs), tcfg, density_only=only)
    assert st.shape == (2000,) and _rel(st.numpy(), sj) <= TOL
    if only:
        assert ct is None and cj is None
    else:
        assert ct.shape == (2000, 3) and _rel(ct.numpy(), cj) <= TOL
    if mode == "dirs":       # the directions change the colour
        _, c0 = TT.triplane_point_decode(
            TT.triplane_params_from_flax(params), _t(code), _t(xyz), None,
            tcfg)
        assert float((c0 - ct).abs().max()) > 1e-3


def test_triplane_init_zeroes_the_last_dir_layer():
    p = TT.triplane_init(TT.TriPlaneConfig(**CARS),
                         torch.Generator().manual_seed(0))
    j = JT.triplane_init(jax.random.PRNGKey(0), JT.TriPlaneConfig(**CARS))
    for k in ("base", "density", "color", "dir"):
        assert [l["w"].shape for l in p[k]] == \
            [tuple(l["w"].shape) for l in j[k]]
    # the dir MLP (16 -> 64) is one layer, its last
    assert float(p["dir"][-1]["w"].abs().max()) == 0.0
    assert float(p["base"][0]["w"].abs().max()) > 0.0


def test_triplane_ingp_decode_and_gradients_match_jax():
    jh = JHash(n_levels=4, log2_hashmap_size=12, base_resolution=4,
               max_resolution=32)
    th = THash(n_levels=4, log2_hashmap_size=12, base_resolution=4,
               max_resolution=32)
    jcfg = JT.TriPlaneINGPConfig(triplane=JT.TriPlaneConfig(**CARS), hash=jh)
    tcfg = TT.TriPlaneINGPConfig(triplane=TT.TriPlaneConfig(**CARS), hash=th)
    init = JT.triplane_ingp_init(jax.random.PRNGKey(3), jcfg)
    assert float(np.abs(np.asarray(init["ingp_base"][-1]["w"])).max()) == 0
    params = _jitter(init, 4)
    params["table"] = np.asarray(init["table"]) * 1e3
    code, xyz, d = _inputs(seed=5)
    g = np.random.default_rng(6).normal(size=(2000, 4)).astype(np.float32)

    def j_loss(p):
        s, c = JT.triplane_ingp_point_decode(p, jnp.asarray(code),
                                             jnp.asarray(xyz),
                                             jnp.asarray(d), jcfg)
        return jnp.sum(jnp.concatenate([s[:, None], c], -1) * g)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    loss_j, grads = jax.value_and_grad(j_loss)(jp)
    tp = TT.triplane_params_from_flax(params)
    leaves = [tp["table"]] + [l[n] for k in ("ingp_base", "base")
                              for l in tp[k] for n in ("w", "b")]
    for x in leaves:
        x.requires_grad_(True)
    st, ct = TT.triplane_ingp_point_decode(tp, _t(code), _t(xyz), _t(d), tcfg)
    loss_t = (torch.cat([st[:, None], ct], -1) * _t(g)).sum()
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= TOL * abs(float(loss_j))
    jl = [grads["table"]] + [l[n] for k in ("ingp_base", "base")
                             for l in grads[k] for n in ("w", "b")]
    for i, (a, b) in enumerate(zip(leaves, jl)):
        assert np.abs(np.asarray(b)).max() > 0, i
        assert _rel(a.grad.numpy(), b) <= TOL, (i, _rel(a.grad.numpy(), b))


def test_vae_decoder_preproc_matches_jax():
    kw = dict(block_out_channels=(32, 64))
    net = JT.VAEDecoderPreproc(**kw)
    z = np.random.default_rng(7).normal(size=(3, 10, 10, 12)).astype(
        np.float32)
    params = _jitter(net.init(jax.random.PRNGKey(8), jnp.asarray(z))
                     ["params"], 9, 0.02)
    out_j = np.asarray(net.apply({"params": params}, jnp.asarray(z)))
    tnet = TT.VAEDecoderPreproc(**kw)
    tnet.load_state_dict(torch_state_from_flax(params, "vae_preproc"),
                         strict=True)
    with torch.no_grad():
        out_t = tnet(_t(z)).numpy()
    assert out_t.shape == out_j.shape == (3, 20, 20, 48)
    assert _rel(out_t, out_j) <= TOL, _rel(out_t, out_j)


def test_tanh_code_matches_jax():
    x = np.concatenate([np.random.default_rng(10).normal(0, 3, 500),
                        [-40.0, -2.0, 0.0, 2.0, 40.0]]).astype(np.float32)
    a_j = np.asarray(JS.tanh_code(jnp.asarray(x)))
    a_t = TS.tanh_code(_t(x)).numpy()
    assert _rel(a_t, a_j) <= TOL
    inv_j = np.asarray(JS.tanh_code_inverse(jnp.asarray(a_j)))
    inv_t = TS.tanh_code_inverse(_t(a_j)).numpy()
    assert _rel(inv_t, inv_j) <= TOL
    assert np.isfinite(inv_t).all() and np.abs(inv_t).max() < 16
