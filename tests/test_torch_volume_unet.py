"""`mvedit_tpu_torch/models/volume_unet.py` against the JAX package's, on
the CPU in f32, at tiny widths, with the flax params (jittered so that the
zero-initialised convs and `to_out` count) bridged by
`volume_unet_state_from_flax` (DHWIO kernels to OIDHW):

- `UNetVolume` (two levels of 64 / 128, the mid attention at head dim 16,
  an out conv; and once with the strided encoder) on an 8^3 volume: the
  output and every `extra_res` within 1e-5 relative (L2); the gradients
  of a weighted sum to the input within 1e-5 and to every parameter
  within 1e-5 of the larger of its norm and 1e-3 of the largest leaf's
  (the leaves whose gradient is 0 analytically, see `_grads_agree`);
- `ResnetBlockVolume` with a mask (the submanifold conv and the masked
  GroupNorm) and without: outputs and gradients within 1e-5;
- `masked_trilinear_upsample`, `downsample_mask` and `masked_group_norm`
  directly: masks exactly equal, values within 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.models import volume_unet as JV
from mvedit_tpu_torch.models import volume_unet as TV

torch.set_num_threads(4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ncdhw(a):
    return _t(a).permute(0, 4, 1, 2, 3)


def _ndhwc(t):
    return t.detach().permute(0, 2, 3, 4, 1).numpy()


def _jitter(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape)
        .astype(np.float32), params)


def _grads_agree(tnet, jgrads, tol=1e-5):
    """The leaves whose gradients differ by more than `tol` of the larger
    of their own norm and 1e-3 of the largest leaf's: the keys' bias of
    an attention has a gradient of 0 (softmax ignores a shift shared by
    a query's scores), which both frameworks leave as rounding noise."""
    jg = TV.volume_unet_state_from_flax(jgrads)
    big = max(np.linalg.norm(np.asarray(g)) for g in jg.values())
    bad = {}
    for k, p in tnet.named_parameters():
        d = np.linalg.norm(p.grad.numpy().astype(np.float64)
                           - np.asarray(jg[k], np.float64))
        if not d <= tol * max(np.linalg.norm(jg[k]), 1e-3 * big):
            bad[k] = d
    return bad


@pytest.mark.parametrize("encoder", [False, True])
def test_unet_volume_matches_jax(encoder):
    kw = dict(in_channels=4, out_channels=3, block_out_channels=(64, 128),
              layers_per_block=1, attention_head_dim=16)
    if encoder:
        kw.update(encoder_block_out_channels=(64,),
                  encoder_layers_per_block=1)
    rng = np.random.default_rng(1)
    n = 16 if encoder else 8
    x = rng.normal(size=(2, n, n, n, 4)).astype(np.float32)
    jnet = JV.UNetVolume(JV.VolumeUNetConfig(**kw))
    params = _jitter(jnet.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, n, n, n, 4)))["params"], 2)
    jout, jextra = jnet.apply({"params": params}, jnp.asarray(x))
    w = rng.normal(size=jout.shape).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jnet.apply({"params": p}, x)[0] * w)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tnet = TV.UNetVolume(TV.VolumeUNetConfig(**kw))
    tnet.load_state_dict(TV.volume_unet_state_from_flax(params), strict=True)
    tx = _ncdhw(x).requires_grad_(True)
    tout, textra = tnet(tx)
    (tout * _ncdhw(w)).sum().backward()
    assert _rel(_ndhwc(tout), jout) <= 1e-5
    assert len(textra) == len(jextra)
    for a, b in zip(textra, jextra):
        assert _rel(_ndhwc(a), b) <= 1e-5
    assert _rel(_ndhwc(tx.grad), jgx) <= 1e-5
    bad = _grads_agree(tnet, jgp)
    assert not bad, bad


@pytest.mark.parametrize("masked", [False, True])
def test_resnet_block_volume_matches_jax(masked):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 6, 6, 32)).astype(np.float32)
    mask = rng.random((2, 6, 6, 6)) < 0.4
    x = x * mask[..., None] if masked else x
    m = jnp.asarray(mask) if masked else None
    jblk = JV.ResnetBlockVolume(64)
    params = _jitter(jblk.init(jax.random.PRNGKey(1), jnp.asarray(x),
                               m)["params"], 4)
    jout = jblk.apply({"params": params}, jnp.asarray(x), m)
    w = rng.normal(size=jout.shape).astype(np.float32)
    jgp, jgx = jax.grad(lambda p, x: jnp.sum(jblk.apply(
        {"params": p}, x, m) * w), argnums=(0, 1))(params, jnp.asarray(x))
    tblk = TV.ResnetBlockVolume(32, 64)
    tblk.load_state_dict(TV.volume_unet_state_from_flax(params),
                         strict=True)
    tx = _ncdhw(x).requires_grad_(True)
    tout = tblk(tx, _t(mask) if masked else None)
    (tout * _ncdhw(w)).sum().backward()
    assert _rel(_ndhwc(tout), jout) <= 1e-5
    assert _rel(_ndhwc(tx.grad), jgx) <= 1e-5
    bad = _grads_agree(tblk, jgp)
    assert not bad, bad


def test_masked_helpers_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4, 5, 6, 32)).astype(np.float32)
    mask = rng.random((2, 4, 5, 6)) < 0.5
    fine = rng.random((2, 8, 10, 12)) < 0.5
    ju, jm = JV.masked_trilinear_upsample(jnp.asarray(x), jnp.asarray(mask),
                                          jnp.asarray(fine))
    tu, tm = TV.masked_trilinear_upsample(_ncdhw(x), _t(mask), _t(fine))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert _rel(_ndhwc(tu), ju) <= 1e-6
    big = rng.random((2, 8, 10, 12)) < 0.2
    np.testing.assert_array_equal(TV.downsample_mask(_t(big)).numpy(),
                                  np.asarray(JV.downsample_mask(
                                      jnp.asarray(big))))
    scale = rng.normal(size=(32,)).astype(np.float32)
    bias = rng.normal(size=(32,)).astype(np.float32)
    jg = JV.masked_group_norm(jnp.asarray(x), jnp.asarray(mask), 8,
                              jnp.asarray(scale), jnp.asarray(bias))
    tg = TV.masked_group_norm(_ncdhw(x), _t(mask), 8, _t(scale), _t(bias))
    assert _rel(_ndhwc(tg), jg) <= 1e-6
