"""Diffusion modules of the port against the JAX package's, on the CPU in
fp32, at the runner's tiny configurations (`Adapter3DRunner._tiny_unet_cfg`
and the tiny VAE / CLIP of `load_stable_diffusion`).

Inputs are made from a seed with numpy and fed to both packages; weights
are flax's seeded init (plus seeded noise where flax initialises to zero
or one, so no path is trivially zero) sent through the weight bridge.

Tolerance per module: rtol 1e-4 and atol 1e-4 * max|ref|. Convolutions and
matmuls sum in a different order in XLA and in PyTorch, and the GroupNorms
take their statistics differently (ones-vector matmuls against
`F.group_norm`), so bit equality is not expected.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.models.diffusion import (AttnMode, AutoencoderKL,
                                         CLIPTextConfig, CLIPTextModel,
                                         ControlNet, UNet2DCondition,
                                         UNetConfig, VAEConfig,
                                         apply_multi_controlnet,
                                         schedulers as S)
from mvedit_tpu.models.diffusion.norm import GroupNormNHWC
import mvedit_tpu_torch.models.diffusion as TD
from mvedit_tpu_torch.models.diffusion import schedulers as TS
from mvedit_tpu_torch.models.diffusion.norm import GroupNorm
from mvedit_tpu_torch.models.diffusion.weights import torch_state_from_flax

torch.set_num_threads(2)

TINY_UNET = UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                       attn_down=(True, False), cross_attention_dim=32,
                       num_heads=4, dtype=jnp.float32)
TINY_VAE = VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                     dtype=jnp.float32)
TINY_TEXT = CLIPTextConfig(vocab_size=49408, hidden_size=32,
                           intermediate_size=64, num_layers=2, num_heads=4)
T_UNET = TD.UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                       attn_down=(True, False), cross_attention_dim=32,
                       num_heads=4, dtype=torch.float32)
T_VAE = TD.VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                     dtype=torch.float32)
T_TEXT = TD.CLIPTextConfig(vocab_size=49408, hidden_size=32,
                           intermediate_size=64, num_layers=2, num_heads=4)


def _close(out, ref, rtol=1e-4):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _jitter(params, seed, scale=0.1):
    """Adds seeded noise to every leaf: flax's zero-initialised convs
    (the ControlNet heads, controlnet.py:64,100,104), unit norm scales and
    zero biases would otherwise leave paths untested."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.standard_normal(
            p.shape).astype(np.float32), params)


def _load(module, params, kind):
    module.load_state_dict(torch_state_from_flax(params, kind), strict=True)
    return module.eval().requires_grad_(False)


def _t(x):
    return torch.from_numpy(np.array(x))


def _unet_inputs(rng, B=2, hw=8):
    return (rng.standard_normal((B, hw, hw, 4)).astype(np.float32),
            np.array([999, 500, 10, 250][:B], np.int32),
            rng.standard_normal((B, 7, 32)).astype(np.float32))


def _unet_pair(seed=0):
    j = UNet2DCondition(TINY_UNET)
    p = _jitter(j.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, 4)),
                       jnp.zeros((1,), jnp.int32),
                       jnp.zeros((1, 8, 32)))["params"], seed)
    return j, p, _load(TD.UNet2DCondition(T_UNET), p, "unet")


def _controlnet_pair(seed):
    j = ControlNet(TINY_UNET, hint_strides=1)
    p = _jitter(j.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, 4)),
                       jnp.zeros((1,), jnp.int32), jnp.zeros((1, 8, 32)),
                       jnp.zeros((1, 16, 16, 3)))["params"], seed)
    return j, p, _load(TD.ControlNet(T_UNET, hint_strides=1), p,
                       "controlnet")


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm(eps):
    rng = np.random.RandomState(0)
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 7, 64))).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    ref = GroupNormNHWC(32, epsilon=eps).apply(
        {"params": {"scale": scale, "bias": bias}}, x)
    gn = GroupNorm(32, 64, eps)
    gn.load_state_dict({"weight": _t(scale), "bias": _t(bias)})
    with torch.no_grad():
        out = gn(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(out, ref)


def test_timestep_embedding_cos_first():
    from mvedit_tpu.models.diffusion.unet import timestep_embedding
    ts = np.array([0, 1, 500, 999], np.int32)
    _close(TD.unet.timestep_embedding(_t(ts), 320),
           timestep_embedding(jnp.asarray(ts), 320))


def test_unet_all():
    j, p, tmod = _unet_pair()
    x, t, ctx = _unet_inputs(np.random.RandomState(1))
    ref = j.apply({"params": p}, x, t, ctx)
    with torch.no_grad():
        _close(tmod(_t(x), _t(t), _t(ctx)), ref)


def test_unet_enc_dec_with_residuals():
    j, p, tmod = _unet_pair()
    rng = np.random.RandomState(2)
    x, t, ctx = _unet_inputs(rng)
    enc = j.apply({"params": p}, x, t, ctx, part="enc",
                  mode=AttnMode(num_views=2))
    downs = [rng.standard_normal(r.shape).astype(np.float32)
             for r in enc["residuals"]]
    mid = rng.standard_normal(enc["h"].shape).astype(np.float32)
    ref = j.apply({"params": p}, None, None, None, part="dec",
                  enc_state=enc, mode=AttnMode(num_views=2),
                  down_block_res=downs, mid_block_res=mid)
    with torch.no_grad():
        tenc = tmod(_t(x), _t(t), _t(ctx), part="enc",
                    mode=TD.AttnMode(num_views=2))
        # the encoder state itself, NCHW inside the port
        for a, b in zip(tenc["residuals"], enc["residuals"]):
            _close(a.permute(0, 2, 3, 1), b)
        out = tmod(None, None, None, part="dec", enc_state=tenc,
                   mode=TD.AttnMode(num_views=2),
                   down_block_res=[_t(d) for d in downs],
                   mid_block_res=_t(mid))
    _close(out, ref)


def test_controlnet_and_multi():
    pairs = [_controlnet_pair(s) for s in (3, 4)]
    rng = np.random.RandomState(5)
    x, t, ctx = _unet_inputs(rng)
    hints = [rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
             for _ in pairs]
    d_ref, m_ref = pairs[0][0].apply({"params": pairs[0][1]}, x, t, ctx,
                                     hints[0], conditioning_scale=0.7)
    with torch.no_grad():
        d, m = pairs[0][2](_t(x), _t(t), _t(ctx), _t(hints[0]),
                           conditioning_scale=0.7)
    assert len(d) == len(d_ref)
    for a, b in zip(d + [m], list(d_ref) + [m_ref]):
        _close(a, b)
    d_ref, m_ref = apply_multi_controlnet(
        [pr[0] for pr in pairs], [pr[1] for pr in pairs], x, t, ctx, hints,
        [1.0, 0.5])
    with torch.no_grad():
        d, m = TD.apply_multi_controlnet(
            [pr[2] for pr in pairs], _t(x), _t(t), _t(ctx),
            [_t(h) for h in hints], [1.0, 0.5])
    for a, b in zip(d + [m], list(d_ref) + [m_ref]):
        _close(a, b)


def _vae_pair():
    j = AutoencoderKL(TINY_VAE)
    p = _jitter(j.init(jax.random.PRNGKey(6),
                       jnp.zeros((1, 16, 16, 3)))["params"], 6)
    return j, p, _load(TD.AutoencoderKL(T_VAE), p, "vae")


def test_vae_encode_decode():
    j, p, tmod = _vae_pair()
    rng = np.random.RandomState(7)
    img = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    lat_ref = j.apply({"params": p}, img, method=j.encode)
    lat_s_ref = j.apply({"params": p}, img, key, method=j.encode)
    # the posterior sample: JAX draws from `key`; the port takes the draw
    noise = jax.random.normal(key, lat_ref.shape, jnp.float32)
    z = rng.standard_normal(lat_ref.shape).astype(np.float32)
    dec_ref = j.apply({"params": p}, z, method=j.decode)
    with torch.no_grad():
        _close(tmod.encode(_t(img)), lat_ref)
        _close(tmod.encode(_t(img), noise=_t(noise)), lat_s_ref)
        _close(tmod.decode(_t(z)), dec_ref)


def test_clip_text():
    j = CLIPTextModel(TINY_TEXT)
    p = _jitter(j.init(jax.random.PRNGKey(9),
                       jnp.zeros((1, 8), jnp.int32))["params"], 9)
    tmod = _load(TD.CLIPTextModel(T_TEXT), p, "clip_text")
    ids = np.random.RandomState(10).randint(0, 49408, (2, 77))
    with torch.no_grad():
        _close(tmod(_t(ids)), j.apply({"params": p}, ids))
        _close(tmod(_t(ids), output_hidden_state_index=-1),
               j.apply({"params": p}, ids, output_hidden_state_index=-1))


# ---- schedulers -----------------------------------------------------------

def test_schedule_tables():
    np.testing.assert_array_equal(TS.sd_schedule().alphas_cumprod,
                                  S.sd_schedule().alphas_cumprod)
    for spacing in ("trailing", "leading", "linspace"):
        np.testing.assert_array_equal(TS.make_timesteps(24, 1000, spacing),
                                      S.make_timesteps(24, 1000, spacing))
    sig, ts = TS.karras_sigmas(TS.sd_schedule(), 12)
    sig_r, ts_r = S.karras_sigmas(S.sd_schedule(), 12)
    np.testing.assert_allclose(sig, sig_r, rtol=1e-12)
    np.testing.assert_array_equal(ts, ts_r)
    for tf in (0.0, 17.3, 998.6, 999.0):
        for a, b in zip(TS.get_noise_scales(TS.sd_schedule(), tf),
                        S.get_noise_scales(S.sd_schedule(), tf)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)


def _sched_inputs(seed, shape=(3, 4, 4, 4)):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
def test_add_noise_and_predictions(pred):
    x0, noise, model_out, _ = _sched_inputs(11)
    sj = S.sd_schedule(prediction_type=pred)
    st = TS.sd_schedule(prediction_type=pred)
    tv = np.array([999, 500, 3], np.int32)
    _close(TS.add_noise(st, _t(x0), _t(noise), _t(tv)),
           S.add_noise(sj, x0, noise, jnp.asarray(tv)))
    _close(TS.add_noise(st, _t(x0), _t(noise), 321),
           S.add_noise(sj, x0, noise, jnp.full((3,), 321)))
    for fj, ft in ((S.pred_x0, TS.pred_x0), (S.pred_eps, TS.pred_eps)):
        _close(ft(st, _t(x0), _t(model_out), 420),
               fj(sj, x0, model_out, jnp.asarray(420)))


def test_dpmsolver_three_steps():
    """DPM-Solver++(2M) over 3 steps, the last one to t_prev = -1: the
    first step is first order, the next two second order."""
    x, _, _, _ = _sched_inputs(12)
    outs = _sched_inputs(13)[:3]
    sj, st = S.sd_schedule(), TS.sd_schedule()
    steps = [999, 666, 333, -1]
    xj, statej = x, S.SolverState.init(x.shape)
    xt, statet = _t(x), TS.SolverState.init(_t(x))
    for i in range(3):
        xj, statej = S.dpmsolver_step(sj, xj, outs[i], jnp.asarray(steps[i]),
                                      jnp.asarray(steps[i + 1]), statej)
        xt, statet = TS.dpmsolver_step(st, xt, _t(outs[i]), steps[i],
                                       steps[i + 1], statet)
        _close(xt, xj)
        _close(statet.prev_x0, statej.prev_x0)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim(eta):
    x, model_out, _, _ = _sched_inputs(14)
    sj, st = S.sd_schedule(), TS.sd_schedule()
    key = jax.random.PRNGKey(15)
    for t, tp in ((999, 958), (41, -1)):
        ref = S.ddim_step(sj, x, model_out, jnp.asarray(t), jnp.asarray(tp),
                          eta=eta, key=key)
        noise = np.asarray(jax.random.normal(key, x.shape))
        _close(TS.ddim_step(st, _t(x), _t(model_out), t, tp, eta=eta,
                            noise=_t(noise)), ref)


def test_euler_ancestral():
    x, model_out, _, _ = _sched_inputs(16)
    sj, st = S.sd_schedule(), TS.sd_schedule()
    key = jax.random.PRNGKey(17)
    noise = np.asarray(jax.random.normal(key, x.shape))
    for t, tp in ((999, 958), (41, -1)):
        ref = S.euler_ancestral_step(sj, x, model_out, jnp.asarray(t),
                                     jnp.asarray(tp), key)
        _close(TS.euler_ancestral_step(st, _t(x), _t(model_out), t, tp,
                                       noise=_t(noise)), ref)
    # with a generator the draw is the generator's, the same for a reseed
    g = [torch.Generator().manual_seed(3) for _ in range(2)]
    a, b = (TS.euler_ancestral_step(st, _t(x), _t(model_out), 500, 458,
                                    generator=gi) for gi in g)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
