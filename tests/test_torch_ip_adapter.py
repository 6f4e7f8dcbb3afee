"""IP-Adapter in the port against the JAX package's, on the CPU in fp32 at
tiny widths: the CLIP vision tower (image embeds and the penultimate
hidden states), `ImageProjModel`, `Resampler`, and a UNet call with image
tokens through the decoupled cross-attention (whole, and as the encoder /
decoder split that the 2-pass denoise runs), plus one 2-pass denoise step
with reference pairs and `ip_context`, chunked by `diff_bs`.

Inputs are made from a seed with numpy; weights are flax's seeded init plus
seeded noise, sent through the weight bridge (`torch_state_from_flax`).
Tolerance: rtol 1e-4 and atol 1e-4 * max|ref|, as for the other diffusion
modules (matmuls and convolutions sum in another order in XLA).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.models.diffusion import (AttnMode, UNet2DCondition,
                                         UNetConfig)
from mvedit_tpu.models.diffusion.clip import (CLIPVisionConfig,
                                              CLIPVisionModel)
from mvedit_tpu.models.diffusion.ip_adapter import (ImageProjModel,
                                                    Resampler,
                                                    get_ip_prompt_embeds)
from mvedit_tpu.pipelines import denoise as JDn
import mvedit_tpu_torch.models.diffusion as TD
from mvedit_tpu_torch.models.diffusion import clip as TC
from mvedit_tpu_torch.models.diffusion import ip_adapter as TI
from mvedit_tpu_torch.models.diffusion.weights import (attn2_keys,
                                                       torch_state_from_flax)
from mvedit_tpu_torch.pipelines import denoise as TDn

torch.set_num_threads(2)

TINY_UNET = UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                       attn_down=(True, False), cross_attention_dim=32,
                       num_heads=4, dtype=jnp.float32)
T_UNET = TD.UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                       attn_down=(True, False), cross_attention_dim=32,
                       num_heads=4, dtype=torch.float32)
VISION = dict(image_size=32, patch_size=8, hidden_size=32,
              intermediate_size=64, num_layers=3, num_heads=4,
              projection_dim=24)
IP_TOKENS = 4


def _close(out, ref, rtol=1e-4):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _jitter(params, seed, scale=0.1):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.standard_normal(
            p.shape).astype(np.float32), params)


def _t(x):
    return torch.from_numpy(np.array(x))


def _load(module, params, kind):
    module.load_state_dict(torch_state_from_flax(params, kind), strict=True)
    return module.eval().requires_grad_(False)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_vision_tower(act):
    j = CLIPVisionModel(CLIPVisionConfig(act=act, **VISION))
    p = _jitter(j.init(jax.random.PRNGKey(1),
                       jnp.zeros((1, 32, 32, 3)))["params"], 1)
    tmod = _load(TC.CLIPVisionModel(TC.CLIPVisionConfig(act=act, **VISION)),
                 p, "clip_vision")
    x = np.random.RandomState(2).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        _close(tmod(_t(x)), j.apply({"params": p}, x))
        _close(tmod(_t(x), return_hidden=True),
               j.apply({"params": p}, x, return_hidden=True))


def test_image_proj_model():
    j = ImageProjModel(cross_attention_dim=32, clip_embed_dim=24,
                       num_tokens=IP_TOKENS)
    p = _jitter(j.init(jax.random.PRNGKey(3), jnp.zeros((1, 24)))["params"],
                3)
    tmod = _load(TI.ImageProjModel(32, 24, IP_TOKENS), p, "image_proj")
    rng = np.random.RandomState(4)
    x = rng.standard_normal((3, 24)).astype(np.float32)
    with torch.no_grad():
        tok = tmod(_t(x))
        _close(tok, j.apply({"params": p}, x))
    # the CFG contexts with the image tokens appended
    text, untext = (rng.standard_normal((3, 7, 32)).astype(np.float32)
                    for _ in range(2))
    jpos, jneg = get_ip_prompt_embeds(text, untext, np.asarray(tok),
                                      np.zeros_like(np.asarray(tok)))
    tpos, tneg = TI.get_ip_prompt_embeds(_t(text), _t(untext), tok,
                                         torch.zeros_like(tok))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tneg.numpy(), np.asarray(jneg))


def test_resampler():
    kw = dict(dim=32, depth=2, dim_head=8, heads=4, num_queries=16,
              embedding_dim=24, output_dim=32, ff_mult=2)
    j = Resampler(**kw)
    p = _jitter(j.init(jax.random.PRNGKey(5),
                       jnp.zeros((1, 17, 24)))["params"], 5)
    tmod = _load(TI.Resampler(**kw), p, "resampler")
    x = np.random.RandomState(6).standard_normal(
        (2, 17, 24)).astype(np.float32)
    with torch.no_grad():
        _close(tmod(_t(x)), j.apply({"params": p}, x))


def _ip_unet_pair(seed=7):
    """The JAX UNet initialised in IP mode (ip_to_k / ip_to_v on every
    cross-attention) and the port's with `add_ip_branches`, same weights."""
    j = UNet2DCondition(TINY_UNET)
    p = _jitter(j.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, 4)),
                       jnp.zeros((1,), jnp.int32), jnp.zeros((1, 8, 32)),
                       mode=AttnMode(ip_tokens=IP_TOKENS),
                       ip_context=jnp.zeros((1, IP_TOKENS, 32)))["params"],
                seed)
    tmod = TD.UNet2DCondition(T_UNET)
    new = TI.add_ip_branches(tmod)
    # one ip_to_k and one ip_to_v per cross-attention (4 in the tiny UNet),
    # named as the IP-Adapter checkpoint's entries are mapped
    keys = attn2_keys(T_UNET)
    assert len(keys) == 4
    assert sorted(new) == sorted(f"{k}.ip_to_{b}.weight" for k in keys
                                 for b in "kv")
    return j, p, _load(tmod, p, "unet")


def test_unet_with_ip_context():
    j, p, tmod = _ip_unet_pair()
    rng = np.random.RandomState(8)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([999, 300], np.int32)
    ctx = rng.standard_normal((2, 7, 32)).astype(np.float32)
    ipc = rng.standard_normal((2, IP_TOKENS, 32)).astype(np.float32)
    for mode_kw in (dict(ip_tokens=IP_TOKENS),
                    dict(ip_tokens=IP_TOKENS, ip_scale=0.6),
                    dict(ip_tokens=IP_TOKENS, num_views=2)):
        jm, tm = AttnMode(**mode_kw), TD.AttnMode(**mode_kw)
        ref = j.apply({"params": p}, lat, t, ctx, mode=jm, ip_context=ipc)
        with torch.no_grad():
            out = tmod(_t(lat), _t(t), _t(ctx), mode=tm, ip_context=_t(ipc))
            _close(out, ref)
            # the encoder / decoder split of the 2-pass denoise
            enc = tmod(_t(lat), _t(t), _t(ctx), part="enc", mode=tm,
                       ip_context=_t(ipc))
            _close(tmod(None, None, None, part="dec", enc_state=enc,
                        mode=tm, ip_context=_t(ipc)), ref)
    # the image tokens change the output (the branch is live)
    with torch.no_grad():
        plain = tmod(_t(lat), _t(t), _t(ctx))
    assert float((plain - out).abs().max()) > 1e-3


def test_denoise_2pass_with_ip_context():
    """One 2-pass step with reference pairs and IP tokens, chunked by
    diff_bs 2 over 3 views (the texture pipeline's call), against the JAX
    package's chunked functions."""
    from mvedit_tpu.models.diffusion import ControlNet
    j, p, tmod = _ip_unet_pair(9)
    cns_j, cns_p, cns_t = [], [], []
    for s in (10, 11):
        cj = ControlNet(TINY_UNET, hint_strides=1)
        cp = _jitter(cj.init(jax.random.PRNGKey(s), jnp.zeros((1, 8, 8, 4)),
                             jnp.zeros((1,), jnp.int32),
                             jnp.zeros((1, 8, 32)),
                             jnp.zeros((1, 16, 16, 3)))["params"], s)
        cns_j.append(cj)
        cns_p.append(cp)
        cns_t.append(_load(TD.ControlNet(T_UNET, hint_strides=1), cp,
                           "controlnet"))
    N = 3
    rng = np.random.RandomState(12)
    lat = rng.standard_normal((2 * N, 8, 8, 4)).astype(np.float32)
    t = np.full((2 * N,), 700, np.int32)
    emb = rng.standard_normal((2 * N, 7, 32)).astype(np.float32)
    ipc = np.concatenate([np.repeat(rng.standard_normal(
        (1, IP_TOKENS, 32)), N, 0), np.repeat(rng.standard_normal(
            (1, IP_TOKENS, 32)), N, 0)]).astype(np.float32)
    depth, tile = (rng.random((2 * N, 16, 16, 3)).astype(np.float32)
                   for _ in range(2))
    ref_noisy = rng.standard_normal((N, 8, 8, 4)).astype(np.float32)
    jm = JDn.DenoiseModels(unet=j, controlnets=tuple(cns_j), num_views=N,
                           ip_tokens=IP_TOKENS, use_reference=True)
    tm = TDn.DenoiseModels(unet=tmod, controlnets=tuple(cns_t), num_views=N,
                           ip_tokens=IP_TOKENS, use_reference=True)
    jp1, jp2 = JDn.make_chunked_noise_pred_2pass(jm, 2)
    tp1, tp2 = TDn.make_chunked_noise_pred_2pass(tm, 2)
    eps_j, enc_j, res_j = jp1(p, cns_p, lat, t, emb, depth, 0.5, 7.0,
                              ip_context=ipc, ref_noisy=ref_noisy)
    eps_t, enc_t, res_t = tp1(_t(lat), _t(t), _t(emb), _t(depth), 0.5, 7.0,
                              ip_context=_t(ipc), ref_noisy=_t(ref_noisy))
    _close(eps_t, eps_j)
    out_j = jp2(p, cns_p, lat, enc_j, res_j, t, emb, tile, depth, 1.0, 0.5,
                7.0, ip_context=ipc, ref_noisy=ref_noisy)
    out_t = tp2(_t(lat), enc_t, res_t, _t(t), _t(emb), _t(tile), _t(depth),
                1.0, 0.5, 7.0, ip_context=_t(ipc), ref_noisy=_t(ref_noisy))
    _close(out_t, out_j)
