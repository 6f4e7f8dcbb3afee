"""The port's tiny bundles (`mvedit_tpu_torch.testing`) against the JAX
package's (`mvedit_tpu.testing`), on the CPU in f32:

- the configurations field for field, and `make_tiny_mvedit_cfg`'s
  (the reference's `latent_size` has no port counterpart);
- JAX's bundle bridged into the port's (`torch_state_from_flax`, every
  key loaded strictly; the ControlNets' zero heads jittered first, or
  their residuals would be zero): the UNet with joint attention over 2
  views, both ControlNets and the VAE's encode and decode within 1e-5 of
  the largest magnitude;
- `make_tiny_models` seeded: one seed, one bundle.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mvedit_tpu.testing as JT
from mvedit_tpu.models.diffusion import AttnMode as JAttnMode

import mvedit_tpu_torch.testing as TT
from mvedit_tpu_torch.models.diffusion import AttnMode
from mvedit_tpu_torch.models.diffusion.weights import torch_state_from_flax


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=1e-5 * max(np.abs(b).max(), 1e-30))


def test_configs_match_reference():
    for name in ("block_out_channels", "layers_per_block", "attn_down",
                 "cross_attention_dim", "num_heads"):
        assert getattr(TT.TINY_UNET, name) == getattr(JT.TINY_UNET, name)
    for name in ("block_out_channels", "layers_per_block"):
        assert getattr(TT.TINY_VAE, name) == getattr(JT.TINY_VAE, name)
    assert TT.TINY_UNET.dtype == TT.TINY_VAE.dtype == torch.float32
    assert dataclasses.asdict(TT.TINY_INGP.hash) == \
        dataclasses.asdict(JT.TINY_INGP.hash)
    tc = TT.make_tiny_mvedit_cfg(num_views=3, render_size=32, steps=2,
                                 nerf_switch_progress=0.5)
    jc = JT.make_tiny_mvedit_cfg(num_views=3, render_size=32, steps=2,
                                 nerf_switch_progress=0.5)
    for f in dataclasses.fields(tc):
        if f.name in ("ingp", "render"):
            continue
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert dataclasses.asdict(tc.ingp.hash) == dataclasses.asdict(
        jc.ingp.hash)
    for f in dataclasses.fields(tc.render):
        assert getattr(tc.render, f.name) == getattr(jc.render, f.name)


def test_bridged_bundle_matches_reference():
    jm = JT.make_tiny_models(jax.random.PRNGKey(0), n_cn=2, hint_strides=1)
    gen = torch.Generator()
    gen.manual_seed(0)
    tm = TT.make_tiny_models(gen, n_cn=2, hint_strides=1)
    rng = np.random.default_rng(0)
    tm.unet.load_state_dict(torch_state_from_flax(
        jax.tree_util.tree_map(np.asarray, jm.unet_params), "unet"))
    tm.vae.load_state_dict(torch_state_from_flax(
        jax.tree_util.tree_map(np.asarray, jm.vae_params), "vae"))
    cn_params = [jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32), p) for p in jm.cn_params]
    for net, p in zip(tm.controlnets, cn_params):
        net.load_state_dict(torch_state_from_flax(p, "controlnet"))

    x = rng.normal(size=(4, 8, 8, 4)).astype(np.float32)
    t = np.array([10, 300, 500, 999], np.int32)
    ctx = rng.normal(size=(4, 8, 32)).astype(np.float32)
    hint = rng.uniform(0, 1, (4, 16, 16, 3)).astype(np.float32)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    tx, tt, tctx, thint, timg = (torch.from_numpy(a) for a in
                                 (x, t, ctx, hint, img))
    with torch.no_grad():
        eps = tm.unet(tx, tt, tctx, mode=AttnMode(num_views=2))
        res = [net(tx, tt, tctx, thint, conditioning_scale=0.7)
               for net in tm.controlnets]
        lat = tm.vae.encode(timg)
        dec = tm.vae.decode(lat)
    _close(eps, jm.unet.apply({"params": jm.unet_params}, x, t, ctx,
                              mode=JAttnMode(num_views=2)))
    for (downs, mid), net, p in zip(res, jm.controlnets, cn_params):
        jd, jmid = net.apply({"params": p}, x, t, ctx, hint,
                             conditioning_scale=0.7)
        assert len(downs) == len(jd)
        for a, b in zip(downs, jd):
            _close(a.permute(0, 2, 3, 1) if a.shape[1:] != b.shape[1:]
                   else a, b)
        _close(mid.permute(0, 2, 3, 1) if mid.shape[1:] != jmid.shape[1:]
               else mid, jmid)
    vae = jm.vae
    jlat = vae.apply({"params": jm.vae_params}, jnp.asarray(img),
                     method=vae.encode)
    _close(lat, jlat)
    _close(dec, vae.apply({"params": jm.vae_params}, jlat,
                          method=vae.decode))


def test_make_tiny_models_is_seeded():
    def bundle(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        m = TT.make_tiny_models(gen, n_cn=1)
        return [t for net in (m.unet, m.vae, *m.controlnets)
                for t in net.state_dict().values()]
    a, b, c = bundle(3), bundle(3), bundle(4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
