"""The port's denoise slice against the JAX package's, on the CPU in fp32.

- Two 2-pass reference-pair timesteps at 3 views, run the way the MVEdit
  3D pipeline runs them (`mvedit_3d.py:769-941`) with the 3D fuse left
  out: the decoded x0 images stand in for the renders as tile and depth
  hints.
- The `diff_bs` chunked 2-pass and 1-pass variants (diff_bs=2 at 3 views:
  one full chunk and one padded remainder).
- The 1-pass path, with reference pairs and with all-view joint attention.
- A tiny `run_text_to_img` (64^2, 2 steps) with the JAX noise draw
  injected.
- The port imports no JAX.

Weights are the JAX package's seeded tiny models sent through the bridge;
inputs are made from a seed with numpy. Tolerances: rtol 1e-4 and
atol 1e-4 * max|ref| for one denoise call, 5e-4 for results after two
timesteps or two sampler steps, because convolutions and matmuls sum in a
different order in XLA and PyTorch and the differences compound through
the UNet, the VAE and the solver.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.models.diffusion import (AutoencoderKL, ControlNet,
                                         UNet2DCondition, UNetConfig,
                                         VAEConfig, schedulers as S)
from mvedit_tpu.pipelines import denoise as JD
import mvedit_tpu_torch.models.diffusion as TD
from mvedit_tpu_torch.models.diffusion import schedulers as TS
from mvedit_tpu_torch.models.diffusion.weights import torch_state_from_flax
from mvedit_tpu_torch.pipelines import denoise as PD

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 3                       # views
GS, TILE_W, DEPTH_W = 7.0, 1.0, 0.5

TINY_UNET = UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                       attn_down=(True, False), cross_attention_dim=32,
                       num_heads=4, dtype=jnp.float32)
TINY_VAE = VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                     dtype=jnp.float32)
T_UNET = TD.UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                       attn_down=(True, False), cross_attention_dim=32,
                       num_heads=4, dtype=torch.float32)
T_VAE = TD.VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                     dtype=torch.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(out, ref, rtol):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _jitter(params, rng, scale=0.1):
    # the ControlNets' zero-initialised convs (controlnet.py:64,100,104)
    # get seeded values, or their residual path would be all zeros
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.standard_normal(
            p.shape).astype(np.float32), params)


@pytest.fixture(scope="module")
def models():
    """JAX tiny UNet, tile + depth ControlNets and VAE, and their port
    twins loaded through the bridge."""
    rng = np.random.RandomState(0)
    k = jax.random.split(jax.random.PRNGKey(0), 4)
    lat, t0 = jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32)
    ctx, hint = jnp.zeros((1, 8, 32)), jnp.zeros((1, 16, 16, 3))
    unet = UNet2DCondition(TINY_UNET)
    cns = tuple(ControlNet(TINY_UNET, hint_strides=1) for _ in range(2))
    vae = AutoencoderKL(TINY_VAE)
    up = _jitter(unet.init(k[0], lat, t0, ctx)["params"], rng)
    cps = [_jitter(cn.init(kk, lat, t0, ctx, hint)["params"], rng)
           for cn, kk in zip(cns, k[1:3])]
    vp = _jitter(vae.init(k[3], jnp.zeros((1, 16, 16, 3)))["params"], rng)

    def load(module, params, kind):
        module.load_state_dict(torch_state_from_flax(params, kind))
        return module.eval().requires_grad_(False)

    t_unet = load(TD.UNet2DCondition(T_UNET), up, "unet")
    t_cns = tuple(load(TD.ControlNet(T_UNET, hint_strides=1), p,
                       "controlnet") for p in cps)
    t_vae = load(TD.AutoencoderKL(T_VAE), vp, "vae")
    return dict(unet=unet, cns=cns, vae=vae, up=up, cps=cps, vp=vp,
                t_unet=t_unet, t_cns=t_cns, t_vae=t_vae)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(1)
    return dict(
        images=rng.uniform(size=(N, 16, 16, 3)).astype(np.float32),
        pos=rng.standard_normal((N, 7, 32)).astype(np.float32),
        neg=rng.standard_normal((N, 7, 32)).astype(np.float32),
        noise=rng.standard_normal((8, 8, 4)).astype(np.float32),
        ref_noise=rng.standard_normal((8, 8, 4)).astype(np.float32),
        lat=rng.standard_normal((2 * N, 8, 8, 4)).astype(np.float32),
        ref=rng.standard_normal((N, 8, 8, 4)).astype(np.float32),
        hints=[rng.uniform(size=(2 * N, 16, 16, 3)).astype(np.float32)
               for _ in range(2)])


def _hints(dec):
    """Tile hint: the decoded views; depth hint: their gray level as a
    3-channel image (a normalised depth map's layout)."""
    if isinstance(dec, torch.Tensor):
        return dec, dec.mean(-1, keepdim=True).expand_as(dec)
    return dec, jnp.repeat(dec.mean(-1, keepdims=True), 3, -1)


@pytest.fixture(scope="module")
def jax_fns(models):
    """The JAX package's jitted denoise functions, compiled once for the
    module: the whole-batch 2-pass and 1-pass steps and the VAE."""
    md = models
    dm = JD.DenoiseModels(unet=md["unet"], controlnets=md["cns"],
                          num_views=N, use_reference=True)
    vae, vp = md["vae"], md["vp"]
    return dict(
        p1p2=JD.make_noise_pred_2pass(dm),
        one_ref=JD.make_noise_pred_1pass(dm),
        one_joint=JD.make_noise_pred_1pass(JD.DenoiseModels(
            unet=md["unet"], controlnets=md["cns"], num_views=N)),
        enc=jax.jit(lambda im: vae.apply({"params": vp}, im,
                                         method=vae.encode)),
        dec=jax.jit(lambda z: vae.apply({"params": vp}, z,
                                        method=vae.decode)))


@pytest.fixture(scope="module")
def jax_timesteps(models, inputs, jax_fns):
    """(latents, ref_noisy) after two 2-pass reference-pair timesteps of
    the JAX package."""
    md, x = models, inputs
    sch = S.sd_schedule()
    p1, p2 = jax_fns["p1p2"]
    enc, dec = jax_fns["enc"], jax_fns["dec"]
    steps = S.make_timesteps(24, 1000, "trailing")
    lat0 = enc(x["images"] * 2 - 1)
    t0 = jnp.full((N,), int(steps[0]))
    latents = S.add_noise(sch, lat0, jnp.broadcast_to(x["noise"],
                                                      lat0.shape), t0)
    ref_noisy = S.add_noise(sch, lat0, jnp.broadcast_to(x["ref_noise"],
                                                        lat0.shape), t0)
    state = ref_state = S.SolverState.init(latents.shape)
    embeds = jnp.concatenate([x["neg"], x["pos"]], 0)
    for i in range(2):
        t, t_prev = int(steps[i]), int(steps[i + 1])
        t_vec = jnp.full((2 * N,), t, jnp.int32)
        cfg_lat = jnp.concatenate([latents, latents], 0)
        eps, enc_state, p1_res = p1(md["up"], md["cps"], cfg_lat, t_vec,
                                    embeds, None, DEPTH_W, GS,
                                    ref_noisy=ref_noisy)
        sa, sn = sch.sqrt_acp(jnp.asarray(t))
        dec_imgs = jnp.clip((dec((latents - sn * eps) / sa) + 1) / 2, 0, 1)
        tile, depth = _hints(dec_imgs)
        eps_3d = (latents - sa * enc(tile * 2 - 1)) / sn
        eps_unet = p2(md["up"], md["cps"], cfg_lat, enc_state, p1_res, t_vec,
                      embeds, jnp.concatenate([tile, tile], 0),
                      jnp.concatenate([depth, depth], 0), TILE_W, DEPTH_W,
                      GS, ref_noisy=ref_noisy)
        bw = 1.0 - sa
        latents, state = S.dpmsolver_step(
            sch, latents, bw * eps_3d + (1 - bw) * eps_unet, jnp.asarray(t),
            jnp.asarray(t_prev), state)
        ref_noisy, ref_state = S.dpmsolver_step(
            sch, ref_noisy, (ref_noisy - sa * lat0) / sn, jnp.asarray(t),
            jnp.asarray(t_prev), ref_state)
    return latents, ref_noisy


@torch.inference_mode()
def _torch_timesteps(md, x, diff_bs):
    """The port's twin of `jax_timesteps`; diff_bs > 0 runs the chunked
    p1/p2."""
    sch = TS.sd_schedule()
    dm = PD.DenoiseModels(unet=md["t_unet"], controlnets=md["t_cns"],
                          num_views=N, use_reference=True)
    p1, p2 = (PD.make_chunked_noise_pred_2pass(dm, diff_bs) if diff_bs
              else PD.make_noise_pred_2pass(dm))
    vae = md["t_vae"]
    steps = TS.make_timesteps(24, 1000, "trailing")
    lat0 = vae.encode(_t(x["images"]) * 2 - 1)
    latents = TS.add_noise(sch, lat0, _t(x["noise"]).expand_as(lat0),
                           int(steps[0]))
    ref_noisy = TS.add_noise(sch, lat0, _t(x["ref_noise"]).expand_as(lat0),
                             int(steps[0]))
    state = ref_state = TS.SolverState.init(latents)
    embeds = torch.cat([_t(x["neg"]), _t(x["pos"])], 0)
    for i in range(2):
        t, t_prev = int(steps[i]), int(steps[i + 1])
        t_vec = torch.full((2 * N,), t, dtype=torch.int32)
        cfg_lat = torch.cat([latents, latents], 0)
        eps, enc_state, p1_res = p1(cfg_lat, t_vec, embeds, None, DEPTH_W,
                                    GS, ref_noisy=ref_noisy)
        sa, sn = sch.sqrt_acp(t)
        dec_imgs = ((vae.decode((latents - sn * eps) / sa) + 1) / 2).clamp(
            0, 1)
        tile, depth = _hints(dec_imgs)
        eps_3d = (latents - sa * vae.encode(tile * 2 - 1)) / sn
        eps_unet = p2(cfg_lat, enc_state, p1_res, t_vec, embeds,
                      torch.cat([tile, tile], 0), torch.cat([depth, depth], 0),
                      TILE_W, DEPTH_W, GS, ref_noisy=ref_noisy)
        bw = 1.0 - sa
        latents, state = TS.dpmsolver_step(
            sch, latents, bw * eps_3d + (1 - bw) * eps_unet, t, t_prev,
            state)
        ref_noisy, ref_state = TS.dpmsolver_step(
            sch, ref_noisy, (ref_noisy - sa * lat0) / sn, t, t_prev,
            ref_state)
    return latents, ref_noisy


@pytest.mark.parametrize("diff_bs", [0, 2])
def test_two_pass_reference_pair_timesteps(models, inputs, jax_timesteps,
                                           diff_bs):
    """Two full denoise timesteps. The chunked run (diff_bs=2) is held
    against the JAX whole-batch run too: chunking is exact in reference-pair
    mode, which the JAX package's own tests pin."""
    lat_ref, rn_ref = jax_timesteps
    lat, rn = _torch_timesteps(models, inputs, diff_bs)
    assert np.isfinite(lat.numpy()).all()
    _close(lat, lat_ref, 5e-4)
    _close(rn, rn_ref, 5e-4)


def test_chunked_p1_p2_outputs(models, inputs, jax_fns):
    """The chunked p1 reassembles eps, the encoder states and the
    residuals in the whole-batch layouts; p2 consumes them."""
    x = inputs
    dm_t = PD.DenoiseModels(unet=models["t_unet"],
                            controlnets=models["t_cns"], num_views=N,
                            use_reference=True)
    p1_j, p2_j = jax_fns["p1p2"]
    p1_t, p2_t = PD.make_chunked_noise_pred_2pass(dm_t, 2)
    t = np.full((2 * N,), 500, np.int32)
    emb = np.concatenate([x["neg"], x["pos"]], 0)
    # p1 without a depth hint, as the MVEdit 3D pipeline calls it, so no
    # ControlNet runs in p1 and its residuals are None
    eps_j, enc_j, res_j = p1_j(models["up"], models["cps"], x["lat"], t,
                               emb, None, DEPTH_W, GS, ref_noisy=x["ref"])
    eps_t, enc_t, res_t = p1_t(_t(x["lat"]), _t(t), _t(emb), None, DEPTH_W,
                               GS, ref_noisy=_t(x["ref"]))
    assert res_t == (None, None)
    _close(eps_t, eps_j, 1e-4)
    for enc_a, enc_b in zip(enc_t, enc_j):
        _close(enc_a["h"].permute(0, 2, 3, 1), enc_b["h"], 1e-4)
        for a, b in zip(enc_a["residuals"], enc_b["residuals"]):
            _close(a.permute(0, 2, 3, 1), b, 1e-4)
    eps2_j = p2_j(models["up"], models["cps"], x["lat"], enc_j, res_j, t,
                  emb, x["hints"][0], x["hints"][1], TILE_W, DEPTH_W, GS,
                  ref_noisy=x["ref"])
    eps2_t = p2_t(_t(x["lat"]), enc_t, res_t, _t(t), _t(emb),
                  _t(x["hints"][0]), _t(x["hints"][1]), TILE_W, DEPTH_W, GS,
                  ref_noisy=_t(x["ref"]))
    _close(eps2_t, eps2_j, 1e-4)


@pytest.mark.parametrize("use_reference,diff_bs", [(True, 0), (True, 2),
                                                   (False, 0)])
def test_one_pass(models, inputs, jax_fns, use_reference, diff_bs):
    """1-pass: reference pairs (whole batch and chunked, both held against
    the JAX whole batch) and all-view joint attention."""
    x = inputs
    dm_t = PD.DenoiseModels(unet=models["t_unet"],
                            controlnets=models["t_cns"], num_views=N,
                            use_reference=use_reference)
    one_j = jax_fns["one_ref" if use_reference else "one_joint"]
    one_t = (PD.make_chunked_noise_pred_1pass(dm_t, diff_bs) if diff_bs
             else PD.make_noise_pred_1pass(dm_t))
    t = np.full((2 * N,), 700, np.int32)
    emb = np.concatenate([x["neg"], x["pos"]], 0)
    ref = x["ref"] if use_reference else None
    eps_j = one_j(models["up"], models["cps"], x["lat"], t, emb, x["hints"],
                  [TILE_W, DEPTH_W], GS, ref_noisy=ref)
    eps_t = one_t(_t(x["lat"]), _t(t), _t(emb), [_t(h) for h in x["hints"]],
                  [TILE_W, DEPTH_W], GS,
                  ref_noisy=None if ref is None else _t(ref))
    _close(eps_t, eps_j, 1e-4)


def test_chunk_view_batches(models):
    """diff_bs chunking of a per-view function (the pipeline's 512^2 VAE
    passes): every call sees exactly diff_bs rows, the remainder padded,
    and the result equals the whole batch's."""
    vae = models["t_vae"]
    x = torch.from_numpy(np.random.RandomState(2).uniform(
        -1, 1, (5, 16, 16, 3)).astype(np.float32))
    rows = []

    def encode(z):
        rows.append(z.shape[0])
        return vae.encode(z)

    with torch.no_grad():
        out = PD.chunk_view_batches(encode, 2)(x)
        whole = vae.encode(x)
    assert rows == [2, 2, 2]
    torch.testing.assert_close(out, whole, rtol=1e-5, atol=1e-5)


def test_run_text_to_img_tiny():
    """A whole tiny request: tokenizer, CLIP, the CFG DPM-Solver++ loop and
    the VAE decode, from the JAX runner's weights and noise draw. The JAX
    runner tokenizes with the port's crc32 word ids
    (`torch_tokenizer.StableHashTokenizer`)."""
    from mvedit_tpu.apis import Adapter3DRunner as JaxRunner
    from mvedit_tpu_torch.apis import Adapter3DRunner
    from torch_tokenizer import StableHashTokenizer
    jr = JaxRunner(tiny_models=True, seed=0)
    jr.tokenizer = StableHashTokenizer()
    ref = jr.run_text_to_img("a red car", "blurry", seed=3, steps=2)
    jm = jr.load_stable_diffusion()
    tr = Adapter3DRunner(tiny_models=True, seed=0, device="cpu")
    tm = tr.load_stable_diffusion()
    for mod, params, kind in ((tm.unet, jm.unet_params, "unet"),
                              (tm.vae, jm.vae_params, "vae"),
                              (tm.text, jm.text_params, "clip_text")):
        mod.load_state_dict(torch_state_from_flax(
            jax.tree_util.tree_map(np.asarray, params), kind))
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                       (1, 32, 32, 4)))
    img = tr.text_to_img_from_latents(tm, "a red car", "blurry", _t(lat),
                                      steps=2, cfg_scale=7.0)
    assert img.shape == (64, 64, 3) and img.dtype == np.float32
    _close(img, ref, 5e-4)
    # the endpoint itself draws its own noise from a seeded generator
    a = tr.run_text_to_img("a red car", seed=3, steps=2)
    b = tr.run_text_to_img("a red car", seed=3, steps=2)
    assert a.shape == (64, 64, 3) and np.isfinite(a).all()
    assert a.min() >= 0 and a.max() <= 1
    np.testing.assert_array_equal(a, b)


def test_port_imports_no_jax():
    code = ("import sys, mvedit_tpu_torch, mvedit_tpu_torch.apis, "
            "mvedit_tpu_torch.pipelines.denoise, "
            "mvedit_tpu_torch.kernels.flash_attention, "
            "mvedit_tpu_torch.models.mesh_fit, "
            "mvedit_tpu_torch.models.mesh.rasterize, "
            "mvedit_tpu_torch.models.mesh.renderer, "
            "mvedit_tpu_torch.pipelines.mvedit_3d, "
            "mvedit_tpu_torch.kernels.raster_select, "
            "mvedit_tpu_torch.ops.flash_attention\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'mvedit_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
