"""The StableSSDNeRF recipe (`mvedit_tpu_torch/configs/stablessdnerf_cars_
lpips.py`) against the JAX package's `configs/stablessdnerf_cars_lpips.py`,
on the CPU in f32, at tiny widths: the JAX recipe's own `build_denoiser`
and `make_cond_fn`, with its SD2.1 UNet config swapped for a tiny one with
the same flags (two levels of 32 / 64, heads of 8, linear projections,
the recipe's 1024-wide context), its code cut to (3, 4, 8, 8) and its CLIP
to 64 wide; the base weights, the LoRA (B drawn nonzero) and CLIP bridged;
JAX's step draws replayed (`torch_jax_draws.ssdnerf_step_draws`); the
JAX tokenizer handed the port's crc32 ids
(`torch_tokenizer.StableHashTokenizer`):

- the denoiser's forward, with text `cond` and with `cond=None` (zeros),
  within 1e-5 relative (L2); the code's way into the UNet: the (P * H,
  W, C) latent image of the JAX recipe's `transpose(0, 1, 3, 4, 2)`;
- `make_cond_fn`'s embeddings at act "gelu": within 1e-5 relative;
- three train steps through both packages' `make_train_step` with text
  `cond` and the LPIPS patch term (a seeded VGG16 at its widths on one
  16 x 16 patch a scene): the losses within 1e-5 at the first step and
  1e-4 after; after one step the LoRA (and its first Adam moments), the
  codes and the decoder within 1e-4 relative, after three 1e-3 (the
  tolerances of `test_torch_ssdnerf_train.py`'s steps: Adam's eps
  amplifies rounding in gradients near 0);
- the state holds the LoRA alone, and the frozen base is bit-equal to its
  initial value after a step; through `tools/train_ssdnerf.main` on a
  tiny copy of the recipe with a captions pickle, the state, the EMA and
  the checkpoint hold the LoRA alone.
"""
import dataclasses
import importlib.util
import inspect
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mvedit_tpu.models.diffusion as JDiff
from mvedit_tpu.models import ssdnerf as JS
from mvedit_tpu.models import triplane as JT
from mvedit_tpu.models.diffusion import clip as JClip
from mvedit_tpu.models.diffusion import schedulers as JSch
from mvedit_tpu.models.diffusion import tokenizer as JTok
from mvedit_tpu.models.diffusion.unet import UNetConfig as JUNetConfig
from mvedit_tpu.models.volume_renderer import RenderConfig as JRender

from mvedit_tpu_torch.configs import stablessdnerf_cars_lpips as S
from mvedit_tpu_torch.models import ssdnerf as TS
from mvedit_tpu_torch.models import triplane as TT
from mvedit_tpu_torch.models.diffusion import schedulers as TSch
from mvedit_tpu_torch.models.diffusion.clip import CLIPTextConfig
from mvedit_tpu_torch.models.diffusion.lora import lora_params_from_flax
from mvedit_tpu_torch.models.diffusion.unet import (UNet2DCondition,
                                                    UNetConfig)
from mvedit_tpu_torch.models.diffusion.weights import torch_state_from_flax
from mvedit_tpu_torch.models.volume_renderer import RenderConfig as TRender

from torch_jax_draws import ssdnerf_step_draws
from torch_tokenizer import StableHashTokenizer

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, CODE, PS = 2, (3, 4, 8, 8), 16
UNET = dict(block_out_channels=(32, 64), attn_down=(True, False),
            layers_per_block=1, cross_attention_dim=1024,
            use_linear_projection=True, head_dim=8, num_heads=0)
TEXT = dict(hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, act="gelu")
TP = dict(n_channels=4, base_layers=(12, 16), density_layers=(16, 1),
          color_layers=(16, 3), dir_layers=(16, 16), bound=0.5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_recipe():
    spec = importlib.util.spec_from_file_location(
        "jax_stablessdnerf", os.path.join(REPO, "configs",
                                          "stablessdnerf_cars_lpips.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.ssdnerf_config = dataclasses.replace(
        mod.ssdnerf_config, code_shape=CODE, latent_shape=CODE)
    return mod


@pytest.fixture(scope="module")
def recipe():
    mp = pytest.MonkeyPatch()
    mp.setattr(JDiff, "SD21_UNET", JUNetConfig(dtype=jnp.float32, **UNET))
    mod = _jax_recipe()
    _, apply, lora = mod.build_denoiser(jax.random.PRNGKey(0))
    mp.undo()
    base = inspect.getclosurevars(apply).nonlocals["base"]
    rng = np.random.default_rng(1)
    base = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape)
        .astype(np.float32), base)
    lora = {k: {"a": np.asarray(v["a"]),
                "b": rng.normal(size=v["b"].shape).astype(np.float32) * 0.05}
            for k, v in lora.items()}

    # the recipe's own apply, its closure's base jittered
    cell = apply.__closure__[apply.__code__.co_freevars.index("base")]
    cell.cell_contents = base
    tunet = UNet2DCondition(UNetConfig(dtype=torch.float32, **UNET))
    tunet.load_state_dict(torch_state_from_flax(base, "unet"), strict=True)
    tnet = S.LoRADenoiser(tunet, lora_params_from_flax(lora), CODE)
    return dict(apply=apply, lora=lora, tnet=tnet, base=base)


def _flat_lora(tree):
    return {f"lora.{p}.{f}": v for p, ab in lora_params_from_flax(
        tree).items() for f, v in ab.items()}


def test_denoiser_forward_matches_jax(recipe):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, *CODE)).astype(np.float32)
    t = np.array([5, 801], np.int32)
    cond = (rng.normal(size=(B, 77, 1024)) * 0.5).astype(np.float32)
    net = recipe["tnet"]
    seen = []
    hook = net.unet.register_forward_hook(
        lambda m, args, out: seen.append(args[0]))
    apply = TS.module_apply(net)
    params = TS.module_params(net)
    with torch.no_grad():
        for c in (cond, None):
            jout = recipe["apply"](recipe["lora"], jnp.asarray(x),
                                   jnp.asarray(t),
                                   None if c is None else jnp.asarray(c))
            tout = apply(params, _t(x), _t(t), None if c is None else _t(c))
            assert tout.shape == (B, *CODE)
            assert _rel(tout, jout) <= 1e-5
    hook.remove()
    np.testing.assert_array_equal(
        seen[0].numpy(), x.transpose(0, 1, 3, 4, 2).reshape(B, 24, 8, 4))


def test_cond_fn_matches_jax(monkeypatch):
    monkeypatch.delenv("MVEDIT_CHECKPOINT_DIR", raising=False)
    real = JClip.CLIPTextConfig
    monkeypatch.setattr(JClip, "CLIPTextConfig",
                        lambda **kw: real(**dict(kw, **TEXT)))
    monkeypatch.setattr(JTok, "HashTokenizer", StableHashTokenizer)
    jfn = _jax_recipe().make_cond_fn()
    params = inspect.getclosurevars(jfn).nonlocals["params"]
    monkeypatch.setattr(S, "SD21_TEXT", CLIPTextConfig(**TEXT))
    tfn = S.make_cond_fn("cpu")
    tfn.net.load_state_dict(torch_state_from_flax(params, "clip_text"),
                            strict=True)
    caps = ["a red sports car", "an old pickup truck with wooden sides"]
    je, te = jfn(caps), tfn(caps)
    assert te.shape == (2, 77, 64)
    assert _rel(te, je) <= 1e-5


def _batch():
    rng = np.random.default_rng(6)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    R = PS * PS
    ro = np.tile((rot @ np.array([0, 0, -1.3], np.float32))[None, None],
                 (B, R, 1))
    rd = rng.normal(size=(B, R, 3)).astype(np.float32) * 0.25 - ro / 1.3
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return {"rays_o": ro, "rays_d": rd,
            "rgb": rng.random((B, R, 3)).astype(np.float32),
            "cond": (rng.normal(size=(B, 77, 1024)) * 0.5).astype(
                np.float32)}


def test_train_steps_match_jax(recipe):
    from mvedit_tpu.models.losses import lpips_init as j_lpips_init
    from mvedit_tpu_torch.models.losses import lpips_params_from_flax
    kw = dict(code_shape=CODE, latent_shape=CODE, n_rays=PS * PS,
              code_lr=0.04)
    jcfg = JS.SSDNeRFConfig(triplane=JT.TriPlaneConfig(**TP),
                            render=JRender(num_samples=16, bound=0.5), **kw)
    tcfg = TS.SSDNeRFConfig(triplane=TT.TriPlaneConfig(**TP),
                            render=TRender(num_samples=16, bound=0.5), **kw)
    lp = jax.tree_util.tree_map(np.asarray,
                                j_lpips_init(jax.random.PRNGKey(3)))
    sch = "v_prediction"
    jstep = JS.make_train_step(recipe["apply"], jcfg.triplane, jcfg,
                               JSch.sd_schedule(prediction_type=sch),
                               lpips_params=lp, patch_size=PS)
    net = recipe["tnet"]
    tstep = TS.make_train_step(TS.module_apply(net), tcfg.triplane, tcfg,
                               TSch.sd_schedule(prediction_type=sch),
                               lpips_params=lpips_params_from_flax(lp),
                               patch_size=PS)
    decoder = jax.tree_util.tree_map(np.asarray, JT.triplane_init(
        jax.random.PRNGKey(1), jcfg.triplane))
    codes = (np.random.default_rng(7).normal(size=(B, *CODE)) * 0.5).astype(
        np.float32)
    lora = jax.tree_util.tree_map(jnp.array, recipe["lora"])
    js = {"decoder": jax.tree_util.tree_map(jnp.array, decoder),
          "decoder_opt": optax.adam(1e-3).init(decoder),
          "denoiser": lora,
          "denoiser_opt": optax.adamw(1e-4, weight_decay=1e-2).init(lora),
          "codes": jnp.array(codes), "code_m": jnp.zeros(codes.shape),
          "code_v": jnp.zeros(codes.shape),
          "code_steps": jnp.zeros((B,), jnp.int32)}
    dec = TT.triplane_params_from_flax(decoder)
    dparams = TS.module_params(net)
    assert set(dparams) == set(_flat_lora(recipe["lora"]))
    ts = {"decoder": dec, "decoder_opt": TS.adam_init(dec),
          "denoiser": dparams, "denoiser_opt": TS.adam_init(dparams),
          "codes": _t(codes), "code_m": torch.zeros(codes.shape),
          "code_v": torch.zeros(codes.shape),
          "code_steps": torch.zeros((B,), dtype=torch.int32)}
    base0 = {k: v.clone() for k, v in net.unet.state_dict().items()}
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(v) for k, v in b.items()}
    for i in range(3):
        key = jax.random.PRNGKey(40 + i)
        js, jm = jstep(js, dict(jb), key)
        ts, tm = tstep(ts, dict(tb), draws=ssdnerf_step_draws(key, B, CODE))
        assert set(tm) == set(jm) == {"loss_diffusion", "loss_render"}
        for k in jm:
            assert abs(float(tm[k]) - float(jm[k])) <= (
                1e-5 if i == 0 else 1e-4) * abs(float(jm[k])), (i, k)
        tol = 1e-4 if i == 0 else 1e-3
        jl = _flat_lora(js["denoiser"])
        diffs = {"codes": _rel(ts["codes"], js["codes"]),
                 "lora": max(_rel(ts["denoiser"][k], jl[k]) for k in jl),
                 "decoder": max(_rel(a, c) for a, c in zip(
                     TS.tree_leaves(ts["decoder"]), TS.tree_leaves(
                         TT.triplane_params_from_flax(js["decoder"]))))}
        if i == 0:
            mu = _flat_lora(js["denoiser_opt"][0].mu)
            diffs["lora_mu"] = max(_rel(ts["denoiser_opt"]["m"][k], mu[k])
                                   for k in mu)
        bad = {k: d for k, d in diffs.items() if not d <= tol}
        assert not bad, (i, bad)
    # the LoRA moved; the frozen base did not, bit for bit
    assert any(not torch.equal(ts["denoiser"][k], dparams[k])
               for k in dparams)
    state = net.unet.state_dict()
    assert all(torch.equal(state[k], base0[k]) for k in base0)
    assert not any(p.requires_grad for p in net.unet.parameters())


def _tiny_recipe(monkeypatch):
    """The port's recipe module at the tiny widths: its UNet (context 64),
    CLIP (64 wide) and code."""
    monkeypatch.setattr(S, "SD21_UNET", UNetConfig(
        dtype=torch.float32, **dict(UNET, cross_attention_dim=64)))
    monkeypatch.setattr(S, "SD21_TEXT", CLIPTextConfig(**TEXT))
    monkeypatch.setattr(S, "ssdnerf_config", dataclasses.replace(
        S.ssdnerf_config, code_shape=CODE, latent_shape=CODE))


def test_built_recipe_state_holds_the_lora_alone(monkeypatch):
    _tiny_recipe(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    net = S.build_denoiser(gen, "cpu")
    params = TS.module_params(net)
    n_proj = 4 * 2 * 4      # to_q/k/v/out x attn1/2 x 4 transformers
    assert len(params) == 2 * n_proj
    assert all(k.startswith("lora.") and k[-2:] in (".a", ".b")
               for k in params)
    assert all(not v.any() for k, v in params.items() if k.endswith(".b"))
    rank = {v.shape[0] for k, v in params.items() if k.endswith(".a")}
    assert rank == {32}
    assert sum(v.numel() for v in params.values()) < sum(
        p.numel() for p in net.unet.parameters()) / 4


CFG = '''
import dataclasses
from mvedit_tpu_torch.configs import stablessdnerf_cars_lpips as base
from mvedit_tpu_torch.models.volume_renderer import RenderConfig

ssdnerf_config = dataclasses.replace(
    base.ssdnerf_config, render=RenderConfig(num_samples=8, bound=0.5),
    n_rays={rays})
train_config = dict(base.train_config, batch_size=2, max_iters=2,
                    log_interval=1, ckpt_interval=2, patch_size={ps})
captions = {captions!r}


def build_denoiser(generator=None, device=None):
    return base.build_denoiser(generator, device)


def make_cond_fn(device=None):
    return base.make_cond_fn(device)
'''


def _srn(root, scenes=3, views=2, size=16):
    from PIL import Image
    for s in range(scenes):
        d = os.path.join(root, f"scene{s}")
        os.makedirs(os.path.join(d, "rgb"))
        os.makedirs(os.path.join(d, "pose"))
        rng = np.random.default_rng(20 + s)
        for i in range(views):
            Image.fromarray((rng.random((size, size, 3)) * 255).astype(
                np.uint8)).save(os.path.join(d, "rgb", f"{i:06d}.png"))
            pose = np.eye(4)
            pose[2, 3] = -1.3
            np.savetxt(os.path.join(d, "pose", f"{i:06d}.txt"),
                       pose.reshape(1, 16))
        with open(os.path.join(d, "intrinsics.txt"), "w") as f:
            f.write(f"{size} {size / 2} {size / 2} 0\n0 0 0\n{size} "
                    f"{size}\n")


def test_training_cli_keeps_the_lora_alone(tmp_path, monkeypatch):
    from mvedit_tpu_torch.runner.trainer import CheckpointHook
    from mvedit_tpu_torch.tools import train_ssdnerf
    monkeypatch.delenv("MVEDIT_CHECKPOINT_DIR", raising=False)
    data = str(tmp_path / "srn")
    _srn(data)
    caps = str(tmp_path / "captions.pkl")
    with open(caps, "wb") as f:
        pickle.dump({f"scene{s}": f"a car number {s}" for s in range(3)}, f)
    _tiny_recipe(monkeypatch)
    cfg = str(tmp_path / "cfg.py")
    with open(cfg, "w") as f:
        f.write(CFG.format(rays=PS * PS, ps=PS, captions=caps))
    calls = []
    real = S.make_cond_fn

    def spy(*a, **k):
        fn = real(*a, **k)

        def wrapped(captions):
            calls.append(list(captions))
            return fn(captions)
        return wrapped
    monkeypatch.setattr(S, "make_cond_fn", spy)
    work = str(tmp_path / "work")
    out = train_ssdnerf.main(["--config", cfg, "--data", data, "--work-dir",
                              work, "--device", "cpu"])
    assert out.trainer.step == 2 and len(calls) == 2
    assert all(c.startswith("a car number") for cs in calls for c in cs)
    state = out.trainer.state
    assert all(k.startswith("lora.") for k in state["denoiser"])
    assert set(out.ema["denoiser"]) == set(state["denoiser"])
    saved, step = CheckpointHook.load(work)
    assert step == 2
    assert set(saved["denoiser"]) == set(state["denoiser"])
    assert set(saved["denoiser_opt"]["m"]) == set(state["denoiser"])
    assert np.isfinite([m["loss_render"] for m in out.metrics]).all()


def _same(a, b):
    la, lb = TS.tree_leaves(a), TS.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _tiny_cfg(tmp_path):
    from mvedit_tpu_torch.tools.train_ssdnerf import load_config
    cfg = str(tmp_path / "cfg.py")
    with open(cfg, "w") as f:
        f.write(CFG.format(rays=PS * PS, ps=PS, captions=None))
    return cfg, load_config(cfg)


@pytest.mark.parametrize("seed", [0, 5])
def test_cli_builders_draw_from_cpu_generators(tmp_path, monkeypatch, seed):
    """The seeded frozen weights come from CPU generators (the CPU's and the
    card's give different streams, and a LoRA checkpoint holds the LoRA
    alone): at `--device cpu`, `train_ssdnerf.init_models`' decoder,
    denoiser (base and LoRA) and LPIPS, `test_ssdnerf.eval_denoiser`, the
    recipe's text tower and `inception_stat.load_inception`'s net equal
    builds from `torch.Generator().manual_seed(seed)` of their seeds.
    `tests/test_torch_kernels_cuda.py` holds the card's builds to these."""
    from mvedit_tpu_torch.models.diffusion.clip import CLIPTextModel
    from mvedit_tpu_torch.models.inception import InceptionV3Features
    from mvedit_tpu_torch.models.losses import lpips_init
    from mvedit_tpu_torch.apis.runner import init_random_
    from mvedit_tpu_torch.tools import (inception_stat, test_ssdnerf,
                                        train_ssdnerf)
    _tiny_recipe(monkeypatch)
    _, cfg_mod = _tiny_cfg(tmp_path)
    cpu = torch.device("cpu")

    def gen(s):
        return torch.Generator().manual_seed(s)
    decoder, net, lp = train_ssdnerf.init_models(cfg_mod, seed, cpu)
    assert _same(decoder, TT.triplane_init(S.ssdnerf_config.triplane,
                                           gen(seed), cpu))
    ref = S.build_denoiser(gen(seed), cpu)
    assert _same(dict(net.unet.named_parameters()),
                 dict(ref.unet.named_parameters()))
    assert _same(TS.module_params(net), TS.module_params(ref))
    assert _same(lp, lpips_init(gen(7), cpu))
    ev = test_ssdnerf.eval_denoiser(cfg_mod, cpu)
    ref0 = S.build_denoiser(gen(0), cpu)
    assert _same(TS.module_params(ev), TS.module_params(ref0))
    assert _same(dict(ev.unet.named_parameters()),
                 dict(ref0.unet.named_parameters()))
    text = CLIPTextModel(S.SD21_TEXT)
    init_random_(text, gen(1))
    assert _same(dict(S.make_cond_fn(cpu).net.named_parameters()),
                 dict(text.named_parameters()))
    if seed == 0:
        inc = InceptionV3Features()
        init_random_(inc, gen(0))
        assert _same(inception_stat.load_inception(None, cpu).state_dict(),
                     inc.state_dict())


def test_eval_cli_rebuilds_the_base_from_seed_0(tmp_path, monkeypatch):
    """The reference's own behaviour, pinned (ROADMAP Queue 3): a run
    trained with `--seed 3` builds its denoiser from a CPU generator of
    seed 3, and `test_ssdnerf`'s recons eval rebuilds the frozen base from
    seed 0, on a CPU generator too."""
    from mvedit_tpu_torch.tools import test_ssdnerf, train_ssdnerf
    monkeypatch.delenv("MVEDIT_CHECKPOINT_DIR", raising=False)
    _tiny_recipe(monkeypatch)
    cfg, _ = _tiny_cfg(tmp_path)
    data = str(tmp_path / "srn")
    _srn(data)
    calls = []
    real = S.build_denoiser

    def spy(generator=None, device=None):
        calls.append((generator.device.type, generator.initial_seed()))
        return real(generator, device)
    monkeypatch.setattr(S, "build_denoiser", spy)
    work = str(tmp_path / "work")
    common = ["--config", cfg, "--data", data, "--work-dir", work,
              "--device", "cpu"]
    train_ssdnerf.main(common + ["--seed", "3", "--max-iters", "1"])
    got = test_ssdnerf.main(common + ["--num-scenes", "1",
                                      "--recons-views", "1",
                                      "--recons-steps", "1"])
    assert calls == [("cpu", 3), ("cpu", 0)]
    assert got["scenes"] == 1 and np.isfinite(got["psnr"])
