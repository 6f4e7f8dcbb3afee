"""Zero123++ at its published family's shape in the port against the
benchmark's plain float32 reference (`portbench/reference/zero123plus.py`,
which imports nothing of the port), on the CPU in float32 with seeded
weights (`portbench/harness/weights.py`, the same draw for both):

- a tiny SD2-family UNet (linear proj_in / proj_out, a fixed head dim of
  16, a cross-attention width of 24 that is neither block's width): the
  write pass's stored states and output, the read pass's output, and the
  read pass with the normal ControlNet's residuals;
- the pipeline's prompt embeds of the CFG batch and its guided
  Euler-ancestral step on their own;
- a 2-step v1.2 normal pass through `Zero123PlusPipeline` (the vision
  tower with GELU, the ramped condition, the write and read passes, the
  ControlNet on the hint, the v-prediction CFG Euler-ancestral step, the
  latent roll, the VAE), the same draws in both: the grid;
- the full-size build (on `meta`): `load_zero123plus` and
  `load_zero123plus_normal` have the shapes of the benchmark's
  configuration file and share no model with MVEdit's SD1.5 stack;
- the benchmark's cell at its tiny preset: correct, and its control (the
  reference in float8) refused on every number.

Tolerances: the port and the reference compute the same float32
products in another order (the port's attention in one softmax over the
keys, the reference's in blocks of queries; the port's GroupNorm and
LayerNorm through an f32 copy): relative L2 <= 1e-5 a call; the grid
after two steps within 1e-4, the Euler-ancestral step's sigma ratios
computed in float32 by the port and float64 by the reference.
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from mvedit_tpu_torch.models.diffusion import (AttnMode, AutoencoderKL,
                                               ControlNet, UNet2DCondition,
                                               UNetConfig, VAEConfig)
from mvedit_tpu_torch.models.diffusion import schedulers as S
from mvedit_tpu_torch.models.diffusion.clip import (CLIPVisionConfig,
                                                    CLIPVisionModel)
from mvedit_tpu_torch.pipelines.zero123plus import (Zero123PlusConfig,
                                                    Zero123PlusPipeline)
from portbench.harness.weights import seed_params_
from portbench.reference import diffusion as RD
from portbench.reference import zero123plus as RZ

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                  "zero123plus_v12.json")))
UNET = dict(block_out_channels=(32, 64), layers_per_block=1,
            attn_down=(True, False), cross_attention_dim=24, num_heads=0,
            head_dim=16, use_linear_projection=True)
VAE = dict(block_out_channels=(32, 64), layers_per_block=1)
VISION = dict(image_size=32, patch_size=8, hidden_size=32,
              intermediate_size=64, num_layers=2, num_heads=4,
              projection_dim=24, act="gelu")
SEED = 2 ** 31 + 11
CPU = torch.device("cpu")


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _pair(port, ref, tag):
    a = {k: tuple(p.shape) for k, p in port.named_parameters()}
    assert a == {k: tuple(p.shape) for k, p in ref.named_parameters()}
    for m in (port, ref):
        seed_params_(m, SEED, tag, CPU)
        m.eval().requires_grad_(False)
    return port, ref


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    p, r = types.SimpleNamespace(), types.SimpleNamespace()
    p.unet, r.unet = _pair(
        UNet2DCondition(UNetConfig(**UNET, dtype=torch.float32)),
        RZ.UNet(RD.UNetCfg(**UNET)), "UNet2DCondition:5")
    p.controlnet, r.controlnet = _pair(
        ControlNet(UNetConfig(**UNET, dtype=torch.float32), hint_strides=1),
        RD.ControlNet(RD.UNetCfg(**UNET), 1), "ControlNet:1")
    p.vae, r.vae = _pair(AutoencoderKL(VAEConfig(**VAE, dtype=torch.float32)),
                         RD.VAE(RD.VAECfg(**VAE)), "AutoencoderKL:0")
    p.vision, r.vision = _pair(CLIPVisionModel(CLIPVisionConfig(**VISION)),
                               RZ.CLIPVision(RZ.VisionCfg(**VISION)),
                               "CLIPVisionModel:3")
    for m in (p, r):
        m.ramping = np.linspace(0, 1, 8).astype(np.float32)
        m.text_uncond = torch.zeros((1, 8, 24))
    p.schedule = S.sd_schedule(prediction_type="v_prediction")
    return p, r


def _inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    cond, lat = (torch.randn((2, 12, 8, 4), generator=g) for _ in range(2))
    emb = torch.randn((2, 8, 24), generator=g)
    hint = torch.rand((2, 24, 16, 3), generator=g)     # /2 to the latents
    return cond, lat, emb, torch.tensor([500, 500], dtype=torch.int32), hint


@torch.no_grad()
def test_write_pass_matches_the_reference(models):
    p, r = models
    cond, _, emb, t2, _ = _inputs()
    out, states = p.unet(cond, t2, emb, mode=AttnMode(reference="write"))
    rout, rstates = r.unet(cond, t2, emb, {"reference": "write"})
    # level 0 (12 x 8 tokens) down and up (two), level 1 (6 x 4) mid; the
    # stored states are the transformers' normed inputs at their widths
    assert [tuple(s.shape) for s in states] == [(2, 96, 32), (2, 24, 64),
                                                (2, 96, 32), (2, 96, 32)]
    assert max(_rel(a, b) for a, b in zip(states, rstates)) <= 1e-5
    assert _rel(out, rout) <= 1e-5


@pytest.mark.parametrize("with_controlnet", [False, True])
@torch.no_grad()
def test_read_pass_matches_the_reference(models, with_controlnet):
    p, r = models
    cond, lat, emb, t2, hint = _inputs(2)
    _, states = p.unet(cond, t2, emb, mode=AttnMode(reference="write"))
    down = mid = rdown = rmid = None
    if with_controlnet:
        down, mid = p.controlnet(lat, t2, emb, hint, conditioning_scale=0.7)
        rdown, rmid = r.controlnet(lat, t2, emb, hint,
                                   conditioning_scale=0.7)
        assert max(_rel(a, b) for a, b in zip(down + [mid],
                                               rdown + [rmid])) <= 1e-5
    out = p.unet(lat, t2, emb, mode=AttnMode(reference="read"),
                 ref_kv=states, down_block_res=down, mid_block_res=mid)
    ref = r.unet(lat, t2, emb, {"reference": "read"}, states, rdown, rmid)
    assert _rel(out, ref) <= 1e-5
    # what is compared moves the output: the stored states, the residuals
    plain = r.unet(lat, t2, emb, None, None, rdown, rmid)
    assert _rel(plain, ref) > 1e-3
    if with_controlnet:
        assert _rel(r.unet(lat, t2, emb, {"reference": "read"}, states),
                    ref) > 1e-3


class _Draws:
    """The same draws for the port's pipeline and the reference."""

    def __init__(self, init, steps):
        self.init, self.steps, self.i = init, steps, 0

    def initial_latents(self, shape, device):
        assert tuple(shape) == tuple(self.init.shape)
        return self.init

    def step_noise(self, ref_shape, lat_shape, device):
        s = self.steps[self.i]
        self.i += 1
        return s


@torch.no_grad()
def test_condition_and_guided_step_match_the_reference(models):
    """The pipeline's two steps that the benchmark judges on the card, on
    their own: the CFG batch's prompt embeds (text_uncond, then the
    ramped image embed on it) and the CFG combine with the
    Euler-ancestral step, at a high timestep and at the last one."""
    p, r = models
    pipe = Zero123PlusPipeline(p, Zero123PlusConfig(num_steps=2,
                                                    grid_hw=(48, 32)))
    g = torch.Generator().manual_seed(4)
    pixels = torch.rand((1, 32, 32, 3), generator=g)
    emb = pipe._encode_condition(pixels)
    assert emb.shape == (2, 8, 24) and torch.equal(emb[:1], p.text_uncond)
    ref = RZ.encode_condition(r.vision, pixels, r.text_uncond, r.ramping)
    assert _rel(emb[1:], ref) <= 1e-5
    lat, noise = (torch.randn((1, 24, 16, 4), generator=g) for _ in range(2))
    out = torch.randn((2, 24, 16, 4), generator=g)
    acp = RZ.sd_alphas_cumprod()
    for t, t_prev in ((999, 499), (499, -1)):
        got, _ = pipe._guided_step(lat, out, t, t_prev, noise, None)
        want = RZ.cfg_euler_ancestral(acp, lat, out, 4.0, t, t_prev, noise)
        assert _rel(got, want) <= 1e-5


def test_normal_pass_matches_the_reference(models):
    p, r = models
    g = torch.Generator().manual_seed(3)
    image = torch.rand((1, 48, 32, 3), generator=g)
    pixels = torch.rand((1, 32, 32, 3), generator=g)
    hint = torch.rand((1, 48, 32, 3), generator=g)
    init = torch.randn((1, 24, 16, 4), generator=g)
    steps = [(torch.randn((1, 24, 16, 4), generator=g),
              torch.randn((1, 24, 16, 4), generator=g)) for _ in range(2)]
    out = Zero123PlusPipeline(p, Zero123PlusConfig(
        num_steps=2, grid_hw=(48, 32), shift_views=True))(
        image, pixels, draws=_Draws(init, steps), normal_cond=hint)
    with torch.no_grad():
        ref = RZ.sample(r, image, pixels, (init, steps), num_steps=2,
                        shift_views=True, normal_cond=hint)
    assert out.shape == ref.shape == (1, 48, 32, 3)
    assert 0.05 < float(ref.std())
    assert float((out - ref).abs().max()) <= 1e-4


def test_full_size_build_has_the_configuration_widths():
    """The runner's full-size Zero123++ build, made on `meta`: the
    configuration file's UNet, normal UNet, ControlNet, vision tower and
    condition, and no model of MVEdit's SD1.5 stack."""
    import mvedit_tpu_torch.apis.runner as R
    r = R.Adapter3DRunner(device="meta")

    def build(name, make, **kw):
        if name not in r._cache:
            with torch.device("meta"):
                r._cache[name] = make()
        return r._cache[name]
    r._build = build
    rgb = r.load_zero123plus("1.2")
    nrm = r.load_zero123plus_normal("1.2")
    assert sorted(r._cache) == ["controlnet:z123_normal", "vae:sd15",
                                "z123_normal_unet:1.2", "z123_unet:1.2",
                                "z123_vision:1.2"]
    for mod, key in ((rgb.unet, "unet"), (nrm.unet, "normal_unet"),
                     (nrm.controlnet, "normal_unet")):
        u = dict(CFG[key], block_out_channels=tuple(
            CFG[key]["block_out_channels"]), attn_down=tuple(
            CFG[key]["attn_down"]))
        assert {k: getattr(mod.cfg, k) for k in u} == u
    with torch.device("meta"):
        ref = RZ.UNet(RD.UNetCfg(**{k: getattr(rgb.unet.cfg, k)
                                    for k in CFG["unet"]}))
    assert {k: p.shape for k, p in rgb.unet.named_parameters()} == \
        {k: p.shape for k, p in ref.named_parameters()}
    # level 0's self-attention: 5 heads of 64 over 320 channels
    attn = rgb.unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1
    assert (attn.heads, attn.dim_head) == (5, 64)
    assert {k: getattr(rgb.vision.cfg, k) for k in CFG["vision"]} == \
        CFG["vision"]
    assert list(rgb.text_uncond.shape) == CFG["text_uncond"]
    assert nrm.controlnet.controlnet_cond_embedding.conv_in.in_channels \
        == CFG["controlnet"]["conditioning_channels"]
    assert rgb.vae is nrm.vae and rgb.vision is nrm.vision
    assert rgb.unet is not nrm.unet
    mvedit = r.load_stable_diffusion()
    assert mvedit.unet.cfg.cross_attention_dim == 768
    assert all(m is not mvedit.unet for m in (rgb.unet, nrm.unet))


def test_benchmark_cell_at_tiny_size(tmp_path):
    """The cell's dry run at the tiny preset: correct, with the control's
    readings (`--readings 1`) above every limit."""
    env = dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path))
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "zero123plus_v12.views_normals", "--seed",
         str(SEED), "--seconds", "0.1", "--device", "cpu", "--preset",
         "tiny", "--readings", "1"], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["attempted"] >= 2, out["check"]
    control = {line.split()[1]: float(line.split()[2])
               for line in res.stderr.splitlines()
               if line.startswith("control ")}
    assert set(control) == set(out["check"])
    assert all(control[k] > c["limit"] for k, c in out["check"].items()), \
        control
