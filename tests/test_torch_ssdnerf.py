"""Text-to-3D in the port against the JAX package, on the CPU in f32.

- `sample_from_noise` with a toy denoiser (a channel-mixing tanh of the
  latent and its timestep) in each mode: DPM-Solver++, DDIM, the Karras
  table, CFG on a doubled batch, x0 gradient guidance and the Langevin
  corrector (its per-step draws replayed from JAX's keys): within 1e-5
  relative (L2);
- the SSDNeRF cars `LatentDenoiser` at its published widths (ch 128, 4
  residual blocks, GroupNorm(32) eps 1e-6, the planes folded into
  channels plane-major) on one step, flax params (biases and norms
  jittered) bridged through `torch_state_from_flax(..., "latent_
  denoiser")`: within 1e-4 relative;
- one whole tiny `run_stablessdnerf_to_mesh` in both packages (the port's
  runner with the JAX runner's SD stack, ControlNets, denoiser and
  triplane decoder bridged, and JAX's draws replayed through
  `torch_jax_draws.JaxTextTo3DDraws`; the prompts tokenized alike through
  `torch_tokenizer.StableHashTokenizer`), held in its parts:
  - `run_stablessdnerf` (4 steps, the 32^2 preview): the code within 1e-4
    relative, the preview max |d| <= 1e-4;
  - `distill_triplane_to_field` (20 steps of 65536 points) from JAX's
    code and decoder: the MLP within 1e-3 and the tables within 1e-2
    relative (the NeRF chunk's bounds, `test_torch_nerf_fit.py`);
  - the MVEdit loop, with `test_torch_pipeline.py`'s bounds: the latents
    after the first timestep within 2e-3 of their magnitude, the
    reference rows within 1e-4; the mesh's face count within 10%, its
    vertices' mean radius within 2%, its bounding box within 0.05. JAX
    gives a mesh on these inputs (the reference's own tiny test tolerates
    none) without any density bias: the seeded decoder, 4 samples of the
    seeded denoiser and seed 1 leave a surface.

  Both runners' MVEdit field gathers its dense grid in f32 here, as
  `test_torch_nerf_fit.py`'s does: the distillation's 20 Adam steps
  (eps 1e-8, lr 5e-3) move every table entry, and with the runners'
  bf16 gather an entry that the two frameworks' f32 sums leave on either
  side of a bf16 rounding boundary reads one bf16 ulp (0.4%) apart from
  then on. Measured with bf16: the distilled tables 1.4% apart, the first
  MLP layer 0.56%, the first timestep's latents 2.08e-3 of their
  magnitude; with f32: 1.7e-5, 1.2e-5 and 1.1e-5. `test_torch_pipeline.py`
  holds the bf16 gather on a request whose field starts from one init,
  and the distillation at bf16 is held here by the fields it fits: their
  rgb and log1p(sigma) at points in the box within retex's max 1e-2 /
  mean 1e-3.
JAX's own tiny request takes most of this file's time.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.apis import Adapter3DRunner as JRunner
from mvedit_tpu.models import gaussian_diffusion as JGD
from mvedit_tpu.models.diffusion import schedulers as JS
from mvedit_tpu.models.triplane import triplane_init as j_triplane_init

from mvedit_tpu_torch.apis import Adapter3DRunner as TRunner
from mvedit_tpu_torch.configs.ssdnerf_cars import LatentDenoiser
from mvedit_tpu_torch.models import gaussian_diffusion as TGD
from mvedit_tpu_torch.models.diffusion import schedulers as TS
from mvedit_tpu_torch.models.diffusion.weights import torch_state_from_flax
from mvedit_tpu_torch.models.fields import field_leaves
from mvedit_tpu_torch.models.triplane import triplane_params_from_flax

from test_torch_pipeline import _bridge
from torch_jax_draws import JaxTextTo3DDraws
from torch_tokenizer import StableHashTokenizer

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, PROMPT = 1, "a red car"
SHAPE = (2, 3, 4, 6, 6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_config_module():
    spec = importlib.util.spec_from_file_location(
        "ssdnerf_cfg", os.path.join(REPO, "configs", "ssdnerf_cars.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# sample_from_noise
# ---------------------------------------------------------------------------

_W = np.random.default_rng(0).normal(size=(4, 4)).astype(np.float32) * 0.4
_TARGET = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
_COND = np.random.default_rng(2).normal(size=SHAPE).astype(np.float32)
_UNCOND = np.random.default_rng(3).normal(size=SHAPE).astype(np.float32)
MODES = {
    "dpmsolver": dict(),
    "ddim": dict(solver="ddim"),
    "karras": dict(use_karras=True),
    "cfg": dict(guidance_scale=3.0),
    "guidance": dict(guide_gain=0.5),
    "langevin": dict(langevin_steps=2, langevin_t_range=(200, 900)),
}


def _toy_j(x, t, c):
    s = (t.astype(jnp.float32) / 1000.0)[:, None, None, None, None]
    out = jnp.tanh(jnp.einsum("bpchw,cd->bpdhw", x, _W)) * (0.5 + s) + 0.1 * x
    return out if c is None else out + 0.3 * c


def _toy_t(x, t, c):
    s = (t.float() / 1000.0)[:, None, None, None, None]
    out = torch.tanh(torch.einsum("bpchw,cd->bpdhw", x, _t(_W))) \
        * (0.5 + s) + 0.1 * x
    return out if c is None else out + 0.3 * c


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sample_from_noise_matches_jax(mode):
    kw = dict(MODES[mode])
    steps = 6
    sch_j = JS.sd_schedule(prediction_type="v_prediction")
    sch_t = TS.sd_schedule(prediction_type="v_prediction")
    jkw, tkw = dict(kw), dict(kw)
    if mode == "cfg":
        jkw.update(cond=jnp.asarray(_COND), uncond=jnp.asarray(_UNCOND))
        tkw.update(cond=_t(_COND), uncond=_t(_UNCOND))
    if mode == "guidance":
        jkw["grad_guide_fn"] = lambda z: 0.05 * jnp.sum((z - _TARGET) ** 2)
        tkw["grad_guide_fn"] = lambda z: 0.05 * ((z - _t(_TARGET)) ** 2).sum()
    key = jax.random.PRNGKey(5)
    out_j = np.asarray(JGD.sample_from_noise(sch_j, _toy_j, SHAPE, key,
                                             num_steps=steps, **jkw))
    # JAX's draws: key -> (key, k0) for x_T, then one key a step; the
    # corrector's k-th draw from fold_in(step key, k)
    key, k0 = jax.random.split(key)
    step_keys = jax.random.split(key, steps)
    lg = np.stack([np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(sk, k), SHAPE)) for k in range(2)])
        for sk in step_keys])
    out_t = TGD.sample_from_noise(
        sch_t, _toy_t, SHAPE, noise=_t(jax.random.normal(k0, SHAPE)),
        num_steps=steps,
        langevin_noise=_t(lg) if mode == "langevin" else None, **tkw).numpy()
    assert np.isfinite(out_j).all() and out_t.shape == SHAPE
    assert _rel(out_t, out_j) <= 1e-5, _rel(out_t, out_j)


def test_sample_from_noise_draws_from_the_generator():
    """Without given draws the port draws the initial noise and the
    corrector's from its generator: one seed, one sample."""
    sch = TS.sd_schedule(prediction_type="v_prediction")

    def run():
        return TGD.sample_from_noise(
            sch, _toy_t, SHAPE, generator=torch.Generator().manual_seed(3),
            num_steps=4, langevin_steps=1, langevin_t_range=(0, 999))
    a, b = run(), run()
    assert torch.equal(a, b) and torch.isfinite(a).all()


# ---------------------------------------------------------------------------
# the denoiser
# ---------------------------------------------------------------------------

def test_latent_denoiser_matches_jax():
    mod = _jax_config_module()
    net, apply, params = mod.build_denoiser(jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape)
        .astype(np.float32), params)
    x = rng.normal(size=(2, 3, 12, 40, 40)).astype(np.float32)
    t = np.array([10, 700], np.int32)
    out_j = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(t), None))
    tnet = LatentDenoiser()
    tnet.load_state_dict(torch_state_from_flax(params, "latent_denoiser"),
                         strict=True)
    with torch.no_grad():
        out_t = tnet(_t(x), _t(t), None).numpy()
    assert out_t.shape == out_j.shape == (2, 3, 12, 40, 40)
    assert _rel(out_t, out_j) <= 1e-4, _rel(out_t, out_j)


# ---------------------------------------------------------------------------
# the whole tiny request
# ---------------------------------------------------------------------------

def _record_solver(module, calls, skip_tracers=False):
    step = module.dpmsolver_step

    def wrapped(*a, **k):
        out = step(*a, **k)
        if skip_tracers and isinstance(out[0], jax.core.Tracer):
            return out
        calls.append(out[0].detach().cpu().numpy()
                     if isinstance(out[0], torch.Tensor)
                     else np.array(out[0]))
        return out
    return wrapped


def _f32_gather(runner):
    """The runner's MVEdit field with its dense grid gathered in f32."""
    orig = runner._mvedit_cfg

    def cfg(*a, **k):
        c = orig(*a, **k)
        dense = dataclasses.replace(c.ingp.dense, gather_dtype="float32")
        return dataclasses.replace(
            c, ingp=dataclasses.replace(c.ingp, dense=dense))
    runner._mvedit_cfg = cfg


@pytest.fixture(scope="module")
def request_pair(tmp_path_factory):
    """JAX's whole tiny request, its parts recorded, and the port's runner
    with JAX's weights; the port's whole request with JAX's draws."""
    root = tmp_path_factory.mktemp("t23")
    jr = JRunner(tiny_models=True, seed=0)
    jr.tokenizer = StableHashTokenizer()
    tr = TRunner(tiny_models=True, seed=0, device="cpu")
    _bridge(jr, tr)
    for r in (jr, tr):
        _f32_gather(r)
    rec = {}
    orig_sample, orig_distill = jr.run_stablessdnerf, \
        jr.distill_triplane_to_field

    def sample(*a, **k):
        rec["ssd"] = orig_sample(*a, **k)
        return rec["ssd"]

    def distill(decoder, code_act, *a, **k):
        rec["distill_in"] = (decoder, np.asarray(code_act), a, k)
        field = orig_distill(decoder, code_act, *a, **k)
        # a copy: the MVEdit loop donates the field's buffers
        rec["field"] = jax.tree_util.tree_map(np.array, field)
        return field
    jr.run_stablessdnerf, jr.distill_triplane_to_field = sample, distill
    calls_j, calls_t = [], []
    orig_j, orig_t = JS.dpmsolver_step, TS.dpmsolver_step
    JS.dpmsolver_step = _record_solver(JS, calls_j, skip_tracers=True)
    TS.dpmsolver_step = _record_solver(TS, calls_t)
    try:
        out_j = jr.run_stablessdnerf_to_mesh(PROMPT, seed=SEED,
                                             out_path=str(root / "jax.glb"))
        ss = tr.load_ssdnerf()
        _, _, dparams = _jax_config_module().build_denoiser(
            jax.random.PRNGKey(SEED))
        ss.denoiser.load_state_dict(torch_state_from_flax(
            jax.tree_util.tree_map(np.asarray, dparams), "latent_denoiser"))
        ss.decoder = triplane_params_from_flax(j_triplane_init(
            jax.random.PRNGKey(jr.seed), ss.cfg.triplane))
        ingp = jr._mvedit_cfg(3, 2, 4, 8).ingp
        rec["ingp"] = ingp
        out_t = tr.run_stablessdnerf_to_mesh(
            PROMPT, seed=SEED, out_path=str(root / "port.glb"),
            draws=JaxTextTo3DDraws(SEED, ingp))
    finally:
        JS.dpmsolver_step, TS.dpmsolver_step = orig_j, orig_t
    return jr, tr, rec, out_j, out_t, calls_j, calls_t


def test_run_stablessdnerf_matches_jax(request_pair):
    jr, tr, rec, *_ = request_pair
    out = tr.run_stablessdnerf(PROMPT, seed=SEED,
                               draws=JaxTextTo3DDraws(SEED, rec["ingp"]))
    code_j = np.asarray(rec["ssd"]["code"])
    assert out["code"].shape == code_j.shape == (3, 12, 40, 40)
    assert np.isfinite(code_j).all()
    assert _rel(out["code"].numpy(), code_j) <= 1e-4, \
        _rel(out["code"].numpy(), code_j)
    prev_j = np.asarray(rec["ssd"]["preview"])
    assert out["preview"].shape == prev_j.shape == (32, 32, 3)
    assert np.abs(out["preview"] - prev_j).max() <= 1e-4
    assert prev_j.std() > 1e-3


def test_distill_triplane_to_field_matches_jax(request_pair):
    jr, tr, rec, *_ = request_pair
    decoder, code_act, a, k = rec["distill_in"]
    assert a[1].dense.gather_dtype == "float32"
    assert k.get("steps") == 20
    ss = tr.load_ssdnerf()
    tcfg = tr._mvedit_cfg(3, 2, 4, 8).ingp
    p_t = tr.distill_triplane_to_field(
        triplane_params_from_flax(decoder), _t(code_act), ss.cfg, tcfg,
        steps=20, draws=JaxTextTo3DDraws(SEED, rec["ingp"]))
    field_j = rec["field"]
    leaves_j = ([field_j["table"][n] for n in sorted(field_j["table"])]
                + [l[n] for l in field_j["mlp"] for n in ("w", "b")])
    n_tables = len(field_j["table"])
    for i, (a_, b) in enumerate(zip(field_leaves(p_t), leaves_j)):
        tol = 1e-2 if i < n_tables else 1e-3
        assert _rel(a_.numpy(), b) <= tol, (i, _rel(a_.numpy(), b))


def test_distill_bf16_gather_fields_match_jax(request_pair):
    """The distillation at the runners' own bf16 gather, held by what it
    fits: the distilled fields' rgb and log1p(sigma) at 4096 points in the
    triplane's box within retex's bounds on renders (max |d| <= 1e-2,
    mean |d| <= 1e-3). The tables part by a bf16 ulp here and there (see
    the module's docstring); what the field decodes must not."""
    from mvedit_tpu.models.fields import ingp_point_decode as j_decode
    from mvedit_tpu_torch.models.fields import ingp_point_decode as t_decode
    jr, tr, rec, *_ = request_pair
    decoder, code_act, a, k = rec["distill_in"]

    def bf16(c):
        return dataclasses.replace(c, dense=dataclasses.replace(
            c.dense, gather_dtype="bfloat16"))
    jcfg, tcfg = bf16(rec["ingp"]), bf16(tr._mvedit_cfg(3, 2, 4, 8).ingp)
    # the JAX runner's own method, past the fixture's recording wrapper
    field_j = JRunner.distill_triplane_to_field(
        jr, decoder, jnp.asarray(code_act), a[0], jcfg, steps=20)
    ss = tr.load_ssdnerf()
    field_t = tr.distill_triplane_to_field(
        triplane_params_from_flax(decoder), _t(code_act), ss.cfg, tcfg,
        steps=20, draws=JaxTextTo3DDraws(SEED, rec["ingp"]))
    bound = ss.cfg.triplane.bound
    pts = np.random.default_rng(7).uniform(
        -bound, bound, (4096, 3)).astype(np.float32)
    s_j, c_j = (np.asarray(v) for v in j_decode(field_j, jnp.asarray(pts),
                                                jcfg))
    with torch.no_grad():
        s_t, c_t = (v.numpy() for v in t_decode(field_t, _t(pts), tcfg))
    assert c_j.std() > 1e-3
    for a_, b in ((c_t, c_j), (np.log1p(s_t), np.log1p(s_j))):
        d = np.abs(a_ - b)
        assert d.max() <= 1e-2 and d.mean() <= 1e-3, (d.max(), d.mean())


def test_run_stablessdnerf_to_mesh_matches_jax(request_pair):
    jr, tr, rec, out_j, out_t, calls_j, calls_t = request_pair
    # the port's first 4 solver calls are its code sample's (JAX's run
    # inside a scan, unrecorded)
    calls_t = calls_t[4:]
    assert len(calls_t) == len(calls_j) > 0
    lat_j, lat_t = calls_j[0], calls_t[0]
    assert np.isfinite(lat_j).all()
    np.testing.assert_allclose(lat_t, lat_j, atol=2e-3 * np.abs(lat_j).max())
    # the reference rows follow the schedule from the VAE encoding of the
    # init renders: within 1e-4 of their magnitude
    np.testing.assert_allclose(calls_t[1], calls_j[1],
                               atol=1e-4 * np.abs(calls_j[1]).max())
    mj, mt = out_j["mesh"], out_t["mesh"]
    assert mj is not None and mt is not None
    assert abs(len(mt.f) - len(mj.f)) <= 0.1 * len(mj.f)
    rj = np.linalg.norm(mj.v - mj.v.mean(0), axis=-1).mean()
    rt = np.linalg.norm(mt.v - mt.v.mean(0), axis=-1).mean()
    assert abs(rt - rj) <= 0.02 * rj
    np.testing.assert_allclose(mt.v.min(0), mj.v.min(0), atol=0.05)
    np.testing.assert_allclose(mt.v.max(0), mj.v.max(0), atol=0.05)
