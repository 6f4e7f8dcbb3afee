"""SSDNeRF training in the port against the JAX package, on the CPU in f32,
with seeded numpy inputs, bridged weights and JAX's draws replayed
(`torch_jax_draws.ssdnerf_step_draws`, `val_guide_noise`,
`val_optim_draws`):

- `grid_sample_2d` / `grid_sample_3d` in both padding modes and both
  `align_corners`, on points inside the input and past it: values and the
  gradients to the input and to the grid within 1e-5 relative (L2). The
  input's gradient is summed in float32 by the segment sum, as on the
  card;
- the triplane code's gradient through `triplane_point_decode` on a batch
  of two scenes against JAX's vmapped per-scene decode: 1e-5;
- `training_loss`, v-prediction and epsilon, value and gradient to x0:
  1e-5;
- one stage-2 and one stage-1 train step with the cars `LatentDenoiser`
  (ch 128) on (2, 3, 12, 8, 8) codes, 64 rays of 16 samples: the losses
  within 1e-5, the codes' and the decoder's and denoiser's first Adam
  moments (the gradients, times 1 - b1) and their parameters within 1e-4
  relative after one step. After three steps the losses stay within 1e-4
  and the parameters and codes within 1e-3 relative: Adam divides by
  sqrt(v) + eps with eps 1e-8, which amplifies the frameworks' rounding
  differences in gradients near 0 (the code Adam's b2 is 0.99; measured
  here: 1e-5 after three steps);
- the stage-2 step with the LPIPS patch term (a seeded VGG16 at its
  widths on one 16 x 16 patch a scene): the same bounds as one step;
- `val_guide` (3 DPM-Solver++ steps, guided) and `val_optim` (4 steps, the
  prior on): the codes within 1e-4 relative, the losses within 1e-5;
- `EmaHook`'s values over a ramped-up sequence of states: 1e-6;
- `eval_psnr`, `eval_ssim`, `fid_from_feats`, `kid_from_feats`: 1e-9.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvedit_tpu.models import gaussian_diffusion as JGD
from mvedit_tpu.models import ssdnerf as JS
from mvedit_tpu.models import triplane as JT
from mvedit_tpu.models.diffusion import schedulers as JSch
from mvedit_tpu.models.volume_renderer import RenderConfig as JRender
from mvedit_tpu.ops import grid_sample as JG
from mvedit_tpu.runner import trainer as JTr
from mvedit_tpu.utils import evaluation as JE

from mvedit_tpu_torch.configs.ssdnerf_cars import LatentDenoiser
from mvedit_tpu_torch.models import gaussian_diffusion as TGD
from mvedit_tpu_torch.models import ssdnerf as TS
from mvedit_tpu_torch.models import triplane as TT
from mvedit_tpu_torch.models.diffusion import schedulers as TSch
from mvedit_tpu_torch.models.diffusion.weights import torch_state_from_flax
from mvedit_tpu_torch.models.volume_renderer import RenderConfig as TRender
from mvedit_tpu_torch.ops import grid_sample as TG
from mvedit_tpu_torch.runner import trainer as TTr
from mvedit_tpu_torch.utils import evaluation as TE

from torch_jax_draws import (ssdnerf_step_draws, val_guide_noise,
                             val_optim_draws)

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, R, CODE = 2, 64, (3, 12, 8, 8)
TP = dict(n_channels=12, base_layers=(36, 16), density_layers=(16, 1),
          color_layers=(16, 3), dir_layers=(16, 16), bound=0.5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# grid sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("align", [False, True])
def test_grid_sample_values_and_gradients_match_jax(dims, padding, align):
    rng = np.random.default_rng(dims * 10 + (padding == "border") * 2
                                + align)
    spatial = (5, 7) if dims == 2 else (4, 5, 6)
    gshape = (4, 6) if dims == 2 else (3, 4, 5)
    x = rng.normal(size=(2, 3, *spatial)).astype(np.float32)
    g = rng.uniform(-1.2, 1.2, (2, *gshape, dims)).astype(np.float32)
    w = rng.normal(size=(2, 3, *gshape)).astype(np.float32)
    jfn = JG.grid_sample_2d if dims == 2 else JG.grid_sample_3d
    tfn = TG.grid_sample_2d if dims == 2 else TG.grid_sample_3d

    def jloss(x, g):
        return jnp.sum(jfn(x, g, padding, align) * w)
    jout = jfn(jnp.asarray(x), jnp.asarray(g), padding, align)
    jgx, jgg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(g))
    tx, tg = _t(x).requires_grad_(True), _t(g).requires_grad_(True)
    tout = tfn(tx, tg, padding, align)
    (tout * _t(w)).sum().backward()
    assert tout.shape == jout.shape
    assert _rel(tout.detach(), jout) <= 1e-5
    assert _rel(tx.grad, jgx) <= 1e-5
    assert _rel(tg.grad, jgg) <= 1e-5
    # without a gradient asked for: F.grid_sample, the same values
    with torch.no_grad():
        assert _rel(tfn(_t(x), _t(g), padding, align), jout) <= 1e-5


def test_triplane_code_gradient_matches_jax():
    rng = np.random.default_rng(3)
    jcfg, tcfg = JT.TriPlaneConfig(**TP), TT.TriPlaneConfig(**TP)
    params = JT.triplane_init(jax.random.PRNGKey(0), jcfg)
    codes = rng.normal(size=(B, *CODE)).astype(np.float32)
    xyz = rng.uniform(-0.55, 0.55, (B, 300, 3)).astype(np.float32)
    ws = rng.normal(size=(B, 300)).astype(np.float32)
    wc = rng.normal(size=(B, 300, 3)).astype(np.float32)

    def jloss(codes):
        def one(code, x):
            return JT.triplane_point_decode(params, code, x, None, jcfg)
        s, c = jax.vmap(one)(codes, jnp.asarray(xyz))
        return jnp.sum(s * ws) + jnp.sum(c * wc)
    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(codes))
    tc = _t(codes).requires_grad_(True)
    s, c = TT.triplane_point_decode(TT.triplane_params_from_flax(params),
                                    tc, _t(xyz), None, tcfg)
    tl = (s * _t(ws)).sum() + (c * _t(wc)).sum()
    tl.backward()
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert _rel(tc.grad, jg) <= 1e-5


# ---------------------------------------------------------------------------
# the diffusion loss
# ---------------------------------------------------------------------------

_W = np.random.default_rng(0).normal(size=(12, 12)).astype(np.float32) * 0.3


@pytest.mark.parametrize("pred", ["v_prediction", "epsilon"])
def test_training_loss_matches_jax(pred):
    rng = np.random.default_rng(4)
    x0 = rng.normal(size=(3, *CODE)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([5, 500, 990], np.int32)
    jcfg = JGD.GaussianDiffusionConfig(prediction_type=pred)
    tcfg = TGD.GaussianDiffusionConfig(prediction_type=pred)

    def jden(x, tt, c):
        return jnp.tanh(jnp.einsum("bpchw,cd->bpdhw", x, _W)) \
            * (tt[:, None, None, None, None] / 1000.0)

    def tden(x, tt, c):
        return torch.tanh(torch.einsum("bpchw,cd->bpdhw", x, _t(_W))) \
            * (tt[:, None, None, None, None] / 1000.0)
    jl, jg = jax.value_and_grad(lambda x: JGD.training_loss(
        JSch.sd_schedule(prediction_type="v_prediction"), jden, x,
        jnp.asarray(t), jnp.asarray(noise), cfg=jcfg))(jnp.asarray(x0))
    tx = _t(x0).requires_grad_(True)
    tl = TGD.training_loss(TSch.sd_schedule(prediction_type="v_prediction"),
                           tden, tx, _t(t), _t(noise), cfg=tcfg)
    tl.backward()
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert _rel(tx.grad, jg) <= 1e-5


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _jax_denoiser():
    spec = importlib.util.spec_from_file_location(
        "ssdnerf_cfg", os.path.join(REPO, "configs", "ssdnerf_cars.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _, apply, params = mod.build_denoiser(jax.random.PRNGKey(0))
    # jitter the zero biases and unit norms so that every leaf counts
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32), params)
    return apply, params


@pytest.fixture(scope="module")
def setup():
    apply, dparams = _jax_denoiser()
    rng = np.random.default_rng(6)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    ro = np.tile((rot @ np.array([0, 0, -1.3], np.float32))[None, None],
                 (B, R, 1))
    rd = rng.normal(size=(B, R, 3)).astype(np.float32) * 0.25
    rd[..., :] += -ro[..., :] / 1.3
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    batch = {"rays_o": ro, "rays_d": rd,
             "rgb": rng.random((B, R, 3)).astype(np.float32)}
    decoder = jax.tree_util.tree_map(
        np.asarray, JT.triplane_init(jax.random.PRNGKey(1),
                                     JT.TriPlaneConfig(**TP)))
    codes = (rng.normal(size=(B, *CODE)) * 0.5).astype(np.float32)
    return dict(apply=apply, dparams=dparams, batch=batch, decoder=decoder,
                codes=codes)


def _cfgs():
    kw = dict(code_shape=CODE, latent_shape=CODE, n_rays=R)
    return (JS.SSDNeRFConfig(triplane=JT.TriPlaneConfig(**TP),
                             render=JRender(num_samples=16, bound=0.5),
                             **kw),
            TS.SSDNeRFConfig(triplane=TT.TriPlaneConfig(**TP),
                             render=TRender(num_samples=16, bound=0.5),
                             **kw))


def _jax_state(s, diffusion):
    codes = jnp.array(s["codes"])
    state = {"decoder": jax.tree_util.tree_map(jnp.array, s["decoder"]),
             "decoder_opt": optax.adam(1e-3).init(s["decoder"]),
             "codes": codes, "code_m": jnp.zeros_like(codes),
             "code_v": jnp.zeros_like(codes),
             "code_steps": jnp.zeros((B,), jnp.int32)}
    if diffusion:
        state["denoiser"] = jax.tree_util.tree_map(jnp.array,
                                                   s["dparams"])
        state["denoiser_opt"] = optax.adamw(
            1e-4, weight_decay=1e-2).init(s["dparams"])
    return state


def _port_state(s, diffusion):
    dec = TT.triplane_params_from_flax(s["decoder"])
    codes = _t(s["codes"])
    state = {"decoder": dec, "decoder_opt": TS.adam_init(dec),
             "codes": codes, "code_m": torch.zeros_like(codes),
             "code_v": torch.zeros_like(codes),
             "code_steps": torch.zeros((B,), dtype=torch.int32)}
    if diffusion:
        state["denoiser"] = torch_state_from_flax(s["dparams"],
                                                  "latent_denoiser")
        state["denoiser_opt"] = TS.adam_init(state["denoiser"])
    return state


def _compare(js, ts, tol, diffusion, moments):
    """(name, relative difference) of every compared part of the states."""
    out = [(k, _rel(ts[k], js[k])) for k in ("codes", "code_v")]
    if moments:
        out.append(("code_m", _rel(ts["code_m"], js["code_m"])))
    dec = TT.triplane_params_from_flax(js["decoder"])
    flat = TS.tree_leaves
    out.append(("decoder", max(_rel(a, b) for a, b in zip(
        flat(ts["decoder"]), flat(dec)))))
    if moments:
        mu = TT.triplane_params_from_flax(js["decoder_opt"][0].mu)
        out.append(("decoder_mu", max(_rel(a, b) for a, b in zip(
            flat(ts["decoder_opt"]["m"]), flat(mu)))))
    if diffusion:
        den = torch_state_from_flax(js["denoiser"], "latent_denoiser")
        out.append(("denoiser", max(_rel(ts["denoiser"][k], den[k])
                                    for k in den)))
        if moments:
            mu = torch_state_from_flax(js["denoiser_opt"][0].mu,
                                       "latent_denoiser")
            out.append(("denoiser_mu", max(
                _rel(ts["denoiser_opt"]["m"][k], mu[k]) for k in mu)))
    return [(k, d) for k, d in out if not d <= tol]


@pytest.mark.parametrize("stage", ["stage2", "stage1"])
def test_train_step_matches_jax(setup, stage):
    diffusion = stage == "stage2"
    jcfg, tcfg = _cfgs()
    sch_j = JSch.sd_schedule(prediction_type="v_prediction")
    sch_t = TSch.sd_schedule(prediction_type="v_prediction")
    jstep = JS.make_train_step(setup["apply"] if diffusion else None,
                               jcfg.triplane, jcfg, sch_j,
                               with_diffusion=diffusion)
    net = LatentDenoiser()
    tstep = TS.make_train_step(TS.module_apply(net) if diffusion else None,
                               tcfg.triplane, tcfg, sch_t,
                               with_diffusion=diffusion)
    js, ts = _jax_state(setup, diffusion), _port_state(setup, diffusion)
    b = setup["batch"]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jb["cond"] = None
    tb = {k: _t(v) for k, v in b.items()}
    tb["cond"] = None
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        draws = ssdnerf_step_draws(key, B, CODE)
        js, jm = jstep(js, dict(jb), key)
        ts, tm = tstep(ts, dict(tb), draws=draws)
        assert set(tm) == set(jm)
        for k in jm:
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(
                float(jm[k])) * (1 if i == 0 else 10), (i, k)
        bad = _compare(js, ts, 1e-4 if i == 0 else 1e-3, diffusion,
                       moments=i == 0)
        assert not bad, (i, bad)
    assert int(ts["code_steps"][0]) == 3


def test_train_step_lpips_patch_matches_jax(setup):
    """The stage-2 step with the LPIPS patch term (VGG16 at its widths,
    seeded, bridged): 2 scenes x one 16 x 16 patch of rays; the losses
    within 1e-5 and the state within 1e-4 after one step."""
    from mvedit_tpu.models.losses import lpips_init as j_lpips_init
    from mvedit_tpu_torch.models.losses import lpips_params_from_flax
    ps = 16
    jcfg, tcfg = _cfgs()
    lp = jax.tree_util.tree_map(np.asarray, j_lpips_init(
        jax.random.PRNGKey(3)))
    rng = np.random.default_rng(9)
    b = setup["batch"]
    batch = {"rays_o": np.repeat(b["rays_o"][:, :1], ps * ps, 1),
             "rays_d": np.concatenate([b["rays_d"]] * 4, 1),
             "rgb": rng.random((B, ps * ps, 3)).astype(np.float32)}
    jstep = JS.make_train_step(setup["apply"], jcfg.triplane, jcfg,
                               JSch.sd_schedule(prediction_type=
                                                "v_prediction"),
                               lpips_params=lp, patch_size=ps)
    tstep = TS.make_train_step(
        TS.module_apply(LatentDenoiser()), tcfg.triplane, tcfg,
        TSch.sd_schedule(prediction_type="v_prediction"),
        lpips_params=lpips_params_from_flax(lp), patch_size=ps)
    key = jax.random.PRNGKey(30)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["cond"] = None
    tb = {k: _t(v) for k, v in batch.items()}
    tb["cond"] = None
    js, jm = jstep(_jax_state(setup, True), jb, key)
    ts, tm = tstep(_port_state(setup, True), tb,
                   draws=ssdnerf_step_draws(key, B, CODE))
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k]))
    bad = _compare(js, ts, 1e-4, True, moments=True)
    assert not bad, bad


# ---------------------------------------------------------------------------
# val_guide, val_optim
# ---------------------------------------------------------------------------

def test_val_guide_and_val_optim_match_jax(setup):
    jcfg, tcfg = _cfgs()
    sch_j = JSch.sd_schedule(prediction_type="v_prediction")
    sch_t = TSch.sd_schedule(prediction_type="v_prediction")
    apply, dp = setup["apply"], setup["dparams"]
    tden = TS.module_apply(LatentDenoiser())
    tdp = torch_state_from_flax(dp, "latent_denoiser")
    dec_j = setup["decoder"]
    dec_t = TT.triplane_params_from_flax(dec_j)
    b = setup["batch"]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(v) for k, v in b.items()}
    key = jax.random.PRNGKey(21)
    jcode = JS.make_val_guide(apply, jcfg.triplane, jcfg, sch_j)(
        dp, dec_j, jb, key, num_steps=3)
    tcode = TS.make_val_guide(tden, tcfg.triplane, tcfg, sch_t)(
        tdp, dec_t, tb, noise=val_guide_noise(key, (B, *CODE)),
        num_steps=3)
    assert _rel(tcode, jcode) <= 1e-4
    key = jax.random.PRNGKey(22)
    start = np.array(jcode)
    jc, jl = JS.make_val_optim(apply, jcfg.triplane, jcfg, sch_j, n_steps=4,
                               prior_weight=0.1)(dp, jnp.asarray(start),
                                                 dec_j, jb, key)
    tc, tl = TS.make_val_optim(tden, tcfg.triplane, tcfg, sch_t, n_steps=4,
                               prior_weight=0.1)(
        tdp, _t(start), dec_t, tb,
        draws=val_optim_draws(key, 4, B, CODE))
    assert _rel(tl, jl) <= 1e-5
    assert _rel(tc, jc) <= 1e-4


# ---------------------------------------------------------------------------
# EMA and the metrics
# ---------------------------------------------------------------------------

def test_ema_hook_matches_jax():
    rng = np.random.default_rng(7)
    seq = [rng.normal(size=(4, 5)).astype(np.float32) for _ in range(8)]

    class Tr:
        pass
    jh = JTr.EmaHook(keys=("denoiser",), momentum=0.01, rampup=5)
    th = TTr.EmaHook(keys=("denoiser",), momentum=0.01, rampup=5)
    jt, tt = Tr(), Tr()
    for i, x in enumerate(seq):
        jt.step = tt.step = i + 1
        jt.state = {"denoiser": {"w": jnp.asarray(x)}}
        tt.state = {"denoiser": {"w": _t(x)}}
        jh.after_iter(jt, {})
        th.after_iter(tt, {})
    assert _rel(th.ema["denoiser"]["w"], jh.ema["denoiser"]["w"]) <= 1e-6


def test_evaluation_metrics_match_jax():
    rng = np.random.default_rng(8)
    a = rng.random((2, 24, 24, 3))
    b = np.clip(a + rng.normal(size=a.shape) * 0.05, 0, 1)
    np.testing.assert_allclose(TE.eval_psnr(a, b), JE.eval_psnr(a, b),
                               rtol=1e-9)
    np.testing.assert_allclose(TE.eval_ssim(a, b), JE.eval_ssim(a, b),
                               rtol=1e-9)
    assert TE.eval_ssim(a[0], b[0]) == pytest.approx(
        JE.eval_ssim(a[0], b[0]), rel=1e-9)
    fa, fb = rng.normal(size=(40, 6)), rng.normal(size=(40, 6)) + 0.3
    assert TE.fid_from_feats(fa, fb) == pytest.approx(
        JE.fid_from_feats(fa, fb), rel=1e-9)
    assert TE.kid_from_feats(fa, fb, num_subsets=5, subset_size=20) \
        == pytest.approx(JE.kid_from_feats(fa, fb, num_subsets=5,
                                           subset_size=20), rel=1e-9)
