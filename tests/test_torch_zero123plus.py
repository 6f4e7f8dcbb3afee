"""Zero123++ in the port against the JAX package, on the CPU in f32 at the
tiny configuration both runners build (`tiny_models=True`):

- reference attention through the tiny UNet: the write pass's stored
  states (the reference's `[w[0] for w in ref_writes if w is not None]`)
  and the read pass's output, also across the port's encode / decode
  split: relative L2 <= 1e-5;
- `Zero123PlusPipeline`: 2 steps at grid (48, 32), Euler-ancestral and
  DPM-Solver, the JAX run's draws replayed (`torch_jax_draws.
  JaxZero123PlusDraws`): the grid within 1e-4;
- `run_zero123plus` (v1.1 and v1.2's latent roll) through both runners,
  and `proc_zero123plus`'s mirrored passes and `_split_grid` on a grid
  made from the input and the seed;
- v1.2's normal pass: `run_zero123plus(return_normal=True)` (the normal
  UNet and the normal ControlNet, whose hint is the RGB grid; the RGB
  pass's draws from PRNGKey(seed), the normal pass's from PRNGKey(seed +
  1000)): both grids within 1e-4, the ControlNet's residuals moving the
  normal grid by more than 1e-2; and `proc_zero123plus(return_normals=
  True)`'s mirrored pass (x channel 1 - n, then un-mirrored) on grids
  made from the input and the seed, with the draw sources it asks for.

Weights are the JAX runner's seeded init plus seeded noise, sent through
the weight bridge (`torch_state_from_flax`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.apis import Adapter3DRunner as JRunner
from mvedit_tpu.models.diffusion import AttnMode as JAttnMode
from mvedit_tpu.pipelines import (Zero123PlusConfig as JConfig,
                                  Zero123PlusPipeline as JPipeline)

from mvedit_tpu_torch.apis import Adapter3DRunner as TRunner
from mvedit_tpu_torch.models.diffusion import AttnMode
from mvedit_tpu_torch.models.diffusion.weights import torch_state_from_flax
from mvedit_tpu_torch.pipelines.zero123plus import (
    Zero123PlusConfig, Zero123PlusPipeline)

from torch_jax_draws import JaxZero123PlusDraws

torch.set_num_threads(4)


def _jitter(params, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.standard_normal(
            p.shape).astype(np.float32), params)


@pytest.fixture(scope="module")
def runners():
    """Both tiny runners with the JAX runner's Zero123++ weights (jittered
    in its cache) in the port's."""
    jr = JRunner(tiny_models=True, seed=0)
    tr = TRunner(tiny_models=True, seed=0, device="cpu")
    jm, tm = jr.load_zero123plus(), tr.load_zero123plus()
    for name, kind, mod, seed in (("unet:sd15", "unet", tm.unet, 1),
                                  ("vae:sd15", "vae", tm.vae, 2),
                                  ("z123_vision:1.1", "clip_vision",
                                   tm.vision, 3)):
        p = _jitter(jr._cache[name], seed)
        jr._cache[name] = p
        mod.load_state_dict(torch_state_from_flax(p, kind))
    return jr, tr


def _rel_l2(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return np.linalg.norm(out - ref) / np.linalg.norm(ref)


def test_reference_attention_matches_jax(runners):
    jr, tr = runners
    jm, tm = jr.load_zero123plus(), tr.load_zero123plus()
    rng = np.random.RandomState(0)
    cond = rng.standard_normal((2, 12, 8, 4)).astype(np.float32)
    lat = rng.standard_normal((2, 12, 8, 4)).astype(np.float32)
    emb = rng.standard_normal((2, 8, 32)).astype(np.float32)
    t2 = np.array([500, 500], np.int32)
    _, jw = jm.unet.apply({"params": jm.unet_params}, cond, t2, emb,
                          mode=JAttnMode(reference="write"))
    jflat = [np.asarray(w[0]) for w in jw if w is not None]
    jout = jm.unet.apply({"params": jm.unet_params}, lat, t2, emb,
                         mode=JAttnMode(reference="read"), ref_kv=jflat)
    T = torch.from_numpy
    with torch.no_grad():
        _, tw = tm.unet(T(cond), T(t2), T(emb),
                        mode=AttnMode(reference="write"))
        tout = tm.unet(T(lat), T(t2), T(emb),
                       mode=AttnMode(reference="read"), ref_kv=tw)
        # the encode / decode split reads the states in the same order
        enc = tm.unet(T(lat), T(t2), T(emb), part="enc",
                      mode=AttnMode(reference="read"), ref_kv=tw)
        tsplit = tm.unet(None, None, None, part="dec", enc_state=enc,
                         mode=AttnMode(reference="read"))
    # down blocks, mid, up blocks: (12 x 8), (6 x 4), (12 x 8) x 2 tokens
    assert [w.shape[1] for w in tw] == [96, 24, 96, 96]
    assert len(tw) == len(jflat)
    for a, b in zip(tw, jflat):
        assert _rel_l2(a.numpy(), b) <= 1e-5
    assert _rel_l2(tout.numpy(), jout) <= 1e-5
    assert torch.equal(tsplit, tout)
    # reading the states changes the output
    with torch.no_grad():
        plain = tm.unet(T(lat), T(t2), T(emb))
    assert _rel_l2(plain.numpy(), jout) > 1e-3


@pytest.mark.parametrize("sampler", ["euler_ancestral", "dpmsolver"])
def test_pipeline_matches_jax(runners, sampler):
    jr, tr = runners
    jm, tm = jr.load_zero123plus(), tr.load_zero123plus()
    rng = np.random.default_rng(1)
    img = rng.random((1, 48, 32, 3)).astype(np.float32)
    clip_px = rng.random((1, 32, 32, 3)).astype(np.float32)
    jm.cond_pixels_clip = jnp.asarray(clip_px)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(JPipeline(jm, JConfig(num_steps=2, grid_hw=(48, 32),
                                           sampler=sampler))(
        jnp.asarray(img), key))
    out = Zero123PlusPipeline(tm, Zero123PlusConfig(
        num_steps=2, grid_hw=(48, 32), sampler=sampler))(
        torch.from_numpy(img), torch.from_numpy(clip_px),
        draws=JaxZero123PlusDraws(key))
    assert out.shape == ref.shape == (1, 48, 32, 3)
    assert 0.05 < ref.std()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("version", ["1.1", "1.2"])
def test_run_zero123plus_matches_jax(runners, version):
    """The endpoint: the resizes to the grid and the vision tower's size,
    the pipeline, v1.2's latent roll; draws from PRNGKey(seed)."""
    jr, tr = runners
    if version == "1.2":      # the same weights under v1.2's vision name
        tr._cache["z123_vision:1.2"] = tr._cache["z123_vision:1.1"]
        jr._cache["z123_vision:1.2"] = jr._cache["z123_vision:1.1"]
    img = np.random.default_rng(2).random((40, 40, 3)).astype(np.float32)
    ref = jr.run_zero123plus(img, seed=3, version=version)
    out = tr.run_zero123plus(img, seed=3, version=version,
                             draws=JaxZero123PlusDraws(
                                 jax.random.PRNGKey(3)))
    assert out.shape == ref.shape == (48, 32, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_proc_zero123plus_mirrors_like_jax(runners, monkeypatch):
    """Two passes: the second mirrors the input and un-mirrors each of its
    six views; the grids come from a function of the input and the seed,
    so the two packages' views must be equal."""
    jr, tr = runners

    def fake(self, image, seed=42, num_steps=None, version="1.1",
             return_normal=False, draws=None, normal_draws=None):
        im = np.asarray(image, np.float32)
        grid = np.zeros((48, 32, 3), np.float32)
        grid[:, :, 0] = np.linspace(0, 1, 32)[None] * im[..., 0].mean()
        grid[:, :, 1] = np.linspace(0, 1, 48)[:, None] * (seed % 7)
        grid[:, :16, 2] = im[:48, :16, 0]
        return grid
    monkeypatch.setattr(type(jr), "run_zero123plus", fake)
    monkeypatch.setattr(type(tr), "run_zero123plus", fake)
    img = np.random.default_rng(4).random((48, 32, 3)).astype(np.float32)
    ref = jr.proc_zero123plus(img, seed=5, passes=2)
    out = tr.proc_zero123plus(img, seed=5, passes=2)
    assert out.shape == ref.shape == (12, 16, 16, 3)
    np.testing.assert_array_equal(out, ref)
    grid = fake(None, img[:, ::-1], seed=6)
    np.testing.assert_array_equal(out[6:], tr._split_grid(grid)[:, :, ::-1])
    np.testing.assert_array_equal(tr._split_grid(grid),
                                  jr._split_grid(grid))


@pytest.fixture(scope="module")
def normal_runners(runners):
    """`runners` with the JAX runner's normal UNet and normal ControlNet
    (jittered in its cache) in the port's, and one vision tower for both
    versions."""
    jr, tr = runners
    tr._cache["z123_vision:1.2"] = tr._cache["z123_vision:1.1"]
    jr._cache["z123_vision:1.2"] = jr._cache["z123_vision:1.1"]
    jr.load_zero123plus_normal("1.2")
    tm = tr.load_zero123plus_normal("1.2")
    for name, kind, mod, seed in (
            ("z123_normal_unet:1.2", "unet", tm.unet, 4),
            ("controlnet:z123_normal", "controlnet", tm.controlnet, 5)):
        p = _jitter(jr._cache[name], seed)
        jr._cache[name] = p
        mod.load_state_dict(torch_state_from_flax(p, kind))
    return jr, tr


def test_normal_pass_matches_jax(normal_runners):
    jr, tr = normal_runners
    img = np.random.default_rng(7).random((40, 40, 3)).astype(np.float32)
    ref, nref = jr.run_zero123plus(img, seed=3, version="1.2",
                                   return_normal=True)
    out, nout = tr.run_zero123plus(
        img, seed=3, version="1.2", return_normal=True,
        draws=JaxZero123PlusDraws(jax.random.PRNGKey(3)),
        normal_draws=JaxZero123PlusDraws(jax.random.PRNGKey(1003)))
    assert nout.shape == nref.shape == (48, 32, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(nout, nref, atol=1e-4, rtol=0)
    # the ControlNet's residuals matter: the same pass without its hint
    from mvedit_tpu_torch.ops.image import resize_bilinear
    tm = tr.load_zero123plus_normal("1.2")
    x = torch.from_numpy(img)[None]
    plain = Zero123PlusPipeline(tm, Zero123PlusConfig(
        num_steps=2, grid_hw=(48, 32), shift_views=True))(
        resize_bilinear(x, (48, 32)), resize_bilinear(x, (32, 32)),
        draws=JaxZero123PlusDraws(jax.random.PRNGKey(1003)))
    assert np.abs(plain[0].numpy() - nout).max() > 1e-2


def test_proc_zero123plus_normals_mirror_like_jax(runners, monkeypatch):
    """Two passes with normals: the mirrored pass's normal views get their
    x channel inverted and are un-mirrored; each pass asks for its draws
    at seed + p and its normal pass's at seed + p + 1000."""
    jr, tr = runners
    asked = []

    def fake(self, image, seed=42, num_steps=None, version="1.1",
             return_normal=False, draws=None, normal_draws=None):
        asked.append((draws, normal_draws))
        im = np.asarray(image, np.float32)
        grid = np.zeros((48, 32, 3), np.float32)
        grid[:, :, 0] = np.linspace(0, 1, 32)[None] * im[..., 0].mean()
        grid[:, :16, 2] = im[:48, :16, 0]
        ngrid = np.stack([np.broadcast_to(np.linspace(0.1, 0.9, 32)[None],
                                          (48, 32)),
                          im[:48, :32, 1], np.full((48, 32), seed / 10)],
                         -1).astype(np.float32)
        return grid, ngrid
    monkeypatch.setattr(type(jr), "run_zero123plus", fake)
    monkeypatch.setattr(type(tr), "run_zero123plus", fake)
    img = np.random.default_rng(8).random((48, 32, 3)).astype(np.float32)
    ref, nref = jr.proc_zero123plus(img, seed=5, passes=2,
                                    return_normals=True)
    asked.clear()
    out, nout = tr.proc_zero123plus(img, seed=5, passes=2,
                                    return_normals=True,
                                    z123_draws=lambda s: s)
    assert asked == [(5, 1005), (6, 1006)]
    assert nout.shape == nref.shape == (12, 16, 16, 3)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(nout, nref)
    _, ngrid = fake(None, img[:, ::-1], seed=6)
    n6 = tr._split_grid(ngrid)
    np.testing.assert_array_equal(nout[6:, ..., 0],
                                  1.0 - n6[:, :, ::-1, 0])
    np.testing.assert_array_equal(nout[6:, ..., 1:], n6[:, :, ::-1, 1:])
