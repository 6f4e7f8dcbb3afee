"""A whole tiny `run_retex` in both packages, on the CPU in fp32.

Both runners load the same seeded tiny checkpoint
(`torch_checkpoints.write_tiny_checkpoint`: SD stack, tile / depth / ip2p
ControlNets, the IP-Adapter tower, projection and UNet branches), and the
port replays the JAX request's random draws (`torch_jax_draws.JaxDraws`:
the field init, the shared latent noise, and each timestep's albedo-fit
view draws, which the reference takes from PRNGKey(0)). Cases:

- `front_ip`: `front_view_id=0` (the von Mises view weights, 3.0 on the
  front view, the top view at index 1, per-view prompt suffixes,
  `keep_first_views=2`), `in_image` through IP-Adapter, and pruning from 5
  views to 3 (`min_num_views=3`, two buckets);
- `instruct`: the ip2p ControlNet on the source renders, instruct's
  prompts.

Compared, with their tolerances:
- each timestep's albedo-fit losses, rtol 2e-3;
- the final renders (values in [0, 1]): max |d| <= 1e-2, mean |d| <= 1e-3.
  Adam with eps 1e-15 turns the frameworks' different rounding into
  +-lr updates from the first step on wherever a gradient nearly cancels
  (ROADMAP, reference behaviours; the field's MLP weights end up to 0.09
  apart), and the denoise feeds the fit back through 3 timesteps. The
  JAX runner tokenizes through `torch_tokenizer.StableHashTokenizer`, the
  port's crc32 word ids: its own `HashTokenizer` hashes words with the
  per-process salted `hash()`, so its ids, and with them how far the two
  chains part, changed from process to process (max |d| from 4.4e-3 to
  1.8e-2 over runs);
- the baked 1024^2 albedo: mean |d| <= 2e-3 and at most 3% of its values
  off by more than 1e-2. The grid atlas puts texel centres on its cells'
  diagonal edges, where coverage is a tie that rounding decides, so a few
  texels take the neighbouring face in one package (the bake test's 3%
  bound; measured 0.64% of values, mean 2.9e-4).

`n_inverse_steps=0` runs on the port only (the reference divides by zero
there): the field stays as initialised.
"""
import math
import os

import jax
import numpy as np
import pytest
import torch

from mvedit_tpu.apis import Adapter3DRunner as JRunner
from mvedit_tpu.models.fields import INGPConfig as JINGPConfig
from mvedit_tpu.ops.dense_grid import DenseGridConfig as JDense
from mvedit_tpu.ops.hash_grid import HashGridConfig
import mvedit_tpu.pipelines.texture as JT

from mvedit_tpu_torch.apis import Adapter3DRunner as TRunner
from mvedit_tpu_torch.models.mesh import Mesh
from torch_checkpoints import write_tiny_checkpoint
from torch_jax_draws import JaxDraws
from torch_tokenizer import StableHashTokenizer

torch.set_num_threads(2)

SEED, LOSS_RTOL, MAX_D, MEAN_D = 1, 2e-3, 1e-2, 1e-3
ALBEDO_MEAN_D, ALBEDO_OFF = 2e-3, 0.03
# the JAX runner's tiny retex field (runner.py:653-661)
J_INGP = JINGPConfig(backend="dense", dense=JDense(resolutions=(8, 32)),
                     hash=HashGridConfig(n_levels=4, log2_hashmap_size=12,
                                         base_resolution=4,
                                         max_resolution=32))
CASES = {"front_ip": dict(front_view_id=0, in_image=True, min_num_views=3),
         "instruct": dict(instruct=True)}


def _sphere(n=10):
    th = np.linspace(0.15, np.pi - 0.15, n)
    ph = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
    v = np.array([[math.sin(t) * math.cos(p), math.sin(t) * math.sin(p),
                   math.cos(t) * 1.2] for t in th for p in ph], np.float32)
    f = []
    for i in range(n - 1):
        for j in range(2 * n):
            a, b = i * 2 * n + j, i * 2 * n + (j + 1) % (2 * n)
            c, d = a + 2 * n, b + 2 * n
            f += [[a, c, b], [b, c, d]]
    return v * 0.6, np.array(f, np.int32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("retex"))
    write_tiny_checkpoint(root, "safetensors", seed=4)
    v, f = _sphere()
    mesh_path = os.path.join(root, "sphere.obj")
    Mesh(v=v, f=f).write(mesh_path)
    img = np.random.RandomState(7).random((40, 40, 3)).astype(np.float32)
    return root, mesh_path, img


def _run_jax(root, mesh_path, kw):
    losses = []
    orig = JT.make_texture_fit

    def recording(*a, **k):
        fit, opt = orig(*a, **k)

        def fit2(*fa, **fk):
            out = fit(*fa, **fk)
            losses.append(np.asarray(out[2]))
            return out
        return fit2, opt
    JT.make_texture_fit = recording
    try:
        runner = JRunner(checkpoint_dir=root, seed=0, tiny_models=True)
        runner.tokenizer = StableHashTokenizer()
        out = runner.run_retex(mesh_path, "a wooden vase", seed=SEED,
                               steps=4, n_inverse_steps=3, **kw)
    finally:
        JT.make_texture_fit = orig
    return out, losses


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_retex_matches_jax(setup, case):
    root, mesh_path, img = setup
    kw = dict(CASES[case])
    if kw.pop("in_image", False):
        kw["in_image"] = img
    jout, jlosses = _run_jax(root, mesh_path, kw)
    runner = TRunner(checkpoint_dir=root, seed=0, tiny_models=True,
                     device="cpu")
    tout = runner.run_retex(
        mesh_path, "a wooden vase", seed=SEED, steps=4, n_inverse_steps=3,
        draws=JaxDraws(jax.random.PRNGKey(SEED), J_INGP), **kw)
    tl = [x.numpy() for x in tout["fit_losses"]]
    assert len(tl) == len(jlosses) == 3
    for a, b in zip(tl, jlosses):
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL)
    jr, tr = np.asarray(jout["renders"]), tout["renders"].numpy()
    assert tr.shape == jr.shape == ((3 if case == "front_ip" else 4),
                                    64, 64, 3)
    d = np.abs(tr - jr)
    print(f"[{case}] renders max |d| {d.max():.3e} mean {d.mean():.3e}")
    assert d.max() <= MAX_D and d.mean() <= MEAN_D, (d.max(), d.mean())
    ja, ta = jout["mesh"].albedo, tout["mesh"].albedo
    assert ta.shape == ja.shape == (1024, 1024, 3)
    assert np.isfinite(ta).all() and ta.std() > 1e-3
    d = np.abs(ta - ja)
    print(f"[{case}] albedo mean |d| {d.mean():.3e}, share off "
          f"{(d > MAX_D).mean():.4f}")
    assert d.mean() <= ALBEDO_MEAN_D and (d > MAX_D).mean() <= ALBEDO_OFF, \
        (d.mean(), (d > MAX_D).mean())


def test_run_retex_zero_inverse_steps_keeps_the_field(setup):
    """n_inverse_steps=0: no fit step runs, the renders are the seeded
    field's and a GLB is still written."""
    root, mesh_path, _ = setup
    r = TRunner(checkpoint_dir=root, seed=0, tiny_models=True, device="cpu")
    out_path = os.path.join(root, "zero.glb")
    draws = JaxDraws(jax.random.PRNGKey(SEED), J_INGP)
    out = r.run_retex(mesh_path, "a vase", seed=SEED, steps=4,
                      n_inverse_steps=0, draws=draws, out_path=out_path)
    assert all(x.numel() == 0 for x in out["fit_losses"])
    fresh = JaxDraws(jax.random.PRNGKey(SEED), J_INGP).field_init(
        None, "cpu")
    for k, v in fresh["table"].items():
        assert torch.equal(out["field_params"]["table"][k].detach(), v)
    assert os.path.exists(out_path)
    assert Mesh.load(out_path).albedo is not None
