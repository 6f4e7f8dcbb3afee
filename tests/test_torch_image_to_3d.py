"""One whole tiny `run_zero123plus_to_mesh` (v1.1) in both packages, on the
CPU in f32, with TRACER segmentation (the initial views and every denoise
step's), Omnidata normals on the input view, LoFTR pose estimation and
IP-Adapter on: 1 + 6 views at 64^2, Zero123++ at 2 steps on its (48, 32)
grid, 2 MVEdit steps, tet 16.

Both runners load one seeded tiny checkpoint (`torch_checkpoints`: the SD
stack, the ControlNets, IP-Adapter and the perception nets); the JAX
runner keeps its seeded Zero123++ vision tower (its loader has no
converter), which the port gets through the bridge. The port replays the
JAX request's draws: Zero123++'s per pass (`JaxZero123PlusDraws` from
PRNGKey(seed + pass)) and the MVEdit loop's (`JaxDraws`).

Compared: the generated views within 1e-4 (the Zero123++ pipeline's
bound), the input pose (the same route, the same pose within 1e-4), then
the MVEdit loop with the bounds `test_torch_pipeline.py` holds the whole
`run_3d_to_3d` to, no looser: the reference rows after the first
timestep within 1e-4 of their magnitude; the mesh's face count within
10%, its mean radius within 2%, its bounding box within 0.05; the albedo's
mean |d| <= 0.05. The first timestep's latents are held in their two
parts instead of whole: the denoise's x0 estimate (the UNet with
IP-Adapter on the same inputs) within 1e-4 of its magnitude, and the
renders after the timestep's NeRF fit within `test_torch_retex.py`'s
render bounds (max |d| <= 1e-2, mean |d| <= 1e-3). Whole, they part by ~1.7% of
their magnitude here, not the 0.2% of `run_3d_to_3d`'s torus: the fit's
targets are Zero123++'s noise-like views of seeded weights, with empty
TRACER masks (seeded TRACER maps sit near 0.5 everywhere, and its failure
rule zeroes them), and Adam's eps of 1e-15 turns the frameworks' rounding
into whole steps where gradients nearly cancel (ROADMAP Queue 3,
reference behaviours; measured: the renders part by 4.7e-3 at most, 4.8e-4
on average, and the VAE encode and the solver's 1 / sqrt(alpha) carry
that into the latents).

JAX's own tiny request takes most of this file's time (its eager TRACER-B7
and the first compiles of its programs).
"""
import jax
import numpy as np
import torch

from mvedit_tpu.apis import Adapter3DRunner as JRunner
from mvedit_tpu.models.diffusion import schedulers as JS
from mvedit_tpu.models.fields import INGPConfig as JINGPConfig
from mvedit_tpu.ops.dense_grid import DenseGridConfig as JDense
from mvedit_tpu.ops.hash_grid import HashGridConfig
import mvedit_tpu.pipelines.mvedit_3d as JM

from mvedit_tpu_torch.apis import Adapter3DRunner as TRunner
from mvedit_tpu_torch.models.diffusion import schedulers as TS
from mvedit_tpu_torch.models.diffusion.weights import torch_state_from_flax
import mvedit_tpu_torch.pipelines.mvedit_3d as TM
from torch_checkpoints import (write_image_to_3d_checkpoint,
                               write_tiny_checkpoint)
from torch_jax_draws import JaxDraws, JaxZero123PlusDraws

torch.set_num_threads(4)

SEED = 2
# the JAX runner's tiny MVEdit field (endpoints.py `_mvedit_cfg`)
J_INGP = JINGPConfig(backend="dense", dense=JDense(resolutions=(8, 32)),
                     hash=HashGridConfig(n_levels=4, log2_hashmap_size=12,
                                         base_resolution=4,
                                         max_resolution=32))


def _record(monkeypatch, module):
    calls = []
    step = module.dpmsolver_step

    def wrapped(*a, **k):
        out = step(*a, **k)
        calls.append(np.array(out[0]) if not isinstance(out[0], torch.Tensor)
                     else out[0].detach().cpu().numpy())
        return out
    monkeypatch.setattr(module, "dpmsolver_step", wrapped)
    return calls


def _record_vae(monkeypatch, cls, rec):
    """Record the inputs of the pipeline's VAE encode (the renders) and
    decode (the x0 latents)."""
    for meth, key in (("_vae_encode", "enc"), ("_vae_decode", "dec")):
        orig = getattr(cls, meth)

        def make(self, orig=orig, key=key):
            fn = orig(self)

            def call(*a):
                x = a[-1]
                rec[key].append(x.detach().cpu().numpy().copy()
                                if isinstance(x, torch.Tensor)
                                else np.array(x))
                return fn(*a)
            return call
        monkeypatch.setattr(cls, meth, make)


def test_run_zero123plus_to_mesh_matches_jax(tmp_path, monkeypatch):
    root = str(tmp_path / "ckpt")
    write_tiny_checkpoint(root, "safetensors", seed=6)
    write_image_to_3d_checkpoint(root, "safetensors", seed=7)
    jr = JRunner(checkpoint_dir=root, seed=0, tiny_models=True)
    tr = TRunner(checkpoint_dir=root, seed=0, tiny_models=True,
                 device="cpu")
    tr.load_zero123plus().vision.load_state_dict(torch_state_from_flax(
        jax.tree_util.tree_map(np.asarray,
                               jr.load_zero123plus().vision_params),
        "clip_vision"))
    poses = {}

    def pose_of(runner, name):
        orig = runner.estimate_input_pose

        def recording(*a, **k):
            poses[name] = orig(*a, **k)
            return poses[name]
        return recording
    jr.estimate_input_pose = pose_of(jr, "jax")
    tr.estimate_input_pose = pose_of(tr, "port")
    calls_j, calls_t = _record(monkeypatch, JS), _record(monkeypatch, TS)
    vae_j, vae_t = {"enc": [], "dec": []}, {"enc": [], "dec": []}
    _record_vae(monkeypatch, JM.MVEdit3DPipeline, vae_j)
    _record_vae(monkeypatch, TM.MVEdit3DPipeline, vae_t)
    views_j = []
    orig_proc = JRunner.proc_zero123plus

    def proc(self, *a, **k):
        views_j.append(orig_proc(self, *a, **k))
        return views_j[-1]
    monkeypatch.setattr(JRunner, "proc_zero123plus", proc)
    img = np.random.default_rng(3).random((40, 40, 3)).astype(np.float32)
    out_j = jr.run_zero123plus_to_mesh(img, seed=SEED,
                                       out_path=str(tmp_path / "jax.glb"))
    out_t = tr.run_zero123plus_to_mesh(
        img, seed=SEED, out_path=str(tmp_path / "port.glb"),
        draws=JaxDraws(jax.random.PRNGKey(SEED), J_INGP),
        z123_draws=lambda s: JaxZero123PlusDraws(jax.random.PRNGKey(s)))
    # Zero123++'s views
    assert out_t["views"].shape == views_j[0].shape == (6, 16, 16, 3)
    np.testing.assert_allclose(out_t["views"], views_j[0], atol=1e-4,
                               rtol=0)
    # the input pose: the same route, the same solve
    (pj, ej), (pt, et) = poses["jax"], poses["port"]
    assert (pj is None) == (pt is None)
    assert out_t["pose_route"] == ("front" if pt is None else "estimated")
    if pj is not None:
        np.testing.assert_allclose(pt, pj, atol=1e-4)
    # the MVEdit loop's first timestep: the init renders, the denoise's x0
    # estimate, the first fit's renders, the reference rows
    assert len(calls_t) == len(calls_j) == 4
    (init_j, fit_j), (init_t, fit_t) = vae_j["enc"][:2], vae_t["enc"][:2]
    np.testing.assert_allclose(init_t, init_j, atol=1e-4, rtol=0)
    x0_j, x0_t = vae_j["dec"][0], vae_t["dec"][0]
    np.testing.assert_allclose(x0_t, x0_j, atol=1e-4 * np.abs(x0_j).max(),
                               rtol=0)
    d = np.abs(fit_t - fit_j)
    assert d.max() <= 1e-2 and d.mean() <= 1e-3, (d.max(), d.mean())
    assert np.isfinite(calls_j[0]).all() and np.isfinite(calls_t[0]).all()
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
    assert mt.albedo.shape == mj.albedo.shape
    assert np.isfinite(mt.albedo).all()
    assert np.abs(mt.albedo - mj.albedo).mean() <= 0.05
