"""One whole tiny `run_zero123plus1_2_to_mesh` (v1.2, its defaults: the
generated normals on) in both packages, on the CPU in f32, as
`test_torch_image_to_3d.py` runs v1.1: 1 + 6 views at 64^2, Zero123++ at
2 steps on its (48, 32) grid with the v1.2 latent roll, then its normal
pass (the normal UNet and the normal ControlNet on the RGB grid), the
normal-norm matte of each generated view (`zero123plus_postprocess`), the
masks min(TRACER, matte), the generated normals supervising every
generated view, TRACER, Omnidata on the input view, LoFTR pose and
IP-Adapter on, 2 MVEdit steps, tet 16.

Both runners load one seeded tiny checkpoint (`torch_checkpoints`); the
JAX runner's seeded Zero123++ vision tower, normal UNet and normal
ControlNet (its loaders have no converters) reach the port through the
bridge. The port replays the JAX request's draws: each Zero123++ pass's
(`JaxZero123PlusDraws` from PRNGKey(seed + pass) for the RGB pass,
PRNGKey(seed + pass + 1000) for the normal pass) and the MVEdit loop's
(`JaxDraws`). The JAX runner tokenizes the prompts with the port's crc32
word ids (`torch_tokenizer.StableHashTokenizer`).

Compared, with `test_torch_image_to_3d.py`'s bounds and no looser: the
generated views and normals within 1e-4; the MVEdit loop's masks and
normal targets (recorded at the pipeline's call) within 1e-4 mean and
1e-2 max (the matte's thresholds on the normals' norm; seeded TRACER's
masks are empty, so the min leaves them empty); the input pose;
the first timestep's init renders within 1e-4, its x0 estimate within
1e-4 of its magnitude and the renders after its fit within max |d| <=
1e-2, mean |d| <= 1e-3; the reference rows after the first timestep
within 1e-4 of their magnitude; the mesh's face count within 10%, its
mean radius within 2%, its bounding box within 0.05; the albedo's mean
|d| <= 0.05.

A second test stubs the segmenter in both runners with a map that is not
empty, and the MVEdit loop out: the targets' masks, min(segmenter,
matte) for the generated views and the segmenter's alone for the input
view, and the normal targets, within the same bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.apis import Adapter3DRunner as JRunner
from mvedit_tpu.models.diffusion import schedulers as JS
import mvedit_tpu.pipelines.mvedit_3d as JM

from mvedit_tpu_torch.apis import Adapter3DRunner as TRunner
from mvedit_tpu_torch.models.diffusion import schedulers as TS
from mvedit_tpu_torch.models.diffusion.weights import torch_state_from_flax
import mvedit_tpu_torch.pipelines.mvedit_3d as TM
from test_torch_image_to_3d import J_INGP, SEED, _record, _record_vae
from torch_checkpoints import (write_image_to_3d_checkpoint,
                               write_tiny_checkpoint)
from torch_jax_draws import JaxDraws, JaxZero123PlusDraws
from torch_tokenizer import StableHashTokenizer

torch.set_num_threads(4)


def _record_targets(monkeypatch, cls, rec):
    """Record the targets each MVEdit pipeline is called with."""
    orig = cls.__call__

    def call(self, targets, *a, **k):
        rec.append({k_: np.array(v) if not isinstance(v, torch.Tensor)
                    else v.detach().cpu().numpy()
                    for k_, v in targets.items()})
        return orig(self, targets, *a, **k)
    monkeypatch.setattr(cls, "__call__", call)


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt"))
    write_tiny_checkpoint(root, "safetensors", seed=6)
    write_image_to_3d_checkpoint(root, "safetensors", seed=7)
    jr = JRunner(checkpoint_dir=root, seed=0, tiny_models=True)
    jr.tokenizer = StableHashTokenizer()
    tr = TRunner(checkpoint_dir=root, seed=0, tiny_models=True,
                 device="cpu")
    jn, tn = jr.load_zero123plus_normal("1.2"), \
        tr.load_zero123plus_normal("1.2")
    for mod, params, kind in ((tn.vision, jn.vision_params, "clip_vision"),
                              (tn.unet, jn.unet_params, "unet"),
                              (tn.controlnet, jn.cn_params, "controlnet")):
        mod.load_state_dict(torch_state_from_flax(
            jax.tree_util.tree_map(np.asarray, params), kind))
    return jr, tr


def test_run_zero123plus1_2_to_mesh_matches_jax(runners, tmp_path,
                                                monkeypatch):
    jr, tr = runners
    poses = {}

    def pose_of(runner, name):
        orig = runner.estimate_input_pose

        def recording(*a, **k):
            poses[name] = orig(*a, **k)
            return poses[name]
        return recording
    monkeypatch.setattr(jr, "estimate_input_pose", pose_of(jr, "jax"))
    monkeypatch.setattr(tr, "estimate_input_pose", pose_of(tr, "port"))
    calls_j, calls_t = _record(monkeypatch, JS), _record(monkeypatch, TS)
    vae_j, vae_t = {"enc": [], "dec": []}, {"enc": [], "dec": []}
    _record_vae(monkeypatch, JM.MVEdit3DPipeline, vae_j)
    _record_vae(monkeypatch, TM.MVEdit3DPipeline, vae_t)
    tgt_j, tgt_t = [], []
    _record_targets(monkeypatch, JM.MVEdit3DPipeline, tgt_j)
    _record_targets(monkeypatch, TM.MVEdit3DPipeline, tgt_t)
    gen_j = []
    orig_proc = JRunner.proc_zero123plus

    def proc(self, *a, **k):
        gen_j.append(orig_proc(self, *a, **k))
        return gen_j[-1]
    monkeypatch.setattr(JRunner, "proc_zero123plus", proc)
    img = np.random.default_rng(3).random((40, 40, 3)).astype(np.float32)
    out_j = jr.run_zero123plus1_2_to_mesh(
        img, seed=SEED, out_path=str(tmp_path / "jax.glb"))
    out_t = tr.run_zero123plus1_2_to_mesh(
        img, seed=SEED, out_path=str(tmp_path / "port.glb"),
        draws=JaxDraws(jax.random.PRNGKey(SEED), J_INGP),
        z123_draws=lambda s: JaxZero123PlusDraws(jax.random.PRNGKey(s)))
    # Zero123++'s views and its generated normals
    (views_j, normals_j), = gen_j
    assert out_t["views"].shape == views_j.shape == (6, 16, 16, 3)
    np.testing.assert_allclose(out_t["views"], views_j, atol=1e-4, rtol=0)
    assert out_t["normals"].shape == normals_j.shape
    np.testing.assert_allclose(out_t["normals"], normals_j, atol=1e-4,
                               rtol=0)
    # the loop's masks (min(TRACER, matte)) and normal targets
    (tj,), (tt,) = tgt_j, tgt_t
    np.testing.assert_array_equal(tt["normal_weights"], np.ones(7))
    np.testing.assert_array_equal(tj["normal_weights"], np.ones(7))
    for k in ("masks", "normals"):
        d = np.abs(tt[k] - tj[k])
        assert d.mean() <= 1e-4 and d.max() <= 1e-2, (k, d.mean(), d.max())
    # seeded TRACER's masks are empty here (as in the v1.1 test), so the
    # min keeps them so; the generated normals are real targets
    assert np.abs(tj["normals"][1:] - 0.5).max() > 1e-2
    # the input pose: the same route, the same solve
    (pj, ej), (pt, et) = poses["jax"], poses["port"]
    assert (pj is None) == (pt is None)
    assert out_t["pose_route"] == ("front" if pt is None else "estimated")
    if pj is not None:
        np.testing.assert_allclose(pt, pj, atol=1e-4)
    # the MVEdit loop: as test_torch_image_to_3d.py holds v1.1
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


class _StubTracer:
    """A segmenter map that falls off with the normalised input's mean
    channel, 0 below a level (so TRACER's failure rule stays off): a
    partial mask that the matte's minimum can cut."""

    @staticmethod
    def apply(params, x):
        return jnp.clip(0.8 - jnp.mean(x, -1, keepdims=True), 0.0, 1.0)

    def __call__(self, x):
        return (0.8 - x.mean(-1, keepdim=True)).clamp(0.0, 1.0)


def test_v12_masks_and_normal_targets_match_jax(runners, monkeypatch):
    """The v1.2 targets with a segmenter whose masks are not empty: each
    generated view's mask min(segmenter, matte), the input view's the
    segmenter's alone, within the first test's bounds; the loop itself
    stubbed out."""
    jr, tr = runners
    monkeypatch.setitem(jr._cache, "tracer_model", (_StubTracer(), None))
    monkeypatch.setitem(tr._cache, "tracer", _StubTracer())
    tgt_j, tgt_t, seg_t = [], [], []
    for cls, rec in ((JM.MVEdit3DPipeline, tgt_j),
                     (TM.MVEdit3DPipeline, tgt_t)):
        monkeypatch.setattr(cls, "__call__", lambda self, targets, *a,
                            rec=rec, **k: rec.append(targets)
                            or {"mesh": None})
    orig_seg = tr.run_segmentation
    monkeypatch.setattr(tr, "run_segmentation",
                        lambda *a, **k: seg_t.append(orig_seg(*a, **k))
                        or seg_t[-1])
    img = np.random.default_rng(3).random((40, 40, 3)).astype(np.float32)
    jr.run_zero123plus1_2_to_mesh(img, seed=SEED)
    tr.run_zero123plus1_2_to_mesh(
        img, seed=SEED,
        z123_draws=lambda s: JaxZero123PlusDraws(jax.random.PRNGKey(s)))
    (tj,), (tt,) = tgt_j, tgt_t
    seg = seg_t[0].numpy()
    for k in ("masks", "normals"):
        a, b = np.asarray(tt[k]), np.asarray(tj[k])
        d = np.abs(a - b)
        assert d.mean() <= 1e-4 and d.max() <= 1e-2, (k, d.mean(), d.max())
    masks = np.asarray(tt["masks"])
    np.testing.assert_array_equal(masks[0], seg[0])
    assert 0.0 < seg[1:].mean() < 1.0
    # the matte cuts the segmenter's masks of the generated views
    assert (masks[1:] < seg[1:] - 1e-3).any()
    assert (masks[1:] <= seg[1:]).all()
