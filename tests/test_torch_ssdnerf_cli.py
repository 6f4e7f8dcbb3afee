"""SSDNeRF training's host side and CLIs in the port, on the CPU:

- `SceneCodeCache` loads a `scene_cache.npz` that the JAX package wrote
  (equal arrays, the batch gathered as float32 tensors); the
  `FileSceneCodeCache` round trip (writer threads, a re-read right after a
  write, untouched scenes zero, reload) and a file cache the JAX package
  wrote;
- `ray_batch_iterator`'s batches equal the JAX package's bit for bit, with
  rotated cameras, for scattered rays, `num_train_imgs`, the patch mode,
  `skip_iter` and `shard`;
- the trainer's hooks: checkpoints (the last `max_keep` kept, `load`), the
  log and the scheduled update;
- `python -m mvedit_tpu_torch.tools.train_ssdnerf`'s `main` in-process at a
  tiny config on `--device cpu`: stage 2 with `--eval-interval`, a resume
  (the EMA and the cache restored), stage 1 then a stage-2 warm start from
  its cache, the filesystem cache backend, and `tools.test_ssdnerf` on
  cached codes and with `--recons-views 1`; the loader's, the step's and
  the hooks' spans under an installed phase timer, the step and loader
  times read off it (and off the CLI's own timer without one);
- the same tools with `jax`, `flax`, `optax` and `mvedit_tpu` blocked.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.datasets import ray_batch_iterator as j_rays
from mvedit_tpu.models import ssdnerf as JS

from mvedit_tpu_torch.datasets import ray_batch_iterator as t_rays
from mvedit_tpu_torch.models import ssdnerf as TS
from mvedit_tpu_torch.runner import trainer as TTr
from mvedit_tpu_torch.tools import test_ssdnerf, train_ssdnerf
from mvedit_tpu_torch.utils import profiling as TP

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (3, 4, 8, 8)


def test_scene_code_cache_reads_the_jax_cache(tmp_path):
    rng = np.random.default_rng(0)
    jc = JS.SceneCodeCache(5, SHAPE)
    ids = np.array([1, 3])
    jc.scatter(ids, rng.normal(size=(2, *SHAPE)), rng.normal(
        size=(2, *SHAPE)), rng.random((2, *SHAPE)), np.array([4, 7]))
    path = str(tmp_path / "scene_cache.npz")
    jc.save(path)
    tc = TS.SceneCodeCache.load(path)
    for k in ("codes", "m", "v", "steps"):
        np.testing.assert_array_equal(getattr(tc, k), getattr(jc, k))
    jg, tg = jc.gather(ids), tc.gather(ids)
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert tg[0].dtype == torch.float32 and tg[3].dtype == torch.int32
    # the port's write reads back in the JAX package
    tc.scatter(np.array([0]), tg[0][:1] + 1, tg[1][:1], tg[2][:1],
               torch.tensor([9]))
    tc.save(path)
    back = JS.SceneCodeCache.load(path)
    np.testing.assert_array_equal(back.codes, tc.codes)
    assert int(back.steps[0]) == 9


def test_file_scene_code_cache(tmp_path):
    d = str(tmp_path / "code")
    cache = TS.FileSceneCodeCache(5, SHAPE, d, num_file_writers=2)
    ids = np.array([1, 3])
    codes, m, v, steps = cache.gather(ids)
    assert float(codes.abs().max()) == 0.0
    cache.scatter(ids, codes + 1.0, m + 0.5, v, steps + 2)
    # an immediate re-read awaits the pending write
    codes2, m2, _, steps2 = cache.gather(ids)
    np.testing.assert_array_equal(codes2.numpy(), 1.0)
    np.testing.assert_array_equal(m2.numpy(), 0.5)
    assert int(steps2[1]) == 2
    z, *_ = cache.gather(np.array([0]))
    assert float(z.abs().max()) == 0.0
    cache.save()
    c2 = TS.FileSceneCodeCache.load(d)
    assert c2.num_scenes == 5 and int(c2.steps[3]) == 2
    np.testing.assert_array_equal(c2.get_code(1), 1.0)
    cache.close()
    c2.close()
    # a file cache the JAX package wrote
    jd = str(tmp_path / "jax_code")
    jc = JS.FileSceneCodeCache(4, SHAPE, jd, num_file_writers=1)
    jc.scatter(np.array([2]), jnp.full((1, *SHAPE), 0.25),
               jnp.zeros((1, *SHAPE)), jnp.ones((1, *SHAPE)), np.array([5]))
    jc.save()
    tc = TS.FileSceneCodeCache.load(jd)
    np.testing.assert_array_equal(tc.gather(np.array([2]))[0].numpy(), 0.25)
    assert int(tc.steps[2]) == 5
    tc.close()


class FakeScenes:
    """Seeded scenes: random images, rotated cameras on a sphere."""

    def __init__(self, n=4, views=3, h=8, w=10):
        self.n, self.views, self.h, self.w = n, views, h, w

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        q = np.linalg.qr(rng.normal(size=(self.views, 3, 3)))[0]
        t = rng.normal(size=(self.views, 3, 1)) * 1.3
        return {"images": rng.random((self.views, self.h, self.w, 3)
                                     ).astype(np.float32),
                "poses": np.concatenate([q, t], -1).astype(np.float32),
                "intrinsics": np.tile(np.array([9.5, 8.25, 5.1, 3.9],
                                               np.float32),
                                      (self.views, 1)),
                "scene_id": i}


@pytest.mark.parametrize("mode", [
    dict(), dict(num_train_imgs=2), dict(patch_size=4), dict(skip_iter=3),
    dict(shard=(1, 2))])
def test_ray_batch_iterator_matches_jax_bits(mode):
    ds = FakeScenes(n=8)
    n_rays = 16 if "patch_size" in mode else 300
    jit = j_rays(ds, 2, n_rays, seed=5, **mode)
    tit = t_rays(ds, 2, n_rays, seed=5, **mode)
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        for k in ("rays_o", "rays_d", "rgb"):
            assert tb[k].dtype == torch.float32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]),
                                          err_msg=k)
        np.testing.assert_array_equal(tb["scene_ids"], jb["scene_ids"])
        assert tb["cond"] is None and len(tb["captions"]) == 2


@pytest.mark.parametrize("n", [8, 10, 16, 32, 64, 128, 256, 320, 400, 512,
                               800, 1024])
def test_pixel_centres_match_jax_linspace(n):
    from mvedit_tpu_torch.datasets.loader import pixel_centres
    np.testing.assert_array_equal(pixel_centres(np.arange(n), n),
                                  np.asarray(jnp.linspace(0.5, n - 0.5, n)))


def test_trainer_hooks(tmp_path):
    def train_step(state, batch, generator):
        return {"w": state["w"] - 0.1}, {"loss": state["w"].abs().sum()}

    def data():
        while True:
            yield {}
    calls = []
    ema = TTr.EmaHook(keys=("w",), momentum=0.5, rampup=0)
    hooks = [ema, TTr.LogHook(str(tmp_path), interval=2),
             TTr.CheckpointHook(str(tmp_path), interval=2, max_keep=2),
             TTr.ModelUpdaterHook({3: lambda tr: calls.append(tr.step)})]
    tr = TTr.Trainer(train_step, {"w": torch.ones(2)}, data(), hooks)
    tr.run(5)
    assert tr.step == 5 and calls == [3]
    assert sorted(os.listdir(tmp_path)) == ["metrics.jsonl", "step_4",
                                            "step_5"]
    rows = [json.loads(r) for r in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 4]
    state, step = TTr.CheckpointHook.load(str(tmp_path))
    assert step == 5
    np.testing.assert_allclose(state["w"].numpy(), 0.5, rtol=1e-6)
    # EMA of w = 0.9, 0.8, ..., 0.5: the first step copies, then e <- e / 2
    # + w / 2 (float32: 1e-6)
    np.testing.assert_allclose(state["ema"]["w"].numpy(), 0.59375,
                               rtol=1e-6)
    assert TTr.CheckpointHook.load(str(tmp_path / "none")) == (None, 0)


CFG = '''
import dataclasses
import torch
from mvedit_tpu_torch.apis.runner import init_random_
from mvedit_tpu_torch.configs.ssdnerf_cars import (LatentDenoiser,
                                                   ssdnerf_config)
from mvedit_tpu_torch.models.volume_renderer import RenderConfig

ssdnerf_config = dataclasses.replace(
    ssdnerf_config, code_shape=(3, 12, 8, 8), latent_shape=(3, 12, 8, 8),
    render=RenderConfig(num_samples=8, bound=0.5), n_rays=32)
train_config = dict(batch_size=2, max_iters=3, log_interval=1,
                    ckpt_interval=2{extra})


def build_denoiser(generator=None, device=None):
    with torch.device(device or "cpu"):
        net = LatentDenoiser(ch=32)
    with torch.no_grad():
        return init_random_(net, generator)
'''


def _srn(root, scenes=4, views=3, size=16):
    from PIL import Image
    for s in range(scenes):
        d = os.path.join(root, f"scene{s}")
        os.makedirs(os.path.join(d, "rgb"))
        os.makedirs(os.path.join(d, "pose"))
        rng = np.random.default_rng(s)
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


def _cfg(tmp_path, name, extra=""):
    path = str(tmp_path / f"{name}.py")
    with open(path, "w") as f:
        f.write(CFG.replace("{extra}", extra))
    return path


@pytest.fixture(scope="module")
def srn(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("srn"))
    _srn(root)
    return root


def test_train_resume_and_eval_cli(tmp_path, srn):
    cfg, work = _cfg(tmp_path, "cfg"), str(tmp_path / "work")
    args = ["--config", cfg, "--data", srn, "--work-dir", work,
            "--device", "cpu"]
    pt = TP.PhaseTimer()
    TP.set_phase_timer(pt)
    try:
        out = train_ssdnerf.main(args + ["--eval-interval", "2",
                                         "--eval-scenes", "1"])
    finally:
        TP.set_phase_timer(None)
    assert out.trainer.step == 3 and len(out.step_seconds) == 3
    spans = pt.spans

    def under(name):
        return {s.name for s in spans
                if s.parent is not None and spans[s.parent].name == name}
    assert under("loader") == {"loader.read", "loader.rays"}
    assert under("step") == {"step.h2d", "step.gather", "step.update",
                             "step.scatter"}
    roots = [s.name for s in spans if s.parent is None]
    assert roots.count("hooks.ema") == 3 and roots.count("hooks.eval") == 1
    assert set(pt.report()) == {"loader", "step"}
    for name, got in (("step", out.step_seconds),
                      ("loader", out.loader_seconds)):
        assert got == [s.end - s.start for s in spans if s.name == name]
    rows = [json.loads(r) for r in open(os.path.join(work, "eval.jsonl"))]
    assert [r["step"] for r in rows] == [2, 3]
    assert all(np.isfinite(r["psnr"]) for r in rows)
    losses = [json.loads(r) for r in open(os.path.join(work,
                                                       "metrics.jsonl"))]
    assert all(np.isfinite(r["loss_render"]) and np.isfinite(
        r["loss_diffusion"]) for r in losses)
    codes = out.cache.codes.copy()
    ema = out.ema
    res = train_ssdnerf.main(args + ["--resume", "--max-iters", "5"])
    assert res.trainer.step == 5 and len(res.step_seconds) == 2
    assert sorted(d for d in os.listdir(work) if d.startswith("step_")) \
        == ["step_3", "step_4", "step_5"]
    # the resume started from the saved codes and EMA, not from zeros
    state, _ = TTr.CheckpointHook.load(work)
    assert set(state) == {"decoder", "decoder_opt", "denoiser",
                          "denoiser_opt", "ema"}
    assert not np.array_equal(res.cache.codes, codes)
    assert res.cache.steps.sum() == out.cache.steps.sum() + 4
    assert int(res.trainer.state["decoder_opt"]["count"]) == 5
    assert not torch.equal(res.ema["denoiser"]["conv_in.weight"],
                           ema["denoiser"]["conv_in.weight"])
    got = test_ssdnerf.main(["--config", cfg, "--data", srn, "--work-dir",
                             work, "--device", "cpu", "--num-scenes", "2",
                             "--recons-views", "0"])
    assert got["scenes"] == 2 and np.isfinite(got["psnr"])


def test_two_stage_training_and_recons_eval_cli(tmp_path, srn):
    work = str(tmp_path / "work")
    base = ["--data", srn, "--work-dir", work, "--device", "cpu",
            "--max-iters", "2"]
    s1 = train_ssdnerf.main(["--config", _cfg(tmp_path, "s1",
                                              ", no_diffusion=True")]
                            + base)
    assert "denoiser" not in s1.trainer.state and s1.ema is None
    s2 = train_ssdnerf.main(["--config", _cfg(
        tmp_path, "s2", ", init_scene_cache='scene_cache.npz'")] + base)
    # the warm start read stage 1's codes and moved them on
    touched = s1.cache.steps > 0
    assert touched.any()
    assert (s2.cache.steps[touched] > s1.cache.steps[touched]).any()
    assert "denoiser" in s2.trainer.state
    got = test_ssdnerf.main(["--config", _cfg(tmp_path, "s2"), "--data",
                             srn, "--work-dir", work, "--device", "cpu",
                             "--num-scenes", "1", "--recons-views", "1",
                             "--recons-steps", "3"])
    assert got["scenes"] == 1 and np.isfinite(got["psnr"])
    # the filesystem cache backend, then its cached-code eval
    fs = str(tmp_path / "fs")
    cfg = _cfg(tmp_path, "fs", ", cache_backend='filesystem', "
               "num_file_writers=2")
    out = train_ssdnerf.main(["--config", cfg, "--data", srn, "--work-dir",
                              fs, "--device", "cpu", "--max-iters", "2"])
    out.cache.close()
    assert os.path.exists(os.path.join(fs, "code", "steps.npz"))
    got = test_ssdnerf.main(["--config", cfg, "--data", srn, "--work-dir",
                             fs, "--device", "cpu", "--num-scenes", "2",
                             "--recons-views", "0"])
    assert got["scenes"] == 2


def test_training_tools_run_with_jax_blocked(tmp_path, srn):
    """The port's datasets, runner and tools import, and a tiny train + a
    recons eval run, with JAX, flax, optax and `mvedit_tpu` blocked."""
    code = f'''
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "mvedit_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import mvedit_tpu_torch
for pkg in ("datasets", "runner", "tools"):
    mod = importlib.import_module("mvedit_tpu_torch." + pkg)
    for m in pkgutil.walk_packages(mod.__path__, mod.__name__ + "."):
        importlib.import_module(m.name)
from mvedit_tpu_torch.tools import train_ssdnerf, test_ssdnerf
args = ["--config", {_cfg(tmp_path, "blocked")!r}, "--data", {srn!r},
        "--work-dir", {str(tmp_path / "w")!r}, "--device", "cpu"]
train_ssdnerf.main(args + ["--max-iters", "1"])
test_ssdnerf.main(args + ["--num-scenes", "1", "--recons-views", "1",
                          "--recons-steps", "1"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "mvedit_tpu"))
assert not bad, bad
'''
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PSNR" in res.stdout
