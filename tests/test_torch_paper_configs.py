"""The port's copies of the training recipes under `configs/` against the
JAX package's, on the CPU:

- every recipe file has a port copy under `mvedit_tpu_torch/configs/`
  whose `ssdnerf_config` (with its `TriPlaneConfig`, `RenderConfig` and
  `GaussianDiffusionConfig`) equals the JAX module's field by field, and
  whose `train_config` equals it; its `build_denoiser(generator, device)`
  builds (the paper family's conv denoiser; None for stage 1; the SD2.1
  recipe is built in `test_torch_stablessdnerf.py`);
- the paper family's stack and tiled denoisers
  (`_ssdnerf_paper_base.build_denoiser_for`) against JAX's on the
  family's (3, 6, H, W) code cut to 16 x 16 (the stack one at ch 128, the
  tiled one at ch 64, where JAX builds), with the flax params jittered
  and bridged: outputs within 1e-5 relative (L2), and the tiled layout's
  plane order (a permutation that swapped planes would still train);
- the pin: the JAX tiled recipe's ch 80 asks flax for 32 GroupNorm groups
  over 80 channels and raises; the port's builds with 16.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu_torch.configs import _ssdnerf_paper_base as TP
from mvedit_tpu_torch.models.diffusion.weights import torch_state_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = sorted(f for f in os.listdir(os.path.join(REPO, "configs"))
                 if f.endswith(".py") and not f.startswith("_"))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_every_recipe_is_listed():
    assert len(RECIPES) == 23
    assert "stablessdnerf_cars_lpips.py" in RECIPES


@pytest.mark.parametrize("name", RECIPES)
def test_port_recipe_matches_jax(name):
    jmod = _load(os.path.join(REPO, "configs", name), "jax_" + name[:-3])
    path = os.path.join(REPO, "mvedit_tpu_torch", "configs", name)
    assert os.path.exists(path), f"no port copy of configs/{name}"
    tmod = _load(path, "port_" + name[:-3])
    assert dataclasses.asdict(tmod.ssdnerf_config) == dataclasses.asdict(
        jmod.ssdnerf_config)
    assert type(tmod.ssdnerf_config.triplane).__name__ == "TriPlaneConfig"
    assert type(tmod.ssdnerf_config.render).__name__ == "RenderConfig"
    assert tmod.train_config == jmod.train_config
    if name == "stablessdnerf_cars_lpips.py":
        assert hasattr(tmod, "make_cond_fn")
        return
    net = tmod.build_denoiser(torch.Generator().manual_seed(0), "cpu")
    if tmod.train_config.get("no_diffusion"):
        assert net is None
        return
    P, C, H, W = tmod.ssdnerf_config.latent_shape
    with torch.no_grad():
        out = net(torch.zeros((1, P, C, 8, 8)), torch.zeros(
            (1,), dtype=torch.long))
    assert out.shape == (1, P, C, 8, 8)


def _small(cfg):
    return dataclasses.replace(cfg, code_shape=(3, 6, 16, 16),
                               latent_shape=(3, 6, 16, 16))


@pytest.mark.parametrize("layout,ch", [("stack", 128), ("tiled", 64)])
def test_paper_denoisers_match_jax(layout, ch):
    jbase = _load(os.path.join(REPO, "configs", "_ssdnerf_paper_base.py"),
                  "jax_paper_base")
    _, apply, params = jbase.build_denoiser_for(
        _small(jbase.make_paper_config()), jax.random.PRNGKey(0), ch=ch,
        layout=layout)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape)
        .astype(np.float32), params)
    x = rng.normal(size=(2, 3, 6, 16, 16)).astype(np.float32)
    # planes told apart: plane p shifted by 3 p
    x += 3.0 * np.arange(3, dtype=np.float32)[None, :, None, None, None]
    t = np.array([12, 600], np.int32)
    jout = apply(params, jnp.asarray(x), jnp.asarray(t))
    net = TP.build_denoiser_for(_small(TP.make_paper_config()), None, "cpu",
                                ch=ch, layout=layout)
    net.load_state_dict(torch_state_from_flax(params["params"],
                                              "latent_denoiser"),
                        strict=True)
    with torch.no_grad():
        tout = net(torch.from_numpy(x), torch.from_numpy(t))
    assert tout.shape == jout.shape == x.shape
    assert _rel(tout, jout) <= 1e-5
    # a plane-swapped output is far from JAX's
    assert _rel(tout[:, [1, 0, 2]], jout) > 1e-2


def test_tiled_recipe_groups():
    jbase = _load(os.path.join(REPO, "configs", "_ssdnerf_paper_base.py"),
                  "jax_paper_base")
    with pytest.raises(ValueError, match="groups"):
        jbase.build_denoiser_for(_small(jbase.make_paper_config()),
                                 jax.random.PRNGKey(0), ch=80,
                                 layout="tiled")
    tmod = _load(os.path.join(REPO, "mvedit_tpu_torch", "configs",
                              "ssdnerf_cars_recons1v_tiled.py"), "tiled")
    net = tmod.build_denoiser(torch.Generator().manual_seed(0), "cpu")
    assert net.layout == "tiled" and net.ch == 80
    assert {net.get_submodule(f"norm{i}").num_groups
            for i in range(4)} == {16}
    assert net.conv_in.in_channels == 6
    assert [TP.norm_groups(c) for c in (32, 64, 80, 128, 24)] == [
        32, 32, 16, 32, 24]


def test_new_modules_and_tools_run_with_jax_blocked(tmp_path):
    """Every port config loads, and this slice's modules and
    `tools.inception_stat` import and run (a tiny DDPMUNet, UNetVolume,
    sparse interpolation, LoRA merge, the stat tool on 2 images), with
    JAX, flax, optax, orbax and `mvedit_tpu` blocked."""
    import subprocess
    import sys
    from PIL import Image
    d = tmp_path / "srn" / "scene0"
    os.makedirs(d / "rgb")
    os.makedirs(d / "pose")
    for i in range(2):
        Image.fromarray(np.full((8, 8, 3), 40 * i, np.uint8)).save(
            d / "rgb" / f"{i:06d}.png")
        np.savetxt(d / "pose" / f"{i:06d}.txt", np.eye(4).reshape(1, 16))
    (d / "intrinsics.txt").write_text("8 4 4 0\n0 0 0\n8 8\n")
    code = f'''
import glob, importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                  "mvedit_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import torch
from mvedit_tpu_torch.tools.train_ssdnerf import load_config
for p in sorted(glob.glob("mvedit_tpu_torch/configs/*.py")):
    load_config(p)
for m in ("models.inception", "models.ddpm_unet", "models.volume_unet",
          "ops.volume_interp", "models.diffusion.lora",
          "configs._ssdnerf_paper_base", "configs.stablessdnerf_cars_lpips"):
    importlib.import_module("mvedit_tpu_torch." + m)
from mvedit_tpu_torch.models.ddpm_unet import DDPMUNet, DDPMUNetConfig
from mvedit_tpu_torch.models import volume_unet as V
from mvedit_tpu_torch.ops import volume_interp as VI
from mvedit_tpu_torch.models.diffusion import lora as L
net = DDPMUNet(DDPMUNetConfig(in_channels=6, out_channels=6,
                              base_channels=32, channel_mults=(1, 2),
                              layers_per_block=1, attn_levels=(1,)))
assert net(torch.zeros(1, 3, 2, 8, 8), torch.zeros(1)).shape == \\
    (1, 3, 2, 8, 8)
vn = V.UNetVolume(V.VolumeUNetConfig(block_out_channels=(32, 64),
                                     layers_per_block=1, out_channels=2))
assert vn(torch.zeros(1, 4, 8, 8, 8))[0].shape == (1, 2, 8, 8, 8)
vol = VI.sparse_volume(torch.tensor([[0, 2, 2, 2]]), torch.ones(1, 2),
                       (4, 4, 4), 1)
out, ok = VI.spvolume_linear_interp(vol, torch.zeros(1, 3),
                                    torch.zeros(1, 1, dtype=torch.long))
assert bool(ok[0])
w = {{"x.to_q.weight": torch.zeros(3, 2)}}
lo = L.init_lora(None, w, rank=1)
assert L.merge_lora(w, lo)["x.to_q.weight"].shape == (3, 2)
from mvedit_tpu_torch.tools import inception_stat
r = inception_stat.main(["--data", {str(tmp_path / "srn")!r}, "--out",
                         {str(tmp_path / "s.npz")!r}, "--device", "cpu"])
assert r["feats"].shape == (2, 2048)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "orbax", "mvedit_tpu"))
assert not bad, bad
'''
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "saved (2, 2048) features" in res.stdout
