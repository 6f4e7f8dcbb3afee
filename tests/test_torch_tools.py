"""The port's root tools (`mvedit_tpu_torch/tools/`), run in-process
through `main(argv)` on the CPU, against the JAX package's tools where one
exists (each loaded from `tools/*.py` and run with `sys.argv` patched):

- `generate_tets` at 8: the npz arrays equal to JAX's tool's;
- `glb_to_obj`: the OBJs read back equal (vertices, faces, uvs);
- `kitti_preproc` on JAX's synthetic scene (`tests/test_cli.py::
  test_kitti_preproc_cli`): every output file byte for byte;
- `checkpoint_cleaner` on a work dir the port's `CheckpointHook` wrote at
  three steps (one step left; `--save-inf` drops the optimiser states and
  casts to float16), and on flat `.npz` files beside JAX's tool (the same
  files left, the same contents);
- `convert_weights`: the seeded tiny checkpoints of
  `tests/torch_checkpoints.py` laid out under MANIFEST names; a runner
  loaded from the tool's output equals one loaded from the hand-made dir,
  state dict for state dict, and the IP-Adapter's npz equals the
  hand-made one; a seeded IP-Adapter checkpoint gives the npz JAX's
  `_convert_ip_adapter` gives, key for key; `--kind` reports 0 unmatched
  keys on the right kind and some on a wrong one;
- the endpoint walkthrough at `--tiny --device cpu` (slow: ~1 min here;
  `chip_smoke.py` runs it on the card).
"""
import importlib.util
import os
import shutil
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from mvedit_tpu_torch.models.mesh import Mesh
from mvedit_tpu_torch.tools import (checkpoint_cleaner, convert_weights,
                                    generate_tets, glb_to_obj,
                                    kitti_preproc)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name, argv, monkeypatch):
    """Runs the JAX package's `tools/<name>.py` main() in-process."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if argv is not None:
        monkeypatch.setattr(sys, "argv", [name] + list(argv))
        mod.main()
    return mod


def test_generate_tets_equals_jax(tmp_path, monkeypatch):
    out = generate_tets.main(["--resolution", "8", "--out",
                              str(tmp_path / "port" / "8_tets.npz")])
    _jax_tool("generate_tets", ["--resolution", "8", "--out",
                                str(tmp_path / "jax" / "8_tets.npz")],
              monkeypatch)
    a, b = np.load(out), np.load(tmp_path / "jax" / "8_tets.npz")
    assert sorted(a.files) == sorted(b.files) == ["indices", "vertices"]
    for k in a.files:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    assert len(a["indices"]) > 1000


def test_glb_to_obj_equals_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    v = rng.normal(size=(30, 3)).astype(np.float32)
    f = rng.integers(0, 30, (40, 3)).astype(np.int32)
    m = Mesh(v=v, f=f, vt=rng.random((30, 2)).astype(np.float32), ft=f,
             albedo=rng.random((8, 8, 3)).astype(np.float32))
    m.auto_normal()
    src = str(tmp_path / "m.glb")
    m.write_glb(src)
    dst = glb_to_obj.main([src, str(tmp_path / "port.obj")])
    _jax_tool("glb_to_obj", [src, str(tmp_path / "jax.obj")], monkeypatch)
    a, b = Mesh.load(dst), Mesh.load(str(tmp_path / "jax.obj"))
    for k in ("v", "f", "vt", "ft"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    np.testing.assert_allclose(a.v, m.v, atol=1e-6)


def _kitti_scene(base):
    """JAX's synthetic KITTI scene (`tests/test_cli.py`)."""
    for d in ("image_2", "instance_2", "label_2", "calib"):
        (base / d).mkdir(parents=True)
    rng = np.random.default_rng(0)
    Image.fromarray((rng.random((128, 256, 3)) * 255).astype(np.uint8)
                    ).save(base / "image_2" / "000000.png")
    seg = np.zeros((128, 256), np.int32)
    seg[40:90, 100:180] = 1000
    Image.fromarray(seg).save(base / "instance_2" / "000000.png")
    (base / "label_2" / "000000.txt").write_text(
        "Car 0 0 0.0 100 40 180 90 1.5 1.7 4.0 2.0 1.6 15.0 0.3\n")
    P = np.array([[700, 0, 128, 40], [0, 700, 64, 1],
                  [0, 0, 1, 0.002]], np.float32)
    lines = [f"P{i}: " + " ".join(str(v) for v in P.reshape(-1))
             for i in range(4)]
    (base / "calib" / "000000.txt").write_text("\n".join(lines) + "\n")


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_kitti_preproc_equals_jax(tmp_path, monkeypatch):
    base = tmp_path / "training"
    _kitti_scene(base)
    kitti_preproc.main(["--kitti-dir", str(base), "--out-dir",
                        str(tmp_path / "port")])
    _jax_tool("kitti_preproc", ["--kitti-dir", str(base), "--out-dir",
                                str(tmp_path / "jax")], monkeypatch)
    a, b = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(a) == sorted(b) and len(a) == 4
    assert a == b


def test_checkpoint_cleaner_on_port_workdir(tmp_path):
    from mvedit_tpu_torch.runner.trainer import CheckpointHook
    g = torch.Generator().manual_seed(0)
    state = {"decoder": {"w": torch.randn(4, 3, generator=g)},
             "decoder_opt": {"m": torch.zeros(4, 3), "step": torch.ones(())},
             "denoiser": {"b": torch.randn(5, generator=g)},
             "denoiser_opt": {"v": torch.ones(5)},
             "count": torch.tensor(3)}
    hook = CheckpointHook(str(tmp_path / "work"), interval=1, max_keep=3)
    trainer = types.SimpleNamespace(state=state, hooks=[], step=0)
    for step in (1, 2, 3):
        trainer.step = step
        hook.after_iter(trainer, {})
    assert sorted(os.listdir(tmp_path / "work")) == \
        ["step_1", "step_2", "step_3"]
    checkpoint_cleaner.main([str(tmp_path / "work"), "--save-inf", "--yes"])
    assert sorted(os.listdir(tmp_path / "work")) == ["step_3"]
    kept, step = CheckpointHook.load(str(tmp_path / "work"))
    assert step == 3 and sorted(kept) == ["count", "decoder", "denoiser"]
    assert kept["decoder"]["w"].dtype == torch.float16
    assert kept["count"].dtype == torch.int64
    np.testing.assert_array_equal(kept["decoder"]["w"].numpy(),
                                  state["decoder"]["w"].half().numpy())


@pytest.mark.parametrize("save_inf", [True, False])
def test_checkpoint_cleaner_npz_equals_jax(tmp_path, monkeypatch, save_inf):
    """The flat-npz rule, as the JAX tool has it (its own test's files)."""
    for tag in ("port", "jax"):
        work = tmp_path / tag
        work.mkdir()
        for i in (1, 2, 3):
            np.savez(work / f"model_{i:03d}.npz",
                     w=np.full(3, i, np.float32), opt_mu=np.ones(3))
    argv = ["--save-inf"] if save_inf else []
    checkpoint_cleaner.main([str(tmp_path / "port"), "--yes"] + argv)
    _jax_tool("checkpoint_cleaner", [str(tmp_path / "jax"), "--yes"] + argv,
              monkeypatch)
    a, b = sorted(os.listdir(tmp_path / "port")), \
        sorted(os.listdir(tmp_path / "jax"))
    assert a == b == (["model_001.npz", "model_002.npz", "model_003.npz"]
                      if save_inf else ["model_003.npz"])
    for name in a:
        x, y = np.load(tmp_path / "port" / name), \
            np.load(tmp_path / "jax" / name)
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


def _ip_adapter_raw(trees):
    """The hand-made dir's IP-Adapter in its published layout
    (`image_proj.*`, `ip_adapter.{2i+1}.to_{k,v}_ip.weight` over the
    cross-attentions in diffusers' processor order)."""
    from mvedit_tpu_torch.models.diffusion import UNetConfig
    from mvedit_tpu_torch.models.diffusion.weights import (
        attn2_keys, torch_state_from_flax)
    sd = {f"image_proj.{k}": v for k, v in torch_state_from_flax(
        trees["image_proj"], "image_proj").items()}
    tree = {}
    for path, v in trees["unet_ip"].items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    unet = torch_state_from_flax(tree, "unet")
    cfg = UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                     attn_down=(True, False), cross_attention_dim=32,
                     num_heads=4)
    for i, key in enumerate(attn2_keys(cfg)):
        for b in "kv":
            sd[f"ip_adapter.{2 * i + 1}.to_{b}_ip.weight"] = \
                unet[f"{key}.ip_to_{b}.weight"]
    return sd


def test_convert_weights_layout_loads_equal(tmp_path, capsys):
    from safetensors.torch import save_file
    from mvedit_tpu_torch.apis import Adapter3DRunner
    from torch_checkpoints import write_tiny_checkpoint
    hand = tmp_path / "hand"
    trees = write_tiny_checkpoint(str(hand), "safetensors")
    zoo = tmp_path / "zoo"
    layout = {
        "stable-diffusion-v1-5/unet": "unet/diffusion_pytorch_model"
                                      ".safetensors",
        "stable-diffusion-v1-5/vae": "vae/diffusion_pytorch_model"
                                     ".safetensors",
        "stable-diffusion-v1-5/text_encoder": "text_encoder/model"
                                              ".safetensors",
        "control_v11f1e_sd15_tile": "controlnet_tile/controlnet_tile"
                                    ".safetensors",
        "control_v11f1p_sd15_depth": "controlnet_depth/diffusion_pytorch_"
                                     "model.safetensors",
        "control_v11e_sd15_ip2p": "controlnet_ip2p/diffusion_pytorch_model"
                                  ".safetensors",
        "realesr-general-x4v3": "image_enhancer/model.safetensors",
        # an entry no loader of the port reads
        "zero123plus-v1.1/unet": "unet/diffusion_pytorch_model"
                                 ".safetensors"}
    for name, rel in layout.items():
        os.makedirs(zoo / name)
        fname = "model.safetensors" if name.startswith("realesr") \
            else "diffusion_pytorch_model.safetensors"
        shutil.copyfile(hand / rel, zoo / name / fname)
    os.makedirs(zoo / "ip-adapter_sd15")
    save_file({k: v.contiguous() for k, v in _ip_adapter_raw(trees).items()},
              str(zoo / "ip-adapter_sd15" / "model.safetensors"))
    out = tmp_path / "out"
    report = convert_weights.main(["--all", "--src", str(zoo), "--out-dir",
                                   str(out), "--tiny"])
    for name in layout:
        if name.startswith("zero123plus"):
            assert report[name].startswith("not read by the port")
        else:
            assert report[name].startswith("ok: ") and \
                "(0 unmatched, 0 missing)" in report[name], report[name]
    assert report["ip-adapter_sd15"] == \
        "ok: ip_adapter/ip_adapter.npz (0 unmatched, 0 missing)"
    assert report["tracer_b7"] == "missing"
    assert not (out / "zero123plus_unet").exists()
    # the IP-Adapter npz equals the hand-made one, key for key
    a = np.load(out / "ip_adapter" / "ip_adapter.npz")
    b = np.load(hand / "ip_adapter" / "ip_adapter.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    # a runner of the tool's output equals one of the hand-made dir
    r_out = Adapter3DRunner(checkpoint_dir=str(out), seed=0,
                            tiny_models=True, device="cpu")
    r_hand = Adapter3DRunner(checkpoint_dir=str(hand), seed=0,
                             tiny_models=True, device="cpu")
    mo, mh = r_out.load_stable_diffusion(), r_hand.load_stable_diffusion()
    pairs = [(mo.unet, mh.unet), (mo.vae, mh.vae), (mo.text, mh.text)]
    kinds = ("tile", "depth", "ip2p")
    pairs += list(zip(r_out.load_controlnets(kinds),
                      r_hand.load_controlnets(kinds)))
    r_out.load_image_enhancer()
    r_hand.load_image_enhancer()
    pairs.append((r_out._cache["srvgg"], r_hand._cache["srvgg"]))
    for x, y in pairs:
        sx, sy = x.state_dict(), y.state_dict()
        assert sorted(sx) == sorted(sy)
        for k in sx:
            assert torch.equal(sx[k], sy[k]), k
    capsys.readouterr()


def test_convert_ip_adapter_equals_jax_tool(tmp_path, monkeypatch):
    """A seeded IP-Adapter checkpoint at SD1.5's 16 cross-attentions (small
    arbitrary widths: the conversion only transposes)."""
    g = torch.Generator().manual_seed(11)
    sd = {"image_proj.proj.weight": torch.randn((12, 6), generator=g),
          "image_proj.proj.bias": torch.randn((12,), generator=g),
          "image_proj.norm.weight": torch.randn((3,), generator=g),
          "image_proj.norm.bias": torch.randn((3,), generator=g)}
    for i in range(16):
        for b in "kv":
            sd[f"ip_adapter.{2 * i + 1}.to_{b}_ip.weight"] = torch.randn(
                (5 + i % 3, 4), generator=g)
    src = str(tmp_path / "ip-adapter_sd15.bin")
    torch.save(sd, src)
    dst, unmatched, _ = convert_weights.layout_entry(
        "ip_adapter", "ip_adapter", src, str(tmp_path / "port"))
    assert unmatched == []
    jtool = _jax_tool("convert_weights", None, monkeypatch)
    jout = str(tmp_path / "jax.npz")
    assert jtool.convert_one("ip_adapter", src, jout) == []
    a, b = np.load(dst), np.load(jout)
    assert sorted(a.files) == sorted(b.files) and len(a.files) == 36
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_convert_weights_kind_reports_keys(tmp_path):
    from torch_checkpoints import write_tiny_checkpoint
    root = tmp_path / "ckpt"
    write_tiny_checkpoint(str(root), "bin")
    cases = [("unet", "unet"), ("vae", "vae"), ("clip_text", "text_encoder"),
             ("controlnet", "controlnet_tile/diffusion_pytorch_model.bin"),
             ("srvgg", "image_enhancer"), ("clip_vision",
                                           "ip_adapter_vision")]
    for kind, rel in cases:
        res = convert_weights.main(["--kind", kind, "--src",
                                    str(root / rel), "--tiny"])
        assert res["unmatched"] == res["missing"] == [], (kind, res)
    res = convert_weights.main(["--kind", "vae", "--src", str(root / "unet"),
                                "--tiny"])
    assert len(res["unmatched"]) > 100
    assert convert_weights.main(["--kind", "clip_camera_projection",
                                 "--src", str(root / "unet")]) is None


@pytest.mark.slow
def test_walkthrough_tiny_cpu(tmp_path):
    from mvedit_tpu_torch.tools import example_api_local
    out = example_api_local.main(["--tiny", "--device", "cpu", "--out-dir",
                                  str(tmp_path)])
    assert out["3d_to_3d"] and out["zero123plus_to_mesh"]
    assert out["retex"] == (1024, 1024, 3)
    assert os.path.exists(out["video"])
