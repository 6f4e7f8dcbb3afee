"""Checkpoint loading in the port against the JAX package's, on the CPU.

- The port's safetensors reader (no `safetensors` package needed) against
  the package's own loader, byte for byte, over every dtype it reads.
- Seeded tiny state dicts (`torch_checkpoints.write_tiny_checkpoint`) in
  diffusers', transformers' and Real-ESRGAN's keys, as `.safetensors` and
  as `.bin`, in a temporary `checkpoint_dir` under the names the runners
  search; both packages' runners load them and give equal outputs: the
  UNet, VAE, CLIP text encoder, the three ControlNets, and IP-Adapter (the
  vision tower from `ip_adapter_vision/`, the projection and the UNet's
  IP branches from `ip_adapter/ip_adapter.npz`), at rtol 1e-4 and atol
  1e-4 * max|ref| as the diffusion module tests (the two frameworks sum in
  another order). SRVGG keeps Real-ESRGAN's layout in the port; the
  reference's converter misorders it (ROADMAP, reference behaviours), so
  the port's loaded enhancer is held against the JAX module on the params
  the file was made from, through the flax bridge.
- LPIPS from `lpips/lpips_vgg.*` in both key layouts: the same bf16
  parameters in both packages.
- Keys that match nothing are reported, and parameters a file lacks keep
  their seeded values.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from mvedit_tpu.apis import Adapter3DRunner as JRunner
from mvedit_tpu.models.image_enhancer import SRVGGNetCompact

from mvedit_tpu_torch.apis import Adapter3DRunner as TRunner
from mvedit_tpu_torch.models.diffusion.weights import (load_torch_state,
                                                       read_safetensors)
from torch_checkpoints import write_tiny_checkpoint

torch.set_num_threads(2)


def _close(out, ref, rtol=1e-4):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _t(x):
    return torch.from_numpy(np.array(x))


def test_safetensors_reader_matches_the_package(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {
        "f32": torch.randn((3, 5), generator=g),
        "bf16": torch.randn((7,), generator=g).bfloat16(),
        "f16": torch.randn((2, 2, 3), generator=g).half(),
        "f64": torch.randn((4,), generator=g).double(),
        "i64": torch.randint(-9, 9, (5,), generator=g),
        "i32": torch.randint(-9, 9, (3, 1), generator=g).int(),
        "u8": torch.randint(0, 255, (9,), generator=g).to(torch.uint8),
        "bool": torch.rand((6,), generator=g) > 0.5,
        "scalar": torch.tensor(3.5),
        "empty": torch.zeros((0, 4)),
    }
    path = str(tmp_path / "x.safetensors")
    save_file(state, path, metadata={"format": "pt"})
    ours, ref = read_safetensors(path), load_file(path)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        # the raw bytes, through a view as bytes (numpy has no bfloat16)
        assert ours[k].reshape(-1).view(torch.uint8).numpy().tobytes() \
            == v.reshape(-1).view(torch.uint8).numpy().tobytes(), k
    # load_torch_state takes both formats; .bin unwraps "state_dict"
    torch.save({"state_dict": state}, str(tmp_path / "x.bin"))
    for p in ("x.safetensors", "x.bin"):
        got = load_torch_state(str(tmp_path / p))
        assert all(torch.equal(got[k], state[k]) for k in state)


@pytest.fixture(scope="module", params=["safetensors", "bin"])
def loaded(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(f"ckpt_{request.param}"))
    trees = write_tiny_checkpoint(root, request.param)
    jr = JRunner(checkpoint_dir=root, seed=0, tiny_models=True)
    tr = TRunner(checkpoint_dir=root, seed=0, tiny_models=True,
                 device="cpu")
    return root, trees, jr, tr


def test_sd_stack_loads_equal(loaded):
    _, _, jr, tr = loaded
    jm, tm = jr.load_stable_diffusion(), tr.load_stable_diffusion()
    rng = np.random.RandomState(1)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([999, 400], np.int32)
    ctx = rng.standard_normal((2, 7, 32)).astype(np.float32)
    ids = rng.randint(0, 49408, (2, 77))
    with torch.no_grad():
        _close(tm.unet(_t(lat), _t(t), _t(ctx)),
               jm.unet.apply({"params": jm.unet_params}, lat, t, ctx))
        _close(tm.vae.decode(_t(lat)),
               jm.vae.apply({"params": jm.vae_params}, lat,
                            method=jm.vae.decode))
        _close(tm.text(_t(ids)),
               jm.text.apply({"params": jm.text_params}, ids))


def test_controlnets_load_equal(loaded):
    _, _, jr, tr = loaded
    kinds = ("tile", "depth", "ip2p")
    jnets, jparams = jr.load_controlnets(kinds)
    tnets = tr.load_controlnets(kinds)
    rng = np.random.RandomState(2)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([999, 400], np.int32)
    ctx = rng.standard_normal((2, 7, 32)).astype(np.float32)
    hint = rng.random((2, 16, 16, 3)).astype(np.float32)
    outs = []
    for jn, jp, tn in zip(jnets, jparams, tnets):
        jd, jmid = jn.apply({"params": jp}, lat, t, ctx, hint)
        with torch.no_grad():
            td, tmid = tn(_t(lat), _t(t), _t(ctx), _t(hint))
        for a, b in zip(td, jd):
            _close(a, b)
        _close(tmid, jmid)
        outs.append(np.asarray(jmid))
    # three different files went into three different nets
    assert not np.allclose(outs[0], outs[1])


def test_enhancer_loads_real_esrgan_layout(loaded):
    _, trees, _, tr = loaded
    enhance = tr.load_image_enhancer()
    x = np.random.RandomState(3).random((1, 16, 16, 3)).astype(np.float32)
    ref = SRVGGNetCompact(num_feat=8, num_conv=2).apply(
        {"params": trees["srvgg"]}, jnp.asarray(x))
    _close(enhance(_t(x), 64), np.clip(np.asarray(ref), 0, 1))


def test_ip_adapter_loads_equal(loaded):
    from mvedit_tpu.models.diffusion import AttnMode as JMode
    from mvedit_tpu_torch.models.diffusion import AttnMode as TMode
    _, _, jr, tr = loaded
    jm, tm = jr.load_stable_diffusion(), tr.load_stable_diffusion()
    img = np.random.RandomState(4).random((48, 40, 3)).astype(np.float32)
    jctx = jr.enable_ip_adapter(jm, img)
    tctx = tr.enable_ip_adapter(tm, img)
    assert tctx.shape == (2, 4, 32)
    _close(tctx, jctx)
    rng = np.random.RandomState(5)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([999, 400], np.int32)
    ctx = rng.standard_normal((2, 7, 32)).astype(np.float32)
    ref = jm.unet.apply({"params": jm.unet_params}, lat, t, ctx,
                        mode=JMode(ip_tokens=4), ip_context=np.asarray(jctx))
    with torch.no_grad():
        out = tm.unet(_t(lat), _t(t), _t(ctx), mode=TMode(ip_tokens=4),
                      ip_context=tctx)
    _close(out, ref)


def test_unmatched_keys_reported_and_missing_keep_seed(tmp_path, capsys):
    src = TRunner(seed=0, tiny_models=True, device="cpu")
    vae = src.load_stable_diffusion().vae
    state = {k: v.clone() for k, v in vae.state_dict().items()}
    dropped = "decoder.conv_out.bias"
    del state[dropped]
    state["decoder.not_a_layer.weight"] = torch.zeros(3)
    os.makedirs(tmp_path / "vae")
    save_file(state, str(tmp_path / "vae" / "vae.safetensors"))
    tr = TRunner(checkpoint_dir=str(tmp_path), seed=5, tiny_models=True,
                 device="cpu")
    got = tr.load_stable_diffusion().vae.state_dict()
    out = capsys.readouterr().out
    assert "vae:sd15: 1 unconverted keys" in out
    assert "1 parameters keep their seeded values" in out
    seeded = TRunner(seed=5, tiny_models=True,
                     device="cpu").load_stable_diffusion().vae.state_dict()
    assert torch.equal(got[dropped], seeded[dropped])
    assert all(torch.equal(got[k], state[k]) for k in state
               if k in got)
    # no file for the UNet in that directory: its seeded init stays
    assert all(torch.equal(a, b) for a, b in zip(
        tr.load_stable_diffusion().unet.state_dict().values(),
        TRunner(seed=5, tiny_models=True, device="cpu")
        .load_stable_diffusion().unet.state_dict().values()))


@pytest.mark.parametrize("layout", ["lin", "lpips_package"])
def test_lpips_loads_equal(tmp_path, layout):
    """Full-width VGG16 + heads (LPIPS is off at tiny sizes): both packages
    read the same bf16 parameters from either key layout."""
    g = torch.Generator().manual_seed(6)
    cfg = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
           "M", 512, 512, 512)
    state, c_in, i = {}, 3, 0
    for v in cfg:
        if v == "M":
            i += 1
            continue
        state[f"features.{i}.weight"] = torch.randn((v, c_in, 3, 3),
                                                    generator=g) * 0.05
        state[f"features.{i}.bias"] = torch.randn((v,), generator=g) * 0.05
        c_in, i = v, i + 2
    for j, c in enumerate((64, 128, 256, 512, 512)):
        w = torch.rand((1, c, 1, 1), generator=g)
        if layout == "lin":
            state[f"lin{j}"] = w.reshape(-1)
        else:
            state[f"lin{j}.model.1.weight"] = w
    os.makedirs(tmp_path / "lpips")
    save_file(state, str(tmp_path / "lpips" / "lpips_vgg.safetensors"))
    jp = JRunner(checkpoint_dir=str(tmp_path), seed=0).load_lpips()
    tp = TRunner(checkpoint_dir=str(tmp_path), seed=0,
                 device="cpu").load_lpips()
    assert len(tp["convs"]) == len(jp["convs"]) == 13
    for a, b in zip(tp["convs"], jp["convs"]):
        np.testing.assert_array_equal(
            a["w"].float().numpy(),
            np.asarray(b["w"], np.float32).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(a["b"].float().numpy(),
                                      np.asarray(b["b"], np.float32))
    for a, b in zip(tp["lins"], jp["lins"]):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


def test_convert_ip_adapter_matches_jax():
    """An IP-Adapter checkpoint in its published layout (`image_proj.*`,
    `ip_adapter.{i}.to_{k,v}_ip.weight` numbered over every attention
    processor, the cross-attentions odd): the port's converter gives the
    state of the JAX converter's trees, key for key and exactly."""
    from mvedit_tpu.models.diffusion.weights import (
        convert_ip_adapter as j_convert)
    from mvedit_tpu_torch.models.diffusion import UNetConfig
    from mvedit_tpu_torch.models.diffusion.weights import (
        convert_ip_adapter, torch_state_from_flax)
    jcfg = JRunner(tiny_models=True)._tiny_unet_cfg()
    tcfg = UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                      attn_down=(True, False), cross_attention_dim=32,
                      num_heads=4)
    g = torch.Generator().manual_seed(9)
    sd = {"image_proj.proj.weight": torch.randn((4 * 32, 24), generator=g),
          "image_proj.proj.bias": torch.randn((4 * 32,), generator=g),
          "image_proj.norm.weight": torch.randn((32,), generator=g),
          "image_proj.norm.bias": torch.randn((32,), generator=g)}
    inner = {0: 32, 1: 32, 2: 32, 3: 64}     # down 0, up 1 (x2), mid
    for i in range(4):
        for b in "kv":
            sd[f"ip_adapter.{2 * i + 1}.to_{b}_ip.weight"] = torch.randn(
                (inner[i], 32), generator=g)
    jproj, jpatch, jun = j_convert({k: v.numpy() for k, v in sd.items()},
                                   jcfg)
    proj, unet, un = convert_ip_adapter(sd, tcfg)
    assert jun == un == []
    want = torch_state_from_flax(jproj, "image_proj")
    assert sorted(want) == sorted(proj)
    assert all(torch.equal(want[k], proj[k]) for k in want)
    want = torch_state_from_flax(jpatch, "unet")
    assert sorted(want) == sorted(unet)
    assert all(torch.equal(want[k], unet[k]) for k in want)
