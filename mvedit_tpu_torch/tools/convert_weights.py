"""Lay the reference's model zoo out as a `checkpoint_dir` of the port
(counterpart of `tools/convert_weights.py`).

The port reads the reference's torch checkpoints as they come (diffusers',
transformers', Real-ESRGAN's and the perception nets' own keys;
`apis/runner.py`), so most entries need no conversion, only a place:

  # every MANIFEST entry found under ROOT -> DIR/<subdir>/<file>
  python -m mvedit_tpu_torch.tools.convert_weights --all --src ROOT \\
      --out-dir DIR

  # load one checkpoint into the port's module of a kind, report its keys
  python -m mvedit_tpu_torch.tools.convert_weights --kind unet \\
      --src /path/to/unet

MANIFEST mirrors the reference's model zoo (`lib/apis/adapter3d.py:159-
423`), each entry mapped to a (kind, subdir) pair as in the JAX tool. An
entry the port reads is copied to the subdir under a file name the
runner searches (`lpips/lpips_vgg.*` for LPIPS); the IP-Adapter is
converted to `ip_adapter/ip_adapter.npz`, the flattened tree
`Adapter3DRunner.enable_ip_adapter` reads (the JAX tool's
`_convert_ip_adapter` layout). Each laid-out file is then loaded into the
port's module of its kind (built on the meta device, so no memory is
taken) and its unmatched keys and the parameters it lacks are counted.
An entry no loader of the port reads is reported as such, never dropped
silently. `--tiny` takes the runner's `tiny_models` widths for the
modules.
"""
import argparse
import json
import os
import re
import shutil

import numpy as np
import torch

__all__ = ["MANIFEST", "KINDS", "main", "ip_adapter_tree", "check_kind",
           "layout_entry"]

# reference model zoo -> (kind, target subdir under checkpoint_dir), as the
# JAX tool (lib/apis/adapter3d.py:159-423, lib/pipelines/utils.py:191-305)
MANIFEST = {
    "stable-diffusion-v1-5/unet": ("unet", "unet"),
    "stable-diffusion-v1-5/vae": ("vae", "vae"),
    "stable-diffusion-v1-5/text_encoder": ("clip_text", "text_encoder"),
    "control_v11f1e_sd15_tile": ("controlnet", "controlnet_tile"),
    "control_v11f1p_sd15_depth": ("controlnet", "controlnet_depth"),
    "control_v11e_sd15_ip2p": ("controlnet", "controlnet_ip2p"),
    "zero123plus-v1.1/unet": ("unet", "zero123plus_unet"),
    "zero123plus-v1.1/vision_encoder": ("clip_vision",
                                        "zero123plus_vision"),
    "zero123plus-v1.2/unet": ("unet", "zero123plus_unet_v12"),
    "ip-adapter_sd15": ("ip_adapter", "ip_adapter"),
    "tracer_b7": ("tracer", "tracer"),
    "realesr-general-x4v3": ("srvgg", "image_enhancer"),
    "lpips_vgg": ("lpips", "lpips"),
    "pt_inception-2015-12-05": ("inception", "inception"),
    "omnidata_dpt_normal_v2": ("dpt", "omnidata"),
    "indoor_ds_new": ("loftr", "loftr"),
    "sam_vit_h_4b8939": ("sam", "sam"),
    "zero123/unet": ("unet", "zero123_unet"),
    "zero123/image_encoder": ("clip_vision", "zero123_vision"),
    "zero123/clip_camera_projection": ("clip_camera_projection",
                                       "zero123_ccp"),
}
# the subdirs some loader of the port reads (`apis/runner.py`,
# `apis/endpoints.py::load_zero123plus`, `tools/inception_stat.py`); the
# Zero123++ UNets are SD1.5's `unet/`, and legacy Zero123 is seeded
READ_BY_PORT = ("unet", "vae", "text_encoder", "controlnet_tile",
                "controlnet_depth", "controlnet_ip2p", "zero123plus_vision",
                "ip_adapter", "tracer", "image_enhancer", "lpips",
                "inception", "omnidata", "loftr", "sam")
# the files of a source dir, in the JAX tool's search order
_SOURCE_FILES = ("diffusion_pytorch_model.safetensors", "model.safetensors",
                 "diffusion_pytorch_model.bin", "pytorch_model.bin")


def _module(kind, tiny):
    """(port module factory, state converter or None) of a kind, at the
    runner's widths (`tiny_models` with `tiny`)."""
    from ..models.diffusion import (SD15_TEXT, SD_VAE, AutoencoderKL,
                                    CLIPTextConfig, CLIPTextModel,
                                    ControlNet, UNet2DCondition, VAEConfig)
    from ..models.diffusion.clip import CLIPVisionConfig, CLIPVisionModel
    from ..models.diffusion.weights import convert_clip_vision
    unet = _unet_cfg(tiny)
    if kind == "unet":
        return (lambda: UNet2DCondition(unet)), None
    if kind == "controlnet":
        return (lambda: ControlNet(unet, hint_strides=1 if tiny else 3)), \
            None
    if kind == "vae":
        cfg = VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                        dtype=torch.float32) if tiny else SD_VAE
        return (lambda: AutoencoderKL(cfg)), None
    if kind == "clip_text":
        cfg = CLIPTextConfig(vocab_size=49408, hidden_size=32,
                             intermediate_size=64, num_layers=2,
                             num_heads=4) if tiny else SD15_TEXT
        return (lambda: CLIPTextModel(cfg)), None
    if kind == "clip_vision":       # the Zero123++ tower
        cfg = CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=32,
                               intermediate_size=64, num_layers=2,
                               num_heads=4, projection_dim=32) if tiny \
            else CLIPVisionConfig(projection_dim=768)
        return (lambda: CLIPVisionModel(cfg)), convert_clip_vision
    if kind == "srvgg":
        from ..models.image_enhancer import SRVGGNetCompact
        return (lambda: SRVGGNetCompact(num_feat=8 if tiny else 64,
                                        num_conv=2 if tiny else 32)), \
            lambda sd: (sd.get("params_ema", sd.get("params", sd)), [])
    if kind == "tracer":
        from ..models.segmentors import TracerDecoder, convert_tracer_state
        return TracerDecoder, convert_tracer_state
    if kind == "dpt":
        from ..models.segmentors import DPTNormalModel, convert_dpt_state
        if tiny:
            return (lambda: DPTNormalModel(
                vit_layers=2, readout_taps=(0, 1),
                resnet_layers=(1, 1, 1))), convert_dpt_state
        return DPTNormalModel, convert_dpt_state
    if kind == "loftr":
        from ..models.segmentors import LoFTR, convert_loftr_state
        return (lambda: LoFTR(layers=1 if tiny else 4)), convert_loftr_state
    if kind == "sam":
        from ..models.segmentors.sam import SAM_TINY, SAM_VIT_H, SamModel
        return (lambda: SamModel(SAM_TINY if tiny else SAM_VIT_H)), None
    if kind == "inception":
        from ..models.inception import InceptionV3Features
        return InceptionV3Features, None
    return None, None


KINDS = ("unet", "controlnet", "vae", "clip_text", "clip_vision", "srvgg",
         "tracer", "dpt", "loftr", "sam", "inception", "lpips", "ip_adapter",
         "zero123plus_ramping", "clip_camera_projection")


def _unet_cfg(tiny):
    """The runner's UNet (and ControlNet) widths."""
    from ..models.diffusion import SD15_UNET, UNetConfig
    return UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                      attn_down=(True, False), cross_attention_dim=32,
                      num_heads=4, dtype=torch.float32) if tiny \
        else SD15_UNET


def _attn2_flax_paths(cfg):
    """The JAX UNet's cross-attention module paths, in the order the
    IP-Adapter checkpoint numbers its `ip_adapter.{i}` entries (down
    blocks, up blocks, mid: `weights.attn2_keys`' order)."""
    paths = []
    n = len(cfg.block_out_channels)
    depth = getattr(cfg, "transformer_depth", 1)

    def tb(base):
        paths.extend(base + (f"transformer_blocks_{d}", "attn2")
                     for d in range(depth))
    for bi in range(n):
        if cfg.attn_down[bi]:
            for li in range(cfg.layers_per_block):
                tb((f"down_{bi}_attentions_{li}",))
    for ui, bi in enumerate(reversed(range(n))):
        if cfg.attn_down[bi]:
            for li in range(cfg.layers_per_block + 1):
                tb((f"up_{ui}_attentions_{li}",))
    tb(("mid_attentions_0",))
    return paths


def ip_adapter_tree(sd, cfg):
    """An IP-Adapter checkpoint (h94/IP-Adapter `ip-adapter_sd15.bin`
    layout: `image_proj.*` + `ip_adapter.{i}.to_{k,v}_ip.weight`) -> (the
    flattened {path: array} that `enable_ip_adapter` reads from
    `ip_adapter.npz`, unmatched keys): `image_proj/...` and
    `unet_patch/<attn2 path>/ip_to_{k,v}/kernel`, the JAX tool's layout."""
    def a(v):
        return v.detach().cpu().numpy() if torch.is_tensor(v) \
            else np.asarray(v)
    flat, unmatched, entries = {}, [], {}
    names = {"image_proj.proj.weight": ("proj/kernel", True),
             "image_proj.proj.bias": ("proj/bias", False),
             "image_proj.norm.weight": ("norm/scale", False),
             "image_proj.norm.bias": ("norm/bias", False)}
    for k, v in sd.items():
        m = re.match(r"ip_adapter\.(\d+)\.to_([kv])_ip\.weight$", k)
        if k in names:
            path, transpose = names[k]
            flat[f"image_proj/{path}"] = a(v).T if transpose else a(v)
        elif m:
            entries.setdefault(int(m.group(1)), {})[m.group(2)] = a(v)
        elif not k.startswith(("ip_adapter.", "image_proj.")):
            unmatched.append(k)
    paths = _attn2_flax_paths(cfg)
    ids = sorted(entries)
    if len(ids) != len(paths):
        unmatched.append(f"ip_adapter entry count {len(ids)} != attn2 "
                         f"count {len(paths)}")
    for i, path in zip(ids, paths):
        base = "unet_patch/" + "/".join(path)
        flat[f"{base}/ip_to_k/kernel"] = entries[i]["k"].T
        flat[f"{base}/ip_to_v/kernel"] = entries[i]["v"].T
    return flat, unmatched


def _source_file(src):
    if os.path.isdir(src):
        for name in _SOURCE_FILES:
            p = os.path.join(src, name)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no checkpoint file under {src} (looked "
                                f"for {', '.join(_SOURCE_FILES)})")
    return src


def _target_name(subdir, path):
    st = path.endswith(".safetensors")
    if subdir == "lpips":
        return "lpips_vgg.safetensors" if st else "lpips_vgg.bin"
    base = os.path.basename(path)
    if base in _SOURCE_FILES:
        return base
    return "model.safetensors" if st else "pytorch_model.bin"


def check_kind(kind, path, tiny=False):
    """Loads the checkpoint at `path` into the port's module of `kind`
    (built on the meta device) and returns (unmatched keys, parameters
    the file lacks); None when no module of the port reads the kind."""
    from ..models.diffusion.weights import convert_ip_adapter, load_torch_state
    sd = load_torch_state(path)
    if kind == "ip_adapter":
        _, _, unmatched = convert_ip_adapter(sd, _unet_cfg(tiny))
        return unmatched, []
    if kind == "lpips":
        pat = re.compile(r"(features\.)?\d+\.(weight|bias)$|"
                         r"lin\d(\.model\.1\.weight)?$")
        unmatched = [k for k in sd if not pat.match(k)]
        convs = sum(1 for k, v in sd.items() if k.endswith("weight")
                    and not k.startswith("lin") and v.dim() == 4)
        heads = sum(1 for k in sd if k.startswith("lin"))
        missing = [] if convs >= 13 and heads >= 5 else [
            f"13 conv weights and 5 heads expected, found {convs} and "
            f"{heads}"]
        return unmatched, missing
    make, convert = _module(kind, tiny)
    if make is None:
        return None
    unmatched = []
    if convert is not None:
        sd, unmatched = convert(sd)
    sd = {k: v for k, v in sd.items() if "position_ids" not in k}
    with torch.device("meta"):
        model = make()
    own = model.state_dict()
    good, unmatched = {}, list(unmatched)
    for k, v in sd.items():
        if k not in own:
            unmatched.append(k)
        elif tuple(v.shape) != tuple(own[k].shape):
            unmatched.append(f"{k} {tuple(v.shape)} != "
                             f"{tuple(own[k].shape)}")
        else:
            good[k] = v
    missing, _ = model.load_state_dict(good, strict=False, assign=True)
    return unmatched, [k for k in missing if "num_batches_tracked" not in k]


def layout_entry(kind, subdir, src, out_dir, tiny=False):
    """One MANIFEST entry into `out_dir/subdir/`; returns (written path,
    unmatched, missing)."""
    from ..models.diffusion.weights import load_torch_state
    path = _source_file(src)
    dst_dir = os.path.join(out_dir, subdir)
    os.makedirs(dst_dir, exist_ok=True)
    if kind == "ip_adapter":
        flat, unmatched = ip_adapter_tree(load_torch_state(path),
                                          _unet_cfg(tiny))
        dst = os.path.join(dst_dir, "ip_adapter.npz")
        np.savez(dst, **flat)
        return dst, unmatched, []
    dst = os.path.join(dst_dir, _target_name(subdir, path))
    shutil.copyfile(path, dst)
    unmatched, missing = check_kind(kind, dst, tiny)
    return dst, unmatched, missing


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="checkpoint file / dir, or the zoo root with --all")
    ap.add_argument("--kind", choices=KINDS)
    ap.add_argument("--all", action="store_true",
                    help="lay out every MANIFEST entry found under --src")
    ap.add_argument("--out-dir", default="checkpoints")
    ap.add_argument("--tiny", action="store_true",
                    help="the runner's tiny_models widths")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.all:
        report = {}
        for name, (kind, subdir) in MANIFEST.items():
            src = os.path.join(args.src, name)
            if not os.path.exists(src):
                report[name] = "missing"
                continue
            if subdir not in READ_BY_PORT:
                report[name] = (f"not read by the port: no loader reads "
                                f"{subdir}/")
                continue
            try:
                dst, um, miss = layout_entry(kind, subdir, src,
                                             args.out_dir, args.tiny)
                report[name] = (f"ok: {os.path.relpath(dst, args.out_dir)} "
                                f"({len(um)} unmatched, {len(miss)} "
                                f"missing)")
                if um:
                    print(f"{name} unmatched (first 10): {um[:10]}")
            except Exception as e:  # keep going; report at the end
                report[name] = f"FAILED: {e}"
        print(json.dumps(report, indent=2))
        return report
    if not args.kind:
        raise SystemExit("--kind is required without --all")
    res = check_kind(args.kind, _source_file(args.src), args.tiny)
    if res is None:
        print(f"no module of the port reads kind {args.kind!r}")
        return None
    unmatched, missing = res
    print(f"{args.src} as {args.kind}: {len(unmatched)} unmatched keys, "
          f"{len(missing)} parameters missing")
    if unmatched:
        print("unmatched (first 10):", unmatched[:10])
    if missing:
        print("missing (first 10):", missing[:10])
    return {"unmatched": unmatched, "missing": missing}


if __name__ == "__main__":
    main()
