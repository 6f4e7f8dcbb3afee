"""Checkpoint loading and the weight bridge.

Counterpart of `mvedit_tpu/models/diffusion/weights.py`. The port's modules
use diffusers' and transformers' key names, so a checkpoint's state dict
goes into them with `load_state_dict` as it is:

- `load_torch_state(path)`: a `.safetensors`, `.bin` or `.pt` file (or a
  `huggingface://` reference to one in the local cache) -> {key: tensor}.
  Safetensors files are read without the `safetensors` package: an 8-byte
  little-endian header length, a JSON header of dtypes, shapes and byte
  ranges, then the raw little-endian data.
- `convert_clip_vision(sd)`: a transformers CLIP vision state dict -> the
  keys `CLIPVisionModel` takes, and the unmatched ones.
- `convert_ip_adapter(sd, cfg)`: an IP-Adapter checkpoint (`image_proj.*` +
  `ip_adapter.{i}.to_{k,v}_ip.weight`) -> (ImageProjModel state, the UNet's
  `ip_to_k` / `ip_to_v` state, unmatched).
- `torch_state_from_flax(tree, kind)`: the exact inverse of the reference's
  flax converters (`convert_unet`, `convert_controlnet`, `convert_vae`,
  `convert_clip_text`, `convert_clip_vision`, the IP-Adapter trees of
  its `ip_adapter.npz`, and the perception nets' `convert_tracer`,
  `convert_dpt`, `convert_loftr`): applied to their output it gives the
  state dict they were converted from, in the port's keys;
  `tracer_state_from_flax`, `dpt_state_from_flax` and
  `loftr_state_from_flax` name the last three.

Layout rules (inverted): kernel (I, O) -> weight (O, I); kernel HWIO ->
weight OIHW; scale -> weight; embedding -> weight.
"""
import json
import re

import numpy as np
import torch

__all__ = ["torch_state_from_flax", "tracer_state_from_flax",
           "dpt_state_from_flax", "loftr_state_from_flax", "flatten",
           "load_torch_state", "read_safetensors", "convert_clip_vision", "convert_ip_adapter",
           "attn2_keys"]

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path):
    """{key: tensor} of a `.safetensors` file, read by hand."""
    with open(path, "rb") as f:
        data = f.read()
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    base = 8 + n
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: dtype {info['dtype']} of {key!r} "
                             f"is not supported")
        a, b = info["data_offsets"]
        dt = _ST_DTYPES[info["dtype"]]
        # a copy of the tensor's bytes: its offset need not be aligned
        buf = bytearray(data[base + a:base + b])
        t = torch.frombuffer(buf, dtype=dt) if buf else \
            torch.empty((0,), dtype=dt)
        out[key] = t.reshape(info["shape"])
    return out


def load_torch_state(path):
    """A `.safetensors` / `.bin` / `.pt` checkpoint -> {key: tensor} on the
    CPU; a `state_dict` entry is unwrapped. Accepts `huggingface://`
    references, resolved against the local cache (`utils/hub.py`)."""
    from ...utils.hub import is_hub_path, resolve_checkpoint
    if is_hub_path(path):
        path = resolve_checkpoint(path)
    if str(path).endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def convert_clip_vision(sd):
    """A transformers CLIP vision state dict (`vision_model.*`,
    `visual_projection.weight`) -> (the state `CLIPVisionModel` takes,
    unmatched keys). Position-id buffers are dropped, as the reference
    drops them."""
    state, unmatched = {}, []
    for k, v in sd.items():
        if "position_ids" in k:
            continue
        if k.startswith(("vision_model.", "visual_projection.")):
            state[k] = v
        else:
            unmatched.append(k)
    return state, unmatched


def attn2_keys(cfg):
    """The port's key prefix of each UNet cross-attention, in the order the
    IP-Adapter checkpoint numbers its `ip_adapter.{i}` entries (diffusers'
    attention processors: down blocks, then up blocks, then mid)."""
    keys = []
    n = len(cfg.block_out_channels)
    depth = getattr(cfg, "transformer_depth", 1)

    def tb(base):
        keys.extend(f"{base}.transformer_blocks.{d}.attn2"
                    for d in range(depth))
    for bi in range(n):
        if cfg.attn_down[bi]:
            for li in range(cfg.layers_per_block):
                tb(f"down_blocks.{bi}.attentions.{li}")
    for ui, bi in enumerate(reversed(range(n))):
        if cfg.attn_down[bi]:
            for li in range(cfg.layers_per_block + 1):
                tb(f"up_blocks.{ui}.attentions.{li}")
    tb("mid_block.attentions.0")
    return keys


def convert_ip_adapter(sd, cfg):
    """An IP-Adapter checkpoint (h94/IP-Adapter `ip-adapter_sd15.bin`
    layout) -> (ImageProjModel state, UNet state of the `ip_to_k` /
    `ip_to_v` branches, unmatched). The `ip_adapter.{i}` entries are
    numbered over all attention processors; they go to the
    cross-attentions in `attn2_keys` order."""
    proj, unmatched, entries = {}, [], {}
    for k, v in sd.items():
        m = re.match(r"ip_adapter\.(\d+)\.to_([kv])_ip\.weight$", k)
        if k.startswith("image_proj."):
            proj[k[len("image_proj."):]] = v
        elif m:
            entries.setdefault(int(m.group(1)), {})[m.group(2)] = v
        else:
            unmatched.append(k)
    keys = attn2_keys(cfg)
    ids = sorted(entries)
    if len(ids) != len(keys):
        unmatched.append(f"ip_adapter entry count {len(ids)} != "
                         f"cross-attention count {len(keys)}")
    unet = {}
    for i, key in zip(ids, keys):
        unet[f"{key}.ip_to_k.weight"] = entries[i]["k"]
        unet[f"{key}.ip_to_v.weight"] = entries[i]["v"]
    return proj, unet, unmatched

# inner attention-tower paths (the reference's _ATTN_INNER, inverted)
_ATTN_INNER = [
    (r"transformer_blocks_(\d+)/(attn[12])/to_out_0",
     r"transformer_blocks.\1.\2.to_out.0"),
    (r"transformer_blocks_(\d+)/(attn[12])/(to_[qkv])",
     r"transformer_blocks.\1.\2.\3"),
    (r"transformer_blocks_(\d+)/(attn2)/(ip_to_[kv])",
     r"transformer_blocks.\1.\2.\3"),
    (r"transformer_blocks_(\d+)/ff/net_0_proj",
     r"transformer_blocks.\1.ff.net.0.proj"),
    (r"transformer_blocks_(\d+)/ff/net_2", r"transformer_blocks.\1.ff.net.2"),
    (r"transformer_blocks_(\d+)/(norm[123])", r"transformer_blocks.\1.\2"),
    (r"(proj_in|proj_out|norm)", r"\1"),
]

_UNET_BODY = [
    (r"time_embedding_linear_(\d)", r"time_embedding.linear_\1"),
    (r"(conv_in|conv_norm_out|conv_out)", r"\1"),
    (r"down_(\d+)_resnets_(\d+)/(\w+)", r"down_blocks.\1.resnets.\2.\3"),
    (r"down_(\d+)_downsample/conv", r"down_blocks.\1.downsamplers.0.conv"),
    (r"up_(\d+)_resnets_(\d+)/(\w+)", r"up_blocks.\1.resnets.\2.\3"),
    (r"up_(\d+)_upsample/conv", r"up_blocks.\1.upsamplers.0.conv"),
    (r"mid_resnets_(\d+)/(\w+)", r"mid_block.resnets.\1.\2"),
    (r"(down|up)_(\d+)_attentions_(\d+)/(.+)",
     lambda m: f"{m[1]}_blocks.{m[2]}.attentions.{m[3]}."
               + _inner(m[4])),
    (r"mid_attentions_(\d+)/(.+)",
     lambda m: f"mid_block.attentions.{m[1]}." + _inner(m[2])),
]

_CONTROLNET_EXTRA = [
    (r"cond_conv_in", r"controlnet_cond_embedding.conv_in"),
    (r"cond_blocks_(\d+)", r"controlnet_cond_embedding.blocks.\1"),
    (r"cond_conv_out", r"controlnet_cond_embedding.conv_out"),
    (r"controlnet_down_blocks_(\d+)", r"controlnet_down_blocks.\1"),
    (r"controlnet_mid_block", r"controlnet_mid_block"),
]

_VAE = [
    (r"(encoder|decoder)/(conv_in|conv_norm_out|conv_out)", r"\1.\2"),
    (r"encoder/down_(\d+)_resnets_(\d+)/(\w+)",
     r"encoder.down_blocks.\1.resnets.\2.\3"),
    (r"encoder/down_(\d+)_downsample",
     r"encoder.down_blocks.\1.downsamplers.0.conv"),
    (r"decoder/up_(\d+)_resnets_(\d+)/(\w+)",
     r"decoder.up_blocks.\1.resnets.\2.\3"),
    (r"decoder/up_(\d+)_upsample", r"decoder.up_blocks.\1.upsamplers.0.conv"),
    (r"(encoder|decoder)/mid_resnets_(\d+)/(\w+)",
     r"\1.mid_block.resnets.\2.\3"),
    (r"(encoder|decoder)/mid_attentions_0/(group_norm|to_q|to_k|to_v)",
     r"\1.mid_block.attentions.0.\2"),
    (r"(encoder|decoder)/mid_attentions_0/to_out_0",
     r"\1.mid_block.attentions.0.to_out.0"),
    (r"encoder/quant_conv", r"quant_conv"),
    (r"decoder/post_quant_conv", r"post_quant_conv"),
]

_CLIP_TEXT = [
    (r"layers_(\d+)/([qkv]_proj|out_proj)",
     r"text_model.encoder.layers.\1.self_attn.\2"),
    (r"layers_(\d+)/layer_norm([12])",
     r"text_model.encoder.layers.\1.layer_norm\2"),
    (r"layers_(\d+)/fc([12])", r"text_model.encoder.layers.\1.mlp.fc\2"),
    (r"token_embedding", r"text_model.embeddings.token_embedding"),
    (r"final_layer_norm", r"text_model.final_layer_norm"),
]

_CLIP_VISION = [
    (r"layers_(\d+)/([qkv]_proj|out_proj)",
     r"vision_model.encoder.layers.\1.self_attn.\2"),
    (r"layers_(\d+)/layer_norm([12])",
     r"vision_model.encoder.layers.\1.layer_norm\2"),
    (r"layers_(\d+)/fc([12])", r"vision_model.encoder.layers.\1.mlp.fc\2"),
    (r"patch_embedding", r"vision_model.embeddings.patch_embedding"),
    (r"(pre_layrnorm|post_layernorm)", r"vision_model.\1"),
    (r"visual_projection", r"visual_projection"),
]

_IMAGE_PROJ = [(r"(proj|norm)", r"\1")]

# the perception nets: flax paths -> the reference checkpoints' own keys
_TRACER = [
    (r"encoder/stem_conv", r"encoder._conv_stem"),
    (r"encoder/stem_bn", r"encoder._bn0"),
    (r"encoder/blocks_(\d+)/(\w+)", r"encoder._blocks.\1._\2"),
    (r"(rfb\d)/(branch\d)_(\d)/(conv|bn)", r"\1.\2.\3.\4"),
    (r"(rfb\d)/(conv_cat|conv_res)/(conv|bn)", r"\1.\2.\3"),
    (r"agg/UAM/norm_bn", r"agg.UAM.norm.0"),
    (r"agg/UAM/(\w+)", r"agg.UAM.\1"),
    (r"agg/(\w+)/(conv|bn)", r"agg.\1.\2"),
    (r"(ObjectAttention\d)/DWSConv/depthwise", r"\1.DWSConv.DWConv"),
    (r"(ObjectAttention\d)/DWSConv/bn1", r"\1.DWSConv.bn"),
    (r"(ObjectAttention\d)/DWSConv/pointwise", r"\1.DWSConv.PWConv"),
    (r"(ObjectAttention\d)/DWSConv/bn2", r"\1.DWSConv.bn2"),
    (r"(ObjectAttention\d)/(DWConv\d)_0/conv", r"\1.\2.0.DWConv"),
    (r"(ObjectAttention\d)/(DWConv\d)_(\d)/(conv|bn)", r"\1.\2.\3.\4"),
    (r"(ObjectAttention\d)/conv1/(conv|bn)", r"\1.conv1.\2"),
]

_BB = "pretrained.model.patch_embed.backbone"
_DPT = [
    (r"backbone/stem_conv", _BB + ".stem.conv"),
    (r"backbone/stem_norm/gn", _BB + ".stem.norm"),
    (r"backbone/stage(\d)_(\d+)/downsample_(conv|norm)(/gn)?",
     _BB + r".stages.\1.blocks.\2.downsample.\3"),
    (r"backbone/stage(\d)_(\d+)/(\w+?)(/gn)?",
     _BB + r".stages.\1.blocks.\2.\3"),
    (r"patch_embed", r"pretrained.model.patch_embed.proj"),
    (r"vit_(\d+)/(norm[12])", r"pretrained.model.blocks.\1.\2"),
    (r"vit_(\d+)/(qkv|proj)", r"pretrained.model.blocks.\1.attn.\2"),
    (r"vit_(\d+)/(fc[12])", r"pretrained.model.blocks.\1.mlp.\2"),
    (r"readout(\d)", r"pretrained.act_postprocess\1.0.project.0"),
    (r"postproc3", r"pretrained.act_postprocess3.3"),
    (r"postproc4a", r"pretrained.act_postprocess4.3"),
    (r"postproc4b", r"pretrained.act_postprocess4.4"),
    (r"(layer\d_rn)", r"scratch.\1"),
    (r"fusion(\d)/out_conv", r"scratch.refinenet\1.out_conv"),
    (r"fusion(\d)/rcu(\d)/(conv\d)",
     r"scratch.refinenet\1.resConfUnit\2.\3"),
    (r"head1", r"scratch.output_conv.0"),
    (r"head2", r"scratch.output_conv.2"),
    (r"head3", r"scratch.output_conv.4"),
]

_LOFTR = [
    (r"backbone/(conv1|bn1)", r"backbone.\1"),
    (r"backbone/layer(\d)_(\d)/downsample_conv",
     r"backbone.layer\1.\2.downsample.0"),
    (r"backbone/layer(\d)_(\d)/downsample_bn",
     r"backbone.layer\1.\2.downsample.1"),
    (r"backbone/layer(\d)_(\d)/(\w+)", r"backbone.layer\1.\2.\3"),
    (r"backbone/(layer\d_outconv)", r"backbone.\1"),
    (r"backbone/(layer\d_outconv2)/conv1", r"backbone.\1.0"),
    (r"backbone/(layer\d_outconv2)/bn", r"backbone.\1.1"),
    (r"backbone/(layer\d_outconv2)/conv2", r"backbone.\1.3"),
    (r"coarse_(\d+)/mlp([02])", r"loftr_coarse.layers.\1.mlp.\2"),
    (r"coarse_(\d+)/(\w+)", r"loftr_coarse.layers.\1.\2"),
    (r"fine_(\d+)/mlp([02])", r"loftr_fine.layers.\1.mlp.\2"),
    (r"fine_(\d+)/(\w+)", r"loftr_fine.layers.\1.\2"),
    (r"(down_proj|merge_feat)", r"fine_preprocess.\1"),
]

_RESAMPLER = [
    (r"layers_(\d+)_attn/(norm1|norm2|to_q|to_kv|to_out)",
     r"layers.\1.attn.\2"),
    (r"layers_(\d+)_ff_(norm|1|2)", r"layers.\1.ff_\2"),
    (r"(proj_in|proj_out|norm_out)", r"\1"),
]

# params that are no module's kernel / scale / bias: flax path -> key
_RAW = {
    "clip_text": {"position_embedding":
                  "text_model.embeddings.position_embedding.weight"},
    "clip_vision": {"position_embedding":
                    "vision_model.embeddings.position_embedding.weight",
                    "class_embedding":
                    "vision_model.embeddings.class_embedding"},
    "resampler": {"latents": "latents"},
    "dpt": {"cls_token": "pretrained.model.cls_token",
            "pos_embed": "pretrained.model.pos_embed"},
}

# modules named as their flax counterparts: `a/b` -> `a.b`
_SAME_NAMES = [(r"(\w+)/(\w+)", r"\1.\2"), (r"(\w+)", r"\1")]

_RULES = {
    "unet": _UNET_BODY,
    "controlnet": _CONTROLNET_EXTRA + _UNET_BODY,
    "vae": _VAE,
    "clip_text": _CLIP_TEXT,
    "clip_vision": _CLIP_VISION,
    "image_proj": _IMAGE_PROJ,
    "resampler": _RESAMPLER,
    "tracer": _TRACER,
    "dpt": _DPT,
    "loftr": _LOFTR,
    "latent_denoiser": _SAME_NAMES,
    "vae_preproc": _SAME_NAMES,
}


def _apply(rules, path):
    for pat, repl in rules:
        m = re.fullmatch(pat, path)
        if m:
            return repl(m) if callable(repl) else m.expand(repl)
    raise KeyError(f"no bridge rule for flax module path {path!r}")


def _inner(path):
    return _apply(_ATTN_INNER, path)


def flatten(tree, prefix=""):
    """Nested dict -> {'a/b/c': leaf}."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, p))
        else:
            out[p] = v
    return out


def _leaf(name, arr):
    if name == "kernel":
        if arr.ndim == 4:   # HWIO -> OIHW
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:   # (I, O) -> (O, I)
            return "weight", arr.T
    if name in ("scale", "embedding"):
        return "weight", arr
    if name == "bias":
        return "bias", arr
    if name in ("mean", "var"):        # inference BatchNorm statistics
        return f"running_{name}", arr
    raise KeyError(f"unexpected flax leaf {name!r} of shape {arr.shape}")


def torch_state_from_flax(tree, kind):
    """Flax params tree (numpy-convertible leaves) of `kind` in {'unet',
    'controlnet', 'vae', 'clip_text', 'clip_vision', 'image_proj',
    'resampler', 'tracer', 'dpt', 'loftr', 'latent_denoiser' (the SSDNeRF
    cars denoiser), 'vae_preproc' (`VAEDecoderPreproc`)} -> {port key:
    torch.Tensor}.
    The perception nets' keys are their reference checkpoints' (what
    `convert_tracer` / `convert_dpt` / `convert_loftr` read); the DPT's
    unused `refinenet4.resConfUnit1` and final ViT norm, which the flax
    tree lacks, are absent."""
    rules = _RULES[kind]
    raw = _RAW.get(kind, {})
    state = {}
    for path, val in flatten(tree).items():
        arr = np.asarray(val)
        if path in raw:
            key = raw[path]
        else:
            module, leaf = path.rsplit("/", 1)
            name, arr = _leaf(leaf, arr)
            key = f"{_apply(rules, module)}.{name}"
        # np.array copies: the leaves may be read-only views of JAX arrays
        state[key] = torch.from_numpy(np.array(arr))
    return state


def tracer_state_from_flax(tree):
    """TRACER-B7's flax params -> the port's (the checkpoint's) keys."""
    return torch_state_from_flax(tree, "tracer")


def dpt_state_from_flax(tree):
    """The DPT normal model's flax params -> the port's keys."""
    return torch_state_from_flax(tree, "dpt")


def loftr_state_from_flax(tree):
    """LoFTR's flax params -> the port's keys."""
    return torch_state_from_flax(tree, "loftr")
