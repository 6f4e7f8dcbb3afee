"""Weight bridge: a flax parameter tree -> a diffusers-keyed state dict.

`torch_state_from_flax(tree, kind)` is the exact inverse of the reference's
checkpoint converters (`mvedit_tpu/models/diffusion/weights.py`
`convert_unet`, `convert_controlnet`, `convert_vae`, `convert_clip_text`):
applied to its output they give back the same tree. The port's modules use
diffusers' key names, so `module.load_state_dict(state)` takes the result
as it is.

Layout rules (inverted): kernel (I, O) -> weight (O, I); kernel HWIO ->
weight OIHW; scale -> weight; embedding -> weight.
"""
import re

import numpy as np
import torch

__all__ = ["torch_state_from_flax", "flatten"]

# inner attention-tower paths (the reference's _ATTN_INNER, inverted)
_ATTN_INNER = [
    (r"transformer_blocks_(\d+)/(attn[12])/to_out_0",
     r"transformer_blocks.\1.\2.to_out.0"),
    (r"transformer_blocks_(\d+)/(attn[12])/(to_[qkv])",
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

_RULES = {
    "unet": _UNET_BODY,
    "controlnet": _CONTROLNET_EXTRA + _UNET_BODY,
    "vae": _VAE,
    "clip_text": _CLIP_TEXT,
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
    raise KeyError(f"unexpected flax leaf {name!r} of shape {arr.shape}")


def torch_state_from_flax(tree, kind):
    """Flax params tree (numpy-convertible leaves) of `kind` in {'unet',
    'controlnet', 'vae', 'clip_text'} -> {diffusers key: torch.Tensor}."""
    rules = _RULES[kind]
    state = {}
    for path, val in flatten(tree).items():
        arr = np.asarray(val)
        if kind == "clip_text" and path == "position_embedding":
            key = "text_model.embeddings.position_embedding.weight"
        else:
            module, leaf = path.rsplit("/", 1)
            name, arr = _leaf(leaf, arr)
            key = f"{_apply(rules, module)}.{name}"
        # np.array copies: the leaves may be read-only views of JAX arrays
        state[key] = torch.from_numpy(np.array(arr))
    return state
