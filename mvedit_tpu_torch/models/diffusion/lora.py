"""LoRA adapters on a model's parameters (counterpart of
`mvedit_tpu/models/diffusion/lora.py`).

LoRA lives apart from the model, as {module path: {"a": (r, in), "b":
(out, r)}} (the path is the dotted name of a linear layer, its weight
`path + ".weight"`), and `merge_lora` folds `scale * B @ A` into the
weights, in their own dtype (the reference merges into its f32 kernels
before the layers cast to their compute dtype; so does the port).
`LoRAParams` holds the factors as an `nn.Module`'s parameters named
`{path}.a` / `{path}.b`, so that a wrapper can train, decay and
checkpoint them alone (`configs/stablessdnerf_cars_lpips.py`).
"""
import torch
from torch import nn

__all__ = ["init_lora", "lora_apply_delta", "merge_lora",
           "lora_params_from_flax", "LoRAParams"]

_MATCH = ("to_q", "to_k", "to_v", "to_out")


def init_lora(generator, params, rank=8, match=None, std=0.01):
    """{path: {"a": N(0, std^2) (rank, in), "b": zeros (out, rank)}} for
    every 2-D `path.weight` of `params` ({name: tensor}, in its order)
    whose path contains one of `match` (None: the attention projections
    to_q / to_k / to_v / to_out). `a` is drawn on the generator's device
    and moved to the weight's."""
    keys = match or _MATCH
    lora = {}
    for name, w in params.items():
        if not name.endswith(".weight") or w.dim() != 2:
            continue
        path = name[:-len(".weight")]
        if not any(m in path for m in keys):
            continue
        d_out, d_in = w.shape
        dev = generator.device if generator is not None else w.device
        lora[path] = {
            "a": (torch.randn((rank, d_in), generator=generator, device=dev)
                  * std).to(w.device),
            "b": torch.zeros((d_out, rank), device=w.device),
        }
    return lora


def lora_apply_delta(params, lora, scale=1.0, sign=1.0):
    """A new {name: tensor} with `sign * scale * B @ A` added to each LoRA
    path's weight ((out, in), cast to the weight's dtype); the other
    entries are the same tensors."""
    out = dict(params)
    for path, ab in lora.items():
        w = params[path + ".weight"]
        out[path + ".weight"] = w + ((ab["b"] @ ab["a"]) * scale
                                     * sign).to(w.dtype)
    return out


def merge_lora(params, lora, scale=1.0):
    """Fold LoRA into the weights; returns a new {name: tensor}."""
    return lora_apply_delta(params, lora, scale=scale, sign=1.0)


def lora_params_from_flax(lora, kind="unet"):
    """The reference's {flax path tuple: {"a", "b"}} (module paths such as
    (`down_0_attentions_0`, `transformer_blocks_0`, `attn1`, `to_out_0`))
    -> {the port's dotted path: {"a", "b"}} through the weight bridge's
    rules for `kind`; the factors keep their layouts, (r, in) and
    (out, r), which are torch's."""
    import numpy as np
    from .weights import _RULES, _apply
    return {_apply(_RULES[kind], "/".join(path)): {
        k: torch.from_numpy(np.array(v)) for k, v in ab.items()}
        for path, ab in lora.items()}


class LoRAParams(nn.Module):
    """LoRA factors as parameters `{path}.a` / `{path}.b` (one child module
    per path component); `factors()` gives them back as {path: {"a",
    "b"}}, reading the module's current tensors (those that
    `torch.func.functional_call` put in place included)."""

    def __init__(self, lora):
        super().__init__()
        self.paths = list(lora)
        for path, ab in lora.items():
            mod = self
            for part in path.split("."):
                if part not in mod._modules:
                    mod.add_module(part, nn.Module())
                mod = mod._modules[part]
            mod.a = nn.Parameter(ab["a"])
            mod.b = nn.Parameter(ab["b"])

    def _leaf(self, path):
        mod = self
        for part in path.split("."):
            mod = mod._modules[part]
        return mod

    def factors(self):
        return {p: {"a": self._leaf(p).a, "b": self._leaf(p).b}
                for p in self.paths}
