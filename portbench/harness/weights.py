"""The benchmark's weights: drawn from the run's seed on the device, one
`torch.randn` per model, in bfloat16 (the type the full-size models serve
in).

A model's matrices (every parameter of rank >= 2, in the sorted order of
their names) take consecutive slices of one draw, scaled by fan_in^-0.5;
biases are 0 and other vectors (norm scales) 1. The stream depends only on
the seed, the model's tag and its parameters' names and shapes, so the
reference, whose modules carry the same names, draws the same values.
"""
import zlib

import torch

__all__ = ["model_seed", "seed_params_"]


def model_seed(seed, tag):
    return (int(seed) * 1000003 + zlib.crc32(tag.encode())) % (1 << 63)


@torch.no_grad()
def seed_params_(module, seed, tag, device, only=None):
    """Fill `module`'s parameters in place (see the module doc); with
    `only`, a predicate on names, those parameters alone."""
    params = sorted(((n, p) for n, p in module.named_parameters()
                     if only is None or only(n)), key=lambda kv: kv[0])
    mats = [p for _, p in params if p.dim() >= 2]
    total = sum(p.numel() for p in mats)
    gen = torch.Generator(device=device)
    gen.manual_seed(model_seed(seed, tag))
    buf = torch.randn(total, generator=gen, device=device,
                      dtype=torch.bfloat16) if total else None
    off = 0
    for name, p in params:
        if p.dim() >= 2:
            n = p.numel()
            w = buf[off:off + n].view(p.shape) * (p[0].numel() ** -0.5)
            p.copy_(w)
            off += n
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
    return module
