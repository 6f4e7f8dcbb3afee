"""`clip` with the reference's gradient at the bounds.

`jnp.clip(x, lo, hi)` is `minimum(maximum(x, lo), hi)`, whose gradient at
x == lo or x == hi is split evenly between the tied operands (0.5), where
`torch.clamp` passes it whole. A mesh vertex that projects exactly onto a
pixel boundary puts a soft-alpha term exactly on its bound, so the
differentiable paths of the port clip this way to keep their gradients the
reference's.
"""
import torch

__all__ = ["clip"]


def clip(x, lo=None, hi=None):
    """`minimum(maximum(x, lo), hi)` (either bound may be None)."""
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                             device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                             device=x.device))
    return x
