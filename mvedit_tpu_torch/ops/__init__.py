"""Tensor ops of the port: scatter-add, activations, tone curve, the dense
feature grid, the flash-attention API on (BH, L, D) tensors, image ops, and
the Morton codes and `fill_holes` (re-exported here, as the JAX package's
`ops` does)."""
from .image import fill_holes
from .morton import morton3d, morton3d_invert, packbits

__all__ = ["fill_holes", "morton3d", "morton3d_invert", "packbits"]
