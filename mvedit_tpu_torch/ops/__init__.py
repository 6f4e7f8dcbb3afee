"""Tensor ops of the port: scatter-add, activations, tone curve, the dense
feature grid, the flash-attention API on (BH, L, D) tensors, and the Morton
codes (re-exported here, as the JAX package's `ops` does)."""
from .morton import morton3d, morton3d_invert, packbits

__all__ = ["morton3d", "morton3d_invert", "packbits"]
