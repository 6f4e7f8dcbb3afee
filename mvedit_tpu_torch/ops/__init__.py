"""Tensor ops of the port: scatter-add, activations, tone curve, the dense
feature grid and the flash-attention API on (BH, L, D) tensors."""
