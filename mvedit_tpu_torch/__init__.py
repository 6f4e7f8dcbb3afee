"""mvedit_tpu_torch: the PyTorch / CUDA port of mvedit_tpu for NVIDIA Hopper.

The JAX package `mvedit_tpu` is the reference; each module here sits at the
same path as its counterpart there. Public functions keep the reference's
layouts: NHWC images and latents, (B, L, H, D) attention tensors.
"""
