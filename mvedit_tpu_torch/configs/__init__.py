"""The port's copies of the repo's model configurations (the originals
under `configs/` import JAX)."""
