"""Models of the port (the diffusion stack so far)."""
