"""Models of the port: the diffusion stack, the field, the losses, the mesh
stack and the mesh fit."""
