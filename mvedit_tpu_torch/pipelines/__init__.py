"""Pipelines of the port: the multi-view denoise steps and the mesh phase of
the MVEdit 3D pipeline."""
