"""Pipelines of the port (the multi-view denoise steps so far)."""
