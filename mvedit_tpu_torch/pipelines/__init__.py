"""Pipelines of the port: the multi-view denoise steps, the MVEdit 3D
pipeline and the re-texturing pipeline."""
from .denoise import (DenoiseModels, make_noise_pred_1pass,
                      make_noise_pred_2pass, make_chunked_noise_pred_1pass,
                      make_chunked_noise_pred_2pass)
from .mvedit_3d import GeneratorDraws, MVEdit3DConfig, MVEdit3DPipeline
from .texture import (TextureConfig, TexturePipeline, camera_dense_weighting,
                      make_texture_fit)

__all__ = [
    "DenoiseModels", "make_noise_pred_1pass", "make_noise_pred_2pass",
    "make_chunked_noise_pred_1pass", "make_chunked_noise_pred_2pass",
    "GeneratorDraws", "MVEdit3DConfig", "MVEdit3DPipeline",
    "TextureConfig", "TexturePipeline", "camera_dense_weighting",
    "make_texture_fit",
]
