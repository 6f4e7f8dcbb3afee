"""Pipelines of the port: the multi-view denoise steps, the MVEdit 3D
pipeline, the re-texturing pipeline, texture superres and Zero123++."""
from .denoise import (DenoiseModels, make_noise_pred_1pass,
                      make_noise_pred_2pass, make_chunked_noise_pred_1pass,
                      make_chunked_noise_pred_2pass)
from .mvedit_3d import GeneratorDraws, MVEdit3DConfig, MVEdit3DPipeline
from .texture import (TextureConfig, TexturePipeline, camera_dense_weighting,
                      make_texture_fit)
from .superres import SuperResConfig, TextureSuperResPipeline
from .zero123plus import (Zero123PlusConfig, Zero123PlusDraws,
                          Zero123PlusPipeline)

__all__ = [
    "DenoiseModels", "make_noise_pred_1pass", "make_noise_pred_2pass",
    "make_chunked_noise_pred_1pass", "make_chunked_noise_pred_2pass",
    "GeneratorDraws", "MVEdit3DConfig", "MVEdit3DPipeline",
    "TextureConfig", "TexturePipeline", "camera_dense_weighting",
    "make_texture_fit", "SuperResConfig", "TextureSuperResPipeline",
    "Zero123PlusConfig", "Zero123PlusDraws", "Zero123PlusPipeline",
]
