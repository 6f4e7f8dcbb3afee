"""Pipelines of the port: the multi-view denoise steps, the MVEdit 3D
pipeline, the re-texturing pipeline, texture superres, Zero123++, legacy
Zero123 and the image pre- and post-processing."""
from .denoise import (DenoiseModels, make_noise_pred_1pass,
                      make_noise_pred_2pass, make_chunked_noise_pred_1pass,
                      make_chunked_noise_pred_2pass)
from .mvedit_3d import GeneratorDraws, MVEdit3DConfig, MVEdit3DPipeline
from .texture import (TextureConfig, TexturePipeline, camera_dense_weighting,
                      make_texture_fit)
from .superres import SuperResConfig, TextureSuperResPipeline
from .zero123plus import (Zero123PlusConfig, Zero123PlusDraws,
                          Zero123PlusPipeline)
from .zero123 import (CLIPCameraProjection, Zero123Config, Zero123Draws,
                      Zero123Pipeline, camera_embedding)
from .preproc import (do_segmentation, pad_rgba_image,
                      zero123plus_postprocess)

__all__ = [
    "DenoiseModels", "make_noise_pred_1pass", "make_noise_pred_2pass",
    "make_chunked_noise_pred_1pass", "make_chunked_noise_pred_2pass",
    "GeneratorDraws", "MVEdit3DConfig", "MVEdit3DPipeline",
    "TextureConfig", "TexturePipeline", "camera_dense_weighting",
    "make_texture_fit", "SuperResConfig", "TextureSuperResPipeline",
    "Zero123PlusConfig", "Zero123PlusDraws", "Zero123PlusPipeline",
    "CLIPCameraProjection", "Zero123Config", "Zero123Draws",
    "Zero123Pipeline", "camera_embedding", "do_segmentation",
    "pad_rgba_image", "zero123plus_postprocess",
]
