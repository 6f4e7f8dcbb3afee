"""The perception nets of image-to-3D: TRACER-B7 (foreground masks),
SAM (their box-prompted refinement), Omnidata's DPT-hybrid (normals) and
LoFTR (matches for the input view's pose)."""
from .efficientnet import EfficientEncoderB7
from .tracer import TracerDecoder, convert_tracer_state, tracer_segment
from .dpt import DPTNormalModel, convert_dpt_state
from .loftr import LoFTR, convert_loftr_state, match_images
from .sam import (SAM_TINY, SAM_VIT_H, SAMConfig, SamModel, sam_predict_box,
                  sam_preprocess, sam_state_from_flax)

__all__ = ["EfficientEncoderB7", "TracerDecoder", "tracer_segment",
           "convert_tracer_state", "DPTNormalModel", "convert_dpt_state",
           "LoFTR", "match_images", "convert_loftr_state", "SAMConfig",
           "SAM_VIT_H", "SAM_TINY", "SamModel", "sam_preprocess",
           "sam_predict_box", "sam_state_from_flax"]
