"""The perception nets of image-to-3D: TRACER-B7 (foreground masks),
Omnidata's DPT-hybrid (normals) and LoFTR (matches for the input view's
pose). SAM waits for its slice."""
from .efficientnet import EfficientEncoderB7
from .tracer import TracerDecoder, convert_tracer_state, tracer_segment
from .dpt import DPTNormalModel, convert_dpt_state
from .loftr import LoFTR, convert_loftr_state, match_images

__all__ = ["EfficientEncoderB7", "TracerDecoder", "tracer_segment",
           "convert_tracer_state", "DPTNormalModel", "convert_dpt_state",
           "LoFTR", "match_images", "convert_loftr_state"]
