from .attention import AttnMode, RefStates
from .unet import UNetConfig, UNet2DCondition, SD15_UNET, SD21_UNET
from .vae import VAEConfig, AutoencoderKL, SD_VAE
from .clip import CLIPTextConfig, CLIPTextModel, SD15_TEXT
from .controlnet import ControlNet, apply_multi_controlnet
from . import schedulers

__all__ = [
    "AttnMode", "RefStates", "UNetConfig", "UNet2DCondition", "SD15_UNET",
    "SD21_UNET",
    "VAEConfig", "AutoencoderKL", "SD_VAE",
    "CLIPTextConfig", "CLIPTextModel", "SD15_TEXT",
    "ControlNet", "apply_multi_controlnet", "schedulers",
]
