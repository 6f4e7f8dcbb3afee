"""SSDNeRF ShapeNet-cars configuration (the port's copy of
`configs/ssdnerf_cars.py`, which imports JAX).

The decoder matches StableSSDNeRF's cars config: a 12ch 40x40 triplane,
base MLP 36 -> 64, SH4 view directions, bound 0.5, 96 samples a ray. The
denoiser is the compact conv net over the (3, 12, 40, 40) latent with the
reference's widths: the planes fold into channels in the reference's
order (plane-major: channel p * C + c), a 128-wide conv stem, 4 residual
blocks (GroupNorm(32) with flax's eps 1e-6, silu, 3x3 conv, a timestep
projection, silu, 3x3 conv) and a conv back to 3 * C channels. Module
names are the flax module's, so `torch_state_from_flax(params,
"latent_denoiser")` bridges its params.
"""
import torch.nn.functional as F
from torch import nn

from ..models.diffusion.layers import Conv, Dense
from ..models.diffusion.norm import GroupNorm
from ..models.diffusion.unet import timestep_embedding
from ..models.ssdnerf import SSDNeRFConfig
from ..models.triplane import TriPlaneConfig
from ..models.volume_renderer import RenderConfig

__all__ = ["ssdnerf_config", "LatentDenoiser"]

ssdnerf_config = SSDNeRFConfig(
    code_shape=(3, 12, 40, 40),
    latent_shape=(3, 12, 40, 40),
    triplane=TriPlaneConfig(
        n_channels=12,
        plane_cfg=("yx", "yz", "xz"),
        flip_z=True,
        base_layers=(36, 64),
        density_layers=(64, 1),
        color_layers=(64, 3),
        dir_layers=(16, 64),
        bound=0.5),
    render=RenderConfig(num_samples=96, bound=0.5, grid_size=64),
    n_rays=4096,
    code_lr=0.04,
    decoder_lr=1e-3,
    denoiser_lr=1e-4,
)


class LatentDenoiser(nn.Module):
    """(B, 3, C, H, W) latent, (B,) timesteps -> (B, 3, C, H, W); `cond`
    is ignored (the denoiser is unconditional)."""

    def __init__(self, planes=3, channels=12, ch=128, n_blocks=4):
        super().__init__()
        pc = planes * channels
        self.ch, self.n_blocks = ch, n_blocks
        self.temb1 = Dense(ch, ch * 4)
        self.temb2 = Dense(ch * 4, ch * 4)
        self.conv_in = Conv(pc, ch, 3, padding=1)
        for i in range(n_blocks):
            self.add_module(f"norm{i}", GroupNorm(32, ch, 1e-6))
            self.add_module(f"conv{i}a", Conv(ch, ch, 3, padding=1))
            self.add_module(f"tproj{i}", Dense(ch * 4, ch))
            self.add_module(f"conv{i}b", Conv(ch, ch, 3, padding=1))
        self.conv_out = Conv(ch, pc, 3, padding=1)

    def forward(self, x, t, cond=None):
        B, P, C, H, W = x.shape
        temb = self.temb1(timestep_embedding(t, self.ch))
        temb = F.silu(self.temb2(F.silu(temb)))
        h = self.conv_in(x.reshape(B, P * C, H, W))
        for i in range(self.n_blocks):
            r = getattr(self, f"conv{i}a")(F.silu(
                getattr(self, f"norm{i}")(h)))
            r = r + getattr(self, f"tproj{i}")(temb)[:, :, None, None]
            h = h + getattr(self, f"conv{i}b")(F.silu(r))
        return self.conv_out(h).reshape(B, P, C, H, W)
