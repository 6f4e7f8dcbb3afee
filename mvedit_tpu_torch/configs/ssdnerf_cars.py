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

`train_config` is the reference's training recipe (4 scenes a step, 40000
iterations) and `build_denoiser(generator, device)` the seeded denoiser
that `tools/train_ssdnerf.py` trains. The imports are absolute, so the
training tools can load this file, or a copy of it, by its path.
"""
import torch
import torch.nn.functional as F
from torch import nn

from mvedit_tpu_torch.models.diffusion.layers import Conv, Dense
from mvedit_tpu_torch.models.diffusion.norm import GroupNorm
from mvedit_tpu_torch.models.diffusion.unet import timestep_embedding
from mvedit_tpu_torch.models.ssdnerf import SSDNeRFConfig
from mvedit_tpu_torch.models.triplane import TriPlaneConfig
from mvedit_tpu_torch.models.volume_renderer import RenderConfig

__all__ = ["ssdnerf_config", "train_config", "LatentDenoiser",
           "build_denoiser"]

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

train_config = dict(
    batch_size=4,
    max_iters=40000,       # stablessdnerf_cars_lpips.py:189 total_iters
    log_interval=50,
    ckpt_interval=2000,
)


class LatentDenoiser(nn.Module):
    """(B, P, C, H, W) latent, (B,) timesteps -> (B, P, C, H, W); `cond`
    is ignored (the denoiser is unconditional).

    layout "stack": the planes fold into channels, plane-major (channel
    p * C + c), an (H, W) image of P * C channels; "tiled": the planes
    sit side by side along the width, a (H, P * W) image of C channels
    (the paper family's tiled recipe, `configs/_ssdnerf_paper_base.py`).
    `groups`: the GroupNorms' group count."""

    def __init__(self, planes=3, channels=12, ch=128, n_blocks=4,
                 layout="stack", groups=32):
        super().__init__()
        if layout not in ("stack", "tiled"):
            raise ValueError(f"unknown layout {layout!r}")
        cin = channels if layout == "tiled" else planes * channels
        self.ch, self.n_blocks, self.layout = ch, n_blocks, layout
        self.temb1 = Dense(ch, ch * 4)
        self.temb2 = Dense(ch * 4, ch * 4)
        self.conv_in = Conv(cin, ch, 3, padding=1)
        for i in range(n_blocks):
            self.add_module(f"norm{i}", GroupNorm(groups, ch, 1e-6))
            self.add_module(f"conv{i}a", Conv(ch, ch, 3, padding=1))
            self.add_module(f"tproj{i}", Dense(ch * 4, ch))
            self.add_module(f"conv{i}b", Conv(ch, ch, 3, padding=1))
        self.conv_out = Conv(ch, cin, 3, padding=1)

    def forward(self, x, t, cond=None):
        B, P, C, H, W = x.shape
        temb = self.temb1(timestep_embedding(t, self.ch))
        temb = F.silu(self.temb2(F.silu(temb)))
        if self.layout == "tiled":
            h = x.permute(0, 2, 3, 1, 4).reshape(B, C, H, P * W)
        else:
            h = x.reshape(B, P * C, H, W)
        h = self.conv_in(h)
        for i in range(self.n_blocks):
            r = getattr(self, f"conv{i}a")(F.silu(
                getattr(self, f"norm{i}")(h)))
            r = r + getattr(self, f"tproj{i}")(temb)[:, :, None, None]
            h = h + getattr(self, f"conv{i}b")(F.silu(r))
        out = self.conv_out(h)
        if self.layout == "tiled":
            return out.reshape(B, C, H, P, W).permute(0, 3, 1, 2, 4)
        return out.reshape(B, P, C, H, W)


def build_denoiser(generator=None, device=None):
    """The `LatentDenoiser` at the config's widths on `device`, seeded from
    `generator` (flax's defaults: weights N(0, 1/fan_in), biases 0, norm
    weights 1)."""
    from mvedit_tpu_torch.apis.runner import init_random_
    with torch.device(device or "cpu"):
        net = LatentDenoiser()
    with torch.no_grad():
        return init_random_(net, generator)
