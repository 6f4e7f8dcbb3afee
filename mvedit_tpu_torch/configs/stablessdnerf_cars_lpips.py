"""StableSSDNeRF recipe (the port's copy of
`configs/stablessdnerf_cars_lpips.py`, which imports JAX): text-
conditioned triplane diffusion with a frozen SD2.1 UNet and a trainable
rank-32 LoRA on its attention projections as the denoiser, the frozen
1024-wide CLIP text tower for the captions, and a patch-wise render loss
with LPIPS.

The (3, 4, 40, 40) code rides through the UNet as a 4-channel 120 x 40
latent image (the reference's code_permute=(1, 0, 2, 3) +
code_reshape=(4, 120, 40)); the text conditioning enters through the
cross-attention `cond`. The JAX recipe's docstring names a CLIP "LoRA
hook", but its code puts no LoRA on CLIP; neither does the port.

`build_denoiser(generator, device)` returns a module whose only
parameters are the LoRA factors: the frozen UNet is held outside
`named_parameters()`, so `tools/train_ssdnerf.py` trains, decays and
checkpoints the LoRA alone, as the JAX recipe keeps only the LoRA pytree
in its state. The LoRA is merged into the UNet's f32 weights on every
call, before the layers cast to bf16, as the reference merges it.
"""
import os

import torch
from torch import nn

from mvedit_tpu_torch.models.diffusion.attention import AttnMode
from mvedit_tpu_torch.models.diffusion.clip import (CLIPTextConfig,
                                                    CLIPTextModel)
from mvedit_tpu_torch.models.diffusion.lora import (LoRAParams, init_lora,
                                                    merge_lora)
from mvedit_tpu_torch.models.diffusion.unet import (SD21_UNET,
                                                    UNet2DCondition)
from mvedit_tpu_torch.models.ssdnerf import SSDNeRFConfig
from mvedit_tpu_torch.models.triplane import TriPlaneConfig
from mvedit_tpu_torch.models.volume_renderer import RenderConfig

__all__ = ["ssdnerf_config", "train_config", "SD21_TEXT", "LoRADenoiser",
           "build_denoiser", "make_cond_fn"]

ssdnerf_config = SSDNeRFConfig(
    code_shape=(3, 4, 40, 40),
    latent_shape=(3, 4, 40, 40),
    triplane=TriPlaneConfig(
        n_channels=4,
        base_layers=(12, 64),
        density_layers=(64, 1),
        color_layers=(64, 3),
        dir_layers=(16, 64),
        bound=0.5),
    render=RenderConfig(num_samples=96, bound=0.5, grid_size=32),
    n_rays=32 * 32,          # one 32x32 patch per scene (LPIPS needs
                             # contiguous patches)
    code_lr=0.04,
    decoder_lr=1e-3,
    denoiser_lr=1e-4,
)

train_config = dict(
    batch_size=8,
    max_iters=100000,
    log_interval=50,
    ckpt_interval=2000,
    dataset="cars",
    patch_size=32,
    use_lpips=True,
    lpips_weight=1.2,
)

# SD2.1's text tower: 23 layers of 1024 (the penultimate layer of
# OpenCLIP ViT-H), gelu in its tanh form (what `jax.nn.gelu` computes)
SD21_TEXT = CLIPTextConfig(hidden_size=1024, intermediate_size=4096,
                           num_layers=23, num_heads=16, act="gelu")
CONTEXT = (77, 1024)


class LoRADenoiser(nn.Module):
    """(B, P, C, H, W) code, (B,) timesteps, cond (B, 77, 1024) or None
    -> (B, P, C, H, W) through the frozen `unet` with `lora` merged.

    The code goes in as the NHWC (P * H, W, C) latent image, the planes
    stacked along the height; cond None is zeros."""

    def __init__(self, unet, lora, latent_shape, context=CONTEXT):
        super().__init__()
        # a tuple keeps the frozen UNet out of the module's parameters
        self._frozen = (unet.requires_grad_(False),)
        self.latent_shape = tuple(latent_shape)
        self.context = tuple(context)
        self.lora = LoRAParams(lora)
        params = dict(unet.named_parameters())
        self._base = {p + ".weight": params[p + ".weight"]
                      for p in self.lora.paths}

    @property
    def unet(self):
        return self._frozen[0]

    def forward(self, x, t, cond=None):
        B = x.shape[0]
        P, C, H, W = self.latent_shape
        h = x.permute(0, 1, 3, 4, 2).reshape(B, P * H, W, C)
        if cond is None:
            cond = torch.zeros((B, *self.context), dtype=h.dtype,
                               device=h.device)
        weights = merge_lora(self._base, self.lora.factors())
        out = torch.func.functional_call(self.unet, weights, (h, t, cond),
                                         {"mode": AttnMode()})
        return out.reshape(B, P, H, W, C).permute(0, 1, 4, 2, 3)


def build_denoiser(generator=None, device=None):
    """The seeded SD2.1 UNet (flax's default init), frozen, with a seeded
    rank-32 LoRA on every to_q / to_k / to_v / to_out, on `device`. The
    weights are drawn on the generator's device: the CLIs pass a CPU
    generator, so that one seed gives one base on every device."""
    from mvedit_tpu_torch.apis.runner import init_random_
    with torch.device(device or "cpu"):
        unet = UNet2DCondition(SD21_UNET)
    with torch.no_grad():
        init_random_(unet, generator)
        lora = init_lora(generator, dict(unet.named_parameters()), rank=32)
    return LoRADenoiser(unet, lora, ssdnerf_config.latent_shape,
                        (CONTEXT[0], SD21_UNET.cross_attention_dim))


def _tokenizer():
    from mvedit_tpu_torch.models.diffusion.tokenizer import (CLIPTokenizer,
                                                             HashTokenizer)
    ckpt = os.environ.get("MVEDIT_CHECKPOINT_DIR")
    tok_dir = ckpt and os.path.join(ckpt, "tokenizer")
    if tok_dir and os.path.exists(os.path.join(tok_dir, "vocab.json")):
        return CLIPTokenizer(os.path.join(tok_dir, "vocab.json"),
                             os.path.join(tok_dir, "merges.txt"))
    return HashTokenizer()


def make_cond_fn(device=None):
    """The frozen text tower: captions -> (B, 77, 1024) embeddings on
    `device`. Weights seeded from a CPU generator (seed 1, the JAX
    recipe's key), the same on every device; the tokenizer
    is CLIP's BPE where `$MVEDIT_CHECKPOINT_DIR/tokenizer/vocab.json`
    exists, else the stand-in `HashTokenizer`."""
    from mvedit_tpu_torch.apis.runner import init_random_
    generator = torch.Generator().manual_seed(1)
    with torch.device(device or "cpu"):
        net = CLIPTextModel(SD21_TEXT)
    with torch.no_grad():
        init_random_(net, generator)
    net.requires_grad_(False)
    tok = _tokenizer()

    @torch.no_grad()
    def cond_fn(captions):
        ids = torch.as_tensor(tok(list(captions)), device=device)
        return net(ids)

    cond_fn.net = net
    return cond_fn
