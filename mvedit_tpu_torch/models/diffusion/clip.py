"""CLIP text and vision encoders.

Counterpart of `mvedit_tpu/models/diffusion/clip.py`, with transformers'
parameter names: `CLIPTextModel` (`text_model.*`; causal self-attention,
quick_gelu for SD1.5) and `CLIPVisionModel`, the image tower with its
projection that IP-Adapter encodes image prompts with
(`vision_model.*`, `visual_projection`, as transformers'
`CLIPVisionModelWithProjection`). LayerNorm eps is flax's 1e-6, as in the
reference. The vision tower's attention goes through the diffusion
models' `dot_product_attention`, as the reference's does.
"""
from dataclasses import dataclass

import torch
from torch import nn

from .attention import dot_product_attention
from .layers import Conv, Dense
from .norm import LayerNorm

__all__ = ["CLIPTextConfig", "CLIPTextModel", "SD15_TEXT",
           "CLIPVisionConfig", "CLIPVisionModel", "IPADAPTER_VISION"]


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    act: str = "quick_gelu"
    dtype: torch.dtype = torch.float32


SD15_TEXT = CLIPTextConfig()


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    projection_dim: int = 768
    act: str = "quick_gelu"
    dtype: torch.dtype = torch.float32


# OpenCLIP ViT-H/14, the tower IP-Adapter's checkpoints were trained with
IPADAPTER_VISION = CLIPVisionConfig(
    image_size=224, patch_size=14, hidden_size=1280, intermediate_size=5120,
    num_layers=32, num_heads=16, projection_dim=1024, act="gelu")


def _act(name, x):
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return torch.nn.functional.gelu(x, approximate="tanh")


def causal_attention(q, k, v):
    """(B, L, H, D) causal attention in the input dtype."""
    L, D = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (D ** -0.5)
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


class _SelfAttn(nn.Module):
    def __init__(self, hidden, dt):
        super().__init__()
        self.q_proj = Dense(hidden, hidden, dtype=dt)
        self.k_proj = Dense(hidden, hidden, dtype=dt)
        self.v_proj = Dense(hidden, hidden, dtype=dt)
        self.out_proj = Dense(hidden, hidden, dtype=dt)


class _MLP(nn.Module):
    def __init__(self, hidden, inter, dt):
        super().__init__()
        self.fc1 = Dense(hidden, inter, dtype=dt)
        self.fc2 = Dense(inter, hidden, dtype=dt)


class CLIPLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dt = cfg.dtype
        self.heads, self.act = cfg.num_heads, cfg.act
        self.layer_norm1 = LayerNorm(cfg.hidden_size, dtype=dt)
        self.self_attn = _SelfAttn(cfg.hidden_size, dt)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, dtype=dt)
        self.mlp = _MLP(cfg.hidden_size, cfg.intermediate_size, dt)

    def forward(self, x, causal=True):
        B, L, C = x.shape
        a = self.self_attn
        h = self.layer_norm1(x)

        def split(t):
            return t.reshape(B, L, self.heads, C // self.heads)

        attend = causal_attention if causal else dot_product_attention
        o = attend(split(a.q_proj(h)), split(a.k_proj(h)),
                   split(a.v_proj(h))).reshape(B, L, C)
        x = x + a.out_proj(o)
        h = self.mlp.fc1(self.layer_norm2(x))
        return x + self.mlp.fc2(_act(self.act, h))


class _Embeddings(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length,
                                               cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList([CLIPLayer(cfg)
                                     for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, dtype=cfg.dtype)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig = SD15_TEXT):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextTransformer(cfg)

    def forward(self, input_ids, output_hidden_state_index=None):
        """input_ids: (B, L) int -> last hidden state (B, L, hidden) after
        the final LayerNorm, or an intermediate layer's output when
        `output_hidden_state_index` is set (clip skip)."""
        cfg, tm = self.cfg, self.text_model
        L = input_ids.shape[1]
        emb = tm.embeddings
        x = (emb.token_embedding.weight[input_ids].to(cfg.dtype)
             + emb.position_embedding.weight[:L][None].to(cfg.dtype))
        for i, layer in enumerate(tm.encoder.layers):
            x = layer(x, causal=True)
            if output_hidden_state_index is not None \
                    and i == cfg.num_layers + output_hidden_state_index:
                return x
        return tm.final_layer_norm(x)


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = Conv(3, cfg.hidden_size, cfg.patch_size,
                                    stride=cfg.patch_size, bias=False,
                                    dtype=cfg.dtype)
        self.position_embedding = nn.Embedding(n, cfg.hidden_size)


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, dtype=cfg.dtype)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = LayerNorm(cfg.hidden_size, dtype=cfg.dtype)


class CLIPVisionModel(nn.Module):
    """The CLIP image tower with its projection."""

    def __init__(self, cfg: CLIPVisionConfig = IPADAPTER_VISION):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionTransformer(cfg)
        self.visual_projection = Dense(cfg.hidden_size, cfg.projection_dim,
                                       bias=False, dtype=cfg.dtype)

    def forward(self, pixel_values, return_hidden=False):
        """pixel_values: (B, H, W, 3) CLIP-normalised -> image embeds
        (B, projection_dim), or with `return_hidden` the penultimate
        layer's hidden states (B, 1 + P, hidden) (IP-Adapter-plus's
        Resampler input)."""
        cfg, vm = self.cfg, self.vision_model
        emb = vm.embeddings
        B = pixel_values.shape[0]
        patches = emb.patch_embedding(pixel_values.permute(0, 3, 1, 2))
        patches = patches.flatten(2).transpose(1, 2)          # (B, P, C)
        cls = emb.class_embedding.to(patches.dtype).expand(B, 1, -1)
        x = torch.cat([cls, patches], 1)
        x = x + emb.position_embedding.weight.to(x.dtype)[None]
        x = vm.pre_layrnorm(x)
        hidden = None
        for i, layer in enumerate(vm.encoder.layers):
            if return_hidden and i == cfg.num_layers - 1:
                hidden = x          # the penultimate layer's output
            x = layer(x, causal=False)
        if return_hidden:
            return hidden
        return self.visual_projection(vm.post_layernorm(x[:, 0]))
