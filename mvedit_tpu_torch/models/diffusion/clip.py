"""CLIP text encoder.

Counterpart of `mvedit_tpu/models/diffusion/clip.py::CLIPTextModel`, with
transformers' `CLIPTextModel` parameter names (`text_model.*`). Causal
self-attention; quick_gelu for SD1.5. LayerNorm eps is flax's 1e-6, as in
the reference. The vision tower is not ported yet.
"""
from dataclasses import dataclass

import torch
from torch import nn

from .layers import Dense
from .norm import LayerNorm

__all__ = ["CLIPTextConfig", "CLIPTextModel", "SD15_TEXT"]


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
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        dt = cfg.dtype
        self.heads, self.act = cfg.num_heads, cfg.act
        self.layer_norm1 = LayerNorm(cfg.hidden_size, dtype=dt)
        self.self_attn = _SelfAttn(cfg.hidden_size, dt)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, dtype=dt)
        self.mlp = _MLP(cfg.hidden_size, cfg.intermediate_size, dt)

    def forward(self, x):
        B, L, C = x.shape
        a = self.self_attn
        h = self.layer_norm1(x)

        def split(t):
            return t.reshape(B, L, self.heads, C // self.heads)

        o = causal_attention(split(a.q_proj(h)), split(a.k_proj(h)),
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
            x = layer(x)
            if output_hidden_state_index is not None \
                    and i == cfg.num_layers + output_hidden_state_index:
                return x
        return tm.final_layer_norm(x)
