"""IP-Adapter image-prompt projections.

Counterpart of `mvedit_tpu/models/diffusion/ip_adapter.py`:
- `ImageProjModel`: a CLIP image embed -> `num_tokens` (4) context tokens
  (plain IP-Adapter; parameter names as the checkpoints' `image_proj.*`);
- `Resampler`: the perceiver-style resampler over the CLIP tower's
  penultimate hidden states -> 16 tokens (IP-Adapter-plus);
- `get_ip_prompt_embeds`: text tokens with image tokens appended, per CFG
  half;
- `add_ip_branches`: the decoupled cross-attention's `ip_to_k` / `ip_to_v`
  projections grafted onto every cross-attention of a UNet (the attention
  itself is `CrossAttention`'s, enabled by `AttnMode.ip_tokens > 0`).

ControlNets never see the image tokens: the pipelines pass them to the
UNet only, as the reference does.
"""
import torch
import torch.nn.functional as F
from torch import nn

from .attention import CrossAttention, dot_product_attention
from .layers import Dense
from .norm import LayerNorm

__all__ = ["ImageProjModel", "PerceiverAttention", "Resampler",
           "get_ip_prompt_embeds", "add_ip_branches"]


class ImageProjModel(nn.Module):
    def __init__(self, cross_attention_dim=768, clip_embed_dim=1024,
                 num_tokens=4):
        super().__init__()
        self.num_tokens, self.dim = num_tokens, cross_attention_dim
        # float32 compute over any stored dtype, as flax promotes a bf16
        # kernel against a float32 input
        self.proj = Dense(clip_embed_dim, cross_attention_dim * num_tokens,
                          dtype=torch.float32)
        self.norm = LayerNorm(cross_attention_dim)

    def forward(self, image_embeds):
        """(B, clip_embed_dim) -> (B, num_tokens, cross_attention_dim)."""
        x = self.proj(image_embeds)
        return self.norm(x.reshape(-1, self.num_tokens, self.dim))


class PerceiverAttention(nn.Module):
    def __init__(self, dim, dim_head=64, heads=16):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.to_q = Dense(dim, inner, bias=False)
        self.to_kv = Dense(dim, inner * 2, bias=False)
        self.to_out = Dense(inner, dim, bias=False)

    def forward(self, x, latents):
        xl, lt = self.norm1(x), self.norm2(latents)
        q = self.to_q(lt)
        k, v = self.to_kv(torch.cat([xl, lt], -2)).chunk(2, dim=-1)

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads,
                             self.dim_head)

        out = dot_product_attention(split(q), split(k), split(v))
        return self.to_out(out.reshape(latents.shape[0], latents.shape[1],
                                       -1))


class _ResamplerLayer(nn.Module):
    def __init__(self, dim, dim_head, heads, ff_mult):
        super().__init__()
        self.attn = PerceiverAttention(dim, dim_head, heads)
        self.ff_norm = LayerNorm(dim)
        self.ff_1 = Dense(dim, dim * ff_mult, bias=False)
        self.ff_2 = Dense(dim * ff_mult, dim, bias=False)


class Resampler(nn.Module):
    """IP-Adapter-plus resampler."""

    def __init__(self, dim=768, depth=4, dim_head=64, heads=12,
                 num_queries=16, embedding_dim=1280, output_dim=768,
                 ff_mult=4):
        super().__init__()
        self.latents = nn.Parameter(torch.zeros(num_queries, dim))
        self.proj_in = Dense(embedding_dim, dim)
        self.layers = nn.ModuleList([
            _ResamplerLayer(dim, dim_head, heads, ff_mult)
            for _ in range(depth)])
        self.proj_out = Dense(dim, output_dim)
        self.norm_out = LayerNorm(output_dim)

    def forward(self, x):
        """x: (B, P, embedding_dim) -> (B, num_queries, output_dim)."""
        latents = self.latents[None].expand(x.shape[0], -1, -1)
        x = self.proj_in(x)
        for layer in self.layers:
            latents = latents + layer.attn(x, latents)
            # jax.nn.gelu defaults to the tanh approximation
            h = F.gelu(layer.ff_1(layer.ff_norm(latents)),
                       approximate="tanh")
            latents = latents + layer.ff_2(h)
        return self.norm_out(self.proj_out(latents))


def get_ip_prompt_embeds(text_embeds, uncond_text_embeds, image_tokens,
                         uncond_image_tokens):
    """(pos, neg) contexts: the image tokens appended to the text tokens."""
    return (torch.cat([text_embeds, image_tokens], 1),
            torch.cat([uncond_text_embeds, uncond_image_tokens], 1))


def add_ip_branches(unet):
    """Give every cross-attention of `unet` its `ip_to_k` / `ip_to_v`
    (no bias, context width -> inner width, on the module's device and
    dtype) unless it has them. Returns the names of the new parameters."""
    new = []
    for name, mod in list(unet.named_modules()):
        if isinstance(mod, CrossAttention) and not mod.is_self \
                and not hasattr(mod, "ip_to_k"):
            ref = mod.to_k.weight
            for branch in ("ip_to_k", "ip_to_v"):
                d = Dense(mod.ctx_dim, mod.heads * mod.dim_head, bias=False,
                          dtype=mod.to_k.compute_dtype)
                setattr(mod, branch, d.to(device=ref.device,
                                          dtype=ref.dtype))
                new.append(f"{name}.{branch}.weight")
    return new
