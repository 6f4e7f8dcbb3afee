"""Attention core and transformer blocks of the diffusion UNets.

Counterpart of `mvedit_tpu/models/diffusion/attention.py`. All attention
funnels through `dot_product_attention`, which routes exactly as the
reference does:

- on the card, long sequences (max(Lq, Lk) > 1024) with both lengths
  divisible by 128 and D <= 128 -- the shapes for which the reference's
  `_pallas_flash` returns a result -- go to the flash-attention kernel;
  CPU tensors never do, as the reference skips it on its CPU backend;
- otherwise, Lq * Lk > 4096 * 8192 goes to the chunked online-softmax;
- everything else (cross-attention over 77 tokens, the VAE's single-head
  D=512 mid-attention) to plain matmul attention.

`AttnMode` keeps the reference's fields. This port implements joint
(cross-view) self-attention and IP-Adapter's decoupled cross-attention
(`ip_to_k` / `ip_to_v` over the image tokens, added with `ip_scale`; its 4
or 16 keys route to the plain attention); zero123++ reference attention
raises until its slice is ported.
"""
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...kernels.flash_attention import (MAX_HEAD_DIM, attention_reference,
                                        flash_attention)
from .layers import Conv, Dense
from .norm import GroupNorm, LayerNorm

__all__ = ["AttnMode", "dot_product_attention", "uses_flash",
           "CrossAttention", "FeedForward", "BasicTransformerBlock",
           "Transformer2D"]


@dataclass(frozen=True)
class AttnMode:
    """Attention behaviour flags, as the reference's."""
    num_views: int = 1          # >1 -> cross-image joint self-attention
    ip_tokens: int = 0          # >0 -> decoupled IP-Adapter cross-attn
    ip_scale: float = 1.0
    reference: str = "none"     # none | write | read (zero123++ ref attn)


_CHUNK_THRESHOLD = 1024
_KV_CHUNK = 2048


def _block_ok(n):
    # the reference's `_block` finds a block size in (1024, 512, 256, 128)
    return n % 128 == 0


def uses_flash(Lq, Lk, D):
    """True exactly where the reference's `_pallas_flash` returns a result
    (attention.py:154-156 and :119-126)."""
    return (max(Lq, Lk) > _CHUNK_THRESHOLD and _block_ok(Lq)
            and _block_ok(Lk) and D <= MAX_HEAD_DIM)


def _chunked_attention(q, k, v):
    """Online-softmax attention over KV chunks of 2048, O(Lq * chunk)
    memory (the reference's `_chunked_attention`)."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    qs = q * (D ** -0.5)
    acc = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Lq), float("-inf"), device=q.device)
    l = torch.zeros((B, H, Lq), device=q.device)
    for c0 in range(0, Lk, _KV_CHUNK):
        kb, vb = k[:, c0:c0 + _KV_CHUNK], v[:, c0:c0 + _KV_CHUNK]
        s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kb.float())
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    out = acc / l[..., None].clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


def dot_product_attention(q, k, v):
    """(B, Lq, H, D) x (B, Lk, H, D) -> (B, Lq, H, D)."""
    Lq, Lk, D = q.shape[1], k.shape[1], q.shape[-1]
    # CPU tensors skip the kernel, as the reference does on its CPU backend
    if q.device.type != "cpu" and uses_flash(Lq, Lk, D):
        return flash_attention(q, k, v)
    if Lq * Lk > 4096 * 8192:
        return _chunked_attention(q, k, v)
    return attention_reference(q, k, v)


class CrossAttention(nn.Module):
    """Multi-head attention with diffusers' parameter names
    (to_q / to_k / to_v / to_out.0)."""

    def __init__(self, query_dim, context_dim=None, heads=8, dim_head=64,
                 dtype=None):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = query_dim if context_dim is None else context_dim
        self.is_self = context_dim is None
        self.ctx_dim = ctx_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(ctx_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(ctx_dim, inner, bias=False, dtype=dtype)
        self.to_out = nn.ModuleList([Dense(inner, query_dim, dtype=dtype)])

    def forward(self, x, context=None, mode=AttnMode(), ip_context=None):
        """x: (B, L, C); context: (B, Lc, Cc), or None for self-attention;
        ip_context: (B, T, Cc) image tokens for a cross-attention with
        IP branches (`ip_adapter.add_ip_branches`) when mode.ip_tokens >
        0."""
        if mode.reference != "none":
            raise NotImplementedError(
                "reference attention is not ported yet")
        B, L, C = x.shape
        joint = context is None and mode.num_views > 1
        if joint:
            # fold views into the sequence axis (attention.py:199-207)
            x = x.reshape(B // mode.num_views, mode.num_views * L, C)
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads,
                             self.dim_head)

        out = dot_product_attention(split(q), split(k), split(v))
        out = out.reshape(q.shape[0], q.shape[1], self.heads * self.dim_head)
        if not self.is_self and mode.ip_tokens > 0 \
                and ip_context is not None:
            ip_out = dot_product_attention(
                split(q), split(self.ip_to_k(ip_context)),
                split(self.ip_to_v(ip_context)))
            out = out + mode.ip_scale * ip_out.reshape(out.shape)
        return self.to_out[0](out.reshape(B, L, -1))


class _GEGLU(nn.Module):
    def __init__(self, dim, inner, dtype=None):
        super().__init__()
        self.proj = Dense(dim, inner * 2, dtype=dtype)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        # jax.nn.gelu defaults to the tanh approximation
        return a * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU feed-forward, diffusers names net.0.proj / net.2."""

    def __init__(self, dim, mult=4, dtype=None):
        super().__init__()
        self.net = nn.ModuleList([_GEGLU(dim, dim * mult, dtype),
                                  nn.Identity(),
                                  Dense(dim * mult, dim, dtype=dtype)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim=768, dtype=None):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, heads, dim_head, dtype)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head, dtype)
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.norm3 = LayerNorm(dim, dtype=dtype)
        self.ff = FeedForward(dim, dtype=dtype)

    def forward(self, x, context, mode=AttnMode(), ip_context=None):
        x = x + self.attn1(self.norm1(x), None, mode)
        x = x + self.attn2(self.norm2(x), context, mode, ip_context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm -> proj_in -> blocks -> proj_out + skip, on NCHW input."""

    def __init__(self, channels, heads, dim_head, depth=1, context_dim=768,
                 use_linear=False, dtype=None):
        super().__init__()
        self.use_linear = use_linear
        self.norm = GroupNorm(32, channels, eps=1e-6)
        if use_linear:
            self.proj_in = Dense(channels, channels, dtype=dtype)
            self.proj_out = Dense(channels, channels, dtype=dtype)
        else:
            self.proj_in = Conv(channels, channels, 1, dtype=dtype)
            self.proj_out = Conv(channels, channels, 1, dtype=dtype)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, dim_head, context_dim,
                                  dtype) for _ in range(depth)])

    def forward(self, x, context, mode=AttnMode(), ip_context=None):
        B, C, H, W = x.shape
        h = self.norm(x)
        if self.use_linear:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(B, H * W, C))
        else:
            h = self.proj_in(h).permute(0, 2, 3, 1).reshape(B, H * W, C)
        for blk in self.transformer_blocks:
            h = blk(h, context, mode, ip_context)
        if self.use_linear:
            h = self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(B, H, W, C).permute(0, 3, 1, 2))
        return h + x
