"""Attention core and transformer blocks of the diffusion UNets.

Counterpart of `mvedit_tpu/models/diffusion/attention.py`. All attention
funnels through `dot_product_attention`. CPU tensors never take the
kernel, as the reference skips it on its CPU backend, and neither does a
call that asks for a gradient: the kernel has no backward (the
reference differentiates through its Pallas kernel). On the card any
other call goes to the hand-written flash kernel when either of two
rules holds:

- `uses_flash`, the reference's own rule: long sequences (max(Lq, Lk) >
  1024) with both lengths divisible by 128 and D <= 128, the shapes for
  which the reference's `_pallas_flash` returns a result (the TPU kernel's
  128-row blocks). f32 callers there reach the kernel through its bf16
  copy, as the reference casts them;
- `kernel_takes`, what the H100 kernel takes as it is: bf16 inputs it
  reads without a copy, D <= 128 and D % 8 == 0, and no gradient asked
  for (it has no backward). The kernel masks ragged query rows and key
  tiles, so any lengths do: Zero123++'s levels 1-3 (L 2400, 600, 150),
  every bf16 cross-attention over 77 text tokens, IP-Adapter's 4 or 16
  image tokens.

Every other call, in f32 or carrying a gradient or wider than 128, takes
the reference's route off the kernel: Lq * Lk > 4096 * 8192 goes to the
chunked online-softmax; the rest (the f32 text and vision towers, the
VAE's single-head D=512 mid-attention, a training step's attention) to
plain matmul attention, whose large score tensors are recomputed in the
backward rather than saved (the LoRA recipe's step).

`AttnMode` keeps the reference's fields, plus `views` for a batch
sharded over ranks (`parallel.ViewShard`). This port implements joint
(cross-view) self-attention and IP-Adapter's decoupled cross-attention
(`ip_to_k` / `ip_to_v` over the image tokens, added with `ip_scale`) and
Zero123++'s reference attention: a `reference="write"` pass stores each
Transformer2D's self-attention input (the normed hidden state before
`to_k` / `to_v`) in a `RefStates`, and a `reference="read"` pass
concatenates the stored state onto that self-attention's context along
the sequence axis, so Lk = 2 Lq (attention.py:174-206, :257-306).
"""
from dataclasses import dataclass

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ...kernels.flash_attention import (MAX_HEAD_DIM, attention_reference,
                                        flash_attention, plan)
from ...utils.profiling import count
from .layers import Conv, Dense
from .norm import GroupNorm, LayerNorm

__all__ = ["AttnMode", "RefStates", "dot_product_attention", "uses_flash",
           "kernel_takes", "CrossAttention", "FeedForward",
           "BasicTransformerBlock", "Transformer2D"]


@dataclass(frozen=True)
class AttnMode:
    """Attention behaviour flags, as the reference's."""
    num_views: int = 1          # >1 -> cross-image joint self-attention
    ip_tokens: int = 0          # >0 -> decoupled IP-Adapter cross-attn
    ip_scale: float = 1.0
    reference: str = "none"     # none | write | read (zero123++ ref attn)
    # a `parallel.ViewShard` when this rank holds part of the batch
    views: object = None


class RefStates:
    """Reference attention's stored states, one per Transformer2D in the
    UNet's order (down blocks, mid, up blocks): a write pass appends the
    first block's self-attention input, a read pass takes them back in the
    same order, across the UNet's encode / decode split. The reference
    keeps the first block's entry of each (`w[0]`) and hands each
    transformer's entry to all of its blocks."""

    def __init__(self, states=None):
        self.states = [] if states is None else list(states)
        self._next = 0

    def take(self):
        s = self.states[self._next]
        self._next += 1
        return s


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


def kernel_takes(q, k, v):
    """True where the flash kernel takes (B, Lq, H, D) x (B, Lk, H, D) as
    it is, whatever the lengths: bf16 q, k and v, D <= MAX_HEAD_DIM, no
    gradient asked for, and `plan` sends them "direct" (no staged copy:
    D % 8 == 0, aligned). Decided on the host alone."""
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)) \
            or q.shape[-1] > MAX_HEAD_DIM or _asks_grad(q, k, v):
        return False
    return plan(q, k, v, q.shape[-1] ** -0.5) == "direct"


def _asks_grad(*ts):
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


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


# scores of at least this many elements are recomputed in the backward
# instead of saved (f32: 256 MiB): saving them, the LoRA recipe's step
# (L 4800, batch 8) peaked at 66.7 GiB alone on an NVIDIA H100 80GB HBM3
# at 700 W (chip_smoke.py phase 20; PERF.md)
RECOMPUTE_SCORES = 1 << 26


def _plain_attention(q, k, v):
    """`attention_reference`, through `torch.utils.checkpoint` where a
    gradient is asked for and the scores are large: the backward runs the
    same forward again, so the bits do not change."""
    B, Lq, H, _ = q.shape
    if _asks_grad(q, k, v) and B * H * Lq * k.shape[1] >= RECOMPUTE_SCORES:
        return torch.utils.checkpoint.checkpoint(
            attention_reference, q, k, v, use_reentrant=False)
    return attention_reference(q, k, v)


def _route(q, k, v):
    """Where `dot_product_attention` sends a call: "kernel" (`uses_flash`),
    "ragged" (the kernel, admitted by `kernel_takes` alone), "chunked" or
    "plain"."""
    Lq, Lk, D = q.shape[1], k.shape[1], q.shape[-1]
    # CPU tensors skip the kernel, as the reference does on its CPU
    # backend; the kernel has no backward, so a call that asks for a
    # gradient skips it too
    if q.device.type != "cpu" and not _asks_grad(q, k, v):
        if uses_flash(Lq, Lk, D):
            return "kernel"
        if kernel_takes(q, k, v):
            return "ragged"
    return "chunked" if Lq * Lk > 4096 * 8192 else "plain"


def dot_product_attention(q, k, v):
    """(B, Lq, H, D) x (B, Lk, H, D) -> (B, Lq, H, D), routed as the module
    doc says. Each call adds one to the installed phase timer's
    `attention.kernel` or `attention.plain` count (the chunked path is
    plain); a kernel call that `kernel_takes` alone admits also adds one
    to `attention.kernel.ragged`."""
    route = _route(q, k, v)
    if route == "kernel" or route == "ragged":
        count("attention.kernel")
        if route == "ragged":
            count("attention.kernel.ragged")
        return flash_attention(q, k, v)
    count("attention.plain")
    if route == "chunked":
        return _chunked_attention(q, k, v)
    return _plain_attention(q, k, v)


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

    def forward(self, x, context=None, mode=AttnMode(), ip_context=None,
                ref_kv=None):
        """x: (B, L, C); context: (B, Lc, Cc), or None for self-attention;
        ip_context: (B, T, Cc) image tokens for a cross-attention with
        IP branches (`ip_adapter.add_ip_branches`) when mode.ip_tokens >
        0; ref_kv: (B, Lr, C) stored reference state, concatenated onto a
        self-attention's context in mode.reference == "read"."""
        B, L, C = x.shape
        ctx = x if context is None else context
        if context is None and mode.reference == "read" \
                and ref_kv is not None:
            ctx = torch.cat([ctx, ref_kv.to(ctx.dtype)], 1)
        nv = mode.num_views
        if context is None and nv > 1 and mode.views is not None \
                and not mode.views.holds_whole_groups(nv):
            # this rank holds part of a view group: its queries attend over
            # the group's keys and values, gathered across the ranks
            q = self.to_q(x).reshape(1, B * L, -1)
            k, v = mode.views.group_kv(
                torch.cat([self.to_k(ctx), self.to_v(ctx)], -1), nv).chunk(
                    2, -1)
        else:
            if context is None and nv > 1:
                # fold views into the sequence axis (attention.py:199-207)
                x = x.reshape(B // nv, nv * L, C)
                ctx = ctx.reshape(x.shape[0], -1, ctx.shape[-1])
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
        return self.to_out[0](out.reshape(B, L, self.heads * self.dim_head))


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

    def forward(self, x, context, mode=AttnMode(), ip_context=None,
                ref_kv=None, writes=None):
        """`writes`: a list the self-attention's input is appended to in
        mode.reference == "write"."""
        h = self.norm1(x)
        if writes is not None and mode.reference == "write":
            writes.append(h)
        x = x + self.attn1(h, None, mode, ref_kv=ref_kv)
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

    def forward(self, x, context, mode=AttnMode(), ip_context=None,
                ref=None):
        """x: NCHW; ref: the UNet's `RefStates` for reference attention."""
        B, C, H, W = x.shape
        ref_kv = ref.take() if ref is not None \
            and mode.reference == "read" else None
        h = self.norm(x)
        if self.use_linear:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(B, H * W, C))
        else:
            h = self.proj_in(h).permute(0, 2, 3, 1).reshape(B, H * W, C)
        for i, blk in enumerate(self.transformer_blocks):
            h = blk(h, context, mode, ip_context, ref_kv,
                    ref.states if ref is not None and i == 0 else None)
        if self.use_linear:
            h = self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(B, H, W, C).permute(0, 3, 1, 2))
        return h + x
