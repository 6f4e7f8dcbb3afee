"""Plain float32 reference of the SD UNet, ControlNet and VAE.

A frozen copy of the port's module structure, with diffusers' parameter
names, so that one seeded state fills both. It imports nothing of the port:
every layer computes in float32 (TF32 off, see `no_tf32`) and attention is
written out, softmax over whole key rows, in blocks of queries.

`Quant` is the control: with `fp8=True` every dense and conv layer rounds
its input and its weight to float8 e4m3 (one scale per tensor, amax to
448) before the product, the step below the program's bfloat16.
"""
import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["UNetCfg", "VAECfg", "UNet", "ControlNet", "VAE", "Quant",
           "no_tf32", "attention"]

# f32 score elements of one block of queries
SCORE_BLOCK = 1 << 28


@contextmanager
def no_tf32():
    """Matmuls and convs in true float32 on the card."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


@dataclass(frozen=True)
class Quant:
    fp8: bool = False

    def __call__(self, x):
        """x rounded to float8 e4m3 at one scale a tensor; the gradient
        passes through the rounding as through the identity, as a
        low-precision training step's does to its master copy."""
        if not self.fp8:
            return x
        s = x.detach().abs().amax().clamp_min(1e-12) / 448.0
        q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        return x + (q - x).detach()


@dataclass(frozen=True)
class UNetCfg:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attn_down: Tuple[bool, ...] = (True, True, True, False)
    num_heads: int = 8
    head_dim: Optional[int] = None
    use_linear_projection: bool = False


@dataclass(frozen=True)
class VAECfg:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215


def attention(q, k, v):
    """(B, Lq, H, D) x (B, Lk, H, D) -> (B, Lq, H, D) float32."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    q, k, v = q.float(), k.float(), v.float()
    out = torch.empty((B, Lq, H, D), dtype=torch.float32, device=q.device)
    # blocks of queries bound the scores' memory; on the meta device, where
    # only the work is counted, one block does
    step = Lq if q.device.type == "meta" else \
        max(1, SCORE_BLOCK // max(1, B * H * Lk))
    for i in range(0, Lq, step):
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, i:i + step], k) / math.sqrt(D)
        out[:, i:i + step] = torch.einsum("bhqk,bkhd->bqhd",
                                          torch.softmax(s, -1), v)
    return out


class Dense(nn.Linear):
    def __init__(self, i, o, bias=True, quant=Quant()):
        super().__init__(i, o, bias=bias)
        self.quant = quant

    def forward(self, x):
        q = self.quant
        return F.linear(q(x.float()), q(self.weight.float()),
                        None if self.bias is None else self.bias.float())


class Conv(nn.Conv2d):
    def __init__(self, i, o, k, stride=1, padding=0, quant=Quant()):
        super().__init__(i, o, k, stride=stride, padding=padding)
        self.quant = quant

    def forward(self, x):
        q = self.quant
        return F.conv2d(q(x.float()), q(self.weight.float()),
                        self.bias.float(), self.stride, self.padding)


class GroupNorm(nn.Module):
    def __init__(self, groups, ch, eps=1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return F.group_norm(x.float(), self.groups, self.weight.float(),
                            self.bias.float(), self.eps)


class LayerNorm(nn.Module):
    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                            self.bias.float(), self.eps)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def timestep_embedding(t, dim, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    a = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(a), torch.sin(a)], -1)


class CrossAttention(nn.Module):
    def __init__(self, dim, ctx_dim, heads, dim_head, ip, quant):
        super().__init__()
        inner = heads * dim_head
        self.is_self = ctx_dim is None
        ctx_dim = dim if ctx_dim is None else ctx_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(dim, inner, False, quant)
        self.to_k = Dense(ctx_dim, inner, False, quant)
        self.to_v = Dense(ctx_dim, inner, False, quant)
        self.to_out = nn.ModuleList([Dense(inner, dim, True, quant)])
        if ip and not self.is_self:
            self.ip_to_k = Dense(ctx_dim, inner, False, quant)
            self.ip_to_v = Dense(ctx_dim, inner, False, quant)

    def forward(self, x, context, mode, ip_context=None):
        B, L, C = x.shape
        nv = mode["num_views"]
        if context is None:
            ctx = x
            if nv > 1:
                x = x.reshape(B // nv, nv * L, C)
                ctx = x
        else:
            ctx = context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads,
                             self.dim_head)
        out = attention(split(q), split(k), split(v)).reshape(
            q.shape[0], q.shape[1], -1)
        if not self.is_self and mode["ip_tokens"] > 0 \
                and ip_context is not None:
            ip = attention(split(q), split(self.ip_to_k(ip_context)),
                           split(self.ip_to_v(ip_context)))
            out = out + mode["ip_scale"] * ip.reshape(out.shape)
        return self.to_out[0](out.reshape(B, L, -1))


class GEGLU(nn.Module):
    def __init__(self, dim, inner, quant):
        super().__init__()
        self.proj = Dense(dim, inner * 2, True, quant)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, -1)
        return a * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim, quant):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4, quant), nn.Identity(),
                                  Dense(dim * 4, dim, True, quant)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class Block(nn.Module):
    def __init__(self, dim, heads, dim_head, ctx_dim, ip, quant):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, heads, dim_head, ip, quant)
        self.attn2 = CrossAttention(dim, ctx_dim, heads, dim_head, ip, quant)
        self.norm1, self.norm2, self.norm3 = (LayerNorm(dim)
                                              for _ in range(3))
        self.ff = FeedForward(dim, quant)

    def forward(self, x, ctx, mode, ip_context):
        x = x + self.attn1(self.norm1(x), None, mode)
        x = x + self.attn2(self.norm2(x), ctx, mode, ip_context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, ch, heads, dim_head, ctx_dim, linear, ip, quant):
        super().__init__()
        self.linear = linear
        self.norm = GroupNorm(32, ch, 1e-6)
        if linear:
            self.proj_in = Dense(ch, ch, True, quant)
            self.proj_out = Dense(ch, ch, True, quant)
        else:
            self.proj_in = Conv(ch, ch, 1, quant=quant)
            self.proj_out = Conv(ch, ch, 1, quant=quant)
        self.transformer_blocks = nn.ModuleList(
            [Block(ch, heads, dim_head, ctx_dim, ip, quant)])

    def forward(self, x, ctx, mode, ip_context=None):
        B, C, H, W = x.shape
        h = self.norm(x)
        if self.linear:
            h = self.proj_in(nhwc(h).reshape(B, H * W, C))
        else:
            h = nhwc(self.proj_in(h)).reshape(B, H * W, C)
        h = self.transformer_blocks[0](h, ctx, mode, ip_context)
        if self.linear:
            h = nchw(self.proj_out(h).reshape(B, H, W, C))
        else:
            h = self.proj_out(nchw(h.reshape(B, H, W, C)))
        return h + x


class Resnet(nn.Module):
    def __init__(self, i, o, temb, quant, eps=1e-5):
        super().__init__()
        self.norm1 = GroupNorm(32, i, eps)
        self.conv1 = Conv(i, o, 3, padding=1, quant=quant)
        self.time_emb_proj = Dense(temb, o, True, quant) if temb else None
        self.norm2 = GroupNorm(32, o, eps)
        self.conv2 = Conv(o, o, 3, padding=1, quant=quant)
        self.conv_shortcut = Conv(i, o, 1, quant=quant) if i != o else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Sampler(nn.Module):
    def __init__(self, ch, stride, quant, padding=1):
        super().__init__()
        self.conv = Conv(ch, ch, 3, stride=stride, padding=padding,
                         quant=quant)


def _heads(cfg, ch):
    if cfg.head_dim is not None:
        return ch // cfg.head_dim, cfg.head_dim
    return cfg.num_heads, ch // cfg.num_heads


def _transformer(cfg, ch, ip, quant):
    nh, hd = _heads(cfg, ch)
    return Transformer2D(ch, nh, hd, cfg.cross_attention_dim,
                         cfg.use_linear_projection, ip, quant)


class TimeEmbedding(nn.Module):
    def __init__(self, c0, quant):
        super().__init__()
        self.linear_1 = Dense(c0, c0 * 4, True, quant)
        self.linear_2 = Dense(c0 * 4, c0 * 4, True, quant)

    def forward(self, t):
        return self.linear_2(F.silu(self.linear_1(t)))


class DownBlock(nn.Module):
    def __init__(self, cfg, bi, in_ch, ip, quant):
        super().__init__()
        ch, temb = cfg.block_out_channels[bi], cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList([
            Resnet(in_ch if li == 0 else ch, ch, temb, quant)
            for li in range(cfg.layers_per_block)])
        if cfg.attn_down[bi]:
            self.attentions = nn.ModuleList([
                _transformer(cfg, ch, ip, quant)
                for _ in range(cfg.layers_per_block)])
        if bi != len(cfg.block_out_channels) - 1:
            self.downsamplers = nn.ModuleList([Sampler(ch, 2, quant)])


class UpBlock(nn.Module):
    def __init__(self, cfg, ui, prev, ip, quant):
        super().__init__()
        boc = cfg.block_out_channels
        n = len(boc)
        bi = n - 1 - ui
        ch, temb = boc[bi], boc[0] * 4
        self.resnets = nn.ModuleList()
        for li in range(cfg.layers_per_block + 1):
            skip = boc[bi] if li < cfg.layers_per_block else \
                boc[max(bi - 1, 0)]
            self.resnets.append(Resnet((prev if li == 0 else ch) + skip, ch,
                                       temb, quant))
        if cfg.attn_down[bi]:
            self.attentions = nn.ModuleList([
                _transformer(cfg, ch, ip, quant)
                for _ in range(cfg.layers_per_block + 1)])
        if ui != n - 1:
            self.upsamplers = nn.ModuleList([Sampler(ch, 1, quant)])


class MidBlock(nn.Module):
    def __init__(self, cfg, ip, quant):
        super().__init__()
        ch, temb = cfg.block_out_channels[-1], cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList([Resnet(ch, ch, temb, quant)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([_transformer(cfg, ch, ip, quant)])


def run_encoder(down_blocks, mid, h, temb, ehs, mode, ip_context=None):
    residuals = [h]
    for blk in down_blocks:
        for li, res in enumerate(blk.resnets):
            h = res(h, temb)
            if hasattr(blk, "attentions"):
                h = blk.attentions[li](h, ehs, mode, ip_context)
            residuals.append(h)
        if hasattr(blk, "downsamplers"):
            h = blk.downsamplers[0].conv(h)
            residuals.append(h)
    h = mid.resnets[0](h, temb)
    h = mid.attentions[0](h, ehs, mode, ip_context)
    return mid.resnets[1](h, temb), residuals


NO_MODE = {"num_views": 1, "ip_tokens": 0, "ip_scale": 1.0}


class UNet(nn.Module):
    """forward(sample, timesteps, ehs, part, mode, down_block_res,
    mid_block_res, enc_state, ip_context), as the port's: 'all' and 'dec'
    return epsilon (B, H, W, out), 'enc' the encoder state (h, residuals,
    temb, ehs)."""

    def __init__(self, cfg=UNetCfg(), ip=False, quant=Quant()):
        super().__init__()
        self.cfg = cfg
        boc = cfg.block_out_channels
        self.time_embedding = TimeEmbedding(boc[0], quant)
        self.conv_in = Conv(cfg.in_channels, boc[0], 3, padding=1,
                            quant=quant)
        self.down_blocks = nn.ModuleList()
        prev = boc[0]
        for bi, ch in enumerate(boc):
            self.down_blocks.append(DownBlock(cfg, bi, prev, ip, quant))
            prev = ch
        self.mid_block = MidBlock(cfg, ip, quant)
        self.up_blocks = nn.ModuleList()
        for ui in range(len(boc)):
            self.up_blocks.append(UpBlock(cfg, ui, prev, ip, quant))
            prev = boc[len(boc) - 1 - ui]
        self.conv_norm_out = GroupNorm(32, boc[0], 1e-5)
        self.conv_out = Conv(boc[0], cfg.out_channels, 3, padding=1,
                             quant=quant)

    def encode(self, sample, timesteps, ehs, mode, ip_context=None):
        temb = self.time_embedding(timestep_embedding(
            timesteps, self.cfg.block_out_channels[0]))
        h = self.conv_in(nchw(sample.float()))
        ehs = ehs.float()
        ip_context = None if ip_context is None else ip_context.float()
        h, residuals = run_encoder(self.down_blocks, self.mid_block, h, temb,
                                   ehs, mode, ip_context)
        return {"h": h, "residuals": residuals, "temb": temb, "ehs": ehs}

    def decode(self, enc, mode, down_block_res=None, mid_block_res=None,
               ip_context=None):
        ip_context = None if ip_context is None else ip_context.float()
        h, temb, ehs = (enc["h"].float(), enc["temb"].float(),
                        enc["ehs"].float())
        residuals = [r.float() for r in enc["residuals"]]
        if down_block_res is not None:
            residuals = [r + nchw(c.float())
                         for r, c in zip(residuals, down_block_res)]
        if mid_block_res is not None:
            h = h + nchw(mid_block_res.float())
        for blk in self.up_blocks:
            for li, res in enumerate(blk.resnets):
                h = res(torch.cat([h, residuals.pop()], 1), temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[li](h, ehs, mode, ip_context)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(
                    F.interpolate(h, scale_factor=2, mode="nearest"))
        return nhwc(self.conv_out(F.silu(self.conv_norm_out(h))))

    def forward(self, sample, timesteps, encoder_hidden_states, part="all",
                mode=NO_MODE, down_block_res=None, mid_block_res=None,
                enc_state=None, ip_context=None):
        if part != "dec":
            enc_state = self.encode(sample, timesteps, encoder_hidden_states,
                                    mode, ip_context)
            if part == "enc":
                return enc_state
        return self.decode(enc_state, mode, down_block_res, mid_block_res,
                           ip_context)


HINT_CHANNELS = (16, 32, 32, 96, 96, 256)


class CondEmbedding(nn.Module):
    def __init__(self, cond_ch, out_ch, hint_strides, quant):
        super().__init__()
        self.conv_in = Conv(cond_ch, 16, 3, padding=1, quant=quant)
        self.blocks = nn.ModuleList()
        prev, n = 16, 0
        for i, ch in enumerate(HINT_CHANNELS):
            stride = 2 if (i % 2 == 1 and n < hint_strides) else 1
            n += stride == 2
            self.blocks.append(Conv(prev, ch, 3, stride=stride, padding=1,
                                    quant=quant))
            prev = ch
        self.conv_out = Conv(prev, out_ch, 3, padding=1, quant=quant)

    def forward(self, c):
        c = F.silu(self.conv_in(c))
        for blk in self.blocks:
            c = F.silu(blk(c))
        return self.conv_out(c)


class ControlNet(nn.Module):
    """forward(sample, timesteps, ehs, cond_image, conditioning_scale,
    mode) -> (down residuals, mid residual), NHWC."""

    def __init__(self, cfg=UNetCfg(), hint_strides=3, quant=Quant()):
        super().__init__()
        self.cfg = cfg
        boc = cfg.block_out_channels
        self.time_embedding = TimeEmbedding(boc[0], quant)
        self.conv_in = Conv(cfg.in_channels, boc[0], 3, padding=1,
                            quant=quant)
        self.controlnet_cond_embedding = CondEmbedding(3, boc[0],
                                                       hint_strides, quant)
        self.down_blocks = nn.ModuleList()
        prev, res_ch = boc[0], [boc[0]]
        for bi, ch in enumerate(boc):
            self.down_blocks.append(DownBlock(cfg, bi, prev, False, quant))
            res_ch += [ch] * cfg.layers_per_block
            if bi != len(boc) - 1:
                res_ch.append(ch)
            prev = ch
        self.mid_block = MidBlock(cfg, False, quant)
        self.controlnet_down_blocks = nn.ModuleList(
            [Conv(c, c, 1, quant=quant) for c in res_ch])
        self.controlnet_mid_block = Conv(boc[-1], boc[-1], 1, quant=quant)

    def forward(self, sample, timesteps, encoder_hidden_states, cond_image,
                conditioning_scale=1.0, mode=NO_MODE):
        temb = self.time_embedding(timestep_embedding(
            timesteps, self.cfg.block_out_channels[0]))
        h = self.conv_in(nchw(sample.float()))
        h = h + self.controlnet_cond_embedding(nchw(cond_image.float()))
        h, residuals = run_encoder(self.down_blocks, self.mid_block, h, temb,
                                   encoder_hidden_states.float(), mode)
        downs = [nhwc(conv(r) * conditioning_scale)
                 for conv, r in zip(self.controlnet_down_blocks, residuals)]
        return downs, nhwc(self.controlnet_mid_block(h) * conditioning_scale)


class VAEAttention(nn.Module):
    def __init__(self, ch, quant):
        super().__init__()
        self.group_norm = GroupNorm(32, ch, 1e-6)
        self.to_q, self.to_k, self.to_v = (Dense(ch, ch, True, quant)
                                           for _ in range(3))
        self.to_out = nn.ModuleList([Dense(ch, ch, True, quant)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = nhwc(self.group_norm(x)).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        out = attention(q[:, :, None], k[:, :, None], v[:, :, None])
        out = self.to_out[0](out.reshape(B, H * W, C))
        return x + nchw(out.reshape(B, H, W, C))


class Mid(nn.Module):
    def __init__(self, ch, quant):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(ch, ch, 0, quant, 1e-6)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, quant)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class VBlock(nn.Module):
    def __init__(self, resnets, name=None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            self.add_module(name, nn.ModuleList([sampler]))


class Encoder(nn.Module):
    def __init__(self, cfg, quant):
        super().__init__()
        boc = cfg.block_out_channels
        self.conv_in = Conv(cfg.in_channels, boc[0], 3, padding=1,
                            quant=quant)
        self.down_blocks = nn.ModuleList()
        prev = boc[0]
        for bi, ch in enumerate(boc):
            last = bi == len(boc) - 1
            self.down_blocks.append(VBlock(
                [Resnet(prev if li == 0 else ch, ch, 0, quant, 1e-6)
                 for li in range(cfg.layers_per_block)], "downsamplers",
                None if last else Sampler(ch, 2, quant, padding=0)))
            prev = ch
        self.mid_block = Mid(boc[-1], quant)
        self.conv_norm_out = GroupNorm(32, boc[-1], 1e-6)
        self.conv_out = Conv(boc[-1], 2 * cfg.latent_channels, 3, padding=1,
                             quant=quant)

    def forward(self, x):
        h = self.conv_in(x.float())
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg, quant):
        super().__init__()
        boc = cfg.block_out_channels
        self.conv_in = Conv(cfg.latent_channels, boc[-1], 3, padding=1,
                            quant=quant)
        self.mid_block = Mid(boc[-1], quant)
        self.up_blocks = nn.ModuleList()
        prev = boc[-1]
        for ui, ch in enumerate(reversed(boc)):
            last = ui == len(boc) - 1
            self.up_blocks.append(VBlock(
                [Resnet(prev if li == 0 else ch, ch, 0, quant, 1e-6)
                 for li in range(cfg.layers_per_block + 1)], "upsamplers",
                None if last else Sampler(ch, 1, quant)))
            prev = ch
        self.conv_norm_out = GroupNorm(32, boc[0], 1e-6)
        self.conv_out = Conv(boc[0], 3, 3, padding=1, quant=quant)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z.float()))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(
                    F.interpolate(h, scale_factor=2, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VAE(nn.Module):
    """decode(z) and encode(x, noise), as the port's `AutoencoderKL`."""

    def __init__(self, cfg=VAECfg(), quant=Quant()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, quant)
        self.decoder = Decoder(cfg, quant)
        lc = 2 * cfg.latent_channels
        self.quant_conv = Conv(lc, lc, 1, quant=quant)
        self.post_quant_conv = Conv(cfg.latent_channels, cfg.latent_channels,
                                    1, quant=quant)

    def encode(self, x, noise=None):
        moments = self.quant_conv(self.encoder(nchw(x.float())))
        mean, logvar = moments.chunk(2, 1)
        z = nhwc(mean)
        if noise is not None:
            z = z + torch.exp(0.5 * nhwc(logvar.clamp(-30.0, 20.0))) \
                * noise.float()
        return z * self.cfg.scaling_factor

    def decode(self, z):
        z = self.post_quant_conv(nchw(z.float() / self.cfg.scaling_factor))
        return nhwc(self.decoder(z))
