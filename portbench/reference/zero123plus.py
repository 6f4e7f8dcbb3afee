"""Plain float32 reference of Zero123++ (sudo-ai's zero123plus-v1.2, Shi
et al., arXiv:2310.15110): its UNet's reference attention, the CLIP vision
tower, the ramped condition, the normal ControlNet's residuals into the
read pass and the v-prediction CFG step.

It builds on `diffusion.py`'s modules (the same parameter names as the
port's, so one seeded state fills both) and imports nothing of the port.
Every layer computes in float32 (TF32 off, `diffusion.no_tf32`) and
attention is written out in blocks of queries, so the full widths fit.

- Reference attention: a `reference="write"` pass of the noised
  condition latent stores each Transformer2D's self-attention input (its
  first block's `norm1` output), in the order down blocks, mid block, up
  blocks; a `reference="read"` pass of the grid's latents concatenates
  the stored state onto that self-attention's keys and values, so Lk =
  2 Lq at every level.
- The condition: the vision tower's projected class token, scaled per
  token by `ramping`, added to `text_uncond`.
- The sampler: trailing timesteps, Euler-ancestral on the v-prediction
  output, classifier-free guidance over the batch [uncond; cond].

Departures from the published models, as the port and the JAX package
make them: GELU in the tanh form (the feed-forwards' GEGLU and the ViT-H
tower's MLP), LayerNorm eps 1e-6.
"""
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import diffusion as RD

__all__ = ["UNet", "VisionCfg", "CLIPVision", "encode_condition",
           "sd_alphas_cumprod", "trailing_timesteps", "add_noise",
           "cfg_euler_ancestral", "sample", "scale_image", "unscale_image",
           "unscale_latents"]


class _Ref:
    """The states of one pass: appended in a write pass, taken back in
    order in a read pass."""

    def __init__(self, mode, states=None):
        self.mode = mode
        self.states = [] if states is None else list(states)
        self.next = 0

    def take(self):
        s = self.states[self.next]
        self.next += 1
        return s


def _self_attention(attn, x, kv):
    B, L, _ = x.shape
    q, k, v = attn.to_q(x), attn.to_k(kv), attn.to_v(kv)

    def split(t):
        return t.reshape(t.shape[0], t.shape[1], attn.heads, attn.dim_head)
    out = RD.attention(split(q), split(k), split(v))
    return attn.to_out[0](out.reshape(B, L, -1))


def _transformer(t, x, ctx, ref):
    """`diffusion.Transformer2D` with reference attention in its block."""
    B, C, H, W = x.shape
    h = t.norm(x)
    if t.linear:
        h = t.proj_in(RD.nhwc(h).reshape(B, H * W, C))
    else:
        h = RD.nhwc(t.proj_in(h)).reshape(B, H * W, C)
    blk = t.transformer_blocks[0]
    n1 = blk.norm1(h)
    kv = n1
    if ref.mode == "write":
        ref.states.append(n1)
    elif ref.mode == "read":
        kv = torch.cat([n1, ref.take().float()], 1)
    h = h + _self_attention(blk.attn1, n1, kv)
    h = h + blk.attn2(blk.norm2(h), ctx, RD.NO_MODE)
    h = h + blk.ff(blk.norm3(h))
    if t.linear:
        h = RD.nchw(t.proj_out(h).reshape(B, H, W, C))
    else:
        h = t.proj_out(RD.nchw(h.reshape(B, H, W, C)))
    return h + x


class UNet(RD.UNet):
    """`diffusion.UNet` with reference attention. forward(sample,
    timesteps, ehs, mode, ref_kv, down_block_res, mid_block_res): `mode`
    a dict (or None) whose `reference` is "write" (returns (out, the
    stored states)), "read" (reads `ref_kv`, the write pass's states) or
    "none"; the ControlNet's residuals, NHWC, add to the skips and the mid
    block's output. `tagged(tag, ...)` is forward with a leading tag."""

    def forward(self, sample, timesteps, encoder_hidden_states, mode=None,
                ref_kv=None, down_block_res=None, mid_block_res=None):
        reference = (mode or {}).get("reference", "none")
        ref = _Ref(reference, ref_kv)
        boc = self.cfg.block_out_channels
        temb = self.time_embedding(RD.timestep_embedding(timesteps, boc[0]))
        ehs = encoder_hidden_states.float()
        h = self.conv_in(RD.nchw(sample.float()))
        residuals = [h]
        for blk in self.down_blocks:
            for li, res in enumerate(blk.resnets):
                h = res(h, temb)
                if hasattr(blk, "attentions"):
                    h = _transformer(blk.attentions[li], h, ehs, ref)
                residuals.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(h)
                residuals.append(h)
        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h = _transformer(mid.attentions[0], h, ehs, ref)
        h = mid.resnets[1](h, temb)
        if down_block_res is not None:
            residuals = [r + RD.nchw(c.float())
                         for r, c in zip(residuals, down_block_res)]
        if mid_block_res is not None:
            h = h + RD.nchw(mid_block_res.float())
        for blk in self.up_blocks:
            for li, res in enumerate(blk.resnets):
                h = res(torch.cat([h, residuals.pop()], 1), temb)
                if hasattr(blk, "attentions"):
                    h = _transformer(blk.attentions[li], h, ehs, ref)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(
                    F.interpolate(h, scale_factor=2, mode="nearest"))
        out = RD.nhwc(self.conv_out(F.silu(self.conv_norm_out(h))))
        if reference == "write":
            return out, ref.states
        return out

    def tagged(self, tag, *args, **kwargs):
        return self(*args, **kwargs)


@dataclass(frozen=True)
class VisionCfg:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    projection_dim: int = 1024
    act: str = "gelu"


class _PatchConv(nn.Conv2d):
    def __init__(self, i, o, k, quant):
        super().__init__(i, o, k, stride=k, bias=False)
        self.quant = quant

    def forward(self, x):
        q = self.quant
        return F.conv2d(q(x.float()), q(self.weight.float()), None,
                        self.stride)


class _Embeddings(nn.Module):
    def __init__(self, cfg, quant):
        super().__init__()
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = _PatchConv(3, cfg.hidden_size,
                                          cfg.patch_size, quant)
        self.position_embedding = nn.Embedding(n, cfg.hidden_size)


class _Projections(nn.Module):
    def __init__(self, hidden, quant):
        super().__init__()
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            RD.Dense(hidden, hidden, True, quant) for _ in range(4))


class _MLP(nn.Module):
    def __init__(self, hidden, inter, quant):
        super().__init__()
        self.fc1 = RD.Dense(hidden, inter, True, quant)
        self.fc2 = RD.Dense(inter, hidden, True, quant)


class _Layer(nn.Module):
    def __init__(self, cfg, quant):
        super().__init__()
        self.heads, self.act = cfg.num_heads, cfg.act
        self.layer_norm1 = RD.LayerNorm(cfg.hidden_size)
        self.self_attn = _Projections(cfg.hidden_size, quant)
        self.layer_norm2 = RD.LayerNorm(cfg.hidden_size)
        self.mlp = _MLP(cfg.hidden_size, cfg.intermediate_size, quant)

    def forward(self, x):
        B, L, C = x.shape
        a, h = self.self_attn, self.layer_norm1(x)

        def split(t):
            return t.reshape(B, L, self.heads, C // self.heads)
        o = RD.attention(split(a.q_proj(h)), split(a.k_proj(h)),
                         split(a.v_proj(h))).reshape(B, L, C)
        x = x + a.out_proj(o)
        h = self.mlp.fc1(self.layer_norm2(x))
        if self.act == "quick_gelu":
            h = h * torch.sigmoid(1.702 * h)
        else:
            h = F.gelu(h, approximate="tanh")
        return x + self.mlp.fc2(h)


class _Encoder(nn.Module):
    def __init__(self, cfg, quant):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(cfg, quant)
                                     for _ in range(cfg.num_layers)])


class _Tower(nn.Module):
    def __init__(self, cfg, quant):
        super().__init__()
        self.embeddings = _Embeddings(cfg, quant)
        self.pre_layrnorm = RD.LayerNorm(cfg.hidden_size)
        self.encoder = _Encoder(cfg, quant)
        self.post_layernorm = RD.LayerNorm(cfg.hidden_size)


class CLIPVision(nn.Module):
    """The CLIP image tower with its projection (transformers'
    `CLIPVisionModelWithProjection`): pixels (B, S, S, 3) as the pipeline
    hands them -> the projected class token (B, projection_dim)."""

    def __init__(self, cfg=VisionCfg(), quant=RD.Quant()):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _Tower(cfg, quant)
        self.visual_projection = RD.Dense(cfg.hidden_size,
                                          cfg.projection_dim, False, quant)

    def forward(self, pixel_values):
        vm = self.vision_model
        emb = vm.embeddings
        B = pixel_values.shape[0]
        x = emb.patch_embedding(RD.nchw(pixel_values.float()))
        x = x.flatten(2).transpose(1, 2)
        cls = emb.class_embedding.float().expand(B, 1, -1)
        pos = emb.position_embedding.weight.float()[None]
        x = torch.cat([cls, x], 1) + pos
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


# ---------------------------------------------------------------------------
# the pipeline around the models

def unscale_latents(x):
    return x / 0.75 + 0.22


def scale_image(x):
    return x * 0.5 / 0.8


def unscale_image(x):
    return x / 0.5 * 0.8


def encode_condition(vision, pixels, text_uncond, ramping):
    """The prompt embeds (1, L, C): text_uncond + the global image embed
    times ramping[l] at token l."""
    emb = vision(pixels).float()
    ramp = torch.as_tensor(np.asarray(ramping, np.float32),
                           device=emb.device)[None, :, None]
    return text_uncond.float() + emb[:, None, :] * ramp


def sd_alphas_cumprod(n=1000, beta_start=0.00085, beta_end=0.012):
    """SD's scaled-linear schedule, float64."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, n) ** 2
    return np.cumprod(1.0 - betas)


def trailing_timesteps(num_steps, n=1000):
    return np.round(np.arange(n, 0, -n / num_steps)).astype(np.int64) - 1


def add_noise(acp, x0, noise, t):
    a = float(acp[t])
    return math.sqrt(a) * x0 + math.sqrt(1.0 - a) * noise


def cfg_euler_ancestral(acp, latents, out, scale, t, t_prev, noise):
    """One step from the UNet's v-prediction output `out` (2, ...) over
    [uncond; cond]: the guided v, its x0 and epsilon, then diffusers'
    Euler-ancestral step in sigma space to t_prev (-1: the end)."""
    out_u, out_c = out.float().chunk(2, 0)
    v = out_u + scale * (out_c - out_u)
    a_t = float(acp[t])
    x0 = math.sqrt(a_t) * latents - math.sqrt(1.0 - a_t) * v
    s_t = math.sqrt((1.0 - a_t) / a_t)
    a_p = float(acp[t_prev]) if t_prev >= 0 else 1.0
    s_p = math.sqrt((1.0 - a_p) / a_p)
    s_up = math.sqrt(max(s_p ** 2 * (s_t ** 2 - s_p ** 2) / s_t ** 2, 0.0))
    s_down = math.sqrt(max(s_p ** 2 - s_up ** 2, 0.0))
    x_sig = latents / math.sqrt(a_t)
    d = (x_sig - x0) / s_t
    x_sig = x_sig + d * (s_down - s_t) + noise * s_up
    return x_sig * math.sqrt(a_p)


def sample(models, cond_image, cond_pixels, draws, num_steps=40,
           guidance_scale=4.0, shift_views=False, normal_cond=None,
           cond_scale=1.0):
    """One Zero123++ pass. `models`: unet (`UNet`), vae (`diffusion.VAE`),
    vision (`CLIPVision`), ramping, text_uncond (1, L, C) and, for the
    normal pass, controlnet (`diffusion.ControlNet`); cond_image (1, H, W,
    3) and cond_pixels (1, S, S, 3) in [0, 1]; normal_cond (1, H, W, 3)
    the ControlNet's hint; `draws` = (initial latents, [(reference noise,
    ancestral noise) a step]). Returns the decoded grid (1, H, W, 3) in
    [0, 1]."""
    m = models
    acp = sd_alphas_cumprod()
    prompt = encode_condition(m.vision, cond_pixels, m.text_uncond,
                              m.ramping)
    embeds = torch.cat([m.text_uncond.float(), prompt], 0)
    cond_latent = m.vae.encode(scale_image(cond_image * 2 - 1))
    latents, steps = draws
    latents = latents.float()
    ts = trailing_timesteps(num_steps)
    hint = None if normal_cond is None else torch.cat([normal_cond] * 2, 0)
    for i, t in enumerate(ts):
        t = int(t)
        ref_noise, anc_noise = steps[i]
        t2 = torch.full((2,), t, dtype=torch.int32, device=latents.device)
        ref_lat = add_noise(acp, torch.cat([cond_latent] * 2, 0),
                            torch.cat([ref_noise.float()] * 2, 0), t)
        _, states = m.unet(ref_lat, t2, embeds, {"reference": "write"})
        lat2 = torch.cat([latents] * 2, 0)
        down = mid = None
        if hint is not None:
            down, mid = m.controlnet(lat2, t2, embeds, hint,
                                     conditioning_scale=cond_scale)
        out = m.unet(lat2, t2, embeds, {"reference": "read"}, states, down,
                     mid)
        t_prev = int(ts[i + 1]) if i + 1 < len(ts) else -1
        latents = cfg_euler_ancestral(acp, latents, out, guidance_scale, t,
                                      t_prev, anc_noise.float())
    latents = unscale_latents(latents)
    if shift_views:
        latents = torch.roll(latents, shifts=latents.shape[2] // 4, dims=2)
    img = unscale_image(m.vae.decode(latents))
    return ((img + 1) / 2).clamp(0.0, 1.0)
