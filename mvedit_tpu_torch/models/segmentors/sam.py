"""Segment Anything (SAM): box-prompted mask refinement (counterpart of
`mvedit_tpu/models/segmentors/sam.py`).

The reference loads segment-anything's ViT-H (`sam_vit_h_4b8939.pth`) and
prompts it with the segmenter's box, keeping the last of the three
multimask outputs. The modules here carry segment-anything's own names, so
that checkpoint's state dict loads as it is:

- `ImageEncoderViT`: 16 x 16 patches, 14 x 14 windowed attention except
  the global blocks (`global_attn_indexes`), decomposed relative
  positions (`_get_rel_pos`, `_add_decomposed_rel_pos`), the absolute
  `pos_embed`, and the conv neck with `LayerNorm2d` to the 256-channel
  image embedding;
- `PromptEncoder`: random-Fourier encoding of the two box corners plus the
  corner-type embeddings, and the no-mask dense embedding
  (`not_a_point_embed` and `mask_downscaling` load with the checkpoint
  and serve no box prompt);
- `MaskDecoder`: the two-way transformer over [iou token, 4 mask tokens,
  box tokens] x the image embedding, the transposed-convolution 4x
  upscaling, the hypernetwork MLPs -> three multimask outputs and their
  IoU predictions.

Attention is a plain matmul and softmax, as in the reference (whose global
blocks add the relative-position bias, which no flash kernel takes). The
model runs in float32. The decoder's layer norms take flax's eps of 1e-6
(segment-anything's are torch's 1e-5), as the reference computes them.

`sam_state_from_flax` turns the reference's params into this state dict.
The reference's `_convT` maps segment-anything's `ConvTranspose2d` weights
to flax's `ConvTranspose` without the spatial flip a transposed
convolution needs, so its decoder places every 2 x 2 block of each
upscaling mirrored against segment-anything's; the bridge flips the
kernels so that both packages compute the same function on its weights
(ROADMAP Queue 3, reference behaviours).
"""
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.image import resize_bilinear
from ..diffusion.norm import LayerNorm

__all__ = ["SAMConfig", "SAM_VIT_H", "SAM_TINY", "SamModel",
           "sam_preprocess", "sam_predict_box", "sam_state_from_flax"]

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


@dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    window_size: int = 14
    out_chans: int = 256          # image embedding channels
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_multimask: int = 3

    @property
    def tokens_hw(self):
        return self.img_size // self.patch_size


SAM_VIT_H = SAMConfig()
# the tests' configuration: the same topology at toy sizes
SAM_TINY = SAMConfig(img_size=64, patch_size=8, embed_dim=32, depth=2,
                     num_heads=4, global_attn_indexes=(1,), window_size=4,
                     out_chans=32, decoder_mlp_dim=64)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW tensor."""

    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mu = x.mean(1, keepdim=True)
        var = ((x - mu) ** 2).mean(1, keepdim=True)
        x = (x - mu) / torch.sqrt(var + self.eps)
        return x * self.weight[:, None, None] + self.bias[:, None, None]


class _MLPBlock(nn.Module):
    def __init__(self, dim, hidden, act):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


def _get_rel_pos(q_size, k_size, rel_pos):
    """The relative-position table's rows for every (query, key) pair
    (q_size, k_size, dim), the table resized linearly where its length is
    not 2 max(q_size, k_size) - 1."""
    max_rel = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel:
        rel_pos = resize_bilinear(rel_pos[:, None, :], (max_rel, 1))[:, 0]
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] \
        * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] \
        * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def _add_decomposed_rel_pos(attn, q, rel_h, rel_w, q_hw, k_hw):
    """attn (B, qh qw, kh kw) plus the query's products with the height
    and the width tables."""
    qh, qw = q_hw
    kh, kw = k_hw
    Rh = _get_rel_pos(qh, kh, rel_h)
    Rw = _get_rel_pos(qw, kw, rel_w)
    B = q.shape[0]
    r_q = q.reshape(B, qh, qw, -1)
    rel_h_term = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w_term = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = attn.reshape(B, qh, qw, kh, kw) + rel_h_term[..., :, None] \
        + rel_w_term[..., None, :]
    return attn.reshape(B, qh * qw, kh * kw)


class _Attention(nn.Module):
    """Multi-head self-attention over an (B, H, W, C) grid with decomposed
    relative positions."""

    def __init__(self, dim, num_heads, input_size):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, hd))

    def forward(self, x):
        B, H, W, C = x.shape
        nh = self.num_heads
        hd = C // nh
        qkv = self.qkv(x).reshape(B, H * W, 3, nh, hd).permute(
            2, 0, 3, 1, 4).reshape(3, B * nh, H * W, hd)
        q, k, v = qkv.unbind(0)
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        attn = _add_decomposed_rel_pos(attn, q, self.rel_pos_h,
                                       self.rel_pos_w, (H, W), (H, W))
        attn = attn.softmax(-1)
        x = (attn @ v).reshape(B, nh, H * W, hd).transpose(1, 2)
        return self.proj(x.reshape(B, H, W, C))


def _window_partition(x, ws):
    B, H, W, C = x.shape
    ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C), (Hp, Wp)


def _window_unpartition(wins, ws, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = wins.shape[0] // (Hp * Wp // ws // ws)
    x = wins.reshape(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


class _Block(nn.Module):
    def __init__(self, cfg: SAMConfig, windowed):
        super().__init__()
        c = cfg
        self.window_size = c.window_size if windowed else 0
        self.norm1 = LayerNorm(c.embed_dim)
        self.attn = _Attention(c.embed_dim, c.num_heads,
                               c.window_size if windowed else c.tokens_hw)
        self.norm2 = LayerNorm(c.embed_dim)
        self.mlp = _MLPBlock(c.embed_dim, 4 * c.embed_dim, nn.GELU())

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        hw = x.shape[1:3]
        if self.window_size:
            x, pad_hw = _window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size:
            x = _window_unpartition(x, self.window_size, pad_hw, hw)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size,
                              stride=cfg.patch_size)

    def forward(self, x):
        return self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    """(B, S, S, 3) normalised pixels -> (B, t, t, out_chans)."""

    def __init__(self, cfg: SAMConfig):
        super().__init__()
        c = cfg
        t = c.tokens_hw
        self.patch_embed = _PatchEmbed(c)
        self.pos_embed = nn.Parameter(torch.zeros(1, t, t, c.embed_dim))
        self.blocks = nn.ModuleList(
            [_Block(c, windowed=i not in c.global_attn_indexes)
             for i in range(c.depth)])
        self.neck = nn.Sequential(
            nn.Conv2d(c.embed_dim, c.out_chans, 1, bias=False),
            LayerNorm2d(c.out_chans),
            nn.Conv2d(c.out_chans, c.out_chans, 3, padding=1, bias=False),
            LayerNorm2d(c.out_chans))

    def forward(self, x):
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def forward(self, coords):
        """coords in [0, 1]^2 (..., 2) -> (..., 2 num_pos_feats)."""
        proj = (2.0 * math.pi) * (
            (2.0 * coords - 1.0) @ self.positional_encoding_gaussian_matrix)
        return torch.cat([torch.sin(proj), torch.cos(proj)], -1)


class PromptEncoder(nn.Module):
    """A box -> 2 sparse tokens; the no-mask dense embedding; the image
    grid's positional encoding."""

    def __init__(self, cfg: SAMConfig, mask_in_chans=16):
        super().__init__()
        c = cfg.out_chans
        self.cfg = cfg
        self.pe_layer = _PositionEmbeddingRandom(c // 2)
        # corner types: 2 top-left, 3 bottom-right (0 / 1: click labels)
        self.point_embeddings = nn.ModuleList(
            [nn.Embedding(1, c) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, c)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, 2, stride=2),
            LayerNorm2d(mask_in_chans // 4), nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, stride=2),
            LayerNorm2d(mask_in_chans), nn.GELU(),
            nn.Conv2d(mask_in_chans, c, 1))
        self.no_mask_embed = nn.Embedding(1, c)

    def encode_box(self, box):
        """box (4,) = (x1, y1, x2, y2) in model-input pixels -> (2, C)."""
        pts = (box.reshape(2, 2) + 0.5) / self.cfg.img_size
        emb = self.pe_layer(pts)
        return emb + torch.cat([self.point_embeddings[2].weight,
                                self.point_embeddings[3].weight], 0)

    def dense_pe(self):
        """The positional encoding of the t x t embedding grid (t, t, C),
        from (x, y) cell centres."""
        t = self.cfg.tokens_hw
        ar = torch.arange(t, device=self.no_mask_embed.weight.device)
        g = (torch.stack(torch.meshgrid(ar, ar, indexing="ij"), -1)
             + 0.5) / t
        return self.pe_layer(g.flip(-1).float())

    def forward(self, box):
        return self.encode_box(box), self.no_mask_embed.weight[0], \
            self.dense_pe()


class _DecoderAttention(nn.Module):
    def __init__(self, dim, heads, downsample=1):
        super().__init__()
        d = dim // downsample
        self.heads = heads
        self.q_proj = nn.Linear(dim, d)
        self.k_proj = nn.Linear(dim, d)
        self.v_proj = nn.Linear(dim, d)
        self.out_proj = nn.Linear(d, dim)

    def forward(self, q, k, v):
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        d = q.shape[-1]
        hd = d // self.heads

        def split(x):
            return x.reshape(*x.shape[:-1], self.heads, hd).transpose(-3, -2)
        qh, kh, vh = split(q), split(k), split(v)
        a = (qh @ kh.transpose(-1, -2) * hd ** -0.5).softmax(-1)
        o = (a @ vh).transpose(-3, -2).reshape(*q.shape[:-1], d)
        return self.out_proj(o)


class _TwoWayBlock(nn.Module):
    def __init__(self, cfg: SAMConfig, skip_first_pe):
        super().__init__()
        d, h = cfg.out_chans, cfg.decoder_heads
        self.skip_first_pe = skip_first_pe
        self.self_attn = _DecoderAttention(d, h)
        self.norm1 = LayerNorm(d)
        self.cross_attn_token_to_image = _DecoderAttention(d, h, 2)
        self.norm2 = LayerNorm(d)
        self.mlp = _MLPBlock(d, cfg.decoder_mlp_dim, nn.ReLU())
        self.norm3 = LayerNorm(d)
        self.norm4 = LayerNorm(d)
        self.cross_attn_image_to_token = _DecoderAttention(d, h, 2)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_pe:
            # the first layer replaces the queries (no residual)
            queries = self.self_attn(queries, queries, queries)
        else:
            qp = queries + query_pe
            queries = queries + self.self_attn(qp, qp, queries)
        queries = self.norm1(queries)
        qp, kp = queries + query_pe, keys + key_pe
        queries = self.norm2(
            queries + self.cross_attn_token_to_image(qp, kp, keys))
        queries = self.norm3(queries + self.mlp(queries))
        qp, kp = queries + query_pe, keys + key_pe
        keys = self.norm4(
            keys + self.cross_attn_image_to_token(kp, qp, queries))
        return queries, keys


class _TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d = cfg.out_chans
        self.layers = nn.ModuleList(
            [_TwoWayBlock(cfg, skip_first_pe=i == 0)
             for i in range(cfg.decoder_depth)])
        self.final_attn_token_to_image = _DecoderAttention(
            d, cfg.decoder_heads, 2)
        self.norm_final_attn = LayerNorm(d)

    def forward(self, keys, key_pe, tokens):
        queries = tokens
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        qp, kp = queries + tokens, keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(qp, kp, keys))
        return queries, keys


class _MLP(nn.Module):
    """Linear layers with ReLU between them, in `layers`."""

    def __init__(self, dims):
        super().__init__()
        self.layers = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d, n = cfg.out_chans, cfg.num_multimask + 1
        self.transformer = _TwoWayTransformer(cfg)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(n, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, stride=2), LayerNorm2d(d // 4),
            nn.GELU(), nn.ConvTranspose2d(d // 4, d // 8, 2, stride=2),
            nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            [_MLP((d, d, d, d // 8)) for _ in range(n)])
        self.iou_prediction_head = _MLP((d, d, d, n))

    def forward(self, img_emb, img_pe, sparse_tokens, dense_emb):
        """img_emb (t, t, C), img_pe (t, t, C), sparse_tokens (S, C),
        dense_emb (C,) -> (masks (3, 4t, 4t), iou (3,)): mask tokens 1-3,
        the multimask outputs (token 0 is the single-mask output)."""
        t, d = img_emb.shape[0], img_emb.shape[-1]
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight,
                            sparse_tokens], 0)
        keys = (img_emb + dense_emb).reshape(t * t, d)
        queries, keys = self.transformer(keys, img_pe.reshape(t * t, d),
                                         tokens)
        n = self.mask_tokens.weight.shape[0]
        src = self.output_upscaling(keys.t().reshape(1, d, t, t))[0]
        hyper = torch.stack([mlp(queries[1 + i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)])
        masks = torch.einsum("nc,chw->nhw", hyper, src)
        iou = self.iou_prediction_head(queries[0])
        return masks[1:n], iou[1:n]


class SamModel(nn.Module):
    def __init__(self, cfg: SAMConfig = SAM_VIT_H):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)

    def encode_image(self, x):
        return self.image_encoder(x)

    def decode_box(self, img_emb, box):
        sparse, no_mask, dense_pe = self.prompt_encoder(box)
        return self.mask_decoder(img_emb, dense_pe, sparse, no_mask)

    def forward(self, x, box):
        """x (1, S, S, 3) normalised, box (4,) in model pixels -> (masks
        (3, 4t, 4t) logits, iou (3,))."""
        return self.decode_box(self.encode_image(x)[0], box)


def sam_preprocess(image, cfg: SAMConfig = SAM_VIT_H):
    """(H, W, 3) float tensor in [0, 1] -> (1, S, S, 3) normalised: the
    longest side resized to `img_size` (antialiased bilinear, as
    `jax.image.resize`), padded with zeros at the bottom and right; and
    (nh, nw, H, W, scale) to undo it."""
    H, W = image.shape[:2]
    S = cfg.img_size
    scale = S / max(H, W)
    nh, nw = int(round(H * scale)), int(round(W * scale))
    x = resize_bilinear(image.float()[None] * 255.0, (nh, nw))[0]
    mean = torch.tensor(PIXEL_MEAN, device=x.device)
    std = torch.tensor(PIXEL_STD, device=x.device)
    x = F.pad((x - mean) / std, (0, 0, 0, S - nw, 0, S - nh))
    return x[None], (nh, nw, H, W, scale)


@torch.inference_mode()
def sam_predict_box(model, image, box_xyxy, cfg=None):
    """The reference's predict call: one box prompt (in image pixels), the
    three multimask outputs, the last one kept, its logits resized to
    `img_size`, cropped to the image's part, resized to (H, W) and
    thresholded at 0. image: (H, W, 3) in [0, 1], a tensor on the model's
    device. Returns an (H, W) float32 {0, 1} tensor."""
    cfg = cfg or model.cfg
    x, (nh, nw, H, W, scale) = sam_preprocess(image, cfg)
    box = torch.as_tensor(np.asarray(box_xyxy, np.float32),
                          device=x.device) * scale
    masks, _ = model(x, box)
    m = masks[-1][..., None]
    if m.shape[0] != cfg.img_size:
        m = resize_bilinear(m, (cfg.img_size, cfg.img_size))
    m = resize_bilinear(m[:nh, :nw], (H, W))[..., 0]
    return (m > 0.0).float()


def sam_state_from_flax(params, cfg: SAMConfig = SAM_VIT_H):
    """The reference's SAM params (numpy-convertible leaves) -> this
    model's state dict (segment-anything's keys). The upscaling kernels
    are flipped in (kh, kw) (see the module doc); the keys the reference
    has no params for (`not_a_point_embed`, `mask_downscaling`) are
    absent."""
    sd = {}

    def arr(x):
        return np.array(x, np.float32)

    def lin(prefix, p):
        sd[prefix + ".weight"] = arr(p["kernel"]).T
        sd[prefix + ".bias"] = arr(p["bias"])

    def conv(prefix, p):
        sd[prefix + ".weight"] = arr(p["kernel"]).transpose(3, 2, 0, 1)
        if "bias" in p:
            sd[prefix + ".bias"] = arr(p["bias"])

    def norm(prefix, p):
        sd[prefix + ".weight"] = arr(p["scale"] if "scale" in p
                                     else p["weight"])
        sd[prefix + ".bias"] = arr(p["bias"])

    def conv_t(prefix, p):
        # (kh, kw, in, out) -> (in, out, kh, kw), spatially flipped
        sd[prefix + ".weight"] = arr(p["kernel"]).transpose(
            2, 3, 0, 1)[:, :, ::-1, ::-1]
        sd[prefix + ".bias"] = arr(p["bias"])

    enc = params["image_encoder"]
    conv("image_encoder.patch_embed.proj", enc["patch_embed"])
    sd["image_encoder.pos_embed"] = arr(enc["pos_embed"])
    conv("image_encoder.neck.0", enc["neck_conv1"])
    norm("image_encoder.neck.1", enc["neck_ln1"])
    conv("image_encoder.neck.2", enc["neck_conv2"])
    norm("image_encoder.neck.3", enc["neck_ln2"])
    for i in range(cfg.depth):
        b, p = enc[f"block_{i}"], f"image_encoder.blocks.{i}"
        norm(p + ".norm1", b["norm1"])
        norm(p + ".norm2", b["norm2"])
        lin(p + ".attn.qkv", b["attn"]["qkv"])
        lin(p + ".attn.proj", b["attn"]["proj"])
        sd[p + ".attn.rel_pos_h"] = arr(b["attn"]["rel_pos_h"])
        sd[p + ".attn.rel_pos_w"] = arr(b["attn"]["rel_pos_w"])
        lin(p + ".mlp.lin1", b["mlp_lin1"])
        lin(p + ".mlp.lin2", b["mlp_lin2"])

    pe = params["prompt_encoder"]
    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = \
        arr(pe["pe_gaussian"])
    for i in range(4):
        sd[f"prompt_encoder.point_embeddings.{i}.weight"] = \
            arr(pe["point_embeddings"])[i:i + 1]
    sd["prompt_encoder.no_mask_embed.weight"] = arr(pe["no_mask_embed"])[None]

    dec = params["mask_decoder"]

    def dec_attn(prefix, p):
        for n in ("q", "k", "v", "out"):
            lin(f"{prefix}.{n}_proj", p[n + "_proj"])
    sd["mask_decoder.iou_token.weight"] = arr(dec["iou_token"])
    sd["mask_decoder.mask_tokens.weight"] = arr(dec["mask_tokens"])
    conv_t("mask_decoder.output_upscaling.0", dec["upscale_conv1"])
    norm("mask_decoder.output_upscaling.1", dec["upscale_ln"])
    conv_t("mask_decoder.output_upscaling.3", dec["upscale_conv2"])
    tr = "mask_decoder.transformer"
    norm(tr + ".norm_final_attn", dec["norm_final"])
    dec_attn(tr + ".final_attn_token_to_image", dec["final_attn_t2i"])
    for i in range(cfg.decoder_depth):
        layer, p = dec[f"layer_{i}"], f"{tr}.layers.{i}"
        dec_attn(p + ".self_attn", layer["self_attn"])
        dec_attn(p + ".cross_attn_token_to_image", layer["cross_attn_t2i"])
        dec_attn(p + ".cross_attn_image_to_token", layer["cross_attn_i2t"])
        for j in range(1, 5):
            norm(f"{p}.norm{j}", layer[f"norm{j}"])
        lin(p + ".mlp.lin1", layer["mlp_lin1"])
        lin(p + ".mlp.lin2", layer["mlp_lin2"])
    for i in range(cfg.num_multimask + 1):
        for j in range(3):
            lin(f"mask_decoder.output_hypernetworks_mlps.{i}.layers.{j}",
                dec[f"hyper_{i}_lin{j}"])
    for j in range(3):
        lin(f"mask_decoder.iou_prediction_head.layers.{j}",
            dec[f"iou_lin{j}"])
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}
