"""DPT-hybrid monocular normal predictor (Omnidata).

Counterpart of `mvedit_tpu/models/segmentors/dpt.py`: timm's ResNetV2
stem and stages (3, 4, 9) -> ViT-B/16 over the /16 map (the first two
stages tapped as skip features) -> project-readout reassembly ->
RefineNet-style fusion -> a 3-channel ReLU head. Details kept: weight
standardisation (eps 1e-6) and timm's asymmetric "same" padding on the
stem and strided convs (`F.pad`), the stem max-pool padded with -inf,
GroupNorm(32, eps 1e-5), the project readout (cls concatenated, Linear,
GELU), align-corners bilinear upsampling in fusion and head.

Module names are the `omnidata_dpt_normal_v2.ckpt` keys (timm's
`vit_base_resnet50_384` under `pretrained.model.`, the reassembly under
`pretrained.act_postprocess{3,4}.`, the fusion under `scratch.`), so its
state dict loads with `load_state_dict` (`convert_dpt_state` strips the
lightning `model.` prefix). Public tensors are NHWC. Inference only.
"""
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.image import resize_bilinear
from ..diffusion.attention import dot_product_attention, uses_flash
from ..diffusion.norm import GroupNorm, LayerNorm
from .efficientnet import Conv2d, Linear

__all__ = ["StdConvSame", "GN", "BottleneckV2", "ResNetV2Stages", "ViTBlock",
           "ResidualConvUnit", "FeatureFusion", "DPTNormalModel",
           "convert_dpt_state", "resize_align_corners"]


def _same_pad(size, k, s):
    """timm 'same' padding of one axis: (before, after), the extra after."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, k, s, value=0.0):
    top, bottom = _same_pad(x.shape[2], k, s)
    left, right = _same_pad(x.shape[3], k, s)
    return F.pad(x, (left, right, top, bottom), value=value)


def resize_align_corners(x, h2, w2):
    """NCHW bilinear resize with align_corners=True (the reference's
    `_resize_ac`)."""
    if (h2, w2) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=(h2, w2), mode="bilinear",
                         align_corners=True)


class StdConvSame(nn.Conv2d):
    """timm StdConv2dSame: weight-standardised (eps 1e-6), 'same'
    asymmetric padding, no bias."""

    def __init__(self, cin, cout, kernel, stride=1):
        super().__init__(cin, cout, kernel, stride=stride, bias=False)

    def forward(self, x):
        w = self.weight.float()
        mu = w.mean((1, 2, 3), keepdim=True)
        var = w.var((1, 2, 3), unbiased=False, keepdim=True)
        w = (w - mu) * torch.rsqrt(var + 1e-6)
        k, s = self.kernel_size[0], self.stride[0]
        return F.conv2d(_pad_same(x.float(), k, s), w, None, s)


class GN(GroupNorm):
    """GroupNorm(32, eps 1e-5) + optional ReLU (timm GroupNormAct)."""

    def __init__(self, channels, act=True):
        super().__init__(32, channels, 1e-5)
        self.act = act

    def forward(self, x):
        x = super().forward(x.float())
        return F.relu(x) if self.act else x


class _Downsample(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv = StdConvSame(cin, cout, 1, stride)
        self.norm = GN(cout, act=False)

    def forward(self, x):
        return self.norm(self.conv(x))


class BottleneckV2(nn.Module):
    """timm ResNetV2 (non-preact) bottleneck: conv-norm(relu) x 2 ->
    conv-norm, relu(residual + shortcut); the shortcut is a 1x1 conv +
    norm of the input where the shape changes."""

    def __init__(self, cin, mid, stride=1):
        super().__init__()
        out = mid * 4
        if cin != out or stride != 1:
            self.downsample = _Downsample(cin, out, stride)
        self.conv1 = StdConvSame(cin, mid, 1)
        self.norm1 = GN(mid)
        self.conv2 = StdConvSame(mid, mid, 3, stride)
        self.norm2 = GN(mid)
        self.conv3 = StdConvSame(mid, out, 1)
        self.norm3 = GN(out, act=False)

    def forward(self, x):
        sc = self.downsample(x) if hasattr(self, "downsample") else x
        h = self.norm1(self.conv1(x))
        h = self.norm2(self.conv2(h))
        h = self.norm3(self.conv3(h))
        return F.relu(h + sc)


class _Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = StdConvSame(3, 64, 7, 2)
        self.norm = GN(64)


class _Stage(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class ResNetV2Stages(nn.Module):
    """Stem + stages of vitb_rn50_384: NCHW -> (/4 256, /8 512, /16
    1024)."""

    def __init__(self, layers=(3, 4, 9)):
        super().__init__()
        self.stem = _Stem()
        stages, cin = [], 64
        for si, (n, mid) in enumerate(zip(layers, (64, 128, 256))):
            blocks = []
            for i in range(n):
                blocks.append(BottleneckV2(
                    cin, mid, 2 if (i == 0 and si > 0) else 1))
                cin = mid * 4
            stages.append(_Stage(blocks))
        self.stages = nn.ModuleList(stages)

    def forward(self, x):
        h = self.stem.norm(self.stem.conv(x))
        h = F.max_pool2d(_pad_same(h, 3, 2, float("-inf")), 3, 2)
        feats = []
        for stage in self.stages:
            for blk in stage.blocks:
                h = blk(h)
            feats.append(h)
        return tuple(feats)


class _Attn(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)


class _MLP(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.fc1 = Linear(dim, dim * 4)
        self.fc2 = Linear(dim * 4, dim)


class ViTBlock(nn.Module):
    def __init__(self, dim=768, heads=12):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm(dim)
        self.attn = _Attn(dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = _MLP(dim)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.attn.qkv(self.norm1(x))
        if qkv.is_cuda and uses_flash(N, N, C // self.heads):
            # the kernel reads bf16, as the reference's casts to it
            qkv = qkv.to(torch.bfloat16)
        q, k, v = qkv.chunk(3, dim=-1)

        def split(t):
            return t.reshape(B, N, self.heads, C // self.heads)
        o = dot_product_attention(split(q), split(k), split(v))
        x = x + self.attn.proj(o.reshape(B, N, C))
        h = F.gelu(self.mlp.fc1(self.norm2(x)))
        return x + self.mlp.fc2(h)


class ResidualConvUnit(nn.Module):
    """relu -> conv3x3 -> relu -> conv3x3, + input."""

    def __init__(self, ch):
        super().__init__()
        self.conv1 = Conv2d(ch, ch, 3, padding=1)
        self.conv2 = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusion(nn.Module):
    """x (+ rcu1(skip)) -> rcu2 -> 2x align-corners upsampling -> 1x1."""

    def __init__(self, ch):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(ch)
        self.resConfUnit2 = ResidualConvUnit(ch)
        self.out_conv = Conv2d(ch, ch, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = resize_align_corners(x, x.shape[2] * 2, x.shape[3] * 2)
        return self.out_conv(x)


class _ProjectReadout(nn.Module):
    """Concatenate the cls token to every token, Linear(2D -> D), GELU."""

    def __init__(self, dim):
        super().__init__()
        self.project = nn.ModuleList([Linear(2 * dim, dim)])

    def forward(self, t):
        cls = t[:, :1].expand(-1, t.shape[1] - 1, -1)
        return F.gelu(self.project[0](torch.cat([t[:, 1:], cls], -1)))


class _PatchEmbed(nn.Module):
    def __init__(self, layers, vit_dim):
        super().__init__()
        self.backbone = ResNetV2Stages(layers)
        self.proj = Conv2d(1024, vit_dim, 1)


class _ViT(nn.Module):
    def __init__(self, vit_dim, vit_layers, layers, pos_tokens):
        super().__init__()
        self.patch_embed = _PatchEmbed(layers, vit_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, vit_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_tokens, vit_dim))
        self.blocks = nn.ModuleList([ViTBlock(vit_dim)
                                     for _ in range(vit_layers)])
        # the final norm: in the checkpoint; the taps read before it
        self.norm = LayerNorm(vit_dim)


class _Pretrained(nn.Module):
    def __init__(self, vit_dim, vit_layers, layers, pos_tokens):
        super().__init__()
        self.model = _ViT(vit_dim, vit_layers, layers, pos_tokens)
        self.act_postprocess3 = nn.ModuleList([
            _ProjectReadout(vit_dim), nn.Identity(), nn.Identity(),
            Conv2d(vit_dim, vit_dim, 1)])
        self.act_postprocess4 = nn.ModuleList([
            _ProjectReadout(vit_dim), nn.Identity(), nn.Identity(),
            Conv2d(vit_dim, vit_dim, 1),
            Conv2d(vit_dim, vit_dim, 3, stride=2, padding=1)])


class _Scratch(nn.Module):
    def __init__(self, vit_dim, features):
        super().__init__()
        for n, cin in zip(range(1, 5), (256, 512, vit_dim, vit_dim)):
            setattr(self, f"layer{n}_rn", Conv2d(cin, features, 3,
                                                 padding=1, bias=False))
            setattr(self, f"refinenet{n}", FeatureFusion(features))
        self.output_conv = nn.ModuleList([
            Conv2d(features, features // 2, 3, padding=1), nn.Identity(),
            Conv2d(features // 2, 32, 3, padding=1), nn.Identity(),
            Conv2d(32, 3, 1)])


class DPTNormalModel(nn.Module):
    """(B, H, W, 3) raw [0, 1] images (no mean / std normalisation), H
    and W multiples of 32 -> (B, H, W, 3) normals in [0, inf) (ReLU head;
    callers clamp to [0, 1])."""

    vit_dim, features, pos_grid = 768, 256, (24, 24)

    def __init__(self, vit_layers=12, readout_taps=(8, 11),
                 resnet_layers=(3, 4, 9)):
        super().__init__()
        vit_dim, pos_grid = self.vit_dim, self.pos_grid
        self.readout_taps = tuple(readout_taps)
        self.pretrained = _Pretrained(vit_dim, vit_layers, resnet_layers,
                                      pos_grid[0] * pos_grid[1] + 1)
        self.scratch = _Scratch(vit_dim, self.features)

    def _pos(self, hp, wp):
        pos = self.pretrained.model.pos_embed.float()
        if (hp, wp) == tuple(self.pos_grid):
            return pos
        # resized over the token grid (vit.py::_resize_pos_embed), with the
        # reference's antialiased bilinear
        grid = pos[:, 1:].reshape(1, *self.pos_grid, self.vit_dim)
        grid = resize_bilinear(grid, (hp, wp))
        return torch.cat([pos[:, :1], grid.reshape(1, hp * wp, -1)], 1)

    def forward(self, x):
        B = x.shape[0]
        vit, pre, sc = self.pretrained.model, self.pretrained, self.scratch
        D = self.vit_dim
        f1, f2, f3 = vit.patch_embed.backbone(x.permute(0, 3, 1, 2).float())
        hp, wp = f3.shape[2], f3.shape[3]
        tokens = vit.patch_embed.proj(f3).flatten(2).transpose(1, 2)
        t = torch.cat([vit.cls_token.float().expand(B, 1, D), tokens], 1) \
            + self._pos(hp, wp)
        taps = []
        for i, blk in enumerate(vit.blocks):
            t = blk(t)
            if i in self.readout_taps:
                taps.append(t)

        def reassemble(tk, post):
            h = post[0](tk)                               # (B, hp*wp, D)
            return h.transpose(1, 2).reshape(B, D, hp, wp)
        l3 = pre.act_postprocess3[3](reassemble(taps[0],
                                                pre.act_postprocess3))
        l4 = pre.act_postprocess4[3](reassemble(taps[1],
                                                pre.act_postprocess4))
        l4 = pre.act_postprocess4[4](l4)
        l1, l2 = sc.layer1_rn(f1), sc.layer2_rn(f2)
        l3, l4 = sc.layer3_rn(l3), sc.layer4_rn(l4)
        h = sc.refinenet4(l4)
        h = sc.refinenet3(h, l3)
        h = sc.refinenet2(h, l2)
        h = sc.refinenet1(h, l1)
        out = sc.output_conv
        h = out[0](h)
        h = resize_align_corners(h, h.shape[2] * 2, h.shape[3] * 2)
        h = F.relu(out[2](h))
        return F.relu(out[4](h)).permute(0, 2, 3, 1)


def convert_dpt_state(sd):
    """An Omnidata DPT checkpoint's state dict -> (the state
    `DPTNormalModel` takes, unmatched keys): the lightning `model.` prefix
    stripped."""
    if any(k.startswith("model.pretrained") for k in sd):
        sd = {k[6:]: v for k, v in sd.items() if k.startswith("model.")}
    return dict(sd), []
