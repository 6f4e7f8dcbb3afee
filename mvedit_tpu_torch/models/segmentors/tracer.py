"""TRACER-B7 salient-object segmentor.

Counterpart of `mvedit_tpu/models/segmentors/tracer.py`: the
EfficientNet-B7 encoder -> RFB blocks -> multi-level Aggregation with the
Union Attention Module -> two ObjectAttention refinements, and
`tracer_segment`'s preprocessing (bilinear resize to the input size
without antialiasing, ImageNet normalisation), erosion as -maxpool(-x)
and the failure rule (a mask above 0.2 everywhere -> everything below 0.8
zeroed).

Module names are the reference checkpoint's (Carve/tracer_b7, the torch
layout `convert_tracer` reads): `encoder._blocks.N...`, `rfb2.branch1.2.
conv`, `agg.UAM.norm.0`, `ObjectAttention2.DWSConv.DWConv`,
`ObjectAttention2.DWConv1.0.DWConv`, ...; `convert_tracer_state` only
strips the `module.` / `model.` prefixes and the encoder's unused
classifier head. Public tensors are NHWC; inside, NCHW, in f32.
"""
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.image import erode, resize_bilinear
from .efficientnet import BN, Conv2d, EfficientEncoderB7

__all__ = ["ConvBNRelu", "DWConv", "DWSConv", "RFBBlock", "UnionAttention",
           "Aggregation", "ObjectAttention", "TracerDecoder",
           "tracer_segment", "convert_tracer_state"]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _up(x, f):
    """Bilinear upsampling by f (half-pixel centres, as jax.image.resize
    when it grows)."""
    return F.interpolate(x, scale_factor=f, mode="bilinear",
                         align_corners=False)


class ConvBNRelu(nn.Module):
    """conv -> BN -> ReLU (the reference's BasicConv2d)."""

    def __init__(self, cin, cout, kernel=1, padding=0, dilation=1):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, padding=padding,
                           dilation=dilation, bias=False)
        self.bn = BN(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class DWConv(nn.Module):
    """Depthwise conv -> BN -> ReLU."""

    def __init__(self, cin, cout, kernel=3, padding=1, dilation=1):
        super().__init__()
        self.DWConv = Conv2d(cin, cout, kernel, padding=padding,
                             dilation=dilation, groups=cin, bias=False)
        self.bn = BN(cout)

    def forward(self, x):
        return F.relu(self.bn(self.DWConv(x)))


class DWSConv(nn.Module):
    """Depthwise separable conv: depthwise -> BN -> ReLU -> pointwise ->
    BN -> ReLU."""

    def __init__(self, cin, cout, kernel=3, padding=1):
        super().__init__()
        self.DWConv = Conv2d(cin, cin, kernel, padding=padding, groups=cin,
                             bias=False)
        self.bn = BN(cin)
        self.PWConv = Conv2d(cin, cout, 1, bias=False)
        self.bn2 = BN(cout)

    def forward(self, x):
        x = F.relu(self.bn(self.DWConv(x)))
        return F.relu(self.bn2(self.PWConv(x)))


def _branch(cin, oc, k, dil):
    """1x1 -> 1xk -> kx1 -> 3x3 dilated."""
    return nn.Sequential(
        ConvBNRelu(cin, oc),
        ConvBNRelu(oc, oc, (1, k), padding=(0, k // 2)),
        ConvBNRelu(oc, oc, (k, 1), padding=(k // 2, 0)),
        ConvBNRelu(oc, oc, 3, padding=dil, dilation=dil))


class RFBBlock(nn.Module):
    def __init__(self, cin, oc):
        super().__init__()
        self.branch0 = nn.Sequential(ConvBNRelu(cin, oc))
        self.branch1 = _branch(cin, oc, 3, 3)
        self.branch2 = _branch(cin, oc, 5, 5)
        self.branch3 = _branch(cin, oc, 7, 7)
        self.conv_cat = ConvBNRelu(4 * oc, oc, 3, padding=1)
        self.conv_res = ConvBNRelu(cin, oc)

    def forward(self, x):
        cat = torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                         self.branch3(x)], 1)
        return F.relu(self.conv_cat(cat) + self.conv_res(x))


class UnionAttention(nn.Module):
    """Channel then spatial attention over the aggregated map (eval mode:
    no dropout). The channel attention has one query and one key, so its
    softmax is 1 and its output is `channel_v`'s; `channel_q` /
    `channel_k` are kept for the checkpoint's keys. Channels at or below
    the 0.1-quantile of the channel attention are dropped."""

    def __init__(self, channels):
        super().__init__()
        C = channels
        self.norm = nn.Sequential(BN(C))
        self.bn = BN(C)
        for name in ("channel_q", "channel_k", "channel_v", "fc"):
            setattr(self, name, Conv2d(C, C, 1, bias=False))
        for name in ("spatial_q", "spatial_k", "spatial_v"):
            setattr(self, name, Conv2d(C, 1, 1, bias=False))

    def forward(self, x):
        B, C, H, W = x.shape
        xn = self.norm(x.mean((2, 3), keepdim=True))
        att = torch.sigmoid(self.fc(self.channel_v(xn)))     # (B, C, 1, 1)
        x_c = self.bn(x * att + x)
        mask = att[:, :, 0, 0]
        thr = torch.quantile(mask, 0.1, dim=-1, keepdim=True)
        mask = torch.where(mask <= thr, torch.zeros_like(mask), mask)
        x_drop = x_c * mask[:, :, None, None]
        q = self.spatial_q(x_drop).reshape(B, H * W, 1)
        k = self.spatial_k(x_drop).reshape(B, H * W, 1)
        v = self.spatial_v(x_drop)
        scores = torch.softmax(q @ k.transpose(1, 2), dim=-1)
        out = scores @ v.reshape(B, H * W, 1)
        return out.reshape(B, 1, H, W) + v


class Aggregation(nn.Module):
    def __init__(self, channels):
        super().__init__()
        c0, c1, c2 = channels
        self.conv_upsample1 = ConvBNRelu(c2, c1, 3, padding=1)
        self.conv_upsample2 = ConvBNRelu(c2, c0, 3, padding=1)
        self.conv_upsample3 = ConvBNRelu(c1, c0, 3, padding=1)
        self.conv_upsample4 = ConvBNRelu(c2, c2, 3, padding=1)
        self.conv_upsample5 = ConvBNRelu(c2 + c1, c2 + c1, 3, padding=1)
        self.conv_concat2 = ConvBNRelu(c2 + c1, c2 + c1, 3, padding=1)
        self.conv_concat3 = ConvBNRelu(c0 + c1 + c2, c0 + c1 + c2, 3,
                                       padding=1)
        self.UAM = UnionAttention(c0 + c1 + c2)

    def forward(self, e4, e3, e2):
        e3_1 = self.conv_upsample1(_up(e4, 2)) * e3
        e2_1 = self.conv_upsample2(_up(_up(e4, 2), 2)) \
            * self.conv_upsample3(_up(e3, 2)) * e2
        e3_2 = self.conv_concat2(torch.cat(
            [e3_1, self.conv_upsample4(_up(e4, 2))], 1))
        e2_2 = torch.cat([e2_1, self.conv_upsample5(_up(e3_2, 2))], 1)
        return self.UAM(self.conv_concat3(e2_2))


class ObjectAttention(nn.Module):
    def __init__(self, channel):
        super().__init__()
        c = channel
        self.DWSConv = DWSConv(c, c // 2, 3, padding=1)
        for i, (kk, pad, dil) in enumerate(((1, 0, 1), (3, 1, 1),
                                            (3, 3, 3), (3, 5, 5))):
            setattr(self, f"DWConv{i + 1}", nn.Sequential(
                DWConv(c // 2, c // 2, kk, pad, dil),
                ConvBNRelu(c // 2, c // 8)))
        self.conv1 = ConvBNRelu(c // 2, 1)

    def forward(self, decoder_map, encoder_map):
        mask_ob = torch.sigmoid(decoder_map)
        mask_bg = 1.0 - mask_ob
        edge = torch.where(mask_bg > 0.93, torch.zeros_like(mask_bg),
                           mask_bg)
        x = self.DWSConv(mask_ob * encoder_map + edge * encoder_map)
        parts = [getattr(self, f"DWConv{i}")(x) for i in range(1, 5)]
        x = torch.cat(parts, 1) + x
        return F.relu(self.conv1(x)) + decoder_map


class TracerDecoder(nn.Module):
    """The whole TRACER net: (B, H, W, 3) preprocessed -> (B, H, W, 1)
    mask in (0, 1)."""

    def __init__(self):
        super().__init__()
        r, fc = (32, 64, 128), (48, 80, 224, 640)
        self.encoder = EfficientEncoderB7()
        self.rfb2 = RFBBlock(fc[1], r[0])
        self.rfb3 = RFBBlock(fc[2], r[1])
        self.rfb4 = RFBBlock(fc[3], r[2])
        self.agg = Aggregation(r)
        self.ObjectAttention2 = ObjectAttention(fc[1])
        self.ObjectAttention1 = ObjectAttention(fc[0])

    def forward(self, x):
        feats = self.encoder(x.permute(0, 3, 1, 2).float())
        x3 = self.rfb2(feats[1])
        x4 = self.rfb3(feats[2])
        x5 = self.rfb4(feats[3])
        D0 = self.agg(x5, x4, x3)
        ds0 = _up(D0, 8)
        D1 = self.ObjectAttention2(D0, feats[1])
        ds1 = _up(D1, 8)
        D2 = self.ObjectAttention1(_up(D1, 2), feats[0])
        ds2 = _up(D2, 4)
        return torch.sigmoid((ds0 + ds1 + ds2) / 3.0).permute(0, 2, 3, 1)


def tracer_segment(net, images, input_size=640, chunk=None):
    """(N, H, W, 3) in [0, 1] -> (N, H, W, 1) masks: resize to the input
    size (no antialias), ImageNet normalisation, the net, erosion
    -maxpool(-x) over 3 x 3, resize back, then the failure rule. `chunk`
    runs that many images per net call (same result)."""
    n, h, w = images.shape[:3]
    x = resize_bilinear(images.float(), (input_size, input_size),
                        antialias=False)
    mean = torch.tensor(_IMAGENET_MEAN, device=x.device)
    std = torch.tensor(_IMAGENET_STD, device=x.device)
    x = (x - mean) / std
    step = chunk or n
    mask = torch.cat([net(x[i:i + step]) for i in range(0, n, step)], 0)
    mask = erode(mask[..., 0], 3)
    mask = resize_bilinear(mask[..., None], (h, w), antialias=False)
    failure = (mask.reshape(n, -1) > 0.2).all(dim=1)
    mask = torch.where(failure[:, None, None, None] & (mask < 0.8),
                       torch.zeros_like(mask), mask)
    return mask.clamp(0.0, 1.0)


# the encoder's classifier head: in the checkpoint, unused by TRACER
_HEAD = ("encoder._conv_head.", "encoder._bn1.", "encoder._fc.")


def convert_tracer_state(sd):
    """A TRACER-B7 checkpoint's state dict -> (the state `TracerDecoder`
    takes, unmatched keys): the `module.` / `model.` prefixes stripped,
    the encoder's classifier head dropped."""
    state = {}
    for k, v in sd.items():
        for pre in ("module.", "model."):
            if k.startswith(pre):
                k = k[len(pre):]
        if not k.startswith(_HEAD):
            state[k] = v
    return state, []
