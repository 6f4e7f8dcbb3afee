"""LoFTR detector-free matcher.

Counterpart of `mvedit_tpu/models/segmentors/loftr.py`, used to estimate
the pose of the user's input image against the generated views:

- ResNetFPN_8_2 -> coarse (/8, 256 channels) and fine (/2, 128) maps;
- the sinusoidal 2D position encoding (interleaved sin / cos channels,
  1-indexed positions);
- the coarse transformer: interleaved self / cross *linear* attention
  (elu + 1, eps 1e-6), the cross pass sequential (feat1 attends the
  already updated feat0);
- dual-softmax coarse matching (T = 0.1) with mutual-max filtering and
  border removal; a fixed top-k of the rows, ties in index order (as
  `jax.lax.top_k`; a stable descending sort here, since `torch.topk`
  leaves the order of equal values open);
- fine refinement: 5 x 5 windows of the /2 map around the top-k matches,
  coarse context concatenated, one self / cross pair at width 128, then a
  softmax heatmap's expectation as the sub-pixel offset.

Module names are the `indoor_ds_new.ckpt` keys (`backbone.layer1.0.conv1`,
`loftr_coarse.layers.N.q_proj`, `fine_preprocess.down_proj`, ...);
`convert_loftr_state` strips the lightning `matcher.` prefix. Public
tensors are NHWC. LayerNorm eps is the reference's flax 1e-6.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..diffusion.norm import LayerNorm
from .efficientnet import BN, Conv2d, Linear

__all__ = ["ResNetFPN", "LoFTREncoderLayer", "LoFTR", "match_images",
           "convert_loftr_state"]


def _resize_ac2x(x):
    """NCHW 2x bilinear upsampling with align_corners=True."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def _conv(cin, cout, k, stride=1):
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    """conv-bn-relu, conv-bn, + shortcut (1x1 conv + bn when strided)."""

    def __init__(self, cin, ch, stride=1):
        super().__init__()
        self.conv1 = _conv(cin, ch, 3, stride)
        self.bn1 = BN(ch, 1e-5)
        self.conv2 = _conv(ch, ch, 3)
        self.bn2 = BN(ch, 1e-5)
        if stride != 1:
            self.downsample = nn.Sequential(_conv(cin, ch, 1, stride),
                                            BN(ch, 1e-5))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        return F.relu(x + h)


def _outconv2(mid, out):
    """conv3x3 -> BN -> LeakyReLU -> conv3x3 (indices 0, 1, 3)."""
    return nn.Sequential(_conv(mid, mid, 3), BN(mid, 1e-5),
                         nn.LeakyReLU(0.01), _conv(mid, out, 3))


class ResNetFPN(nn.Module):
    """ResNetFPN_8_2: NCHW grey -> (coarse /8 256 ch, fine /2 128 ch)."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(1, 128, 7, stride=2, padding=3, bias=False)
        self.bn1 = BN(128, 1e-5)
        self.layer1 = nn.Sequential(BasicBlock(128, 128),
                                    BasicBlock(128, 128))
        self.layer2 = nn.Sequential(BasicBlock(128, 196, 2),
                                    BasicBlock(196, 196))
        self.layer3 = nn.Sequential(BasicBlock(196, 256, 2),
                                    BasicBlock(256, 256))
        self.layer3_outconv = _conv(256, 256, 1)
        self.layer2_outconv = _conv(196, 256, 1)
        self.layer2_outconv2 = _outconv2(256, 196)
        self.layer1_outconv = _conv(128, 196, 1)
        self.layer1_outconv2 = _outconv2(196, 128)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1(h)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        c3 = self.layer3_outconv(x3)
        c2 = self.layer2_outconv2(self.layer2_outconv(x2)
                                  + _resize_ac2x(c3))
        c1 = self.layer1_outconv2(self.layer1_outconv(x1)
                                  + _resize_ac2x(c2))
        return c3, c1


def _linear_attention(q, k, v):
    """elu + 1 kernelised linear attention; (B, N, H, D) each."""
    q = F.elu(q) + 1.0
    k = F.elu(k) + 1.0
    L = v.shape[1]
    v = v / L
    kv = torch.einsum("bnhd,bnhv->bhdv", k, v)
    z = 1.0 / (torch.einsum("bnhd,bhd->bnh", q, k.sum(1)) + 1e-6)
    return torch.einsum("bnhd,bhdv,bnh->bnhv", q, kv, z) * L


class LoFTREncoderLayer(nn.Module):
    """Attention + an MLP over [x, message], post-norms."""

    def __init__(self, dim=256, heads=8):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.q_proj = Linear(dim, dim, bias=False)
        self.k_proj = Linear(dim, dim, bias=False)
        self.v_proj = Linear(dim, dim, bias=False)
        self.merge = Linear(dim, dim, bias=False)
        self.mlp = nn.Sequential(Linear(2 * dim, 2 * dim, bias=False),
                                 nn.ReLU(), Linear(2 * dim, dim, bias=False))
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, x, source):
        B, N, _ = x.shape
        d = self.dim // self.heads

        def split(t):
            return t.reshape(B, -1, self.heads, d)
        m = _linear_attention(split(self.q_proj(x)),
                              split(self.k_proj(source)),
                              split(self.v_proj(source)))
        m = self.norm1(self.merge(m.reshape(B, N, self.dim)))
        h = self.mlp(torch.cat([x, m], -1))
        return x + self.norm2(h)


class _Layers(nn.Module):
    def __init__(self, n, dim):
        super().__init__()
        self.layers = nn.ModuleList([LoFTREncoderLayer(dim)
                                     for _ in range(n)])


class _FinePreprocess(nn.Module):
    def __init__(self, dim, fine_dim):
        super().__init__()
        self.down_proj = Linear(dim, fine_dim)
        self.merge_feat = Linear(2 * fine_dim, fine_dim)


def _pos_encoding(h, w, dim, device):
    """PositionEncodingSine (temp_bug_fix): channels 4k..4k+3 <- sin/cos
    (x), sin/cos(y), positions 1-indexed; built on the host."""
    ys = np.arange(1, h + 1, dtype=np.float32)[:, None, None]
    xs = np.arange(1, w + 1, dtype=np.float32)[None, :, None]
    div = np.exp(np.arange(0, dim // 2, 2, dtype=np.float32)
                 * (-np.log(10000.0) / (dim // 2)))
    pe = np.zeros((h, w, dim), np.float32)
    pe[:, :, 0::4] = np.sin(xs * div) * np.ones((h, 1, 1), np.float32)
    pe[:, :, 1::4] = np.cos(xs * div) * np.ones((h, 1, 1), np.float32)
    pe[:, :, 2::4] = np.sin(ys * div) * np.ones((1, w, 1), np.float32)
    pe[:, :, 3::4] = np.cos(ys * div) * np.ones((1, w, 1), np.float32)
    return torch.from_numpy(pe.reshape(1, h * w, dim)).to(device)


def _unfold_windows(fm, ids, wsize, stride):
    """wsize x wsize windows of the fine map fm (H, W, C), zero-padded,
    at the coarse cells ids (K,) -> (K, wsize, wsize, C)."""
    H, W, C = fm.shape
    pad = wsize // 2
    fmp = F.pad(fm, (0, 0, pad, pad, pad, pad))
    wc = W // stride
    r = (ids // wc) * stride
    c = (ids % wc) * stride
    d = torch.arange(wsize, device=fm.device)
    rows = r[:, None, None] + d[None, :, None]
    cols = c[:, None, None] + d[None, None, :]
    return fmp[rows, cols]


class LoFTR(nn.Module):
    """(1, H, W, 1) grey images in [0, 1], H and W multiples of 8 ->
    {"pts0", "pts1": (K, 2) pixel coords, "conf": (K,) descending}, K =
    min(topk, coarse cells)."""

    dim, fine_dim, fine_window, border_rm, topk = 256, 128, 5, 2, 512
    conf_thresh = 0.2

    def __init__(self, layers=4):
        super().__init__()
        self.n_layers = layers
        self.backbone = ResNetFPN()
        self.loftr_coarse = _Layers(2 * layers, self.dim)
        self.fine_preprocess = _FinePreprocess(self.dim, self.fine_dim)
        self.loftr_fine = _Layers(2, self.fine_dim)

    def forward(self, img0, img1):
        dev = img0.device
        fc, ff = self.backbone(torch.cat([img0, img1], 0).permute(
            0, 3, 1, 2).float())
        fc, ff = fc.permute(0, 2, 3, 1), ff.permute(0, 2, 3, 1)
        _, h0, w0, C = fc.shape
        h1, w1 = h0, w0
        x0 = fc[:1].reshape(1, h0 * w0, C) + _pos_encoding(h0, w0, C, dev)
        x1 = fc[1:].reshape(1, h1 * w1, C) + _pos_encoding(h1, w1, C, dev)
        layers = self.loftr_coarse.layers
        for i in range(self.n_layers):
            sl, cl = layers[2 * i], layers[2 * i + 1]
            x0 = sl(x0, x0)
            x1 = sl(x1, x1)
            x0 = cl(x0, x1)
            x1 = cl(x1, x0)

        # dual-softmax matching
        sim = torch.einsum("bnc,bmc->bnm", x0 / C ** 0.5,
                           x1 / C ** 0.5) / 0.1
        conf = (torch.softmax(sim, 1) * torch.softmax(sim, 2))[0]
        valid = conf > self.conf_thresh
        # the border margin shrinks on tiny grids so the interior stays
        b = min(self.border_rm, (min(h0, w0, h1, w1) - 1) // 2)
        if b > 0:
            def border_mask(h, w):
                m = np.zeros((h, w), bool)
                m[b:h - b, b:w - b] = True
                return torch.from_numpy(m.reshape(-1)).to(dev)
            valid &= border_mask(h0, w0)[:, None]
            valid &= border_mask(h1, w1)[None, :]
        valid &= conf == conf.amax(1, keepdim=True)
        valid &= conf == conf.amax(0, keepdim=True)
        mconf_all = torch.where(valid, conf, torch.zeros_like(conf))
        # argmax picks the first maximum, as jnp.argmax
        row_best, row_j = mconf_all.amax(1), mconf_all.argmax(1)
        k = min(self.topk, row_best.shape[0])
        mconf, i_ids = torch.sort(row_best, descending=True, stable=True)
        mconf, i_ids = mconf[:k], i_ids[:k]
        j_ids = row_j[i_ids]
        pts0_c = torch.stack([i_ids % w0, i_ids // w0], -1).float() * 8.0
        pts1_c = torch.stack([j_ids % w1, j_ids // w1], -1).float() * 8.0

        # fine refinement
        W5, stride = self.fine_window, 4
        win0 = _unfold_windows(ff[0], i_ids, W5, stride)
        win1 = _unfold_windows(ff[1], j_ids, W5, stride)
        fp = self.fine_preprocess
        cf = fp.down_proj(torch.cat([x0[0][i_ids], x1[0][j_ids]], 0))
        wins = torch.cat([win0.reshape(k, W5 * W5, -1),
                          win1.reshape(k, W5 * W5, -1)], 0)
        wins = fp.merge_feat(torch.cat(
            [wins, cf[:, None].expand(-1, W5 * W5, -1)], -1))
        fs, fcr = self.loftr_fine.layers
        wins = fs(wins, wins)
        w0f, w1f = wins[:k], wins[k:]
        w0f = fcr(w0f, w1f)
        w1f = fcr(w1f, w0f)
        center = w0f[:, (W5 * W5) // 2]
        simf = torch.einsum("kc,krc->kr", center, w1f) / self.fine_dim ** 0.5
        heat = torch.softmax(simf, -1).reshape(k, W5, W5)
        grid = torch.from_numpy((np.arange(W5, dtype=np.float32)
                                 / (W5 - 1)) * 2 - 1).to(dev)
        ex = torch.einsum("khw,w->k", heat, grid)
        ey = torch.einsum("khw,h->k", heat, grid)
        offset = torch.stack([ex, ey], -1) * (W5 // 2) * 2.0
        return {"pts0": pts0_c, "pts1": pts1_c + offset, "conf": mconf,
                "hw0": (h0, w0), "hw1": (h1, w1)}


@torch.inference_mode()
def match_images(net, img0, img1):
    """LoFTR's matches as numpy pixel coords (pts0 (M, 2), pts1 (M, 2),
    conf (M,)), those at or below its 0.2 threshold dropped."""
    out = net(img0, img1)
    conf = out["conf"].float().cpu().numpy()
    keep = conf > net.conf_thresh
    return (out["pts0"].float().cpu().numpy()[keep],
            out["pts1"].float().cpu().numpy()[keep], conf[keep])


def convert_loftr_state(sd):
    """A LoFTR checkpoint's state dict -> (the state `LoFTR` takes,
    unmatched keys): the lightning `matcher.` prefix stripped."""
    return {(k[8:] if k.startswith("matcher.") else k): v
            for k, v in sd.items()}, []
