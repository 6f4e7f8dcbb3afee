"""InceptionV3 features (FID / KID) and the CLIP aesthetic head
(counterpart of `mvedit_tpu/models/inception.py`).

- `InceptionV3Features`: (B, 3, 299, 299) in [0, 1] -> (B, 2048) pool3
  features, with the reference's numerics: the input mapped by x * 2 - 1,
  inference BatchNorm with eps 1e-3 (`(x - mean) * rsqrt(var + eps) *
  scale + bias`, f32), max pools padded with -inf and average pools that
  count the zero padding (torchvision's blocks; pytorch-fid's FID blocks
  differ). Module names are torchvision's (`Conv2d_1a_3x3.conv`,
  `Mixed_5b.branch1x1.bn`, ...), so the `pt_inception` state dict loads
  as `tools/convert_weights.py` stores it; `inception_state_from_flax`
  bridges the flax params.
- `AestheticHead`: a CLIP image embedding (768), L2-normalised, through
  the 768-1024-128-64-16-1 MLP -> (B,) scores.

The FID / KID math is `utils/evaluation.py`'s.
"""
import torch
import torch.nn.functional as F
from torch import nn

from .segmentors.efficientnet import BN, Conv2d

__all__ = ["InceptionV3Features", "AestheticHead",
           "inception_state_from_flax", "aesthetic_state_from_flax"]


class ConvBN(nn.Module):
    """conv (no bias) -> BN(eps 1e-3) -> relu; torchvision's
    BasicConv2d."""

    def __init__(self, cin, cout, kernel=3, stride=1, padding=0):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride=stride,
                           padding=padding, bias=False)
        self.bn = BN(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    # 3 x 3, stride 1, zero padding 1, divided by 9 everywhere
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _max_pool(x):
    # 3 x 3, stride 2, no padding
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, cin, pool_ch):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 64, 1)
        self.branch5x5_1 = ConvBN(cin, 48, 1)
        self.branch5x5_2 = ConvBN(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, padding=1)
        self.branch_pool = ConvBN(cin, pool_ch, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(
            self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = ConvBN(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(
            self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin, c7):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 192, 1)
        self.branch7x7_1 = ConvBN(cin, c7, 1)
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = ConvBN(cin, c7, 1)
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = ConvBN(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = ConvBN(cin, 192, 1)
        self.branch3x3_2 = ConvBN(192, 320, 3, stride=2)
        self.branch7x7x3_1 = ConvBN(cin, 192, 1)
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBN(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 320, 1)
        self.branch3x3_1 = ConvBN(cin, 384, 1)
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBN(cin, 448, 1)
        self.branch3x3dbl_2 = ConvBN(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = ConvBN(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        return torch.cat([self.branch1x1(x), self.branch3x3_2a(b3),
                          self.branch3x3_2b(b3), self.branch3x3dbl_3a(bd),
                          self.branch3x3dbl_3b(bd),
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionV3Features(nn.Module):
    """(B, 3, 299, 299) in [0, 1] -> (B, 2048) pool3 features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = ConvBN(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, 3)
        self.Conv2d_2b_3x3 = ConvBN(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, 1)
        self.Conv2d_4a_3x3 = ConvBN(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x):
        h = x.float() * 2.0 - 1.0
        h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(h)))
        h = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(h)))
        h = _max_pool(h)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            h = getattr(self, name)(h)
        return h.mean((2, 3))


class AestheticHead(nn.Module):
    """CLIP image embedding (B, 768) -> (B,) aesthetic scores."""

    def __init__(self, dim=768):
        super().__init__()
        self.fc1 = nn.Linear(dim, 1024)
        self.fc2 = nn.Linear(1024, 128)
        self.fc3 = nn.Linear(128, 64)
        self.fc4 = nn.Linear(64, 16)
        self.fc5 = nn.Linear(16, 1)

    def forward(self, emb):
        emb = emb / torch.linalg.norm(emb, dim=-1,
                                      keepdim=True).clamp(min=1e-8)
        h = self.fc1(emb)
        h = self.fc2(F.relu(h))
        h = self.fc3(F.relu(h))
        h = self.fc4(F.relu(h))
        return self.fc5(h)[..., 0]


def inception_state_from_flax(tree):
    """`InceptionV3Features`' flax params (BN scale / bias / mean / var)
    -> the port's (torchvision's) keys."""
    from .diffusion.weights import torch_state_from_flax
    return torch_state_from_flax(tree, "inception")


def aesthetic_state_from_flax(tree):
    """`AestheticHead`'s flax params -> the port's keys."""
    from .diffusion.weights import torch_state_from_flax
    return torch_state_from_flax(tree, "aesthetic")
