"""Losses (counterpart of `mvedit_tpu/models/losses.py`): L1, TV, the
opacity entropy and LPIPS.

LPIPS is the VGG16 feature stack with the linear calibration heads, as
plain functions on a params dict: `{"convs": [{"w": (cout, cin, 3, 3),
"b": (cout,)}, ...13], "lins": [(c,) x5]}`, torch's OIHW layout, so the
torchvision / lpips state dicts map onto it directly.
`lpips_params_from_flax` bridges the JAX package's pytree (HWIO kernels).
Images are NHWC in [0, 1], as in the reference; the VGG runs in the
params' dtype (the runner keeps bf16 weights at full size).
"""
import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.clip import clip

__all__ = ["l1_loss", "tv_loss", "entropy_loss", "lpips_init", "lpips_apply",
           "lpips_params_from_flax", "lpips_params_from_torch",
           "deterministic_convs"]


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN with deterministic algorithms only, for the fits' backward
    passes: its heuristics may otherwise pick a backward-data algorithm for
    LPIPS's convolutions that adds atomically, so that one seed gives two
    results on the card."""
    c = torch.backends.cudnn
    prev = c.deterministic
    c.deterministic = True
    try:
        yield
    finally:
        c.deterministic = prev


def _weighted_mean(err, weight):
    if weight is None:
        return err.mean()
    return (err * torch.broadcast_to(weight, err.shape)).mean()


def _abs(x):
    # the reference's |x| has gradient +1 at x == 0 (torch.abs: 0), and a
    # rendered alpha often equals its target exactly (0 or 1)
    return torch.where(x >= 0, x, -x)


def l1_loss(pred, target, weight=None):
    return _weighted_mean(_abs(pred - target), weight)


def tv_loss(x, target=None, weight=None, power=1.5):
    """Total variation of x (N, C, H, W); with `target`, the TV of the
    difference. `weight` is an elementwise map over the differences."""
    d = x if target is None else x - target
    dh = d[..., 1:, :] - d[..., :-1, :]
    dw = d[..., :, 1:] - d[..., :, :-1]
    if weight is not None:
        wh = torch.minimum(weight[..., 1:, :], weight[..., :-1, :])
        ww = torch.minimum(weight[..., :, 1:], weight[..., :, :-1])
    else:
        wh = ww = None
    lh = _weighted_mean(_abs(dh) ** power, wh)
    lw = _weighted_mean(_abs(dw) ** power, ww)
    return 0.5 * (lh + lw)


def entropy_loss(weights, bin_widths, alphas, bg_width=0.125,
                 num_pixels=None):
    """Opacity entropy regulariser over the compositing weights (R, S),
    their bin widths (R, S) and the accumulated opacity (R,)."""
    w = weights.float()
    bg = (1.0 - alphas.reshape(-1)).float()
    n = num_pixels if num_pixels is not None else w.shape[0]
    ent = (w * (torch.log(clip(w, 1e-6))
                - torch.log(clip(bin_widths, 1e-6)))).sum() \
        + (bg * (torch.log(clip(bg, 1e-6)) - np.log(bg_width))).sum()
    return -ent / n


# ---- LPIPS (VGG16 + linear heads) -----------------------------------------

_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512)
_TAP_LAYERS = (1, 3, 6, 9, 12)     # taps after relu1_2 .. relu5_3
_TAP_CHANNELS = (64, 128, 256, 512, 512)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def lpips_init(generator=None, device=None, dtype=torch.float32):
    """Seeded LPIPS params at VGG16's published widths: conv weights
    N(0, 1/fan_in), zero biases, heads 1/c (the reference's random init)."""
    convs, c_in = [], 3
    for v in _VGG16_CFG:
        if v == "M":
            continue
        w = torch.randn((v, c_in, 3, 3), generator=generator, device=device,
                        dtype=dtype) / (9 * c_in) ** 0.5
        convs.append({"w": w, "b": torch.zeros((v,), device=device,
                                               dtype=dtype)})
        c_in = v
    lins = [torch.full((c,), 1.0 / c, device=device, dtype=dtype)
            for c in _TAP_CHANNELS]
    return {"convs": convs, "lins": lins}


def _vgg_features(params, x):
    """x: (N, 3, H, W) normalised -> the five tap activations (NCHW), in
    the params' dtype."""
    feats, i = [], 0
    h = x.to(params["convs"][0]["w"].dtype)
    for v in _VGG16_CFG:
        if v == "M":
            h = F.max_pool2d(h, 2, 2)
            continue
        c = params["convs"][i]
        h = torch.relu(F.conv2d(h, c["w"], c["b"], padding=1))
        if i in _TAP_LAYERS:
            feats.append(h)
        i += 1
    return feats


def lpips_apply(params, pred, target, weight=None):
    """Perceptual distance of pred / target (N, H, W, 3) in [0, 1]: the
    mean over the batch (weighted by `weight` (N,) when given)."""
    def norm_input(im):
        shift = torch.tensor(_SHIFT, dtype=im.dtype, device=im.device)
        scale = torch.tensor(_SCALE, dtype=im.dtype, device=im.device)
        return ((im * 2.0 - 1.0 - shift) / scale).permute(0, 3, 1, 2)

    fp = _vgg_features(params, norm_input(pred))
    ft = _vgg_features(params, norm_input(target))
    per_im = 0
    for a, b, lin in zip(fp, ft, params["lins"]):
        a = a / clip(torch.linalg.vector_norm(a, dim=1, keepdim=True), 1e-10)
        b = b / clip(torch.linalg.vector_norm(b, dim=1, keepdim=True), 1e-10)
        d = (((a - b) ** 2) * clip(lin, 0.0)[:, None, None]).sum(1)
        per_im = per_im + d.mean((1, 2))                       # (N,)
    if weight is not None:
        return (per_im * weight).mean()
    return per_im.mean()


def lpips_params_from_flax(tree, device=None, dtype=torch.float32):
    """The JAX package's LPIPS pytree (`{"convs": [{"w": HWIO, "b"}],
    "lins": [...]}`, numpy or JAX leaves) -> the port's params."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device,
                            dtype=dtype)
    return {"convs": [{"w": t(np.asarray(c["w"], np.float32)
                              .transpose(3, 2, 0, 1)), "b": t(c["b"])}
                      for c in tree["convs"]],
            "lins": [t(l) for l in tree["lins"]]}


def lpips_params_from_torch(vgg_state, lin_state, device=None,
                            dtype=torch.float32):
    """A torchvision VGG16 `features` state dict (keys `N.weight` or
    `features.N.weight`) and the lpips package's five linear heads ((c, 1,
    1, 1) or (c,)) -> the port's params (the reference's
    `lpips_params_from_torch`; the conv weights stay OIHW)."""
    convs, i = [], 0
    while f"{i}.weight" in vgg_state or f"features.{i}.weight" in vgg_state:
        pre = f"features.{i}" if f"features.{i}.weight" in vgg_state \
            else str(i)
        w = torch.as_tensor(vgg_state[f"{pre}.weight"])
        if w.dim() == 4:
            convs.append({"w": w.to(device=device, dtype=dtype),
                          "b": torch.as_tensor(vgg_state[f"{pre}.bias"]).to(
                              device=device, dtype=dtype)})
        i += 1
        while (f"{i}.weight" not in vgg_state
               and f"features.{i}.weight" not in vgg_state and i < 40):
            i += 1
    lins = [torch.as_tensor(v).reshape(-1).to(device=device, dtype=dtype)
            for v in lin_state]
    return {"convs": convs[:13], "lins": lins}
