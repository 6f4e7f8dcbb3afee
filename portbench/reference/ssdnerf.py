"""Plain float32 reference of the StableSSDNeRF LoRA training step: a frozen
copy of the port's plain code (`models/ssdnerf.py::make_train_step`, its
render loss, `models/triplane.py`, `models/volume_renderer.py`,
`models/losses.py::lpips_apply`, `models/gaussian_diffusion.py::
training_loss`, `models/diffusion/lora.py::merge_lora`, the scene-code
cache's float16 storage), with the SD2.1 UNet of `reference/diffusion.py`
and every gather and sum in plain PyTorch. It imports nothing of the port.

`Precision(low=True)` is the control: the UNet's layers in float8 e4m3
and the decoder's and LPIPS's products in bfloat16, the steps below the
program's bfloat16 and float32.
"""
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import diffusion as RD

__all__ = ["Precision", "sd_acp", "train_step", "Cache"]

VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
         "M", 512, 512, 512)
TAPS = (1, 3, 6, 9, 12)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


@dataclass(frozen=True)
class Precision:
    low: bool = False

    def bf16(self, x):
        """x rounded to bfloat16 under `low`; the gradient passes through
        the rounding."""
        if not self.low:
            return x
        return x + (x.detach().to(torch.bfloat16).float() - x).detach()


def sd_acp(n=1000, beta_start=0.00085, beta_end=0.012):
    """SD's scaled-linear schedule's cumulative alphas (float64)."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, n,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


# ---------------------------------------------------------------- decoder
def mlp(params, x, prec):
    x = x.float()
    for i, layer in enumerate(params):
        x = prec.bf16(x) @ prec.bf16(layer["w"].float()) + layer["b"]
        if i != len(params) - 1:
            x = torch.relu(x)
    return x


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def _corner_sample(img, grid):
    """Bilinear sampling of img (N, C, H, W) at grid (N, 1, P, 2) in
    [-1, 1], align_corners False, border padding: (N, C, 1, P)."""
    N, C, H, W = img.shape
    x = ((grid[..., 0] + 1) * W - 1) / 2
    y = ((grid[..., 1] + 1) * H - 1) / 2
    x = x.clamp(0, W - 1)
    y = y.clamp(0, H - 1)
    x0, y0 = x.floor(), y.floor()
    wx, wy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    flat = img.reshape(N, C, H * W)

    def at(yy, xx):
        idx = (yy * W + xx).reshape(N, 1, -1).expand(N, C, -1)
        return flat.gather(2, idx).reshape(N, C, 1, -1)
    wx, wy = wx[:, None], wy[:, None]
    return (at(y0, x0) * (1 - wx) * (1 - wy) + at(y0, x1) * wx * (1 - wy)
            + at(y1, x0) * (1 - wx) * wy + at(y1, x1) * wx * wy)


def triplane_decode(params, code, xyz, tcfg, prec):
    """code (B, 3, C, H, W), xyz (B, P, 3) -> sigma (B, P), rgb (B, P, 3)."""
    B, _, C, H, W = code.shape
    P = xyz.shape[1]
    x, y, z = (xyz[..., i] / tcfg["bound"] for i in range(3))
    z = -z
    axes = {"x": x, "y": y, "z": z}
    grid = torch.stack([torch.stack([axes[p[0]], axes[p[1]]], -1)
                        for p in ("yx", "yz", "xz")]).transpose(0, 1)
    s = _corner_sample(code.float().reshape(B * 3, C, H, W),
                       grid.reshape(B * 3, 1, P, 2))
    feat = s.reshape(B, 3, C, P).permute(0, 3, 2, 1).reshape(B, P, -1)
    base = mlp(params["base"], feat, prec)
    act = base * torch.sigmoid(base)
    sigma = _TruncExp.apply(mlp(params["density"], act, prec)[..., 0])
    rgb = torch.sigmoid(mlp(params["color"], act, prec))
    sat = 0.001
    return sigma, rgb * (1 + 2 * sat) - sat


def render(decode, ro, rd, num_samples, bound):
    """Bin-centre samples inside the AABB, front-to-back compositing on a
    white background (no occupancy grid)."""
    tiny = torch.where(rd >= 0, 1e-9, -1e-9).to(rd.dtype)
    inv = 1.0 / torch.where(rd.abs() < 1e-9, tiny, rd)
    t0, t1 = (-bound - ro) * inv, (bound - ro) * inv
    near = torch.minimum(t0, t1).amax(-1).clamp(min=0.05)
    far = torch.maximum(t0, t1).amin(-1)
    hit = far > near
    far = torch.where(hit, far, near + 1e-3)
    S = num_samples
    u = (torch.arange(S, dtype=ro.dtype, device=ro.device) + 0.5) / S
    ts = near[..., None] + (far - near)[..., None] * u
    last = ts[..., -1:] + (far - near)[..., None] / S
    deltas = torch.diff(ts, dim=-1, append=last)
    xyz = ro[..., None, :] + rd[..., None, :] * ts[..., None]
    valid = hit[..., None].expand(ts.shape)
    sig, rgb = decode(xyz)
    sig = torch.where(valid, sig, torch.zeros_like(sig))
    alpha = 1.0 - torch.exp(-sig * deltas)
    log_t = torch.cumsum(torch.log((1.0 - alpha).clamp(min=1e-10))
                         .double(), -1).float()
    trans = torch.exp(torch.cat([torch.zeros_like(log_t[..., :1]),
                                 log_t[..., :-1]], -1))
    w = alpha * trans * (trans > 1e-4).float()
    out = (w[..., None] * rgb).sum(-2)
    return out + (1.0 - w.sum(-1))[..., None]


def lpips(params, pred, target, prec):
    def norm(im):
        sh = torch.tensor(SHIFT, device=im.device)
        sc = torch.tensor(SCALE, device=im.device)
        return ((im * 2.0 - 1.0 - sh) / sc).permute(0, 3, 1, 2)

    def feats(x):
        out, i, h = [], 0, x
        for v in VGG16:
            if v == "M":
                h = F.max_pool2d(h, 2, 2)
                continue
            c = params["convs"][i]
            h = torch.relu(F.conv2d(prec.bf16(h), prec.bf16(c["w"].float()),
                                    c["b"].float(), padding=1))
            if i in TAPS:
                out.append(h)
            i += 1
        return out
    total = 0
    for a, b, lin in zip(feats(norm(pred)), feats(norm(target)),
                         params["lins"]):
        a = a / torch.linalg.vector_norm(a, dim=1, keepdim=True).clamp(
            min=1e-10)
        b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True).clamp(
            min=1e-10)
        total = total + (((a - b) ** 2) * lin.float().clamp(min=0)[
            :, None, None]).sum(1).mean((1, 2))
    return total.mean()


def render_loss(dec, codes_act, batch, lpips_params, cfg, prec):
    ro, rd, rgb = batch["rays_o"], batch["rays_d"], batch["rgb"]
    B = ro.shape[0]

    def decode(x):
        s, c = triplane_decode(dec, codes_act, x.reshape(B, -1, 3),
                               cfg["triplane"], prec)
        return s.reshape(x.shape[:-1]), c.reshape(*x.shape[:-1], 3)
    out = render(decode, ro, rd, cfg["num_samples"], cfg["bound"])
    d = out - rgb
    total = torch.where(d >= 0, d, -d).mean((1, 2)).mean()
    ps = cfg["patch_size"]
    return total + lpips(lpips_params, out.reshape(B, ps, ps, 3),
                         rgb.reshape(B, ps, ps, 3), prec) * cfg[
                             "lpips_weight"]


# ---------------------------------------------------------------- denoiser
def lora_unet_out(unet, base, lora, x, t, cond, latent_shape):
    """The LoRA merged into the frozen weights, then the UNet on the code
    as a (P H, W, C) latent image."""
    B = x.shape[0]
    P, C, H, W = latent_shape
    h = x.permute(0, 1, 3, 4, 2).reshape(B, P * H, W, C)
    if cond is None:
        cond = torch.zeros((B, 77, unet.cfg.cross_attention_dim),
                           device=x.device)
    weights = dict(base)
    for path, ab in lora.items():
        weights[path + ".weight"] = base[path + ".weight"] + ab["b"] @ ab["a"]
    out = torch.func.functional_call(unet, weights, (h, t, cond))
    return out.reshape(B, P, H, W, C).permute(0, 1, 4, 2, 3)


def diffusion_loss_grads(unet, base, lora, codes, t, noise, cond, acp,
                         latent_shape, chunk=2):
    """The v-prediction loss (timestep weights (1 - acp)^0.5 over their
    batch mean) and its gradients in the LoRA factors and the codes, the
    batch in chunks whose gradients add up."""
    acp_t = torch.as_tensor(acp, dtype=torch.float32,
                            device=codes.device)[t.long()]
    sa, sn = acp_t.sqrt(), (1 - acp_t).sqrt()
    w = (1.0 - acp_t) ** 0.5
    w = w / w.mean().clamp(min=1e-8)
    leaves = [ab[k] for ab in lora.values() for k in ("a", "b")]
    grads = [torch.zeros_like(x) for x in leaves]
    cgrad = torch.zeros_like(codes)
    total = 0
    B = codes.shape[0]
    shape = (-1,) + (1,) * (codes.dim() - 1)
    for i in range(0, B, chunk):
        sl = slice(i, i + chunk)
        c = codes[sl].detach().requires_grad_(True)
        lr = {p: {k: v.detach().requires_grad_(True) for k, v in ab.items()}
              for p, ab in lora.items()}
        xt = sa[sl].reshape(shape) * c + sn[sl].reshape(shape) * noise[sl]
        out = lora_unet_out(unet, base, lr, xt, t[sl],
                            None if cond is None else cond[sl],
                            latent_shape)
        target = sa[sl].reshape(shape) * noise[sl] \
            - sn[sl].reshape(shape) * c
        mse = ((out - target) ** 2).mean(tuple(range(1, c.dim())))
        loss = (mse * w[sl]).sum() / B
        lv = [ab[k] for ab in lr.values() for k in ("a", "b")]
        g = torch.autograd.grad(loss, lv + [c])
        for acc, gi in zip(grads, g[:-1]):
            acc += gi
        cgrad[sl] = g[-1]
        total = total + loss.detach()
    out, i = {}, 0
    for p in lora:
        out[p] = {"a": grads[i], "b": grads[i + 1]}
        i += 2
    return total, out, cgrad


# ---------------------------------------------------------------- Adam
def adam(params, grads, opt, lr, b1=0.9, b2=0.999, eps=1e-8, wd=0.0):
    count = opt["count"] + 1
    m = {k: (1 - b1) * grads[k] + b1 * opt["m"][k] for k in params}
    v = {k: (1 - b2) * grads[k] * grads[k] + b2 * opt["v"][k]
         for k in params}
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    new = {}
    for k, p in params.items():
        u = (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps)
        if wd:
            u = u + wd * p
        new[k] = p - lr * u
    return new, {"m": m, "v": v, "count": count}


def code_adam(codes, grads, m, v, steps, lr, b1=0.9, b2=0.99, eps=1e-8):
    steps = steps + 1
    m = b1 * m + (1 - b1) * grads
    v = b2 * v + (1 - b2) * grads ** 2
    t = steps.reshape((-1,) + (1,) * (codes.dim() - 1)).float()
    return (codes - lr * (m / (1 - b1 ** t))
            / (torch.sqrt(v / (1 - b2 ** t)) + eps), m, v, steps)


class Cache:
    """Per-scene codes and their Adam moments in float16, as the scene-code
    cache stores them; rows go out as float32."""

    def __init__(self, n, shape, device):
        z = torch.zeros((n, *shape), dtype=torch.float16, device=device)
        self.codes, self.m, self.v = z, z.clone(), z.clone()
        self.steps = torch.zeros((n,), dtype=torch.int32, device=device)

    def gather(self, ids):
        return (self.codes[ids].float(), self.m[ids].float(),
                self.v[ids].float(), self.steps[ids])

    def scatter(self, ids, codes, m, v, steps):
        self.codes[ids] = codes.half()
        self.m[ids] = m.half()
        self.v[ids] = v.half()
        self.steps[ids] = steps


def flat(tree, prefix=""):
    """{dotted path: tensor} of a tree of dicts and lists."""
    out = {}
    if torch.is_tensor(tree):
        out[prefix] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}.{i}" if prefix else str(i)))
    return out


def unflat(tree, values, prefix=""):
    if torch.is_tensor(tree):
        return values[prefix]
    if isinstance(tree, dict):
        return {k: unflat(v, values, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    return [unflat(v, values, f"{prefix}.{i}" if prefix else str(i))
            for i, v in enumerate(tree)]


def train_step(S, batch, draws, unet, base, acp, cfg, prec):
    """One step from the reference state S {lora, lora_opt, decoder,
    decoder_opt, cache, lpips}; returns (metrics, grads) and updates S."""
    ids = batch["scene_ids"]
    codes, cm, cv, steps = S["cache"].gather(ids)
    dl, lgrads, prior = diffusion_loss_grads(
        unet, base, S["lora"], codes, draws["t"], draws["noise"],
        batch.get("cond"), acp, cfg["latent_shape"])
    lf = {f"lora.{p}.{k}": v for p, ab in S["lora"].items()
          for k, v in ab.items()}
    lg = {f"lora.{p}.{k}": v for p, ab in lgrads.items()
          for k, v in ab.items()}
    new, S["lora_opt"] = adam(lf, lg, S["lora_opt"], cfg["denoiser_lr"],
                              wd=1e-2)
    S["lora"] = {p: {"a": new[f"lora.{p}.a"], "b": new[f"lora.{p}.b"]}
                 for p in S["lora"]}
    dec = {k: v.detach().requires_grad_(True)
           for k, v in flat(S["decoder"]).items()}
    c = codes.detach().requires_grad_(True)
    act = torch.tanh(c / 2.0) * 2.0
    rl = render_loss(unflat(S["decoder"], dec), act, batch, S["lpips"], cfg,
                     prec)
    keys = list(dec)
    g = torch.autograd.grad(rl, [dec[k] for k in keys] + [c],
                            allow_unused=True)
    dg = {k: torch.zeros_like(dec[k]) if gi is None else gi
          for k, gi in zip(keys, g[:-1])}
    newd, S["decoder_opt"] = adam({k: v.detach() for k, v in dec.items()},
                                  dg, S["decoder_opt"], cfg["decoder_lr"])
    S["decoder"] = unflat(S["decoder"], newd)
    codes, cm, cv, steps = code_adam(codes, g[-1] + prior, cm, cv, steps,
                                     cfg["code_lr"])
    S["cache"].scatter(ids, codes, cm, cv, steps)
    return ({"loss_diffusion": float(dl), "loss_render": float(rl.detach())},
            {"lora": lg, "decoder": dg, "codes": g[-1] + prior})


def init_state(lora, decoder, lpips_params, n_scenes, code_shape, device):
    def zeros(d):
        return {k: torch.zeros_like(v) for k, v in d.items()}
    lf = {f"lora.{p}.{k}": v for p, ab in lora.items()
          for k, v in ab.items()}
    df = flat(decoder)
    return {"lora": lora, "lora_opt": {"m": zeros(lf), "v": zeros(lf),
                                       "count": 0},
            "decoder": decoder, "decoder_opt": {"m": zeros(df),
                                                "v": zeros(df), "count": 0},
            "cache": Cache(n_scenes, code_shape, device),
            "lpips": lpips_params}


def unet_cfg(d):
    return RD.UNetCfg(**{**d, "block_out_channels": tuple(
        d["block_out_channels"]), "attn_down": tuple(d["attn_down"])})

