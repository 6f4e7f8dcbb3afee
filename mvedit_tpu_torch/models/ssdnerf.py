"""SSDNeRF: multi-scene triplane NeRF + code diffusion, sampling and
training (counterpart of `mvedit_tpu/models/ssdnerf.py`).

- The diffusion latent is the raw code; the decoder reads
  `tanh_code(code) = tanh(code / 2) * 2`.
- `SceneCodeCache` keeps the per-scene codes and their Adam moments on the
  host (numpy, fp16 by default) in the JAX package's `.npz` layout (codes,
  m, v, steps); `FileSceneCodeCache` keeps one `.npz` a scene on disk,
  written by a pool of threads, a scene's pending write awaited before it
  is read again. Both hand a batch to the device as float32 tensors.
- `make_train_step` is the reference's step: (a) the diffusion loss on the
  raw codes -> the denoiser's AdamW update and the codes' prior gradient;
  (b) the render loss on the activated *original* codes -> the decoder's
  Adam update and the codes' Adam update from the render gradient plus the
  prior gradient. Stage 1 (`with_diffusion=False`) has no denoiser and no
  prior. The step's draws (`t`, `noise`) come from a `torch.Generator` or
  are given (`draws=`).
- `make_render_loss`, `make_val_guide` (guided sampling through
  `sample_from_noise(grad_guide_fn=)`) and `make_val_optim` (Adam on the
  code against condition views).

Every scene of a batch is rendered in one `render_rays` call on (B, R)
rays, so the codes' gradient of a step is one fixed-order segment sum
(`ops/grid_sample.py`). The backward passes run under
`losses.deterministic_convs()`. Parameters are trees (dicts and lists) of
tensors; `adam_init` / `adam_update` are optax's adam / adamw on them
(weight decay on every leaf), so that state is plain tensors that
`runner/trainer.py` checkpoints.
"""
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from . import gaussian_diffusion as GD
from .gaussian_diffusion import GaussianDiffusionConfig
from .losses import _abs, deterministic_convs
from .triplane import TriPlaneConfig, triplane_point_decode
from .volume_renderer import RenderConfig, render_rays

__all__ = ["SSDNeRFConfig", "SceneCodeCache", "FileSceneCodeCache",
           "tanh_code", "tanh_code_inverse", "tree_map", "tree_leaves",
           "adam_init", "adam_update", "module_params", "module_apply",
           "make_train_step", "make_render_loss", "make_val_guide",
           "make_val_optim"]


def tanh_code(code, scale=2.0):
    return torch.tanh(code / scale) * scale


def tanh_code_inverse(act, scale=2.0):
    return torch.atanh((act / scale).clamp(-0.999999, 0.999999)) * scale


@dataclass(frozen=True)
class SSDNeRFConfig:
    code_shape: tuple = (3, 16, 80, 80)    # activated feature triplane
    latent_shape: tuple = (3, 12, 40, 40)  # diffusion latent
    triplane: TriPlaneConfig = field(default_factory=TriPlaneConfig)
    render: RenderConfig = field(default_factory=lambda: RenderConfig(
        num_samples=96, bound=0.5))
    n_rays: int = 4096
    code_lr: float = 0.04
    decoder_lr: float = 1e-3
    denoiser_lr: float = 1e-4
    diffusion: GaussianDiffusionConfig = field(
        default_factory=GaussianDiffusionConfig)


# ---------------------------------------------------------------------------
# trees of tensors and Adam
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """`fn` over the leaves of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def adam_init(params):
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params), "count": 0}


@torch.no_grad()
def adam_update(params, grads, opt, lr, b1=0.9, b2=0.999, eps=1e-8,
                weight_decay=0.0):
    """optax's adam (weight_decay 0) or adamw, on a tree: returns (params,
    opt). The weight decay applies to every leaf, as optax's does."""
    count = opt["count"] + 1
    m = tree_map(lambda m, g: (1 - b1) * g + b1 * m, opt["m"], grads)
    v = tree_map(lambda v, g: (1 - b2) * g * g + b2 * v, opt["v"], grads)
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count

    def step(p, m, v):
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay:
            u = u + weight_decay * p
        return p - lr * u
    return tree_map(step, params, m, v), {"m": m, "v": v, "count": count}


def _code_adam(codes, grads, m, v, steps, lr, b1=0.9, b2=0.99, eps=1e-8):
    """Per-scene Adam on the raw codes (each scene its own step count)."""
    steps = steps + 1
    m = b1 * m + (1 - b1) * grads
    v = b2 * v + (1 - b2) * grads ** 2
    t = steps.reshape((-1,) + (1,) * (codes.dim() - 1)).float()
    mhat = m / (1 - b1 ** t)
    vhat = v / (1 - b2 ** t)
    return codes - lr * mhat / (torch.sqrt(vhat) + eps), m, v, steps


def module_params(net):
    """A module's parameters as a dict of detached tensors."""
    return {k: p.detach().clone() for k, p in net.named_parameters()}


def module_apply(net):
    """(params, x, t, cond) -> net(x, t, cond) with `params` in place of
    the module's own (`torch.func.functional_call`)."""
    def apply(params, x, t, cond=None):
        return torch.func.functional_call(net, params, (x, t, cond))
    return apply


# ---------------------------------------------------------------------------
# scene-code caches
# ---------------------------------------------------------------------------

def _host(x, dtype):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x,
                      dtype)


class SceneCodeCache:
    """Host-side per-scene codes + Adam moments (fp16 storage); `gather`
    hands a batch to `device` as float32 tensors."""

    def __init__(self, num_scenes, code_shape, dtype=np.float16,
                 device=None):
        self.codes = np.zeros((num_scenes, *code_shape), dtype)
        self.m = np.zeros_like(self.codes)
        self.v = np.zeros_like(self.codes)
        self.steps = np.zeros((num_scenes,), np.int32)
        self.device = device

    def _dev(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def gather(self, ids):
        return (self._dev(self.codes[ids]), self._dev(self.m[ids]),
                self._dev(self.v[ids]),
                self._dev(self.steps[ids], torch.int32))

    def scatter(self, ids, codes, m, v, steps):
        self.codes[ids] = _host(codes, self.codes.dtype)
        self.m[ids] = _host(m, self.m.dtype)
        self.v[ids] = _host(v, self.v.dtype)
        self.steps[ids] = _host(steps, np.int32)

    def save(self, path):
        np.savez(path, codes=self.codes, m=self.m, v=self.v,
                 steps=self.steps)

    @classmethod
    def load(cls, path, device=None):
        d = np.load(path)
        obj = cls.__new__(cls)
        obj.codes, obj.m, obj.v, obj.steps = (
            d["codes"], d["m"], d["v"], d["steps"])
        obj.device = device
        return obj

    def get_code(self, i):
        return self.codes[i]

    def flush(self):
        pass


class FileSceneCodeCache:
    """Disk-backed per-scene codes (`scene_XXXXXXXX.npz` of code, m, v
    under `cache_dir`), written by `num_file_writers` threads; a scene's
    pending write is awaited before it is read again, so `gather` never
    sees a torn file. Missing scenes read as zeros."""

    def __init__(self, num_scenes, code_shape, cache_dir,
                 dtype=np.float16, num_file_writers=4, device=None):
        import concurrent.futures as cf
        os.makedirs(cache_dir, exist_ok=True)
        self.num_scenes = int(num_scenes)
        self.code_shape = tuple(code_shape)
        self.cache_dir = cache_dir
        self.dtype = np.dtype(dtype)
        self.device = device
        self._pool = cf.ThreadPoolExecutor(max_workers=num_file_writers)
        self._pending = {}          # scene id -> in-flight Future
        self.steps = np.zeros((self.num_scenes,), np.int32)

    def _path(self, i):
        return os.path.join(self.cache_dir, f"scene_{int(i):08d}.npz")

    def _wait(self, i):
        fut = self._pending.pop(int(i), None)
        if fut is not None:
            fut.result()

    def _read(self, i):
        self._wait(i)
        p = self._path(i)
        if not os.path.exists(p):
            z = np.zeros(self.code_shape, self.dtype)
            return z, np.zeros_like(z), np.zeros_like(z)
        with np.load(p) as d:
            return d["code"], d["m"], d["v"]

    def get_code(self, i):
        return self._read(i)[0]

    def gather(self, ids):
        rows = [self._read(i) for i in np.asarray(ids).reshape(-1)]

        def dev(k):
            return torch.as_tensor(np.stack([r[k] for r in rows]),
                                   device=self.device).float()
        return (dev(0), dev(1), dev(2),
                torch.as_tensor(self.steps[ids], device=self.device))

    def scatter(self, ids, codes, m, v, steps):
        codes, m, v = (_host(x, self.dtype) for x in (codes, m, v))
        self.steps[ids] = _host(steps, np.int32)

        def write(path, c, mm, vv):
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:   # np.savez would append .npz
                np.savez(f, code=c, m=mm, v=vv)
            os.replace(tmp, path)

        for j, i in enumerate(np.asarray(ids).reshape(-1)):
            self._wait(i)
            self._pending[int(i)] = self._pool.submit(
                write, self._path(i), codes[j], m[j], v[j])

    def flush(self):
        for i in list(self._pending):
            self._wait(i)

    def save(self, path=None):
        """The codes already live on disk: flush the writers, write the
        step counts."""
        self.flush()
        np.savez(os.path.join(self.cache_dir, "steps.npz"),
                 steps=self.steps, code_shape=np.asarray(self.code_shape))

    def close(self):
        self.flush()
        self._pool.shutdown()

    @classmethod
    def load(cls, cache_dir, num_file_writers=4, device=None):
        d = np.load(os.path.join(cache_dir, "steps.npz"))
        obj = cls(len(d["steps"]), tuple(d["code_shape"]), cache_dir,
                  num_file_writers=num_file_writers, device=device)
        obj.steps = d["steps"].copy()
        return obj


# ---------------------------------------------------------------------------
# losses and steps
# ---------------------------------------------------------------------------

def make_render_loss(decoder_cfg: TriPlaneConfig, cfg: SSDNeRFConfig,
                     lpips_params=None, lpips_weight=1.2, patch_size=None):
    """render_loss(decoder_params, codes_act (B, 3, C, H, W), batch) -> the
    mean over scenes of each scene's mean |rgb - target| over its rays
    (bin-centre samples, no occupancy grid, white background); plus
    `lpips_weight` x LPIPS of the (patch_size, patch_size) patches when
    `lpips_params` and `patch_size` are given (the loader's patch mode)."""
    def render_loss(decoder_params, codes_act, batch):
        ro, rd, rgb = batch["rays_o"], batch["rays_d"], batch["rgb"]
        B = ro.shape[0]

        def decode(x):
            s, c = triplane_point_decode(decoder_params, codes_act,
                                         x.reshape(B, -1, 3), None,
                                         decoder_cfg)
            return s.reshape(x.shape[:-1]), c.reshape(*x.shape[:-1], 3)
        out = render_rays(decode, ro, rd, cfg.render, bg_color=1.0)
        total = _abs(out["rgb"] - rgb).mean((1, 2)).mean()
        if lpips_params is not None and patch_size is not None:
            from .losses import lpips_apply
            ps = patch_size
            total = total + lpips_apply(
                lpips_params, out["rgb"].reshape(B, ps, ps, 3),
                rgb.reshape(B, ps, ps, 3)) * lpips_weight
        return total
    return render_loss


def _grads(loss, trees):
    """d loss / d each tree's leaves -> trees of gradients (zeros for the
    leaves the loss does not use, such as the dir MLP without dirs)."""
    leaves = [tree_leaves(t) for t in trees]
    xs = [x for ls in leaves for x in ls]
    flat = [torch.zeros_like(x) if g is None else g for x, g in zip(
        xs, torch.autograd.grad(loss, xs, allow_unused=True))]
    out, i = [], 0
    for t, ls in zip(trees, leaves):
        out.append(_unflatten(t, flat[i:i + len(ls)]))
        i += len(ls)
    return out


def _leaf(x):
    return x.detach().requires_grad_(True)


def make_train_step(denoise_apply, decoder_cfg: TriPlaneConfig,
                    cfg: SSDNeRFConfig, schedule, with_decoder_loss=True,
                    with_diffusion=True, lpips_params=None, lpips_weight=1.2,
                    patch_size=None):
    """The SSDNeRF train step.

    denoise_apply(params, x, t, cond) -> the model's output over the
    latent shape (`module_apply`). Returns step(state, batch,
    generator=None, draws=None) -> (state, metrics) with
      state = {denoiser, denoiser_opt, decoder, decoder_opt, codes, code_m,
               code_v, code_steps}
      batch = {rays_o (B, R, 3), rays_d (B, R, 3), rgb (B, R, 3), cond}
    and draws = {"t": (B,) int, "noise": codes' shape}, else drawn from
    `generator` (t first). `with_diffusion=False` is stage 1: no denoiser
    in `state`, no prior gradient. The returned state holds new tensors;
    the metrics are 0-dim tensors."""
    render_loss = make_render_loss(decoder_cfg, cfg, lpips_params,
                                   lpips_weight, patch_size)

    def step(state, batch, generator=None, draws=None):
        state = dict(state)
        codes = state["codes"]
        B = codes.shape[0]
        metrics = {}
        if with_diffusion:
            if draws is None:
                dev = None if generator is None else generator.device
                draws = {"t": torch.randint(
                    0, schedule.num_train_timesteps, (B,),
                    generator=generator, device=dev),
                    "noise": torch.randn(codes.shape, generator=generator,
                                         device=dev)}
            dparams = tree_map(_leaf, state["denoiser"])
            c = _leaf(codes)
            with torch.enable_grad(), deterministic_convs():
                dloss = GD.training_loss(
                    schedule,
                    lambda x, tt, cc: denoise_apply(dparams, x, tt, cc),
                    c, draws["t"], draws["noise"], cond=batch.get("cond"),
                    cfg=cfg.diffusion)
                dgrads, prior = _grads(dloss, [dparams, c])
            state["denoiser"], state["denoiser_opt"] = adam_update(
                state["denoiser"], dgrads, state["denoiser_opt"],
                cfg.denoiser_lr, weight_decay=1e-2)
            metrics["loss_diffusion"] = dloss.detach()
        else:
            prior = torch.zeros_like(codes)
        if with_decoder_loss:
            dec = tree_map(_leaf, state["decoder"])
            c = _leaf(codes)
            with torch.enable_grad(), deterministic_convs():
                rloss = render_loss(dec, tanh_code(c), batch)
                decgrads, cgrads = _grads(rloss, [dec, c])
            metrics["loss_render"] = rloss.detach()
            state["decoder"], state["decoder_opt"] = adam_update(
                state["decoder"], decgrads, state["decoder_opt"],
                cfg.decoder_lr)
            with torch.no_grad():
                (state["codes"], state["code_m"], state["code_v"],
                 state["code_steps"]) = _code_adam(
                    codes, cgrads + prior, state["code_m"], state["code_v"],
                    state["code_steps"], cfg.code_lr)
        return state, metrics
    return step


def make_val_guide(denoise_apply, decoder_cfg: TriPlaneConfig,
                   cfg: SSDNeRFConfig, schedule, guide_gain=0.5):
    """Guided sampling (DiffusionNeRF.val_guide): every denoise step's x0
    estimate takes a render-loss gradient step against the condition
    views. val_guide(dparams, decoder_params, cond_batch, generator=None,
    noise=None, num_steps=50) -> the raw code (B, *latent_shape); `noise`
    the initial x, else drawn from `generator`."""
    render_loss = make_render_loss(decoder_cfg, cfg)

    @torch.no_grad()
    def val_guide(dparams, decoder_params, cond_batch, generator=None,
                  noise=None, num_steps=50):
        def guide_loss(code_latent):
            return render_loss(decoder_params, tanh_code(code_latent),
                               cond_batch)

        B = cond_batch["rays_o"].shape[0]
        with deterministic_convs():
            return GD.sample_from_noise(
                schedule, lambda x, t, c: denoise_apply(dparams, x, t, c),
                (B, *cfg.latent_shape), generator=generator, noise=noise,
                num_steps=num_steps, grad_guide_fn=guide_loss,
                guide_gain=guide_gain)
    return val_guide


def make_val_optim(denoise_apply, decoder_cfg: TriPlaneConfig,
                   cfg: SSDNeRFConfig, schedule, n_steps=100,
                   prior_weight=0.0):
    """Per-scene code refinement (DiffusionNeRF.val_optim): `n_steps` of
    Adam on the raw code against the condition views, with
    `prior_weight` x the diffusion loss when > 0. val_optim(dparams, code,
    decoder_params, cond_batch, generator=None, draws=None) -> (code,
    losses (n_steps,)); draws = {"t": (n_steps, B), "noise": (n_steps,
    *code.shape)}, else drawn from `generator` step by step (t, then
    noise)."""
    render_loss = make_render_loss(decoder_cfg, cfg)

    def val_optim(dparams, code, decoder_params, cond_batch, generator=None,
                  draws=None):
        code = code.detach()
        m, v = torch.zeros_like(code), torch.zeros_like(code)
        steps = torch.zeros((code.shape[0],), dtype=torch.int32,
                            device=code.device)
        dev = None if generator is None else generator.device
        losses = []
        for i in range(n_steps):
            c = _leaf(code)
            with torch.enable_grad(), deterministic_convs():
                loss = render_loss(decoder_params, tanh_code(c), cond_batch)
                if prior_weight > 0:
                    if draws is not None:
                        t, noise = draws["t"][i], draws["noise"][i]
                    else:
                        t = torch.randint(0, schedule.num_train_timesteps,
                                          (c.shape[0],), generator=generator,
                                          device=dev)
                        noise = torch.randn(c.shape, generator=generator,
                                            device=dev)
                    loss = loss + prior_weight * GD.training_loss(
                        schedule,
                        lambda x, tt, cc: denoise_apply(dparams, x, tt, cc),
                        c, t, noise, cfg=cfg.diffusion)
                (g,) = torch.autograd.grad(loss, [c])
            with torch.no_grad():
                code, m, v, steps = _code_adam(code, g, m, v, steps,
                                               cfg.code_lr)
            losses.append(loss.detach())
        return code, torch.stack(losses)
    return val_optim
