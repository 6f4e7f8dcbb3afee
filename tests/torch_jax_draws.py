"""The JAX package's random draws, made as its fits make them and handed to
the port as its `draws=` inputs (torch cannot reproduce threefry). Shared
by the parity tests of the NeRF fit, the texture refinement, the whole
pipeline, the re-texturing pipeline and texture superres.

Each helper makes the same `jax.random` calls in the same order as the
JAX function named in its docstring.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from mvedit_tpu.models.fields import ingp_init as j_ingp_init

from mvedit_tpu_torch.models.fields import field_params_from_flax


def _t(a):
    return torch.from_numpy(np.array(a))


def _stack(lists):
    return {k: _t(np.stack([np.asarray(x) for x in v]))
            for k, v in lists.items() if v}


def _logits(cam_weights, n):
    p = (jnp.asarray(cam_weights) > 0).astype(jnp.float32)
    return jnp.log(jnp.clip(p, 1e-9, None))[None].repeat(n, 0)


def chunk_keys(key, chunks):
    """The keys of `_nerf_fit_fns` / `_mesh_fit_fns`' chained programs: the
    key itself for one whole program, else one split per chunk."""
    if len(chunks) == 1:
        return [key]
    out = []
    for _ in chunks:
        key, kc = jax.random.split(key)
        out.append(kc)
    return out


def nerf_fit_draws(key, n_steps, cam_weights, cfg, render_size):
    """`make_nerf_fit`'s `fit(..., key)`: per step (k_patch, k_ray, k_grid);
    `_sample_patch`'s camera ids and patch origins from k_patch, the ray
    jitter from k_ray, the grid jitter from k_grid at refresh steps."""
    B, ps = cfg.patch_bs, cfg.patch_size
    S, g = cfg.render.num_samples, cfg.render.grid_size
    out = {k: [] for k in ("cam_ids", "oy", "ox", "jitter", "grid_jitter")}
    for i, k in enumerate(jax.random.split(key, n_steps)):
        k_patch, k_ray, k_grid = jax.random.split(k, 3)
        k1, k2, k3 = jax.random.split(k_patch, 3)
        out["cam_ids"].append(jax.random.categorical(
            k1, _logits(cam_weights, B)))
        out["oy"].append(jax.random.randint(k2, (B,), 0,
                                            render_size - ps + 1))
        out["ox"].append(jax.random.randint(k3, (B,), 0,
                                            render_size - ps + 1))
        out["jitter"].append(jax.random.uniform(k_ray, (B * ps * ps, S)))
        if i % cfg.update_extra_interval == 0:
            out["grid_jitter"].append(jax.random.uniform(k_grid,
                                                         (g, g, g, 3)))
    return _stack(out)


def _patch_origins(key, cfg, nb):
    ps = min(cfg.patch_size, cfg.raster.height)
    k_oy, k_ox = jax.random.split(key)
    return (jax.random.randint(k_oy, (nb,), 0, cfg.raster.height - ps + 1),
            jax.random.randint(k_ox, (nb,), 0, cfg.raster.width - ps + 1))


def mesh_fit_draws(key, n_steps, cam_weights, cfg, face_cap, lpips=False):
    """`make_mesh_fit`'s `_fit(..., key)`: per step (k1, k2); the views
    from k1, the regulariser faces from k2 and, with LPIPS, the patch
    origins from fold_in(k2, 7)."""
    out = {k: [] for k in ("view_ids", "reg_faces", "patch_oy", "patch_ox")}
    sub = bool(cfg.reg_face_samples) and cfg.reg_face_samples < face_cap
    for k in jax.random.split(key, n_steps):
        k1, k2 = jax.random.split(k)
        out["view_ids"].append(jax.random.categorical(
            k1, _logits(cam_weights, cfg.render_bs)))
        if sub:
            out["reg_faces"].append(jax.random.randint(
                k2, (cfg.reg_face_samples,), 0, face_cap))
        if lpips:
            oy, ox = _patch_origins(jax.random.fold_in(k2, 7), cfg,
                                    cfg.render_bs)
            out["patch_oy"].append(oy)
            out["patch_ox"].append(ox)
    return _stack(out)


def texture_fit_draws(cam_weights, cfg, key=None):
    """`pipelines/texture.py::make_texture_fit`'s `fit(..., key)`: chained
    programs of at most 64 steps, one split of the key per program, then
    one key per step and `views_per_step` categorical draws over the views
    with weight > 0. The texture pipeline passes no key, so every fit draws
    from PRNGKey(0)."""
    key = jax.random.PRNGKey(0) if key is None else key
    n = cfg.n_inverse_steps
    vps = min(cfg.views_per_step, len(cam_weights))
    Lp = min(64, n)
    programs = [Lp] * (n // Lp) + ([n % Lp] if n % Lp else []) if n else []
    if not programs:                 # no fit step (the port's n = 0)
        return {"view_ids": torch.zeros((0, vps), dtype=torch.int64)}
    ids = []
    for steps in programs:
        key, kc = jax.random.split(key)
        for k in jax.random.split(kc, steps):
            ids.append(np.asarray(jax.random.categorical(
                k, _logits(cam_weights, vps))))
    return {"view_ids": _t(np.stack(ids))}


def refine_draws(key, n_steps, cam_weights, cfg, lpips=False):
    """`make_texture_refine`'s `refine(..., key)`: per step (k1, k2); the
    views from k1, the LPIPS patch origins from k2."""
    out = {k: [] for k in ("view_ids", "patch_oy", "patch_ox")}
    for k in jax.random.split(key, n_steps):
        k1, k2 = jax.random.split(k)
        out["view_ids"].append(jax.random.categorical(
            k1, _logits(cam_weights, cfg.render_bs)))
        if lpips:
            oy, ox = _patch_origins(k2, cfg, cfg.render_bs)
            out["patch_oy"].append(oy)
            out["patch_ox"].append(ox)
    return _stack(out)


class JaxDraws:
    """A draw source for the port's `MVEdit3DPipeline` and
    `TexturePipeline` (the methods of `GeneratorDraws`) that replays
    `mvedit_tpu`'s pipeline `__call__` from `key`: the same splits of the
    same key in the same order. jax_ingp: the JAX field config (for the
    field init)."""

    def __init__(self, key, jax_ingp, lpips=False):
        self.key, self.jax_ingp, self.lpips = key, jax_ingp, lpips
        self._field_split = False

    def _split(self, n=1):
        self.key, *ks = jax.random.split(self.key, n + 1)
        return ks

    def field_init(self, cfg, device):
        (k0,) = self._split()
        self._field_split = True
        return field_params_from_flax(jax.tree_util.tree_map(
            np.asarray, j_ingp_init(k0, self.jax_ingp)), device)

    def latent_noise(self, shape, device):
        if not self._field_split:          # the reference splits k0 anyway
            self._split()
        k1, k2 = self._split(2)
        return (_t(jax.random.normal(k1, tuple(shape))).to(device),
                _t(jax.random.normal(k2, tuple(shape))).to(device))

    def fit(self, run, targets):
        (kf,) = self._split()
        cw = targets["cam_weights"].cpu().numpy()
        draws = []
        for kc, steps in zip(chunk_keys(kf, run.chunks), run.chunks):
            if run.kind == "nerf":
                d = nerf_fit_draws(kc, steps, cw, run.fit_cfg,
                                   run.render_size)
            else:
                d = mesh_fit_draws(kc, steps, cw, run.fit_cfg, run.face_cap,
                                   self.lpips)
            draws.append(d)
        return draws

    def refine(self, refine, targets, n_steps):
        (kb,) = self._split()
        return refine_draws(kb, n_steps, targets["cam_weights"].cpu().numpy(),
                            refine.cfg, self.lpips)

    def texture_fit(self, fit, targets):
        """The texture pipeline's fits take no key of the request's: each
        replays PRNGKey(0)."""
        return texture_fit_draws(targets["cam_weights"].cpu().numpy(),
                                 fit.cfg)


class JaxSuperResDraws:
    """A draw source for the port's `TextureSuperResPipeline` that replays
    `mvedit_tpu`'s superres `__call__` from `key`: the per-view latent
    noise from the first split, the field init from the second (split
    and unused when a live field is handed over, and nothing is drawn
    after it), and the albedo fit's views from PRNGKey(0) over all views
    (the fit is called without a key or cam_weights)."""

    def __init__(self, key, jax_ingp):
        self.key, self.jax_ingp = key, jax_ingp

    def _split(self):
        self.key, k = jax.random.split(self.key)
        return k

    def view_noise(self, shape, device):
        return _t(jax.random.normal(self._split(), tuple(shape))).to(device)

    def field_init(self, cfg, device):
        return field_params_from_flax(jax.tree_util.tree_map(
            np.asarray, j_ingp_init(self._split(), self.jax_ingp)), device)

    def texture_fit(self, fit, targets):
        return texture_fit_draws(np.ones(fit.cfg.num_views, np.float32),
                                 fit.cfg)


class JaxZero123PlusDraws:
    """A draw source for the port's `Zero123PlusPipeline` that replays
    `mvedit_tpu`'s `Zero123PlusPipeline.__call__` from `key`: key -> (key,
    k0) for the initial latents, then per step key -> (key, kr, ks), the
    reference noise from kr and the ancestral noise from ks."""

    def __init__(self, key):
        self.key = key

    def initial_latents(self, shape, device):
        self.key, k0 = jax.random.split(self.key)
        return _t(jax.random.normal(k0, tuple(shape))).to(device)

    def step_noise(self, ref_shape, lat_shape, device):
        self.key, kr, ks = jax.random.split(self.key, 3)
        return (_t(jax.random.normal(kr, tuple(ref_shape))).to(device),
                _t(jax.random.normal(ks, tuple(lat_shape))).to(device))


class JaxZero123Draws:
    """A draw source for the port's `Zero123Pipeline` that replays
    `mvedit_tpu`'s `Zero123Pipeline.__call__` from `key`: key -> (key, k0)
    for the initial latents, then per step key -> (key, kr), the DDIM
    noise from kr where eta > 0."""

    def __init__(self, key):
        self.key = key

    def initial_latents(self, shape, device):
        self.key, k0 = jax.random.split(self.key)
        return _t(jax.random.normal(k0, tuple(shape))).to(device)

    def step_noise(self, shape, device, eta):
        self.key, kr = jax.random.split(self.key)
        if eta <= 0:
            return None
        return _t(jax.random.normal(kr, tuple(shape))).to(device)


class JaxTextTo3DDraws(JaxDraws):
    """A draw source for the port's text-to-3D endpoints that replays
    `mvedit_tpu`'s: the code sample's initial noise from PRNGKey(seed)
    split once (`sample_from_noise`), the distillation's field init from
    PRNGKey(0) and each step's points from its next split
    (`distill_triplane_to_field`, whose seed is 0 whatever the request's),
    and the MVEdit loop's draws from PRNGKey(seed) (`JaxDraws`).
    jax_ingp: the JAX field config."""

    def __init__(self, seed, jax_ingp):
        super().__init__(jax.random.PRNGKey(seed), jax_ingp)
        self.seed, self.distill_key = seed, jax.random.PRNGKey(0)

    def code_noise(self, shape, device):
        _, k0 = jax.random.split(jax.random.PRNGKey(self.seed))
        return _t(jax.random.normal(k0, tuple(shape))).to(device)

    def distill_field_init(self, cfg, device):
        return field_params_from_flax(jax.tree_util.tree_map(
            np.asarray, j_ingp_init(self.distill_key, self.jax_ingp)), device)

    def distill_points(self, n, bound, device):
        self.distill_key, k = jax.random.split(self.distill_key)
        return _t(jax.random.uniform(k, (n, 3), minval=-bound,
                                     maxval=bound)).to(device)


def ssdnerf_step_draws(key, batch, code_shape, num_train_timesteps=1000):
    """`mvedit_tpu/models/ssdnerf.py::make_train_step`'s draws from the
    step's key: k1 -> t (B,), k2 -> the noise over the codes."""
    k1, k2 = jax.random.split(key)
    return {"t": _t(jax.random.randint(k1, (batch,), 0,
                                       num_train_timesteps)),
            "noise": _t(jax.random.normal(k2, (batch, *code_shape)))}


def ssdnerf_trainer_keys(key, n_steps):
    """The step keys of `mvedit_tpu/runner/trainer.py::Trainer.run`: the
    trainer's key split before every step."""
    out = []
    for _ in range(n_steps):
        key, k = jax.random.split(key)
        out.append(k)
    return out


def val_guide_noise(key, shape):
    """`sample_from_noise`'s initial x: the second half of its first
    split."""
    _, k0 = jax.random.split(key)
    return _t(jax.random.normal(k0, shape))


def val_optim_draws(key, n_steps, batch, code_shape,
                    num_train_timesteps=1000):
    """`make_val_optim`'s prior draws: one key a step, split into t and the
    noise -> {"t": (n_steps, B), "noise": (n_steps, B, *code_shape)}."""
    ts, noises = [], []
    for k in jax.random.split(key, n_steps):
        k1, k2 = jax.random.split(k)
        ts.append(np.asarray(jax.random.randint(k1, (batch,), 0,
                                                num_train_timesteps)))
        noises.append(np.asarray(jax.random.normal(k2,
                                                   (batch, *code_shape))))
    return {"t": _t(np.stack(ts)), "noise": _t(np.stack(noises))}
