"""The port's NeRF fit against the JAX package's, on the CPU in fp32: one
chunk of 8 steps (the pipeline's `fit_steps_per_program`) at tiny width:
3 views of 32^2 targets (one of them pruned: weight 0), 16^2 patches, 16
samples per ray, a 16^3 occupancy grid refreshed at the chunk's first
step, a dense field (8, 32) from the JAX init with its tables scaled up,
bridged, and every random draw of JAX's chunk injected (camera ids, patch
origins, ray and grid jitter; `torch_jax_draws.nerf_fit_draws`).

Held, with LPIPS off and on (VGG16 at its published widths, seeded by the
JAX init, bridged by `lpips_params_from_flax`), the schedule weights the
pipeline's at progress 0.25 (entropy, normal TV and the patch LPIPS on):
- the first step: the loss and the gradient of every field tensor within
  1e-4 relative (L2), against the JAX fit's own `loss_fn`;
- the chunk: the loss of every step within 1e-4 relative; the MLP tensors
  within 1e-3 and the tables within 1e-2 relative L2; the grid density
  within 1e-3 relative. The tables part for a reason of the reference's
  own (ROADMAP Queue 3): Adam's eps is 1e-15, so its first update is
  lr * sign(gradient) for every entry the step touched, and an entry whose
  gradient nearly cancels (~1e-10) takes its sign from rounding: after one
  step 94 of 287496 entries of the fine level sit 2 lr apart, though the
  gradients agree to 1e-6 relative. The losses stay within 1e-5.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.apis.cameras import surround_rig
from mvedit_tpu.models import losses as JL
from mvedit_tpu.models import nerf_fit as JNF
from mvedit_tpu.models import volume_renderer as JV
from mvedit_tpu.models.fields import INGPConfig as JINGP
from mvedit_tpu.models.fields import ingp_init as j_ingp_init
from mvedit_tpu.models.fields import ingp_point_decode as j_decode
from mvedit_tpu.ops.dense_grid import DenseGridConfig as JDense
from mvedit_tpu.utils import camera as cam_utils

from mvedit_tpu_torch.models import losses as TL
from mvedit_tpu_torch.models import nerf_fit as TNF
from mvedit_tpu_torch.models import volume_renderer as TV
from mvedit_tpu_torch.models.fields import INGPConfig as TINGP
from mvedit_tpu_torch.models.fields import (field_leaves,
                                            field_params_from_flax,
                                            ingp_point_decode)
from mvedit_tpu_torch.ops.dense_grid import DenseGridConfig as TDense

from torch_jax_draws import nerf_fit_draws

torch.set_num_threads(2)
RS, PS, STEPS, TOL = 32, 16, 8, 1e-4
JCFG = JINGP(backend="dense", dense=JDense(resolutions=(8, 32),
                                           gather_dtype="float32"))
TCFG = TINGP(backend="dense", dense=TDense(resolutions=(8, 32),
                                           gather_dtype="float32"))
SCHED = {"lr": 0.00875, "entropy": 1.0, "patch_rgb": 0.6,
         "patch_normal": 0.75, "normal_reg": 3.0}


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _targets():
    rng = np.random.default_rng(0)
    poses, intr = surround_rig(3, 2.6, 40, -0.3, 0.6, RS, rng=rng)
    lights, _ = cam_utils.light_sampling(poses, rng=rng)
    yy, xx = np.mgrid[:RS, :RS] / RS
    masks = np.stack([((xx - 0.5 - 0.05 * i) ** 2 + (yy - 0.5) ** 2 < 0.08)
                      for i in range(3)]).astype(np.float32)[..., None]
    images = np.stack([np.stack([xx, yy, 0.5 + 0.3 * np.sin(6 * xx + i)], -1)
                       for i in range(3)]).astype(np.float32)
    return {"images": images * masks + (1 - masks), "masks": masks,
            "poses": poses.astype(np.float32),
            "intrinsics": intr.astype(np.float32),
            "cam_weights": np.array([1.0, 0.5, 0.0], np.float32),
            "cam_lights": lights.astype(np.float32)}


def j_dec(params, x):
    """The field with a density blob multiplied in (contrast for the grid
    and the rays)."""
    sigma, rgb = j_decode(params, x, JCFG)
    return sigma * 50.0 * jnp.exp(-8.0 * jnp.sum(x * x, -1)), rgb


def t_dec(params, x):
    sigma, rgb = ingp_point_decode(params, x, TCFG)
    return sigma * 50.0 * torch.exp(-8.0 * (x * x).sum(-1)), rgb


def _setup(lpips, steps):
    tg = _targets()
    rcfg = dict(num_samples=16, grid_size=16)
    kw = dict(patch_size=PS, n_steps=steps, alpha_soften=0.02,
              bg_width=0.015)
    jcfg = JNF.NerfFitConfig(render=JV.RenderConfig(**rcfg), **kw)
    tcfg = TNF.NerfFitConfig(render=TV.RenderConfig(**rcfg), **kw)
    field = j_ingp_init(jax.random.PRNGKey(0), JCFG)
    field["table"] = jax.tree_util.tree_map(lambda x: x * 1000.0,
                                            field["table"])
    field = jax.tree_util.tree_map(np.asarray, field)
    lp_j = JL.lpips_init(jax.random.PRNGKey(1)) if lpips else None
    return tg, jcfg, tcfg, field, lp_j


def _jax_leaves(p):
    return ([p["table"][k] for k in sorted(p["table"])]
            + [l[n] for l in p["mlp"] for n in ("w", "b")])


def _run_port(tcfg, tg, field, lp_j, draws):
    fit_t, make_opt = TNF.make_nerf_fit(t_dec, tcfg, RS,
                                        use_lpips=lp_j is not None)
    p_t = field_params_from_flax(field)
    p_t, _, g_t, out_t = fit_t(
        p_t, make_opt(p_t), TV.OccupancyGrid.create(16),
        {k: _t(v) for k, v in tg.items()}, sched=SCHED,
        lpips_params=None if lp_j is None else TL.lpips_params_from_flax(lp_j),
        draws=draws)
    return p_t, g_t, out_t


@pytest.mark.parametrize("lpips", [False, True])
def test_nerf_fit_step_gradients_match_jax(lpips):
    tg, jcfg, tcfg, field, lp_j = _setup(lpips, 1)
    key = jax.random.PRNGKey(4)
    fit_j, _ = JNF.make_nerf_fit(j_dec, jcfg, RS, use_lpips=lpips)
    loss_fn = inspect.getclosurevars(fit_j.__wrapped__).nonlocals["loss_fn"]
    jt = {k: jnp.asarray(v) for k, v in tg.items()}
    jt["masks_soft"] = JNF._soften_masks(jt["masks"], jcfg)
    k_patch, k_ray, _ = jax.random.split(jax.random.split(key, 1)[0], 3)
    patch = JNF._sample_patch(k_patch, jt, jcfg, RS)
    (loss_j, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, field),
        JV.OccupancyGrid.create(16), patch, k_ray,
        {k: jnp.float32(v) for k, v in SCHED.items()}, lp_j)
    p_t, _, out_t = _run_port(tcfg, tg, field, lp_j, nerf_fit_draws(
        key, 1, tg["cam_weights"], jcfg, RS))
    np.testing.assert_allclose(float(out_t["loss"][0]), float(loss_j),
                               rtol=TOL)
    for i, (a, g) in enumerate(zip(field_leaves(p_t), _jax_leaves(grads))):
        assert np.abs(np.asarray(g)).max() > 0, i
        assert _rel(a.grad.numpy(), g) <= TOL, (i, _rel(a.grad.numpy(), g))


@pytest.mark.parametrize("lpips", [False, True])
def test_nerf_fit_chunk_matches_jax(lpips):
    tg, jcfg, tcfg, field, lp_j = _setup(lpips, STEPS)
    key = jax.random.PRNGKey(4)
    fit_j, opt = JNF.make_nerf_fit(j_dec, jcfg, RS, use_lpips=lpips)
    p_j = jax.tree_util.tree_map(jnp.array, field)
    p_j, _, g_j, out_j = fit_j(
        p_j, opt.init(p_j), JV.OccupancyGrid.create(16),
        {k: jnp.asarray(v) for k, v in tg.items()}, key,
        sched={k: jnp.float32(v) for k, v in SCHED.items()},
        lpips_params=lp_j)
    p_t, g_t, out_t = _run_port(tcfg, tg, field, lp_j, nerf_fit_draws(
        key, STEPS, tg["cam_weights"], jcfg, RS))
    loss_j = np.asarray(out_j["loss"])
    assert np.isfinite(loss_j).all() and len(loss_j) == STEPS
    np.testing.assert_allclose(out_t["loss"].numpy(), loss_j, rtol=TOL)
    n_tables = len(field["table"])
    for i, (a, b) in enumerate(zip(field_leaves(p_t), _jax_leaves(p_j))):
        tol = 1e-2 if i < n_tables else 1e-3
        assert _rel(a.detach().numpy(), b) <= tol, (i, _rel(a.detach(), b))
    assert _rel(g_t.density.numpy(), g_j.density) <= 1e-3
    assert 0 < float(g_j.occ.mean()) < 1
