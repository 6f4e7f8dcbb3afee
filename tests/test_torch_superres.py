"""Texture superres in the port against the JAX package, on the CPU in fp32.

Both runners load one seeded tiny checkpoint
(`torch_checkpoints.write_tiny_checkpoint`), hash prompts with the same
stable tokenizer, and draw the superres rig's elevations from
`np.random.default_rng(seed)` (the reference draws them from an unseeded
generator; the JAX runner is patched to the port's seeded draw); the port
replays JAX's draws (`torch_jax_draws.JaxSuperResDraws`: the per-view
latent noise, the field init, the albedo fit's views from PRNGKey(0)).

- `bake_multiview` (one 4-channel `segment_add` in the port, two scatters
  in the reference): within 1e-5.
- `camera_weights_uv` of a sphere with spherical uvs (64^2 atlas, two
  64^2 views): within 1e-5 on all but 0.2% of the texels (measured: all;
  a texel whose visibility test or depth-buffer pixel sat on a rounding
  tie would flip between 0 and its cosine).
- `rasterize.tile_load` (the smoke's count of the bake's overflowing
  tiles) equals what binning keeps, min(pairs, K), per tile.
- `make_texture_fit` without cam_weights: the port draws every view with
  equal weight (the same draws as all-ones weights, every view drawn),
  and 72 steps over 2 views (across the reference's 64-step program
  boundary) with JAX's draws give every step's loss within 1e-4
  relative (at lr 1e-4; draws for 72 steps from one program fail it).
- a tiny `run_texture_superres` (8 views of 64^2, one img2img timestep of
  2, 8 fit steps, a 128^2 atlas blended with the input's 128^2 albedo),
  with IP-Adapter on and off: the fit losses within 1e-4 relative, the
  final renders within 2e-4 (measured 4.3e-5), the port's bake of the JAX
  field (tile 32 on the plain selection, dilation, blend) within 1e-5 of
  the JAX albedo, and the whole request's albedo within mean |d| 5e-4 and
  max |d| 1e-2 (measured 6.7e-5 / 1.2e-4 and 3.3e-3 / 2.6e-3: Adam's eps
  1e-15 turns rounding into +-lr updates where a gradient nearly cancels,
  which moves the field's MLP weights apart; ROADMAP, reference
  behaviours).
- a tiny `run_retex(..., superres={"steps": 2})` that hands the live
  field over: the superres fit's losses within 1e-4 relative; its renders
  within the retex test's bounds (max 1e-2, mean 1e-3; measured max
  2.8e-3), since they start from the retex field, and its albedo within
  mean 2e-3 and max 5e-2 (measured 2.9e-4 and 1.4e-2).
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvedit_tpu.apis.cameras as JC
import mvedit_tpu.pipelines.superres as JS
from mvedit_tpu.apis import Adapter3DRunner as JRunner
from mvedit_tpu.models.fields import FieldColor as JFieldColor
from mvedit_tpu.models.fields import INGPConfig as JINGP
from mvedit_tpu.models.fields import ingp_init as j_ingp_init
from mvedit_tpu.models.mesh import RasterConfig as JRC
from mvedit_tpu.models.mesh import camera_weights_uv as j_cwuv
from mvedit_tpu.models.mesh.texture import bake_multiview as j_bmv
from mvedit_tpu.ops.dense_grid import DenseGridConfig as JDense
from mvedit_tpu.pipelines.texture import TextureConfig as JTextureConfig
from mvedit_tpu.pipelines.texture import make_texture_fit as j_fit
from mvedit_tpu.utils.camera import get_pose_from_angles

from mvedit_tpu_torch.apis import Adapter3DRunner as TRunner
from mvedit_tpu_torch.models.fields import FieldColor as TFieldColor
from mvedit_tpu_torch.models.fields import INGPConfig as TINGP
from mvedit_tpu_torch.models.fields import field_params_from_flax
from mvedit_tpu_torch.models.mesh import Mesh
from mvedit_tpu_torch.models.mesh import RasterConfig as TRC
from mvedit_tpu_torch.models.mesh import bake_multiview as t_bmv
from mvedit_tpu_torch.models.mesh import camera_weights_uv as t_cwuv
from mvedit_tpu_torch.ops.dense_grid import DenseGridConfig as TDense
from mvedit_tpu_torch.pipelines import (SuperResConfig,
                                        TextureSuperResPipeline)
from mvedit_tpu_torch.pipelines.texture import TextureConfig as TTextureConfig
from mvedit_tpu_torch.pipelines.texture import make_texture_fit as t_fit
from torch_checkpoints import write_tiny_checkpoint
from torch_jax_draws import JaxDraws, JaxSuperResDraws, texture_fit_draws
from torch_tokenizer import StableHashTokenizer

torch.set_num_threads(2)

SEED = 1
BMV_TOL, CW_TOL, CW_OFF, LOSS_RTOL = 1e-5, 1e-5, 2e-3, 1e-4
RENDER_TOL, BAKE_TOL, ALBEDO_MEAN, ALBEDO_MAX = 2e-4, 1e-5, 5e-4, 1e-2
# chained: the retex field handed over is within `test_torch_retex.py`'s
# bounds of the reference's (renders max 1e-2, mean 1e-3)
CHAIN_MAX, CHAIN_MEAN, CHAIN_ALBEDO_MEAN, CHAIN_ALBEDO_MAX = \
    1e-2, 1e-3, 2e-3, 5e-2
# the runners' tiny superres field (endpoints.py proc_texture_superres)
J_INGP = JINGP(backend="dense", dense=JDense(resolutions=(8, 32)))
T_INGP = TINGP(backend="dense", dense=TDense(resolutions=(8, 32)))


def _sphere(n=10):
    """A sphere of n rings of 2n + 1 vertices (the seam's column twice,
    at u = 0 and u = 1) with per-vertex spherical uvs: no face wraps
    around the atlas."""
    th = np.linspace(0.15, np.pi - 0.15, n)
    ph = np.linspace(0, 2 * np.pi, 2 * n + 1)
    v = np.array([[math.sin(t) * math.cos(p), math.sin(t) * math.sin(p),
                   math.cos(t) * 1.2] for t in th for p in ph], np.float32)
    f = []
    for i in range(n - 1):
        for j in range(2 * n):
            a, b = i * (2 * n + 1) + j, i * (2 * n + 1) + j + 1
            c, d = a + 2 * n + 1, b + 2 * n + 1
            f += [[a, c, b], [b, c, d]]
    vt = np.array([[0.02 + 0.96 * p / (2 * np.pi), 0.02 + 0.96 * t / np.pi]
                   for t in th for p in ph], np.float32)
    return v * 0.6, np.array(f, np.int32), vt


def test_bake_multiview_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.random((3, 16, 16, 3)).astype(np.float32)
    uv = rng.uniform(-0.1, 1.1, (3, 16, 16, 2)).astype(np.float32)
    w = (rng.random((3, 16, 16)) * (rng.random((3, 16, 16)) > 0.3)
         ).astype(np.float32)
    ja, jw = j_bmv(jnp.asarray(img), jnp.asarray(uv), jnp.asarray(w),
                   (12, 10))
    ta, tw = t_bmv(torch.from_numpy(img), torch.from_numpy(uv),
                   torch.from_numpy(w), (12, 10))
    assert ta.shape == (12, 10, 3) and tw.shape == (12, 10)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=BMV_TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=BMV_TOL)


def test_camera_weights_uv_matches_jax():
    v, f, vt = _sphere()
    poses = get_pose_from_angles(np.array([0.3, 2.0]), np.array([0.2, -0.3]),
                                 3.1)[:, :3]
    intr = np.tile(np.array([[70.0, 70.0, 32.0, 32.0]], np.float32), (2, 1))
    cfg = dict(height=64, width=64, span=4, k_per_tile=128, k_big=32)
    ref = np.asarray(j_cwuv(
        jnp.asarray(v), jnp.asarray(f), jnp.ones(len(f), bool),
        jnp.asarray(vt), jnp.asarray(f), jnp.asarray(poses),
        jnp.asarray(intr), JRC(**cfg), JRC(**cfg)))
    out = t_cwuv(torch.from_numpy(v), torch.from_numpy(f).long(),
                 torch.ones(len(f), dtype=torch.bool), torch.from_numpy(vt),
                 torch.from_numpy(f).long(), torch.from_numpy(poses),
                 torch.from_numpy(intr), TRC(**cfg), TRC(**cfg)).numpy()
    assert out.shape == ref.shape == (2, 64, 64)
    off = np.abs(out - ref) > CW_TOL
    print(f"[camera_weights_uv] {off.mean():.4f} of texels off, covered "
          f"{(ref > 0).mean():.3f}")
    assert off.mean() <= CW_OFF and (ref > 0).mean() > 0.1


def test_tile_load_counts_what_binning_drops():
    """`rasterize.tile_load` (the smoke's count of the superres bake's
    overflow) against the bin lists: each tile keeps min(pairs, K)."""
    import importlib
    RZ = importlib.import_module("mvedit_tpu_torch.models.mesh.rasterize")
    n = 3000
    m = Mesh(v=np.zeros((3 * n, 3), np.float32),
             f=np.arange(3 * n, dtype=np.int32).reshape(n, 3))
    m.auto_uv()
    cfg = TRC(height=128, width=128, tile=32, k_per_tile=64, k_big=32)
    uv = torch.from_numpy(m.vt)
    pts = torch.stack([uv[:, 0] * 128, uv[:, 1] * 128,
                       torch.ones_like(uv[:, 0])], -1)
    faces = torch.from_numpy(m.ft).long()
    fv = torch.ones(n, dtype=torch.bool)
    pairs, big = RZ.tile_load(pts, faces, fv, cfg)
    _, tile_valid, _, big_valid = RZ._bin_triangles(pts, faces, fv, cfg)
    assert torch.equal(pairs.clamp(max=64), tile_valid.sum(1))
    assert big == int(big_valid.sum()) == 0
    assert int((pairs > 64).sum()) > 0


def _fit_setup(n_views=2, size=16, n_steps=72):
    rng = np.random.RandomState(3)
    xyz = rng.uniform(-0.5, 0.5, (n_views, size, size, 3)).astype(np.float32)
    alpha = (rng.random((n_views, size, size, 1)) > 0.2).astype(np.float32)
    weight = alpha * rng.random((n_views, size, size, 1)).astype(np.float32)
    # two views of different content, so that the view drawn shows
    images = np.stack([np.full((size, size, 3), 0.2 + 0.6 * i, np.float32)
                       for i in range(n_views)])
    images += 0.05 * rng.random(images.shape).astype(np.float32)
    # a small lr: Adam's eps 1e-15 makes near-cancelling gradients' updates
    # +-lr by rounding, which would blur a check of the draws
    kw = dict(num_views=n_views, render_size=size, n_inverse_steps=n_steps,
              lr=1e-4)
    return (dict(xyz=xyz, alpha=alpha, weight=weight), images,
            JTextureConfig(ingp=J_INGP, **kw), TTextureConfig(ingp=T_INGP,
                                                              **kw))


def test_texture_fit_draws_all_views_without_cam_weights():
    """No cam_weights: every view equally likely, the same draws as
    all-ones weights from the same generator."""
    _, images, _, tcfg = _fit_setup(n_views=5, n_steps=400)
    fit, _ = t_fit(TFieldColor(T_INGP), tcfg)
    imgs = torch.from_numpy(images)
    g1 = torch.Generator().manual_seed(0)
    g2 = torch.Generator().manual_seed(0)
    a = fit.draw({"images": imgs}, g1)["view_ids"]
    b = fit.draw({"images": imgs, "cam_weights": torch.ones(5)},
                 g2)["view_ids"]
    assert torch.equal(a, b) and a.shape == (400, 4)
    counts = torch.bincount(a.reshape(-1), minlength=5)
    assert counts.min() > 0.8 * 320 and counts.max() < 1.2 * 320, counts


def test_texture_fit_across_a_program_boundary_matches_jax():
    """72 steps: the reference chains a 64-step and an 8-step program,
    each from its own split of PRNGKey(0); targets carry no cam_weights."""
    geom, images, jcfg, tcfg = _fit_setup()
    jp = j_ingp_init(jax.random.PRNGKey(5), J_INGP)
    tp = field_params_from_flax(jax.tree_util.tree_map(np.array, jp))
    jfit, jopt = j_fit(JFieldColor(J_INGP), jcfg)
    _, _, jl = jfit(jp, jopt.init(jp),
                    {k: jnp.asarray(x) for k, x in geom.items()},
                    {"images": jnp.asarray(images)})
    tfit, make_opt = t_fit(TFieldColor(T_INGP), tcfg)
    draws = texture_fit_draws(np.ones(2, np.float32), tcfg)
    _, _, tl = tfit(tp, make_opt(tp),
                    {k: torch.from_numpy(x) for k, x in geom.items()},
                    {"images": torch.from_numpy(images)}, draws=draws)
    assert tl.shape == (72,) == np.shape(jl)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=LOSS_RTOL)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("superres"))
    write_tiny_checkpoint(root, "safetensors", seed=4)
    v, f, vt = _sphere()
    albedo = np.random.RandomState(3).random((128, 128, 3)).astype(
        np.float32)
    path = os.path.join(root, "ball.glb")
    Mesh(v=v, f=f, vt=vt, ft=f.copy(), albedo=albedo).write(path)
    return root, path


@pytest.fixture
def seeded_jax_rig(monkeypatch):
    """The JAX runner's superres elevations from default_rng(SEED), as the
    port draws them."""
    orig = JC.random_surround_views
    monkeypatch.setattr(JC, "random_surround_views", lambda *a, **k: orig(
        *a, **{**k, "rng": np.random.default_rng(SEED)}))


def _runners(root):
    jr = JRunner(checkpoint_dir=root, seed=0, tiny_models=True)
    tr = TRunner(checkpoint_dir=root, seed=0, tiny_models=True,
                 device="cpu")
    jr.tokenizer = StableHashTokenizer()
    return jr, tr


def _jax_fit_losses(monkeypatch):
    losses = []
    orig = JS.make_texture_fit

    def recording(*a, **k):
        fit, opt = orig(*a, **k)

        def fit2(*fa, **fk):
            out = fit(*fa, **fk)
            losses.append(np.asarray(out[2]))
            return out
        return fit2, opt
    monkeypatch.setattr(JS, "make_texture_fit", recording)
    return losses


def _compare(tag, jsr, tsr, jlosses, tlosses, render_max, render_mean,
             albedo_mean, albedo_max):
    np.testing.assert_allclose(tlosses.detach().numpy(), jlosses,
                               rtol=LOSS_RTOL)
    jr, tr = np.asarray(jsr["renders"]), tsr["renders"].numpy()
    assert tr.shape == jr.shape == (8, 64, 64, 3)
    ja, ta = jsr["mesh"].albedo, tsr["mesh"].albedo
    assert ta.shape == ja.shape == (128, 128, 3) and np.isfinite(ta).all()
    d, da = np.abs(tr - jr), np.abs(ta - ja)
    print(f"[{tag}] renders max |d| {d.max():.3e} mean {d.mean():.3e}; "
          f"albedo mean |d| {da.mean():.3e} max {da.max():.3e}")
    assert d.max() <= render_max and d.mean() <= render_mean
    assert da.mean() <= albedo_mean and da.max() <= albedo_max


@pytest.mark.parametrize("ip", [True, False])
def test_run_texture_superres_matches_jax(setup, seeded_jax_rig,
                                          monkeypatch, ip):
    root, path = setup
    jr, tr = _runners(root)
    jlosses = _jax_fit_losses(monkeypatch)
    jout = jr.run_texture_superres(path, "a ball", seed=SEED,
                                   use_ip_adapter=ip)
    tout = tr.run_texture_superres(
        path, "a ball", seed=SEED, use_ip_adapter=ip,
        draws=JaxSuperResDraws(jax.random.PRNGKey(SEED), J_INGP))
    assert len(jlosses) == 1 and tout["fit_losses"].shape == (8,)
    _compare(f"superres ip={ip}", jout, tout, jlosses[0],
             tout["fit_losses"], RENDER_TOL, RENDER_TOL, ALBEDO_MEAN,
             ALBEDO_MAX)
    # the port's bake of the JAX field: tile 32, dilation and the blend
    mesh = tr.run_mesh_preproc(path)["mesh"]
    pipe = TextureSuperResPipeline(None, SuperResConfig(
        render_size=64, atlas_size=128, ingp=T_INGP))
    baked = pipe.bake(mesh, field_params_from_flax(jax.tree_util.tree_map(
        np.array, jout["field_params"])), torch.device("cpu"))
    np.testing.assert_allclose(baked.albedo, jout["mesh"].albedo,
                               atol=BAKE_TOL)


def test_run_retex_chains_superres_like_jax(setup, seeded_jax_rig,
                                            monkeypatch):
    """The retex field handed over in memory: no field init, and the
    superres init renders come from the live field."""
    root, path = setup
    jr, tr = _runners(root)
    jlosses = _jax_fit_losses(monkeypatch)
    kw = dict(seed=SEED, steps=2, n_inverse_steps=2)
    jout = jr.run_retex(path, "a ball", superres={"steps": 2}, **kw)
    tout = tr.run_retex(
        path, "a ball", draws=JaxDraws(jax.random.PRNGKey(SEED), J_INGP),
        superres={"steps": 2, "draws": JaxSuperResDraws(
            jax.random.PRNGKey(SEED), J_INGP)}, **kw)
    assert len(jlosses) == 1 and len(tout["fit_losses"]) == 2
    _compare("retex + superres",
             {"renders": jout["superres_renders"], "mesh": jout["mesh"]},
             {"renders": tout["superres_renders"], "mesh": tout["mesh"]},
             jlosses[0], tout["superres_fit_losses"], CHAIN_MAX, CHAIN_MEAN,
             CHAIN_ALBEDO_MEAN, CHAIN_ALBEDO_MAX)
