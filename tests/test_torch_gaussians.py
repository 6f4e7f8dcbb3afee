"""The port's gaussian-splatting renderer against the JAX package's, on the
CPU in f32 at 64^2, tile 16, K 64, with ~300 seeded gaussians, some at
tied depths and some off screen:

- each tile's candidate ids equal the reference's, id for id (JAX's are
  rebuilt here from its own `_project_gaussians` with the reference's
  binning lines: its `render_gaussians` returns no candidates);
- rgb, alpha and depth within 1e-5, and the gradients of a weighted sum
  of them w.r.t. all five attributes within 1e-4 of their largest
  magnitude;
- the reference's own checks (a centred blob, occlusion, a gradient that
  flows), one seed giving the same bits twice, and the attribute gathers'
  backward going through the fixed-order segment sum, once a render.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.models.mesh import gaussians as JG

from mvedit_tpu_torch.models.mesh.gaussians import (
    GSRasterConfig, bin_gaussians, project_gaussians, render_gaussians)

CFG = GSRasterConfig(height=64, width=64, tile=16, k_per_tile=64,
                     tile_chunk=16)
J_CFG = JG.GSRasterConfig(height=64, width=64, tile=16, k_per_tile=64,
                          tile_chunk=16)
NAMES = ("means", "scales", "quats", "colors", "opacities")


def _scene(n=300, seed=0):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
                      rng.uniform(1.5, 3.0, n)], -1)
    means[:40, 2] = 2.0                              # tied depths
    means[40:60, :2] = rng.uniform(3.0, 6.0, (20, 2))  # off screen
    means[60:70, 2] = -1.0                           # behind the camera
    attrs = {"means": means,
             "scales": rng.uniform(0.02, 0.12, (n, 3)),
             "quats": rng.normal(size=(n, 4)),
             "colors": rng.uniform(0, 1, (n, 3)),
             "opacities": rng.uniform(0.0, 1.0, n)}
    attrs = {k: v.astype(np.float32) for k, v in attrs.items()}
    pose = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(
        np.float32)
    intr = np.array([64.0, 64.0, 32.0, 32.0], np.float32)
    return attrs, pose, intr


def _pixel_weights(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(64, 64, 3)).astype(np.float32),
            rng.normal(size=(64, 64)).astype(np.float32),
            rng.normal(size=(64, 64)).astype(np.float32))


def _jax_candidates(a, pose, intr):
    """The reference's binning (gaussians.py:87-129), on its own
    projection."""
    cfg = J_CFG
    N = a["means"].shape[0]
    uv, depth, cov2d, radius = JG._project_gaussians(
        jnp.asarray(a["means"]), jnp.asarray(a["scales"]),
        jnp.asarray(a["quats"]), jnp.asarray(pose), jnp.asarray(intr), cfg)
    live = (depth > cfg.near) & (jnp.asarray(a["opacities"])
                                 > cfg.opacity_thr)
    ts = cfg.tile
    t0x = jnp.clip(((uv[:, 0] - radius) // ts).astype(jnp.int32), 0,
                   cfg.tiles_x - 1)
    t0y = jnp.clip(((uv[:, 1] - radius) // ts).astype(jnp.int32), 0,
                   cfg.tiles_y - 1)
    t1x = jnp.clip(((uv[:, 0] + radius) // ts).astype(jnp.int32), 0,
                   cfg.tiles_x - 1)
    t1y = jnp.clip(((uv[:, 1] + radius) // ts).astype(jnp.int32), 0,
                   cfg.tiles_y - 1)
    dx = jnp.arange(3)
    gx = t0x[:, None] + dx[None]
    gy = t0y[:, None] + dx[None]
    tile_id = gy[:, :, None] * cfg.tiles_x + gx[:, None, :]
    ok = ((gy <= t1y[:, None])[:, :, None] & (gx <= t1x[:, None])[:, None, :]
          & live[:, None, None])
    order = jnp.argsort(depth)
    rank = jnp.zeros((N,), jnp.int32).at[order].set(
        jnp.arange(N, dtype=jnp.int32))
    tile_keys = jnp.where(ok, tile_id, cfg.num_tiles).reshape(-1)
    rank_keys = jnp.tile(rank[:, None], (1, 9)).reshape(-1)
    vals = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[:, None, None],
                            tile_id.shape).reshape(-1)
    tile_of_key, _, vals = jax.lax.sort((tile_keys, rank_keys, vals),
                                        num_keys=2)
    starts = jnp.searchsorted(tile_of_key, jnp.arange(cfg.num_tiles),
                              side="left")
    ends = jnp.searchsorted(tile_of_key, jnp.arange(cfg.num_tiles),
                            side="right")
    idx = starts[:, None] + jnp.arange(cfg.k_per_tile)[None]
    valid = idx < ends[:, None]
    return (np.asarray(vals[jnp.clip(idx, 0, vals.shape[0] - 1)]),
            np.asarray(valid))


def _port(a, pose, intr, grad=False):
    t = {k: torch.from_numpy(v.copy()).requires_grad_(grad)
         for k, v in a.items()}
    out = render_gaussians(*(t[k] for k in NAMES), torch.from_numpy(pose),
                           torch.from_numpy(intr), CFG, bg_color=0.5)
    return t, out


def test_candidates_equal_reference():
    a, pose, intr = _scene()
    cand_j, valid_j = _jax_candidates(a, pose, intr)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    uv, depth, _, radius = project_gaussians(
        t["means"], t["scales"], t["quats"], torch.from_numpy(pose),
        torch.from_numpy(intr), CFG)
    live = (depth > CFG.near) & (t["opacities"] > CFG.opacity_thr)
    cand, valid = bin_gaussians(uv, depth, radius, live, CFG)
    assert valid_j.sum() > 300        # tiles do hold several candidates
    np.testing.assert_array_equal(valid.numpy(), valid_j)
    np.testing.assert_array_equal(cand.numpy(), cand_j)


def test_render_and_gradients_match_reference():
    a, pose, intr = _scene()
    wr, wa, wd = _pixel_weights()

    def jloss(*attrs):
        out = JG.render_gaussians(*attrs, jnp.asarray(pose),
                                  jnp.asarray(intr), J_CFG, bg_color=0.5)
        return (jnp.sum(out["rgb"] * wr) + jnp.sum(out["alpha"] * wa)
                + jnp.sum(out["depth"] * wd)), out

    jattrs = tuple(jnp.asarray(a[k]) for k in NAMES)
    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(*jattrs)

    t, out = _port(a, pose, intr, grad=True)
    for k in ("rgb", "alpha", "depth"):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(jout[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    assert float(out["alpha"].max()) > 0.5
    loss = ((out["rgb"] * torch.from_numpy(wr)).sum()
            + (out["alpha"] * torch.from_numpy(wa)).sum()
            + (out["depth"] * torch.from_numpy(wd)).sum())
    loss.backward()
    for k, jg in zip(NAMES, jgrads):
        jg = np.asarray(jg)
        assert np.abs(jg).max() > 0, k
        np.testing.assert_allclose(t[k].grad.numpy(), jg, rtol=0,
                                   atol=1e-4 * np.abs(jg).max(), err_msg=k)


def test_one_seed_gives_the_same_bits_twice():
    a, pose, intr = _scene(seed=3)
    runs = []
    for _ in range(2):
        t, out = _port(a, pose, intr, grad=True)
        (out["rgb"].sum() + out["depth"].sum()).backward()
        runs.append([out["rgb"].detach(), out["alpha"].detach()]
                    + [t[k].grad for k in NAMES])
    for x, y in zip(*runs):
        assert torch.equal(x, y)


def test_backward_is_one_segment_sum(monkeypatch):
    import mvedit_tpu_torch.ops.segment as seg
    calls = []
    real = seg.segment_sum

    def counted(idx, vals, rows, **kw):
        calls.append((tuple(idx.shape), tuple(vals.shape), rows))
        return real(idx, vals, rows, **kw)
    monkeypatch.setattr(seg, "segment_sum", counted)
    a, pose, intr = _scene()
    t, out = _port(a, pose, intr, grad=True)
    out["rgb"].sum().backward()
    n_tiles = CFG.num_tiles * CFG.k_per_tile
    assert calls == [((n_tiles,), (n_tiles, 10), 300)]


def _cam():
    pose = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(
        np.float32)
    return torch.from_numpy(pose), torch.tensor([64.0, 64.0, 32.0, 32.0])


def test_single_gaussian_renders_centered_blob():
    pose, intr = _cam()
    out = render_gaussians(
        torch.tensor([[0.0, 0.0, 2.0]]), torch.tensor([[0.1, 0.1, 0.1]]),
        torch.tensor([[1.0, 0.0, 0.0, 0.0]]), torch.tensor([[1.0, 0.0, 0.0]]),
        torch.tensor([0.9]), pose, intr, CFG, bg_color=0.0)
    rgb, alpha = out["rgb"].numpy(), out["alpha"].numpy()
    assert alpha[32, 32] > 0.5 and alpha[2, 2] < 0.01
    assert rgb[32, 32, 0] > rgb[32, 32, 1]
    assert abs(float(out["depth"][32, 32]) / max(alpha[32, 32], 1e-6)
               - 2.0) < 0.1


def test_gaussian_occlusion_front_to_back():
    pose, intr = _cam()
    out = render_gaussians(
        torch.tensor([[0.0, 0.0, 3.0], [0.0, 0.0, 1.5]]),
        torch.full((2, 3), 0.15), torch.tensor([[1.0, 0, 0, 0]] * 2),
        torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]]),
        torch.tensor([0.99, 0.99]), pose, intr, CFG, bg_color=0.0)
    rgb = out["rgb"].numpy()
    assert rgb[32, 32, 0] > rgb[32, 32, 1] * 2


def test_gaussian_grads_flow():
    pose, intr = _cam()
    means = torch.tensor([[0.0, 0.0, 2.0]], requires_grad=True)
    out = render_gaussians(
        means, torch.full((1, 3), 0.1), torch.tensor([[1.0, 0, 0, 0]]),
        torch.tensor([[0.5, 0.5, 0.5]]), torch.tensor([0.9]), pose, intr,
        CFG)
    (out["alpha"] * torch.arange(64.0)[None, :]).sum().backward()
    assert torch.isfinite(means.grad).all()
    assert abs(float(means.grad[0, 0])) > 1e-3


@pytest.mark.parametrize("size", [(60, 44), (64, 64)])
def test_ragged_frame_matches_reference(size):
    """A frame that is not a whole number of tiles is cropped as the
    reference crops it."""
    h, w = size
    a, pose, intr = _scene(n=120, seed=5)
    cfg = GSRasterConfig(height=h, width=w, tile=16, k_per_tile=32)
    jcfg = JG.GSRasterConfig(height=h, width=w, tile=16, k_per_tile=32,
                             tile_chunk=4)
    jout = JG.render_gaussians(*(jnp.asarray(a[k]) for k in NAMES),
                               jnp.asarray(pose), jnp.asarray(intr), jcfg)
    out = render_gaussians(*(torch.from_numpy(a[k]) for k in NAMES),
                           torch.from_numpy(pose), torch.from_numpy(intr),
                           cfg)
    for k in ("rgb", "alpha", "depth"):
        assert out[k].shape == jout[k].shape
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
