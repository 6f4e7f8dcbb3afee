"""View and ray sharding of the port (`mvedit_tpu_torch.parallel`) over
gloo process groups on the CPU: the 2-rank cases in one group of 2
processes and the 1-rank cases in one group of 1, each spawned by
`torch_parallel_workers.run_ranks` with a time limit of its own:

- the sharded CFG denoise step at 2 ranks against the unsharded port and
  against the JAX package's `make_mesh(2)` step on the bridged tiny UNet,
  at the reference test's tolerances (atol 2e-4, rtol 1e-3); a view group
  split over both ranks (each gathers the group's K and V) against the
  whole group;
- the sharded NeRF step, a NeRF-fit chunk (also with rays that do not
  split evenly, which every rank renders whole: bit-equal) and the mesh
  fit at 2 ranks against the unsharded ones (the mesh fit at the reference test's
  tolerances: loss rtol 1e-4 / atol 1e-5, sdf rtol 1e-3 / atol 1e-5);
- `dryrun(2)`; the reference's `dryrun(1)`, which denoises no view
  (N = n // 2 = 0), and the port's, which does the same;
- at world size 1, the sharded denoise step, NeRF-fit chunk, mesh fit
  and tiny pipeline (renders, sdf, mesh and albedo) bit-equal to the
  unsharded ones; the step refusing a batch that splits view groups;
- the tiny pipeline (`dryrun_pipeline`) at 2 ranks against the unsharded
  request, at the reference test's atol 5e-2 on the renders;
- `make_mesh` refusing to run without a process group.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.models.diffusion import AttnMode as JAttnMode
from mvedit_tpu.parallel import dryrun as jax_dryrun
from mvedit_tpu.parallel.sharded import make_mesh as jax_make_mesh
from mvedit_tpu.parallel.sharded import \
    make_sharded_denoise_step as jax_denoise_step
from mvedit_tpu.testing import make_tiny_models as jax_tiny_models

import torch_parallel_workers as W
from mvedit_tpu_torch.models.diffusion.weights import torch_state_from_flax
from mvedit_tpu_torch.parallel import make_mesh


def _eq(a, b):
    if isinstance(a, (list, tuple)):
        return all(_eq(x, y) for x, y in zip(a, b)) and len(a) == len(b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_eq(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return torch.equal(a, b)


def _close(a, b, **tol):
    if isinstance(a, (list, tuple)):
        for x, y in zip(a, b):
            _close(x, y, **tol)
        return
    np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)


N_VIEWS, GS = 2, 7.5


def _denoise_inputs():
    rng = np.random.default_rng(1)
    lat = rng.normal(size=(2 * N_VIEWS, 8, 8, 4)).astype(np.float32)
    t = np.full((2 * N_VIEWS,), 500, np.int32)
    ctx = rng.normal(size=(2 * N_VIEWS, 8, 32)).astype(np.float32)
    return lat, t, ctx


def _rays(R=32):
    rng = np.random.default_rng(2)
    rays_o = np.tile(np.array([[0.0, 0.0, -2.0]], np.float32), (R, 1))
    rays_o[:, :2] += rng.uniform(-0.3, 0.3, (R, 2)).astype(np.float32)
    rays_d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (R, 1))
    target = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    return rays_o, rays_d, target


@pytest.fixture(scope="module")
def jax_tiny():
    return jax_tiny_models(jax.random.PRNGKey(0), n_cn=0)


@pytest.fixture(scope="module")
def two_ranks(jax_tiny):
    """Every 2-rank case, run once in one gloo group of 2 processes."""
    state = torch_state_from_flax(jax_tiny.unet_params, "unet")
    return W.run_ranks(W.two_rank_cases, 2,
                       (state, *_denoise_inputs(), N_VIEWS, GS), _rays(),
                       (4, 2, 3), timeout=600)


@pytest.fixture(scope="module")
def one_rank():
    (r,) = W.run_ranks(W.one_rank_cases, 1, timeout=400)
    return r


def test_sharded_denoise_matches_unsharded_and_reference(jax_tiny,
                                                         two_ranks):
    lat, t, ctx = _denoise_inputs()
    jstep = jax_denoise_step(jax_tiny.unet, jax_make_mesh(2),
                             JAttnMode(num_views=N_VIEWS), GS)
    ref = np.asarray(jstep({"params": jax_tiny.unet_params},
                           jnp.asarray(lat), jnp.asarray(t),
                           jnp.asarray(ctx)))
    r0, r1 = (r["denoise"] for r in two_ranks)
    out = torch.cat([r0["step"], r1["step"]], 0)
    assert out.shape == (2 * N_VIEWS, 8, 8, 4)
    np.testing.assert_allclose(out.numpy(), r0["full"].numpy(), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=1e-3)
    # one view group over both ranks: each rank's queries against the
    # group's gathered keys and values
    for r in (r0, r1):
        np.testing.assert_allclose(r["group"].numpy(),
                                   r["group_full"].numpy(), atol=2e-4,
                                   rtol=1e-3)


def test_sharded_nerf_step_matches_unsharded(two_ranks):
    r0, r1 = (r["nerf_step"] for r in two_ranks)
    assert torch.equal(r0["loss"], r1["loss"])
    assert _eq(r0["params"], r1["params"])     # one Adam step on each rank
    _close(r0["loss"], r0["ref_loss"], rtol=1e-6, atol=1e-7)
    _close(r0["params"], r0["ref_params"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["nerf", "mesh", "nerf_uneven"])
def test_sharded_fit_matches_unsharded(two_ranks, kind):
    (sh0, ref), (sh1,) = (r["fits"][kind] for r in two_ranks)
    assert _eq(sh0, sh1)
    assert torch.isfinite(sh0["loss"]).all()
    if kind == "nerf_uneven":
        # every rank renders every ray; (g + g) / 2 is g
        assert _eq(sh0, ref)
    elif kind == "mesh":
        _close(sh0["loss"], ref["loss"], rtol=1e-4, atol=1e-5)
        _close(sh0["sdf"], ref["sdf"], rtol=1e-3, atol=1e-5)
        _close(sh0["deform"], ref["deform"], rtol=1e-3, atol=1e-5)
    else:
        _close(sh0["loss"], ref["loss"], rtol=1e-4, atol=1e-5)
        _close(sh0["params"], ref["params"], rtol=1e-3, atol=1e-5)


def test_dryrun_two_ranks(two_ranks):
    assert [r["dryrun"] for r in two_ranks] == [True, True]


def test_dryrun_at_one_rank_denoises_no_view(monkeypatch, one_rank):
    """The reference's dryrun(n) denoises N = n // 2 views: none at n = 1,
    and it still runs its NeRF and mesh steps. The port's does the same."""
    import mvedit_tpu.parallel.sharded as JS
    seen = []
    real = JS.make_sharded_denoise_step

    def spy(net, mesh, mode, guidance_scale=7.5):
        seen.append(mode.num_views)
        step = real(net, mesh, mode, guidance_scale)

        def wrapped(params, lat, t, ctx):
            seen.append(lat.shape)
            return step(params, lat, t, ctx)
        return wrapped
    monkeypatch.setattr(JS, "make_sharded_denoise_step", spy)
    jax_dryrun(1)
    assert seen == [0, (0, 8, 8, 4)]
    assert one_rank["dryrun"]


def test_one_rank_is_bit_equal_to_unsharded(one_rank):
    assert one_rank["refused"]
    for k in ("denoise", "nerf", "mesh", "pipeline"):
        sharded, plain = one_rank[k]
        assert _eq(sharded, plain), k


def test_sharded_pipeline_matches_unsharded(two_ranks):
    (sh0, ref), (sh1,) = (r["pipeline"] for r in two_ranks)
    assert _eq(sh0, sh1)
    a, b = sh0["rgb"].numpy(), ref["rgb"].numpy()
    assert a.shape == b.shape and np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=5e-2)


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(2)
