"""The perception nets of image-to-3D in the port against the JAX package,
on the CPU in f32:

- TRACER: the full B7 net at 64^2 through `tracer_segment` (JAX eager, no
  `jit`, to keep the compile out): masks within 1e-4; and the failure
  rule and erosion on fixed maps;
- the tiny DPT the runners build (2 ViT layers, ResNet stages (1, 1, 1))
  through `predict_normals`: normals within 1e-4;
- the tiny LoFTR (one coarse layer pair) at the runner's 32^2: `conf`
  within 1e-5 and the same match ids, in the same order, ties included
  (most rows' best is 0, and `jax.lax.top_k` keeps equal values in index
  order);
- `elev_estimation` on fixed matches: the elevation within 1e-6 rad; and
  `estimate_input_pose` end to end.

Weights are seeded (the BatchNorm statistics too; the shapes from
`jax.eval_shape` of the flax init), sent through the bridge
(`tracer_state_from_flax`, `dpt_state_from_flax`,
`loftr_state_from_flax`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.apis import Adapter3DRunner as JRunner
from mvedit_tpu.models.segmentors import TracerDecoder as JTracer
from mvedit_tpu.models.segmentors import tracer_segment as j_segment
from mvedit_tpu.models.segmentors.loftr import match_images as j_match
from mvedit_tpu.utils.pose_estimation import elev_estimation as j_elev

from mvedit_tpu_torch.apis import Adapter3DRunner as TRunner
from mvedit_tpu_torch.models.diffusion.weights import (
    dpt_state_from_flax, loftr_state_from_flax, tracer_state_from_flax)
from mvedit_tpu_torch.models.segmentors import (TracerDecoder,
                                                match_images, tracer_segment)
from mvedit_tpu_torch.utils.pose_estimation import elev_estimation

torch.set_num_threads(4)


def _seeded_params(module, seed, *inputs, scale=0.05):
    """Seeded params of a flax module without running its init (the
    shapes from `jax.eval_shape`; an eager init of B7 takes a minute):
    kernels N(0, 1 / fan_in), scales and variances near 1, the rest small
    noise."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.RandomState(seed)

    def f(path, sd):
        name = getattr(path[-1], "key", None)
        n = rng.standard_normal(sd.shape).astype(np.float32)
        if name == "kernel":
            out = n / np.sqrt(np.prod(sd.shape[:-1]))
        elif name in ("scale", "var"):
            out = 1.0 + scale * np.abs(n)
        else:
            out = scale * n
        return out.astype(np.float32)
    return jax.tree_util.tree_map_with_path(f, shapes)


def _load(net, state):
    missing, unexpected = net.load_state_dict(state, strict=False)
    assert not unexpected, unexpected
    return missing


@pytest.fixture(scope="module")
def tracer_pair():
    dec = JTracer()
    params = _seeded_params(dec, 1, jnp.zeros((1, 64, 64, 3)))
    net = TracerDecoder().eval()
    missing = _load(net, tracer_state_from_flax(params["params"]))
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    return dec, params, net


def test_tracer_segment_matches_jax(tracer_pair):
    """The net's map and `tracer_segment`'s masks (the net's output taken
    on the way, since seeded weights may trip the failure rule)."""
    dec, params, net = tracer_pair
    img = np.random.default_rng(0).random((2, 48, 48, 3)).astype(np.float32)
    raw_j, raw_t = [], []

    def j_apply(p, x):
        raw_j.append(np.asarray(dec.apply(p, x)))
        return raw_j[-1]

    def t_net(x):
        raw_t.append(net(x))
        return raw_t[-1]
    ref = np.asarray(j_segment(j_apply, params, jnp.asarray(img),
                               input_size=64))
    with torch.no_grad():
        out = tracer_segment(t_net, torch.from_numpy(img), input_size=64,
                             chunk=1).numpy()
    raw_t = torch.cat(raw_t).numpy()
    assert raw_t.shape == raw_j[0].shape == (2, 64, 64, 1)
    assert raw_j[0].std() > 1e-3
    np.testing.assert_allclose(raw_t, raw_j[0], atol=1e-4, rtol=0)
    assert out.shape == ref.shape == (2, 48, 48, 1)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("level", [0.5, 0.9])
def test_tracer_failure_rule_and_erosion(level):
    """A map above 0.2 everywhere is a failure: below 0.8 goes to 0."""
    rng = np.random.default_rng(1)
    maps = (level + 0.09 * rng.random((2, 16, 16, 1))).astype(np.float32)
    maps[1, 4:8, 4:8] = 0.1            # not a failure: eroded, kept

    def j_net(p, x):
        return jnp.asarray(maps)
    ref = np.asarray(j_segment(j_net, None, jnp.ones((2, 24, 24, 3)),
                               input_size=16))
    out = tracer_segment(lambda x: torch.from_numpy(maps),
                         torch.ones((2, 24, 24, 3)), input_size=16).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    assert (out[0] == 0).all() == (level < 0.8)


@pytest.fixture(scope="module")
def runners():
    jr = JRunner(tiny_models=True, seed=0)
    tr = TRunner(tiny_models=True, seed=0, device="cpu")
    return jr, tr


def test_predict_normals_matches_jax(runners):
    from mvedit_tpu.models.segmentors.dpt import DPTNormalModel
    jr, tr = runners
    net_j = DPTNormalModel(vit_layers=2, readout_taps=(0, 1),
                           resnet_layers=(1, 1, 1))
    params = _seeded_params(net_j, 2, jnp.zeros((1, 32, 32, 3)), scale=0.02)
    jr._cache["dpt"] = (net_j, params, 32)
    net_t, s_t = tr.load_normal_model()
    assert s_t == 32
    missing = _load(net_t, dpt_state_from_flax(params["params"]))
    assert sorted(missing) == sorted(
        ["pretrained.model.norm.weight", "pretrained.model.norm.bias"]
        + [f"scratch.refinenet4.resConfUnit1.conv{i}.{w}"
           for i in (1, 2) for w in ("weight", "bias")])
    img = np.random.default_rng(3).random((2, 48, 48, 3)).astype(np.float32)
    ref = np.asarray(jr.predict_normals(jnp.asarray(img)))
    out = tr.predict_normals(img).numpy()
    assert out.shape == ref.shape == (2, 48, 48, 3)
    assert 0.01 < ref.std() and 0 < ref.mean() < 1
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def _loftr_pair(runners):
    """The tiny LoFTR of both runners, with one set of seeded weights."""
    from mvedit_tpu.models.segmentors.loftr import LoFTR as JLoFTR
    jr, tr = runners
    if "loftr" not in jr._cache:
        net_j = JLoFTR(layers=1)
        z = jnp.zeros((1, 32, 32, 1))
        params = _seeded_params(net_j, 4, z, z, scale=0.02)
        jr._cache["loftr"] = (net_j, params)
        _load(tr.load_matcher(), loftr_state_from_flax(params["params"]))
    net_j, params = jr._cache["loftr"]
    return net_j, params, tr.load_matcher()


@pytest.mark.parametrize("shift", [0, 8])
def test_loftr_matches_jax(runners, shift, size=32):
    net_j, params, net_t = _loftr_pair(runners)
    rng = np.random.default_rng(size + shift)
    a = rng.random((1, size + shift, size, 1)).astype(np.float32)
    img0, img1 = a[:, :size], a[:, shift:shift + size]
    jo = net_j.apply(params, jnp.asarray(img0), jnp.asarray(img1))
    with torch.no_grad():
        to = net_t(torch.from_numpy(img0), torch.from_numpy(img1))
    n = (size // 8) ** 2
    assert to["conf"].shape == (n,)
    np.testing.assert_allclose(to["conf"].numpy(), np.asarray(jo["conf"]),
                               atol=1e-5, rtol=0)
    # every row's id in the same order: the rows with no match (conf 0)
    # tie, and both keep them in index order
    assert (np.asarray(jo["conf"]) == 0).sum() > 1
    np.testing.assert_array_equal(to["pts0"].numpy(), np.asarray(jo["pts0"]))
    pj0, pj1, cj = j_match(lambda p, x, y: net_j.apply(p, x, y), params,
                           jnp.asarray(img0), jnp.asarray(img1))
    pt0, pt1, ct = match_images(net_t, torch.from_numpy(img0),
                                torch.from_numpy(img1))
    np.testing.assert_array_equal(pt0, pj0)
    np.testing.assert_allclose(pt1, pj1, atol=1e-4)
    np.testing.assert_allclose(ct, cj, atol=1e-5)


def _fixed_matches():
    from mvedit_tpu_torch.utils.camera import (get_pose_from_angles,
                                               intrinsics_from_fov)
    rng = np.random.default_rng(0)
    in_pose = get_pose_from_angles(np.array([0.0]), np.array([0.3]),
                                   2.5)[0]
    intr = intrinsics_from_fov(40.0, 256, 256)
    pts3d = rng.normal(size=(64, 3)) * 0.4

    def project(pose, pts):
        pc = (pts - pose[:3, 3]) @ pose[:3, :3]
        return pc[:, :2] / pc[:, 2:3] * intr[:2] + intr[2:]
    matches, ref_poses = [], []
    for azi in (0.8, 2.0, 4.0):
        pose = get_pose_from_angles(np.array([azi]), np.array([0.1]),
                                    2.5)[0]
        noise = rng.normal(size=(64, 2)) * 0.5
        matches.append((project(in_pose, pts3d) + noise,
                        project(pose, pts3d), rng.random(64)))
        ref_poses.append(pose)
    return matches, np.stack(ref_poses), intr


def test_elev_estimation_matches_jax():
    matches, ref_poses, intr = _fixed_matches()
    ej, pj = j_elev(matches, ref_poses, intr)
    et, pt = elev_estimation(matches, ref_poses, intr)
    assert abs(et - ej) <= 1e-6
    assert abs(et - 0.3) < 0.05
    np.testing.assert_allclose(pt, pj, atol=1e-6)


def test_estimate_input_pose_matches_jax(runners):
    """Matches of the input against two views at 32^2, then the solve (or
    the "< 8 matches" route to None, in both)."""
    jr, tr = runners
    _loftr_pair(runners)
    from mvedit_tpu_torch.apis import cameras as C
    poses44, fov, _ = C.zero123plus_v11_rig()
    rng = np.random.default_rng(5)
    image = rng.random((40, 40, 3)).astype(np.float32)
    views = [image, np.ascontiguousarray(image[::-1])]
    pj, ej = jr.estimate_input_pose(image, views, poses44[:2], fov)
    pt, et = tr.estimate_input_pose(image, views, poses44[:2], fov)
    assert (pj is None) == (pt is None)
    if pj is not None:
        assert abs(et - ej) <= 1e-4
        np.testing.assert_allclose(pt, pj, atol=1e-4)
