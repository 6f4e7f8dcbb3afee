"""The port's image ops, ray geometry and camera pruning against the JAX
package's, on the CPU in fp32, on seeded numpy inputs.

Tolerance 1e-5 (absolute, on values of order 1) for every op, forward and,
where the NeRF fit differentiates through it (`depth_to_normal`,
`highpass`), gradient: f32 arithmetic in another order. `resize_bilinear`
is pinned against `jax.image.resize(..., "bilinear")`, whose triangle
filter widens by the shrink factor (antialias) when it shrinks.
`prune_cameras` keeps the same ids. `fill_holes` (a fixed point of
min-pools and maxima, exact in f32) and `get_cam_rays` within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.apis.cameras import surround_rig
from mvedit_tpu.utils import camera as JC
from mvedit_tpu.ops import image as JI
from mvedit_tpu.ops import rotation as JR
from mvedit_tpu.utils import geometry as JG

from mvedit_tpu_torch.ops import image as TI
from mvedit_tpu_torch.ops import rotation as TR
from mvedit_tpu_torch.utils import geometry as TG

torch.set_num_threads(2)
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(out, ref, tol=TOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    np.testing.assert_allclose(out, np.asarray(ref), rtol=tol, atol=tol)


def test_blur_highpass_erode_match_jax():
    rng = np.random.default_rng(0)
    img = rng.random((2, 3, 20, 17)).astype(np.float32)
    _close(TI.gaussian_kernel1d(1.5), JI.gaussian_kernel1d(1.5))
    _close(TI.gaussian_blur(_t(img), 1.5), JI.gaussian_blur(img, 1.5))
    _close(TI.highpass(_t(img)), JI.highpass(img))
    mask = (rng.random((2, 20, 17)) > 0.3).astype(np.float32)
    _close(TI.erode(_t(mask), 3), JI.erode(mask, 3))
    # the gradient of a weighted highpass, as the LPIPS normal loss takes it
    w = rng.random(img.shape).astype(np.float32)
    g_j = jax.grad(lambda x: jnp.sum(JI.highpass(x) * w))(jnp.asarray(img))
    x = _t(img).requires_grad_(True)
    (TI.highpass(x) * _t(w)).sum().backward()
    _close(x.grad, g_j)


@pytest.mark.parametrize("shape", [(8, 8), (16, 16), (12, 20), (64, 64),
                                   (40, 24)])
def test_resize_bilinear_matches_jax_image_resize(shape):
    """Shrinking 32^2 by 4 and 2 (the targets at 128^2 and 256^2 of a
    512^2 request), unequal and upsampling factors."""
    rng = np.random.default_rng(1)
    img = rng.random((3, 32, 32, 3)).astype(np.float32)
    ref = jax.image.resize(img, (3, *shape, 3), "bilinear")
    _close(TI.resize_bilinear(_t(img), shape), ref)
    _close(TI.resize_bilinear(_t(img), shape),
           JI.resize_bilinear(img, shape))


def test_edge_dilation_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.random((24, 24, 3)).astype(np.float32)
    mask = np.zeros((24, 24), np.float32)
    mask[5:9, 3:14] = 1.0
    mask[15:20, 16:22] = 1.0
    for n in (1, 4, 16):
        _close(TI.edge_dilation(_t(img), _t(mask), n_iters=n),
               JI.edge_dilation(img, mask, n_iters=n))


def test_rays_and_depth_to_normal_match_jax():
    rng = np.random.default_rng(3)
    poses, intr = surround_rig(3, 2.5, 40, -0.2, 0.5, 24, rng=rng)
    poses = poses.astype(np.float32)
    intr = intr.astype(np.float32)
    for norm in (False, True):
        _close(TG.get_ray_directions(20, 24, _t(intr), norm=norm),
               JG.get_ray_directions(20, 24, intr, norm=norm))
    dirs = np.asarray(JG.get_ray_directions(20, 24, intr))
    for norm in (False, True):
        for a, b in zip(TG.get_rays(_t(dirs), _t(poses), norm=norm),
                        JG.get_rays(jnp.asarray(dirs), jnp.asarray(poses),
                                    norm=norm)):
            _close(a, b)
    inv_z = (0.4 + 0.1 * rng.random((3, 20, 24))).astype(np.float32)
    w = rng.random((3, 20, 24, 3)).astype(np.float32)
    for fmt in ("opengl", "opencv"):
        _close(TG.depth_to_normal(_t(inv_z), _t(dirs), fmt),
               JG.depth_to_normal(inv_z, dirs, fmt))
    g_j = jax.grad(lambda d: jnp.sum(JG.depth_to_normal(d, dirs) * w))(
        jnp.asarray(inv_z))
    d = _t(inv_z).requires_grad_(True)
    (TG.depth_to_normal(d, _t(dirs)) * _t(w)).sum().backward()
    _close(d.grad, g_j, 1e-4 * float(np.abs(g_j).max()))


def _basin():
    # `tests/test_ops.py::test_fill_holes`'s image: a dark basin inside a
    # bright ring whose lowest pass is 0.7
    img = np.zeros((16, 16), np.float32)
    img[4:13, 4:13] = 1.0
    img[6:11, 6:11] = 0.2
    img[8, 4:6] = 0.7
    return img


@pytest.mark.parametrize("max_iters", [None, 3])
@pytest.mark.parametrize("case", ["basin", "random"])
def test_fill_holes_matches_jax(case, max_iters):
    """Equal to JAX's `fill_holes`, cut short by `max_iters` too, and
    idempotent."""
    img = _basin() if case == "basin" else \
        np.random.default_rng(5).random((64, 96)).astype(np.float32)
    out = TI.fill_holes(_t(img), max_iters=max_iters)
    _close(out, JI.fill_holes(jnp.asarray(img), max_iters=max_iters), 1e-6)
    if max_iters is None:
        _close(TI.fill_holes(out), out, 1e-6)
    if case == "basin" and max_iters is None:
        _close(out[6:11, 6:11], np.full((5, 5), 0.7, np.float32), 1e-6)
        _close(out[img == 0.0], np.zeros(int((img == 0).sum())), 1e-6)
    if case == "random":
        assert (out > _t(img)).any()    # it filled something


def test_get_cam_rays_matches_jax():
    """`tests/test_camera_geometry.py::test_get_rays_world`'s call, and a
    seeded rig of 3 views at 20 x 24."""
    intr = np.array([100.0, 100.0, 16.0, 16.0], np.float32)
    pose = JC.get_pose_from_angles(np.array([0.0]), np.array([0.0]), 2.0)
    c2w = pose[:, :3, :].astype(np.float32)
    for a, b in zip(TG.get_cam_rays(_t(c2w), _t(intr), 32, 32),
                    JG.get_cam_rays(jnp.asarray(c2w), jnp.asarray(intr),
                                    32, 32)):
        assert a.shape == (1, 32, 32, 3)
        _close(a, b, 1e-6)
    poses, intr = surround_rig(3, 2.5, 40, -0.2, 0.5, 24,
                               rng=np.random.default_rng(6))
    poses, intr = poses[:, :3].astype(np.float32), intr.astype(np.float32)
    for a, b in zip(TG.get_cam_rays(_t(poses), _t(intr), 20, 24),
                    JG.get_cam_rays(jnp.asarray(poses), jnp.asarray(intr),
                                    20, 24)):
        _close(a, b, 1e-6)


def test_prune_cameras_matches_jax():
    rng = np.random.default_rng(4)
    poses, _ = surround_rig(32, 2.5, 40, -0.2, 0.5, 64, rng=rng)
    np.testing.assert_allclose(TR.matrix_to_quaternion(poses[:, :3, :3]),
                               JR.matrix_to_quaternion(poses[:, :3, :3]),
                               atol=1e-6)
    np.testing.assert_allclose(TR.get_camera_dists(poses),
                               JR.get_camera_dists(poses), atol=1e-6)
    bonus = rng.random((32, 32)) * 0.1
    for keep, n, b in (([], 16, None), ([0, 3], 9, None), ([], 9, bonus)):
        np.testing.assert_array_equal(
            TR.prune_cameras(poses, keep, n, pixel_dist_bonus=b),
            JR.prune_cameras(poses, keep, n, pixel_dist_bonus=b))
