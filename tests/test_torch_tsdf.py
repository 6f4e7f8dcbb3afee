"""TSDF fusion and marching cubes in the port against the JAX package's,
on the CPU:

- `tsdf_integrate` on the reference test's analytic sphere
  (`tests/test_mesh.py::test_tsdf_rgbd_to_mesh_sphere`: 8 views of 64^2,
  G 64): the tsdf, weight and colour grids equal bit for bit outside the
  voxels whose projection lands the other way of a rounding tie or an
  observation threshold in the two frameworks' f32 products; those are
  counted and must stay within 0.1% of the observed voxels;
- `tsdf_to_mesh` on one grid in both packages, decimation off and on:
  equal vertices, faces and colours;
- a failing `decimate_qem` raises in the port (the reference swallows the
  error and keeps the full mesh: pinned too);
- `marching_cubes` and `extract_geometry` on a sphere density: equal
  faces, vertices within 1e-6;
- `tsdf_rgbd_to_mesh` end to end on the sphere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvedit_tpu.native as JNative
from mvedit_tpu.apis.cameras import surround_rig
from mvedit_tpu.models.mesh import tsdf as JT
from mvedit_tpu.ops import marching_cubes as JMC

import mvedit_tpu_torch.models.mesh.tsdf as TT
from mvedit_tpu_torch.models.mesh import (tsdf_integrate, tsdf_rgbd_to_mesh,
                                          tsdf_to_mesh)
from mvedit_tpu_torch.native import native_available
from mvedit_tpu_torch.ops.marching_cubes import (extract_geometry,
                                                 marching_cubes)

R = 0.5
COL = np.array([0.8, 0.3, 0.2], np.float32)


def _sphere_views(N=8, hw=64):
    """The reference test's analytic sphere renders."""
    poses, intr = surround_rig(N, 2.0, 40, -0.6, 0.6, hw,
                               rng=np.random.default_rng(0))
    c2w = np.concatenate([poses, np.tile([[[0, 0, 0, 1.0]]], (N, 1, 1))], 1)
    w2cs = np.linalg.inv(c2w)
    depths = np.zeros((N, hw, hw), np.float32)
    rgbs = np.zeros((N, hw, hw, 3), np.float32)
    u, v = np.meshgrid(np.arange(hw) + 0.5, np.arange(hw) + 0.5,
                       indexing="xy")
    for i in range(N):
        fx, fy, cx, cy = intr[i]
        d = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)
        c = w2cs[i, :3, 3]
        a = np.sum(d * d, -1)
        b = -2 * np.sum(d * c, -1)
        cc = np.sum(c * c) - R * R
        disc = b * b - 4 * a * cc
        hit = disc > 0
        t = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
        depths[i] = np.where(hit & (t > 0), t, 0).astype(np.float32)
        rgbs[i] = np.where(hit[..., None], COL, 0)
    return rgbs, depths, c2w.astype(np.float32), w2cs.astype(np.float32), \
        intr.astype(np.float32)


@pytest.fixture(scope="module")
def fused():
    rgbs, depths, c2w, w2cs, intr = _sphere_views()
    jout = JT.tsdf_integrate(rgbs, depths, w2cs, intr, bound=1.0,
                             resolution=64, z_chunk=16)
    tout = tsdf_integrate(*(torch.from_numpy(x) for x in
                            (rgbs, depths, w2cs, intr)),
                          bound=1.0, resolution=64)
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.numpy() for k, v in tout.items()},
            (rgbs, depths, c2w, intr))


def test_integrate_matches_reference(fused):
    j, t, _ = fused
    for k in j:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
    differ = ((t["tsdf"] != j["tsdf"]) | (t["weight"] != j["weight"])
              | (t["color"] != j["color"]).any(-1))
    observed = int((j["weight"] > 0).sum())
    assert observed > 10000
    assert int(differ.sum()) <= 0.001 * observed, (int(differ.sum()),
                                                   observed)
    # a differing voxel differs by whole observations, not by rounding
    dw = np.abs(t["weight"] - j["weight"])[differ]
    assert ((dw == 0) | (dw >= 1)).all()


def test_z_chunk_does_not_change_the_grid(fused):
    _, t, (rgbs, depths, c2w, intr) = fused
    w2cs = np.linalg.inv(c2w).astype(np.float32)
    t16 = tsdf_integrate(*(torch.from_numpy(x) for x in
                           (rgbs, depths, w2cs, intr)),
                         bound=1.0, resolution=64, z_chunk=16)
    for k in t:
        np.testing.assert_array_equal(t16[k].numpy(), t[k])


@pytest.mark.parametrize("reduction", [0.0, 0.2])
def test_to_mesh_matches_reference(fused, reduction):
    j, _, _ = fused
    assert native_available() and JNative.native_available()
    jm = JT.tsdf_to_mesh(j["tsdf"], j["weight"], j["color"], bound=1.0,
                         prune_thr=10, mesh_reduction=reduction)
    tm = tsdf_to_mesh(torch.from_numpy(j["tsdf"].copy()), j["weight"],
                      j["color"],
                      bound=1.0, prune_thr=10, mesh_reduction=reduction)
    assert len(tm.f) > 100
    np.testing.assert_array_equal(tm.f, jm.f)
    np.testing.assert_array_equal(tm.v, jm.v)
    np.testing.assert_array_equal(tm.vc, jm.vc)
    np.testing.assert_array_equal(tm.vn, jm.vn)
    rad = np.linalg.norm(tm.v, axis=-1)
    assert abs(np.median(rad) - R) < 0.07


def test_failing_decimation_raises(fused, monkeypatch):
    j, _, _ = fused

    def broken(*a, **k):
        raise RuntimeError("decimation failed")
    monkeypatch.setattr(TT, "decimate_qem", broken)
    with pytest.raises(RuntimeError, match="decimation failed"):
        tsdf_to_mesh(j["tsdf"], j["weight"], j["color"], prune_thr=10,
                     mesh_reduction=0.2)
    # the reference swallows it and keeps the full-resolution mesh
    monkeypatch.setattr(JNative, "decimate_qem", broken)
    jm = JT.tsdf_to_mesh(j["tsdf"], j["weight"], j["color"], prune_thr=10,
                         mesh_reduction=0.2)
    full = JT.tsdf_to_mesh(j["tsdf"], j["weight"], j["color"], prune_thr=10,
                           mesh_reduction=0.0)
    assert len(jm.f) == len(full.f)


def test_prune_everything_gives_an_empty_mesh(fused):
    j, _, _ = fused
    m = tsdf_to_mesh(j["tsdf"], j["weight"], j["color"], prune_thr=10 ** 6,
                     mesh_reduction=0.0)
    assert len(m.f) == 0


def test_rgbd_to_mesh_end_to_end(fused):
    _, _, (rgbs, depths, c2w, intr) = fused
    m = tsdf_rgbd_to_mesh(rgbs, depths, c2w, intr, voxel_resolution=64,
                          prune_thr=10, mesh_reduction=0.0, device="cpu")
    jm = JT.tsdf_rgbd_to_mesh(rgbs, depths, c2w, intr, voxel_resolution=64,
                              prune_thr=10, mesh_reduction=0.0)
    assert abs(len(m.f) - len(jm.f)) <= 0.01 * len(jm.f)
    assert abs(np.median(np.linalg.norm(m.v, axis=-1)) - R) < 0.07
    assert np.allclose(np.median(m.vc, axis=0), COL, atol=0.15)
    assert (np.sum(m.vn * m.v, -1) > 0).mean() > 0.95


def _sphere_density(x):
    return 20.0 * (0.6 - np.linalg.norm(x, axis=-1))


def test_marching_cubes_matches_reference():
    r = 24
    xs = np.linspace(-1, 1, r + 1, dtype=np.float32)
    pts = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    field = _sphere_density(pts).astype(np.float32)
    jv, jf, jvm, jfm = JMC.marching_cubes(jnp.asarray(field), iso=2.0,
                                          bound=1.5)
    tv, tf, tvm, tfm = marching_cubes(torch.from_numpy(field), iso=2.0,
                                      bound=1.5)
    np.testing.assert_array_equal(tfm.numpy(), np.asarray(jfm))
    np.testing.assert_array_equal(tvm.numpy(), np.asarray(jvm))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    m = np.asarray(jvm)
    np.testing.assert_allclose(tv.numpy()[m], np.asarray(jv)[m], rtol=0,
                               atol=1e-6)


def test_extract_geometry_matches_reference():
    jv, jf = JMC.extract_geometry(
        lambda p: jnp.asarray(_sphere_density(np.asarray(p))),
        resolution=32, threshold=10.0, bound=1.0, chunk=5000)
    tv, tf = extract_geometry(
        lambda p: torch.from_numpy(_sphere_density(p.numpy())),
        resolution=32, threshold=10.0, bound=1.0, chunk=5000, device="cpu")
    assert len(tf) > 100 and tf.dtype == np.int32
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    assert abs(np.median(np.linalg.norm(tv, axis=-1)) - 0.1) < 0.02
