"""The viewers (`apis/viewer.py`), port against the JAX package on the CPU:
the JAX package's headless GUI actions (`tests/test_cli.py::
test_viewers_headless`) on the port's `SSDNeRFViewer` and `MeshViewer`;
`export_mesh` at 16 (faces equal, vertices within 1e-5), `export_vdb` at
16 (equal bytes, the uuid patched), and a `MeshViewer` frame at 32^2 of a
torus with per-vertex UVs and an albedo (equal coverage, max |d| <= 1e-4).
"""
import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.apis.viewer import MeshViewer as JMeshViewer
from mvedit_tpu.apis.viewer import SSDNeRFViewer as JSSDNeRFViewer
from mvedit_tpu.models.mesh import Mesh as JMesh
from mvedit_tpu.utils.camera import intrinsics_from_fov as j_intrinsics

from mvedit_tpu_torch.apis.viewer import MeshViewer, SSDNeRFViewer
from mvedit_tpu_torch.models.mesh import Mesh
from mvedit_tpu_torch.utils.camera import intrinsics_from_fov

SIZE = 16


def _sample_fn(prompt, negp, seed, steps, cfg_scale):
    code = np.full((4,), float(seed), np.float32)

    def render_fn(pose, intrinsics):
        return np.full((SIZE, SIZE, 3), 0.25, np.float32)
    return code, render_fn


def _density(xyz):
    return 20.0 * (0.5 - torch.linalg.norm(xyz, dim=-1))


def _j_density(xyz):
    return 20.0 * (0.5 - jnp.linalg.norm(xyz, axis=-1))


def _viewers():
    intr = intrinsics_from_fov(40.0, SIZE, SIZE)
    np.testing.assert_array_equal(intr, j_intrinsics(40.0, SIZE, SIZE))
    return (SSDNeRFViewer(_sample_fn, intr, density_fn=_density,
                          device="cpu"),
            JSSDNeRFViewer(_sample_fn, intr, density_fn=_j_density))


def test_viewers_headless(tmp_path):
    """The JAX package's headless actions, on the port."""
    v, _ = _viewers()
    v.generate("a car", seed=3, steps=2)
    assert v.code is not None
    img = v.export_screenshot(str(tmp_path / "s.png"))
    assert img.shape == (SIZE, SIZE, 3)
    v.export_multi_view(str(tmp_path / "mv_{}.png"), num_views=2)
    assert (tmp_path / "mv_1.png").exists()
    v.save_scene(str(tmp_path / "scene.npz"))
    v2 = SSDNeRFViewer(_sample_fn, v.intrinsics, device="cpu")
    code = v2.load_scene(str(tmp_path / "scene.npz"),
                         lambda c: lambda pose, i: np.zeros((8, 8, 3)))
    np.testing.assert_allclose(code, v.code)
    path = v.export_video(str(tmp_path / "turn.gif"), num_frames=3)
    assert path.endswith(".gif")
    mesh = v.export_mesh(str(tmp_path / "m.glb"), resolution=16,
                         threshold=1.0)
    assert len(mesh.f) > 0
    frame = MeshViewer(mesh, render_size=32, device="cpu").frame(0.3)
    assert frame.shape == (32, 32, 3)
    assert np.isfinite(frame).all()
    with pytest.raises(ImportError, match="dearpygui"):
        v.run_gui()


def test_export_mesh_equals_jax(tmp_path):
    v, jv = _viewers()
    m = v.export_mesh(str(tmp_path / "port.glb"), resolution=16,
                      threshold=1.0)
    jm = jv.export_mesh(str(tmp_path / "jax.glb"), resolution=16,
                        threshold=1.0)
    assert len(m.f) > 0
    np.testing.assert_array_equal(m.f, jm.f)
    np.testing.assert_allclose(m.v, jm.v, atol=1e-5)
    np.testing.assert_allclose(Mesh.load(str(tmp_path / "port.glb")).v,
                               m.v, atol=1e-6)


def test_export_vdb_equals_jax(tmp_path, monkeypatch):
    fixed = uuid.UUID("0f1e2d3c-4b5a-6978-8796-a5b4c3d2e1f0")
    monkeypatch.setattr(uuid, "uuid4", lambda: fixed)
    v, jv = _viewers()
    sigma = v.export_vdb(str(tmp_path / "port.vdb"), resolution=16)
    jsigma = jv.export_vdb(str(tmp_path / "jax.vdb"), resolution=16)
    np.testing.assert_allclose(sigma, np.asarray(jsigma), atol=1e-5)
    data = (tmp_path / "port.vdb").read_bytes()
    assert data == (tmp_path / "jax.vdb").read_bytes() and len(data) > 1000


def _torus(nu=24, nv=8, R=0.6, r=0.25):
    u, v = np.meshgrid(np.linspace(0, 2 * np.pi, nu, endpoint=False),
                       np.linspace(0, 2 * np.pi, nv, endpoint=False),
                       indexing="ij")
    verts = np.stack([(R + r * np.cos(v)) * np.cos(u),
                      (R + r * np.cos(v)) * np.sin(u),
                      r * np.sin(v)], -1).reshape(-1, 3).astype(np.float32)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a, b = i * nv + j, ((i + 1) % nu) * nv + j
    c, d = ((i + 1) % nu) * nv + (j + 1) % nv, i * nv + (j + 1) % nv
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    vt = np.stack([u.reshape(-1), v.reshape(-1)], -1).astype(
        np.float32) / (2 * np.pi)
    albedo = np.random.default_rng(0).random((16, 16, 3)).astype(np.float32)
    return verts, faces.astype(np.int32), vt, albedo


@pytest.mark.parametrize("textured", [True, False])
def test_mesh_viewer_frame_equals_jax(textured):
    verts, faces, vt, albedo = _torus()
    kw = dict(v=verts, f=faces, vt=vt, ft=faces, albedo=albedo) \
        if textured else dict(v=verts, f=faces)
    frame = MeshViewer(Mesh(**kw), render_size=32, device="cpu").frame(
        0.3, elev=0.4)
    ref = JMeshViewer(JMesh(**kw), render_size=32).frame(0.3, elev=0.4)
    cover, jcover = (frame < 1).any(-1), (ref < 1).any(-1)
    assert cover.sum() > 100
    np.testing.assert_array_equal(cover, jcover)
    assert np.abs(frame - ref).max() <= 1e-4
