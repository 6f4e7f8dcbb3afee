"""Texture sampling and `run_mesh_to_video` in the port against the JAX
package, on the CPU in fp32.

- `grid_sample_2d` (bilinear; zeros and border padding; both
  `align_corners`), on a grid that reaches past [-1, 1]: within 4e-6 of
  the reference's gathers and lerps on N(0, 1) texels (a few float32
  ulps: without a gradient the port calls `F.grid_sample`, which forms
  the four weights another way and clamps the coordinate, not the index,
  at a border). With a gradient asked for it takes the reference's
  gathers and lerps (no atomic backward): the same values within 4e-6
  and a gradient that sums each sample's weights (1 inside the input).
- `build_mipmaps` within 1e-6; `_sample_level` and `sample_texture` (four
  levels, the level from `uv_screen_derivatives` of a uv map, both within
  1e-5 of the reference; a level's fraction comes from a log2 of the
  footprint, whose rounding moves the blend by ~1e-6).
- `run_mesh_to_video`, 3 frames at 64^2, of a sphere with per-vertex uvs
  and a 32^2 albedo (the albedo route) and without them (the normals
  route), the frames captured in both packages: within 1e-4 (measured
  1.0e-5: the edges' soft alpha and the bilinear samples through
  ulp-apart barycentrics); the port writes the GIF (no ffmpeg here) and
  returns its path.
"""
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvedit_tpu.utils.video as JV
from mvedit_tpu.apis import Adapter3DRunner as JRunner
from mvedit_tpu.models.mesh import texture as JT
from mvedit_tpu.ops.grid_sample import grid_sample_2d as j_gs

import mvedit_tpu_torch.utils.video as TV
from mvedit_tpu_torch.apis import Adapter3DRunner as TRunner
from mvedit_tpu_torch.models.mesh import Mesh
from mvedit_tpu_torch.models.mesh import texture as TT
from mvedit_tpu_torch.ops.grid_sample import grid_sample_2d as t_gs

torch.set_num_threads(2)

GS_TOL, MIP_TOL, SAMPLE_TOL, FRAME_TOL = 4e-6, 1e-6, 1e-5, 1e-4


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_grid_sample_2d_matches_jax(padding, align):
    rng = np.random.RandomState(0)
    img = rng.standard_normal((2, 3, 7, 9)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 5, 6, 2)).astype(np.float32)
    ref = np.asarray(j_gs(jnp.asarray(img), jnp.asarray(grid), padding,
                          align))
    out = t_gs(torch.from_numpy(img), torch.from_numpy(grid), padding,
               align).numpy()
    assert out.shape == ref.shape == (2, 3, 5, 6)
    np.testing.assert_allclose(out, ref, atol=GS_TOL, rtol=0)


def test_grid_sample_2d_is_forward_only():
    """Named for the forward-only op it was: `F.grid_sample` serves only
    the calls that ask for no gradient; one that asks takes the gather
    path, with the same values and the input's gradient summed through
    `ops/segment.py`; an unsupported padding mode raises either way."""
    g = torch.Generator().manual_seed(0)
    img = torch.randn((1, 1, 4, 4), generator=g).requires_grad_(True)
    grid = torch.rand((1, 2, 2, 2), generator=g) - 0.5
    out = t_gs(img, grid)
    with torch.no_grad():
        ref = t_gs(img, grid)
    assert out.shape == ref.shape == (1, 1, 2, 2)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(),
                               atol=GS_TOL, rtol=0)
    out.sum().backward()
    # every corner of a sample inside the input has weight: they sum to 1
    assert float(img.grad.sum()) == pytest.approx(4.0, abs=1e-6)
    with pytest.raises(ValueError):
        t_gs(img, grid, padding_mode="reflection")
    with pytest.raises(ValueError):
        t_gs(img.detach(), grid, padding_mode="reflection")


def _texture_and_uv(seed=1):
    rng = np.random.RandomState(seed)
    tex = rng.random((32, 32, 3)).astype(np.float32)
    # a smooth uv map over 24^2 pixels, zoomed so that its footprint
    # crosses several mip levels
    y, x = np.mgrid[0:24, 0:24].astype(np.float32) / 24
    scale = 0.2 + 2.5 * x[..., None]
    uv = np.concatenate([x[..., None] * scale, y[..., None] * scale],
                        -1) % 1.0
    return tex, uv.astype(np.float32)


def test_mipmaps_and_sampling_match_jax():
    tex, uv = _texture_and_uv()
    jm = JT.build_mipmaps(jnp.asarray(tex), 4)
    tm = TT.build_mipmaps(torch.from_numpy(tex), 4)
    assert len(tm) == len(jm) == 4
    for a, b in zip(jm, tm):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=MIP_TOL)
    np.testing.assert_allclose(
        TT._sample_level(tm[0], torch.from_numpy(uv)).numpy(),
        np.asarray(JT._sample_level(jm[0], jnp.asarray(uv))),
        atol=SAMPLE_TOL)
    jdx, jdy = JT.uv_screen_derivatives(jnp.asarray(uv))
    tdx, tdy = TT.uv_screen_derivatives(torch.from_numpy(uv))
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), atol=1e-7)
    np.testing.assert_allclose(tdy.numpy(), np.asarray(jdy), atol=1e-7)
    ref = np.asarray(JT.sample_texture(jm, jnp.asarray(uv), jdx, jdy))
    out = TT.sample_texture(tm, torch.from_numpy(uv), tdx, tdy).numpy()
    np.testing.assert_allclose(out, ref, atol=SAMPLE_TOL)
    # the derivatives pick more than one level
    assert np.abs(out - TT._sample_level(
        tm[0], torch.from_numpy(uv)).numpy()).max() > 1e-2


def _sphere_uv(n=10):
    th = np.linspace(0.15, np.pi - 0.15, n)
    ph = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
    v = np.array([[math.sin(t) * math.cos(p), math.sin(t) * math.sin(p),
                   math.cos(t)] for t in th for p in ph], np.float32)
    f = []
    for i in range(n - 1):
        for j in range(2 * n):
            a, b = i * 2 * n + j, i * 2 * n + (j + 1) % (2 * n)
            c, d = a + 2 * n, b + 2 * n
            f += [[a, c, b], [b, c, d]]
    vt = np.array([[p / (2 * np.pi), t / np.pi] for t in th for p in ph],
                  np.float32)
    return v * 0.7, np.array(f, np.int32), vt


@pytest.mark.parametrize("textured", [True, False])
def test_run_mesh_to_video_matches_jax(tmp_path, monkeypatch, textured):
    v, f, vt = _sphere_uv()
    albedo = np.random.RandomState(2).random((32, 32, 3)).astype(np.float32)
    path = str(tmp_path / "ball.glb")
    Mesh(v=v, f=f, vt=vt if textured else None,
         ft=f.copy() if textured else None,
         albedo=albedo if textured else None).write(path)
    frames = {}

    def capture(pkg, write):
        def rec(fr, p, fps=30):
            frames[pkg] = np.asarray(fr)
            return write(fr, p, fps)
        return rec
    monkeypatch.setattr(JV, "write_video", capture("jax", JV.write_video))
    monkeypatch.setattr(TV, "write_video", capture("torch", TV.write_video))
    JRunner(tiny_models=True).run_mesh_to_video(
        path, out_path=str(tmp_path / "j.mp4"), num_frames=3)
    out = TRunner(tiny_models=True, device="cpu").run_mesh_to_video(
        path, out_path=str(tmp_path / "t.mp4"), num_frames=3)
    assert out == str(tmp_path / "t.gif") and os.path.getsize(out) > 0
    j, t = frames["jax"], frames["torch"]
    assert t.shape == j.shape == (3, 64, 64, 3)
    assert np.isfinite(t).all()
    d = np.abs(t - j)
    print(f"[video textured={textured}] max |d| {d.max():.3e}")
    assert d.max() <= FRAME_TOL, d.max()
    # the frames see the mesh and, textured, the albedo's variation
    assert (t < 0.99).mean() > 0.1
    if textured:
        assert t[t < 0.99].std() > 0.05
