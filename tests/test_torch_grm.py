"""GRM's modules in the port against the JAX package's, on the CPU in f32,
with the flax params bridged by `grm_state_from_flax`:

- `GRMEncoder` at dim 32, depth 1, heads 4, patch 8, on 2 views of 32^2
  and of 36 x 44 (not a multiple of the patch: flax's "SAME" padding);
- `GaussianUpsampler` (factor 8 and 2), whose tanh GELU and
  (V, h, w, r, r, C) pixel layout are pinned by hand-made weights that
  tell the exact GELU and `F.pixel_shuffle`'s order apart;
- `unproject_depth` and `pixels_to_gaussians` on seeded maps and poses;

all within 1e-5 of the largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mvedit_tpu.models import grm as JGRM

from mvedit_tpu_torch.models.grm import (GaussianUpsampler, GRMConfig,
                                         GRMEncoder, grm_state_from_flax,
                                         pixels_to_gaussians, plucker_rays,
                                         unproject_depth)

CFG = dict(dim=32, depth=1, heads=4, patch_size=8)


def _close(a, b, rel=1e-5):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                               atol=rel * max(np.abs(b).max(), 1e-30))


def _poses(v, seed=0):
    rng = np.random.default_rng(seed)
    poses = np.zeros((v, 3, 4), np.float32)
    for i in range(v):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        poses[i, :, :3] = q
        poses[i, :, 3] = rng.normal(size=3)
    return poses


@pytest.mark.parametrize("hw", [(32, 32), (36, 44)])
def test_encoder_matches_reference(hw):
    h, w = hw
    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    plk = rng.normal(size=(2, h, w, 6)).astype(np.float32)
    jenc = JGRM.GRMEncoder(JGRM.GRMConfig(**CFG))
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(imgs),
                       jnp.asarray(plk))["params"]
    ref = jenc.apply({"params": params}, jnp.asarray(imgs), jnp.asarray(plk))
    enc = GRMEncoder(GRMConfig(**CFG))
    enc.load_state_dict(grm_state_from_flax(params))
    with torch.no_grad():
        out = enc(torch.from_numpy(imgs), torch.from_numpy(plk))
    assert out.shape == ref.shape == (2, -(-h // 8), -(-w // 8), 32)
    _close(out, ref)


@pytest.mark.parametrize("factor", [8, 2])
def test_upsampler_matches_reference(factor):
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(2, 3, 4, 32)).astype(np.float32)
    jup = JGRM.GaussianUpsampler(factor=factor, hidden=16)
    params = jup.init(jax.random.PRNGKey(1), jnp.asarray(feat))["params"]
    ref = jup.apply({"params": params}, jnp.asarray(feat))
    up = GaussianUpsampler(32, 14, factor, hidden=16)
    up.load_state_dict(grm_state_from_flax(params))
    with torch.no_grad():
        out = up(torch.from_numpy(feat))
    assert out.shape == ref.shape == (2, 3 * factor, 4 * factor, 14)
    _close(out, ref)


def test_upsampler_gelu_and_pixel_layout_pinned():
    """conv1 an identity on one channel, conv2 writing channel
    (i * r + j) * C + c = that value times (1 + index): the reference's
    layout puts it at pixel (y * r + i, x * r + j), channel c, after a
    tanh GELU."""
    r, C, hid = 2, 3, 4
    up = GaussianUpsampler(1, C, r, hidden=hid)
    with torch.no_grad():
        up.conv1.weight.zero_()
        up.conv1.bias.zero_()
        up.conv1.weight[0, 0, 1, 1] = 1.0
        up.conv2.weight.zero_()
        up.conv2.bias.zero_()
        for o in range(r * r * C):
            up.conv2.weight[o, 0, 1, 1] = 1.0 + o
    feat = torch.tensor([[[[-1.5], [0.7]], [[2.0], [-0.3]]]])   # (1,2,2,1)
    out = up(feat)
    g = F.gelu(feat[..., 0], approximate="tanh")
    want = torch.empty(1, 2 * r, 2 * r, C)
    for y in range(2):
        for x in range(2):
            for i in range(r):
                for j in range(r):
                    for c in range(C):
                        want[0, y * r + i, x * r + j, c] = \
                            g[0, y, x] * (1 + (i * r + j) * C + c)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    # the exact GELU and pixel_shuffle's channel order both differ here
    assert not torch.allclose(g, F.gelu(feat[..., 0]), atol=1e-4)
    # F.pixel_shuffle reads the channels as (C, r, r), the reference as
    # (r, r, C)
    with torch.no_grad():
        x = up.conv2(F.gelu(up.conv1(feat.permute(0, 3, 1, 2)),
                            approximate="tanh"))
    assert not torch.allclose(F.pixel_shuffle(x, r).permute(0, 2, 3, 1), out)


def test_unproject_and_pixels_to_gaussians_match_reference():
    rng = np.random.default_rng(3)
    V, H, W = 2, 16, 12
    poses = _poses(V)
    intr = np.array([[20.0, 22.0, 6.0, 8.0], [18.0, 18.0, 6.5, 7.5]],
                    np.float32)
    depth = rng.uniform(0.5, 3.0, (V, H, W)).astype(np.float32)
    _close(unproject_depth(torch.from_numpy(depth), torch.from_numpy(poses),
                           torch.from_numpy(intr)),
           JGRM.unproject_depth(jnp.asarray(depth), jnp.asarray(poses),
                                jnp.asarray(intr)))
    pm = rng.normal(size=(V, H, W, 14)).astype(np.float32) * 3
    pm[0, 0, 0, 4:8] = 0.0           # a zero quaternion: the norm's clip
    out = pixels_to_gaussians(torch.from_numpy(pm), torch.from_numpy(poses),
                              torch.from_numpy(intr))
    ref = JGRM.pixels_to_gaussians(jnp.asarray(pm), jnp.asarray(poses),
                                   jnp.asarray(intr))
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        _close(out[k], ref[k])


def test_plucker_rays_are_moment_and_direction():
    poses = torch.from_numpy(_poses(2, seed=4))
    intr = torch.tensor([[16.0, 16.0, 4.0, 4.0]] * 2)
    p = plucker_rays(poses, intr, 8, 8)
    assert p.shape == (2, 8, 8, 6)
    d, m = p[..., 3:], p[..., :3]
    torch.testing.assert_close(d.norm(dim=-1), torch.ones(2, 8, 8))
    # the moment is orthogonal to the direction and independent of the
    # point taken on the ray
    torch.testing.assert_close((d * m).sum(-1), torch.zeros(2, 8, 8),
                               atol=1e-5, rtol=0)
    o2 = poses[:, None, None, :, 3] + 2.5 * d
    torch.testing.assert_close(torch.linalg.cross(o2, d), m, atol=1e-5,
                               rtol=0)
