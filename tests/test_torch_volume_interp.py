"""`mvedit_tpu_torch/ops/volume_interp.py` against the JAX package's, on the
CPU, with seeded numpy inputs:

- `encode_coords`: the same int32 bits, also past 31 bits where both
  wrap (the JAX package asks for int64 there, which JAX without 64-bit
  types gives as int32);
- `sparse_volume`, `coord_to_feat_idx`, `build_neighbor`,
  `dense_from_sparse` and `sparse_from_dense`: indices, keys, masks and
  rows exactly equal; features exactly equal (gathers and single adds);
- `spvolume_linear_interp` and `neighbor_spvolume_linear_interp`, masked
  and unmasked, normalised or not: valid masks exactly equal, features
  within 1e-6 (absolute, for values of order 1), the gradient to the
  features within 1e-6 relative (L2) and to the points within 1e-5: in
  the normalised modes a point next to empty voxels divides by a small
  weight sum, and both frameworks' float32 gradients lie 2-3e-6 from a
  float64 one there (measured on these inputs).
"""
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.ops import volume_interp as J
from mvedit_tpu_torch.ops import volume_interp as T

SHAPE, BATCH = (6, 7, 5), 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _volume(seed, occupancy=0.4, C=3):
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(np.arange(BATCH), *[np.arange(s)
                                                    for s in SHAPE],
                                indexing="ij"), -1).reshape(-1, 4)
    keep = rng.random(grid.shape[0]) < occupancy
    idx = grid[keep][rng.permutation(int(keep.sum()))].astype(np.int32)
    # spare rows past the live ones, inactive
    idx = np.concatenate([idx, np.zeros((7, 4), np.int32)])
    active = np.arange(idx.shape[0]) < keep.sum()
    feats = rng.normal(size=(idx.shape[0], C)).astype(np.float32)
    return idx, feats, active


def _points(seed, P=400):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.1, 1.1, (P, 3)).astype(np.float32)
    bi = rng.integers(0, BATCH, (P, 1)).astype(np.int32)
    return pts, bi


@pytest.mark.parametrize("shape,batch", [((6, 7, 5), 2),
                                         ((1024, 1024, 512), 16)])
def test_encode_coords_bits_match_jax(shape, batch):
    rng = np.random.default_rng(0)
    c = np.stack([rng.integers(0, batch, 500)] + [
        rng.integers(0, s, 500) for s in shape], -1).astype(np.int32)
    with pytest.warns(UserWarning) if shape[0] > 64 else nullcontext():
        jk = np.asarray(J.encode_coords(jnp.asarray(c), shape, batch))
    tk = T.encode_coords(_t(c), shape, batch)
    assert tk.dtype == torch.int32 and jk.dtype == np.int32
    np.testing.assert_array_equal(tk.numpy(), jk)
    if shape[0] > 64:
        # past 31 bits both wrap: some keys are negative
        assert (jk < 0).any()


def test_sparse_volume_and_lookup_match_jax():
    idx, feats, active = _volume(1)
    jv = J.sparse_volume(idx, feats, SHAPE, BATCH, active=active)
    tv = T.sparse_volume(_t(idx), _t(feats), SHAPE, BATCH, _t(active))
    for k in ("indices", "features", "keys", "active"):
        np.testing.assert_array_equal(getattr(tv, k).numpy(),
                                      np.asarray(getattr(jv, k)))
    rng = np.random.default_rng(2)
    q = np.stack([rng.integers(-1, BATCH + 1, 300)] + [
        rng.integers(-1, s + 1, 300) for s in SHAPE], -1).astype(np.int32)
    ji, jok = J.coord_to_feat_idx(jv, jnp.asarray(q))
    ti, tok = T.coord_to_feat_idx(tv, _t(q))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.any() and not tok.all()


@pytest.mark.parametrize("neighbor", [False, True])
@pytest.mark.parametrize("masked,normalize", [(True, None), (False, None),
                                              (False, True)])
def test_interp_values_and_gradients_match_jax(neighbor, masked, normalize):
    idx, feats, active = _volume(3)
    pts, bi = _points(4)
    w = np.random.default_rng(5).normal(size=(pts.shape[0], 3)).astype(
        np.float32)
    jfn = J.neighbor_spvolume_linear_interp if neighbor else \
        J.spvolume_linear_interp
    tfn = T.neighbor_spvolume_linear_interp if neighbor else \
        T.spvolume_linear_interp

    def jloss(f, p):
        vol = J.sparse_volume(idx, f, SHAPE, BATCH, active=active)
        out, _ = jfn(vol, p, jnp.asarray(bi), masked=masked,
                     normalize=normalize)
        return jnp.sum(out * w)
    jvol = J.sparse_volume(idx, feats, SHAPE, BATCH, active=active)
    jout, jvalid = jfn(jvol, jnp.asarray(pts), jnp.asarray(bi),
                       masked=masked, normalize=normalize)
    jgf, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(feats),
                                               jnp.asarray(pts))
    tf = _t(feats).requires_grad_(True)
    tp = _t(pts).requires_grad_(True)
    tvol = T.sparse_volume(_t(idx), tf, SHAPE, BATCH, _t(active))
    tout, tvalid = tfn(tvol, tp, _t(bi), masked=masked, normalize=normalize)
    (tout * _t(w)).sum().backward()
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert tvalid.any() and not tvalid.all()
    assert np.abs(tout.detach().numpy() - np.asarray(jout)).max() <= 1e-6
    assert _rel(tf.grad, jgf) <= 1e-6
    assert _rel(tp.grad, jgp) <= 1e-5


def test_build_neighbor_matches_jax():
    idx, feats, active = _volume(6)
    jn = J.build_neighbor(J.sparse_volume(idx, feats, SHAPE, BATCH,
                                          active=active))
    tn = T.build_neighbor(T.sparse_volume(_t(idx), _t(feats), SHAPE, BATCH,
                                          _t(active)))
    for k in ("keys", "corner_idx", "corner_valid", "active"):
        np.testing.assert_array_equal(getattr(tn, k).numpy(),
                                      np.asarray(getattr(jn, k)))
    assert tn.spatial_shape_p1 == jn.spatial_shape_p1


def test_dense_round_trip_matches_jax():
    idx, feats, active = _volume(7)
    jd, jm = J.dense_from_sparse(J.sparse_volume(idx, feats, SHAPE, BATCH,
                                                 active=active))
    td, tm = T.dense_from_sparse(T.sparse_volume(_t(idx), _t(feats), SHAPE,
                                                 BATCH, _t(active)))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    cap = int(active.sum()) + 5
    js = J.sparse_from_dense(jd, jm, cap)
    ts = T.sparse_from_dense(td, tm, cap)
    for k in ("indices", "features", "keys", "active"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)))
