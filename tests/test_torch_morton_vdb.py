"""The Morton ops and the OpenVDB export, port against the JAX package on
the CPU: `morton3d` / `morton3d_invert` / `packbits` bit for bit (uint32
codes, int32 coords, uint8 bytes), and `dumps` byte for byte with the
blob's `uuid.uuid4()` patched to one value in both packages.
"""
import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.ops import morton as JM
from mvedit_tpu.utils import vdb as JV

from mvedit_tpu_torch.ops import morton3d, morton3d_invert, packbits
from mvedit_tpu_torch.utils import vdb as TV


def test_morton3d_equals_jax_bit_for_bit():
    coords = np.random.default_rng(0).integers(0, 1024, (1000, 3))
    code = morton3d(torch.from_numpy(coords))
    ref = np.asarray(JM.morton3d(jnp.asarray(coords)))
    assert code.dtype == torch.uint32 and ref.dtype == np.uint32
    np.testing.assert_array_equal(code.to(torch.int64).numpy(), ref)
    # the round trip, and the inverse against JAX's
    inv = morton3d_invert(code)
    assert inv.dtype == torch.int32
    np.testing.assert_array_equal(inv.numpy(), coords)
    np.testing.assert_array_equal(
        inv.numpy(), np.asarray(JM.morton3d_invert(jnp.asarray(ref))))


def test_morton3d_wraps_as_uint32():
    """Beyond 1024 the JAX multiplies wrap in uint32; the port's 32-bit
    masks give the same codes (below 1024 no wrap can show)."""
    coords = np.random.default_rng(1).integers(0, 1 << 20, (1000, 3))
    np.testing.assert_array_equal(
        morton3d(torch.from_numpy(coords)).to(torch.int64).numpy(),
        np.asarray(JM.morton3d(jnp.asarray(coords))))
    codes = np.random.default_rng(2).integers(0, 1 << 32, 1000,
                                              dtype=np.uint64)
    np.testing.assert_array_equal(
        morton3d_invert(torch.from_numpy(codes.astype(np.int64))).numpy(),
        np.asarray(JM.morton3d_invert(jnp.asarray(codes.astype(
            np.uint32)))))


def test_morton3d_seeded_grid_and_packbits():
    g = 16
    ax = np.arange(g)
    grid = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    code = morton3d(torch.from_numpy(grid)).to(torch.int64).numpy()
    np.testing.assert_array_equal(
        code, np.asarray(JM.morton3d(jnp.asarray(grid))))
    # a Morton order visits every cell once
    assert sorted(code.reshape(-1).tolist()) == list(range(g ** 3))
    dens = np.random.default_rng(3).random(g ** 3).astype(np.float32)
    bits = packbits(torch.from_numpy(dens), 0.4)
    assert bits.dtype == torch.uint8
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(JM.packbits(jnp.asarray(dens), 0.4)))


@pytest.mark.parametrize("threshold", [0.5, 0.01])
def test_vdb_dumps_equals_jax(monkeypatch, threshold):
    """JAX's own test volume (`tests/test_ops.py::test_vdb_dumps_roundtrip`:
    a 48^3 cone with sparse holes)."""
    fixed = uuid.UUID("12345678-1234-5678-1234-567812345678")
    monkeypatch.setattr(uuid, "uuid4", lambda: fixed)
    rng = np.random.default_rng(0)
    V = 48
    ax = np.linspace(-1, 1, V, dtype=np.float32)
    r = np.sqrt(((np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1))
                 ** 2).sum(-1))
    density = np.maximum(1.0 - r, 0.0) * 20.0
    density *= rng.random(density.shape) > 0.3
    blob = TV.dumps(density, sparse_threshold=threshold)
    assert blob == JV.dumps(density, sparse_threshold=threshold)
    assert str(fixed).encode() in blob and len(blob) > 1000
