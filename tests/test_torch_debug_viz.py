"""`utils/debug_viz.py::save_tiled_viz`, port against the JAX package on the
CPU, on seeded host arrays: the same file names, equal pixels where every
channel has the tile's size, within 1 / 255 where a target is resized
(the port's `resize_bilinear` against `jax.image.resize`). Pinned
difference: where the JAX package writes a black tile on any error of
that resize (`except Exception`), the port raises.
"""
import os

import numpy as np
import pytest
from PIL import Image

from mvedit_tpu.utils.debug_viz import save_tiled_viz as j_save

from mvedit_tpu_torch.utils.debug_viz import save_tiled_viz as t_save


def _arrays(seed, n, h, tgt, normals=True):
    rng = np.random.default_rng(seed)
    renders = {"rgb": rng.random((n, h, h, 3), np.float32),
               "depth": rng.random((n, h, h), np.float32) * 3 + 1,
               "alpha": rng.random((n, h, h, 1), np.float32)}
    targets = {"images": rng.random((n, tgt, tgt, 3), np.float32),
               "masks": rng.random((n, tgt, tgt, 1), np.float32)}
    if normals:
        renders["normal"] = rng.random((n, h, h, 3), np.float32)
        targets["normals"] = rng.random((n, tgt, tgt, 3), np.float32)
    return renders, targets


def _tiles(d):
    return {f: np.asarray(Image.open(os.path.join(d, f)), np.int32)
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("tgt,normals,tol", [(16, True, 0), (16, False, 0),
                                             (32, True, 1), (24, True, 1)])
def test_tiles_equal_jax(tmp_path, tgt, normals, tol):
    renders, targets = _arrays(tgt, 3, 16, tgt, normals)
    t_save(str(tmp_path / "port"), 7, renders, targets)
    j_save(str(tmp_path / "jax"), 7, renders, targets)
    tp, tj = _tiles(tmp_path / "port"), _tiles(tmp_path / "jax")
    assert list(tp) == list(tj) == [f"007_{v:03d}.png" for v in range(3)]
    for f in tp:
        assert tp[f].shape == (32, 48, 3)
        assert np.abs(tp[f] - tj[f]).max() <= tol


def test_port_raises_where_jax_writes_black(tmp_path):
    """A target channel the resize cannot take ((1, H, W, 3) a view): the
    JAX package swallows the error and writes that tile part black."""
    renders, targets = _arrays(1, 2, 16, 8)
    targets["images"] = targets["images"][:, None]
    j_save(str(tmp_path / "jax"), 0, renders, targets)
    tile = _tiles(tmp_path / "jax")["000_000.png"]
    assert tile[:16, :16].max() == 0
    with pytest.raises(ValueError, match="tile's channel"):
        t_save(str(tmp_path / "port"), 0, renders, targets)
