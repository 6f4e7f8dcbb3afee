"""The port's image pre- and post-processing (`pipelines/preproc.py`)
against the JAX package's, on seeded inputs. Both are the same host numpy
code in float64, so every output must be bit-equal:

- `pad_rgba_image` with and without an alpha channel, and an empty one;
- `zero123plus_postprocess` on seeded views whose normal maps have a
  0.5-grey background, a foreground disc and a noisy band between;
- `do_segmentation` with the same masks from a stub segmenter, a stub
  `refine_fn` (a disc inside the prompted box, so the box and the uint8
  image it gets both matter), `bg_color` and the edge-padded erosion.
"""
import numpy as np
import pytest
import torch

from mvedit_tpu.pipelines import preproc as J
from mvedit_tpu_torch.pipelines import preproc as T


def _views(n, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    rgb = rng.random((n, h, w, 3)).astype(np.float32)
    normal = np.full((n, h, w, 3), 0.5, np.float32)
    for i in range(n):
        r = np.hypot(yy - h / 2 - i, xx - w / 2 + i)
        fg = r < 0.3 * h
        band = (r >= 0.3 * h) & (r < 0.38 * h)
        normal[i][fg] = rng.random((fg.sum(), 3)) * 0.2 + [0.9, 0.5, 0.7]
        normal[i][band] = rng.random((band.sum(), 3))
    return rgb, normal


def test_pad_rgba_image_matches_jax():
    rng = np.random.default_rng(0)
    rgba = np.zeros((40, 30, 4), np.float32)
    rgba[5:20, 8:27] = rng.random((15, 19, 4)) * 0.4 + 0.6
    for img in (rgba, rgba[..., :3], np.zeros((8, 8, 4), np.float32)):
        for ratio in (0.75, 0.9):
            ref = J.pad_rgba_image(img, ratio)
            out = T.pad_rgba_image(img, ratio)
            np.testing.assert_array_equal(out, ref)
    assert T.pad_rgba_image(rgba).shape == (25, 25, 4)


def test_zero123plus_postprocess_matches_jax():
    rgb, normal = _views(3, 40, 40, 1)
    for v, n in zip(rgb, normal):
        rgba_j, n_j = J.zero123plus_postprocess(v, n)
        rgba_t, n_t = T.zero123plus_postprocess(v, n)
        np.testing.assert_array_equal(rgba_t, rgba_j)
        np.testing.assert_array_equal(n_t, n_j)
        alpha = rgba_t[..., 3]
        # hard foreground, hard background and a refined band between
        assert (alpha == 1).any() and (alpha == 0).any()
        assert ((alpha > 0) & (alpha < 1)).any()


def _stub_masks(images):
    """A segmenter's masks from the image: bright pixels 1, a blob of 0.6
    in the first image, the rest 0 (numpy, (N, H, W, 1))."""
    m = (np.asarray(images).mean(-1, keepdims=True) > 0.55).astype(
        np.float32)
    m[0, :3, :4] = 0.6
    return m


def _refine(image_uint8, bbox):
    """A disc inside the box, its radius from the image's mean."""
    h, w = image_uint8.shape[:2]
    yy, xx = np.mgrid[:h, :w]
    cx, cy = (bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2
    r = 0.25 * min(bbox[2] - bbox[0], bbox[3] - bbox[1]) \
        * (1 + image_uint8.mean() / 255.0)
    return ((xx - cx) ** 2 + (yy - cy) ** 2 < r * r).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(refine_fn=_refine),
    dict(refine_fn=_refine, erosion=2),
    dict(bg_color=(1.0, 1.0, 1.0)),
    dict(refine_fn=_refine, bg_color=1.0, erosion=1),
], ids=["refine", "refine_erosion", "bg_color", "all"])
def test_do_segmentation_matches_jax(kw):
    rng = np.random.default_rng(2)
    images = np.ones((3, 32, 36, 3), np.float32)
    images[:, 8:24, 10:30] = rng.random((3, 16, 20, 3))
    images[2] = 0.0            # dark: an empty mask, no prompt (unless
    #                            bg_color makes it all foreground)
    calls = []

    def refine_t(im, bbox):
        calls.append(bbox)
        return kw["refine_fn"](im, bbox)
    kw_t = dict(kw, refine_fn=refine_t) if "refine_fn" in kw else kw
    ref = J.do_segmentation(images, lambda x: _stub_masks(x), **kw)
    out = T.do_segmentation(torch.from_numpy(images),
                            lambda x: torch.from_numpy(
                                _stub_masks(x.numpy())), **kw_t)
    assert isinstance(out, torch.Tensor) and out.shape == (3, 32, 36, 1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    if "refine_fn" in kw:
        assert len(calls) == (3 if "bg_color" in kw else 2)
    # numpy input and a 3-d segmenter output take the same path
    out2 = T.do_segmentation(images, lambda x: torch.from_numpy(
        _stub_masks(x.numpy())[..., 0]), **kw)
    np.testing.assert_array_equal(out2.numpy(), out.numpy())
