"""SAM in the port against the JAX package's, on the CPU in f32 at
`SAM_TINY` (64^2 input, 8 x 8 tokens, 4 x 4 windows, one global block):

- with the JAX params bridged by `sam_state_from_flax`: the image
  embedding and the decoder's multimask logits and IoU predictions within
  1e-5 of their largest magnitude, and `sam_predict_box`'s masks (resize
  of a 48 x 40 image, box prompt, the last mask, crop, resize back,
  threshold at 0) equal;
- the reference's transposed-convolution mirror, pinned: one
  segment-anything state dict, loaded by the port as it is and by the JAX
  package through `convert_sam`, gives JAX logits that are the port's with
  every 4 x 4 block of the two 2x upscalings reversed in both axes (within
  1e-5), and the bridge back (`sam_state_from_flax`) undoes it;
- `run_segmentation` with `use_sam`, `erosion` and `bg_color` through
  both runners, with one stub segmenter in place of TRACER (seeded
  TRACER's masks are empty, which would leave SAM unprompted): equal
  masks, and SAM prompted once per image.

The JAX params are seeded from `jax.eval_shape` of the flax init (an
eager init costs tens of seconds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvedit_tpu.models.segmentors as JSeg
from mvedit_tpu.apis import Adapter3DRunner as JRunner
from mvedit_tpu.models.segmentors.sam import SAM_TINY as J_TINY
from mvedit_tpu.models.segmentors.sam import SamModel as JSam
from mvedit_tpu.models.segmentors.sam import convert_sam
from mvedit_tpu.models.segmentors.sam import sam_predict_box as j_predict

from mvedit_tpu_torch.apis import Adapter3DRunner as TRunner
from mvedit_tpu_torch.apis.runner import init_random_
from mvedit_tpu_torch.models.segmentors.sam import (SAM_TINY, SamModel,
                                                    sam_predict_box,
                                                    sam_state_from_flax)

torch.set_num_threads(4)

# the port's modules the reference has no params for (no box prompt
# reads them)
_UNUSED = ("prompt_encoder.not_a_point_embed.",
           "prompt_encoder.mask_downscaling.")


def _seeded_params(seed):
    shapes = jax.eval_shape(JSam(J_TINY).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), jnp.zeros((4,)))
    rng = np.random.RandomState(seed)

    def f(path, sd):
        name = getattr(path[-1], "key", None)
        n = rng.standard_normal(sd.shape).astype(np.float32)
        if name == "kernel":
            return n / np.sqrt(np.prod(sd.shape[:-1]))
        if name in ("scale", "weight"):
            return 1.0 + 0.1 * n
        if name == "bias":
            return 0.05 * n
        return 0.5 * n
    return jax.tree_util.tree_map_with_path(f, shapes)["params"]


@pytest.fixture(scope="module")
def pair():
    params = _seeded_params(0)
    net = SamModel(SAM_TINY).eval()
    missing, unexpected = net.load_state_dict(
        sam_state_from_flax(params, SAM_TINY), strict=False)
    assert not unexpected and all(k.startswith(_UNUSED) for k in missing)
    return JSam(J_TINY), params, net


def _peak(x):
    return float(np.abs(np.asarray(x)).max())


def test_encoder_and_decoder_match_jax(pair):
    jm, params, net = pair
    x = np.random.default_rng(1).standard_normal((1, 64, 64, 3)).astype(
        np.float32)
    box = np.array([5.0, 7.0, 50.0, 40.0], np.float32)
    emb_j = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                                method=jm.encode_image))
    masks_j, iou_j = jm.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(box))
    with torch.no_grad():
        emb_t = net.encode_image(torch.from_numpy(x)).numpy()
        masks_t, iou_t = net(torch.from_numpy(x), torch.from_numpy(box))
    assert emb_t.shape == emb_j.shape == (1, 8, 8, 32)
    np.testing.assert_allclose(emb_t, emb_j, atol=1e-5 * _peak(emb_j))
    assert masks_t.shape == masks_j.shape == (3, 32, 32)
    np.testing.assert_allclose(masks_t.numpy(), masks_j,
                               atol=1e-5 * _peak(masks_j))
    np.testing.assert_allclose(iou_t.numpy(), iou_j,
                               atol=1e-5 * _peak(iou_j))


def test_predict_box_matches_jax(pair):
    jm, params, net = pair
    img = np.random.default_rng(2).random((48, 40, 3)).astype(np.float32)
    for box in ([3.0, 4.0, 30.0, 36.0], [10.0, 2.0, 39.0, 47.0]):
        ref = np.asarray(j_predict(jm, params, img, np.asarray(box)))
        out = sam_predict_box(net, torch.from_numpy(img), box).numpy()
        assert out.shape == ref.shape == (48, 40)
        assert 0.0 < ref.mean() < 1.0
        np.testing.assert_array_equal(out, ref)


def _unmirror(m):
    """Reverse every 4 x 4 block of (N, 4t, 4t) in both axes."""
    n, h, w = m.shape
    return m.reshape(n, h // 4, 4, w // 4, 4)[:, :, ::-1, :, ::-1].reshape(
        n, h, w)


def test_reference_mirrors_the_upscaling():
    """A reference behaviour, not copied: flax's `ConvTranspose` does not
    flip the kernel that `_convT` hands it from a torch `ConvTranspose2d`
    (k = s = 2), so each upscaling places its 2 x 2 blocks mirrored, and
    the two compose into reversed 4 x 4 blocks."""
    net = SamModel(SAM_TINY).eval()
    init_random_(net, torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, p in net.named_parameters():   # non-trivial norms, biases
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator()
                                         .manual_seed(len(name))))
        pe = net.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix
        pe.copy_(torch.randn(pe.shape, generator=torch.Generator()
                             .manual_seed(4)))
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    params, unmatched = convert_sam(sd, J_TINY)
    assert all(k.startswith(_UNUSED) for k in unmatched)
    x = np.random.default_rng(5).standard_normal((1, 64, 64, 3)).astype(
        np.float32)
    box = np.array([6.0, 3.0, 44.0, 58.0], np.float32)
    masks_j = np.asarray(JSam(J_TINY).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(box))[0])
    with torch.no_grad():
        masks_t = net(torch.from_numpy(x), torch.from_numpy(box))[0].numpy()
    tol = 1e-5 * _peak(masks_j)
    assert np.abs(masks_t - masks_j).max() > 100 * tol
    np.testing.assert_allclose(_unmirror(masks_t), masks_j, atol=tol)
    # the bridge flips the kernels back: the port then computes JAX's
    bridged = SamModel(SAM_TINY).eval()
    bridged.load_state_dict(sam_state_from_flax(params, SAM_TINY),
                            strict=False)
    with torch.no_grad():
        masks_b = bridged(torch.from_numpy(x),
                          torch.from_numpy(box))[0].numpy()
    np.testing.assert_allclose(masks_b, masks_j, atol=tol)


class _StubTracer:
    """A segmenter map from the normalised input: 1 where the mean channel
    is below 1.5 (the object on white), else 0."""

    @staticmethod
    def apply(params, x):
        return (jnp.mean(x, -1, keepdims=True) < 1.5).astype(jnp.float32)

    def __call__(self, x):
        return (x.mean(-1, keepdim=True) < 1.5).float()


@pytest.fixture(scope="module")
def runners(pair):
    jm, params, net = pair
    jr = JRunner(tiny_models=True, seed=0)
    tr = TRunner(tiny_models=True, seed=0, device="cpu")
    jr._cache["tracer_model"] = (_StubTracer(), None)
    jr._cache["sam_model"] = (jm, params)
    tr._cache["tracer"] = _StubTracer()
    tr._cache["sam"] = net
    return jr, tr


@pytest.mark.parametrize("kw", [dict(use_sam=True),
                                dict(use_sam=True, erosion=1),
                                dict(bg_color=1.0)],
                         ids=["use_sam", "erosion", "bg_color"])
def test_run_segmentation_options_match_jax(runners, kw, monkeypatch):
    jr, tr = runners
    rng = np.random.default_rng(6)
    images = np.ones((2, 64, 64, 3), np.float32)
    images[0, 10:40, 14:50] = rng.random((30, 36, 3)) * 0.5
    images[1, 20:60, 5:30] = rng.random((40, 25, 3)) * 0.5
    images[1, 30:40, 30:62] = 0.3
    # the reference's do_segmentation writes into the segmenter's masks,
    # which JAX hands over read-only: give it a writable copy
    j_segment = JSeg.tracer_segment
    monkeypatch.setattr(JSeg, "tracer_segment",
                        lambda *a, **k: np.array(j_segment(*a, **k)))
    calls = []
    make = tr.make_sam_refine_fn

    def counted():
        refine = make()

        def f(*a):
            calls.append(a[1])
            return refine(*a)
        return f
    monkeypatch.setattr(tr, "make_sam_refine_fn", counted)
    ref = np.asarray(jr.run_segmentation(images, **kw))
    out = tr.run_segmentation(images, **kw)
    assert isinstance(out, torch.Tensor) and out.shape == (2, 64, 64, 1)
    assert 0.0 < ref.mean() < 1.0
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(calls) == (2 if kw.get("use_sam") else 0)
