"""The port's LPIPS and entropy losses against the JAX package's, on the CPU
in fp32.

LPIPS: VGG16 at its published widths (13 convs, 64..512 channels) with the
JAX init's weights bridged by `lpips_params_from_flax`, on 32^2 images
(the full-size runner's bf16 cast is held against f32 on the card, in
`test_torch_kernels_cuda.py`). The distance within 1e-5 relative, its
gradient with respect to the prediction within 1e-4 relative L2 (f32
convolutions summed in another order through 13 layers). The entropy
loss and its gradients within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from mvedit_tpu.models import losses as JL

from mvedit_tpu_torch.models import losses as TL

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_lpips_matches_jax():
    params = jax.tree_util.tree_map(np.asarray,
                                    JL.lpips_init(jax.random.PRNGKey(0)))
    tp = TL.lpips_params_from_flax(params)
    assert [tuple(c["w"].shape) for c in tp["convs"]][::4] == [
        (64, 3, 3, 3), (256, 128, 3, 3), (512, 512, 3, 3), (512, 512, 3, 3)]
    rng = np.random.default_rng(0)
    pred, tgt = (rng.random((3, 32, 32, 3)).astype(np.float32)
                 for _ in range(2))
    w = np.array([1.0, 0.5, 2.0], np.float32)
    for wt in (None, w):
        ref = float(JL.lpips_apply(params, pred, tgt, weight=wt))
        out = float(TL.lpips_apply(tp, _t(pred), _t(tgt),
                                   weight=None if wt is None else _t(wt)))
        assert ref > 0
        np.testing.assert_allclose(out, ref, rtol=1e-5)
    g_j = jax.grad(lambda p: JL.lpips_apply(params, p, tgt, weight=w))(
        jnp.asarray(pred))
    x = _t(pred).requires_grad_(True)
    TL.lpips_apply(tp, x, _t(tgt), weight=_t(w)).backward()
    assert _rel(x.grad.numpy(), g_j) <= 1e-4


def test_lpips_init_shapes_match_jax():
    ref = JL.lpips_init(jax.random.PRNGKey(0))
    out = TL.lpips_init(torch.Generator().manual_seed(0))
    for a, b in zip(out["convs"], ref["convs"]):
        assert tuple(a["w"].shape) == np.asarray(b["w"]).transpose(
            3, 2, 0, 1).shape
        # the same init scale, N(0, 1 / fan_in)
        np.testing.assert_allclose(float(a["w"].std()),
                                   float(np.asarray(b["w"]).std()), rtol=0.1)
    for a, b in zip(out["lins"], ref["lins"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_entropy_loss_matches_jax():
    rng = np.random.default_rng(1)
    R, S = 256, 16
    w = (rng.random((R, S)) * 0.2).astype(np.float32)
    w[:10] = 0.0                          # empty rays: the clips' bounds
    d = (rng.random((R, S)) * 0.05).astype(np.float32)
    a = np.clip(w.sum(-1), 0, 1).astype(np.float32)
    f_j = lambda w_, a_: JL.entropy_loss(w_, d, a_, bg_width=0.015,  # noqa
                                         num_pixels=R)
    ref, (gw_j, ga_j) = jax.value_and_grad(f_j, (0, 1))(jnp.asarray(w),
                                                         jnp.asarray(a))
    wt, at = _t(w).requires_grad_(True), _t(a).requires_grad_(True)
    out = TL.entropy_loss(wt, _t(d), at, bg_width=0.015, num_pixels=R)
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=1e-5)
    out.backward()
    for g_t, g_j in ((wt.grad, gw_j), (at.grad, ga_j)):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(g_j).max()))
