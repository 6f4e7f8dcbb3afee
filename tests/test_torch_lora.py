"""`mvedit_tpu_torch/models/diffusion/lora.py` and the SD2.1 UNet flags
(`use_linear_projection=True`, `head_dim` 8, `num_heads=0`) against the
JAX package, on the CPU in f32, on a tiny UNet (two levels of 32 / 64
channels, 4 / 8 heads of 8, context 32) whose flax params are bridged by
`torch_state_from_flax(params, "unet")` and whose LoRA is JAX's
`init_lora` bridged by `lora_params_from_flax`, with B drawn nonzero:

- the set of LoRA'd projections and their factors' shapes equal JAX's;
- `merge_lora` and `lora_apply_delta(sign=-1)`: every merged weight
  within 1e-6 relative (L2) of JAX's, the others the same tensors;
- the UNet forward with the LoRA merged: within 1e-5 relative (L2) (the
  linear-projection branch of `Transformer2D` included);
- the gradient of a weighted sum of that output to every LoRA factor:
  within 1e-5 relative (L2) each, against `jax.grad`;
- the port's recompute of large attention scores in the backward
  (`attention.RECOMPUTE_SCORES`): bit-equal to saving them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from mvedit_tpu.models.diffusion import lora as JL
from mvedit_tpu.models.diffusion import unet as JU
from mvedit_tpu_torch.models.diffusion import lora as TL
from mvedit_tpu_torch.models.diffusion import unet as TU
from mvedit_tpu_torch.models.diffusion.weights import torch_state_from_flax

torch.set_num_threads(4)
TINY = dict(block_out_channels=(32, 64), attn_down=(True, False),
            layers_per_block=1, cross_attention_dim=32,
            use_linear_projection=True, head_dim=8, num_heads=0)
RANK = 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _setup():
    jnet = JU.UNet2DCondition(JU.UNetConfig(dtype=jnp.float32, **TINY))
    base = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 8, 4)),
                     jnp.zeros((1,), jnp.int32),
                     jnp.zeros((1, 7, 32)))["params"]
    rng = np.random.default_rng(1)
    base = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape)
        .astype(np.float32), base)
    lora = JL.init_lora(jax.random.PRNGKey(2), base, rank=RANK)
    lora = {k: {"a": np.asarray(v["a"]),
                "b": rng.normal(size=v["b"].shape).astype(np.float32) * 0.1}
            for k, v in lora.items()}
    tnet = TU.UNet2DCondition(TU.UNetConfig(dtype=torch.float32, **TINY))
    tnet.load_state_dict(torch_state_from_flax(base, "unet"), strict=True)
    return jnet, base, lora, tnet


def test_lora_targets_match_jax():
    _, base, lora, tnet = _setup()
    tl = TL.init_lora(torch.Generator().manual_seed(0),
                      dict(tnet.named_parameters()), rank=RANK)
    bridged = TL.lora_params_from_flax(lora)
    assert set(tl) == set(bridged)
    # 4 projections x 2 attentions x 4 transformers (down, mid, 2 up)
    assert len(tl) == 4 * 2 * 4
    for k in tl:
        for f in ("a", "b"):
            assert tuple(tl[k][f].shape) == tuple(bridged[k][f].shape), k
        assert not tl[k]["b"].any()
        assert 0.005 < float(tl[k]["a"].std()) < 0.02


def test_merge_and_unmerge_match_jax():
    _, base, lora, tnet = _setup()
    bridged = TL.lora_params_from_flax(lora)
    params = dict(tnet.named_parameters())
    for sign in (1.0, -1.0):
        jm = torch_state_from_flax(
            JL.lora_apply_delta(base, lora, scale=0.5, sign=sign), "unet")
        tm = TL.lora_apply_delta(params, bridged, scale=0.5, sign=sign)
        for k, v in tm.items():
            if k[:-len(".weight")] in bridged:
                assert _rel(v.detach(), jm[k]) <= 1e-6, k
            else:
                assert v is params[k]
    jm = torch_state_from_flax(JL.merge_lora(base, lora), "unet")
    tm = TL.merge_lora(params, bridged)
    assert max(_rel(tm[k].detach(), jm[k]) for k in jm) <= 1e-6


def test_merged_forward_and_lora_gradient_match_jax():
    jnet, base, lora, tnet = _setup()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 8, 4)).astype(np.float32)
    t = np.array([3, 700], np.int32)
    ctx = rng.normal(size=(2, 7, 32)).astype(np.float32)
    w = rng.normal(size=(2, 16, 8, 4)).astype(np.float32)

    def jfwd(lo):
        return jnet.apply({"params": JL.merge_lora(base, lo)},
                          jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    jout = jfwd(lora)
    jg = jax.grad(lambda lo: jnp.sum(jfwd(lo) * w))(
        jax.tree_util.tree_map(jnp.asarray, lora))
    tl = {k: {f: v.requires_grad_(True) for f, v in ab.items()}
          for k, ab in TL.lora_params_from_flax(lora).items()}
    merged = TL.merge_lora(dict(tnet.named_parameters()), tl)
    tout = torch.func.functional_call(tnet, merged, (_t(x), _t(t),
                                                     _t(ctx)))
    (tout * _t(w)).sum().backward()
    assert _rel(tout.detach(), jout) <= 1e-5
    tg = TL.lora_params_from_flax(jg)
    bad = [(k, f, _rel(tl[k][f].grad, tg[k][f])) for k in tl
           for f in ("a", "b") if not _rel(tl[k][f].grad, tg[k][f]) <= 1e-5]
    assert not bad, bad
    # the factors' module holds them under `{path}.a` / `{path}.b`
    mod = TL.LoRAParams(TL.lora_params_from_flax(lora))
    names = dict(mod.named_parameters())
    assert set(names) == {f"{k}.{f}" for k in tl for f in ("a", "b")}
    f = mod.factors()
    assert all(torch.equal(f[k]["a"], names[k + ".a"]) for k in tl)


def test_recomputed_attention_keeps_the_bits(monkeypatch):
    """With every plain attention's scores recomputed in the backward
    (`attention.RECOMPUTE_SCORES` 1, as the LoRA recipe's L 4800 maps are
    at full width), the output and the LoRA's gradients are bit-equal to
    the saved-scores run."""
    import torch.utils.checkpoint as ckpt
    from mvedit_tpu_torch.models.diffusion import attention as TA
    _, base, lora, tnet = _setup()
    rng = np.random.default_rng(4)
    x = _t(rng.normal(size=(2, 16, 8, 4)).astype(np.float32))
    t = _t(np.array([3, 700], np.int32))
    ctx = _t(rng.normal(size=(2, 7, 32)).astype(np.float32))

    def run():
        tl = {k: {f: v.requires_grad_(True) for f, v in ab.items()}
              for k, ab in TL.lora_params_from_flax(lora).items()}
        out = torch.func.functional_call(
            tnet, TL.merge_lora(dict(tnet.named_parameters()), tl),
            (x, t, ctx))
        out.square().sum().backward()
        return [out.detach()] + [tl[k][f].grad for k in sorted(tl)
                                 for f in ("a", "b")]
    calls = []
    real = ckpt.checkpoint
    monkeypatch.setattr(ckpt, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    saved = run()
    assert not calls
    monkeypatch.setattr(TA, "RECOMPUTE_SCORES", 1)
    recomputed = run()
    assert len(calls) == 8      # 4 transformers x 2 attentions
    assert all(torch.equal(a, b) for a, b in zip(saved, recomputed))
