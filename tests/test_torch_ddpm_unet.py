"""`mvedit_tpu_torch/models/ddpm_unet.py` against the JAX package's
`DDPMUNet`, on the CPU in f32, at a tiny width (base 64, two levels,
attention at level 1; 32 groups over 64 channels, so that no GroupNorm
group is one channel, where a channel's bias has no gradient), with the
flax params (jittered so that every leaf counts) bridged by
`torch_state_from_flax(params, "ddpm_unet")`:

- the forward on a (B, 3, 4, 8, 8) triplane with a concatenated condition
  and on a (B, C, H, W) image: within 1e-5 relative (L2);
- the gradients of a weighted sum of the output to the input and to
  every parameter: within 1e-5 relative (L2) each;
- the attention routing: the (Lq, Lk, D) that the port's DDPMUNet hands
  `dot_product_attention` at the default widths and at tiny ones on maps
  up to 64^2 take the flash kernel (`uses_flash`) exactly where the JAX
  package's `_pallas_flash` would return a result on a TPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.models import ddpm_unet as JD
from mvedit_tpu.models.diffusion import attention as JA
from mvedit_tpu_torch.models import ddpm_unet as TD
from mvedit_tpu_torch.models.diffusion import attention as TA
from mvedit_tpu_torch.models.diffusion.weights import torch_state_from_flax

torch.set_num_threads(4)
TINY = dict(in_channels=12, out_channels=12, base_channels=64,
            channel_mults=(1, 2), layers_per_block=1, attn_levels=(1,),
            num_heads=2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _nets(x0, cond0=None, cond_channels=0, **over):
    cfg = dict(TINY, **over)
    jnet = JD.DDPMUNet(JD.DDPMUNetConfig(**cfg))
    params = jnet.init(jax.random.PRNGKey(0), x0, jnp.zeros((1,), jnp.int32),
                       cond0)["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape)
        .astype(np.float32), params)
    tnet = TD.DDPMUNet(TD.DDPMUNetConfig(**cfg), cond_channels)
    tnet.load_state_dict(torch_state_from_flax(params, "ddpm_unet"),
                         strict=True)
    return jnet, params, tnet


def test_triplane_forward_and_gradients_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 4, 8, 8)).astype(np.float32)
    cond = rng.normal(size=(2, 8, 8, 5)).astype(np.float32)   # NHWC
    t = np.array([7, 640], np.int32)
    w = rng.normal(size=x.shape).astype(np.float32)
    jnet, params, tnet = _nets(jnp.zeros((1, 3, 4, 8, 8)),
                               jnp.zeros((1, 8, 8, 5)), cond_channels=5)

    def jloss(p, x):
        return jnp.sum(jnet.apply({"params": p}, x, jnp.asarray(t),
                                  jnp.asarray(cond)) * w)
    jout = jnet.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                      jnp.asarray(cond))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    tout = tnet(tx, _t(t), _t(cond).permute(0, 3, 1, 2))
    (tout * _t(w)).sum().backward()
    assert tout.shape == jout.shape
    assert _rel(tout.detach(), jout) <= 1e-5
    assert _rel(tx.grad, jgx) <= 1e-5
    jg = torch_state_from_flax(jgp, "ddpm_unet")
    bad = {k: _rel(p.grad, jg[k]) for k, p in tnet.named_parameters()
           if not _rel(p.grad, jg[k]) <= 1e-5}
    assert not bad, bad


def test_image_forward_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 16, 12)).astype(np.float32)   # NHWC
    t = np.array([1, 999], np.int32)
    jnet, params, tnet = _nets(jnp.zeros((1, 16, 16, 12)))
    jout = jnet.apply({"params": params}, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        tout = tnet(_t(x).permute(0, 3, 1, 2), _t(t))
    assert _rel(tout.permute(0, 2, 3, 1), jout) <= 1e-5


def _shapes(cfg, x, monkeypatch):
    seen = []

    def record(q, k, v):
        seen.append((q.shape[1], k.shape[1], q.shape[-1]))
        return TA.attention_reference(q, k, v)
    monkeypatch.setattr(TD, "dot_product_attention", record)
    with torch.device("meta"):
        net = TD.DDPMUNet(cfg)
        net(x.to("meta"), torch.zeros((x.shape[0],), dtype=torch.long,
                                      device="meta"))
    return seen


@pytest.mark.parametrize("case", ["default_40", "default_128", "tiny_64",
                                  "tiny_48", "tiny_36"])
def test_attention_routes_as_the_reference(monkeypatch, case):
    import jax.experimental.pallas.ops.tpu.flash_attention as pf
    if case.startswith("default"):
        n = int(case.split("_")[1])
        cfg = TD.DDPMUNetConfig()
        x = torch.zeros((1, 3, 12, n, n))
    else:
        n = int(case.split("_")[1])
        cfg = TD.DDPMUNetConfig(**dict(TINY, attn_levels=(0, 1)))
        x = torch.zeros((1, 3, 4, n, n))
    shapes = _shapes(cfg, x, monkeypatch)
    assert shapes
    monkeypatch.setattr(pf, "flash_attention",
                        lambda q, k, v, **kw: jnp.zeros_like(q))
    for Lq, Lk, D in shapes:
        q = jnp.zeros((1, Lq, 1, D), jnp.bfloat16)
        kv = jnp.zeros((1, Lk, 1, D), jnp.bfloat16)
        jax_takes_flash = (max(Lq, Lk) > JA._CHUNK_THRESHOLD
                           and JA._pallas_flash(q, kv, kv) is not None)
        assert TA.uses_flash(Lq, Lk, D) == jax_takes_flash, (Lq, Lk, D)
    takes = [TA.uses_flash(*s) for s in shapes]
    # 64^2 and 48^2 maps (4096, 2304 tokens) take the kernel at level 0;
    # 36^2 (1296, not a multiple of 128) and the defaults' maps do not
    assert any(takes) == (case in ("tiny_64", "tiny_48"))
