"""The port's attention against the JAX package's, on the CPU in fp32.

- The flash-attention wrapper's plain version (what the wrapper runs for a
  CPU tensor) against JAX `dot_product_attention`, which on the CPU is
  `_pallas_flash`'s plain reference `_manual_attention`. Tolerance
  rtol 1e-5 / atol 1e-5: both compute f32 scores and softmax and differ
  only in summation order.
- The routing predicate `uses_flash` against the conditions under which
  JAX's `_pallas_flash` returns a result, over a table of shapes; the
  port's routing over that table in f32 and bf16, with and without a
  gradient asked for (the kernel also takes bf16 calls of any length
  that need none), its `attention.kernel.ragged` counter, and a bf16
  LoRA UNet's attention on the plain path while its factors need a
  gradient.
- `CrossAttention` in joint mode and `Transformer2D` with weights bridged
  from flax; rtol 1e-4 and atol 1e-4 * max|ref|, because the projections
  sum in a different order than XLA's.
- `ops.flash_attention` (the counterpart of the JAX package's own flash
  kernel `mvedit_tpu/ops/flash_attention.py`): its plain version against
  the Pallas kernel in interpret mode, within `FA.agreement`; `supported`
  and the shapes it rejects, against JAX's block picker.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.models.diffusion import attention as JA
import mvedit_tpu_torch.models.diffusion.attention as TA
from mvedit_tpu_torch.kernels import flash_attention as FA
from mvedit_tpu_torch.models.diffusion.weights import _leaf, flatten

torch.set_num_threads(2)


def _qkv(rng, B, Lq, Lk, H, D):
    return (rng.standard_normal((B, Lq, H, D)).astype(np.float32),
            rng.standard_normal((B, Lk, H, D)).astype(np.float32),
            rng.standard_normal((B, Lk, H, D)).astype(np.float32))


def _close(out, ref, rtol=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("L", [1280, 2048])
@pytest.mark.parametrize("D", [40, 80])
def test_plain_attention_matches_jax(L, D):
    q, k, v = _qkv(np.random.RandomState(L + D), 1, L, L, 2, D)
    ref = np.asarray(JA.dot_product_attention(q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    np.testing.assert_allclose(
        FA.attention_reference(tq, tk, tv).numpy(), ref, rtol=1e-5,
        atol=1e-5)
    # the wrapper itself takes the plain version for CPU tensors and
    # launches nothing
    before = FA.flash_attention.launches
    np.testing.assert_allclose(FA.flash_attention(tq, tk, tv).numpy(), ref,
                               rtol=1e-5, atol=1e-5)
    assert FA.flash_attention.launches == before


def test_chunked_attention_matches_jax():
    # ragged Lk exercises the reference's padded last chunk
    q, k, v = _qkv(np.random.RandomState(0), 1, 300, 2 * JA._KV_CHUNK + 77,
                   2, 8)
    ref = JA._chunked_attention(q, k, v)
    out = TA._chunked_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# (Lq, Lk, D): path shapes at 512^2, the thresholds' edges, ragged lengths
_ROUTES = [(4096, 4096, 40), (8192, 8192, 40), (24576, 24576, 40),
           (2048, 2048, 80), (6144, 6144, 80), (1024, 1024, 80),
           (1152, 1152, 64), (1024, 77, 40), (4096, 77, 40),
           (4096, 4096, 512), (4096, 4096, 128), (4096, 4096, 136),
           (1000, 1000, 40), (2000, 2048, 40), (2048, 2000, 40),
           (1280, 1280, 40), (1088, 64, 8), (64, 1152, 8)]


@pytest.mark.parametrize("Lq,Lk,D", _ROUTES)
def test_flash_predicate_matches_jax(monkeypatch, Lq, Lk, D):
    """`uses_flash` holds exactly where JAX's dot_product_attention would
    take `_pallas_flash`'s result on a TPU."""
    import jax.experimental.pallas.ops.tpu.flash_attention as pf
    monkeypatch.setattr(pf, "flash_attention",
                        lambda q, k, v, **kw: jnp.zeros_like(q))
    q = jnp.zeros((1, Lq, 1, D), jnp.bfloat16)
    kv = jnp.zeros((1, Lk, 1, D), jnp.bfloat16)
    jax_takes_flash = (max(Lq, Lk) > JA._CHUNK_THRESHOLD
                       and JA._pallas_flash(q, kv, kv) is not None)
    assert TA.uses_flash(Lq, Lk, D) == jax_takes_flash


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("Lq,Lk,D", _ROUTES)
def test_dispatch_routes(monkeypatch, Lq, Lk, D, device, dtype, grad):
    """dot_product_attention sends each shape where the JAX package does:
    flash kernel, chunked online softmax (Lq * Lk > 4096 * 8192), or plain
    matmul attention; and, beyond that, every bf16 call the kernel reads
    as it is (D <= 128, D % 8 == 0) and no gradient is asked of, whatever
    its lengths, to the kernel. f32 calls route as the JAX package's; a
    call that needs a gradient never takes the kernel, which has no
    backward, and goes where the chunked rule sends it. The `meta` device
    stands in for the card (any non-CPU device); CPU tensors never take
    the kernel, as JAX skips `_pallas_flash` on its CPU backend."""
    seen = []
    for name in ("flash_attention", "_chunked_attention",
                 "attention_reference"):
        monkeypatch.setattr(TA, name,
                            lambda q, k, v, _n=name: seen.append(_n) or q)
    q = torch.empty((1, Lq, 1, D), device=device, dtype=dtype,
                    requires_grad=grad)
    kv = torch.empty((1, Lk, 1, D), device=device, dtype=dtype,
                     requires_grad=grad)
    TA.dot_product_attention(q, kv, kv)
    as_it_is = (dtype == torch.bfloat16 and not grad and D <= 128
                and D % 8 == 0)
    if device != "cpu" and not grad and (TA.uses_flash(Lq, Lk, D)
                                         or as_it_is):
        want = "flash_attention"
    elif Lq * Lk > 4096 * 8192:
        want = "_chunked_attention"
    else:
        want = "attention_reference"
    assert seen == [want]


@pytest.mark.parametrize("L,want", [(4096, "plain"), (8192, "chunked")])
def test_route_sends_a_gradient_off_the_kernel(L, want):
    """An aligned call that `uses_flash` admits, on the card (`meta`
    stands in), takes the kernel without a gradient and, asking for one,
    the path off the kernel that the chunked rule picks: the kernel's
    output has no `grad_fn`."""
    q, kv = (torch.empty((1, L, 2, 64), device="meta", dtype=torch.bfloat16,
                         requires_grad=True) for _ in range(2))
    assert TA.uses_flash(L, L, 64)
    assert TA._route(q, kv, kv) == want
    with torch.no_grad():
        assert TA._route(q, kv, kv) == "kernel"
    assert TA._route(q.detach(), kv.detach(), kv.detach()) == "kernel"


def test_ragged_counter_counts_the_new_route_alone(monkeypatch):
    """`attention.kernel.ragged` counts the kernel calls that only
    `kernel_takes` admits (bf16, no gradient, lengths off the TPU's
    128-row blocks or at most 1024); `attention.kernel` counts every
    kernel call, `attention.plain` the rest."""
    from mvedit_tpu_torch.utils.profiling import PhaseTimer, set_phase_timer
    for name in ("flash_attention", "_chunked_attention",
                 "attention_reference"):
        monkeypatch.setattr(TA, name, lambda q, k, v: q)

    def call(Lq, Lk, D, dtype=torch.bfloat16, device="meta", grad=False):
        q = torch.empty((2, Lq, 2, D), device=device, dtype=dtype,
                        requires_grad=grad)
        kv = torch.empty((2, Lk, 2, D), device=device, dtype=dtype,
                         requires_grad=grad)
        TA.dot_product_attention(q, kv, kv)

    pt = PhaseTimer()
    set_phase_timer(pt)
    try:
        call(9600, 19200, 64)                    # uses_flash
        call(4096, 4096, 40, torch.float32)      # uses_flash, staged
        call(2400, 4800, 64)                     # ragged
        call(150, 150, 64)                       # ragged
        call(9600, 77, 64)                       # cross-attention
        call(4096, 4, 40)                        # IP-Adapter's tokens
        call(1024, 1024, 80)                     # not above 1024
        call(2400, 4800, 64, grad=True)          # a gradient: plain
        with torch.no_grad():
            call(2400, 4800, 64, grad=True)      # none asked for
        call(2400, 4800, 64, torch.float32)      # f32: plain
        call(256, 77, 160)                       # D > 128: plain
        call(4096, 4096, 512)                    # the VAE's D: plain
        call(2400, 4800, 64, device="cpu")       # CPU: plain
    finally:
        set_phase_timer(None)
    assert pt.counts["attention.kernel"] == 8
    assert pt.counts["attention.kernel.ragged"] == 6
    assert pt.counts["attention.plain"] == 5


def test_lora_step_attention_stays_plain(monkeypatch):
    """A bf16 LoRA UNet (the StableSSDNeRF recipe's form, tiny, on
    `meta`): with the LoRA's factors asking for a gradient every attention
    takes the plain path, as the kernel has no backward; the same forward
    under `no_grad` sends every one to the kernel."""
    from mvedit_tpu_torch.models.diffusion import lora as TL
    from mvedit_tpu_torch.models.diffusion import unet as TU
    from mvedit_tpu_torch.utils.profiling import PhaseTimer, set_phase_timer
    seen = []
    for name in ("flash_attention", "_chunked_attention",
                 "attention_reference"):
        monkeypatch.setattr(TA, name,
                            lambda q, k, v, _n=name: seen.append(_n) or q)
    with torch.device("meta"):
        net = TU.UNet2DCondition(TU.UNetConfig(
            block_out_channels=(32, 64), attn_down=(True, False),
            layers_per_block=1, cross_attention_dim=32,
            use_linear_projection=True, head_dim=8, num_heads=0,
            dtype=torch.bfloat16))
    net.requires_grad_(False)
    params = dict(net.named_parameters())
    lora = TL.init_lora(torch.Generator().manual_seed(0), params, rank=4)
    x = torch.empty((2, 16, 8, 4), device="meta")
    t = torch.zeros((2,), dtype=torch.int32, device="meta")
    ctx = torch.empty((2, 7, 32), device="meta")

    def run(grad):
        factors = {k: {f: v.requires_grad_(grad) for f, v in ab.items()}
                   for k, ab in lora.items()}
        seen.clear()
        with torch.set_grad_enabled(grad):
            torch.func.functional_call(
                net, TL.merge_lora(params, factors), (x, t, ctx))
        return list(seen)
    assert run(True) == ["attention_reference"] * 8
    assert run(False) == ["flash_attention"] * 8


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((1, 128, 2, 40))
    with pytest.raises(ValueError):
        FA.flash_attention(q, q[:, :, :1], q)
    with pytest.raises(ValueError):
        FA.flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError):
        FA.flash_attention(q, q.double(), q)


def _bridge_state(params, rename=lambda p: p):
    """Flax params of one attention-side module -> its torch state dict
    (the bridge's leaf rules; module paths mapped by `rename`)."""
    state = {}
    for path, arr in flatten(params).items():
        module, leaf = path.rsplit("/", 1)
        name, a = _leaf(leaf, np.asarray(arr))
        state[f"{rename(module).replace('/', '.')}.{name}"] = \
            torch.from_numpy(np.array(a))
    return state


def _rename_inner(path):
    return (path.replace("to_out_0", "to_out.0")
            .replace("net_0_proj", "net.0.proj").replace("net_2", "net.2")
            .replace("transformer_blocks_", "transformer_blocks/"))


@pytest.mark.parametrize("num_views", [2, 3])
def test_cross_attention_joint_mode(num_views):
    rng = np.random.RandomState(num_views)
    x = rng.standard_normal((2 * num_views, 64, 32)).astype(np.float32)
    mode = JA.AttnMode(num_views=num_views)
    jmod = JA.CrossAttention(32, None, heads=4, dim_head=8)
    params = jmod.init(jax.random.PRNGKey(num_views), x, None,
                       mode=mode)["params"]
    # non-zero output bias so the bridge's bias path is checked too
    params = dict(params, to_out_0=dict(
        params["to_out_0"],
        bias=jnp.asarray(rng.standard_normal(32).astype(np.float32))))
    ref, _ = jmod.apply({"params": params}, x, None, mode=mode)
    tmod = TA.CrossAttention(32, None, heads=4, dim_head=8)
    tmod.load_state_dict(_bridge_state(params, _rename_inner), strict=True)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), None,
                   TA.AttnMode(num_views=num_views))
    _close(out.numpy(), ref)


@pytest.mark.parametrize("use_linear", [False, True])
def test_transformer2d_takes_flash_route(use_linear):
    """Joint 2-view self-attention over 32x32 tokens (L = 2048), a shape
    the card sends to the flash kernel; on the CPU both packages run the
    plain attention there. Both projection forms: 1x1 convs (SD1.5) and
    linear (SD2.x)."""
    rng = np.random.RandomState(7)
    x = rng.standard_normal((2, 32, 32, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, 16)).astype(np.float32)
    mode = JA.AttnMode(num_views=2)
    jmod = JA.Transformer2D(32, heads=4, dim_head=8, context_dim=16,
                            use_linear=use_linear)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32)),
        jmod.init(jax.random.PRNGKey(0), x, ctx, mode=mode)["params"])
    ref, _ = jmod.apply({"params": params}, x, ctx, mode=mode)
    tmod = TA.Transformer2D(32, heads=4, dim_head=8, context_dim=16,
                            use_linear=use_linear)
    tmod.load_state_dict(_bridge_state(params, _rename_inner), strict=True)
    assert TA.uses_flash(2 * 32 * 32, 2 * 32 * 32, 8)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(
            ctx), TA.AttnMode(num_views=2)).permute(0, 2, 3, 1)
    _close(out.numpy(), ref)


# ---- ops/flash_attention: the JAX package's own flash kernel ---------------

def _jax_ops_flash_interpret(monkeypatch):
    """`mvedit_tpu.ops.flash_attention` with its Pallas kernel run in
    interpret mode on the CPU (pallas_call patched, `_flash_fwd` re-jitted);
    nothing in the JAX package changes."""
    import functools

    from jax.experimental import pallas as pl

    import mvedit_tpu.ops.flash_attention as JF
    monkeypatch.setattr(JF.pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))
    monkeypatch.setattr(JF, "_flash_fwd", jax.jit(
        JF._flash_fwd.__wrapped__, static_argnames=("sm_scale",)))
    return JF


@pytest.mark.parametrize("B,Lq,Lk,H,D,scale", [
    (1, 256, 256, 2, 40, 0.1), (1, 128, 1024, 2, 64, None),
    (2, 384, 512, 1, 80, 0.2)])
def test_ops_flash_plain_matches_jax_kernel(monkeypatch, B, Lq, Lk, H, D,
                                            scale):
    """The plain version (what `ops.flash_attention` runs on a CPU tensor)
    against the JAX kernel in interpret mode, from the same bf16-rounded
    inputs; tolerance `FA.agreement` (bf16 P and output, another summation
    order; Lk = 1024 runs the kernel's online softmax over two key
    blocks)."""
    from mvedit_tpu_torch.ops import flash_attention as TOF
    JF = _jax_ops_flash_interpret(monkeypatch)
    rng = np.random.RandomState(Lq + Lk + D)
    q = rng.standard_normal((B, Lq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Lk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Lk, H, D)).astype(np.float32)
    ref = np.asarray(JF.flash_attention(q, k, v, sm_scale=scale))
    before = TOF.flash_fwd.launches
    out = TOF.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              sm_scale=scale)
    assert TOF.flash_fwd.launches == before
    assert out.dtype == torch.float32 and out.shape == (B, Lq, H, D)
    r = FA.agreement(out, torch.from_numpy(ref))
    assert r["ok"], r


@pytest.mark.parametrize("Lq,Lk,D", [(256, 256, 40), (1000, 1024, 40),
                                     (1024, 1000, 40), (128, 128, 128),
                                     (128, 128, 136), (3072, 2560, 64),
                                     (64, 128, 40)])
def test_ops_flash_supported_matches_jax(Lq, Lk, D):
    import mvedit_tpu.ops.flash_attention as JF
    from mvedit_tpu_torch.ops import flash_attention as TOF
    want = JF.supported((1, Lq, D), (1, Lk, D))
    assert TOF.supported((1, Lq, D), (1, Lk, D)) == want
    q = torch.zeros((1, Lq, D), dtype=torch.bfloat16)
    kv = torch.zeros((1, Lk, D), dtype=torch.bfloat16)
    if want:
        assert TOF.flash_fwd(q, kv, kv, 0.1).shape == (1, Lq, D)
    else:
        with pytest.raises(ValueError):
            TOF.flash_fwd(q, kv, kv, 0.1)
