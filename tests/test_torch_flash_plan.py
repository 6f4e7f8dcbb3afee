"""The flash-attention wrapper's host-side plan, on the CPU: which inputs
the Hopper kernel's TMA tensor maps read as they are ("direct"), which the
wrapper first copies into aligned bf16 with D padded to a multiple of 8
("staged"), and which raise. `plan` looks only at shapes, dtypes, strides
and addresses, so CPU and `meta` tensors exercise it without a card; the
kernel itself is tested on the card (`test_torch_kernels_cuda.py`).

The staging algebra (zero-padded D, a negative scale folded into a negated
k) is checked against the plain version in float32, exactly up to
float rounding (1e-5)."""
import numpy as np
import pytest
import torch

from mvedit_tpu_torch.kernels import flash_attention as FA
from mvedit_tpu_torch.ops import flash_attention as OF


def _t(shape, dtype=torch.bfloat16, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("shape", [(8, 8192, 8, 40), (8, 2048, 8, 80),
                                   (2, 512, 4, 8), (1, 256, 2, 128),
                                   (3, 77, 2, 24)])
def test_path_layouts_go_direct(device, shape):
    """Contiguous bf16 (B, L, H, D) with D % 8 == 0: the UNet's layout."""
    q = _t(shape, device=device)
    k = _t((shape[0], 1152) + shape[2:], device=device)
    assert FA.plan(q, k, k, shape[-1] ** -0.5) == "direct"


def test_strided_views_go_direct():
    """Every other head of a wider tensor, and ops' (BH, L, 1, D) view:
    strides that are multiples of 8 elements are read as they are."""
    wide = _t((2, 1152, 16, 40), device="meta")
    q = wide[:, :, ::2]
    assert FA.plan(q, q, q, 0.1) == "direct"
    bhld = _t((48, 1024, 40))
    v = bhld[:, :, None]
    assert FA.plan(v, v, v, 0.1) == "direct"
    # a stride of a size-1 dimension is never followed, nor checked
    odd = torch.as_strided(_t((1, 64, 1, 40)), (1, 64, 1, 40),
                           (3, 40, 5, 1))
    assert FA.plan(odd, odd, odd, 0.1) == "direct"


@pytest.mark.parametrize("make", [
    lambda: _t((2, 128, 2, 33)),                            # D % 8 != 0
    lambda: _t((2, 128, 2, 1)),
    lambda: _t((2, 128, 2, 40), torch.float32),             # another dtype
    lambda: _t((2, 128, 2, 40), torch.float16),
    lambda: _t(2 * 128 * 2 * 40 + 1)[1:].view(2, 128, 2, 40),   # offset 1
    lambda: _t(2 * 128 * 2 * 40 + 4, device="meta")[4:].view(
        2, 128, 2, 40),                                     # 8 bytes off
    lambda: _t((2, 128, 40, 2)).transpose(2, 3),            # D not inner
    lambda: _t((2, 128, 3, 44))[..., :40],                  # head stride 44
])
def test_other_inputs_are_staged(make):
    q = make()
    k = torch.zeros_like(q) if q.device.type == "meta" else q.clone()
    assert FA.plan(q, k, k, 0.1) == "staged"
    # one misaligned operand is enough
    good = _t(q.shape, q.dtype, q.device)
    assert FA.plan(good, good, q, 0.1) == "staged"


def test_scale_sign():
    q = _t((1, 256, 2, 40))
    assert FA.plan(q, q, q, 0.0) == "direct"
    assert FA.plan(q, q, q, -0.1) == "staged"


@pytest.mark.parametrize("make,exc", [
    (lambda: (_t((1, 128, 2, 136)),) * 3, ValueError),        # D > 128
    (lambda: (_t((1, 128, 2, 40), torch.float64),) * 3, TypeError),
    (lambda: (_t((1, 128, 2, 40)), _t((1, 128, 2, 48)), _t((1, 128, 2, 48))),
     ValueError),                                             # D differs
    (lambda: (_t((1, 128, 2, 40)), _t((1, 128, 4, 40)), _t((1, 128, 4, 40))),
     ValueError),                                             # H differs
    (lambda: (_t((2, 128, 2, 40)), _t((1, 128, 2, 40)), _t((1, 128, 2, 40))),
     ValueError),                                             # B differs
    (lambda: (_t((1, 128, 2, 40)), _t((1, 128, 2, 40)), _t((1, 64, 2, 40))),
     ValueError),                                             # k != v
    (lambda: (_t((128, 2, 40)),) * 3, ValueError),            # not 4-D
    (lambda: (_t((1, 0, 2, 40)),) * 3, ValueError),           # empty
    (lambda: (_t((65536, 1, 1, 8), device="meta"),) * 3, ValueError),
])
def test_unsupported_inputs_raise(make, exc):
    with pytest.raises(exc):
        FA.plan(*make(), 0.1)


def test_size_one_strides_are_normalised():
    """TMA wants every stride a multiple of 16 bytes: size-1 dimensions
    get contiguous ones."""
    v = _t((48, 1024, 40))[:, :, None]
    assert FA._strides(v) == (1024 * 40, 40, 40)
    odd = torch.as_strided(_t((1, 64, 1, 40)), (1, 64, 1, 40),
                           (3, 40, 5, 1))
    assert FA._strides(odd) == (64 * 40, 40, 40)
    q = _t((2, 64, 3, 40))[:, :, ::2]
    assert FA._strides(q) == (64 * 3 * 40, 3 * 40, 80)


def test_cpu_tensors_take_the_plain_version():
    """`flash_attention` on the CPU is the plain version and counts no
    launch; the bare `launch` refuses a CPU tensor."""
    g = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(g.standard_normal((1, 64, 2, 40)).astype(
        np.float32)).bfloat16() for _ in range(3))
    before, staged = FA.flash_attention.launches, FA.launch.staged
    out = FA.flash_attention(q, k, v)
    assert torch.equal(out, FA.attention_reference(q, k, v))
    assert FA.flash_attention.launches == before
    with pytest.raises(ValueError):
        FA.launch(q, k, v, 0.1)
    assert FA.launch.staged == staged


@pytest.mark.parametrize("D,scale", [(33, 0.2), (40, -0.15), (5, -1.0)])
def test_staging_algebra(D, scale):
    """What the wrapper hands the kernel for a staged call computes the
    same attention: D zero-padded to a multiple of 8 changes no score, and
    softmax(q k^T s) = softmax(q (-k)^T |s|) for s < 0."""
    g = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(g.standard_normal((2, 96, 3, D)).astype(
        np.float32)) for _ in range(3))
    Dp = -(-D // 8) * 8
    qs, vs = FA._stage(q, Dp), FA._stage(v, Dp)
    ks = FA._stage(k, Dp, -1.0 if scale < 0 else 1.0)
    assert qs.dtype == torch.bfloat16 and qs.shape[-1] == Dp
    assert qs.is_contiguous() and not qs[..., D:].any()

    def bhld(t):
        return t.float().transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])
    want = OF.flash_reference(bhld(q.bfloat16()), bhld(k.bfloat16()),
                              bhld(v.bfloat16()), scale)
    got = OF.flash_reference(bhld(qs), bhld(ks), bhld(vs), abs(scale))
    np.testing.assert_allclose(got[..., :D].numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)
