"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked `gpu`: without a CUDA device each test skips with its
reason (a CUDA kernel has no CPU or interpret mode). On a GPU machine
(`--noconftest`: the suite's conftest pins JAX to the CPU, and the port's
machine needs no JAX):

    python -m pytest tests/test_torch_kernels_cuda.py -q -m gpu --noconftest

Tolerance: `FA.agreement`, which bounds max|d| and mean|d| relative to
the plain version's magnitude (from the same bf16 inputs): both round P
and the output to bf16 (eps 2^-8) at other points and sum in another
order. The bounds fail a kernel that scales by 1/sqrt(padded D) or leaves
ragged keys unmasked.
"""
import pytest
import torch

from mvedit_tpu_torch.kernels import flash_attention as FA

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("qk", [1.0, 2.0])
@pytest.mark.parametrize("shape", [(2, 4096, 8, 40), (2, 2048, 8, 80),
                                   (1, 1024, 4, 64), (1, 512, 2, 128),
                                   (1, 1000, 8, 40), (2, 200, 8, 40),
                                   (3, 77, 2, 24)])
def test_flash_attention_matches_plain(cuda, shape, qk):
    """N(0,1) inputs (nearly uniform attention), and q, k scaled by 2 (a
    peaked softmax)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    q, k = q * qk, k * qk
    before = FA.flash_attention.launches
    out = FA.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    r = FA.agreement(out, FA.attention_reference(q, k, v))
    assert r["ok"], r


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_strided(cuda, dtype):
    """Q read through strides (every other head of a wider tensor; bf16
    reaches the kernel as it is) and an f32 caller, which the wrapper
    casts to bf16 and back, as the TPU kernel's caller does."""
    g = torch.Generator(device=cuda).manual_seed(1)
    wide = torch.randn((2, 1152, 16, 40), generator=g, device=cuda,
                       dtype=dtype)
    q = wide[:, :, ::2]
    k, v = (torch.randn((2, 1152, 8, 40), generator=g, device=cuda,
                        dtype=dtype) for _ in range(2))
    out = FA.flash_attention(q, k, v)
    assert out.dtype == dtype and out.shape == q.shape
    ref = FA.attention_reference(*(t.bfloat16() for t in (q, k, v)))
    r = FA.agreement(out, ref)
    assert r["ok"], r


def test_flash_attention_rejects(cuda):
    q = torch.zeros((1, 128, 2, 136), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q)
    q = torch.zeros((1, 128, 2, 40), device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        FA.flash_attention(q, q, q)
