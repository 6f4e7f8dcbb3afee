"""The yardstick: the H100's published peaks and the least time of one call
of each measured entry, frozen copies of the port's chip smoke's
`flash_bound` and `segment_bound`.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): bf16 and
fp16 tensor cores 989 TFLOP/s, float32 outside them 67 TFLOP/s, HBM 3.35
TB/s; the exp floor of attention is the special-function units' rate,
16 per clock per SM x 132 SMs x ~1.83 GHz.
"""
import torch

__all__ = ["PEAK_BF16", "PEAK_F32", "PEAK_BYTES", "PEAK_EXP",
           "flash_bound_s", "segment_bound_s"]

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_EXP = 3.9e12


def flash_bound_s(B, Lq, Lk, H, D, elt=2):
    """Least time of one attention call: the largest of the tensor-core
    time of its 4 B H Lq Lk D FLOPs, its B H Lq Lk exponentials and its
    bytes (q, k, v read once, o written once)."""
    mma = 4.0 * B * H * Lq * Lk * D / PEAK_BF16
    exp = 1.0 * B * H * Lq * Lk / PEAK_EXP
    nbytes = float(elt) * B * H * D * (2 * Lq + 2 * Lk)
    return max(mma, exp, nbytes / PEAK_BYTES)


def segment_bound_s(n, rows, C, elt, idx_elt, out_elt=4):
    """Least time of one segment sum: its bytes (the targets and the values
    read once, the output written once) at the memory rate; its n C adds
    take far less."""
    nbytes = float(idx_elt) * n + float(n) * C * elt \
        + float(out_elt) * rows * C
    return max(n * C / PEAK_F32, nbytes / PEAK_BYTES)


def attention_call_bound(sig):
    """`flash_bound_s` of one recorded `dot_product_attention` call (its
    signature: q, k, v as (B, L, H, D))."""
    (q, k, _), _ = _tensors(sig)
    B, Lq, H, D = q[1]
    Lk = k[1][1]
    return flash_bound_s(B, Lq, Lk, H, D, _elt(q[2]))


def segment_call_bound(sig):
    """`segment_bound_s` of one recorded `segment_sum(idx, vals, size,
    out_dtype)` call, with a bf16 output written in 2 bytes."""
    (idx, vals, size), kw = _tensors(sig)
    n, C = vals[1]
    out = kw.get("out_dtype", ("Y", "torch.float32"))
    return segment_bound_s(n, size, C, _elt(vals[2]), _elt(idx[2]),
                           _elt(out[1]))


def _tensors(sig):
    args, kwargs = sig
    a = tuple(args[1:]) if args and args[0] == "U" else args
    kw = dict(kwargs[1:]) if kwargs and kwargs[0] == "D" else {}
    return a, kw


def _elt(dtype_name):
    dt = getattr(torch, dtype_name.split(".")[-1])
    return torch.empty((), dtype=dt).element_size()
