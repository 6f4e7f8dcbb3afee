"""Forward flash attention with a caller-given softmax scale (counterpart of
`mvedit_tpu/ops/flash_attention.py`, the JAX package's own flash kernel
`_flash_fwd` and its wrapper `flash_attention`).

- `flash_attention(q, k, v, sm_scale=None)`: (B, L, H, D) -> (B, Lq, H, D)
  in q's dtype, computed in bf16 with f32 softmax statistics.
- `flash_fwd(q, k, v, sm_scale)`: the kernel-level API on (BH, L, D) bf16.
- `supported(q_shape, k_shape)`: the shapes the JAX kernel's block picker
  takes (D <= 128, Lq a multiple of 128..1024, Lk of 128..512); both
  functions raise ValueError on any other shape, as the JAX wrapper fails.

CUDA tensors launch the hand-written kernel of
`csrc/flash_attention.cu` (the same entry point as
`kernels/flash_attention.py`, which takes the scale and the strides: a
(BH, L, D) tensor is read as (BH, L, 1, D)). CPU tensors take
`flash_reference`, the plain version of `_kernel`'s math: f32 scores, P
rounded to bf16 before P V, the output divided by max(l, 1e-30).
`flash_fwd.launches` counts this API's kernel launches.
"""
import torch

from ..kernels import flash_attention as FA

__all__ = ["flash_attention", "flash_fwd", "flash_reference", "supported"]


def _pick_block(n, cap):
    for b in (cap, 1024, 512, 256, 128):
        if b <= cap and n % b == 0:
            return b
    return None


def supported(q_shape, k_shape):
    """Static check: the shapes the kernel handles."""
    Lq, D = q_shape[-2], q_shape[-1]
    Lk = k_shape[-2]
    return (D <= 128 and _pick_block(Lq, 1024) is not None
            and _pick_block(Lk, 512) is not None)


def flash_reference(q, k, v, sm_scale):
    """Plain version on (BH, L, D): softmax(q k^T * sm_scale) v with f32
    statistics, bf16 P into P V, division by max(l, 1e-30)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    pv = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    return (pv / l.clamp(min=1e-30)).to(q.dtype)


def flash_fwd(q, k, v, sm_scale):
    """q (BH, Lq, D), k / v (BH, Lk, D) bf16 -> (BH, Lq, D)."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not supported(q.shape, k.shape):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if q.device.type == "cpu":
        return flash_reference(q, k, v, sm_scale)
    out = FA.launch(q[:, :, None], k[:, :, None], v[:, :, None],
                    sm_scale)[:, :, 0]
    flash_fwd.launches += 1
    return out


flash_fwd.launches = 0


def flash_attention(q, k, v, sm_scale=None):
    """(B, L, H, D) attention -> (B, Lq, H, D) in q's dtype."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / (D ** 0.5)

    def to_bhld(t, L):
        return t.to(torch.bfloat16).transpose(1, 2).reshape(B * H, L, D)
    out = flash_fwd(to_bhld(q, Lq), to_bhld(k, Lk), to_bhld(v, Lk), scale)
    return out.reshape(B, H, Lq, D).transpose(1, 2).to(q.dtype)
