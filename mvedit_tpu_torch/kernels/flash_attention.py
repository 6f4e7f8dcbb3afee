"""Flash attention forward: the hand-written Hopper kernel and its plain
PyTorch version.

`flash_attention(q, k, v)` is the counterpart of
`mvedit_tpu/models/diffusion/attention.py::_pallas_flash`: (B, Lq, H, D) x
(B, Lk, H, D) -> (B, Lq, H, D), non-causal, scale 1/sqrt(D), computed in
bf16 with f32 softmax statistics and returned in the input dtype.

- CUDA tensors launch `csrc/flash_attention.cu` (sm_90a: TMA, wgmma, warp
  specialisation), `LIBRARY` (built and bound by `library.py` at first
  use). A build or launch failure raises; nothing falls back.
- CPU tensors take `attention_reference`, the plain version, in their own
  dtype (the JAX package likewise runs its plain attention on the CPU).

The kernel reads bf16 (B, L, H, D) through TMA tensor maps, which need
D % 8 == 0, 16-byte aligned bases and strides that are multiples of 8
elements. `plan(q, k, v, scale)` says, on the host alone (CPU and `meta`
tensors too), whether inputs go to the kernel as they are ("direct") or
through an aligned bf16 copy with D padded to a multiple of 8 ("staged"),
and raises for what the kernel cannot take. `launch.staged` counts the
launches that needed the copy; the UNet's attention needs none.

`flash_attention.launches` counts kernel launches, so a run can show that
its attention went through the kernel. `launch(q, k, v, scale)` is the
bare entry with a caller-given scale, which `ops/flash_attention.py` (the
JAX package's own flash API) also uses, with its own count.
`agreement(out, ref)` is the check that holds the kernel against its
plain version.
"""
import ctypes

import torch

from .library import Library, nvcc, on_stream

__all__ = ["flash_attention", "launch", "plan", "attention_reference",
           "agreement", "LIBRARY", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 128
# Kernel against the plain version from the same bf16 inputs, relative to
# the reference's own magnitude (with N(0,1) inputs attention is nearly
# uniform and the outputs are small, ~1/sqrt(L)): P and the output round to
# bf16 in both, at other points (the kernel rounds the unnormalised P), and
# the sums run in another order. The bounds sit a few times above the
# errors of the sound kernel and below those of a kernel that scales by
# 1/sqrt(padded D) or leaves ragged keys unmasked (PERF.md, Findings).
MEAN_REL_TOL = 6e-3     # mean|d| / mean|ref|
MAX_REL_TOL = 2e-2      # max|d| / max|ref|


def _bind(lib):
    fn = lib.mvedit_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = Library("flash_attention", "flash_attention.cu", nvcc(), _bind)


def attention_reference(q, k, v):
    """Plain attention with `_manual_attention` semantics
    (`mvedit_tpu/models/diffusion/attention.py:47`): f32 scores and
    softmax, probabilities cast to v's dtype, f32 accumulation of P V."""
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (D ** -0.5)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(),
                        v.float()).to(q.dtype)


def agreement(out, ref):
    """Errors of `out` against the plain version's `ref`: a dict with the
    absolute and relative (to the reference's magnitude) max and mean
    errors, and `ok` when both relative errors are within bounds and `out`
    is finite."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    r = dict(max_abs=err.max().item(), mean_abs=err.mean().item(),
             ref_max=ref.abs().max().item(), ref_mean=ref.abs().mean().item())
    r["max_rel"] = r["max_abs"] / r["ref_max"]
    r["mean_rel"] = r["mean_abs"] / r["ref_mean"]
    r["ok"] = bool(torch.isfinite(out).all().item()
                   and r["max_rel"] <= MAX_REL_TOL
                   and r["mean_rel"] <= MEAN_REL_TOL)
    return r


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, L, H, D), got "
                             f"{tuple(t.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q, k and v must share device and dtype")
    B, Lq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Lq < 1 or k.shape[1] < 1 or D < 1:
        raise ValueError("empty attention")


def flash_attention(q, k, v):
    """(B, Lq, H, D) x (B, Lk, H, D) -> (B, Lq, H, D), see module doc."""
    if q.device.type == "cpu":
        _check(q, k, v)
        return attention_reference(q, k, v)
    out = launch(q, k, v, q.shape[-1] ** -0.5)
    flash_attention.launches += 1
    return out


def _direct(t):
    """True when the kernel's tensor maps can read bf16 `t` as it is."""
    D = t.shape[-1]
    if t.dtype != torch.bfloat16 or D % 8 or t.stride(3) != 1 \
            or t.data_ptr() % 16:
        return False
    # a stride of a size-1 dimension is never followed
    return all(n == 1 or (s > 0 and s % 8 == 0)
               for n, s in zip(t.shape[:3], t.stride()[:3]))


def plan(q, k, v, scale):
    """"direct" or "staged" for `launch(q, k, v, scale)`, decided from
    shapes, dtypes, strides and addresses alone; raises ValueError or
    TypeError for inputs the kernel does not take."""
    _check(q, k, v)
    if q.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"unsupported dtype {q.dtype}")
    B, Lq, H, D = q.shape
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}")
    if B > 65535 or H > 65535:
        raise ValueError(f"grid too large: B {B}, H {H}")
    # a negative scale is folded into a negated copy of k, so that the
    # kernel's running max is taken over scores that rise with the logits
    ok = scale >= 0 and all(_direct(t) for t in (q, k, v))
    return "direct" if ok else "staged"


def _stage(t, Dp, sign=1.0):
    """Aligned, contiguous bf16 copy of `t` with D zero-padded to Dp."""
    out = torch.zeros(t.shape[:3] + (Dp,), dtype=torch.bfloat16,
                      device=t.device)
    out[..., :t.shape[-1]] = t * sign if sign != 1.0 else t
    return out


def _strides(t):
    """(batch, sequence, head) strides, with those of size-1 dimensions
    replaced by contiguous ones (TMA wants multiples of 16 bytes)."""
    B, L, H, D = t.shape
    dense = (L * H * D, H * D, D)
    return tuple(d if n == 1 else s
                 for n, s, d in zip(t.shape[:3], t.stride()[:3], dense))


def launch(q, k, v, scale, lib=None):
    """Launch the kernel on CUDA tensors (B, Lq, H, D) x (B, Lk, H, D) with
    softmax scale `scale`; returns (B, Lq, H, D) in q's dtype. Counts
    nothing but staged copies: each public wrapper keeps its own launch
    count. `lib` is a loaded library to launch instead of `LIBRARY` (an
    edited source built alike, timed against it)."""
    how = plan(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    dt = q.dtype
    Dp = -(-D // 8) * 8
    if how == "staged":
        # the TPU kernel runs in bf16 and casts back (attention.py:139-144)
        q, v = _stage(q, Dp), _stage(v, Dp)
        k = _stage(k, Dp, -1.0 if scale < 0 else 1.0)
        scale = abs(scale)
        launch.staged += 1
    out = torch.empty((B, Lq, H, Dp), dtype=torch.bfloat16, device=q.device)
    lib = LIBRARY.load() if lib is None else lib
    err = on_stream(q.device, lib.mvedit_flash_attention_fwd,
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, H, Lq, Lk, Dp, *_strides(q), *_strides(k),
                    *_strides(v), *out.stride()[:3], float(scale))
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    if Dp != D:
        out = out[..., :D].contiguous()
    return out.to(dt)


launch.staged = 0
flash_attention.launches = 0
