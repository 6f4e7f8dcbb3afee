"""Flash attention forward: the hand-written Hopper kernel and its plain
PyTorch version.

`flash_attention(q, k, v)` is the counterpart of
`mvedit_tpu/models/diffusion/attention.py::_pallas_flash`: (B, Lq, H, D) x
(B, Lk, H, D) -> (B, Lq, H, D), non-causal, scale 1/sqrt(D), computed in
bf16 with f32 softmax statistics and returned in the input dtype.

- CUDA tensors launch `csrc/flash_attention.cu` (sm_90a), built with nvcc
  at first use into `_build/` and bound through ctypes. A build or launch
  failure raises; nothing falls back.
- CPU tensors take `attention_reference`, the plain version, in their own
  dtype (the JAX package likewise runs its plain attention on the CPU).

`flash_attention.launches` counts kernel launches, so a run can show that
its attention went through the kernel. `launch(q, k, v, scale)` is the
bare entry with a caller-given scale, which `ops/flash_attention.py` (the
JAX package's own flash API) also uses, with its own count.
`agreement(out, ref)` is the check that holds the kernel against its
plain version.
"""
import ctypes
import os
import subprocess
import threading

import torch

__all__ = ["flash_attention", "launch", "attention_reference", "agreement",
           "build", "MAX_HEAD_DIM"]

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

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "csrc", "flash_attention.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB = os.path.join(_BUILD_DIR, "libmvedit_flash_attention.so")
BUILD_LOG = os.path.join(_BUILD_DIR, "flash_attention.nvcc.log")
_lib = None
_lib_lock = threading.Lock()


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


def build():
    """Compile the kernel (if its library is missing or older than the
    source) and load it. Returns the ctypes library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            from torch.utils.cpp_extension import CUDA_HOME
            if CUDA_HOME is None:
                raise RuntimeError("no CUDA toolkit found to build "
                                   "flash_attention.cu")
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{_LIB}.{os.getpid()}.tmp"
            cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"),
                   "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas=-v", "-o", tmp, _SRC]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                   f"{res.stdout}\n{res.stderr}")
            # ptxas' registers / shared memory / spills per instantiation
            with open(BUILD_LOG, "w") as f:
                f.write(res.stdout + res.stderr)
            os.replace(tmp, _LIB)
        lib = ctypes.CDLL(_LIB)
        fn = lib.mvedit_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
        return lib


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
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    out = launch(q, k, v, q.shape[-1] ** -0.5)
    flash_attention.launches += 1
    return out


def launch(q, k, v, scale):
    """Launch the kernel on CUDA tensors (B, Lq, H, D) x (B, Lk, H, D) with
    softmax scale `scale`; returns (B, Lq, H, D) in q's dtype. Counts
    nothing: each public wrapper keeps its own launch count."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"unsupported dtype {q.dtype}")
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}")
    dt = q.dtype
    # the TPU kernel runs in bf16 and casts back (attention.py:139-144)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    vec = int(D % 8 == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
        for t in (q, k, v)))
    out = torch.empty((B, Lq, H, D), dtype=torch.bfloat16, device=q.device)
    lib = build()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mvedit_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, Lq, Lk, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            float(scale), vec, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return out.to(dt)


flash_attention.launches = 0
