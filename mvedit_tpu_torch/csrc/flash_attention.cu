// Flash attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the TPU kernel `mvedit_tpu/models/diffusion/attention.py::
// _pallas_flash` (the stock Pallas TPU flash attention): non-causal
// softmax(Q K^T / sqrt(D)) V with f32 softmax statistics, used for every
// UNet and ControlNet self-attention longer than 1024 tokens.
//
// Layout: Q, K, V and O are (B, L, H, D) as the JAX package keeps them. The
// kernel reads them through their batch, sequence and head strides (the
// last dimension must be contiguous), so no transpose to (B, H, L, D) is
// made.
//
// Design (a simple kernel that is right; wgmma, TMA and warp
// specialisation are later work):
//  - one CTA of 4 warps per (64-row query tile, head, batch); each warp
//    owns 16 query rows and loops over 64-row K/V tiles;
//  - Q K^T and P V on the tensor cores through mma.sync m16n8k16, bf16
//    inputs and f32 accumulation;
//  - online softmax with f32 running max and sum per row; P is rounded to
//    bf16 for P V; the output is acc / l rounded to bf16;
//  - D is padded with zeros in shared memory to DP, a multiple of 16
//    (D=40 becomes 48), and scores are scaled by 1/sqrt(D) of the real D;
//  - ragged Lq and Lk are masked (rows past L load as zero, keys past Lk
//    score -inf).
//
// What bounds it on an H100: at the path's shapes (L = 4096..24576) it is
// compute-bound, not memory-bound: each K/V tile is reused by all 64 query
// rows of a CTA, and K/V of one head (L x D x 2 bytes, < 4 MB) stay in the
// 50 MB L2. At D=40 the tensor-core work per score is small (4 * 48 flops
// with the padded D), so the per-score exp (about 3.2e9 of them for one
// L=8192 call over 48 (batch, head) pairs) on the special-function units
// costs about as much as the mma work. Later work: exp2 with log2(e)
// folded into the scale, ldmatrix fragment loads, a cp.async or TMA
// double-buffered K/V ring, and wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // query rows per CTA, keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;        // smem row padding (bf16) against bank conflicts

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int H, Lq, Lk, D;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long o_sb, o_sl, o_sh;
  float scale;
  int vec;                     // 1: 16-byte global loads are aligned
};

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Loads 8 consecutive elements of row `row` (columns c..c+7) of a
// (rows, D) slice with row stride `ld`; zeros past D or past `nrows`.
__device__ __forceinline__ void load8(__nv_bfloat16 out[8],
                                      const __nv_bfloat16* base, long long ld,
                                      int row, int nrows, int c, int D,
                                      int vec) {
  if (row < nrows && vec && c + 8 <= D) {
    uint4 u = *reinterpret_cast<const uint4*>(base + row * ld + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = e[i];
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    out[i] = (row < nrows && c + i < D) ? base[row * ld + c + i]
                                        : __float2bfloat16(0.f);
}

// 64 rows x DP columns, row-major into smem with row stride DP + kPad.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          long long ld, int row0, int nrows,
                                          int D, int vec) {
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    int r = i / kChunks, c = (i % kChunks) * 8;
    alignas(16) __nv_bfloat16 e[8];
    load8(e, base, ld, row0 + r, nrows, c, D, vec);
    *reinterpret_cast<uint4*>(dst + r * (DP + kPad) + c) =
        *reinterpret_cast<uint4*>(e);
  }
}

// The same tile stored transposed: dst[d * (kRows + kPad) + r].
template <int DP>
__device__ __forceinline__ void load_tile_t(__nv_bfloat16* dst,
                                            const __nv_bfloat16* base,
                                            long long ld, int row0, int nrows,
                                            int D, int vec) {
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    int r = i % kRows, c = (i / kRows) * 8;
    alignas(16) __nv_bfloat16 e[8];
    load8(e, base, ld, row0 + r, nrows, c, D, vec);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * (kRows + kPad) + r] = e[j];
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int SQ = DP + kPad;
  constexpr int SV = kRows + kPad;
  constexpr int KD = DP / 16;  // k-steps over D in Q K^T
  constexpr int ND = DP / 8;   // n-tiles over D in P V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kRows * SQ;
  __nv_bfloat16* sVt = sK + kRows * SQ;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;

  load_tile<DP>(sQ, qb, p.q_sl, q0, p.Lq, p.D, p.vec);
  __syncthreads();
  uint32_t qf[KD][4];
  {
    const __nv_bfloat16* r0 = sQ + (warp * 16 + g) * SQ + tig * 2;
    const __nv_bfloat16* r1 = r0 + 8 * SQ;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qf[kk][0] = ld32(r0 + kk * 16);
      qf[kk][1] = ld32(r1 + kk * 16);
      qf[kk][2] = ld32(r0 + kk * 16 + 8);
      qf[kk][3] = ld32(r1 + kk * 16 + 8);
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows g and g+8
  float l0 = 0.f, l1 = 0.f;              // this thread's partial row sums

  const int n_tiles = (p.Lk + kRows - 1) / kRows;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<DP>(sK, kb, p.k_sl, k0, p.Lk, p.D, p.vec);
    load_tile_t<DP>(sVt, vb, p.v_sl, k0, p.Lk, p.D, p.vec);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = sK + (j * 8 + g) * SQ + tig * 2;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        mma_bf16(s[j], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = k0 + j * 8 + tig * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale;
        if (col + (e & 1) >= p.Lk) x = -INFINITY;
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every tile holds at least one valid key, so the new max is finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = __expf(s[j][0] - mn0);
      s[j][1] = __expf(s[j][1] - mn0);
      s[j][2] = __expf(s[j][2] - mn1);
      s[j][3] = __expf(s[j][3] - mn1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // P V: the score accumulators of key tiles 2kk and 2kk+1 are exactly
    // the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vr = sVt + (n * 8 + g) * SV + kk * 16 + tig * 2;
        mma_bf16(acc[n], a, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n * 8 + tig * 2 + e;
      if (c < p.D) {
        if (r0 < p.Lq) ob[r0 * p.o_sl + c] = __float2bfloat16(acc[n][e] * inv0);
        if (r1 < p.Lq)
          ob[r1 * p.o_sl + c] = __float2bfloat16(acc[n][2 + e] * inv1);
      }
    }
  }
}

template <int DP>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem =
      (2 * kRows * (DP + kPad) + DP * (kRows + kPad)) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Lq + kRows - 1) / kRows, p.H, B);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mvedit_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Lq, int Lk, int D, long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long o_sb, long long o_sl,
    long long o_sh, float scale, int vec, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sl = o_sl; p.o_sh = o_sh;
  p.scale = scale;
  p.vec = vec;
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return static_cast<int>(launch<16>(p, B, s));
    case 2: return static_cast<int>(launch<32>(p, B, s));
    case 3: return static_cast<int>(launch<48>(p, B, s));
    case 4: return static_cast<int>(launch<64>(p, B, s));
    case 5: return static_cast<int>(launch<80>(p, B, s));
    case 6: return static_cast<int>(launch<96>(p, B, s));
    case 7: return static_cast<int>(launch<112>(p, B, s));
    case 8: return static_cast<int>(launch<128>(p, B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
