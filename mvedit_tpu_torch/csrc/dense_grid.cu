// Dense-grid encode for Hopper (sm_90a): the multi-resolution feature
// volume of `ops/dense_grid.py`, every level of every point in one launch.
//
// For a point x in [0, 1]^3 (clipped) and a level of resolution R, with
// pos = x R, p0 = floor(pos), t = pos - p0 and w = t t (3 - 2 t)
// (smoothstep) or t (linear), the level's F features are
//   sum over the 8 corners (ox, oy, oz) in {0, 1}^3, x slowest, z fastest,
//   of row(min(p0 + o, R)) * (ax * ay) * az,  a = w where o = 1, else 1 - w,
// where row(i, j, k) is row (i (R + 1) + j) (R + 1) + k of the level's
// ((R + 1)^3, F) table, rounded to bf16 and widened back to float32 (the
// gather dtype; float32 rows are read as they are). The output is
// (N, L F) float32, level-major along a row.
//
// Bits: every operation is the plain version's, in its order, each
// rounded on its own (the library is built with -fmad=false, so no add
// and multiply fuse): pos, floor, t, t t, 2 t, 3 - 2 t, w, 1 - w, the
// corner weight (a b) c, each corner's widened row times its weight, and
// acc = v0 w0, then acc + v1 w1, ... in corner order. clip is the plain
// version's maximum / minimum, which keep a NaN. So the forward has the
// plain version's bits on the card. A NaN coordinate, whose int64 index
// the plain gather rejects there, takes index 0: the point's features are
// NaN, and its corners' rows take NaN gradients.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 3.35 TB/s): bytes.
// A point reads 12 B and writes 4 L F B; its 8 L corner rows come from L2
// or from DRAM at sector granularity (level 0 of the (32, 160) grid is
// 575 KB in bf16; the samples along a ray fall in neighbouring cells).
//
// The backward recomputes the corners from x:
//  - the table's gradient: the int32 target of each corner (L, N 8) and
//    its contribution, the output gradient times the corner weight
//    rounded to the gather dtype (L, N 8, F), sample-major and corner-minor
//    as the plain gather's gradient; the wrapper sums them with the
//    fixed-order segment sum (`kernels/segment_sum.py`), no atomics;
//  - x's gradient, per point (no reduction across points): for each level
//    s_k = sum_f g_f v_kf, gw_d = sum_k (+-1) s_k (the other two weights'
//    product), times dw/dt = 6 t (1 - t) (or 1) and R; summed over the
//    levels, then times clip's gradient (1 inside, 0.5 on a bound, 0
//    outside). The order differs from autograd's, so the bits may too.
//
// Each C entry launches one kernel on the caller's stream (no host sync,
// no allocation) and returns the launch's error code.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

// how a table's rows are read: bf16 rows; float32 rows rounded to bf16 in
// registers (the bf16 gather of a float32 table); float32 rows as they are
enum RowMode { kBf16 = 0, kF32ToBf16 = 1, kF32 = 2 };

struct Levels {
  const void* table[kMaxLevels];
  int res[kMaxLevels];
  int n;
};

// the plain version's clip: minimum(maximum(x, 0), 1), a NaN kept
__device__ __forceinline__ float clip01(float x) {
  if (x != x) return x;
  return fminf(fmaxf(x, 0.f), 1.f);
}

// one level's cell of a point: the 8 corners' rows and the weights
template <bool kSmooth>
struct Cell {
  int row[8];
  float t[3], w[3];

  __device__ __forceinline__ Cell(const float (&x)[3], int res) {
    const int side = res + 1;
    int i0[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float pos = x[d] * (float)res;
      const float p0 = floorf(pos);
      t[d] = pos - p0;
      w[d] = kSmooth ? (t[d] * t[d]) * (3.f - 2.f * t[d]) : t[d];
      // Tensor.long() of the floor, clamped into the grid: a NaN gives
      // -2^63 there, whose plain gather asserts; here its index is 0 (its
      // weights are NaN, so its features are NaN whatever it reads)
      const long long q = (long long)p0;
      i0[d] = q < 0 ? 0 : (int)(q < res ? q : res);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int ix = min(i0[0] + (k >> 2), res);
      const int iy = min(i0[1] + ((k >> 1) & 1), res);
      const int iz = min(i0[2] + (k & 1), res);
      row[k] = (ix * side + iy) * side + iz;
    }
  }

  // corner k's weight, (a b) c as the plain version multiplies
  __device__ __forceinline__ float weight(int k) const {
    const float a = (k >> 2) ? w[0] : 1.f - w[0];
    const float b = ((k >> 1) & 1) ? w[1] : 1.f - w[1];
    const float c = (k & 1) ? w[2] : 1.f - w[2];
    return (a * b) * c;
  }
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// row r of a table, widened to float32 as the plain gather then .float()
template <int kMode, int F>
__device__ __forceinline__ void load_row(const void* table, int r,
                                         float (&v)[F]) {
  if (kMode == kBf16) {
    const uint4* p = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(table) + (long long)r * F);
#pragma unroll
    for (int q = 0; q < F / 8; ++q) {
      const uint4 u = __ldg(p + q);
      const unsigned h[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[8 * q + 2 * j] = __uint_as_float(h[j] << 16);
        v[8 * q + 2 * j + 1] = __uint_as_float(h[j] & 0xffff0000u);
      }
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(table) + (long long)r * F);
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 u = __ldg(p + q);
      const float h[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[4 * q + j] = kMode == kF32ToBf16 ? round_bf16(h[j]) : h[j];
    }
  }
}

__device__ __forceinline__ void load_point(const float* __restrict__ x,
                                           long long i, float (&p)[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) p[d] = clip01(__ldg(x + 3 * i + d));
}

template <int kMode, int F, bool kSmooth>
__global__ void __launch_bounds__(kThreads)
encode_forward(const float* __restrict__ x, long long n, Levels lv,
               float* __restrict__ out) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  float p[3];
  load_point(x, i, p);
  float* o = out + i * lv.n * F;
  for (int l = 0; l < lv.n; ++l) {
    const Cell<kSmooth> c(p, lv.res[l]);
    // the 8 rows first: their loads in flight together
    float v[8][F];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      load_row<kMode, F>(lv.table[l], c.row[k], v[k]);
    float acc[F];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float wc = c.weight(k);
#pragma unroll
      for (int f = 0; f < F; ++f)
        acc[f] = k == 0 ? v[k][f] * wc : acc[f] + v[k][f] * wc;
    }
    float4* q = reinterpret_cast<float4*>(o + l * F);
#pragma unroll
    for (int f = 0; f < F / 4; ++f)
      q[f] = make_float4(acc[4 * f], acc[4 * f + 1], acc[4 * f + 2],
                         acc[4 * f + 3]);
  }
}

// a corner's contribution to the table's gradient, in the gather dtype
template <int kMode, int F>
__device__ __forceinline__ void store_contrib(void* contrib, long long j,
                                              const float (&g)[F], float wc) {
  if (kMode == kF32) {
    float4* q =
        reinterpret_cast<float4*>(static_cast<float*>(contrib) + j * F);
#pragma unroll
    for (int f = 0; f < F / 4; ++f)
      q[f] = make_float4(g[4 * f] * wc, g[4 * f + 1] * wc, g[4 * f + 2] * wc,
                         g[4 * f + 3] * wc);
  } else {
    uint4* q = reinterpret_cast<uint4*>(
        static_cast<__nv_bfloat16*>(contrib) + j * F);
#pragma unroll
    for (int f = 0; f < F / 8; ++f) {
      unsigned h[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const unsigned lo = __bfloat16_as_ushort(
            __float2bfloat16_rn(g[8 * f + 2 * m] * wc));
        const unsigned hi = __bfloat16_as_ushort(
            __float2bfloat16_rn(g[8 * f + 2 * m + 1] * wc));
        h[m] = lo | (hi << 16);
      }
      q[f] = make_uint4(h[0], h[1], h[2], h[3]);
    }
  }
}

template <int kMode, int F, bool kSmooth>
__global__ void __launch_bounds__(kThreads)
encode_backward(const float* __restrict__ x, long long n, Levels lv,
                const float* __restrict__ grad, int* __restrict__ targets,
                void* __restrict__ contrib, float* __restrict__ gx) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  float raw[3], p[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    raw[d] = __ldg(x + 3 * i + d);
    p[d] = clip01(raw[d]);
  }
  float gp[3] = {0.f, 0.f, 0.f};
  for (int l = 0; l < lv.n; ++l) {
    const int res = lv.res[l];
    const Cell<kSmooth> c(p, res);
    float g[F];
    const float4* gr = reinterpret_cast<const float4*>(
        grad + (i * lv.n + l) * F);
#pragma unroll
    for (int f = 0; f < F / 4; ++f) {
      const float4 u = __ldg(gr + f);
      g[4 * f] = u.x;
      g[4 * f + 1] = u.y;
      g[4 * f + 2] = u.z;
      g[4 * f + 3] = u.w;
    }
    if (targets != nullptr) {
      int4* tq = reinterpret_cast<int4*>(targets + (l * n + i) * 8);
      tq[0] = make_int4(c.row[0], c.row[1], c.row[2], c.row[3]);
      tq[1] = make_int4(c.row[4], c.row[5], c.row[6], c.row[7]);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        store_contrib<kMode, F>(contrib, (l * n + i) * 8 + k, g, c.weight(k));
    }
    if (gx != nullptr) {
      float gw[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float v[F];
        load_row<kMode, F>(lv.table[l], c.row[k], v);
        float s = 0.f;
#pragma unroll
        for (int f = 0; f < F; ++f) s += g[f] * v[f];
        const float a = (k >> 2) ? c.w[0] : 1.f - c.w[0];
        const float b = ((k >> 1) & 1) ? c.w[1] : 1.f - c.w[1];
        const float e = (k & 1) ? c.w[2] : 1.f - c.w[2];
        gw[0] += (k >> 2) ? s * (b * e) : -(s * (b * e));
        gw[1] += ((k >> 1) & 1) ? s * (a * e) : -(s * (a * e));
        gw[2] += (k & 1) ? s * (a * b) : -(s * (a * b));
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float dw = kSmooth ? 6.f * c.t[d] * (1.f - c.t[d]) : 1.f;
        gp[d] += gw[d] * dw * (float)res;
      }
    }
  }
  if (gx != nullptr) {
    // clip's gradient: maximum's and minimum's, each halved at a tie
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float r = raw[d];
      gx[3 * i + d] = (r < 0.f || r > 1.f) ? 0.f
                      : (r == 0.f || r == 1.f) ? 0.5f * gp[d] : gp[d];
    }
  }
}

template <int kMode, int F>
int launch(const float* x, long long n, const Levels& lv, int smooth,
           const float* grad, int* targets, void* contrib, float* gx,
           float* out, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (out != nullptr) {
    if (smooth)
      encode_forward<kMode, F, true><<<blocks, kThreads, 0, s>>>(x, n, lv, out);
    else
      encode_forward<kMode, F, false><<<blocks, kThreads, 0, s>>>(x, n, lv,
                                                                 out);
  } else if (smooth) {
    encode_backward<kMode, F, true><<<blocks, kThreads, 0, s>>>(
        x, n, lv, grad, targets, contrib, gx);
  } else {
    encode_backward<kMode, F, false><<<blocks, kThreads, 0, s>>>(
        x, n, lv, grad, targets, contrib, gx);
  }
  return (int)cudaGetLastError();
}

int dispatch(const float* x, long long n, int levels,
             const void* const* tables, const int* res, int mode, int F,
             int smooth, const float* grad, int* targets, void* contrib,
             float* gx, float* out, cudaStream_t s) {
  if (n < 0 || (n + kThreads - 1) / kThreads > 0x7fffffffLL ||
      levels < 1 || levels > kMaxLevels || F != 8 || mode < kBf16 ||
      mode > kF32)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = levels;
  for (int l = 0; l < levels; ++l) {
    const long long side = (long long)res[l] + 1;
    if (res[l] < 1 || side * side * side > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    lv.table[l] = tables[l];
    lv.res[l] = res[l];
  }
  if (n == 0) return (int)cudaSuccess;
  switch (mode) {
    case kBf16:
      return launch<kBf16, 8>(x, n, lv, smooth, grad, targets, contrib, gx,
                              out, s);
    case kF32ToBf16:
      return launch<kF32ToBf16, 8>(x, n, lv, smooth, grad, targets, contrib,
                                   gx, out, s);
    default:
      return launch<kF32, 8>(x, n, lv, smooth, grad, targets, contrib, gx,
                             out, s);
  }
}

}  // namespace

// x (n, 3) float32 -> out (n, levels F) float32; tables[l] the level's
// ((res[l] + 1)^3, F) rows in `mode`'s dtype, 16-byte aligned
extern "C" int mvedit_dense_grid_forward(const void* x, long long n,
                                         int levels, const void* const* tables,
                                         const int* res, int mode, int F,
                                         int smooth, void* out, void* stream) {
  if (out == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(static_cast<const float*>(x), n, levels, tables, res, mode,
                  F, smooth, nullptr, nullptr, nullptr, nullptr,
                  static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}

// grad (n, levels F) float32 -> targets (levels, n 8) int32 and contrib
// (levels, n 8, F) in the gather dtype (both null: no table gradient), and
// gx (n, 3) float32 (null: no x gradient; otherwise the tables are read)
extern "C" int mvedit_dense_grid_backward(const void* x, long long n,
                                          int levels,
                                          const void* const* tables,
                                          const int* res, int mode, int F,
                                          int smooth, const void* grad,
                                          void* targets, void* contrib,
                                          void* gx, void* stream) {
  // the segment sum takes int32 positions: n 8 contributions a level
  if (grad == nullptr || (targets == nullptr) != (contrib == nullptr) ||
      (targets == nullptr && gx == nullptr) || n > 0x7ffffffeLL / 8)
    return (int)cudaErrorInvalidValue;
  return dispatch(static_cast<const float*>(x), n, levels, tables, res, mode,
                  F, smooth, static_cast<const float*>(grad),
                  static_cast<int*>(targets), contrib,
                  static_cast<float*>(gx), nullptr,
                  static_cast<cudaStream_t>(stream));
}
