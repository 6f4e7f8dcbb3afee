// Fixed-order segment sum for Hopper (sm_90a): out[r, c] = the sum over
// j in [off[r], off[r + 1]) of vals[perm[j], c] in float32, in an order
// that the data alone fixes (one after another in j order for a row of at
// most kLong, blocked beyond; see (2) below).
//
// A kernel of the port alone: the TPU package has no Pallas counterpart.
// There the gradients of the row gathers (the dense grid's corner gathers,
// the mesh's vertex gathers) and the vertex-normal / Laplacian sums are
// XLA scatter-adds. On the card the same sums through `index_add` are
// atomic adds, which round in arrival order, so two runs of one seed
// differ. Here the wrapper (`kernels/segment_sum.py`) sorts the target
// rows once with a stable sort, which keeps each row's contributions in
// their original order, and turns the sorted ids into row offsets; the
// kernels then sum each row in a fixed order. The result is the same bits
// on every run.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 3.35 TB/s): bytes.
// It reads each contribution once (its value, 4 or 2 bytes a channel, and
// its 8-byte permutation entry), each row's two offsets, and writes each
// output once; there is one add per contribution and channel. The design:
//  (1) rows of at most kLong contributions (all but a few on the path: a
//      vertex's faces, the samples of one grid cell, ~500 on average in
//      the grid's coarse level, where one block per row measured 4x the
//      time of a thread per row): one thread per (row,
//      channel), so the C threads of a row read the row's permutation
//      entries together and its values as C neighbouring words; four loads
//      in flight per thread, added in order; empty rows (most of the dense
//      grid's 161^3 table in a NeRF chunk) cost two offset reads and one
//      store;
//  (2) longer rows (the background pixels that all gather one dummy face
//      in the rasterizer's and `interpolate`'s backward: 10^5 contributions
//      in one row, which a serial thread took ~50 ms over): the first
//      kernel lists them (an atomic counter; the list's order does not
//      matter, each row is summed by one block), and a second kernel sums
//      each with one 256-thread block: thread t adds entries t, t + 256,
//      ... in order, then a fixed tree over the threads in shared memory.
// Both orders are fixed by the data alone, so the bits are the same on
// every run; they equal a sequential float32 sum (the CPU's plain version)
// for rows of at most kLong, and `segment_sum_ordered` (the same orders in
// plain PyTorch) on every row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLong = 1024;     // longer rows go to the block kernel
constexpr int kBlock = 256;     // threads of the block kernel

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(256)
segment_sum_rows(const T* __restrict__ vals,
                 const long long* __restrict__ perm,
                 const long long* __restrict__ off, int C, long long rows,
                 float* __restrict__ out, int* __restrict__ n_long,
                 int* __restrict__ long_rows) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * C) return;
  const long long r = i / C;
  const int c = (int)(i - r * C);
  const long long b = __ldg(off + r), e = __ldg(off + r + 1);
  if (e - b > kLong) {
    if (c == 0) long_rows[atomicAdd(n_long, 1)] = (int)r;
    return;
  }
  float s = 0.f;
  long long j = b;
  for (; j + 4 <= e; j += 4) {
    const long long p0 = __ldg(perm + j), p1 = __ldg(perm + j + 1),
                    p2 = __ldg(perm + j + 2), p3 = __ldg(perm + j + 3);
    const float v0 = load(vals + p0 * C + c), v1 = load(vals + p1 * C + c),
                v2 = load(vals + p2 * C + c), v3 = load(vals + p3 * C + c);
    s = __fadd_rn(s, v0);
    s = __fadd_rn(s, v1);
    s = __fadd_rn(s, v2);
    s = __fadd_rn(s, v3);
  }
  for (; j < e; ++j) s = __fadd_rn(s, load(vals + __ldg(perm + j) * C + c));
  out[i] = s;
}

// One block per listed long row (grid-striding over the list): per
// channel, thread t sums entries t, t + kBlock, ... of the row in order,
// then the block adds the kBlock partial sums in a fixed tree.
template <typename T>
__global__ void __launch_bounds__(kBlock)
segment_sum_long(const T* __restrict__ vals,
                 const long long* __restrict__ perm,
                 const long long* __restrict__ off, int C,
                 float* __restrict__ out, const int* __restrict__ n_long,
                 const int* __restrict__ long_rows) {
  __shared__ float part[kBlock];
  const int n = *n_long, t = threadIdx.x;
  for (int k = blockIdx.x; k < n; k += gridDim.x) {
    const long long r = long_rows[k];
    const long long b = __ldg(off + r), e = __ldg(off + r + 1);
    for (int c = 0; c < C; ++c) {
      float s = 0.f;
      for (long long j = b + t; j < e; j += kBlock)
        s = __fadd_rn(s, load(vals + __ldg(perm + j) * C + c));
      part[t] = s;
      __syncthreads();
#pragma unroll
      for (int w = kBlock / 2; w > 0; w >>= 1) {
        if (t < w) part[t] = __fadd_rn(part[t], part[t + w]);
        __syncthreads();
      }
      if (t == 0) out[r * C + c] = part[0];
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int mvedit_segment_sum(const void* vals, int bf16,
                                  const void* perm, const void* off, int C,
                                  long long rows, long long n, void* scratch,
                                  void* out, void* stream) {
  if (C <= 0 || rows < 0 || n < 0) return (int)cudaErrorInvalidValue;
  const long long total = rows * C;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // at most n / (kLong + 1) rows are long; the list is scratch[1:]
  const long long max_long = n / (kLong + 1) + 1;
  const int long_blocks = (int)(max_long < 1024 ? max_long : 1024);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* p = static_cast<const long long*>(perm);
  const long long* o = static_cast<const long long*>(off);
  float* y = static_cast<float*>(out);
  int* n_long = static_cast<int*>(scratch);
  int* list = n_long + 1;
  if (bf16) {
    const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(vals);
    segment_sum_rows<<<(unsigned)blocks, threads, 0, s>>>(v, p, o, C, rows,
                                                          y, n_long, list);
    segment_sum_long<<<long_blocks, kBlock, 0, s>>>(v, p, o, C, y, n_long,
                                                    list);
  } else {
    const float* v = static_cast<const float*>(vals);
    segment_sum_rows<<<(unsigned)blocks, threads, 0, s>>>(v, p, o, C, rows,
                                                          y, n_long, list);
    segment_sum_long<<<long_blocks, kBlock, 0, s>>>(v, p, o, C, y, n_long,
                                                    list);
  }
  return (int)cudaGetLastError();
}
