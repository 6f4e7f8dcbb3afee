// Fixed-order segment sum for Hopper (sm_90a): out[r, c] = the sum over
// the contributions j with idx[j] == r of vals[j, c] in float32, targets
// outside [0, rows) dropped, in an order that the data alone fixes.
//
// A kernel of the port alone: the TPU package has no Pallas counterpart.
// There the gradients of the row gathers (the dense grid's corner gathers,
// the mesh's vertex gathers, the rasterizer's and `interpolate`'s
// gathers) and the vertex-normal / Laplacian sums are XLA scatter-adds.
// On the card the same sums through `index_add` are atomic adds, which
// round in arrival order, so two runs of one seed differ. Here every sum
// has one order, and one seed gives the same bits on every run.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 3.35 TB/s): bytes. The
// function reads each target (8 B) and each contribution's values once and
// writes each output once; one add per contribution and channel.
//
// Each C entry launches its kernels on the caller's stream (no host sync,
// no allocation: the wrapper hands in the buffers).
// `mvedit_segment_sum_targets` is the whole sum in one call, the ordering
// then the sums; `mvedit_segment_order` and `mvedit_segment_sum` are its
// two halves, for tests and timing.
//
// The ordering:
//  (a) `segment_keys`: key = the target, or `rows` where it is dropped,
//      and the identity permutation, both int32;
//  (b) CUB's stable LSD radix sort (`cub::DeviceRadixSort::SortPairs`)
//      over bits [0, bits) only, bits = bit_length(rows): keys lie in
//      [0, rows], so the higher bits are 0 and need no pass (22 bits at
//      161^3 rows: three 8-bit passes instead of four, int32 payload);
//  (c) `segment_offsets`: off[k] = the first sorted position whose key is
//      >= k, written from the sorted keys alone: position j writes j into
//      off[k] for the keys k in (key[j - 1], key[j]] it steps over (the
//      last position n steps to `rows`). Short steps are written by their
//      thread, long ones (empty stretches of the grid) by the whole block.
//
// The sums:
//  (1) `segment_rows`: one thread per (row, channel) adds a row of at most
//      kLong contributions one after another in float32 (the order of
//      `index_add` on the CPU), the C threads of a row reading the row's
//      permutation entries together and its values as C neighbouring
//      words; an empty row costs two offset reads and one store. For bf16
//      rows of 8 (the dense grid), (1b) `segment_rows8`: one thread per
//      row, one 16-byte load per contribution, the same adds. A row of
//      at most kWarp is listed for (2); a longer one is cut into slices of
//      kSlice from its start and takes one slot per slice (atomic
//      counters: where a row or a slot lies never reaches a sum, only the
//      order inside a row does);
//  (2) `segment_warps`: one warp per listed row (the grid's coarse level
//      and retex's surface cells hold rows of hundreds, too long for one
//      thread's serial loads): lane t adds entries t, t + 32, ... in order
//      for all C channels at once, then a fixed tree of shuffles;
//  (3) `segment_slices`: one CTA per slot (the grid strides over all
//      slices of all long rows, so rows of ~10^6 fill every SM): thread t
//      adds entries t, t + 256, ... of the slice in order for all C
//      channels at once (each permutation entry read once), then a fixed
//      tree over the 256 threads (shared memory, then warp shuffles that
//      add the same pairs); the partials go to the slot, or, for a row of
//      one slice, out;
//  (4) `segment_finish`: one CTA per row of more than one slice: thread t
//      adds the row's slice partials t, t + 256, ... in order, then the
//      same tree.
// Every order here is fixed by the data alone, so the bits are the same on
// every run; they equal a sequential float32 sum for rows of at most kLong
// and `segment_sum_ordered` (the same orders in plain PyTorch) on every
// row. The output is written in float32 or, for a bf16 gather's gradient,
// rounded once to bf16 (round to nearest even, as `Tensor.to`).
#include <cub/device/device_radix_sort.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLong = 64;       // rows one thread adds in order
constexpr int kWarp = 1024;     // rows one warp adds
constexpr int kSlice = 8192;    // longer: contributions per CTA
constexpr int kBlock = 256;     // threads of a slice / finish CTA
constexpr int kGroup = 8;       // channels a slice CTA sums at once
constexpr int kUnroll = 4;      // loads in flight per thread of (1b)-(3)
constexpr int kRowsUnroll = 8;  // loads in flight per thread of (1)
constexpr int kGapDirect = 8;   // longer offset steps go to the block
static_assert(kSlice % kBlock == 0 && kSlice >= kBlock, "slice");
static_assert(kLong < kWarp, "tiers");

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// 8 sums to 16-byte aligned memory
__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&x)[8]) {
  uint4 w;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = w;
}

// the C values of one contribution, channels [c0, c0 + cg)
template <typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ vals,
                                           long long p, int C, int c0,
                                           int cg, float (&x)[kGroup]) {
  const T* row = vals + p * C + c0;
  if (sizeof(T) == 2 && cg == 8 && C == 8) {
    // one 16-byte load: the wrapper hands in 16-byte aligned bf16 rows
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(row));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      x[2 * k] = f.x;
      x[2 * k + 1] = f.y;
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < kGroup; ++c) x[c] = c < cg ? load(row + c) : 0.f;
}

// (a) keys and the identity permutation; the targets are read with a
// stride (a column of the mesh's faces is one)
template <typename I>
__global__ void __launch_bounds__(256)
segment_keys(const I* __restrict__ idx, long long stride, int n, int rows,
             unsigned* __restrict__ keys, int* __restrict__ iota) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const long long t = (long long)idx[j * stride];
  keys[j] = (t >= 0 && t < rows) ? (unsigned)t : (unsigned)rows;
  iota[j] = j;
}

// (c) offsets from the sorted keys: position j in [0, n] writes j into
// off[k] for k in (key[j - 1], key[j]], key[-1] = -1 and key[n] = rows
__global__ void __launch_bounds__(kBlock)
segment_offsets(const unsigned* __restrict__ sk, int n, int rows,
                int* __restrict__ off) {
  __shared__ int lo_s[kBlock], hi_s[kBlock], at_s[kBlock];
  __shared__ int count;
  const int t = threadIdx.x;
  if (t == 0) count = 0;
  __syncthreads();
  const long long j = (long long)blockIdx.x * kBlock + t;
  if (j <= n) {
    const int prev = j == 0 ? -1 : (int)sk[j - 1];
    const int cur = j == n ? rows : (int)sk[j];
    if (cur - prev <= kGapDirect) {
      for (int k = prev + 1; k <= cur; ++k) off[k] = (int)j;
    } else {
      // the steps are disjoint, so the list's order does not matter
      const int s = atomicAdd(&count, 1);
      lo_s[s] = prev + 1;
      hi_s[s] = cur;
      at_s[s] = (int)j;
    }
  }
  __syncthreads();
  for (int s = 0; s < count; ++s) {
    const int hi = hi_s[s], at = at_s[s];
    for (int k = lo_s[s] + t; k <= hi; k += kBlock) off[k] = at;
  }
}

// the bookkeeping in the sums' scratch: hdr[0] rows of the slice tier,
// hdr[1] their slices, hdr[2] rows of more than one slice, hdr[3] rows of
// the warp tier; per slice-tier row its row and first slot; per slot
// (slice) its row and index in the row; the rows of more than one slice;
// the warp tier's rows; the slots' partials
struct Plan {
  int* hdr;
  int* row;
  int* first;
  int2* slot;
  int* multi;
  int* mid;
  float* part;
};

// a row of more than kLong: a row of at most kWarp goes to the warp tier's
// list; a longer one takes q = ceil(len / kSlice) consecutive slots. The
// lists and slots are filled with atomics: where a row or a slot lies
// never reaches a sum, only the order inside a row does
__device__ __forceinline__ void route(const Plan& plan, int r, int len) {
  if (len <= kWarp) {
    plan.mid[atomicAdd(plan.hdr + 3, 1)] = r;
    return;
  }
  const int q = (len + kSlice - 1) / kSlice;
  const int k = atomicAdd(plan.hdr, 1);
  const int g = atomicAdd(plan.hdr + 1, q);
  plan.row[k] = r;
  plan.first[k] = g;
  for (int s = 0; s < q; ++s) plan.slot[g + s] = make_int2(r, s);
  if (q > 1) plan.multi[atomicAdd(plan.hdr + 2, 1)] = k;
}

// (1) rows of at most kLong, one thread per (row, channel), in order;
// longer ones routed to (2) and (3)
template <typename T, typename O>
__global__ void __launch_bounds__(256)
segment_rows(const T* __restrict__ vals, const int* __restrict__ perm,
             const int* __restrict__ off, int C, int rows,
             O* __restrict__ out, Plan plan) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * C) return;
  const int r = (int)(i / C);
  const int c = (int)(i - (long long)r * C);
  const int b = __ldg(off + r), e = __ldg(off + r + 1);
  if (e - b > kLong) {
    if (c == 0) route(plan, r, e - b);
    return;
  }
  float s = 0.f;
  int j = b;
  for (; j + kRowsUnroll <= e; j += kRowsUnroll) {
    float v[kRowsUnroll];
#pragma unroll
    for (int u = 0; u < kRowsUnroll; ++u)
      v[u] = load(vals + (long long)__ldg(perm + j + u) * C + c);
#pragma unroll
    for (int u = 0; u < kRowsUnroll; ++u) s = __fadd_rn(s, v[u]);
  }
  for (; j < e; ++j)
    s = __fadd_rn(s, load(vals + (long long)__ldg(perm + j) * C + c));
  store(out + i, s);
}

// (1b) for bf16 rows of 8 channels (the dense grid's gathers): one thread
// per row, all 8 channels from one 16-byte load per contribution, each
// channel added in order as in `segment_rows` (the same bits); the row's
// 8 sums stored as 32 (float32) or 16 (bf16) contiguous bytes
template <typename O>
__global__ void __launch_bounds__(256)
segment_rows8(const __nv_bfloat16* __restrict__ vals,
              const int* __restrict__ perm, const int* __restrict__ off,
              int rows, O* __restrict__ out, Plan plan) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int b = __ldg(off + r), e = __ldg(off + r + 1);
  if (e - b > kLong) {
    route(plan, r, e - b);
    return;
  }
  float s[kGroup];
#pragma unroll
  for (int c = 0; c < kGroup; ++c) s[c] = 0.f;
  int j = b;
  for (; j + kUnroll <= e; j += kUnroll) {
    float x[kUnroll][kGroup];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      load_group(vals, __ldg(perm + j + u), 8, 0, 8, x[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int c = 0; c < kGroup; ++c) s[c] = __fadd_rn(s[c], x[u][c]);
  }
  for (; j < e; ++j) {
    float x[kGroup];
    load_group(vals, __ldg(perm + j), 8, 0, 8, x);
#pragma unroll
    for (int c = 0; c < kGroup; ++c) s[c] = __fadd_rn(s[c], x[c]);
  }
  store8(out + (long long)r * 8, s);
}

// lane `lane` of `lanes` adds entries b + lane, b + lane + lanes, ... < e
// in order, channels [c0, c0 + cg) at once (each permutation entry read
// once), into acc (from +0)
template <int lanes, typename T>
__device__ __forceinline__ void strided(const T* __restrict__ vals,
                                        const int* __restrict__ perm, int b,
                                        int e, int C, int c0, int cg,
                                        int lane, float (&acc)[kGroup]) {
#pragma unroll
  for (int c = 0; c < kGroup; ++c) acc[c] = 0.f;
  for (int j0 = b + lane; j0 < e; j0 += kUnroll * lanes) {
    int p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * lanes;
      p[u] = j < e ? __ldg(perm + j) : -1;
    }
    float x[kUnroll][kGroup];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p[u] >= 0) {
        load_group(vals, p[u], C, c0, cg, x[u]);
      } else {
#pragma unroll
        for (int c = 0; c < kGroup; ++c) x[u][c] = 0.f;
      }
    }
    // a missing entry adds +0: a sum that starts at +0 is never -0, so
    // that is no change
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int c = 0; c < kGroup; ++c) acc[c] = __fadd_rn(acc[c], x[u][c]);
  }
}

// the fixed tree over a warp's lanes: v[t] += v[t + w] for w = 16, ..., 1
// (shuffles); lane 0 ends with the sum
__device__ __forceinline__ void warp_tree(float (&x)[kGroup]) {
#pragma unroll
  for (int c = 0; c < kGroup; ++c)
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
      x[c] = __fadd_rn(x[c], __shfl_down_sync(0xffffffffu, x[c], w));
}

// the fixed tree over the block's kBlock partials of cg channels:
// red[c][t] += red[c][t + w] for w = kBlock / 2, ..., 1; the levels below
// a warp as `warp_tree`, which adds the same pairs. Thread 0 ends with the
// sums in x
__device__ __forceinline__ void block_tree(float (*red)[kBlock], int cg,
                                           int t, float (&x)[kGroup]) {
#pragma unroll
  for (int w = kBlock / 2; w >= 32; w >>= 1) {
    if (t < w) {
#pragma unroll
      for (int c = 0; c < kGroup; ++c)
        if (c < cg) red[c][t] = __fadd_rn(red[c][t], red[c][t + w]);
    }
    __syncthreads();
  }
  if (t < 32) {
#pragma unroll
    for (int c = 0; c < kGroup; ++c) x[c] = c < cg ? red[c][t] : 0.f;
    warp_tree(x);
  }
}

// (2) one warp per row of the warp tier (grid-striding over the list):
// lane t adds entries t, t + 32, ... in order, then the warp's tree
template <typename T, typename O>
__global__ void __launch_bounds__(256)
segment_warps(const T* __restrict__ vals, const int* __restrict__ perm,
              const int* __restrict__ off, int C, Plan plan,
              O* __restrict__ out) {
  const int lane = threadIdx.x & 31, m = plan.hdr[3];
  const int warps = gridDim.x * (blockDim.x >> 5);
  const int c0 = blockIdx.y * kGroup, cg = min(kGroup, C - c0);
  for (int k = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); k < m;
       k += warps) {
    const int r = plan.mid[k];
    float acc[kGroup];
    strided<32>(vals, perm, __ldg(off + r), __ldg(off + r + 1), C, c0, cg,
                lane, acc);
    warp_tree(acc);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kGroup; ++c)
        if (c < cg) store(out + (long long)r * C + c0 + c, acc[c]);
    }
  }
}

// (3) one CTA per slot (grid-striding): thread t adds entries t, t + 256,
// ... of the slice in order, then the block's tree. A row of one slice is
// written out here: (4) would add its one partial to +0 and then +0s,
// which changes no bit (the partial, a sum that starts at +0, is never -0)
template <typename T, typename O>
__global__ void __launch_bounds__(kBlock)
segment_slices(const T* __restrict__ vals, const int* __restrict__ perm,
               const int* __restrict__ off, int C, Plan plan,
               O* __restrict__ out) {
  __shared__ float red[kGroup][kBlock];
  const int t = threadIdx.x, total = plan.hdr[1];
  const int c0 = blockIdx.y * kGroup, cg = min(kGroup, C - c0);
  for (int g = blockIdx.x; g < total; g += gridDim.x) {
    const int2 rs = plan.slot[g];
    const int rb = __ldg(off + rs.x), re = __ldg(off + rs.x + 1);
    const int b = rb + rs.y * kSlice;
    float acc[kGroup];
    strided<kBlock>(vals, perm, b, min(re, b + kSlice), C, c0, cg, t, acc);
#pragma unroll
    for (int c = 0; c < kGroup; ++c) red[c][t] = acc[c];
    __syncthreads();
    block_tree(red, cg, t, acc);
    if (t == 0) {
      const bool one = re - rb <= kSlice;
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        if (c >= cg) break;
        if (one)
          store(out + (long long)rs.x * C + c0 + c, acc[c]);
        else
          plan.part[(long long)g * C + c0 + c] = acc[c];
      }
    }
    __syncthreads();
  }
}

// (4) one CTA per row of more than one slice: thread t adds the row's
// slice partials t, t + 256, ... in order, then the block's tree; the
// row's sum in the output's type
template <typename O>
__global__ void __launch_bounds__(kBlock)
segment_finish(const int* __restrict__ off, int C, Plan plan,
               O* __restrict__ out) {
  __shared__ float red[kGroup][kBlock];
  const int t = threadIdx.x, m = plan.hdr[2];
  const int c0 = blockIdx.y * kGroup, cg = min(kGroup, C - c0);
  for (int k = blockIdx.x; k < m; k += gridDim.x) {
    const int l = plan.multi[k];
    const int r = plan.row[l];
    const int q = (off[r + 1] - off[r] + kSlice - 1) / kSlice;
    const long long g0 = plan.first[l];
    float acc[kGroup];
#pragma unroll
    for (int c = 0; c < kGroup; ++c) acc[c] = 0.f;
    for (int s = t; s < q; s += kBlock) {
#pragma unroll
      for (int c = 0; c < kGroup; ++c)
        if (c < cg)
          acc[c] = __fadd_rn(acc[c], plan.part[(g0 + s) * C + c0 + c]);
    }
#pragma unroll
    for (int c = 0; c < kGroup; ++c) red[c][t] = acc[c];
    __syncthreads();
    block_tree(red, cg, t, acc);
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < kGroup; ++c)
        if (c < cg) store(out + (long long)r * C + c0 + c, acc[c]);
    }
    __syncthreads();
  }
}

// the sums' scratch, in bytes, laid out as `plan_at` reads it
long long max_mid(long long n) { return n / (kLong + 1) + 1; }
long long max_long(long long n) { return n / (kWarp + 1) + 1; }
long long max_slices(long long n) { return n / kSlice + max_long(n); }
long long plan_ints(long long n) {
  return (4 + 2 * max_slices(n) + 3 * max_long(n) + max_mid(n) + 3) / 4 * 4;
}

Plan plan_at(char* scratch, long long n) {
  Plan p;
  p.hdr = reinterpret_cast<int*>(scratch);
  p.slot = reinterpret_cast<int2*>(p.hdr + 4);
  p.row = reinterpret_cast<int*>(p.slot + max_slices(n));
  p.first = p.row + max_long(n);
  p.multi = p.first + max_long(n);
  p.mid = p.multi + max_long(n);
  p.part = reinterpret_cast<float*>(p.hdr + plan_ints(n));
  return p;
}

unsigned capped(long long blocks, long long cap) {
  return (unsigned)(blocks < cap ? blocks : cap);
}

template <typename T, typename O>
int sum(const T* v, const int* perm, const int* off, int C, int rows,
        long long n, char* scratch, O* out, cudaStream_t s) {
  const Plan plan = plan_at(scratch, n);
  cudaError_t err = cudaMemsetAsync(plan.hdr, 0, 4 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)rows * C;
  if (sizeof(T) == 2 && C == 8)
    segment_rows8<O><<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
        reinterpret_cast<const __nv_bfloat16*>(v), perm, off, rows, out,
        plan);
  else
    segment_rows<T, O><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
        v, perm, off, C, rows, out, plan);
  const unsigned groups = (unsigned)((C + kGroup - 1) / kGroup);
  const dim3 g_warps(capped(max_mid(n) / 8 + 1, 132 * 8), groups);
  const dim3 g_slices(capped(max_slices(n), 132 * 16), groups);
  const dim3 g_finish(capped(max_long(n), 264), groups);
  segment_warps<T, O><<<g_warps, 256, 0, s>>>(v, perm, off, C, plan, out);
  segment_slices<T, O><<<g_slices, kBlock, 0, s>>>(v, perm, off, C, plan,
                                                   out);
  segment_finish<O><<<g_finish, kBlock, 0, s>>>(off, C, plan, out);
  return (int)cudaGetLastError();
}

}  // namespace

// CUB's temporary bytes for a sort of n pairs over `bits` bits
extern "C" long long mvedit_segment_order_temp_bytes(long long n, int bits) {
  size_t bytes = 0;
  cub::DoubleBuffer<unsigned> k(nullptr, nullptr);
  cub::DoubleBuffer<int> v(nullptr, nullptr);
  if (cub::DeviceRadixSort::SortPairs(nullptr, bytes, k, v, (int)n, 0, bits)
      != cudaSuccess)
    return -1;
  return (long long)bytes;
}

namespace {

// (a)-(c) into pairs (2, 2, n) int32, [keys, permutation] x [buffer 0,
// buffer 1], and off (rows + 1,); *selector = the buffer that holds the
// sorted keys and the permutation
int order(const void* idx, int idx64, long long stride, long long n,
          int rows, int bits, void* pairs, void* temp, long long temp_bytes,
          int* off, int* selector, cudaStream_t s) {
  if (n < 0 || n > 0x7ffffffeLL || rows < 0 || rows > 0x7ffffffe ||
      bits < 1 || bits > 31 || (1LL << bits) <= rows)
    return (int)cudaErrorInvalidValue;
  unsigned* k0 = static_cast<unsigned*>(pairs);
  unsigned* k1 = k0 + n;
  int* v0 = reinterpret_cast<int*>(k1 + n);
  int* v1 = v0 + n;
  *selector = 0;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + 255) / 256);
    if (idx64)
      segment_keys<<<blocks, 256, 0, s>>>(static_cast<const long long*>(idx),
                                          stride, (int)n, rows, k0, v0);
    else
      segment_keys<<<blocks, 256, 0, s>>>(static_cast<const int*>(idx),
                                          stride, (int)n, rows, k0, v0);
    cub::DoubleBuffer<unsigned> k(k0, k1);
    cub::DoubleBuffer<int> v(v0, v1);
    size_t bytes = (size_t)temp_bytes;
    cudaError_t err = cub::DeviceRadixSort::SortPairs(temp, bytes, k, v,
                                                      (int)n, 0, bits, s);
    if (err != cudaSuccess) return (int)err;
    *selector = k.selector;
    if (v.selector != k.selector) return (int)cudaErrorUnknown;
    k0 = k.Current();
  }
  const unsigned blocks = (unsigned)((n + 1 + kBlock - 1) / kBlock);
  segment_offsets<<<blocks, kBlock, 0, s>>>(k0, (int)n, rows, off);
  return (int)cudaGetLastError();
}

long long align(long long b) { return (b + 255) / 256 * 256; }

}  // namespace

extern "C" int mvedit_segment_order(const void* idx, int idx64,
                                    long long stride, long long n, int rows,
                                    int bits, void* pairs, void* temp,
                                    long long temp_bytes, void* off,
                                    int* selector, void* stream) {
  return order(idx, idx64, stride, n, rows, bits, pairs, temp, temp_bytes,
               static_cast<int*>(off), selector,
               static_cast<cudaStream_t>(stream));
}

extern "C" long long mvedit_segment_sum_scratch_bytes(long long n, int C) {
  return 4 * plan_ints(n) + max_slices(n) * C * 4;
}

namespace {

int sums(const void* vals, int bf16, const int* p, const int* o, int C,
         int rows, long long n, char* sc, void* out, int out_bf16,
         cudaStream_t s) {
  if (C <= 0 || rows < 0 || n < 0 || n > 0x7ffffffeLL)
    return (int)cudaErrorInvalidValue;
  if ((long long)rows * C == 0) return (int)cudaSuccess;
  if (((long long)rows * C + 255) / 256 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (bf16) {
    const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(vals);
    return out_bf16
        ? sum(v, p, o, C, rows, n, sc, static_cast<__nv_bfloat16*>(out), s)
        : sum(v, p, o, C, rows, n, sc, static_cast<float*>(out), s);
  }
  const float* v = static_cast<const float*>(vals);
  return out_bf16
      ? sum(v, p, o, C, rows, n, sc, static_cast<__nv_bfloat16*>(out), s)
      : sum(v, p, o, C, rows, n, sc, static_cast<float*>(out), s);
}

}  // namespace

// the sums on the order of mvedit_segment_order: vals (n, C) float32 or
// bf16, perm (n,) and off (rows + 1,) int32, out (rows, C) float32 or bf16
extern "C" int mvedit_segment_sum(const void* vals, int bf16,
                                  const void* perm, const void* off, int C,
                                  int rows, long long n, void* scratch,
                                  void* out, int out_bf16, void* stream) {
  return sums(vals, bf16, static_cast<const int*>(perm),
              static_cast<const int*>(off), C, rows, n,
              static_cast<char*>(scratch), out, out_bf16,
              static_cast<cudaStream_t>(stream));
}

// the workspace of mvedit_segment_sum_targets, in bytes, and CUB's part of
// it in *temp_bytes (-1 if CUB's query fails)
extern "C" long long mvedit_segment_sum_targets_bytes(long long n, int rows,
                                                      int C, int bits,
                                                      long long* temp_bytes) {
  *temp_bytes = mvedit_segment_order_temp_bytes(n, bits);
  if (*temp_bytes < 0) return -1;
  return align(16 * n) + align(*temp_bytes) + align(4LL * (rows + 1)) +
         mvedit_segment_sum_scratch_bytes(n, C);
}

// the whole sum in one call: the order of idx (n,) int64 or int32 (with a
// stride in elements), then
// the sums of vals (n, C) into out (rows, C); ws holds the pairs, CUB's
// temporary, the offsets and the sums' scratch, laid out as
// mvedit_segment_sum_targets_bytes counts them
extern "C" int mvedit_segment_sum_targets(const void* idx, int idx64,
                                          long long stride,
                                          const void* vals, int bf16, int C,
                                          int rows, long long n, int bits,
                                          void* ws, long long temp_bytes,
                                          void* out, int out_bf16,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* w = static_cast<char*>(ws);
  char* temp = w + align(16 * n);
  int* off = reinterpret_cast<int*>(temp + align(temp_bytes));
  char* scratch = reinterpret_cast<char*>(off) + align(4LL * (rows + 1));
  int sel = 0;
  const int err = order(idx, idx64, stride, n, rows, bits, w, temp,
                        temp_bytes, off, &sel, s);
  if (err != 0) return err;
  const int* perm = reinterpret_cast<const int*>(w) + (2 + sel) * n;
  return sums(vals, bf16, perm, off, C, rows, n, scratch, out, out_bf16, s);
}
