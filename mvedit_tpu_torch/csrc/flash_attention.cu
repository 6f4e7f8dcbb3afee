// Flash attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the TPU kernel `mvedit_tpu/models/diffusion/attention.py::
// _pallas_flash` (the stock Pallas TPU flash attention): non-causal
// softmax(Q K^T * scale) V with f32 softmax statistics, used for every UNet
// and ControlNet self-attention longer than 1024 tokens; with a caller-given
// scale it also serves `mvedit_tpu/ops/flash_attention.py::_flash_fwd`.
//
// Layout: Q, K, V and O are (B, L, H, D) as the JAX package keeps them. Each
// of Q, K and V is read through a TMA tensor map over the 4-D view
// (D, H, L, B) with the caller's strides, so no transpose is made. The
// entry point needs D % 8 == 0, 16-byte aligned bases and strides that are
// multiples of 8 elements; the Python wrapper makes an aligned copy of any
// other input first.
//
// Design (one CTA per 64 NC query rows of one (head, batch), NC consumer
// warpgroups: 3 at D <= 48, 2 above):
//  - warpgroup 0 is the producer: one thread issues TMA loads, Q once and
//    then 128-key K and V tiles into 3-stage rings guarded by full / empty
//    mbarriers (K runs a tile ahead of V; a K stage is freed once its
//    Q K^T is done, a V stage once its P V is). Boxes are 64 columns (128
//    bytes) wide with 128-byte swizzle; columns past D and rows past L are
//    out of bounds and TMA fills them with zeros, which pads D to the wgmma
//    depth for free and never reads a neighbouring head. D > 64 takes two
//    column boxes. The producer gives its registers to the consumers
//    (setmaxnreg).
//  - each consumer warpgroup owns 64 query rows. S = Q K^T is one wgmma
//    m64n128k16 per 16 columns of D, both operands from shared memory
//    (K-major). O += P V is a wgmma m64nNk16 per 16 keys with P from
//    registers (S's f32 accumulator fragments, rounded to bf16, are exactly
//    the A fragments) and V as the transposed (MN-major) B operand read
//    straight from the TMA tile; N is D rounded up to the next instantiated
//    width (40 at D=40).
//  - one loop, one pass per tile plus one: pass j issues Q K^T of tile j
//    and P V of tile j - 1 together (wgmma commit / wait groups), and P V
//    runs under tile j's softmax; the warpgroups' warps share each SM
//    sub-partition, so one group's softmax also runs under another's
//    GEMMs. No wgmma sits under a branch (ptxas then allocates without
//    spills and keeps the groups asynchronous): the last pass repeats a
//    Q K^T whose result is dropped, the first multiplies P = 0.
//  - online softmax with f32 running max and sum per row: one FFMA and one
//    ex2.approx per score, with scale * log2(e) folded in; P is rounded to
//    bf16 for P V; the output is O / l rounded to bf16, stored with 4-byte
//    stores through the output's strides, ragged rows masked. Keys past Lk
//    score -inf in the last tile only.
//
// What bounds it on an H100: at the path's shapes it is compute-bound. At
// D=40 the tensor-core work per score is 4 * 44 flops (48-deep Q K^T, 40-wide
// P V) while every score needs one exponential on the special-function
// units (16 per clock per SM), so the exp is the larger of the two floors;
// measured, latency along each warpgroup's chain bounds it before either
// (PERF.md, Findings), hence the third warpgroup where registers allow.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kKeys = 128;              // keys per K / V tile
// K and V ring depth: 4 and 6 were measured no faster, and 2 with one
// release per K/V stage 1.6x slower (PERF.md, Findings)
constexpr int kStages = 3;
constexpr int kBox = kKeys * 128;       // bytes of one 128-key x 64-col box
constexpr int kProducerRegs = 24;

struct Params {
  __nv_bfloat16* o;
  long long o_sb, o_sl, o_sh;
  int Lq, Lk, D;
  float sl2;                            // scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  long long tries = 0;
  do {
    if (++tries > (1ll << 31)) __trap();  // a lost arrival traps, not hangs
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64-column x 128-row box of a (D, H, L, B) tensor map into smem.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c, int h, int l, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(h), "r"(l), "r"(b),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. Offsets in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses to wgmma registers across an
// issue or a wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x 128, f32) = A (64 x 16) * B^T (128 x 16), both K-major in smem.
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x N, f32) += P (64 x 16, bf16 registers) * V (16 x N), V MN-major
// in smem (the transposed B operand); accumulates always.
template <int N>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<16>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pv<32>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pv<40>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pv<48>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pv<80>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pv<96>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void fence_regs_u32(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int NV>
struct Tile {
  static constexpr int NB = (NV + 63) / 64;  // 64-column boxes per row
  static constexpr int KS = (NV + 15) / 16;  // k-steps of Q K^T
  // consumer warpgroups of 64 query rows: 3 while a thread's accumulators
  // fit in 160 registers without spilling (D <= 48), else 2 with 240; the
  // producer's registers go to them (128 x 24 + 128 NC x regs <= 65536),
  // which works only if every thread starts with the launch bound's
  static constexpr int NC = NV <= 48 ? 3 : 2;
  static constexpr int kConsumerRegs = NC == 3 ? 160 : 240;
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kLaunchRegs = NC == 3 ? 128 : 168;  // 65536 / threads
  static constexpr int kQRows = 64 * NC;     // query rows per CTA
  static constexpr int kQBox = kQRows * 128; // bytes of one Q column box
  static constexpr int kBytes = NB * kBox;   // one K or V tile, all boxes
  // Q, kStages K tiles, kStages V tiles, barriers; +1024 for alignment
  static constexpr int kSmem = 1024 + NB * kQBox + 2 * kStages * kBytes + 128;
};

// S = Q K^T for one 128-key tile: one m64n128k16 per 16 columns of D.
template <int NV>
__device__ __forceinline__ void issue_qk(float* s, uint32_t qa, uint32_t kb) {
#pragma unroll
  for (int kk = 0; kk < Tile<NV>::KS; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_qk(s, smem_desc(qa + (kk / 4) * Tile<NV>::kQBox + col, 16, 1024),
             smem_desc(kb + (kk / 4) * kBox + col, 16, 1024), kk > 0);
  }
}

// O += P V for one 128-key tile: one m64nNVk16 per 16 keys (two 8-row
// swizzle atoms of V); the second column box sits kBox further on.
template <int NV>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t* pf,
                                         uint32_t vb) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    wgmma_pv<NV>(o, pf + 4 * kk, smem_desc(vb + kk * 2048, kBox, 1024));
}

// Online softmax of one tile in place: s[4j + e] is row g (e < 2) or g + 8
// of this warp, key 8j + 2t + (e & 1) of the tile. On return s holds the
// unnormalised probabilities, m / ms / l the running raw max, scaled max
// and this thread's partial sum, and c the factor that rescales O.
template <bool kRagged>
__device__ __forceinline__ void softmax_tile(float* s, float (&m)[2],
                                             float (&ms)[2], float (&l)[2],
                                             float (&c)[2], float sl2,
                                             int nvalid, int t) {
  if (kRagged) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (8 * (i / 4) + 2 * t + (i & 1) >= nvalid) s[i] = -INFINITY;
  }
  // two chains per row, so the max and the sum are not one long chain
  float x[4] = {m[0], m[1], m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int h = (j & 1) * 2;
    x[h] = fmaxf(x[h], fmaxf(s[4 * j], s[4 * j + 1]));
    x[h + 1] = fmaxf(x[h + 1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    x[r] = fmaxf(x[r], x[r + 2]);
    x[r] = fmaxf(x[r], __shfl_xor_sync(0xffffffffu, x[r], 1));
    x[r] = fmaxf(x[r], __shfl_xor_sync(0xffffffffu, x[r], 2));
    // every tile holds a valid key, so the new max is finite
    const float msn = x[r] * sl2;
    c[r] = ex2(ms[r] - msn);
    m[r] = x[r];
    ms[r] = msn;
  }
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    float p = ex2(fmaf(s[i], sl2, -ms[r]));
    if (kRagged && 8 * (i / 4) + 2 * t + (i & 1) >= nvalid) p = 0.f;
    s[i] = p;
    sum[(i & 4) / 2 + r] += p;
  }
  l[0] = l[0] * c[0] + (sum[0] + sum[2]);
  l[1] = l[1] * c[1] + (sum[1] + sum[3]);
}

// s (f32 accumulator fragments) -> P as bf16 A fragments: k-step kk of P V
// is pf[4kk .. 4kk + 3].
__device__ __forceinline__ void to_p(const float* s, uint32_t* pf) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    pf[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pf[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

template <int NV>
__device__ __forceinline__ void rescale(float* o, const float (&c)[2]) {
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) o[i] *= c[(i >> 1) & 1];
}

template <int NV>
__global__ void __launch_bounds__(Tile<NV>::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
  using T = Tile<NV>;
  constexpr int S = kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + T::NB * T::kQBox;                // + stage * kBytes
  const uint32_t sV = sK + S * T::kBytes;              // + stage * kBytes
  const uint32_t bar = sV + S * T::kBytes;
  const uint32_t q_full = bar;                         // 8 bytes each:
  const uint32_t k_full = bar + 8;                     // + stage * 8
  const uint32_t v_full = k_full + 8 * S;
  const uint32_t k_empty = v_full + 8 * S;
  const uint32_t v_empty = k_empty + 8 * S;

  const int tid = threadIdx.x;
  const int n_tiles = (p.Lk + kKeys - 1) / kKeys;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4 * T::NC);
      mbar_init(v_empty + 8 * s, 4 * T::NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      const int q0 = blockIdx.x * T::kQRows, h = blockIdx.y, b = blockIdx.z;
      mbar_expect_tx(q_full, T::NB * T::kQBox);
#pragma unroll
      for (int c = 0; c < T::NB; ++c)
        tma_load(sQ + c * T::kQBox, &tq, c * 64, h, q0, b, q_full);
      // K runs one tile ahead of V, as the consumers use them: K(j) with
      // V(j - 1). A K stage is free once its Q K^T is done, a V stage once
      // its P V is.
      for (int j = 0; j <= n_tiles; ++j) {
        if (j < n_tiles) {
          const int s = j % S;
          if (j >= S) mbar_wait(k_empty + 8 * s, (j / S - 1) & 1);
          mbar_expect_tx(k_full + 8 * s, T::kBytes);
#pragma unroll
          for (int c = 0; c < T::NB; ++c)
            tma_load(sK + s * T::kBytes + c * kBox, &tk, c * 64, h, j * kKeys,
                     b, k_full + 8 * s);
        }
        if (j >= 1) {
          const int i = j - 1, s = i % S;
          if (i >= S) mbar_wait(v_empty + 8 * s, (i / S - 1) & 1);
          mbar_expect_tx(v_full + 8 * s, T::kBytes);
#pragma unroll
          for (int c = 0; c < T::NB; ++c)
            tma_load(sV + s * T::kBytes + c * kBox, &tv, c * 64, h, i * kKeys,
                     b, v_full + 8 * s);
        }
      }
    }
  } else {
    // consumer warpgroups 1 .. NC: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        T::kConsumerRegs));
    const int cw = tid / 128 - 1;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const uint32_t qa = sQ + cw * 64 * 128;     // rows 64 cw .. 64 cw + 63
    const int ragged = p.Lk % kKeys;            // valid keys of the last tile

    float s[64], o[NV / 2];
    uint32_t pf[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) pf[i] = 0u;
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, ms[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f}, c[2];

    mbar_wait(q_full, 0);
    // one pass per tile plus one: pass j issues Q K^T of tile j and P V of
    // tile j - 1
    for (int j = 0; j <= n_tiles; ++j) {
      const bool qk = j < n_tiles, pv = j > 0;
      // no branch around a wgmma: the last pass repeats the last tile's
      // Q K^T (dropped), the first multiplies P = 0 into V(0) (as the plain
      // version does for a key whose p is 0)
      const int kt = qk ? j : n_tiles - 1, vt = pv ? j - 1 : 0;
      const int st = kt % S, pst = vt % S;
      mbar_wait(k_full + 8 * st, (kt / S) & 1);
      wgmma_fence();
      issue_qk<NV>(s, qa, sK + st * T::kBytes);
      wgmma_commit();
      mbar_wait(v_full + 8 * pst, (vt / S) & 1);
      issue_pv<NV>(o, pf, sV + pst * T::kBytes);
      wgmma_commit();
      wgmma_wait<1>();   // Q K^T of tile j is done; P V of tile j-1 runs on
      fence_regs<64>(s);
      if (qk) {
        if (lane == 0) mbar_arrive(k_empty + 8 * st);
        if (ragged && j == n_tiles - 1)
          softmax_tile<true>(s, m, ms, l, c, p.sl2, ragged, t);
        else
          softmax_tile<false>(s, m, ms, l, c, p.sl2, kKeys, t);
      }
      wgmma_wait<0>();
      fence_regs<NV / 2>(o);
      fence_regs_u32<32>(pf);
      fence_regs<64>(s);
      if (pv && lane == 0) mbar_arrive(v_empty + 8 * pst);
      if (qk) {
        rescale<NV>(o, c);
        to_p(s, pf);
      }
    }

    // epilogue: O / l in bf16, rows g and g + 8 of this warp
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.f / l[r];
    }
    const int row0 = blockIdx.x * T::kQRows + cw * 64 + warp * 16 + g;
    __nv_bfloat16* ob = p.o + blockIdx.z * p.o_sb + blockIdx.y * p.o_sh;
#pragma unroll
    for (int i = 0; i < NV / 2; i += 2) {
      const int r = (i >> 1) & 1, row = row0 + 8 * r;
      const int col = 8 * (i / 4) + 2 * t;
      if (row < p.Lq && col < p.D)
        *reinterpret_cast<uint32_t*>(ob + row * p.o_sl + col) =
            pack_bf16(o[i] * l[r], o[i + 1] * l[r]);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query, without
// linking libcuda.
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// The caller's tensors: bases, sizes and (batch, sequence, head) element
// strides.
struct Args {
  const void *q, *k, *v;
  int B, H, Lq, Lk, D;
  long long qs[3], ks[3], vs[3];
};

// (B, L, H, D) bf16 with element strides (st[0], st[1], st[2], 1) as the
// 4-D view (D, H, L, B); 64 x 1 x rows x 1 boxes, 128-byte swizzle, zeros
// out of bounds.
bool encode(CUtensorMap* map, const void* ptr, int B, int L, int H, int D,
            const long long* st, int rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NV>
cudaError_t launch(const Args& a, const Params& p, cudaStream_t stream) {
  using T = Tile<NV>;
  // once per device: the register check behind setmaxnreg, and the shared
  // memory above 48 KB, which has to be asked for
  static uint64_t ready = 0;  // bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(ready >> dev & 1)) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, flash_fwd_kernel<NV>);
    if (err != cudaSuccess) return err;
    if (attr.numRegs < T::kLaunchRegs) return cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(flash_fwd_kernel<NV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready |= 1ull << dev;
  }
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, a.q, a.B, a.Lq, a.H, a.D, a.qs, T::kQRows) ||
      !encode(&tk, a.k, a.B, a.Lk, a.H, a.D, a.ks, kKeys) ||
      !encode(&tv, a.v, a.B, a.Lk, a.H, a.D, a.vs, kKeys))
    return cudaErrorUnknown;
  dim3 grid((a.Lq + T::kQRows - 1) / T::kQRows, a.H, a.B);
  flash_fwd_kernel<NV><<<grid, T::kThreads, T::kSmem, stream>>>(tq, tk, tv,
                                                                p);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for inputs the kernel does
// not take (D % 8 != 0, D > 128, misaligned bases or strides), cudaErrorUnknown
// if a tensor map cannot be encoded.
extern "C" int mvedit_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Lq, int Lk, int D, long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long o_sb, long long o_sl,
    long long o_sh, float scale, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || B > 65535 || H > 65535 ||
      D < 8 || D > 128 || D % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long strides[] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
                               v_sb, v_sl, v_sh, o_sl, o_sh, o_sb};
  for (long long s : strides)
    if (s <= 0 || s % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {q, k, v, o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {q, k, v, B, H, Lq, Lk, D, {q_sb, q_sl, q_sh},
                  {k_sb, k_sl, k_sh}, {v_sb, v_sl, v_sh}};
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = o_sb;
  p.o_sl = o_sl;
  p.o_sh = o_sh;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  p.sl2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return static_cast<int>(launch<16>(a, p, s));
  if (D <= 32) return static_cast<int>(launch<32>(a, p, s));
  if (D <= 40) return static_cast<int>(launch<40>(a, p, s));
  if (D <= 48) return static_cast<int>(launch<48>(a, p, s));
  if (D <= 64) return static_cast<int>(launch<64>(a, p, s));
  if (D <= 80) return static_cast<int>(launch<80>(a, p, s));
  if (D <= 96) return static_cast<int>(launch<96>(a, p, s));
  return static_cast<int>(launch<128>(a, p, s));
}
