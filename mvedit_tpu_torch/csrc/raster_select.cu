// Raster selection for Hopper (sm_90a): per 16 x 16 screen tile, the
// nearest covering triangle of each pixel.
//
// Replaces the TPU kernel `mvedit_tpu/models/mesh/select_pallas.py::
// select_pallas` (body `_select_kernel`) together with the XLA pass that
// feeds it, `prepare_coeffs`. Each tile's candidate axis is its bin list
// (tile_tris, T x Kt) followed by the global big list (big_tris, Kb); an
// index >= Kt points into the big list. Every pixel centre (x + 0.5,
// y + 0.5) is tested against three sign-folded edge functions and the
// screen-space 1/z plane, each affine in the pixel:
//   w_i(q) = alpha_i qx + beta_i qy + gamma_i,  1/z(q) = zx qx + zy qy + zc.
// A pixel keeps the covering candidate with the largest 1/z (key -1/z
// smallest), replacing its winner only on a strictly smaller key, so ties
// go to the lowest candidate index; a covered key that is NaN or not below
// 3e38 is never taken. Outputs: the winner's index into the candidate axis
// (int32), its key (float32) and its face id (int64); 0, 3e38 and -1 where
// nothing covers the pixel.
//
// Numerics: every product, sum and quotient rounds on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn; the file builds with -fmad=false) in the order of
// the plain version (`kernels/raster_select.py::prepare_coeffs` /
// `select_reference`), so ids and keys are bit-equal to it.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; `chip_smoke.py`
// `raster_bound`, counted from the call's data: edge tests only on the
// pixel-candidate pairs that the exact reject below keeps): at every path
// config the bound is the bytes, a few microseconds: 3.5 us at the fit's
// 512^2 (K 1024 + 64), 2.2 us at `load_init_mesh`'s (K 256 + 64),
// 0.7 / 0.23 us at the 256^2 / 128^2 ramp, 8.5 us at the bake's 1024^2
// (K 64 + 32). The PR 2 kernel's device time sat at 11-160x these bounds
// because
//  (a) every thread walked all K slots, most of them padding;
//  (b) every pixel tested every candidate, though a DMTet triangle at span
//      2 covers a few pixels of its tile;
//  (c) one 8-warp CTA per tile left the SMs short of warps at 128^2 (64
//      tiles) and 256^2 (256 tiles);
//  (d) the wrapper cast and concatenated the lists on every call.
// This kernel sits at 4-44x them (16x at the fit). What is left binds by
// latency: each chunk is a chain of dependent
// loads (mask and id, face, corners) and two barriers, and each warp's
// scan a chain of shared-memory loads and rounded tests; on the fit's
// config the build and the scan take about half of the time each
// (ablations, PERF.md).
// The design, step by step:
//  (1) Compaction. The CTA walks the candidate axis in chunks of one slot
//      per thread; a thread loads its slot's mask and id together, then
//      the face and corners where the mask is set, and computes the 12
//      coefficients. Invalid slots, out-of-range ids and degenerate
//      triangles (|area| <= 1e-12, or area <= 1e-12 with culling) drop
//      out, and so does a candidate that no pixel of the tile can find
//      covered (below). Survivors are written to shared memory in
//      candidate-axis order (a warp ballot and a prefix over the warps'
//      counts), each with its original index. The mask is read as a mask:
//      the big list's padding (face 0, valid when face 0 is big) stays,
//      and its duplicates lose their ties by index.
//  (2) Reject per warp. Each warp owns an 8 x 4 pixel block (2 x 4 blocks
//      per tile). For each survivor the CTA evaluates which blocks it may
//      cover and appends it, in candidate-axis order again (one ballot per
//      block), to those blocks' lists; a warp walks only its block's list,
//      two entries at a time, with the edges as two float4 and a float
//      and the 1/z plane read only for a covered pixel. The block test is
//      exact for the rounded tests, with no margin to argue: the computed
//      edge value
//        fl(fl(fl(alpha qx) + fl(beta qy)) + gamma)
//      is monotone in qx (non-decreasing for alpha >= 0, non-increasing
//      for alpha < 0) and in qy likewise, because each product is monotone
//      in q and round-to-nearest is monotone. So over a block's pixel
//      centres it is largest at the corner picked by the signs of alpha
//      and beta, evaluated by the same ops on the same centres; if that
//      value is not >= 0 (negative or NaN) for some edge, no pixel of the
//      block passes that edge. (A NaN at the corner needs an infinite
//      product or gamma, which then makes every pixel's value -inf or
//      NaN.) A box of the vertices grown by a margin would not be safe:
//      past the apex of a needle the rounded edge tests may pass for
//      pixels far outside it. The tile's own test is the union of its
//      blocks'.
//  (3) Small grids. Below 16 tiles per SM the CTA has 2 warps per pixel
//      block (4 below 4 tiles per SM: the 128^2 and 256^2 ramp), which take
//      the block's list in turns; their (key, index) pairs are combined in
//      shared memory by the smaller key and, on equal keys, the lower
//      index. The float compare keeps -0.0 == +0.0 as the scan does, so no
//      sign canonicalisation is needed (no packed 64-bit min is used).
//  (4) No copies per call: the kernel reads the path's tensors as they
//      are (f32 pts, int64 faces and ids, bool masks, the tile and big
//      lists apart) and writes the winner's face id, so `rasterize` needs
//      no gather.
// ptxas (sm_90a, -fmad=false; `raster_select.nvcc.log`): 63 registers and
// 44160 / 39488 bytes of static shared memory at 4 / 2 warps per block,
// 40 registers (capped for 6 CTAs per SM) and 18720 bytes at 1, no spills.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;                 // tile edge in pixels
constexpr int kPix = kTile * kTile;       // one warp per 8 x 4 block
constexpr int kBlocks = kPix / 32;        // 8: 2 across, 4 down
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
// the correctly rounded reciprocal: the bits of an IEEE 1 / a
__device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }

// a pixel centre coordinate, as the plain version forms it
__device__ __forceinline__ float centre(int i) { return (float)i + 0.5f; }

struct Params {
  const float* pts;            // (V, 3) pixel-space (u, v, z_cam)
  const long long* faces;      // (F, 3)
  const long long* tris;       // (T, Kt) bin lists
  const bool* valid;           // (T, Kt)
  const long long* big_tris;   // (Kb,) the big list, shared by every tile
  const bool* big_valid;       // (Kb,)
  long long F;
  int Kt, Kb, tiles_x, cull;
  int* best;                   // (T, 256)
  float* key;                  // (T, 256)
  long long* face;             // (T, 256)
};

// The face id in candidate slot j of tile t, -1 where its mask is clear
// or j is past the axis. The mask and the id are loaded together.
__device__ __forceinline__ long long slot_id(const Params& p, int t, int j) {
  if (j >= p.Kt + p.Kb) return -1;
  bool v;
  long long id;
  if (j < p.Kt) {
    const long long o = (long long)t * p.Kt + j;
    v = p.valid[o];
    id = __ldg(p.tris + o);
  } else {
    v = p.big_valid[j - p.Kt];
    id = __ldg(p.big_tris + (j - p.Kt));
  }
  return v ? id : -1;
}

// The 12 coefficients of face `id` into c; true when the id is in range
// and the triangle not degenerate.
__device__ __forceinline__ bool coeffs(const Params& p, long long id,
                                       float* c) {
  if (id < 0 || id >= p.F) return false;
  const long long ia = __ldg(p.faces + 3 * id), ib = __ldg(p.faces + 3 * id + 1),
                  ic = __ldg(p.faces + 3 * id + 2);
  const float ax = __ldg(p.pts + 3 * ia), ay = __ldg(p.pts + 3 * ia + 1),
              az = __ldg(p.pts + 3 * ia + 2);
  const float bx = __ldg(p.pts + 3 * ib), by = __ldg(p.pts + 3 * ib + 1),
              bz = __ldg(p.pts + 3 * ib + 2);
  const float cx = __ldg(p.pts + 3 * ic), cy = __ldg(p.pts + 3 * ic + 1),
              cz = __ldg(p.pts + 3 * ic + 2);
  const float al0 = -sub(cy, by), be0 = sub(cx, bx),
              ga0 = sub(mul(bx, cy), mul(cx, by));
  const float al1 = -sub(ay, cy), be1 = sub(ax, cx),
              ga1 = sub(mul(cx, ay), mul(ax, cy));
  const float al2 = -sub(by, ay), be2 = sub(bx, ax),
              ga2 = sub(mul(ax, by), mul(bx, ay));
  const float area = add(add(ga0, ga1), ga2);
  float sgn = 1.f;
  if (p.cull) {
    if (!(area > 1e-12f)) return false;
  } else {
    if (!(fabsf(area) > 1e-12f)) return false;
    sgn = area > 0.f ? 1.f : -1.f;
  }
  // the 1/z plane uses the unfolded coefficients and the signed area
  const float inv_area = rcp(area);
  const float iza = rcp(az), izb = rcp(bz), izc = rcp(cz);
  c[9] = mul(add(add(mul(al0, iza), mul(al1, izb)), mul(al2, izc)), inv_area);
  c[10] = mul(add(add(mul(be0, iza), mul(be1, izb)), mul(be2, izc)), inv_area);
  c[11] = mul(add(add(mul(ga0, iza), mul(ga1, izb)), mul(ga2, izc)), inv_area);
  c[0] = mul(al0, sgn); c[1] = mul(be0, sgn); c[2] = mul(ga0, sgn);
  c[3] = mul(al1, sgn); c[4] = mul(be1, sgn); c[5] = mul(ga1, sgn);
  c[6] = mul(al2, sgn); c[7] = mul(be2, sgn); c[8] = mul(ga2, sgn);
  return true;
}

// Bit b set when block b (8 x 4 pixels at (8 (b % 2), 4 (b / 2)) in the
// tile whose first pixel is (x0, y0)) may hold a pixel that passes all
// three edge tests: each edge is evaluated at the block corner where it is
// largest (see the note at the top).
__device__ __forceinline__ unsigned block_mask(const float* c, int x0,
                                               int y0) {
  unsigned m = (1u << kBlocks) - 1;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float al = c[3 * e], be = c[3 * e + 1], ga = c[3 * e + 2];
    const int dx = al >= 0.f ? 7 : 0, dy = be >= 0.f ? 3 : 0;
    float hx[2], hy[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) hx[i] = mul(al, centre(x0 + 8 * i + dx));
#pragma unroll
    for (int i = 0; i < 4; ++i) hy[i] = mul(be, centre(y0 + 4 * i + dy));
    unsigned me = 0;
#pragma unroll
    for (int b = 0; b < kBlocks; ++b)
      me |= (add(add(hx[b & 1], hy[b >> 1]), ga) >= 0.f ? 1u : 0u) << b;
    m &= me;
  }
  return m;
}

// The three edge tests of one survivor at a pixel centre, all evaluated
// (no branch), as the plain version rounds them.
__device__ __forceinline__ float affine(float a, float b, float c, float qx,
                                        float qy) {
  return add(add(mul(a, qx), mul(b, qy)), c);
}
__device__ __forceinline__ bool covered(float4 u, float4 v, float g2,
                                        float qx, float qy) {
  return (affine(u.x, u.y, u.z, qx, qy) >= 0.f) &
         (affine(u.w, v.x, v.y, qx, qy) >= 0.f) &
         (affine(v.z, v.w, g2, qx, qy) >= 0.f);
}
// A covered survivor replaces the pixel's winner only on a strictly
// smaller key (-1/z): ties keep the earlier one in list order.
__device__ __forceinline__ void take(float4 z, int idx, float qx, float qy,
                                     float& best_key, int& best_idx) {
  const float k = -affine(z.x, z.y, z.z, qx, qy);
  if (k < best_key) {
    best_key = k;
    best_idx = idx;
  }
}

// S warps per pixel block; C candidate slots per chunk (one per thread of
// the first C threads)
template <int S>
__global__ void __launch_bounds__(kPix * S, S == 1 ? 6 : (S == 2 ? 2 : 1))
raster_select_kernel(Params p) {
  constexpr int C = kPix * S < 512 ? kPix * S : 512;
  constexpr int kWarps = kPix * S / 32;
  constexpr int kBuildWarps = C / 32;
  // each survivor's edges as two float4 and a float, (a0 b0 g0 a1)
  // (b1 g1 a2 b2) g2, and its 1/z plane (zx zy zc) as a float4 that the
  // scan reads only for a covered pixel
  __shared__ float4 ce[2][C];
  __shared__ float cg2[C];
  __shared__ float4 cz[C];
  __shared__ int cidx[C];
  __shared__ unsigned short blist[kBlocks][C];  // per block, entries of ce
  __shared__ int wlive[kWarps];
  __shared__ int wblk[kBlocks][kWarps];
  __shared__ float part_key[S > 1 ? S - 1 : 1][kPix];
  __shared__ int part_idx[S > 1 ? S - 1 : 1][kPix];

  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = warp % kBlocks, split = warp / kBlocks;
  const int x0 = (t % p.tiles_x) * kTile, y0 = (t / p.tiles_x) * kTile;
  const int px = (blk & 1) * 8 + (lane & 7);
  const int py = (blk >> 1) * 4 + (lane >> 3);
  const float qx = centre(x0 + px), qy = centre(y0 + py);
  const int K = p.Kt + p.Kb;
  const unsigned lt = (1u << lane) - 1u;

  float best_key = kBig;
  int best_idx = 0;
  for (int k0 = 0; k0 < K; k0 += C) {
    // (1) coefficients and block masks of this chunk's slots
    const int j = k0 + tid;
    float c[12];
    unsigned m = 0;
    if (tid < C && coeffs(p, slot_id(p, t, j), c)) m = block_mask(c, x0, y0);
    const unsigned live = __ballot_sync(0xffffffffu, m != 0);
    int off[kBlocks];
#pragma unroll
    for (int b = 0; b < kBlocks; ++b) {
      const unsigned bb = __ballot_sync(0xffffffffu, (m >> b) & 1u);
      off[b] = __popc(bb & lt);
      if (lane == 0) wblk[b][warp] = __popc(bb);
    }
    if (lane == 0) wlive[warp] = __popc(live);
    __syncthreads();
    // (2) survivors in candidate-axis order: into the coefficient arrays
    // at their rank among the live slots, and into the list of each block
    // they may cover at their rank among that block's
    if (m) {
      int pos = __popc(live & lt);
      for (int w = 0; w < warp; ++w) pos += wlive[w];
      ce[0][pos] = make_float4(c[0], c[1], c[2], c[3]);
      ce[1][pos] = make_float4(c[4], c[5], c[6], c[7]);
      cg2[pos] = c[8];
      cz[pos] = make_float4(c[9], c[10], c[11], 0.f);
      cidx[pos] = j;
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) {
        if ((m >> b) & 1u) {
          int q = off[b];
          for (int w = 0; w < warp; ++w) q += wblk[b][w];
          blist[b][q] = (unsigned short)pos;
        }
      }
    }
    int nb = 0;
#pragma unroll
    for (int w = 0; w < kBuildWarps; ++w) nb += wblk[blk][w];
    __syncthreads();
    // (3) each warp tests its pixels against its block's list, two entries
    // at a time, in list order; the S warps of a block take the entries in
    // turns
    const unsigned short* list = blist[blk];
    int i = split;
    for (; i + S < nb; i += 2 * S) {
      const int e0 = list[i], e1 = list[i + S];
      const bool c0 = covered(ce[0][e0], ce[1][e0], cg2[e0], qx, qy);
      const bool c1 = covered(ce[0][e1], ce[1][e1], cg2[e1], qx, qy);
      if (c0) take(cz[e0], cidx[e0], qx, qy, best_key, best_idx);
      if (c1) take(cz[e1], cidx[e1], qx, qy, best_key, best_idx);
    }
    if (i < nb) {
      const int e0 = list[i];
      if (covered(ce[0][e0], ce[1][e0], cg2[e0], qx, qy))
        take(cz[e0], cidx[e0], qx, qy, best_key, best_idx);
    }
    // the next chunk writes the coefficients and the lists only after its
    // first barrier, which every warp reaches after this scan
  }

  const int pix = py * kTile + px;
  if (S > 1) {
    // (4) combine the block's S partial winners: smaller key, then lower
    // index (the float compare holds -0.0 == +0.0, as the scan does)
    if (split > 0) {
      part_key[split - 1][pix] = best_key;
      part_idx[split - 1][pix] = best_idx;
    }
    __syncthreads();
    if (split == 0) {
#pragma unroll
      for (int s = 0; s < S - 1; ++s) {
        const float k = part_key[s][pix];
        const int i = part_idx[s][pix];
        if (k < best_key || (k == best_key && i < best_idx)) {
          best_key = k;
          best_idx = i;
        }
      }
    }
  }
  if (split == 0) {
    const long long o = (long long)t * kPix + pix;
    long long f = -1;
    if (best_key < kBig)
      f = best_idx < p.Kt ? __ldg(p.tris + (long long)t * p.Kt + best_idx)
                          : __ldg(p.big_tris + (best_idx - p.Kt));
    p.best[o] = best_idx;
    p.key[o] = best_key;
    p.face[o] = f;
  }
}

}  // namespace

extern "C" int mvedit_raster_select(
    const void* pts, const void* faces, long long F, const void* tris,
    const void* valid, int T, int Kt, const void* big_tris,
    const void* big_valid, int Kb, int tiles_x, int cull, int splits,
    void* best, void* key, void* face, void* stream) {
  Params p;
  p.pts = static_cast<const float*>(pts);
  p.faces = static_cast<const long long*>(faces);
  p.F = F;
  p.tris = static_cast<const long long*>(tris);
  p.valid = static_cast<const bool*>(valid);
  p.big_tris = static_cast<const long long*>(big_tris);
  p.big_valid = static_cast<const bool*>(big_valid);
  p.Kt = Kt; p.Kb = Kb; p.tiles_x = tiles_x; p.cull = cull;
  p.best = static_cast<int*>(best);
  p.key = static_cast<float*>(key);
  p.face = static_cast<long long*>(face);
  if (T <= 0 || Kt < 0 || Kb < 0 || tiles_x <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (splits) {
    case 1: raster_select_kernel<1><<<T, kPix, 0, s>>>(p); break;
    case 2: raster_select_kernel<2><<<T, 2 * kPix, 0, s>>>(p); break;
    case 4: raster_select_kernel<4><<<T, 4 * kPix, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
