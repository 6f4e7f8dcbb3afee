// Raster selection for Hopper (sm_90a): per screen tile, the nearest
// covering triangle of each pixel.
//
// Replaces the TPU kernel `mvedit_tpu/models/mesh/select_pallas.py::
// select_pallas` (body `_select_kernel`) together with the XLA pass that
// feeds it, `prepare_coeffs`. For each tile x tile screen tile and its K
// candidate triangles (the tile's bin list plus the global big list), every
// pixel centre (x + 0.5, y + 0.5) is tested against three edge functions
// and the screen-space 1/z plane, each affine in the pixel:
//   w_i(q) = alpha_i qx + beta_i qy + gamma_i,  1/z(q) = zx qx + zy qy + zc.
// A pixel keeps the covering candidate with the largest 1/z (key -1/z
// smallest), replacing its running winner only on a strictly smaller key,
// so ties go to the lowest candidate index. Outputs: best index into the
// candidate axis (int32) and key (float32), 3e38 and 0 where nothing
// covers the pixel.
//
// Design (simple and right first):
//  - one CTA per tile, one thread per pixel (256 threads at tile 16);
//  - the candidate list is walked in chunks of kChunk: the threads of the
//    CTA gather each chunk's triangle corners from `pts` / `faces` and
//    compute its 12 coefficients into shared memory (structure of arrays,
//    so the per-pixel reads are broadcasts); then every thread tests its
//    pixel against the chunk. The coefficient array the TPU path writes
//    to HBM ((T, K, 12) f32, 57 MB per view at 512^2) never exists here;
//  - the sign of the triangle's area is folded into the edge coefficients
//    (covered <=> all three >= 0 for either winding); the 1/z plane is
//    divided by the signed area; invalid or degenerate candidates get
//    edges (0, 0, -1) and are never covered;
//  - every product, sum and quotient rounds on its own (__fmul_rn,
//    __fadd_rn, __fdiv_rn, and the file builds with -fmad=false), in the
//    order the plain PyTorch version (`kernels/raster_select.py::
//    prepare_coeffs` / `select_reference`) evaluates them, so pixels on an
//    edge decide as the plain version decides and the ids match it at
//    every pixel.
//
// What bounds it on an H100: at the fit's 512^2 config (1024 tiles, K =
// 1088) one view is ~2.9e8 pixel-candidate tests of a few FP32 ops each,
// plus ~1.1e6 coefficient sets gathered through L2; shared-memory
// broadcast reads of the coefficients (3 per test that fails the first
// edge) and the chunk barriers bound it, not device memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;        // candidates per shared-memory chunk
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rcp(float a) { return __fdiv_rn(1.0f, a); }

struct Params {
  const float* pts;       // (V, 3) pixel-space (u, v, z_cam)
  const int* faces;       // (F, 3)
  const int* cand;        // (T, K) face ids
  const uint8_t* valid;   // (T, K)
  int T, K, tile, tiles_x, cull, F;
  int* best;              // (T, tile * tile)
  float* key;             // (T, tile * tile)
};

__global__ void __launch_bounds__(1024)
raster_select_kernel(Params p) {
  __shared__ float co[12][kChunk];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int P = p.tile * p.tile;
  const float qx = (float)((t % p.tiles_x) * p.tile + tid % p.tile) + 0.5f;
  const float qy = (float)((t / p.tiles_x) * p.tile + tid / p.tile) + 0.5f;
  const int* cand = p.cand + (long long)t * p.K;
  const uint8_t* valid = p.valid + (long long)t * p.K;

  float best_key = kBig;
  int best_idx = 0;
  for (int k0 = 0; k0 < p.K; k0 += kChunk) {
    const int n = min(kChunk, p.K - k0);
    for (int j = tid; j < n; j += blockDim.x) {
      const int c = __ldg(cand + k0 + j);
      bool ok = __ldg(valid + k0 + j) != 0 && c >= 0 && c < p.F;
      float al0 = 0.f, be0 = 0.f, ga0 = -1.f, al1 = 0.f, be1 = 0.f,
            ga1 = -1.f, al2 = 0.f, be2 = 0.f, ga2 = -1.f;
      float zx = 0.f, zy = 0.f, zc = 0.f;
      if (ok) {
        const int ia = __ldg(p.faces + 3 * c), ib = __ldg(p.faces + 3 * c + 1),
                  ic = __ldg(p.faces + 3 * c + 2);
        const float ax = __ldg(p.pts + 3 * ia), ay = __ldg(p.pts + 3 * ia + 1),
                    az = __ldg(p.pts + 3 * ia + 2);
        const float bx = __ldg(p.pts + 3 * ib), by = __ldg(p.pts + 3 * ib + 1),
                    bz = __ldg(p.pts + 3 * ib + 2);
        const float cx = __ldg(p.pts + 3 * ic), cy = __ldg(p.pts + 3 * ic + 1),
                    cz = __ldg(p.pts + 3 * ic + 2);
        al0 = -sub(cy, by); be0 = sub(cx, bx); ga0 = sub(mul(bx, cy), mul(cx, by));
        al1 = -sub(ay, cy); be1 = sub(ax, cx); ga1 = sub(mul(cx, ay), mul(ax, cy));
        al2 = -sub(by, ay); be2 = sub(bx, ax); ga2 = sub(mul(ax, by), mul(bx, ay));
        const float area = add(add(ga0, ga1), ga2);
        float sgn = 1.f;
        if (p.cull) {
          ok = area > 1e-12f;
        } else {
          ok = fabsf(area) > 1e-12f;
          sgn = area > 0.f ? 1.f : -1.f;   // |area| > 1e-12 here
        }
        if (ok) {
          // the 1/z plane uses the unfolded coefficients and the signed area
          const float inv_area = rcp(area);
          const float iza = rcp(az), izb = rcp(bz), izc = rcp(cz);
          zx = mul(add(add(mul(al0, iza), mul(al1, izb)), mul(al2, izc)), inv_area);
          zy = mul(add(add(mul(be0, iza), mul(be1, izb)), mul(be2, izc)), inv_area);
          zc = mul(add(add(mul(ga0, iza), mul(ga1, izb)), mul(ga2, izc)), inv_area);
          al0 = mul(al0, sgn); be0 = mul(be0, sgn); ga0 = mul(ga0, sgn);
          al1 = mul(al1, sgn); be1 = mul(be1, sgn); ga1 = mul(ga1, sgn);
          al2 = mul(al2, sgn); be2 = mul(be2, sgn); ga2 = mul(ga2, sgn);
        } else {
          al0 = be0 = al1 = be1 = al2 = be2 = 0.f;
          ga0 = ga1 = ga2 = -1.f;
        }
      }
      co[0][j] = al0; co[1][j] = be0; co[2][j] = ga0;
      co[3][j] = al1; co[4][j] = be1; co[5][j] = ga1;
      co[6][j] = al2; co[7][j] = be2; co[8][j] = ga2;
      co[9][j] = zx; co[10][j] = zy; co[11][j] = zc;
    }
    __syncthreads();
    if (tid < P) {
      for (int j = 0; j < n; ++j) {
        if (add(add(mul(co[0][j], qx), mul(co[1][j], qy)), co[2][j]) >= 0.f &&
            add(add(mul(co[3][j], qx), mul(co[4][j], qy)), co[5][j]) >= 0.f &&
            add(add(mul(co[6][j], qx), mul(co[7][j], qy)), co[8][j]) >= 0.f) {
          const float k = -add(add(mul(co[9][j], qx), mul(co[10][j], qy)),
                               co[11][j]);
          if (k < best_key) {
            best_key = k;
            best_idx = k0 + j;
          }
        }
      }
    }
    __syncthreads();
  }
  if (tid < P) {
    p.best[(long long)t * P + tid] = best_idx;
    p.key[(long long)t * P + tid] = best_key;
  }
}

}  // namespace

extern "C" int mvedit_raster_select(
    const void* pts, const void* faces, const void* cand, const void* valid,
    int T, int K, int tile, int tiles_x, int cull, int F, void* best,
    void* key, void* stream) {
  Params p;
  p.pts = static_cast<const float*>(pts);
  p.faces = static_cast<const int*>(faces);
  p.cand = static_cast<const int*>(cand);
  p.valid = static_cast<const uint8_t*>(valid);
  p.T = T; p.K = K; p.tile = tile; p.tiles_x = tiles_x; p.cull = cull;
  p.F = F;
  p.best = static_cast<int*>(best);
  p.key = static_cast<float*>(key);
  const int threads = tile * tile;
  if (T <= 0 || threads <= 0 || threads > 1024) return (int)cudaErrorInvalidValue;
  raster_select_kernel<<<T, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
