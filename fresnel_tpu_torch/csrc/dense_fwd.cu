// Dense splat forward (K5) for NVIDIA Hopper (sm_90a).
//
// Replaces the chunked lax.scan accumulations of
// fresnel_tpu/render/wave.py::render_wave_field (:63-84) and of
// fresnel_tpu/render/fourier.py::render_fourier, mode "spatial"
// (:85-106): every Gaussian of an image splatted onto every pixel, with no
// compositing (the sums do not depend on order).  No Pallas kernel takes
// either; XLA runs them as scans over chunks of 64 Gaussians.
//
// Input:  params (B, N, 8) float32 per Gaussian (dense_common.cuh);
//         V      (B, N, C) float32, the values splatted (C = 8 WAVE, 3 ISO).
// Output: out    (B, H * W, C) float32, row-major pixels
//                (p = y * W + x at integer coordinates (x, y)).
//
// What bounds it: the pixel-Gaussian pairs within reach.  Only a few
// hundred of an image's thousands of Gaussians reach any one 16 x 16 tile
// (at experiment 4's launch ~440 of 5 476 per pixel), so a kernel that
// tests every Gaussian in every thread spends its time culling; what is
// left is a few floating-point operations per pair and the shared-memory
// reads that feed them.  Bytes are no limit: each block reads the image's
// parameters once and writes its tile once.
//
// Design: one block of 256 threads per 16 x 16 tile of one image, one
// thread per pixel, B images in one launch.
//   1. Cull together.  The image's Gaussians are staged 256 at a time, one
//      per thread: each thread tests its Gaussian once (opacity 0 or a
//      reach that clearly misses the tile: every w there is exactly 0) and
//      the survivors are compacted into a shared list in index order (a
//      warp ballot, __popc and a prefix over the 8 warps' counts).
//   2. No division per pair.  A listed Gaussian keeps its derived
//      constants in shared memory: ISO, -1 / den, and then the separable
//      factors of the tile's 16 columns and 16 rows (the row's times the
//      opacity), so a pair costs one multiply and a multiply-add per
//      channel; WAVE, the conic, and one expf of the quadratic form per
//      pair inside the box (the cross term makes it non-separable).
//   3. Every thread then walks the list only, summing w * V in registers.
// Each pixel sums its Gaussians in index order, with no atomics: the
// result repeats bit for bit.  Pixels past the image's edge (H or W not a
// multiple of 16) compute and are not written.

#include "dense_common.cuh"

namespace {

using namespace dense;

constexpr int TS = 16;
constexpr int STAGE = NTHREADS;   // Gaussians staged and tested at once
constexpr int NWARP = NTHREADS / 32;

template <int MODE>
struct Shared;

// WAVE: per listed Gaussian (mx, my, radius, opacity), (a, b, c, 0) and V.
template <>
struct Shared<WAVE> {
  float4 g0[STAGE];
  float4 g1[STAGE];
  float4 v[STAGE][2];
};

// ISO: per listed Gaussian (mx, my, -1 / den, opacity), V, and the
// factors of the tile's columns and rows (the row's times the opacity).
template <>
struct Shared<ISO> {
  float4 g0[STAGE];
  float4 v[STAGE];
  float col[STAGE][TS];
  float row[STAGE][TS];
};

template <int MODE>
__global__ void __launch_bounds__(NTHREADS)
dense_splat(const float* __restrict__ params, const float* __restrict__ V,
            float* __restrict__ out, int N, int H, int W, int n_tiles_x) {
  constexpr int C = Mode<MODE>::C;
  __shared__ Shared<MODE> sh;
  __shared__ int warp_count[NWARP];
  const int b = blockIdx.y;
  const int x0 = (blockIdx.x % n_tiles_x) * TS;
  const int y0 = (blockIdx.x / n_tiles_x) * TS;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int tx = t % TS;
  const int ty = t / TS;
  const float px = static_cast<float>(x0 + tx);
  const float py = static_cast<float>(y0 + ty);
  const float* pb = params + static_cast<size_t>(b) * N * NP;
  const float* vb = V + static_cast<size_t>(b) * N * C;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  for (int first = 0; first < N; first += STAGE) {
    // 1. Each thread tests one Gaussian against the tile.
    const int gi = first + t;
    float g[NP];
    bool keep = false;
    if (gi < N) {
#pragma unroll
      for (int k = 0; k < NP; ++k) g[k] = pb[static_cast<size_t>(gi) * NP + k];
      const float den = iso_den<MODE>(g[CA]);
      const float r = reach<MODE>(g[RADIUS], den) + 1.0f;
      keep = g[OPACITY] != 0.0f &&
             !(g[MX] + r < x0 || g[MX] - r > x0 + TS - 1 || g[MY] + r < y0 ||
               g[MY] - r > y0 + TS - 1);
    }
    const unsigned ballot = __ballot_sync(FULL, keep);
    __syncthreads();   // the previous stage's list has been walked
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int slot = __popc(ballot & ((1u << lane) - 1u));
    int listed = 0;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const int n = warp_count[w];
      slot += w < warp ? n : 0;
      listed += n;
    }
    if (keep) {
      const float* vg = vb + static_cast<size_t>(gi) * C;
      if constexpr (MODE == WAVE) {
        sh.g0[slot] = make_float4(g[MX], g[MY], g[RADIUS], g[OPACITY]);
        sh.g1[slot] = make_float4(g[CA], g[CB], g[CC], 0.0f);
        sh.v[slot][0] = make_float4(vg[0], vg[1], vg[2], vg[3]);
        sh.v[slot][1] = make_float4(vg[4], vg[5], vg[6], vg[7]);
      } else {
        sh.g0[slot] = make_float4(g[MX], g[MY], -1.0f / iso_den<ISO>(g[CA]),
                                  g[OPACITY]);
        sh.v[slot] = make_float4(vg[0], vg[1], vg[2], 0.0f);
      }
    }
    if (listed == 0) continue;
    __syncthreads();

    if constexpr (MODE == WAVE) {
      // 3. WAVE: one expf of the quadratic form per pair inside the box.
#pragma unroll 2
      for (int j = 0; j < listed; ++j) {
        const float4 q0 = sh.g0[j];
        const float4 q1 = sh.g1[j];
        const float dx = px - q0.x;
        const float dy = py - q0.y;
        const bool in = (fabsf(dx) <= q0.z) & (fabsf(dy) <= q0.z);
        const float w = in ? wave_e(q1.x, q1.y, q1.z, dx, dy) * q0.w : 0.0f;
        const float4 v0 = sh.v[j][0];
        const float4 v1 = sh.v[j][1];
        acc[0] += w * v0.x;
        acc[1] += w * v0.y;
        acc[2] += w * v0.z;
        acc[3] += w * v0.w;
        acc[4] += w * v1.x;
        acc[5] += w * v1.y;
        acc[6] += w * v1.z;
        acc[7] += w * v1.w;
      }
    } else {
      // 2. ISO: the listed Gaussians' column and row factors, once each.
      for (int i = t; i < listed * 2 * TS; i += NTHREADS) {
        const int j = i / (2 * TS);
        const int k = i % (2 * TS);
        const float4 q = sh.g0[j];
        if (k < TS) {
          sh.col[j][k] = iso_factor(static_cast<float>(x0 + k) - q.x, q.z);
        } else {
          sh.row[j][k - TS] =
              iso_factor(static_cast<float>(y0 + k - TS) - q.y, q.z) * q.w;
        }
      }
      __syncthreads();
      // 3. ISO: w = column factor * (row factor * opacity) per pair.
#pragma unroll 4
      for (int j = 0; j < listed; ++j) {
        const float w = sh.col[j][tx] * sh.row[j][ty];
        const float4 v = sh.v[j];
        acc[0] += w * v.x;
        acc[1] += w * v.y;
        acc[2] += w * v.z;
      }
    }
  }
  const int x = x0 + tx;
  const int y = y0 + ty;
  if (x < W && y < H) {
    float* o = out + (static_cast<size_t>(b) * H * W + y * W + x) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = acc[c];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// mode 0 WAVE, 1 ISO.  The caller allocates every buffer; nothing is
// synchronised here.
extern "C" int dense_fwd(const float* params, const float* V, float* out,
                         int B, int N, int H, int W, int mode, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const int ntx = (W + TS - 1) / TS;
  const int nty = (H + TS - 1) / TS;
  const dim3 grid(ntx * nty, B);
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == WAVE)
    dense_splat<WAVE><<<grid, NTHREADS, 0, s>>>(params, V, out, N, H, W, ntx);
  else if (mode == ISO)
    dense_splat<ISO><<<grid, NTHREADS, 0, s>>>(params, V, out, N, H, W, ntx);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
