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
// Design: one block of 256 threads per 16 x 16 pixel tile of one image
// (one thread per pixel; B images in one launch).  The image's Gaussians
// are staged through shared memory 128 at a time; each thread sums w * V
// over them in index order, in registers.  A Gaussian whose reach (the WAVE
// box; in ISO mode where the exponent passes -110) clearly misses the tile
// is skipped by the whole block (every w there is exactly 0), as is any
// Gaussian of opacity 0.  No atomics: the result repeats bit for bit.

#include "dense_common.cuh"

namespace {

using namespace dense;

constexpr int TS = 16;
constexpr int STAGE = 128;

template <int MODE>
__global__ void __launch_bounds__(NTHREADS)
dense_splat(const float* __restrict__ params, const float* __restrict__ V,
            float* __restrict__ out, int N, int H, int W, int n_tiles_x) {
  constexpr int C = Mode<MODE>::C;
  __shared__ float sp[STAGE * NP];
  __shared__ float sv[STAGE * C];
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int x0 = (tile % n_tiles_x) * TS;
  const int y0 = (tile / n_tiles_x) * TS;
  const int p = threadIdx.x;
  const int x = x0 + p % TS;
  const int y = y0 + p / TS;
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  const float* pb = params + static_cast<size_t>(b) * N * NP;
  const float* vb = V + static_cast<size_t>(b) * N * C;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  for (int first = 0; first < N; first += STAGE) {
    const int cnt = min(STAGE, N - first);
    __syncthreads();
    for (int i = p; i < cnt * NP; i += NTHREADS)
      sp[i] = pb[static_cast<size_t>(first) * NP + i];
    for (int i = p; i < cnt * C; i += NTHREADS)
      sv[i] = vb[static_cast<size_t>(first) * C + i];
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float* g = sp + j * NP;
      if (g[OPACITY] == 0.0f) continue;
      const float den = iso_den<MODE>(g);
      const float r = reach<MODE>(g, den) + 1.0f;
      if (g[MX] + r < x0 || g[MX] - r > x0 + TS - 1 || g[MY] + r < y0 ||
          g[MY] - r > y0 + TS - 1)
        continue;
      const float w = splat_e<MODE>(g, px - g[MX], py - g[MY], den) *
                      g[OPACITY];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += w * sv[j * C + c];
    }
  }
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
