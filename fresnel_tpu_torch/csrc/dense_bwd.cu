// Dense splat backward (K6) for NVIDIA Hopper (sm_90a): the analytic VJP
// of dense_fwd.cu.
//
// Replaces the reverse-mode derivative XLA takes of the chunked scans of
// fresnel_tpu/render/wave.py::render_wave_field (:63-84) and
// fresnel_tpu/render/fourier.py::render_fourier, mode "spatial" (:85-106).
//
// Input:  params (B, N, 8), V (B, N, C) as the forward's; g_out (B, H * W,
//         C), the cotangent of its output.
// Output: g_params (B, N, 8): mean, conic a, b, c (ISO: sigma in column 2)
//         and opacity; radius and pad 0.  g_V (B, N, C).
//         part (8, B, N, 14) float32 scratch.
//
// For a pixel with weight w = e * opacity and dw = sum_c g_out[p, c] V[c]:
//   g_V[c] += w g_out[p, c];  g_opacity += dw e;
//   WAVE: dm = -dw w / 2 (m the quadratic form), then
//         g_mx += dm (-2 a dx - 2 b dy), g_my += dm (-2 b dx - 2 c dy),
//         g_a += dm dx^2, g_b += dm 2 dx dy, g_c += dm dy^2;
//   ISO:  with den = 2 sigma^2 + 1e-8 and r2 = dx^2 + dy^2,
//         g_mx += dw w 2 dx / den, g_my += dw w 2 dy / den,
//         g_sigma += dw w r2 / den^2 * 4 sigma.
// Design: the sums run over pixels for each Gaussian, so the threads are
// Gaussians: thread (b, g, band) walks the pixel rows of one of 8 bands of
// the image (only the rows and columns within its reach, past which every
// term is exactly 0: the WAVE box, the ISO exponent's -110), in order,
// summing its terms in registers; a second kernel adds the 8 bands' partials
// in order.  No atomics and no cross-thread reduction: the result repeats
// bit for bit.  In ISO mode the 32 lanes of a warp walk the same pixels, so
// each read of g_out is one broadcast.

#include "dense_common.cuh"

namespace {

using namespace dense;

constexpr int NBAND = 8;
constexpr int NT = 14;   // terms: mx, my, a, b, c, opacity, V[0..7]

// A pixel bound as an int, clamped far outside any image first.
__device__ __forceinline__ int to_int(float v) {
  return static_cast<int>(fminf(fmaxf(v, -1e6f), 1e6f));
}

template <int MODE>
__global__ void __launch_bounds__(NTHREADS)
dense_splat_bwd(const float* __restrict__ params,
                const float* __restrict__ V,
                const float* __restrict__ g_out, float* __restrict__ part,
                int B, int N, int H, int W) {
  constexpr int C = Mode<MODE>::C;
  const long long id = static_cast<long long>(blockIdx.x) * NTHREADS +
                       threadIdx.x;
  if (id >= static_cast<long long>(B) * N * NBAND) return;
  const int g_i = static_cast<int>(id % N);
  const int b = static_cast<int>((id / N) % B);
  const int band = static_cast<int>(id / (static_cast<long long>(N) * B));
  const size_t gi = static_cast<size_t>(b) * N + g_i;
  float g[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) g[k] = params[gi * NP + k];
  float v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = V[gi * C + c];
  float t[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) t[k] = 0.0f;

  const int rows = (H + NBAND - 1) / NBAND;
  int y_lo = band * rows, y_hi = min(H, (band + 1) * rows) - 1;
  int x_lo = 0, x_hi = W - 1;
  // The pixels within the reach (dense_common.cuh) and one more on each
  // side: beyond it every term is exactly 0.  Every pixel within is walked
  // whatever the opacity: the opacity's own gradient, sum dw e, does not
  // vanish with it.
  const float den = iso_den<MODE>(g);
  const float r = reach<MODE>(g, den);
  y_lo = max(y_lo, to_int(floorf(g[MY] - r)) - 1);
  y_hi = min(y_hi, to_int(ceilf(g[MY] + r)) + 1);
  x_lo = max(x_lo, to_int(floorf(g[MX] - r)) - 1);
  x_hi = min(x_hi, to_int(ceilf(g[MX] + r)) + 1);
  const bool live = isfinite(g[MX]) && isfinite(g[MY]);
  if (live) {
    for (int y = y_lo; y <= y_hi; ++y) {
      const float dy = static_cast<float>(y) - g[MY];
      const float* go = g_out + (static_cast<size_t>(b) * H * W +
                                 static_cast<size_t>(y) * W) * C;
      for (int x = x_lo; x <= x_hi; ++x) {
        const float dx = static_cast<float>(x) - g[MX];
        const float e = splat_e<MODE>(g, dx, dy, den);
        if (e == 0.0f) continue;
        const float w = e * g[OPACITY];
        float dw = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float gc = go[x * C + c];
          dw += gc * v[c];
          t[6 + c] += w * gc;
        }
        t[5] += dw * e;
        if (MODE == WAVE) {
          const float dm = dw * w * -0.5f;
          t[0] += dm * (-2.0f * g[CA] * dx - 2.0f * g[CB] * dy);
          t[1] += dm * (-2.0f * g[CB] * dx - 2.0f * g[CC] * dy);
          t[2] += dm * dx * dx;
          t[3] += dm * 2.0f * dx * dy;
          t[4] += dm * dy * dy;
        } else {
          const float k = dw * w / den;
          t[0] += k * 2.0f * dx;
          t[1] += k * 2.0f * dy;
          t[2] += k * (dx * dx + dy * dy) / den;
        }
      }
    }
  }
  float* q = part + ((static_cast<size_t>(band) * B + b) * N + g_i) * NT;
#pragma unroll
  for (int k = 0; k < NT; ++k) q[k] = t[k];
}

// Sums the bands' partials in order and lays them out as the gradients.
template <int MODE>
__global__ void __launch_bounds__(NTHREADS)
dense_splat_reduce(const float* __restrict__ params,
                   const float* __restrict__ part,
                   float* __restrict__ g_params, float* __restrict__ g_V,
                   int B, int N) {
  constexpr int C = Mode<MODE>::C;
  const long long id = static_cast<long long>(blockIdx.x) * NTHREADS +
                       threadIdx.x;
  if (id >= static_cast<long long>(B) * N) return;
  float t[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) t[k] = 0.0f;
  for (int band = 0; band < NBAND; ++band) {
    const float* q = part + (static_cast<size_t>(band) * B * N + id) * NT;
#pragma unroll
    for (int k = 0; k < NT; ++k) t[k] += q[k];
  }
  float* gp = g_params + id * NP;
  gp[MX] = t[0];
  gp[MY] = t[1];
  if (MODE == WAVE) {
    gp[CA] = t[2];
    gp[CB] = t[3];
    gp[CC] = t[4];
  } else {
    gp[CA] = t[2] * 4.0f * params[id * NP + CA];
    gp[CB] = 0.0f;
    gp[CC] = 0.0f;
  }
  gp[RADIUS] = 0.0f;
  gp[OPACITY] = t[5];
  gp[NP - 1] = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) g_V[id * C + c] = t[6 + c];
}

template <int MODE>
int launch(const float* params, const float* V, const float* g_out,
           float* part, float* g_params, float* g_V, int B, int N, int H,
           int W, cudaStream_t s) {
  const long long n_bwd = static_cast<long long>(B) * N * NBAND;
  dense_splat_bwd<MODE><<<static_cast<int>((n_bwd + NTHREADS - 1) /
                                           NTHREADS),
                          NTHREADS, 0, s>>>(params, V, g_out, part, B, N, H,
                                            W);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_red = static_cast<long long>(B) * N;
  dense_splat_reduce<MODE><<<static_cast<int>((n_red + NTHREADS - 1) /
                                              NTHREADS),
                             NTHREADS, 0, s>>>(params, part, g_params, g_V, B,
                                               N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches both kernels on `stream` and returns the first nonzero
// cudaGetLastError() (0 on success).  mode 0 WAVE, 1 ISO.  `part` is
// (8, B, N, 14) float32 scratch.  The caller allocates every buffer;
// nothing is synchronised here.
extern "C" int dense_bwd(const float* params, const float* V,
                         const float* g_out, float* part, float* g_params,
                         float* g_V, int B, int N, int H, int W, int mode,
                         void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == WAVE)
    return launch<WAVE>(params, V, g_out, part, g_params, g_V, B, N, H, W, s);
  if (mode == ISO)
    return launch<ISO>(params, V, g_out, part, g_params, g_V, B, N, H, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
