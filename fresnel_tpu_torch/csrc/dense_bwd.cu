// Dense splat backward (K6) for NVIDIA Hopper (sm_90a): the analytic VJP
// of dense_fwd.cu.
//
// Replaces the reverse-mode derivative XLA takes of the chunked scans of
// fresnel_tpu/render/wave.py::render_wave_field (:63-84) and
// fresnel_tpu/render/fourier.py::render_fourier, mode "spatial" (:85-106).
//
// Input:  params (B, N, 8), V (B, N, C) as the forward's; g_out (B, H * W,
//         C), the cotangent of its output, 16-byte aligned.
// Output: g_params (B, N, 8): mean, conic a, b, c (ISO: sigma in column 2,
//         columns 3-4 0) and opacity; radius and pad 0.  g_V (B, N, C).
//
// For a pixel with weight w = e * opacity, dw = sum_c g_out[p, c] V[c] and
// k = dw e, summed over the pixels within the Gaussian's reach:
//   g_V[c] = opacity sum e g_out[p, c];  g_opacity = sum k;
//   WAVE: g_mx = opacity (a sum k dx + b sum k dy),
//         g_my = opacity (b sum k dx + c sum k dy),
//         g_a = -opacity / 2 sum k dx^2, g_b = -opacity sum k dx dy,
//         g_c = -opacity / 2 sum k dy^2;
//   ISO:  with den = 2 sigma^2 + 1e-8,
//         g_mx = 2 opacity / den sum k dx, g_my = 2 opacity / den sum k dy,
//         g_sigma = 4 sigma opacity / den^2 sum k (dx^2 + dy^2).
// The constants are applied once per Gaussian: no division per pair.
//
// What bounds it: the cotangent reads of the pixel-Gaussian pairs within
// reach, C floats a pair (at experiment 4's Fourier route 5 200 to 12 700
// pixels for each of 43 808 Gaussians, 2.7-6.7 GB), from L2: the whole
// g_out is a few MB and stays there, so L2's rate to the SMs (about 7 TB/s
// on an H100 80GB HBM3, chip_smoke.py --ab) and not device memory sets the
// time.  The sums run over
// pixels for each Gaussian, so the design gives each Gaussian cooperating
// lanes:
//   One warp per (image, Gaussian), 8 warps a block.  The lanes take 32
//   consecutive columns of the Gaussian's window (its reach, clipped to the
//   image, one pixel of margin: beyond it every term is exactly 0) and the
//   warp walks the window's rows, so each row segment's g_out read is one
//   coalesced run of 32 x C floats; a window wider than 32 columns is
//   walked 32 columns at a time.  Windows narrower than 32 would leave
//   lanes idle, but the routes' median reaches (30-35 px WAVE, 35-55 px
//   ISO) make windows of 60-110 columns, 2-4 chunks with most lanes busy,
//   and 43 808 (exp4) or 21 904 (QSR, physics) warps fill the card several
//   times over: so no window is folded onto the lanes and none is split
//   over warps.
//   ISO: each lane keeps its column's factor exp(-dx^2 / den) in a
//   register; the row factor is one value per row, computed by one lane
//   for 32 rows at a time and passed by a shuffle.  WAVE: one expf of the
//   quadratic form per pair inside the box, and each lane reads its
//   pixel's 8 floats as two float4s (as 8 scalar loads at a 32-byte lane
//   stride they cost L1 four times the sector requests and the kernel
//   twice the time).
//   Each lane sums its column's terms over the rows (sum k, k dy, k dy^2
//   and e g_out), folds them into its totals once per column (times dx,
//   dx^2), and a butterfly of __shfl_xor_sync in a fixed order combines the
//   lanes.  No atomics, no scratch, one kernel: the result repeats bit for
//   bit from run to run.
// Every pixel of the window is walked whatever the opacity: the opacity's
// own gradient, sum k, does not vanish with it.  A Gaussian whose mean is
// not finite gets a gradient of 0 (every field).

#include "dense_common.cuh"

namespace {

using namespace dense;

constexpr int NWARP = NTHREADS / 32;

// A pixel bound as an int, clamped far outside any image first.
__device__ __forceinline__ int to_int(float v) {
  return static_cast<int>(fminf(fmaxf(v, -1e6f), 1e6f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int MODE>
__global__ void __launch_bounds__(NTHREADS)
dense_splat_bwd(const float* __restrict__ params,
                const float* __restrict__ V,
                const float* __restrict__ g_out,
                float* __restrict__ g_params, float* __restrict__ g_V,
                int B, int N, int H, int W) {
  constexpr int C = Mode<MODE>::C;
  const int lane = threadIdx.x & 31;
  const long long id = static_cast<long long>(blockIdx.x) * NWARP +
                       (threadIdx.x >> 5);
  if (id >= static_cast<long long>(B) * N) return;   // the whole warp
  const int b = static_cast<int>(id / N);
  float g[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) g[k] = params[id * NP + k];
  float v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = V[id * C + c];

  float* gp = g_params + id * NP;
  float* gv = g_V + id * C;
  if (!(isfinite(g[MX]) && isfinite(g[MY]))) {
    if (lane < NP) gp[lane] = 0.0f;
    if (lane < C) gv[lane] = 0.0f;
    return;
  }

  // The window: the pixels within the reach and one more on each side.
  const float den = iso_den<MODE>(g[CA]);
  const float r = reach<MODE>(g[RADIUS], den);
  const int y_lo = max(0, to_int(floorf(g[MY] - r)) - 1);
  const int y_hi = min(H - 1, to_int(ceilf(g[MY] + r)) + 1);
  const int x_lo = max(0, to_int(floorf(g[MX] - r)) - 1);
  const int x_hi = min(W - 1, to_int(ceilf(g[MX] + r)) + 1);
  const float ninv = MODE == ISO ? -1.0f / den : 0.0f;
  const float* gob = g_out + static_cast<size_t>(b) * H * W * C;

  // Totals per lane: sum k, k dx, k dy, k dx^2, k dx dy, k dy^2, e g_out.
  float T = 0.0f, Tx = 0.0f, Ty = 0.0f, Txx = 0.0f, Txy = 0.0f, Tyy = 0.0f;
  float G[C];
#pragma unroll
  for (int c = 0; c < C; ++c) G[c] = 0.0f;
  for (int xc = x_lo; xc <= x_hi; xc += 32) {
    const int x = xc + lane;
    const bool in_x = x <= x_hi;
    const float dx = static_cast<float>(x) - g[MX];
    // ISO: the column's factor.  WAVE: the column inside the box.
    const float cf = MODE == ISO && in_x ? iso_factor(dx, ninv) : 0.0f;
    const bool box_x = in_x && fabsf(dx) <= g[RADIUS];
    float A = 0.0f, Ay = 0.0f, Ayy = 0.0f;
    float Gc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) Gc[c] = 0.0f;
    for (int yb = y_lo; yb <= y_hi; yb += 32) {
      const int rows = min(32, y_hi - yb + 1);
      // ISO: lane i holds the factor of row yb + i, shuffled to all.
      const float rf_l =
          MODE == ISO
              ? iso_factor(static_cast<float>(yb + lane) - g[MY], ninv)
              : 0.0f;
      const float* go = gob + (static_cast<size_t>(yb) * W +
                               (in_x ? x : x_lo)) * C;
      float yf = static_cast<float>(yb);
#pragma unroll 4
      for (int i = 0; i < rows; ++i, yf += 1.0f, go += W * C) {
        const float dy = yf - g[MY];
        float gc[C];
        if constexpr (MODE == WAVE) {
          // The pixel's 8 floats as two float4s (g_out is 16-byte
          // aligned): 2 of L1's sector requests per lane, not 8.
          const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const float4* go4 = reinterpret_cast<const float4*>(go);
          const float4 lo = in_x ? go4[0] : z;
          const float4 hi = in_x ? go4[1] : z;
          gc[0] = lo.x, gc[1] = lo.y, gc[2] = lo.z, gc[3] = lo.w;
          gc[4] = hi.x, gc[5] = hi.y, gc[6] = hi.z, gc[7] = hi.w;
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) gc[c] = in_x ? go[c] : 0.0f;
        }
        float e;
        if constexpr (MODE == ISO) {
          e = cf * __shfl_sync(FULL, rf_l, i);
        } else {
          e = box_x && fabsf(dy) <= g[RADIUS]
                  ? wave_e(g[CA], g[CB], g[CC], dx, dy)
                  : 0.0f;
        }
        float dw = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dw += gc[c] * v[c];
          Gc[c] += e * gc[c];
        }
        const float k = dw * e;
        const float kdy = k * dy;
        A += k;
        Ay += kdy;
        Ayy += kdy * dy;
      }
    }
    T += A;
    Tx += dx * A;
    Txx += dx * (dx * A);
    Ty += Ay;
    Txy += dx * Ay;
    Tyy += Ayy;
#pragma unroll
    for (int c = 0; c < C; ++c) G[c] += Gc[c];
  }
  T = warp_sum(T);
  Tx = warp_sum(Tx);
  Ty = warp_sum(Ty);
  Txx = warp_sum(Txx);
  Txy = warp_sum(Txy);
  Tyy = warp_sum(Tyy);
#pragma unroll
  for (int c = 0; c < C; ++c) G[c] = warp_sum(G[c]);
  if (lane != 0) return;
  const float op = g[OPACITY];
  if constexpr (MODE == WAVE) {
    gp[MX] = op * (g[CA] * Tx + g[CB] * Ty);
    gp[MY] = op * (g[CB] * Tx + g[CC] * Ty);
    gp[CA] = -0.5f * op * Txx;
    gp[CB] = -op * Txy;
    gp[CC] = -0.5f * op * Tyy;
  } else {
    const float s = 2.0f * op / den;
    gp[MX] = s * Tx;
    gp[MY] = s * Ty;
    gp[CA] = s * 2.0f * g[CA] / den * (Txx + Tyy);
    gp[CB] = 0.0f;
    gp[CC] = 0.0f;
  }
  gp[RADIUS] = 0.0f;
  gp[OPACITY] = T;
  gp[NP - 1] = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) gv[c] = op * G[c];
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// mode 0 WAVE, 1 ISO.  The caller allocates every buffer; nothing is
// synchronised here.
extern "C" int dense_bwd(const float* params, const float* V,
                         const float* g_out, float* g_params, float* g_V,
                         int B, int N, int H, int W, int mode, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const long long warps = static_cast<long long>(B) * N;
  const int blocks = static_cast<int>((warps + NWARP - 1) / NWARP);
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == WAVE)
    dense_splat_bwd<WAVE><<<blocks, NTHREADS, 0, s>>>(params, V, g_out,
                                                      g_params, g_V, B, N, H,
                                                      W);
  else if (mode == ISO)
    dense_splat_bwd<ISO><<<blocks, NTHREADS, 0, s>>>(params, V, g_out,
                                                     g_params, g_V, B, N, H,
                                                     W);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
