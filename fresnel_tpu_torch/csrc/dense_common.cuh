// Shared by the dense splat forward (dense_fwd.cu, K5) and its backward
// (dense_bwd.cu, K6): the per-Gaussian layout and the weight of one
// Gaussian at one pixel.
//
// The dense splat sums, for every pixel p of an image, every Gaussian g of
// that image: out[p, c] = sum_g w(g, p) V[g, c].  Two modes:
//   WAVE (the wave-field renderer, fresnel_tpu/render/wave.py:63-84):
//        w = exp(-m / 2) * opacity inside the +-radius box, else 0, with
//        m = a dx^2 + 2 b dx dy + c dy^2; V has 8 channels
//        (cos(phi) rgb, sin(phi) rgb, depth, 1).
//   ISO  (the Fourier renderer's spatial mode, fresnel_tpu/render/
//        fourier.py:85-106): w = exp(-(dx^2 + dy^2) / (2 sigma^2 + 1e-8))
//        * opacity, no box; V has 3 channels (rgb).
// dx, dy are the integer pixel coordinates minus the Gaussian's mean.

#pragma once

#include <cuda_runtime.h>

namespace dense {

// Per Gaussian: [mx, my, conic a (or sigma), b, c, radius, opacity, pad].
constexpr int NP = 8;
enum Param { MX, MY, CA, CB, CC, RADIUS, OPACITY };
constexpr int WAVE = 0;
constexpr int ISO = 1;
constexpr int NTHREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

template <int MODE>
struct Mode;

template <>
struct Mode<WAVE> {
  static constexpr int C = 8;
};

template <>
struct Mode<ISO> {
  static constexpr int C = 3;
};

// exp(-m / 2) (WAVE, inside the box) or exp(-r^2 / (2 sigma^2 + 1e-8))
// (ISO) of Gaussian g at offset (dx, dy); 0 outside a WAVE box.  `den` is
// the ISO denominator.  expf, no fast math.
template <int MODE>
__device__ __forceinline__ float splat_e(const float* g, float dx, float dy,
                                         float den) {
  if (MODE == WAVE) {
    if (!((fabsf(dx) <= g[RADIUS]) & (fabsf(dy) <= g[RADIUS]))) return 0.0f;
    const float m = g[CA] * dx * dx + 2.0f * g[CB] * dx * dy +
                    g[CC] * dy * dy;
    return expf(-0.5f * m);
  }
  return expf(-(dx * dx + dy * dy) / den);
}

template <int MODE>
__device__ __forceinline__ float iso_den(const float* g) {
  return MODE == ISO ? 2.0f * g[CA] * g[CA] + 1e-8f : 0.0f;
}

// The offset beyond which (in x or y) w is exactly 0: WAVE, the box's
// radius; ISO, where the exponent passes -110, below float32's least
// subnormal (e^-103.3), so expf rounds to 0.  Skipping such pixels leaves
// every sum as it was, bit for bit.
template <int MODE>
__device__ __forceinline__ float reach(const float* g, float den) {
  return MODE == WAVE ? g[RADIUS] : sqrtf(110.0f * den) + 1.0f;
}

}  // namespace dense
