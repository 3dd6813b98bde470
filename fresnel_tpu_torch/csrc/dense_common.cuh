// Shared by the dense splat forward (dense_fwd.cu, K5) and its backward
// (dense_bwd.cu, K6): the per-Gaussian layout, each Gaussian's reach and
// the weight of one Gaussian at one pixel, so that both kernels evaluate
// the same function.
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
//
// The ISO weight is separable: exp(-dx^2 / den) * exp(-dy^2 / den), each
// factor iso_factor(d, -1 / den).  Both kernels take it so, with the
// reciprocal formed once per Gaussian: no division per pixel-Gaussian
// pair, and the factors of a tile's 16 columns and 16 rows (K5) or of a
// warp's 32 columns and one row (K6) serve every pair they meet.  The
// product differs from the single exp of the sum by a few ulps.  Past the
// reach below in x or in y, that axis's exponent alone passes -110, its
// factor rounds to exactly 0 and so does the product, as the single exp
// did.  Inside the reach, where only the sum of the two exponents passes
// float32's least subnormal (e^-103.3), the exact product is below half
// that subnormal and rounds to 0 too.

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

// exp(-m / 2) of a WAVE Gaussian with conic (a, b, c) at offset (dx, dy),
// the box test left to the caller.  expf, no fast math.
__device__ __forceinline__ float wave_e(float a, float b, float c, float dx,
                                        float dy) {
  return expf(-0.5f * (a * dx * dx + 2.0f * b * dx * dy + c * dy * dy));
}

// One ISO factor, exp(-d^2 / den), with ninv = -1 / den.
__device__ __forceinline__ float iso_factor(float d, float ninv) {
  return expf(d * d * ninv);
}

template <int MODE>
__device__ __forceinline__ float iso_den(float sigma) {
  return MODE == ISO ? 2.0f * sigma * sigma + 1e-8f : 0.0f;
}

// The offset beyond which (in x or y) w is exactly 0: WAVE, the box's
// radius; ISO, where the exponent passes -110, below float32's least
// subnormal (e^-103.3), so the weight rounds to 0.  Skipping such pixels
// leaves every sum as it was, bit for bit.
template <int MODE>
__device__ __forceinline__ float reach(float radius, float den) {
  return MODE == WAVE ? radius : sqrtf(110.0f * den) + 1.0f;
}

}  // namespace dense
