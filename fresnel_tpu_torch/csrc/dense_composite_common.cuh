// Shared by the dense compositing forward (dense_composite_fwd.cu, K7) and
// its backward (dense_composite_bwd.cu, K8): the per-Gaussian layout, each
// Gaussian's reach, its alpha at one pixel and the cull of a stage of
// Gaussians against a 16 x 16 tile, so that both kernels evaluate the same
// function with the same bits.
//
// Each pixel composites every Gaussian of one image front to back (they
// come depth-sorted): w_i = alpha_i T_i, T_0 = 1, T_{i+1} = T_i (1 -
// alpha_i).  Two modes:
//   DENSE  (fresnel_tpu/render/dense.py:35-115): alpha = clip(exp(-m / 2)
//          opacity, 0, 0.99), m = a dx^2 + 2 b dx dy + c dy^2, no box; the
//          fourth output channel is sum w depth.
//   SIMPLE (fresnel_tpu/render/simplified.py:22-92): alpha = clip(exp(
//          -(dx^2 + dy^2) / (2 sigma^2)) opacity, 0, 1) inside |dx|, |dy| <=
//          radius + 1, else 0; the fourth channel is the least depth where
//          alpha > 0.1 (+inf where none passes).
// dx, dy are the integer pixel coordinates minus the Gaussian's mean.  The
// exponents round op by op in the JAX renderers' order (explicit _rn
// intrinsics: nvcc contracts nothing here), so K7 and K8 get the same
// alpha, and so the same transmittances and the same hits.
//
// The reach.  DENSE has no box, but exp(-m / 2) rounds to exactly 0 once
// m / 2 passes 103.97 (half of float32's least subnormal).  For a positive
// definite conic, m >= dx^2 det / c and m >= dy^2 det / a (det = a c -
// b^2), so past |dx| = sqrt(220 c / det) (or |dy| = sqrt(220 a / det))
// m > 220 and the weight is 0: one pixel more on each side is K7's and
// K8's reach, and skipping a Gaussian that cannot reach a tile leaves
// every sum as it was, bit for bit (1 - 0 is 1).  A conic that is not
// positive definite, or not finite, reaches everywhere.  SIMPLE's reach is
// its box, radius + 1.  The opacity plays no part in the cull: an opacity
// of 0 still gets the gradient its weight gives it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dcomp {

// Per Gaussian: [mx, my, conic a (SIMPLE: sigma), b, c, radius (SIMPLE),
// opacity, depth].
constexpr int NP = 8;
enum Param { MX, MY, CA, CB, CC, RADIUS, OPACITY, DEPTH };
constexpr int DENSE = 0;
constexpr int SIMPLE = 1;
constexpr int TS = 16;
constexpr int NTHREADS = 256;
constexpr int NWARP = NTHREADS / 32;
constexpr int STAGE = 256;   // Gaussians culled at once; one checkpoint each
constexpr unsigned FULL = 0xffffffffu;
constexpr float HIT_ALPHA = 0.1f;

template <int MODE>
__device__ __forceinline__ float alpha_max() {
  return MODE == DENSE ? 0.99f : 1.0f;
}

// jnp.clip(x, lo, hi): maximum, then minimum; NaN stays NaN.
__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  const float y = x < lo ? lo : x;
  return y > hi ? hi : y;
}

// d jclip / dx, ties split evenly as jax.grad splits them.
__device__ __forceinline__ float jclip_grad(float x, float lo, float hi) {
  const float f1 = x > lo ? 1.0f : (x == lo ? 0.5f : 0.0f);
  const float y = x < lo ? lo : x;
  const float f2 = y < hi ? 1.0f : (y == hi ? 0.5f : 0.0f);
  return f1 * f2;
}

// One Gaussian at one pixel offset: the weight (DENSE: exp(-m / 2); SIMPLE:
// the boxed exp), the unclipped alpha (weight times opacity) and alpha.
struct Pair {
  float e, raw, alpha;
};

template <int MODE>
__device__ __forceinline__ Pair pair_at(float4 g0, float4 g1, float dx,
                                        float dy) {
  // g0 = (mx, my, a | sigma, b), g1 = (c, radius, opacity, depth).
  Pair p;
  if (MODE == DENSE) {
    const float m = __fadd_rn(
        __fadd_rn(__fmul_rn(__fmul_rn(g0.z, dx), dx),
                  __fmul_rn(__fmul_rn(__fmul_rn(2.0f, g0.w), dx), dy)),
        __fmul_rn(__fmul_rn(g1.x, dy), dy));
    p.e = expf(__fmul_rn(-0.5f, m));
  } else {
    const float r1 = __fadd_rn(g1.y, 1.0f);
    const bool in = fabsf(dx) <= r1 && fabsf(dy) <= r1;
    const float dist = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float den = __fmul_rn(__fmul_rn(2.0f, g0.z), g0.z);
    p.e = in ? expf(__fdiv_rn(-dist, den)) : 0.0f;
  }
  p.raw = __fmul_rn(p.e, g1.z);
  p.alpha = jclip(p.raw, 0.0f, alpha_max<MODE>());
  return p;
}

// The half-widths (x, y) past which the Gaussian's weight is exactly 0,
// plus one pixel; +inf where it may reach everywhere.
template <int MODE>
__device__ __forceinline__ float2 reach(const float* g) {
  if (MODE == SIMPLE) {
    const float r = g[RADIUS] + 2.0f;
    return make_float2(r, r);
  }
  const float det = g[CA] * g[CC] - g[CB] * g[CB];
  if (!(det > 0.0f && g[CA] > 0.0f && g[CC] > 0.0f))
    return make_float2(INFINITY, INFINITY);
  return make_float2(sqrtf(220.0f * g[CC] / det) + 1.0f,
                     sqrtf(220.0f * g[CA] / det) + 1.0f);
}

// The Gaussians of one stage, [first, last), that reach the tile at (x0,
// y0), compacted in index order into shared memory: each thread tests one
// (a warp ballot, __popc and a prefix over the warps' counts).  Returns
// their number.  The caller synchronises before the lists are read.
struct StageLists {
  float4 g0[STAGE];
  float4 g1[STAGE];
  float4 col[STAGE];
  int idx[STAGE];
  int warp_count[NWARP];
};

template <int MODE>
__device__ int cull_stage(StageLists& sh, const float* __restrict__ params,
                          const float* __restrict__ colors, int first,
                          int last, int x0, int y0) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int gi = first + t;
  float g[NP];
  bool keep = false;
  if (gi < last) {
#pragma unroll
    for (int k = 0; k < NP; ++k) g[k] = params[static_cast<size_t>(gi) * NP + k];
    const float2 r = reach<MODE>(g);
    keep = !(g[MX] + r.x < x0 || g[MX] - r.x > x0 + TS - 1 ||
             g[MY] + r.y < y0 || g[MY] - r.y > y0 + TS - 1);
  }
  const unsigned ballot = __ballot_sync(FULL, keep);
  __syncthreads();   // the previous stage's lists have been read
  if (lane == 0) sh.warp_count[warp] = __popc(ballot);
  __syncthreads();
  int slot = __popc(ballot & ((1u << lane) - 1u));
  int listed = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) {
    const int n = sh.warp_count[w];
    slot += w < warp ? n : 0;
    listed += n;
  }
  if (keep) {
    const float* c = colors + static_cast<size_t>(gi) * 3;
    sh.g0[slot] = make_float4(g[MX], g[MY], g[CA], g[CB]);
    sh.g1[slot] = make_float4(g[CC], g[RADIUS], g[OPACITY], g[DEPTH]);
    sh.col[slot] = make_float4(c[0], c[1], c[2], 0.0f);
    sh.idx[slot] = gi;
  }
  return listed;
}

}  // namespace dcomp
