// Shared by the dense compositing forward (dense_composite_fwd.cu, K7) and
// its backward (dense_composite_bwd.cu, K8): the per-Gaussian layout, each
// Gaussian's reach and tile box, the folded constants, a thread's pixels
// and their alphas, so that both kernels evaluate the same function with
// the same bits.
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
// dx, dy are the integer pixel coordinates minus the Gaussian's mean.
//
// The alpha, with its constants folded.  When a listed Gaussian enters
// shared memory (`fold`) its exponent's coefficients are scaled once by
// -log2(e) / 2 (DENSE: A = -a log2(e) / 2, B = -b log2(e), C = -c log2(e)
// / 2; SIMPLE: K = -log2(e) / (2 sigma^2)), so a pixel's weight is
//   DENSE   2^(A dx^2 + (B dx + C dy) dy)   = fma(fma(C, dy, B dx), dy, A dx^2)
//   SIMPLE  2^(K dx^2 + (K dy) dy)           inside the box, else 0,
// two fmas per pixel after the column's products (a thread's two pixels
// share dx) and one ex2.approx.ftz.f32, the approximate base-2 exponential
// (relative error under 2^-22; results below 2^-126 flush to 0).  Every
// step is an explicit intrinsic (__fmaf_rn, __fmul_rn, __fsub_rn, inline
// PTX for ex2 and for the clip's max.NaN / min.NaN), so nvcc has nothing
// to contract or reorder: K7 and K8 get the same alpha, and so K8's
// transmittances, recomputed from K7's checkpoints, are K7's bits.  The
// rounding differs from the JAX renderers' op-by-op exp; the outputs stay
// within the kernels' tolerances of the plain versions.
//
// The reach, exact.  With the weight 2^m', m' = -m log2(e) / 2, and
// ex2.approx.ftz flushing every result below 2^-126 to +0, the weight is
// exactly 0 once m' < -127 (2^-127 times a relative error under 2^-22 is
// still below 2^-126), that is once m > 254 ln 2 = 176.06.  For a positive
// definite conic m >= dx^2 det / c and m >= dy^2 det / a (det = a c - b^2),
// so past |dx| = sqrt(220 c / det) (or |dy| = sqrt(220 a / det)) m > 220:
// the weight is 0 with a margin of 1.25x for the folded coefficients'
// rounding, and one pixel more on each side is K7's and K8's reach.  A
// pair outside it has weight exactly 0, so leaving it out changes no sum:
// 1 - 0 is 1, 0 T is 0.  A conic that is not positive definite, or not
// finite, reaches everywhere.  SIMPLE's reach is its box, radius + 1, plus
// a pixel.  The opacity plays no part: an opacity of 0 still gets the
// gradient its weight gives it.  Neither kernel stops at a small or zero T.
//
// Tiles and lists.  A block owns a tile of BW x BH = 32 x 16 pixels with
// 256 threads, two pixels a thread in one column, (lx, ly) and (lx, ly +
// 1).  `tile_boxes` gives each Gaussian the range of tiles its reach
// meets; K7 lists, per tile and in index order, the Gaussians whose box
// holds the tile, and K8 walks the same lists.

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
constexpr int BW = 32;                    // a tile's width and height
constexpr int BH = 16;
constexpr int NTHREADS = 256;
constexpr int NWARP = NTHREADS / 32;
constexpr int PPT = 2;                    // pixels a thread, one column
constexpr int TILE_PIX = BW * BH;
// Listed Gaussians a K8 run (and a K7 checkpoint each), and listed
// Gaussians in shared memory at once (one a thread).
constexpr int SUB = 16;
constexpr int STAGE = NTHREADS;
constexpr unsigned FULL = 0xffffffffu;
constexpr float HIT_ALPHA = 0.1f;
constexpr float LOG2E = 1.44269504088896341f;
static_assert(STAGE % SUB == 0 && NTHREADS == TILE_PIX / PPT, "layout");

template <int MODE>
__device__ __forceinline__ float alpha_max() {
  return MODE == DENSE ? 0.99f : 1.0f;
}

// 2^x, approximate; subnormal results flush to +0.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// jnp.clip(x, lo, hi): maximum, then minimum; NaN stays NaN.
__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(x), "f"(lo));
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(y), "f"(hi));
  return y;
}

// d jclip / dx, ties split evenly as jax.grad splits them.
__device__ __forceinline__ float jclip_grad(float x, float lo, float hi) {
  return x > lo && x < hi ? 1.0f : (x == lo || x == hi ? 0.5f : 0.0f);
}

// A listed Gaussian in shared memory, its constants folded:
//   DENSE   g0 = (mx, my, A, B), g1 = (C, opacity, depth, 0)
//   SIMPLE  g0 = (mx, my, K, radius + 1), g1 = (0, opacity, depth, its
//           chunk gi / chunk as int bits)
//   col = (r, g, b, its index gi as int bits).
template <int MODE>
__device__ __forceinline__ void fold(const float* __restrict__ params,
                                     const float* __restrict__ colors,
                                     int gi, int chunk, float4& g0,
                                     float4& g1, float4& col) {
  const float* g = params + static_cast<size_t>(gi) * NP;
  const float* c = colors + static_cast<size_t>(gi) * 3;
  if (MODE == DENSE) {
    g0 = make_float4(g[MX], g[MY], __fmul_rn(g[CA], -0.5f * LOG2E),
                     __fmul_rn(g[CB], -LOG2E));
    g1 = make_float4(__fmul_rn(g[CC], -0.5f * LOG2E), g[OPACITY], g[DEPTH],
                     0.0f);
  } else {
    const float den = __fmul_rn(__fmul_rn(2.0f, g[CA]), g[CA]);
    g0 = make_float4(g[MX], g[MY], __fdiv_rn(-LOG2E, den),
                     __fadd_rn(g[RADIUS], 1.0f));
    g1 = make_float4(0.0f, g[OPACITY], g[DEPTH], __int_as_float(gi / chunk));
  }
  col = make_float4(c[0], c[1], c[2], __int_as_float(gi));
}

// The weights e[i] of folded Gaussian (g0, g1) at the thread's pixels
// (px, py[i]), and the offsets dx, dy[i].
template <int MODE>
__device__ __forceinline__ void weights(float4 g0, float4 g1, float px,
                                        const float (&py)[PPT], float& dx,
                                        float (&dy)[PPT], float (&e)[PPT]) {
  dx = __fsub_rn(px, g0.x);
  if (MODE == DENSE) {
    const float a2 = __fmul_rn(__fmul_rn(g0.z, dx), dx);
    const float b1 = __fmul_rn(g0.w, dx);
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      dy[i] = __fsub_rn(py[i], g0.y);
      e[i] = ex2_ftz(__fmaf_rn(__fmaf_rn(g1.x, dy[i], b1), dy[i], a2));
    }
  } else {
    const float k2 = __fmul_rn(__fmul_rn(g0.z, dx), dx);
    const bool in_x = fabsf(dx) <= g0.w;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      dy[i] = __fsub_rn(py[i], g0.y);
      const float w = ex2_ftz(__fmaf_rn(__fmul_rn(g0.z, dy[i]), dy[i], k2));
      e[i] = in_x && fabsf(dy[i]) <= g0.w ? w : 0.0f;
    }
  }
}

// alpha from a weight and the opacity.
template <int MODE>
__device__ __forceinline__ float alpha_of(float e, float opacity) {
  return jclip(__fmul_rn(e, opacity), 0.0f, alpha_max<MODE>());
}

// The transmittance past a Gaussian of this alpha: T - alpha T, one
// rounding.
__device__ __forceinline__ float trans_step(float T, float alpha) {
  return __fmaf_rn(-alpha, T, T);
}

// The tiles (x0, x1, y0, y1), inclusive, that a Gaussian's reach meets:
// the tile at column tx holds pixels x in [BW tx, BW tx + BW - 1].  An
// empty range where it meets none; every tile where the reach or the mean
// is not finite.
template <int MODE>
__device__ __forceinline__ short4 tile_box(const float* g, int ntx,
                                           int nty) {
  float rx, ry;
  if (MODE == SIMPLE) {
    rx = ry = g[RADIUS] + 2.0f;
  } else {
    const float det = g[CA] * g[CC] - g[CB] * g[CB];
    if (det > 0.0f && g[CA] > 0.0f && g[CC] > 0.0f) {
      rx = sqrtf(220.0f * g[CC] / det) + 1.0f;
      ry = sqrtf(220.0f * g[CA] / det) + 1.0f;
    } else {
      rx = ry = INFINITY;
    }
  }
  // fmaxf / fminf return the other operand for a NaN: a NaN bound opens
  // the range to the image's edge.
  const float lx = ceilf((g[MX] - rx - (BW - 1)) * (1.0f / BW));
  const float hx = floorf((g[MX] + rx) * (1.0f / BW));
  const float ly = ceilf((g[MY] - ry - (BH - 1)) * (1.0f / BH));
  const float hy = floorf((g[MY] + ry) * (1.0f / BH));
  return make_short4(
      static_cast<short>(fminf(fmaxf(lx, 0.0f), static_cast<float>(ntx))),
      static_cast<short>(fmaxf(fminf(hx, ntx - 1.0f), -1.0f)),
      static_cast<short>(fminf(fmaxf(ly, 0.0f), static_cast<float>(nty))),
      static_cast<short>(fmaxf(fminf(hy, nty - 1.0f), -1.0f)));
}

__device__ __forceinline__ bool box_holds(short4 b, int tx, int ty) {
  return b.x <= tx && tx <= b.y && b.z <= ty && ty <= b.w;
}

// The scratch both kernels share, in one int32 buffer (aux): per Gaussian
// its tile box (2 ints), per tile its list's length, per pixel SIMPLE's
// tie record (3 ints), per tile a list of up to N Gaussian indices.
// K7's checkpoints are floats of their own: per tile, ceil(N / SUB) runs
// of TILE_PIX transmittances.
struct Scratch {
  short4* boxes;
  int* counts;
  int* ties;
  int* lists;
};

__host__ __device__ inline Scratch scratch(int* aux, int N, int H, int W) {
  const size_t ntiles = static_cast<size_t>((W + BW - 1) / BW) *
                        ((H + BH - 1) / BH);
  Scratch s;
  s.boxes = reinterpret_cast<short4*>(aux);
  s.counts = aux + 2 * static_cast<size_t>(N);
  s.ties = s.counts + ntiles;
  s.lists = s.ties + 3 * static_cast<size_t>(H) * W;
  return s;
}

// A thread's pixels: column t % 32 of its tile, rows 2 (t / 32) and the
// next, so a warp owns two whole rows.
struct Pixels {
  float px, py[PPT];
  int slot[PPT];      // index within the tile, row-major
  size_t p[PPT];      // index within the image
  bool valid[PPT];
};

__device__ __forceinline__ Pixels pixels(int tile, int ntx, int H, int W) {
  const int t = threadIdx.x;
  const int x = (tile % ntx) * BW + t % BW;
  Pixels q;
  q.px = static_cast<float>(x);
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    q.slot[i] = (t / 32) * 32 * PPT + i * 32 + t % 32;
    const int y = (tile / ntx) * BH + q.slot[i] / BW;
    q.py[i] = static_cast<float>(y);
    q.valid[i] = x < W && y < H;
    q.p[i] = static_cast<size_t>(y) * W + x;
  }
  return q;
}

// For a kernel's exported *_residency: registers per thread, static
// shared and local (spill) bytes, threads per block and blocks per SM on
// the current device.  Returns a CUDA error code.
template <typename Kernel>
inline int kernel_residency(Kernel kernel, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        NTHREADS, 0);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = static_cast<int>(fa.localSizeBytes);
  out[3] = NTHREADS;
  out[4] = blocks;
  return static_cast<int>(err);
}

}  // namespace dcomp
