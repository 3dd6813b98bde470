// Phase-blending backward tile compositor (K2-phi) for NVIDIA Hopper
// (sm_90a): the analytic VJP of raster_phase_fwd.cu.
//
// Replaces the reverse-mode derivative XLA takes of the phase path of
// fresnel_tpu/render/tile.py::_composite_tiles (:672-716).
//
// Input:  pack (T, M, 12) float32 with the phases in column 11, counts
//         (T,) int32, the amplitude A and 1 - A and box as the forward's;
//         g_color (T, 256, 3), g_depth (T, 256), g_trans (T, 256): the
//         cotangents of the forward's outputs;
//         ckpt (T, ceil(M / 16), 2, 256): the forward's checkpoints of
//         (T, acc_phase) before every 16th slot.
// Output: grad (T, M, 12) float32, the gradient of the pack: mean, conic,
//         RGB, opacity, depth and phase (column 11); the radius column
//         and every slot >= count are 0.
//
// Reverse mode over the recurrence (raster_common.cuh, phase_step), per
// pixel, with adjoints lT of the transmittance and lP of the running phase
// (lT starts at g_trans, lP at 0; the colour and depth sums are linear, so
// their adjoints stay g_color and g_depth).  For a slot with weight w,
// alpha = clip(x), x = alpha_raw * F, F = 1 - A + A cos(2 pi d),
// acc_alpha = (1 - T) + w, m = max(acc_alpha, 1e-6), p = w / m:
//   dw     = g_c . c + g_D depth + lP (phase - acc_phase) / m
//            + [acc_alpha > 1e-6] dm,   dm = -lP (phase - acc_phase) p / m
//   dalpha = -lT T + dw T
//   lT'    = lT (1 - alpha) + dw alpha - [acc_alpha > 1e-6] dm
//   lP'    = lP (1 - p) - dd * sign(phase - acc_phase)
//   dx     = dalpha where 0 < x < ALPHA_MAX, else 0
//   dalpha_raw = dx F,  dF = dx alpha_raw,
//   dd     = dF A (-sin(2 pi d)) 2 pi * (+1, -1 or 0 as d = |.| or 1 - |.|
//            is the smaller, 0 at a tie, as XLA splits a tie's gradient)
//   dphase = lP p + dd * sign(phase - acc_phase)
// then alpha_raw = e * opacity into mean, conic and opacity as K2 does.
// The state before each slot comes from recomputing the slot's 16-slot
// checkpoint segment forward (the same phase_step the forward runs) into
// shared memory, never from inverting the recurrence: its phase weight is
// exactly 1 at a pixel's first contributing slot, and 1 - alpha is 0.01
// at ALPHA_MAX.
//
// One block of 256 threads per tile walks its segments last to first.  Per
// slot, each of the 11 gradient terms is summed over a warp by a shuffle
// butterfly, then over the 8 warps in a fixed order: no atomics, so the
// result repeats bit for bit.  A warp in which every pixel's alpha_raw is
// 0 skips the slot: every term there is exactly 0 and the adjoints do not
// change.

#include "raster_common.cuh"

namespace {

using namespace raster;

// Gradient terms per slot: mx, my, conic a, b, c, R, G, B, opacity, depth,
// phase.
constexpr int NG = 11;

// Pack column -> gradient term, -1 for the radius (no gradient).
__device__ __forceinline__ int grad_term(int col) {
  if (col < 5) return col;
  if (col == 5) return -1;
  return col - 1;
}

template <bool BOX>
__global__ void __launch_bounds__(PIX)
composite_phase_bwd(const float* __restrict__ pack,
                    const int* __restrict__ counts,
                    const float* __restrict__ g_color,
                    const float* __restrict__ g_depth,
                    const float* __restrict__ g_trans,
                    const float* __restrict__ ckpt,
                    float* __restrict__ grad, int max_per_tile,
                    int n_tiles_x, int tiles_per_image, Amplitude amp) {
  __shared__ float sh[CKPT * PACK];
  __shared__ float state[CKPT][2][PIX];
  __shared__ float sums[NWARP][CKPT][NG];
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p % 32;
  const int warp = p / 32;
  const int n = tile_count(counts, tile, max_per_tile);
  const int nck = n_checkpoints(max_per_tile);
  float* row = grad + static_cast<size_t>(tile) * max_per_tile * PACK;
  float px, py;
  pixel_coords(tile, p, n_tiles_x, tiles_per_image, &px, &py);
  const size_t o = static_cast<size_t>(tile) * PIX + p;
  const float gR = g_color[o * 3 + 0];
  const float gG = g_color[o * 3 + 1];
  const float gB = g_color[o * 3 + 2];
  const float gD = g_depth[o];
  float lT = g_trans[o];
  float lP = 0.0f;

  for (int k = (n + CKPT - 1) / CKPT - 1; k >= 0; --k) {
    const int first = k * CKPT;
    const int cnt = min(CKPT, n - first);
    __syncthreads();   // the previous segment's slots and sums are consumed
    stage_slots(sh, pack + (static_cast<size_t>(tile) * max_per_tile +
                            first) * PACK, cnt, p);
    __syncthreads();
    {
      const float* q = ckpt + ((static_cast<size_t>(tile) * nck + k) * 2) *
                                  PIX + p;
      float T = q[0], acc_phase = q[PIX];
      for (int j = 0; j < cnt; ++j) {
        state[j][0][p] = T;
        state[j][1][p] = acc_phase;
        phase_step<BOX>(sh + j * PACK, px, py, amp, T, acc_phase, nullptr);
      }
    }
    for (int j = cnt - 1; j >= 0; --j) {
      const float* g = sh + j * PACK;
      const Alpha a = eval_alpha_rn<BOX>(g, px, py);
      const bool live = a.alpha_raw != 0.0f;
      if (!__any_sync(FULL, live)) {
        if (lane < NG) sums[warp][j][lane] = 0.0f;
        continue;
      }
      float v[NG];
#pragma unroll
      for (int t = 0; t < NG; ++t) v[t] = 0.0f;
      if (live) {
        const float T = state[j][0][p];
        const float acc_phase = state[j][1][p];
        const Interference f = interference(g[PHASE], acc_phase, amp);
        // The forward's values, rounded as phase_step rounds them.
        const float x = __fmul_rn(a.alpha_raw, f.factor);
        const float alpha = clip_alpha(x);
        const float w = __fmul_rn(alpha, T);
        const float acc_alpha = __fadd_rn(__fsub_rn(1.0f, T), w);
        const float m = fmaxf(acc_alpha, 1e-6f);
        const float pc = __fdiv_rn(w, m);
        // Through acc_phase' = acc_phase (1 - p) + phase p.
        const float dpc = lP * (g[PHASE] - acc_phase);
        float dw = gR * g[R] + gG * g[G] + gB * g[B] + gD * g[DEPTH] +
                   dpc / m;
        const float dm = acc_alpha > 1e-6f ? -dpc * pc / m : 0.0f;
        dw += dm;
        const float dalpha = (dw - lT) * T;
        const float lT_new = lT * (1.0f - alpha) + dw * alpha - dm;
        const float dx = (x > 0.0f && x < ALPHA_MAX) ? dalpha : 0.0f;
        const float dF = dx * a.alpha_raw;
        const float dpw = dF * amp.a * -sinf(f.arg) * TWO_PI_F;
        const float one_m = 1.0f - f.pd;
        const float dpd = f.pd < one_m ? dpw : (f.pd > one_m ? -dpw : 0.0f);
        const float sgn = f.diff > 0.0f ? 1.0f : (f.diff < 0.0f ? -1.0f
                                                                 : 0.0f);
        const float dphase = lP * pc + dpd * sgn;
        lP = lP * (1.0f - pc) - dpd * sgn;
        lT = lT_new;
        const float da = dx * f.factor;
        // dmq = d loss / d m, m the quadratic form; the conic is staged as
        // qa = -a / 2, qb = -b, qc = -c / 2.
        const float dmq = da * a.alpha_raw * -0.5f;
        const float dmx = dmq * a.dx;
        v[0] = dmq * 2.0f * (2.0f * g[QA] * a.dx + g[QB] * a.dy);
        v[1] = dmq * 2.0f * (g[QB] * a.dx + 2.0f * g[QC] * a.dy);
        v[2] = dmx * a.dx;
        v[3] = 2.0f * dmx * a.dy;
        v[4] = dmq * a.dy * a.dy;
        v[5] = w * gR;
        v[6] = w * gG;
        v[7] = w * gB;
        v[8] = da * a.e;
        v[9] = w * gD;
        v[10] = dphase;
      }
#pragma unroll
      for (int t = 0; t < NG; ++t) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v[t] += __shfl_xor_sync(FULL, v[t], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int t = 0; t < NG; ++t) sums[warp][j][t] = v[t];
      }
    }
    __syncthreads();
    for (int i = p; i < cnt * PACK; i += PIX) {
      const int t = grad_term(i % PACK);
      float s = 0.0f;
      if (t >= 0) {
#pragma unroll
        for (int w = 0; w < NWARP; ++w) s += sums[w][i / PACK][t];
      }
      row[first * PACK + i] = s;
    }
  }
  for (int i = n * PACK + p; i < max_per_tile * PACK; i += PIX) row[i] = 0.0f;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller allocates every buffer (grad need not be zeroed: the kernel
// writes every element); nothing is synchronised here.
extern "C" int raster_phase_bwd(const float* pack, const int* counts,
                                const float* g_color, const float* g_depth,
                                const float* g_trans, const float* ckpt,
                                float* grad, int n_tiles, int max_per_tile,
                                int n_tiles_x, int tiles_per_image, int box,
                                float amp, float one_minus_amp,
                                void* stream) {
  if (n_tiles <= 0) return 0;
  if (tiles_per_image < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const raster::Amplitude a{amp, one_minus_amp};
  if (box)
    composite_phase_bwd<true><<<n_tiles, PIX, 0, s>>>(
        pack, counts, g_color, g_depth, g_trans, ckpt, grad, max_per_tile,
        n_tiles_x, tiles_per_image, a);
  else
    composite_phase_bwd<false><<<n_tiles, PIX, 0, s>>>(
        pack, counts, g_color, g_depth, g_trans, ckpt, grad, max_per_tile,
        n_tiles_x, tiles_per_image, a);
  return static_cast<int>(cudaGetLastError());
}
