// Backward tile compositor for NVIDIA Hopper (sm_90a): the analytic VJP of
// raster_fwd.cu.
//
// Replaces the TPU kernel fresnel_tpu/render/pallas_raster.py::_bwd_kernel
// (:179) and its body _bwd_chunk_body (:220), launched by _run_backward and
// attached to the forward by composite_pallas.defvjp.
//
// Input:  pack    (T, M, 12) float32 and counts (T,) int32, as the forward;
//         color   (T, 256, 3), depth (T, 256): the forward's premultiplied
//                 sums, BEFORE any background is added;
//         trans   (T, 256): the forward's final transmittance T_fin;
//         g_color (T, 256, 3), g_depth (T, 256), g_trans (T, 256): the
//                 cotangents of the three outputs.
// Output: grad    (T, M, 12) float32, the gradient of the pack.  Columns 5
//                 (radius) and 11 (pad) and every slot >= count are 0.
//
// The math is _bwd_chunk_body's.  Front to back, with T_before the running
// transmittance and the suffix sums S (RGB, depth) starting at the tile's
// totals (the forward's outputs) and S_after = S - w * c:
//   dalpha = sum_c g_c (T_before c - S_after_c / (1 - alpha))
//            - g_T T_fin / (1 - alpha),   1 - alpha clamped at 1e-6,
// gated by alpha_raw < 0.99, then chained into mean, conic, RGB, opacity and
// depth.  The alpha of each slot comes from raster_common.cuh, the function
// the forward uses, so T_before repeats the forward's transmittance.
//
// What bounds it on this card: each tile reads count * 48 bytes of pack and
// 256 * 40 bytes of outputs and cotangents and writes M * 48 bytes, while it
// does count * 256 pixel-slot evaluations of ~90 operations (the forward's
// alpha, the suffix update, dalpha, the chain rule and a share of the
// reduction over the tile's pixels).  At the refine path's occupancy it is
// bound by float32 operations.  The design:
//   * one block of 256 threads per tile, one thread per pixel, as the
//     forward; CHUNK slots are staged in shared memory with one coalesced
//     load and read by broadcast;
//   * each thread carries T and the four suffix sums in registers;
//   * each slot's 10 per-pixel gradient terms are summed over the block
//     deterministically: a warp-shuffle butterfly leaves each warp's sum in
//     shared memory, and at the end of the chunk a fixed-order sum of the 8
//     warp partials gives each (slot, field), written with coalesced stores.
//     One block owns each (tile, slot) row, so there are no atomics and the
//     result is the same from run to run;
//   * the loop stops at the tile's count; the rest of the row is zeroed.
// It uses expf (not __expf) and no fast math.

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int NWARP = PIX / 32;
// Gradient terms per slot, in this order: mx, my, conic a, b, c, R, G, B,
// opacity, depth.
constexpr int NGRAD = 10;

// Pack column -> gradient term, -1 for radius and pad (no gradient).
__device__ __forceinline__ int grad_term(int col) {
  if (col < 5) return col;
  if (col == 5 || col == 11) return -1;
  return col - 1;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(PIX)
raster_bwd_kernel(const float* __restrict__ pack,
                  const int* __restrict__ counts,
                  const float* __restrict__ color,
                  const float* __restrict__ depth,
                  const float* __restrict__ trans,
                  const float* __restrict__ g_color,
                  const float* __restrict__ g_depth,
                  const float* __restrict__ g_trans,
                  float* __restrict__ grad,
                  int max_per_tile, int n_tiles_x) {
  __shared__ float sh[CHUNK * PACK];
  __shared__ float part[NWARP][CHUNK][NGRAD];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / 32;
  const int lane = p % 32;
  float px, py;
  pixel_coords(tile, p, n_tiles_x, &px, &py);

  const int n = min(max(counts[tile], 0), max_per_tile);
  const size_t row = static_cast<size_t>(tile) * max_per_tile * PACK;
  const float* src = pack + row;
  float* dst = grad + row;

  const size_t o = static_cast<size_t>(tile) * PIX + p;
  const float gR = g_color[o * 3 + 0];
  const float gG = g_color[o * 3 + 1];
  const float gB = g_color[o * 3 + 2];
  const float gD = g_depth[o];
  const float gT_fin = g_trans[o] * trans[o];
  float SR = color[o * 3 + 0];
  float SG = color[o * 3 + 1];
  float SB = color[o * 3 + 2];
  float SD = depth[o];
  float T = 1.0f;

  for (int base = 0; base < n; base += CHUNK) {
    const int cnt = min(CHUNK, n - base);
    __syncthreads();  // the previous chunk's slots and partials are consumed
    stage_chunk(sh, src + base * PACK, cnt, p);
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float* g = sh + j * PACK;
      const Alpha a = eval_alpha(g, px, py);
      const float w = a.alpha * T;
      SR -= w * g[6];
      SG -= w * g[7];
      SB -= w * g[8];
      SD -= w * g[10];
      const float inv = 1.0f / fmaxf(1.0f - a.alpha, 1e-6f);
      float dalpha = gR * (T * g[6] - SR * inv) + gG * (T * g[7] - SG * inv) +
                     gB * (T * g[8] - SB * inv) + gD * (T * g[10] - SD * inv) -
                     gT_fin * inv;
      if (!(a.alpha_raw < ALPHA_MAX)) dalpha = 0.0f;
      const float dm = dalpha * a.alpha_raw * -0.5f;

      float v[NGRAD];
      v[0] = dm * -(2.0f * g[2] * a.dx + 2.0f * g[3] * a.dy);
      v[1] = dm * -(2.0f * g[3] * a.dx + 2.0f * g[4] * a.dy);
      v[2] = dm * a.dx * a.dx;
      v[3] = dm * 2.0f * a.dx * a.dy;
      v[4] = dm * a.dy * a.dy;
      v[5] = w * gR;
      v[6] = w * gG;
      v[7] = w * gB;
      v[8] = dalpha * a.e;
      v[9] = w * gD;
#pragma unroll
      for (int k = 0; k < NGRAD; ++k) {
        const float s = warp_sum(v[k]);
        if (lane == 0) part[warp][j][k] = s;
      }
      T *= 1.0f - a.alpha;
    }
    __syncthreads();
    for (int i = p; i < cnt * PACK; i += PIX) {
      const int slot = i / PACK;
      const int k = grad_term(i % PACK);
      float s = 0.0f;
      if (k >= 0) {
#pragma unroll
        for (int q = 0; q < NWARP; ++q) s += part[q][slot][k];
      }
      dst[base * PACK + i] = s;
    }
  }
  for (int i = n * PACK + p; i < max_per_tile * PACK; i += PIX) dst[i] = 0.0f;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller allocates every buffer (grad need not be zeroed: the kernel writes
// every element); nothing is synchronised here.
extern "C" int raster_bwd(const float* pack, const int* counts,
                          const float* color, const float* depth,
                          const float* trans, const float* g_color,
                          const float* g_depth, const float* g_trans,
                          float* grad, int n_tiles, int max_per_tile,
                          int n_tiles_x, void* stream) {
  if (n_tiles <= 0) return 0;
  raster_bwd_kernel<<<n_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
      pack, counts, color, depth, trans, g_color, g_depth, g_trans, grad,
      max_per_tile, n_tiles_x);
  return static_cast<int>(cudaGetLastError());
}
