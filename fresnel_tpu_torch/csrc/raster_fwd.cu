// Forward tile compositor for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fresnel_tpu/render/pallas_raster.py::_fwd_kernel
// (launched by _run_forward through composite_tiles_pallas_packed): front-
// to-back alpha compositing of each 16x16 tile's depth-ordered binned
// Gaussians into premultiplied RGB, depth and final transmittance.
//
// Input:  pack   (T, M, 12) float32, per slot [mx, my, conic a, b, c, radius,
//                R, G, B, opacity, depth, pad]; dead slots carry opacity 0 and
//                radius -1, so they contribute nothing.
//         counts (T,) int32, occupied slots per tile (slots >= count are
//                never read).
// Output: color (T, 256, 3), depth (T, 256), trans (T, 256), float32, pixel
//         p = ly * 16 + lx of tile t = ty * n_tiles_x + tx at integer pixel
//         coordinates (tx * 16 + lx, ty * 16 + ly).
//
// What bounds it on this card: each tile reads count * 48 bytes and writes
// 256 * 20 bytes, while it does count * 256 pixel-Gaussian evaluations of
// ~20 FLOP and one exp.  At the main path's occupancy (hundreds of Gaussians
// per tile) the evaluations dominate: it is bound by float32 operations,
// not by memory.  The design keeps every evaluation in registers:
//   * one block of 256 threads per tile, one thread per pixel;
//   * the block stages CHUNK slots (CHUNK * 48 bytes) at a time in shared
//     memory with one coalesced cooperative load, and every thread then
//     reads each slot by broadcast from shared memory;
//   * each thread carries its own transmittance and RGB / depth sums front
//     to back, sequentially: the Pallas kernel's vectorised cumprod over a
//     chunk is a TPU lane trick that Hopper does not need;
//   * the loop stops at the tile's count, not at M.
// It uses expf (not __expf) and no fast math, and, like both JAX
// compositors, it does not stop a pixel early at low transmittance.  The
// alpha of a slot comes from raster_common.cuh, shared with the backward.

#include "raster_common.cuh"

namespace {

using namespace raster;

__global__ void __launch_bounds__(PIX)
raster_fwd_kernel(const float* __restrict__ pack,
                  const int* __restrict__ counts,
                  float* __restrict__ color,
                  float* __restrict__ depth,
                  float* __restrict__ trans,
                  int max_per_tile, int n_tiles_x) {
  __shared__ float sh[CHUNK * PACK];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  float px, py;
  pixel_coords(tile, p, n_tiles_x, &px, &py);

  const int n = min(max(counts[tile], 0), max_per_tile);
  const float* src = pack + static_cast<size_t>(tile) * max_per_tile * PACK;

  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;

  for (int base = 0; base < n; base += CHUNK) {
    const int cnt = min(CHUNK, n - base);
    __syncthreads();  // every thread is done with the previous chunk
    stage_chunk(sh, src + base * PACK, cnt, p);
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float* g = sh + j * PACK;
      const float alpha = eval_alpha(g, px, py).alpha;
      const float w = alpha * T;
      acc_r += w * g[6];
      acc_g += w * g[7];
      acc_b += w * g[8];
      acc_d += w * g[10];
      T *= 1.0f - alpha;
    }
  }

  const size_t o = static_cast<size_t>(tile) * PIX + p;
  color[o * 3 + 0] = acc_r;
  color[o * 3 + 1] = acc_g;
  color[o * 3 + 2] = acc_b;
  depth[o] = acc_d;
  trans[o] = T;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller allocates every buffer; nothing is synchronised here.
extern "C" int raster_fwd(const float* pack, const int* counts, float* color,
                          float* depth, float* trans, int n_tiles,
                          int max_per_tile, int n_tiles_x, void* stream) {
  if (n_tiles <= 0) return 0;
  raster_fwd_kernel<<<n_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
      pack, counts, color, depth, trans, max_per_tile, n_tiles_x);
  return static_cast<int>(cudaGetLastError());
}
