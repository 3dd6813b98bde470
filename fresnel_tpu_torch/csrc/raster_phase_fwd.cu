// Phase-blending forward tile compositor (K1-phi) for NVIDIA Hopper
// (sm_90a).
//
// Replaces the phase path of the XLA scan compositor
// fresnel_tpu/render/tile.py::_composite_tiles (:672-716), which the JAX
// package runs when a tiled renderer with use_phase_blending is handed
// phases (render_tiled, :869-871; no Pallas kernel takes it, :889).
//
// Input:  pack    (T, M, 12) float32, K1's layout with each slot's phase in
//                 column 11 (0 in dead slots); counts (T,) int32.
//         amp     the phase amplitude A of the interference factor, and
//                 one_minus_amp 1 - A rounded to float32 from double (as
//                 the plain version's scalar is).
//         box     0 drops the 3-sigma box test (hard_cutoff=False).
//         ckpt    (T, ceil(M / 16), 2, 256) float32 or null: with it, every
//                 pixel's (T, acc_phase) before slots 0, 16, 32, ... for
//                 the backward (K2-phi).
// Output: color (T, 256, 3), depth (T, 256), trans (T, 256), as K1's.
//
// The recurrence (raster_common.cuh, phase_step) carries a running phase
// per pixel that each slot's alpha depends on, so a segment cannot start
// before every slot ahead of it is done: unlike K1 this kernel does not
// split a tile's list.  One block of 256 threads (one per pixel) walks
// each tile's list whole, 64 slots staged in shared memory at a time (the
// conic pre-scaled as K1 stages it).  One launch, T blocks.  No atomics;
// the result repeats bit for bit.  expf and cosf, no fast math.

#include "raster_common.cuh"

namespace {

using namespace raster;

template <bool BOX>
__global__ void __launch_bounds__(PIX)
composite_phase(const float* __restrict__ pack,
                const int* __restrict__ counts, float* __restrict__ color,
                float* __restrict__ depth, float* __restrict__ trans,
                float* __restrict__ ckpt, int max_per_tile, int n_tiles_x,
                int tiles_per_image, Amplitude amp) {
  __shared__ float sh[SEG * PACK];
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int n = tile_count(counts, tile, max_per_tile);
  const int nck = n_checkpoints(max_per_tile);
  float px, py;
  pixel_coords(tile, p, n_tiles_x, tiles_per_image, &px, &py);
  float T = 1.0f, acc_phase = 0.0f;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int first = 0; first < n; first += SEG) {
    const int cnt = min(SEG, n - first);
    __syncthreads();   // every thread is done with the previous chunk
    stage_slots(sh, pack + (static_cast<size_t>(tile) * max_per_tile +
                            first) * PACK, cnt, p);
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const int slot = first + j;
      if (ckpt != nullptr && slot % CKPT == 0) {
        float* q = ckpt + ((static_cast<size_t>(tile) * nck + slot / CKPT) *
                           2) * PIX + p;
        q[0] = T;
        q[PIX] = acc_phase;
      }
      phase_step<BOX>(sh + j * PACK, px, py, amp, T, acc_phase, acc);
    }
  }
  const size_t o = static_cast<size_t>(tile) * PIX + p;
  color[o * 3 + 0] = acc[0];
  color[o * 3 + 1] = acc[1];
  color[o * 3 + 2] = acc[2];
  depth[o] = acc[3];
  trans[o] = T;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `ckpt` may be null (no backward).  The caller allocates every buffer.
extern "C" int raster_phase_fwd(const float* pack, const int* counts,
                                float* color, float* depth, float* trans,
                                float* ckpt, int n_tiles, int max_per_tile,
                                int n_tiles_x, int tiles_per_image, int box,
                                float amp, float one_minus_amp,
                                void* stream) {
  if (n_tiles <= 0) return 0;
  if (tiles_per_image < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const raster::Amplitude a{amp, one_minus_amp};
  if (box)
    composite_phase<true><<<n_tiles, PIX, 0, s>>>(
        pack, counts, color, depth, trans, ckpt, max_per_tile, n_tiles_x,
        tiles_per_image, a);
  else
    composite_phase<false><<<n_tiles, PIX, 0, s>>>(
        pack, counts, color, depth, trans, ckpt, max_per_tile, n_tiles_x,
        tiles_per_image, a);
  return static_cast<int>(cudaGetLastError());
}
