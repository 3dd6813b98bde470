// Backward tile compositor for NVIDIA Hopper (sm_90a): the analytic VJP of
// raster_fwd.cu.
//
// Replaces the TPU kernel fresnel_tpu/render/pallas_raster.py::_bwd_kernel
// (:179) and its body _bwd_chunk_body (:220), launched at :326 by
// _run_backward and attached to the forward by composite_pallas.defvjp.
//
// Input:  pack    (T, M, 12) float32 and counts (T,) int32, as the forward;
//         color   (T, 256, 3), depth (T, 256): the forward's premultiplied
//                 sums, BEFORE any background is added;
//         trans   (T, 256): the forward's final transmittance T_fin;
//         g_color (T, 256, 3), g_depth (T, 256), g_trans (T, 256): the
//                 cotangents of the three outputs;
//         part    (ceil(M / 64), T, 5, 256) float32: the forward's segment
//                 prefixes (raster_common.cuh) when `prefix_ready`, else
//                 scratch that the forward's kernel fills first;
//         tickets (T,) int32, zero, as the forward's;
//         resident  as the forward's: it sets the segment length.
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
// the forward uses.
//
// What bounds it on this card: the function reads count * 48 bytes of pack
// and 256 * 40 bytes of outputs and cotangents per tile and writes M * 48
// bytes, while it evaluates every pixel inside each slot's box, ~90
// operations each (the forward's alpha, the suffix update, dalpha, the
// chain rule and a share of the reduction over the tile's pixels); outside
// the box every term is exactly 0.  A design with one block per tile
// walking the whole list and summing each slot's ten terms over the warp
// with ten 5-step shuffle butterflies is held by the heaviest tile's serial
// list and by ~190 instructions per pixel and slot, half of them the
// butterflies, paid by every warp for every slot.  The design:
//   * the work unit is (tile, segment), the forward's (raster_common.cuh):
//     one block of 256 threads per unit, one thread per pixel, in one
//     launch with the forward's grid and segment length.  A segment k needs
//     only the transmittance at its start T_in and the suffix sums there,
//     S_in = S_total - P (P the sums of the segments before it): the
//     prefixes that the forward's fold leaves in `part`.  This is the carry
//     the Pallas kernel passes along its sequential chunk axis; here the
//     axis is parallel blocks and the carry a second pass.  Without
//     `prefix_ready` the entry point reruns the forward's kernel into
//     `part` first (same code, same bits);
//   * each block owns its unit's rows of `grad`: per slot, the 10
//     per-pixel terms are summed over the block deterministically, with no
//     atomics, so the result repeats bit for bit;
//   * a warp in which no pixel lies inside the slot's box (__any_sync)
//     skips the slot and its partial sums are 0: every term there is
//     exactly 0;
//   * otherwise one reduce-scatter over the warp (11 shuffle steps that
//     halve the terms each lane holds, and one butterfly) leaves 10 lanes
//     with the warp's sum of one term each, where ten butterflies took 50
//     shuffles; after each staged chunk a fixed-order sum of the 8 warp
//     partials gives each (slot, field), written with coalesced stores, and
//     the unit that ends a tile writes the slots past its count as 0 (an
//     empty tile's first block zeroes its row).
// It uses expf (not __expf) and no fast math.

#include "raster_common.cuh"

namespace {

using namespace raster;

// Gradient terms per slot, in this order: mx, my, conic a, b, c, R, G, B,
// opacity, depth.
constexpr int NGRAD = 10;

// Pack column -> gradient term, -1 for radius and pad (no gradient).
__device__ __forceinline__ int grad_term(int col) {
  if (col < 5) return col;
  if (col == 5 || col == 11) return -1;
  return col - 1;
}

// One step of the reduce-scatter: lanes with `upper` keep b, the others a;
// each sends the other to its partner `off` lanes away and adds what it
// receives.
__device__ __forceinline__ float fold(float a, float b, bool upper,
                                      int off) {
  const float keep = upper ? b : a;
  const float send = upper ? a : b;
  return keep + __shfl_xor_sync(FULL, send, off);
}

// Sums ten terms over the warp.  Returns to lane l the warp's sum of term
// reduced_term(l), in a fixed order.
__device__ __forceinline__ float warp_sum10(const float (&v)[NGRAD],
                                            int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  // Lanes below 16 keep terms 0-4, the others 5-9; then 3 + 2 of those
  // five, then 2 + 1 of those three (the gaps padded with 0), then one.
  const float s0 = fold(v[0], v[5], b4, 16), s1 = fold(v[1], v[6], b4, 16),
              s2 = fold(v[2], v[7], b4, 16), s3 = fold(v[3], v[8], b4, 16),
              s4 = fold(v[4], v[9], b4, 16);
  const float t0 = fold(s0, s3, b3, 8), t1 = fold(s1, s4, b3, 8),
              t2 = fold(s2, 0.0f, b3, 8);
  const float u0 = fold(t0, t2, b2, 4), u1 = fold(t1, 0.0f, b2, 4);
  const float w = fold(u0, u1, b1, 2);
  return w + __shfl_xor_sync(FULL, w, 1);
}

// The term whose warp sum warp_sum10 leaves in lane l, -1 if none: lanes
// 2k and 2k + 1 hold the same sum, and lane bits 3..1 pick one of the five
// terms of the half that bit 4 picks (0, 1, 2, -, 3, 4, -, -).
__device__ __forceinline__ int reduced_term(int lane) {
  const int idx = ((0x00540321 >> (4 * ((lane >> 1) & 7))) & 0xF) - 1;
  return (lane & 1) == 0 && idx >= 0 ? 5 * (lane >> 4) + idx : -1;
}

__global__ void __launch_bounds__(PIX)
raster_bwd_segments(const float* __restrict__ pack,
                    const int* __restrict__ counts,
                    const float* __restrict__ color,
                    const float* __restrict__ depth,
                    const float* __restrict__ trans,
                    const float* __restrict__ g_color,
                    const float* __restrict__ g_depth,
                    const float* __restrict__ g_trans,
                    const float* __restrict__ part,
                    float* __restrict__ grad,
                    int n_tiles, int max_per_tile, int n_tiles_x,
                    int tiles_per_image, int resident) {
  __shared__ float sh[SEG * PACK];
  __shared__ float sums[NWARP][SEG][NGRAD];
  __shared__ BlockUnits bu;

  const int p = threadIdx.x;
  const int warp = p / 32;
  const int lane = p % 32;
  const int term = reduced_term(lane);
  plan_block(counts, n_tiles, max_per_tile, resident, bu);

  for (int l = 0; l < bu.n; ++l) {
    const int tile = bu.tile[l];
    const int seg = bu.seg[l];
    const int n = tile_count(counts, tile, max_per_tile);
    const int nseg = n_segments(n, bu.L);
    const int end = min(n, (seg + 1) * bu.L);
    float* row = grad + static_cast<size_t>(tile) * max_per_tile * PACK;

    float px, py;
    pixel_coords(tile, p, n_tiles_x, tiles_per_image, &px, &py);
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
    if (nseg > 1) {
      const float* q = part + part_at(seg, tile, n_tiles, 0) + p;
      SR -= q[0 * PIX];
      SG -= q[1 * PIX];
      SB -= q[2 * PIX];
      SD -= q[3 * PIX];
      T = q[4 * PIX];
    }

    for (int first = seg * bu.L; first < end; first += SEG) {
      const int cnt = min(SEG, end - first);
      __syncthreads();   // the previous chunk's slots and sums are consumed
      stage_slots(sh, pack + (static_cast<size_t>(tile) * max_per_tile +
                              first) * PACK, cnt, p);
      __syncthreads();
      for (int j = 0; j < cnt; ++j) {
        const float* g = sh + j * PACK;
        const Alpha a = eval_alpha(g, px, py);
        if (!__any_sync(FULL, in_box(g, a.dx, a.dy))) {
          if (term >= 0) sums[warp][j][term] = 0.0f;
          continue;
        }
        const float w = a.alpha * T;
        SR -= w * g[R];
        SG -= w * g[G];
        SB -= w * g[B];
        SD -= w * g[DEPTH];
        const float inv = __frcp_rn(fmaxf(1.0f - a.alpha, 1e-6f));
        // sum_c g_c (T c - S_c inv) - g_T T_fin inv, regrouped.
        const float gc = gR * g[R] + gG * g[G] + gB * g[B] + gD * g[DEPTH];
        const float gs = gR * SR + gG * SG + gB * SB + gD * SD;
        float dalpha = T * gc - inv * (gs + gT_fin);
        if (!(a.alpha_raw < ALPHA_MAX)) dalpha = 0.0f;
        // dm = d loss / d m, m the quadratic form; the conic is staged as
        // qa = -a / 2, qb = -b, qc = -c / 2.
        const float dm = dalpha * a.alpha_raw * -0.5f;
        const float dmx = dm * a.dx;
        const float v[NGRAD] = {
            dm * 2.0f * (2.0f * g[QA] * a.dx + g[QB] * a.dy),
            dm * 2.0f * (g[QB] * a.dx + 2.0f * g[QC] * a.dy),
            dmx * a.dx,
            2.0f * dmx * a.dy,
            dm * a.dy * a.dy,
            w * gR,
            w * gG,
            w * gB,
            dalpha * a.e,
            w * gD};
        const float s = warp_sum10(v, lane);
        if (term >= 0) sums[warp][j][term] = s;
        T *= 1.0f - a.alpha;
      }
      __syncthreads();
      for (int i = p; i < cnt * PACK; i += PIX) {
        const int k = grad_term(i % PACK);
        float s = 0.0f;
        if (k >= 0) {
  #pragma unroll
          for (int q = 0; q < NWARP; ++q) s += sums[q][i / PACK][k];
        }
        row[first * PACK + i] = s;
      }
    }
    // The unit that ends the tile (or an empty tile's, in the whole-tile
    // walk) zeroes its slots past the count.
    if (seg >= nseg - 1) {
      for (int i = n * PACK + p; i < max_per_tile * PACK; i += PIX)
        row[i] = 0.0f;
    }
  }
  if (bu.whole) return;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    if (tile_count(counts, tile, max_per_tile) > 0) continue;
    float* row = grad + static_cast<size_t>(tile) * max_per_tile * PACK;
    for (int i = p; i < max_per_tile * PACK; i += PIX) row[i] = 0.0f;
  }
}

}  // namespace

// Launches on `stream` and returns the first nonzero cudaGetLastError() (0
// on success).  When `prefix_ready`, part holds the forward's prefixes for
// the same pack, counts and `resident`; else the forward's kernel fills it
// first (tickets as the forward's).  The caller allocates every buffer
// (grad need not be zeroed: the kernel writes every element); nothing is
// synchronised here.
extern "C" int raster_bwd(const float* pack, const int* counts,
                          const float* color, const float* depth,
                          const float* trans, const float* g_color,
                          const float* g_depth, const float* g_trans,
                          float* part, int* tickets, float* grad,
                          int n_tiles, int max_per_tile, int n_tiles_x,
                          int tiles_per_image, int resident, int prefix_ready,
                          void* stream) {
  if (n_tiles <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (!prefix_ready) {
    const cudaError_t err = raster::launch_composite(
        pack, counts, nullptr, nullptr, nullptr, part, tickets, n_tiles,
        max_per_tile, n_tiles_x, tiles_per_image, resident, 1, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  raster_bwd_segments<<<raster::grid_size(n_tiles, max_per_tile, resident),
                        raster::PIX, 0, s>>>(
      pack, counts, color, depth, trans, g_color, g_depth, g_trans, part,
      grad, n_tiles, max_per_tile, n_tiles_x, tiles_per_image, resident);
  return static_cast<int>(cudaGetLastError());
}
