// Forward tile compositor for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fresnel_tpu/render/pallas_raster.py::_fwd_kernel
// (:135, launched at :288 by _run_forward through
// composite_tiles_pallas_packed): front-to-back alpha compositing of each
// 16x16 tile's depth-ordered binned Gaussians into premultiplied RGB, depth
// and final transmittance; and, at any other tile size ts, what the JAX
// package's XLA scan fresnel_tpu/render/tile.py::_composite_tiles
// (:614-670) computes there.
//
// Input:  pack    (T, M, 12) float32, per slot [mx, my, conic a, b, c,
//                 radius, R, G, B, opacity, depth, pad]; dead slots carry
//                 opacity 0 and radius -1, so they contribute nothing.
//         counts  (T,) int32, occupied slots per tile (slots >= count are
//                 never read).
//         part    (ceil(M / 64), T, 5, P) float32 scratch and tickets
//                 (T,) int32, zero (raster_common.cuh).  With `keep_prefix`
//                 part is left holding each segment's prefix, which the
//                 backward takes instead of rerunning this pass.
//         resident  blocks of this kernel the card holds at once; it sets
//                 the segment length, so the backward must be given the
//                 same.
//         tile_size  ts >= 1, P = ts^2 pixels a tile (16 compiled in);
//         plan    int32 scratch of 3 + 2 (resident + T) for a size other
//                 than 16 (raster_common.cuh, plan_units), else unused.
// Output: color (T, P, 3), depth (T, P), trans (T, P), float32, pixel
//         p = ly * ts + lx of tile t = ty * n_tiles_x + tx at integer pixel
//         coordinates (tx * ts + lx, ty * ts + ly), t counted within its
//         image: a pack of B images holds each one's tiles_per_image
//         tiles in turn (one launch for a batch).
//
// What bounds it on this card: the function reads count * 48 bytes per tile
// and writes 256 * 20, and evaluates every pixel inside each slot's box
// (~20 FLOP and one exp), so it is bound by float32 operations.  A design
// with one block per tile walking the whole list in series is held instead
// by the heaviest tile where few tiles hold long lists (the refine pack:
// 256 blocks on 132 SMs, up to 1 024 slots each), and, where the pack fills
// the card, by the instructions per evaluation (~34, expf alone 8, for
// every pixel of the tile, in the box or not).
// The design (raster_common.cuh):
//   * the work unit is (tile, segment), the segment length L set from the
//     pack's total work by every block alike: heavy tiles of a light pack
//     are cut into 64-slot segments that run in parallel, a pack that fills
//     the card keeps whole tiles and pays no fold;
//   * one launch, one block of 256 threads per unit, one thread per pixel
//     (at another tile size, a block of one pixel group that walks the
//     unit once for each group, and, where the tiles are many, a one-block
//     pre-pass that writes the plan every block would else derive:
//     raster_common.cuh):
//     max(resident, T) blocks, each deriving the plan from `counts` (two
//     units per block at most, every unit in one wave where the card holds
//     them; no block launched for nothing, which cost 4-10 µs at the
//     image and refine packs).  A block stages 64 slots (3 KB) at a time
//     in shared memory, conic pre-scaled, and every thread reads each
//     slot's fields by broadcast where it uses them (32 registers: eight
//     blocks per SM).  A skip of
//     slots outside a warp's pixels measured no faster here (PERF.md): at
//     these packs most warps have a pixel in most boxes, and the test
//     costs what it saves;
//   * a one-segment tile writes its outputs directly; a longer tile's
//     segments write partials that the tile's last unit to finish folds in
//     segment order (no second launch), so the result is the same from run
//     to run.  No value is summed with atomics.
// It uses expf (not __expf) and no fast math, and, like both JAX
// compositors, it does not stop a pixel early at low transmittance.

#include "raster_common.cuh"

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  The caller allocates every buffer; nothing is synchronised.
// `box` 0 drops the 3-sigma box test (hard_cutoff=False).
extern "C" int raster_fwd(const float* pack, const int* counts, float* color,
                          float* depth, float* trans, float* part,
                          int* tickets, int* plan, int n_tiles,
                          int max_per_tile, int n_tiles_x,
                          int tiles_per_image, int resident, int keep_prefix,
                          int box, int tile_size, void* stream) {
  if (n_tiles <= 0) return 0;
  return static_cast<int>(raster::launch_composite(
      pack, counts, color, depth, trans, part, tickets, plan, n_tiles,
      max_per_tile, n_tiles_x, tiles_per_image, resident, keep_prefix, box,
      tile_size, static_cast<cudaStream_t>(stream)));
}
