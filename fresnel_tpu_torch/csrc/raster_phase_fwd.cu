// Phase-blending forward tile compositor (K1-phi) for NVIDIA Hopper
// (sm_90a).
//
// Replaces the phase path of the XLA scan compositor
// fresnel_tpu/render/tile.py::_composite_tiles (:672-716), which the JAX
// package runs when a tiled renderer with use_phase_blending is handed
// phases (render_tiled, :869-871).  No Pallas kernel takes it (:889), so
// this kernel has no Pallas counterpart.
//
// Input:  pack    (T, M, 12) float32, K1's layout with each slot's phase in
//                 column 11 (0 in dead slots); counts (T,) int32.
//         amp     the phase amplitude A of the interference factor, and
//                 one_minus_amp 1 - A rounded to float32 from double (as
//                 the plain version's scalar is).
//         box     0 drops the 3-sigma box test (hard_cutoff=False).
//         tile_size  ts >= 1, P = ts^2 pixels a tile (16 compiled in).
//         ckpt    (T, ceil(M / 16), 2, P) float32 or null: with it, every
//                 pixel's (T, acc_phase) before slots 0, 16, 32, ... for
//                 the backward (K2-phi).
// Output: color (T, P, 3), depth (T, P), trans (T, P), as K1's.
//
// What bounds it on this card: the recurrence (raster_common.cuh,
// phase_step_set) carries a running phase per pixel that each slot's alpha
// depends on, so each pixel's chain runs serially over its tile's whole
// list.  A step inside a slot's box is ~45 operations rounded op by op (no
// fast math, no fused multiply-adds), of which a chain of ~35 is serial:
// the cosf of the running phase's distance (range reduction, polynomial),
// the factor, alpha, the weight and an IEEE division.  The bytes (the pack
// once, the outputs and the checkpoints) would take a tenth of the time.
// The first design, one pixel per thread in blocks of 256 (32 registers, 8
// blocks per SM, so T = 1 024 already ran in one wave), evaluated every
// slot in every warp before skipping it, and stalled on each chain: cosf
// and the division each branch to a slow path, and the branch stops the
// compiler from overlapping anything across it.  The design:
//   * two pixels per thread, one column, two rows apart (raster_common.cuh,
//     PixelSet): they share the column's offset and its products, and their
//     two chains interleave;
//   * no branch in a step (phase_step_set): expf at every pixel with a
//     select for the box, cosf and the division by their exact fast paths
//     (sin_quadrant, div_fast: the same instructions CUDA runs, held bit
//     for bit against the library by phase_fastpath_check.cu) unless an
//     argument is out of their range, and the commit by selects;
//   * each warp owns a strip of 16 x 4 pixels and lists the slots whose
//     box can reach it: 32 slots at a time, one per lane, are loaded from
//     the pack, tested once against the strip (strip_hit, exact: a slot is
//     dropped only where no pixel of the strip is inside its box, and there
//     alpha_raw is 0 and nothing changes) and the survivors compacted in
//     index order (a ballot, __popc of the lanes below) into the warp's own
//     list in shared memory.  The warp then walks only its list, with no
//     barrier with the other warps.  Under box = 0 every slot is listed;
//   * the checkpoints are written once per 16 slots of the tile's list,
//     between the two halves of a warp's 32-slot list (every k < ceil(n /
//     16), whether or not the warp lists a slot there), not tested per
//     slot;
//   * heaviest tiles first (raster_common.cuh, tile_by_weight): block b
//     takes the b-th tile by descending count, so the longest chains start
//     first and each SM gets one of the heaviest 132 (faster than tile
//     order on the card, PERF.md);
//   * at a tile size other than 16 (one runtime instantiation) a block
//     takes one pixel group of at most 256 pixels of a tile (blocks b / NG
//     by weight, group b % NG), a thread pixels p and p + 32 of the
//     group's order, and a warp culls against the bounding box of the
//     pixels it owns (the tile's width where they cross a row).
// Residency: 128 threads and 6 KB of shared memory per block, at most 64
// registers a thread (__launch_bounds__(128, 8)): an SM holds 8 tiles, the
// card 1 056, so the phase-train pack (T = 1 024) runs in one wave.  No
// atomics; the result repeats bit for bit and equals the plain version's
// on the card (and the first design's).  expf, cosf and IEEE division, no
// fast math.

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int LIST = 32;   // slots a warp tests and lists at a time

template <int TSC, bool BOX>
__global__ void __launch_bounds__(PHASE_MAX_THREADS, TSC > 0 ? 8 : 6)
composite_phase(const float* __restrict__ pack,
                const int* __restrict__ counts, float* __restrict__ color,
                float* __restrict__ depth, float* __restrict__ trans,
                float* __restrict__ ckpt, int n_tiles, int max_per_tile,
                int n_tiles_x, int tiles_per_image, Amplitude amp,
                int tile_size) {
  __shared__ __align__(16) float list[PHASE_MAX_THREADS / 32][LIST * PACK];
  const Tile<TSC> geo(tile_size);
  const int P = geo.pix();
  const int NG = phase_groups(geo);
  // Block b takes pixel group b % NG of the (b / NG)-th heaviest tile.
  const int tile = tile_by_weight<TSC == TS ? PHASE_THREADS : 0>(
      counts, n_tiles, max_per_tile, blockIdx.x / NG);
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int n = tile_count(counts, tile, max_per_tile);
  const int nck = n_checkpoints(max_per_tile);
  const PixelSet<TSC> q = pixel_set(geo, tile, blockIdx.x % NG, t,
                                    n_tiles_x, tiles_per_image);
  const float* src = pack + static_cast<size_t>(tile) * max_per_tile * PACK;
  float* mine = list[t / 32];
  float T[PPT], acc_phase[PPT], acc[PPT][4];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    T[i] = 1.0f;
    acc_phase[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  }
  // Writes checkpoint k (the state before slot 16 k) of the thread's pixels.
  auto checkpoint = [&](int k) {
    if (ckpt == nullptr) return;
    float* c = ckpt + (static_cast<size_t>(tile) * nck + k) * 2 * P + q.p;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      if (!q.owns(i)) continue;
      c[i * 32] = T[i];
      c[P + i * 32] = acc_phase[i];
    }
  };
  for (int first = 0; first < n; first += LIST) {
    // Lane l tests slot first + l against the warp's box.
    const int j = first + lane;
    float v[PACK];
    bool keep = false;
    if (j < n && q.owns_any()) {
#pragma unroll
      for (int c = 0; c < PACK; ++c)
        v[c] = staged(src[static_cast<size_t>(j) * PACK + c], c);
      keep = !BOX || strip_hit(v, q);
    }
    const unsigned live = __ballot_sync(FULL, keep);
    __syncwarp();   // the warp is done with its previous list
    if (keep) {
      float* row = mine + __popc(live & ((1u << lane) - 1u)) * PACK;
#pragma unroll
      for (int c = 0; c < PACK; ++c) row[c] = v[c];
    }
    __syncwarp();
    const int half = __popc(live & 0xffffu);
    const int listed = __popc(live);
    checkpoint(first / CKPT);
    for (int i = 0; i < half; ++i)
      phase_step_set<BOX>(mine + i * PACK, q, amp, T, acc_phase, acc);
    if (first + CKPT < n) checkpoint(first / CKPT + 1);
    for (int i = half; i < listed; ++i)
      phase_step_set<BOX>(mine + i * PACK, q, amp, T, acc_phase, acc);
  }
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    if (!q.owns(i)) continue;
    const size_t o = static_cast<size_t>(tile) * P + q.p + i * 32;
    color[o * 3 + 0] = acc[i][0];
    color[o * 3 + 1] = acc[i][1];
    color[o * 3 + 2] = acc[i][2];
    depth[o] = acc[i][3];
    trans[o] = T[i];
  }
}

template <int TSC>
cudaError_t launch_as(const float* pack, const int* counts, float* color,
                      float* depth, float* trans, float* ckpt, int n_tiles,
                      int max_per_tile, int n_tiles_x, int tiles_per_image,
                      int box, Amplitude a, int tile_size, cudaStream_t s) {
  const Tile<TSC> geo(tile_size);
  const int grid = n_tiles * phase_groups(geo), nt = phase_threads(geo);
  if (box)
    composite_phase<TSC, true><<<grid, nt, 0, s>>>(
        pack, counts, color, depth, trans, ckpt, n_tiles, max_per_tile,
        n_tiles_x, tiles_per_image, a, tile_size);
  else
    composite_phase<TSC, false><<<grid, nt, 0, s>>>(
        pack, counts, color, depth, trans, ckpt, n_tiles, max_per_tile,
        n_tiles_x, tiles_per_image, a, tile_size);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `ckpt` may be null (no backward).  The caller allocates every buffer.
extern "C" int raster_phase_fwd(const float* pack, const int* counts,
                                float* color, float* depth, float* trans,
                                float* ckpt, int n_tiles, int max_per_tile,
                                int n_tiles_x, int tiles_per_image, int box,
                                int tile_size, float amp, float one_minus_amp,
                                void* stream) {
  if (n_tiles <= 0) return 0;
  if (tiles_per_image < 1 || tile_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const raster::Amplitude a{amp, one_minus_amp};
  const auto launch =
      tile_size == raster::TS ? launch_as<raster::TS> : launch_as<0>;
  return static_cast<int>(launch(pack, counts, color, depth, trans, ckpt,
                                 n_tiles, max_per_tile, n_tiles_x,
                                 tiles_per_image, box, a, tile_size, s));
}

// The box-test kernel's residency on the current device at tile size
// `tile_size` (raster_common.cuh, kernel_residency): out[5] = registers per
// thread, static shared bytes, local bytes, threads per block, blocks per
// SM.  Returns a CUDA error code.
extern "C" int raster_phase_fwd_residency(int tile_size, int* out) {
  if (tile_size < 1) return static_cast<int>(cudaErrorInvalidValue);
  const raster::Tile<0> geo(tile_size);
  return tile_size == raster::TS
             ? raster::kernel_residency(composite_phase<raster::TS, true>,
                                        raster::PHASE_THREADS, out)
             : raster::kernel_residency(composite_phase<0, true>,
                                        raster::phase_threads(geo), out);
}
