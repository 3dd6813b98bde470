// Rank table of the search binning for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fresnel_tpu/render/pallas_binning.py::_table_kernel
// (launched by build_rank_table): for every (tile, Gaussian) pair the hit bit
// of four integer interval tests, and along the depth-sorted Gaussian axis
// the inclusive count of hits within each chunk of 256, written in the
// (tiles, Gaussians) layout that the two-level search reads.
//
// Input:  xlo, xhi, ylo, yhi (n2,) int32, inclusive tile-index intervals in
//         depth order; n2 is a multiple of 256; an empty interval (hi < lo)
//         marks an invisible or padding entry.
//         Tiles t = ty * n_tiles_x + tx, tested at (tx, ty + y_offset):
//         y_offset shifts the rows for a tile-row group.
// Output: table  (T, n2) bfloat16: table[t, k] = hits of tile t among the
//                Gaussians of k's chunk up to and including k (<= 256, so
//                exact in bfloat16);
//         cumtot (T, n2 / 256) int32: hits of tile t in chunks 0..c,
//                inclusive.
//
// The Pallas body turns the in-chunk count into a (tiles, 256) x (256, 256)
// matrix product against a triangular ones matrix, because the TPU's matrix
// unit is its cheapest prefix sum.
//
// What bounds it on this card: the table is written once, T * n2 * 2 bytes
// (2 048 393 216 B at a million Gaussians and 1024 tiles), 0.61 ms at the
// card's 3.35 TB/s.  A design with one thread per entry (a vote, a popcount,
// a byte in shared memory, a barrier per 16 tiles and a 2-byte store per
// entry, 64 B per warp store) issues ~20 instructions per entry and is held
// by instruction issue and barriers at ~3x the byte bound.  So this one cuts
// the instructions per entry until the stores are the limit:
//   * one warp owns one chunk; each lane keeps the bounds of 8 consecutive
//     Gaussians in registers, loaded once for all the tiles the warp walks;
//   * the y test depends on the tile row only: once per row it folds each
//     Gaussian's y test into its x interval (an empty one where the row is
//     missed), so a tile costs two compares and an add per Gaussian, which
//     give the 8 in-lane inclusive counts;
//   * the lanes' totals get a 5-step __shfl_up_sync scan, the warp's
//     exclusive offset of each lane; no shared memory, no barrier;
//   * the 8 counts become bfloat16 without a conversion instruction (the
//     float of k < 2^23 is the bit pattern 2^23 + k less 2^23, and the
//     bfloat16 of an integer <= 256 is that float's upper half), paired by
//     one byte permute each, and leave as ONE 16-byte streaming store per
//     lane: the warp writes the chunk's 512-byte row segment in one
//     instruction;
//   * lane 31's inclusive count is the chunk's total;
//   * a block holds WARPS chunks and walks ROWS tile rows, so a million
//     Gaussians at 1024 tiles give 489 x 4 blocks, ~4 waves of 4 blocks
//     per SM (63 registers) on 132 SMs.
// A second small kernel turns the chunk totals of each tile into their
// inclusive running sum in place (one block per tile, coalesced through
// shared memory).  Offsets into the table are 64-bit.

#include <cstddef>
#include <cstdint>

namespace {

constexpr int CHUNK = 256;
constexpr int PER_LANE = CHUNK / 32;    // Gaussians a lane holds
constexpr int WARPS = 8;                // chunks per block
constexpr int ROWS = 8;                 // tile rows a warp walks
constexpr int VEC = 8;                  // bfloat16 per 16-byte store
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_HIT = 0x7fffffff;      // a lower bound no tile reaches

__device__ __forceinline__ float exact_float(int k) {
  // For 0 <= k < 2^23 the pattern 2^23 + k is the float 2^23 + k exactly:
  // an integer add and a float subtract instead of a conversion.
  return __int_as_float(0x4B000000 + k) - 8388608.0f;
}

__device__ __forceinline__ unsigned bf16_pair(int lo, int hi) {
  // Counts up to 256 have at most 8 significant bits: the upper half of
  // each float32 pattern is the exact bfloat16; lo in the low half, the
  // lower address.
  return __byte_perm(__float_as_uint(exact_float(lo)),
                     __float_as_uint(exact_float(hi)), 0x7632);
}

__global__ void __launch_bounds__(WARPS * 32)
bin_table_kernel(const int* __restrict__ xlo, const int* __restrict__ xhi,
                 const int* __restrict__ ylo, const int* __restrict__ yhi,
                 uint4* __restrict__ table, int* __restrict__ totals,
                 size_t n2, int n_chunks, int n_tiles_x, int n_rows,
                 int y_offset) {
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;  // the whole warp

  const size_t j0 = static_cast<size_t>(chunk) * CHUNK + lane * PER_LANE;
  int lo[PER_LANE], hi[PER_LANE], y0[PER_LANE], y1[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    lo[i] = xlo[j0 + i];
    hi[i] = xhi[j0 + i];
    y0[i] = ylo[j0 + i];
    y1[i] = yhi[j0 + i];
  }

  const int r_begin = blockIdx.y * ROWS;
  const int r_end = min(r_begin + ROWS, n_rows);
  const size_t row_vecs = n2 / VEC;  // 16-byte words per table row
  const size_t t_begin = static_cast<size_t>(r_begin) * n_tiles_x;
  uint4* out = table + t_begin * row_vecs
               + static_cast<size_t>(chunk) * (CHUNK / VEC) + lane;
  int* tot = totals + t_begin * n_chunks + chunk;

  for (int r = r_begin; r < r_end; ++r) {
    const int ty = r + y_offset;
    int rlo[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      rlo[i] = (y0[i] <= ty && ty <= y1[i]) ? lo[i] : NO_HIT;

    for (int tx = 0; tx < n_tiles_x; ++tx) {
      int c[PER_LANE];
      int run = 0;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        run += (tx >= rlo[i] && tx <= hi[i]) ? 1 : 0;
        c[i] = run;
      }
      int incl = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += up;
      }
      const int base = incl - run;
      uint4 v;
      v.x = bf16_pair(base + c[0], base + c[1]);
      v.y = bf16_pair(base + c[2], base + c[3]);
      v.z = bf16_pair(base + c[4], base + c[5]);
      v.w = bf16_pair(base + c[6], base + c[7]);
      __stcs(out, v);  // streaming: 2 GB pass the 50 MB L2 once
      if (lane == 31) *tot = incl;
      out += row_vecs;
      tot += n_chunks;
    }
  }
}

// In place: totals[t, c] <- sum of totals[t, 0..c].  One block per tile
// walks its row in segments of SCAN_SEG totals: coalesced loads into
// shared memory, each thread scans 8 neighbours, a warp-shuffle scan and
// the 8 warp sums give its offset, coalesced stores.  Shared indices skip
// one word per 32, so a thread's 8 neighbours sit in distinct banks.
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_SEG = CHUNK * SCAN_ITEMS;

__device__ __forceinline__ int padded(int k) { return k + (k >> 5); }

__global__ void __launch_bounds__(CHUNK)
chunk_cumsum_kernel(int* __restrict__ totals, int n_chunks) {
  __shared__ int seg[SCAN_SEG + SCAN_SEG / 32];
  __shared__ int warp_sums[CHUNK / 32];
  int* row = totals + static_cast<size_t>(blockIdx.x) * n_chunks;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int carry = 0;
  for (int s0 = 0; s0 < n_chunks; s0 += SCAN_SEG) {
    const int len = min(SCAN_SEG, n_chunks - s0);
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
      const int k = i * CHUNK + tid;
      seg[padded(k)] = k < len ? row[s0 + k] : 0;
    }
    __syncthreads();
    int v[SCAN_ITEMS];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
      v[i] = seg[padded(tid * SCAN_ITEMS + i)];
      sum += v[i];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int running = carry + incl - sum;
    int seg_total = 0;
#pragma unroll
    for (int w = 0; w < CHUNK / 32; ++w) {
      if (w < warp) running += warp_sums[w];
      seg_total += warp_sums[w];
    }
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
      running += v[i];
      seg[padded(tid * SCAN_ITEMS + i)] = running;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
      const int k = i * CHUNK + tid;
      if (k < len) row[s0 + k] = seg[padded(k)];
    }
    carry += seg_total;
    __syncthreads();  // the next segment overwrites seg and warp_sums
  }
}

}  // namespace

// Launches both kernels on `stream` and returns cudaGetLastError() (0 on
// success).  The caller allocates table (T, n2) bfloat16 and cumtot
// (T, n2 / 256) int32 with T = n_tiles_x * n_tiles_y; nothing is
// synchronised here.
extern "C" int bin_table(const int* xlo, const int* xhi, const int* ylo,
                         const int* yhi, void* table, int* cumtot, int n2,
                         int n_tiles_x, int n_tiles_y, int y_offset,
                         void* stream) {
  const int n_tiles = n_tiles_x * n_tiles_y;
  const int n_chunks = n2 / CHUNK;
  if (n_tiles <= 0 || n_chunks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_chunks + WARPS - 1) / WARPS,
                  (n_tiles_y + ROWS - 1) / ROWS);
  bin_table_kernel<<<grid, WARPS * 32, 0, s>>>(
      xlo, xhi, ylo, yhi, static_cast<uint4*>(table), cumtot,
      static_cast<size_t>(n2), n_chunks, n_tiles_x, n_tiles_y, y_offset);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  chunk_cumsum_kernel<<<n_tiles, CHUNK, 0, s>>>(cumtot, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
