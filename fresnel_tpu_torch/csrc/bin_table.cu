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
// unit is its cheapest prefix sum.  Here the count comes from warp votes:
//   * a block of 256 threads owns one chunk: each thread keeps one
//     Gaussian's four bounds in registers and walks TILES_PER_BLOCK tiles;
//   * per tile, __ballot_sync gives the warp's hit mask, the popcount of the
//     lanes up to one's own the rank within the warp;
//   * the 8 warp totals of a tile are bytes of one 64-bit word in shared
//     memory; one multiply by 0x0101010101010100 turns it into the 8
//     exclusive warp offsets (each < 256, so no byte carries);
//   * tiles go BATCH at a time, so the block meets at two barriers per
//     BATCH tiles and not per tile;
//   * the count is stored along the Gaussian axis: a warp writes 64
//     contiguous bytes, the block 512 bytes of the tile's row.  The last
//     thread's count is the chunk's total.
// A second small kernel turns the chunk totals of each tile into their
// inclusive running sum in place (one block per tile).
//
// What bounds it on this card: the table is written once, T * n2 * 2 bytes
// (2 GB at a million Gaussians and 1024 tiles), against five integer
// operations per entry: memory.  Offsets into the table are 64-bit.

#include <cstddef>
#include <cstdint>

namespace {

constexpr int CHUNK = 256;
constexpr int TILES_PER_BLOCK = 64;
constexpr int BATCH = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long PREFIX = 0x0101010101010100ull;

__device__ __forceinline__ uint16_t bf16_bits(int count) {
  // Integers up to 256 have at most 8 significant bits: the upper half of
  // the float32 pattern is the exact bfloat16.
  return static_cast<uint16_t>(__float_as_uint(static_cast<float>(count)) >> 16);
}

__global__ void __launch_bounds__(CHUNK)
bin_table_kernel(const int* __restrict__ xlo, const int* __restrict__ xhi,
                 const int* __restrict__ ylo, const int* __restrict__ yhi,
                 uint16_t* __restrict__ table, int* __restrict__ totals,
                 size_t n2, int n_chunks, int n_tiles_x, int n_tiles,
                 int y_offset) {
  __shared__ unsigned long long warp_counts[BATCH];
  unsigned char* wc = reinterpret_cast<unsigned char*>(warp_counts);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunk = blockIdx.x;
  const size_t j = static_cast<size_t>(chunk) * CHUNK + tid;
  const int lo_x = xlo[j], hi_x = xhi[j], lo_y = ylo[j], hi_y = yhi[j];
  const unsigned le_mask = FULL >> (31 - lane);

  const int t_begin = blockIdx.y * TILES_PER_BLOCK;
  const int t_end = min(t_begin + TILES_PER_BLOCK, n_tiles);

  for (int t0 = t_begin; t0 < t_end; t0 += BATCH) {
    const int nb = min(BATCH, t_end - t0);
    int rank[BATCH];
    int tx = t0 % n_tiles_x;
    int ty = t0 / n_tiles_x + y_offset;
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const bool hit = tx >= lo_x && tx <= hi_x && ty >= lo_y && ty <= hi_y;
      const unsigned mask = __ballot_sync(FULL, hit);
      rank[b] = __popc(mask & le_mask);
      if (lane == 0) wc[b * 8 + warp] = static_cast<unsigned char>(__popc(mask));
      if (++tx == n_tiles_x) {
        tx = 0;
        ++ty;
      }
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      if (b < nb) {
        const unsigned long long excl = warp_counts[b] * PREFIX;
        const int count =
            static_cast<int>((excl >> (8 * warp)) & 0xffull) + rank[b];
        const size_t t = static_cast<size_t>(t0 + b);
        table[t * n2 + j] = bf16_bits(count);
        if (tid == CHUNK - 1) totals[t * n_chunks + chunk] = count;
      }
    }
    __syncthreads();  // the next batch overwrites warp_counts
  }
}

// In place: totals[t, c] <- sum of totals[t, 0..c].  One block per tile;
// each thread sums a contiguous run of chunks, the runs are prefixed by a
// warp-shuffle scan and the 8 warp sums through shared memory.
__global__ void __launch_bounds__(CHUNK)
chunk_cumsum_kernel(int* __restrict__ totals, int n_chunks) {
  __shared__ int warp_sums[CHUNK / 32];
  int* row = totals + static_cast<size_t>(blockIdx.x) * n_chunks;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = (n_chunks + CHUNK - 1) / CHUNK;
  const int begin = min(tid * per, n_chunks);
  const int end = min(begin + per, n_chunks);

  int sum = 0;
  for (int k = begin; k < end; ++k) sum += row[k];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int running = incl - sum;
  for (int w = 0; w < warp; ++w) running += warp_sums[w];
  for (int k = begin; k < end; ++k) {
    running += row[k];
    row[k] = running;
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
  const dim3 grid(n_chunks, (n_tiles + TILES_PER_BLOCK - 1) / TILES_PER_BLOCK);
  bin_table_kernel<<<grid, CHUNK, 0, s>>>(
      xlo, xhi, ylo, yhi, static_cast<uint16_t*>(table), cumtot,
      static_cast<size_t>(n2), n_chunks, n_tiles_x, n_tiles, y_offset);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  chunk_cumsum_kernel<<<n_tiles, CHUNK, 0, s>>>(cumtot, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
