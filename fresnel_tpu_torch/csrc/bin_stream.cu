// Streaming per-tile compaction for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel
// fresnel_tpu/render/pallas_stream_binning.py::_stream_kernel (launched by
// bin_gaussians_stream): one pass over the depth-sorted Gaussian stream
// that gives every tile the stream indices of its first M hitting
// Gaussians, in order, and stops a tile as soon as it is full.  No rank
// table and no search.
//
// Input:  iv (n, 4) int32, per Gaussian [xlo, xhi, ylo, yhi]: inclusive
//         tile-index intervals clamped to the grid, in depth order; an empty
//         interval (xhi < xlo) marks an invisible entry.
// Output: out    (T, M) int32: out[t, r] = stream index of tile t's r-th
//                hit, 0 in slots past the tile's count;
//         valid  (T, M) bool (one byte each): r < count;
//         counts (T,) int32: min(hits of tile t, M).
//
// The Pallas body ranks 256 Gaussians at a time with a matrix product
// against a triangular ones matrix and places ranks with lane reductions,
// rotations and 128-aligned segment stores: devices of the TPU's vector
// unit.  Here the ranks come from warp votes:
//   * one block of 256 threads per tile walks the stream in slabs of 256;
//     a thread loads one Gaussian's interval as one 16-byte word and tests
//     it against the tile;
//   * __ballot_sync and a popcount of the lower lanes give the rank within
//     the warp; the 8 warp totals are bytes of one 64-bit word in shared
//     memory, and one multiply turns it into the 8 exclusive warp offsets;
//     the word is double-buffered, so a slab costs one barrier;
//   * a hit with base + rank < M stores its stream index at
//     out[t, base + rank]; the order of the stream is kept, every slot has
//     one writer, and there are no atomics, so the result repeats bit for
//     bit;
//   * the block leaves the loop once base >= M (the capacity early exit)
//     or the stream ends, then zeroes the dead slots and writes validity.
//
// What bounds it on this card: a tile reads the stream up to the position
// of its M-th hit (the whole stream if it never fills), 16 bytes and five
// integer operations per Gaussian; the stream itself (16 bytes x n) fits
// the L2 cache, so device memory sees it about once and the interval tests
// are the work: operations.

#include <cstddef>

namespace {

constexpr int SLAB = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long PREFIX = 0x0101010101010100ull;

__global__ void __launch_bounds__(SLAB)
bin_stream_kernel(const int4* __restrict__ iv, int* __restrict__ out,
                  unsigned char* __restrict__ valid, int* __restrict__ counts,
                  int n, int max_per_tile, int n_tiles_x) {
  __shared__ unsigned long long warp_counts[2];
  unsigned char* wc = reinterpret_cast<unsigned char*>(warp_counts);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int tx = tile % n_tiles_x;
  const int ty = tile / n_tiles_x;
  const unsigned lt_mask = (1u << lane) - 1u;
  int* row = out + static_cast<size_t>(tile) * max_per_tile;

  int base = 0;   // hits of this tile before the slab; the same in every thread
  int buf = 0;
  for (int s = 0; s < n && base < max_per_tile; s += SLAB, buf ^= 1) {
    const int j = s + tid;
    bool hit = false;
    if (j < n) {
      const int4 b = iv[j];
      hit = tx >= b.x && tx <= b.y && ty >= b.z && ty <= b.w;
    }
    const unsigned mask = __ballot_sync(FULL, hit);
    if (lane == 0) wc[buf * 8 + warp] = static_cast<unsigned char>(__popc(mask));
    // One barrier per slab: slab i + 2 reuses this buffer, and a thread
    // only gets there through the barrier of slab i + 1, which every
    // thread reaches after it has read this one.
    __syncthreads();
    const unsigned long long v = warp_counts[buf];
    const unsigned long long excl = v * PREFIX;
    const int slot = base + static_cast<int>((excl >> (8 * warp)) & 0xffull)
                     + __popc(mask & lt_mask);
    if (hit && slot < max_per_tile) row[slot] = j;
    base += static_cast<int>(excl >> 56) + static_cast<int>(v >> 56);
  }

  const int count = min(base, max_per_tile);
  unsigned char* vrow = valid + static_cast<size_t>(tile) * max_per_tile;
  for (int m = tid; m < max_per_tile; m += SLAB) {
    if (m >= count) row[m] = 0;
    vrow[m] = m < count ? 1 : 0;
  }
  if (tid == 0) counts[tile] = count;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller allocates out (T, M) int32, valid (T, M) bool and counts (T,)
// int32; nothing is synchronised here.
extern "C" int bin_stream(const void* iv, int* out, void* valid, int* counts,
                          int n, int n_tiles, int max_per_tile, int n_tiles_x,
                          void* stream) {
  if (n_tiles <= 0 || max_per_tile <= 0) return 0;
  bin_stream_kernel<<<n_tiles, SLAB, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(iv), out, static_cast<unsigned char*>(valid),
      counts, n, max_per_tile, n_tiles_x);
  return static_cast<int>(cudaGetLastError());
}
