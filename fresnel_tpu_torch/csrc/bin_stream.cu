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
//         tile-index intervals in depth order (clamped to the grid by the
//         caller; tiles outside the grid are never counted); an empty
//         interval (hi < lo) marks an invisible entry.
// Output: out    (T, M) int32: out[t, r] = stream index of tile t's r-th
//                hit, 0 in slots past the tile's count;
//         valid  (T, M) bool (one byte each): r < count;
//         counts (T,) int32: min(hits of tile t, M).
// Scratch (the caller's, `scratch_ints` of them): pair records
//         (T * min(C, M), 4) int32, chunk counts and prefixes (C, T) int32
//         each, stop (T,) int32 and n_pairs (1,), C = ceil(n / chunk).
//
// The Pallas body walks the stream in order, one grid step per 256
// Gaussians, carrying each tile's count in scratch from step to step: the
// TPU's grid is sequential.  A port that gives each tile one block walking
// the stream in order is one serial chain per tile, and the tiles that
// never fill walk the whole stream: ~0.4 us per slab of 256 x 3 907 slabs
// at a million Gaussians, 1.5 ms, on 119 SMs.  The work itself is small
// (the tests up to each tile's M-th hit, ~1.9e8, ~14 us at the card's
// rate); the chain's latency is what bounds it.  So here no walk is longer
// than one chunk of the stream, and the chunks run in parallel:
//   (a) count: one block per chunk of `chunk` Gaussians (and per window of
//       WINDOW tiles): each thread walks its Gaussian's clamped interval
//       and adds into per-tile counters in shared memory; integer adds
//       commute, so chunk_counts (C, T) is the same in every run;
//   (b) scan: one warp per tile takes the exclusive prefix of its counts
//       over the chunks, 32 chunks per step (a shuffle scan, four steps'
//       loads in flight), and stops once the tile holds M.  It writes
//       counts[t] = min(total, M), valid, and 0 in the dead slots, which
//       no pair writes;
//   (b') compact: one block per chunk lists its *open* (chunk, tile)
//       pairs, those with hits and a prefix below M, as records {chunk,
//       tile, base, min(hits, M - base)}; one atomic per chunk places its
//       records (the chunks' order in the list varies from run to run, the
//       tables do not), so a chunk's pairs are neighbours;
//   (c) place: a persistent grid of warps takes the records in turn, a
//       block's warps neighbouring records, so they mostly walk one chunk
//       and share its reads in L1; a warp walks its chunk 32 Gaussians a
//       vote (__ballot_sync and a popcount of the lower lanes give the
//       rank, eight votes' loads in flight), writes out[t, base + rank]
//       and stops when it has placed the pair's hits.
// Every slot has exactly one writer and no atomic decides an order, so
// the tables repeat bit for bit and equal the plain version's.
//
// What bounds it on this card: the inputs read once and the tables
// written (14 MB at a million Gaussians, T 1024, M 256: ~4 us) against a
// count per Gaussian and per kept hit: bytes.  What it does beyond that:
// the tests of the open chunks up to each tile's M-th hit, spread over
// the whole card, and four launches.  The walks read the intervals of
// their chunks up to the last hit they need; at a million Gaussians (T
// 1024, M 256) that is 4.7e7 intervals over 66 268 open pairs with chunks
// of 1 024, and 7.5e7 over 23 579 with chunks of 4 096, which skip less
// empty stream (on an H100 those reads ran at ~9 TB/s from L2 while each
// warp read its own; the chunk-major list lets L1 serve the reads that a
// block's warps share).

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WINDOW = 8192;        // tiles a count block holds (32 KB)
constexpr int PLACE_BLOCKS = 1024;  // at most; their warps stride the records
constexpr int AHEAD = 8;            // votes a place warp loads at once
constexpr int SCAN_AHEAD = 4;       // 32-chunk steps a scan warp loads at once
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

// (a) chunk_counts[c, t] = hits of tile t among the Gaussians of chunk c.
__global__ void __launch_bounds__(THREADS)
count_kernel(const int4* __restrict__ iv, int* __restrict__ chunk_counts,
             int* __restrict__ n_pairs, int n, int chunk, int n_tiles,
             int n_tiles_x, int n_tiles_y) {
  __shared__ int cnt[WINDOW];
  const int c = blockIdx.x;
  const int t0 = blockIdx.y * WINDOW;
  const int width = min(WINDOW, n_tiles - t0);
  if (c == 0 && blockIdx.y == 0 && threadIdx.x == 0) *n_pairs = 0;
  for (int k = threadIdx.x; k < width; k += THREADS) cnt[k] = 0;
  __syncthreads();

  const int row_first = t0 / n_tiles_x;
  const int row_last = min((t0 + width - 1) / n_tiles_x, n_tiles_y - 1);
  const long long begin = static_cast<long long>(c) * chunk;
  const int end = static_cast<int>(min(begin + chunk,
                                       static_cast<long long>(n)));
  for (int j = static_cast<int>(begin) + threadIdx.x; j < end;
       j += THREADS) {
    const int4 b = iv[j];
    const int x_lo = max(b.x, 0), x_hi = min(b.y, n_tiles_x - 1);
    const int y_lo = max(b.z, row_first), y_hi = min(b.w, row_last);
    for (int ty = y_lo; ty <= y_hi; ++ty) {
      for (int tx = x_lo; tx <= x_hi; ++tx) {
        const int k = ty * n_tiles_x + tx - t0;
        if (k >= 0 && k < width) atomicAdd(&cnt[k], 1);
      }
    }
  }
  __syncthreads();
  int* dst = chunk_counts + static_cast<size_t>(c) * n_tiles + t0;
  for (int k = threadIdx.x; k < width; k += THREADS) dst[k] = cnt[k];
}

// (b) One warp per tile: the exclusive prefix of its chunk counts, 32
// chunks a step and SCAN_AHEAD steps' loads at once, until the tile holds
// M; then counts, valid and the dead slots.  stop[t] is the number of
// chunks whose prefix it wrote.
__global__ void __launch_bounds__(THREADS)
scan_kernel(const int* __restrict__ chunk_counts, int* __restrict__ bases,
            int* __restrict__ stop, int* __restrict__ out,
            unsigned char* __restrict__ valid, int* __restrict__ counts,
            int n_chunks, int n_tiles, int max_per_tile) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= n_tiles) return;  // the whole warp
  const int M = max_per_tile;

  int run = 0, scanned = 0;
  for (int c0 = 0; c0 < n_chunks && run < M; c0 += 32 * SCAN_AHEAD) {
    int k[SCAN_AHEAD];
#pragma unroll
    for (int u = 0; u < SCAN_AHEAD; ++u) {
      const int c = c0 + u * 32 + lane;
      k[u] = c < n_chunks
          ? chunk_counts[static_cast<size_t>(c) * n_tiles + t] : 0;
    }
#pragma unroll
    for (int u = 0; u < SCAN_AHEAD; ++u) {
      const int c = c0 + u * 32 + lane;
      if (run >= M || c0 + u * 32 >= n_chunks) break;  // the whole warp
      const int incl = warp_inclusive_scan(k[u], lane);
      if (c < n_chunks)
        bases[static_cast<size_t>(c) * n_tiles + t] = run + incl - k[u];
      run += __shfl_sync(FULL, incl, 31);
      scanned = min(c0 + (u + 1) * 32, n_chunks);
    }
  }
  const int count = min(run, M);
  int* row = out + static_cast<size_t>(t) * M;
  unsigned char* vrow = valid + static_cast<size_t>(t) * M;
  for (int m = lane; m < M; m += 32) {
    if (m >= count) row[m] = 0;
    vrow[m] = m < count ? 1 : 0;
  }
  if (lane == 0) {
    counts[t] = count;
    stop[t] = scanned;
  }
}

// (b') One block per chunk: its open (chunk, tile) pairs in tile order,
// placed in the list by one atomic per chunk, so that a chunk's pairs are
// neighbours in the list and the place warps of one block read one chunk.
__global__ void __launch_bounds__(THREADS)
compact_kernel(const int* __restrict__ chunk_counts,
               const int* __restrict__ bases, const int* __restrict__ stop,
               int4* __restrict__ pairs, int* __restrict__ n_pairs,
               int n_tiles, int max_per_tile) {
  __shared__ int warp_open[WARPS];
  __shared__ int at;
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int* k_row = chunk_counts + static_cast<size_t>(c) * n_tiles;
  const int* b_row = bases + static_cast<size_t>(c) * n_tiles;

  int total = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += THREADS) {
    const int t = t0 + threadIdx.x;
    total += __syncthreads_count(t < n_tiles && c < stop[t] && k_row[t] > 0
                                 && b_row[t] < max_per_tile);
  }
  if (total == 0) return;  // the whole block
  if (threadIdx.x == 0) at = atomicAdd(n_pairs, total);
  __syncthreads();
  int base_at = at;
  for (int t0 = 0; t0 < n_tiles; t0 += THREADS) {
    const int t = t0 + threadIdx.x;
    int k = 0, b = 0;
    bool open = false;
    if (t < n_tiles && c < stop[t]) {
      k = k_row[t];
      b = b_row[t];
      open = k > 0 && b < max_per_tile;
    }
    const unsigned mask = __ballot_sync(FULL, open);
    if (lane == 0) warp_open[warp] = __popc(mask);
    __syncthreads();
    int pos = base_at + __popc(mask & lt_mask);
    int seg = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) pos += warp_open[w];
      seg += warp_open[w];
    }
    if (open) pairs[pos] = make_int4(c, t, b, min(k, max_per_tile - b));
    base_at += seg;
    __syncthreads();  // the next round overwrites warp_open
  }
}

// (c) A persistent grid of warps over the open pairs.
__global__ void __launch_bounds__(THREADS)
place_kernel(const int4* __restrict__ iv, const int4* __restrict__ pairs,
             const int* __restrict__ n_pairs, int* __restrict__ out, int n,
             int chunk, int n_tiles_x, int max_per_tile) {
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int total = *n_pairs;
  const int stride = gridDim.x * WARPS;
  for (int p = blockIdx.x * WARPS + (threadIdx.x >> 5); p < total;
       p += stride) {
    const int4 pr = pairs[p];  // {chunk, tile, base, hits to place}
    const int tx = pr.y % n_tiles_x;
    const int ty = pr.y / n_tiles_x;
    int* row = out + static_cast<size_t>(pr.y) * max_per_tile + pr.z;
    const int need = pr.w;
    const long long begin = static_cast<long long>(pr.x) * chunk;
    const int end = static_cast<int>(min(begin + chunk,
                                         static_cast<long long>(n)));
    int found = 0;
    for (int j = static_cast<int>(begin); found < need && j < end;
         j += 32 * AHEAD) {
      int4 b[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int jj = j + u * 32 + lane;
        b[u] = jj < end ? iv[jj] : make_int4(1, 0, 1, 0);  // empty
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const bool hit = tx >= b[u].x && tx <= b[u].y && ty >= b[u].z
                         && ty <= b[u].w;
        const unsigned mask = __ballot_sync(FULL, hit);
        const int r = found + __popc(mask & lt_mask);
        if (hit && r < need) row[r] = j + u * 32 + lane;
        found += __popc(mask);
      }
    }
  }
}

// Scratch ints the entry point needs: the pair records (16-byte aligned at
// the start), chunk counts and prefixes (C, T) each, stop (T,), n_pairs.
long long scratch_ints(int n_chunks, int n_tiles, int max_per_tile) {
  const long long capacity = static_cast<long long>(n_tiles)
                             * min(n_chunks, max_per_tile);
  return 4 * capacity + 2LL * n_chunks * n_tiles + n_tiles + 1;
}

}  // namespace

// Launches the four kernels on `stream` and returns cudaGetLastError() (0
// on success; cudaErrorInvalidValue for a chunk length below 1 or scratch
// smaller than the plan above).  The caller allocates out (T, M) int32,
// valid (T, M) bool, counts (T,) int32 and `scratch` of `n_scratch`
// int32; nothing is synchronised here.
extern "C" int bin_stream(const void* iv, int* out, void* valid, int* counts,
                          int* scratch, int n, int n_tiles, int max_per_tile,
                          int n_tiles_x, int chunk, int n_scratch,
                          void* stream) {
  if (n_tiles <= 0 || max_per_tile <= 0) return 0;
  if (chunk <= 0 || n_tiles_x <= 0) return 1;  // cudaErrorInvalidValue
  const int n_chunks = n > 0 ? (n - 1) / chunk + 1 : 0;
  if (n_scratch < scratch_ints(n_chunks, n_tiles, max_per_tile)) return 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles_y = n_tiles / n_tiles_x;
  const long long capacity = static_cast<long long>(n_tiles)
                             * min(n_chunks, max_per_tile);
  int4* pairs = reinterpret_cast<int4*>(scratch);
  int* chunk_counts = scratch + 4 * capacity;
  int* bases = chunk_counts + static_cast<size_t>(n_chunks) * n_tiles;
  int* stop = bases + static_cast<size_t>(n_chunks) * n_tiles;
  int* n_pairs = stop + n_tiles;
  const int4* ivs = static_cast<const int4*>(iv);
  int err;
  if (n_chunks > 0) {
    const dim3 grid(n_chunks, (n_tiles + WINDOW - 1) / WINDOW);
    count_kernel<<<grid, THREADS, 0, s>>>(ivs, chunk_counts, n_pairs, n,
                                          chunk, n_tiles, n_tiles_x,
                                          n_tiles_y);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  }
  scan_kernel<<<(n_tiles + WARPS - 1) / WARPS, THREADS, 0, s>>>(
      chunk_counts, bases, stop, out, static_cast<unsigned char*>(valid),
      counts, n_chunks, n_tiles, max_per_tile);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  if (n_chunks == 0) return 0;
  compact_kernel<<<n_chunks, THREADS, 0, s>>>(chunk_counts, bases, stop,
                                              pairs, n_pairs, n_tiles,
                                              max_per_tile);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  const int blocks = static_cast<int>(
      min(static_cast<long long>(PLACE_BLOCKS),
          (capacity + WARPS - 1) / WARPS));
  place_kernel<<<blocks, THREADS, 0, s>>>(ivs, pairs, n_pairs, out, n, chunk,
                                          n_tiles_x, max_per_tile);
  return static_cast<int>(cudaGetLastError());
}
