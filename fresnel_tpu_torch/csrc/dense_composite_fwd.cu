// Dense compositing forward (K7) for NVIDIA Hopper (sm_90a).
//
// Replaces the chunked lax.scan of fresnel_tpu/render/dense.py::
// render_dense (:68-108: every Gaussian at every pixel, front to back, an
// exclusive cumprod inside each chunk of 256) and of fresnel_tpu/render/
// simplified.py::render_simplified (:52-86: the isotropic boxed splats,
// chunks of 128, and the least depth where alpha > 0.1).  No Pallas kernel
// takes either; the modes, the folded alpha and the exact reach are in
// dense_composite_common.cuh.
//
// Input:  params (N, 8) float32 per Gaussian, front to back;
//         colors (N, 3) float32.
// Output: out    (H * W, 4) float32: colour (before the background) and
//                the depth channel (DENSE sum w depth, SIMPLE the least
//                depth of a hit or +inf);
//         trans  (H * W) float32, the final transmittance;
//         ck     (tiles, ceil(N / SUB), TILE_PIX) float32: each pixel's
//                transmittance at the start of every run of SUB = 16
//                entries of its tile's list (K8 starts each back walk
//                there); 4 * TILE_PIX * tiles * ceil(N / 16) bytes, 64
//                bytes per (16 x 16 pixels, Gaussian): 359 MB at 512^2
//                with N = 5 476, written only for the runs a tile has;
//         aux    int32 (Scratch in the header): the tile boxes (2 N), the
//                lists' lengths (tiles), SIMPLE's tie record (3 H W: the
//                first and last chunk of `chunk` Gaussians whose hits
//                reach the least depth, and how many chunks do, from which
//                K8 splits the depth's gradient as jax.grad does) and the
//                lists (tiles * N, each in index order).
//
// What bounds it.  DENSE on the decoded cloud lists ~4 700 of 5 476
// Gaussians at every 512^2 pixel (1.19e9 pairs): instruction-bound, ~28
// operations a pair (the bound's count, 0.496 ms at float32's peak).  The
// first version spent ~30 instructions a pair on one pixel a thread (the
// op-by-op quadratic form, a full expf, three shared loads) and re-culled
// every tile's Gaussians in 22 stages of 256: 1.708 ms.  This one spends
// ~20 a pair (the folded fmas and ex2, the loads and dx shared by two
// pixels): 0.964 ms, 1.9x the bound (H100 80GB HBM3, 700 W; chip_smoke.py
// --ab).  SIMPLE lists 78-162 Gaussians a tile on average but up to 636
// (512^2) and 1 284 (256^2) on the cloud's densest tiles, and the block
// that walks the longest list bounds the launch: latency, not work (0.109
// / 0.160 ms against a bound of 0.003 / 0.001).  Tiles of 32 x 8 pixels
// took SIMPLE to 0.090 / 0.106 ms but K8 DENSE from 4.6 to 5.1 ms.
//
// Design.  Launch 1, `tile_boxes`: a thread per Gaussian writes the tiles
// its reach meets.  Launch 2, `composite_fwd`, a block of 256 threads per
// 32 x 16 tile: each warp counts the hits of its eighth of the boxes
// (ballots), one barrier, then writes its hits' indices at their offsets,
// so the tile's list is in index order (0.01 ms of the launch).  The list
// is walked STAGE entries at a time: each thread folds one entry into
// shared memory, then every thread runs its two pixels over them (three
// shared float4 loads and the column's dx serve both pixels; the two
// transmittance chains are independent; SIMPLE's tie record is kept with
// selects, not branches, so the unrolled walk overlaps entries), leaving a
// checkpoint every SUB entries.  No atomics: the result repeats bit for
// bit.  Pixels past the image's edge compute and are not written (their
// checkpoints are).

#include "dense_composite_common.cuh"

namespace {

using namespace dcomp;

template <int MODE>
__global__ void tile_boxes(const float* __restrict__ params, int N, int ntx,
                           int nty, short4* __restrict__ boxes) {
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  if (gi >= N) return;
  float g[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) g[k] = params[static_cast<size_t>(gi) * NP + k];
  boxes[gi] = tile_box<MODE>(g, ntx, nty);
}

// The tile's list: the indices, in order, of the Gaussians whose box
// holds tile (tx, ty), into `list`; returns its length.  Each warp takes
// a contiguous eighth of the Gaussians, counts, and after one barrier
// writes from its offset.
__device__ int build_list(const short4* __restrict__ boxes, int N, int tx,
                          int ty, int* __restrict__ list, int* warp_count) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (N + NTHREADS - 1) / NTHREADS * 32;
  const int first = warp * per;
  const int last = min(N, first + per);
  int n = 0;
  for (int i = first + lane; i < first + per; i += 32) {
    const bool hit = i < last && box_holds(boxes[i], tx, ty);
    n += __popc(__ballot_sync(FULL, hit));
  }
  if (lane == 0) warp_count[warp] = n;
  __syncthreads();
  int at = 0, total = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) {
    at += w < warp ? warp_count[w] : 0;
    total += warp_count[w];
  }
  for (int i = first + lane; i < first + per; i += 32) {
    const bool hit = i < last && box_holds(boxes[i], tx, ty);
    const unsigned ballot = __ballot_sync(FULL, hit);
    if (hit) list[at + __popc(ballot & ((1u << lane) - 1u))] = i;
    at += __popc(ballot);
  }
  return total;
}

template <int MODE>
__global__ void __launch_bounds__(NTHREADS, 2)
composite_fwd(const float* __restrict__ params,
              const float* __restrict__ colors, float* __restrict__ out,
              float* __restrict__ trans, float* __restrict__ ck, int* aux,
              int N, int H, int W, int ntx, int chunk) {
  __shared__ float4 s_g0[STAGE];
  __shared__ float4 s_g1[STAGE];
  __shared__ float4 s_col[STAGE];
  __shared__ int warp_count[NWARP];
  const Scratch sc = scratch(aux, N, H, W);
  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  int* list = sc.lists + static_cast<size_t>(tile) * N;
  const int L = build_list(sc.boxes, N, tile % ntx, tile / ntx, list,
                           warp_count);
  if (t == 0) sc.counts[tile] = L;
  const Pixels q = pixels(tile, ntx, H, W);
  float* ck_tile =
      ck + static_cast<size_t>(tile) * ((N + SUB - 1) / SUB) * TILE_PIX;

  float T[PPT], acc[PPT][4], dmin[PPT];
  int c_first[PPT], c_last[PPT], n_chunks[PPT];   // SIMPLE: the hits' chunks
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    T[i] = 1.0f;
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
    dmin[i] = INFINITY;
    c_first[i] = c_last[i] = -1;
    n_chunks[i] = 0;
  }

  for (int s0 = 0; s0 < L; s0 += STAGE) {
    const int n = min(STAGE, L - s0);
    __syncthreads();   // the list is written; the last stage has been read
    if (t < n) fold<MODE>(params, colors, list[s0 + t], chunk, s_g0[t],
                          s_g1[t], s_col[t]);
    __syncthreads();
    for (int j = 0; j < n; j += SUB) {
      float* c = ck_tile + static_cast<size_t>((s0 + j) / SUB) * TILE_PIX;
#pragma unroll
      for (int i = 0; i < PPT; ++i) c[q.slot[i]] = T[i];
      const int kn = min(SUB, n - j);
#pragma unroll 4
      for (int k = 0; k < kn; ++k) {
        const float4 g0 = s_g0[j + k];
        const float4 g1 = s_g1[j + k];
        const float4 col = s_col[j + k];
        float dx, dy[PPT], e[PPT];
        weights<MODE>(g0, g1, q.px, q.py, dx, dy, e);
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const float alpha = alpha_of<MODE>(e[i], g1.y);
          const float w = __fmul_rn(alpha, T[i]);
          acc[i][0] = __fmaf_rn(w, col.x, acc[i][0]);
          acc[i][1] = __fmaf_rn(w, col.y, acc[i][1]);
          acc[i][2] = __fmaf_rn(w, col.z, acc[i][2]);
          if (MODE == DENSE) acc[i][3] = __fmaf_rn(w, g1.z, acc[i][3]);
          T[i] = trans_step(T[i], alpha);
          if (MODE == SIMPLE) {   // the tie record, with no branch
            const int ch = __float_as_int(g1.w);
            const bool hit = alpha > HIT_ALPHA;
            const bool less = hit && g1.z < dmin[i];
            const bool more = hit && !less && g1.z == dmin[i] &&
                              isfinite(dmin[i]) && ch != c_last[i];
            dmin[i] = less ? g1.z : dmin[i];
            c_first[i] = less ? ch : c_first[i];
            c_last[i] = less || more ? ch : c_last[i];
            n_chunks[i] = less ? 1 : n_chunks[i] + more;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    if (!q.valid[i]) continue;
    float* o = out + q.p[i] * 4;
    o[0] = acc[i][0];
    o[1] = acc[i][1];
    o[2] = acc[i][2];
    o[3] = MODE == DENSE ? acc[i][3] : dmin[i];
    trans[q.p[i]] = T[i];
    if (MODE == SIMPLE) {
      int* r = sc.ties + q.p[i] * 3;
      r[0] = c_first[i];
      r[1] = c_last[i];
      r[2] = n_chunks[i];
    }
  }
}

template <int MODE>
int launch(const float* params, const float* colors, float* out,
           float* trans, float* ck, int* aux, int N, int H, int W,
           int chunk, cudaStream_t s) {
  const int ntx = (W + BW - 1) / BW;
  const int nty = (H + BH - 1) / BH;
  if (N > 0) {
    tile_boxes<MODE><<<(N + 255) / 256, 256, 0, s>>>(
        params, N, ntx, nty, scratch(aux, N, H, W).boxes);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  composite_fwd<MODE><<<ntx * nty, NTHREADS, 0, s>>>(
      params, colors, out, trans, ck, aux, N, H, W, ntx, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// mode 0 DENSE, 1 SIMPLE; `chunk` the JAX scan's step (SIMPLE's ties).
// The caller allocates every buffer (ck and aux as the note above sizes
// them); nothing is synchronised here.
extern "C" int dense_composite_fwd(const float* params, const float* colors,
                                   float* out, float* trans, float* ck,
                                   int* aux, int N, int H, int W, int mode,
                                   int chunk, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  if (chunk <= 0 || N < 0 || (W + BW - 1) / BW > 32767 ||
      (H + BH - 1) / BH > 32767)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == DENSE)
    return launch<DENSE>(params, colors, out, trans, ck, aux, N, H, W, chunk,
                         s);
  if (mode == SIMPLE)
    return launch<SIMPLE>(params, colors, out, trans, ck, aux, N, H, W,
                          chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Its residency in `mode` (kernel_residency in the header).
extern "C" int dense_composite_fwd_residency(int mode, int* out) {
  return kernel_residency(
      mode == DENSE ? composite_fwd<DENSE> : composite_fwd<SIMPLE>, out);
}
