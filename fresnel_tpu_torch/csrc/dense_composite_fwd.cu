// Dense compositing forward (K7) for NVIDIA Hopper (sm_90a).
//
// Replaces the chunked lax.scan of fresnel_tpu/render/dense.py::
// render_dense (:68-108: every Gaussian at every pixel, front to back, an
// exclusive cumprod inside each chunk of 256) and of fresnel_tpu/render/
// simplified.py::render_simplified (:52-86: the isotropic boxed splats,
// chunks of 128, and the least depth where alpha > 0.1).  No Pallas kernel
// takes either; the modes are in dense_composite_common.cuh.
//
// Input:  params (N, 8) float32 per Gaussian, front to back;
//         colors (N, 3) float32.
// Output: out    (H * W, 4) float32: colour (before the background) and
//                the depth channel (DENSE sum w depth, SIMPLE the least
//                depth of a hit or +inf);
//         trans  (H * W) float32, the final transmittance;
//         ck     (ceil(N / 256), H * W) float32, each pixel's
//                transmittance at the start of each stage of 256
//                Gaussians (K8 recomputes the rest from these);
//         aux    (H * W, 3) int32, SIMPLE only: the first and last chunk
//                (of `chunk` Gaussians) whose hits reach the least depth
//                and how many chunks do, from which K8 splits the depth's
//                gradient as jax.grad does.
//
// Design (simple and correct first): one block of 256 threads per 16 x 16
// tile, one thread per pixel.  The Gaussians are taken 256 at a time (a
// stage): each thread tests one against the tile's reach and the
// survivors are compacted into shared memory in index order; every thread
// then walks the list, keeping the running transmittance and its sums in
// registers: a sequential product per pixel, as the recurrence is.  No
// atomics: the result repeats bit for bit.  Pixels past the image's edge
// compute and are not written.

#include "dense_composite_common.cuh"

namespace {

using namespace dcomp;

template <int MODE>
__global__ void __launch_bounds__(NTHREADS)
composite_fwd(const float* __restrict__ params,
              const float* __restrict__ colors, float* __restrict__ out,
              float* __restrict__ trans, float* __restrict__ ck,
              int* __restrict__ aux, int N, int H, int W, int n_tiles_x,
              int chunk) {
  __shared__ StageLists sh;
  const int x0 = (blockIdx.x % n_tiles_x) * TS;
  const int y0 = (blockIdx.x / n_tiles_x) * TS;
  const int x = x0 + static_cast<int>(threadIdx.x) % TS;
  const int y = y0 + static_cast<int>(threadIdx.x) / TS;
  const bool valid = x < W && y < H;
  const size_t p = static_cast<size_t>(y) * W + x;
  const size_t HW = static_cast<size_t>(H) * W;
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);

  float T = 1.0f;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dmin = INFINITY;   // SIMPLE: the least depth of a hit
  int c_first = -1, c_last = -1, n_chunks = 0;

  for (int first = 0, s = 0; first < N; first += STAGE, ++s) {
    if (valid) ck[s * HW + p] = T;
    const int listed =
        cull_stage<MODE>(sh, params, colors, first, min(N, first + STAGE),
                         x0, y0);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < listed; ++j) {
      const float4 g0 = sh.g0[j];
      const float4 g1 = sh.g1[j];
      const Pair q = pair_at<MODE>(g0, g1, __fsub_rn(px, g0.x),
                                   __fsub_rn(py, g0.y));
      const float w = q.alpha * T;
      const float4 c = sh.col[j];
      acc[0] += w * c.x;
      acc[1] += w * c.y;
      acc[2] += w * c.z;
      if (MODE == DENSE) acc[3] += w * g1.w;
      T *= 1.0f - q.alpha;
      if (MODE == SIMPLE && q.alpha > HIT_ALPHA) {
        const int ch = sh.idx[j] / chunk;
        if (g1.w < dmin) {
          dmin = g1.w;
          c_first = c_last = ch;
          n_chunks = 1;
        } else if (g1.w == dmin && isfinite(dmin) && ch != c_last) {
          c_last = ch;
          ++n_chunks;
        }
      }
    }
  }
  if (!valid) return;
  float* o = out + p * 4;
  o[0] = acc[0];
  o[1] = acc[1];
  o[2] = acc[2];
  o[3] = MODE == DENSE ? acc[3] : dmin;
  trans[p] = T;
  if (MODE == SIMPLE) {
    aux[p * 3 + 0] = c_first;
    aux[p * 3 + 1] = c_last;
    aux[p * 3 + 2] = n_chunks;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// mode 0 DENSE, 1 SIMPLE; `chunk` the JAX scan's step (SIMPLE's ties).
// The caller allocates every buffer; nothing is synchronised here.
extern "C" int dense_composite_fwd(const float* params, const float* colors,
                                   float* out, float* trans, float* ck,
                                   int* aux, int N, int H, int W, int mode,
                                   int chunk, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int ntx = (W + TS - 1) / TS;
  const int nty = (H + TS - 1) / TS;
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == DENSE)
    composite_fwd<DENSE><<<ntx * nty, NTHREADS, 0, s>>>(
        params, colors, out, trans, ck, aux, N, H, W, ntx, chunk);
  else if (mode == SIMPLE)
    composite_fwd<SIMPLE><<<ntx * nty, NTHREADS, 0, s>>>(
        params, colors, out, trans, ck, aux, N, H, W, ntx, chunk);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
