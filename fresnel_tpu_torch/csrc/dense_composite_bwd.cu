// Dense compositing backward (K8) for NVIDIA Hopper (sm_90a): the
// reverse-mode derivative of K7 (dense_composite_fwd.cu), which replaces
// what jax.grad makes of the scans of fresnel_tpu/render/dense.py (:68-108)
// and fresnel_tpu/render/simplified.py (:52-86).
//
// Input:  params (N, 8), colors (N, 3) as K7 took them; K7's out
//         (H * W, 4), ck (stages, H * W) and aux (H * W, 3); the
//         cotangents g_out (H * W, 4) and g_trans (H * W).
// Output: g_params (N, 8), g_colors (N, 3), zeroed by the caller and
//         accumulated here (the radius column and the mode's unused
//         columns stay 0).
//
// The gradient, with no division.  For pixel p, let g be the cotangent of
// the colour (and DENSE's depth sum) and v_i Gaussian i's colour (and
// depth).  With Q_i the cotangent of T_{i+1} (the transmittance after i),
//   Q_{N-1} = g_trans,   Q_{i-1} = alpha_i g.v_i + (1 - alpha_i) Q_i,
//   dL/dalpha_i = T_i (g.v_i - Q_i),   dL/dv_i = alpha_i T_i g,
// and the chain through the clip (ties split evenly, as jax.grad splits
// jnp.clip's) to the opacity and the weight's parameters.  A walk back to
// front carries Q; T_i comes forward from K7's checkpoint at the start of
// each stage, recomputed with K7's own bits.  SIMPLE's alpha reaches 1
// and T then 0 exactly, where recovering T_i by dividing T_{i+1} by 1 -
// alpha_i (or T underflowing to 0 over many Gaussians) would lose it; no
// quantity here is divided out.
//
// SIMPLE's depth channel is a minimum: its cotangent goes to the hits
// (alpha > 0.1) whose depth equals it.  The JAX scan takes jnp.min over
// each chunk (ties in it share evenly) and jnp.minimum with the running
// minimum (a tie shares in halves), so with the least depth reached in m
// chunks, the j-th of them (in order) gets 2^-(m - j + 1) of it, the first
// 2^-(m - 1), each shared by its chunk's k ties.  K7 leaves the first and
// last such chunk and m; a pass over those chunks counts k and then
// deals the shares.
//
// Design (simple and correct first): one block of 256 threads per 16 x 16
// tile, one thread per pixel, the stages of 256 Gaussians taken last to
// first, each culled and compacted as K7 does.  Within a stage, a forward
// pass from the checkpoint leaves the transmittance at every SUB-th listed
// Gaussian in shared memory; then each run of SUB, last first, recomputes
// its SUB transmittances into registers and walks them back.  Each listed
// Gaussian's 10 terms are summed over a warp by a reduce-scatter of
// shuffles (each lane ends with one term), over the 8 warps in shared
// memory, and added to its gradient with one atomicAdd per field and
// tile: the sums' order across tiles varies from run to run, so the
// result does not repeat bit for bit.

#include "dense_composite_common.cuh"

namespace {

using namespace dcomp;

constexpr int SUB = 16;                  // listed Gaussians per back walk
constexpr int NSUB = STAGE / SUB;
constexpr int NV = 10;                   // gradient terms per Gaussian

// Term f of a Gaussian goes to g_params column PARAM_OF[f] or, past 7, to
// g_colors column f - 7.
__device__ __constant__ int PARAM_OF[7] = {MX, MY, CA, CB, CC, OPACITY,
                                           DEPTH};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The warp's sums of the NV = 10 terms v, reduce-scattered: each step
// halves the terms a lane carries (padding an odd count with 0), so 12
// shuffles do what 10 butterflies (50) would.  Returns the sum this lane
// ends with and sets `term` to its index, or -1 for a lane that ends
// with padding or with a copy its neighbour (lane ^ 1) writes.  The order
// of the additions is fixed: the sums repeat bit for bit.
__device__ __forceinline__ float reduce_scatter(const float (&v)[NV],
                                                int lane, int& term) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float a[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float send = b4 ? v[i] : v[i + 5];
    a[i] = (b4 ? v[i + 5] : v[i]) + __shfl_xor_sync(FULL, send, 16);
  }
  float b[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float hi = i + 3 < 5 ? a[i + 3] : 0.0f;
    b[i] = (b3 ? hi : a[i]) + __shfl_xor_sync(FULL, b3 ? a[i] : hi, 8);
  }
  float c[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float hi = i + 2 < 3 ? b[i + 2] : 0.0f;
    c[i] = (b2 ? hi : b[i]) + __shfl_xor_sync(FULL, b2 ? b[i] : hi, 4);
  }
  float d = (b1 ? c[1] : c[0]) + __shfl_xor_sync(FULL, b1 ? c[0] : c[1], 2);
  d += __shfl_xor_sync(FULL, d, 1);
  const int i = (b3 ? 3 : 0) + (b2 ? 2 : 0) + (b1 ? 1 : 0);
  term = (lane & 1) || (b2 && b1) || i >= 5 ? -1 : (b4 ? 5 : 0) + i;
  return d;
}

// The term reduce_scatter leaves lane `lane` (or -1), without the sums.
__device__ __forceinline__ void reduce_scatter_terms(int lane, int& term) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  const int i = (b3 ? 3 : 0) + (b2 ? 2 : 0) + (b1 ? 1 : 0);
  term = (lane & 1) || (b2 && b1) || i >= 5 ? -1 : (b4 ? 5 : 0) + i;
}

struct BwdShared {
  StageLists lists;
  float tstart[NSUB][NTHREADS];
  float red[NWARP][SUB][NV];
  int range[2];
};

// Adds red's sums over the warps for listed Gaussians [base, base + SUB)
// to the gradients.  Called by the whole block between two barriers.
__device__ void flush(BwdShared& sh, int base, int listed,
                      float* __restrict__ g_params,
                      float* __restrict__ g_colors) {
  for (int i = threadIdx.x; i < SUB * NV; i += NTHREADS) {
    const int k = i / NV;
    const int f = i % NV;
    if (base + k >= listed) continue;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) s += sh.red[w][k][f];
    if (s == 0.0f) continue;
    const size_t gi = static_cast<size_t>(sh.lists.idx[base + k]);
    if (f < 7)
      atomicAdd(g_params + gi * NP + PARAM_OF[f], s);
    else
      atomicAdd(g_colors + gi * 3 + (f - 7), s);
  }
}

template <int MODE>
__global__ void __launch_bounds__(NTHREADS)
composite_bwd(const float* __restrict__ params,
              const float* __restrict__ colors,
              const float* __restrict__ out, const float* __restrict__ ck,
              const int* __restrict__ aux, const float* __restrict__ g_out,
              const float* __restrict__ g_trans, float* __restrict__ g_params,
              float* __restrict__ g_colors, int N, int H, int W,
              int n_tiles_x, int chunk) {
  __shared__ BwdShared sh;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int x0 = (blockIdx.x % n_tiles_x) * TS;
  const int y0 = (blockIdx.x / n_tiles_x) * TS;
  const int x = x0 + t % TS;
  const int y = y0 + t / TS;
  const bool valid = x < W && y < H;
  const size_t p = static_cast<size_t>(y) * W + x;
  const size_t HW = static_cast<size_t>(H) * W;
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  const float amax = alpha_max<MODE>();

  // Pixels past the edge carry zero cotangents and add nothing.
  float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float Q = 0.0f;
  if (valid) {
#pragma unroll
    for (int c = 0; c < 4; ++c) g[c] = g_out[p * 4 + c];
    Q = g_trans[p];
  }
  const float gD = MODE == DENSE ? g[3] : 0.0f;

  const int n_stages = (N + STAGE - 1) / STAGE;
  for (int s = n_stages - 1; s >= 0; --s) {
    const int first = s * STAGE;
    const int listed = cull_stage<MODE>(sh.lists, params, colors, first,
                                        min(N, first + STAGE), x0, y0);
    __syncthreads();
    if (listed == 0) continue;   // uniform over the block
    // The transmittance at every SUB-th listed Gaussian of the stage.
    float tr = valid ? ck[s * HW + p] : 0.0f;
    for (int j = 0; j < listed; ++j) {
      if (j % SUB == 0) sh.tstart[j / SUB][t] = tr;
      const float4 g0 = sh.lists.g0[j];
      const Pair q = pair_at<MODE>(g0, sh.lists.g1[j], __fsub_rn(px, g0.x),
                                   __fsub_rn(py, g0.y));
      tr *= 1.0f - q.alpha;
    }
    for (int base = ((listed - 1) / SUB) * SUB; base >= 0; base -= SUB) {
      // The run's transmittances and weights, kept for the walk back.
      float Tk[SUB], Ek[SUB];
      float tk = sh.tstart[base / SUB][t];
#pragma unroll
      for (int k = 0; k < SUB; ++k) {
        Tk[k] = tk;
        Ek[k] = 0.0f;
        if (base + k < listed) {
          const float4 g0 = sh.lists.g0[base + k];
          const Pair q = pair_at<MODE>(g0, sh.lists.g1[base + k],
                                       __fsub_rn(px, g0.x),
                                       __fsub_rn(py, g0.y));
          Ek[k] = q.e;
          tk *= 1.0f - q.alpha;
        }
      }
#pragma unroll
      for (int k = SUB - 1; k >= 0; --k) {
        const int j = base + k;
        if (j >= listed) continue;   // uniform over the block
        const float4 g0 = sh.lists.g0[j];
        const float4 g1 = sh.lists.g1[j];
        const float4 c = sh.lists.col[j];
        const float dx = __fsub_rn(px, g0.x);
        const float dy = __fsub_rn(py, g0.y);
        Pair q;                                    // pair_at's, from Ek
        q.e = Ek[k];
        q.raw = __fmul_rn(q.e, g1.z);
        q.alpha = jclip(q.raw, 0.0f, amax);
        const float gv = g[0] * c.x + g[1] * c.y + g[2] * c.z + gD * g1.w;
        const float dalpha = Tk[k] * (gv - Q);
        Q = q.alpha * gv + (1.0f - q.alpha) * Q;
        const float wgt = q.alpha * Tk[k];
        const float draw = dalpha * jclip_grad(q.raw, 0.0f, amax);
        float v[NV];
        v[5] = draw * q.e;                         // opacity
        const float de = draw * g1.z;              // d weight
        if (MODE == DENSE) {
          const float dm = -0.5f * de * q.e;
          v[0] = -dm * (2.0f * g0.z * dx + 2.0f * g0.w * dy);
          v[1] = -dm * (2.0f * g0.w * dx + 2.0f * g1.x * dy);
          v[2] = dm * dx * dx;
          v[3] = dm * 2.0f * dx * dy;
          v[4] = dm * dy * dy;
          v[6] = wgt * gD;
        } else {
          const float den = 2.0f * g0.z * g0.z;
          const float k2 = de * q.e * 2.0f / den;  // d exponent, times 2/den
          v[0] = k2 * dx;
          v[1] = k2 * dy;
          v[2] = k2 * (dx * dx + dy * dy) * 2.0f * g0.z / den;
          v[3] = v[4] = v[6] = 0.0f;
        }
        v[7] = wgt * g[0];
        v[8] = wgt * g[1];
        v[9] = wgt * g[2];
        bool any = false;
#pragma unroll
        for (int f = 0; f < NV; ++f) any |= v[f] != 0.0f;
        int term = -1;
        float sum = 0.0f;
        if (__any_sync(FULL, any))
          sum = reduce_scatter(v, lane, term);
        else
          reduce_scatter_terms(lane, term);
        if (term >= 0) sh.red[warp][k][term] = sum;
      }
      __syncthreads();
      flush(sh, base, listed, g_params, g_colors);
      __syncthreads();
    }
  }

  if (MODE != SIMPLE) return;

  // SIMPLE's depth: the cotangent of each pixel's least depth, dealt to
  // its ties chunk by chunk over the chunks K7 recorded.
  const float dstar = valid ? out[p * 4 + 3] : INFINITY;
  const float gmin = valid ? g[3] : 0.0f;
  int c_first = 0, c_last = -1, m = 0;
  if (valid) {
    c_first = aux[p * 3 + 0];
    c_last = aux[p * 3 + 1];
    m = aux[p * 3 + 2];
  }
  const bool active = valid && isfinite(dstar) && gmin != 0.0f && m > 0;
  if (t == 0) {
    sh.range[0] = 0x7fffffff;
    sh.range[1] = -1;
  }
  __syncthreads();
  if (active) {
    atomicMin(&sh.range[0], c_first);
    atomicMax(&sh.range[1], c_last);
  }
  __syncthreads();
  const int c_lo = sh.range[0];
  const int c_hi = sh.range[1];
  int seen = 0;   // chunks so far that hold a tie of this pixel
  for (int c = c_lo; c <= c_hi; ++c) {
    const int lo = c * chunk;
    const int hi = min(N, lo + chunk);
    // Pass 0 counts this chunk's ties; pass 1 deals them their share.
    int k = 0;
    float share = 0.0f;
    for (int pass = 0; pass < 2; ++pass) {
      for (int first = lo; first < hi; first += STAGE) {
        const int listed = cull_stage<MODE>(sh.lists, params, colors,
                                            first, min(hi, first + STAGE),
                                            x0, y0);
        __syncthreads();
        for (int j = 0; j < listed; ++j) {
          const float4 g0 = sh.lists.g0[j];
          const float4 g1 = sh.lists.g1[j];
          bool tie = false;
          if (active && c >= c_first && c <= c_last && g1.w == dstar) {
            const Pair q = pair_at<MODE>(g0, g1, __fsub_rn(px, g0.x),
                                         __fsub_rn(py, g0.y));
            tie = q.alpha > HIT_ALPHA;
          }
          if (pass == 0) {
            k += tie;
            continue;
          }
          float v = tie ? share : 0.0f;
          if (__any_sync(FULL, tie)) {
            v = warp_sum(v);
            if (lane == 0 && v != 0.0f)
              atomicAdd(g_params + static_cast<size_t>(sh.lists.idx[j]) * NP +
                            DEPTH,
                        v);
          }
        }
      }
      if (pass == 0 && k > 0) {
        ++seen;
        const int e = c == c_first ? m - 1 : m - seen + 1;
        share = ldexpf(gmin, -e) / static_cast<float>(k);
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// mode 0 DENSE, 1 SIMPLE; `chunk` as K7 took it.  g_params and g_colors
// must be zeroed; nothing is synchronised here.
extern "C" int dense_composite_bwd(const float* params, const float* colors,
                                   const float* out, const float* ck,
                                   const int* aux, const float* g_out,
                                   const float* g_trans, float* g_params,
                                   float* g_colors, int N, int H, int W,
                                   int mode, int chunk, void* stream) {
  if (H <= 0 || W <= 0 || N <= 0) return 0;
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int ntx = (W + TS - 1) / TS;
  const int nty = (H + TS - 1) / TS;
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == DENSE)
    composite_bwd<DENSE><<<ntx * nty, NTHREADS, 0, s>>>(
        params, colors, out, ck, aux, g_out, g_trans, g_params, g_colors, N,
        H, W, ntx, chunk);
  else if (mode == SIMPLE)
    composite_bwd<SIMPLE><<<ntx * nty, NTHREADS, 0, s>>>(
        params, colors, out, ck, aux, g_out, g_trans, g_params, g_colors, N,
        H, W, ntx, chunk);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
