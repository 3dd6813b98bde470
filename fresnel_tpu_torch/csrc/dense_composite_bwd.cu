// Dense compositing backward (K8) for NVIDIA Hopper (sm_90a): the
// reverse-mode derivative of K7 (dense_composite_fwd.cu), which replaces
// what jax.grad makes of the scans of fresnel_tpu/render/dense.py (:68-108)
// and fresnel_tpu/render/simplified.py (:52-86).
//
// Input:  params (N, 8), colors (N, 3) as K7 took them; K7's out
//         (H * W, 4), ck and aux (its checkpoints, tile lists and tie
//         record); the cotangents g_out (H * W, 4) and g_trans (H * W).
// Output: g_params (N, 8), g_colors (N, 3), zeroed by the caller and
//         accumulated here (the radius column and the mode's unused
//         columns stay 0).
//
// The gradient, with no division.  For pixel p, let g be the cotangent of
// the colour (and DENSE's depth sum) and v_i Gaussian i's colour (and
// depth).  With Q_i the cotangent of T_{i+1} (the transmittance after i),
//   Q_{N-1} = g_trans,   Q_{i-1} = Q_i + alpha_i (g.v_i - Q_i),
//   dL/dalpha_i = T_i (g.v_i - Q_i),   dL/dv_i = alpha_i T_i g,
// and the chain through the clip (ties split evenly, as jax.grad splits
// jnp.clip's) to the opacity and the weight's parameters.  A walk back to
// front carries Q; T_i comes from K7's checkpoint at the start of its run,
// recomputed with K7's own bits (the shared `weights`).  SIMPLE's alpha
// reaches 1 and T then 0 exactly, and T underflows to 0 over thousands of
// DENSE Gaussians, so T_i cannot be recovered by dividing T_{i+1} by 1 -
// alpha_i; no quantity here is divided out.
//
// The sums over a tile's pixels.  With u = dL/dalpha clip'(raw) e (e the
// weight, raw = e opacity), every gradient of a Gaussian is a sum over
// pixels of u or of w g (w = alpha T): DENSE dL/dopacity = sum u, and
// with the moments S_x = sum u dx, S_y, S_xx = sum u dx^2, S_xy, S_yy,
//   dL/dmx = op (a S_x + b S_y),  dL/dmy = op (b S_x + c S_y),
//   dL/da = -op S_xx / 2,  dL/db = -op S_xy,  dL/dc = -op S_yy / 2;
// SIMPLE dL/dmx = op S_x / sigma^2, dL/dmy = op S_y / sigma^2, dL/dsigma
// = op (S_xx + S_yy) / sigma^3.  A thread sums its two pixels' terms (10
// DENSE, 7 SIMPLE: the moments, sum w g_depth, sum w g_rgb), a
// reduce-scatter of shuffles sums them over the warp (12 / 9 shuffles),
// shared memory over the 8 warps, and the flush turns a run's moments into
// gradients and adds them with one atomicAdd per field and tile.  The
// order across tiles varies from run to run: not bit for bit.
//
// SIMPLE's depth channel is a minimum: its cotangent goes to the hits
// (alpha > 0.1) whose depth equals it.  The JAX scan takes jnp.min over
// each chunk (ties in it share evenly) and jnp.minimum with the running
// minimum (a tie shares in halves), so with the least depth reached in m
// chunks, the j-th of them (in order) gets 2^-(m - j + 1) of it, the first
// 2^-(m - 1), each shared by its chunk's k ties.  K7 leaves the first and
// last such chunk and m; a pass over those chunks of the tile's list
// (found by index: the list is in index order) counts k and then deals
// the shares.
//
// What bounds it.  DENSE lists ~4 700 of 5 476 Gaussians at every 512^2
// pixel: bound by instruction throughput (~60 operations a pair, the
// bound's count, 1.06 ms).
// The first version spent ~130 instructions a pair: every alpha three
// times (a forward pass within a stage of 256 from K7's checkpoint, then
// each run of 16 again, each an op-by-op form and a full expf), a
// reduce-scatter of 10 terms per pixel, two barriers and a flush per run:
// 9.67 ms.  Here ~60 a pixel-pair: one alpha, the walk back, the moments,
// and half a reduce-scatter (two pixels a thread): 4.64 ms (H100 80GB
// HBM3, 700 W; chip_smoke.py --ab).  Measured by removing one part at a
// time: the reduce-scatter is 1.6 ms of it, the atomics (2.4e7) and
// SIMPLE's tie pass under 0.05 ms each.  At 256^2 the 128 tiles leave one
// block of 8 warps per SM: latency-bound, 1.86 ms.  SIMPLE is bound by
// its longest list, as in K7.
//
// Design: one block of 256 threads per 32 x 16 tile, two pixels a thread
// (one column: dx, the shared loads and the reduction serve both; two
// independent Q / T chains).  The list is walked last to first, STAGE
// entries folded into shared memory at a time, and in runs of SUB = 16:
// each run starts at K7's checkpoint, evaluates its 16 alphas once into
// registers (T and e, 64 floats), and walks them back.  The run's sums
// go to a double-buffered scratch, so a run pays one block barrier; the
// flush of one run overlaps the next run's walk.  125 registers (SIMPLE
// 127), no spills, two blocks per SM.

#include "dense_composite_common.cuh"

namespace {

using namespace dcomp;

// Terms a thread sums per listed Gaussian.
template <int MODE>
constexpr int NTERMS = MODE == DENSE ? 10 : 7;
static_assert(PPT == 2, "the walk back sums two pixels' terms");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Reduce-scatter over the warp of the first N of a's values, from lane
// offset OFF down: at each step a lane keeps one half of its values (the
// upper half where bit OFF of its lane is set, padded with 0 when N is
// odd) and adds its partner's copy of that half.  After the five steps
// each lane holds one warp sum, of the term `rs_term` names.  The order
// of the additions is fixed.
template <int NT, int N, int OFF>
__device__ __forceinline__ float reduce_scatter(float (&a)[NT], int lane) {
  const bool up = lane & OFF;
  if constexpr (N == 1) {
    a[0] += __shfl_xor_sync(FULL, a[0], OFF);
  } else {
    constexpr int H = (N + 1) / 2;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float lo = a[i];
      const float hi = i + H < N ? a[i + H] : 0.0f;
      a[i] = (up ? hi : lo) + __shfl_xor_sync(FULL, up ? lo : hi, OFF);
    }
  }
  if constexpr (OFF > 1)
    return reduce_scatter<NT, (N + 1) / 2, OFF / 2>(a, lane);
  else
    return a[0];
}

// The term whose warp sum reduce_scatter leaves `lane`, or -1 for a lane
// that ends with padding or with a copy another lane writes.
__device__ __forceinline__ int rs_term(int n_terms, int lane) {
  int n = n_terms, idx = 0, real = n_terms;
  for (int off = 16; off >= 1; off >>= 1) {
    const bool up = lane & off;
    if (n == 1) {
      if (up) return -1;
      continue;
    }
    const int h = (n + 1) / 2;
    if (up) {
      idx += h;
      real -= h;
    } else {
      real = min(real, h);
    }
    n = h;
  }
  return real >= 1 ? idx : -1;
}

template <int MODE>
struct BwdShared {
  float4 g0[STAGE];
  float4 g1[STAGE];
  float4 col[STAGE];
  float4 raw[STAGE];     // (a | sigma, b, c, opacity), unfolded, for the flush
  float red[2][NWARP][SUB][NTERMS<MODE>];
  int range[2];
};

// One Gaussian's gradients from its terms summed over the tile: output o
// of listed Gaussian k of the run, added to its field with one atomic.
// DENSE terms: [sum u, S_x, S_y, S_xx, S_xy, S_yy, sum w gD, sum w g_rgb];
// SIMPLE: [sum u, S_x, S_y, S_xx + S_yy, sum w g_rgb].
template <int MODE>
__device__ void flush(const BwdShared<MODE>& sh, int buf, int base, int kn,
                      float* __restrict__ g_params,
                      float* __restrict__ g_colors) {
  constexpr int NT = NTERMS<MODE>;
  for (int i = threadIdx.x; i < kn * NT; i += NTHREADS) {
    const int k = i / NT;
    const int o = i % NT;
    auto term = [&](int f) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) s += sh.red[buf][w][k][f];
      return s;
    };
    const float4 r = sh.raw[base + k];
    const size_t gi = static_cast<size_t>(__float_as_int(sh.col[base + k].w));
    float v;
    float* dst;
    if (MODE == DENSE) {
      switch (o) {
        case 0: v = r.w * (r.x * term(1) + r.y * term(2));
                dst = g_params + gi * NP + MX; break;
        case 1: v = r.w * (r.y * term(1) + r.z * term(2));
                dst = g_params + gi * NP + MY; break;
        case 2: v = -0.5f * r.w * term(3); dst = g_params + gi * NP + CA; break;
        case 3: v = -r.w * term(4); dst = g_params + gi * NP + CB; break;
        case 4: v = -0.5f * r.w * term(5); dst = g_params + gi * NP + CC; break;
        case 5: v = term(0); dst = g_params + gi * NP + OPACITY; break;
        case 6: v = term(6); dst = g_params + gi * NP + DEPTH; break;
        default: v = term(o); dst = g_colors + gi * 3 + (o - 7); break;
      }
    } else {
      const float s2 = r.w / (r.x * r.x);
      switch (o) {
        case 0: v = s2 * term(1); dst = g_params + gi * NP + MX; break;
        case 1: v = s2 * term(2); dst = g_params + gi * NP + MY; break;
        case 2: v = s2 / r.x * term(3); dst = g_params + gi * NP + CA; break;
        case 3: v = term(0); dst = g_params + gi * NP + OPACITY; break;
        default: v = term(o); dst = g_colors + gi * 3 + (o - 4); break;
      }
    }
    if (v != 0.0f) atomicAdd(dst, v);
  }
}

template <int MODE>
__global__ void __launch_bounds__(NTHREADS, 2)
composite_bwd(const float* __restrict__ params,
              const float* __restrict__ colors,
              const float* __restrict__ out, const float* __restrict__ ck,
              const int* __restrict__ aux, const float* __restrict__ g_out,
              const float* __restrict__ g_trans, float* __restrict__ g_params,
              float* __restrict__ g_colors, int N, int H, int W, int ntx,
              int chunk) {
  constexpr int NT = NTERMS<MODE>;
  __shared__ BwdShared<MODE> sh;
  const Scratch sc = scratch(const_cast<int*>(aux), N, H, W);
  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int my_term = rs_term(NT, lane);
  const int* list = sc.lists + static_cast<size_t>(tile) * N;
  const int L = sc.counts[tile];
  const Pixels q = pixels(tile, ntx, H, W);
  const float* ck_tile =
      ck + static_cast<size_t>(tile) * ((N + SUB - 1) / SUB) * TILE_PIX;
  const float amax = alpha_max<MODE>();

  // Pixels past the edge carry zero cotangents and add nothing.
  float g[PPT][4], Q[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      g[i][c] = q.valid[i] ? g_out[q.p[i] * 4 + c] : 0.0f;
    Q[i] = q.valid[i] ? g_trans[q.p[i]] : 0.0f;
  }

  int buf = 0;
  for (int s0 = L > 0 ? (L - 1) / STAGE * STAGE : -1; s0 >= 0;
       s0 -= STAGE) {
    const int n = min(STAGE, L - s0);
    __syncthreads();   // the last stage's entries have been flushed
    if (t < n) {
      const int gi = list[s0 + t];
      fold<MODE>(params, colors, gi, chunk, sh.g0[t], sh.g1[t], sh.col[t]);
      const float* p = params + static_cast<size_t>(gi) * NP;
      sh.raw[t] = make_float4(p[CA], p[CB], p[CC], p[OPACITY]);
    }
    __syncthreads();
    for (int j = (n - 1) / SUB * SUB; j >= 0; j -= SUB) {
      const int kn = min(SUB, n - j);
      // The run's transmittances and weights, from K7's checkpoint.
      const float* c = ck_tile + static_cast<size_t>((s0 + j) / SUB) * TILE_PIX;
      float T[PPT], Tk[SUB][PPT], Ek[SUB][PPT];
#pragma unroll
      for (int i = 0; i < PPT; ++i) T[i] = c[q.slot[i]];
#pragma unroll
      for (int k = 0; k < SUB; ++k) {
        if (k < kn) {
          float dx, dy[PPT];
          weights<MODE>(sh.g0[j + k], sh.g1[j + k], q.px, q.py, dx, dy,
                        Ek[k]);
#pragma unroll
          for (int i = 0; i < PPT; ++i) {
            Tk[k][i] = T[i];
            T[i] = trans_step(T[i], alpha_of<MODE>(Ek[k][i],
                                                   sh.g1[j + k].y));
          }
        }
      }
      // The walk back.
#pragma unroll
      for (int k = SUB - 1; k >= 0; --k) {
        if (k >= kn) continue;   // uniform over the block
        const float4 g0 = sh.g0[j + k];
        const float4 g1 = sh.g1[j + k];
        const float4 col = sh.col[j + k];
        const float dx = __fsub_rn(q.px, g0.x);
        float u[PPT], w[PPT], dy[PPT];
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          dy[i] = __fsub_rn(q.py[i], g0.y);
          const float e = Ek[k][i];
          const float raw = __fmul_rn(e, g1.y);
          const float alpha = jclip(raw, 0.0f, amax);
          float gv = g[i][0] * col.x + g[i][1] * col.y + g[i][2] * col.z;
          if (MODE == DENSE) gv += g[i][3] * g1.z;
          const float d = gv - Q[i];
          const float dalpha = Tk[k][i] * d;
          Q[i] = fmaf(alpha, d, Q[i]);
          w[i] = alpha * Tk[k][i];
          u[i] = dalpha * jclip_grad(raw, 0.0f, amax) * e;
        }
        float v[NT];
        const float sy0 = u[0] * dy[0], sy1 = u[1] * dy[1];
        v[0] = u[0] + u[1];
        v[1] = v[0] * dx;
        v[2] = sy0 + sy1;
        const float syy = fmaf(sy0, dy[0], sy1 * dy[1]);
        if (MODE == DENSE) {
          v[3] = v[1] * dx;
          v[4] = v[2] * dx;
          v[5] = syy;
          v[6] = fmaf(w[1], g[1][3], w[0] * g[0][3]);
        } else {
          v[3] = fmaf(v[1], dx, syy);
        }
        constexpr int C0 = NT - 3;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          v[C0 + ch] = fmaf(w[1], g[1][ch], w[0] * g[0][ch]);
        const float sum = reduce_scatter<NT, NT, 16>(v, lane);
        if (my_term >= 0) sh.red[buf][warp][k][my_term] = sum;
      }
      __syncthreads();
      flush<MODE>(sh, buf, j, kn, g_params, g_colors);
      buf ^= 1;
    }
  }

  if (MODE != SIMPLE) return;

  // SIMPLE's depth: the cotangent of each pixel's least depth, dealt to
  // its ties chunk by chunk over the chunks K7 recorded.
  float dstar[PPT], gmin[PPT];
  int c_first[PPT], c_last[PPT], m[PPT], seen[PPT];
  bool active[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    dstar[i] = q.valid[i] ? out[q.p[i] * 4 + 3] : INFINITY;
    gmin[i] = g[i][3];
    c_first[i] = 0;
    c_last[i] = -1;
    m[i] = 0;
    if (q.valid[i]) {
      c_first[i] = sc.ties[q.p[i] * 3 + 0];
      c_last[i] = sc.ties[q.p[i] * 3 + 1];
      m[i] = sc.ties[q.p[i] * 3 + 2];
    }
    active[i] = q.valid[i] && isfinite(dstar[i]) && gmin[i] != 0.0f &&
                m[i] > 0;
    seen[i] = 0;
  }
  if (t == 0) {
    sh.range[0] = 0x7fffffff;
    sh.range[1] = -1;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    if (active[i]) {
      atomicMin(&sh.range[0], c_first[i]);
      atomicMax(&sh.range[1], c_last[i]);
    }
  }
  __syncthreads();
  const int c_lo = sh.range[0];
  const int c_hi = sh.range[1];
  if (c_lo > c_hi) return;   // uniform over the block
  // The list's entries of chunks c_lo..c_hi: [j, j_end), by bisection.
  auto lower_bound = [&](int value) {
    int lo = 0, hi = L;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (list[mid] < value) lo = mid + 1; else hi = mid;
    }
    return lo;
  };
  int j = lower_bound(c_lo * chunk);
  const int j_end = lower_bound(min(N, (c_hi + 1) * chunk));
  while (j < j_end) {
    const int c = list[j] / chunk;
    int jn = j + 1;
    while (jn < j_end && list[jn] < (c + 1) * chunk) ++jn;
    bool in_c[PPT], any_c = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      in_c[i] = active[i] && c >= c_first[i] && c <= c_last[i];
      any_c |= in_c[i];
    }
    if (!__any_sync(FULL, any_c)) {   // no pixel of the warp has chunk c
      j = jn;
      continue;
    }
    // Pass 0 counts this chunk's ties at each pixel; pass 1 deals them
    // their share.  Only a Gaussian at a pixel's least depth needs its
    // alpha.
    int k[PPT] = {};
    float share[PPT] = {};
    for (int pass = 0; pass < 2; ++pass) {
      for (int jj = j; jj < jn; ++jj) {
        const int gi = list[jj];
        const float depth = params[static_cast<size_t>(gi) * NP + DEPTH];
        bool tie[PPT];
#pragma unroll
        for (int i = 0; i < PPT; ++i) tie[i] = in_c[i] && depth == dstar[i];
        if (tie[0] || tie[1]) {
          float4 g0, g1, col;
          fold<SIMPLE>(params, colors, gi, chunk, g0, g1, col);
          float dx, dy[PPT], e[PPT];
          weights<SIMPLE>(g0, g1, q.px, q.py, dx, dy, e);
#pragma unroll
          for (int i = 0; i < PPT; ++i)
            tie[i] = tie[i] && alpha_of<SIMPLE>(e[i], g1.y) > HIT_ALPHA;
        }
        float v = 0.0f;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          k[i] += pass == 0 && tie[i];
          v += pass == 1 && tie[i] ? share[i] : 0.0f;
        }
        if (pass == 1 && __any_sync(FULL, tie[0] || tie[1])) {
          v = warp_sum(v);
          if (lane == 0 && v != 0.0f)
            atomicAdd(g_params + static_cast<size_t>(gi) * NP + DEPTH, v);
        }
      }
      if (pass == 0) {
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          if (k[i] == 0) continue;
          ++seen[i];
          const int ex = c == c_first[i] ? m[i] - 1 : m[i] - seen[i] + 1;
          share[i] = ldexpf(gmin[i], -ex) / static_cast<float>(k[i]);
        }
      }
    }
    j = jn;
  }
}

template <int MODE>
int launch(const float* params, const float* colors, const float* out,
           const float* ck, const int* aux, const float* g_out,
           const float* g_trans, float* g_params, float* g_colors, int N,
           int H, int W, int chunk, cudaStream_t s) {
  const int ntx = (W + BW - 1) / BW;
  const int nty = (H + BH - 1) / BH;
  composite_bwd<MODE><<<ntx * nty, NTHREADS, 0, s>>>(
      params, colors, out, ck, aux, g_out, g_trans, g_params, g_colors, N, H,
      W, ntx, chunk);
  return static_cast<int>(cudaGetLastError());
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
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == DENSE)
    return launch<DENSE>(params, colors, out, ck, aux, g_out, g_trans,
                         g_params, g_colors, N, H, W, chunk, s);
  if (mode == SIMPLE)
    return launch<SIMPLE>(params, colors, out, ck, aux, g_out, g_trans,
                          g_params, g_colors, N, H, W, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Its residency in `mode` (kernel_residency in the header).
extern "C" int dense_composite_bwd_residency(int mode, int* out) {
  return kernel_residency(
      mode == DENSE ? composite_bwd<DENSE> : composite_bwd<SIMPLE>, out);
}
