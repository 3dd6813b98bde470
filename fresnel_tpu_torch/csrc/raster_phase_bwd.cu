// Phase-blending backward tile compositor (K2-phi) for NVIDIA Hopper
// (sm_90a): the analytic VJP of raster_phase_fwd.cu.
//
// Replaces the reverse-mode derivative XLA takes of the phase path of
// fresnel_tpu/render/tile.py::_composite_tiles (:672-716); no Pallas kernel
// takes that path, so this kernel has no Pallas counterpart.
//
// Input:  pack (T, M, 12) float32 with the phases in column 11, counts
//         (T,) int32, the amplitude A and 1 - A, box and tile_size as the
//         forward's (P = ts^2 pixels a tile);
//         g_color (T, P, 3), g_depth (T, P), g_trans (T, P): the
//         cotangents of the forward's outputs;
//         ckpt (T, ceil(M / 16), 2, P): the forward's checkpoints of
//         (T, acc_phase) before every 16th slot.
// Output: grad (T, M, 12) float32, the gradient of the pack: mean, conic,
//         RGB, opacity, depth and phase (column 11); the radius column
//         and every slot >= count are 0.
//
// Reverse mode over the recurrence (raster_common.cuh, phase_apply), per
// pixel, with adjoints lT of the transmittance and lP of the running phase
// (lT starts at g_trans, lP at 0; the colour and depth sums are linear, so
// their adjoints stay g_color and g_depth).  For a slot with weight w,
// alpha = clip(x), x = alpha_raw * F, F = 1 - A + A cos(2 pi d),
// acc_alpha = (1 - T) + w, m = max(acc_alpha, 1e-6), p = w / m:
//   dw     = g_c . c + g_D depth + lP (phase - acc_phase) / m
//            + [acc_alpha > 1e-6] dm,   dm = -lP (phase - acc_phase) p / m
//   dalpha = -lT T + dw T
//   lT'    = lT (1 - alpha) + dw alpha - [acc_alpha > 1e-6] dm
//   lP'    = lP (1 - p) - dd * sign(phase - acc_phase)
//   dx     = dalpha where 0 < x < ALPHA_MAX, else 0
//   dalpha_raw = dx F,  dF = dx alpha_raw,
//   dd     = dF A (-sin(2 pi d)) 2 pi * (+1, -1 or 0 as d = |.| or 1 - |.|
//            is the smaller, 0 at a tie, as XLA splits a tie's gradient)
//   dphase = lP p + dd * sign(phase - acc_phase)
// then alpha_raw = e * opacity into mean, conic and opacity as K2 does.
// The state before each slot comes from recomputing the slot's 16-slot
// checkpoint segment forward (the same phase_apply the forward runs) into
// shared memory, never from inverting the recurrence: its phase weight is
// exactly 1 at a pixel's first contributing slot, and 1 - alpha is 0.01
// at ALPHA_MAX.
//
// What bounds it on this card: per in-box pixel-slot pair the forward's
// step (expf, cosf, a division) to know the state, then the adjoint (expf,
// sin and cos, three divisions) and the chain rule, ~100 operations
// rounded op by op, and 11 sums over the tile's pixels per slot, each
// pixel's chain serial over its tile's segments.  The first design, a
// block of 256 threads per tile (53 registers and 39 KB of shared memory:
// 4 blocks per SM, 1.9 waves at T = 1 024), summed each slot's 11 terms
// over every warp with 11 five-step shuffle butterflies (55 shuffles and
// 55 adds per warp and slot), evaluated every slot in every warp before
// skipping it, stalled on its chains as K1-phi's first design did, and
// left a heavy tile of the last wave running alone.  The design:
//   * heaviest tiles first (tile_by_weight): block b takes the b-th tile
//     by descending count, found on the card from the counts, so the
//     second wave holds the lightest tiles;
//   * two pixels per thread in one column (raster_common.cuh, PixelSet),
//     and no branch in a step: the recompute is the forward's
//     phase_step_set, and the adjoint (phase_adjoint_set) takes sin, cos
//     and the divisions by their exact fast paths and commits by selects,
//     so the two chains interleave;
//   * per segment, each warp tests the segment's 16 slots once against its
//     16 x 4-pixel strip (strip_hit, exact) and keeps a ballot mask; the
//     recompute walks the mask up and the reverse pass walks it down, so a
//     warp evaluates only the slots whose box reaches its strip, and a
//     culled warp-slot writes zero partial sums;
//   * each warp-slot's 11 terms (the thread's two pixels added first) are
//     summed over the warp by one reduce-scatter (fold: each step halves
//     the terms a lane holds, 13 shuffles in all), which leaves each sum in
//     the order a butterfly would; then a fixed-order sum over the 4 warps
//     gives each (slot, field), written with coalesced stores;
//   * the recompute keeps only the state (T, acc_phase) of each listed
//     slot in shared memory, 32 KB per tile at 16 slots: keeping alpha_raw
//     and the interference factor as well would double that and halve the
//     blocks an SM holds, so the reverse pass evaluates expf and cos again;
//   * at a tile size other than 16 (one runtime instantiation) a block
//     walks each pixel group of its tile in turn, with K1-phi's pixels
//     and warp boxes, and adds each group's sums to the gradient row in
//     group order; pixels a thread does not own add zero terms.
// At another tile size the states and sums are sized to the block's warps
// at launch (8.5 KB a warp: one warp's at 8, where a block is one warp).
// Residency: 128 threads and 35.5 KB of shared memory per block, at most
// 80 registers a thread (__launch_bounds__(128, 6)): an SM holds 6 tiles,
// the card 792, so T = 1 024 takes 1.29 waves, the second of the lightest
// tiles.  The next segment's pack values and checkpoints are loaded while
// the current one is walked.  No
// atomics, so the result repeats bit for bit.  expf, cosf, sinf and IEEE
// division, no fast math.

#include "raster_common.cuh"

namespace {

using namespace raster;

// Gradient terms per slot: mx, my, conic a, b, c, R, G, B, opacity, depth,
// phase.
constexpr int NG = 11;

// Pack column -> gradient term, -1 for the radius (no gradient).
__device__ __forceinline__ int grad_term(int col) {
  if (col < 5) return col;
  if (col == 5) return -1;
  return col - 1;
}

// One step of the reduce-scatter: lanes with `upper` keep b, the others a;
// each sends the other to its partner `off` lanes away and adds what it
// receives (raster_bwd.cu's).
__device__ __forceinline__ float fold(float a, float b, bool upper,
                                      int off) {
  const float keep = upper ? b : a;
  const float send = upper ? a : b;
  return keep + __shfl_xor_sync(FULL, send, off);
}

// Sums eleven terms over the warp.  Returns to lane l the warp's sum of
// term reduced_term(l), each summed in the order of a butterfly over the
// lanes: lanes below 16 keep terms 0-5, the others 6-10 (and a gap padded
// with 0); then 3 of those six; then 2 of the three (one a gap); then one;
// then a last exchange with the neighbouring lane.
__device__ __forceinline__ float warp_sum11(const float (&v)[NG],
                                            int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float s[6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
    s[i] = fold(v[i], i + 6 < NG ? v[i + 6] : 0.0f, b4, 16);
  float t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = fold(s[i], s[i + 3], b3, 8);
  const float u0 = fold(t[0], t[2], b2, 4), u1 = fold(t[1], 0.0f, b2, 4);
  const float w = fold(u0, u1, b1, 2);
  return w + __shfl_xor_sync(FULL, w, 1);
}

// The term whose warp sum warp_sum11 leaves in lane l, -1 if none: even
// lanes only; bit 4 picks terms 0-5 or 6-11, bit 3 the first or last three
// of those, bits 2 and 1 one of them (0, 1, 2 or a gap); term 11 is a gap.
__device__ __forceinline__ int reduced_term(int lane) {
  if (lane & 1) return -1;
  const int i = (lane & 2) ? ((lane & 4) ? -1 : 1) : ((lane & 4) ? 2 : 0);
  if (i < 0) return -1;
  const int term = ((lane & 16) ? 6 : 0) + ((lane & 8) ? 3 : 0) + i;
  return term < NG ? term : -1;
}

// The adjoint step of staged slot g at the thread's pixels, whose states
// before the slot are st[2 k] = T and st[2 k + 1] = acc_phase: updates lT
// and lP and adds the pixels' 11 terms to v.  Where a pixel's alpha_raw is
// 0 nothing changes.  As in phase_step_set, every value is computed for
// every pixel and committed by a select, and sin, cos and the divisions
// take their fast paths, so the pixels' chains interleave.
template <bool BOX, int TSC>
__device__ __forceinline__ void phase_adjoint_set(
    const float* g, const PixelSet<TSC>& q, const float (*st)[32], int lane,
    Amplitude amp, const float (&gR)[PPT], const float (&gG)[PPT],
    const float (&gB)[PPT], const float (&gD)[PPT], float (&lT)[PPT],
    float (&lP)[PPT], float (&v)[NG]) {
  Alpha a[PPT];
  eval_alpha_set<BOX>(g, q, a);
  const float phase = g[PHASE];
  float T[PPT], diff[PPT], pd[PPT], arg[PPT], c[PPT], sn[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    T[k] = st[2 * k][lane];
    diff[k] = __fsub_rn(phase, st[2 * k + 1][lane]);
    pd[k] = fabsf(diff[k]);
    arg[k] = __fmul_rn(fminf(pd[k], __fsub_rn(1.0f, pd[k])), TWO_PI_F);
  }
  sin_cos_set(arg, sn, c);
  // The forward's values, rounded as phase_step_set rounds them.
  float factor[PPT], x[PPT], w[PPT], acc_alpha[PPT], m[PPT], pc[PPT];
  float dpc[PPT], dpc_m[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    factor[k] = __fadd_rn(amp.one_minus_a, __fmul_rn(amp.a, c[k]));
    x[k] = __fmul_rn(a[k].alpha_raw, factor[k]);
    w[k] = __fmul_rn(clip_alpha(x[k]), T[k]);
    acc_alpha[k] = __fadd_rn(__fsub_rn(1.0f, T[k]), w[k]);
    m[k] = fmaxf(acc_alpha[k], 1e-6f);
    // Through acc_phase' = acc_phase (1 - p) + phase p.
    dpc[k] = lP[k] * diff[k];
  }
  div_set(w, m, pc);
  div_set(dpc, m, dpc_m);
  float dm_num[PPT], dm[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) dm_num[k] = -dpc[k] * pc[k];
  div_set(dm_num, m, dm);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const float alpha = clip_alpha(x[k]);
    if (!(acc_alpha[k] > 1e-6f)) dm[k] = 0.0f;
    const float dw = gR[k] * g[R] + gG[k] * g[G] + gB[k] * g[B] +
                     gD[k] * g[DEPTH] + dpc_m[k] + dm[k];
    const float dalpha = (dw - lT[k]) * T[k];
    const float lT_new = lT[k] * (1.0f - alpha) + dw * alpha - dm[k];
    const float dx = (x[k] > 0.0f && x[k] < ALPHA_MAX) ? dalpha : 0.0f;
    const float dF = dx * a[k].alpha_raw;
    const float dpw = dF * amp.a * -sn[k] * TWO_PI_F;
    const float one_m = 1.0f - pd[k];
    const float dpd =
        pd[k] < one_m ? dpw : (pd[k] > one_m ? -dpw : 0.0f);
    const float sgn =
        diff[k] > 0.0f ? 1.0f : (diff[k] < 0.0f ? -1.0f : 0.0f);
    const float dphase = lP[k] * pc[k] + dpd * sgn;
    const float lP_new = lP[k] * (1.0f - pc[k]) - dpd * sgn;
    const float da = dx * factor[k];
    // dmq = d loss / d m, m the quadratic form; the conic is staged as
    // qa = -a / 2, qb = -b, qc = -c / 2.
    const float dmq = da * a[k].alpha_raw * -0.5f;
    const float dmx = dmq * a[k].dx;
    const float term[NG] = {
        dmq * 2.0f * (2.0f * g[QA] * a[k].dx + g[QB] * a[k].dy),
        dmq * 2.0f * (g[QB] * a[k].dx + 2.0f * g[QC] * a[k].dy),
        dmx * a[k].dx,
        2.0f * dmx * a[k].dy,
        dmq * a[k].dy * a[k].dy,
        w[k] * gR[k],
        w[k] * gG[k],
        w[k] * gB[k],
        da * a[k].e,
        w[k] * gD[k],
        dphase};
    const bool live = q.owns(k) & (a[k].alpha_raw != 0.0f);
    lT[k] = live ? lT_new : lT[k];
    lP[k] = live ? lP_new : lP[k];
#pragma unroll
    for (int i = 0; i < NG; ++i) v[i] += live ? term[i] : 0.0f;
  }
}

template <int TSC, bool BOX>
__global__ void __launch_bounds__(PHASE_MAX_THREADS, TSC > 0 ? 6 : 4)
composite_phase_bwd(const float* __restrict__ pack,
                    const int* __restrict__ counts,
                    const float* __restrict__ g_color,
                    const float* __restrict__ g_depth,
                    const float* __restrict__ g_trans,
                    const float* __restrict__ ckpt,
                    float* __restrict__ grad, int n_tiles, int max_per_tile,
                    int n_tiles_x, int tiles_per_image, Amplitude amp,
                    int tile_size) {
  // The threads of a block: compiled in for the 16-pixel tile.
  constexpr int NTC = TSC == TS ? PHASE_THREADS : 0;
  __shared__ __align__(16) float sh[CKPT * PACK];
  const Tile<TSC> geo(tile_size);
  const int P = geo.pix();
  const int NT = NTC > 0 ? NTC : phase_threads(geo);
  // Per warp and slot of the segment, the state before it (T and
  // acc_phase of the thread's pixels, lane by lane) and the warp's sums:
  // static for the 16-pixel tile, else sized to the block's warps at
  // launch (phase_bwd_shared), so a block of one warp holds one warp's.
  float (*state)[CKPT][2 * PPT][32];
  float (*sums)[CKPT][NG];
  if constexpr (NTC > 0) {
    __shared__ float state_s[NTC / 32][CKPT][2 * PPT][32];
    __shared__ float sums_s[NTC / 32][CKPT][NG];
    state = state_s;
    sums = sums_s;
  } else {
    extern __shared__ float dyn[];
    state = reinterpret_cast<float (*)[CKPT][2 * PPT][32]>(dyn);
    sums = reinterpret_cast<float (*)[CKPT][NG]>(
        dyn + (NT / 32) * CKPT * 2 * PPT * 32);
  }
  const int tile =
      tile_by_weight<NTC>(counts, n_tiles, max_per_tile, blockIdx.x);
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int term = reduced_term(lane);
  const int n = tile_count(counts, tile, max_per_tile);
  const int nck = n_checkpoints(max_per_tile);
  float* row = grad + static_cast<size_t>(tile) * max_per_tile * PACK;
  float (*st)[2 * PPT][32] = state[warp];
  const float* tile_pack =
      pack + static_cast<size_t>(tile) * max_per_tile * PACK;
  // Loads a thread of a segment's pack values: CKPT * PACK over the
  // fewest threads a block has.
  constexpr int PF = (CKPT * PACK + (NTC > 0 ? NTC : 32) - 1) /
                     (NTC > 0 ? NTC : 32);

  // Each pixel group in turn; the groups' sums add into `row` in order.
  for (int grp = 0; grp < phase_groups(geo); ++grp) {
    const PixelSet<TSC> q =
        pixel_set(geo, tile, grp, t, n_tiles_x, tiles_per_image);
    // Pixel i of the thread in its tile (pixel 0 for one it does not own,
    // whose terms are 0).
    auto pix = [&](int i) { return q.owns(i) ? q.p + i * 32 : 0; };
    float gR[PPT], gG[PPT], gB[PPT], gD[PPT], lT[PPT], lP[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const size_t o = static_cast<size_t>(tile) * P + pix(i);
      gR[i] = g_color[o * 3 + 0];
      gG[i] = g_color[o * 3 + 1];
      gB[i] = g_color[o * 3 + 2];
      gD[i] = g_depth[o];
      lT[i] = g_trans[o];
      lP[i] = 0.0f;
    }

    // Segment k's pack values (the thread's elements t, t + NT, ... of its
    // cnt * PACK) and checkpoints, loaded one segment ahead.
    float pf[PF], ck[2 * PPT];
    auto prefetch = [&](int k) {
      const int first = k * CKPT, cnt = min(CKPT, n - first);
#pragma unroll
      for (int h = 0; h < PF; ++h) {
        const int i = t + h * NT;
        pf[h] = i < cnt * PACK ? tile_pack[first * PACK + i] : 0.0f;
      }
      const float* c = ckpt + (static_cast<size_t>(tile) * nck + k) * 2 * P;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        ck[2 * i] = c[pix(i)];
        ck[2 * i + 1] = c[P + pix(i)];
      }
    };
    if (n > 0) prefetch(n_segments(n, CKPT) - 1);
    for (int k = n_segments(n, CKPT) - 1; k >= 0; --k) {
      const int first = k * CKPT;
      const int cnt = min(CKPT, n - first);
      __syncthreads();   // the previous segment's slots and sums are consumed
#pragma unroll
      for (int h = 0; h < PF; ++h) {
        const int i = t + h * NT;
        if (i < cnt * PACK) sh[i] = staged(pf[h], i % PACK);
      }
      float T[PPT], acc_phase[PPT];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        T[i] = ck[2 * i];
        acc_phase[i] = ck[2 * i + 1];
      }
      if (k > 0) prefetch(k - 1);
      __syncthreads();
      // The slots whose box reaches this warp's pixels; the others' partial
      // sums are 0.
      const bool keep = lane < cnt && q.owns_any() &&
                        (!BOX || strip_hit(sh + lane * PACK, q));
      const unsigned live = __ballot_sync(FULL, keep);
      if (lane < cnt && !keep) {
#pragma unroll
        for (int i = 0; i < NG; ++i) sums[warp][lane][i] = 0.0f;
      }
      for (unsigned m = live; m != 0; m &= m - 1) {
        const int j = __ffs(m) - 1;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          st[j][2 * i][lane] = T[i];
          st[j][2 * i + 1][lane] = acc_phase[i];
        }
        phase_step_set<BOX>(sh + j * PACK, q, amp, T, acc_phase, nullptr);
      }
      for (unsigned m = live; m != 0;) {
        const int j = 31 - __clz(m);
        m ^= 1u << j;
        float v[NG];
#pragma unroll
        for (int i = 0; i < NG; ++i) v[i] = 0.0f;
        phase_adjoint_set<BOX>(sh + j * PACK, q, st[j], lane, amp, gR, gG,
                               gB, gD, lT, lP, v);
        const float s = warp_sum11(v, lane);
        if (term >= 0) sums[warp][j][term] = s;
      }
      __syncthreads();
      for (int i = t; i < cnt * PACK; i += NT) {
        const int f = grad_term(i % PACK);
        float s = 0.0f;
        if (f >= 0) {
#pragma unroll
          for (int w = 0; w < NT / 32; ++w) s += sums[w][i / PACK][f];
        }
        // This thread wrote the same element for the groups before.
        row[first * PACK + i] = grp == 0 ? s : row[first * PACK + i] + s;
      }
    }
  }
  for (int i = n * PACK + t; i < max_per_tile * PACK; i += NT) row[i] = 0.0f;
}

// Dynamic shared bytes of the runtime instantiation for `nt` threads: each
// warp's states and sums.
__host__ __forceinline__ size_t phase_bwd_shared(int nt) {
  return static_cast<size_t>(nt / 32) * CKPT * (2 * PPT * 32 + NG) *
         sizeof(float);
}

template <int TSC>
cudaError_t launch_as(const float* pack, const int* counts,
                      const float* g_color, const float* g_depth,
                      const float* g_trans, const float* ckpt, float* grad,
                      int n_tiles, int max_per_tile, int n_tiles_x,
                      int tiles_per_image, int box, Amplitude a,
                      int tile_size, cudaStream_t s) {
  const int nt = phase_threads(Tile<TSC>(tile_size));
  const size_t dyn = TSC > 0 ? 0 : phase_bwd_shared(nt);
  if (box)
    composite_phase_bwd<TSC, true><<<n_tiles, nt, dyn, s>>>(
        pack, counts, g_color, g_depth, g_trans, ckpt, grad, n_tiles,
        max_per_tile, n_tiles_x, tiles_per_image, a, tile_size);
  else
    composite_phase_bwd<TSC, false><<<n_tiles, nt, dyn, s>>>(
        pack, counts, g_color, g_depth, g_trans, ckpt, grad, n_tiles,
        max_per_tile, n_tiles_x, tiles_per_image, a, tile_size);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller allocates every buffer (grad need not be zeroed: the kernel
// writes every element); nothing is synchronised here.
extern "C" int raster_phase_bwd(const float* pack, const int* counts,
                                const float* g_color, const float* g_depth,
                                const float* g_trans, const float* ckpt,
                                float* grad, int n_tiles, int max_per_tile,
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
  return static_cast<int>(launch(pack, counts, g_color, g_depth, g_trans,
                                 ckpt, grad, n_tiles, max_per_tile,
                                 n_tiles_x, tiles_per_image, box, a,
                                 tile_size, s));
}

// The box-test kernel's residency on the current device at tile size
// `tile_size` (raster_common.cuh, kernel_residency): out[5] = registers per
// thread, static shared bytes, local bytes, threads per block, blocks per
// SM.  Returns a CUDA error code.
extern "C" int raster_phase_bwd_residency(int tile_size, int* out) {
  if (tile_size < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = raster::phase_threads(raster::Tile<0>(tile_size));
  return tile_size == raster::TS
             ? raster::kernel_residency(composite_phase_bwd<raster::TS, true>,
                                        raster::PHASE_THREADS, out)
             : raster::kernel_residency(composite_phase_bwd<0, true>, nt,
                                        out, phase_bwd_shared(nt));
}
