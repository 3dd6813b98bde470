// Card check of the exact fast paths K1-phi and K2-phi take
// (raster_common.cuh): sin_quadrant against CUDA's sinf and cosf, and
// div_fast against __fdiv_rn.  Not on any render path: chip_smoke.py and
// tests/test_torch_cuda.py run it to show that the kernels round as the
// library does wherever they take the fast paths.
//
// Output: out[5] unsigned 64-bit counters, zeroed by the caller:
//   [0] arguments checked, [1] cos mismatches, [2] sin mismatches,
//   [3] division pairs checked, [4] division mismatches (bitwise).
// Arguments: every float x >= 0 with trig_fast_ok(x), and -x; PAIRS
// pseudo-random (a, b) with exponents across div_fast_ok's range (a zero in
// every 101st pair, signs random) that div_fast_ok admits.
// The counters are summed with atomics: this is a count, not a result.

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr unsigned FAST_LIMIT = 0x47ce4780u;   // 105615.0f
constexpr unsigned PAIRS = 1u << 30;

__device__ __forceinline__ unsigned mix(unsigned x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

// Exponent field in [87, 168): |value| in [2^-40, 2^41), random mantissa
// and sign.
__device__ __forceinline__ float pick(unsigned h) {
  return __uint_as_float((h & 0x807fffffu) | ((87u + mix(h) % 81u) << 23));
}

__global__ void check(unsigned long long* out) {
  unsigned long long n = 0, bad_c = 0, bad_s = 0, n_div = 0, bad_div = 0;
  const unsigned step = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
       i <= FAST_LIMIT; i += step) {
    for (int sign = 0; sign < 2; ++sign) {
      const float x = __uint_as_float(i | (sign ? 0x80000000u : 0u));
      if (!trig_fast_ok(x)) continue;
      ++n;
      bad_c += __float_as_uint(sin_quadrant(x, 1)) != __float_as_uint(cosf(x));
      bad_s += __float_as_uint(sin_quadrant(x, 0)) != __float_as_uint(sinf(x));
    }
  }
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < PAIRS;
       i += step) {
    const float a = i % 101 == 0 ? (i & 1 ? -0.0f : 0.0f)
                                 : pick(mix(2 * i + 1));
    const float b = pick(mix(2 * i + 0x9e3779b9u));
    if (!div_fast_ok(a, b)) continue;
    ++n_div;
    bad_div += __float_as_uint(div_fast(a, b)) !=
               __float_as_uint(__fdiv_rn(a, b));
  }
  atomicAdd(out + 0, n);
  atomicAdd(out + 1, bad_c);
  atomicAdd(out + 2, bad_s);
  atomicAdd(out + 3, n_div);
  atomicAdd(out + 4, bad_div);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int phase_fastpath_check(unsigned long long* out, void* stream) {
  check<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return static_cast<int>(cudaGetLastError());
}
