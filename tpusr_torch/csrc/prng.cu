// K5: JAX's random streams (threefry2x32 and the jax.random samplers) for
// sm_90a, bit for bit the port's plain version (core/prng.py).
//
// Replaces no Pallas kernel. On the TPU these draws are one fused kernel that
// XLA generates from jax._src.prng (threefry2x32 with
// jax_threefry_partitionable on) and jax._src.random's samplers; the port's
// plain version spells each of them out as ~135 small tensor ops. Here one
// launch makes one draw: thread i hashes the counter words (0, i), i < n <
// 2^31, under the key (k0, k1) with the 20 threefry rounds in registers
// (rotations by __funnelshift_l), applies the sampler and stores only the
// result, with a grid-stride loop and coalesced stores. A second entry, for
// NORMAL and TRUNCATED only, reads the words from memory instead of hashing
// counters, so that a check can feed every mantissa to the normal samplers.
//
// The samplers (core/prng.py line for line; the hex-float constants are
// prng.py's, held equal by tests/test_torch_prng_kernel.py):
//   BITS32, BITS64   the word o0 ^ o1, as int32 or as a zero-extended int64
//   UNIFORM          f = float(1.m) - 1, then fma(f, span, lo) clamped below
//                    at lo, or f itself where (lo, span) is (0, 1)
//   BERNOULLI        f < p, as bool
//   NORMAL           erf_inv(u) * SQRT2, u uniform on (nextafter(-1, 0), 1)
//   NORMAL_ERF_INV   erf_inv(u), before the factor
//   TRUNCATED        erf_inv(u) * SQRT2, u uniform on (erf(lower / sqrt 2),
//                    erf(upper / sqrt 2)) (the wrapper passes both), clipped
//   RANDINT          two words per value under the two keys of split(key),
//                    reduced modulo the span in uint32 arithmetic, as int64
// Every float step rounds where the plain version rounds: __fmaf_rn where
// prng.py calls fma32, and __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn and
// __fsqrt_rn for every other product, sum, difference, quotient and root.
// Those intrinsics are never contracted into an FMA, and the build has no
// fast-math and no flush-to-zero, so denormals (x * x^2 in log1p's small
// branch) round as on the CPU.
//
// What bounds it on this card: a normal value costs ~200 instructions in
// SASS (threefry's 20 rounds of add, funnel shift and xor with 6 key
// injections, ~55 of them; erf_inv over log1p the rest) and moves only its
// 4-byte store, so it is bound by instruction issue (4 warp instructions a
// clock an SM), not by HBM: the gate's 100.7 M normals write 403 MB (0.12
// ms at 3.35 TB/s) against ~0.6 ms of issue. chip_smoke.py counts the
// instructions of the built loop in its SASS by pipe and states the bound
// from them. The design does nothing beyond that: no shared memory, no
// reuse between values (the hash of one counter shares nothing with the
// next), one pass.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

enum Kind {
  BITS32 = 0,
  BITS64 = 1,
  UNIFORM = 2,
  BERNOULLI = 3,
  NORMAL = 4,
  NORMAL_ERF_INV = 5,
  TRUNCATED = 6,
  RANDINT = 7,
};

// The sampler's scalars, set by the wrapper (core/prng.py::_k5_params).
struct Params {
  uint32_t k0, k1;      // the key
  uint32_t k2, k3;      // RANDINT: the second key of split(key)
  float lo, span;       // UNIFORM, NORMAL*, TRUNCATED: the uniform's range
  int identity;         // (lo, span) == (0, 1): the uniform is f itself
  float p;              // BERNOULLI
  float clip_lo, clip_hi;   // TRUNCATED
  uint32_t range, mult, minval;   // RANDINT
};

__device__ __forceinline__ uint32_t threefry_word(uint32_t k0, uint32_t k1,
                                                  uint32_t counter) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = k0, x1 = counter + k1;
#define TF_ROUND(r)                       \
  x0 += x1;                               \
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
#define TF_ROUNDS_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ROUNDS_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  TF_ROUNDS_A x0 += k1; x1 += k2 + 1u;
  TF_ROUNDS_B x0 += k2; x1 += k0 + 2u;
  TF_ROUNDS_A x0 += k0; x1 += k1 + 3u;
  TF_ROUNDS_B x0 += k1; x1 += k2 + 4u;
  TF_ROUNDS_A x0 += k2; x1 += k0 + 5u;
#undef TF_ROUNDS_B
#undef TF_ROUNDS_A
#undef TF_ROUND
  return x0 ^ x1;
}

// The uniform on [0, 1) from a word's 23 high bits (jax.random._uniform).
__device__ __forceinline__ float unit_float(uint32_t w) {
  return __fsub_rn(__uint_as_float((w >> 9) | 0x3F800000u), 1.0f);
}

__device__ __forceinline__ float uniform_value(uint32_t w, const Params& p) {
  const float f = unit_float(w);
  if (p.identity) return f;
  const float u = __fmaf_rn(f, p.span, p.lo);
  return u < p.lo ? p.lo : u;
}

// XLA's float32 log on the CPU (prng.py::_xla_log), for finite y > 0.
__device__ __forceinline__ float xla_log(float y) {
  y = y < 0x1.0p-126f ? 0x1.0p-126f : y;
  const int ib = __float_as_int(y);
  float e = __fadd_rn((float)((ib >> 23) - 127), 1.0f);
  const float m = __int_as_float((ib & 0x7FFFFF) | 0x3F000000);
  const bool small = m < 0x1.6a09e6p-1f;
  const float x = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  const float z = __fmul_rn(x, x);
  const float x3 = __fmul_rn(z, x);
  const float a = __fmaf_rn(__fmaf_rn(x, 0x1.204376p-4f, -0x1.d7a37p-4f), x,
                            0x1.de4a34p-4f);
  const float b = __fmaf_rn(__fmaf_rn(x, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), x,
                            -0x1.555cap-3f);
  const float c = __fmaf_rn(__fmaf_rn(x, 0x1.999d58p-3f, -0x1.fffff8p-3f), x,
                            0x1.555554p-2f);
  float r = __fmaf_rn(__fmaf_rn(__fmaf_rn(a, x3, b), x3, c), x3,
                      __fmul_rn(e, -0x1.bd0106p-13f));
  r = __fadd_rn(__fsub_rn(x, __fmul_rn(z, 0.5f)), r);
  return __fmaf_rn(e, 0x1.63p-1f, r);
}

// XLA's float32 log1p on the CPU (prng.py::_xla_log1p), for x > -1.
__device__ __forceinline__ float xla_log1p(float x) {
  const float x2 = __fmul_rn(x, x);
  float den = 1.0f;
  den = __fmaf_rn(den, x, 0x1.e2035ap+3f);
  den = __fmaf_rn(den, x, 0x1.4c30b6p+6f);
  den = __fmaf_rn(den, x, 0x1.bb865ap+7f);
  den = __fmaf_rn(den, x, 0x1.351946p+8f);
  den = __fmaf_rn(den, x, 0x1.b0db14p+7f);
  den = __fmaf_rn(den, x, 0x1.e0f304p+5f);
  float num = 0x1.7bc096p-15f;
  num = __fmaf_rn(num, x, 0x1.fe818ap-2f);
  num = __fmaf_rn(num, x, 0x1.a509f4p+2f);
  num = __fmaf_rn(num, x, 0x1.de9738p+4f);
  num = __fmaf_rn(num, x, 0x1.e798ecp+5f);
  num = __fmaf_rn(num, x, 0x1.c8e75ap+5f);
  num = __fmaf_rn(num, x, 0x1.40a202p+4f);
  float small = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den));
  small = __fadd_rn(x, __fsub_rn(small, __fmul_rn(x2, 0.5f)));
  return fabsf(x) < 0x1.a8279ap-2f ? small : xla_log(__fadd_rn(x, 1.0f));
}

// Giles' coefficients of XLA's float32 erf_inv, for w < 5 and w >= 5.
__constant__ float ERFINV_LT5[9] = {
    0x1.e2cb1p-26f,   0x1.70966cp-22f, -0x1.d8e6aep-19f,
    -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a81p-10f,
    -0x1.11c9dep-8f,  0x1.f91ec6p-3f,  0x1.805c5ep+0f};
__constant__ float ERFINV_GE5[9] = {
    -0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
    -0x1.e17bcep-9f,  0x1.7824f6p-8f,  -0x1.f38baep-8f,
    0x1.354afcp-7f,   0x1.006db6p+0f,  0x1.6a9efcp+1f};
#define SQRT2 0x1.6a09e6p+0f

// XLA's float32 erf_inv (prng.py::_erf_inv), for u in (-1, 1).
__device__ __forceinline__ float erf_inv(float u) {
  const float lg = xla_log1p(__fmul_rn(u, -u));
  const bool lt = lg > -5.0f;
  const float w = lt ? __fsub_rn(-2.5f, lg)
                     : __fsub_rn(__fsqrt_rn(-lg), 3.0f);
#define COEF(i) (lt ? ERFINV_LT5[i] : ERFINV_GE5[i])
  float p = __fmaf_rn(COEF(0), w, COEF(1));
#pragma unroll
  for (int i = 2; i < 9; ++i) p = __fmaf_rn(w, p, COEF(i));
#undef COEF
  return __fmul_rn(fabsf(u) == 1.0f ? __int_as_float(0x7F800000) : p, u);
}

template <int KIND>
struct Out {
  using T = float;
};
template <> struct Out<BITS32> { using T = int32_t; };
template <> struct Out<BITS64> { using T = long long; };
template <> struct Out<BERNOULLI> { using T = uint8_t; };
template <> struct Out<RANDINT> { using T = long long; };

__device__ __forceinline__ uint32_t rem(uint32_t a, uint32_t s) {
  return s ? a % s : a;     // XLA's unsigned remainder: a % 0 is a
}

template <int KIND>
__device__ __forceinline__ typename Out<KIND>::T sample(uint32_t w,
                                                        uint32_t i,
                                                        const Params& p) {
  if constexpr (KIND == BITS32) {
    return (int32_t)w;
  } else if constexpr (KIND == BITS64) {
    return (long long)w;
  } else if constexpr (KIND == UNIFORM) {
    return uniform_value(w, p);
  } else if constexpr (KIND == BERNOULLI) {
    return unit_float(w) < p.p ? 1 : 0;
  } else if constexpr (KIND == NORMAL_ERF_INV) {
    return erf_inv(uniform_value(w, p));
  } else if constexpr (KIND == NORMAL) {
    return __fmul_rn(erf_inv(uniform_value(w, p)), SQRT2);
  } else if constexpr (KIND == TRUNCATED) {
    float v = __fmul_rn(erf_inv(uniform_value(w, p)), SQRT2);
    v = v < p.clip_lo ? p.clip_lo : v;
    return v > p.clip_hi ? p.clip_hi : v;
  } else {   // RANDINT: w is the higher word; the lower one hashes i under k2
    const uint32_t lower = threefry_word(p.k2, p.k3, i);
    const uint32_t off = rem(rem(w, p.range) * p.mult + rem(lower, p.range),
                             p.range);
    return (long long)(int32_t)(p.minval + off);
  }
}

// WORDS: sample words[i]; else draw from the counters 0..n-1. One value a
// trip of the grid-stride loop (not unrolled, so that chip_smoke.py reads
// one value's instructions in its SASS).
template <int KIND, bool WORDS>
__global__ void __launch_bounds__(256) prng_kernel(
    typename Out<KIND>::T* __restrict__ out,
    const uint32_t* __restrict__ words, int n, Params p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
#pragma unroll 1
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t w =
        WORDS ? words[i] : threefry_word(p.k0, p.k1, (uint32_t)i);
    out[i] = sample<KIND>(w, (uint32_t)i, p);
  }
}

float host_float(unsigned bits) {
  float f;
  memcpy(&f, &bits, sizeof f);
  return f;
}

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;   // 16 blocks of 8 warps on each SM

template <int KIND>
cudaError_t launch(void* out, const void* words, int n, const Params& p,
                   cudaStream_t stream) {
  const int blocks = (int)(((long long)n + THREADS - 1) / THREADS);
  const int grid = blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS;
  using T = typename Out<KIND>::T;
  if (words) {   // only the normal samplers are fed words
    if constexpr (KIND == NORMAL || KIND == TRUNCATED)
      prng_kernel<KIND, true><<<grid, THREADS, 0, stream>>>(
          (T*)out, (const uint32_t*)words, n, p);
    else
      return cudaErrorInvalidValue;
  } else {
    prng_kernel<KIND, false><<<grid, THREADS, 0, stream>>>(
        (T*)out, nullptr, n, p);
  }
  return cudaGetLastError();
}

}  // namespace

// One draw of n values (n > 0) of the sampler `kind` (Kind above) into
// `out`, from the counters 0..n-1 (words == NULL) or, for NORMAL and
// TRUNCATED, from n words. The float
// parameters come as their float32 bit patterns.
extern "C" int prng_launch(void* out, const void* words, int n, int kind,
                           unsigned k0, unsigned k1, unsigned k2, unsigned k3,
                           unsigned lo, unsigned span, int identity,
                           unsigned prob, unsigned clip_lo, unsigned clip_hi,
                           unsigned range, unsigned mult, unsigned minval,
                           void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.k0 = k0;
  p.k1 = k1;
  p.k2 = k2;
  p.k3 = k3;
  p.lo = host_float(lo);
  p.span = host_float(span);
  p.identity = identity;
  p.p = host_float(prob);
  p.clip_lo = host_float(clip_lo);
  p.clip_hi = host_float(clip_hi);
  p.range = range;
  p.mult = mult;
  p.minval = minval;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case BITS32: return (int)launch<BITS32>(out, words, n, p, st);
    case BITS64: return (int)launch<BITS64>(out, words, n, p, st);
    case UNIFORM: return (int)launch<UNIFORM>(out, words, n, p, st);
    case BERNOULLI: return (int)launch<BERNOULLI>(out, words, n, p, st);
    case NORMAL: return (int)launch<NORMAL>(out, words, n, p, st);
    case NORMAL_ERF_INV:
      return (int)launch<NORMAL_ERF_INV>(out, words, n, p, st);
    case TRUNCATED: return (int)launch<TRUNCATED>(out, words, n, p, st);
    case RANDINT: return (int)launch<RANDINT>(out, words, n, p, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* prng_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
