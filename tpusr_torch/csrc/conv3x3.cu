// 3x3 SAME convolution as an implicit GEMM with a fused epilogue, for sm_90a.
//
// One templated body, three entry points:
//
//   conv3x3_int8_requant_launch  replaces the Pallas kernel
//       tpusr/core/pallas_conv.py::conv3x3_int8_requant (body
//       _conv3x3_gemm_kernel, epilogue _requant_epilogue):
//       int8 x int8 -> int32, then clip(acc * rescale[c] + bias[c], 0, 127)
//       with a truncating int8 cast. Bit-exact with the XLA requant in
//       tpusr/models/quant.py::int8_backbone.
//   conv3x3_bias_act_f32_launch  replaces
//       tpusr/core/pallas_conv.py::conv3x3_bias_act (epilogue
//       _bias_relu_epilogue) for float32: fp32 FMAs (no TF32), + bias,
//       optional ReLU.
//   conv3x3_bias_act_bf16_launch  replaces the same Pallas kernel for
//       bfloat16, with its contract (pallas_conv.py:139-143): bf16 x and
//       kernel, f32 bias, fp32 accumulation, + bias and ReLU in fp32, one
//       round-to-nearest-even cast to bf16 at the store. The products run
//       as fp32 FMAs on the exact fp32 values of the bf16 operands.
//   conv3x3_int8_dequant_launch  has no Pallas counterpart: it replaces the
//       XLA int8 conv of the int8 EDSR (tpusr/models/edsr_quant.py::_qconv
//       and _dequant), int8 x int8 -> int32 with K1's __dp4a body, then
//       f32(acc) * rescale[c], + bias[c] (no FMA contraction) and one
//       round-to-nearest-even cast to bf16.
//
// Layouts are the JAX package's: x (N, H, W, Cin) NHWC, weights
// (3, 3, Cin, Cout) HWIO, which is already the (K = 9*Cin, Cout) GEMM
// operand with k = (ky*3 + kx)*Cin + ci. The GEMM's M index is the flat
// output pixel (n, oh, ow).
//
// What bounds it on this card: at the VGG16 and EDSR widths (Cin, Cout >= 64)
// every instance is compute-bound (arithmetic intensity > 100 op/byte). The
// Pallas kernel ran the GEMM on the MXU; this first Hopper port runs it on the
// CUDA cores (__dp4a for int8, FFMA for fp32 and for bf16 widened to fp32),
// so it sits well below the tensor-core roofline, the bf16 instance furthest
// (its bound is the 989 TFLOP/s bf16 tensor-core rate). The design keeps
// every byte that is not an input or output out of device memory: the
// im2col tile is gathered into shared memory per block (the Pallas version
// padded the whole input in HBM first; here SAME padding is a bounds
// check), and the int32/fp32 accumulators
// never leave registers -- the requant or bias/ReLU epilogue runs before the
// one store. Tensor cores (wgmma, TMA) are later work.
//
// Tiling: a 256-thread block computes a 64-pixel x 64-channel output tile;
// each thread owns a 4x4 sub-tile. The K loop walks the 9 taps x Cin in
// chunks of BK elements. A fast path loads 16-byte vectors when a chunk lies
// inside one tap (Cin % BK == 0) and when Cout % 4 == 0; a generic
// element-wise path covers the rest (Cin = 3 for the first layer, Cout = 3
// for the EDSR tail). A shared-memory word holds PACK consecutive k of one
// pixel or channel: 4 int8 for __dp4a, 2 bf16, or 1 fp32, so every path
// moves 16 words per K chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int NT = 256;  // threads per block
constexpr int APAD = 4;  // row padding of the A tile (keeps 16-byte alignment)

struct Int8Path {
  using T = int8_t;      // element type in HBM
  using Word = int;      // one shared-memory word: 4 consecutive k of int8
  using Acc = int;
  static constexpr int PACK = 4;
  static constexpr int BK = 64;
  __device__ static __forceinline__ Acc mac(Word a, Word b, Acc c) {
    return __dp4a(a, b, c);
  }
};

struct Bf16Path {
  using T = uint16_t;    // the bits of one bf16 in HBM
  using Word = unsigned; // 2 consecutive k: the lower k in the low half
  using Acc = float;
  static constexpr int PACK = 2;
  static constexpr int BK = 32;
  // a bf16 is the upper half of the fp32 with the same value
  __device__ static __forceinline__ Acc mac(Word a, Word b, Acc c) {
    c = __fmaf_rn(__uint_as_float(a << 16), __uint_as_float(b << 16), c);
    return __fmaf_rn(__uint_as_float(a & 0xffff0000u),
                     __uint_as_float(b & 0xffff0000u), c);
  }
};

struct F32Path {
  using T = float;
  using Word = float;
  using Acc = float;
  static constexpr int PACK = 1;
  static constexpr int BK = 16;
  __device__ static __forceinline__ Acc mac(Word a, Word b, Acc c) {
    return __fmaf_rn(a, b, c);
  }
};

// Reinterpret 32 bits as a shared-memory word.
template <class Word>
__device__ __forceinline__ Word from_bits(unsigned u);
template <>
__device__ __forceinline__ int from_bits<int>(unsigned u) { return (int)u; }
template <>
__device__ __forceinline__ unsigned from_bits<unsigned>(unsigned u) {
  return u;
}
template <>
__device__ __forceinline__ float from_bits<float>(unsigned u) {
  return __uint_as_float(u);
}

// Element k of the im2col row of output pixel (n, oh, ow), 0 outside the
// image (SAME zero padding) and past K.
template <class P>
__device__ __forceinline__ typename P::T im2col_elem(
    const typename P::T* __restrict__ x, bool pix_ok, int n, int oh, int ow,
    int k, int K, int H, int W, int Cin) {
  if (!pix_ok || k >= K) return typename P::T(0);
  const int tap = k / Cin, ci = k - tap * Cin;
  const int ih = oh + tap / 3 - 1, iw = ow + tap % 3 - 1;
  if (ih < 0 || ih >= H || iw < 0 || iw >= W) return typename P::T(0);
  return x[(((long long)n * H + ih) * W + iw) * Cin + ci];
}

template <class P>
__device__ __forceinline__ typename P::Word pack_elems(const typename P::T* e) {
  if constexpr (P::PACK == 4) {
    return (int)((uint32_t)(uint8_t)e[0] | ((uint32_t)(uint8_t)e[1] << 8) |
                 ((uint32_t)(uint8_t)e[2] << 16) |
                 ((uint32_t)(uint8_t)e[3] << 24));
  } else if constexpr (P::PACK == 2) {
    return (unsigned)e[0] | ((unsigned)e[1] << 16);
  } else {
    return e[0];
  }
}

template <class P, class Epi>
__global__ void __launch_bounds__(NT)
conv3x3_gemm(const typename P::T* __restrict__ x,
             const typename P::T* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ bias,
             typename Epi::Out* __restrict__ y, int N, int H, int W, int Cin,
             int Cout, int relu) {
  using T = typename P::T;
  using Word = typename P::Word;
  using Acc = typename P::Acc;
  constexpr int BK = P::BK;
  constexpr int BKW = BK / P::PACK;  // 16 words per chunk on both paths
  static_assert(BKW == 16, "loader mappings assume 16 words per K chunk");

  __shared__ __align__(16) Word sA[BKW][BM + APAD];
  __shared__ __align__(16) Word sB[BKW][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long M = (long long)N * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * Cin;
  const bool a_vec = (Cin % BK) == 0;
  const bool b_vec = (Cout % 4) == 0;

  // The A-loader pixel of this thread is fixed over the whole K loop.
  const int a_p = tid / 4, a_q = tid % 4;  // pixel in tile, 16-byte segment
  const long long a_m = m0 + a_p;
  const bool a_ok = a_m < M;
  int a_n = 0, a_oh = 0, a_ow = 0;
  if (a_ok) {
    const long long hw = (long long)H * W;
    a_n = (int)(a_m / hw);
    const int r = (int)(a_m - (long long)a_n * hw);
    a_oh = r / W;
    a_ow = r - a_oh * W;
  }

  Acc acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // ---- A tile: 64 pixels x BK elements, stored as sA[word][pixel] ----
    if (a_vec) {
      // the chunk lies inside one tap: one 16-byte vector per thread
      const int tap = k0 / Cin, c0 = k0 - tap * Cin;
      const int ih = a_oh + tap / 3 - 1, iw = a_ow + tap % 3 - 1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (a_ok && ih >= 0 && ih < H && iw >= 0 && iw < W) {
        const T* src = x + (((long long)a_n * H + ih) * W + iw) * Cin + c0 +
                       a_q * (16 / (int)sizeof(T));
        v = *reinterpret_cast<const uint4*>(src);
      }
      sA[a_q * 4 + 0][a_p] = from_bits<Word>(v.x);
      sA[a_q * 4 + 1][a_p] = from_bits<Word>(v.y);
      sA[a_q * 4 + 2][a_p] = from_bits<Word>(v.z);
      sA[a_q * 4 + 3][a_p] = from_bits<Word>(v.w);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int wi = a_q * 4 + j;
        T e[P::PACK];
#pragma unroll
        for (int b = 0; b < P::PACK; ++b)
          e[b] = im2col_elem<P>(x, a_ok, a_n, a_oh, a_ow, k0 + wi * P::PACK + b,
                                K, H, W, Cin);
        sA[wi][a_p] = pack_elems<P>(e);
      }
    }

    // ---- B tile: BK rows of the (K, Cout) weights x 64 channels ----
    if constexpr (P::PACK == 4) {
      // thread -> 4 rows (k) x 4 channels; a 4x4 byte transpose packs the 4 k
      // of each channel into one dp4a word
      const int g = tid / 16, c4 = tid % 16;
      const int co = n0 + c4 * 4;
      if (b_vec) {
        int r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + g * 4 + i;
          r[i] = (k < K && co < Cout)
                     ? *reinterpret_cast<const int*>(w + (long long)k * Cout + co)
                     : 0;
        }
        const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
        const unsigned t1 = __byte_perm(r[0], r[1], 0x7362);
        const unsigned u0 = __byte_perm(r[2], r[3], 0x5140);
        const unsigned u1 = __byte_perm(r[2], r[3], 0x7362);
        sB[g][c4 * 4 + 0] = (int)__byte_perm(t0, u0, 0x5410);
        sB[g][c4 * 4 + 1] = (int)__byte_perm(t0, u0, 0x7632);
        sB[g][c4 * 4 + 2] = (int)__byte_perm(t1, u1, 0x5410);
        sB[g][c4 * 4 + 3] = (int)__byte_perm(t1, u1, 0x7632);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          T e[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = k0 + g * 4 + i;
            e[i] = (k < K && co + j < Cout) ? w[(long long)k * Cout + co + j]
                                            : T(0);
          }
          sB[g][c4 * 4 + j] = pack_elems<P>(e);
        }
      }
    } else if constexpr (P::PACK == 2) {
      // thread -> 2 rows (k, k+1) x 4 channels, interleaved into one word
      // per channel
      const int g = tid / 16, c4 = tid % 16;
      const int co = n0 + c4 * 4, k = k0 + 2 * g;
      if (b_vec) {
        uint2 r0 = make_uint2(0u, 0u), r1 = make_uint2(0u, 0u);
        if (co < Cout && k < K)
          r0 = *reinterpret_cast<const uint2*>(w + (long long)k * Cout + co);
        if (co < Cout && k + 1 < K)
          r1 = *reinterpret_cast<const uint2*>(w + (long long)(k + 1) * Cout +
                                               co);
        sB[g][c4 * 4 + 0] = __byte_perm(r0.x, r1.x, 0x5410);
        sB[g][c4 * 4 + 1] = __byte_perm(r0.x, r1.x, 0x7632);
        sB[g][c4 * 4 + 2] = __byte_perm(r0.y, r1.y, 0x5410);
        sB[g][c4 * 4 + 3] = __byte_perm(r0.y, r1.y, 0x7632);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          T e[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            e[i] = (k + i < K && co + j < Cout)
                       ? w[(long long)(k + i) * Cout + co + j]
                       : T(0);
          sB[g][c4 * 4 + j] = pack_elems<P>(e);
        }
      }
    } else {
      // thread -> one row (k) x 4 channels
      const int row = tid / 16, c4 = tid % 16;
      const int k = k0 + row, co = n0 + c4 * 4;
      if (b_vec) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k < K && co < Cout)
          v = *reinterpret_cast<const float4*>(w + (long long)k * Cout + co);
        *reinterpret_cast<float4*>(&sB[row][c4 * 4]) = v;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sB[row][c4 * 4 + j] =
              (k < K && co + j < Cout) ? w[(long long)k * Cout + co + j] : 0.f;
      }
    }
    __syncthreads();

    // ---- 64 x 64 x BK product on the tile ----
#pragma unroll
    for (int kw = 0; kw < BKW; ++kw) {
      const uint4 av = *reinterpret_cast<const uint4*>(&sA[kw][ty * 4]);
      const uint4 bv = *reinterpret_cast<const uint4*>(&sB[kw][tx * 4]);
      const Word a[4] = {from_bits<Word>(av.x), from_bits<Word>(av.y),
                         from_bits<Word>(av.z), from_bits<Word>(av.w)};
      const Word b[4] = {from_bits<Word>(bv.x), from_bits<Word>(bv.y),
                         from_bits<Word>(bv.z), from_bits<Word>(bv.w)};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = P::mac(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // ---- fused epilogue: one store per output element ----
  const int co = n0 + tx * 4;
  if (co >= Cout) return;
  float sc[4], bi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sc[j] = (co + j < Cout && scale != nullptr) ? scale[co + j] : 0.f;
    bi[j] = (co + j < Cout) ? bias[co + j] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) break;
    typename Epi::Out o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = Epi::apply(acc[i][j], sc[j], bi[j], relu);
    typename Epi::Out* dst = y + m * Cout + co;
    if (b_vec) {
      Epi::store4(dst, o);
    } else {
      for (int j = 0; j < 4 && co + j < Cout; ++j) dst[j] = o[j];
    }
  }
}

struct RequantEpi {
  using Out = int8_t;
  // quant.py:112-115 arithmetic, rounded step by step: f32(acc) * rescale,
  // then + bias (no FMA contraction), clip to [0, 127], truncating cast.
  __device__ static __forceinline__ Out apply(int acc, float rs, float b, int) {
    float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), rs), b);
    v = fminf(fmaxf(v, 0.f), 127.f);
    return (Out)__float2int_rz(v);
  }
  __device__ static __forceinline__ void store4(Out* dst, const Out* o) {
    const uint32_t packed = (uint32_t)(uint8_t)o[0] |
                            ((uint32_t)(uint8_t)o[1] << 8) |
                            ((uint32_t)(uint8_t)o[2] << 16) |
                            ((uint32_t)(uint8_t)o[3] << 24);
    *reinterpret_cast<uint32_t*>(dst) = packed;
  }
};

struct DequantBf16Epi {
  using Out = uint16_t;
  // edsr_quant.py:141-143: f32(acc) * rescale, then + bias, then to bf16
  __device__ static __forceinline__ Out apply(int acc, float rs, float b, int) {
    const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), rs), b);
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static __forceinline__ void store4(Out* dst, const Out* o) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2((unsigned)o[0] | ((unsigned)o[1] << 16),
                   (unsigned)o[2] | ((unsigned)o[3] << 16));
  }
};

struct BiasActEpi {
  using Out = float;
  __device__ static __forceinline__ Out apply(float acc, float, float b,
                                              int relu) {
    const float v = __fadd_rn(acc, b);
    return relu ? fmaxf(v, 0.f) : v;
  }
  __device__ static __forceinline__ void store4(Out* dst, const Out* o) {
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  }
};

struct BiasActBf16Epi {
  using Out = uint16_t;
  __device__ static __forceinline__ Out apply(float acc, float, float b,
                                              int relu) {
    float v = __fadd_rn(acc, b);
    if (relu) v = fmaxf(v, 0.f);
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static __forceinline__ void store4(Out* dst, const Out* o) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2((unsigned)o[0] | ((unsigned)o[1] << 16),
                   (unsigned)o[2] | ((unsigned)o[3] << 16));
  }
};

dim3 grid_for(int N, int H, int W, int Cout) {
  const long long M = (long long)N * H * W;
  return dim3((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
}

}  // namespace

extern "C" int conv3x3_int8_requant_launch(const void* x, const void* w,
                                           const void* rescale,
                                           const void* bias, void* y, int N,
                                           int H, int W, int Cin, int Cout,
                                           void* stream) {
  conv3x3_gemm<Int8Path, RequantEpi>
      <<<grid_for(N, H, W, Cout), NT, 0, (cudaStream_t)stream>>>(
          (const int8_t*)x, (const int8_t*)w, (const float*)rescale,
          (const float*)bias, (int8_t*)y, N, H, W, Cin, Cout, 0);
  return (int)cudaGetLastError();
}

extern "C" int conv3x3_int8_dequant_launch(const void* x, const void* w,
                                           const void* rescale,
                                           const void* bias, void* y, int N,
                                           int H, int W, int Cin, int Cout,
                                           void* stream) {
  conv3x3_gemm<Int8Path, DequantBf16Epi>
      <<<grid_for(N, H, W, Cout), NT, 0, (cudaStream_t)stream>>>(
          (const int8_t*)x, (const int8_t*)w, (const float*)rescale,
          (const float*)bias, (uint16_t*)y, N, H, W, Cin, Cout, 0);
  return (int)cudaGetLastError();
}

extern "C" int conv3x3_bias_act_f32_launch(const void* x, const void* w,
                                           const void* bias, void* y, int N,
                                           int H, int W, int Cin, int Cout,
                                           int relu, void* stream) {
  conv3x3_gemm<F32Path, BiasActEpi>
      <<<grid_for(N, H, W, Cout), NT, 0, (cudaStream_t)stream>>>(
          (const float*)x, (const float*)w, nullptr, (const float*)bias,
          (float*)y, N, H, W, Cin, Cout, relu);
  return (int)cudaGetLastError();
}

extern "C" int conv3x3_bias_act_bf16_launch(const void* x, const void* w,
                                            const void* bias, void* y, int N,
                                            int H, int W, int Cin, int Cout,
                                            int relu, void* stream) {
  conv3x3_gemm<Bf16Path, BiasActBf16Epi>
      <<<grid_for(N, H, W, Cout), NT, 0, (cudaStream_t)stream>>>(
          (const uint16_t*)x, (const uint16_t*)w, nullptr, (const float*)bias,
          (uint16_t*)y, N, H, W, Cin, Cout, relu);
  return (int)cudaGetLastError();
}

extern "C" const char* conv3x3_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
