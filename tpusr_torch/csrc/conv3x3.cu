// 3x3 SAME int8 convolution as an implicit GEMM on Hopper's int8 tensor
// cores (wgmma), with a fused epilogue, for sm_90a. K2 (the float
// conv3x3_bias_act) lives in conv3x3_bias_act.cu.
//
// One templated body, two entry points:
//
//   conv3x3_int8_requant_launch  replaces the Pallas kernel
//       tpusr/core/pallas_conv.py::conv3x3_int8_requant (body
//       _conv3x3_gemm_kernel, epilogue _requant_epilogue):
//       int8 x int8 -> int32, then clip(acc * rescale[c] + bias[c], 0, 127)
//       with a truncating int8 cast. Bit-exact with the XLA requant in
//       tpusr/models/quant.py::int8_backbone.
//   conv3x3_int8_dequant_launch  has no Pallas counterpart: it replaces the
//       XLA int8 conv of the int8 EDSR (tpusr/models/edsr_quant.py::_qconv
//       and _dequant), int8 x int8 -> int32, then f32(acc) * rescale[c],
//       + bias[c] (no FMA contraction) and one round-to-nearest-even cast to
//       bf16.
//
// Layouts: x (N, H, W, Cin) NHWC int8. The weights come packed K-major,
// (Cout_p, K_p) int8 with row co = output channel co and column
// k = (ky*3 + kx)*Cin + ci, zero-padded to Cout_p = Cout rounded up to 64 and
// K_p = 9*Cin rounded up to 128 (tpusr_torch/core/conv3x3.py::
// pack_int8_kernel): int8 wgmma takes both operands K-major only, and HWIO
// rows are Cout-contiguous. The GEMM's M index is the flat output pixel
// (n, oh, ow); a tile of M may cross image boundaries (the 6x6 and 12x12
// patch layers would waste most of a spatial tile).
//
// What bounds it on this card: every VGG16 conv from b1c2 on does 576 to
// over 2000 int8 operations per byte it must move, at or above the H100's
// int8 balance (1979 TOP/s over 3.35 TB/s, ~591), so the tensor cores are
// the limit; the Cin = 3 first layers (VGG b1c1, the EDSR head; K = 27) and
// the 64 -> 64 convs at 128^2 are bound by their bytes, mostly the output.
// The design:
//   - a 256-thread block is two warpgroups and owns 128 pixels x BN
//     channels (BN = 128 when Cout % 128 == 0, else 64); each warpgroup
//     issues wgmma.mma_async.m64nBNk32.s32.s8.s8 on its 64 rows, both
//     operands read from shared memory through 128-byte-swizzle
//     descriptors;
//   - K runs in chunks of 128 bytes (one swizzle row) through a 3-stage
//     ring, three blocks per SM at BN = 64 and two at BN = 128; the copies
//     of chunk c + 2 are issued right after chunk c's products, so they
//     overlap them. A partial last chunk is zero-filled, not skipped: a
//     branch between two wgmma makes ptxas serialize them;
//   - A, the im2col rows, is gathered into shared memory, never into device
//     memory: with Cin % 16 == 0 each 16-byte segment of a row lies inside
//     one tap and comes by cp.async (the zero-fill form for SAME padding,
//     rows past M and k past K); any other Cin by an element-wise gather.
//     B, the packed weights, comes by cp.async. Rows land in the swizzled
//     layout the descriptors name: 16-byte unit u of row r at u ^ (r % 8);
//   - Cin = 3 has a kernel of its own (conv3x3_int8_narrow): one k32 step,
//     a gather with compile-time offsets, four blocks per SM;
//   - the epilogue runs on the accumulator fragments (per-column scale and
//     bias, copied to shared memory with the first chunk), stages the int8
//     or bf16 tile through shared memory and stores each output row as
//     16-byte writes.
// No split-K and no atomics: each output's int32 sum is exact, and the
// tile is chosen by shape alone, never by N.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int NT = 256;         // threads per block: two warpgroups
constexpr int BM = 128;         // output pixels per block, 64 per warpgroup
constexpr int BK = 128;         // k (bytes) per chunk: one 128-byte row
constexpr int A_BYTES = BM * BK;
constexpr int K_ALIGN = 128;    // padding of the packed weights: K_p
constexpr int MMA_K = 32;       // k per wgmma

// BN = 64: three blocks of ~74 KB per SM; BN = 128: two of ~98 KB.
template <int BN>
struct Tile {
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK;
  static constexpr int STAGES = 3;
  static constexpr int MIN_BLOCKS = BN == 64 ? 3 : 2;
  static constexpr int RING = STAGES * STAGE_BYTES;
  // + the block's scale and bias columns; + 1024: the ring starts on a
  // 1024-byte boundary (the swizzle atom)
  static constexpr int SMEM = RING + 2 * BN * 4 + 1024;
};

// 4-byte global -> shared copy (scale and bias columns); src_bytes 0 writes
// a zero.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Columns n0 .. n0 + BN - 1 of scale and bias into shared memory at `dst`
// (scale, then bias), zeros past Cout; part of the caller's next cp.async
// group.
template <int BN>
__device__ __forceinline__ void load_columns(uint32_t dst,
                                             const float* __restrict__ scale,
                                             const float* __restrict__ bias,
                                             int n0, int Cout) {
  for (int i = threadIdx.x; i < 2 * BN; i += NT) {
    const int c = n0 + i % BN;
    const bool ok = c < Cout;
    cp_async4(dst + 4 * i, ok ? (i < BN ? scale : bias) + c : scale,
              ok ? 4 : 0);
  }
}

// Byte offset of 16-byte unit u of row r in a 128-byte-swizzled tile.
__device__ __forceinline__ uint32_t swz(int r, int u) {
  return (uint32_t)(r * 128 + ((u ^ (r & 7)) << 4));
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled tile at
// shared address `saddr`: rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4)   // start address
         | ((uint64_t)1 << 16)                // leading offset (unused)
         | ((uint64_t)(1024 >> 4) << 32)      // stride offset: 8 rows
         | ((uint64_t)1 << 62);               // 128-byte swizzle
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across a
// wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x N, int32, the warpgroup's fragments) += A (64 x 32) * B (32 x N),
// int8, both operands K-major in shared memory.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void run(int (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void run(int (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

struct RequantEpi {
  using Out = int8_t;
  using Pair = uint16_t;
  // quant.py:112-115 arithmetic, rounded step by step: f32(acc) * rescale,
  // then + bias (no FMA contraction), clip to [0, 127], truncating cast.
  __device__ static __forceinline__ uint32_t one(int acc, float rs, float b) {
    float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), rs), b);
    v = fminf(fmaxf(v, 0.f), 127.f);
    return (uint32_t)(uint8_t)__float2int_rz(v);
  }
  __device__ static __forceinline__ Pair pair(int a0, int a1, float rs0,
                                              float rs1, float b0, float b1) {
    return (Pair)(one(a0, rs0, b0) | (one(a1, rs1, b1) << 8));
  }
};

struct DequantBf16Epi {
  using Out = uint16_t;
  using Pair = uint32_t;
  // edsr_quant.py:141-143: f32(acc) * rescale, then + bias, then to bf16
  __device__ static __forceinline__ uint32_t one(int acc, float rs, float b) {
    const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), rs), b);
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static __forceinline__ Pair pair(int a0, int a1, float rs0,
                                              float rs1, float b0, float b1) {
    return one(a0, rs0, b0) | (one(a1, rs1, b1) << 16);
  }
};

// The block's 128 x BN output tile from the two warpgroups' accumulator
// fragments: scale and bias per column (Epi; `cols` holds the block's scale
// then bias columns in shared memory), staged in shared memory at `tile`
// (free when called), then stored as 16-byte units of output rows.
template <int BN, class Epi>
__device__ __forceinline__ void store_tile(const int (&acc)[BN / 2],
                                           unsigned char* tile,
                                           const float* cols,
                                           typename Epi::Out* __restrict__ y,
                                           int M, int Cout, int m0, int n0) {
  using Out = typename Epi::Out;
  constexpr int PITCH = BN * (int)sizeof(Out) + 16;  // bytes; staggers banks
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = (tid >> 7) * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    const float s0 = cols[col], s1 = cols[col + 1];
    const float b0 = cols[BN + col], b1 = cols[BN + col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<typename Epi::Pair*>(
          tile + (r0 + 8 * h) * PITCH + col * (int)sizeof(Out)) =
          Epi::pair(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], s0, s1, b0,
                    b1);
  }
  __syncthreads();
  constexpr int EPU = 16 / (int)sizeof(Out);  // outputs per 16-byte unit
  constexpr int UNITS = BN / EPU;
  const bool vec_out = Cout % EPU == 0;
  for (int idx = tid; idx < BM * UNITS; idx += NT) {
    const int r = idx / UNITS, u = idx % UNITS;
    const int m = m0 + r, co = n0 + u * EPU;
    if (m >= M || co >= Cout) continue;
    const unsigned char* src = tile + r * PITCH + u * 16;
    Out* dst = y + (long long)m * Cout + co;
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < EPU && co + e < Cout; ++e)
        dst[e] = reinterpret_cast<const Out*>(src)[e];
    }
  }
}

// The four A rows a thread fills: rows tid/8 + 32*i of the tile, 16-byte
// unit tid%8 of each. A pixel past M gets an oh that fails every bounds
// check.
struct ARows {
  int base[4];  // element offset of pixel (n, oh, ow, 0) in x
  int oh[4], ow[4];
};

template <int BN, bool VEC, class Epi>
__global__ void __launch_bounds__(NT, Tile<BN>::MIN_BLOCKS)
conv3x3_int8_wgmma(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   typename Epi::Out* __restrict__ y, int N, int H, int W,
                   int Cin, int Cout) {
  using Tl = Tile<BN>;
  constexpr int S = Tl::STAGES;
  extern __shared__ unsigned char dsmem[];
  const uint32_t ring = (smem_u32(dsmem) + 1023u) & ~1023u;
  unsigned char* const ring_ptr = dsmem + (ring - smem_u32(dsmem));

  const int M = N * H * W, K = 9 * Cin;
  const int nchunks = (K + K_ALIGN - 1) / K_ALIGN;
  const int Kp = nchunks * BK;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, unit = tid & 7, row = tid >> 3;

  ARows rows;
  {
    const int hw = H * W;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + row + 32 * i;
      if (m < M) {
        const int n = m / hw, rem = m - n * hw;
        rows.oh[i] = rem / W;
        rows.ow[i] = rem - rows.oh[i] * W;
        rows.base[i] = m * Cin;
      } else {
        rows.oh[i] = -4;  // every tap's ih < 0
        rows.ow[i] = 0;
        rows.base[i] = 0;
      }
    }
  }

  // Chunk c into stage c % S: A rows (im2col, zeros past K) and B rows
  // (packed weights, zero-padded to K_p). Every product runs on the whole
  // chunk: a partial last chunk costs zero products, not a branch between
  // two wgmma (which makes ptxas serialize them).
  auto load = [&](int c) {
    const uint32_t sA = ring + (c % S) * Tl::STAGE_BYTES, sB = sA + A_BYTES;
    const int k = c * BK + unit * 16;
    if constexpr (VEC) {  // Cin % 16 == 0: the unit lies inside one tap
      const bool kin = k < K;
      const int tap = kin ? k / Cin : 0, ci = k - tap * Cin;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const int off = (dy * W + dx) * Cin + ci;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ih = rows.oh[i] + dy, iw = rows.ow[i] + dx;
        const bool ok = kin && ih >= 0 && ih < H && iw >= 0 && iw < W;
        cp_async16(sA + swz(row + 32 * i, unit),
                   ok ? x + rows.base[i] + off : x, ok ? 16 : 0);
      }
    } else {  // element-wise: walk 16 consecutive k, tap and ci by increment
      uint32_t v[4][4] = {};
      int kk = k, tap = k / Cin, ci = k - tap * Cin;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (kk < K) {
          const int dy = tap / 3 - 1, dx = tap % 3 - 1;
          const int off = (dy * W + dx) * Cin + ci;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ih = rows.oh[i] + dy, iw = rows.ow[i] + dx;
            if (ih >= 0 && ih < H && iw >= 0 && iw < W)
              v[i][j / 4] |= (uint32_t)(uint8_t)x[rows.base[i] + off]
                             << (8 * (j % 4));
          }
        }
        ++kk;
        if (++ci == Cin) {
          ci = 0;
          ++tap;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint4*>(ring_ptr + (sA - ring) +
                                  swz(row + 32 * i, unit)) =
            make_uint4(v[i][0], v[i][1], v[i][2], v[i][3]);
    }
#pragma unroll
    for (int i = 0; i < BN / 32; ++i)
      cp_async16(sB + swz(row + 32 * i, unit),
                 wp + (long long)(n0 + row + 32 * i) * Kp + k, 16);
  };

  const int wg = tid / 128;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  load_columns<BN>(ring + Tl::RING, scale, bias, n0, Cout);  // with chunk 0
#pragma unroll
  for (int c = 0; c < S - 1; ++c) {
    if (c < nchunks) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<S - 2>();
    fence_proxy_async();  // this thread's copies and stores, to wgmma
    __syncthreads();      // chunk c landed; every product of c - 1 is done
    const uint32_t sA = ring + (c % S) * Tl::STAGE_BYTES;
    const uint64_t da = sw128_desc(sA + wg * 64 * BK);
    const uint64_t db = sw128_desc(sA + A_BYTES);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / MMA_K; ++ks)  // +2: 32 bytes in 16-byte units
      Wgmma<BN>::run(acc, da + 2 * ks, db + 2 * ks);
    wgmma_commit();
    if (c + S - 1 < nchunks) load(c + S - 1);  // overlaps the products
    cp_async_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the output tile in it
  store_tile<BN, Epi>(acc, ring_ptr,
                      reinterpret_cast<const float*>(ring_ptr + Tl::RING), y,
                      M, Cout, m0, n0);
}

// Cin = 3 (K = 27: the first VGG16 conv and the int8 EDSR head) is bound
// by its bytes, the 64-channel output above all, so nothing is spent on K:
// one k32 step per warpgroup; thread t gathers 16 of pixel t/2's 32 k
// (zeros past k = 27) with every tap and channel offset known at compile
// time, the 64 x 32 weights come by cp.async; one ~25 KB stage, four
// blocks per SM to hide the gather's latency. BN = 64.
constexpr int NARROW_COLS = A_BYTES + 64 * BK;  // scale and bias columns
constexpr int NARROW_SMEM = NARROW_COLS + 2 * 64 * 4 + 1024;

// k = 16*U .. 16*U + 15 of the im2col row of the pixel at `px` (x + m*3),
// packed 4 per word; `rok`/`cok`: rows oh-1, oh, oh+1 / columns ow-1, ow,
// ow+1 inside the image.
template <int U>
__device__ __forceinline__ uint4 gather_cin3(const int8_t* __restrict__ px,
                                             int W, const bool (&rok)[3],
                                             const bool (&cok)[3]) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int k = 16 * U + j, tap = k / 3, ci = k % 3;
    if (k < 27 && rok[tap / 3] && cok[tap % 3])
      v[j / 4] |= (uint32_t)(uint8_t)px[((tap / 3 - 1) * W + tap % 3 - 1) * 3 +
                                        ci]
                  << (8 * (j % 4));
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

template <class Epi>
__global__ void __launch_bounds__(NT, 4)
conv3x3_int8_narrow(const int8_t* __restrict__ x,
                    const int8_t* __restrict__ wp,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    typename Epi::Out* __restrict__ y, int N, int H, int W,
                    int Cout) {
  extern __shared__ unsigned char dsmem[];
  const uint32_t sA = (smem_u32(dsmem) + 1023u) & ~1023u, sB = sA + A_BYTES;
  unsigned char* const tile = dsmem + (sA - smem_u32(dsmem));
  const int M = N * H * W;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * 64;
  const int tid = threadIdx.x, r = tid >> 1, u = tid & 1;
  if (tid < 128)  // packed rows n0 .. n0 + 63, k 0 .. 31 (K_p = 128)
    cp_async16(sB + swz(r, u), wp + (long long)(n0 + r) * K_ALIGN + u * 16,
               16);
  load_columns<64>(sA + NARROW_COLS, scale, bias, n0, Cout);
  cp_async_commit();

  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  const int m = m0 + r;
  if (m < M) {
    const int hw = H * W, rem = m - (m / hw) * hw;
    const int oh = rem / W, ow = rem - oh * W;
    const bool rok[3] = {oh > 0, true, oh + 1 < H};
    const bool cok[3] = {ow > 0, true, ow + 1 < W};
    v = u == 0 ? gather_cin3<0>(x + m * 3, W, rok, cok)
               : gather_cin3<1>(x + m * 3, W, rok, cok);
  }
  *reinterpret_cast<uint4*>(tile + swz(r, u)) = v;
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  int acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  fence_acc(acc);
  wgmma_fence();
  Wgmma<64>::run(acc, sw128_desc(sA + (tid >> 7) * 64 * BK), sw128_desc(sB));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  __syncthreads();  // every product is done: stage the output over A
  store_tile<64, Epi>(acc, tile,
                      reinterpret_cast<const float*>(tile + NARROW_COLS), y, M,
                      Cout, m0, n0);
}

// Launch with `smem` bytes of dynamic shared memory, raising the kernel's
// limit above the default 48 KB.
template <class... Params, class... Args>
int launch_dyn(void (*kernel)(Params...), dim3 grid, int smem,
               cudaStream_t stream, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, NT, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// One dispatch, by shape alone: the narrow kernel when Cin = 3; else
// BN = 128 when Cout % 128 == 0, else 64, with the cp.async A loader when
// Cin % 16 == 0, else the element-wise gather.
template <class Epi>
int launch(const void* x, const void* wp, const void* scale, const void* bias,
           void* y, int N, int H, int W, int Cin, int Cout, void* stream) {
  using Out = typename Epi::Out;
  const long long M = (long long)N * H * W;
  const unsigned gm = (unsigned)((M + BM - 1) / BM);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = Cin % 16 == 0;
  const int8_t *xq = (const int8_t*)x, *wq = (const int8_t*)wp;
  const float *sc = (const float*)scale, *bi = (const float*)bias;
  Out* yo = (Out*)y;
  if (Cin == 3)
    return launch_dyn(conv3x3_int8_narrow<Epi>, dim3(gm, (Cout + 63) / 64),
                      NARROW_SMEM, s, xq, wq, sc, bi, yo, N, H, W, Cout);
  if (Cout % 128 == 0) {
    const dim3 grid(gm, Cout / 128);
    return vec ? launch_dyn(conv3x3_int8_wgmma<128, true, Epi>, grid,
                            Tile<128>::SMEM, s, xq, wq, sc, bi, yo, N, H, W,
                            Cin, Cout)
               : launch_dyn(conv3x3_int8_wgmma<128, false, Epi>, grid,
                            Tile<128>::SMEM, s, xq, wq, sc, bi, yo, N, H, W,
                            Cin, Cout);
  }
  const dim3 grid(gm, (Cout + 63) / 64);
  return vec ? launch_dyn(conv3x3_int8_wgmma<64, true, Epi>, grid,
                          Tile<64>::SMEM, s, xq, wq, sc, bi, yo, N, H, W, Cin,
                          Cout)
             : launch_dyn(conv3x3_int8_wgmma<64, false, Epi>, grid,
                          Tile<64>::SMEM, s, xq, wq, sc, bi, yo, N, H, W, Cin,
                          Cout);
}

}  // namespace

// x, y: N*H*W*C < 2^31 elements; wp: the packed (Cout_p, K_p) weights (the
// wrapper checks both).
extern "C" int conv3x3_int8_requant_launch(const void* x, const void* wp,
                                           const void* rescale,
                                           const void* bias, void* y, int N,
                                           int H, int W, int Cin, int Cout,
                                           void* stream) {
  return launch<RequantEpi>(x, wp, rescale, bias, y, N, H, W, Cin, Cout,
                            stream);
}

extern "C" int conv3x3_int8_dequant_launch(const void* x, const void* wp,
                                           const void* rescale,
                                           const void* bias, void* y, int N,
                                           int H, int W, int Cin, int Cout,
                                           void* stream) {
  return launch<DequantBf16Epi>(x, wp, rescale, bias, y, N, H, W, Cin, Cout,
                                stream);
}

extern "C" const char* conv3x3_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
