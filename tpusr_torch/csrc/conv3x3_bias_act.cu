// K2: 3x3 SAME float convolution + f32 bias (+ ReLU), for sm_90a.
//
// Replaces the Pallas kernel tpusr/core/pallas_conv.py::conv3x3_bias_act
// (epilogue _bias_relu_epilogue) in both of its dtypes, with its contract:
// fp32 accumulation, + bias and optional ReLU in fp32, one cast to x's
// dtype. Layouts are the JAX package's: x (N, H, W, Cin) NHWC, weights
// (3, 3, Cin, Cout) HWIO, which is already the (K = 9*Cin, Cout) row-major
// GEMM operand with k = (ky*3 + kx)*Cin + ci. The GEMM's M index is the flat
// output pixel (n, oh, ow); SAME padding is a bounds check in the gather.
//
// What bounds each instance on this card, and what the design does:
//
//   bf16 (conv3x3_bias_act_bf16_launch). At the EDSR widths the bytes bound
//   (each input read once, the output written once at 3.35 TB/s) is the
//   larger, the bf16 tensor-core operations bound (989 TFLOP/s) just under
//   it. So the products run on the tensor cores,
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with fragments from
//   ldmatrix, and the design keeps the input from crossing L2 once per tap.
//   The main kernel (conv3x3_bias_act_bf16_halo) keeps the block's whole
//   (9*Cin, BN) weight slice resident in shared memory (72 KB at Cin = 64,
//   BN = 64), walks output tiles of 8 x 16 (or 16 x 8) pixels of one image
//   on a persistent grid of two blocks per SM, copies each tile's 10 x 18 x
//   Cin input halo once by cp.async (the zero-fill form, src-size 0, for
//   SAME padding) and feeds all 9 taps from it: ldmatrix takes one row
//   address per lane, so tap (ky, kx) is the same fragment load on pixel
//   rows shifted by ky*(TW+2) + kx. The weights come from the HWIO rows as
//   they are and reach the mma by ldmatrix.trans, so they need no repack.
//   BN = 64 (8 warps of 32 x 32; Cout = 256 takes 4 N tiles on blockIdx.y)
//   or 8 for Cout <= 8 (8 warps of 16 x 8: the 3-channel tail uses 3 of 8
//   columns, not 3 of 64). Rows are padded to an odd number of 16-byte
//   units (pixel 144 bytes, weight row 144 or 48), so the 8 row addresses
//   of every ldmatrix phase fall in 8 different bank groups. A general
//   kernel (conv3x3_bias_act_bf16) covers Cin % 16 != 0 (the Cin = 3 head):
//   128 pixels x 64 channels per block, K in chunks of 32 through a 3-stage
//   cp.async ring of A (im2col rows) and B chunks. The tensor cores sum the exact
//   products in fp32 in their own order (not the f32 kernel's), so the bf16
//   output is held to its twin by a derived bound (chip_smoke.py
//   k2_bf16_tolerance), not bit for bit.
//
//   f32 (conv3x3_bias_act_f32_launch). "f32 means fp32 math": no TF32, no
//   split-precision tensor-core product, so the bound is the fp32 FFMA rate
//   (67 TFLOP/s) and the design removes what keeps the FFMA pipes waiting.
//   A 128-thread block owns 128 pixels x 64 channels, each thread an 8 x 8
//   register tile (64 accumulators; per k, 4 shared-memory loads of 16 bytes
//   feed 64 FFMAs). K runs in chunks of 16 floats; A and B chunks come by
//   cp.async into a 3-stage ring, so the next chunks' gather overlaps this
//   chunk's FFMAs.
//
//   f32, Cout <= 8 (conv3x3_narrow_f32): the 3-channel EDSR tail is bound
//   by reading its input (58.7 MB for 0.8 GFLOP per slab). A GEMM tile of
//   64 channels would waste 61 of them, and a per-pixel gather reads the
//   input 9 times through L2. Here a block owns 512 pixels of one image and
//   the whole (9*Cin, 4 or 8) weight matrix, and brings the input through
//   shared memory as a halo in chunks of 16 channels, read as float4.
//
// One dispatch, by shape alone, in the launchers below:
//   bf16: the halo kernel if Cin % 16 == 0 and its shared memory fits two
//         blocks per SM, with BN = 8 if Cout <= 8 else 64, and TW = 16 if
//         W > 8 else 8; otherwise the general kernel;
//   f32:  the narrow kernel if Cout <= 8, Cin % 16 == 0 and its shared
//         memory fits 96 KB; otherwise the GEMM (Cout > 64: several N
//         tiles on blockIdx.y);
//   in the two general GEMMs, the A chunk comes by 16-byte cp.async when a
//   chunk lies inside one tap (Cin a multiple of the chunk: 32 bf16 or 16
//   f32), else by an element-wise loader that walks k with one division per
//   16 bytes (Cin = 3 for the EDSR head: K = 27, padded with zeros to 32);
//   the B chunk by 16-byte cp.async when Cout is a multiple of 16 bytes,
//   else element-wise. No choice depends on N.
//
// Numerics every path keeps: each output's sum runs over k in one fixed
// order that depends on neither N, the tile the pixel lands in, nor the
// grid (no split-K, no atomics), so an image's output does not depend on
// the batch around it. The f32 paths sum with __fmaf_rn, the GEMM in k
// order, the narrow kernel by 16-channel chunk, then tap. The epilogue adds
// the bias with __fadd_rn, takes the ReLU and rounds once (to bf16
// round-to-nearest-even, or not at all for f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int NT = 128;      // threads per GEMM block
constexpr int BM = 128;      // output pixels per GEMM block
constexpr int STAGES = 3;    // cp.async ring depth
constexpr int ROW_BYTES = 64;         // one A row of one K chunk
constexpr int A_PITCH_BYTES = 80;     // padded: 5 x 16 bytes (odd)
constexpr int A_SEGS = ROW_BYTES / 16;  // 16-byte segments per A row

// The 4 output pixels whose A rows one thread gathers: rows tid/4 + 32*i of
// the tile, 16-byte segment tid%4 of each. A pixel past M gets an oh that
// fails every bounds check.
struct ARows {
  int base[4];  // element offset of pixel (n, oh, ow, 0) in x
  int oh[4], ow[4];
};

__device__ __forceinline__ ARows a_rows(long long m0, int M, int H, int W,
                                        int Cin) {
  ARows r;
  const int hw = H * W;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + threadIdx.x / A_SEGS + 32 * i;
    if (m < M) {
      const int n = (int)(m / hw), rem = (int)(m - (long long)n * hw);
      r.oh[i] = rem / W;
      r.ow[i] = rem - r.oh[i] * W;
      r.base[i] = (int)m * Cin;
    } else {
      r.oh[i] = -4;  // every tap's ih < 0
      r.ow[i] = 0;
      r.base[i] = 0;
    }
  }
  return r;
}

// One K chunk of A (BM pixels x ROW_BYTES) into sA[row][A_PITCH_BYTES].
// T is the element type (uint16_t: the bits of a bf16); a chunk holds
// E = ROW_BYTES / sizeof(T) k values, chunk c covers k = c*E .. c*E + E - 1.
template <class T>
__device__ __forceinline__ void load_a(unsigned char* sA, const T* __restrict__ x,
                                       const ARows& r, int c, bool vec, int H,
                                       int W, int Cin) {
  constexpr int E = ROW_BYTES / (int)sizeof(T);   // k per chunk
  constexpr int SE = 16 / (int)sizeof(T);         // k per 16-byte segment
  const int seg = threadIdx.x % A_SEGS;
  const int K = 9 * Cin;
  if (vec) {  // Cin % E == 0: the chunk lies inside one tap
    const int k0 = c * E, tap = k0 / Cin, c0 = k0 - tap * Cin;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int off = (dy * W + dx) * Cin + c0 + seg * SE;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ih = r.oh[i] + dy, iw = r.ow[i] + dx;
      const bool ok = ih >= 0 && ih < H && iw >= 0 && iw < W;
      const T* src = ok ? x + r.base[i] + off : x;
      unsigned char* dst =
          sA + (threadIdx.x / A_SEGS + 32 * i) * A_PITCH_BYTES + seg * 16;
      cp_async16(dst, src, ok ? 16 : 0);
    }
  } else {  // element-wise: walk SE consecutive k, one division per segment
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int k = c * E + seg * SE;
      int tap = k / Cin, ci = k - tap * Cin;
      union {
        T e[SE];
        uint4 v;
      } u;
#pragma unroll
      for (int j = 0; j < SE; ++j) {
        T v = T(0);
        if (k < K) {
          const int ih = r.oh[i] + tap / 3 - 1, iw = r.ow[i] + tap % 3 - 1;
          if (ih >= 0 && ih < H && iw >= 0 && iw < W)
            v = x[r.base[i] + ((tap / 3 - 1) * W + (tap % 3 - 1)) * Cin + ci];
        }
        u.e[j] = v;
        ++k;
        if (++ci == Cin) {
          ci = 0;
          ++tap;
        }
      }
      *reinterpret_cast<uint4*>(
          sA + (threadIdx.x / A_SEGS + 32 * i) * A_PITCH_BYTES + seg * 16) = u.v;
    }
  }
}

// One K chunk of B: rows k0 .. k0 + BK - 1 of the (K, Cout) weights, columns
// n0 .. n0 + BN - 1, into sB[k][PITCH] (elements); zeros past K and Cout.
template <class T, int BK, int BN, int PITCH>
__device__ __forceinline__ void load_b(T* sB, const T* __restrict__ w, int k0,
                                       int n0, bool vec, int K, int Cout) {
  constexpr int SE = 16 / (int)sizeof(T);
  constexpr int SEGS = BN / SE;  // 16-byte segments per B row
  if (vec) {  // Cout % SE == 0: a segment is all inside Cout or all out
    for (int idx = threadIdx.x; idx < BK * SEGS; idx += NT) {
      const int r = idx / SEGS, s = idx % SEGS;
      const int k = k0 + r, col = n0 + s * SE;
      const bool ok = k < K && col < Cout;
      cp_async16(sB + r * PITCH + s * SE,
                 ok ? w + (long long)k * Cout + col : w, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < BK * BN; idx += NT) {
      const int r = idx / BN, col = idx % BN;
      const int k = k0 + r, co = n0 + col;
      sB[r * PITCH + col] =
          (k < K && co < Cout) ? w[(long long)k * Cout + co] : T(0);
    }
  }
}

// ------------------------------------------------------------ bf16, mma.sync

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The general bf16 kernel: 128 pixels x 64 channels, 2 x 2 warps of 64 x 32.
struct Bf16Tile {
  static constexpr int BN = 64;
  static constexpr int BK = 32;                      // bf16 per K chunk
  static constexpr int WARPS_N = 2;
  static constexpr int WM = 64, WN = 32;
  static constexpr int MI = WM / 16, NI = WN / 8;    // m16 and n8 fragments
  static constexpr int PITCH = 72;                   // 144 bytes: odd x 16
  static constexpr int A_BYTES = BM * A_PITCH_BYTES;
  static constexpr int B_BYTES = BK * PITCH * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static_assert(BM * PITCH * 2 <= STAGES * STAGE_BYTES, "epilogue tile");
};

__global__ void __launch_bounds__(NT)
conv3x3_bias_act_bf16(const uint16_t* __restrict__ x,
                      const uint16_t* __restrict__ w,
                      const float* __restrict__ bias,
                      uint16_t* __restrict__ y, int N, int H, int W,
                      int Cin, int Cout, int relu) {
  using Tl = Bf16Tile;
  constexpr int BN = Tl::BN;
  __shared__ __align__(128) unsigned char smem[STAGES * Tl::STAGE_BYTES];
  const int M = N * H * W, K = 9 * Cin;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nchunks = (K + Tl::BK - 1) / Tl::BK;
  const bool a_vec = Cin % Tl::BK == 0, b_vec = Cout % 8 == 0;
  const ARows rows = a_rows(m0, M, H, W, Cin);

  auto sA = [&](int s) { return smem + s * Tl::STAGE_BYTES; };
  auto sB = [&](int s) {
    return reinterpret_cast<uint16_t*>(smem + s * Tl::STAGE_BYTES +
                                       Tl::A_BYTES);
  };
  auto load = [&](int c) {
    if (c < nchunks) {
      const int s = c % STAGES;
      load_a(sA(s), x, rows, c, a_vec, H, W, Cin);
      load_b<uint16_t, Tl::BK, BN, Tl::PITCH>(sB(s), w, c * Tl::BK, n0, b_vec,
                                              K, Cout);
    }
    cp_async_commit();
  };

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm0 = (warp / Tl::WARPS_N) * Tl::WM;
  const int wn0 = (warp % Tl::WARPS_N) * Tl::WN;
  float acc[Tl::MI][Tl::NI][4];
#pragma unroll
  for (int i = 0; i < Tl::MI; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) load(c);

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c has landed; chunk c-1's buffer is free
    load(c + STAGES - 1);
    const unsigned char* a = sA(c % STAGES);
    const uint16_t* b = sB(c % STAGES);
#pragma unroll
    for (int ks = 0; ks < Tl::BK / 16; ++ks) {
      unsigned af[Tl::MI][4], bfr[Tl::NI][2];
#pragma unroll
      for (int i = 0; i < Tl::MI; ++i)
        ldsm_x4(af[i], a + (wm0 + i * 16 + (lane & 15)) * A_PITCH_BYTES +
                           (ks * 16 + (lane >> 4) * 8) * 2);
      const int krow = ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int j = 0; j < Tl::NI; j += 2) {
        unsigned r[4];
        ldsm_x4_t(r, b + krow * Tl::PITCH + wn0 + j * 8 + (lane >> 4) * 8);
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < Tl::MI; ++i)
#pragma unroll
        for (int j = 0; j < Tl::NI; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the output tile

  // ---- epilogue: + bias, ReLU, one RNE cast; staged for 16-byte stores ----
  uint16_t* sC = reinterpret_cast<uint16_t*>(smem);
#pragma unroll
  for (int j = 0; j < Tl::NI; ++j) {
    const int col = wn0 + j * 8 + (lane & 3) * 2;
    const float b0 = n0 + col < Cout ? bias[n0 + col] : 0.f;
    const float b1 = n0 + col + 1 < Cout ? bias[n0 + col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < Tl::MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = __fadd_rn(acc[i][j][2 * h], b0);
        float v1 = __fadd_rn(acc[i][j][2 * h + 1], b1);
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const int row = wm0 + i * 16 + (lane >> 2) + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(sC + row * Tl::PITCH + col) =
            __floats2bfloat162_rn(v0, v1);
      }
  }
  __syncthreads();
  constexpr int SEGS = BN / 8;
  for (int idx = threadIdx.x; idx < BM * SEGS; idx += NT) {
    const int row = idx / SEGS, s = idx % SEGS;
    const long long m = m0 + row;
    const int co = n0 + s * 8;
    if (m >= M || co >= Cout) continue;
    const uint16_t* src = sC + row * Tl::PITCH + s * 8;
    uint16_t* dst = y + m * Cout + co;
    if (b_vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && co + e < Cout; ++e) dst[e] = src[e];
    }
  }
}

// ------------------------------- bf16, halo tile + resident weights (mma)

// Cin % 16 == 0 (the EDSR body, slabs and tail): a block keeps its whole
// (9*Cin, BN) weight slice in shared memory and walks output tiles of
// TH x TW = 128 pixels of one image. Per tile it copies the (TH+2) x (TW+2)
// x Cin input halo once (cp.async, zero-fill outside the image) and takes
// all 9 taps' A fragments from it by ldmatrix on shifted pixel rows, so the
// input crosses L2 ~1.4 times instead of 9. Two blocks share an SM: one
// copies its halo while the other multiplies. BN = 64: 8 warps of 32 x 32;
// BN = 8 (Cout <= 8): 8 warps of 16 x 8.
constexpr int HALO_NT = 256;
constexpr int HALO_SMEM_MAX = 110 * 1024;  // two blocks per SM

template <int BN>
struct HaloTile {
  static constexpr int WARPS_N = BN == 64 ? 2 : 1;
  static constexpr int WARPS_M = HALO_NT / 32 / WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr int PITCH = BN == 64 ? 72 : 24;  // bf16; odd x 16 bytes
  // dynamic shared memory: the weights, then one region for the halo and,
  // after the product, the staged output tile
  static constexpr int smem(int Cin, int TW) {
    return 9 * Cin * PITCH * 2 +
           ((BM / TW + 2) * (TW + 2) * (Cin * 2 + 16) > BM * PITCH * 2
                ? (BM / TW + 2) * (TW + 2) * (Cin * 2 + 16)
                : BM * PITCH * 2);
  }
};

template <int BN, int TW>
__global__ void __launch_bounds__(HALO_NT, 2)
conv3x3_bias_act_bf16_halo(const uint16_t* __restrict__ x,
                           const uint16_t* __restrict__ w,
                           const float* __restrict__ bias,
                           uint16_t* __restrict__ y, int N, int H, int W,
                           int Cin, int Cout, int relu) {
  using Tl = HaloTile<BN>;
  constexpr int TH = BM / TW, HWD = TW + 2, HPIX = (TH + 2) * HWD;
  constexpr int SEGS = BN / 8;  // 16-byte segments per weight / output row
  extern __shared__ __align__(128) unsigned char dsmem[];
  const int K = 9 * Cin, pitch = Cin * 2 + 16, segs = Cin / 8;
  uint16_t* sW = reinterpret_cast<uint16_t*>(dsmem);
  unsigned char* sH = dsmem + K * Tl::PITCH * 2;
  uint16_t* sC = reinterpret_cast<uint16_t*>(sH);
  const int n0 = blockIdx.y * BN;
  const bool vec = Cout % 8 == 0;

  if (vec) {
    for (int idx = threadIdx.x; idx < K * SEGS; idx += HALO_NT) {
      const int r = idx / SEGS, s = idx % SEGS, col = n0 + s * 8;
      const bool ok = col < Cout;
      cp_async16(sW + r * Tl::PITCH + s * 8,
                 ok ? w + (long long)r * Cout + col : w, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < K * BN; idx += HALO_NT) {
      const int r = idx / BN, c = idx % BN, co = n0 + c;
      sW[r * Tl::PITCH + c] = co < Cout ? w[(long long)r * Cout + co] : 0;
    }
  }
  cp_async_commit();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm0 = (warp / Tl::WARPS_N) * Tl::WM;
  const int wn0 = (warp % Tl::WARPS_N) * Tl::WN;
  int hb[Tl::MI];  // halo pixel of this lane's ldmatrix row, tap (0, 0)
#pragma unroll
  for (int i = 0; i < Tl::MI; ++i) {
    const int p = wm0 + i * 16 + (lane & 15);
    hb[i] = (p / TW) * HWD + p % TW;
  }
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int per_img = tiles_x * tiles_y, n_tiles = N * per_img;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n = tile / per_img, t = tile - n * per_img;
    const int oy0 = (t / tiles_x) * TH, ox0 = (t % tiles_x) * TW;
    for (int idx = threadIdx.x; idx < HPIX * segs; idx += HALO_NT) {
      const int hp = idx / segs, s = idx - hp * segs;
      const int iy = oy0 + hp / HWD - 1, ix = ox0 + hp % HWD - 1;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
      cp_async16(sH + hp * pitch + s * 16,
                 ok ? x + (((long long)n * H + iy) * W + ix) * Cin + s * 8 : x,
                 ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // the halo (and, on the first tile, the weights) landed

    float acc[Tl::MI][Tl::NI][4];
#pragma unroll
    for (int i = 0; i < Tl::MI; ++i)
#pragma unroll
      for (int j = 0; j < Tl::NI; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    // k = tap*Cin + ci in steps of 16, in increasing order
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * HWD + tap % 3;
      const unsigned char* a[Tl::MI];
#pragma unroll
      for (int i = 0; i < Tl::MI; ++i)
        a[i] = sH + (hb[i] + toff) * pitch + (lane >> 4) * 16;
      const uint16_t* b =
          sW + (tap * Cin + ((lane >> 3) & 1) * 8 + (lane & 7)) * Tl::PITCH + wn0;
#pragma unroll 4
      for (int kc = 0; kc < Cin / 16; ++kc) {
        unsigned af[Tl::MI][4], bfr[Tl::NI][2];
#pragma unroll
        for (int i = 0; i < Tl::MI; ++i) ldsm_x4(af[i], a[i] + kc * 32);
        const uint16_t* bk = b + kc * 16 * Tl::PITCH;
        if constexpr (Tl::NI == 1) {
          ldsm_x2_t(bfr[0], bk);
        } else {
#pragma unroll
          for (int j = 0; j < Tl::NI; j += 2) {
            unsigned r[4];
            ldsm_x4_t(r, bk + j * 8 + (lane >> 4) * 8);
            bfr[j][0] = r[0];
            bfr[j][1] = r[1];
            bfr[j + 1][0] = r[2];
            bfr[j + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int i = 0; i < Tl::MI; ++i)
#pragma unroll
          for (int j = 0; j < Tl::NI; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
      }
    }
    __syncthreads();  // the halo is read: stage the output tile over it

#pragma unroll
    for (int j = 0; j < Tl::NI; ++j) {
      const int col = wn0 + j * 8 + (lane & 3) * 2;
      const float b0 = n0 + col < Cout ? bias[n0 + col] : 0.f;
      const float b1 = n0 + col + 1 < Cout ? bias[n0 + col + 1] : 0.f;
#pragma unroll
      for (int i = 0; i < Tl::MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = __fadd_rn(acc[i][j][2 * h], b0);
          float v1 = __fadd_rn(acc[i][j][2 * h + 1], b1);
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          const int row = wm0 + i * 16 + (lane >> 2) + 8 * h;
          *reinterpret_cast<__nv_bfloat162*>(sC + row * Tl::PITCH + col) =
              __floats2bfloat162_rn(v0, v1);
        }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * SEGS; idx += HALO_NT) {
      const int p = idx / SEGS, s = idx % SEGS;
      const int oy = oy0 + p / TW, ox = ox0 + p % TW, co = n0 + s * 8;
      if (oy >= H || ox >= W || co >= Cout) continue;
      const uint16_t* src = sC + p * Tl::PITCH + s * 8;
      uint16_t* dst = y + (((long long)n * H + oy) * W + ox) * Cout + co;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && co + e < Cout; ++e) dst[e] = src[e];
      }
    }
    __syncthreads();  // the staged tile is stored: the next halo may land
  }
}

// ------------------------------------------------------ f32, FFMA GEMM tile

constexpr int F32_BK = 16;   // floats per K chunk
constexpr int F32_BN = 64;   // output channels per block
constexpr int F32_PITCH = F32_BN;
constexpr int F32_A_BYTES = BM * A_PITCH_BYTES;
constexpr int F32_STAGE_BYTES = F32_A_BYTES + F32_BK * F32_PITCH * 4;

// thread (ty, tx) = (tid / 8, tid % 8) owns pixels ty*8 .. ty*8 + 7 and
// channels tx*4 .. tx*4 + 3 and 32 + tx*4 .. 32 + tx*4 + 3 of the tile. Four
// blocks per SM (128 registers a thread, 43 KB of shared memory each).
__global__ void __launch_bounds__(NT, 4)
conv3x3_bias_act_f32(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y,
                     int N, int H, int W, int Cin, int Cout, int relu) {
  __shared__ __align__(128) unsigned char smem[STAGES * F32_STAGE_BYTES];
  const int M = N * H * W, K = 9 * Cin;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * F32_BN;
  const int nchunks = (K + F32_BK - 1) / F32_BK;
  const bool a_vec = Cin % F32_BK == 0, b_vec = Cout % 4 == 0;
  const ARows rows = a_rows(m0, M, H, W, Cin);

  auto sA = [&](int s) { return smem + s * F32_STAGE_BYTES; };
  auto sB = [&](int s) {
    return reinterpret_cast<float*>(smem + s * F32_STAGE_BYTES + F32_A_BYTES);
  };
  auto load = [&](int c) {
    if (c < nchunks) {
      const int s = c % STAGES;
      load_a(sA(s), x, rows, c, a_vec, H, W, Cin);
      load_b<float, F32_BK, F32_BN, F32_PITCH>(sB(s), w, c * F32_BK, n0,
                                               b_vec, K, Cout);
    }
    cp_async_commit();
  };

  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) load(c);

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c has landed; chunk c-1's buffer is free
    load(c + STAGES - 1);
    const unsigned char* a = sA(c % STAGES);
    const float* b = sB(c % STAGES);
#pragma unroll
    for (int k4 = 0; k4 < F32_BK / 4; ++k4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(
            a + (ty * 8 + i) * A_PITCH_BYTES + k4 * 16);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = b + (k4 * 4 + kk) * F32_PITCH;
        const float4 b0 = *reinterpret_cast<const float4*>(brow + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + 32 + tx * 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ai = (&av[i].x)[kk];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(ai, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: + bias, ReLU, one store per output ----
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int co = n0 + h * 32 + tx * 4;
    if (co >= Cout) continue;
    float bi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bi[j] = co + j < Cout ? bias[co + j] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long m = m0 + ty * 8 + i;
      if (m >= M) break;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = __fadd_rn(acc[i][h * 4 + j], bi[j]);
        if (relu) v[j] = fmaxf(v[j], 0.f);
      }
      float* dst = y + m * Cout + co;
      if (b_vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (int j = 0; j < 4 && co + j < Cout; ++j) dst[j] = v[j];
      }
    }
  }
}

// ------------------------------------------- f32, narrow Cout (<= 8), halo

// A block owns 512 output pixels of one image (TH x TW, 2 per thread) and
// the whole (9*Cin, NCO) weight matrix; the input comes through shared
// memory in chunks of 16 channels as a (TH+2) x (TW+2) halo, so each input
// value crosses L2 ~1.2 times, not 9. Per k: one float4 weight load
// (broadcast), 2 * NCO FFMAs.
constexpr int NW_NT = 256;
constexpr int NW_CC = 16;      // input channels per halo chunk
constexpr int NW_PITCH = 20;   // floats per halo pixel (80 bytes: odd x 16)

__host__ __device__ constexpr int narrow_smem(int Cin, int nco, int TW) {
  return 9 * Cin * nco * 4 + (2 * NW_NT / TW + 2) * (TW + 2) * NW_PITCH * 4;
}

template <int NCO, int TW>
__global__ void __launch_bounds__(NW_NT)
conv3x3_narrow_f32(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int N, int H, int W, int Cin, int Cout, int relu) {
  constexpr int TH = 2 * NW_NT / TW, HWD = TW + 2, HPIX = (TH + 2) * HWD;
  extern __shared__ float4 sW4[];  // 9*Cin rows of NCO floats, then the halo
  float* sW = reinterpret_cast<float*>(sW4);
  float* sH = sW + 9 * Cin * NCO;
  for (int idx = threadIdx.x; idx < 9 * Cin * NCO; idx += NW_NT) {
    const int k = idx / NCO, c = idx % NCO;
    sW[idx] = c < Cout ? w[(long long)k * Cout + c] : 0.f;
  }
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int n = blockIdx.x / (tiles_x * tiles_y);
  const int t = blockIdx.x - n * tiles_x * tiles_y;
  const int oy0 = (t / tiles_x) * TH, ox0 = (t % tiles_x) * TW;
  int hb[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int p = threadIdx.x + q * NW_NT;
    hb[q] = (p / TW) * HWD + p % TW;
  }
  float acc[2][NCO];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int c = 0; c < NCO; ++c) acc[q][c] = 0.f;

#pragma unroll 1
  for (int cc = 0; cc < Cin; cc += NW_CC) {
    __syncthreads();  // the previous chunk is read
    for (int idx = threadIdx.x; idx < HPIX * 4; idx += NW_NT) {
      const int hp = idx / 4, s = idx % 4;
      const int iy = oy0 + hp / HWD - 1, ix = ox0 + hp % HWD - 1;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
      cp_async16(sH + hp * NW_PITCH + s * 4,
                 ok ? x + (((long long)n * H + iy) * W + ix) * Cin + cc + s * 4
                    : x,
                 ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * HWD + tap % 3;
      const float4* wt = sW4 + (tap * Cin + cc) * (NCO / 4);
#pragma unroll
      for (int c4 = 0; c4 < NW_CC / 4; ++c4) {
        float4 xv[2];
#pragma unroll
        for (int q = 0; q < 2; ++q)
          xv[q] = *reinterpret_cast<const float4*>(
              sH + (hb[q] + toff) * NW_PITCH + c4 * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float wv[NCO];
#pragma unroll
          for (int v = 0; v < NCO / 4; ++v) {
            const float4 t4 = wt[(c4 * 4 + e) * (NCO / 4) + v];
            wv[4 * v] = t4.x;
            wv[4 * v + 1] = t4.y;
            wv[4 * v + 2] = t4.z;
            wv[4 * v + 3] = t4.w;
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float xe = (&xv[q].x)[e];
#pragma unroll
            for (int c = 0; c < NCO; ++c)
              acc[q][c] = __fmaf_rn(xe, wv[c], acc[q][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int p = threadIdx.x + q * NW_NT;
    const int oy = oy0 + p / TW, ox = ox0 + p % TW;
    if (oy >= H || ox >= W) continue;
    float* dst = y + (((long long)n * H + oy) * W + ox) * Cout;
#pragma unroll
    for (int c = 0; c < NCO; ++c) {
      if (c >= Cout) break;
      const float v = __fadd_rn(acc[q][c], bias[c]);
      dst[c] = relu ? fmaxf(v, 0.f) : v;
    }
  }
}

// Launch with `smem` bytes of dynamic shared memory, raising the kernel's
// limit above the default 48 KB once.
template <class... Params, class... Args>
int launch_dyn(void (*kernel)(Params...), dim3 grid, int threads, int smem,
               cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace

// x, y: N*H*W*C < 2^31 elements (the wrapper checks).
extern "C" int conv3x3_bias_act_f32_launch(const void* x, const void* w,
                                           const void* bias, void* y, int N,
                                           int H, int W, int Cin, int Cout,
                                           int relu, void* stream) {
  const long long M = (long long)N * H * W;
  const cudaStream_t s = (cudaStream_t)stream;
  const float *xf = (const float*)x, *wf = (const float*)w,
              *bf = (const float*)bias;
  float* yf = (float*)y;
  const int nco = Cout <= 4 ? 4 : 8, tw = W > 8 ? 32 : 8;
  const int smem = narrow_smem(Cin, nco, tw);
  if (Cout <= 8 && Cin % NW_CC == 0 && smem <= 96 * 1024) {
    const int th = 2 * NW_NT / tw;
    const dim3 grid((unsigned)(N * ((H + th - 1) / th) * ((W + tw - 1) / tw)));
    if (nco == 4)
      return tw == 32 ? launch_dyn(conv3x3_narrow_f32<4, 32>, grid, NW_NT, smem,
                                   s, xf, wf, bf, yf, N, H, W, Cin, Cout, relu)
                      : launch_dyn(conv3x3_narrow_f32<4, 8>, grid, NW_NT, smem,
                                   s, xf, wf, bf, yf, N, H, W, Cin, Cout, relu);
    return tw == 32 ? launch_dyn(conv3x3_narrow_f32<8, 32>, grid, NW_NT, smem, s,
                                 xf, wf, bf, yf, N, H, W, Cin, Cout, relu)
                    : launch_dyn(conv3x3_narrow_f32<8, 8>, grid, NW_NT, smem, s,
                                 xf, wf, bf, yf, N, H, W, Cin, Cout, relu);
  }
  const dim3 grid((unsigned)((M + BM - 1) / BM),
                  (unsigned)((Cout + F32_BN - 1) / F32_BN));
  conv3x3_bias_act_f32<<<grid, NT, 0, s>>>(xf, wf, bf, yf, N, H, W, Cin, Cout,
                                           relu);
  return (int)cudaGetLastError();
}

extern "C" int conv3x3_bias_act_bf16_launch(const void* x, const void* w,
                                            const void* bias, void* y, int N,
                                            int H, int W, int Cin, int Cout,
                                            int relu, void* stream) {
  const long long M = (long long)N * H * W;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint16_t *xb = (const uint16_t*)x, *wb = (const uint16_t*)w;
  const float* bf = (const float*)bias;
  uint16_t* yb = (uint16_t*)y;
  const int tw = W > 8 ? 16 : 8;
  if (Cin % 16 == 0) {
    const bool narrow = Cout <= 8;
    const int bn = narrow ? 8 : 64;
    const int smem = narrow ? HaloTile<8>::smem(Cin, tw)
                            : HaloTile<64>::smem(Cin, tw);
    if (smem <= HALO_SMEM_MAX) {
      const int ny = (Cout + bn - 1) / bn;
      const long long tiles = (long long)N * ((H + BM / tw - 1) / (BM / tw)) *
                              ((W + tw - 1) / tw);
      const long long per_n = (2LL * sm_count() + ny - 1) / ny;
      const dim3 grid((unsigned)(tiles < per_n ? tiles : per_n), ny);
      auto kernel = narrow ? (tw == 16 ? conv3x3_bias_act_bf16_halo<8, 16>
                                       : conv3x3_bias_act_bf16_halo<8, 8>)
                           : (tw == 16 ? conv3x3_bias_act_bf16_halo<64, 16>
                                       : conv3x3_bias_act_bf16_halo<64, 8>);
      return launch_dyn(kernel, grid, HALO_NT, smem, s, xb, wb, bf, yb, N, H,
                        W, Cin, Cout, relu);
    }
  }
  const dim3 grid((unsigned)((M + BM - 1) / BM), (Cout + 63) / 64);
  conv3x3_bias_act_bf16<<<grid, NT, 0, s>>>(xb, wb, bf, yb, N, H, W, Cin, Cout,
                                            relu);
  return (int)cudaGetLastError();
}

extern "C" const char* conv3x3_bias_act_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
