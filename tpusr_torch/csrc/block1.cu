// K3: block 1 of the per-patch int8 VGG16, fused, for sm_90a.
//
// Replaces the Pallas kernel tpusr/models/pallas_vgg.py::make_block1_fn
// (body _block1_kernel). Per patch of the reference protocol it computes
//
//   extract the patch x patch window at stride `stride` from the image,
//       reflect-101 padded at the bottom/right (pad_amounts)
//   b1c1: 3x3 SAME conv 3 -> 64, int8 x int8 -> int32, requant
//   b1c2: 3x3 SAME conv 64 -> 64, int8 x int8 -> int32, requant
//   2x2 stride-2 max pool
//
// and writes the pooled (patch/2, patch/2, 64) int8 activations, patches in
// image-major, then row, then column order. Each patch keeps its own SAME
// zero padding for both convs, as the reference classifies every patch on
// its own. The requant is quant.py:112-115 rounded step by step (f32 acc *
// rescale, then + bias, no FMA contraction, clip to [0, 127], truncating
// cast), so the output equals tpusr/models/pallas_vgg.py::block1_reference
// bit for bit. The pool runs on the int8 values; the Pallas kernel pools in
// f32 before the cast, which gives the same values because the cast is
// monotonic.
//
// What bounds it on this card: 2 * (patch^2) * 64 * (27 + 576) int8
// operations per patch against ~(patch/2)^2 * 64 bytes out, so it is bound
// by operations (the int8 tensor-core rate). This first port runs the
// products on the CUDA cores with __dp4a, as K1 does, well below that bound.
// The design keeps every block-1 intermediate on chip: no patch tensor, no
// b1c1 or b1c2 activation reaches device memory.
//
// Design: one 256-thread block per (patch, 16x16 tile of b1c2 outputs).
// 1. The tile's 20x20x3 input window (halo 2) is staged in shared memory,
//    read straight from the unpadded image: the reflect-101 pad is index
//    arithmetic, and pixels outside the patch are the patch's SAME zeros.
// 2. b1c1 on the 18x18 halo-1 tile, 64 channels, into shared memory as
//    int8; cells outside the patch are zeroed (b1c2's SAME padding). The
//    halo recompute adds ~1% to block 1's operations.
// 3. b1c2 as a __dp4a implicit GEMM, K = 9 * 64: the 144 x 64 weight words
//    (4 consecutive k of one output channel each, K1's __byte_perm
//    transpose) sit in shared memory; each thread owns one 2x2 output quad
//    for 16 channels (64 int32 accumulators).
// 4. Requant, 2x2 max pool in registers, one 16-byte store per thread.
// Tensor cores (mma/wgmma int8) and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int TILE = 16;      // b1c2 outputs per tile side
constexpr int MID = TILE + 2; // b1c1 tile side (halo 1)
constexpr int WIN = TILE + 4; // input window side (halo 2)
constexpr int C = 64;         // block-1 channels
constexpr int MID_WORDS = C / 4 + 1;  // one pixel's 64 int8 + one pad word
constexpr int K2W = 9 * C / 4;        // 144 weight words per channel (b1c2)
constexpr int K1W = 7;                // 27 k of b1c1 in 7 words (last 1 zero)

constexpr int SMEM_W2 = K2W * C * 4;            // 36,864
constexpr int SMEM_W1 = K1W * C * 4;            //  1,792
constexpr int SMEM_MID = MID * MID * MID_WORDS * 4;  // 22,032
constexpr int SMEM_IN = WIN * WIN * 3;          //  1,200
constexpr int SMEM_BYTES = SMEM_W2 + SMEM_W1 + SMEM_MID + SMEM_IN;

__device__ __forceinline__ int8_t requant(int acc, float rs, float b) {
  float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), rs), b);
  v = fminf(fmaxf(v, 0.f), 127.f);
  return (int8_t)__float2int_rz(v);
}

// np.pad(mode="reflect") index of padded position i >= 0 in a dim of n
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  return i < n ? i : period - i;
}

__device__ __forceinline__ int pack4(const int8_t* e) {
  return (int)((uint32_t)(uint8_t)e[0] | ((uint32_t)(uint8_t)e[1] << 8) |
               ((uint32_t)(uint8_t)e[2] << 16) | ((uint32_t)(uint8_t)e[3] << 24));
}

__global__ void __launch_bounds__(NT)
block1_kernel(const int8_t* __restrict__ img, const int8_t* __restrict__ w1,
              const float* __restrict__ rs1, const float* __restrict__ bs1,
              const int8_t* __restrict__ w2, const float* __restrict__ rs2,
              const float* __restrict__ bs2, int8_t* __restrict__ out, int H,
              int W, int patch, int stride, int n_h, int n_w, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* sW2 = reinterpret_cast<int*>(smem);                  // [144][64]
  int* sW1 = reinterpret_cast<int*>(smem + SMEM_W2);        // [7][64]
  int* sMid = reinterpret_cast<int*>(smem + SMEM_W2 + SMEM_W1);  // [18*18][17]
  int8_t* sIn = reinterpret_cast<int8_t*>(smem + SMEM_W2 + SMEM_W1 + SMEM_MID);

  const int tid = threadIdx.x;
  const int pid = blockIdx.x;                      // patch index
  const int n = pid / (n_h * n_w);
  const int pr = (pid / n_w) % n_h, pc = pid % n_w;
  const int ty0 = (blockIdx.y / tiles) * TILE;     // tile origin in the patch
  const int tx0 = (blockIdx.y % tiles) * TILE;

  // ---- b1c2 weights: word (kw, co) = k 4kw..4kw+3 of channel co ----
  for (int u = tid; u < K2W * (C / 4); u += NT) {
    const int kw = u / (C / 4), c4 = u % (C / 4);
    int r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = *reinterpret_cast<const int*>(w2 + (4 * kw + i) * C + c4 * 4);
    const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
    const unsigned t1 = __byte_perm(r[0], r[1], 0x7362);
    const unsigned u0 = __byte_perm(r[2], r[3], 0x5140);
    const unsigned u1 = __byte_perm(r[2], r[3], 0x7362);
    int* dst = sW2 + kw * C + c4 * 4;
    dst[0] = (int)__byte_perm(t0, u0, 0x5410);
    dst[1] = (int)__byte_perm(t0, u0, 0x7632);
    dst[2] = (int)__byte_perm(t1, u1, 0x5410);
    dst[3] = (int)__byte_perm(t1, u1, 0x7632);
  }
  // ---- b1c1 weights: k = (ky*3 + kx)*3 + c, 27 of 28 used ----
  for (int u = tid; u < K1W * C; u += NT) {
    const int kw = u / C, co = u % C;
    int8_t e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * kw + i;
      e[i] = k < 27 ? w1[k * C + co] : (int8_t)0;
    }
    sW1[kw * C + co] = pack4(e);
  }
  // ---- input window: patch-local rows ty0-2 .. ty0+17 ----
  const long long img_base = (long long)n * H * W * 3;
  for (int u = tid; u < WIN * WIN; u += NT) {
    const int wy = u / WIN, wx = u % WIN;
    const int y = ty0 - 2 + wy, x = tx0 - 2 + wx;
    int8_t v0 = 0, v1 = 0, v2 = 0;
    if (y >= 0 && y < patch && x >= 0 && x < patch) {
      const int gy = reflect101(stride * pr + y, H);
      const int gx = reflect101(stride * pc + x, W);
      const int8_t* src = img + img_base + ((long long)gy * W + gx) * 3;
      v0 = src[0];
      v1 = src[1];
      v2 = src[2];
    }
    sIn[u * 3 + 0] = v0;
    sIn[u * 3 + 1] = v1;
    sIn[u * 3 + 2] = v2;
  }
  __syncthreads();

  // ---- b1c1 on the 18x18 halo tile, 16 channels per work item ----
  for (int u = tid; u < MID * MID * 4; u += NT) {
    const int pix = u >> 2, cg = u & 3;
    const int my = pix / MID, mx = pix % MID;
    const int y = ty0 - 1 + my, x = tx0 - 1 + mx;
    int* dst = sMid + pix * MID_WORDS + cg * 4;
    if (y < 0 || y >= patch || x < 0 || x >= patch) {
      dst[0] = dst[1] = dst[2] = dst[3] = 0;   // b1c2's SAME zero padding
      continue;
    }
    int8_t e[28];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int j = 0; j < 9; ++j)   // kx*3 + c: 9 consecutive bytes per row
        e[ky * 9 + j] = sIn[((my + ky) * WIN + mx) * 3 + j];
    e[27] = 0;
    int a[K1W];
#pragma unroll
    for (int kw = 0; kw < K1W; ++kw) a[kw] = pack4(e + 4 * kw);
    int8_t o[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int co = cg * 16 + j;
      int acc = 0;
#pragma unroll
      for (int kw = 0; kw < K1W; ++kw) acc = __dp4a(a[kw], sW1[kw * C + co], acc);
      o[j] = requant(acc, rs1[co], bs1[co]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[q] = pack4(o + 4 * q);
  }
  __syncthreads();

  // ---- b1c2: each thread one 2x2 output quad x 16 channels ----
  const int cg = tid & 3, quad = tid >> 2;
  const int qy = quad / (TILE / 2), qx = quad % (TILE / 2);
  int acc[4][16];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[p][j] = 0;

  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    // sMid pixel of output (2qy+dy, 2qx+dx) at this tap
    const int* a_base = sMid + ((2 * qy + ky) * MID + 2 * qx + kx) * MID_WORDS;
    const int* b_base = sW2 + tap * (C / 4) * C + cg * 16;
#pragma unroll 4
    for (int cw = 0; cw < C / 4; ++cw) {
      const int a[4] = {a_base[cw], a_base[MID_WORDS + cw],
                        a_base[MID * MID_WORDS + cw],
                        a_base[(MID + 1) * MID_WORDS + cw]};
      const int4* bv = reinterpret_cast<const int4*>(b_base + cw * C);
      int b[16];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int4 t = bv[v];
        b[4 * v + 0] = t.x;
        b[4 * v + 1] = t.y;
        b[4 * v + 2] = t.z;
        b[4 * v + 3] = t.w;
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[p][j] = __dp4a(a[p], b[j], acc[p][j]);
    }
  }

  // ---- requant, 2x2 max pool, one 16-byte store ----
  const int half = patch / 2;
  const int oy = ty0 / 2 + qy, ox = tx0 / 2 + qx;
  if (oy >= half || ox >= half) return;
  int8_t o[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int co = cg * 16 + j;
    const float rs = rs2[co], b = bs2[co];
    int8_t m = requant(acc[0][j], rs, b);
#pragma unroll
    for (int p = 1; p < 4; ++p) {
      const int8_t v = requant(acc[p][j], rs, b);
      m = v > m ? v : m;
    }
    o[j] = m;
  }
  int4 packed = make_int4(pack4(o), pack4(o + 4), pack4(o + 8), pack4(o + 12));
  int8_t* dst = out + (((long long)pid * half + oy) * half + ox) * C + cg * 16;
  *reinterpret_cast<int4*>(dst) = packed;
}

}  // namespace

extern "C" int block1_int8_launch(const void* img, const void* w1,
                                  const void* rs1, const void* bs1,
                                  const void* w2, const void* rs2,
                                  const void* bs2, void* out, int N, int H,
                                  int W, int patch, int stride, int n_h,
                                  int n_w, void* stream) {
  // above 48 KB of shared memory needs an opt-in, once per device
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !attr_set[dev]) {
    e = cudaFuncSetAttribute(block1_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) attr_set[dev] = true;
  }
  const int tiles = (patch + TILE - 1) / TILE;
  const dim3 grid((unsigned)(N * n_h * n_w), (unsigned)(tiles * tiles));
  block1_kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const int8_t*)img, (const int8_t*)w1, (const float*)rs1,
      (const float*)bs1, (const int8_t*)w2, (const float*)rs2,
      (const float*)bs2, (int8_t*)out, H, W, patch, stride, n_h, n_w, tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* block1_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
