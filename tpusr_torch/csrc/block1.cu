// K3: block 1 of the per-patch int8 VGG16, fused, on Hopper's int8 tensor
// cores, for sm_90a.
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
// zero padding for both convs: a b1c1 cell outside the patch is 0 in the
// staged tile, not requant(0 * w + bias). The requant is quant.py:112-115
// rounded step by step (f32 acc * rescale, then + bias, no FMA contraction,
// clip to [0, 127], truncating cast), so the output equals
// tpusr/models/pallas_vgg.py::block1_reference bit for bit. The int32 sums
// are exact (|acc| <= 576 * 127^2 < 2^24, so the cast to f32 is exact too),
// with no split-K and no atomics: the output depends neither on the grid nor
// on N. The pool runs on the int32 sums before the requant, which gives the
// same values because the requant is monotonic in the sum (see the pool).
//
// What bounds it on this card: 2 * patch^2 * 64 * (27 + 576) int8
// operations per patch against ~(patch/2)^2 * 64 bytes out, so the int8
// tensor-core rate (1979 TOP/s). Both products run on the tensor cores
// (wgmma.mma_async ... .s32.s8.s8), and no b1c1 or b1c2 activation and no
// patch tensor reaches device memory. What holds it below that rate is the
// instruction issue of the CUDA-core work around the products (the window
// gather and above all b1c1's 64 requants per pixel), so the design spends
// few instructions there. The design:
//
//   - Persistent grid: as many 256-thread blocks (two warpgroups) as fit on
//     the card, two per SM, each walking (patch, 16x32 tile of b1c2
//     outputs) work items. A block copies the packed weights once, by
//     cp.async, into 128-byte-swizzled K-major tiles (K1's layout, from the
//     trees' kernel_packed: b1c2 (64, 640), b1c1 (64, 128)), and keeps them.
//   - Staged window: per item, the tile's 20x36x3 input window (halo 2) in
//     shared memory, read pixel by pixel, 3 bytes each, from the unpadded
//     image (the image may be a sub-batch view off any alignment): the
//     reflect-101 pad is index arithmetic, pixels outside the patch are its
//     SAME zeros. The next item's window is loaded into registers before
//     this item's products and stored to the other of two buffers after
//     them.
//   - b1c1 on the halo-1 tile (18x34 = 612 pixels, ten 64-row M tiles, five
//     per warpgroup), one k32 step each (K = 27 zero-padded to 32),
//     wgmma.m64n64k32 with A in registers: each thread gathers its A
//     fragment straight from the window with byte offsets fixed at the
//     start; B is the resident weights. The sums start at the bits of
//     1.5 * 2^23, so the requant reads f32(sum) with one FADD. The int8
//     result goes to shared memory as four planes of 16 channels, 16 bytes
//     per pixel.
//   - b1c2 fed from that tile, never from L2, with the roles of the
//     operands swapped: A is the weights (64 output channels x K, the
//     swizzled resident tile) and B the activations, read through a
//     descriptor without swizzle. There an 8-row core matrix is 8
//     consecutive 16-byte pixels of a plane, the next 8 rows a tile row
//     (MW pixels) on, and the two 16-byte k halves a plane apart; so the
//     descriptor of tap (ky, kx) is the same one with its start moved by
//     ky * MW + kx pixels. (A 128-byte swizzle cannot be shifted by one
//     pixel; the no-swizzle layout can, by any 16 bytes.) Per warpgroup
//     and 8-column strip of the tile: D (64 channels x 128 outputs), 18
//     wgmma.m64n128k32 issued back to back, one wait.
//   - The pool in registers: column n = 8j + 2q + e of D is output (row j,
//     column 2q + e of the strip), so each thread holds whole 2x2 quads for
//     its two channels. The requant is monotone in the sum, so the pool
//     takes the quad's largest sum (its smallest where the rescale is
//     negative) and requantizes once, not four times. The pooled tile is
//     staged in shared memory and stored as 16-byte writes with 64-bit
//     offsets.
//   - No int <-> float conversion instruction (16 a clock per SM against
//     128 FP32 adds) in b1c1's requants: f32 by the magic above, and every
//     truncating cast an add of 1.5 * 2^23 rounded down. Both are exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int NT = 256;            // threads per block: two warpgroups
constexpr int C = 64;              // block-1 channels
constexpr int TH = 16, TW = 32;    // b1c2 outputs per tile: rows, columns
constexpr int STRIPS = TW / 16;    // 8-column b1c2 strips per warpgroup
constexpr int MH = TH + 2, MW = TW + 2;  // b1c1 tile (halo 1)
constexpr int WH = TH + 4, WW = TW + 4;  // input window (halo 2)
constexpr int WIN_SLOT = (WH * WW * 3 + 15) / 16 * 16;  // one window buffer
constexpr int FETCH = (WH * WW + NT - 1) / NT;          // window pixels a thread
constexpr int MID_PIX = MH * MW;
constexpr int PLANE = MID_PIX * 16;  // b1c1 tile: 16 channels of each pixel
constexpr int B1_TILES = (MID_PIX + 127) / 128;  // b1c1 M tiles per warpgroup
constexpr int PW = TW / 2, POOL_PIX = TH / 2 * PW;  // pooled tile
constexpr int PITCH = 80;          // bytes per pixel of the pooled tile
constexpr int K1P = 128;           // packed row of b1c1 (pack_int8_kernel)
constexpr int K2P = 640;           // packed row of b1c2: 576 rounded up to 128
constexpr int STEPS = 9 * C / 32;  // b1c2 k32 steps
constexpr int CHUNK = 64 * 128;    // one 64-row, 128-byte-swizzled tile
constexpr uint32_t MAGIC = 0x4B400000u;  // the bits of 1.5 * 2^23

// shared memory, byte offsets from a 1024-byte-aligned base (the swizzle atom)
constexpr int OFF_W2 = 0;                            // 5 chunks of b1c2
constexpr int OFF_W1 = OFF_W2 + K2P / 128 * CHUNK;   // b1c1, k 0..31 used
constexpr int OFF_VEC = OFF_W1 + CHUNK;              // rs1, bs1
constexpr int OFF_WIN = OFF_VEC + 2 * C * 4;         // two window buffers
constexpr int OFF_MID = OFF_WIN + 2 * WIN_SLOT;      // b1c1 output tile
constexpr int OFF_OUT = OFF_MID + 4 * PLANE;         // pooled tile
constexpr int SMEM_BYTES = OFF_OUT + POOL_PIX * PITCH + 1024;
static_assert(OFF_MID % 16 == 0 && OFF_OUT % 16 == 0, "16-byte units");
static_assert(2 * C <= NT && TW % 16 == 0 && TH == 16, "thread mapping");
static_assert(2 * SMEM_BYTES <= 227 * 1024, "two blocks per SM");

// The requant of quant.py:112-115 on f32(acc) `x`: * rs, then + b (no FMA
// contraction), clip to [0, 127], truncating cast. The cast is an add of
// 1.5 * 2^23 rounded down, whose bits are 0x4B400000 + floor(v): one
// full-rate FADD where F2I runs at an eighth of the rate on this card. The
// int8 value is the low byte of the result (callers pack with __byte_perm).
__device__ __forceinline__ uint32_t requant_f(float x, float rs, float b) {
  float v = __fadd_rn(__fmul_rn(x, rs), b);
  v = fminf(fmaxf(v, 0.f), 127.f);
  return __float_as_uint(__fadd_rd(v, 12582912.f));   // MAGIC + floor(v)
}

// b1c1's sums start at MAGIC, so with |sum| <= 27 * 128^2 < 2^22 the
// accumulator is the bits of 1.5 * 2^23 + sum: f32(sum) exactly, less the
// magic (full rate; I2F runs at an eighth).
__device__ __forceinline__ uint32_t requant_b1c1(int acc, float rs, float b) {
  return requant_f(__int_as_float(acc) - 12582912.f, rs, b);
}

// b1c2's |acc| <= 576 * 127 * 128 < 2^24: I2F is exact.
__device__ __forceinline__ uint32_t requant_b1c2(int acc, float rs, float b) {
  return requant_f(__int2float_rn(acc), rs, b);
}

// np.pad(mode="reflect") index of padded position i >= 0 in a dim of n
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < n) return i;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  return i < n ? i : period - i;
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
// Keep the compiler from moving reads or writes of registers a wgmma uses
// (accumulators, A fragments) across a wgmma fence or wait.
template <int N, class T>
__device__ __forceinline__ void fence_regs(T (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a K-major tile without swizzle at
// `saddr`: 8-row core matrices of 16-byte rows, `lbo` bytes apart along K and
// `sbo` bytes apart along the rows.
__device__ __forceinline__ uint64_t plain_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// D (64 x 128, int32) += A (64 x 32) * B (32 x 128), int8, both operands
// K-major in shared memory.
__device__ __forceinline__ void wgmma_ss128(int (&d)[64], uint64_t a,
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

// D (64 x 64, int32, the warpgroup's fragments) += A (64 x 32) * B (32 x 64),
// int8; A in registers (each warp its m16k32 fragment: a0 row g, k 4q..4q+3;
// a1 row g + 8; a2, a3 the same rows at k + 16; g = lane / 4, q = lane % 4),
// B K-major in shared memory.
__device__ __forceinline__ void wgmma_rs(int (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

struct Geometry {
  int H, W, patch, stride, n_h, n_w, tiles_y, tiles_x;
};

// Work item `item`: patch pid at patch-grid cell (pr, pc) of image n, tile
// origin (ty0, tx0) in the patch.
struct Item {
  int pid, n, pr, pc, ty0, tx0;
  __device__ Item(int item, const Geometry& g) {
    const int per_patch = g.tiles_y * g.tiles_x;
    pid = item / per_patch;
    const int t = item - pid * per_patch;
    const int tr = t / g.tiles_x;
    ty0 = tr * TH;
    tx0 = (t - tr * g.tiles_x) * TW;
    n = pid / (g.n_h * g.n_w);
    const int cell = pid - n * g.n_h * g.n_w;
    pr = cell / g.n_w;
    pc = cell - pr * g.n_w;
  }
};

// This thread's FETCH pixels of an item's input window (window pixel
// u = tid + j*NT; patch-local rows ty0 - 2 .. ty0 + TH + 1), 3 bytes each:
// global loads whose results `stash` stores after the item's products.
__device__ __forceinline__ void fetch(const int8_t* __restrict__ img,
                                      const Item& it, const Geometry& g,
                                      int8_t (&v)[FETCH][3]) {
  const int8_t* im = img + (long long)it.n * g.H * g.W * 3;
#pragma unroll
  for (int j = 0; j < FETCH; ++j) {
    const int u = threadIdx.x + j * NT;
    const int y = it.ty0 - 2 + u / WW, x = it.tx0 - 2 + u % WW;
    v[j][0] = v[j][1] = v[j][2] = 0;
    if (u < WH * WW && y >= 0 && y < g.patch && x >= 0 && x < g.patch) {
      const int gy = reflect101(g.stride * it.pr + y, g.H);
      const int gx = reflect101(g.stride * it.pc + x, g.W);
      const int8_t* src = im + ((long long)gy * g.W + gx) * 3;
      v[j][0] = src[0];
      v[j][1] = src[1];
      v[j][2] = src[2];
    }
  }
}

__device__ __forceinline__ void stash(int8_t* win, const int8_t (&v)[FETCH][3]) {
#pragma unroll
  for (int j = 0; j < FETCH; ++j) {
    const int u = threadIdx.x + j * NT;
    if (u < WH * WW) {
      win[3 * u] = v[j][0];
      win[3 * u + 1] = v[j][1];
      win[3 * u + 2] = v[j][2];
    }
  }
}

__global__ void __launch_bounds__(NT, 2)
block1_kernel(const int8_t* __restrict__ img, const int8_t* __restrict__ w1p,
              const float* __restrict__ rs1, const float* __restrict__ bs1,
              const int8_t* __restrict__ w2p, const float* __restrict__ rs2,
              const float* __restrict__ bs2, int8_t* __restrict__ out,
              Geometry g, int n_items) {
  extern __shared__ unsigned char dsmem[];
  const uint32_t base = (smem_u32(dsmem) + 1023u) & ~1023u;
  unsigned char* const sm = dsmem + (base - smem_u32(dsmem));
  const float* const vec = reinterpret_cast<const float*>(sm + OFF_VEC);
  unsigned char* const mid = sm + OFF_MID;
  unsigned char* const pooled = sm + OFF_OUT;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) & 3, wg = tid >> 7;
  const int gid = lane >> 2, q = lane & 3;
  const int half = g.patch / 2;

  // ---- weights and per-channel vectors, once per block ----
  for (int i = tid; i < 64 * (K2P / 16); i += NT) {
    const int r = i / (K2P / 16), u = i % (K2P / 16);
    cp_async16(base + OFF_W2 + (u >> 3) * CHUNK + swz(r, u & 7),
               w2p + r * K2P + u * 16, 16);
  }
  if (tid < 128)
    cp_async16(base + OFF_W1 + swz(tid >> 1, tid & 1),
               w1p + (tid >> 1) * K1P + (tid & 1) * 16, 16);
  cp_async_commit();
  if (tid < 2 * C)
    reinterpret_cast<float*>(sm + OFF_VEC)[tid] = tid < C ? rs1[tid] : bs1[tid - C];
  // b1c2's accumulator rows are output channels: this thread's two are
  // c0 = 16 warp + gid and c0 + 8, with their rescale and bias
  const int c0 = 16 * warp + gid;
  const float rs2_0 = rs2[c0], rs2_1 = rs2[c0 + 8];
  const float bs2_0 = bs2[c0], bs2_1 = bs2[c0 + 8];

  // b1c1: window byte offset of this thread's k (k = 4q + j, then
  // 16 + 4q + j) from a b1c1 pixel's window origin (0 past k = 27, whose
  // bytes `kmask` clears)
  int koff[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = (j < 4 ? 4 * q + j : 16 + 4 * q + j - 4);
    const int tap = k / 3, c = k % 3;
    koff[j] = k < 27 ? ((tap / 3) * WW + tap % 3) * 3 + c : 0;
  }
  const uint32_t kmask = q < 2 ? ~0u : q == 2 ? 0x00FFFFFFu : 0u;  // k 16 + 4q ..
  const uint64_t desc_w1 = sw128_desc(base + OFF_W1);
  const uint64_t desc_w2 = sw128_desc(base + OFF_W2);

  int8_t v[FETCH][3];
  if ((int)blockIdx.x < n_items) {
    fetch(img, Item(blockIdx.x, g), g, v);
    stash(reinterpret_cast<int8_t*>(sm + OFF_WIN), v);
  }

  int buf = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, buf ^= 1) {
    const Item it(item, g);
    const int8_t* win = reinterpret_cast<const int8_t*>(sm + OFF_WIN + buf * WIN_SLOT);
    cp_async_wait<0>();
    fence_proxy_async();  // the weights, to wgmma
    __syncthreads();      // window in; the last item's tiles are all read
    const int next = item + gridDim.x;
    if (next < n_items) fetch(img, Item(next, g), g, v);

    // ---- b1c1 on the halo-1 tile, into `mid` as int8 ----
    // M tile i of this warpgroup: b1c1 pixels (B1_TILES wg + i) * 64 .. + 63;
    // this thread's A fragment rows (fragment rows gid, gid + 8) gathered
    // from the window
    auto gather = [&](int i, uint32_t (&a)[4]) {
      const int p0 = (wg * B1_TILES + i) * 64 + warp * 16 + gid;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + 8 * h < MID_PIX ? p0 + 8 * h : 0;
        const int8_t* wp = win + ((p / MW) * WW + p % MW) * 3;
        uint32_t e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = (uint8_t)wp[koff[j]];
        a[h] = __byte_perm(__byte_perm(e[0], e[1], 0x0040),
                           __byte_perm(e[2], e[3], 0x0040), 0x5410);
        a[2 + h] = __byte_perm(__byte_perm(e[4], e[5], 0x0040),
                               __byte_perm(e[6], e[7], 0x0040), 0x5410) &
                   kmask;
      }
    };
    // rescale and bias of this thread's b1c1 channels 8j + 2q + e
    float r1[16], b1[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      r1[j] = vec[8 * (j >> 1) + 2 * q + (j & 1)];
      b1[j] = vec[C + 8 * (j >> 1) + 2 * q + (j & 1)];
    }
    auto store_b1c1 = [&](int i, const int (&acc)[32]) {
      const int p0 = (wg * B1_TILES + i) * 64 + warp * 16 + gid;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + 8 * h;
        if (p >= MID_PIX) continue;
        const int my = p / MW, mx = p % MW;
        const int y = it.ty0 - 1 + my, x = it.tx0 - 1 + mx;
        const bool inside = y >= 0 && y < g.patch && x >= 0 && x < g.patch;
        // channel c of pixel p: byte c % 16 of unit p of plane c / 16
        unsigned char* dst = mid + p * 16 + 2 * q;
        if (inside) {
#pragma unroll
          for (int j = 0; j < 8; ++j)   // channels 8j + 2q, + 1
            *reinterpret_cast<uint16_t*>(dst + (j >> 1) * PLANE + (j & 1) * 8) =
                (uint16_t)__byte_perm(
                    requant_b1c1(acc[4 * j + 2 * h], r1[2 * j], b1[2 * j]),
                    requant_b1c1(acc[4 * j + 2 * h + 1], r1[2 * j + 1],
                                 b1[2 * j + 1]),
                    0x0040);
        } else {   // b1c2's SAME zero padding
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<uint16_t*>(dst + (j >> 1) * PLANE + (j & 1) * 8) = 0;
        }
      }
    };
    auto issue_b1c1 = [&](int (&acc)[32], uint32_t (&a)[4]) {
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = (int)MAGIC;
      fence_regs(acc);
      fence_regs(a);
      wgmma_fence();
      wgmma_rs(acc, a, desc_w1);
      wgmma_commit();
    };
    {
      int acc_a[32];
      uint32_t a_a[4];
#pragma unroll 1
      for (int i = 0; i < B1_TILES; ++i) {
        gather(i, a_a);
        issue_b1c1(acc_a, a_a);
        wgmma_wait<0>();
        fence_regs(acc_a);
        fence_regs(a_a);
        store_b1c1(i, acc_a);
      }
    }
    fence_proxy_async();  // this thread's b1c1 stores, to wgmma
    __syncthreads();      // the b1c1 tile is in

    // ---- b1c2: D (64 channels x 128 outputs) per strip, 18 k32 steps ----
    // A: the resident weights, 128-byte-swizzled; k = 32 s = tap * 64 + ci
    // is chunk 32 s / 128, 32-byte step s % 4 inside it. B: the b1c1 tile,
    // no swizzle: output columns x0 .. x0 + 7, rows 0 .. 15, so an 8-row
    // core matrix is one output row (8 consecutive 16-byte pixels of a
    // plane) and the next output row is MW pixels on; k halves 16 channels,
    // a plane apart. Tap (ky, kx) moves the start by ky * MW + kx pixels.
#pragma unroll 1
    for (int st = 0; st < STRIPS; ++st) {
      const int strip = wg * STRIPS + st;
      int acc[64];
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] = 0;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        const int tap = s >> 1, kc = s & 1;
        const uint64_t da = desc_w2 +
                            (uint64_t)((32 * s / 128) * (CHUNK >> 4)) + 2 * (s % 4);
        const uint64_t db = plain_desc(
            base + OFF_MID + 2 * kc * PLANE +
                ((tap / 3) * MW + tap % 3 + 8 * strip) * 16,
            PLANE, MW * 16);
        wgmma_ss128(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);

      // 2x2 max pool on the int32 sums, then the requant. The requant is
      // monotone in acc (every step rounds monotonically): non-decreasing
      // for rs >= 0, non-increasing for rs < 0. So the max of the quad's
      // four requants is the requant of its largest sum, or of its
      // smallest where rs < 0: one requant per pooled value, not four.
      // Column n = 8 j + 2 q + e of D is output (row j, column 8 strip +
      // 2 q + e), so the quad of pooled (row jj, column 4 strip + q) is
      // j = 2 jj, 2 jj + 1, e = 0, 1: all in this thread, for both of its
      // channels.
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s0 = acc[8 * jj + 2 * h], s1 = acc[8 * jj + 2 * h + 1];
          const int s2 = acc[8 * jj + 4 + 2 * h], s3 = acc[8 * jj + 5 + 2 * h];
          const float rs = h ? rs2_1 : rs2_0, b = h ? bs2_1 : bs2_0;
          const int key = rs < 0.f ? min(min(s0, s1), min(s2, s3))
                                   : max(max(s0, s1), max(s2, s3));
          pooled[(jj * PW + 4 * strip + q) * PITCH + c0 + 8 * h] =
              (unsigned char)requant_b1c2(key, rs, b);
        }
      }
    }
    // the next item's window into the other buffer (last read before this
    // item's first barrier)
    if (next < n_items)
      stash(reinterpret_cast<int8_t*>(sm + OFF_WIN + (buf ^ 1) * WIN_SLOT), v);
    __syncthreads();  // the pooled tile is in

    for (int u = tid; u < POOL_PIX * 4; u += NT) {
      const int pix = u >> 2, unit = u & 3;
      const int oy = it.ty0 / 2 + pix / PW, ox = it.tx0 / 2 + pix % PW;
      if (oy < half && ox < half)
        *reinterpret_cast<uint4*>(
            out + (((long long)it.pid * half + oy) * half + ox) * C + unit * 16) =
            *reinterpret_cast<const uint4*>(pooled + pix * PITCH + unit * 16);
    }
  }
}

}  // namespace

// img: (N, H, W, 3) int8, any alignment; w1p, w2p: the packed K-major
// weights of b1c1 and b1c2 ((64, 128) and (64, 640) int8,
// pack_int8_kernel), 16-byte aligned; rs*, bs*: (64,) float32; out:
// (N * n_h * n_w, patch/2, patch/2, 64) int8, 16-byte aligned.
extern "C" int block1_int8_launch(const void* img, const void* w1p,
                                  const void* rs1, const void* bs1,
                                  const void* w2p, const void* rs2,
                                  const void* bs2, void* out, int N, int H,
                                  int W, int patch, int stride, int n_h,
                                  int n_w, void* stream) {
  // blocks resident on the whole card, per device (0 until first use)
  static int resident[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int cap = dev < 64 ? resident[dev] : 0;
  if (cap == 0) {
    // above 48 KB of shared memory needs an opt-in
    e = cudaFuncSetAttribute(block1_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block1_kernel,
                                                      NT, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cap = sms * per_sm;
    if (dev < 64) resident[dev] = cap;
  }
  const Geometry g{H, W, patch, stride, n_h, n_w, (patch + TH - 1) / TH,
                   (patch + TW - 1) / TW};
  const long long items = (long long)N * n_h * n_w * g.tiles_y * g.tiles_x;
  if (items <= 0) return 0;
  if (items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int grid = items < cap ? (int)items : cap;
  block1_kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const int8_t*)img, (const int8_t*)w1p, (const float*)rs1,
      (const float*)bs1, (const int8_t*)w2p, (const float*)rs2,
      (const float*)bs2, (int8_t*)out, g, (int)items);
  return (int)cudaGetLastError();
}

extern "C" const char* block1_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
