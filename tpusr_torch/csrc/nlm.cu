// K4: fast non-local means on a [0, 1] grayscale image, for sm_90a.
//
// Replaces the Pallas kernel tpusr/core/pallas_nlm.py::nlm_denoise_pallas
// (body _nlm_kernel). For an (H, W) float32 image x, with d = 6, box = 5 and
// pad = d + box/2 = 8:
//   - x is reflect-101 padded by pad (np.pad mode='reflect', any H, W);
//   - for each of the 168 non-zero offsets (dy, dx) of the 13x13 window,
//     d2 = (5x5 box SUM of (x0 - xs)^2) * (1/25): the column sums top to
//     bottom, then the row sums left to right, as the Pallas kernel adds
//     them, each step rounded on its own (no FMA contraction);
//     w = expf(-max(d2 - 2 sigma^2, 0) * inv_h2);
//   - num starts at the centre pixel and den at 1 (the (0, 0) offset has
//     weight 1); num += w * shift(x), den += w;
//   - y = num / den.
// sigma and h come in as device scalars; every block forms sigma^2 and
// inv_h2 = 1 / max(h^2, 1e-12) itself, so a call makes one launch and an
// on-device sigma estimate never forces a host sync.
//
// What bounds it on this card: per output pixel it moves 8 bytes, so it is
// bound by operations (the fp32 pipe and the SFU), never by HBM. The least
// work (chip_smoke.py::nlm_work) uses w(p, q) = w(p + q, -q), bit for bit:
// 84 box sums and expf serve the 168 accumulations, ~10 fp32 operations and
// half an expf per pixel and offset. This kernel forms all 168 weights
// (~17 operations and one expf each), and issue, not the fp32 pipe, sets
// its pace: the box sums also need loads and shuffles, and expf is ~8
// instructions. How the design spends them:
//   - a block stages its output tile plus an 8-pixel halo in shared memory
//     once, reflect-101 by index arithmetic (no padded copy in HBM); after
//     that barrier the offset loop reads only that read-only tile and
//     registers: no barrier and no shared-memory round trip per offset;
//   - a warp's lanes own two adjacent columns each (64 columns) and yield
//     60 output columns (lanes 0 and 31 only lend their column sums); each
//     thread walks a run of R output rows. Its two centre columns (R + 4
//     values each) stay in registers across offsets. Per offset it loads
//     R + 4 shifted values per column, squares the differences, takes each
//     row's column sums from five registers (4 FADD each) and the row sums
//     from its own pair and its neighbours' (4 SHFL and 8 FADD for two
//     pixels), then the weights and the accumulations, with the shifted
//     centre pixel from its own loads: ~28 instructions per pixel and
//     offset, expf's included, against ~80 for three shared-memory passes
//     with two barriers per offset.
//     Loading the pair as one 8-byte word from two tile copies (one shifted
//     by a column, so either parity is aligned) measured slower;
//   - the row loop is unrolled, so the window stays in registers; the
//     offset loop stays rolled, (dy, dx) following from the step k alone
//     (row-major over the 13x13 window, centre skipped), the order of the
//     reference's offset table.
// The split at small sizes: a block is 8 warps. S of them share one pixel
// run, each taking 168 / S consecutive offsets with its own num and den;
// after the loop the partials meet once in shared memory and are added in
// warp order, so the same input gives the same bits on every run (no
// atomics; the two configurations add in another order). There are two:
// R = 8, S = 1 (one warp per pixel run, 64 rows a block) and R = 2, S = 8
// (all eight warps on one 2-row run). The wrapper (core/nlm.py::
// launch_config) takes S = 1 unless its grid has fewer blocks than the card
// has SMs, which it decides from the image size and SM count alone: at 128^2
// (the classic comparison's size) S = 1 launches 6 blocks for 132 SMs and
// S = 8 launches 192; at 2048^2 S = 1 launches 1120 and took 28% less time
// than S = 8 on an H100. Two blocks per SM (__launch_bounds__): at three,
// R = 8 spills 16 bytes and ran 12% slower at 2048^2.
//
// expf is the exact libdevice expf: build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int D = 6;                          // patch_distance
constexpr int BOX = 5;                        // patch_size
constexpr int HALF = BOX / 2;
constexpr int PAD = D + HALF;                 // 8
constexpr int A0 = PAD - HALF;                // the box window's top-left
constexpr int SIDE = 2 * D + 1;               // 13
constexpr int N_OFF = SIDE * SIDE - 1;        // 168
constexpr int WARPS = 8;                      // warps in a block
constexpr int COLS = 64 - 2 * HALF;           // 60 output columns per warp
constexpr int TILE_COLS = 64 + 2 * D;         // 76 staged columns
constexpr unsigned FULL = 0xffffffffu;

// Index of padded coordinate i (relative to the image) under reflect-101,
// periodic with period 2(n-1), as np.pad reflects repeatedly for pad >= n.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

// The weight of one offset at one pixel from its 5x5 box SUM b.
__device__ __forceinline__ float weight(float b, float two_sig2,
                                        float inv_h2) {
  const float d2 = __fmul_rn(b, 1.f / (BOX * BOX));
  return expf(-fmaxf(__fsub_rn(d2, two_sig2), 0.f) * inv_h2);
}

// R: output rows a thread walks; S: warps that split the offsets of one run.
template <int R, int S>
__global__ void __launch_bounds__(WARPS * 32, 2)
nlm_kernel(const float* __restrict__ x, const float* __restrict__ sigma_p,
           const float* __restrict__ h_p, float* __restrict__ y, int H,
           int W) {
  constexpr int G = WARPS / S;                // pixel runs in the block
  constexpr int ROWS = G * R;                 // output rows of the block
  constexpr int TILE = (ROWS + 2 * PAD) * TILE_COLS;
  constexpr int PART = (WARPS - G) * R * 128; // partial num, den of s > 0
  constexpr int PER = N_OFF / S;              // offsets per warp
  static_assert(WARPS % S == 0 && N_OFF % S == 0, "S must divide 8 and 168");
  __shared__ float smem[TILE > PART ? TILE : PART];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = warp / S, s = warp - g * S;
  const int oy = blockIdx.y * ROWS, ox = blockIdx.x * COLS;

  // smem[r][c] = padded image at (oy + r, ox + c) = x at (oy + r - PAD, ...)
  for (int i = threadIdx.x; i < TILE; i += WARPS * 32) {
    const int r = i / TILE_COLS, c = i - r * TILE_COLS;
    smem[i] = x[(long long)reflect101(oy + r - PAD, H) * W
                + reflect101(ox + c - PAD, W)];
  }
  const float sigma = *sigma_p, h = *h_p;
  const float two_sig2 = 2.f * __fmul_rn(sigma, sigma);
  const float inv_h2 = 1.f / fmaxf(__fmul_rn(h, h), 1e-12f);
  __syncthreads();

  // This lane's two columns, image columns ox + 2 lane - 2 and the next
  // (lanes 0 and 31 only lend their column sums), from row oy + g R - 2:
  // at offset 0, the window's rows (c0a, c0b) and, for rows 2..R+1, the
  // centre pixels.
  const float* t = smem + (g * R + A0) * TILE_COLS + 2 * lane + D;
  float c0a[R + 4], c0b[R + 4];
#pragma unroll
  for (int i = 0; i < R + 4; ++i) {
    c0a[i] = t[i * TILE_COLS];
    c0b[i] = t[i * TILE_COLS + 1];
  }
  float num_a[R], num_b[R], den_a[R], den_b[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {               // centre pixel, weight 1
    num_a[r] = s == 0 ? c0a[r + HALF] : 0.f;
    num_b[r] = s == 0 ? c0b[r + HALF] : 0.f;
    den_a[r] = den_b[r] = s == 0 ? 1.f : 0.f;
  }

#pragma unroll 1
  for (int k = s * PER; k < (s + 1) * PER; ++k) {
    const int j = k < N_OFF / 2 ? k : k + 1;  // skip the centre
    const int dy = j / SIDE - D, dx = j - (j / SIDE) * SIDE - D;
    const float* ts = t + dy * TILE_COLS + dx;
    float xa[R + 4], xb[R + 4], sa[R + 4], sb[R + 4];
#pragma unroll
    for (int i = 0; i < R + 4; ++i) {         // (x0 - xs)^2 down both columns
      xa[i] = ts[i * TILE_COLS];
      xb[i] = ts[i * TILE_COLS + 1];
      const float a = __fsub_rn(c0a[i], xa[i]), b = __fsub_rn(c0b[i], xb[i]);
      sa[i] = __fmul_rn(a, a);
      sb[i] = __fmul_rn(b, b);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float ca = sa[r], cb = sb[r];           // column sums, top to bottom
#pragma unroll
      for (int u = 1; u < BOX; ++u) {
        ca = __fadd_rn(ca, sa[r + u]);
        cb = __fadd_rn(cb, sb[r + u]);
      }
      // row sums, left to right: the lane to the left lends two columns,
      // the lane to the right one (column a) or two (column b)
      const float l0 = __shfl_up_sync(FULL, ca, 1);
      const float l1 = __shfl_up_sync(FULL, cb, 1);
      const float r0 = __shfl_down_sync(FULL, ca, 1);
      const float r1 = __shfl_down_sync(FULL, cb, 1);
      const float ba = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(l0, l1), ca),
                                           cb), r0);
      const float bb = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(l1, ca), cb),
                                           r0), r1);
      const float wa = weight(ba, two_sig2, inv_h2);
      const float wb = weight(bb, two_sig2, inv_h2);
      num_a[r] = fmaf(wa, xa[r + HALF], num_a[r]);
      num_b[r] = fmaf(wb, xb[r + HALF], num_b[r]);
      den_a[r] += wa;
      den_b[r] += wb;
    }
  }

  if constexpr (S > 1) {
    // warps 1..S-1 of each run hand their partials to warp 0, which adds
    // them in warp order
    __syncthreads();                          // the tile's last reads
    constexpr int STRIDE = R * 128;
    float* part = smem + (g * (S - 1) + s - 1) * STRIDE + lane;
    if (s > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        part[r * 128] = num_a[r];
        part[r * 128 + 32] = num_b[r];
        part[r * 128 + 64] = den_a[r];
        part[r * 128 + 96] = den_b[r];
      }
    }
    __syncthreads();
    if (s > 0) return;
    for (int u = 1; u < S; ++u) {
      const float* p = smem + (g * (S - 1) + u - 1) * STRIDE + lane;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        num_a[r] += p[r * 128];
        num_b[r] += p[r * 128 + 32];
        den_a[r] += p[r * 128 + 64];
        den_b[r] += p[r * 128 + 96];
      }
    }
  }

  const int col = ox + 2 * lane - HALF;
  if (lane == 0 || lane == 31) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = oy + g * R + r;
    if (row >= H) break;
    float* yr = y + (long long)row * W + col;
    if (col < W) yr[0] = num_a[r] / den_a[r];
    if (col + 1 < W) yr[1] = num_b[r] / den_b[r];
  }
}

template <int R, int S>
cudaError_t launch(const void* x, const void* sigma, const void* h, void* y,
                   int H, int W, cudaStream_t stream) {
  constexpr int ROWS = WARPS / S * R;
  const dim3 grid((unsigned)((W + COLS - 1) / COLS),
                  (unsigned)((H + ROWS - 1) / ROWS));
  nlm_kernel<R, S><<<grid, WARPS * 32, 0, stream>>>(
      (const float*)x, (const float*)sigma, (const float*)h, (float*)y, H, W);
  return cudaGetLastError();
}

}  // namespace

// (rows, split) is one of core/nlm.py's CONFIGS: (8, 1) or (2, 8).
extern "C" int nlm_denoise_launch(const void* x, const void* sigma,
                                  const void* h, void* y, int H, int W,
                                  int rows, int split, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define NLM_CONFIG(R, S) \
  if (rows == R && split == S) return (int)launch<R, S>(x, sigma, h, y, H, W, st);
  NLM_CONFIG(8, 1)
  NLM_CONFIG(2, 8)
#undef NLM_CONFIG
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* nlm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
