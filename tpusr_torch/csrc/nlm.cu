// K4: fast non-local means on a [0, 1] grayscale image, for sm_90a.
//
// Replaces the Pallas kernel tpusr/core/pallas_nlm.py::nlm_denoise_pallas
// (body _nlm_kernel). For an (H, W) float32 image x, with d = 6, box = 5 and
// pad = d + box/2 = 8:
//   - x is reflect-101 padded by pad (np.pad mode='reflect', any H, W);
//   - for each of the 168 non-zero offsets (dy, dx) of the 13x13 window,
//     d2 = (5x5 box SUM of (x0 - xs)^2) * (1/25), the column sums first and
//     then the row sums, each left to right, as the Pallas kernel adds them;
//     w = expf(-max(d2 - 2 sigma^2, 0) * inv_h2);
//   - num starts at the centre pixel and den at 1 (the (0, 0) offset has
//     weight 1); num += w * shift(x), den += w;
//   - y = num / den.
// sigma^2 and inv_h2 = 1 / max(h^2, 1e-12) come in as a 2-float device
// array, so an on-device sigma estimate never forces a host sync.
//
// What bounds it on this card: per output pixel it does ~17 fp32 operations
// and one expf for each of the 168 offsets and moves 8 bytes, so it is
// bound by operations (the fp32 pipe and the SFU), never by HBM. The design
// reads each input pixel from HBM about (32/16)^2 = 4 times (the halo of
// neighbouring tiles; all of it L2 hits) and writes each output once:
// a block stages its 16x16 output tile plus an 8-pixel halo, 32x32 floats,
// in shared memory, with the reflect padding done by index arithmetic while
// staging (no padded copy in HBM). For every offset the block computes the
// squared differences on the 20x20 box-extended window in shared memory,
// the 5-tap column sums into a 16x20 buffer, and then each thread its
// pixel's 5-tap row sum, weight and accumulation in registers. The Pallas
// kernel needed circular rotates of the whole image and a <= 512^2 VMEM
// gate; here the image size is bounded only by the grid.
//
// The offset of step k follows from k alone (row-major over the 13x13
// window, centre skipped), the order of the reference's offset table, so
// the loop needs no table. expf is the exact libdevice expf: build without
// --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int D = 6;                          // patch_distance
constexpr int BOX = 5;                        // patch_size
constexpr int HALF = BOX / 2;
constexpr int PAD = D + HALF;                 // 8
constexpr int SIDE = 2 * D + 1;               // 13
constexpr int N_OFF = SIDE * SIDE - 1;        // 168
constexpr int T = 16;                         // output tile, one pixel a thread
constexpr int EXT = T + 2 * HALF;             // 20: box-extended window
constexpr int HALO = T + 2 * PAD;             // 32: tile + halo

// Index of padded coordinate i (relative to the image) under reflect-101,
// periodic with period 2(n-1), as np.pad reflects repeatedly for pad >= n.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

__global__ void __launch_bounds__(T * T)
nlm_kernel(const float* __restrict__ x, const float* __restrict__ params,
           float* __restrict__ y, int H, int W) {
  __shared__ float sx[HALO][HALO + 1];   // the padded image around the tile
  __shared__ float sd[EXT][EXT + 1];     // (x0 - xs)^2, box-extended window
  __shared__ float sv[T][EXT + 1];       // 5-tap column sums

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * T + tx;
  const int oy = blockIdx.y * T, ox = blockIdx.x * T;

  // sx[r][c] = padded image at (oy + r, ox + c) = x at (oy + r - PAD, ...)
  for (int i = tid; i < HALO * HALO; i += T * T) {
    const int r = i / HALO, c = i - (i / HALO) * HALO;
    const int iy = reflect101(oy + r - PAD, H);
    const int ix = reflect101(ox + c - PAD, W);
    sx[r][c] = x[(long long)iy * W + ix];
  }
  const float sig2 = params[0];
  const float inv_h2 = params[1];
  __syncthreads();

  float num = sx[PAD + ty][PAD + tx];    // centre pixel, weight 1
  float den = 1.f;
  constexpr int A0 = PAD - HALF;         // top-left of the window at offset 0

  for (int k = 0; k < N_OFF; ++k) {
    const int j = k < N_OFF / 2 ? k : k + 1;   // skip the centre
    const int dy = j / SIDE - D, dx = j % SIDE - D;

    for (int i = tid; i < EXT * EXT; i += T * T) {
      const int r = i / EXT, c = i - (i / EXT) * EXT;
      const float a = sx[A0 + r][A0 + c] - sx[A0 + dy + r][A0 + dx + c];
      sd[r][c] = a * a;
    }
    __syncthreads();

    for (int i = tid; i < T * EXT; i += T * T) {
      const int r = i / EXT, c = i - (i / EXT) * EXT;
      float s = sd[r][c];
#pragma unroll
      for (int u = 1; u < BOX; ++u) s += sd[r + u][c];
      sv[r][c] = s;
    }
    __syncthreads();

    float b = sv[ty][tx];
#pragma unroll
    for (int v = 1; v < BOX; ++v) b += sv[ty][tx + v];
    const float d2 = b * (1.f / (BOX * BOX));
    const float w = expf(-fmaxf(d2 - 2.f * sig2, 0.f) * inv_h2);
    num += w * sx[PAD + dy + ty][PAD + dx + tx];
    den += w;
    // the next offset rewrites sd only: every thread has passed the barrier
    // above, so all reads of sd for this offset are done; sv is rewritten
    // only after the next barrier, which every thread reaches after its
    // reads of sv here
  }

  const int oyy = oy + ty, oxx = ox + tx;
  if (oyy < H && oxx < W) y[(long long)oyy * W + oxx] = num / den;
}

}  // namespace

extern "C" int nlm_denoise_launch(const void* x, const void* params, void* y,
                                  int H, int W, void* stream) {
  const dim3 block(T, T);
  const dim3 grid((unsigned)((W + T - 1) / T), (unsigned)((H + T - 1) / T));
  nlm_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)params, (float*)y, H, W);
  return (int)cudaGetLastError();
}

extern "C" const char* nlm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
