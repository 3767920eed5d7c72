// FAST-16-9 corner score at two thresholds + 3x3 non-maximum suppression.
//
// Replaces the TPU kernel orbslam3_tpu/ops/fast_pallas.py::fast_nms_pallas_batch
// (Pallas body _kernel_batched/_compute). Computes, for a stack of B float32
// images (B, H, W):
//
//   s   = max(fast(img, thr_hi), 1e-3f * fast(img, thr_lo))
//   out = s where s >= all 8 neighbours of s, else 0
//
// where fast() is orbslam3_tpu/ops/fast.py::fast_score (16 ring differences on
// the radius-3 Bresenham circle, a run of 9 contiguous ring pixels found with
// a 16-bit rotate/AND, SAD over the qualifying polarity), the image is
// edge-replicated, and the NMS window is padded with -inf. The result equals
// fast_score + nms3x3 over the whole image, borders included, and the plain
// PyTorch version in ops/fast_cuda.py bit for bit: the 16 SAD terms are
// accumulated in CIRCLE order and no multiply-add is contracted (built with
// --fmad=false, no fast math).
//
// Bound: at the front end's sizes this kernel is bound by launches and bytes,
// not arithmetic. A 480x752 frame has about 1.1 M pixels per image across
// its 8 pyramid levels, so the stereo pair reads and writes about 18 MB per
// frame: microseconds of HBM time against 8 launches (one per level). The
// design keeps every intermediate out of device memory: one block loads its
// haloed tile once into shared memory, computes the two-threshold score for
// the tile plus its 1-pixel NMS ring in a second shared array, and writes
// only the suppressed tile. Fusing the 8 levels into one launch is left for
// a later change.
//
// Layout: blockIdx.z = image, 2-D output tiles of TX x TY = 32 x 8 pixels,
// one thread per output pixel; the block masks the ragged image edge itself.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int HALO = 4;  // 3 px Bresenham circle + 1 px NMS ring
constexpr int PW = TX + 2 * HALO;
constexpr int PH = TY + 2 * HALO;
constexpr int SW = TX + 2;
constexpr int SH = TY + 2;

// ops/fast.py::CIRCLE, clockwise from 12 o'clock, as (dy, dx)
__constant__ int c_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ bool seg9(unsigned bits) {
  unsigned acc = bits;
#pragma unroll
  for (int k = 1; k < 9; ++k) acc &= ((bits << k) | (bits >> (16 - k))) & 0xFFFFu;
  return acc != 0u;
}

__global__ void __launch_bounds__(TX * TY)
fast_nms_kernel(const float* __restrict__ in, float* __restrict__ out, int H, int W,
                float thr_hi, float thr_lo) {
  __shared__ float patch[PH][PW];
  __shared__ float score[SH][SW];

  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const size_t plane = (size_t)H * W;
  const float* img = in + blockIdx.z * plane;
  const int tid = threadIdx.y * TX + threadIdx.x;

  // 1. haloed tile, reads clamped to the image edge (edge replication)
  for (int i = tid; i < PH * PW; i += TX * TY) {
    const int py = i / PW, px = i % PW;
    const int y = min(max(y0 - HALO + py, 0), H - 1);
    const int x = min(max(x0 - HALO + px, 0), W - 1);
    patch[py][px] = img[(size_t)y * W + x];
  }
  __syncthreads();

  // 2. two-threshold score on the tile + its NMS ring; -inf outside the image
  for (int i = tid; i < SH * SW; i += TX * TY) {
    const int sy = i / SW, sx = i % SW;
    const int y = y0 - 1 + sy, x = x0 - 1 + sx;
    float s = -INFINITY;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const int cy = sy + HALO - 1, cx = sx + HALO - 1;
      const float c = patch[cy][cx];
      unsigned b_hi = 0u, d_hi = 0u, b_lo = 0u, d_lo = 0u;
      float sb_hi = 0.f, sd_hi = 0.f, sb_lo = 0.f, sd_lo = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float d = patch[cy + c_dy[k]][cx + c_dx[k]] - c;
        b_hi |= (unsigned)(d > thr_hi) << k;
        d_hi |= (unsigned)(d < -thr_hi) << k;
        b_lo |= (unsigned)(d > thr_lo) << k;
        d_lo |= (unsigned)(d < -thr_lo) << k;
        sb_hi += fmaxf(d - thr_hi, 0.f);
        sd_hi += fmaxf(-d - thr_hi, 0.f);
        sb_lo += fmaxf(d - thr_lo, 0.f);
        sd_lo += fmaxf(-d - thr_lo, 0.f);
      }
      const float s_hi = (seg9(b_hi) || seg9(d_hi)) ? fmaxf(sb_hi, sd_hi) : 0.f;
      const float s_lo = (seg9(b_lo) || seg9(d_lo)) ? fmaxf(sb_lo, sd_lo) : 0.f;
      s = fmaxf(s_hi, s_lo * 1e-3f);
    }
    score[sy][sx] = s;
  }
  __syncthreads();

  // 3. 3x3 NMS; the ragged edge of the image is masked here
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x < W && y < H) {
    const int ty = threadIdx.y + 1, tx = threadIdx.x + 1;
    const float c = score[ty][tx];
    float m = c;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) m = fmaxf(m, score[ty + dy][tx + dx]);
    out[blockIdx.z * plane + (size_t)y * W + x] = (c >= m) ? c : 0.f;
  }
}

}  // namespace

extern "C" cudaError_t fast_nms_launch(const float* in, float* out, int B, int H, int W,
                                       float thr_hi, float thr_lo, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  const dim3 block(TX, TY, 1);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  fast_nms_kernel<<<grid, block, 0, stream>>>(in, out, H, W, thr_hi, thr_lo);
  return cudaGetLastError();
}
