// FAST-16-9 corner score at two thresholds + 3x3 non-maximum suppression,
// for every level of an image pyramid in one launch.
//
// Replaces the TPU kernels orbslam3_tpu/ops/fast_pallas.py::fast_nms_pallas_batch
// (Pallas body _kernel_batched/_compute, called once a pyramid level) and
// ::fast_nms_pallas (one image). Computes, for each level's stack of B
// float32 images (B, H, W):
//
//   s   = max(fast(img, thr_hi), 1e-3f * fast(img, thr_lo))
//   out = s where s >= all 8 neighbours of s, else 0
//
// where fast() is orbslam3_tpu/ops/fast.py::fast_score (16 ring differences on
// the radius-3 Bresenham circle, a run of 9 contiguous ring pixels, SAD over
// the qualifying polarity), the image is edge-replicated, and the NMS window
// is padded with -inf. The result equals fast_score + nms3x3 over the whole
// image, borders included, and the plain PyTorch version in ops/fast_cuda.py
// bit for bit on finite images: the 16 SAD terms are accumulated in CIRCLE
// order and no multiply-add is contracted (built with --fmad=false, no fast
// math).
//
// Bound. The front end's pyramid (480x752, 8 levels, scale 1.2, stereo pair)
// has 2.23 M pixels a frame. Bytes: each float32 pixel read once and written
// once is 17.9 MB, 5.3 us at the H100's 3.35 TB/s. Arithmetic: done at every
// pixel as the plain version does it (16 differences, then 32 compares and
// 32 x (sub, max, add) for each threshold) it is about 270 float32
// operations a pixel, 0.6 GFLOP, 9 us at 67 TFLOP/s and twice that since
// none of them is a fused multiply-add: more than the bytes. So the design
// goes after arithmetic and launches first, bytes second:
//
// 1. One launch a frame. The launcher passes a table of up to 16 levels by
//    value as a kernel parameter (no upload, no synchronisation); the grid is
//    one-dimensional over all tiles of all levels and images, and a block
//    finds its level by walking the table's prefix of first tile indices.
// 2. Run test first. Pass A computes, for every site of the tile and its
//    1-pixel NMS ring, the 16 differences and the bright/dark bit masks at
//    min(thr_hi, thr_lo) only (the masks at the larger threshold are subsets
//    of these). A mask bit is the sign bit of (thr - d) or (d + thr), shifted
//    in with one funnel shift; the run of 9 is found by doubling (runs of 2,
//    4, 8, then 9) on the mask repeated twice in 32 bits. A site without a
//    run scores 0 and is finished: about 56 operations instead of 270, which
//    brings the arithmetic this data needs under the 5.3 us of the bytes.
// 3. SAD only at corners, without divergence. Sites with a run are appended
//    to a list in shared memory (one atomic a warp, positions from a ballot).
//    Pass B walks the compacted list with all 256 threads, so a warp whose
//    32 sites hold one corner does not run the SAD code for 32 lanes: there
//    the run at the smaller threshold is known, its score is the larger of
//    its two SADs, and the masks at the larger threshold put the site onto a
//    second list. Pass C accumulates the SADs at the larger threshold on
//    that list only. The order of the lists varies from run to run; each
//    entry writes only its own score, so the output does not.
// 4. Tiles of 64x16 outputs for 256 threads: the haloed patch is 72x24 (1.69
//    loads an output) and 66x18 sites are scored (1.16 an output). The patch
//    is filled with 16-byte loads: a row whose first patch pixel is not
//    16-byte aligned is read from the aligned address below it and stored
//    shifted, so every row of every level shape takes the wide path; only
//    groups that cross the image's edge fall back to scalar clamped loads.
//    Ring offsets are literals, so the unrolled loads index shared memory
//    with immediates. NMS takes a column of 4 outputs a thread and reuses the
//    row maxima (20 max operations for 4 outputs instead of 32).
//
// Left out: cp.async / TMA for the patch (a TMA box cannot replicate the
// image's edge, and with several 16 KB blocks resident on every SM the loads
// of one block already overlap the arithmetic of another); thread block
// clusters (neighbouring tiles share only the 4-pixel halo, which L2 serves);
// wgmma (a stencil of compares has no matrix product). What keeps the kernel
// above its bound is instruction throughput: the bound counts float
// operations, and beside each of them pass A runs a shared-memory load or a
// shift on the half-rate integer pipe (about 125 instructions a site, and about 200
// more at a site on the first list). Smaller tiles (32x16, 64x8, 128x8) were
// timed and are slower, 32x32 is equal. Measured times are in PERF.md.
//
// Images must be finite: a NaN pixel would set a mask bit here (sign bit)
// where the plain version's compare is false.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef FAST_TX
#define FAST_TX 64
#endif
#ifndef FAST_TY
#define FAST_TY 16
#endif
#ifndef FAST_MAX_LEVELS
#define FAST_MAX_LEVELS 16
#endif

// One pyramid level: (B, H, W) in and out, tiles across, and the flat index
// of its first tile in the grid. Mirrored by ops/fast_cuda.py with ctypes.
struct FastNmsLevel {
  const float* in;
  float* out;
  int H, W, tiles_x, first;
};

struct FastNmsTable {
  FastNmsLevel lv[FAST_MAX_LEVELS];
  int n, B, total;
};

namespace {

constexpr int TX = FAST_TX;
constexpr int TY = FAST_TY;
constexpr int NT = 256;
constexpr int HALO = 4;  // 3 px Bresenham circle + 1 px NMS ring
constexpr int PW = TX + 2 * HALO;
constexpr int PH = TY + 2 * HALO;
constexpr int SW = TX + 2;
constexpr int SH = TY + 2;
constexpr int NS = SW * SH;
constexpr int NV = PW / 4 + 1;        // aligned 16-byte groups that can touch one patch row
constexpr int RPT = TY / (NT / TX);   // NMS outputs a thread (one column of RPT rows)
static_assert(TX % 4 == 0 && HALO % 4 == 0, "patch rows are filled in groups of 4 floats");
static_assert(NT % TX == 0 && RPT * (NT / TX) == TY, "NMS: NT threads cover TX x TY outputs");
static_assert(NS < 65536, "site indices are kept in 16 bits");

// ops/fast.py::CIRCLE, clockwise from 12 o'clock: F(k, dy, dx)
#define FAST_RING(F)                                                                 \
  F(0, -3, 0) F(1, -3, 1) F(2, -2, 2) F(3, -1, 3) F(4, 0, 3) F(5, 1, 3) F(6, 2, 2)  \
  F(7, 3, 1) F(8, 3, 0) F(9, 3, -1) F(10, 2, -2) F(11, 1, -3) F(12, 0, -3)          \
  F(13, -1, -3) F(14, -2, -2) F(15, -3, -1)

// any run of >= 9 consecutive set bits on the 16-bit circle
__device__ __forceinline__ bool run9(unsigned bits) {
  const unsigned w = bits | (bits << 16);
  unsigned r = w & (w >> 1);  // runs of 2
  r &= r >> 2;                // runs of 4
  r &= r >> 4;                // runs of 8
  r &= w >> 8;                // runs of 9
  return (r & 0xFFFFu) != 0u;
}

__global__ void __launch_bounds__(NT)
fast_nms_kernel(const __grid_constant__ FastNmsTable t, float thr_hi, float thr_lo) {
  __shared__ __align__(16) float patch[PH][PW];
  __shared__ float score[SH][SW];
  __shared__ unsigned short cand[NS], cand2[NS];
  __shared__ int n_cand, n_cand2;

  const int tid = threadIdx.x;
  const int bid = blockIdx.x;

  // this block's level (the last whose first tile is <= bid), image and tile
  int l = 0;
#pragma unroll
  for (int i = 1; i < FAST_MAX_LEVELS; ++i)
    if (i < t.n && bid >= t.lv[i].first) l = i;
  const int H = t.lv[l].H, W = t.lv[l].W, tiles_x = t.lv[l].tiles_x;
  const int per_img = tiles_x * ((H + TY - 1) / TY);
  int rem = bid - t.lv[l].first;
  const int b = rem / per_img;
  rem -= b * per_img;
  const int tile_y = rem / tiles_x;
  const int x0 = (rem - tile_y * tiles_x) * TX;
  const int y0 = tile_y * TY;
  const size_t plane = (size_t)H * W;
  const float* img = t.lv[l].in + b * plane;
  float* out = t.lv[l].out + b * plane;

  // 1. haloed tile, edge-replicated, in aligned groups of 4 floats
  if (tid == 0) n_cand = n_cand2 = 0;
  for (int task = tid; task < PH * NV; task += NT) {
    const int r = task / NV, j = task - r * NV;
    const int y = min(max(y0 - HALO + r, 0), H - 1);
    const float* row = img + (size_t)y * W;
    // floats by which the row's first patch pixel lies above a 16-byte boundary
    const int m = (int)(((reinterpret_cast<uintptr_t>(row) >> 2) + (uintptr_t)x0) & 3u);
    const int px0 = 4 * j - m;           // patch column of the group's first float
    const int xs = x0 - HALO + px0;      // its image column
    float v[4];
    if (xs >= 0 && xs + 3 < W) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(row + xs));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = __ldg(row + min(max(xs + e, 0), W - 1));
    }
    if (m == 0) {
      if (j < PW / 4) *reinterpret_cast<float4*>(&patch[r][px0]) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (px0 + e >= 0 && px0 + e < PW) patch[r][px0 + e] = v[e];
    }
  }
  __syncthreads();

  // 2. pass A: run test at the smaller threshold on the tile + its NMS ring.
  //    -inf outside the image, 0 without a run, else onto the list.
  const float thr_t = fminf(thr_hi, thr_lo);
  const int lane = tid & 31;
  for (int it = 0; it < (NS + NT - 1) / NT; ++it) {
    const int i = it * NT + tid;
    bool is_cand = false;
    if (i < NS) {
      const int sy = i / SW, sx = i - sy * SW;
      const int y = y0 - 1 + sy, x = x0 - 1 + sx;
      if (y >= 0 && y < H && x >= 0 && x < W) {
        const float* p = &patch[sy + HALO - 1][sx + HALO - 1];
        const float c = p[0];
        float d[16];
#define FAST_DIFF(k, dy, dx) d[k] = p[(dy) * PW + (dx)] - c;
        FAST_RING(FAST_DIFF)
#undef FAST_DIFF
        unsigned bright = 0u, dark = 0u;
#pragma unroll
        for (int k = 15; k >= 0; --k) {  // bit k: d[k] > thr_t, d[k] < -thr_t
          bright = __funnelshift_l(__float_as_uint(thr_t - d[k]), bright, 1);
          dark = __funnelshift_l(__float_as_uint(d[k] + thr_t), dark, 1);
        }
        is_cand = run9(bright) || run9(dark);
        if (!is_cand) score[sy][sx] = 0.f;
      } else {
        score[sy][sx] = -INFINITY;
      }
    }
    const unsigned votes = __ballot_sync(0xFFFFFFFFu, is_cand);
    if (votes != 0u) {
      const int leader = __ffs(votes) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(&n_cand, __popc(votes));
      base = __shfl_sync(0xFFFFFFFFu, base, leader);
      if (is_cand) cand[base + __popc(votes & ((1u << lane) - 1u))] = (unsigned short)i;
    }
  }
  __syncthreads();

  // 3. pass B: at a listed site the run at the smaller threshold exists, so
  //    its score is the larger SAD; the masks at the larger threshold decide
  //    whether the site goes onto the second list. All lanes of a warp make
  //    the same number of turns (q0 is the warp's), as the ballot needs.
  const bool hi_is_large = thr_hi >= thr_lo;
  const float thr_l = fmaxf(thr_hi, thr_lo);
  const int nc = n_cand;
  for (int q0 = tid - lane; q0 < nc; q0 += NT) {
    const int q = q0 + lane;
    bool is_cand = false;
    int i = 0;
    if (q < nc) {
      i = cand[q];
      const int sy = i / SW, sx = i - sy * SW;
      const float* p = &patch[sy + HALO - 1][sx + HALO - 1];
      const float c = p[0];
      float d[16];
#define FAST_DIFF(k, dy, dx) d[k] = p[(dy) * PW + (dx)] - c;
      FAST_RING(FAST_DIFF)
#undef FAST_DIFF
      float sb = 0.f, sd = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {  // CIRCLE order
        sb += fmaxf(d[k] - thr_t, 0.f);
        sd += fmaxf(-d[k] - thr_t, 0.f);
      }
      unsigned bright = 0u, dark = 0u;
#pragma unroll
      for (int k = 15; k >= 0; --k) {
        bright = __funnelshift_l(__float_as_uint(thr_l - d[k]), bright, 1);
        dark = __funnelshift_l(__float_as_uint(d[k] + thr_l), dark, 1);
      }
      is_cand = run9(bright) || run9(dark);
      const float s_small = fmaxf(sb, sd);
      // final where the larger threshold has no run (its score is 0), else kept for pass C
      score[sy][sx] = is_cand ? s_small
                              : (hi_is_large ? fmaxf(0.f, s_small * 1e-3f) : fmaxf(s_small, 0.f));
    }
    const unsigned votes = __ballot_sync(0xFFFFFFFFu, is_cand);
    if (votes != 0u) {
      const int leader = __ffs(votes) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(&n_cand2, __popc(votes));
      base = __shfl_sync(0xFFFFFFFFu, base, leader);
      if (is_cand) cand2[base + __popc(votes & ((1u << lane) - 1u))] = (unsigned short)i;
    }
  }
  __syncthreads();

  // 4. pass C: the SAD at the larger threshold, only where it has a run
  const int nc2 = n_cand2;
  for (int q = tid; q < nc2; q += NT) {
    const int i = cand2[q];
    const int sy = i / SW, sx = i - sy * SW;
    const float* p = &patch[sy + HALO - 1][sx + HALO - 1];
    const float c = p[0];
    float sb = 0.f, sd = 0.f;
#define FAST_ACC(k, dy, dx)                  \
  {                                          \
    const float d = p[(dy) * PW + (dx)] - c; \
    sb += fmaxf(d - thr_l, 0.f);             \
    sd += fmaxf(-d - thr_l, 0.f);            \
  }
    FAST_RING(FAST_ACC)
#undef FAST_ACC
    const float s_large = fmaxf(sb, sd), s_small = score[sy][sx];
    score[sy][sx] = hi_is_large ? fmaxf(s_large, s_small * 1e-3f)
                                : fmaxf(s_small, s_large * 1e-3f);
  }
  __syncthreads();

  // 5. 3x3 NMS, a column of RPT outputs a thread; the ragged edge is masked here
  const int cx = tid % TX, r0 = (tid / TX) * RPT;
  const int x = x0 + cx;
  if (x < W) {
    float hmax[RPT + 2], ctr[RPT + 2];
#pragma unroll
    for (int r = 0; r < RPT + 2; ++r) {
      ctr[r] = score[r0 + r][cx + 1];
      hmax[r] = fmaxf(fmaxf(score[r0 + r][cx], ctr[r]), score[r0 + r][cx + 2]);
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int y = y0 + r0 + r;
      if (y < H) {
        const float m = fmaxf(fmaxf(hmax[r], hmax[r + 1]), hmax[r + 2]);
        out[(size_t)y * W + x] = (ctr[r + 1] >= m) ? ctr[r + 1] : 0.f;
      }
    }
  }
}

}  // namespace

// One launch over every tile of every level. Returns the launch's error.
extern "C" cudaError_t fast_nms_launch(const FastNmsTable* t, float thr_hi, float thr_lo,
                                       cudaStream_t stream) {
  if (t == nullptr || t->n <= 0 || t->n > FAST_MAX_LEVELS || t->B <= 0 || t->total <= 0)
    return cudaErrorInvalidValue;
  fast_nms_kernel<<<t->total, NT, 0, stream>>>(*t, thr_hi, thr_lo);
  return cudaGetLastError();
}
