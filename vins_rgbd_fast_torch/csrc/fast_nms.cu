// K1: FAST-9/16 corner score + 3x3 non-maximum suppression, one pass.
//
// Replaces the Pallas TPU kernel vins_rgbd_fast_tpu/ops/fast_pallas.py
// (fast_score_nms / _fast_nms_kernel).  Same result as the plain PyTorch
// version nms3(fast_score(img, thr)) in vins_rgbd_fast_torch/ops/fast.py,
// bit for bit: every step is a float32 subtraction, min, max or negation,
// so any evaluation order gives the same bits.
//
// The least time on the H100: reading the image once and writing the
// score once, 19.7 MB for 8x480x640, take 5.9 us at 3.35 TB/s.  A pixel
// costs 38 float32 operations (16 ring differences, 8 pre-test
// comparisons, 9 for the 3x3 NMS, a few selects) and each of its
// polarities that passes the pre-test 80 more (its 9-of-16 arc term by
// doubling): 7.3 us at 67 TFLOP/s if both polarities of every pixel
// passed, but about 0.5 polarities per pixel pass on rendered frames and
// 0.9 on uniform noise, so bytes set the bound.
// Design, per 64x32 output tile (a 256-thread block; grid (W/64, H/32, B)):
//   * the tile and its halo (FAST radius 3 + NMS 1, widened to 8 columns
//     each side so every row starts on 16 bytes) are staged in shared
//     memory once, by 16-byte row loads where the row pitch allows (scalar
//     loads otherwise); ring offsets are compile-time constants;
//   * pass 1, four adjacent pixels per thread (16-byte shared reads), over
//     the 34 x 72 scores around the tile: the compass pre-test.  Every
//     contiguous 9-arc of the 16-ring holds two cyclically adjacent points
//     of {0, 4, 8, 12}, so a polarity with no adjacent compass pair beyond
//     the threshold has a term <= threshold, and a pixel where both fail
//     scores exactly 0 and skips the arc work.  Each polarity that passed
//     goes to a shared list (one atomic per warp);
//   * pass 2, one listed (pixel, polarity) per thread, so the warps run no
//     divergent arc work: the 16 differences, negated for the dark
//     polarity, and the max over the 16 starts of the 9-arc minimum by
//     doubling (pairs, quads, eights, plus one): bright = max_k min_arc d,
//     dark = max_k min_arc (-d) = -(min_k max_arc d), exactly the plain
//     version's terms.  A term beyond the (non-negative) threshold is > 0,
//     and positive floats order as their bits, so the two polarities of a
//     pixel meet in a shared integer atomicMax on a score that starts at 0;
//   * pass 3, four outputs per thread: the 3x3 NMS from the shared scores
//     (16-byte reads) and one 16-byte store.  Outside the image a score
//     reads 0 instead of the plain version's -inf: a pixel is kept only if
//     its score is > 0, so no 0 neighbour can suppress it.
// Real frames leave few survivors and the kernel moves toward its bytes;
// uniform noise defeats the pre-test and is the worst case.

#include <cuda_runtime.h>
#include <stdint.h>

#include "current_device.cuh"

namespace {

constexpr int TW = 64;               // output tile width
constexpr int TH = 32;               // output tile height
constexpr int NT = 256;              // threads per block
constexpr int PX = 4;                // adjacent pixels per thread
constexpr int R = 3;                 // FAST radius
constexpr int SC0 = 4;               // scored columns start at x0 - SC0 (16-byte aligned)
constexpr int SW = TW + 2 * SC0;     // 72 scored columns (x0-4 .. x0+67), 66 needed
constexpr int SH = TH + 2;           // 34 scored rows (y0-1 .. y0+32)
constexpr int SG = SW / PX;          // 18 groups of 4 per scored row
constexpr int IC0 = SC0 + 4;         // staged columns start at x0 - IC0
constexpr int IW = SW + 8;           // 80 staged columns (20 float4)
constexpr int IR0 = R + 1;           // staged rows start at y0 - IR0
constexpr int IH = SH + 2 * R;       // 40 staged rows
constexpr int LIST = 2 * SH * (TW + 2);  // (pixel, polarity) entries at most
constexpr unsigned FULL = 0xffffffffu;

// ring point k of the radius-3 Bresenham circle (OpenCV order, as
// FAST_OFFSETS in ops/fast.py): dy = 0 1 2 3 3 3 2 1, then negated
__host__ __device__ constexpr int ring_dy(int k) {
  return (k & 8 ? -1 : 1) * ((k & 7) <= 3 ? (k & 7) : ((k & 7) <= 5 ? 3 : 8 - (k & 7)));
}
__host__ __device__ constexpr int ring_dx(int k) { return ring_dy((k + 4) & 15); }

// max over the 16 starts of the min over a contiguous 9-arc, by doubling
__device__ __forceinline__ float max_arc_min(const float (&d)[16]) {
  float m2[16], m4[16], m8[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m2[k] = fminf(d[k], d[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m4[k] = fminf(m2[k], m2[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m8[k] = fminf(m4[k], m4[(k + 4) & 15]);
  float best = fminf(m8[0], d[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) best = fmaxf(best, fminf(m8[k], d[(k + 8) & 15]));
  return best;
}

__global__ void __launch_bounds__(NT) fast_nms_kernel(const float* __restrict__ img,
                                                      float* __restrict__ out, int H, int W,
                                                      float thr, int vec) {
  __shared__ __align__(16) float tile[IH][IW];
  __shared__ __align__(16) float score[SH][SW];  // thresholded scores, >= 0
  __shared__ unsigned short list[LIST];          // (row * SW + column) << 1 | dark
  __shared__ int n_list;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const float* im = img + (size_t)b * H * W;
  const int tid = threadIdx.x, lane = tid & 31;

  // ---- stage rows y0-4 .. y0+35, columns x0-8 .. x0+71; outside the image
  // the value is never used (those pixels lie in the 3-px border or out) ----
  if (vec) {  // W % 4 == 0 and 16-byte aligned rows
    for (int i = tid; i < IH * (IW / 4); i += NT) {
      const int ty = i / (IW / 4), tq = i - ty * (IW / 4);
      const int y = y0 - IR0 + ty, x = x0 - IC0 + 4 * tq;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (y >= 0 && y < H && x >= 0 && x < W)
        v = *reinterpret_cast<const float4*>(im + (size_t)y * W + x);
      *reinterpret_cast<float4*>(&tile[ty][4 * tq]) = v;
    }
  } else {
    for (int i = tid; i < IH * IW; i += NT) {
      const int ty = i / IW, tx = i - ty * IW;
      const int y = y0 - IR0 + ty, x = x0 - IC0 + tx;
      tile[ty][tx] = (y >= 0 && y < H && x >= 0 && x < W) ? im[(size_t)y * W + x] : 0.f;
    }
  }
  if (tid == 0) n_list = 0;
  __syncthreads();

  // ---- pass 1: the compass pre-test.  Score (sy, sc) is image (y0 - 1 +
  // sy, x0 - SC0 + sc) and tile (sy + R, sc + R + 1); group g covers
  // columns 4j .. 4j+3, tile columns 4j+4 .. 4j+7 ----
  for (int g0 = 0; g0 < SH * SG; g0 += NT) {  // warp-uniform trip count
    const int g = g0 + tid;
    bool br[PX], dk[PX];
    int cnt = 0, sy = 0, j = 0;
#pragma unroll
    for (int p = 0; p < PX; ++p) br[p] = dk[p] = false;
    if (g < SH * SG) {
      sy = g / SG;
      j = g - sy * SG;
      const float* row = &tile[sy + R][4 * j];
      const float4 a = *reinterpret_cast<const float4*>(row);
      const float4 c4 = *reinterpret_cast<const float4*>(row + 4);
      const float4 e = *reinterpret_cast<const float4*>(row + 8);
      const float4 up = *reinterpret_cast<const float4*>(row + ring_dy(12) * IW + 4);
      const float4 dn = *reinterpret_cast<const float4*>(row + ring_dy(4) * IW + 4);
      const float r0[12] = {a.x, a.y, a.z, a.w, c4.x, c4.y, c4.z, c4.w, e.x, e.y, e.z, e.w};
      const float u[4] = {up.x, up.y, up.z, up.w}, dw[4] = {dn.x, dn.y, dn.z, dn.w};
      const int y = y0 - 1 + sy;
      const bool y_core = y >= R && y < H - R;
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const int sc = 4 * j + p, x = x0 - SC0 + sc;
        // the NMS reads columns x0-1 .. x0+64; the 3-px border scores 0
        if (y_core && x >= R && x < W - R && sc >= SC0 - 1 && sc <= SC0 + TW) {
          const float c = r0[4 + p];
          const float d0 = r0[4 + p + ring_dx(0)] - c, d8 = r0[4 + p + ring_dx(8)] - c;
          const float d4 = dw[p] - c, d12 = u[p] - c;
          const float nthr = -thr;
          br[p] = (d0 > thr && d4 > thr) || (d4 > thr && d8 > thr) ||
                  (d8 > thr && d12 > thr) || (d12 > thr && d0 > thr);
          dk[p] = (d0 < nthr && d4 < nthr) || (d4 < nthr && d8 < nthr) ||
                  (d8 < nthr && d12 < nthr) || (d12 < nthr && d0 < nthr);
          cnt += (br[p] ? 1 : 0) + (dk[p] ? 1 : 0);
        }
      }
      // 0 everywhere; pass 2 raises the candidates that beat the threshold
      *reinterpret_cast<float4*>(&score[sy][4 * j]) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // warp-aggregated append: inclusive scan of the counts, one atomic
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    int base = 0;
    if (lane == 31 && incl > 0) base = atomicAdd(&n_list, incl);
    int off = __shfl_sync(FULL, base, 31) + incl - cnt;
    const unsigned pos = (unsigned)(sy * SW + 4 * j);
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      if (br[p]) list[off++] = (unsigned short)(((pos + p) << 1) | 0u);
      if (dk[p]) list[off++] = (unsigned short)(((pos + p) << 1) | 1u);
    }
  }
  __syncthreads();

  // ---- pass 2: one (pixel, polarity) per thread ----
  const int n = n_list;
  for (int i = tid; i < n; i += NT) {
    const unsigned e = list[i];
    const int pos = (int)(e >> 1);
    const int sy = pos / SW, sc = pos - sy * SW;
    const float* t = &tile[sy + R][sc + R + 1];
    // the differences, negated for the dark polarity: t * sg - c * sg is
    // t - c rounded once and then negated (rounding to nearest is
    // symmetric), so one exact fma per ring point
    const float sg = (e & 1u) ? -1.f : 1.f, csg = -t[0] * sg;
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = fmaf(t[ring_dy(k) * IW + ring_dx(k)], sg, csg);
    const float s = max_arc_min(d);
    // scores beyond the threshold are > 0, whose float order is their
    // bits' integer order; the two polarities of a pixel meet here
    if (s > thr) atomicMax(reinterpret_cast<int*>(&score[sy][sc]), __float_as_int(s));
  }
  __syncthreads();

  // ---- pass 3: 3x3 NMS, PX outputs per thread; output
  // columns 4q .. 4q+3 read scored columns 4q+3 .. 4q+8 ----
  float* o_img = out + (size_t)b * H * W;
  for (int g = tid; g < TH * (TW / PX); g += NT) {
    const int oy = g / (TW / PX), q = g - oy * (TW / PX);
    const int y = y0 + oy, x = x0 + PX * q;
    if (y >= H || x >= W) continue;
    float sv[3][PX + 2];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float* srow = &score[oy + r][4 * q];
      const float4 a = *reinterpret_cast<const float4*>(srow);
      const float4 m = *reinterpret_cast<const float4*>(srow + 4);
      const float4 z = *reinterpret_cast<const float4*>(srow + 8);
      sv[r][0] = a.w;
      sv[r][1] = m.x;
      sv[r][2] = m.y;
      sv[r][3] = m.z;
      sv[r][4] = m.w;
      sv[r][5] = z.x;
    }
    float o[PX];
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const float s = sv[1][p + 1];
      float m = s;
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) m = fmaxf(m, sv[r][p + c]);
      o[p] = (s >= m && s > 0.f) ? s : 0.f;
    }
    float* dst = o_img + (size_t)y * W + x;
    if (vec && x + PX <= W) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int p = 0; p < PX; ++p)
        if (x + p < W) dst[p] = o[p];
    }
  }
}

}  // namespace

extern "C" int fast_nms_launch(const float* img, float* out, int B, int H,
                               int W, float threshold, int device, cudaStream_t stream) {
  if (!(threshold >= 0.f)) return (int)cudaErrorInvalidValue;  // scores compare as ints
  if (B == 0 || H == 0 || W == 0) return 0;
  const cudaError_t st = check_current_device(device);
  if (st != cudaSuccess) return (int)st;
  const int vec = (W % 4 == 0) && ((uintptr_t)img % 16 == 0) && ((uintptr_t)out % 16 == 0);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  fast_nms_kernel<<<grid, NT, 0, stream>>>(img, out, H, W, threshold, vec);
  return (int)cudaGetLastError();
}
