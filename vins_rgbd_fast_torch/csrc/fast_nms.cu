// K1: FAST-9/16 corner score + 3x3 non-maximum suppression, one pass.
//
// Replaces the Pallas TPU kernel vins_rgbd_fast_tpu/ops/fast_pallas.py
// (fast_score_nms / _fast_nms_kernel).  Same result as the plain PyTorch
// version nms3(fast_score(img, thr)) in vins_rgbd_fast_torch/ops/fast.py,
// bit for bit: every step is a float32 subtraction, min or max.
//
// What bounds it on the H100: memory traffic.  A 640x480 frame is 1.2 MB in
// and 1.2 MB out, with ~100 min/max operations per pixel; the plain version
// instead writes a (16+8, H, W) ring stack and its arc minima to device
// memory.  Design: one thread per output pixel, grid (W/32, H/8, B).  Each
// block stages its 8x32 tile plus a 4-pixel halo (FAST radius 3 + NMS 1)
// in shared memory once, scores the (8+2)x(32+2) ring it needs for NMS into
// shared memory, and writes only the final NMS'd score.  The image is read
// once from device memory (the halo re-reads hit L2).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TW = 32;         // tile width (one warp per row)
constexpr int TH = 8;          // tile height
constexpr int HALO = 4;        // FAST radius 3 + NMS radius 1
constexpr int IW = TW + 2 * HALO;
constexpr int IH = TH + 2 * HALO;
constexpr int SW = TW + 2;     // scored ring for NMS
constexpr int SH = TH + 2;

__constant__ int kDy[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kDx[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};

__device__ __forceinline__ float arc_best(const float* d) {
  // max over the 16 start positions of the min over a contiguous arc of 9
  float best = -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float m = d[k];
#pragma unroll
    for (int j = 1; j < 9; ++j) m = fminf(m, d[(k + j) & 15]);
    best = fmaxf(best, m);
  }
  return best;
}

__global__ void fast_nms_kernel(const float* __restrict__ img,
                                float* __restrict__ out, int H, int W,
                                float threshold) {
  __shared__ float tile[IH][IW];
  __shared__ float score[SH][SW];
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const float* im = img + (size_t)b * H * W;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int nthreads = TW * TH;

  // image tile with halo; outside the image the value is never used
  // (those pixels lie in the zeroed 3-px border or outside)
  for (int i = tid; i < IH * IW; i += nthreads) {
    int ty = i / IW, tx = i % IW;
    int y = y0 - HALO + ty, x = x0 - HALO + tx;
    tile[ty][tx] = (y >= 0 && y < H && x >= 0 && x < W) ? im[(size_t)y * W + x] : 0.f;
  }
  __syncthreads();

  // scores on the (TH+2) x (TW+2) ring; -inf outside the image
  for (int i = tid; i < SH * SW; i += nthreads) {
    int sy = i / SW, sx = i % SW;
    int y = y0 - 1 + sy, x = x0 - 1 + sx;
    float s;
    if (y < 0 || y >= H || x < 0 || x >= W) {
      s = -CUDART_INF_F;
    } else if (y < 3 || y >= H - 3 || x < 3 || x >= W - 3) {
      s = 0.f;
    } else {
      const int cy = sy + HALO - 1, cx = sx + HALO - 1;
      const float c = tile[cy][cx];
      float db[16], dd[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        db[k] = tile[cy + kDy[k]][cx + kDx[k]] - c;
        dd[k] = -db[k];
      }
      s = fmaxf(arc_best(db), arc_best(dd));
      s = (s > threshold) ? s : 0.f;
    }
    score[sy][sx] = s;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x < W && y < H) {
    const float s = score[threadIdx.y + 1][threadIdx.x + 1];
    float m = s;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        m = fmaxf(m, score[threadIdx.y + dy][threadIdx.x + dx]);
    out[(size_t)b * H * W + (size_t)y * W + x] = (s >= m && s > 0.f) ? s : 0.f;
  }
}

}  // namespace

extern "C" int fast_nms_launch(const float* img, float* out, int B, int H,
                               int W, float threshold, cudaStream_t stream) {
  dim3 block(TW, TH);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  fast_nms_kernel<<<grid, block, 0, stream>>>(img, out, H, W, threshold);
  return (int)cudaGetLastError();
}
