// K2: one Lucas-Kanade pyramid level for B x N points, template + Gauss-Newton.
// K3: the Gauss-Newton loop of one level alone, from given patches.
//
// K2 replaces the Pallas TPU kernel vins_rgbd_fast_tpu/ops/lk_pallas3.py
// (lk_level_fused -> _run_batch -> _kernel); K3 replaces
// vins_rgbd_fast_tpu/ops/lk_pallas2.py (lk_iterate -> _lk_iter_kernel).
// Both run the same loop (gn_iterate below).  Same semantics as the plain
// PyTorch versions lk_level_plain and lk_iterate_plain in
// vins_rgbd_fast_torch/ops/lk.py (the port of ops/lk.py:_track_level_matmul):
//   * the level image is edge-padded by WIN = win + 1 + 2*search_margin; K2
//     reads the unpadded image with clamp-to-edge addressing instead of
//     materialising the padded copy;
//   * a (PS+1)^2 tile from prev (PS = win + 2) gives the bilinear PS x PS
//     template at pts_l, central-difference gradients, the 2x2 structure
//     tensor and the min-eigenvalue gate (K2 only; K3 is handed them);
//   * each GN iteration samples win x win bilinearly inside the WIN x WIN
//     search window at p + u, p the patch origin in window coordinates;
//     samples outside the window read 0 (the masked selectors of the TPU
//     kernels); a point stops once |du| < eps, which gives the same u as
//     the done-masked fixed count; err is the mean |final sample - template|
//     for every point, done or not.
//
// What bounds them on the H100: latency, not bytes or FLOPs.  B*N (200 to
// 1600) independent tiny problems per level (~1 K flops per sample, 441
// samples, up to 12 iterations), each a chain of dependent block
// reductions.  Design: one 256-thread block per (point, sequence); the
// tiles live in shared memory (K2 ~34 KB, K3 ~21 KB: template, gradients
// and the 38x38 window), so the only device-memory traffic is one read of
// each tile; each iteration is one pass over the 441 samples (<= 2 per
// thread) and one warp-shuffle block reduction whose result every thread
// reads, so u and the done flag stay uniform without extra synchronisation.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;         // threads per block
constexpr int MAX_T = 33;       // max template tile side (PS + 1)
constexpr int MAX_WIN = 48;     // max search window side
constexpr int MAX_S = 31 * 31;  // max samples per patch (win^2)
constexpr float BIG = 1048576.f;  // sample coordinates clamp (2^20)

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float clampbig(float v) {
  return fminf(fmaxf(v, -BIG), BIG);
}

// Sum of NV values over the block; every thread returns the same sums.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float (*red)[NT / 32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
  __syncthreads();  // previous readers of red are done
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) red[k][warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += red[k][w];
    v[k] = s;
  }
}

struct SamplePos {
  int ibx, iby;  // integer origin of the win x win patch in window coords
  float fx, fy;  // bilinear fractions
};

// integer origin and fractions of the patch at window coordinates (sx, sy);
// NaN and huge values are clamped first (a float-to-int cast of NaN is
// undefined), which sends them outside the window
__device__ __forceinline__ SamplePos sample_pos(float sx, float sy) {
  sx = clampbig(sx);
  sy = clampbig(sy);
  const float bx = floorf(sx), by = floorf(sy);
  return SamplePos{(int)bx, (int)by, sx - bx, sy - by};
}

// bilinear sample i (row-major in the win x win patch); taps outside the
// WIN x WIN window read 0 (row blend first, then column blend)
__device__ __forceinline__ float sample(const float* wn, int WIN, int win, int i,
                                        const SamplePos& sp) {
  const int r = i / win, c = i % win;
  const int iy0 = sp.iby + r, iy1 = iy0 + 1, ix0 = sp.ibx + c, ix1 = ix0 + 1;
  const bool my0 = iy0 >= 0 && iy0 < WIN, my1 = iy1 >= 0 && iy1 < WIN;
  const bool mx0 = ix0 >= 0 && ix0 < WIN, mx1 = ix1 >= 0 && ix1 < WIN;
  float rw0 = 0.f, rw1 = 0.f;
  if (mx0) {
    rw0 = (my0 ? wn[iy0 * WIN + ix0] * (1.f - sp.fy) : 0.f)
        + (my1 ? wn[iy1 * WIN + ix0] * sp.fy : 0.f);
  }
  if (mx1) {
    rw1 = (my0 ? wn[iy0 * WIN + ix1] * (1.f - sp.fy) : 0.f)
        + (my1 ? wn[iy1 * WIN + ix1] * sp.fy : 0.f);
  }
  return (mx0 ? rw0 * (1.f - sp.fx) : 0.f) + (mx1 ? rw1 * sp.fx : 0.f);
}

// The GN loop of one point and its final mean-abs residual, shared by K2
// and K3.  (px, py) is the patch origin at u = 0 in window coordinates;
// (ux, uy) enter as the warm start and leave as the result.  Every thread
// returns the same u and err.
__device__ __forceinline__ float gn_iterate(const float* wn, const float* tmpl,
                                            const float* gx, const float* gy,
                                            int WIN, int win, float px, float py,
                                            float Gxx, float Gxy, float Gyy,
                                            float inv_det, bool done, int iters,
                                            float eps2, float& ux, float& uy,
                                            float (*red)[NT / 32]) {
  const int tid = threadIdx.x, S = win * win;
  for (int it = 0; it < iters && !done; ++it) {
    const SamplePos sp = sample_pos(px + ux, py + uy);
    float bsum[2] = {0.f, 0.f};
    for (int i = tid; i < S; i += NT) {
      const float dI = sample(wn, WIN, win, i, sp) - tmpl[i];
      bsum[0] += dI * gx[i];
      bsum[1] += dI * gy[i];
    }
    block_sum<2>(bsum, red);
    const float dux = inv_det * (Gyy * bsum[0] - Gxy * bsum[1]);
    const float duy = inv_det * (-Gxy * bsum[0] + Gxx * bsum[1]);
    ux -= dux;
    uy -= duy;
    done = dux * dux + duy * duy < eps2;
  }
  const SamplePos sp = sample_pos(px + ux, py + uy);
  float e[1] = {0.f};
  for (int i = tid; i < S; i += NT) e[0] += fabsf(sample(wn, WIN, win, i, sp) - tmpl[i]);
  block_sum<1>(e, red);
  return e[0] / (float)S;
}

__global__ void __launch_bounds__(NT) lk_level_kernel(
    const float* __restrict__ prev, const float* __restrict__ cur,
    const float* __restrict__ pts, const float* __restrict__ flow,
    const unsigned char* __restrict__ active, const int* __restrict__ axs,
    const int* __restrict__ ays, float* __restrict__ u_out,
    unsigned char* __restrict__ ok_out, float* __restrict__ err_out, int N,
    int H, int W, int win, int sm, int iters, float eps2, float min_eig) {
  __shared__ float T[MAX_T * MAX_T];        // template tile (PS+1)^2
  __shared__ float Ey[MAX_T * MAX_T];       // row-blended tile PS x (PS+1)
  __shared__ float pe[MAX_T * MAX_T];       // bilinear patch PS x PS
  __shared__ float tmpl[MAX_S], gx[MAX_S], gy[MAX_S];
  __shared__ float wn[MAX_WIN * MAX_WIN];   // search window WIN x WIN
  __shared__ float red[3][NT / 32];

  const int n = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int PS = win + 2, WIN = win + 1 + 2 * sm, pad = WIN;
  const int Wp = W + 2 * pad, Hp = H + 2 * pad;
  const int half = (PS - 1) / 2, hw = win / 2, S = win * win, PT = PS + 1;
  const float* P = prev + (size_t)b * H * W;
  const float* C = cur + (size_t)b * H * W;
  const size_t pi = (size_t)b * N + n;
  const float px = pts[2 * pi], py = pts[2 * pi + 1];
  const bool act = active[pi] != 0;
  const int ax = axs[pi], ay = ays[pi];

  // ---- template: (PS+1)^2 tile, row blend, column blend ----
  const float bxT = floorf(clampbig(px)), byT = floorf(clampbig(py));
  const float fxT = px - bxT, fyT = py - byT;
  const int x0 = clampi((int)bxT + pad - half, 0, Wp - PS - 1);
  const int y0 = clampi((int)byT + pad - half, 0, Hp - PS - 1);
  for (int i = tid; i < PT * PT; i += NT) {
    const int r = i / PT, c = i % PT;
    T[i] = P[clampi(y0 + r - pad, 0, H - 1) * W + clampi(x0 + c - pad, 0, W - 1)];
  }
  for (int i = tid; i < WIN * WIN; i += NT) {
    const int r = i / WIN, c = i % WIN;
    wn[i] = C[clampi(ay + r - pad, 0, H - 1) * W + clampi(ax + c - pad, 0, W - 1)];
  }
  __syncthreads();
  for (int i = tid; i < PS * PT; i += NT) {
    const int r = i / PT, c = i % PT;
    Ey[i] = T[r * PT + c] * (1.f - fyT) + T[(r + 1) * PT + c] * fyT;
  }
  __syncthreads();
  for (int i = tid; i < PS * PS; i += NT) {
    const int r = i / PS, c = i % PS;
    pe[i] = Ey[r * PT + c] * (1.f - fxT) + Ey[r * PT + c + 1] * fxT;
  }
  __syncthreads();
  float g[3] = {0.f, 0.f, 0.f};
  for (int i = tid; i < S; i += NT) {
    const int r = i / win + 1, c = i % win + 1;
    const float ix = (pe[r * PS + c + 1] - pe[r * PS + c - 1]) * 0.5f;
    const float iy = (pe[(r + 1) * PS + c] - pe[(r - 1) * PS + c]) * 0.5f;
    tmpl[i] = pe[r * PS + c];
    gx[i] = ix;
    gy[i] = iy;
    g[0] += ix * ix;
    g[1] += ix * iy;
    g[2] += iy * iy;
  }
  block_sum<3>(g, red);  // also orders tmpl/gx/gy writes before the reads below
  const float Gxx = g[0], Gxy = g[1], Gyy = g[2];
  const float det = Gxx * Gyy - Gxy * Gxy;
  const float tr = Gxx + Gyy;
  const float eig_min = 0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.f * det, 0.f)));
  const bool ok_eig = eig_min / (float)(win * win) >= min_eig;
  const float inv_det = 1.f / (fabsf(det) > 1e-12f ? det : 1e-12f);

  const float axf = (float)ax - (float)pad, ayf = (float)ay - (float)pad;
  float ux = flow[2 * pi], uy = flow[2 * pi + 1];
  const float err = gn_iterate(wn, tmpl, gx, gy, WIN, win, px - axf - (float)hw,
                               py - ayf - (float)hw, Gxx, Gxy, Gyy, inv_det,
                               !(act && ok_eig), iters, eps2, ux, uy, red);
  if (tid == 0) {
    u_out[2 * pi] = ux;
    u_out[2 * pi + 1] = uy;
    ok_out[pi] = ok_eig ? 1 : 0;
    err_out[pi] = err;
  }
}

// K3: tmpl/Ix/Iy (B, N, win, win), the window (B, N, WIN, WIN) and the
// per-point scalars (B, N) as lk_iterate_plain takes them.
__global__ void __launch_bounds__(NT) lk_iterate_kernel(
    const float* __restrict__ tmpl_g, const float* __restrict__ ix_g,
    const float* __restrict__ iy_g, const float* __restrict__ win_g,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ u0, const unsigned char* __restrict__ done0,
    const float* __restrict__ inv_det, const float* __restrict__ gxx,
    const float* __restrict__ gxy, const float* __restrict__ gyy,
    float* __restrict__ u_out, float* __restrict__ err_out, int N, int win,
    int WIN, int iters, float eps2) {
  __shared__ float tmpl[MAX_S], gx[MAX_S], gy[MAX_S];
  __shared__ float wn[MAX_WIN * MAX_WIN];
  __shared__ float red[2][NT / 32];

  const int n = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int S = win * win, WW = WIN * WIN;
  const size_t pi = (size_t)b * N + n;
  for (int i = tid; i < S; i += NT) {
    tmpl[i] = tmpl_g[pi * S + i];
    gx[i] = ix_g[pi * S + i];
    gy[i] = iy_g[pi * S + i];
  }
  for (int i = tid; i < WW; i += NT) wn[i] = win_g[pi * WW + i];
  __syncthreads();
  float ux = u0[2 * pi], uy = u0[2 * pi + 1];
  const float err = gn_iterate(wn, tmpl, gx, gy, WIN, win, px[pi], py[pi], gxx[pi],
                               gxy[pi], gyy[pi], inv_det[pi], done0[pi] != 0, iters,
                               eps2, ux, uy, red);
  if (tid == 0) {
    u_out[2 * pi] = ux;
    u_out[2 * pi + 1] = uy;
    err_out[pi] = err;
  }
}

}  // namespace

extern "C" int lk_level_launch(const float* prev, const float* cur,
                               const float* pts, const float* flow,
                               const unsigned char* active, const int* ax,
                               const int* ay, float* u, unsigned char* ok,
                               float* err, int B, int N, int H, int W, int win,
                               int search_margin, int iters, float eps2,
                               float min_eig, cudaStream_t stream) {
  if (win + 3 > MAX_T || win + 1 + 2 * search_margin > MAX_WIN || win * win > MAX_S)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  dim3 grid(N, B);
  lk_level_kernel<<<grid, NT, 0, stream>>>(prev, cur, pts, flow, active, ax, ay,
                                           u, ok, err, N, H, W, win,
                                           search_margin, iters, eps2, min_eig);
  return (int)cudaGetLastError();
}

extern "C" int lk_iterate_launch(const float* tmpl, const float* ix, const float* iy,
                                 const float* win, const float* px, const float* py,
                                 const float* u0, const unsigned char* done0,
                                 const float* inv_det, const float* gxx,
                                 const float* gxy, const float* gyy, float* u,
                                 float* err, int B, int N, int w, int WIN, int iters,
                                 float eps2, cudaStream_t stream) {
  if (w * w > MAX_S || WIN > MAX_WIN) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  dim3 grid(N, B);
  lk_iterate_kernel<<<grid, NT, 0, stream>>>(tmpl, ix, iy, win, px, py, u0, done0,
                                             inv_det, gxx, gxy, gyy, u, err, N, w,
                                             WIN, iters, eps2);
  return (int)cudaGetLastError();
}
