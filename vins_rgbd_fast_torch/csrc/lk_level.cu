// K2: one Lucas-Kanade pyramid level for B x N points, template + Gauss-Newton.
// K3: the Gauss-Newton loop of one level alone, from given patches.
//
// K2 replaces the Pallas TPU kernel vins_rgbd_fast_tpu/ops/lk_pallas3.py
// (lk_level_fused -> _run_batch -> _kernel); K3 replaces
// vins_rgbd_fast_tpu/ops/lk_pallas2.py (lk_iterate -> _lk_iter_kernel).
// Both run the same Gauss-Newton loop (K2 in warp_pass, K3 in gn_iterate)
// and share sample_pos.  Same semantics as the plain PyTorch versions
// lk_level_plain and lk_iterate_plain in vins_rgbd_fast_torch/ops/lk.py
// (the port of ops/lk.py:_track_level_matmul):
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
// The least time on the H100.  Per point K2 reads a 24x24 template tile
// and a 38x38 window (8.1 KB), but no pixel of the level images needs
// reading twice: at most 13.0 MB for 8x200 points at level 0 (3.9 us at
// 3.35 TB/s) and the two 240x320 images, 4.9 MB, at level 1 (1.5 us), and
// less where tiles overlap, as they do around clustered corners.  Its
// float32 work is <= 13 passes of 441 bilinear samples, 16 operations each
// (0.16 GFLOP at 8x200 if every point ran every step, 2.4 us at 67
// TFLOP/s); most points stop after a few steps, and then bytes and
// operations take about as long.  K3 reads the template, two gradients and
// the window (11.1 KB; 2.2 MB at 1x200, 0.7 us), longer than its
// operations take.  Past the copies, each point is a chain of up to 13
// dependent passes, each ending in a sum over its 441 samples, and the
// points that need all of them set the end of the launch.
//
// K2 design (win is the compile-time 21 of both pipelines; WIN up to 48):
// one warp per point, 4 points per 128-thread block, no block barrier.  A
// warp copies its 24x24 tile of prev and its WIN x WIN window of cur into
// its own shared memory, one row per copy instruction (cp.async, each lane
// a fixed column with its clamped address: TMA would fill out-of-range
// boxes with zeros, not the edge pixel).  Both tiles have a row pitch of 53
// floats, 21 (mod 32), so the 32 consecutive samples a warp reads at once
// fall in 32 different banks.  Lane l owns samples l + 32k (k < 14): it
// takes their template and central-difference gradients straight from the
// tile (5 bilinear taps each) and keeps them, with the samples' window
// offsets, in registers for the whole loop.  A GN pass is 14 samples per
// lane (unmasked when the whole patch lies inside the window, the common
// case; otherwise clamped addresses and masks, no divergent branch) and
// one xor-butterfly over 2 values; every lane adds the same numbers in the
// same pairs, so u and done stay bitwise uniform in the warp, and each
// warp stops on its own eps.  At most 128 registers a thread keep 16 warps
// on an SM, so the 1,600 points of 8x200 are on the card at once.
//
// K3 design (unchanged): one 256-thread block per (point, sequence); its
// tiles live in shared memory (~21 KB: template, gradients and the 38x38
// window); each iteration is one pass over the 441 samples (<= 2 per
// thread) and one warp-shuffle block reduction whose result every thread
// reads, so u and the done flag stay uniform without extra
// synchronisation.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;         // K3: threads per block
constexpr int MAX_WIN = 48;     // max search window side
constexpr int MAX_S = 31 * 31;  // K3: max samples per patch (win^2)
constexpr float BIG = 1048576.f;  // sample coordinates clamp (2^20)
constexpr unsigned FULL = 0xffffffffu;

// K2's compile-time shapes
constexpr int K2_WIN = 21;                   // patch side
constexpr int K2_S = K2_WIN * K2_WIN;        // 441 samples
constexpr int K2_NK = (K2_S + 31) / 32;      // 14 samples per lane
constexpr int K2_PS = K2_WIN + 2;            // bilinear template side
constexpr int K2_PT = K2_PS + 1;             // template tile side (24)
constexpr int K2_WARPS = 4;                  // points per block
// row pitch of both shared tiles: 21 (mod 32), so sample s = 21 r + c of
// any tap sits at s + 32 r (mod 32) and a warp's 32 consecutive samples
// hit 32 different banks
constexpr int K2_P = 53;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float clampbig(float v) {
  return fminf(fmaxf(v, -BIG), BIG);
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

// ---------------------------------------------------------------- K2 ----

// sum over the warp by an xor butterfly: every lane adds the same pairs,
// so every lane returns the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// bilinear value of the template tile at tile (row a, column c), row blend
// first, then column blend (the plain version's Ey, then pe)
__device__ __forceinline__ float tile_blend(const float* T, int a, int c, float fx, float fy) {
  const float* t = T + a * K2_P + c;
  const float e0 = t[0] * (1.f - fy) + t[K2_P] * fy;
  const float e1 = t[1] * (1.f - fy) + t[K2_P + 1] * fy;
  return e0 * (1.f - fx) + e1 * fx;
}

// one bilinear sample at window offset q (the patch origin plus the
// sample's row and column) with every tap inside the window
__device__ __forceinline__ float window_blend(const float* q, const SamplePos& sp) {
  const float r0 = q[0] * (1.f - sp.fy) + q[K2_P] * sp.fy;
  const float r1 = q[1] * (1.f - sp.fy) + q[K2_P + 1] * sp.fy;
  return r0 * (1.f - sp.fx) + r1 * sp.fx;
}

// sample i of the patch when some taps may fall outside the WIN x WIN
// window: those read 0 (as in K3's sample), here by clamped addresses and masks
// rather than divergent branches
__device__ __forceinline__ float window_blend_masked(const float* wn, int WIN, int i,
                                                     const SamplePos& sp) {
  const int r = i / K2_WIN, c = i - r * K2_WIN;
  const int iy = sp.iby + r, ix = sp.ibx + c;
  const unsigned uw = (unsigned)WIN;
  const bool my0 = (unsigned)iy < uw, my1 = (unsigned)(iy + 1) < uw;
  const bool mx0 = (unsigned)ix < uw, mx1 = (unsigned)(ix + 1) < uw;
  const int y0 = clampi(iy, 0, WIN - 1) * K2_P, y1 = clampi(iy + 1, 0, WIN - 1) * K2_P;
  const int x0 = clampi(ix, 0, WIN - 1), x1 = clampi(ix + 1, 0, WIN - 1);
  const float v00 = (my0 && mx0) ? wn[y0 + x0] : 0.f, v10 = (my1 && mx0) ? wn[y1 + x0] : 0.f;
  const float v01 = (my0 && mx1) ? wn[y0 + x1] : 0.f, v11 = (my1 && mx1) ? wn[y1 + x1] : 0.f;
  const float r0 = v00 * (1.f - sp.fy) + v10 * sp.fy;
  const float r1 = v01 * (1.f - sp.fy) + v11 * sp.fy;
  return r0 * (1.f - sp.fx) + r1 * sp.fx;
}

// one pass of a lane over its samples at sp: s0 += dI * gx, s1 += dI * gy
// (ABS: s0 += |dI|), in two partial sums each (even and odd k) to halve the
// chain of dependent adds; unmasked taps when the whole patch and its +1
// taps lie inside the window (warp-uniform), masked ones otherwise
template <bool ABS>
__device__ __forceinline__ void warp_pass(const float* wn, int WIN, int lane,
                                          const SamplePos& sp, const float (&tm)[K2_NK],
                                          const float (&gx)[K2_NK], const float (&gy)[K2_NK],
                                          const int (&off)[K2_NK], float& s0, float& s1) {
  float a[2] = {0.f, 0.f}, c[2] = {0.f, 0.f};
  auto add = [&](int k, float v) {
    const float dI = v - tm[k];
    if (ABS) {
      a[k & 1] += fabsf(dI);
    } else {
      a[k & 1] += dI * gx[k];
      c[k & 1] += dI * gy[k];
    }
  };
  if (sp.ibx >= 0 && sp.iby >= 0 && sp.ibx + K2_WIN < WIN && sp.iby + K2_WIN < WIN) {
    const float* w0 = wn + sp.iby * K2_P + sp.ibx;
#pragma unroll
    for (int k = 0; k < K2_NK; ++k)
      if (k < K2_NK - 1 || lane + 32 * k < K2_S) add(k, window_blend(w0 + off[k], sp));
  } else {
#pragma unroll
    for (int k = 0; k < K2_NK; ++k) {
      const int i = lane + 32 * k;
      if (k < K2_NK - 1 || i < K2_S) add(k, window_blend_masked(wn, WIN, i, sp));
    }
  }
  s0 = a[0] + a[1];
  s1 = c[0] + c[1];
}

__global__ void __launch_bounds__(32 * K2_WARPS, 16 / K2_WARPS) lk_level_kernel(
    const float* __restrict__ prev, const float* __restrict__ cur,
    const float* __restrict__ pts, const float* __restrict__ flow,
    const unsigned char* __restrict__ active, const int* __restrict__ axs,
    const int* __restrict__ ays, float* __restrict__ u_out,
    unsigned char* __restrict__ ok_out, float* __restrict__ err_out, int BN, int N,
    int H, int W, int WIN, int iters, float eps2, float min_eig) {
  extern __shared__ __align__(16) float k2_smem[];  // per warp: tile, then window
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pi = blockIdx.x * K2_WARPS + warp;  // flat (sequence, point)
  if (pi >= BN) return;  // the whole warp
  const int b = pi / N;
  const int pad = WIN;
  const int Wp = W + 2 * pad, Hp = H + 2 * pad;
  constexpr int half = (K2_PS - 1) / 2, hw = K2_WIN / 2;
  float* T = k2_smem + warp * (K2_PT + WIN) * K2_P;
  float* wn = T + K2_PT * K2_P;
  const float* P = prev + (size_t)b * H * W;
  const float* C = cur + (size_t)b * H * W;
  const float px = pts[2 * pi], py = pts[2 * pi + 1];
  const bool act = active[pi] != 0;
  const int ax = axs[pi], ay = ays[pi];

  // ---- the two tiles, clamp-to-edge, row by row across the lanes ----
  const float bxT = floorf(clampbig(px)), byT = floorf(clampbig(py));
  const float fxT = px - bxT, fyT = py - byT;
  const int x0 = clampi((int)bxT + pad - half, 0, Wp - K2_PS - 1) - pad;
  const int y0 = clampi((int)byT + pad - half, 0, Hp - K2_PS - 1) - pad;
  // a lane owns one column of the template tile and two of the window (its
  // clamped address is fixed); each copy instruction moves one row
  const float* Pc = P + clampi(x0 + lane, 0, W - 1);
  const float* Cc0 = C + clampi(ax - pad + lane, 0, W - 1);
  const float* Cc1 = C + clampi(ax - pad + lane + 32, 0, W - 1);
#pragma unroll 4
  for (int r = 0; r < K2_PT; ++r)
    if (lane < K2_PT) cp_async4(T + r * K2_P + lane, Pc + clampi(y0 + r, 0, H - 1) * W);
#pragma unroll 4
  for (int r = 0; r < WIN; ++r) {
    const int row = clampi(ay - pad + r, 0, H - 1) * W;
    if (lane < WIN) cp_async4(wn + r * K2_P + lane, Cc0 + row);
    if (lane + 32 < WIN) cp_async4(wn + r * K2_P + lane + 32, Cc1 + row);
  }
  cp_async_wait_all();
  __syncwarp();

  // ---- template, gradients and structure tensor of this lane's samples,
  // kept in registers; off = the sample's offset in the window ----
  float tm[K2_NK], gx[K2_NK], gy[K2_NK];
  int off[K2_NK];
  float g0 = 0.f, g1 = 0.f, g2 = 0.f;
#pragma unroll
  for (int k = 0; k < K2_NK; ++k) {
    const int i = lane + 32 * k;
    const bool valid = i < K2_S;
    const int r = (valid ? i : 0) / K2_WIN, c = (valid ? i : 0) - r * K2_WIN;
    const float ix = (tile_blend(T, r + 1, c + 2, fxT, fyT) -
                      tile_blend(T, r + 1, c, fxT, fyT)) * 0.5f;
    const float iy = (tile_blend(T, r + 2, c + 1, fxT, fyT) -
                      tile_blend(T, r, c + 1, fxT, fyT)) * 0.5f;
    tm[k] = tile_blend(T, r + 1, c + 1, fxT, fyT);
    gx[k] = valid ? ix : 0.f;
    gy[k] = valid ? iy : 0.f;
    off[k] = r * K2_P + c;
    g0 += gx[k] * gx[k];
    g1 += gx[k] * gy[k];
    g2 += gy[k] * gy[k];
  }
  const float Gxx = warp_sum(g0), Gxy = warp_sum(g1), Gyy = warp_sum(g2);
  const float det = Gxx * Gyy - Gxy * Gxy;
  const float tr = Gxx + Gyy;
  const float eig_min = 0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.f * det, 0.f)));
  const bool ok_eig = eig_min / (float)K2_S >= min_eig;
  const float inv_det = 1.f / (fabsf(det) > 1e-12f ? det : 1e-12f);

  // ---- Gauss-Newton inside the window; (pxw, pyw) is the patch origin at
  // u = 0 in window coordinates ----
  const float pxw = px - ((float)ax - (float)pad) - (float)hw;
  const float pyw = py - ((float)ay - (float)pad) - (float)hw;
  float ux = flow[2 * pi], uy = flow[2 * pi + 1];
  bool done = !(act && ok_eig);
  for (int it = 0; it < iters && !done; ++it) {
    float bx, by;
    warp_pass<false>(wn, WIN, lane, sample_pos(pxw + ux, pyw + uy), tm, gx, gy, off, bx, by);
    bx = __shfl_sync(FULL, warp_sum(bx), 0);
    by = __shfl_sync(FULL, warp_sum(by), 0);
    const float dux = inv_det * (Gyy * bx - Gxy * by);
    const float duy = inv_det * (-Gxy * bx + Gxx * by);
    ux -= dux;
    uy -= duy;
    done = dux * dux + duy * duy < eps2;
  }
  float e, unused;
  warp_pass<true>(wn, WIN, lane, sample_pos(pxw + ux, pyw + uy), tm, gx, gy, off, e, unused);
  e = warp_sum(e);
  if (lane == 0) {
    u_out[2 * pi] = ux;
    u_out[2 * pi + 1] = uy;
    ok_out[pi] = ok_eig ? 1 : 0;
    err_out[pi] = e / (float)K2_S;
  }
}

// ---------------------------------------------------------------- K3 ----

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

// K3's GN loop of one point and its final mean-abs residual.  (px, py) is
// the patch origin at u = 0 in window coordinates; (ux, uy) enter as the
// warm start and leave as the result.  Every thread returns the same u and
// err.
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
  const int WIN = win + 1 + 2 * search_margin;
  if (win != K2_WIN || search_margin < 0 || WIN > MAX_WIN) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  const int BN = B * N;
  // per warp the template tile and the window, rows of K2_P floats: 51 KB
  // at WIN = 38, 60 KB at most, above the 48 KB a block gets without opting in
  const size_t smem = sizeof(float) * K2_WARPS * (K2_PT + WIN) * K2_P;
  static int opted_in_device = -1;
  int device = 0;
  cudaError_t st = cudaGetDevice(&device);
  if (st == cudaSuccess && opted_in_device != device) {
    st = cudaFuncSetAttribute(lk_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(sizeof(float) * K2_WARPS * (K2_PT + MAX_WIN) * K2_P));
    if (st == cudaSuccess) opted_in_device = device;
  }
  if (st != cudaSuccess) return (int)st;
  lk_level_kernel<<<(BN + K2_WARPS - 1) / K2_WARPS, 32 * K2_WARPS, smem, stream>>>(
      prev, cur, pts, flow, active, ax, ay, u, ok, err, BN, N, H, W, WIN, iters, eps2,
      min_eig);
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
