// K2: one Lucas-Kanade pyramid level for B x N points, template + Gauss-Newton.
// K3: the Gauss-Newton loop of one level alone, from given patches.
//
// K2 replaces the Pallas TPU kernel vins_rgbd_fast_tpu/ops/lk_pallas3.py
// (lk_level_fused -> _run_batch -> _kernel); K3 replaces
// vins_rgbd_fast_tpu/ops/lk_pallas2.py (lk_iterate -> _lk_iter_kernel).
// Both run one Gauss-Newton loop, gn_solve, and share sample_pos.  Same
// semantics as the plain PyTorch versions lk_level_plain and
// lk_iterate_plain in vins_rgbd_fast_torch/ops/lk.py (the port of
// ops/lk.py:_track_level_matmul):
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
// win is the compile-time 21 of both pipelines, WIN at most 48.
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
// the window (11.1 KB; 2.2 MB at 1x200, 0.66 us), longer than its
// operations take.  Past the copies, each point is a chain of up to 13
// dependent passes, each ending in a sum over its 441 samples, and the
// points that need all of them set the end of the launch.
//
// The shared Gauss-Newton loop (gn_solve).  The NW warps of a point own its
// 441 samples in turn: thread t takes samples t + 32*NW*k (k < NK), keeps
// their template and gradient values and their offsets in the window in
// registers for the whole loop, and each pass samples the window in shared
// memory at a row pitch of 53 floats, 21 (mod 32), so that the 32
// consecutive samples a warp reads at once fall in 32 different banks.  A
// pass is NK samples per thread, unmasked when the whole patch and its +1
// taps lie inside the window (uniform over the point, the common case),
// otherwise by clamped addresses and masks (no divergent branch), then one
// xor-butterfly per warp; every lane adds the same numbers in the same
// pairs, so every lane gets the same bits.  With NW > 1 each warp's lane 0
// puts its sums in shared memory and the point's warps alone meet at a
// named barrier (bar.sync id, 32*NW), then every thread adds the NW partial
// sums in one order.  So u and done stay bitwise uniform over the point,
// and each point stops on its own eps, with no block-wide barrier.
//
// K2 design: one warp per point (NW = 1), 4 points per 128-thread block.  A
// warp copies its 24x24 tile of prev and its WIN x WIN window of cur into
// its own shared memory, one row per copy instruction (cp.async, each lane
// a fixed column with its clamped address: TMA would fill out-of-range
// boxes with zeros, not the edge pixel), both at pitch 53.  Each lane takes
// its 14 samples' template and central-difference gradients straight from
// the tile (5 bilinear taps each).  At most 128 registers a thread keep 16
// warps on an SM, so the 1,600 points of 8x200 are on the card at once.
//
// K3 design.  What bounded the earlier block-per-point K3: each pass ended
// in a block reduction (two __syncthreads over 8 warps and 8 serial shared
// reads per value), 441 samples over 256 threads left 71 threads idle in
// their second round, each sample divided by a runtime win and branched on
// four tap masks, the loop read the template and both gradients back from
// shared memory in every pass, and the point's 11.1 KB came in by scalar
// loads behind a block barrier.  Now one block of K3_WARPS = 4 warps per
// point (on an H100 SXM at 700 W, 4 warps beat 2 by 2-4 % and 1 by 17-22 %
// at 1x200; 2 are faster at 8x200, which no path runs).  Each thread loads its NK = 4 template and gradient values from
// device memory once, coalesced (thread t reads element t + 128*k), into
// registers; the point's window goes to shared memory at pitch 53 by
// cp.async, one row per copy instruction and warp (~8 KB at WIN = 38); the
// loop is gn_solve, whose passes end in one butterfly per warp and one
// exchange of the four warps' sums under a named barrier.  At 1x200 the
// points are about one block per SM, so what is left is the chain of passes
// of the slowest point, each about two butterflies, a barrier and a few
// dependent loads long, and the launch.

#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

#include "current_device.cuh"

namespace {

constexpr int MAX_WIN = 48;  // max search window side
constexpr float BIG = 1048576.f;  // sample coordinates clamp (2^20)
constexpr unsigned FULL = 0xffffffffu;

// the compile-time patch of both kernels
constexpr int LK_W = 21;             // patch side
constexpr int LK_S = LK_W * LK_W;    // 441 samples
// row pitch of the shared tiles: 21 (mod 32), so sample s = 21 r + c of
// any tap sits at s + 32 r (mod 32) and a warp's 32 consecutive samples
// hit 32 different banks
constexpr int LK_P = 53;
// K2's shapes
constexpr int K2_PS = LK_W + 2;       // bilinear template side
constexpr int K2_PT = K2_PS + 1;      // template tile side (24)
constexpr int K2_WARPS = 4;           // points per block
// K3's warps per point: 4 was the fastest of 1, 2 and 4 at the latency
// path's 1x200, both levels
constexpr int K3_WARPS = 4;
constexpr int K3_BAR = 1;             // K3's named barrier (0 is __syncthreads)

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

// sum over the warp by an xor butterfly: every lane adds the same pairs,
// so every lane returns the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ------------------------------------------------ the shared GN loop ----

// the samples of one thread of a point's NW warps: thread t owns samples
// t + 32*NW*k (k < NK), with their template, gradients and window offsets
template <int NW>
struct LaneSamples {
  static constexpr int NK = (LK_S + 32 * NW - 1) / (32 * NW);  // 14, 7, 4
  float tm[NK], gx[NK], gy[NK];
  int off[NK];  // row * LK_P + column of the sample in the patch
};

// row and column of sample i (0 for the padding samples past 441)
__device__ __forceinline__ int sample_off(int i) {
  const int v = i < LK_S ? i : 0;
  const int r = v / LK_W;
  return r * LK_P + (v - r * LK_W);
}

// bilinear value of a shared tile at t (row blend first, then column
// blend: the plain version's Ey, then pe)
__device__ __forceinline__ float blend(const float* t, float fx, float fy) {
  const float r0 = t[0] * (1.f - fy) + t[LK_P] * fy;
  const float r1 = t[1] * (1.f - fy) + t[LK_P + 1] * fy;
  return r0 * (1.f - fx) + r1 * fx;
}

// sample i of the patch when some taps may fall outside the WIN x WIN
// window: those read 0, by clamped addresses and masks rather than
// divergent branches
__device__ __forceinline__ float window_blend_masked(const float* wn, int WIN, int i,
                                                     const SamplePos& sp) {
  const int r = i / LK_W, c = i - r * LK_W;
  const int iy = sp.iby + r, ix = sp.ibx + c;
  const unsigned uw = (unsigned)WIN;
  const bool my0 = (unsigned)iy < uw, my1 = (unsigned)(iy + 1) < uw;
  const bool mx0 = (unsigned)ix < uw, mx1 = (unsigned)(ix + 1) < uw;
  const int y0 = clampi(iy, 0, WIN - 1) * LK_P, y1 = clampi(iy + 1, 0, WIN - 1) * LK_P;
  const int x0 = clampi(ix, 0, WIN - 1), x1 = clampi(ix + 1, 0, WIN - 1);
  const float v00 = (my0 && mx0) ? wn[y0 + x0] : 0.f, v10 = (my1 && mx0) ? wn[y1 + x0] : 0.f;
  const float v01 = (my0 && mx1) ? wn[y0 + x1] : 0.f, v11 = (my1 && mx1) ? wn[y1 + x1] : 0.f;
  const float r0 = v00 * (1.f - sp.fy) + v10 * sp.fy;
  const float r1 = v01 * (1.f - sp.fy) + v11 * sp.fy;
  return r0 * (1.f - sp.fx) + r1 * sp.fx;
}

// one pass of thread t over its samples at sp: s0 += dI * gx, s1 += dI * gy
// (ABS: s0 += |dI|), in two partial sums each (even and odd k) to halve the
// chain of dependent adds; unmasked taps when the whole patch and its +1
// taps lie inside the window (uniform over the point), masked ones otherwise
template <bool ABS, int NW>
__device__ __forceinline__ void lane_pass(const float* wn, int WIN, int t, const SamplePos& sp,
                                          const LaneSamples<NW>& ls, float& s0, float& s1) {
  constexpr int NK = LaneSamples<NW>::NK;
  float a[2] = {0.f, 0.f}, c[2] = {0.f, 0.f};
  auto add = [&](int k, float v) {
    const float dI = v - ls.tm[k];
    if (ABS) {
      a[k & 1] += fabsf(dI);
    } else {
      a[k & 1] += dI * ls.gx[k];
      c[k & 1] += dI * ls.gy[k];
    }
  };
  if (sp.ibx >= 0 && sp.iby >= 0 && sp.ibx + LK_W < WIN && sp.iby + LK_W < WIN) {
    const float* w0 = wn + sp.iby * LK_P + sp.ibx;
#pragma unroll
    for (int k = 0; k < NK; ++k)
      if (k < NK - 1 || t + 32 * NW * k < LK_S) add(k, blend(w0 + ls.off[k], sp.fx, sp.fy));
  } else {
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int i = t + 32 * NW * k;
      if (k < NK - 1 || i < LK_S) add(k, window_blend_masked(wn, WIN, i, sp));
    }
  }
  s0 = a[0] + a[1];
  s1 = c[0] + c[1];
}

// the sum of each v[j] over the point's NW warps, the same bits in every
// thread: a butterfly in each warp, then (NW > 1) each warp's lane 0 puts
// its sums in xch, the point's warps meet at named barrier `bar`, and every
// thread adds the NW partial sums in warp order.  xch holds two sets of
// slots used in turn, so a set is written again only after a barrier that
// follows every read of it.
template <int NW, int NV>
__device__ __forceinline__ void point_sum(float (&v)[NV], float* xch, int bar, int& turn) {
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = warp_sum(v[j]);
  if constexpr (NW > 1) {
    const int w = (threadIdx.x >> 5) % NW;
    float* x = xch + turn * 2 * NW;  // slots [w][j], j < 2
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j) x[2 * w + j] = v[j];
    }
    named_barrier(bar, 32 * NW);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float s = x[j];
#pragma unroll
      for (int q = 1; q < NW; ++q) s += x[2 * q + j];
      v[j] = s;
    }
    turn ^= 1;
  }
}

// The Gauss-Newton loop of one point and its final mean |sample -
// template|, shared by K2 and K3.  wn: the point's WIN x WIN window at
// pitch LK_P in shared memory; t: the thread's index among the point's
// 32*NW; (pxw, pyw): the patch origin at u = 0 in window coordinates; (ux,
// uy) enter as the warm start and leave as the result; xch: 4*NW floats of
// shared memory for NW > 1.  Every thread of the point returns the same u
// and err.
template <int NW>
__device__ __forceinline__ float gn_solve(const float* wn, int WIN, int t,
                                          const LaneSamples<NW>& ls, float pxw, float pyw,
                                          float Gxx, float Gxy, float Gyy, float inv_det,
                                          bool done, int iters, float eps2, float* xch,
                                          int bar, float& ux, float& uy) {
  int turn = 0;
  for (int it = 0; it < iters && !done; ++it) {
    float b[2];
    lane_pass<false, NW>(wn, WIN, t, sample_pos(pxw + ux, pyw + uy), ls, b[0], b[1]);
    point_sum<NW>(b, xch, bar, turn);
    const float dux = inv_det * (Gyy * b[0] - Gxy * b[1]);
    const float duy = inv_det * (-Gxy * b[0] + Gxx * b[1]);
    ux -= dux;
    uy -= duy;
    done = dux * dux + duy * duy < eps2;
  }
  float e[1], unused;
  lane_pass<true, NW>(wn, WIN, t, sample_pos(pxw + ux, pyw + uy), ls, e[0], unused);
  point_sum<NW>(e, xch, bar, turn);
  return e[0] / (float)LK_S;
}

// ---------------------------------------------------------------- K2 ----

__global__ void __launch_bounds__(32 * K2_WARPS, 16 / K2_WARPS) lk_level_kernel(
    const float* __restrict__ prev, const float* __restrict__ cur,
    const float* __restrict__ pts, const float* __restrict__ flow,
    const unsigned char* __restrict__ active, const int* __restrict__ axs,
    const int* __restrict__ ays, float* __restrict__ u_out,
    unsigned char* __restrict__ ok_out, float* __restrict__ err_out, int BN, int N,
    int H, int W, int WIN, int iters, float eps2, float min_eig) {
  extern __shared__ __align__(16) float k2_smem[];  // per warp: tile, then window
  constexpr int NK = LaneSamples<1>::NK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pi = blockIdx.x * K2_WARPS + warp;  // flat (sequence, point)
  if (pi >= BN) return;  // the whole warp
  const int b = pi / N;
  const int pad = WIN;
  const int Wp = W + 2 * pad, Hp = H + 2 * pad;
  constexpr int half = (K2_PS - 1) / 2, hw = LK_W / 2;
  float* T = k2_smem + warp * (K2_PT + WIN) * LK_P;
  float* wn = T + K2_PT * LK_P;
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
    if (lane < K2_PT) cp_async4(T + r * LK_P + lane, Pc + clampi(y0 + r, 0, H - 1) * W);
#pragma unroll 4
  for (int r = 0; r < WIN; ++r) {
    const int row = clampi(ay - pad + r, 0, H - 1) * W;
    if (lane < WIN) cp_async4(wn + r * LK_P + lane, Cc0 + row);
    if (lane + 32 < WIN) cp_async4(wn + r * LK_P + lane + 32, Cc1 + row);
  }
  cp_async_wait_all();
  __syncwarp();

  // ---- template, gradients and structure tensor of this lane's samples,
  // kept in registers ----
  LaneSamples<1> ls;
  float g0 = 0.f, g1 = 0.f, g2 = 0.f;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int i = lane + 32 * k;
    const bool valid = i < LK_S;
    const int off = sample_off(i);
    const float* t = T + off + LK_P;  // the template's row r + 1, column c
    const float ix = (blend(t + 2, fxT, fyT) - blend(t, fxT, fyT)) * 0.5f;
    const float iy = (blend(t + LK_P + 1, fxT, fyT) - blend(t + 1 - LK_P, fxT, fyT)) * 0.5f;
    ls.tm[k] = blend(t + 1, fxT, fyT);
    ls.gx[k] = valid ? ix : 0.f;
    ls.gy[k] = valid ? iy : 0.f;
    ls.off[k] = off;
    g0 += ls.gx[k] * ls.gx[k];
    g1 += ls.gx[k] * ls.gy[k];
    g2 += ls.gy[k] * ls.gy[k];
  }
  const float Gxx = warp_sum(g0), Gxy = warp_sum(g1), Gyy = warp_sum(g2);
  const float det = Gxx * Gyy - Gxy * Gxy;
  const float tr = Gxx + Gyy;
  const float eig_min = 0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.f * det, 0.f)));
  const bool ok_eig = eig_min / (float)LK_S >= min_eig;
  const float inv_det = 1.f / (fabsf(det) > 1e-12f ? det : 1e-12f);

  // ---- Gauss-Newton inside the window; (pxw, pyw) is the patch origin at
  // u = 0 in window coordinates ----
  const float pxw = px - ((float)ax - (float)pad) - (float)hw;
  const float pyw = py - ((float)ay - (float)pad) - (float)hw;
  float ux = flow[2 * pi], uy = flow[2 * pi + 1];
  const float e = gn_solve<1>(wn, WIN, lane, ls, pxw, pyw, Gxx, Gxy, Gyy, inv_det,
                              !(act && ok_eig), iters, eps2, nullptr, 0, ux, uy);
  if (lane == 0) {
    u_out[2 * pi] = ux;
    u_out[2 * pi + 1] = uy;
    ok_out[pi] = ok_eig ? 1 : 0;
    err_out[pi] = e;
  }
}

// ---------------------------------------------------------------- K3 ----

// K3: tmpl/Ix/Iy (B, N, 21, 21), the window (B, N, WIN, WIN) and the
// per-point scalars (B, N) as lk_iterate_plain takes them; one block of
// K3_WARPS warps per (sequence, point)
__global__ void __launch_bounds__(32 * K3_WARPS) lk_iterate_kernel(
    const float* __restrict__ tmpl_g, const float* __restrict__ ix_g,
    const float* __restrict__ iy_g, const float* __restrict__ win_g,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ u0, const unsigned char* __restrict__ done0,
    const float* __restrict__ inv_det, const float* __restrict__ gxx,
    const float* __restrict__ gxy, const float* __restrict__ gyy,
    float* __restrict__ u_out, float* __restrict__ err_out, int WIN, int iters,
    float eps2) {
  extern __shared__ __align__(16) float k3_smem[];  // the window, then 4*NW slots
  constexpr int NW = K3_WARPS, NK = LaneSamples<NW>::NK;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t pi = blockIdx.x;  // flat (sequence, point)
  float* wn = k3_smem;
  float* xch = k3_smem + WIN * LK_P;

  // the window: warp w copies rows w, w + NW, ..., a lane one column (and
  // the column 32 to its right)
  const float* src = win_g + pi * WIN * WIN;
  for (int r = warp; r < WIN; r += NW) {
    if (lane < WIN) cp_async4(wn + r * LK_P + lane, src + r * WIN + lane);
    if (lane + 32 < WIN) cp_async4(wn + r * LK_P + lane + 32, src + r * WIN + lane + 32);
  }

  // this thread's template and gradient values, coalesced, while the
  // window is in flight
  const float* tg = tmpl_g + pi * LK_S;
  const float* xg = ix_g + pi * LK_S;
  const float* yg = iy_g + pi * LK_S;
  LaneSamples<NW> ls;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int i = t + 32 * NW * k;
    const bool valid = k < NK - 1 || i < LK_S;
    ls.tm[k] = valid ? __ldg(tg + i) : 0.f;
    ls.gx[k] = valid ? __ldg(xg + i) : 0.f;
    ls.gy[k] = valid ? __ldg(yg + i) : 0.f;
    ls.off[k] = sample_off(i);
  }
  float ux = u0[2 * pi], uy = u0[2 * pi + 1];
  const bool done = done0[pi] != 0;
  const float pxw = px[pi], pyw = py[pi];
  const float Gxx = gxx[pi], Gxy = gxy[pi], Gyy = gyy[pi], idet = inv_det[pi];

  cp_async_wait_all();
  named_barrier(K3_BAR, 32 * NW);
  const float e = gn_solve<NW>(wn, WIN, t, ls, pxw, pyw, Gxx, Gxy, Gyy, idet, done, iters, eps2,
                               xch, K3_BAR, ux, uy);
  if (t == 0) {
    u_out[2 * pi] = ux;
    u_out[2 * pi + 1] = uy;
    err_out[pi] = e;
  }
}

// K2's opt-in above the 48 KB of dynamic shared memory a block gets by
// default.  It is an attribute of the kernel in each device's context, so
// it is set once per device, on the first launch there; launches come from
// several host threads at once (one per shard of a mesh, the loop-closure
// workers), so the first ones on a device meet at a lock.
constexpr int MAX_DEVICES = 64;
std::atomic<bool> k2_opted_in[MAX_DEVICES];
std::mutex k2_opt_in_lock;

cudaError_t k2_opt_in(int device) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (k2_opted_in[device].load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> hold(k2_opt_in_lock);
  if (k2_opted_in[device].load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t st = cudaFuncSetAttribute(
      lk_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * K2_WARPS * (K2_PT + MAX_WIN) * LK_P));
  if (st == cudaSuccess) k2_opted_in[device].store(true, std::memory_order_release);
  return st;
}

}  // namespace

extern "C" int lk_level_launch(const float* prev, const float* cur,
                               const float* pts, const float* flow,
                               const unsigned char* active, const int* ax,
                               const int* ay, float* u, unsigned char* ok,
                               float* err, int B, int N, int H, int W, int win,
                               int search_margin, int iters, float eps2,
                               float min_eig, int device, cudaStream_t stream) {
  const int WIN = win + 1 + 2 * search_margin;
  if (win != LK_W || search_margin < 0 || WIN > MAX_WIN) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  const int BN = B * N;
  // per warp the template tile and the window, rows of LK_P floats: 51 KB
  // at WIN = 38, 60 KB at most, above the 48 KB a block gets without opting in
  const size_t smem = sizeof(float) * K2_WARPS * (K2_PT + WIN) * LK_P;
  cudaError_t st = check_current_device(device);
  if (st == cudaSuccess) st = k2_opt_in(device);
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
                                 float eps2, int device, cudaStream_t stream) {
  if (w != LK_W || WIN < 1 || WIN > MAX_WIN) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  const cudaError_t st = check_current_device(device);
  if (st != cudaSuccess) return (int)st;
  // the window at pitch LK_P and the exchange slots: 8.1 KB at WIN = 38,
  // 10.2 KB at most, under the 48 KB a block gets without opting in
  const size_t smem = sizeof(float) * (WIN * LK_P + 4 * K3_WARPS);
  lk_iterate_kernel<<<B * N, 32 * K3_WARPS, smem, stream>>>(
      tmpl, ix, iy, win, px, py, u0, done0, inv_det, gxx, gxy, gyy, u, err, WIN, iters, eps2);
  return (int)cudaGetLastError();
}
