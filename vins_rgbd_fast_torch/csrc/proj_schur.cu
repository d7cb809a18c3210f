// K4: the window solve's projection factors folded straight into the
// Schur-form normal equations, one pass over the grid of features x frames.
//
// Replaces no TPU kernel: the JAX package assembles these factors in plain
// jnp (vins_rgbd_fast_tpu/ops/solver.py _proj_grid, _accumulate_proj_s),
// which XLA fuses.  In PyTorch the same work was ~400 launches of tiny
// batched GEMMs and elementwise ops per assembly; this kernel and its
// finishing sum take their place.  Its plain version is proj_schur_plain
// in vins_rgbd_fast_torch/ops/solver.py; the arithmetic of one factor and of
// one feature's share is in proj_schur.cuh.
//
// The least time on the H100 (B = 32, M = 376, the 172-dim window): reading
// the grid (3.4 MB) and the system it adds to (Hpl 8.3 MB, Hpp 3.8 MB) and
// writing the system (12.2 MB), 27.8 MB, take 8.3 us at 3.35 TB/s; the
// operations, ~1.75 kflop per live factor, under 1 us at 67 TFLOP/s for the
// fleet's few ten thousand live factors.  Bytes set the bound.
// Design:
//   * grid (tiles of T features, B sequences), 8 warps a block; T is 32, 16
//     or 8, chosen by the wrapper from B and M so the blocks cover the SMs.
//     The block lists its tile's live features (valid, seen in their start
//     frame; the others add nothing) and its warps take them in turn.
//     A warp holds one feature at a time; its lanes compute the feature's
//     11 factors (one frame each) and stage the weighted rows in the warp's
//     shared memory, then all 32 lanes fold them into the system
//     (feature_items: the feature's common Gram, then each live frame's
//     products, a lane a frame and column with its 21 slots read and written
//     in chunks, so the shared-memory latency overlaps): nothing a factor
//     computes goes to device memory;
//   * each feature's own outputs (its Hpl column, dl, gl) depend on it
//     alone: the block keeps its tile's columns in shared memory and writes
//     them once, row by row, added to the input (the rows the factors do not
//     touch, the speed-biases and a relo block, copied);
//   * Hpp, gp and Σ r² sum over features, on 73 dims: each warp adds its
//     features into a private partial (2,775 floats in shared memory), the
//     block sums its 8 partials in warp order and writes one row of
//     scratch (B, tiles, 2,775); proj_schur_finish_kernel sums each
//     sequence's tiles in tile order into the input Hpp (mirrored) and gp.
//     No float atomics: every sum runs in a fixed order, so two launches on
//     the same inputs give the same bits.
// Beyond its bound the kernel moves the blocks' partials through scratch
// (4.3 MB each way at the fleet's shape).  What holds it back on the card
// is the latency of each warp's shared-memory sums at 16 warps an SM,
// which the per-frame chunks overlap.
// Shared memory (113.7 KB a block at T = 32) allows 2 blocks an SM;
// __launch_bounds__ holds the registers to the 128 that this needs.
// The wrapper allocates every output; the inputs are never written.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

#include "current_device.cuh"
#include "proj_schur.cuh"

namespace {

using namespace proj_schur;

constexpr int PS_WARPS = 8;
constexpr int PS_NT = 32 * PS_WARPS;
constexpr int PS_MAX_TILE = 32;
constexpr int FINISH_NT = 256;
constexpr unsigned FULL = 0xffffffffu;

// dynamic shared memory of a block of T features, in floats: the warps'
// partials and staged factors, each warp's live-frame list, the tile's
// Hpl columns (dense rows), dl and gl
__host__ __device__ constexpr int smem_floats(int T) {
  return PS_WARPS * (ACC + FR * FS + 16) + ND * T + 2 * T;
}

__global__ void __launch_bounds__(PS_NT, 2) proj_schur_kernel(
    const float* __restrict__ P, const float* __restrict__ Q, const float* __restrict__ tic_g,
    const float* __restrict__ qic_g, const float* __restrict__ td_g,
    const int* __restrict__ start, const float* __restrict__ pts,
    const float* __restrict__ vel, const float* __restrict__ td_obs,
    const float* __restrict__ row_scaled, const unsigned char* __restrict__ obs,
    const float* __restrict__ inv_depth, const unsigned char* __restrict__ valid,
    const float* __restrict__ Hpl_in, const float* __restrict__ dl_in,
    const float* __restrict__ gl_in, float* __restrict__ Hpl_out, float* __restrict__ dl_out,
    float* __restrict__ gl_out, float* __restrict__ scratch, int M, int nxp, int T,
    float sq, float c2) {
  extern __shared__ __align__(16) float ps_smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x, m0 = tile * T;
  float* acc = ps_smem + warp * ACC;
  float* fac = ps_smem + PS_WARPS * ACC + warp * FR * FS;
  int* okj = reinterpret_cast<int*>(ps_smem + PS_WARPS * (ACC + FR * FS)) + warp * 16;
  float* hpl = ps_smem + PS_WARPS * (ACC + FR * FS + 16);
  float* dl = hpl + ND * T;
  float* gl = dl + T;

  // the tile's live features (valid, seen in their start frame), in
  // feature order; the warps take them in turn
  __shared__ int live[PS_MAX_TILE];
  __shared__ int n_live;
  if (warp == 0) {
    bool lv = false;
    if (lane < T && m0 + lane < M) {
      const size_t fm = (size_t)b * M + m0 + lane;
      lv = valid[fm] && obs[fm * FR + min(max(start[fm], 0), FR - 1)];
    }
    const unsigned bal = __ballot_sync(FULL, lv);
    if (lv) live[__popc(bal & ((1u << lane) - 1u))] = lane;
    if (lane == 0) n_live = __popc(bal);
  }
  for (int e = lane; e < ACC; e += 32) acc[e] = 0.0f;
  for (int e = t; e < ND * T + 2 * T; e += PS_NT) hpl[e] = 0.0f;
  __syncthreads();

  // the sequence's window (read by every lane; cached)
  const float* Pb = P + b * FR * 3;
  const float* Qb = Q + b * FR * 4;
  const float tic[3] = {tic_g[3 * b], tic_g[3 * b + 1], tic_g[3 * b + 2]};
  const float qic[4] = {qic_g[4 * b], qic_g[4 * b + 1], qic_g[4 * b + 2], qic_g[4 * b + 3]};
  const float td = td_g[b];

  for (int k = warp; k < n_live; k += PS_WARPS) {
    const int c = live[k];
    const size_t fm = (size_t)b * M + m0 + c;
    const int i = min(max(start[fm], 0), FR - 1);
    float f[FS];
    bool ok = false;
    if (lane < FR && lane != i && obs[fm * FR + lane]) {
      const size_t oi = fm * FR + i, oj = fm * FR + lane;
      const float Pi[3] = {Pb[3 * i], Pb[3 * i + 1], Pb[3 * i + 2]};
      const float Qi[4] = {Qb[4 * i], Qb[4 * i + 1], Qb[4 * i + 2], Qb[4 * i + 3]};
      const float Pj[3] = {Pb[3 * lane], Pb[3 * lane + 1], Pb[3 * lane + 2]};
      const float Qj[4] = {Qb[4 * lane], Qb[4 * lane + 1], Qb[4 * lane + 2], Qb[4 * lane + 3]};
      const float pi[2] = {pts[2 * oi], pts[2 * oi + 1]};
      const float vi[2] = {vel[2 * oi], vel[2 * oi + 1]};
      const float pj[2] = {pts[2 * oj], pts[2 * oj + 1]};
      const float vj[2] = {vel[2 * oj], vel[2 * oj + 1]};
      projection_factor(Pi, Qi, Pj, Qj, tic, qic, inv_depth[fm], td, pi, vi, td_obs[oi],
                        row_scaled[oi], pj, vj, td_obs[oj], row_scaled[oj], sq, f);
      cauchy_weigh(f, c2);
      ok = true;
    }
    const unsigned okm = __ballot_sync(FULL, ok);
    if (okm == 0u) continue;
    if (ok) {
      float* dst = fac + lane * FS;
#pragma unroll
      for (int k = 0; k < FS; ++k) dst[k] = f[k];
      okj[__popc(okm & ((1u << lane) - 1u))] = lane;
    }
    __syncwarp();
    feature_items(lane, okm, __popc(okm), okj, i, fac, acc, hpl + c, T, dl + c, gl + c);
    __syncwarp();
  }
  __syncthreads();

  // the block's partial: its warps' partials in warp order
  float* dst = scratch + ((size_t)b * tiles + tile) * ACC;
  for (int e = t; e < ACC; e += PS_NT) {
    float s = ps_smem[e];
    for (int w = 1; w < PS_WARPS; ++w) s += ps_smem[w * ACC + e];
    dst[e] = s;
  }
  // the tile's Hpl columns, dl and gl, added to the inputs
  const int n = min(T, M - m0);
  for (int e = t; e < nxp * T; e += PS_NT) {
    const int r = e / T, c = e % T;
    if (c >= n) continue;
    const size_t o = ((size_t)b * nxp + r) * M + m0 + c;
    const int d = dense_of_row(r);
    Hpl_out[o] = d >= 0 ? Hpl_in[o] + hpl[d * T + c] : Hpl_in[o];
  }
  for (int c = t; c < n; c += PS_NT) {
    const size_t o = (size_t)b * M + m0 + c;
    dl_out[o] = dl_in[o] + dl[c];
    gl_out[o] = gl_in[o] + gl[c];
  }
}

// Hpp (mirrored), gp and Σ r² of each sequence: its tiles' partials summed
// in tile order and added to the input; every other entry copied
__global__ void __launch_bounds__(FINISH_NT) proj_schur_finish_kernel(
    const float* __restrict__ scratch, int tiles, const float* __restrict__ Hpp_in,
    const float* __restrict__ gp_in, float* __restrict__ Hpp_out, float* __restrict__ gp_out,
    float* __restrict__ cost, int nxp) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * FINISH_NT + threadIdx.x;
  const int n2 = nxp * nxp;
  const float* sc = scratch + (size_t)b * tiles * ACC;
  if (e < n2) {
    const int dr = dense_of_row(e / nxp), dc = dense_of_row(e % nxp);
    const size_t o = (size_t)b * n2 + e;
    float v = Hpp_in[o];
    if (dr >= 0 && dc >= 0) {
      const int k = dr <= dc ? tri(dr, dc) : tri(dc, dr);
      float s = 0.0f;
#pragma unroll 8
      for (int tl = 0; tl < tiles; ++tl) s += sc[(size_t)tl * ACC + k];
      v += s;
    }
    Hpp_out[o] = v;
  } else if (e < n2 + nxp) {
    const int r = e - n2, d = dense_of_row(r);
    const size_t o = (size_t)b * nxp + r;
    float v = gp_in[o];
    if (d >= 0) {
      float s = 0.0f;
#pragma unroll 8
      for (int tl = 0; tl < tiles; ++tl) s += sc[(size_t)tl * ACC + NTRI + d];
      v += s;
    }
    gp_out[o] = v;
  } else if (e == n2 + nxp) {
    float s = 0.0f;
    for (int tl = 0; tl < tiles; ++tl) s += sc[(size_t)tl * ACC + NTRI + ND];
    cost[b] = s;
  }
}

// the opt-in above the 48 KB of dynamic shared memory a block gets by
// default, once per device (as K2's in lk_level.cu)
constexpr int MAX_DEVICES = 64;
std::atomic<bool> k4_opted_in[MAX_DEVICES];
std::mutex k4_opt_in_lock;

cudaError_t k4_opt_in(int device) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (k4_opted_in[device].load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> hold(k4_opt_in_lock);
  if (k4_opted_in[device].load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t st = cudaFuncSetAttribute(
      proj_schur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * smem_floats(PS_MAX_TILE)));
  if (st == cudaSuccess) k4_opted_in[device].store(true, std::memory_order_release);
  return st;
}

}  // namespace

// The floats of one block's partial sum, a row of proj_schur_launch's
// scratch (the wrapper sizes scratch by it)
extern "C" int proj_schur_scratch_floats(void) { return ACC; }

// The window (P (B, 11, 3), Q (B, 11, 4), tic (B, 3), qic (B, 4), td (B)),
// the grid's VisualData (start (B, M) int32; pts, vel (B, M, 11, 2); td_obs,
// row_scaled (B, M, 11); obs (B, M, 11) bool; inv_depth (B, M); valid (B, M)
// bool) and the system it adds to (Hpp (B, nxp, nxp), Hpl (B, nxp, M), dl,
// gl (B, M), gp (B, nxp)); writes the *_out system, cost (B) = Σ r² and
// scratch (B, ceil(M / T), proj_schur_scratch_floats()).  nxp is 172, or
// 178 with a relo pose.
extern "C" int proj_schur_launch(
    const float* P, const float* Q, const float* tic, const float* qic, const float* td,
    const int* start, const float* pts, const float* vel, const float* td_obs,
    const float* row_scaled, const unsigned char* obs, const float* inv_depth,
    const unsigned char* valid, const float* Hpp_in, const float* Hpl_in, const float* dl_in,
    const float* gp_in, const float* gl_in, float* Hpp_out, float* Hpl_out, float* dl_out,
    float* gp_out, float* gl_out, float* cost, float* scratch, int B, int M, int nxp, int T,
    float sqrt_info, float c2, int device, cudaStream_t stream) {
  if ((T != 8 && T != 16 && T != PS_MAX_TILE) || nxp < NX || B < 0 || M < 0 || !(c2 > 0.0f))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaError_t st = check_current_device(device);
  if (st == cudaSuccess) st = k4_opt_in(device);
  if (st != cudaSuccess) return (int)st;
  const int tiles = (M + T - 1) / T;
  if (tiles > 0) {
    proj_schur_kernel<<<dim3(tiles, B), PS_NT, sizeof(float) * smem_floats(T), stream>>>(
        P, Q, tic, qic, td, start, pts, vel, td_obs, row_scaled, obs, inv_depth, valid, Hpl_in,
        dl_in, gl_in, Hpl_out, dl_out, gl_out, scratch, M, nxp, T, sqrt_info, c2);
    st = cudaGetLastError();
    if (st != cudaSuccess) return (int)st;
  }
  const int n = nxp * nxp + nxp + 1;
  proj_schur_finish_kernel<<<dim3((n + FINISH_NT - 1) / FINISH_NT, B), FINISH_NT, 0, stream>>>(
      scratch, tiles, Hpp_in, gp_in, Hpp_out, gp_out, cost, nxp);
  return (int)cudaGetLastError();
}
