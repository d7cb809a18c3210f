// K4's arithmetic on the host, for tests/test_torch_proj_schur.py: the
// header of the kernel (vins_rgbd_fast_torch/csrc/proj_schur.cuh) built with
// g++, its CUDA qualifiers defined away.  Each live feature's factors come
// from the header's projection_factor and cauchy_weigh, one frame a lane,
// and its share of the system from the header's feature_items, its 32 lanes
// run in turn (they write distinct slots); the sums are laid out as
// solver.proj_schur_plain returns them, through dense_of_row and tri.  The
// kernel's tiles, warps and shared memory are left out: they change only the
// order of the sums across features.
#include <math.h>

#include <vector>

#define __host__
#define __device__
#define __forceinline__ inline
#include "proj_schur.cuh"

using namespace proj_schur;

// The inputs as proj_schur_launch takes them; adds each sequence's
// projection factors into Hpp (B, nxp, nxp), Hpl (B, nxp, M), gp (B, nxp)
// and sets dl, gl (B, M) of its live features and cost (B) = Σ r².
extern "C" void proj_schur_host(
    const float* P, const float* Q, const float* tic_g, const float* qic_g, const float* td_g,
    const int* start, const float* pts, const float* vel, const float* td_obs,
    const float* row_scaled, const unsigned char* obs, const float* inv_depth,
    const unsigned char* valid, int B, int M, int nxp, float sq, float c2, float* Hpp,
    float* Hpl, float* dl, float* gp, float* gl, float* cost) {
  for (int b = 0; b < B; ++b) {
    std::vector<float> acc(ACC, 0.0f), hpl((size_t)ND * M, 0.0f);
    const float* Pb = P + b * FR * 3;
    const float* Qb = Q + b * FR * 4;
    const float* tic = tic_g + 3 * b;
    const float* qic = qic_g + 4 * b;
    for (int m = 0; m < M; ++m) {
      const size_t fm = (size_t)b * M + m;
      int i = start[fm];
      i = i < 0 ? 0 : (i > FR - 1 ? FR - 1 : i);
      if (!valid[fm] || !obs[fm * FR + i]) continue;
      float fac[FR * FS];
      int okj[16];
      unsigned okm = 0u;
      int nok = 0;
      for (int j = 0; j < FR; ++j) {
        if (j == i || !obs[fm * FR + j]) continue;
        const size_t oi = fm * FR + i, oj = fm * FR + j;
        projection_factor(Pb + 3 * i, Qb + 4 * i, Pb + 3 * j, Qb + 4 * j, tic, qic,
                          inv_depth[fm], td_g[b], pts + 2 * oi, vel + 2 * oi, td_obs[oi],
                          row_scaled[oi], pts + 2 * oj, vel + 2 * oj, td_obs[oj],
                          row_scaled[oj], sq, fac + j * FS);
        cauchy_weigh(fac + j * FS, c2);
        okm |= 1u << j;
        okj[nok++] = j;
      }
      if (okm == 0u) continue;
      for (int lane = 0; lane < 32; ++lane)
        feature_items(lane, okm, nok, okj, i, fac, acc.data(), hpl.data() + m, M, dl + fm,
                      gl + fm);
    }
    for (int r = 0; r < nxp; ++r) {
      const int dr = dense_of_row(r);
      if (dr < 0) continue;
      gp[(size_t)b * nxp + r] += acc[NTRI + dr];
      for (int c = 0; c < nxp; ++c) {
        const int dc = dense_of_row(c);
        if (dc >= 0)
          Hpp[((size_t)b * nxp + r) * nxp + c] += acc[dr <= dc ? tri(dr, dc) : tri(dc, dr)];
      }
      for (int m = 0; m < M; ++m) Hpl[((size_t)b * nxp + r) * M + m] += hpl[(size_t)dr * M + m];
    }
    cost[b] = acc[NTRI + ND];
  }
}
