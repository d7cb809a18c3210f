// K4's arithmetic (csrc/proj_schur.cu): one reprojection factor's residual
// and Jacobian, and one feature's share of the Schur-form normal equations.
// Every function here is the work of one thread (a lane of the warp that
// holds the feature); the kernels around them do the loads, the warp's
// synchronisation and the sums across features.
//
// The system's layout is the solver's (backend/state.py): 11 poses of 6
// tangent dims, then 11 speed-biases of 9, the extrinsic (6) at 165, td at
// 171, [a relo pose at 172].  The projection factors touch 73 of those dims,
// numbered densely here: pose dims 0..65, the extrinsic 66..71, td 72.
#pragma once

namespace proj_schur {

constexpr int FR = 11;                    // window frames
constexpr int NPOSE = 66;                 // pose dims
constexpr int EX_OFF = 165;               // the extrinsic's first dim
constexpr int TD_OFF = 171;               // td's dim
constexpr int NX = 172;                   // the window's dims
constexpr int ND = 73;                    // dense dims: pose, extrinsic, td
constexpr int NTRI = ND * (ND + 1) / 2;   // 2,701: Hpp's upper triangle on them
constexpr int ACC = NTRI + ND + 1;        // a partial sum: that triangle, gp, Σ r²
constexpr int FC = 21;                    // a factor row: J's 20 columns and r
constexpr int FS = 2 * FC;                // a factor: its two rows
// the columns of a factor row: pose i, pose j, extrinsic, inverse depth, td, r
constexpr int C_I = 0, C_J = 6, C_E = 12, C_LAM = 18, C_TD = 19, C_R = 20;

// the dense dim of a row of the system; -1 where no projection factor acts
__host__ __device__ __forceinline__ int dense_of_row(int row) {
  if (row < NPOSE) return row;
  if (row >= EX_OFF && row <= TD_OFF) return NPOSE + row - EX_OFF;
  return -1;
}

// the upper-triangle slot of dense dims r <= c
__host__ __device__ __forceinline__ int tri(int r, int c) {
  return r * ND - (r * (r - 1)) / 2 + (c - r);
}

__host__ __device__ __forceinline__ void cross3(const float a[3], const float b[3], float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// R(q) v by the expanded Rodrigues form (utils/quaternion.py qrot); s = -1
// rotates by the conjugate
__host__ __device__ __forceinline__ void qrot(const float q[4], float s, const float v[3],
                                              float o[3]) {
  const float u[3] = {s * q[1], s * q[2], s * q[3]};
  float uv[3], uuv[3];
  cross3(u, v, uv);
  cross3(u, uv, uuv);
  for (int k = 0; k < 3; ++k) o[k] = v[k] + 2.0f * (q[0] * uv[k] + uuv[k]);
}

__host__ __device__ __forceinline__ void q2R(const float q[4], float R[3][3]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float ww = w * w, xx = x * x, yy = y * y, zz = z * z;
  const float wx = w * x, wy = w * y, wz = w * z, xy = x * y, xz = x * z, yz = y * z;
  R[0][0] = ww + xx - yy - zz;
  R[0][1] = 2.0f * (xy - wz);
  R[0][2] = 2.0f * (xz + wy);
  R[1][0] = 2.0f * (xy + wz);
  R[1][1] = ww - xx + yy - zz;
  R[1][2] = 2.0f * (yz - wx);
  R[2][0] = 2.0f * (xz - wy);
  R[2][1] = 2.0f * (yz + wx);
  R[2][2] = ww - xx - yy + zz;
}

// columns c0..c0+2 of the 3 x 20 J3 set to sg * M skew(v)
__host__ __device__ __forceinline__ void put_mskew(float J3[3][20], int c0, const float M[3][3],
                                                   const float v[3], float sg) {
  for (int r = 0; r < 3; ++r) {
    J3[r][c0] = sg * (v[2] * M[r][1] - v[1] * M[r][2]);
    J3[r][c0 + 1] = sg * (v[0] * M[r][2] - v[2] * M[r][0]);
    J3[r][c0 + 2] = sg * (v[1] * M[r][0] - v[0] * M[r][1]);
  }
}

// One projection factor, as ops/factors.py projection_factor computes it:
// the landmark of inverse depth lam seen at pi (velocity vi, td_obs tdi,
// scaled row rowi) in its start frame (Pi, Qi), reprojected into frame j
// (Pj, Qj) where it is seen at pj; the whitened residual r and its 2 x 20
// Jacobian over [pose_i, pose_j, extrinsic, inverse depth, td] into the row
// layout of a factor (columns C_I..C_TD, r at C_R).
__host__ __device__ __forceinline__ void projection_factor(
    const float Pi[3], const float Qi[4], const float Pj[3], const float Qj[4],
    const float tic[3], const float qic[4], float lam, float td, const float pi[2],
    const float vi[2], float tdi, float rowi, const float pj[2], const float vj[2], float tdj,
    float rowj, float sq, float f[FS]) {
  const float ki = td - tdi + rowi, kj = td - tdj + rowj;
  const float p_ci[3] = {(pi[0] - ki * vi[0]) / lam, (pi[1] - ki * vi[1]) / lam, 1.0f / lam};
  float p_ii[3], p_w[3], p_ij[3], p_cj[3], t[3];
  qrot(qic, 1.0f, p_ci, p_ii);
  for (int k = 0; k < 3; ++k) p_ii[k] += tic[k];
  qrot(Qi, 1.0f, p_ii, p_w);
  for (int k = 0; k < 3; ++k) t[k] = p_w[k] + Pi[k] - Pj[k];
  qrot(Qj, -1.0f, t, p_ij);
  for (int k = 0; k < 3; ++k) t[k] = p_ij[k] - tic[k];
  qrot(qic, -1.0f, t, p_cj);
  const float x = p_cj[0], y = p_cj[1], z = p_cj[2];
  f[C_R] = sq * (x / z - (pj[0] - kj * vj[0]));
  f[FC + C_R] = sq * (y / z - (pj[1] - kj * vj[1]));

  float Ric[3][3], Ri[3][3], Rj[3][3], Bm[3][3], A[3][3], ARic[3][3], RicT[3][3], C[3][3];
  q2R(qic, Ric);
  q2R(Qi, Ri);
  q2R(Qj, Rj);
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      RicT[a][b] = Ric[b][a];
      Bm[a][b] = Ric[0][a] * Rj[b][0] + Ric[1][a] * Rj[b][1] + Ric[2][a] * Rj[b][2];
      // Rj^T Ri - I
      C[a][b] = Rj[0][a] * Ri[0][b] + Rj[1][a] * Ri[1][b] + Rj[2][a] * Ri[2][b] -
                (a == b ? 1.0f : 0.0f);
    }
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) A[a][b] = Bm[a][0] * Ri[0][b] + Bm[a][1] * Ri[1][b] + Bm[a][2] * Ri[2][b];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      ARic[a][b] = A[a][0] * Ric[0][b] + A[a][1] * Ric[1][b] + A[a][2] * Ric[2][b];

  float J3[3][20];
  float S[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      J3[r][c] = Bm[r][c];
      J3[r][6 + c] = -Bm[r][c];
      J3[r][12 + c] = RicT[r][0] * C[0][c] + RicT[r][1] * C[1][c] + RicT[r][2] * C[2][c];
    }
  put_mskew(J3, 3, A, p_ii, -1.0f);
  put_mskew(J3, 9, RicT, p_ij, 1.0f);
  put_mskew(J3, 15, ARic, p_ci, -1.0f);
  // + skew(p_cj)
  S[0][0] = 0.0f, S[0][1] = -z, S[0][2] = y;
  S[1][0] = z, S[1][1] = 0.0f, S[1][2] = -x;
  S[2][0] = -y, S[2][1] = x, S[2][2] = 0.0f;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) J3[r][15 + c] += S[r][c];
  for (int r = 0; r < 3; ++r) {
    J3[r][18] = -(ARic[r][0] * p_ci[0] + ARic[r][1] * p_ci[1] + ARic[r][2] * p_ci[2]) / lam;
    J3[r][19] = -(ARic[r][0] * vi[0] + ARic[r][1] * vi[1]) / lam;
  }
  // the 2 x 3 reduction of the pinhole projection (its two zeros left out)
  const float s = sq / z, e0 = -sq * x / (z * z), e1 = -sq * y / (z * z);
#pragma unroll
  for (int c = 0; c < 20; ++c) {
    f[c] = s * J3[0][c] + e0 * J3[2][c];
    f[FC + c] = s * J3[1][c] + e1 * J3[2][c];
  }
  f[C_TD] += sq * vj[0];
  f[FC + C_TD] += sq * vj[1];
}

// The Cauchy weight sqrt(ρ'(|r|²)) of loss scale c (c2 = c²) applied to a
// factor's residual and Jacobian (ops/factors.py cauchy_weight)
__host__ __device__ __forceinline__ void cauchy_weigh(float f[FS], float c2) {
  const float s = f[C_R] * f[C_R] + f[FC + C_R] * f[FC + C_R];
  const float w = sqrtf(1.0f / (1.0f + s / c2));
#pragma unroll
  for (int k = 0; k < FS; ++k) f[k] *= w;
}

// the factor-row column and the dense dim of entry l of a feature's
// common part [J_i (6), J_ex (6), J_td, J_lam, r]; -1 for J_lam, -2 for r
__host__ __device__ __forceinline__ int common_col(int l) {
  return l < 6 ? C_I + l : (l < 12 ? C_E + l - 6 : (l == 12 ? C_TD : (l == 13 ? C_LAM : C_R)));
}
__host__ __device__ __forceinline__ int common_dense(int l, int i) {
  return l < 6 ? 6 * i + l : (l < 12 ? NPOSE + l - 6 : (l == 12 ? ND - 1 : (l == 13 ? -1 : -2)));
}

constexpr int N_COMMON = 15;                           // entries of the common part
constexpr int COMMON_ITEMS = N_COMMON * (N_COMMON + 1) / 2;  // its Gram's upper triangle: 120

// the index of the lowest set bit of m (m != 0)
__host__ __device__ __forceinline__ int low_bit(unsigned m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// the common Gram's entry e (0..119) as a <= b: rows q and 14 - q of the
// triangle (15 - q and q + 1 entries) fold into one row of 16, row 7 alone
__host__ __device__ __forceinline__ void common_pair(int e, int& a, int& b) {
  const int q = e >> 4, k = e & 15;
  if (q == 7 || k < N_COMMON - q) {
    a = q;
    b = q + k;
  } else {
    a = N_COMMON - 1 - q;
    b = a + k - (N_COMMON - q);
  }
}

// Lane ``lane``'s share of one feature's contributions.  The feature starts
// at frame i; its live factors (valid, seen at i and at j, j != i) are the
// bits of okm, the nok frames of okj in order, and their weighted rows fac
// (FS floats each, by frame).  Two kinds of items, spread over the 32 lanes:
//   * the feature's common Gram: the upper triangle of Σ_j A_jᵀ A_j over its
//     live factors, A_j = the factor's [J_i, J_ex, J_td, J_lam, r] rows
//     (pose i, extrinsic and td blocks of Hpp and gp, Σ r², and the
//     feature's Hpl column, dl and gl at pose i, extrinsic and td);
//   * for each live frame j, J_jᵀ times the factor's rows: the (j, j) upper
//     triangle, the (i, j) block, the (j, extrinsic) and (j, td) entries of
//     Hpp, gp at pose j and the feature's Hpl column at pose j.
// Every item writes its own slot of acc (this warp's partial Hpp triangle,
// gp and Σ r², added to) or of the feature's Hpl column hcol (stride ``ld``),
// dl or gl (set): no two items of a feature share a slot, so the lanes need
// no ordering among themselves, and each sum runs over the factors in frame
// order.
__host__ __device__ __forceinline__ void feature_items(
    int lane, unsigned okm, int nok, const int* okj, int i, const float* fac, float* acc,
    float* hcol, int ld, float* dl, float* gl) {
  for (int e = lane; e < COMMON_ITEMS; e += 32) {
    int a, b;
    common_pair(e, a, b);
    const int ca = common_col(a), cb = common_col(b);
    float v0 = 0.0f, v1 = 0.0f;  // the factors' two rows, summed apart
    for (unsigned mm = okm; mm != 0u; mm &= mm - 1u) {
      const float* f = fac + low_bit(mm) * FS;
      v0 += f[ca] * f[cb];
      v1 += f[FC + ca] * f[FC + cb];
    }
    const float v = v0 + v1;
    const int da = common_dense(a, i), db = common_dense(b, i);
    if (db >= 0) acc[tri(da, db)] += v;
    else if (db == -1) (da >= 0 ? hcol[da * ld] : *dl) = v;
    else if (da >= 0) acc[NTRI + da] += v;
    else if (da == -1) *gl = v;
    else acc[NTRI + ND] += v;
  }
  // a lane takes one (live frame, J_j column a) and runs over the factor's
  // columns b in three chunks of 7: products, then every slot read, then
  // every slot written (the chunk's slots are distinct)
  for (int p = lane; p < nok * 6; p += 32) {
    const int q = p / 6, a = p - 6 * q;
    const int j = okj[q], dj = 6 * j + a;
    const float* f = fac + j * FS;
    const float x0 = f[C_J + a], x1 = f[FC + C_J + a];
#pragma unroll
    for (int b0 = 0; b0 < FC; b0 += 7) {
      float v[7], old[7];
      int slot[7];
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        const int b = b0 + k;
        v[k] = x0 * f[b] + x1 * f[FC + b];
        // the dense dim of column b: pose i, pose j, extrinsic, td
        const int d2 = b < C_J ? 6 * i + b
                     : b < C_E ? 6 * j + b - C_J
                     : b < C_LAM ? NPOSE + b - C_E : ND - 1;
        slot[k] = b == C_R ? NTRI + dj
                : (b == C_LAM || (b >= C_J && b < C_E && b - C_J < a)) ? -1
                : (dj < d2 ? tri(dj, d2) : tri(d2, dj));
      }
#pragma unroll
      for (int k = 0; k < 7; ++k)
        if (slot[k] >= 0) old[k] = acc[slot[k]];
#pragma unroll
      for (int k = 0; k < 7; ++k)
        if (slot[k] >= 0) acc[slot[k]] = old[k] + v[k];
      if (b0 <= C_LAM && C_LAM < b0 + 7) hcol[dj * ld] = v[C_LAM - b0];
    }
  }
}

}  // namespace proj_schur
