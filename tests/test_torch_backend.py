"""Parity of the port's backend with the JAX package on the CPU:
preintegration and whitening, the closed-form factor Jacobians against the
JAX autodiff ones, the LM solve, both marginalizations, and one
``vio_step`` from a bridged ``EstimatorState`` (the state is warmed by the
port on synthetic features, bridged to JAX, then both step once).

Tolerances (float32 in both packages; sums run in another order):
  * preintegration Δp/Δv 1e-5, Δq 1e-6; Jacobian and covariance 1e-4 of
    their largest entry; whitening factor 1e-3 of its largest entry (the
    covariance is ill-conditioned);
  * factor residuals and Jacobians 1e-3 of the largest entry;
  * solve and vio_step: P 1 mm, V 1 mm/s, Q 5e-4 (0.06°), inverse depths
    1e-3 (about 0.5 %: the solve starts at cost 3.5e8, and one float32 GN
    step already leaves 3 mm between the two packages, shrinking with
    each step); marginalization priors
    1e-2 of the largest entry of J and r (two chained Cholesky factors of
    matrices whose scales span ~10 orders); after a whole vio_step the
    prior's r0 within 5e-2 of its largest entry (r0 is whitened by the
    prior's square root, so the sub-millimetre state differences of the
    solve show up there amplified).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.helpers import (make_imu_data, make_landmark_field, make_visual_data, perturb_state,
                           project_frame_features, simulate_long_trajectory,
                           simulate_window_trajectory)
from tests.torch_parity import assert_close, f32, tn, tt
from vins_rgbd_fast_torch import bridge
from vins_rgbd_fast_torch.backend import estimator as tes
from vins_rgbd_fast_torch.backend import feature_table as tftab
from vins_rgbd_fast_torch.backend.state import SB_DIM
from vins_rgbd_fast_torch.config import EstimatorConfig, SolverConfig
from vins_rgbd_fast_torch.ops import factors as tfac
from vins_rgbd_fast_torch.ops import imu_preintegration as timu
from vins_rgbd_fast_torch.ops import marginalization as tmarg
from vins_rgbd_fast_torch.ops import solver as tslv
from vins_rgbd_fast_tpu.backend import estimator as jest
from vins_rgbd_fast_tpu.backend import feature_table as jftab
from vins_rgbd_fast_tpu.backend import state as jstate
from vins_rgbd_fast_tpu.config import VinsConfig
from vins_rgbd_fast_tpu.ops import factors as jfac
from vins_rgbd_fast_tpu.ops import imu_preintegration as jimu
from vins_rgbd_fast_tpu.ops import marginalization as jmarg
from vins_rgbd_fast_tpu.ops import solver as jslv

NOISE = (0.1, 0.01, 1e-3, 1e-4)
G = np.array([0.0, 0.0, 9.805], np.float32)


def _rel(a, b, frac, what):
    assert_close(a, b, atol=frac * max(np.abs(np.asarray(b)).max(), 1e-12), what=what)


def _batch1(cls, nt):
    """JAX NamedTuple -> port NamedTuple ``cls`` with a batch axis of 1."""
    return cls(*[tt(np.asarray(v))[None] for v in nt])


def _window(gt_or_x):
    return bridge.to_torch(bridge.stack([jax.device_get(f32(gt_or_x))]))


@functools.partial(jax.jit, static_argnums=0)
def _jax_preint(noise, dts, accs, gyrs, ba, bg):
    pre = jax.vmap(lambda *a: jimu.preintegrate(*a, jimu.ImuNoise(*noise)))(dts, accs, gyrs, ba, bg)
    return pre, jax.vmap(jimu.sqrt_information)(pre)


def _imu_inputs():
    gt, (dts, accs, gyrs) = simulate_window_trajectory(seed=0)
    rng = np.random.default_rng(1)
    ba = rng.normal(0, 0.02, (10, 3))
    bg = rng.normal(0, 0.005, (10, 3))
    return gt, [np.asarray(a, np.float32) for a in (dts, accs, gyrs, ba, bg)]


def test_preintegrate_and_sqrt_information():
    _, (dts, accs, gyrs, ba, bg) = _imu_inputs()
    noise = NOISE
    jpre, jW = _jax_preint(noise, *f32((dts, accs, gyrs, ba, bg)))
    pre = timu.preintegrate(tt(dts), tt(accs), tt(gyrs), tt(ba), tt(bg), timu.ImuNoise(*NOISE))
    W = timu.sqrt_information(pre)
    assert_close(tn(pre.delta_p), jpre.delta_p, 1e-5, what="dp")
    assert_close(tn(pre.delta_v), jpre.delta_v, 1e-5, what="dv")
    assert_close(tn(pre.delta_q), jpre.delta_q, 1e-6, what="dq")
    assert_close(tn(pre.sum_dt), jpre.sum_dt, 1e-6, what="sum_dt")
    for i in range(10):
        _rel(tn(pre.jacobian[i]), jpre.jacobian[i], 1e-4, "jacobian")
        _rel(tn(pre.covariance[i]), jpre.covariance[i], 1e-4, "covariance")
        _rel(tn(W[i]), jW[i], 1e-3, "sqrt_information")


def test_factor_jacobians_match_jax_autodiff():
    rng = np.random.default_rng(4)
    n = 16

    def quats(k):
        q = rng.normal(size=(k, 4))
        q[:, 0] += 3.0
        return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)

    def vec(k, s):
        return rng.normal(0, s, (k, 3)).astype(np.float32)

    # projection factors
    Pi, Pj, tic = vec(n, 0.5), vec(n, 0.5), vec(n, 0.05)
    Qi, Qj, qic = quats(n), quats(n), quats(n)
    pts = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2, 2)), np.ones((n, 2, 1))], -1)
    vel = np.concatenate([rng.normal(0, 0.1, (n, 2, 2)), np.zeros((n, 2, 1))], -1)
    lam = rng.uniform(0.15, 0.4, n).astype(np.float32)
    td = rng.normal(0, 0.003, n).astype(np.float32)
    tdo = rng.normal(0, 0.003, (n, 2)).astype(np.float32)
    row = rng.normal(0, 0.002, (n, 2)).astype(np.float32)
    meas = [np.asarray(a, np.float32) for a in
            (pts[:, 0], pts[:, 1], vel[:, 0], vel[:, 1], tdo[:, 0], tdo[:, 1], row[:, 0], row[:, 1])]
    jr, jJ = jax.jit(jax.vmap(lambda *a: jfac.projection_factor(*a[:8], jfac.ProjMeas(*a[8:]))))(
        *f32((Pi, Qi, Pj, Qj, tic, qic, lam, td, *meas)))
    r, J = tfac.projection_factor(*[tt(a) for a in (Pi, Qi, Pj, Qj, tic, qic, lam, td)],
                                  tfac.ProjMeas(*[tt(a) for a in meas]))
    _rel(tn(r), jr, 1e-3, "projection r")
    for k in range(n):
        _rel(tn(J[k]), jJ[k], 1e-3, f"projection J {k}")

    # IMU factors on real preintegrations
    _, (dts, accs, gyrs, ba, bg) = _imu_inputs()
    noise = NOISE
    jpre, jW = _jax_preint(noise, *f32((dts, accs, gyrs, ba, bg)))
    m = 10
    st = [vec(m, 0.5), quats(m), vec(m, 0.3), vec(m, 0.02), vec(m, 0.005),
          vec(m, 0.5), quats(m), vec(m, 0.3), vec(m, 0.02), vec(m, 0.005)]
    jr, jJ = jax.jit(jax.vmap(
        lambda pre, *a: jfac.imu_factor_whitened(pre, *a[:10], jnp.asarray(G), a[10])))(
        jpre, *f32(st), jW)
    tpre = timu.Preintegrated(*[tt(np.asarray(v)) for v in jpre])
    r, J = tfac.imu_factor_whitened(tpre, *[tt(a) for a in st], tt(G), tt(np.asarray(jW)))
    for k in range(m):
        _rel(tn(r[k]), jr[k], 1e-3, f"imu r {k}")
        _rel(tn(J[k]), jJ[k], 1e-3, f"imu J {k}")


def _solver_problem():
    gt, imu_arrays = simulate_window_trajectory(seed=0)
    jimu_data = f32(make_imu_data(imu_arrays))
    jvis, _ = make_visual_data(gt, maxf=32, n_feat=24, seed=1)
    jvis = f32(jvis)
    x0 = f32(perturb_state(gt, seed=2, keep_frame0=True))
    tvis = _batch1(tslv.VisualData, jvis)
    tpre = _batch1(timu.Preintegrated, jimu_data.pre)
    timu_data = tslv.ImuData(pre=tpre, valid=tt(np.asarray(jimu_data.valid))[None])
    return gt, x0, jvis, jimu_data, tvis, timu_data


def _check_window(x, jx, what):
    assert_close(tn(x.P[0]), jx.P, 1e-3, what=f"{what} P")
    assert_close(tn(x.V[0]), jx.V, 1e-3, what=f"{what} V")
    assert_close(tn(x.Q[0]), jx.Q, 5e-4, what=f"{what} Q")


def test_solve_matches_jax():
    _, x0, jvis, jimu_data, tvis, timu_data = _solver_problem()
    jprior = f32(jslv.empty_prior(jnp.float32))
    cfg = jslv.SolverConfig(maxf=32, max_iters=3)
    jres = jax.jit(functools.partial(jslv.solve, cfg))(x0, jvis, jimu_data, jprior, jnp.asarray(G))
    res = tslv.solve(SolverConfig(maxf=32, max_iters=3), _window(x0), tvis, timu_data,
                     tslv.empty_prior(1, "cpu"), tt(G))
    _check_window(res.x, jres.x, "solve")
    assert_close(tn(res.inv_depth[0]), jres.inv_depth, 1e-3, what="inv_depth")
    assert_close(tn(res.cost0[0]), jres.cost0, 0.0, 1e-5, what="cost0")
    assert float(res.cost[0]) < 1e-8 * float(res.cost0[0])
    assert float(jres.cost) < 1e-8 * float(jres.cost0)


def test_marginalize_old_and_new_match_jax():
    gt, _, jvis, jimu_data, tvis, timu_data = _solver_problem()
    x = f32(perturb_state(gt, seed=2, dp=0.01, dth=0.005, dv=0.01, dbias=0.001))
    cfg = jslv.SolverConfig(maxf=32)
    scfg = SolverConfig(maxf=32)
    jp1 = jax.jit(functools.partial(jmarg.marginalize_old, cfg))(
        x, jvis, jimu_data, f32(jslv.empty_prior(jnp.float32)), jnp.asarray(G))
    tp1 = tmarg.marginalize_old(scfg, _window(x), tvis, timu_data,
                                tslv.empty_prior(1, "cpu"), tt(G))
    _rel(tn(tp1.J[0]), jp1.J, 1e-2, "old J")
    _rel(tn(tp1.r0[0]), jp1.r0, 1e-2, "old r0")
    # marginalize-new from the prior just built, at a perturbed state
    xp = f32(perturb_state(gt, seed=9, dp=0.01, dth=0.005, dv=0.01, dbias=0.001))
    jp2 = jax.jit(functools.partial(jmarg.marginalize_new, cfg))(xp, jp1)
    tp2 = tmarg.marginalize_new(scfg, _window(xp), bridge.to_torch(
        bridge.stack([jax.device_get(jp1)])))
    _rel(tn(tp2.J[0]), jp2.J, 1e-2, "new J")
    _rel(tn(tp2.r0[0]), jp2.r0, 1e-2, "new r0")
    # the speed-biases of slots W-1 and W land on one position, where JAX
    # adds the two columns: they carry a small share of the prior, so the
    # whole-matrix norm above would not see them dropped
    pos = tmarg._shifted_positions_new(tmarg._KEEP_NEW)
    shared = sorted({p for p in pos if pos.count(p) > 1})
    assert len(shared) == SB_DIM
    _rel(tn(tp2.J[0])[:, shared], np.asarray(jp2.J)[:, shared], 1e-2, "new J, shared columns")
    assert bool(tp2.valid[0])



def test_schur_prior_is_finite_where_the_jittered_factor_fails():
    """Two float32 sequences of a block-diagonal H (Hkd = 0, so the Schur
    complement is Hkk): the first positive definite, the second with two
    weak kept dimensions coupled so that their 2×2 block has an eigenvalue
    of −1e-5 (−1e-9 of the largest diagonal entry, the order float32
    rounding leaves on a VO window's gauge directions), below the
    diagonal-relative jitter.  JAX's prior of the second is NaN; the port
    factors it again with the stronger jitter and its prior is finite and
    reproduces A + 1e-6·(d + max d) within 1e-6 relative.  The first
    sequence's prior equals JAX's within 1e-6 relative."""
    rng = np.random.default_rng(5)
    nx = tmarg.NX
    d = (10.0 ** rng.uniform(-2, 4, (2, nx))).astype(np.float32)
    d[:, 0] = 1e4
    H = np.stack([np.diag(r) for r in d])
    i, j = tmarg._KEEP_OLD[40], tmarg._KEEP_OLD[41]
    H[1, i, i] = H[1, j, j] = 1e-2
    H[1, i, j] = H[1, j, i] = 1e-2 * (1 + 1e-3)
    b = rng.normal(0, 1, (2, nx)).astype(np.float32)
    drop, keep = tmarg._DROP_OLD, tmarg._KEEP_OLD
    new_pos = tmarg._shifted_positions_old(keep)
    A = H[1][np.ix_(keep, keep)].astype(np.float64)
    assert np.linalg.eigvalsh(A).min() < -5e-6
    assert not bool(torch.isfinite(tslv.cholesky_nan(tmarg._jitter(tt(A[None]).float()))).all())
    J, r = tmarg._schur_sqrt_prior(tt(H), tt(b), drop, keep, new_pos)
    assert bool(torch.isfinite(J).all()) and bool(torch.isfinite(r).all())
    jJ = [np.asarray(jmarg._schur_sqrt_prior(jnp.asarray(H[s]), jnp.asarray(b[s]), np.array(drop),
                                             np.array(keep), np.array(new_pos),
                                             jnp.float32)[0]) for s in range(2)]
    assert np.isfinite(jJ[0]).all() and not np.isfinite(jJ[1]).all()
    _rel(tn(J[0]), jJ[0], 1e-6, "healthy J")
    nk = len(keep)
    Jk = tn(J[1])[:nk][:, new_pos].astype(np.float64)
    dk = np.diagonal(A)
    _rel(Jk.T @ Jk, A + np.diag(1e-6 * (dk + dk.max()) + 1e-20), 1e-6, "fallback JᵀJ")


# ---------------------------------------------------------------------------
# one vio_step from a bridged state
# ---------------------------------------------------------------------------

JAX_TYPES = {"EstimatorState": jest.EstimatorState, "WindowState": jstate.WindowState,
             "FeatureTable": jftab.FeatureTable, "PriorFactor": jslv.PriorFactor}


def _to_jax(tree, b):
    """Port numpy NamedTuple tree -> the JAX classes, sequence b."""
    if hasattr(tree, "_fields"):
        return JAX_TYPES[type(tree).__name__](*[_to_jax(v, b) for v in tree])
    return jnp.asarray(tree[b])


def test_vio_step_matches_jax_from_bridged_state():
    B, MAXC, n = 2, 48, 13
    vcfg = VinsConfig(imu=True, static_init=True, max_cnt=MAXC, max_features=MAXC,
                      max_imu_per_frame=16, fix_depth=True, depth_min_dist=0.3,
                      depth_max_dist=10.0, keyframe_parallax=10.0, acc_n=0.1, gyr_n=0.01,
                      acc_w=1e-4, gyr_w=1e-5, max_num_iterations=2)
    jcfg = jest.EstimatorConfig.from_vins(vcfg)
    cfg = EstimatorConfig.from_vins(vcfg)
    trajs = [simulate_long_trajectory(n, seed=3 + b) for b in range(B)]
    fields = [make_landmark_field(tr, n_landmarks=400, seed=10 + b) for b, tr in enumerate(trajs)]
    bufs = []
    for tr in trajs:
        buf = tes.ImuIntervalBuffer(cfg.max_imu)
        for (t, a, w) in tr["imu"]:
            buf.push(t, a, w)
        bufs.append(buf)

    def frame(k):
        feats = [project_frame_features(tr["P"][k], tr["Q"][k], L, MAXC)
                 for tr, L in zip(trajs, fields)]
        feats = tftab.FrameFeatures(*[tt(np.stack([np.asarray(f[i]) for f in feats]))
                                      for i in range(5)])
        feats = feats._replace(pts=feats.pts.float(), uv=feats.uv.float(),
                               vel=feats.vel.float(), depth=feats.depth.float())
        ivs = []
        for b, tr in enumerate(trajs):
            t0 = tr["times"][k - 1] if k > 0 else tr["times"][0] - 1e-3
            ivs.append(bufs[b].collect(float(t0), float(tr["times"][k])))
        return feats, tes.ImuInterval(*[tt(np.stack([iv[i] for iv in ivs]).astype(np.float32))
                                          for i in range(3)])

    st = tes.init_estimator_state(cfg, np.eye(3), np.zeros(3), 0.0, B, "cpu")
    for k in range(11):
        feats, imu = frame(k)
        st, _ = tes.fill_step(cfg, st, k, feats, imu)
    st, out0 = tes.init_full(cfg, st)
    assert np.all(np.isfinite(tn(out0.cost)))
    feats, imu = frame(11)
    st1, out1 = tes.vio_step(cfg, st, feats, imu)

    np_state = bridge.to_numpy(st)
    for b in range(B):
        jst = _to_jax(np_state, b)
        jf = jftab.FrameFeatures(*[jnp.asarray(tn(v[b])) for v in feats])
        ji = jest.ImuInterval(*[jnp.asarray(tn(v[b])) for v in imu])
        jst1, jout = jest.vio_step(jcfg, jst, jf, ji, jax.random.PRNGKey(0))
        assert bool(jout.is_keyframe) == bool(out1.is_keyframe[b])
        assert int(jout.n_features) == int(out1.n_features[b]) > 20
        assert_close(tn(out1.P[b]), jout.P, 1e-3, what="P")
        assert_close(tn(out1.V[b]), jout.V, 1e-3, what="V")
        assert_close(tn(out1.Q[b]), jout.Q, 5e-4, what="Q")
        assert_close(tn(st1.x.P[b]), jst1.x.P, 1e-3, what="window P")
        assert np.array_equal(tn(st1.table.ids[b]), np.asarray(jst1.table.ids))
        _rel(tn(st1.prior.J[b]), jst1.prior.J, 1e-2, "prior J")
        _rel(tn(st1.prior.r0[b]), jst1.prior.r0, 5e-2, "prior r0")
        assert np.linalg.norm(tn(out1.P[b]) - trajs[b]["P"][11]) < 0.02
