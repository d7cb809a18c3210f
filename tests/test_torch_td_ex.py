"""Online td and extrinsic estimation in the port against the JAX package
on the CPU: the solver's free mask with td and the extrinsic free (td
gated by ``td_free`` 0 and 1), a solve and both marginalizations with them
free, from bridged states, in float64; ``VinsEstimator`` over the stream
of JAX's ``test_online_extrinsic_calibration_in_estimator`` (the hand-eye
F-RANSAC's draws injected, ``keys[(step + 2048) % 4096]``), in float64;
the pipeline with these knobs and its checkpoints are
``tests/test_torch_td_pipeline.py``.

Tolerances: the free mask exact; the solve's state and inverse depths, and
the priors' J and r0, within 1e-6 of their largest entry (float64 in
another order); the estimator's calibration on the same frame, ``ric``
within 1e-4 rad and every output within 1e-4 m."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import (G, make_imu_data, make_landmark_field, make_visual_data,
                           perturb_state, project_frame_features, simulate_long_trajectory,
                           simulate_window_trajectory)
from tests.test_torch_init import port_feats, port_vcfg
from tests.test_torch_tracker import jax_ransac_uniforms
from tests.torch_parity import assert_close, tn, tt
from vins_rgbd_fast_torch import bridge
from vins_rgbd_fast_torch.backend import estimator as tes
from vins_rgbd_fast_torch.config import SolverConfig
from vins_rgbd_fast_torch.ops import marginalization as tmarg
from vins_rgbd_fast_torch.ops import solver as tslv
from vins_rgbd_fast_tpu import config as jconfig
from vins_rgbd_fast_tpu.backend import estimator as jest
from vins_rgbd_fast_tpu.backend import initialization as jinit
from vins_rgbd_fast_tpu.ops import marginalization as jmarg
from vins_rgbd_fast_tpu.ops import solver as jslv
from vins_rgbd_fast_tpu.utils import quaternion as jquat

MAXF = 32
FREE = dict(estimate_td=True, estimate_extrinsic=True)


def _rel(a, b, frac, what):
    assert_close(a, b, atol=frac * max(np.abs(np.asarray(b)).max(), 1e-12), what=what)


def _port(tree):
    """A JAX tree of one sequence -> the port's, B = 1 (dtypes kept)."""
    return bridge.to_torch(bridge.stack([jax.device_get(tree)]))


@functools.lru_cache(maxsize=None)
def _problem():
    """``tests/test_solver.py``'s window problem in float64 with feature
    velocities, observation-time td and rolling-shutter rows, so that the
    td and extrinsic columns are live; the start state perturbed, its td
    and extrinsic too."""
    gt, imu_arrays = simulate_window_trajectory(seed=0)
    jvis, _ = make_visual_data(gt, maxf=MAXF, depth_fixed_frac=0.5)
    rng = np.random.default_rng(4)
    jvis = jvis._replace(vel=jnp.asarray(rng.normal(0, 0.05, jvis.vel.shape)),
                         td_obs=jnp.full(jvis.td_obs.shape, 0.002),
                         row_scaled=jnp.asarray(rng.uniform(0, 0.03, jvis.row_scaled.shape)))
    x0 = perturb_state(gt, seed=3, dp=0.02, dth=0.01, dv=0.02, dbias=0.002)
    x0 = x0._replace(td=jnp.asarray(0.004), tic=jnp.asarray([0.01, -0.01, 0.005]),
                     qic=jquat.so3_exp(jnp.asarray([0.01, -0.005, 0.008])))
    return gt, x0, jvis, make_imu_data(imu_arrays)


@pytest.mark.parametrize("td_free", [None, 0.0, 1.0], ids=["ungated", "gate-0", "gate-1"])
@pytest.mark.parametrize("free", [dict(estimate_td=True, estimate_extrinsic=True),
                                  dict(estimate_td=True), dict(estimate_extrinsic=True)],
                         ids=["td+ex", "td", "ex"])
def test_free_mask_matches_jax(free, td_free):
    _, _, jvis, _ = _problem()
    jm = jslv.free_mask(jslv.SolverConfig(maxf=MAXF, **free), jvis, jnp.float64,
                        None if td_free is None else jnp.asarray(td_free))
    tm = tslv.free_mask(SolverConfig(maxf=MAXF, **free), _port(jvis), torch.float64,
                        None if td_free is None else torch.tensor([td_free], dtype=torch.float64))
    np.testing.assert_array_equal(tn(tm[0]), np.asarray(jm))


@pytest.mark.parametrize("td_free", [0.0, 1.0], ids=["td-frozen", "td-free"])
def test_solve_with_td_and_extrinsic_free_matches_jax(td_free):
    _, x0, jvis, jimu = _problem()
    jres = jax.jit(functools.partial(jslv.solve, jslv.SolverConfig(maxf=MAXF, max_iters=4,
                                                                    **FREE)))(
        x0, jvis, jimu, jslv.empty_prior(jnp.float64), jnp.asarray(G),
        jnp.asarray(td_free))
    res = tslv.solve(SolverConfig(maxf=MAXF, max_iters=4, **FREE), _port(x0), _port(jvis),
                     _port(jimu), tslv.empty_prior(1, "cpu", torch.float64), tt(G)[None],
                     td_free=torch.tensor([td_free], dtype=torch.float64))
    for f in ("P", "Q", "V", "Ba", "Bg", "tic", "qic", "td"):
        _rel(tn(getattr(res.x, f)[0]), getattr(jres.x, f), 1e-6, f)
    _rel(tn(res.inv_depth[0]), jres.inv_depth, 1e-6, "inv_depth")
    moved = abs(float(res.x.td[0]) - 0.004)
    assert (moved > 1e-6) if td_free else (moved == 0.0)
    assert float(np.abs(tn(res.x.tic[0]) - np.asarray(x0.tic)).max()) > 1e-6


def test_marginalizations_with_td_and_extrinsic_free_match_jax():
    """Marginalize-old at the solved state, then marginalize-new from its
    prior at a perturbed one."""
    _, x0, jvis, jimu = _problem()
    cfg = jslv.SolverConfig(maxf=MAXF, **FREE)
    scfg = SolverConfig(maxf=MAXF, **FREE)
    x = jslv.solve(cfg, x0, jvis, jimu, jslv.empty_prior(jnp.float64), jnp.asarray(G),
                   jnp.asarray(1.0)).x
    jp1 = jax.jit(functools.partial(jmarg.marginalize_old, cfg))(
        x, jvis, jimu, jslv.empty_prior(jnp.float64), jnp.asarray(G))
    tp1 = tmarg.marginalize_old(scfg, _port(x), _port(jvis), _port(jimu),
                                tslv.empty_prior(1, "cpu", torch.float64), tt(G)[None])
    _rel(tn(tp1.J[0]), jp1.J, 1e-6, "old J")
    _rel(tn(tp1.r0[0]), jp1.r0, 1e-6, "old r0")
    xp = perturb_state(x, seed=9, dp=0.01, dth=0.005, dv=0.01, dbias=0.001)
    xp = xp._replace(td=x.td + 0.001, tic=x.tic + 0.002)
    jp2 = jax.jit(functools.partial(jmarg.marginalize_new, cfg))(xp, jp1)
    tp2 = tmarg.marginalize_new(scfg, _port(xp), _port(jp1))
    _rel(tn(tp2.J[0]), jp2.J, 1e-6, "new J")
    _rel(tn(tp2.r0[0]), jp2.r0, 1e-6, "new r0")
    # the extrinsic and td rows carry information
    assert np.abs(tn(tp1.J[0])[:, -7:]).max() > 1e-3


def test_online_extrinsic_calibration_matches_jax(monkeypatch):
    """``test_online_extrinsic_calibration_in_estimator``'s stream through
    both estimators, to 3 frames past the end of the calibration (JAX's
    host calibration compiles its eager operations anew at each frame's
    match count): it ends on the same frame, ``ric`` then within 1e-4 rad
    of JAX's and within 4° of the truth (the JAX test's bound); every
    output within 1e-4 m.  JAX's host calibration calls its math eagerly,
    which compiles every operation anew for each frame's match count; the
    test runs the same functions under ``jax.jit`` (one compile per count)."""
    for name in ("decompose_essential", "calibrate_extrinsic_rotation"):
        monkeypatch.setattr(jinit, name, jax.jit(getattr(jinit, name)))
    ric_true = np.asarray(jquat.q2R(jquat.so3_exp(jnp.asarray([0.25, -0.4, 0.6]))))
    jvcfg = jconfig.VinsConfig(imu=True, static_init=True, estimate_extrinsic=2, max_cnt=48,
                               max_features=48, max_imu_per_frame=16,
                               ric=tuple(np.eye(3).ravel()), acc_n=0.1, gyr_n=0.01,
                               acc_w=1e-4, gyr_w=1e-5)
    traj = simulate_long_trajectory(30, seed=41, omega_scale=1.6, acc_scale=0.3)
    L = make_landmark_field(traj, n_landmarks=600, seed=42)
    keys = jax.random.split(jax.random.PRNGKey(1), 4096)
    je = jest.VinsEstimator(jvcfg, dtype=jnp.float64)
    te = tes.VinsEstimator(port_vcfg(jvcfg), "cpu", dtype=torch.float64,
                           ex_uniforms=lambda step, n: jax_ransac_uniforms(
                               keys[(step + 2048) % 4096], 64, n))
    assert te.cfg.estimate_extrinsic and te._ex_calibrating
    for (t, a, w) in traj["imu"]:
        je.push_imu(t, a, w)
        te.push_imu(t, a, w)
    done = None
    for k in range(30):
        if done is not None and k > done + 3:
            break
        feats = project_frame_features(traj["P"][k], traj["Q"][k], L, 48, ric=ric_true,
                                       tic=np.zeros(3))
        a = je.process_features(feats, float(traj["times"][k]))
        b = te.process_features(port_feats(feats), float(traj["times"][k]))
        assert te._ex_calibrating == je._ex_calibrating, k
        assert (a is None) == (b is None), k
        if b is not None:
            assert_close(b["P"], a["P"], 1e-4, what=f"P at {k}")
        if done is None and not te._ex_calibrating:
            done = k
            ric = tn(tes.quat.q2R(te.state.x.qic[0]))
            jric = np.asarray(jquat.q2R(je.state.x.qic))
            assert np.linalg.norm(tn(tes.quat.so3_log(tes.quat.R2q(tt(ric.T @ jric))))) < 1e-4
            err = np.degrees(np.linalg.norm(tn(tes.quat.so3_log(tes.quat.R2q(
                tt(ric.T @ ric_true))))))
            assert err < 4.0, err
    assert done is not None
