"""Dynamic and monocular initialization of the port against the JAX
package on the CPU, on the same seeded numpy inputs: the copied
``so3_log``, every function of ``backend/initialization.py`` (the essential
decomposition, the hand-eye calibration and its rejection, the excitation
check, the alignments and their gravity refinements), the device programs
``init_dynamic``, ``_dlt_triangulate`` and ``init_mono`` from bridged
states, and ``VinsEstimator`` over the streams of JAX's
``test_dynamic_init_e2e`` and ``test_mono_init_e2e_no_depth``.  JAX's
draws are injected throughout: ``fold_in(key, j)`` split 8 ways for the
dynamic chain's link j, ``key`` for the monocular F-RANSAC,
``split(fold_in(key, rnd), 11)`` then 8 ways for its PnP rounds, each draw
``uniform(k, (MAXF,))``.

Both packages run in float64 (the suite's JAX x64), so the tolerances are
those of float64 arithmetic in another order: 1e-9 for the closed forms,
1e-6 for the alignments (a solve scaled by 1000 with 1e-8 damping), and
for the programs ``ok`` equal and poses, velocities and biases within
1e-5; ``VinsEstimator``'s outputs within 1e-4 m, from the same frame on."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import (make_landmark_field, project_frame_features, simulate_long_trajectory,
                           simulate_window_trajectory)
from tests.test_torch_backend import _to_jax
from tests.test_torch_tracker import jax_ransac_uniforms
from tests.torch_parity import assert_close, tn, tt
from vins_rgbd_fast_torch import bridge
from vins_rgbd_fast_torch import config as tconfig
from vins_rgbd_fast_torch.backend import estimator as tes
from vins_rgbd_fast_torch.backend import feature_table as tftab
from vins_rgbd_fast_torch.backend import initialization as tinit
from vins_rgbd_fast_torch.utils import quaternion as tquat
from vins_rgbd_fast_tpu import config as jconfig
from vins_rgbd_fast_tpu.backend import estimator as jest
from vins_rgbd_fast_tpu.backend import initialization as jinit
from vins_rgbd_fast_tpu.ops import imu_preintegration as jimu
from vins_rgbd_fast_tpu.utils import quaternion as jquat

F64 = torch.float64
MAXC = 48
FRAMES = 11


def _b(a):
    """numpy -> float64 torch with a batch axis of 1."""
    return tt(np.asarray(a))[None]


def test_so3_log_matches_jax():
    rng = np.random.default_rng(0)
    th = np.concatenate([rng.normal(0, 1.0, (16, 3)), rng.normal(0, 1e-9, (4, 3)),
                         [[np.pi - 1e-6, 0, 0]]])
    q = np.array(jquat.so3_exp(jnp.asarray(th)))
    q[::3] *= -1.0  # the double cover
    assert_close(tn(tquat.so3_log(tt(q))), jquat.so3_log(jnp.asarray(q)), 1e-12, what="so3_log")


def _two_views(seed, n=60, noise=0.0, outliers=0):
    rng = np.random.default_rng(seed)
    R = np.asarray(jquat.q2R(jquat.so3_exp(jnp.asarray(rng.normal(0, 0.08, 3)))))
    t = rng.normal(0, 1.0, 3)
    t /= np.linalg.norm(t)
    P1 = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n), rng.uniform(3, 8, n)], -1)
    P2 = P1 @ R.T + t
    x1 = P1[:, :2] / P1[:, 2:3]
    x2 = P2[:, :2] / P2[:, 2:3] + rng.normal(0, noise, (n, 2))
    x2[:outliers] += rng.uniform(-0.1, 0.1, (outliers, 2))
    return R, t, x1, x2


@pytest.mark.parametrize("seed,noise,outliers", [(0, 0.0, 0), (1, 0.5 / 460.0, 6)])
def test_decompose_essential_matches_jax(seed, noise, outliers):
    """Both packages pick the same candidate: R and t within 1e-9, scores equal."""
    R, t, x1, x2 = _two_views(seed, noise=noise, outliers=outliers)
    E = np.asarray(jquat.skew(jnp.asarray(t))) @ R
    valid = np.ones(len(x1), bool)
    valid[-2:] = False
    jR, jt, js = jinit.decompose_essential(*map(jnp.asarray, (E, x1, x2, valid)))
    tR, t_, ts = tinit.decompose_essential(*map(_b, (E, x1, x2, valid)))
    assert_close(tn(tR[0]), jR, 1e-9, what="R")
    assert_close(tn(t_[0]), jt, 1e-9, what="t")
    assert float(ts[0]) == float(js) >= 50
    assert np.abs(tn(tR[0]) - R).max() < 1e-6


def _rotation_pairs(axes_excited: bool):
    """``tests/test_initialization.py``'s pairs: excited on all axes (24
    pairs, the true rotation recoverable) or about one axis only."""
    rng = np.random.default_rng(1)
    ric = np.asarray(jquat.q2R(jquat.so3_exp(jnp.asarray([0.3, -0.5, 0.8]))))
    q_ic = jquat.R2q(jnp.asarray(ric))
    q_cam, q_imu = [], []
    for k in range(24):
        w = (rng.normal(0, 0.3, 3) if axes_excited
             else np.array([0.15 * ((k % 3) + 1), 0.0, 0.0]))
        qi = jquat.so3_exp(jnp.asarray(w))
        q_imu.append(np.asarray(qi))
        q_cam.append(np.asarray(jquat.qmul(jquat.qconj(q_ic), jquat.qmul(qi, q_ic))))
    return ric, np.stack(q_cam), np.stack(q_imu)


@pytest.mark.parametrize("excited", [True, False], ids=["converges", "rejects"])
def test_calibrate_extrinsic_rotation_matches_jax(excited):
    """ok equal (True with all axes excited, False about one axis) and the
    rotation within 1e-9; about one axis the null space of the stack is
    two-dimensional, so where inverse iteration lands depends on rounding:
    within 1e-6 there."""
    ric, qc, qi = _rotation_pairs(excited)
    valid = np.ones(len(qc), bool)
    jR, jok = jinit.calibrate_extrinsic_rotation(jnp.asarray(qc), jnp.asarray(qi),
                                                 jnp.eye(3), jnp.asarray(valid))
    tR, tok = tinit.calibrate_extrinsic_rotation(tt(qc), tt(qi), torch.eye(3, dtype=F64),
                                                 tt(valid))
    assert bool(tok) == bool(jok) == excited
    assert_close(tn(tR), jR, 1e-9 if excited else 1e-6, what="ric")
    if excited:
        assert np.abs(tn(tR) - ric).max() < 1e-6


def _window_preints(seed=0):
    """A window's preintegrations at zero bias (JAX, float64), its true
    poses and a valid mask with one interval off."""
    gt, (dts, accs, gyrs) = simulate_window_trajectory(seed=seed)
    noise = jimu.ImuNoise(*(jnp.asarray(v) for v in (0.1, 0.01, 1e-3, 1e-4)))
    z = jnp.zeros((10, 3))
    pre = jax.vmap(lambda d, a, g, ba, bg: jimu.preintegrate(d, a, g, ba, bg, noise))(
        jnp.asarray(dts), jnp.asarray(accs), jnp.asarray(gyrs), z, z)
    valid = np.ones(10, bool)
    valid[7] = False
    return gt, jax.device_get(pre), valid


@pytest.mark.parametrize("still", [False, True], ids=["moving", "still"])
def test_imu_excitation_ok_matches_jax(still):
    """Excited on the simulated window; not where Δv/Δt is one constant."""
    _, pre, valid = _window_preints()
    dv = np.outer(pre.sum_dt, [0.1, 0.0, 9.8]) if still else pre.delta_v
    j = jinit.imu_excitation_ok(jnp.asarray(dv), jnp.asarray(pre.sum_dt), jnp.asarray(valid))
    t = tinit.imu_excitation_ok(_b(dv), _b(pre.sum_dt), _b(valid))
    assert bool(t[0]) == bool(j) == (not still)


@pytest.mark.parametrize("fn", ["linear_alignment_with_depth", "refine_gravity_with_depth",
                                "linear_alignment", "_refine_gravity_scale"])
def test_alignment_matches_jax(fn):
    """Velocities, gravity (and scale) within 1e-6 of JAX's, ok flags equal;
    from the true poses (the monocular form on positions scaled by 0.5)
    the solves recover the true velocities and ‖g‖ = 9.805."""
    gt, pre, valid = _window_preints()
    tic = np.array([0.05, -0.02, 0.01])
    P = np.asarray(gt.P) + np.asarray(jquat.qrot(gt.Q, jnp.asarray(tic)))  # camera positions
    mono = fn in ("linear_alignment", "_refine_gravity_scale")
    if mono:
        P = 0.5 * P
    else:
        P = np.asarray(gt.P)
    g0 = np.array([0.3, -0.2, 9.7])
    args = [pre.delta_p, pre.delta_v, pre.sum_dt, P, np.asarray(gt.Q),
            tic if mono else np.zeros(3), valid]
    jout = getattr(jinit, fn)(*map(jnp.asarray, args), *([jnp.asarray(g0)] if "refine" in fn
                                                          else []), 9.805)
    tout = getattr(tinit, fn)(*map(_b, args), *([_b(g0)] if "refine" in fn else []), 9.805)
    for a, b in zip(tout, jout):
        a = tn(a[0])
        if a.dtype == bool:
            assert bool(a) == bool(b)
        else:
            assert_close(a, b, 1e-6, 1e-6, what=fn)
    if fn == "linear_alignment_with_depth":
        assert bool(tout[2][0])
        assert np.abs(tn(tout[0][0]) - np.asarray(
            jquat.qrot_inv(gt.Q, gt.V))).max() < 1e-3
    if fn == "linear_alignment":
        assert bool(tout[3][0]) and abs(float(tout[2][0]) - 2.0) < 1e-2
    if "refine" in fn:
        assert abs(np.linalg.norm(tn(tout[0][0])) - 9.805) < 1e-9


# ---------------------------------------------------------------------------
# the initialization programs and the estimator
# ---------------------------------------------------------------------------

def _vcfg(**kw):
    """``test_dynamic_init_e2e``'s configuration."""
    base = dict(imu=True, static_init=False, estimate_td=False, max_cnt=MAXC,
                max_features=MAXC, max_imu_per_frame=16, fix_depth=True, depth_min_dist=0.3,
                depth_max_dist=10.0, acc_n=0.1, gyr_n=0.01, acc_w=1e-4, gyr_w=1e-5)
    base.update(kw)
    return jconfig.VinsConfig(**base)


def port_vcfg(jvcfg):
    return tconfig.VinsConfig(**{f.name: getattr(jvcfg, f.name)
                                 for f in dataclasses.fields(tconfig.VinsConfig)})


def _stream(n=25, depth=True):
    """``test_dynamic_init_e2e``'s stream (seed 31); depth zeroed for the
    monocular one."""
    traj = simulate_long_trajectory(n, seed=31, omega_scale=0.3, acc_scale=0.6)
    L = make_landmark_field(traj, n_landmarks=500, seed=32)
    feats = []
    for k in range(n):
        f = project_frame_features(traj["P"][k], traj["Q"][k], L, MAXC)
        feats.append(f if depth else f._replace(depth=jnp.zeros_like(f.depth)))
    return traj, feats


def port_feats(f, dtype=np.float64):
    """JAX FrameFeatures of one frame -> the port's, B = 1."""
    return tftab.FrameFeatures(*[tt(np.asarray(v, dtype if np.asarray(v).dtype.kind == "f"
                                               else None))[None] for v in f])


def init_draws(key, key_mono, maxf=MAXC):
    """JAX's draws of one initialization attempt: the dynamic chain's from
    ``key``, the monocular ones from ``key_mono`` (the estimator passes
    ``keys[step]`` and ``keys[step + 1]``)."""
    chain = np.stack([jax_ransac_uniforms(jax.random.fold_in(key, j), 8, maxf)
                      for j in range(1, FRAMES)])
    mono_f = jax_ransac_uniforms(key_mono, 64, maxf)
    rounds = np.stack([np.stack([jax_ransac_uniforms(kf, 8, maxf) for kf in
                                 jax.random.split(jax.random.fold_in(key_mono, rnd), FRAMES)])
                       for rnd in range(3)])
    return chain, mono_f, rounds


def estimator_init_draws(keys):
    """The ``init_uniforms`` hook that gives JAX's ``VinsEstimator`` draws."""
    return lambda step: init_draws(keys[step % 4096], keys[(step + 1) % 4096])


def _filled_state(depth: bool):
    """The port's state after 11 window-filling frames of the stream (the
    IMU paired as the estimator pairs it)."""
    jvcfg = _vcfg()
    te = tes.VinsEstimator(port_vcfg(jvcfg), "cpu", dtype=F64)
    traj, feats = _stream(FRAMES, depth)
    for (t, a, w) in traj["imu"]:
        te.push_imu(t, a, w)
    for k in range(FRAMES - 1):
        te.process_features(port_feats(feats[k]), float(traj["times"][k]))
    # the eleventh frame, filled but not initialized
    cfg = te.cfg
    t11 = float(traj["times"][FRAMES - 1])
    iv = te._collect_interval_np(te.prev_time, t11)
    st, _ = tes.fill_step(cfg, te.state, FRAMES - 1, port_feats(feats[FRAMES - 1]),
                          te._upload_interval(*iv))
    return jvcfg, cfg, st


def to_jax(st):
    """The port's state (B = 1) -> JAX's."""
    return _to_jax(bridge.to_numpy(st), 0)


def _check_init(cfg, st_in, res, jres, atol, what):
    """ok equal; the states within ``atol``; where ok the outputs within
    ``atol`` too, where not the state exactly the input state slid (the
    output of a failed attempt is discarded by both hosts)."""
    (st, out, ok), (jst, jout, jok) = res, jres
    assert bool(ok[0]) == bool(jok)
    for f in ("P", "Q", "V", "Ba", "Bg"):
        assert_close(tn(getattr(st.x, f)[0]), getattr(jst.x, f), atol, what=f"{what} state {f}")
        if bool(jok):
            assert_close(tn(getattr(out, f)[0]), getattr(jout, f), atol, what=f"{what} out {f}")
    np.testing.assert_array_equal(tn(st.table.ids[0]), np.asarray(jst.table.ids))
    if not bool(jok):
        slid = tes._slide(cfg, st_in, torch.ones(1, dtype=torch.bool))
        for a, b in zip(jax.tree.leaves(bridge.to_numpy(st)), jax.tree.leaves(bridge.to_numpy(slid))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("depth", [True, False], ids=["depth", "no-depth"])
def test_init_dynamic_matches_jax_from_bridged_state(depth):
    """With depth it initializes; without, both fail and return the slid
    window."""
    jvcfg, cfg, st = _filled_state(depth)
    jcfg = jest.EstimatorConfig.from_vins(jvcfg)
    key = jax.random.PRNGKey(21)
    chain, _, _ = init_draws(key, key)
    jres = jest.init_dynamic(jcfg, to_jax(st), key)
    assert bool(jres[2]) == depth
    _check_init(cfg, st, tes.init_dynamic(cfg, st, tt(chain)[None]), jres, 1e-5, "init_dynamic")


def test_dlt_triangulate_matches_jax():
    """Points within 1e-6 (relative), counts and ok equal, from the true
    camera poses of the filled window with frames 3 and 7 unknown."""
    _, _, st = _filled_state(True)
    traj, _ = _stream(FRAMES)  # the camera is the IMU (identity extrinsic)
    R_cw = tt(np.asarray(jquat.q2R(jnp.asarray(traj["Q"]))))[None].transpose(-1, -2)
    t_wc = tt(traj["P"])[None]
    t_cw = -(R_cw @ t_wc[..., None])[..., 0]
    known = np.ones(FRAMES, bool)
    known[[3, 7]] = False
    obs = st.table.obs_mask & tftab.active_rows(st.table)[..., None]
    jpw, jn, jok = jest._dlt_triangulate(*(jnp.asarray(tn(a[0])) for a in
                                           (st.table.pts, obs, R_cw, t_cw)), jnp.asarray(known))
    pw, n, ok = tes._dlt_triangulate(st.table.pts, obs, R_cw, t_cw, tt(known)[None])
    np.testing.assert_array_equal(tn(ok[0]), np.asarray(jok))
    np.testing.assert_array_equal(tn(n[0]), np.asarray(jn))
    sel = np.asarray(jok)
    assert sel.sum() >= 20
    assert_close(tn(pw[0])[sel], np.asarray(jpw)[sel], 1e-6, 1e-6, what="points")


def test_init_mono_matches_jax_from_bridged_state():
    jvcfg, cfg, st = _filled_state(False)
    jcfg = jest.EstimatorConfig.from_vins(jvcfg)
    key = jax.random.PRNGKey(22)
    _, mono_f, rounds = init_draws(key, key)
    jres = jest.init_mono(jcfg, to_jax(st), key)
    assert bool(jres[2])
    _check_init(cfg, st, tes.init_mono(cfg, st, tt(mono_f)[None], tt(rounds)[None]), jres,
                1e-5, "init_mono")


@pytest.mark.parametrize("depth", [True, False], ids=["dynamic", "mono"])
def test_estimator_init_matches_jax_e2e(depth):
    """``test_dynamic_init_e2e`` and ``test_mono_init_e2e_no_depth`` through
    both estimators with JAX's ``PRNGKey(1)`` draws injected: the same
    frames give outputs, each within 1e-4 m of JAX's, and the relative
    motion meets the JAX tests' bounds."""
    jvcfg = _vcfg()
    traj, feats = _stream(25, depth)
    keys = jax.random.split(jax.random.PRNGKey(1), 4096)
    je = jest.VinsEstimator(jvcfg, dtype=jnp.float64)
    te = tes.VinsEstimator(port_vcfg(jvcfg), "cpu", dtype=F64,
                           init_uniforms=estimator_init_draws(keys))
    for (t, a, w) in traj["imu"]:
        je.push_imu(t, a, w)
        te.push_imu(t, a, w)
    outs = []
    for k in range(25):
        a = je.process_features(feats[k], float(traj["times"][k]))
        b = te.process_features(port_feats(feats[k]), float(traj["times"][k]))
        assert (a is None) == (b is None), k
        if b is not None:
            assert_close(b["P"], a["P"], 1e-4, what=f"P at {k}")
            outs.append((k, b))
    assert len(outs) >= (10 if depth else 8)
    (k0, o0), (k1, o1) = outs[0], outs[-1]
    d_est = np.linalg.norm(o1["P"] - o0["P"])
    d_gt = np.linalg.norm(traj["P"][k1] - traj["P"][k0])
    assert abs(d_est - d_gt) < (max(0.1 * d_gt, 0.08) if depth else max(0.15 * d_gt, 0.1))


def test_init_draws_are_made_on_the_host():
    """The initialization's and the extrinsic calibration's uniforms come
    from a host generator (seed 3) in the estimator's dtype and are then
    uploaded, so a card draws what the CPU draws, as JAX's keys give every
    backend the same draws: the estimator's draws equal ``torch.rand`` on
    a CPU generator seeded 3, in order."""
    e = tes.VinsEstimator(tconfig.VinsConfig(static_init=False), "cpu")
    assert e.init_generator.device.type == "cpu"
    g = torch.Generator()
    g.manual_seed(3)
    M = e.cfg.maxf
    for got, sh in zip(e.draw_init_uniforms(0), ((tes.FRAMES - 1, 8, M), (64, M),
                                                  (3, tes.FRAMES, 8, M))):
        assert got.dtype == torch.float32 and torch.equal(got, torch.rand((1,) + sh, generator=g))
    assert torch.equal(e.draw_ex_uniforms(1, 20), torch.rand((1, 64, 20), generator=g))
