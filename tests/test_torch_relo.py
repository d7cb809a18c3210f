"""Fast relocalization in the port's backend against the JAX package on the
CPU: ``remap_relo_by_id``, one ``vio_step`` with an active ``ReloData`` from
a bridged state (the state is warmed by the port on synthetic features, as
``tests/test_torch_backend.py`` does, and bridged to JAX), an inactive
constraint against none, and the extended ``StepOutput`` through the bridge.

Tolerances: the remap exact; the normal equations with the relo block
within 1e-5 of their largest entry; the step to the ``vio_step`` tolerance
of ``tests/test_torch_backend.py`` (P 1 mm, Q 5e-4), the optimized relo
position within 1 mm and its quaternion within 1e-3 (0.11°: the relo pose
rests on 20 points and two LM steps, and the two packages' float32 steps
part by more than their systems do); an inactive constraint gives the step without one within 1e-5 (P, Q, V; the cost
within 2e-5 of itself): the solve carries 6 more, decoupled, dimensions,
whose factorization rounds the window's step differently."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.helpers import make_landmark_field, project_frame_features, simulate_long_trajectory
from tests.test_torch_backend import _solver_problem, _to_jax, _window
from tests.torch_parity import assert_close, tn, tt
from vins_rgbd_fast_torch import bridge
from vins_rgbd_fast_torch.backend import estimator as tes
from vins_rgbd_fast_torch.backend import feature_table as tftab
from vins_rgbd_fast_torch.config import EstimatorConfig
from vins_rgbd_fast_torch.ops import solver as tslv
from vins_rgbd_fast_tpu.backend import estimator as jest
from vins_rgbd_fast_tpu.backend import feature_table as jftab
from vins_rgbd_fast_tpu.config import VinsConfig
from vins_rgbd_fast_tpu.ops import solver as jslv

MAXC = 48


def test_remap_relo_by_id_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.permutation(200)[:MAXC].astype(np.int32)
    ids[rng.random(MAXC) < 0.2] = -1
    match_ids = np.where(rng.random(MAXC) < 0.7, rng.permutation(ids), 500 + np.arange(MAXC))
    match_ids = match_ids.astype(np.int32)
    relo = dict(active=np.asarray(True), match_pts=rng.normal(size=(MAXC, 2)).astype(np.float32),
                match_valid=rng.random(MAXC) < 0.8, match_ids=match_ids,
                P=rng.normal(size=3).astype(np.float32),
                Q=np.array([1.0, 0, 0, 0], np.float32))
    j = jslv.remap_relo_by_id(jslv.ReloData(**{k: jnp.asarray(v) for k, v in relo.items()}),
                              jnp.asarray(ids))
    t = tslv.remap_relo_by_id(tslv.ReloData(**{k: tt(np.asarray(v))[None]
                                               for k, v in relo.items()}), tt(ids)[None])
    for a, b in zip(t, j):
        np.testing.assert_array_equal(tn(a[0]), np.asarray(b))
    assert 5 < int(tn(t.match_valid).sum()) < MAXC


def test_relo_normal_equations_match_jax():
    """The Schur-form system with the relo block (NX + 6 pose dims)."""
    _, x0, jvis, jimu, tvis, timu = _solver_problem()
    rng = np.random.default_rng(0)
    M = 32
    relo = dict(active=np.asarray(True),
                match_pts=(np.asarray(jvis.pts[:, 3])
                           + rng.normal(0, 1e-3, (M, 2))).astype(np.float32),
                match_valid=np.asarray(jvis.obs_mask[:, 3]) & np.asarray(jvis.valid),
                match_ids=np.arange(M, dtype=np.int32),
                P=(np.asarray(x0.P[3]) + 0.05).astype(np.float32),
                Q=np.asarray(x0.Q[3], np.float32))
    s_j, c_j = jax.jit(lambda *a: jslv.normal_equations_structured(
        jslv.SolverConfig(maxf=M, with_relo=True), *a))(
        x0, jvis, jimu, jax.tree.map(lambda a: jnp.asarray(a, a.dtype),
                                     jslv.empty_prior(jnp.float32)),
        jnp.asarray([0.0, 0.0, 9.805], jnp.float32), None,
        jslv.ReloData(**{k: jnp.asarray(v) for k, v in relo.items()}))
    s_t, c_t = tslv.normal_equations_structured(
        _window(x0), tvis, timu, tslv.empty_prior(1, "cpu"), tt(np.array([0, 0, 9.805],
                                                                          np.float32)),
        relo=tslv.ReloData(**{k: tt(np.asarray(v))[None] for k, v in relo.items()}))
    assert s_t.Hpp.shape[1] == s_j.Hpp.shape[0] == jslv.nxp(jslv.SolverConfig(maxf=M,
                                                                              with_relo=True))
    for name, a, b in zip(s_t._fields, s_t, s_j):
        b = np.asarray(b)
        assert_close(tn(a[0]), b, 1e-5 * np.abs(b).max(), what=name)
    assert_close(tn(c_t[0]), c_j, 0.0, 1e-6, what="cost")


@pytest.fixture(scope="module")
def warmed():
    """A port state after 11 window frames + static init + 1 steady step,
    and the inputs of the next step (B = 1)."""
    n = 14
    vcfg = VinsConfig(imu=True, static_init=True, max_cnt=MAXC, max_features=MAXC,
                      max_imu_per_frame=16, fix_depth=True, depth_min_dist=0.3,
                      depth_max_dist=10.0, keyframe_parallax=10.0, acc_n=0.1, gyr_n=0.01,
                      acc_w=1e-4, gyr_w=1e-5, max_num_iterations=2, fast_relocalization=True)
    tr = simulate_long_trajectory(n, seed=3)
    field = make_landmark_field(tr, n_landmarks=400, seed=10)
    cfg = EstimatorConfig.from_vins(dataclasses.replace(vcfg, fast_relocalization=False))
    buf = tes.ImuIntervalBuffer(cfg.max_imu)
    for (t, a, w) in tr["imu"]:
        buf.push(t, a, w)

    def frame(k):
        f = project_frame_features(tr["P"][k], tr["Q"][k], field, MAXC)
        feats = tftab.FrameFeatures(*[tt(np.asarray(v))[None] for v in f])
        feats = feats._replace(pts=feats.pts.float(), uv=feats.uv.float(),
                               vel=feats.vel.float(), depth=feats.depth.float())
        t0 = tr["times"][k - 1] if k > 0 else tr["times"][0] - 1e-3
        iv = buf.collect(float(t0), float(tr["times"][k]))
        return feats, tes.ImuInterval(*[tt(np.asarray(a, np.float32))[None] for a in iv])

    st = tes.init_estimator_state(cfg, np.eye(3), np.zeros(3), 0.0, 1, "cpu")
    for k in range(11):
        st, _ = tes.fill_step(cfg, st, k, *frame(k))
    st, _ = tes.init_full(cfg, st)
    st, _ = tes.vio_step(cfg, st, *frame(11))
    return vcfg, cfg, st, frame(12), tr


def _relo_for(st, tr, seed=1):
    """A constraint binding 20 window features to their observations in
    window slot 2 seen from a perturbed slot-2 pose."""
    rng = np.random.default_rng(seed)
    ids = tn(st.table.ids[0])
    obs = tn(st.table.obs_mask[0, :, 2]) & (ids >= 0)
    rows = np.nonzero(obs)[0][:20]
    maxf = ids.shape[0]
    match_ids = np.full(maxf, -1, np.int32)
    match_pts = np.zeros((maxf, 2), np.float32)
    match_ids[:len(rows)] = ids[rows]
    match_pts[:len(rows)] = tn(st.table.pts[0, rows, 2]) + rng.normal(0, 1e-3, (len(rows), 2))
    P = tn(st.x.P[0, 2]) + np.array([0.05, -0.02, 0.01], np.float32)
    Q = tn(st.x.Q[0, 2])
    return dict(active=np.asarray(True), match_pts=match_pts,
                match_valid=np.arange(maxf) < len(rows), match_ids=match_ids,
                P=P.astype(np.float32), Q=Q.astype(np.float32))


def test_vio_step_with_relo_matches_jax(warmed):
    vcfg, cfg, st, (feats, imu), tr = warmed
    cfg_r = dataclasses.replace(cfg, fast_relo=True)
    jcfg = jest.EstimatorConfig.from_vins(vcfg)
    assert jcfg.fast_relo and cfg_r.solver.with_relo
    relo = _relo_for(st, tr)
    st1, out = tes.vio_step(cfg_r, st, feats, imu,
                            tslv.ReloData(**{k: tt(np.asarray(v))[None] for k, v in relo.items()}))
    jst1, jout = jest.vio_step(jcfg, _to_jax(bridge.to_numpy(st), 0),
                               jftab.FrameFeatures(*[jnp.asarray(tn(v[0])) for v in feats]),
                               jest.ImuInterval(*[jnp.asarray(tn(v[0])) for v in imu]),
                               jax.random.PRNGKey(0),
                               jslv.ReloData(**{k: jnp.asarray(v) for k, v in relo.items()}))
    assert bool(out.relo_used[0]) and bool(jout.relo_used)
    assert_close(tn(out.P[0]), jout.P, 1e-3, what="P")
    assert_close(tn(out.Q[0]), jout.Q, 5e-4, what="Q")
    assert_close(tn(out.relo_P[0]), jout.relo_P, 1e-3, what="relo P")
    assert_close(tn(out.relo_Q[0]), jout.relo_Q, 1e-3, what="relo Q")
    assert_close(tn(out.relo_cur_P[0]), jout.relo_cur_P, 1e-3, what="relo cur P")
    assert_close(tn(st1.x.P[0]), jst1.x.P, 1e-3, what="window P")
    # the solve moved the relo pose towards slot 2's (the constraint's truth)
    assert (np.linalg.norm(tn(out.relo_P[0]) - tn(st.x.P[0, 2]))
            < np.linalg.norm(relo["P"] - tn(st.x.P[0, 2])))
    # the extended StepOutput through the bridge, both ways
    port_out = bridge.to_torch(jax.device_get(jout))
    assert type(port_out) is tes.StepOutput and port_out._fields == jout._fields
    for a, b in zip(bridge.to_numpy(port_out), jax.device_get(jout)):
        np.testing.assert_array_equal(a, b)
    relo_back = bridge.to_numpy(bridge.to_torch(jslv.ReloData(**relo)))
    for a, b in zip(relo_back, relo.values()):
        np.testing.assert_array_equal(a, b)


def test_inactive_relo_gives_the_step_without_one(warmed):
    _, cfg, st, (feats, imu), _ = warmed
    st_a, out_a = tes.vio_step(cfg, st, feats, imu)
    st_b, out_b = tes.vio_step(dataclasses.replace(cfg, fast_relo=True), st, feats, imu,
                               tslv.empty_relo(1, cfg.maxf, "cpu"))
    assert not bool(out_b.relo_used[0])
    for f in ("P", "Q", "V"):
        assert_close(tn(getattr(out_b, f)), tn(getattr(out_a, f)), 1e-5, what=f)
    assert_close(tn(out_b.cost), tn(out_a.cost), 0.0, 2e-5, what="cost")
    r0 = tn(st_a.prior.r0)  # whitened: the step's differences amplified (test_torch_backend)
    assert_close(tn(st_b.prior.r0), r0, 5e-2 * np.abs(r0).max(), what="prior r0")
    np.testing.assert_array_equal(tn(out_b.relo_P), np.zeros((1, 3), np.float32))


def test_estimator_queues_relo_from_another_thread(warmed):
    """``set_relo_frame`` stores host arrays under a lock; the next steady
    step takes them once."""
    vcfg, _, st, _, tr = warmed
    est = tes.VinsEstimator(vcfg, "cpu")
    relo = _relo_for(st, tr)
    est.set_relo_frame(relo["match_pts"], relo["match_valid"], relo["match_ids"], relo["P"],
                       relo["Q"])
    got = est.take_relo()
    assert est.take_relo() is None
    dev = tes.relo_to_device(got, "cpu")
    assert bool(dev.active[0])
    np.testing.assert_array_equal(tn(dev.match_ids[0]), relo["match_ids"])
