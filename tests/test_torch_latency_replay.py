"""The latency pipeline's steady frame as one frame program
(``VinsPipeline(replay=True)``, the default: ``_FrameProgram``, captured
as a CUDA graph and replayed on the card, its static-buffer step run
eagerly on the CPU) against the same pipeline dispatched op by op
(``replay=False``, the plain version), on ``tests/test_torch_pipeline.py``'s
stream (160×120 radtan rig, max_cnt 32, 18 frames, the bench's envelope:
frames 11-17 are the steady ones).

Tolerance: none.  Both paths run the same ops on the same values in the
same order, so every ``StepOutput`` field of every frame, the end states
and the generators' states agree bit for bit (NaN payloads included).
The last test rehearses a capture's rules on the CPU: no read-back to the
host and no tensor made from host data inside the step."""

import dataclasses
import gc
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from tests.test_torch_pipeline import FRAMES, _drive, _envelope, stream  # noqa: F401
from vins_rgbd_fast_torch.backend import estimator as tes
from vins_rgbd_fast_torch.loop import pose_graph as tpg
from vins_rgbd_fast_torch.parallel import batched_pipeline as tbp
from vins_rgbd_fast_torch.parallel import loop_closer as tlc
from vins_rgbd_fast_torch.pipeline import VinsPipeline as TPipeline
from vins_rgbd_fast_torch.utils import quaternion_np as tnq

MODES = {"imu": {}, "vo": dict(imu=False), "relo": dict(fast_relocalization=True)}


def _pipe(tcfg, replay: bool = True, **kw):
    return _envelope(TPipeline(tcfg, "cpu", fused_steady_state=True, replay=replay, **kw))


def _pair(tcfg, **kw):
    """The plain pipeline and the program's, built alike."""
    return [_pipe(tcfg, r, **kw) for r in (False, True)]


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.detach().reshape(-1).contiguous().view(torch.uint8)


def _same_tree(a, b) -> bool:
    la, lb = tbp.leaves(a), tbp.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _assert_same_run(plain, prog):
    """Every output (all ``StepOutput`` fields), the end states and the
    generators of two pipelines, bit for bit."""
    pa, pb = plain.estimator._pending, prog.estimator._pending
    assert [t for t, _ in pa] == [t for t, _ in pb]
    for (t, x), (_, y) in zip(pa, pb):
        for f in tes.StepOutput._fields:
            assert _same_tree(getattr(x, f), getattr(y, f)), (t, f)
    assert _same_tree(plain.tracker_state, prog.tracker_state), "tracker states"
    assert _same_tree(plain.estimator.state, prog.estimator.state), "estimator states"
    for g, h in ((plain._generator, prog._generator),
                 (plain.estimator.pnp_generator, prog.estimator.pnp_generator)):
        assert torch.equal(g.get_state(), h.get_state())
    assert plain.estimator.solver_flag == prog.estimator.solver_flag


def _no_imu(seq):
    return seq._replace(imu=[])


@pytest.mark.parametrize("mode", list(MODES))
def test_program_equals_plain_bit_for_bit(stream, mode):
    """(a) The steady frames through the program equal the per-op frames
    bit for bit, with an IMU, in VO and with a relocalization constraint
    queued mid-stream (frame 14 carries an active relo block, the other
    steady frames inactive ones)."""
    seq, ts, imgs, deps, tcfg = stream
    tcfg = dataclasses.replace(tcfg, **MODES[mode])
    if mode == "vo":
        seq = _no_imu(seq)
    pipes = _pair(tcfg)
    for p in pipes:
        _drive(p, seq, ts, imgs, deps, 0, 14)
        if mode == "relo":  # frame 12's window points, seen again from its pose
            o = p.estimator._pending[2][1]
            p.estimator.set_relo_frame(o.wp_norm[0], o.wp_valid[0], o.wp_ids[0], o.P[0],
                                       o.Q[0])
        _drive(p, seq, ts, imgs, deps, 14, FRAMES)
    plain, prog = pipes
    assert prog._fused_step == plain._fused_step == FRAMES - 11
    assert prog._prog is not None and plain._prog is None
    _assert_same_run(plain, prog)
    used = [bool(o.relo_used[0]) for _, o in prog.estimator._pending]
    assert used == [mode == "relo" and k == 14 for k in range(10, FRAMES)]


def test_taken_states_and_outputs_do_not_change(stream):
    """(b) A state taken from the pipeline before a steady frame, and the
    output of the frame before, are unchanged after it (the program's
    buffers are not what it hands out)."""
    seq, ts, imgs, deps, tcfg = stream
    pipe = _pipe(tcfg)
    _drive(pipe, seq, ts, imgs, deps, 0, 15)
    taken = (pipe.tracker_state, pipe.estimator.state, pipe.estimator._pending[-1][1])
    kept = tbp.map_tree(torch.clone, taken)
    _drive(pipe, seq, ts, imgs, deps, 15, 16)
    assert pipe.tracker_state is not taken[0] and pipe.estimator.state is not taken[1]
    assert _same_tree(taken, kept)
    assert not _same_tree(taken[2].P, pipe.estimator._pending[-1][1].P)


def test_reset_and_reinit_reload_the_program(stream):
    """(c) States replaced from outside the program are loaded into it: a
    poisoned state (by hand) fails the check and resets the estimator, a
    >1 s gap resets both again, the stream initializes anew, and its steady
    frames give the plain path's outputs."""
    seq, ts, imgs, deps, tcfg = stream
    shift = float(ts[-1] - ts[0]) + 2.0
    again = seq._replace(imu=[(t + shift, a, g) for (t, a, g) in seq.imu])
    pipes = _pair(tcfg)
    for p in pipes:
        _drive(p, seq, ts, imgs, deps, 0, 13)
        st = p.estimator.state
        p.estimator.state = st._replace(x=st.x._replace(Ba=st.x.Ba + 100.0))
        flags, Ps = _drive(p, seq, ts, imgs, deps, 13, 14)
        assert Ps == [None] and flags == [tes.VinsEstimator.INITIAL]
        flags, _ = _drive(p, again, ts + shift, imgs, deps, 0, FRAMES)
        assert flags[-1] == tes.VinsEstimator.NON_LINEAR
    plain, prog = pipes
    assert prog._fused_step == 3 + FRAMES - 11  # frames 11-13, then 11-17 again
    _assert_same_run(plain, prog)


def test_replaced_configs_rebuild_the_program(stream):
    """(d) The envelope, set after construction, is what the program runs;
    configs replaced again mid-stream make a new program, and the frames
    still equal the plain path's."""
    seq, ts, imgs, deps, tcfg = stream
    pipes = _pair(tcfg)
    for p in pipes:
        _drive(p, seq, ts, imgs, deps, 0, 13)
    prog0 = pipes[1]._prog
    assert prog0.cfg == (pipes[1].tcfg, pipes[1].cam, pipes[1].estimator.cfg)
    assert prog0.cfg[2].max_iters == 2 and prog0.cfg[0].lk_max_iters == 12
    for p in pipes:
        p.estimator.cfg = dataclasses.replace(p.estimator.cfg, max_iters=1)
        p.tcfg = dataclasses.replace(p.tcfg, lk_max_iters=8)
        _drive(p, seq, ts, imgs, deps, 13, FRAMES)
    prog1 = pipes[1]._prog
    assert prog1 is not prog0 and prog0.graph is None and prog0.trk is None
    assert prog1.cfg[2] is pipes[1].estimator.cfg and prog1.cfg[0] is pipes[1].tcfg
    _assert_same_run(*pipes)


def test_kept_outputs_are_per_frame_copies(stream):
    """(e) The trajectory and what the loop stager keeps for its worker
    (each frame's outputs, image and depth) are distinct per frame, not
    the program's slots, and equal the plain path's."""
    seq, ts, imgs, deps, tcfg = stream
    got = []
    pipes = _pair(dataclasses.replace(tcfg, loop_closure=True), eager_outputs=False)
    for p in pipes:
        seen = []
        p._loop_stager._process = lambda toks, seen=seen: seen.append(toks)
        for (t, a, g) in seq.imu:
            p.push_imu(t, a, g)
        for k in range(FRAMES):
            p.push_image(ts[k], imgs[k])
            p.push_depth(ts[k], deps[k])
            p.spin_once()
        if p.replay:
            slots = {a.untyped_storage().data_ptr() for a in tbp.leaves(p._prog.inp)}
        p.close()
        got.append([tok for toks in seen for tok in toks])
    (plain, prog), (kp, kr) = pipes, got
    assert len(kr) == len(kp) == FRAMES - 11 and len(slots) == 4
    ptrs = []
    for (row_p, t_p, s_p, img_p, dep_p, *_), (row_r, t_r, s_r, img_r, dep_r, *_) in zip(kp, kr):
        assert t_p == t_r and _same_tree((s_p, img_p, dep_p), (s_r, img_r, dep_r))
        assert np.array_equal(row_p.get()[0], row_r.get()[0])
        ptrs += [a.untyped_storage().data_ptr() for a in tbp.leaves((s_r, img_r, dep_r))]
    assert len(ptrs) == len(set(ptrs)) and not slots & set(ptrs)
    outs = [o for _, o in prog.estimator._pending]
    assert len({o.P.untyped_storage().data_ptr() for o in outs}) == len(outs)
    tp, tr = plain.estimator.trajectory, prog.estimator.trajectory
    assert len(tr) == len(tp) == FRAMES - 10
    for a, b in zip(tp, tr):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    _assert_same_run(plain, prog)


def test_stager_hands_frames_over_when_its_worker_is_idle(stream):
    """Replayed frames can outrun the loop stager's worker: the frame
    thread never waits for it, holds the frames that come while it is
    busy, and hands them all over, as one round, at the first frame that
    finds it idle."""
    seq, ts, imgs, deps, tcfg = stream
    pipe = _pipe(dataclasses.replace(tcfg, loop_closure=True), eager_outputs=False)
    for (t, a, g) in seq.imu:
        pipe.push_imu(t, a, g)
    for k in range(12):
        pipe.push_image(ts[k], imgs[k])
        pipe.push_depth(ts[k], deps[k])
        pipe.spin_once()
    stager = pipe._loop_stager
    stager.drain()
    rounds = []
    stager._process = lambda toks: rounds.append(len(toks))
    held = threading.Event()
    stager._worker.put(lambda: held.wait(10))  # the worker is busy until released
    sout, img = pipe.estimator._pending[-1][1], pipe.tracker_state.pyramid[0][0]
    t0 = time.perf_counter()
    for k in range(5):
        stager.on_frame(sout, img, float(k), depth=img)
    assert time.perf_counter() - t0 < 5 and stager.pending == 5 and rounds == []
    held.set()
    while not stager._worker.idle():
        time.sleep(0.01)
    stager.on_frame(sout, img, 5.0, depth=img)  # the worker is idle: all six go
    assert stager.pending == 0
    stager.on_frame(sout, img, 6.0, depth=img)
    pipe.close()
    assert rounds[:1] == [6] and sum(rounds) == 7 and stager.max_round == 6


def _pose(rng):
    q = rng.normal(size=4)
    return rng.normal(size=3), q / np.linalg.norm(q)


def test_relo_keyframe_pose_carries_the_solve_back_to_the_keyframe():
    """The solve's pose of its second-newest frame, carried to the loop's
    keyframe by the odometry between their outputs: the keyframe's own
    output when the solve left that frame where its output had it, and
    moved with any change the solve made to it."""
    rng = np.random.default_rng(0)
    (P_prev, Q_prev), (P_kf, Q_kf), (t_fix, q_fix) = _pose(rng), _pose(rng), _pose(rng)
    P, Q = tpg.relo_keyframe_pose(P_prev, Q_prev, P_prev, Q_prev, P_kf, Q_kf)
    np.testing.assert_allclose(P, P_kf, atol=1e-12)
    np.testing.assert_allclose(Q, Q_kf, atol=1e-12)
    # the solve moved the frame by (t_fix, q_fix): the keyframe moves with it
    R = tnq.q2R(q_fix)
    P, Q = tpg.relo_keyframe_pose(R @ P_prev + t_fix, tnq.qmul(q_fix, Q_prev), P_prev, Q_prev,
                                  P_kf, Q_kf)
    np.testing.assert_allclose(P, R @ P_kf + t_fix, atol=1e-12)
    np.testing.assert_allclose(tnq.q2R(Q), R @ tnq.q2R(Q_kf), atol=1e-12)


def test_stager_refines_the_loop_edge_against_its_keyframe():
    """A relocalization that reached the frame right after its keyframe
    refines the loop edge against the solve's second-newest frame, as the
    inline pose graph does; one that reached a later frame, against the
    keyframe carried there by the odometry."""
    rng = np.random.default_rng(1)
    kf = SimpleNamespace(t=3.0, P_vio=rng.normal(size=3), Q_vio=_pose(rng)[1])
    updates = []
    stager = SimpleNamespace(g=SimpleNamespace(
        keyframes=[None, kf], update_keyframe_loop=lambda *a: updates.append(a)))
    row = np.zeros(23)
    row[9:12], row[12:16] = _pose(rng)
    row[16:19], row[19:23] = _pose(rng)
    prev = np.zeros(23)
    prev[1:4], prev[4:8] = _pose(rng)
    for t_prev in (3.0, 4.0):
        stager._relo_sent_kf = 1
        tlc.AsyncLoopStager._consume_relo(stager, row, (t_prev, prev))
        assert stager._relo_sent_kf is None
    P, Q = tpg.relo_keyframe_pose(row[16:19], row[19:23], prev[1:4], prev[4:8], kf.P_vio,
                                  kf.Q_vio)
    for (index, *got), want in zip(updates, (
            tpg.relo_relative_pose(row[9:12], row[12:16], row[16:19], row[19:23]),
            tpg.relo_relative_pose(row[9:12], row[12:16], P, Q))):
        assert index == 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


class _CaptureRules(TorchDispatchMode):
    """Records what a CUDA graph's capture refuses: ops that read a value
    back to the host or select by a data-dependent count, tensors made from
    host data (``torch.tensor`` of an array; a Python number's 0-dim lift,
    as ``x[i] = 0.0`` makes, is a fill on the card), and tensor arguments
    that neither existed before the step nor came out of an op inside it
    (``torch.as_tensor`` of a host array)."""

    READS = {"_local_scalar_dense", "item", "is_nonzero", "equal", "nonzero", "masked_select",
             "unique", "_unique", "_unique2", "unique_consecutive", "unique_dim"}
    HOST = {"lift_fresh", "lift_fresh_copy"}

    def __init__(self, known: set):
        super().__init__()
        self.known, self.made, self.bad = set(known), set(), []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        tensors = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        if name in self.READS:
            self.bad.append(("reads back", str(func)))
        if name in self.HOST:
            if tensors[0].dim() > 0:  # not a Python number's 0-dim lift
                self.bad.append(("host data", str(func), tuple(tensors[0].shape)))
            tensors = []
        if name in ("index", "index_put", "index_put_") and any(
                a.dtype in (torch.bool, torch.uint8) for a in tree_leaves(args[1:2])
                if isinstance(a, torch.Tensor)):
            self.bad.append(("boolean mask", str(func)))
        for a in tensors:
            if a.untyped_storage().data_ptr() not in self.known | self.made:
                self.bad.append(("a tensor from outside", str(func), tuple(a.shape)))
        out = func(*args, **(kwargs or {}))
        self.made |= {a.untyped_storage().data_ptr() for a in tree_leaves(out)
                      if isinstance(a, torch.Tensor)}
        return out


@pytest.mark.parametrize("mode", ["imu", "vo"])
def test_steady_step_keeps_the_capture_rules(stream, mode):
    """(f) One steady step of the program after its warm-up, under a
    dispatch mode: no op reads a value back to the host, none selects by a
    boolean mask, and no tensor is made from host data inside it."""
    seq, ts, imgs, deps, tcfg = stream
    tcfg = dataclasses.replace(tcfg, **MODES[mode])
    pipe = _pipe(tcfg)
    _drive(pipe, _no_imu(seq) if mode == "vo" else seq, ts, imgs, deps, 0, 14)
    prog = pipe._prog
    assert prog is not None and prog.out is not None
    known = {0} | {o.untyped_storage().data_ptr() for o in gc.get_objects()
                   if issubclass(type(o), torch.Tensor)}
    rules = _CaptureRules(known)
    with rules:
        prog.step()
    assert rules.made, "the step dispatched no op"
    assert rules.bad == []
