"""The batched runner's static-buffer frame program (``_FrameProgram``, what
``run`` captures as a CUDA graph and replays on the card, and dispatches
eagerly on the CPU) against ``run_eager`` and against JAX's
``fused_frame_step``, and the launch accounting of replays.

The scene is ``tests/test_torch_sharded.py``'s 160×120 rig: one pipeline
warmed on the shared prefix, its state stacked into B = 4 lanes that then
diverge, with an IMU and without (VO).  Tolerances: the program against
``run_eager`` bit for bit (the same ops on the same values; only where
the states live differs); against JAX, fed JAX's per-frame uniforms from
the JAX-warmed state, the newest position within 5e-3 m, the bound of
``tests/test_torch_slice.py``, whose scene it shares."""

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_sharded import N_WARM, RIG, H, W
from tests.test_torch_slice import jax_steady_frames
from tests.torch_parity import tn, tt
from vins_rgbd_fast_torch import native
from vins_rgbd_fast_torch.config import VinsConfig
from vins_rgbd_fast_torch.io import synthetic as syn
from vins_rgbd_fast_torch.ops import fast, lk
from vins_rgbd_fast_torch.parallel import batched_pipeline as tbp
from vins_rgbd_fast_torch.pipeline import VinsPipeline

B, T = 4, 4


@pytest.fixture(scope="module", params=["imu", "vo"])
def lanes(request):
    """One pipeline (with an IMU, or VO) warmed on the shared prefix, its
    state stacked into B lanes, a runner over them, and the next 2T frames
    of the diverging lanes staged."""
    imu = request.param == "imu"
    seqs = [syn.make_trajectory(N_WARM + 2 * T, RIG, seed=5, omega_scale=0.12, acc_scale=0.25,
                                diverge_seed=b, diverge_after=N_WARM - 1) for b in range(B)]
    cfg = VinsConfig(
        imu=imu, static_init=True, image_width=W, image_height=H,
        intrinsics=(RIG.fx, RIG.fy, RIG.cx, RIG.cy), distortion=(0, 0, 0, 0),
        ric=tuple(seqs[0].ric.ravel().tolist()), tic=tuple(seqs[0].tic.tolist()),
        max_cnt=40, max_features=64, max_imu_per_frame=16, min_dist=12, num_grid_rows=3,
        num_grid_cols=4, frontend_freq=0.0, freq=0.0, fix_depth=True, depth_max_dist=12.0,
        acc_n=0.1, gyr_n=0.01, acc_w=1e-4, gyr_w=1e-5)
    rendered = [syn.render_sequence(s, RIG, "cpu") for s in seqs]
    t_cut = float(seqs[0].times[N_WARM - 1]) + 1e-9
    pipe = VinsPipeline(cfg, "cpu", eager_outputs=False, failure_check_interval=10 ** 9)
    for (t, a, w) in seqs[0].imu:
        if t <= t_cut:
            pipe.push_imu(t, a, w)
    ts0, imgs0, deps0 = rendered[0]
    for k in range(N_WARM):
        pipe.push_image(float(ts0[k]), imgs0[k])
        pipe.push_depth(float(ts0[k]), deps0[k])
        pipe.spin_once()
    pipe.close()
    assert pipe.estimator.solver_flag == pipe.estimator.NON_LINEAR
    lane_pipes = []
    for b in range(B):
        p = VinsPipeline(cfg, "cpu", eager_outputs=False, failure_check_interval=10 ** 9)
        for (t, a, w) in seqs[b].imu if imu else ():
            p.push_imu(t, a, w)
        lane_pipes.append(p)
    batch = tbp.stage_frames_arrays(lane_pipes, *([r[i] for r in rendered] for i in range(3)),
                                    N_WARM, N_WARM + 2 * T)
    for p in lane_pipes:
        p.close()
    trk, st = tbp.stack_states([pipe] * B)
    runner = tbp.BatchedVioRunner(pipe.tcfg, pipe.cam, pipe.estimator.cfg, "cpu", B)
    assert (runner.pnp_generators is None) == imu
    return dict(runner=runner, state=(trk, st), batch=batch)


def _frames(batch, k0, k1):
    return tbp.FrameBatch(*(a[k0:k1] for a in batch))


def _assert_equal_trees(a, b, what):
    la, lb = tbp.leaves(a), tbp.leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), (what, i, tuple(x.shape))


def test_program_equals_run_eager_bit_for_bit(lanes):
    """``run`` (the static-buffer program) and ``run_eager`` from the same
    states and generator states over T frames: P, Q, V, cost, keyframes,
    ``wp_*`` and the returned states equal bit for bit, and both leave the
    lanes' generators at the same place."""
    runner, (trk, st) = lanes["runner"], lanes["state"]
    batch = _frames(lanes["batch"], 0, T)
    g0 = chip_smoke.generator_states(runner)
    ref = runner.run_eager(trk, st, batch)
    g_eager = chip_smoke.generator_states(runner)
    chip_smoke.set_generator_states(runner, g0)
    got = runner.run(trk, st, batch)
    assert all(torch.equal(a, b) for a, b in zip(chip_smoke.generator_states(runner), g_eager))
    for f in tbp.ScanOutputs._fields:
        assert torch.equal(getattr(got[2], f), getattr(ref[2], f)), f
    _assert_equal_trees(got[0], ref[0], "tracker states")
    _assert_equal_trees(got[1], ref[1], "estimator states")
    assert tuple(got[2].P.shape) == (T, B, 3) and torch.isfinite(got[2].cost).all()
    runner.close()


def test_two_runs_equal_one_eager_run_of_twice_the_frames(lanes):
    """Two ``run`` calls of T frames, the second from the first's states,
    equal one ``run_eager`` of 2T frames; one program serves both calls; a
    state ``run`` returned is the caller's: the next call leaves it as it
    was, and changing it in place changes no later call."""
    runner, (trk, st) = lanes["runner"], lanes["state"]
    g0 = chip_smoke.generator_states(runner)
    ref = runner.run_eager(trk, st, lanes["batch"])
    chip_smoke.set_generator_states(runner, g0)
    trk1, st1, o1 = runner.run(trk, st, _frames(lanes["batch"], 0, T))
    prog = runner._prog
    kept = tbp.map_tree(torch.clone, (trk1, st1))
    g1 = chip_smoke.generator_states(runner)
    trk2, st2, o2 = runner.run(trk1, st1, _frames(lanes["batch"], T, 2 * T))
    assert runner._prog is prog
    _assert_equal_trees((trk1, st1), kept, "a returned state after the next call")
    for f in tbp.ScanOutputs._fields:
        assert torch.equal(torch.cat([getattr(o1, f), getattr(o2, f)]), getattr(ref[2], f)), f
    _assert_equal_trees((trk2, st2), ref[:2], "the states after 2T frames")
    for a in tbp.leaves((trk1, st1)):  # the caller's own: scribbled over
        a.fill_(7)
    chip_smoke.set_generator_states(runner, g1)
    again = runner.run(*kept, _frames(lanes["batch"], T, 2 * T))
    _assert_equal_trees(again, (trk2, st2, o2), "the second call, run again")
    runner.close()
    assert runner._prog is None


def test_first_frame_draws_equal_run_eager(lanes):
    """Setting up the program takes no draw from the lanes' generators:
    from the same generator states, ``run``'s first frame sees the draws
    ``run_eager``'s first frame does, and each call takes one frame's
    draws per lane per frame."""
    runner, (trk, st) = lanes["runner"], lanes["state"]
    one = _frames(lanes["batch"], 0, 1)
    g0 = chip_smoke.generator_states(runner)
    ref = runner.run_eager(trk, st, one)
    g1 = chip_smoke.generator_states(runner)
    chip_smoke.set_generator_states(runner, g0)
    runner.close()
    got = runner.run(trk, st, one)  # a new program, set up inside this call
    assert all(torch.equal(a, b) for a, b in zip(chip_smoke.generator_states(runner), g1))
    chip_smoke.set_generator_states(runner, g0)
    u = runner.ransac_uniforms()
    assert not all(torch.equal(a, b) for a, b in zip(chip_smoke.generator_states(runner), g0))
    _assert_equal_trees(got, ref, "frame 0")
    assert torch.equal(runner._prog.inp[1], u)  # the slot holds frame 0's draws
    runner.close()


def test_program_matches_jax_fed_its_draws():
    """The static-buffer program fed JAX's per-frame RANSAC uniforms from
    the JAX-warmed state (``tests/test_torch_slice.py``'s scene, B = 2,
    three steady frames): the newest position within 5e-3 m of JAX's
    ``fused_frame_step``'s."""
    runner, batch, trk, st, steps, seqs = jax_steady_frames(2, 3)
    steady = tbp.FrameBatch(*(a[11:] for a in batch))
    frame = tbp.FrameBatch(*(a[0] for a in steady))
    prog = tbp._FrameProgram(runner.tcfg, runner.cam, runner.ecfg,
                             tbp._layout((trk, st, frame)), trk, st)
    prog.load(trk, st, len(steps))
    for i, (us, jP) in enumerate(steps):
        prog.frame(steady, i, tt(us), None)
        err = np.abs(tn(prog.out.P) - jP).max()
        assert err < 5e-3, (i, err)
        assert np.all(np.isfinite(tn(prog.out.cost)))
    assert torch.equal(prog.outs.P[-1], prog.out.P)


class _Graph:
    """A stand-in for a captured CUDA graph: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replays_count_the_launches_their_capture_noted():
    """Launches counted while a thread records are noted, not counted;
    each replay of the captured program adds them to their counters, on
    their devices; a launch outside the recording counts at once."""
    counts = (fast.launches, lk.level_launches, lk.iterate_launches)
    before = [(c.total, dict(c.by_device)) for c in counts]
    with native.recording() as noted:
        fast.launches.add(0)
        lk.level_launches.add(0)
        lk.level_launches.add(0)
        lk.level_launches.add(1)
    assert [(c.total, dict(c.by_device)) for c in counts] == before
    assert noted == {(fast.launches, 0): 1, (lk.level_launches, 0): 2,
                     (lk.level_launches, 1): 1}
    graph = _Graph()
    captured = native.Captured(graph, noted)
    for _ in range(3):
        captured.replay()
    assert graph.replays == 3
    assert fast.launches.total == before[0][0] + 3
    assert lk.level_launches.total == before[1][0] + 9
    assert lk.level_launches.by_device.get(0, 0) == before[1][1].get(0, 0) + 6
    assert lk.level_launches.by_device.get(1, 0) == before[1][1].get(1, 0) + 3
    assert lk.iterate_launches.total == before[2][0]
    lk.iterate_launches.add(2)
    assert lk.iterate_launches.by_device.get(2, 0) == before[2][1].get(2, 0) + 1
    for c in counts:
        c.reset()
        assert c.total == 0 and c.by_device == {}
