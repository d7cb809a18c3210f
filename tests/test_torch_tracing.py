"""The port's tracer (``vins_rgbd_fast_torch/utils/timing.py``) on the
latency pipeline and the batched runner, on the CPU, on the 160×120 stream
of ``tests/test_torch_pipeline.py`` (18 frames, the steady ones from frame
11): off by default and then invisible to the profiler; with tracing on,
spans nested under each frame's root with its frame id (the loop worker's
too), the stage marks of each steady frame in order, counters that add up
to the frames handed in, poses bit-equal to an untraced run, and an export
that reads back."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from vins_rgbd_fast_torch.backend import estimator as tes
from vins_rgbd_fast_torch.io import synthetic as tsyn
from vins_rgbd_fast_torch.parallel import batched_pipeline as tbp
from vins_rgbd_fast_torch.parallel import throughput as ttp
from vins_rgbd_fast_torch.pipeline import VinsPipeline
from vins_rgbd_fast_torch.utils import timing
from vins_rgbd_fast_torch.utils.timing import STAGES, TRACER

W, H, MAX_CNT, FRAMES = 160, 120, 32, 18


@pytest.fixture(scope="module")
def stream():
    rig, _, _, _ = chip_smoke.slice_config(W, H, MAX_CNT)
    seq = tsyn.make_trajectory(FRAMES + 8, rig, seed=7, omega_scale=0.15, acc_scale=0.3)
    ts, imgs, deps = tsyn.render_sequence(seq, rig, "cpu")
    return seq, ts, imgs, deps, chip_smoke.latency_config(rig, seq, MAX_CNT)


@pytest.fixture(autouse=True)
def tracer():
    TRACER.disable()
    TRACER.reset()
    yield TRACER
    TRACER.disable()
    TRACER.reset()


def _pipe(cfg, **kw):
    pipe = VinsPipeline(cfg, "cpu", fused_steady_state=True, **kw)
    pipe.estimator.cfg = dataclasses.replace(pipe.estimator.cfg, max_iters=2)
    pipe.tcfg = dataclasses.replace(pipe.tcfg, lk_max_iters=12, lk_coarse_iters=6)
    return pipe


def _drive(pipe, seq, ts, imgs, deps, n=FRAMES):
    for (t, a, g) in seq.imu:
        pipe.push_imu(t, a, g)
    outs = []
    for k in range(n):
        pipe.push_image(ts[k], imgs[k])
        pipe.push_depth(ts[k], deps[k])
        outs.append(pipe.spin_once())
    pipe.drain()
    return outs


def _by_id(records):
    return {r[0]: r for r in records}


@pytest.fixture(scope="module")
def traced(stream):
    """A traced run with the loop worker: its records, counters and stage
    sums."""
    TRACER.reset()
    TRACER.enable()
    try:
        pipe = _pipe(dataclasses.replace(stream[4], loop_closure=True), eager_outputs=False)
        _drive(pipe, *stream[:4])
        pipe.close()
        stager = pipe._loop_stager
        return dict(records=list(TRACER.records), counters=dict(TRACER.counters),
                    stages=TRACER.stage_sums(), dropped=TRACER.dropped,
                    stager=(stager.n_keyframes, stager.n_loops))
    finally:
        TRACER.disable()
        TRACER.reset()


def test_tracing_is_off_by_default_and_leaves_no_trace(stream, tracer):
    """Off (the default): a span is the one shared null context, and a
    profiled frame holds no range of the program's and keeps no record."""
    assert not timing.Tracer().on and TRACER.span("a") is TRACER.span("b")
    seq, ts, imgs, deps, cfg = stream
    pipe = _pipe(cfg)
    _drive(pipe, seq, ts, imgs, deps, n=FRAMES - 1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pipe.push_image(ts[FRAMES - 1], imgs[FRAMES - 1])
        pipe.push_depth(ts[FRAMES - 1], deps[FRAMES - 1])
        assert pipe.spin_once() is not None
    names = {e.name for e in prof.events()}
    assert not any(n.split("::")[0] in ("vins", "wait", "stage", "program") for n in names)
    assert TRACER.records == [] and TRACER.stage_sums()["track"] == [0.0, 0]
    assert TRACER.counters["vins::fused"] == FRAMES - 11  # counters are always on
    pipe.close()


def test_spans_nest_under_each_frame_and_the_worker_names_its_frame(traced):
    """On: every ``vins::`` and ``wait::`` span lies under a ``vins::frame``
    root of its thread with that root's frame id, each root has an id of
    its own, and the loop worker's spans (another thread) carry the frame
    id of a frame that handed a keyframe over."""
    recs = traced["records"]
    by_id = _by_id(recs)
    roots = [r for r in recs if r[2] == "vins::frame"]
    assert len(roots) == FRAMES and len({r[3] for r in roots}) == FRAMES
    for r in recs:
        if r[2].split("::")[0] in ("vins", "wait", "stage") and r[2] != "vins::frame":
            root = r
            while root[1] in by_id:
                root = by_id[root[1]]
            assert root[2] == "vins::frame" and root[3] == r[3] and root[6] == r[6], r
            assert root[4] <= r[4] <= r[5] <= root[5]
    handed = {r[3] for r in recs if r[2] == "vins::loop_handoff"}
    worker = [r for r in recs if r[2].startswith("loop::")]
    assert len(handed) == FRAMES - 11 and worker
    assert {r[3] for r in worker} <= handed and {r[6] for r in worker} != {roots[0][6]}
    names = {r[2] for r in recs}
    assert {"vins::pair", "vins::interval", "vins::upload", "vins::draws", "vins::replay",
            "vins::handout", "vins::emit", "vins::tracker_only", "wait::failure",
            "loop::gating_wait", "loop::extract", "loop::query"} <= names
    c = traced["counters"]
    assert c["loop::frames"] == FRAMES - 11 == c["wait::failure"] and traced["dropped"] == 0


def test_stage_marks_come_in_order_once_per_steady_frame(traced):
    """Each steady frame's step marks track, init, solve, marg, tail in
    that order, inside its ``vins::replay``; the sums count one mark per
    stage and steady frame."""
    recs = traced["records"]
    by_id = _by_id(recs)
    stages = {}
    for r in sorted((r for r in recs if r[2].startswith("stage::")), key=lambda r: r[4]):
        assert by_id[r[1]][2] == "vins::replay"
        stages.setdefault(r[3], []).append(r[2][len("stage::"):])
    assert len(stages) == FRAMES - 11 and all(v == list(STAGES) for v in stages.values())
    sums = traced["stages"]
    assert all(sums[s][1] == FRAMES - 11 and sums[s][0] > 0 for s in STAGES)


def test_the_stager_keeps_its_own_counts(traced):
    """The stager counts its keyframes and loops itself, and adds them to
    the tracer's ``loop::`` counters (one stager in the run: the same)."""
    c = traced["counters"]
    assert traced["stager"][0] > 0
    assert traced["stager"] == (c["loop::keyframes"], c.get("loop::loops", 0))


def test_marks_belong_to_the_thread_that_armed_them(tracer):
    """A mark from a thread that armed no step marks nothing, though
    another thread's step is armed meanwhile."""
    tracer.enable()
    with TRACER.marking(torch.device("cpu")):
        other = threading.Thread(target=TRACER.mark, args=("track",))
        other.start()
        other.join()
        for s in STAGES[:-1]:
            TRACER.mark(s)
    sums = TRACER.stage_sums()
    assert all(sums[s][1] == 1 and sums[s][0] >= 0 for s in STAGES)
    assert len([r for r in TRACER.records if r[2] == "stage::track"]) == 1


def _runner_scene(B: int, T: int):
    """A runner warmed on 11 frames of B rendered sequences, its states,
    its next T frames staged, and its configuration."""
    rig, tcfg, ecfg, cam = chip_smoke.slice_config(W, H, MAX_CNT)
    seqs, rendered, bufs = chip_smoke.make_sequences(rig, B, 11 + T, "cpu")
    frames = ([r[1] for r in rendered], [r[2] for r in rendered], [r[0] for r in rendered], bufs)
    runner = tbp.BatchedVioRunner(tcfg, cam, ecfg, "cpu", B)
    trk, st = runner.init_states(seqs[0].ric, seqs[0].tic)
    trk, st, _ = runner.warm(trk, st, tbp.stage_frames(*frames, 0, 11, "cpu"))
    return runner, trk, st, tbp.stage_frames(*frames, 11, 11 + T, "cpu"), (tcfg, cam, ecfg)


def test_run_sharded_traces_one_call_over_its_shards(tracer):
    """``run_sharded`` over two CPU entries: one ``runner::run`` root per
    call, whose frame id every span of the call carries; each shard's
    draws, inputs, replay, outputs and stage marks once per frame."""
    B, T, n = 2, 2, 2
    _, trk, st, batch, cfg = _runner_scene(B, T)
    sharded = tbp.BatchedVioRunner(*cfg, None, B, mesh=ttp.make_mesh(n, device="cpu"))
    tracer.enable()
    sharded.run_sharded(sharded.put_states(trk), sharded.put_states(st),
                        sharded.put_batch(batch))
    recs = TRACER.records
    roots = [r for r in recs if r[2] == "runner::run"]
    assert len(roots) == 1 and all(r[3] == roots[0][3] for r in recs)
    spans = TRACER.delta()["spans"]
    assert all(spans[f"runner::{s}"][1] == n * T for s in ("draws", "replay", "outputs"))
    assert spans["runner::inputs"][1] == n * T + 1 and spans["runner::states"][1] == 1
    assert all(spans["stage::" + s][1] == n * T for s in STAGES)


def test_the_runner_traces_its_calls_and_marks_each_frame(tracer):
    """``BatchedVioRunner.run``: one ``runner::run`` root per call, its
    draws, inputs, replay and outputs once per frame, the states once, and
    the stage marks once per frame."""
    B, T = 2, 2
    runner, trk, st, batch, _ = _runner_scene(B, T)
    tracer.enable()
    runner.run(trk, st, batch)
    spans = TRACER.delta()["spans"]
    assert spans["runner::run"][1] == 1
    assert all(spans[f"runner::{n}"][1] == T for n in ("draws", "replay", "outputs"))
    assert spans["runner::inputs"][1] == T + 1 and spans["runner::states"][1] == 1
    assert all(spans["stage::" + s][1] == T for s in STAGES)
    assert spans["runner::run"][2] <= spans["runner::run"][0]


def test_frame_counters_add_up_to_the_frames_handed_in(stream, tracer):
    """With a publish rate below the camera's, every frame handed in is
    skipped, withheld from the estimator, or run unfused or steady:
    counted once, traced or not."""
    seq, ts, imgs, deps, cfg = stream
    n = FRAMES + 8
    pipe = _pipe(dataclasses.replace(cfg, frontend_freq=20.0, freq=15.0))
    _drive(pipe, seq, ts, imgs, deps, n=n)
    pipe.close()
    c = TRACER.counters
    assert c["pairer::pairs"] == n and c["pairer::unpublished"] > 0
    held = 1 if pipe._held_frame is not None else 0
    assert (c.get("pairer::skipped", 0) + c["pairer::unpublished"] + c.get("vins::fused", 0)
            + c["vins::unfused"] + held) == n


def test_poses_are_bit_equal_traced_or_not(stream, tracer):
    """The marks and spans change no value: every output of a traced run
    equals the untraced run's bit for bit."""
    runs = []
    for on in (False, True):
        tracer.on = on
        pipe = _pipe(stream[4])
        _drive(pipe, *stream[:4])
        runs.append(pipe.estimator._pending)
        pipe.close()
    assert TRACER.records  # the second run was traced
    (a, b) = runs
    assert [t for t, _ in a] == [t for t, _ in b] and len(a) == FRAMES - 10
    for (_, x), (_, y) in zip(a, b):
        for f in tes.StepOutput._fields:
            u, v = getattr(x, f), getattr(y, f)
            assert torch.equal(u.reshape(-1).view(torch.uint8), v.reshape(-1).view(torch.uint8)), f


def test_export_reads_back(stream, tracer, tmp_path):
    """``export`` then ``load``: the same records, counters and stage sums."""
    tracer.enable()
    pipe = _pipe(stream[4])
    _drive(pipe, *stream[:4], n=FRAMES - 4)
    pipe.close()
    with TRACER.span("outer", frame=7):
        with TRACER.span("inner"):
            TRACER.count("some::count", 3)
    path = str(tmp_path / "trace.json")
    TRACER.export(path)
    got = timing.load(path)
    assert got["records"] == TRACER.records and got["counters"] == TRACER.counters
    assert got["stages"] == TRACER.stage_sums() and got["dropped"] == 0
    inner = next(r for r in got["records"] if r[2] == "inner")
    assert inner[3] == 7 and _by_id(got["records"])[inner[1]][2] == "outer"
    d = TRACER.delta(TRACER.snapshot())
    assert d["spans"] == {} and d["counters"] == {} and d["stages"]["tail"] == [0.0, 0]
    assert np.isclose(TRACER.delta()["spans"]["inner"][0],
                      1e-9 * (inner[5] - inner[4]))


def test_the_buffer_is_bounded_and_counts_what_it_drops(tracer):
    t = timing.Tracer(capacity=3)
    t.enable()
    for _ in range(5):
        with t.span("s"):
            pass
    assert len(t.records) == 3 and t.dropped == 2 and t.delta()["spans"]["s"][1] == 3
