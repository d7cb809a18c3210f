"""The port's multi-device program on meshes of CPU entries (the twin of
JAX's 8 virtual host devices): ``parallel/throughput.py``'s
``make_batched_step`` against JAX's over a 4-device mesh, the runner's
``run_sharded`` against its ``run``, lane draws that do not depend on the
split, the refusals, the dry run and a rehearsal of ``chip_smoke.py``'s
phase 21.

Tolerances: the sharded batched step within 1e-5 of JAX's sharded step
from the same (bridged) float64 states over four frames, as
``test_torch_throughput.py``'s unsharded step; ``run_sharded`` against
``run`` over the same lanes within JAX's own tolerances for its sharded
scan (``tests/test_sharded_runner.py``: P within 5e-4 m, cost within rtol
5e-3, keyframe flags equal; the largest seen on the CPU is printed); lane
draws and generator states bit-equal."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jg
import __graft_entry_torch__ as tg
import chip_smoke
from vins_rgbd_fast_torch.config import VinsConfig
from vins_rgbd_fast_torch.io import synthetic as syn
from vins_rgbd_fast_torch.parallel import batched_pipeline as tbp
from vins_rgbd_fast_torch.parallel import throughput as ttp
from vins_rgbd_fast_torch.pipeline import VinsPipeline
from vins_rgbd_fast_tpu.parallel import throughput as jtp

B = 8
P_ATOL, COST_RTOL = 5e-4, 5e-3  # JAX's, tests/test_sharded_runner.py
W, H = 160, 120  # the rig of tests/test_sharded_runner.py
RIG = syn.SyntheticRig(width=W, height=H, fx=115.0, fy=115.0, cx=80.0, cy=60.0,
                       imu_rate=200.0, frame_rate=20.0)
N_WARM, N_SCAN = 14, 4


def _drifted(pts, k, xp):
    """Frame k's observations: every sequence's own offset, drifting."""
    return pts + (xp.arange(B)[:, None, None] * 2e-3 + 0.004 * k)


def test_sharded_batched_step_matches_jax_on_a_four_device_mesh():
    """(a) 8 lanes over four mesh entries: the port's outputs come back as
    4 shards of 2 lanes in lane order, each on its entry, and equal JAX's
    ``make_batched_step`` over 4 of its virtual devices within 1e-5."""
    jcfg, tcfg = jg._example_cfg(maxf=16, maxi=8), tg._example_cfg(maxf=16, maxi=8)
    js, jf, ji, jk = jg._example_inputs(jcfg, dtype=jnp.float64, batch=B)
    ts, tf, ti = tg._example_inputs(tcfg, dtype=torch.float64, batch=B, device="cpu")
    jmesh, tmesh = jtp.make_mesh(4), ttp.make_mesh(4, device="cpu")
    assert tmesh == [torch.device("cpu")] * 4
    jstep, tstep = jtp.make_batched_step(jcfg, jmesh), ttp.make_batched_step(tcfg, tmesh)
    js, ji, jk = (jtp.batch_shard(jmesh, t) for t in (js, ji, jk))
    ts, ti = ttp.batch_shard(tmesh, ts), ttp.batch_shard(tmesh, ti)
    for k in range(4):
        jfk = jtp.batch_shard(jmesh, jf._replace(pts=_drifted(jf.pts, k, jnp)))
        js, jout = jstep(js, jfk, ji, jk)
        ts, tout = tstep(ts, tf._replace(pts=_drifted(tf.pts, k, torch)), ti)
        assert len(jout.P.sharding.device_set) == 4
        assert len(tout.parts) == 4 and tout.mesh == tuple(tmesh)
        for i, part in enumerate(tout.parts):  # lane order: shard i holds lanes 2i, 2i + 1
            assert tuple(part.P.shape) == (2, 3)
            np.testing.assert_allclose(part.P.numpy(), np.asarray(jout.P)[2 * i:2 * i + 2],
                                       atol=1e-5, err_msg=f"shard {i} at frame {k}")
        out = tout.gather("cpu")
        for f in ("P", "Q", "V"):
            np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(jout, f)),
                                       atol=1e-5, err_msg=f"{f} at frame {k}")
        np.testing.assert_allclose(out.cost.numpy(), np.asarray(jout.cost), atol=1e-5,
                                   rtol=1e-5)
    assert len(ts.parts) == 4 and ts.devices() == {torch.device("cpu")}


@pytest.fixture(scope="module")
def warmed():
    """tests/test_sharded_runner.py's scene in the port: ONE pipeline
    warmed on the shared prefix (14 frames), its state stacked into 8
    lanes that then diverge, and their next 4 frames staged."""
    n_frames = N_WARM + N_SCAN
    seqs = [syn.make_trajectory(n_frames, RIG, seed=5, omega_scale=0.12, acc_scale=0.25,
                                diverge_seed=b, diverge_after=N_WARM - 1) for b in range(B)]
    cfg = VinsConfig(
        imu=True, static_init=True, image_width=W, image_height=H,
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
        for (t, a, w) in seqs[b].imu:
            p.push_imu(t, a, w)
        lane_pipes.append(p)
    batch = tbp.stage_frames_arrays(lane_pipes, *([r[i] for r in rendered] for i in range(3)),
                                    N_WARM, n_frames)
    for p in lane_pipes:
        p.close()
    trk, st = tbp.stack_states([pipe] * B)
    args = (pipe.tcfg, pipe.cam, pipe.estimator.cfg)
    ref = tbp.BatchedVioRunner(*args, "cpu", B)
    runs = {1: ref.run(trk, st, batch)}
    runners = {1: ref}
    for n in (2, 4):
        r = tbp.BatchedVioRunner(*args, None, B, mesh=ttp.make_mesh(n, device="cpu"))
        runs[n] = r.run_sharded(r.put_states(trk), r.put_states(st), r.put_batch(batch))
        runners[n] = r
    return dict(args=args, state=(trk, st), batch=batch, runs=runs, runners=runners)


@pytest.mark.parametrize("n", [2, 4])
def test_run_sharded_matches_run(warmed, n):
    """(b) ``run_sharded`` over n CPU entries against ``run`` on the same 8
    lanes, 4 frames, within JAX's tolerances; states and outputs come back
    sharded, and a second ``run_sharded`` continues from the states."""
    _, _, ref = warmed["runs"][1]
    trk, st, outs = warmed["runs"][n]
    assert all(isinstance(x, tbp.Sharded) and len(x.parts) == n for x in (trk, st, outs))
    assert outs.axis == 1 and tuple(outs.parts[0].P.shape) == (N_SCAN, B // n, 3)
    got = outs.gather("cpu")
    dP = float((got.P - ref.P).abs().max())
    dc = float(((got.cost - ref.cost).abs() / ref.cost.abs()).max())
    print(f"run_sharded over {n} CPU entries against run: max |dP| {dP:.3e} m, "
          f"max cost rel {dc:.3e}")
    np.testing.assert_allclose(got.P.numpy(), ref.P.numpy(), atol=P_ATOL)
    np.testing.assert_allclose(got.cost.numpy(), ref.cost.numpy(), rtol=COST_RTOL)
    assert torch.equal(got.is_keyframe, ref.is_keyframe)
    assert np.isfinite(got.cost.numpy()).all()
    runner = warmed["runners"][n]
    _, _, more = runner.run_sharded(trk, st, runner.put_batch(warmed["batch"]))
    assert torch.isfinite(more.gather("cpu").cost).all()


def test_lane_draws_do_not_depend_on_the_split(warmed):
    """(c) Each lane's RANSAC uniforms from fresh runners over meshes of 1,
    2 and 4 entries are equal, and so are the lanes' generator states after
    the 4 frames of ``run`` and of ``run_sharded``."""
    args = warmed["args"]
    draws = {}
    for n in (1, 2, 4):
        r = tbp.BatchedVioRunner(*args, None, B, mesh=ttp.make_mesh(n, device="cpu"))
        draws[n] = torch.cat([s.ransac_uniforms() for s in r._shards])
    assert tuple(draws[1].shape[:1]) == (B,)
    for n in (2, 4):
        assert torch.equal(draws[n], draws[1])
    after_run = [g.get_state() for g in warmed["runners"][1].generators]
    for n in (2, 4):
        r = tbp.BatchedVioRunner(*args, None, B, mesh=ttp.make_mesh(n, device="cpu"))
        trk, st = warmed["state"]
        r.run_sharded(r.put_states(trk), r.put_states(st), r.put_batch(warmed["batch"]))
        assert all(torch.equal(a, b) for a, b in zip(
            [g.get_state() for g in r.generators], after_run))


def test_refusals(warmed):
    """(d) B not divisible by the mesh, inputs not split over the runner's
    mesh or a shard on the wrong device, and more cards than present are
    refused; an exception in one shard reaches the caller, noted with the
    shard, and no thread ran a shard."""
    args = warmed["args"]
    trk, st = warmed["state"]
    mesh4 = ttp.make_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        tbp.BatchedVioRunner(*args, None, 6, mesh=mesh4)
    with pytest.raises(ValueError, match="do not split"):
        ttp.batch_shard(ttp.make_mesh(3, device="cpu"), trk)
    r = warmed["runners"][2]
    placed = (r.put_states(trk), r.put_states(st), r.put_batch(warmed["batch"]))
    with pytest.raises(ValueError, match="put_states"):
        r.run_sharded(trk, st, placed[2])  # not split at all
    with pytest.raises(ValueError, match="put_states"):  # split over another mesh
        r.run_sharded(*placed[:2], tbp.ShardSpec(tuple(mesh4), 1).place(warmed["batch"]))
    wrong = tbp.Sharded(placed[1].mesh, [placed[1].parts[0], tbp.map_tree(
        lambda a: a.to("meta"), placed[1].parts[1])], 0)
    with pytest.raises(ValueError, match="lies on meta"):
        r.run_sharded(placed[0], wrong, placed[2])
    with pytest.raises((RuntimeError, ValueError)):
        ttp.make_mesh(torch.cuda.device_count() + 1)
    if torch.cuda.device_count() < 2:
        with pytest.raises((RuntimeError, ValueError)):
            ttp.make_mesh(2)
    # a batch wrongly shaped for shard 1 (IMU intervals one sample short)
    bad = tbp.Sharded(placed[2].mesh, [placed[2].parts[0], placed[2].parts[1]._replace(
        imu_dts=placed[2].parts[1].imu_dts[..., :-1].contiguous())], 1)
    before = set(threading.enumerate())
    with pytest.raises(Exception) as info:
        r.run_sharded(*placed[:2], bad)
    assert any("in shard 1 of 2" in note for note in getattr(info.value, "__notes__", []))
    # the shards ran on the caller's thread: no thread was started for them
    assert set(threading.enumerate()) <= before
    assert not any(t.name.startswith("shard-") for t in threading.enumerate())


def test_on_shards_runs_every_shard_in_turn_before_raising():
    """Shards that raise: every shard still runs, in shard order, on the
    caller's own thread; then the first one's exception reaches the
    caller, with a note naming the shard and its device."""
    ran, threads = [], set()

    def fn(i):
        threads.add(threading.get_ident())
        ran.append(i)
        if i in (1, 2):
            raise KeyError(f"shard {i}")
        return i

    with pytest.raises(KeyError) as info:
        tbp.on_shards([torch.device("cpu")] * 4, fn)
    assert ran == [0, 1, 2, 3] and threads == {threading.get_ident()}
    assert info.value.args == ("shard 1",)
    assert "in shard 1 of 4, on cpu" in info.value.__notes__
    assert tbp.on_shards([torch.device("cpu")] * 3, lambda i: i * i) == [0, 1, 4]


def test_dryrun_multichip_backend_on_four_cpu_entries(capsys):
    """(e) JAX's backend dry run's twin over a mesh of four CPU entries:
    its asserts hold (finite costs > 0, sequences diverge, the outputs on
    every entry of the mesh)."""
    tg.dryrun_multichip_backend(4, device="cpu")
    assert "OK on cpu, cpu, cpu, cpu" in capsys.readouterr().out


@pytest.mark.parametrize("cards", [1, 2])
def test_chip_smoke_sharded_phase_rehearses(cards):
    """(e) ``chip_smoke.py``'s phase 21 (b) on the CPU at B = 2 per shard,
    160×120 and 12 steady frames, over two shards of the CPU and a mesh
    of ``cards`` CPU entries: its gates hold (JAX's tolerances against
    ``run``, outputs on the mesh, every lane under its truth bound, finite
    costs)."""
    staged = chip_smoke.stage_sharded_path("cpu", 2 * cards, 12, W=160, H=120, max_cnt=32)
    res = chip_smoke.run_sharded_path(staged, "cpu", ["cpu"] * cards, per_card=2)
    chip_smoke.check_sharded_path(res, on_gpu=False)
    assert res["compare"]["C"]["shards"] == 2 and res["compare"]["D"]["shards"] == cards
    assert res["compare"]["D"]["B"] == 2 * cards
