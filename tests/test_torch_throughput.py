"""``vins_rgbd_fast_torch/parallel/throughput.py`` and the runner's sharded
and chained API against the JAX package on the CPU at small sizes:
``tests/test_parallel.py``'s two cases and ``tests/test_sharded_runner.py``'s
(``tests/test_torch_sharded.py`` holds the meshes of several entries to
JAX's sharded step and ``run_sharded`` to ``run``).

Tolerances: the batched step within 1e-5 of JAX's ``vmap(vio_step)`` from
the same (bridged) states, float64, four frames (IMU on: JAX's step does
not read its keys, the port's takes no draws); the port's batched step
against its own single-sequence step within 1e-10; ``run_chained``
bit-equal to ``run``, and ``run_sharded`` over two shards of the CPU
within JAX's tolerances of ``run`` (P 5e-4 m, cost rtol 5e-3, keyframes
equal); ``stack_states`` equal to JAX's on the same pipeline states, leaf
by leaf."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jg
import __graft_entry_torch__ as tg
import chip_smoke
from vins_rgbd_fast_torch import bridge
from vins_rgbd_fast_torch.backend import estimator as tes
from vins_rgbd_fast_torch.parallel import batched_pipeline as tbp
from vins_rgbd_fast_torch.parallel import throughput as ttp
from vins_rgbd_fast_tpu.backend import estimator as jest
from vins_rgbd_fast_tpu.parallel import batched_pipeline as jbp

B = 4


def _drifted(pts, k, xp):
    """Frame k's observations: every sequence's own offset, drifting."""
    return pts + (xp.arange(B)[:, None, None] * 2e-3 + 0.004 * k)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_batched_step_runs_on_a_one_device_mesh(n):
    """The batched step over a mesh of n CPU entries (a mesh of more than
    one device was refused before the step ran sharded): 8 lanes split in
    lane order, states and outputs on every entry."""
    mesh = ttp.make_mesh(n, device="cpu")
    assert mesh == [torch.device("cpu")] * n
    cfg = tg._example_cfg(maxf=16, maxi=8)
    states, feats, imus = tg._example_inputs(cfg, dtype=torch.float64, batch=8, device="cpu")
    feats = feats._replace(pts=feats.pts + torch.arange(8)[:, None, None] * 1e-3)
    states, feats, imus = (ttp.batch_shard(mesh, t) for t in (states, feats, imus))
    new_states, outs = ttp.make_batched_step(cfg, mesh)(states, feats, imus)
    assert len(outs.parts) == n and len(new_states.parts) == n
    outs = outs.gather("cpu")
    assert tuple(outs.P.shape) == (8, 3) and bool(torch.isfinite(outs.cost).all())
    assert new_states.devices() == {torch.device("cpu")}
    one = ttp.replicate_state(tg._example_inputs(cfg, torch.float64, device="cpu")[0], 3)
    assert tuple(one.x.P.shape) == (3, 11, 3)


def test_batched_step_matches_jax_vmap_and_the_single_step():
    jcfg, tcfg = jg._example_cfg(maxf=16, maxi=8), tg._example_cfg(maxf=16, maxi=8)
    js, jf, ji, jk = jg._example_inputs(jcfg, dtype=jnp.float64, batch=B)
    ts, tf, ti = tg._example_inputs(tcfg, dtype=torch.float64, batch=B, device="cpu")
    jstep = jax.jit(jax.vmap(lambda s, f, i, k: jest.vio_step(jcfg, s, f, i, k)))
    tstep = ttp.make_batched_step(tcfg, ttp.make_mesh(device="cpu"))
    for k in range(4):
        js, jout = jstep(js, jf._replace(pts=_drifted(jf.pts, k, jnp)), ji, jk)
        t_in = ts
        ts, tout = tstep(ts, tf._replace(pts=_drifted(tf.pts, k, torch)), ti)
        ts, tout = ts.gather("cpu"), tout.gather("cpu")
        for f in ("P", "Q", "V"):
            np.testing.assert_allclose(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)),
                                       atol=1e-5, err_msg=f"{f} at frame {k}")
        np.testing.assert_allclose(tout.cost.numpy(), np.asarray(jout.cost), atol=1e-5,
                                   rtol=1e-5)
    # sequence 2 alone through the port's own step, from the same state
    one = tbp.map_tree(lambda a: a[2:3], t_in)
    f2 = tf._replace(pts=_drifted(tf.pts, 3, torch))
    _, out2 = tes.vio_step(tcfg, one, tbp.map_tree(lambda a: a[2:3], f2),
                           tbp.map_tree(lambda a: a[2:3], ti))
    np.testing.assert_allclose(out2.P[0].numpy(), tout.P[2].numpy(), atol=1e-10)
    np.testing.assert_allclose(out2.cost[0].numpy(), tout.cost[2].numpy(), atol=1e-10)


def test_run_sharded_and_run_chained_are_run_bit_for_bit():
    res = chip_smoke.run_runner_api("cpu", B=2, T=2, W=160, H=120, max_cnt=32)
    assert res["chained_equal"] and res["sharded_equal"]
    assert res["misplaced_refused"] and res["cost_finite"]


def test_stack_states_matches_jax_on_bridged_pipelines():
    """Two pipelines warmed by static initialization (the runner then takes
    one batched frame of each); JAX's ``stack_states`` of the same B = 1
    states, bridged, equals the port's leaf by leaf."""
    res = chip_smoke.run_stack_states("cpu", W=160, H=120, max_cnt=32)
    assert all(res["initialized"]) and res["lanes_equal"]
    assert max(res["next_frame_err_m"]) < 0.08
    pipes = res["pipes"]
    trk, st = tbp.stack_states(pipes)
    jpipes = [types.SimpleNamespace(
        tracker_state=bridge.to_numpy(tbp.map_tree(lambda a: a[0], p.tracker_state)),
        estimator=types.SimpleNamespace(state=bridge.to_numpy(
            tbp.map_tree(lambda a: a[0], p.estimator.state)))) for p in pipes]
    jtrk, jst = jbp.stack_states(jpipes)
    for port, ref in ((trk, jtrk), (st, jst)):
        for a, b in zip(tbp.leaves(port), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("tds", [(0.0, 0.0), (0.004, -0.012)], ids=["td0", "td-per-lane"])
def test_stage_frames_arrays_pairs_each_lane_imu(tds):
    """``stage_frames_arrays`` against ``stage_frames`` on the same frames
    and the same IMU streams: equal batches.  With a host td per lane
    (``estimator._td_cache``) lane b pairs (t[k-1] + td_b, t[k] + td_b],
    which ``stage_frames`` pairs from the lane's stream shifted by -td_b;
    the durations, differences of shifted stamps, within 1e-12 s
    (float64)."""
    rig, tcfg, ecfg, cam = chip_smoke.slice_config(160, 120, 32)
    seqs, rendered, _ = chip_smoke.make_sequences(rig, 2, 14, "cpu")

    def buffers(shift):  # pairing consumes samples: one set per staging
        bufs = [tes.ImuIntervalBuffer(32) for _ in seqs]
        for buf, s, td in zip(bufs, seqs, tds):
            for (t, a, g) in s.imu:
                buf.push(t - shift * td, a, g)
        return bufs

    pipes = [types.SimpleNamespace(estimator=types.SimpleNamespace(
        cfg=ecfg, _collect_interval_np=buf.collect, _td_cache=td))
        for buf, td in zip(buffers(0), tds)]
    ts, imgs, deps = ([r[i] for r in rendered] for i in range(3))
    dtype = torch.float64 if any(tds) else torch.float32
    a = tbp.stage_frames_arrays(pipes, ts, imgs, deps, 3, 9, dtype=dtype)
    b = tbp.stage_frames(imgs, deps, ts, buffers(1), 3, 9, "cpu", dtype=dtype)
    for x, y in zip(a, b):
        if any(tds):
            torch.testing.assert_close(x, y, rtol=0, atol=1e-12)
        else:
            assert torch.equal(x, y)
    if any(tds):
        assert not torch.equal(a.imu_dts[:, 0], tbp.stage_frames(
            imgs, deps, ts, buffers(0), 3, 9, "cpu", dtype=dtype).imu_dts[:, 0])
