"""Entry points of the PyTorch/CUDA port (twins of
``__graft_entry__.py``'s): one backend step to compile and run, and the
multi-device dry runs, one lane per device of a mesh.  They run on CUDA
unless the caller passes ``device="cpu"``: on CUDA the mesh is the first n
cards (``make_mesh(n)``, which raises when fewer are present), on the CPU n
entries of the CPU, the twin of JAX's virtual host devices.  A caller may
pass the mesh itself, for example one card listed n times."""

import numpy as np
import torch


def _example_cfg(maxf=48, maxi=16):
    from vins_rgbd_fast_torch.config import EstimatorConfig

    return EstimatorConfig(maxf=maxf, max_imu=maxi, use_imu=True, static_init=True,
                           acc_n=0.1, gyr_n=0.01, acc_w=1e-4, gyr_w=1e-5)


def _example_inputs(cfg, dtype=torch.float32, batch=None, seed=0, device="cuda"):
    """JAX's stationary example (features on a wall at 3 m, an IMU at rest
    measuring +g) as the port's (state, feats, imu), batch ``batch`` (1
    when None)."""
    from vins_rgbd_fast_torch.backend import estimator as est
    from vins_rgbd_fast_torch.backend.feature_table import FrameFeatures

    B = 1 if batch is None else batch
    rng = np.random.default_rng(seed)
    state = est.init_estimator_state(cfg, np.eye(3), np.zeros(3), 0.0, B, device, dtype)
    n = cfg.max_imu
    dts = np.full((n,), 0.005, np.float32)
    acc = np.tile([0.0, 0.0, 9.805], (n + 1, 1)).astype(np.float32)
    gyr = np.zeros((n + 1, 3), np.float32)

    def put(a, dt=dtype):
        t = torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        return t.expand((B,) + t.shape).contiguous()

    state = state._replace(imu_dts=put(np.tile(dts[None], (11, 1))),
                           imu_acc=put(np.tile(acc[None], (11, 1, 1))),
                           imu_gyr=put(np.tile(gyr[None], (11, 1, 1))))
    k = cfg.maxf // 2
    ids = np.full(cfg.maxf, -1, np.int32)
    ids[:k] = np.arange(k)
    pts = np.zeros((cfg.maxf, 2), np.float32)
    pts[:k] = rng.uniform(-0.4, 0.4, (k, 2))
    feats = FrameFeatures(
        ids=put(ids, torch.int32), pts=put(pts),
        uv=put(pts * 460.0 + np.asarray([320.0, 240.0], np.float32)),
        vel=put(np.zeros((cfg.maxf, 2))), depth=put(np.where(ids >= 0, 3.0, 0.0)))
    imu = est.ImuInterval(dts=put(dts), acc=put(acc), gyr=put(gyr))
    return state, feats, imu


def entry(device="cuda"):
    """(fn, example_args): one full sliding-window VIO backend step of the
    port (ingest → propagate → triangulate → 8-iteration LM with the
    marginalization prior → slide) at ``_example_cfg()``'s sizes."""
    from vins_rgbd_fast_torch.backend import estimator as est

    cfg = _example_cfg()
    args = _example_inputs(cfg, device=device)

    def fn(state, feats, imu):
        _, out = est.vio_step(cfg, state, feats, imu)
        return out.P, out.Q, out.cost

    return fn, args


def _dryrun_mesh(n_devices: int, device, mesh):
    """The dry runs' mesh: ``mesh`` as given (n entries), else
    ``make_mesh(n_devices, device)``."""
    from vins_rgbd_fast_torch.parallel import throughput as tp

    mesh = list(mesh) if mesh is not None else tp.make_mesh(n_devices, device=device)
    if len(mesh) != n_devices:
        raise ValueError(f"a dry run over {n_devices} devices, given a mesh of {len(mesh)}")
    return mesh


def _check_on_mesh(outs, mesh) -> None:
    """The outputs live on every device of the mesh: shard i's on
    ``mesh[i]`` (JAX's test: the output's sharding spans the n devices)."""
    from vins_rgbd_fast_torch.parallel import batched_pipeline as bp

    assert len(outs.parts) == len(mesh), (len(outs.parts), mesh)
    for d, part in zip(bp.mesh_of(mesh), outs.parts):
        assert {a.device for a in bp.leaves(part)} == {d}, (d, part)


def dryrun_multichip(n_devices: int, device="cuda", mesh=None) -> None:
    """The full fused ``BatchedVioRunner`` (gyro prediction → LK tracker →
    depth → sliding-window LM) at production shapes, 640×480 frames, the
    bench's feature capacity and 32-sample IMU intervals, one lane on each
    of the ``n_devices`` devices of the mesh, through ``run_sharded``.
    All lanes share a warm prefix (ONE latency pipeline is warmed to
    NON_LINEAR on the mesh's first device and its state stacked into every
    lane, ``stack_states``, then placed by ``put_states``); then each lane's
    trajectory diverges (``make_trajectory(diverge_seed=lane)``), rendered
    on its lane's device and staged there with ``stage_frames_arrays``.
    Asserts that the outputs live on every device of the mesh, that every
    lane tracks its own ground truth, that the lanes diverge, and that the
    costs are finite and > 0."""
    from vins_rgbd_fast_torch.config import VinsConfig
    from vins_rgbd_fast_torch.io import synthetic as syn
    from vins_rgbd_fast_torch.io.stream import ate_rmse
    from vins_rgbd_fast_torch.parallel import batched_pipeline as bp
    from vins_rgbd_fast_torch.pipeline import VinsPipeline

    mesh = _dryrun_mesh(n_devices, device, mesh)
    Wd, Hd = 640, 480
    n_warm, n_scan = 14, 12
    n_frames = n_warm + n_scan
    rig = syn.SyntheticRig(width=Wd, height=Hd, fx=460.0 * Wd / 640, fy=460.0 * Wd / 640,
                           cx=Wd / 2.0, cy=Hd / 2.0, imu_rate=200.0, frame_rate=20.0)
    B = n_devices
    seqs = [syn.make_trajectory(n_frames, rig, seed=21, omega_scale=0.15, acc_scale=0.3,
                                diverge_seed=b, diverge_after=n_warm - 1) for b in range(B)]
    cfg = VinsConfig(
        imu=True, static_init=True, image_width=Wd, image_height=Hd,
        intrinsics=(rig.fx, rig.fy, rig.cx, rig.cy), distortion=(0, 0, 0, 0),
        ric=tuple(seqs[0].ric.ravel().tolist()), tic=tuple(seqs[0].tic.tolist()),
        max_cnt=130, min_dist=30, num_grid_rows=7, num_grid_cols=8,
        frontend_freq=0.0, freq=0.0, fix_depth=True, depth_max_dist=12.0,
        acc_n=0.1, gyr_n=0.01, acc_w=1e-4, gyr_w=1e-5, max_imu_per_frame=32)
    rendered = [syn.render_sequence(s, rig, mesh[b]) for b, s in enumerate(seqs)]

    # warm ONE pipeline on the shared prefix; the lanes share its state
    t_cut = float(seqs[0].times[n_warm - 1]) + 1e-9
    pipe = VinsPipeline(cfg, mesh[0], eager_outputs=False, failure_check_interval=10 ** 9)
    for (t, a, w) in seqs[0].imu:
        if t <= t_cut:
            pipe.push_imu(t, a, w)
    ts0, imgs0, deps0 = rendered[0]
    for k in range(n_warm):
        pipe.push_image(float(ts0[k]), imgs0[k])
        pipe.push_depth(float(ts0[k]), deps0[k])
        pipe.spin_once()
    pipe.close()
    assert pipe.estimator.solver_flag == pipe.estimator.NON_LINEAR, \
        "warmup did not reach steady state"
    trk, st = bp.stack_states([pipe] * B)

    # per-lane IMU pairing (each lane's own stream); each lane's frames staged
    # on its own device, one shard per lane
    lane_pipes = []
    for b in range(B):
        p = VinsPipeline(cfg, mesh[b], eager_outputs=False, failure_check_interval=10 ** 9)
        for (t, a, w) in seqs[b].imu:
            p.push_imu(t, a, w)
        lane_pipes.append(p)
    runner = bp.BatchedVioRunner(pipe.tcfg, pipe.cam, pipe.estimator.cfg, None, B, mesh=mesh)
    batch = bp.Sharded(mesh, [bp.stage_frames_arrays(
        lane_pipes[b:b + 1], [rendered[b][0]], [rendered[b][1]], [rendered[b][2]], n_warm,
        n_frames) for b in range(B)], axis=1)
    trk, st, outs = runner.run_sharded(runner.put_states(trk), runner.put_states(st), batch)
    for p in lane_pipes:
        p.close()
    _check_on_mesh(outs, mesh)

    outs = outs.gather("cpu")
    cost = outs.cost.numpy()
    P_all = outs.P.numpy()
    assert np.isfinite(cost).all() and (cost > 0).all(), f"costs={cost}"
    finals = []
    for b in range(B):
        ts = [float(rendered[b][0][k]) for k in range(n_warm, n_frames)]
        P = P_all[:, b]
        assert np.isfinite(P).all()
        ate = ate_rmse(ts, P, seqs[b].times, seqs[b].P, align=False)
        travelled = np.sum(np.linalg.norm(np.diff(seqs[b].P, axis=0), axis=1))
        assert np.isfinite(ate) and ate < max(0.05 * travelled, 0.10), (b, ate, travelled)
        finals.append(P[-1])
    spread = np.std(np.stack(finals), axis=0).max()
    assert spread > 1e-4, f"lanes did not diverge (spread={spread})"
    print(f"dryrun_multichip({n_devices}): OK on {', '.join(map(str, mesh))} — {B} lanes of the "
          f"fused pipeline {Wd}x{Hd}, one per shard, maxf={pipe.estimator.cfg.maxf}, "
          f"maxi={pipe.estimator.cfg.max_imu}, T={n_scan}, lane spread={spread:.3f} m, "
          f"costs finite>0")


def dryrun_multichip_backend(n_devices: int, device="cuda", mesh=None) -> None:
    """The backend-only batched step (``parallel/throughput.py``) over four
    frames, one sequence on each of the ``n_devices`` devices of the mesh,
    with distinct gyro rates.  Asserts that the outputs live on every
    device of the mesh, finite costs > 0 and that the sequences diverge."""
    from vins_rgbd_fast_torch.parallel import throughput as tp

    mesh = _dryrun_mesh(n_devices, device, mesh)
    dev = mesh[0]
    cfg = _example_cfg(maxf=16, maxi=8)
    states, feats0, imus = _example_inputs(cfg, batch=n_devices, device=dev)
    rng = np.random.default_rng(7)
    # per-sequence distinct gyro rates -> genuinely different trajectories
    rates = torch.as_tensor(rng.uniform(-0.2, 0.2, (n_devices, 1, 3)), dtype=torch.float32,
                            device=dev)
    imus = imus._replace(gyr=imus.gyr + rates)
    states, imus = tp.batch_shard(mesh, states), tp.batch_shard(mesh, imus)
    step = tp.make_batched_step(cfg, mesh)
    centre = torch.as_tensor([320.0, 240.0], dtype=torch.float32, device=dev)
    outs = None
    for k in range(4):  # a track must age past start < WINDOW_SIZE-2 before its
        # projection factors activate; observations drift, per-sequence noise
        shift = torch.as_tensor(rng.uniform(-0.01, 0.01, (n_devices, 1, 2)) + 0.005 * k,
                                dtype=torch.float32, device=dev)
        noise = torch.as_tensor(rng.normal(0, 2e-3, tuple(feats0.pts.shape)),
                                dtype=torch.float32, device=dev)
        pts = feats0.pts + shift + noise
        feats = tp.batch_shard(mesh, feats0._replace(pts=pts, uv=pts * 460.0 + centre))
        states, outs = step(states, feats, imus)
    _check_on_mesh(outs, mesh)
    outs = outs.gather("cpu")
    P = outs.P.numpy()
    cost = outs.cost.numpy()
    assert P.shape == (n_devices, 3)
    assert np.isfinite(cost).all() and np.isfinite(P).all()
    assert (cost > 0).all(), f"degenerate dryrun: costs={cost}"
    assert np.std(P, axis=0).max() > 1e-6, "sequences did not diverge"
    print(f"dryrun_multichip_backend({n_devices}): OK on {', '.join(map(str, mesh))}, "
          f"costs={cost}")
