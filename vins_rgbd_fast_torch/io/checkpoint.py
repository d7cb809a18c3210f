"""Whole-pipeline checkpoint and resume (the port's twin of
``vins_rgbd_fast_tpu/io/checkpoint.py``): ``save_pipeline`` writes one
``.npz``, ``load_pipeline`` rebuilds a ``VinsPipeline`` from it.

The format is the port's own.  Its device state is the pipeline's tracker
state and estimator state, the port's NamedTuples at B = 1, stored leaf by
leaf and checked against a fresh pipeline's leaf shapes on load (a config
that does not match the checkpoint raises ``ValueError``).  Beside the host
state JAX's checkpoint keeps (the IMU buffers, the window's host scalars,
the frame counter, whether the extrinsic is still being calibrated), it
keeps what the port's pipeline holds beyond JAX's: the states of the
RANSAC generator, the VO PnP generator, the initialization generator and
the pose graph's generator, the fused-step counter, the stream pairer's
rate-gate state, the keyframe gate, the relocalization constraint in
flight, and the extrinsic calibration's rotation pairs and previous frame.  So a
resumed run draws what the uninterrupted one drew and, where the frames are
the same, computes the same trajectory.

The pose graph, when there is one, goes beside the checkpoint as
``<path>.pg.npz`` through ``PoseGraph.save`` (the map format both packages
read); the graph's own sequence bookkeeping (each keyframe's sequence and
landmarks, the live sequence and its alignment) is kept in the checkpoint
and put back after ``PoseGraph.load``, which would otherwise make the
saved keyframes a fixed base map.  ``save_pipeline`` drains the pose
graph's worker first; checkpoint after a ``spin_once`` that consumed a
frame, with no image queued in the pairer.
"""

from __future__ import annotations

import json
import os
from typing import Any, List

import numpy as np
import torch

FORMAT_VERSION = 1


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _rebuild(template, it):
    if hasattr(template, "_fields"):
        return type(template)(*[_rebuild(v, it) for v in template])
    if isinstance(template, tuple):
        return tuple(_rebuild(v, it) for v in template)
    return next(it)


def _pack_tree(prefix: str, tree) -> dict:
    return {f"{prefix}{i}": a.detach().cpu().numpy() for i, a in enumerate(_leaves(tree))}


def _unpack_tree(z, prefix: str, template):
    new = []
    for i, old in enumerate(_leaves(template)):
        a = z[f"{prefix}{i}"]
        if tuple(a.shape) != tuple(old.shape):
            raise ValueError(f"checkpoint leaf {prefix}{i}: shape {a.shape} != "
                             f"{tuple(old.shape)}: config mismatch with the checkpoint")
        new.append(torch.as_tensor(a, dtype=old.dtype).to(old.device))
    return _rebuild(template, iter(new))


def _gen_state(g: torch.Generator) -> np.ndarray:
    return g.get_state().numpy()


def _set_gen_state(g: torch.Generator, a) -> None:
    g.set_state(torch.as_tensor(np.asarray(a, np.uint8)))


def _gate(pipe):
    if pipe._loop_stager is not None:
        return pipe._loop_stager.gate
    return getattr(pipe, "_kf_gate", None)


def save_pipeline(pipe, path: str) -> None:
    """Serialize a ``vins_rgbd_fast_torch.pipeline.VinsPipeline`` to
    ``path`` (npz); its pose graph, if any, to ``<path>.pg.npz``."""
    pipe.drain()
    e = pipe.estimator
    arrs = _pack_tree("trk_", pipe.tracker_state)
    arrs.update(_pack_tree("est_", e.state))
    arrs["imu_buf"] = np.asarray([[t, *a, *g] for (t, a, g) in e._imu._buf],
                                 np.float64).reshape(-1, 7)
    arrs["imu_pred"] = np.asarray([[t, *g] for (t, g) in pipe._imu_for_predict],
                                  np.float64).reshape(-1, 4)
    arrs["bg_cache"] = np.asarray(pipe._bg_cache, np.float64)
    arrs["gen_ransac"] = _gen_state(pipe._generator)
    arrs["gen_pnp"] = _gen_state(e.pnp_generator)
    arrs["gen_init"] = _gen_state(e.init_generator)
    arrs["ex_pairs"] = np.asarray([np.concatenate(p) for p in e._ex_pairs],
                                  np.float64).reshape(-1, 8)
    if e._prev_feats_host is not None:
        arrs["ex_prev_ids"], arrs["ex_prev_pts"] = e._prev_feats_host
    relo = e._pending_relo
    if relo is not None:
        arrs.update({f"relo_{k}": np.asarray(v) for k, v in relo.items() if k != "epoch"})
    pr = pipe.pairer
    gate = _gate(pipe)
    meta: dict[str, Any] = dict(
        version=FORMAT_VERSION, frame_count=int(e.frame_count), solver_flag=int(e.solver_flag),
        headers=[float(h) for h in e.headers], step=int(e._step), td_cache=float(e._td_cache),
        prev_time=None if e.prev_time is None else float(e.prev_time),
        ex_calibrating=bool(e._ex_calibrating),
        frame_idx=int(pipe._frame_idx), fused_step=int(pipe._fused_step),
        last_frame_time=(None if pipe._last_frame_time is None
                         else float(pipe._last_frame_time)),
        pending_relo=relo is not None,
        pairer=[pr.last_image_time, pr.first_image_time, pr.last_pub_time, pr.pub_count],
        gate=None if gate is None else [gate._count, None if gate._anchor is None
                                        else [float(v) for v in gate._anchor]])
    g = pipe.pose_graph
    if g is not None:
        arrs["gen_graph"] = _gen_state(g._gen)
        arrs["pg_sequence"] = np.asarray([k.sequence for k in g.keyframes], np.int64)
        arrs["pg_wp_world"] = (np.stack([np.asarray(k.wp_world) for k in g.keyframes])
                               if g.keyframes else np.zeros((0, g.cfg.max_wp, 3)))
        arrs["pg_w_r_vio"], arrs["pg_w_t_vio"] = g.w_r_vio, g.w_t_vio
        meta["graph"] = dict(sequence=g.sequence, n_solves_6dof=g.n_solves_6dof,
                             relo_sent_kf=(pipe._loop_stager._relo_sent_kf
                                           if pipe._loop_stager is not None
                                           else pipe._relo_sent_kf),
                             sequence_aligned=[[int(k), bool(v)]
                                               for k, v in g.sequence_aligned.items()])
    np.savez(path, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrs)
    if g is not None:
        g.save(path + ".pg.npz")


def load_pipeline(vcfg, path: str, device, dtype=torch.float32, **pipeline_kwargs):
    """Rebuild a pipeline from ``save_pipeline``'s output on ``device``.
    ``vcfg`` must describe the rig and shapes the checkpoint was taken with
    (leaf shapes are checked)."""
    from ..pipeline import VinsPipeline

    pipe = VinsPipeline(vcfg, device, dtype=dtype, **pipeline_kwargs)
    e = pipe.estimator
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("version") != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version: {meta.get('version')}")
        pipe.tracker_state = _unpack_tree(z, "trk_", pipe.tracker_state)
        e.state = _unpack_tree(z, "est_", e.state)
        e._imu._buf = [(float(r[0]), r[1:4].copy(), r[4:7].copy())
                       for r in np.asarray(z["imu_buf"], np.float64)]
        pipe._imu_for_predict = [(float(r[0]), r[1:4].copy())
                                 for r in np.asarray(z["imu_pred"], np.float64)]
        pipe._bg_cache = np.asarray(z["bg_cache"], np.float64)
        _set_gen_state(pipe._generator, z["gen_ransac"])
        _set_gen_state(e.pnp_generator, z["gen_pnp"])
        _set_gen_state(e.init_generator, z["gen_init"])
        e._ex_pairs = [(r[:4].copy(), r[4:].copy()) for r in np.asarray(z["ex_pairs"])]
        e._prev_feats_host = ((np.asarray(z["ex_prev_ids"]), np.asarray(z["ex_prev_pts"]))
                              if "ex_prev_ids" in z.files else None)
        if meta["pending_relo"]:
            e._pending_relo = {k: np.asarray(z[f"relo_{k}"])
                               for k in ("match_pts", "match_valid", "match_ids", "P", "Q")}
            e._pending_relo["epoch"] = e.epoch
        graph = {k: np.asarray(z[k]) for k in z.files if k.startswith(("pg_", "gen_graph"))}
    e.frame_count = int(meta["frame_count"])
    e.solver_flag = int(meta["solver_flag"])
    e.headers = [float(h) for h in meta["headers"]]
    e._step = int(meta["step"])
    e._td_cache = float(meta["td_cache"])
    e.prev_time = meta["prev_time"]
    e._ex_calibrating = bool(meta["ex_calibrating"])
    pipe._frame_idx = int(meta["frame_idx"])
    pipe._fused_step = int(meta["fused_step"])
    pipe._last_frame_time = meta["last_frame_time"]
    pr = pipe.pairer
    pr.last_image_time, pr.first_image_time, pr.last_pub_time, pr.pub_count = meta["pairer"]
    gate = _gate(pipe)
    if gate is not None and meta["gate"] is not None:
        gate._count = int(meta["gate"][0])
        gate._anchor = None if meta["gate"][1] is None else np.asarray(meta["gate"][1])
    g = pipe.pose_graph
    pg_path = path + ".pg.npz"
    if g is not None and "graph" in meta and os.path.exists(pg_path):
        g.load(pg_path)
        m = meta["graph"]
        _set_gen_state(g._gen, graph["gen_graph"])
        g.keyframes = [kf._replace(sequence=int(s), wp_world=w) for kf, s, w in
                       zip(g.keyframes, graph["pg_sequence"], graph["pg_wp_world"])]
        g.w_r_vio, g.w_t_vio = graph["pg_w_r_vio"], graph["pg_w_t_vio"]
        g.sequence = int(m["sequence"])
        g.n_solves_6dof = int(m["n_solves_6dof"])
        g.sequence_aligned = {int(k): bool(v) for k, v in m["sequence_aligned"]}
        if pipe._loop_stager is not None:
            pipe._loop_stager._relo_sent_kf = m["relo_sent_kf"]
        else:
            pipe._relo_sent_kf = m["relo_sent_kf"]
    return pipe
