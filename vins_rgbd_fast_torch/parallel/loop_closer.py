"""The latency pipeline's pose graph on a worker thread (twin of
``_pack_latency_gating`` and ``AsyncLoopStager`` in
``vins_rgbd_fast_tpu/parallel/loop_closer.py``).

The frame thread only packs a 23-float gating row per frame on its own
stream (is_keyframe, pose, the relocalization round trip) and, every
``FETCH_EVERY`` frames, stacks the rows, records an event after them and
queues the batch.  The worker thread runs on a stream of its own that
waits on that event, so it reads those frames' outputs and images and
nothing queued after them; it reads the rows back (one wait, on the
worker), gates keyframes, extracts their features (kernel K1 again on the
card), queries the retrieval DB, verifies a candidate, optimizes the pose
graph, and hands a relocalization constraint back to the estimator as host
arrays (``VinsEstimator.set_relo_frame``); the frame thread uploads it with
its next frame's packed inputs.  Tensors that cross to the worker's stream
are marked with ``record_stream``.  An exception on the worker is raised by
the next ``drain``.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..loop.pose_graph import (KeyframeGate, PoseGraph, _host, combine_db_rows,
                               db_query_multi, extract_kf_device, relo_relative_pose)

STAGES = ("gating", "extract", "query", "verify", "pgo")
# frames per gating read-back; under the window's 10 frames, because the
# relocalization constraint a loop sends back binds window features by id,
# and they leave the window after 10
FETCH_EVERY = 8


def pack_latency_gating(sout) -> torch.Tensor:
    """(23,) gating row of a B = 1 ``StepOutput`` (one device concat):
    is_keyframe, P (3), Q (4), relo_used, relo_P (3), relo_Q (4),
    relo_cur_P (3), relo_cur_Q (4)."""
    dt = sout.P.dtype
    return torch.cat([sout.is_keyframe.to(dt)[:, None], sout.P, sout.Q,
                      sout.relo_used.to(dt)[:, None], sout.relo_P, sout.relo_Q,
                      sout.relo_cur_P, sout.relo_cur_Q], dim=1)[0]


class AsyncLoopStager:
    """Pose graph for the latency pipeline with no host wait on the frame
    thread: keyframes reach the graph at most ``FETCH_EVERY`` frames (plus
    the worker's backlog) after they were made."""

    def __init__(self, pose_graph: PoseGraph, estimator=None, skip_cnt: int = 0,
                 skip_dis: float = 0.0, fast_relocalization: bool = False):
        self.g = pose_graph
        self.est = estimator
        self.cfg = pose_graph.cfg
        self.device = pose_graph.device
        self.gate = KeyframeGate(skip_cnt, skip_dis)
        self.fast_relo = fast_relocalization
        self._stream = (torch.cuda.Stream(device=self.device) if self.device.type == "cuda"
                        else None)
        self._relo_sent_kf: Optional[int] = None
        self.n_keyframes = 0
        self.n_loops = 0
        self.stage_s = dict.fromkeys(STAGES, 0.0)  # the worker's wall seconds by stage
        self._buf: list = []  # (packed row, t, StepOutput, img, depth)
        self._q: "queue.Queue" = queue.Queue()
        self._exc: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True, name="loop-stager")
        self._worker.start()

    # -- frame thread ----------------------------------------------------
    def on_frame(self, sout, img: torch.Tensor, t: float, depth: Optional[torch.Tensor] = None):
        """Record a steady frame: ``sout`` its (B = 1) ``StepOutput``,
        ``img``/``depth`` (H, W) device images.  Launches only."""
        self._buf.append((pack_latency_gating(sout), float(t), sout, img, depth))
        if len(self._buf) >= FETCH_EVERY:
            self._flush_buf()

    def _flush_buf(self):
        if not self._buf:
            return
        toks, self._buf = self._buf, []
        stacked = torch.stack([tk[0] for tk in toks])
        ready = None
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record()  # on the frame thread's stream, after these frames
        self._q.put((stacked, toks, ready))

    def drain(self):
        """Hand over the buffered frames and wait until the worker is idle;
        raises the worker's exception if one occurred."""
        self._flush_buf()
        self._q.join()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def compile_warmup(self, img: torch.Tensor):
        """Run extraction, the DB query, a loop check and the PGO once on a
        clone of the graph, on the worker thread and its stream, so their
        one-time costs (cuBLAS/cuSOLVER handles and workspaces of a new
        thread and stream, the allocator's first blocks) fall outside any
        timed frame.  ``img``: a sample frame (H, W) on the device."""
        self._q.put(lambda: self._warmup(img))
        self.drain()

    def close(self):
        """Drain, then stop the worker thread."""
        try:
            self.drain()
        finally:
            self._q.put(None)
            self._worker.join(timeout=60)

    # -- worker thread ---------------------------------------------------
    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                with self._on_stream():
                    if callable(item):
                        item()
                    else:
                        self._process(*item)
            except BaseException as e:  # noqa: BLE001 — raised by drain()
                self._exc = e
            finally:
                self._q.task_done()

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _adopt(self, *tensors):
        """Mark frame-stream tensors as used by the worker's stream."""
        if self._stream is not None:
            for x in tensors:
                if isinstance(x, torch.Tensor):
                    x.record_stream(self._stream)

    def _process(self, stacked, toks, ready):
        t0 = time.perf_counter()
        if ready is not None:
            self._stream.wait_event(ready)
        self._adopt(stacked)
        for (_, _, sout, img, depth) in toks:
            self._adopt(img, depth, sout.wp_uv, sout.wp_valid, sout.wp_world, sout.wp_norm,
                        sout.wp_ids)
        rows = _host(stacked).astype(np.float64)  # the one read-back of the batch
        self.stage_s["gating"] += time.perf_counter() - t0
        for row, (_, t, sout, img, depth) in zip(rows, toks):
            if row[8] > 0.5 and self._relo_sent_kf is not None:
                self._consume_relo(row)
            if not self.gate.admit(bool(row[0] > 0.5), row[1:4]):
                continue
            self._handle_keyframe(t, row[1:4], row[4:8], sout, img, depth)

    def _handle_keyframe(self, t, P, Q, sout, img, depth):
        """Extraction, retrieval, insertion and the DB append; on a
        candidate the loop check, the PGO and the relocalization hand-off."""
        g, cfg = self.g, self.cfg
        t0 = time.perf_counter()
        ext = extract_kf_device(cfg, g.cam, img[None], sout.wp_uv, sout.wp_valid,
                                None if depth is None else depth[None])
        f32 = torch.float32
        mk, mw = cfg.max_kp, sout.wp_valid.shape[1]
        flat = _host(torch.cat([ext[0][0].reshape(-1), ext[1][0].reshape(-1),
                                ext[2][0].to(f32), sout.wp_world[0].reshape(-1),
                                sout.wp_norm[0].reshape(-1), sout.wp_valid[0].to(f32)]))
        o = np.cumsum([0, 2 * mk, 3 * mk, mk, 3 * mw, 2 * mw, mw])
        kp_uv, kp_norm = flat[o[0]:o[1]].reshape(mk, 2), flat[o[1]:o[2]].reshape(mk, 3)
        kp_valid = flat[o[2]:o[3]] > 0.5
        wp_world = flat[o[3]:o[4]].reshape(mw, 3).astype(np.float64)
        wp_norm, wp_valid = flat[o[4]:o[5]].reshape(mw, 2), flat[o[5]:o[6]] > 0.5
        t1 = time.perf_counter()
        scores = None
        if g._dev_db is not None and g._db_size > 0:
            scores = _host(db_query_multi(g._dev_db, g._dev_valid, ext[3], ext[2],
                                          float(cfg.score_dist)))[0]
        kf, cand = g.insert_keyframe(t, P, Q, wp_world, wp_norm, wp_valid, kp_uv, kp_norm,
                                     kp_valid, ext[3][0], ext[4][0],
                                     detect_loop=scores is not None, scores=scores)
        self.n_keyframes += 1
        # appended after this keyframe's own query: the next keyframe's query
        # sees it (the recency exclusion makes that the serial order)
        d_c, v_c, n_c = combine_db_rows(ext[3], ext[2], ext[1], ext[4], sout.wp_valid,
                                        sout.wp_norm)
        g._db_append_block(d_c, v_c, count=1, norms=n_c, kf_indices=[kf.index])
        t2 = time.perf_counter()
        self.stage_s["extract"] += t1 - t0
        self.stage_s["query"] += t2 - t1
        if cand is None:
            return
        info = g._find_connection(kf, g.keyframes[cand])
        t3 = time.perf_counter()
        self.stage_s["verify"] += t3 - t2
        if info is None:
            return
        self.n_loops += 1
        g.accept_loop(kf, cand, info)
        g.optimize()
        if self.fast_relo and self.est is not None:
            old = g.keyframes[info["old"]]
            self.est.set_relo_frame(info["matched_old_norm"], info["inlier_mask"],
                                    _host(sout.wp_ids[0]), old.P_vio, old.Q_vio)
            self._relo_sent_kf = info["cur"]
        self.stage_s["pgo"] += time.perf_counter() - t3

    def _consume_relo(self, p: np.ndarray):
        """The estimator's optimized relo pose -> the loop's refined
        relative pose -> ``PoseGraph.update_keyframe_loop``."""
        kf_index, self._relo_sent_kf = self._relo_sent_kf, None
        self.g.update_keyframe_loop(kf_index, *relo_relative_pose(p[9:12], p[12:16], p[16:19],
                                                                  p[19:23]))

    def _warmup(self, img: torch.Tensor):
        cfg = self.cfg
        g = self.g.clone()
        dev = self.device
        uv = torch.full((1, cfg.max_wp, 2), 50.0, device=dev)
        wv = torch.ones((1, cfg.max_wp), dtype=torch.bool, device=dev)
        ext = extract_kf_device(cfg, g.cam, img[None], uv, wv, torch.full_like(img, 3.0)[None])
        g._ensure_capacity(2, (cfg.max_kp + cfg.max_wp, 256))
        _host(db_query_multi(g._dev_db, g._dev_valid, ext[3], ext[2], float(cfg.score_dist)))
        kp_uv, kp_norm, kp_valid, kp_desc, _ = (_host(e[0]) for e in ext)
        # two keyframes that see the same points: a loop check that passes
        n = min(cfg.max_wp, cfg.max_kp)
        wpw = np.zeros((cfg.max_wp, 3))
        wpw[:, 2] = 3.0
        wpn = np.zeros((cfg.max_wp, 3), np.float32)
        wpn[:n] = kp_norm[:n]
        wpd = np.zeros((cfg.max_wp, 256), np.int8)
        wpd[:n] = kp_desc[:n]
        wvn = np.zeros(cfg.max_wp, bool)
        wvn[:n] = kp_valid[:n]
        q0 = np.array([1.0, 0, 0, 0])
        kfs = [g.insert_keyframe(float(k), np.full(3, 0.01 * k), q0, wpw, wpn, wvn, kp_uv,
                                 kp_norm, kp_valid, kp_desc, wpd, detect_loop=False)[0]
               for k in range(2)]
        info = g._find_connection(kfs[1], kfs[0])
        g.loops.append(info if info is not None else dict(
            cur=1, old=0, rel_t=np.zeros(3), rel_yaw=0.0, rel_q=q0,
            n_inliers=cfg.min_loop_num))
        g.earliest_loop_index = 0
        g.optimize()
