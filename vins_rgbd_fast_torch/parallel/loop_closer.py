"""Loop closure on the worker side of both pipelines (twin of
``vins_rgbd_fast_tpu/parallel/loop_closer.py``).

**The batched path** (``BatchedLoopCloser``, ``ThreadedLoopCloser``): between
scan segments of ``BatchedVioRunner.run``, per-sequence ``PoseGraph``s are
fed from the segment's ``ScanOutputs`` (poses, keyframe flags, window
points) and frames: one gating read-back per segment, one extraction per
chunk of up to ``k_pad`` keyframes (kernel K1 once over the chunk's
images), one retrieval query per chunk against the B stacked DBs
(``db_query_all``), one verification per candidate group with both sides
gathered on the device (``verify_loops_device``), deferred DB appends, and
one batched 4-DoF solve for the sequences due for a PGO (``pgo_period`` in
stream seconds).  The stages form a 5-deep software pipeline
(``pipeline_advance_packed``); device results reach the host through
non-blocking copies into pinned memory, each followed by an event that the
stage reading it waits on (``HostCopy``).  Deferred appends are exact while
a segment adds fewer keyframes per sequence than the recency exclusion.
Fast relocalization is not fed back on this path (nor in JAX): corrections
ride the per-sequence drift.  ``ThreadedLoopCloser`` runs the stages on a
worker thread and CUDA stream, so the frame thread only launches.

**The latency path** (``AsyncLoopStager``): the frame thread only packs a
23-float gating row per frame on its own stream (is_keyframe, pose, the
relocalization round trip), starts its copy to the host (``HostCopy``:
pinned memory, then an event) and, whenever the worker is idle, hands the
frames it holds over as one round; it never waits for the worker, and
holds frames while the worker is busy (JAX's stager queues a batch every
8 frames and reads it back once: replayed frames run faster than the
worker, and frames that wait in a queue, or for the last frame of their
batch, reach the pose graph later).  The worker thread reads each frame's
row when that frame is done (a wait on its event, on the worker), gates
keyframes and, for a keyframe, orders its own stream after that event, so
it reads the frame's outputs and images and nothing queued after them;
it extracts their features (kernel K1 again on the card), queries the
retrieval DB, verifies a candidate (on the card the check is replayed from
a captured graph, ``pose_graph.verify_row``), hands a relocalization
constraint back to the estimator as host arrays
(``VinsEstimator.set_relo_frame``) and optimizes the pose graph; the frame
thread uploads the constraint with its next frame's packed inputs.  The
solve that takes it refines the loop edge against the window's
second-newest frame, which the worker carries back to the loop's keyframe
by the odometry between their outputs (``relo_keyframe_pose``).  Tensors
that cross to the worker's stream are marked with ``record_stream``.  An
exception on the worker is raised by the next ``drain``.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..loop.pose_graph import (KeyframeGate, PoseGraph, PoseGraphConfig, _host, _on,
                               combine_db_rows, combined_old_rows, db_query_all,
                               db_query_multi, extract_kf_device, optimize_4dof,
                               relo_keyframe_pose, relo_relative_pose, verify_loops_batch,
                               verify_loops_device)
from ..models.camera import CameraModel
from ..utils.timing import TRACER
from .batched_pipeline import FrameBatch, ScanOutputs


def _pad_pow2(n: int, lo: int = 4) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def pack_gating(is_kf, P, ts) -> torch.Tensor:
    """(T, B, 5) gating inputs of a segment in one tensor: is_keyframe, P,
    the frame's stamp."""
    return torch.cat([is_kf[..., None].to(P.dtype), P, ts[..., None].to(P.dtype)], dim=-1)


def _upload(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """Host array -> ``device``; on CUDA through pinned memory, non-blocking
    on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class HostCopy:
    """Device tensors on their way to the host: on CUDA, non-blocking copies
    into pinned buffers on the current stream, then an event; ``get`` waits
    on that event (on the thread that reads) and returns numpy arrays.  CPU
    tensors are read as they are; a copy already done is read without a
    wait."""

    __slots__ = ("_host", "_event")

    def __init__(self, tensors):
        self._host, self._event = [], None
        for t in tensors:
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t = h
                if self._event is None:
                    self._event = torch.cuda.Event()
            self._host.append(t)
        if self._event is not None:
            self._event.record()

    def get(self) -> list:
        if self._event is not None and not self._event.query():
            self._event.synchronize()
        return [h.numpy() for h in self._host]


class _Worker:
    """A worker thread and, on CUDA, a stream of its own: jobs (callables)
    run in order on the thread, inside the stream; the first exception a job
    raises is kept and raised by the next ``wait``."""

    def __init__(self, device: torch.device, name: str):
        self.stream = torch.cuda.Stream(device=device) if device.type == "cuda" else None
        self._q: "queue.Queue" = queue.Queue()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True, name=name)
        self._thread.start()

    def put(self, job):
        self._q.put(job)

    def record(self):
        """An event on the caller's current stream (None off CUDA): what a
        job that reads the caller's tensors hands to ``adopt``."""
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def adopt(self, ready, *tensors):
        """In a job: order the worker's stream after ``ready`` and mark the
        CUDA tensors among ``tensors`` as used by it."""
        if self.stream is None:
            return
        if ready is not None:
            self.stream.wait_event(ready)
        for x in tensors:
            if isinstance(x, torch.Tensor) and x.is_cuda:
                x.record_stream(self.stream)

    def idle(self) -> bool:
        """Whether every job put so far has finished (does not wait)."""
        return self._q.unfinished_tasks == 0

    def wait(self):
        """Wait until the queue is empty and the thread idle; raise a job's
        exception if one occurred."""
        self._q.join()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def close(self):
        """Stop the thread (after the jobs queued so far)."""
        self._q.put(None)
        self._thread.join(timeout=60)

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    def _run(self):
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                with (torch.cuda.stream(self.stream) if self.stream is not None
                      else contextlib.nullcontext()):
                    job()
            except BaseException as e:  # noqa: BLE001 — raised by wait()
                self._exc = e
            finally:
                self._q.task_done()


class BatchedLoopCloser:
    """Per-sequence pose graphs fed from batched scan segments.  Stats per
    segment carry JAX's keys: n_keyframes, n_loops, and the host ms of the
    gating read-back (ms_sync1), the chunk dispatches (ms_dispatch), the
    chunk read-back and insertion (ms_sync2), the verification dispatch
    (ms_vdisp), the loop acceptance with the PGO dispatch (ms_accept) and
    the PGO read-back and write-back (ms_pgo)."""

    CAND_PAD = 64  # loop candidates verified per call (a group never spans two chunks)

    def __init__(self, cam: CameraModel, ric, tic, batch: int, device,
                 pg_cfg: Optional[PoseGraphConfig] = None, skip_cnt: int = 0, skip_dis: float = 0.0, k_pad: int = 0, seq_pad: int = 0,
                 db_capacity: int = 0, pgo_period: float = 0.0, pnp_uniforms=None):
        self.cfg = pg_cfg or PoseGraphConfig()
        self.cam = cam
        self.ric = np.asarray(ric)
        self.tic = np.asarray(tic)
        self.device = torch.device(device)
        self.graphs: List[PoseGraph] = [
            PoseGraph(self.cfg, cam, ric, tic, self.device, pnp_uniforms=pnp_uniforms)
            for _ in range(batch)]
        if db_capacity:
            # one capacity for every graph: the merged cross-sequence query
            # and the device-resident verification stack the DBs
            for g in self.graphs:
                g._ensure_capacity(min(db_capacity, self.cfg.max_keyframes),
                                   (self.cfg.max_kp + self.cfg.max_wp, 256))
        self.skip_cnt = skip_cnt
        self.skip_dis = skip_dis
        self.gates = [KeyframeGate(skip_cnt, skip_dis) for _ in range(batch)]
        # k_pad fixes K1's batch per extraction chunk (0: one chunk of the
        # segment's keyframes); seq_pad the per-sequence blocks of the
        # deferred appends
        self.k_pad = int(k_pad)
        self.seq_pad = int(seq_pad)
        # previous segments' device-resident DB rows, appended at the start of
        # the next dispatch (scoring sees segments up to k - 1)
        self._pending_append: list = []
        # PGO cadence in stream seconds (the reference's optimize4DoF thread
        # wakes every 2 s, pose_graph.cpp:410-581); 0: every segment
        self.pgo_period = float(pgo_period)
        self._pgo_last_t: dict = {}
        self._pgo_backlog: set = set()
        self._dbs_stacked = None  # stacked DB snapshot for the device verification
        self._dbs_index_snap = None  # slot -> keyframe index maps of that snapshot
        self._st0 = self._st1 = self._st2 = self._st3 = None  # pipeline stage slots
        self.n_keyframes = 0
        self.n_loops = 0
        self.n_chunks = 0  # extraction chunks dispatched (one K1 launch each on the card)

    # ------------------------------------------------------------------
    def clone(self) -> "BatchedLoopCloser":
        """A copy sharing nothing mutable (graphs cloned, gates copied, no
        stage in flight)."""
        c = BatchedLoopCloser.__new__(BatchedLoopCloser)
        c.cfg, c.cam, c.ric, c.tic, c.device = self.cfg, self.cam, self.ric, self.tic, self.device
        c.skip_cnt, c.skip_dis = self.skip_cnt, self.skip_dis
        c.gates = copy.deepcopy(self.gates)
        c.k_pad, c.seq_pad = self.k_pad, self.seq_pad
        c._pending_append = []
        c.pgo_period = self.pgo_period
        c._pgo_last_t = dict(self._pgo_last_t)
        c._pgo_backlog = set(self._pgo_backlog)
        c._dbs_stacked = None
        c._dbs_index_snap = None
        c._st0 = c._st1 = c._st2 = c._st3 = None
        c.n_keyframes, c.n_loops, c.n_chunks = self.n_keyframes, self.n_loops, self.n_chunks
        c.graphs = [g.clone() for g in self.graphs]
        return c

    # ------------------------------------------------------------------
    def compile_warmup(self, batch: FrameBatch, outs: ScanOutputs):
        """Run every stage that only runs once the DBs are non-empty or a
        loop fires (the DB query, block appends, both verification forms,
        the sequential loop check, the batched PGO) on a throwaway clone, so
        their one-time costs on this thread and stream (library handles and
        workspaces, the allocator's first blocks) fall outside a timed
        region.  Call after a real ``consume`` of the (untimed) warm
        segment."""
        ghost = self.clone()
        # fresh gates: replaying the same segment against copied travel
        # anchors would admit nothing
        ghost.gates = [KeyframeGate(self.skip_cnt, self.skip_dis) for _ in ghost.graphs]
        ghost.consume(batch, outs)
        cfg, dev = self.cfg, self.device
        g = ghost.graphs[0]
        if len(g.keyframes) < 2:
            return
        old, cur = g.keyframes[0], g.keyframes[-1]
        # a perfectly matching pair: the Hamming gate passes and PnP runs
        n = min(cfg.max_wp, cfg.max_kp)
        wp_desc = _on(cur.wp_desc, torch.int8, dev).clone()
        wp_desc[:n] = _on(old.kp_desc, torch.int8, dev)[:n]
        wp_valid = np.zeros(np.asarray(cur.wp_valid).shape[0], bool)
        wp_valid[:n] = np.asarray(old.kp_valid[:n], bool)
        cur_fake = cur._replace(wp_desc=wp_desc, wp_valid=wp_valid)
        fake = (0, cur_fake, old.index, None, 0, np.eye(3), np.zeros(3))
        ghost._dispatch_verify([fake])[0].get()  # the host-stacked form ...
        if ghost._dbs_stacked is not None:  # ... the device-resident one ...
            dbs, dbvs, dbns = ghost._dbs_stacked
            mw = wp_valid.shape[0]
            HostCopy(verify_loops_device(
                g.pnp_uniforms(cur.index, mw)[None], torch.zeros((1, 4), dtype=torch.int64,
                                                                 device=dev),
                torch.zeros((1, 24), device=dev), torch.zeros((1, mw, 3), device=dev),
                torch.zeros((1, mw, 256), dtype=torch.int8, device=dev),
                torch.zeros((1, mw), dtype=torch.bool, device=dev), dbs, dbvs, dbns,
                float(cfg.match_thresh), int(cfg.min_loop_num))).get()
        g._find_connection(cur_fake, old)  # ... and the sequential one
        g.loops.append(dict(cur=cur.index, old=old.index, rel_t=np.zeros(3), rel_yaw=0.0,
                            rel_q=np.array([1.0, 0.0, 0.0, 0.0]), n_inliers=cfg.min_loop_num))
        if g.earliest_loop_index is None:
            g.earliest_loop_index = old.index
        ghost._optimize_graphs({0})

    # ------------------------------------------------------------------
    def flush(self):
        """Append the deferred DB rows (done at the start of the next
        dispatch; call after the last ``consume_finish`` before reading the
        graphs' DBs)."""
        pend, self._pending_append = self._pending_append, []
        for (desc_d, valid_d, norm_d, by_seq, kf_rows) in pend:
            for b, idxs in by_seq.items():
                k = len(idxs)
                qp = self.seq_pad or _pad_pow2(k)
                for j0 in range(0, k, qp):
                    # blocks padded to qp rows, as JAX's (same capacity growth)
                    part = list(idxs[j0:j0 + qp])
                    idxp = _upload(np.asarray(part + [0] * (qp - len(part)), np.int64),
                                   self.device)
                    real = torch.arange(qp, device=self.device) < len(part)
                    self.graphs[b]._db_append_block(
                        desc_d[idxp], valid_d[idxp] & real[:, None], count=len(part),
                        norms=norm_d[idxp], kf_indices=[kf_rows[i] for i in part])

    # ------------------------------------------------------------------
    def _gate(self, b: int, is_kf: bool, P: np.ndarray) -> bool:
        """Keyframe admission of sequence b (skip count, travel distance;
        ``pose_graph_nodelet.cpp:501,522``)."""
        return self.gates[b].admit(is_kf, P)

    # ------------------------------------------------------------------
    def consume(self, batch: FrameBatch, outs: ScanOutputs) -> dict:
        """Feed one segment's keyframes to the graphs, synchronously
        (dispatch, then finish, then the deferred appends)."""
        out = self.consume_finish(self.consume_dispatch(batch, outs))
        self.flush()
        return out

    def consume_dispatch(self, batch: FrameBatch, outs: ScanOutputs):
        """First half: the gating read-back and the chunk dispatches
        (extraction, retrieval); returns a token for ``consume_finish``."""
        return self._gate_dispatch(self.pack_dispatch(batch, outs))

    def pack_dispatch(self, batch: FrameBatch, outs: ScanOutputs):
        """Launch the segment's gating pack and its copy to the host; the
        stage-0 token of the pipeline."""
        if batch is None:
            return None
        return dict(batch=batch, outs=outs,
                    packed=HostCopy([pack_gating(outs.is_keyframe, outs.P, batch.ts)]))

    def _gate_dispatch(self, tok):
        """Stage 1: flush the deferred appends, read the gating pack, admit
        keyframes and dispatch their chunks."""
        if tok is None:
            return None
        batch, outs = tok["batch"], tok["outs"]
        t0 = time.perf_counter()
        self.flush()
        packed = tok["packed"].get()[0]
        is_kf = packed[..., 0] > 0.5
        P_all = packed[..., 1:4]
        ts = packed[..., 4]
        T, B = ts.shape
        t_sync1 = time.perf_counter()
        sel = [(k, b) for b in range(B) for k in range(T)
               if self._gate(b, bool(is_kf[k, b]), P_all[k, b])]
        if not sel:
            return None
        Kp = self.k_pad or len(sel)
        pends = [self._dispatch_chunk(batch, outs, sel[i:i + Kp], Kp, ts, P_all)
                 for i in range(0, len(sel), Kp)]
        return dict(pends=pends, t0=t0, t_sync1=t_sync1, t_disp=time.perf_counter())

    def _dispatch_chunk(self, batch: FrameBatch, outs: ScanOutputs, sel, Kp: int, ts, P_all):
        """One chunk of at most ``Kp`` keyframes: gather their data, extract
        features (K1 once over Kp images; the pad repeats frame 0 of
        sequence 0), query retrieval, start the copies to the host."""
        K = len(sel)
        ks = np.asarray([s[0] for s in sel] + [0] * (Kp - K), np.int64)
        bs = np.asarray([s[1] for s in sel] + [0] * (Kp - K), np.int64)
        ks_d, bs_d = _upload(ks, self.device), _upload(bs, self.device)
        wp_valid_d = outs.wp_valid[ks_d, bs_d]
        wp_world_d = outs.wp_world[ks_d, bs_d]
        wp_norm_d = outs.wp_norm[ks_d, bs_d]
        Q_d = outs.Q[ks_d, bs_d]
        ext = extract_kf_device(self.cfg, self.cam, batch.imgs[ks_d, bs_d],
                                outs.wp_uv[ks_d, bs_d], wp_valid_d,
                                batch.depths[ks_d, bs_d], n_real=K)
        self.n_chunks += 1
        by_seq: dict = {}
        for i in range(K):
            by_seq.setdefault(int(bs[i]), []).append(i)
        scores_d = self._dispatch_queries(by_seq, ext[3], ext[2], Kp)
        parts = [(b, j, sc) for b, lst in scores_d.items() if lst is not None
                 for j, (sc, _) in enumerate(lst)]
        host = HostCopy([e[:K] for e in ext[:3]]
                        + [wp_world_d[:K], wp_norm_d[:K], wp_valid_d[:K], Q_d[:K]]
                        + [sc for (_, _, sc) in parts])
        return dict(ext=ext, wp_world_d=wp_world_d, wp_norm_d=wp_norm_d, wp_valid_d=wp_valid_d,
                    Q_d=Q_d, scores_d=scores_d, score_parts=parts, host=host, by_seq=by_seq,
                    ks=ks, bs=bs, K=K, ts=ts, P_all=P_all)

    def _dispatch_queries(self, by_seq, kp_desc_d, kp_valid_d, Kp):
        """Retrieval scores of the chunk's keyframes: one query of the B
        stacked DBs when every DB has one capacity (``db_query_all``), else
        per sequence (``db_query_multi``).  Returns {b: None (empty DB) or
        [(scores (n_part, cap), n_part), ...]}."""
        caps = {0 if g._dev_db is None else int(g._dev_db.shape[0]) for g in self.graphs}
        if len(caps) != 1 or 0 in caps:
            self._dbs_stacked = None
            self._dbs_index_snap = None
            scores_d: dict = {}
            for b, idxs in by_seq.items():
                g = self.graphs[b]
                if g._dev_db is None or g._db_size == 0:
                    scores_d[b] = None
                    continue
                qp_b = min(self.seq_pad or _pad_pow2(len(idxs)), Kp)
                scores_d[b] = []
                for j0 in range(0, len(idxs), qp_b):
                    part = idxs[j0:j0 + qp_b]
                    idxp = _upload(np.asarray(part, np.int64), self.device)
                    scores_d[b].append((db_query_multi(g._dev_db, g._dev_valid, kp_desc_d[idxp],
                                                       kp_valid_d[idxp],
                                                       float(self.cfg.score_dist)), len(part)))
            return scores_d
        B = len(self.graphs)
        qp = max(len(v) for v in by_seq.values())
        qidx = np.zeros((B, qp), np.int64)
        qcnt = np.zeros(B, np.int64)
        for b, idxs in by_seq.items():
            qidx[b, :len(idxs)] = idxs
            qcnt[b] = len(idxs)
        dbs = torch.stack([g._dev_db for g in self.graphs])
        dbvs = torch.stack([g._dev_valid for g in self.graphs])
        dbns = torch.stack([g._dev_norm for g in self.graphs])
        # kept for this segment's device verification (appends are deferred
        # to the next dispatch), with the slot -> keyframe maps of the same
        # moment (a later compaction remaps the live ones)
        self._dbs_stacked = (dbs, dbvs, dbns)
        self._dbs_index_snap = [g._db_index.copy() for g in self.graphs]
        qsel = _upload(qidx, self.device)
        real = (torch.arange(qp, device=self.device)[None, :]
                < _upload(qcnt, self.device)[:, None])
        sc = db_query_all(dbs, dbvs, kp_desc_d[qsel], kp_valid_d[qsel] & real[..., None],
                          float(self.cfg.score_dist))
        return {b: (None if self.graphs[b]._db_size == 0 else [(sc[b], len(by_seq[b]))])
                for b in by_seq}

    # ------------------------------------------------------------------
    def consume_finish(self, pend) -> dict:
        """Second half, synchronous: insertion, verification and acceptance,
        the PGO."""
        if pend is None:
            return dict(n_keyframes=0, n_loops=0)
        return self._stage_pgo(self._stage_accept(self._stage_insert(pend)))

    def pipeline_advance(self, batch=None, outs=None):
        """Advance the 5-stage pipeline by one segment (``batch=None``
        drains one stage): PGO read-back and write-back (segment k - 4),
        verification read-back, acceptance and PGO dispatch (k - 3),
        extraction read-back, insertion and verification dispatch (k - 2),
        gating read-back and chunk dispatches (k - 1), the gating pack (k).
        Returns the oldest segment's stats, or None."""
        return self.pipeline_advance_packed(self.pack_dispatch(batch, outs)
                                            if batch is not None else None)

    def pipeline_advance_packed(self, tok):
        """``pipeline_advance`` with a stage-0 token from ``pack_dispatch``."""
        stats = self._stage_pgo(self._st3) if self._st3 is not None else None
        self._st3 = self._stage_accept(self._st2)
        self._st2 = self._stage_insert(self._st1)
        self._st1 = self._gate_dispatch(self._st0)
        self._st0 = tok
        return stats

    def _in_flight(self) -> bool:
        return any(s is not None for s in (self._st0, self._st1, self._st2, self._st3))

    def pipeline_drain(self) -> list:
        """Run the stages in flight to their end, flush the appends and run
        the last PGO wake-up; returns the remaining segments' stats."""
        out = []
        while self._in_flight():
            st = self.pipeline_advance(None, None)
            if st is not None:
                out.append(st)
        self.flush()
        self._final_pgo()
        return out

    def _final_pgo(self):
        """Solve every sequence still deferred by the PGO cadence (the
        reference thread's next wake-up would)."""
        if not self._pgo_backlog:
            return
        due, self._pgo_backlog = set(self._pgo_backlog), set()
        for b in due:
            g = self.graphs[b]
            self._pgo_last_t[b] = g.keyframes[-1].t if g.keyframes else 0.0
        self._optimize_graphs(due)

    # ------------------------------------------------------------------
    def _stage_insert(self, pend):
        """Stage 2: read the chunks back, insert the keyframes and detect
        candidates, dispatch their verification in groups (per chunk, at
        most ``CAND_PAD``)."""
        if pend is None:
            return None
        t0 = time.perf_counter()
        n_kf = 0
        cands = []  # (b, kf, old index, chunk, chunk row, w_r, w_t) in keyframe order
        for chunk in pend["pends"]:
            dn, dc = self._chunk_insert(chunk)
            n_kf += dn
            cands += dc
        t_fetch = time.perf_counter()
        groups, run = [], []
        for c in cands:
            if run and (c[3] is not run[0][3] or len(run) == self.CAND_PAD):
                groups.append(run)
                run = []
            run.append(c)
        if run:
            groups.append(run)
        pend_v = [self._dispatch_verify_dev(gr) if self._dbs_stacked is not None
                  else self._dispatch_verify(gr) for gr in groups]
        self.n_keyframes += n_kf
        return dict(cands=cands, pend_v=pend_v, n_kf=n_kf,
                    ms_sync1=1e3 * (pend["t_sync1"] - pend["t0"]),
                    ms_dispatch=1e3 * (pend["t_disp"] - pend["t_sync1"]),
                    ms_sync2=1e3 * (t_fetch - t0),
                    ms_vdisp=1e3 * (time.perf_counter() - t_fetch))

    def _chunk_insert(self, chunk: dict):
        """Read the chunk back, insert its keyframes, detect candidates from
        the read-back scores and queue the chunk's deferred DB append.  The
        descriptors are not read back: each keyframe keeps row slices of the
        chunk's device tensors."""
        ext, by_seq = chunk["ext"], chunk["by_seq"]
        ks, bs, K = chunk["ks"], chunk["bs"], chunk["K"]
        ts, P_all = chunk["ts"], chunk["P_all"]
        kp_desc_d, wp_desc_d = ext[3], ext[4]
        h = chunk["host"].get()
        kp_uv, kp_norm, kp_valid, wp_world, wp_norm, wp_valid, Qh = h[:7]
        parts: dict = {}  # b -> [(scores, n), ...] in query order
        for (b, j, _), sc in zip(chunk["score_parts"], h[7:]):
            parts.setdefault(b, []).append((sc, chunk["scores_d"][b][j][1]))
        scores: dict = {}
        for b, idxs in by_seq.items():
            if b not in parts:
                scores[b] = {i: None for i in idxs}
            else:
                rows = np.concatenate([sc[:n] for (sc, n) in parts[b]], axis=0)
                scores[b] = {i: rows[j] for j, i in enumerate(idxs)}
        cands = []
        kf_rows: dict = {}  # chunk row -> keyframe index (for the append)
        for i in range(K):
            k, b = int(ks[i]), int(bs[i])
            g = self.graphs[b]
            w_r, w_t = g.w_r_vio.copy(), g.w_t_vio.copy()  # as of the insertion
            kf, cand = g.insert_keyframe(float(ts[k, b]), P_all[k, b], Qh[i], wp_world[i],
                                         wp_norm[i], wp_valid[i], kp_uv[i], kp_norm[i],
                                         kp_valid[i], kp_desc_d[i], wp_desc_d[i],
                                         scores=scores[b][i])
            kf_rows[i] = kf.index
            if cand is not None:
                cands.append((b, kf, cand, chunk, i, w_r, w_t))
        # the combined keypoint + window-point rows (pose_graph.combine_db_rows)
        desc_c, valid_c, norm_c = combine_db_rows(ext[3], ext[2], ext[1], ext[4],
                                                  chunk["wp_valid_d"], chunk["wp_norm_d"])
        self._pending_append.append((desc_c, valid_c, norm_c, by_seq, kf_rows))
        return K, cands

    def _dispatch_verify(self, group):
        """The verification of a group when the DBs are not stacked: the
        current side uploaded per candidate, the old side stacked from each
        keyframe's device rows."""
        dev = self.device
        mw = np.asarray(group[0][1].wp_valid).shape[0]
        u = torch.stack([self.graphs[c[0]].pnp_uniforms(c[1].index, mw) for c in group])
        olds = [self.graphs[b].keyframes[cand] for (b, _, cand, *_) in group]
        old_d, old_v, old_n = (torch.stack(f) for f in zip(*(combined_old_rows(o, dev)
                                                             for o in olds)))
        guesses = [self.graphs[c[0]]._pnp_init_guess(o) for c, o in zip(group, olds)]

        def up(arrays, dtype):
            return _upload(np.stack(arrays), dev, dtype)

        out = verify_loops_batch(
            u, up([c[1].wp_world for c in group], torch.float32),
            torch.stack([_on(c[1].wp_desc, torch.int8, dev) for c in group]),
            up([np.asarray(c[1].wp_valid, bool) for c in group], torch.bool),
            old_d, old_v, old_n, up([gu[0] for gu in guesses], torch.float32),
            up([gu[1] for gu in guesses], torch.float32),
            float(self.cfg.match_thresh), int(self.cfg.min_loop_num))
        return HostCopy(out), len(group)

    def _dispatch_verify_dev(self, group):
        """The device-resident verification of a group: the current side
        from its chunk's tensors, the old side from the stacked DBs; the
        host uploads two small packed arrays (and the PnP uniforms when they
        are injected)."""
        chunk = group[0][3]
        C = len(group)
        ints = np.zeros((C, 4), np.int64)
        flts = np.zeros((C, 24), np.float32)
        for j, (b, kf, cand, _, i_row, w_r, w_t) in enumerate(group):
            g = self.graphs[b]
            idx_map = self._dbs_index_snap[b]
            slot = int(np.searchsorted(idx_map, cand))
            if not (slot < len(idx_map) and idx_map[slot] == cand):
                # the old keyframe left retrieval after the snapshot: host form
                return self._dispatch_verify(group)
            R0, t0 = g._pnp_init_guess(g.keyframes[cand])
            ints[j] = (kf.index, b, slot, i_row)
            flts[j, 0:9] = np.asarray(R0, np.float32).ravel()
            flts[j, 9:12] = np.asarray(t0, np.float32)
            flts[j, 12:21] = np.asarray(w_r, np.float32).ravel()
            flts[j, 21:24] = np.asarray(w_t, np.float32)
        mw = chunk["wp_valid_d"].shape[1]
        u = torch.stack([self.graphs[c[0]].pnp_uniforms(c[1].index, mw) for c in group])
        dbs, dbvs, dbns = self._dbs_stacked
        out = verify_loops_device(u, _upload(ints, self.device), _upload(flts, self.device),
                                  chunk["wp_world_d"], chunk["ext"][4], chunk["wp_valid_d"],
                                  dbs, dbvs, dbns, float(self.cfg.match_thresh),
                                  int(self.cfg.min_loop_num))
        return HostCopy(out), C

    # ------------------------------------------------------------------
    def _stage_accept(self, st2):
        """Stage 3: read the verification back, accept loops in keyframe
        order (after a cross-sequence realignment, the graph's later
        candidates are verified again sequentially, their inputs predating
        the remap), dispatch the PGO of the sequences due."""
        if st2 is None:
            return None
        t0 = time.perf_counter()
        cands, pend_v = st2["cands"], st2["pend_v"]
        n_loops = 0
        looped: set = set()
        if cands:
            host_v = [h.get() for (h, _) in pend_v]
            ns = [n for (_, n) in pend_v]
            idx_b, okf, models, ninl, inls = (
                np.concatenate([np.asarray(h[f])[:n] for h, n in zip(host_v, ns)])
                for f in range(5))
            realigned: set = set()
            for j in range(len(cands)):
                b, kf, cand = cands[j][:3]
                g = self.graphs[b]
                cur, old = g.keyframes[kf.index], g.keyframes[cand]
                if b in realigned:
                    info = g._find_connection(cur, old)
                else:
                    info = g._loop_from_pnp(cur, old, bool(okf[j]), models[j], int(ninl[j]),
                                            idx_b[j], inls[j])
                if info is not None:
                    if g.accept_loop(cur, cand, info):
                        realigned.add(b)
                    n_loops += 1
                    looped.add(b)
        self.n_loops += n_loops
        # the PGO cadence (stream time): deferred sequences stay in the
        # backlog, their loops riding the drift until the next wake-up
        self._pgo_backlog |= looped
        due = set()
        for b in self._pgo_backlog:
            g = self.graphs[b]
            t_now = g.keyframes[-1].t if g.keyframes else 0.0
            if self.pgo_period <= 0 or t_now - self._pgo_last_t.get(b, -1e18) >= self.pgo_period:
                due.add(b)
                self._pgo_last_t[b] = t_now
        self._pgo_backlog -= due
        pgo = self._pgo_dispatch(due)
        st3 = {k: v for k, v in st2.items() if k not in ("cands", "pend_v")}
        st3.update(pgo=pgo, n_loops=n_loops, ms_accept=1e3 * (time.perf_counter() - t0))
        return st3

    def _stage_pgo(self, st3) -> dict:
        """Stage 4: read the PGO back and write it into the graphs; the
        segment's stats."""
        if st3 is None:
            return dict(n_keyframes=0, n_loops=0)
        t0 = time.perf_counter()
        self._pgo_apply(st3.get("pgo"))
        return dict(n_keyframes=st3["n_kf"], n_loops=st3["n_loops"], ms_sync1=st3["ms_sync1"],
                    ms_dispatch=st3["ms_dispatch"], ms_sync2=st3["ms_sync2"],
                    ms_vdisp=st3["ms_vdisp"], ms_accept=st3["ms_accept"],
                    ms_pgo=1e3 * (time.perf_counter() - t0))

    # ------------------------------------------------------------------
    def _optimize_graphs(self, looped):
        """The PGO of the sequences ``looped``, synchronously."""
        self._pgo_apply(self._pgo_dispatch(looped))

    def _pgo_dispatch(self, looped):
        """One batched 4-DoF solve (``optimize_4dof`` over a leading problem
        axis) for every sequence in ``looped`` whose problem has the shared
        padded (nodes, edges) shape; per-graph solves when the shapes
        differ; ``optimize()`` in VO mode.  Returns a token for
        ``_pgo_apply``."""
        probs = []
        for b in sorted(looped):
            g = self.graphs[b]
            pr = g._build_4dof()
            if pr is None:
                continue
            if pr == "6dof":
                g.optimize()
                continue
            probs.append((b, pr))
        if not probs:
            return None
        if len({(pr["yaw"].shape[0], pr["ei"].shape[0]) for _, pr in probs}) > 1:
            for b, pr in probs:
                self.graphs[b]._solve_apply_4dof(pr)
            return None
        f32, dev = torch.float32, self.device

        def st(key, dtype=f32):
            return _upload(np.stack([pr[key] for _, pr in probs]), dev, dtype)

        yaw_o, t_o, _, _ = optimize_4dof(
            st("yaw"), st("tt"), st("pitch"), st("roll"), st("valid", torch.bool),
            st("fixed", torch.bool), st("ei", torch.int64), st("ej", torch.int64), st("ert"),
            st("ery"), st("elo", torch.bool), st("evl", torch.bool), iters=self.cfg.pg_iters,
            huber=self.cfg.huber)
        return dict(probs=probs, host=HostCopy([torch.cat([yaw_o[..., None], t_o], dim=-1)]))

    def _pgo_apply(self, pend):
        """Write a dispatched PGO back (corrected poses, drift)."""
        if pend is None:
            return
        out = pend["host"].get()[0].astype(np.float64)
        for (b, pr), o in zip(pend["probs"], out):
            self.graphs[b]._apply_4dof(pr, o[:, 0], o[:, 1:])

    # ------------------------------------------------------------------
    def corrected_path(self, b: int) -> list:
        """Loop-corrected keyframe trajectory [(t, P, Q)] of sequence b."""
        return self.graphs[b].path()

    def _device_tensors(self):
        """Every device tensor the closer holds (graphs' DBs and keyframe
        descriptors, the stacked DB snapshot)."""
        for g in self.graphs:
            yield from (g._dev_db, g._dev_valid, g._dev_norm)
            for kf in g.keyframes:
                yield from (kf.kp_desc, kf.wp_desc)
        if self._dbs_stacked is not None:
            yield from self._dbs_stacked


class ThreadedLoopCloser:
    """A ``BatchedLoopCloser`` on a worker thread and a CUDA stream of its
    own (the reference's pose-graph nodelet beside the estimator,
    ``pose_graph_nodelet.cpp:449-566``).  ``submit`` records an event on the
    caller's stream after the segment's ``run`` and queues the segment; the
    worker's stream waits on that event, the segment's tensors are marked
    with ``record_stream``, and the worker advances the 5-stage pipeline
    (every host wait happens there).  ``drain`` runs the stages in flight
    to their end and raises a worker exception; ``close`` stops the
    thread."""

    def __init__(self, closer: BatchedLoopCloser):
        if closer._in_flight():
            raise ValueError("hand over a closer with no stage in flight")
        self.closer = closer
        self.stats: list = []
        self._worker = _Worker(closer.device, "loop-closer")
        # the closer's tensors so far were made on the caller's stream
        closer.flush()
        ready = self._worker.record()
        self._worker.put(lambda: self._worker.adopt(ready, *closer._device_tensors()))

    def submit(self, batch: FrameBatch, outs: ScanOutputs):
        """Queue a segment after its ``run`` (launches only)."""
        self._worker.put(functools.partial(self._process, batch, outs, self._worker.record()))

    def compile_warmup(self, batch: FrameBatch, outs: ScanOutputs):
        """``BatchedLoopCloser.compile_warmup`` on the worker thread and
        stream; returns when it is done."""
        ready = self._worker.record()

        def warm():
            self._worker.adopt(ready, *batch, *outs)
            self.closer.compile_warmup(batch, outs)

        self._worker.put(warm)
        self._worker.wait()

    def _keep(self, st):
        if st and st.get("n_keyframes"):
            self.stats.append(st)

    def _process(self, batch, outs, ready):
        c = self.closer
        # the stages first: the earlier segments' dispatches then do not
        # queue behind this segment's event on the worker's stream
        self._keep(c.pipeline_advance_packed(None))
        self._worker.adopt(ready, *batch, *outs)
        c._st0 = c.pack_dispatch(batch, outs)

    def _drain_stages(self):
        for st in self.closer.pipeline_drain():
            self._keep(st)
        if self._worker.stream is not None:
            self._worker.stream.synchronize()  # the graphs' DBs complete for any reader

    def drain(self) -> list:
        """Wait for the queued segments, run the stages in flight to their
        end, flush the appends and run the last PGO wake-up (on the worker);
        raises the worker's exception if one occurred.  Returns the stats of
        the segments with keyframes."""
        self._worker.wait()
        self._worker.put(self._drain_stages)
        self._worker.wait()
        return self.stats

    def close(self):
        """Drain, then stop the worker thread."""
        try:
            self.drain()
        finally:
            self._worker.close()


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
    thread: frames go to the worker whenever it is idle, so a keyframe
    reaches the graph once the worker has finished the round it was busy
    with when the keyframe was made.

    Traced (``utils/timing``): the worker's spans ``loop::gating_wait``,
    ``loop::extract``, ``loop::query``, ``loop::verify`` and ``loop::pgo``
    carry the frame id of the frame they serve; counters ``loop::rounds``,
    ``loop::frames`` (handed over), ``loop::keyframes``, ``loop::loops``,
    summed over the process's stagers.  This stager's own keyframes and
    loops are ``n_keyframes`` and ``n_loops``; ``max_round`` is the most
    frames one round handed over."""

    def __init__(self, pose_graph: PoseGraph, estimator=None, skip_cnt: int = 0,
                 skip_dis: float = 0.0, fast_relocalization: bool = False):
        self.g = pose_graph
        self.est = estimator
        self.cfg = pose_graph.cfg
        self.device = pose_graph.device
        self.gate = KeyframeGate(skip_cnt, skip_dis)
        self.fast_relo = fast_relocalization
        self._relo_sent_kf: Optional[int] = None
        self._epoch = None  # the estimator's epoch of the worker's last frame
        self.n_keyframes = 0
        self.n_loops = 0
        self.max_round = 0  # the most frames handed over at once
        # (gating row on its way to the host, t, StepOutput, img, depth, epoch, frame id)
        self._buf: list = []
        self._prev: Optional[tuple] = None  # (t, gating row) of the worker's last frame
        self._worker = _Worker(self.device, "loop-stager")

    # -- frame thread ----------------------------------------------------
    def on_frame(self, sout, img: torch.Tensor, t: float, depth: Optional[torch.Tensor] = None,
                 frame: Optional[int] = None):
        """Record a steady frame: ``sout`` its (B = 1) ``StepOutput``,
        ``img``/``depth`` (H, W) device images, ``frame`` its tracer frame
        id.  Launches only; hands the frames held so far over when the
        worker is idle."""
        # the copy and its event go on the frame thread's stream, after this frame
        epoch = self.est.epoch if self.est is not None else 0
        self._buf.append((HostCopy([pack_latency_gating(sout)]), float(t), sout, img, depth,
                          epoch, frame))
        if self._worker.idle():
            self._flush_buf()

    def _flush_buf(self):
        if not self._buf:
            return
        toks, self._buf = self._buf, []
        self.max_round = max(self.max_round, len(toks))
        TRACER.count("loop::rounds")
        TRACER.count("loop::frames", len(toks))
        self._worker.put(functools.partial(self._process, toks))

    @property
    def pending(self) -> int:
        """Frames recorded and not yet handed over to the worker."""
        return len(self._buf)

    def drain(self):
        """Hand over the buffered frames and wait until the worker is idle;
        raises the worker's exception if one occurred."""
        self._flush_buf()
        self._worker.wait()

    def compile_warmup(self, img: torch.Tensor):
        """Run extraction, the DB query, a loop check and the PGO once on a
        clone of the graph, on the worker thread and its stream, so their
        one-time costs (cuBLAS/cuSOLVER handles and workspaces of a new
        thread and stream, the allocator's first blocks) fall outside any
        timed frame.  ``img``: a sample frame (H, W) on the device."""
        self._worker.put(lambda: self._warmup(img))
        self.drain()

    def close(self):
        """Drain, then stop the worker thread."""
        try:
            self.drain()
        finally:
            self._worker.close()

    # -- worker thread ---------------------------------------------------
    def _process(self, toks):
        for hc, t, sout, img, depth, epoch, frame in toks:
            with TRACER.span("loop::gating_wait", frame):
                row = hc.get()[0].astype(np.float64)  # waits for this frame alone
            if epoch != self._epoch:  # the estimator was reset: its constraint was dropped
                self._epoch, self._relo_sent_kf = epoch, None
            if row[8] > 0.5 and self._relo_sent_kf is not None:
                self._consume_relo(row, self._prev)
            self._prev = (t, row)
            if not self.gate.admit(bool(row[0] > 0.5), row[1:4]):
                continue
            self._worker.adopt(hc._event, img, depth, sout.wp_uv, sout.wp_valid, sout.wp_world,
                               sout.wp_norm, sout.wp_ids)
            self._handle_keyframe(t, row[1:4], row[4:8], sout, img, depth, epoch, frame)

    def _handle_keyframe(self, t, P, Q, sout, img, depth, epoch, frame):
        """Extraction, retrieval, insertion and the DB append; on a
        candidate the loop check, the PGO and the relocalization hand-off
        (refused by the estimator if it was reset after the keyframe's
        frame, its ``epoch``).  ``frame``: the keyframe's tracer frame id."""
        g, cfg = self.g, self.cfg
        with TRACER.span("loop::extract", frame):
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
        with TRACER.span("loop::query", frame):
            scores = None
            if g._dev_db is not None and g._db_size > 0:
                scores = _host(db_query_multi(g._dev_db, g._dev_valid, ext[3], ext[2],
                                              float(cfg.score_dist)))[0]
            kf, cand = g.insert_keyframe(t, P, Q, wp_world, wp_norm, wp_valid, kp_uv, kp_norm,
                                         kp_valid, ext[3][0], ext[4][0],
                                         detect_loop=scores is not None, scores=scores)
            self.n_keyframes += 1
            TRACER.count("loop::keyframes")
            # appended after this keyframe's own query: the next keyframe's query
            # sees it (the recency exclusion makes that the serial order)
            d_c, v_c, n_c = combine_db_rows(ext[3], ext[2], ext[1], ext[4], sout.wp_valid,
                                            sout.wp_norm)
            g._db_append_block(d_c, v_c, count=1, norms=n_c, kf_indices=[kf.index])
        if cand is None:
            return
        with TRACER.span("loop::verify", frame):
            info = g._find_connection(kf, g.keyframes[cand])
        if info is None:
            return
        self.n_loops += 1
        TRACER.count("loop::loops")
        with TRACER.span("loop::pgo", frame):
            g.accept_loop(kf, cand, info)
            if self.fast_relo and self.est is not None:  # the constraint needs no PGO: send it first
                old = g.keyframes[info["old"]]
                if self.est.set_relo_frame(info["matched_old_norm"], info["inlier_mask"],
                                           _host(sout.wp_ids[0]), old.P_vio, old.Q_vio,
                                           epoch=epoch):
                    self._relo_sent_kf = info["cur"]
            g.optimize()

    def _consume_relo(self, p: np.ndarray, prev: Optional[tuple]):
        """The estimator's optimized relo pose -> the loop's refined
        relative pose -> ``PoseGraph.update_keyframe_loop``.  ``p`` is the
        gating row of the frame whose solve took the constraint, ``prev``
        (t, gating row) the frame before it: the solve's second-newest
        frame, carried back to the loop's keyframe unless it is that
        keyframe."""
        kf_index, self._relo_sent_kf = self._relo_sent_kf, None
        P_cur, Q_cur = p[16:19], p[19:23]
        kf = self.g.keyframes[kf_index]
        if prev is not None and prev[0] != kf.t:
            P_cur, Q_cur = relo_keyframe_pose(P_cur, Q_cur, prev[1][1:4], prev[1][4:8],
                                              kf.P_vio, kf.Q_vio)
        self.g.update_keyframe_loop(kf_index, *relo_relative_pose(p[9:12], p[12:16], P_cur,
                                                                  Q_cur))

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
