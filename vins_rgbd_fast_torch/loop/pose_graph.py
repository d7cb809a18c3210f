"""Loop closure and the 4-DoF and 6-DoF pose graphs (twin of
``vins_rgbd_fast_tpu/loop/pose_graph.py``).

  * keyframe extraction: FAST-20 on the keyframe image through
    ``ops.fast.fast_nms`` (kernel K1 on the card), the ``max_kp`` strongest
    responses by a stable descending sort (JAX's exact top-k order: among
    equal scores the lower flat index first), BRIEF on them and on the VIO
    window points, the measured depth at each keypoint;
  * retrieval: a device tensor DB of int8 ±1 descriptor rows (keypoints and
    window points of each keyframe) that doubles its capacity up to
    ``max_keyframes`` and is compacted there (``_db_compact``), scored by
    one Hamming matmul per query (``db_query_all``: B stacked DBs, one query
    step at a time); recency exclusion and the two-peak acceptance on the
    host;
  * verification: Hamming matching and PnP RANSAC from the old keyframe's
    pose (``verify_loops_batch``; ``verify_loops_device`` gathers both sides
    on the device), the reference's gates on the host;
  * ``optimize_4dof``: dense Levenberg-Marquardt over (yaw, t) per node with
    closed-form edge Jacobians, every step on the device, for one problem or
    a batch of them;
  * ``optimize_6dof`` (VO mode, ``use_6dof``): dense LM over SE(3) nodes
    (t, quaternion), the reference's relative-pose edges, closed-form
    Jacobians over each edge's 12-dim local perturbation;
  * ``PoseGraph``: the host bookkeeping (drift, sequence alignment, fast
    relocalization feedback), numpy as in JAX, and the map's ``save`` and
    ``load`` (JAX's ``.npz`` layout, version 3: a map saved by either
    package loads in the other).

PnP's random draws are an input: ``PoseGraph(pnp_uniforms=...)`` maps a
keyframe index and a point count to (32, N) uniforms (the tests inject the
JAX package's ``PRNGKey(index)`` draws); by default one ``torch.Generator``
on the graph's device draws them.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import native
from ..models.camera import CameraModel
from ..ops import fast as fast_ops
from ..ops import ransac as ransac_ops
from ..ops.solver import cho_solve, cholesky_nan
from ..utils import quaternion as quat
from ..utils import quaternion_np as nq
from ..utils.timing import TRACER
from . import brief

log = logging.getLogger(__name__)

MIN_LOOP_NUM = 25  # keyframe.h:16
LOOP_YAW_MAX = 30.0
LOOP_T_MAX = 20.0
PNP_TRIALS = ransac_ops.PNP_TRIALS


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    max_keyframes: int = 4096  # retrieval capacity (the DB doubles up to this)
    max_pgo_nodes: int = 512  # dense-LM window (older loop nodes anchor it)
    max_kp: int = 192  # FAST-20 retrieval keypoints per keyframe
    max_wp: int = 96  # VIO window points per keyframe
    max_loops: int = 64
    fast_threshold: float = 20.0
    match_thresh: float = 80.0
    score_dist: float = 60.0  # Hamming radius counted as a "word hit"
    score_best: float = 0.14
    score_second: float = 0.05
    pg_iters: int = 10
    huber: float = 1.0
    recency_exclusion: int = 50
    min_loop_num: int = MIN_LOOP_NUM
    use_6dof: bool = False  # VO mode: the SE(3) graph
    pad_nodes_min: int = 8
    pad_edges_min: int = 8


class KeyFrameData(NamedTuple):
    """What the pose graph stores per keyframe: host numpy, except the
    descriptor sets, which may stay device tensors."""
    index: int
    t: float
    sequence: int
    P_vio: np.ndarray  # (3,)
    Q_vio: np.ndarray  # (4,)
    kp_uv: np.ndarray  # (max_kp, 2)
    kp_norm: np.ndarray  # (max_kp, 3): normalized x, y and the measured depth
    kp_valid: np.ndarray  # (max_kp,)
    kp_desc: object  # (max_kp, 256) int8
    wp_world: np.ndarray  # (max_wp, 3)
    wp_norm: np.ndarray  # (max_wp, 2)
    wp_valid: np.ndarray  # (max_wp,)
    wp_desc: object  # (max_wp, 256) int8


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _on(a, dtype, device) -> torch.Tensor:
    """A tensor on ``device`` (host arrays copied)."""
    return torch.as_tensor(a if isinstance(a, torch.Tensor) else np.array(a), dtype=dtype,
                           device=device)


# ---------------------------------------------------------------------------
# Keyframe extraction
# ---------------------------------------------------------------------------

def extract_kf_device(cfg: PoseGraphConfig, cam: CameraModel, imgs: torch.Tensor,
                      wp_uv: torch.Tensor, wp_valid: torch.Tensor,
                      depths: Optional[torch.Tensor] = None, n_real: Optional[int] = None):
    """Features of K keyframes (``_extract_kf_device`` under the vmap of
    JAX's ``make_batch_extractor``):
    imgs (K, H, W) float32, wp_uv (K, max_wp, 2), wp_valid (K, max_wp),
    depths (K, H, W) or None.  Returns kp_uv (K, max_kp, 2), kp_norm
    (K, max_kp, 3), kp_valid, kp_desc (K, max_kp, 256) int8 and wp_desc.
    One K1 launch covers all K images; BRIEF runs per keyframe, over the
    first ``n_real`` only when the rest are padding (their descriptors are
    zero)."""
    K, H, W = imgs.shape
    score = fast_ops.fast_nms(imgs.contiguous(), cfg.fast_threshold)  # K1 on the card
    vals, idx = torch.sort(score.reshape(K, H * W), dim=1, descending=True, stable=True)
    vals, idx = vals[:, :cfg.max_kp], idx[:, :cfg.max_kp]
    xs = (idx % W).to(imgs.dtype)
    ys = (idx // W).to(imgs.dtype)
    kp_uv = torch.stack([xs, ys], dim=-1)
    kp_valid = vals > 0
    n = K if n_real is None else int(n_real)
    pairs = [brief.compute_descriptors_pair(imgs[k], kp_uv[k], kp_valid[k], wp_uv[k],
                                            wp_valid[k]) for k in range(n)]
    if n < K:
        pad = tuple(torch.zeros_like(d) for d in pairs[0])
        pairs += [pad] * (K - n)
    kp_desc = torch.stack([p[0] for p in pairs])
    wp_desc = torch.stack([p[1] for p in pairs])
    rays = cam.lift(kp_uv)
    if depths is None:
        kp_z = torch.zeros_like(xs)
    else:
        xi = torch.clamp(torch.round(xs).to(torch.int64), 0, W - 1)
        yi = torch.clamp(torch.round(ys).to(torch.int64), 0, H - 1)
        kp_z = depths.reshape(K, H * W).gather(1, yi * W + xi)
    kp_norm = torch.cat([rays[..., :2], kp_z[..., None]], dim=-1)
    return kp_uv, kp_norm, kp_valid, kp_desc, wp_desc


def extract_keyframe_features(cfg: PoseGraphConfig, cam: CameraModel, img: torch.Tensor,
                              wp_world, wp_uv, wp_valid, depth=None):
    """One keyframe's features as host numpy arrays."""
    dev, dt = img.device, img.dtype
    out = extract_kf_device(
        cfg, cam, img[None], torch.as_tensor(np.asarray(wp_uv), dtype=dt, device=dev)[None],
        torch.as_tensor(np.asarray(wp_valid), dtype=torch.bool, device=dev)[None],
        None if depth is None else torch.as_tensor(depth, dtype=dt, device=dev)[None])
    return tuple(_host(o[0]) for o in out)


# ---------------------------------------------------------------------------
# Retrieval DB
# ---------------------------------------------------------------------------

def scores_one(db: torch.Tensor, dbv: torch.Tensor, q: torch.Tensor, qv: torch.Tensor,
               score_dist: float) -> torch.Tensor:
    """Retrieval scores (cap,) of one query keyframe: the share of its valid
    descriptors whose best Hamming match in a stored row is under
    ``score_dist``."""
    cap, width, _ = db.shape
    D = brief.hamming_matrix(q, db.reshape(-1, brief.N_BITS)).reshape(q.shape[0], cap, width)
    D = torch.where(dbv[None], D, torch.full_like(D, torch.inf))
    hits = (torch.amin(D, dim=2) < score_dist) & qv[:, None]
    n = torch.clamp(torch.sum(qv), min=1)
    return (torch.sum(hits, dim=0).to(torch.float64) / n).to(torch.float32)


def db_query(db, dbv, q, qv, n_old: int, score_dist: float) -> torch.Tensor:
    """Scores per stored slot; slots >= ``n_old`` read -1."""
    s = scores_one(db, dbv, q, qv, score_dist)
    return torch.where(torch.arange(db.shape[0], device=db.device) < n_old, s,
                       torch.full_like(s, -1.0))


def db_query_multi(db, dbv, qs, qvs, score_dist: float) -> torch.Tensor:
    """(K, cap) raw scores of K queries, one after another."""
    return torch.stack([scores_one(db, dbv, qs[k], qvs[k], score_dist)
                        for k in range(qs.shape[0])])


def db_query_all(dbs, dbvs, qs, qvs, score_dist: float) -> torch.Tensor:
    """Cross-sequence retrieval (JAX's ``_db_query_all``): B stacked DBs
    (B, cap, width, 256) int8 against (B, qp, Nq, 256) queries, (B, qp, cap)
    raw scores.  One query step at a time (a step's Hamming intermediate is
    B × Nq × cap·width floats), each a batched matmul over the B DBs."""
    B, cap, width, _ = dbs.shape
    dbf = dbs.reshape(B, cap * width, brief.N_BITS).to(torch.float32).transpose(1, 2)
    qvs = qvs.to(torch.bool)
    n = torch.clamp(torch.sum(qvs, dim=-1), min=1).to(torch.float64)  # (B, qp)
    out = []
    for j in range(qs.shape[1]):
        D = ((brief.N_BITS - qs[:, j].to(torch.float32) @ dbf) * 0.5).reshape(
            B, -1, cap, width)
        D = torch.where(dbvs[:, None], D, torch.full_like(D, torch.inf))
        hits = (torch.amin(D, dim=3) < score_dist) & qvs[:, j, :, None]
        out.append((torch.sum(hits, dim=1).to(torch.float64) / n[:, j, None]).to(torch.float32))
    return torch.stack(out, dim=1)


def combine_db_rows(kp_desc, kp_valid, kp_norm, wp_desc, wp_valid, wp_norm):
    """A keyframe's DB row: its retrieval keypoints and its window points
    concatenated (descriptors, valid, normalized xy + depth; a 2-column
    norm gets a zero depth).  numpy or tensors, with or without a leading
    K axis."""
    if isinstance(kp_desc, torch.Tensor):
        cat, zeros = torch.cat, (lambda s, a: torch.zeros(s, dtype=a.dtype, device=a.device))
    else:
        cat, zeros = np.concatenate, (lambda s, a: np.zeros(s, a.dtype))

    def norm3(n):
        return n if n.shape[-1] == 3 else cat([n, zeros(n.shape[:-1] + (1,), n)], -1)

    return (cat([kp_desc, wp_desc], -2), cat([kp_valid, wp_valid], -1),
            cat([norm3(kp_norm), norm3(wp_norm)], -2))


def combined_old_rows(kf: KeyFrameData, device):
    """A stored keyframe's DB row (descriptors, valid, norm3) as tensors on
    ``device``: the old side every loop check matches against (JAX's
    ``combined_old_host``; the port keeps the descriptors on the device)."""
    i8, b, f32 = torch.int8, torch.bool, torch.float32
    return combine_db_rows(_on(kf.kp_desc, i8, device), _on(kf.kp_valid, b, device),
                           _on(kf.kp_norm, f32, device), _on(kf.wp_desc, i8, device),
                           _on(kf.wp_valid, b, device), _on(kf.wp_norm, f32, device))


def verify_loops_batch(u, wp_world, wp_desc, wp_valid, kp_desc, kp_valid, kp_norm,
                       R_init, t_init, match_thresh: float, min_loop_num: int):
    """Hamming match + PnP RANSAC of C loop candidates: the current
    keyframes' window points (C, max_wp, ...) against the old keyframes'
    rows (C, P, ...); ``u`` (C, 32, max_wp) PnP uniforms.  Returns (idx_b,
    ok, model (C, 3, 4), n_inliers, inliers)."""
    idx_b, ok = brief.match(wp_desc, kp_desc, wp_valid, kp_valid, max_dist=match_thresh)
    kn = torch.gather(kp_norm, 1, idx_b[..., None].expand(-1, -1, kp_norm.shape[-1]))
    res = ransac_ops.pnp_ransac_guess(u, wp_world, kn, ok, R_init, t_init,
                                      threshold=10.0 / 460.0, min_inliers=min_loop_num)
    enough = torch.sum(ok, -1) >= min_loop_num
    return idx_b, res.ok & enough, res.model, res.n_inliers, res.inliers


def _verify_row(u, wp_world, wp_desc, wp_valid, kp_desc, kp_valid, kp_norm, R_init, t_init,
                match_thresh: float, min_loop_num: int) -> torch.Tensor:
    """One candidate's ``verify_loops_batch`` as one row: the match index
    per window point (n), ok, the model (12), the inlier count, the inlier
    mask (n)."""
    f32 = torch.float32
    idx_b, ok, model, ninl, inl = verify_loops_batch(u, wp_world, wp_desc, wp_valid, kp_desc,
                                                     kp_valid, kp_norm, R_init, t_init,
                                                     match_thresh, min_loop_num)
    return torch.cat([idx_b[0].to(f32), ok.to(f32), model[0].reshape(-1), ninl.to(f32),
                      inl[0].to(f32)])


class _Replayed:
    """``fn`` over CUDA tensors, run once eagerly on a side stream (its
    warm-up), then captured as a CUDA graph; each call copies its inputs
    into the graph's slots, replays it on the current stream and returns
    its output, which the next call overwrites."""

    def __init__(self, fn, inputs):
        TRACER.count("program::captures")
        with TRACER.span("program::capture"):
            self.slots = [x.clone() for x in inputs]
            side = torch.cuda.Stream(inputs[0].device)
            side.wait_stream(torch.cuda.current_stream())
            with TRACER.span("program::warm"), torch.cuda.stream(side):
                fn(*self.slots)
            torch.cuda.current_stream().wait_stream(side)
            out = []
            with TRACER.span("program::record"):
                self.cap = native.capture(lambda: out.append(fn(*self.slots)), side)
            self.out = out[0]

    def __call__(self, inputs) -> torch.Tensor:
        for s, x in zip(self.slots, inputs):
            s.copy_(x)
        self.cap.replay()
        return self.out


def verify_row(inputs, match_thresh: float, min_loop_num: int,
               programs: dict) -> torch.Tensor:
    """``_verify_row`` of ``inputs``; on CUDA replayed from a graph in
    ``programs``, captured at the calling thread's first check of a layout
    (the check dispatches ~4 k small ops, which a loop stager's worker would
    pay for with its latency; one graph per thread, so no two threads share
    its slots)."""
    fn = functools.partial(_verify_row, match_thresh=match_thresh, min_loop_num=min_loop_num)
    if inputs[0].device.type != "cuda":
        return fn(*inputs)
    key = (threading.get_ident(), tuple((x.shape, x.dtype) for x in inputs), match_thresh,
           min_loop_num)
    prog = programs.get(key)
    if prog is None:
        prog = programs[key] = _Replayed(fn, inputs)
    return prog(inputs)


def verify_loops_device(u, ints, flts, wld_chunk, wd_chunk, wv_chunk, dbs, dbvs, dbns,
                        match_thresh: float, min_loop_num: int):
    """``verify_loops_batch`` with both sides gathered on the device: the
    current keyframes' window points from an extraction chunk's tensors by
    row, the old keyframes' rows from the stacked DBs by (sequence, slot).
    ``ints`` (C, 4): [keyframe index, sequence b, DB slot, chunk row];
    ``flts`` (C, 24): [R_init (9), t_init (3), w_r (9), w_t (3)], w_r/w_t
    mapping the chunk's landmarks into the graph's map frame; ``u``
    (C, 32, max_wp) PnP uniforms (the keyframe index column is JAX's PRNG
    seed and unused here)."""
    b, s, row = ints[:, 1].long(), ints[:, 2].long(), ints[:, 3].long()
    C = ints.shape[0]
    w_r = flts[:, 12:21].reshape(C, 3, 3)
    wl = wld_chunk[row] @ w_r.transpose(-1, -2) + flts[:, None, 21:24]
    return verify_loops_batch(u, wl, wd_chunk[row], wv_chunk[row], dbs[b, s], dbvs[b, s],
                              dbns[b, s], flts[:, 0:9].reshape(C, 3, 3), flts[:, 9:12],
                              match_thresh, min_loop_num)


# ---------------------------------------------------------------------------
# 4-DoF pose graph optimization
# ---------------------------------------------------------------------------

def normalize_angle_deg(a):
    return a - 360.0 * torch.floor((a + 180.0) / 360.0)


def _edge_terms(yaw, t, pitch, roll, ei, ej, rel_t, rel_yaw, with_jac: bool):
    """Residuals (..., E, 4) of the FourDOF edges (translation of j in frame
    i by yaw_i and i's fixed pitch/roll; the wrapped yaw difference over 10)
    and, with ``with_jac``, their Jacobians (..., E, 4, 8) over [yaw_i, t_i,
    yaw_j, t_j] (yaw in degrees).  Leading axes are a batch of problems."""
    def at(a, idx):  # a (..., K[, 3]) gathered at idx (..., E)
        if a.dim() == idx.dim():
            return torch.gather(a, -1, idx)
        return torch.gather(a, -2, idx[..., None].expand(idx.shape + a.shape[-1:]))

    R = quat.ypr2R(torch.stack([at(yaw, ei), at(pitch, ei), at(roll, ei)], dim=-1))
    dt = at(t, ej) - at(t, ei)
    RT = R.transpose(-1, -2)
    r_t = (RT @ dt[..., None])[..., 0] - rel_t
    r_y = normalize_angle_deg(at(yaw, ej) - at(yaw, ei) - rel_yaw) * 0.1
    r = torch.cat([r_t, r_y[..., None]], dim=-1)
    if not with_jac:
        return r, None
    # d R / d yaw (degrees): rows 0 and 1 of Rz'(y) Ry Rx, row 2 constant
    dR = torch.stack([-R[..., 1, :], R[..., 0, :], torch.zeros_like(R[..., 0, :])],
                     dim=-2) * (np.pi / 180.0)
    J = torch.zeros(ei.shape + (4, 8), dtype=t.dtype, device=t.device)
    J[..., :3, 0] = (dR.transpose(-1, -2) @ dt[..., None])[..., 0]
    J[..., :3, 1:4] = -RT
    J[..., :3, 5:8] = RT
    J[..., 3, 0] = -0.1
    J[..., 3, 4] = 0.1
    return r, J


def optimize_4dof(yaw0, t0, pitch, roll, node_valid, node_fixed, edge_i, edge_j,
                  edge_rel_t, edge_rel_yaw, edge_is_loop, edge_valid,
                  iters: int = 5, huber: float = 0.1):
    """Dense LM over (yaw, t) of K nodes (node k's parameters at [4k, 4k+4)),
    Huber on loop edges, fixed nodes frozen; ``iters`` damped steps with
    accept/reject on the device.  Returns (yaw, t, cost0, cost).  Every
    argument may carry one leading batch axis: N problems of the same
    (K, E) solve together (batched Cholesky), each with its own damping and
    accept/reject (JAX's ``jax.vmap`` of the solve).  (JAX's
    ``edge_weight`` argument is unused there and left out here.)"""
    if yaw0.dim() == 1:
        out = optimize_4dof(*(a[None] for a in (yaw0, t0, pitch, roll, node_valid, node_fixed,
                                                edge_i, edge_j, edge_rel_t, edge_rel_yaw,
                                                edge_is_loop, edge_valid)),
                            iters=iters, huber=huber)
        return tuple(o[0] for o in out)
    N, K = yaw0.shape
    dtype = t0.dtype
    ei, ej = edge_i.to(torch.int64), edge_j.to(torch.int64)
    nodes = torch.arange(K, device=ei.device)
    Pi = (ei[..., None] == nodes).to(dtype)  # (N, E, K)
    Pj = (ej[..., None] == nodes).to(dtype)

    def robust(r):
        s = torch.sum(r * r, dim=-1)
        hw = torch.where(edge_is_loop & (s > huber * huber),
                         torch.sqrt(huber / torch.clamp(torch.sqrt(s), min=1e-12)),
                         torch.ones_like(s))
        return torch.where(edge_valid, hw, torch.zeros_like(hw))

    def cost_at(yaw, t):
        r, _ = _edge_terms(yaw, t, pitch, roll, ei, ej, edge_rel_t, edge_rel_yaw, False)
        r = r * robust(r)[..., None]
        return 0.5 * torch.sum(r * r, dim=(-2, -1))

    def system(yaw, t):
        r, Jl = _edge_terms(yaw, t, pitch, roll, ei, ej, edge_rel_t, edge_rel_yaw, True)
        hw = robust(r)
        r = r * hw[..., None]
        Jl = Jl * hw[..., None, None]
        rows = (Jl[..., :, None, 0:4] * Pi[..., None, :, None]
                + Jl[..., :, None, 4:8] * Pj[..., None, :, None])
        return r.reshape(N, -1), rows.reshape(N, -1, 4 * K)

    fm = torch.repeat_interleave((node_valid & ~node_fixed).to(dtype), 4, dim=-1)  # (N, 4K)
    eye = torch.eye(4 * K, dtype=dtype, device=t0.device)
    yaw, t = yaw0, t0
    lm = torch.full((N,), 1e-4, dtype=dtype, device=t0.device)
    cost0 = cost = cost_at(yaw, t)
    for _ in range(iters):
        r, J = system(yaw, t)
        J = J * fm[:, None, :]
        JT = J.transpose(-1, -2)
        H = JT @ J
        g = JT @ r[..., None]
        damp = lm[:, None] * torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-6) \
            + (1.0 - fm)
        L = cholesky_nan(H + damp[..., None] * eye)
        d = (-cho_solve(L, g)[..., 0] * fm).reshape(N, K, 4)
        yaw_n = normalize_angle_deg(yaw + d[..., 0])
        t_n = t + d[..., 1:4]
        new_cost = cost_at(yaw_n, t_n)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        yaw = torch.where(accept[:, None], yaw_n, yaw)
        t = torch.where(accept[:, None, None], t_n, t)
        lm = torch.where(accept, lm * 0.3, lm * 5.0)
        cost = torch.where(accept, new_cost, cost)
    return yaw, t, cost0, cost


# ---------------------------------------------------------------------------
# 6-DoF pose graph optimization (VO mode)
# ---------------------------------------------------------------------------

def _edges_6dof(t, q, ei, ej, rel_t, rel_q, t_var: float, q_var: float, with_jac: bool):
    """Residuals (E, 6) of the relative-pose edges (translation of j in
    frame i over ``t_var``; 2·vec(rel_q⁻¹ ⊗ q_i⁻¹ ⊗ q_j) over ``q_var``)
    and, with ``with_jac``, their Jacobians (E, 6, 12) over the local
    perturbation [δt_i, δθ_i, δt_j, δθ_j] (q ⊞ δθ = q ⊗ [1, δθ/2]): the
    closed form of JAX's ``jacfwd`` at 0."""
    ti, qi, tj, qj = t[ei], q[ei], t[ej], q[ej]
    t_ij = quat.qrot_inv(qi, tj - ti)
    b = quat.qmul(quat.qconj(qi), qj)
    a = quat.qconj(rel_q)
    e = quat.qmul(a, b)
    r = torch.cat([(t_ij - rel_t) / t_var, 2.0 * e[..., 1:4] / q_var], dim=-1)
    if not with_jac:
        return r, None
    RiT = quat.q2R(qi).transpose(-1, -2)
    J = torch.zeros(ei.shape + (6, 12), dtype=t.dtype, device=t.device)
    J[..., :3, 0:3] = -RiT / t_var
    J[..., :3, 3:6] = quat.skew(t_ij) / t_var
    J[..., :3, 6:9] = RiT / t_var
    # q_i ⊞ δ: e -> a ⊗ [1, -δ/2] ⊗ b; q_j ⊞ δ: e -> e ⊗ [1, δ/2]
    J[..., 3:, 3:6] = -(quat.qleft(a) @ quat.qright(b))[..., 1:4, 1:4] / q_var
    J[..., 3:, 9:12] = quat.qleft(e)[..., 1:4, 1:4] / q_var
    return r, J


def optimize_6dof(t0, q0, node_valid, node_fixed, edge_i, edge_j, edge_rel_t, edge_rel_q,
                  edge_is_loop, edge_valid, iters: int = 5, huber: float = 0.1,
                  t_var: float = 0.1, q_var: float = 0.01):
    """Dense LM over the SE(3) poses of K nodes, t0 (K, 3) and q0 (K, 4)
    wxyz (node k's tangent at [6k, 6k+6): δt then δθ), Huber on loop edges,
    fixed nodes frozen; ``iters`` damped steps with accept/reject on the
    device.  The normal equations are JᵀJ of the dense edge rows, each edge
    block placed by one-hot products (no indexed stores: node indices
    repeat).  Returns (t, q, cost0, cost)."""
    K = t0.shape[0]
    dtype = t0.dtype
    ei, ej = edge_i.to(torch.int64), edge_j.to(torch.int64)
    nodes = torch.arange(K, device=ei.device)
    Pi = (ei[:, None] == nodes).to(dtype)  # (E, K)
    Pj = (ej[:, None] == nodes).to(dtype)

    def weighted(t, q, with_jac):
        r, Jl = _edges_6dof(t, q, ei, ej, edge_rel_t, edge_rel_q, t_var, q_var, with_jac)
        s = torch.sum(r * r, dim=-1)
        hw = torch.where(edge_is_loop & (s > huber * huber),
                         torch.sqrt(huber / torch.clamp(torch.sqrt(s), min=1e-12)),
                         torch.ones_like(s))
        hw = torch.where(edge_valid, hw, torch.zeros_like(hw))
        return r * hw[:, None], None if Jl is None else Jl * hw[:, None, None]

    def cost_at(t, q):
        r, _ = weighted(t, q, False)
        return 0.5 * torch.sum(r * r)

    fm = torch.repeat_interleave((node_valid & ~node_fixed).to(dtype), 6)  # (6K,)
    eye = torch.eye(6 * K, dtype=dtype, device=t0.device)
    t, q = t0, q0
    lm = torch.full((), 1e-4, dtype=dtype, device=t0.device)
    cost0 = cost = cost_at(t, q)
    for _ in range(iters):
        r, Jl = weighted(t, q, True)
        rows = (Jl[:, :, None, 0:6] * Pi[:, None, :, None]
                + Jl[:, :, None, 6:12] * Pj[:, None, :, None]).reshape(-1, 6 * K) * fm
        H = rows.T @ rows
        g = rows.T @ r.reshape(-1, 1)
        damp = lm * torch.clamp(torch.diagonal(H), min=1e-6) + (1.0 - fm)
        L = cholesky_nan(H + damp[:, None] * eye)
        d = (-cho_solve(L, g)[:, 0] * fm).reshape(K, 6)
        t_n = t + d[:, 0:3]
        q_n = quat.qboxplus(q, d[:, 3:6])
        new_cost = cost_at(t_n, q_n)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        t = torch.where(accept, t_n, t)
        q = torch.where(accept, q_n, q)
        lm = torch.where(accept, lm * 0.3, lm * 5.0)
        cost = torch.where(accept, new_cost, cost)
    return t, q, cost0, cost


# ---------------------------------------------------------------------------
# PoseGraph host class
# ---------------------------------------------------------------------------

class KeyframeGate:
    """The pose graph's keyframe admission (``pose_graph_nodelet.cpp:501,
    522``): keyframes only, every ``skip_cnt``-th, ``skip_dis`` apart."""

    def __init__(self, skip_cnt: int = 0, skip_dis: float = 0.0):
        self.skip_cnt = skip_cnt
        self.skip_dis = skip_dis
        self._count = 0
        self._anchor: Optional[np.ndarray] = None

    def admit(self, is_kf: bool, P: np.ndarray) -> bool:
        if not is_kf:
            return False
        if self.skip_cnt > 0:
            self._count += 1
            if self._count < self.skip_cnt:
                return False
            self._count = 0
        if (self._anchor is not None and self.skip_dis > 0
                and np.linalg.norm(P - self._anchor) < self.skip_dis):
            return False
        self._anchor = P
        return True


def relo_relative_pose(P_relo, Q_relo, P_cur, Q_cur):
    """The refined loop-relative pose (rel_t, rel_q, rel_yaw) from the
    solve's relo pose and the relocalized keyframe's pose (the reference's
    relo_relative_t/q/yaw, ``estimator.cpp:1034-1057``)."""
    P_relo, Q_relo, P_cur, Q_cur = (np.asarray(a, np.float64)
                                    for a in (P_relo, Q_relo, P_cur, Q_cur))
    R_relo = nq.q2R(Q_relo)
    rel_yaw = float(nq.normalize_angle_deg(float(nq.R2ypr(nq.q2R(Q_cur))[0])
                                           - float(nq.R2ypr(R_relo)[0])))
    return R_relo.T @ (P_cur - P_relo), nq.qmul(nq.qconj(Q_relo), Q_cur), rel_yaw


def relo_keyframe_pose(P_cur, Q_cur, P_prev, Q_prev, P_kf, Q_kf):
    """The relocalized keyframe's pose in the frame of a later solve.  The
    solve returns its relo pose beside its pose of the window's
    second-newest frame, ``(P_cur, Q_cur)``: the frame before the solve's,
    which is the keyframe only when the constraint reached the frame right
    after it.  That frame's own output ``(P_prev, Q_prev)`` and the
    keyframe's ``(P_kf, Q_kf)`` give the odometry between them, which
    carries the solve's pose back to the keyframe."""
    P_cur, Q_cur, P_prev, Q_prev, P_kf, Q_kf = (
        np.asarray(a, np.float64) for a in (P_cur, Q_cur, P_prev, Q_prev, P_kf, Q_kf))
    dQ = nq.qmul(Q_cur, nq.qconj(Q_prev))
    Q = nq.qmul(dQ, Q_kf)
    return P_cur + nq.q2R(dQ) @ (P_kf - P_prev), Q / np.linalg.norm(Q)


class PoseGraph:
    """Keyframes, retrieval, loops and optimization on one device."""

    def __init__(self, cfg: PoseGraphConfig, cam: CameraModel, ric, tic, device,
                 dtype=torch.float32, pnp_uniforms: Optional[Callable] = None):
        self.cfg = cfg
        self.cam = cam
        self.ric = np.asarray(ric, np.float64)
        self.tic = np.asarray(tic, np.float64)
        self.device = torch.device(device)
        self.dtype = dtype
        self._pnp_uniforms = pnp_uniforms
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        self._verify_programs: dict = {}  # the loop check's graphs on CUDA (``verify_row``)
        self.keyframes: list = []
        self._dev_db: Optional[torch.Tensor] = None  # (cap, width, 256) int8
        self._dev_valid: Optional[torch.Tensor] = None  # (cap, width) bool
        self._dev_norm: Optional[torch.Tensor] = None  # (cap, width, 3) f32
        self._db_size = 0
        self._db_index = np.zeros(0, np.int64)  # slot -> keyframe index
        self.db_evicted = 0
        self.loops: list = []
        self.earliest_loop_index: Optional[int] = None
        self.sequence = 1
        self.yaw_drift = 0.0  # corrected = yaw_R(yaw_drift) @ vio + t_drift
        self.t_drift = np.zeros(3)
        self.corrected: dict = {}
        self.w_r_vio = np.eye(3)  # vio -> map alignment of the live sequence
        self.w_t_vio = np.zeros(3)
        self.sequence_aligned = {0: True, 1: False}
        self.n_solves_6dof = 0  # 6-DoF LM solves run (diagnostics)

    # ------------------------------------------------------------------
    def clone(self) -> "PoseGraph":
        """A copy sharing no mutable state (the DB tensors are copied)."""
        g = PoseGraph(self.cfg, self.cam, self.ric, self.tic, self.device, self.dtype,
                      self._pnp_uniforms)
        g._gen.set_state(self._gen.get_state())
        g._verify_programs = self._verify_programs  # graphs of the loop check, per thread
        g.keyframes = list(self.keyframes)
        if self._dev_db is not None:
            g._dev_db = self._dev_db.clone()
            g._dev_valid = self._dev_valid.clone()
            g._dev_norm = self._dev_norm.clone()
        g._db_size = self._db_size
        g._db_index = self._db_index.copy()
        g.db_evicted = self.db_evicted
        g.loops = [dict(lp) for lp in self.loops]
        g.earliest_loop_index = self.earliest_loop_index
        g.sequence = self.sequence
        g.yaw_drift = self.yaw_drift
        g.t_drift = self.t_drift.copy()
        g.corrected = dict(self.corrected)
        g.w_r_vio = self.w_r_vio.copy()
        g.w_t_vio = self.w_t_vio.copy()
        g.sequence_aligned = dict(self.sequence_aligned)
        g.n_solves_6dof = self.n_solves_6dof
        return g

    def pnp_uniforms(self, index: int, n: int) -> torch.Tensor:
        """(32, n) PnP uniforms for the loop check of keyframe ``index``."""
        if self._pnp_uniforms is not None:
            u = self._pnp_uniforms(index, n)
            return torch.as_tensor(u if isinstance(u, torch.Tensor) else np.array(u),
                                   device=self.device)
        return torch.rand((PNP_TRIALS, n), generator=self._gen, device=self.device,
                          dtype=self.dtype)

    def _tensor(self, a, dtype) -> torch.Tensor:
        return _on(a, dtype, self.device)

    # ------------------------------------------------------------------
    @property
    def desc_db(self) -> Optional[np.ndarray]:
        """Host copy of the filled part of the DB (diagnostics and tests)."""
        if self._dev_db is None or self._db_size == 0:
            return None
        return _host(self._dev_db[:self._db_size])

    def _ensure_capacity(self, n_needed: int, like_shape):
        """Grow the DB (doubling, at least 64 slots) to ``n_needed`` slots,
        and widen its rows to ``like_shape[0]`` points (new columns invalid)."""
        n_needed = min(n_needed, self.cfg.max_keyframes)
        cap_now = 0 if self._dev_db is None else self._dev_db.shape[0]
        width_now = 0 if self._dev_db is None else self._dev_db.shape[1]
        width = max(int(like_shape[0]), width_now)
        if n_needed <= cap_now and width == width_now:
            return
        cap = max(64, cap_now)
        while cap < n_needed:
            cap *= 2
        cap = min(cap, self.cfg.max_keyframes)
        dev = self.device
        db = torch.zeros((cap, width, brief.N_BITS), dtype=torch.int8, device=dev)
        dbv = torch.zeros((cap, width), dtype=torch.bool, device=dev)
        dbn = torch.zeros((cap, width, 3), dtype=torch.float32, device=dev)
        if self._dev_db is not None:
            n = self._db_size
            db[:n, :width_now] = self._dev_db[:n]
            dbv[:n, :width_now] = self._dev_valid[:n]
            dbn[:n, :width_now] = self._dev_norm[:n]
        self._dev_db, self._dev_valid, self._dev_norm = db, dbv, dbn

    def _pad_row_width(self, desc, valid, norm):
        """Pad (…, P, ·) rows to the DB's row width with invalid points."""
        width = self._dev_db.shape[1] if self._dev_db is not None else None
        if width is None or desc.shape[-2] >= width:
            return desc, valid, norm
        pad = width - desc.shape[-2]

        def z(shape, a):
            return torch.zeros(shape, dtype=a.dtype, device=a.device)

        return (torch.cat([desc, z(desc.shape[:-2] + (pad, brief.N_BITS), desc)], -2),
                torch.cat([valid, z(valid.shape[:-1] + (pad,), valid)], -1),
                torch.cat([norm, z(norm.shape[:-2] + (pad, norm.shape[-1]), norm)], -2))

    def _norm3(self, norm, lead) -> torch.Tensor:
        if norm is None:
            return torch.zeros(lead + (3,), dtype=torch.float32, device=self.device)
        norm = self._tensor(norm, torch.float32)
        if norm.shape[-1] == 2:  # no depth channel
            norm = torch.cat([norm, torch.zeros_like(norm[..., :1])], -1)
        return norm

    def _db_append(self, desc, valid=None, norm=None, kf_index: Optional[int] = None):
        if self._db_size >= self.cfg.max_keyframes:
            self._db_compact()
        if self._db_size >= self.cfg.max_keyframes:
            # nothing could be evicted (loop-protected rows cover the older
            # half): refuse rather than overwrite a slot
            log.warning("pose-graph retrieval DB full (max_keyframes=%d) and uncompactable: "
                        "keyframe %s not added to retrieval", self.cfg.max_keyframes, kf_index)
            return
        desc = self._tensor(desc, torch.int8)
        valid = (torch.any(desc != 0, dim=-1) if valid is None
                 else self._tensor(valid, torch.bool))
        norm = self._norm3(norm, tuple(desc.shape[:-1]))
        self._ensure_capacity(self._db_size + 1, tuple(desc.shape))
        desc, valid, norm = self._pad_row_width(desc, valid, norm)
        s = self._db_size
        self._dev_db[s] = desc
        self._dev_valid[s] = valid
        self._dev_norm[s] = norm
        idx = self._next_db_index() if kf_index is None else int(kf_index)
        self._db_index = np.append(self._db_index, idx)
        self._db_size += 1

    def _next_db_index(self) -> int:
        return int(self._db_index[-1]) + 1 if len(self._db_index) else 0

    def _db_compact(self):
        """At the storage cap: keep the loop-involved keyframes and the newest
        half, every second of the older half (one device gather; the slot ->
        keyframe index map follows).  The keyframes themselves stay; only
        their retrieval candidacy thins."""
        n = self._db_size
        if n < 4:
            return
        half = n // 2
        keep = np.zeros(n, bool)
        keep[half:] = True
        keep[:half:2] = True
        looped = {lp["old"] for lp in self.loops} | {lp["cur"] for lp in self.loops}
        if looped:
            keep |= np.isin(self._db_index[:n], np.fromiter(looped, np.int64))
        slots = np.nonzero(keep)[0]
        k = len(slots)
        if k >= n:  # nothing evictable
            return
        sl = torch.as_tensor(slots, device=self.device)

        def gathered(a):
            out = torch.zeros_like(a)
            out[:k] = a[sl]
            return out

        self._dev_db, self._dev_valid, self._dev_norm = (
            gathered(self._dev_db), gathered(self._dev_valid), gathered(self._dev_norm))
        self._db_index = self._db_index[slots]
        self.db_evicted += n - k
        self._db_size = k
        log.warning("pose-graph retrieval DB hit max_keyframes=%d: compacted to %d slots (%d "
                    "evicted in all); raise PoseGraphConfig.max_keyframes to keep every "
                    "keyframe a candidate", self.cfg.max_keyframes, k, self.db_evicted)

    def _db_append_block(self, descs, valids, count: Optional[int] = None, norms=None,
                         kf_indices=None):
        """Append K rows at once (``count`` of them real; padding rows are
        written and then overwritten by the next append).  At the cap the DB
        is compacted first; rows that still do not fit are dropped from
        retrieval with a warning, the kept ones mapped to their own
        keyframes (``kf_indices``)."""
        descs = self._tensor(descs, torch.int8)
        valids = self._tensor(valids, torch.bool)
        norms = self._norm3(norms, tuple(descs.shape[:2]))
        n = int(descs.shape[0]) if count is None else int(count)
        if self._db_size + n > self.cfg.max_keyframes:
            self._db_compact()
        k = min(n, self.cfg.max_keyframes - self._db_size)
        if k <= 0:
            log.warning("pose-graph retrieval DB full (max_keyframes=%d) and uncompactable: "
                        "%d keyframes not added to retrieval", self.cfg.max_keyframes, n)
            return
        if k < n:
            log.warning("pose-graph retrieval DB near its cap: dropping %d of %d keyframes "
                        "from retrieval candidacy", n - k, n)
        if self._db_size + int(descs.shape[0]) > self.cfg.max_keyframes:
            descs, valids, norms = descs[:k], valids[:k], norms[:k]
        self._ensure_capacity(self._db_size + int(descs.shape[0]), tuple(descs.shape[1:]))
        descs, valids, norms = self._pad_row_width(descs, valids, norms)
        s, m = self._db_size, int(descs.shape[0])
        self._dev_db[s:s + m] = descs
        self._dev_valid[s:s + m] = valids
        self._dev_norm[s:s + m] = norms
        if kf_indices is not None:
            new_idx = np.asarray(kf_indices, np.int64)[:k]
        else:
            start = self._next_db_index()
            new_idx = np.arange(start, start + k)
        self._db_index = np.append(self._db_index, new_idx)
        self._db_size += k

    def detect_scores_batch(self, descs, valids) -> Optional[np.ndarray]:
        """(K, cap) raw scores of K queries against the DB; None if empty."""
        if self._dev_db is None or self._db_size == 0:
            return None
        return _host(db_query_multi(self._dev_db, self._dev_valid,
                                    self._tensor(descs, torch.int8),
                                    self._tensor(valids, torch.bool),
                                    float(self.cfg.score_dist)))

    # ------------------------------------------------------------------
    def _r_drift(self) -> np.ndarray:
        return nq.yaw_R(self.yaw_drift)

    def apply_drift(self, P, Q):
        """A live VIO pose corrected by the current drift."""
        R = self._r_drift()
        return R @ np.asarray(P) + self.t_drift, nq.qmul(nq.R2q(R), np.asarray(Q))

    def new_sequence(self):
        """Stream discontinuity: a new sequence (at most 5), alignment and
        drift reset."""
        if self.sequence >= 5:
            return
        self.sequence += 1
        self.sequence_aligned[self.sequence] = False
        self.w_r_vio = np.eye(3)
        self.w_t_vio = np.zeros(3)
        self.yaw_drift = 0.0
        self.t_drift = np.zeros(3)

    # ------------------------------------------------------------------
    def add_keyframe(self, img, t: float, P_vio, Q_vio, wp_world, wp_uv, wp_norm, wp_valid,
                     detect_loop: bool = True, depth=None) -> Optional[dict]:
        """Extract a keyframe from its image (and depth), query, verify,
        optimize; returns the loop's info dict if one was accepted."""
        img = self._tensor(img, self.dtype)
        kp_uv, kp_norm, kp_valid, kp_desc, wp_desc = extract_keyframe_features(
            self.cfg, self.cam, img, wp_world, wp_uv, wp_valid, depth=depth)
        return self.add_keyframe_extracted(t, P_vio, Q_vio, wp_world, wp_norm, wp_valid,
                                           kp_uv, kp_norm, kp_valid, kp_desc, wp_desc,
                                           detect_loop=detect_loop)

    def add_keyframe_extracted(self, t: float, P_vio, Q_vio, wp_world, wp_norm, wp_valid,
                               kp_uv, kp_norm, kp_valid, kp_desc, wp_desc,
                               detect_loop: bool = True, scores=None, append_db: bool = True,
                               optimize_now: bool = True) -> Optional[dict]:
        """``add_keyframe`` with the features extracted.  ``scores``: raw
        retrieval scores over the DB already computed (``detect_scores_batch``);
        ``append_db=False`` leaves the DB append to the caller
        (``_db_append_block``); ``optimize_now=False`` leaves the PGO to the
        caller (the reference's optimize4DoF thread wakes every 2 s,
        ``pose_graph.cpp:410-581``)."""
        kf, cand = self.insert_keyframe(t, P_vio, Q_vio, wp_world, wp_norm, wp_valid,
                                        kp_uv, kp_norm, kp_valid, kp_desc, wp_desc,
                                        detect_loop=detect_loop, scores=scores)
        loop_info = None
        if cand is not None:
            loop_info = self._find_connection(kf, self.keyframes[cand])
            if loop_info is not None:
                self.accept_loop(kf, cand, loop_info)
        if append_db:
            self._db_append(*combined_old_rows(kf, self.device), kf_index=kf.index)
        if loop_info is not None and optimize_now:
            self.optimize()
        return loop_info

    def insert_keyframe(self, t: float, P_vio, Q_vio, wp_world, wp_norm, wp_valid,
                        kp_uv, kp_norm, kp_valid, kp_desc, wp_desc, detect_loop: bool = True,
                        scores=None):
        """Map the VIO pose and landmarks into the map frame, store the
        keyframe, extend the corrected path; returns (kf, candidate or None)
        from retrieval.  Descriptor tensors stay on the device."""
        idx = len(self.keyframes)
        P_vio = self.w_r_vio @ np.asarray(P_vio) + self.w_t_vio
        Q_vio = nq.qmul(nq.R2q(self.w_r_vio), np.asarray(Q_vio))
        wp_world = _host(wp_world) @ self.w_r_vio.T + self.w_t_vio

        def keep(a):
            return a if isinstance(a, torch.Tensor) else np.asarray(a)

        kf = KeyFrameData(index=idx, t=t, sequence=self.sequence, P_vio=np.asarray(P_vio),
                          Q_vio=np.asarray(Q_vio), kp_uv=_host(kp_uv), kp_norm=_host(kp_norm),
                          kp_valid=_host(kp_valid), kp_desc=keep(kp_desc),
                          wp_world=np.asarray(wp_world), wp_norm=_host(wp_norm),
                          wp_valid=_host(wp_valid), wp_desc=keep(wp_desc))
        cand = None
        if detect_loop and len(self.keyframes) > 0:
            if scores is not None:
                cand = self._detect_from_scores(np.asarray(scores), idx)
            else:
                cand = self._detect_loop(kf)
        self.keyframes.append(kf)
        self.corrected[idx] = self.apply_drift(kf.P_vio, kf.Q_vio)
        return kf, cand

    def accept_loop(self, kf: KeyFrameData, cand: int, loop_info: dict) -> bool:
        """Record a verified loop; align the sequence on its first
        cross-sequence loop (returns True then)."""
        if self.earliest_loop_index is None or cand < self.earliest_loop_index:
            self.earliest_loop_index = cand
        old_kf = self.keyframes[cand]
        aligned = False
        if old_kf.sequence != kf.sequence and not self.sequence_aligned.get(kf.sequence, False):
            kf2 = self._align_sequence(kf, old_kf, loop_info)
            self.keyframes[kf.index] = kf2
            self.corrected[kf.index] = self.apply_drift(kf2.P_vio, kf2.Q_vio)
            aligned = True
        self.loops.append(loop_info)
        return aligned

    def _align_sequence(self, kf: KeyFrameData, old_kf: KeyFrameData,
                        loop_info: dict) -> KeyFrameData:
        """Fold the loop-implied shift (yaw only with an IMU) into the
        sequence's vio -> map alignment and remap its stored keyframes."""
        R_old = nq.q2R(old_kf.Q_vio)
        w_P_cur = R_old @ loop_info["rel_t"] + old_kf.P_vio
        w_R_cur = R_old @ nq.q2R(loop_info["rel_q"])
        R_vio = nq.q2R(kf.Q_vio)
        if self.cfg.use_6dof:
            shift_r = w_R_cur @ R_vio.T
        else:
            shift_r = nq.yaw_R(float(nq.R2ypr(w_R_cur)[0] - nq.R2ypr(R_vio)[0]))
        shift_t = w_P_cur - w_R_cur @ R_vio.T @ kf.P_vio
        self.w_r_vio = shift_r @ self.w_r_vio
        self.w_t_vio = shift_r @ self.w_t_vio + shift_t
        self.sequence_aligned[kf.sequence] = True

        def remap(k: KeyFrameData) -> KeyFrameData:
            return k._replace(P_vio=shift_r @ k.P_vio + shift_t,
                              Q_vio=nq.qmul(nq.R2q(shift_r), k.Q_vio),
                              wp_world=k.wp_world @ shift_r.T + shift_t)

        self.keyframes = [remap(k) if k.sequence == kf.sequence else k for k in self.keyframes]
        for k in self.keyframes:
            if k.sequence == kf.sequence and k.index in self.corrected:
                del self.corrected[k.index]
        return remap(kf)

    def update_keyframe_loop(self, index: int, rel_t, rel_q, rel_yaw: float,
                             fast_relocalization: bool = True):
        """Fast-relocalization feedback: refine the loop edge of keyframe
        ``index`` and set the drift from the old keyframe's corrected pose."""
        lp = next((l for l in reversed(self.loops) if l["cur"] == index), None)
        if lp is None or index >= len(self.keyframes):
            return
        rel_t = np.asarray(rel_t)
        rel_q = np.asarray(rel_q)
        lp["rel_t"] = rel_t
        lp["rel_q"] = rel_q
        lp["rel_yaw"] = float(rel_yaw)
        if not (abs(rel_yaw) < LOOP_YAW_MAX and np.linalg.norm(rel_t) < LOOP_T_MAX):
            return
        if not fast_relocalization:
            return
        kf = self.keyframes[index]
        old_kf = self.keyframes[lp["old"]]
        w_P_old, w_Q_old = self.corrected.get(old_kf.index, (old_kf.P_vio, old_kf.Q_vio))
        w_R_old = nq.q2R(w_Q_old)
        w_P_cur = w_R_old @ rel_t + w_P_old
        w_R_cur = w_R_old @ nq.q2R(rel_q)
        R_vio = nq.q2R(kf.Q_vio)
        shift_yaw = float(nq.R2ypr(w_R_cur)[0] - nq.R2ypr(R_vio)[0])
        self.yaw_drift = float(nq.normalize_angle_deg(shift_yaw))
        self.t_drift = w_P_cur - w_R_cur @ R_vio.T @ kf.P_vio

    # ------------------------------------------------------------------
    def _detect_loop(self, kf: KeyFrameData) -> Optional[int]:
        """Query the DB with the keyframe's retrieval descriptors, all but
        the last ``recency_exclusion`` keyframes."""
        n_old = len(self.keyframes) - self.cfg.recency_exclusion
        if n_old <= 0 or self._dev_db is None:
            return None
        slot_h = int(np.searchsorted(self._db_index, n_old))
        scores = _host(db_query(self._dev_db, self._dev_valid,
                                self._tensor(kf.kp_desc, torch.int8),
                                self._tensor(kf.kp_valid, torch.bool),
                                min(slot_h, self._db_size), float(self.cfg.score_dist)))
        return self._accept_from_scores(scores)

    def _detect_from_scores(self, scores: np.ndarray, query_index: int) -> Optional[int]:
        n_old = query_index - self.cfg.recency_exclusion
        slot_h = min(int(np.searchsorted(self._db_index, n_old)), self._db_size)
        if slot_h <= 0:
            return None
        scores = scores.copy()
        scores[slot_h:] = -1.0
        return self._accept_from_scores(scores)

    def _accept_from_scores(self, scores: np.ndarray) -> Optional[int]:
        """Best score over ``score_best`` and another of the next three over
        ``score_second``; the earliest of them is the candidate."""
        cfg = self.cfg
        order = np.argsort(-scores)
        best = order[0]
        if scores[best] < cfg.score_best:
            return None
        good = [int(i) for i in order[1:4] if scores[i] > cfg.score_second]
        if not good:
            return None
        slot = min([int(best)] + good)
        return int(self._db_index[slot]) if slot < len(self._db_index) else slot

    # ------------------------------------------------------------------
    def _pnp_init_guess(self, old: KeyFrameData):
        """World -> old-camera pose guess from the old keyframe's pose."""
        R_wi = nq.q2R(old.Q_vio)
        R_wc = R_wi @ self.ric
        t_wc = old.P_vio + R_wi @ self.tic
        return R_wc.T, -R_wc.T @ t_wc

    def _verify_inputs(self, cur: KeyFrameData, old: KeyFrameData) -> tuple:
        """``verify_row``'s inputs for one candidate (its PnP uniforms drawn)."""
        f32, dev = torch.float32, self.device
        okd, okv, okn = combined_old_rows(old, dev)
        R_init, t_init = self._pnp_init_guess(old)
        n = int(np.asarray(cur.wp_valid).shape[0])
        return (self.pnp_uniforms(cur.index, n)[None],
                torch.as_tensor(np.asarray(cur.wp_world), dtype=f32, device=dev)[None],
                self._tensor(cur.wp_desc, torch.int8)[None],
                self._tensor(cur.wp_valid, torch.bool)[None], okd[None], okv[None], okn[None],
                torch.as_tensor(R_init, dtype=f32, device=dev)[None],
                torch.as_tensor(t_init, dtype=f32, device=dev)[None])

    def _find_connection(self, cur: KeyFrameData, old: KeyFrameData) -> Optional[dict]:
        """Match + PnP (one candidate) and the acceptance gates; one read-back."""
        n = int(np.asarray(cur.wp_valid).shape[0])
        row = _host(verify_row(self._verify_inputs(cur, old), float(self.cfg.match_thresh),
                               int(self.cfg.min_loop_num), self._verify_programs))
        return self._loop_from_pnp(cur, old, bool(row[n] > 0.5),
                                   row[n + 1:n + 13].reshape(3, 4).astype(np.float64),
                                   int(row[n + 13]), row[:n].astype(np.int64),
                                   row[n + 14:] > 0.5)

    def _loop_from_pnp(self, cur: KeyFrameData, old: KeyFrameData, pnp_ok: bool,
                       M: np.ndarray, n_inliers: int, idx_b: np.ndarray,
                       inlier_mask: np.ndarray) -> Optional[dict]:
        """Relative pose old -> cur from the PnP model and the reference's
        gates (|Δyaw| < 30°, ‖Δt‖ < 20 m)."""
        if not pnp_ok:
            return None
        R_cw, t_cw = M[:, :3], M[:, 3]
        R_w_oldcam = R_cw.T
        t_w_oldcam = -R_cw.T @ t_cw
        R_w_oldimu = R_w_oldcam @ self.ric.T
        t_w_oldimu = t_w_oldcam - R_w_oldimu @ self.tic
        rel_t = R_w_oldimu.T @ (cur.P_vio - t_w_oldimu)
        yaw_cur = float(nq.R2ypr(nq.q2R(cur.Q_vio))[0])
        yaw_old = float(nq.R2ypr(R_w_oldimu)[0])
        rel_yaw = float(nq.normalize_angle_deg(yaw_cur - yaw_old))
        if abs(rel_yaw) >= LOOP_YAW_MAX or np.linalg.norm(rel_t) >= LOOP_T_MAX:
            return None
        rel_q = nq.qmul(nq.qconj(nq.R2q(R_w_oldimu)), np.asarray(cur.Q_vio))
        return dict(cur=cur.index, old=old.index, rel_t=rel_t, rel_yaw=rel_yaw, rel_q=rel_q,
                    n_inliers=int(n_inliers),
                    matched_old_norm=np.concatenate([np.asarray(old.kp_norm)[:, :2],
                                                     np.asarray(old.wp_norm)[:, :2]])[idx_b],
                    inlier_mask=np.asarray(inlier_mask))

    # ------------------------------------------------------------------
    def _select_nodes(self):
        """The last ``max_pgo_nodes`` keyframes from the earliest looped one,
        plus the old ends of loops that reach before that window as fixed
        anchors.  Returns (nodes, local, n_anchors, first, win_start)."""
        first = self.earliest_loop_index
        last = self.keyframes[-1].index
        win_start = max(first, last - self.cfg.max_pgo_nodes + 1)
        window = self.keyframes[win_start:last + 1]
        anchor_idx = sorted({lp["old"] for lp in self.loops
                             if lp["cur"] >= win_start and first <= lp["old"] < win_start})
        nodes = [self.keyframes[i] for i in anchor_idx] + list(window)
        local = {kf.index: li for li, kf in enumerate(nodes)}
        return nodes, local, len(anchor_idx), first, win_start

    def _node_init(self, kf: KeyFrameData):
        return self.corrected.get(kf.index, (kf.P_vio, kf.Q_vio))

    @staticmethod
    def _pad(n: int, lo: int = 8) -> int:
        p = max(lo, 8)
        while p < n:
            p *= 2
        return p

    def optimize(self):
        """4-DoF PGO (6-DoF with ``use_6dof``) from the earliest looped
        keyframe, then the drift and its propagation to later keyframes."""
        prob = self._build_4dof()
        if prob is None:
            return
        if prob == "6dof":
            nodes, local, n_anchors, first, win_start = self._select_nodes()
            Kpad = self._pad(len(nodes), self.cfg.pad_nodes_min)
            valid = np.zeros(Kpad, bool)
            valid[:len(nodes)] = True
            fixed = np.zeros(Kpad, bool)
            for li, kf in enumerate(nodes):
                fixed[li] = (li < n_anchors or kf.index == first or kf.index == win_start
                             or kf.sequence == 0)
            self._optimize_6dof_impl(nodes, Kpad, valid, fixed, local)
            return
        self._solve_apply_4dof(prob)

    def _solve_apply_4dof(self, prob):
        cfg = self.cfg
        dev, dt = self.device, self.dtype

        def f(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        def b(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.bool, device=dev)

        def i(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)

        yaw_o, t_o, _, _ = optimize_4dof(
            f(prob["yaw"]), f(prob["tt"]), f(prob["pitch"]), f(prob["roll"]),
            b(prob["valid"]), b(prob["fixed"]), i(prob["ei"]), i(prob["ej"]), f(prob["ert"]),
            f(prob["ery"]), b(prob["elo"]), b(prob["evl"]), iters=cfg.pg_iters,
            huber=cfg.huber)
        out = _host(torch.cat([yaw_o[:, None], t_o], dim=1)).astype(np.float64)
        self._apply_4dof(prob, out[:, 0], out[:, 1:])

    def _build_4dof(self):
        """The padded 4-DoF problem as host numpy arrays (None when there is
        nothing to optimize, "6dof" in VO mode)."""
        if self.earliest_loop_index is None or not self.loops:
            return None
        cfg = self.cfg
        nodes, local, n_anchors, first, win_start = self._select_nodes()
        K = len(nodes)
        if K < 2:
            return None
        Kpad = self._pad(K, cfg.pad_nodes_min)
        yaw = np.zeros(Kpad)
        tt = np.zeros((Kpad, 3))
        pitch = np.zeros(Kpad)
        roll = np.zeros(Kpad)
        valid = np.zeros(Kpad, bool)
        fixed = np.zeros(Kpad, bool)
        vio_yaw = np.zeros(Kpad)
        Q_vio_n = np.stack([np.asarray(kf.Q_vio) for kf in nodes])
        P_vio_n = np.stack([np.asarray(kf.P_vio) for kf in nodes])
        seq_n = np.asarray([kf.sequence for kf in nodes])
        idx_n = np.asarray([kf.index for kf in nodes])
        inits = [self._node_init(kf) for kf in nodes]
        P0 = np.stack([np.asarray(c[0]) for c in inits])
        Q0 = np.stack([np.asarray(c[1]) for c in inits])
        ypr_v = nq.R2ypr_batch(nq.q2R_batch(Q_vio_n))
        vio_yaw[:K] = ypr_v[:, 0]
        pitch[:K] = ypr_v[:, 1]
        roll[:K] = ypr_v[:, 2]
        yaw[:K] = nq.R2ypr_batch(nq.q2R_batch(Q0))[:, 0]
        tt[:K] = P0
        valid[:K] = True
        fixed[:K] = ((np.arange(K) < n_anchors) | (idx_n == first) | (idx_n == win_start)
                     | (seq_n == 0))
        # sequential edges to up to 4 predecessors of the same sequence, from
        # the raw VIO relative poses
        lis = np.arange(n_anchors + 1, K)
        e_i = e_j = np.empty(0, np.int64)
        if len(lis):
            ljs = lis[:, None] - np.arange(1, 5)[None, :]
            lif = np.broadcast_to(lis[:, None], ljs.shape)
            ok = (ljs >= n_anchors) & (seq_n[np.maximum(ljs, 0)] == seq_n[lif])
            e_i = ljs[ok]
            e_j = lif[ok]
            R_j = nq.q2R_batch(Q_vio_n[e_i])
            e_rt = np.einsum("nij,ni->nj", R_j, P_vio_n[e_j] - P_vio_n[e_i])
            e_ry = vio_yaw[e_j] - vio_yaw[e_i]
        n_seq_e = len(e_i)
        l_i, l_j, l_rt, l_ry = [], [], [], []
        for lp in self.loops:
            if lp["cur"] not in local or lp["old"] not in local:
                continue
            l_i.append(local[lp["old"]])
            l_j.append(local[lp["cur"]])
            l_rt.append(lp["rel_t"])
            l_ry.append(lp["rel_yaw"])
        E = n_seq_e + len(l_i)
        if E == 0:
            return None
        if cfg.use_6dof:
            return "6dof"
        Epad = self._pad(E, cfg.pad_edges_min)
        ei = np.zeros(Epad, np.int32)
        ej = np.zeros(Epad, np.int32)
        ert = np.zeros((Epad, 3))
        ery = np.zeros(Epad)
        elo = np.zeros(Epad, bool)
        ei[:n_seq_e] = e_i
        ej[:n_seq_e] = e_j
        if n_seq_e:
            ert[:n_seq_e] = e_rt
            ery[:n_seq_e] = e_ry
        if l_i:
            ei[n_seq_e:E] = l_i
            ej[n_seq_e:E] = l_j
            ert[n_seq_e:E] = np.asarray(l_rt)
            ery[n_seq_e:E] = l_ry
            elo[n_seq_e:E] = True
        evl = np.zeros(Epad, bool)
        evl[:E] = True
        return dict(yaw=yaw, tt=tt, pitch=pitch, roll=roll, valid=valid, fixed=fixed, ei=ei,
                    ej=ej, ert=ert, ery=ery, elo=elo, evl=evl, nodes=nodes, vio_yaw=vio_yaw, K=K)

    def _apply_4dof(self, prob, yaw_o: np.ndarray, t_o: np.ndarray):
        """Corrected poses, the drift from the last optimized keyframe, and
        the drift applied to the keyframes after it."""
        nodes, vio_yaw, K = prob["nodes"], prob["vio_yaw"], prob["K"]
        Qc = nq.R2q_batch(nq.ypr2R_batch(
            np.stack([yaw_o[:K], prob["pitch"][:K], prob["roll"][:K]], axis=-1)))
        for li, kf in enumerate(nodes):
            self.corrected[kf.index] = (t_o[li], Qc[li])
        cur_kf = nodes[K - 1]
        self.yaw_drift = float(nq.normalize_angle_deg(yaw_o[K - 1] - vio_yaw[K - 1]))
        Rd = self._r_drift()
        self.t_drift = t_o[K - 1] - Rd @ cur_kf.P_vio
        tail = [kf for kf in self.keyframes if kf.index > cur_kf.index]
        if tail:
            P2 = np.stack([np.asarray(kf.P_vio) for kf in tail]) @ Rd.T + self.t_drift
            Q2 = nq.qmul_batch(nq.R2q(Rd)[None], np.stack([np.asarray(kf.Q_vio) for kf in tail]))
            for i, kf in enumerate(tail):
                self.corrected[kf.index] = (P2[i], Q2[i])

    def _optimize_6dof_impl(self, nodes, Kpad: int, valid, fixed, local):
        """The SE(3) graph of VO mode over the windowed nodes: initialised at
        the corrected poses, sequential edges from the raw VIO relative
        poses (anchors are no sequential neighbours), loop edges with their
        ``rel_q``.  The drift kept afterwards is JAX's: the yaw of the last
        node's rotational correction and the translation that goes with it
        (an approximation of the full rotational drift, kept as it is)."""
        cfg = self.cfg
        K = len(nodes)
        tt = np.zeros((Kpad, 3))
        q0 = np.zeros((Kpad, 4))
        q0[:, 0] = 1.0
        for li, kf in enumerate(nodes):
            P0, Q0 = self._node_init(kf)
            tt[li] = np.asarray(P0)
            q0[li] = np.asarray(Q0)
        e_i, e_j, e_rt, e_rq, e_loop = [], [], [], [], []
        for li in range(1, K):
            for back in range(1, 5):
                lj = li - back
                if lj < 0 or nodes[lj].sequence != nodes[li].sequence:
                    continue
                if abs(nodes[li].index - nodes[lj].index) != li - lj:
                    continue  # anchor nodes are not sequential neighbours
                qj = np.asarray(nodes[lj].Q_vio)
                e_i.append(lj)
                e_j.append(li)
                e_rt.append(nq.q2R(qj).T @ (nodes[li].P_vio - nodes[lj].P_vio))
                e_rq.append(nq.qmul(nq.qconj(qj), np.asarray(nodes[li].Q_vio)))
                e_loop.append(False)
        for lp in self.loops:
            if lp["cur"] not in local or lp["old"] not in local or "rel_q" not in lp:
                continue
            e_i.append(local[lp["old"]])
            e_j.append(local[lp["cur"]])
            e_rt.append(lp["rel_t"])
            e_rq.append(lp["rel_q"])
            e_loop.append(True)
        E = len(e_i)
        if E == 0:
            return
        Epad = self._pad(E, cfg.pad_edges_min)
        ei = np.zeros(Epad, np.int64)
        ej = np.zeros(Epad, np.int64)
        ert = np.zeros((Epad, 3))
        erq = np.zeros((Epad, 4))
        erq[:, 0] = 1.0
        elo = np.zeros(Epad, bool)
        evl = np.zeros(Epad, bool)
        ei[:E], ej[:E], ert[:E], erq[:E], elo[:E], evl[:E] = e_i, e_j, e_rt, e_rq, e_loop, True
        dev, dt = self.device, self.dtype

        def put(a, dtype=dt):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        t_o, q_o, _, _ = optimize_6dof(
            put(tt), put(q0), put(valid, torch.bool), put(fixed, torch.bool),
            put(ei, torch.int64), put(ej, torch.int64), put(ert), put(erq),
            put(elo, torch.bool), put(evl, torch.bool), iters=cfg.pg_iters, huber=cfg.huber)
        out = _host(torch.cat([t_o, q_o], dim=1)).astype(np.float64)  # the one read-back
        self.n_solves_6dof += 1
        t_o, q_o = out[:, :3], out[:, 3:]
        for li, kf in enumerate(nodes):
            self.corrected[kf.index] = (t_o[li], q_o[li])
        cur_kf = nodes[K - 1]
        Rd = nq.q2R(q_o[K - 1]) @ nq.q2R(cur_kf.Q_vio).T
        self.yaw_drift = float(nq.R2ypr(Rd)[0])
        self.t_drift = t_o[K - 1] - self._r_drift() @ cur_kf.P_vio
        for kf in self.keyframes:
            if kf.index > cur_kf.index:
                self.corrected[kf.index] = self.apply_drift(kf.P_vio, kf.Q_vio)

    # ------------------------------------------------------------------
    def path(self) -> list:
        """Corrected trajectory [(t, P, Q)] of every keyframe."""
        out = []
        for kf in self.keyframes:
            P, Q = self.corrected.get(kf.index, (kf.P_vio, kf.Q_vio))
            out.append((kf.t, np.asarray(P), np.asarray(Q)))
        return out

    # ------------------------------------------------------------------
    def save(self, path: str):
        """Persist the map as JAX's ``PoseGraph.save`` does (``.npz``,
        version 3): keyframes with their corrected poses, retrieval
        keypoints and window points with their descriptors (brought to the
        host), the loop edges, ``earliest_loop_index``, the drift and the
        BRIEF pattern's hash."""
        kfs = self.keyframes
        corr = [self.corrected.get(k.index, (k.P_vio, k.Q_vio)) for k in kfs]

        def stack(get, empty):
            return np.stack([_host(get(k)) for k in kfs]) if kfs else np.zeros(empty)

        np.savez_compressed(
            path, version=3, n=len(kfs),
            index=np.asarray([k.index for k in kfs]), t=np.asarray([k.t for k in kfs]),
            sequence=np.asarray([k.sequence for k in kfs]),
            P_vio=stack(lambda k: k.P_vio, (0, 3)), Q_vio=stack(lambda k: k.Q_vio, (0, 4)),
            P_corr=np.stack([np.asarray(c[0]) for c in corr]) if kfs else np.zeros((0, 3)),
            Q_corr=np.stack([np.asarray(c[1]) for c in corr]) if kfs else np.zeros((0, 4)),
            kp_uv=stack(lambda k: k.kp_uv, (0, 0, 2)),
            kp_norm=stack(lambda k: k.kp_norm, (0, 0, 2)),
            kp_valid=stack(lambda k: k.kp_valid, (0, 0)),
            kp_desc=stack(lambda k: k.kp_desc, (0, 0, 256)),
            wp_norm=stack(lambda k: _host(k.wp_norm)[..., :2], (0, 0, 2)),
            wp_valid=stack(lambda k: k.wp_valid, (0, 0)),
            wp_desc=stack(lambda k: k.wp_desc, (0, 0, 256)).astype(np.int8),
            loop_cur=np.asarray([lp["cur"] for lp in self.loops], np.int64),
            loop_old=np.asarray([lp["old"] for lp in self.loops], np.int64),
            loop_rel_t=(np.stack([lp["rel_t"] for lp in self.loops]) if self.loops
                        else np.zeros((0, 3))),
            loop_rel_q=(np.stack([lp.get("rel_q", np.array([1.0, 0, 0, 0]))
                                  for lp in self.loops]) if self.loops else np.zeros((0, 4))),
            loop_rel_yaw=np.asarray([lp["rel_yaw"] for lp in self.loops]),
            loop_n_inliers=np.asarray([lp.get("n_inliers", 0) for lp in self.loops], np.int64),
            earliest_loop_index=(-1 if self.earliest_loop_index is None
                                 else self.earliest_loop_index),
            yaw_drift=self.yaw_drift, t_drift=self.t_drift,
            brief_pattern_hash=brief.pattern_hash())

    def load(self, path: str):
        """Rebuild keyframes, the retrieval DB (through ``_db_append``, so
        the DB compacts at its cap) and the loop edges from a map saved by
        either package's ``save``.  Loaded keyframes join as sequence 0
        (fixed in optimization) at their corrected poses; loading into a
        non-empty graph offsets every index past the existing keyframes.
        Legacy (version 1) loop rows are kept; saves from before version 3
        have no window points."""
        data = np.load(path)
        if "brief_pattern_hash" in data and int(data["brief_pattern_hash"]) != brief.pattern_hash():
            log.warning("pose-graph %s was saved under a DIFFERENT BRIEF test pattern (hash %d "
                        "vs active %d): stored descriptors will not match live ones — "
                        "relocalization against this map will not work (set VINS_BRIEF_PATTERN "
                        "to the pattern the map was built with)", path,
                        int(data["brief_pattern_hash"]), brief.pattern_hash())
        cfg = self.cfg
        n = int(data["n"])
        off = len(self.keyframes)
        has_wp = "wp_desc" in data
        for i in range(n):
            kp_norm = data["kp_norm"][i]
            if kp_norm.shape[-1] == 2:
                kp_norm = np.concatenate([kp_norm, np.zeros(kp_norm.shape[:-1] + (1,))], -1)
            kf = KeyFrameData(
                index=off + i, t=float(data["t"][i]), sequence=0,
                P_vio=data["P_vio"][i], Q_vio=data["Q_vio"][i], kp_uv=data["kp_uv"][i],
                kp_norm=kp_norm, kp_valid=data["kp_valid"][i].astype(bool),
                kp_desc=data["kp_desc"][i].astype(np.int8),
                wp_world=np.zeros((cfg.max_wp, 3)),
                wp_norm=(np.asarray(data["wp_norm"][i]) if has_wp
                         else np.zeros((cfg.max_wp, 2))),
                wp_valid=(data["wp_valid"][i].astype(bool) if has_wp
                          else np.zeros(cfg.max_wp, bool)),
                wp_desc=(data["wp_desc"][i].astype(np.int8) if has_wp
                         else np.zeros((cfg.max_wp, 256), np.int8)))
            self.keyframes.append(kf)
            self._db_append(*combine_db_rows(
                kf.kp_desc, kf.kp_valid, np.asarray(kf.kp_norm, np.float32), kf.wp_desc,
                kf.wp_valid, np.asarray(kf.wp_norm, np.float32)), kf_index=kf.index)
            if "P_corr" in data:
                self.corrected[kf.index] = (np.asarray(data["P_corr"][i]),
                                            np.asarray(data["Q_corr"][i]))
        if "loop_cur" in data:
            for j in range(len(data["loop_cur"])):
                self.loops.append(dict(
                    cur=int(data["loop_cur"][j]) + off, old=int(data["loop_old"][j]) + off,
                    rel_t=np.asarray(data["loop_rel_t"][j]),
                    rel_q=np.asarray(data["loop_rel_q"][j]),
                    rel_yaw=float(data["loop_rel_yaw"][j]),
                    n_inliers=int(data["loop_n_inliers"][j])))
            eli = int(data["earliest_loop_index"])
            self._lower_earliest_loop(eli + off if eli >= 0 else None)
        elif "loops" in data:
            # legacy v1 rows [cur, old, rel_yaw, rel_t (3)]: no rel_q, no inlier counts
            legacy = np.asarray(data["loops"])
            for row in legacy:
                self.loops.append(dict(cur=int(row[0]) + off, old=int(row[1]) + off,
                                       rel_t=np.asarray(row[3:6], np.float64),
                                       rel_q=np.array([1.0, 0.0, 0.0, 0.0]),
                                       rel_yaw=float(row[2]), n_inliers=0))
            if len(legacy):
                self._lower_earliest_loop(int(min(int(r[1]) for r in legacy)) + off)
        self.yaw_drift = float(data["yaw_drift"])
        self.t_drift = np.asarray(data["t_drift"])

    def _lower_earliest_loop(self, index: Optional[int]):
        """Lower ``earliest_loop_index`` to ``index`` (None: no change)."""
        if index is not None and (self.earliest_loop_index is None
                                  or index < self.earliest_loop_index):
            self.earliest_loop_index = index
