"""The comparisons that decide ``correct``, and the control's readings.

Each compares what the timed path produced with the plain reference
(``reference/``) or with the benchmark's own truth, never with the
program's own state alone:

* ``ate_ratio``: each stream's unaligned trajectory error (RMSE of the
  positions the program handed out against the truth at the same frames)
  over the bound the configuration states, max(0.05 · travelled, 0.08 m);
  the worst stream.  Limit 1.
* ``k1_off_corner``: features the program's tracker detected in the
  checked frames (live, tracked for one frame) that are not FAST-NMS
  corners of the reference on the same image.  Exact: limit 0.
* ``lk_gap_px``: tracks of the checked frames (ids in the frame before and
  in this one): the widest gap between the program's position and the
  reference's pyramidal LK over the same two frames from where the program
  started the point (its previous position, cold, or on the IMU rig its
  IMU prediction), where the reference tracks the point.  The previous
  positions are the program's own; a track's start is checked as a K1
  corner.
* ``solve_cost0_gap``, ``solve_decrement``: the checked frames' window
  solves against the plain solve (``reference/estimator.py``) from the
  same window, feature table, prior and IMU samples (``solve_numbers``).
* ``td_err_ms``, ``ric_err_deg``: the estimated IMU-camera time offset and
  extrinsic rotation against the truth, under the limits the configuration
  states.
* ``loop_ate_ratio``: the loop-corrected keyframe path's error over the
  same bound.

The control is the reference put in the program's place one precision
below the float32 the configurations state: the frontend in bfloat16, the
window solve in float32 with TF32 operands (``control``).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .reference import estimator as ref_est
from .reference import frontend as ref
from .traffic import synthetic as syn

# the limits the configuration does not state, set from the readings of
# sound runs and of the control (PERF.md gives both)
LK_GAP_LIMIT_PX = 0.2
K1_LIMIT = 0
# (the VO rig's, the IMU rig's); PERF.md gives the readings of each
SOLVE_LIMITS = dict(solve_cost0_gap=(1e-3, 1e-3), solve_decrement=(2e-2, None))
# converged: the reference's solve run this many LM steps, for the
# control's printed readings of where the solved poses lie
CONVERGED_ITERS = 40


def solve_limits(flags) -> dict:
    """The window solve's numbers that a rig compares, with their limits:
    the cost at the inputs on every rig; on a VO rig also the distance
    from the optimum.  With an IMU the eight steps leave some windows as
    far from the optimum as the control does.  The solved poses' gaps to
    the reference's own eight steps are printed, not compared, on every
    rig: along a direction the cost hardly sees, two sound solves end
    millimetres apart at the same cost, as far as the control's."""
    i = 1 if flags.use_imu else 0
    return {k: v[i] for k, v in SOLVE_LIMITS.items() if v[i] is not None}


def travelled(P: np.ndarray) -> float:
    return float(np.sum(np.linalg.norm(np.diff(P, axis=0), axis=1)))


def ate_ratio(P_est: np.ndarray, frames: np.ndarray, seq, guarantees: dict) -> tuple:
    """(unaligned ATE of positions ``P_est`` (n, 3) handed out at truth
    frames ``frames``, its bound).  The bound is max(frac · the truth's path
    length over those frames, floor)."""
    P_true = seq.P[frames]
    ate = float(np.sqrt(np.mean(np.sum((np.asarray(P_est, np.float64) - P_true) ** 2, axis=1))))
    d = travelled(seq.P[frames.min():frames.max() + 1])
    return ate, max(guarantees["ate_frac_of_travel"] * d, guarantees["ate_floor_m"])


def new_features(ids, track_cnt):
    """(B, N) mask of the tracker's features detected at its last frame:
    live, and tracked for one frame only."""
    return (ids >= 0) & (track_cnt == 1)


def k1_off_corner(img, uv, mask, threshold: float) -> tuple:
    """(checked, off): the masked features' pixels that the reference's
    FAST-NMS map of ``img`` (B, H, W) leaves at 0."""
    score = ref.fast_nms(img.float(), threshold)
    B, H, W = score.shape
    x = uv[..., 0].round().long().clamp(0, W - 1)
    y = uv[..., 1].round().long().clamp(0, H - 1)
    s = score.reshape(B, -1).gather(1, y * W + x)
    return int(mask.sum()), int(((s <= 0) & mask).sum())


def k1_control(img, threshold: float, rows: int, cols: int, per_grid: int) -> tuple:
    """The control's K1 answers: each grid cell's ``per_grid`` strongest
    corners of the reference computed in bfloat16, checked against the
    float32 reference as the program's are: (checked, off)."""
    score16 = ref.fast_nms(img.float(), threshold, dtype=torch.bfloat16).float()
    score = ref.fast_nms(img.float(), threshold)
    B, H, W = score.shape
    gh, gw = H // rows, W // cols
    s16 = score16[:, :gh * rows, :gw * cols].reshape(B, rows, gh, cols, gw)
    s16 = s16.permute(0, 1, 3, 2, 4).reshape(B, rows * cols, gh * gw)
    vals, idx = torch.topk(s16, per_grid, dim=-1)
    g = torch.arange(rows * cols, device=img.device)
    yy = (g // cols)[:, None] * gh + idx // gw
    xx = (g % cols)[:, None] * gw + idx % gw
    s = score[:, :gh * rows, :gw * cols].reshape(B, -1).gather(
        1, (yy * W + xx).reshape(B, -1)).reshape(vals.shape)
    picked = vals > 0
    return int(picked.sum()), int(((s <= 0) & picked).sum())


def lk_tracks(prev_img, cur_img, uv_prev, ids_prev, valid_prev, uv, ids, valid, levels: int,
              iters: int, coarse: int, dtype=torch.float32, init_prev=None):
    """The reference's LK over the tracks from one frame to the next:
    (reference positions (B, N, 2), reference status, matched (B, N)), the
    tracks started where the program's previous frame left them, at the
    same position (cold) or at ``init_prev`` (B, N, 2), the program's
    prediction for each of them."""
    eq = (ids[:, :, None] == ids_prev[:, None, :]) & valid_prev[:, None, :] & (ids >= 0)[:, :, None]
    matched = eq.any(-1) & valid
    j = torch.argmax(eq.to(torch.uint8), dim=-1)
    start = torch.gather(uv_prev, 1, j[..., None].expand(-1, -1, 2))
    start = torch.where(matched[..., None], start, torch.zeros_like(start)).to(dtype)
    init = start
    if init_prev is not None:
        init = torch.gather(init_prev, 1, j[..., None].expand(-1, -1, 2))
        init = torch.where(matched[..., None], init, torch.zeros_like(init)).to(dtype)
    pp = ref.pyramid(prev_img.to(dtype), levels)
    cp = ref.pyramid(cur_img.to(dtype), levels)
    pts, status, lv = ref.pyramidal_lk(pp, cp, start, init, matched, iters, coarse)
    return pts, status, matched, lv


def lk_gaps(pts_ref, status, matched, uv) -> torch.Tensor:
    """|program − reference| (px) of the tracks both follow."""
    both = matched & status
    return torch.linalg.norm(uv.double() - pts_ref.double(), dim=-1)[both]


def rot_err_deg(q_est: np.ndarray, R_true: np.ndarray) -> float:
    R = syn._q2R(np.asarray(q_est, np.float64))
    c = (np.trace(R.T @ R_true) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


class Tally:
    """The numbers of one run, gathered as the drivers read the answers:
    the worst of each, and how many were checked."""

    def __init__(self):
        self.worst: Dict[str, float] = {}
        self.count: Dict[str, int] = {}

    def add(self, name: str, value: float, n: int = 1) -> None:
        """Keep the worst (largest) reading; a NaN stays, and fails."""
        v, old = float(value), self.worst.get(name)
        if old is None or math.isnan(v) or (not math.isnan(old) and v > old):
            self.worst[name] = v
        self.count[name] = self.count.get(name, 0) + n

    def sum(self, name: str, value: float, n: int = 1) -> None:
        self.worst[name] = self.worst.get(name, 0.0) + float(value)
        self.count[name] = self.count.get(name, 0) + n


def checks(t: Tally, limits: Dict[str, float], required: List[str]) -> Dict[str, tuple]:
    """name -> (value, limit) for every number compared; a number that was
    due and never read is NaN, and fails."""
    return {k: (t.worst.get(k, float("nan")), limits[k]) for k in required}


def to_np(x) -> np.ndarray:
    return x.detach().double().cpu().numpy()


def checked_frames(seed: int, n: int, k: int, first: int = 1) -> List[int]:
    """k frames of [first, n) drawn from the seed, in order, with the last."""
    rng = np.random.default_rng((abs(int(seed)), 4242))
    pool = np.arange(first, n - 1)
    pick = (set(rng.choice(pool, size=min(k - 1, len(pool)), replace=False).tolist())
            if len(pool) else set())
    pick.add(n - 1)
    return sorted(pick)


def solve_flags(cfg: dict) -> ref_est.Flags:
    """What a configuration file states about the window solve."""
    v = cfg["vins"]
    return ref_est.Flags(
        use_imu=bool(v["imu"]), estimate_extrinsic=int(v.get("estimate_extrinsic", 0)) > 0,
        estimate_td=bool(v.get("estimate_td", False)) and bool(v["imu"]),
        max_iters=int(v["max_num_iterations"]), g_norm=float(v.get("g_norm", 9.805)),
        noise=tuple(float(v.get(k, 0.0)) for k in ("acc_n", "gyr_n", "acc_w", "gyr_w")))


def solve_window(tap: dict, lanes=slice(None)) -> ref_est.Window:
    """The reference's inputs from a tapped solve: the window before it,
    the feature table, the prior, the IMU samples and the relocalization,
    lanes ``lanes``."""
    x, v, p = tap["solve"]["x0"], tap["solve"]["vis"], tap["solve"]["prior"]

    def L(a):
        return a[lanes]

    kw = dict(P=L(x.P), Q=L(x.Q), V=L(x.V), Ba=L(x.Ba), Bg=L(x.Bg), tic=L(x.tic), qic=L(x.qic),
              td=L(x.td), start=L(v.start), pts=L(v.pts), vel=L(v.vel), td_obs=L(v.td_obs),
              row_scaled=L(v.row_scaled), obs_mask=L(v.obs_mask), inv_depth=L(v.inv_depth),
              depth_free=L(v.depth_free), valid=L(v.valid), prior_J=L(p.J), prior_r0=L(p.r0),
              prior_x0=tuple(L(a) for a in p.x0), prior_valid=L(p.valid))
    if tap.get("imu") is not None:
        i = tap["imu"]
        kw.update(imu_dts=L(i["dts"])[:, 1:], imu_acc=L(i["acc"])[:, 1:],
                  imu_gyr=L(i["gyr"])[:, 1:])
    r = tap["solve"].get("relo")
    if r is not None:
        kw.update(relo_active=L(r.active), relo_pts=L(r.match_pts), relo_valid=L(r.match_valid),
                  relo_P=L(r.P), relo_Q=L(r.Q))
    return ref_est.Window(**kw)


def solve_numbers(tap: dict, flags: ref_est.Flags, control: bool = False,
                  block: int = 8) -> tuple:
    """The window solve against the reference, over every lane in blocks
    of ``block``: (the numbers compared, the control's readings of them,
    the solved window's gaps as printed).  ``solve_cost0_gap``: the
    program's cost at the window's inputs against the reference's
    (float64), relative: every factor evaluated.  ``solve_decrement``: how
    far the program's solved window lies from the optimum, in units of its
    cost (``reference.estimator.decrement``).  ``solve_p_gap_mm`` and
    ``solve_q_gap_deg`` (printed): the widest gaps between the program's
    solved poses and the reference's own solve from the same inputs.  With
    ``control`` the reference in float32 with TF32 operands stands in the
    program's place and is read the same way, and the printed readings
    also hold the reference's own decrement and both solves' gaps to a
    solve run ``CONVERGED_ITERS`` steps.  The numbers a rig does not
    compare (``solve_limits``), and the control's readings of them, go to
    the printed ones."""
    s = tap["solve"]
    x = s["x"]
    B = x.P.shape[0]
    keys = ("P", "Q", "V", "Ba", "Bg", "tic", "qic", "td")
    prog, ctrl, printed = {}, {}, {}

    def worst(d, k, v):
        d[k] = v if (math.isnan(v) or math.isnan(d.get(k, 0.0))) else max(d.get(k, 0.0), v)

    tf32 = ref_est.Precision(torch.float32, tf32=True)
    compared = solve_limits(flags)
    for b0 in range(0, B, block):
        lanes = slice(b0, min(b0 + block, B))
        w = solve_window(tap, lanes)
        got = {k: getattr(x, k)[lanes] for k in keys}
        got["inv_depth"] = s["inv_depth"][lanes]
        if "relo_P" in s:
            got.update(relo_P=s["relo_P"][lanes], relo_Q=s["relo_Q"][lanes])
        c0 = ref_est.cost_at(w, flags, {})
        ref64 = ref_est.solve(w, flags)
        nums = dict(solve_cost0_gap=float(((s["cost0"][lanes].double() - c0).abs() / c0).max()),
                    solve_decrement=float(ref_est.decrement(w, flags, got).max()))
        nums.update(ref_est.gaps(got, ref64, flags.use_imu))
        for k, v in nums.items():
            worst(prog if k in compared else printed, k, v)
        if control:
            # where the poses lie: the reference's own distance from the
            # optimum, and the program's and the reference's gaps to a
            # solve run to convergence
            conv = ref_est.solve(w, flags._replace(max_iters=CONVERGED_ITERS))
            diag = {"solve_decrement.reference": float(ref_est.decrement(w, flags, ref64).max())}
            for name, sol in (("program", got), ("reference", ref64)):
                for k, v in ref_est.gaps(sol, conv, flags.use_imu).items():
                    diag[f"{k}.{name}_to_converged"] = v
            for k, v in diag.items():
                worst(printed, k, v)
            del conv
            c32 = ref_est.solve(w, flags, tf32)
            c0c = ref_est.cost_at(w, flags, {}, tf32).double()
            cn = dict(solve_cost0_gap=float(((c0c - c0).abs() / c0).max()),
                      solve_decrement=float(ref_est.decrement(w, flags, c32).max()),
                      **ref_est.gaps(c32, ref64, flags.use_imu))
            for k, v in cn.items():
                v = v if not math.isnan(v) else math.inf
                if k in compared:
                    worst(ctrl, k, v)
                else:
                    worst(printed, k + ".control", v)
        del w, ref64
    return prog, ctrl, printed


def summary(t: Tally) -> dict:
    return {k: dict(value=v, n=t.count.get(k, 0)) for k, v in t.worst.items()}
