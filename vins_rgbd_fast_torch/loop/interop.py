"""Reference-format pose-graph interop: read and write the map directory of
the C++ system (the port's copy of ``vins_rgbd_fast_tpu/loop/interop.py``,
over the port's ``PoseGraph``).

The reference persists its pose graph as a directory
(``pose_graph/src/pose_graph/pose_graph.cpp:849-927`` save, ``:929-1044``
load):

  * ``pose_graph.txt`` — one line per keyframe with 26 whitespace-separated
    fields: ``index  time  VIO_T(3)  PG_T(3)  VIO_Q(wxyz)  PG_Q(wxyz)
    loop_index  loop_info(8)  n_keypoints`` where ``loop_info`` is
    ``[rel_t(3), rel_q(wxyz), rel_yaw]`` and ``loop_index`` is −1 when the
    keyframe closed no loop;
  * ``<index>_keypoints.txt`` — ``u v x_norm y_norm`` per retrieval
    keypoint;
  * ``<index>_briefdes.dat`` — one BRIEF-256 descriptor per line as a
    256-character '0'/'1' string, highest bit first (a streamed
    ``boost::dynamic_bitset``): character ``j`` is bit ``255 − j``.

Bit ``i`` is set when ``I(p + a_i) < I(p + b_i)``; the port's descriptors
hold the same comparison as ±1 int8, so bit 1 ↔ +1 and bit 0 ↔ −1.  A map
of the C++ system relocalizes against this one only under the same test
pattern (``VINS_BRIEF_PATTERN``, ``loop/brief.py``).
"""

from __future__ import annotations

import os

import numpy as np

from .pose_graph import KeyFrameData, PoseGraph, _host, combine_db_rows


def save_reference_pose_graph(dir_path: str, graph: PoseGraph) -> None:
    """Write ``graph`` as a reference-format map directory."""
    os.makedirs(dir_path, exist_ok=True)
    # the reference keeps one loop per keyframe: the newest of each
    # keyframe's loops, the one that drives the current drift
    loop_by_cur = {int(lp["cur"]): lp for lp in graph.loops}
    lines = []
    for kf in graph.keyframes:
        P_pg, Q_pg = graph.corrected.get(kf.index, (kf.P_vio, kf.Q_vio))
        lp = loop_by_cur.get(kf.index)
        if lp is None:
            loop_index, info = -1, np.zeros(8)
        else:
            loop_index = int(lp["old"])
            rel_q = np.asarray(lp.get("rel_q", [1.0, 0, 0, 0]), np.float64)
            info = np.concatenate([np.asarray(lp["rel_t"], np.float64), rel_q,
                                   [float(lp["rel_yaw"])]])
        valid = _host(kf.kp_valid).astype(bool)
        n_kp = int(valid.sum())
        fields = ([int(kf.index), float(kf.t)]
                  + [float(v) for v in np.asarray(kf.P_vio)]
                  + [float(v) for v in np.asarray(P_pg)]
                  + [float(v) for v in np.asarray(kf.Q_vio)]
                  + [float(v) for v in np.asarray(Q_pg)]
                  + [loop_index] + [float(v) for v in info] + [n_kp])
        lines.append(" " + " ".join(str(v) if isinstance(v, int) else f"{v:.9f}"
                                    for v in fields))
        uv = _host(kf.kp_uv)[valid]
        norm = _host(kf.kp_norm)[valid]
        desc = _host(kf.kp_desc)[valid]
        with open(os.path.join(dir_path, f"{kf.index}_keypoints.txt"), "w") as f:
            for i in range(n_kp):
                f.write(f"{uv[i, 0]:.9f} {uv[i, 1]:.9f} {norm[i, 0]:.9f} {norm[i, 1]:.9f}\n")
        with open(os.path.join(dir_path, f"{kf.index}_briefdes.dat"), "w") as f:
            for i in range(n_kp):
                bits = desc[i] > 0
                f.write("".join("1" if b else "0" for b in bits[::-1]) + "\n")
    with open(os.path.join(dir_path, "pose_graph.txt"), "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def load_reference_pose_graph(dir_path: str, graph: PoseGraph) -> int:
    """Parse a reference-format map directory into ``graph``: keyframes join
    as sequence 0 (fixed in optimization), their retrieval descriptors join
    the DB, and every ``loop_index`` re-enters the loop edges.  Loading into
    a non-empty graph offsets indices past the existing keyframes.  Returns
    the number of keyframes loaded."""
    txt = os.path.join(dir_path, "pose_graph.txt")
    cfg = graph.cfg
    off = len(graph.keyframes)
    idx_map = {}  # file index -> in-graph index (files may skip indices)
    n_loaded = 0
    with open(txt) as f:
        rows = [ln.split() for ln in f if ln.strip()]
    for row in rows:
        if len(row) != 26:
            raise ValueError(f"{txt}: expected 26 fields per keyframe, got {len(row)}")
        file_index = int(row[0])
        t = float(row[1])
        vio_t, pg_t = np.asarray(row[2:5], np.float64), np.asarray(row[5:8], np.float64)
        vio_q, pg_q = np.asarray(row[8:12], np.float64), np.asarray(row[12:16], np.float64)
        loop_index = int(row[16])
        info = np.asarray(row[17:25], np.float64)
        n_kp_file = int(row[25])

        kp_uv = np.zeros((cfg.max_kp, 2), np.float64)
        kp_norm = np.zeros((cfg.max_kp, 3), np.float64)
        kp_valid = np.zeros(cfg.max_kp, bool)
        kp_desc = np.zeros((cfg.max_kp, 256), np.int8)
        n_kp = min(n_kp_file, cfg.max_kp)
        kp_path = os.path.join(dir_path, f"{file_index}_keypoints.txt")
        if n_kp_file and os.path.exists(kp_path):
            pts = np.loadtxt(kp_path, ndmin=2)
            with open(os.path.join(dir_path, f"{file_index}_briefdes.dat")) as bf:
                dlines = [ln.strip() for ln in bf if ln.strip()]
            if len(pts) != n_kp_file or len(dlines) != n_kp_file:
                raise ValueError(f"{dir_path}: keyframe {file_index} expects {n_kp_file} "
                                 f"keypoints, files carry {len(pts)}/{len(dlines)}")
            kp_uv[:n_kp] = pts[:n_kp, 0:2]
            kp_norm[:n_kp, :2] = pts[:n_kp, 2:4]
            kp_valid[:n_kp] = True
            bit_rows = np.frombuffer("".join(d[::-1] for d in dlines[:n_kp]).encode(),
                                     np.uint8).reshape(n_kp, 256) - ord("0")
            kp_desc[:n_kp] = np.where(bit_rows > 0, 1, -1).astype(np.int8)

        idx = off + len(idx_map)
        idx_map[file_index] = idx
        kf = KeyFrameData(index=idx, t=t, sequence=0, P_vio=vio_t, Q_vio=vio_q, kp_uv=kp_uv,
                          kp_norm=kp_norm, kp_valid=kp_valid, kp_desc=kp_desc,
                          wp_world=np.zeros((cfg.max_wp, 3)), wp_norm=np.zeros((cfg.max_wp, 2)),
                          wp_valid=np.zeros(cfg.max_wp, bool),
                          wp_desc=np.zeros((cfg.max_wp, 256), np.int8))
        graph.keyframes.append(kf)
        # reference maps carry keypoints only: the window half of the row is invalid
        graph._db_append(*combine_db_rows(kp_desc, kp_valid, kp_norm.astype(np.float32),
                                          kf.wp_desc, kf.wp_valid,
                                          kf.wp_norm.astype(np.float32)), kf_index=idx)
        graph.corrected[idx] = (pg_t, pg_q)
        if loop_index >= 0 and loop_index in idx_map:
            graph.loops.append(dict(cur=idx, old=idx_map[loop_index], rel_t=info[0:3],
                                    rel_q=info[3:7], rel_yaw=float(info[7]),
                                    n_inliers=cfg.min_loop_num))
            graph._lower_earliest_loop(idx_map[loop_index])
        n_loaded += 1
    return n_loaded
