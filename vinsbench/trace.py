"""The reduction of a profiled window (``torch.profiler``'s chrome trace) to
what the per-layer readers and the result's breakdown read: the window's
length, each card's busy time (the union of its kernels, copies and sets),
kernels by name and by stream, and the idle gaps with what the host was
doing meanwhile."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

WINDOW_SPAN = "vinsbench::window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
NAME_LEN = 96
LABELLED = 400  # the longest idle gaps that are labelled by the host's activity
SHORT_GAPS = "shorter gaps"


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def _device_of(e: dict):
    args = e.get("args", {})
    return args.get("device", e.get("pid"))


def short(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    base = name.split("(")[0]
    if "<" in base:
        base = base.split("<")[0]
    base = base.replace("void ", "").strip()
    return (base or name)[:NAME_LEN]


def reduce(trace: dict, frames: int, devices: List[int]) -> dict:
    """``trace`` a chrome trace holding one ``WINDOW_SPAN``; ``frames`` the
    frames profiled inside it; ``devices`` the cards' indices."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    wins = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW_SPAN]
    if not wins:
        raise ValueError("the trace holds no profiled window")
    w = wins[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    by_dev: Dict[object, list] = {}
    kernels: Dict[str, list] = {}
    by_stream: Dict[str, Dict[str, list]] = {}
    for e in dev:
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        by_dev.setdefault(_device_of(e), []).append((a, b))
        if e.get("cat") != "kernel":
            continue
        name = short(e.get("name", "?"))
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-6
        s = by_stream.setdefault(f"{_device_of(e)}:{e.get('args', {}).get('stream', '?')}", {})
        ks = s.setdefault(name, [0, 0.0])
        ks[0] += 1
        ks[1] += (b - a) * 1e-6
    busy = {}
    gaps_all = []
    for d, iv in by_dev.items():
        merged = _union(iv)
        busy[str(d)] = sum(b - a for a, b in merged) * 1e-6
        t = w0
        for a, b in merged:
            if a > t:
                gaps_all.append((t, a))
            t = max(t, b)
        if t < w1:
            gaps_all.append((t, w1))
    n_dev = max(len(devices), 1)
    busy_s = sum(busy.values()) / n_dev
    # what the host was doing in each gap: the innermost host event on the
    # window's thread that covers the gap's middle
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("tid") == w.get("tid")
            and e.get("pid") == w.get("pid") and e is not w]
    gaps: Dict[str, float] = {}
    gaps_all.sort(key=lambda g: g[0] - g[1])
    for a, b in gaps_all[LABELLED:]:
        gaps[SHORT_GAPS] = gaps.get(SHORT_GAPS, 0.0) + (b - a) * 1e-6
    h_ts = np.array([float(e["ts"]) for e in host])
    h_dur = np.array([float(e["dur"]) for e in host])
    for a, b in gaps_all[:LABELLED]:
        mid = 0.5 * (a + b)
        cover = np.nonzero((h_ts <= mid) & (h_ts + h_dur > mid))[0]
        label = (host[cover[np.argmin(h_dur[cover])]]["name"][:NAME_LEN] if cover.size
                 else "host outside the profiled calls")
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    # each card's frame stream: the one its kernels spent most time on
    busiest: Dict[str, tuple] = {}
    for s, ks in by_stream.items():
        t = sum(v[1] for v in ks.values())
        card = s.rsplit(":", 1)[0]
        if card not in busiest or t > busiest[card][1]:
            busiest[card] = (s, t)
    return dict(window_s=(w1 - w0) * 1e-6, busy_s=busy_s, busy_by_device=busy, frames=frames,
                n_kernels=sum(v[0] for v in kernels.values()),
                kernel_s=sum(v[1] for v in kernels.values()),
                kernels={k: tuple(v) for k, v in kernels.items()},
                by_stream={s: {k: tuple(v) for k, v in ks.items()} for s, ks in by_stream.items()},
                frame_streams=sorted(s for s, _ in busiest.values()),
                breakdown=dict(device_ops=[[k, v[1]] for k, v in top_ops],
                               idle_gaps=[[k, v] for k, v in top_gaps]))


def kernel_seconds(red: dict, marker: str, streams=None) -> float:
    """The device seconds of the kernels whose name holds ``marker`` in a
    reduced trace (on the ``streams``, "card:stream", only, if given)."""
    tables = ([red["kernels"]] if streams is None
              else [red["by_stream"].get(s, {}) for s in streams])
    return sum(v[1] for table in tables for k, v in table.items() if marker in k)
