"""The reduction of a profiled window: busy time from the union of each
card's device events, the idle share from the same timeline, and a
kernel's time on every card's frame stream (not one card's alone)."""

import pytest

from vinsbench import harness as H
from vinsbench import trace


def _trace(cards=2):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_SPAN, "ts": 0.0,
           "dur": 1000.0, "pid": 1, "tid": 1}]
    for d in range(cards):
        ev += [  # the frame stream: K1 100 us, 300 us of other kernels; a side stream
            {"ph": "X", "cat": "kernel", "name": "fast_nms_kernel(float const*)", "ts": 100.0,
             "dur": 100.0, "pid": d, "tid": 7, "args": {"device": d, "stream": 7}},
            {"ph": "X", "cat": "kernel", "name": "void at::native::elementwise_kernel<1>()",
             "ts": 150.0, "dur": 300.0, "pid": d, "tid": 7, "args": {"device": d, "stream": 7}},
            {"ph": "X", "cat": "kernel", "name": "fast_nms_kernel(float const*)", "ts": 600.0,
             "dur": 50.0, "pid": d, "tid": 9, "args": {"device": d, "stream": 9}},
        ]
    return {"traceEvents": ev}


@pytest.mark.parametrize("cards", [1, 2])
def test_reduction_counts_every_cards_frame_stream(cards):
    red = trace.reduce(_trace(cards), frames=4, devices=list(range(cards)))
    assert red["frame_streams"] == [f"{d}:7" for d in range(cards)]
    assert red["window_s"] == pytest.approx(1e-3)
    assert red["busy_s"] == pytest.approx(4e-4)  # 100..450 and 600..650 on each card
    k1 = trace.kernel_seconds(red, "fast_nms_kernel", red["frame_streams"])
    assert k1 == pytest.approx(cards * 1e-4)  # the side stream's launch is not the frame's
    rec = {"trace": red, "bounds_ms": {"fast_nms": cards * 0.05}, "frame_streams":
           red["frame_streams"]}
    assert H.reader("fast_nms_roofline.fleet")(rec) == pytest.approx(50.0)
    assert H.reader("device_idle_pct.fleet")(rec) == pytest.approx(60.0)
