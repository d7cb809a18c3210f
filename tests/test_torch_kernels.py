"""The bound arithmetic of ``chip_smoke.py`` (bytes, operations and the
least time on one H100 for one launch of each kernel) against the hand
counts of the kernels' source notes, the helpers that count the work a
run's data needs, and the guards of the kernel wrappers that run before any
launch.  Exact integers for bytes; times within 0.2 % of the rounded hand
figures."""

import numpy as np
import pytest
import torch

import chip_smoke
from vins_rgbd_fast_torch.ops import fast, lk

# case: (kernel, B, H, W, N, iters, MB moved, bound in us, what sets the bound)
CASES = {
    "K1 8x480x640": ("fast_nms", 8, 480, 640, 200, 0, 19.66, 7.263, "operations"),
    "K1 1x480x640": ("fast_nms", 1, 480, 640, 200, 0, 2.458, 0.9078, "operations"),
    "K2 8x200 level 0": ("lk_level", 8, 480, 640, 200, 12, 12.99, 3.877, "bytes"),
    # the level images (2 x 8 x 240 x 320 floats) are smaller than the
    # 1,600 tiles and windows, and each pixel is read once
    "K2 8x200 level 1": ("lk_level", 8, 240, 320, 200, 6, 4.976, 1.4854, "bytes"),
    "K3 1x200": ("lk_iterate", 1, 480, 640, 200, 12, 2.223, 0.663, "bytes"),
    "K3 8x200": ("lk_iterate", 8, 480, 640, 200, 12, 17.78, 5.308, "bytes"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_bounds_match_hand_counts(case):
    name, B, H, W, N, iters, mb, us, by = CASES[case]
    b = chip_smoke.kernel_bounds(B, H, W, N, iters)[name]
    assert b["bytes"] / 1e6 == pytest.approx(mb, rel=2e-3)
    assert b["bound_ms"] * 1e3 == pytest.approx(us, rel=2e-3)
    assert b["bound_by"] == by
    t_bytes = b["bytes"] / chip_smoke.PEAK_BYTES_PER_S
    t_ops = b["ops"] / chip_smoke.PEAK_F32_PER_S
    assert b["bound_ms"] == pytest.approx(1e3 * max(t_bytes, t_ops))


def test_kernel_bounds_exact_counts():
    """The counts spelled out: K1 moves each pixel in and out once and does
    38 operations on it plus 80 for each polarity that needs its arc term;
    K2 moves each covered pixel of prev and cur once plus 38 bytes of
    per-point scalars; K3 three 21² patches and the window plus 45 bytes;
    the LK operations are 16 per sample and pass, one pass per step and one
    for the residual."""
    px, P = 8 * 480 * 640, 1600
    tmpl_ops = P * (8 * 23 * 23 + 8 * 441)
    b = chip_smoke.kernel_bounds(8, 480, 640, 200, 12)
    assert b["fast_nms"]["bytes"] == 8 * px and b["fast_nms"]["ops"] == (38 + 160) * px
    assert b["lk_level"]["bytes"] == 4 * P * (24 * 24 + 38 * 38) + P * 38
    assert b["lk_level"]["ops"] == P * 13 * 441 * 16 + tmpl_ops
    assert b["lk_iterate"]["bytes"] == P * (4 * (3 * 441 + 38 * 38) + 45)
    assert b["lk_iterate"]["ops"] == P * 13 * 441 * 16
    # what a run's data needs, where it is given
    d = chip_smoke.kernel_bounds(8, 480, 640, 200, 12, pairs=1000, footprint=(5000, 7000),
                                 steps=3000)
    assert d["fast_nms"]["ops"] == 38 * px + 80 * 1000
    assert d["lk_level"]["bytes"] == 4 * 12000 + P * 38
    assert d["lk_level"]["ops"] == (3000 + P) * 441 * 16 + tmpl_ops
    assert d["lk_iterate"]["ops"] == (3000 + P) * 441 * 16
    assert d["lk_iterate"]["bytes"] == b["lk_iterate"]["bytes"]


def test_fast_pairs_counts_the_pretest_survivors():
    """A lone bright pixel passes the dark pre-test and nothing else does;
    on texture every scoring pixel survives the pre-test."""
    img = torch.zeros((1, 20, 20))
    img[0, 10, 10] = 100.0
    assert chip_smoke.fast_pairs(img, 20.0) == 1
    rng = np.random.default_rng(5)
    tex = torch.from_numpy(rng.uniform(0, 255, (2, 40, 48)).astype(np.float32))
    n = chip_smoke.fast_pairs(tex, 20.0)
    assert int((fast.fast_score(tex, 20.0) > 0).sum()) <= n <= 2 * 2 * 34 * 42


@pytest.mark.parametrize("points, covered", [
    # two points one column apart: tiles 24 x 25, windows 38 x 39
    (((30.0, 30.0), (31.0, 30.0)), (24 * 25, 38 * 39)),
    # a corner: the clamped tile and window cover 13² and 20² pixels
    (((0.0, 0.0),), (13 * 13, 20 * 20)),
])
def test_k2_footprint_counts_each_pixel_once(points, covered):
    prev = torch.zeros((1, 60, 60))
    pts = torch.tensor([points], dtype=torch.float32)
    ax, ay = lk.window_anchor(pts, torch.zeros_like(pts), 60, 60, 21, 8)
    assert chip_smoke.k2_footprint(prev, pts, ax, ay) == covered


@pytest.mark.parametrize("eps, done, expect", [
    (1e9, False, "once"),   # every point stops after its first step
    (0.01, True, "never"),  # every point starts done
])
def test_gn_steps_counts_the_steps_taken(eps, done, expect):
    rng = np.random.default_rng(2)
    base = torch.from_numpy(rng.uniform(0, 255, (1, 64, 64)).astype(np.float32))
    prev = torch.nn.functional.avg_pool2d(base[None], 5, 1, 2)[0]
    cur = torch.roll(prev, (1, 2), dims=(-2, -1))
    pts = torch.tensor([[[20.0, 22.0], [40.0, 30.0], [30.0, 41.0]]])
    flow = torch.zeros_like(pts)
    ax, ay = lk.window_anchor(pts, flow, 64, 64, 21, 8)
    p = lk.level_patches(prev, cur, pts, ax, ay, 21, 8, 1e-4)
    done0 = torch.full((1, 3), done)
    steps = chip_smoke.gn_steps(lambda k: lk.lk_iterate_plain(
        p.tmpl, p.Ix, p.Iy, p.win_img, p.px, p.py, flow, done0, p.inv_det, p.Gxx, p.Gxy,
        p.Gyy, k, eps)[0], 5)
    assert steps == ([3, 0, 0, 0, 0] if expect == "once" else [0] * 5)


@pytest.mark.parametrize("win, search_margin", [(15, 8), (31, 8), (21, 14)])
def test_k2_wrapper_refuses_shapes_the_kernel_lacks(win, search_margin):
    """K2 is compiled for win = 21 and a window of at most 48 pixels; the
    wrapper raises before it touches a device."""
    img = torch.zeros((1, 60, 60))
    pts = torch.full((1, 3, 2), 30.0)
    act = torch.ones((1, 3), dtype=torch.bool)
    a = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="win=21"):
        lk._lk_level_cuda(img, img, pts, pts, act, a, a, win, search_margin, 4, 0.01, 1e-4)


@pytest.mark.parametrize("win, search_margin", [(15, 8), (21, 14)])
def test_k3_wrapper_refuses_shapes_the_kernel_lacks(win, search_margin):
    """K3 is compiled for win = 21 and a window of at most 48 pixels (21 with
    a margin of 14 makes 50); the wrapper raises before it touches a
    device."""
    WIN = win + 1 + 2 * search_margin
    p = torch.zeros((1, 3, win, win))
    s = torch.zeros((1, 3))
    with pytest.raises(ValueError, match="win=21"):
        lk._lk_iterate_cuda(p, p, p, torch.zeros((1, 3, WIN, WIN)), s, s,
                            torch.zeros((1, 3, 2)), s.bool(), s, s, s, s, 4, 0.01)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__ed9fa6c0_11_fast_nms_cu_30c4d4c115fast_nms_kernelEPKfPfiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__ed9fa6c0_11_fast_nms_cu_30c4d4c115fast_nms_kernelEPKfPfiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 39 registers, used 1 barriers, 31572 bytes smem
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__08154346_11_lk_level_cu_46d3495b17lk_iterate_kernelEPKfS1_S1_S1_S1_S1_S1_PKhS1_S1_S1_S1_PfS4_iif' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__08154346_11_lk_level_cu_46d3495b17lk_iterate_kernelEPKfS1_S1_S1_S1_S1_S1_PKhS1_S1_S1_S1_PfS4_iif
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 163 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__08154346_11_lk_level_cu_46d3495b15lk_level_kernelEPKfS1_S1_S1_PKhPKiS5_PfPhS6_iiiiiiff' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__08154346_11_lk_level_cu_46d3495b15lk_level_kernelEPKfS1_S1_S1_PKhPKiS5_PfPhS6_iiiiiiff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 0 barriers
"""


@pytest.mark.parametrize("B, M, nxp, mb, us", [(32, 376, 172, 27.794176, 8.2968),
                                               (1, 376, 178, 0.903464, 0.26969),
                                               (1, 48, 172, 0.31884, 0.095176)])
def test_proj_schur_bound_counts_each_byte_once(B, M, nxp, mb, us):
    """K4's bound: per sequence the window (85 floats) and Σ r² (one), per
    feature 284 bytes of grid, and the system read and written once; bytes
    set it at the main path's three shapes."""
    b = chip_smoke.proj_schur_bound(B, M, nxp, live=5 * B * M)
    system = 4 * (nxp * nxp + nxp * M + 2 * M + nxp)
    assert b["bytes"] == B * (340 + 284 * M + 2 * system + 4)
    assert b["bytes"] / 1e6 == pytest.approx(mb, rel=1e-6)
    assert b["bound_ms"] * 1e3 == pytest.approx(us, rel=2e-3)
    assert b["ops"] == chip_smoke.PROJ_FLOP_PER_FACTOR * 5 * B * M
    assert b["bound_by"] == "bytes"


def test_ptxas_usage_reads_k4_beside_its_finishing_kernel():
    """K4's two kernels are told apart by their mangled names."""
    log = PTXAS_LOG + """\
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__1a2b3c4d_13_proj_schur_cu_5e6f708117proj_schur_kernelEPKfS1_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__1a2b3c4d_13_proj_schur_cu_5e6f708124proj_schur_finish_kernelEPKfiS1_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 20 registers, used 0 barriers
"""
    u = chip_smoke.ptxas_usage(log)
    assert set(u) == set(chip_smoke.PTXAS_NAMES)
    assert u["proj_schur"]["registers"] == 96 and u["proj_schur_finish"]["registers"] == 20


def test_ptxas_usage_reads_each_kernel():
    """Phase 2's report of ``nvcc -Xptxas -v``: each kernel by its mangled
    name, its registers, static shared memory and spilled bytes."""
    u = chip_smoke.ptxas_usage(PTXAS_LOG)
    assert u == {
        "fast_nms": dict(registers=39, smem_bytes=31572, stack_bytes=0, spill_bytes=0),
        "lk_iterate": dict(registers=163, smem_bytes=0, stack_bytes=8, spill_bytes=16),
        "lk_level": dict(registers=128, smem_bytes=0, stack_bytes=0, spill_bytes=0)}
    assert chip_smoke.ptxas_usage("") == {}


def test_host_waits_counts_by_os_thread(tmp_path, monkeypatch):
    """``chip_smoke.host_waits`` reads the exported trace: waits of the
    span's own OS thread inside the span are named, those of other threads
    only counted, those outside the span ignored."""
    import json

    span = dict(name="span", cat="user_annotation", ph="X", ts=100.0, dur=50.0, tid=7)
    events = [span, dict(name="cudaStreamSynchronize", cat="cuda_runtime", ph="X", ts=110.0,
                         dur=2.0, tid=7),
              dict(name="cudaStreamSynchronize", cat="cuda_runtime", ph="X", ts=120.0, dur=3.0,
                   tid=9),
              dict(name="cudaEventSynchronize", cat="cuda_runtime", ph="X", ts=140.0, dur=1.0,
                   tid=9),
              dict(name="cudaLaunchKernel", cat="cuda_runtime", ph="X", ts=111.0, dur=1.0, tid=7),
              dict(name="cudaDeviceSynchronize", cat="cuda_runtime", ph="X", ts=151.0, dur=4.0,
                   tid=7)]

    class Prof:
        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": events}, f)

    monkeypatch.setattr(chip_smoke, "OUT_DIR", str(tmp_path))
    own, other = chip_smoke.host_waits(Prof(), "span")
    assert own == ["cudaStreamSynchronize"] and other == 2
    assert list(tmp_path.iterdir()) == []  # the trace is not kept
