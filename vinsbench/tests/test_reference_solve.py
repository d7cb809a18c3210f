"""The plain window solve (``reference/estimator.py``) is the estimator's
solve: on windows tapped from the timed path of a tiny run on the CPU,
the program's own ``ops.solver.solve`` in float64 from the same inputs
(the IMU samples preintegrated by the program) lands where the reference
does, with the same cost; and the control (the reference in float32 with
TF32 operands) lands far from both."""

import pytest
import torch

from vins_rgbd_fast_torch.config import EstimatorConfig
from vins_rgbd_fast_torch.ops import imu_preintegration as imupre
from vins_rgbd_fast_torch.ops import solver as slv
from vinsbench import check
from vinsbench import harness as H
from vinsbench.reference import estimator as ref_est
from vinsbench.tests import tiny

D = torch.float64


def _f64(t):
    return type(t)(*[_f64(a) if isinstance(a, tuple) else
                     (a.to(D) if a.is_floating_point() else a) for a in t])


def _tapped_windows(cell, monkeypatch):
    c, cfg, tr = tiny.shrink(cell, **tiny.cell_size(cell))
    kept = []
    real = check.solve_numbers

    def keep(got, flags, control=False, block=8):
        kept.append(got)
        return real(got, flags, control, block)

    monkeypatch.setattr(check, "solve_numbers", keep)
    H.driver(tr["driver"]).run(tiny.ctx(c, cfg, tr, seconds=tiny.window_s(tr)))
    return cfg, tr, kept


@pytest.mark.parametrize("cell", ["robot-tum-vo-loop", "robot-realsense"])
def test_the_reference_solve_is_the_programs_solve(cell, monkeypatch):
    cfg, tr, kept = _tapped_windows(cell, monkeypatch)
    assert kept
    ecfg = EstimatorConfig.from_vins(H.vins_config(cfg, **tr.get("vins", {})))
    flags = check.solve_flags(cfg)
    for got in kept:
        s = got["solve"]
        x0 = _f64(s["x0"])
        imu = None
        if ecfg.use_imu:
            dts, acc, gyr = (got["imu"][k][:, 1:].to(D) for k in ("dts", "acc", "gyr"))
            pre = imupre.preintegrate(dts, acc, gyr, x0.Ba[:, :-1], x0.Bg[:, :-1],
                                      imupre.ImuNoise(ecfg.acc_n, ecfg.gyr_n, ecfg.acc_w,
                                                      ecfg.gyr_w))
            T = dts.sum(-1)
            imu = slv.ImuData(pre=pre, valid=(T > 0) & (T < 10.0))
        td_free = ((torch.linalg.norm(x0.V[:, 0], dim=-1) > 0.2).to(D) if ecfg.use_imu
                   else None)
        prog = slv.solve(ecfg.solver, x0, _f64(s["vis"]), imu, _f64(s["prior"]),
                         torch.tensor([0.0, 0.0, ecfg.g_norm], dtype=D),
                         relo=_f64(s["relo"]) if "relo" in s else None, td_free=td_free)
        w = check.solve_window(got)
        ref = ref_est.solve(w, flags)
        assert torch.allclose(prog.cost, ref["cost"], rtol=1e-6)
        same = ref_est.gaps({k: getattr(prog.x, k) for k in ("P", "Q", "V", "tic", "qic", "td")},
                            ref, flags.use_imu)
        assert same["solve_p_gap_mm"] < 0.01 and same["solve_q_gap_deg"] < 1e-4, same
        ctrl = ref_est.solve(w, flags, ref_est.Precision(torch.float32, tf32=True))
        far = ref_est.gaps(ctrl, ref, flags.use_imu)
        assert far["solve_p_gap_mm"] > 100 * same["solve_p_gap_mm"], (far, same)


def test_tf32_rounds_to_eleven_significant_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0 - 2 ** -9, 1e-20])
    y = ref_est.tf32(x)
    assert y.tolist()[:3] == [1.0, 1.0 + 2 ** -9, -3.0 - 2 ** -9]
    assert abs(y[3] - 1e-20) <= 1e-20 * 2 ** -11
