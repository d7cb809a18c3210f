"""The control comes out not correct: the reference put in the program's
place one precision below the float32 the configurations state (the
frontend in bfloat16, the window solve in float32 with TF32 operands)
fails a number of each cell that it is read in, while the program's own
readings of the same run pass.  On the card the same readings come
from ``python -m vinsbench.control`` at the cells' own sizes."""

import pytest

from vinsbench import check
from vinsbench import harness as H
from vinsbench.control import control_readings
from vinsbench.tests import tiny

LIMITS = dict(k1_off_corner=check.K1_LIMIT, lk_gap_px=check.LK_GAP_LIMIT_PX)


@pytest.mark.parametrize("cell", ["fleet-tum-vo-b32", "robot-tum-vo-loop", "robot-realsense"])
def test_the_control_fails_where_the_program_passes(cell):
    c, cfg, tr = tiny.shrink(cell, **tiny.cell_size(cell))
    res = H.driver(tr["driver"]).run(tiny.ctx(c, cfg, tr, seconds=tiny.window_s(tr),
                                              control=True))
    assert H.passes(res.checks), res.checks
    limits = dict(LIMITS, **check.solve_limits(check.solve_flags(cfg)))
    ctrl = control_readings(res.rec)
    assert ctrl and all(k in limits for k in ctrl)
    assert any(v > limits[k] for k, v in ctrl.items()), ctrl
    # the window solve's control fails its numbers on its own
    assert any(v > limits[k] for k, v in ctrl.items() if k.startswith("solve_")), ctrl
