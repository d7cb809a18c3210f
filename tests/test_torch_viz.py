"""The port's headless diagnostics (``vins_rgbd_fast_torch/io/viz.py``)
against JAX's ``io/viz.py`` on the same numpy inputs: the tracking overlay
and the extrinsic file byte for byte, the margin cloud of the same window
state (bridged) within 1e-9 m in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vins_rgbd_fast_torch import bridge
from vins_rgbd_fast_torch.io import viz as tviz
from vins_rgbd_fast_tpu.backend import estimator as jest
from vins_rgbd_fast_tpu.io import viz as jviz


@pytest.mark.parametrize("with_vel", [False, True])
def test_track_overlay_matches_jax(with_vel):
    rng = np.random.default_rng(4)
    img = rng.uniform(20, 230, (60, 80)).astype(np.float32)
    uv = np.concatenate([rng.uniform([-4, -4], [84, 64], (40, 2)), [[0, 0], [79, 59]]])
    valid = rng.random(42) > 0.2
    cnt = rng.integers(0, 40, 42)
    vel = rng.normal(0, 2, (42, 2)) if with_vel else None
    out = tviz.draw_track_overlay(img, uv, valid, cnt, vel=vel)
    assert out.dtype == np.uint8 and out.shape == (60, 80, 3)
    np.testing.assert_array_equal(out, jviz.draw_track_overlay(img, uv, valid, cnt, vel=vel))


class _Estimator:  # what margin_cloud reads: ``state``
    def __init__(self, state):
        self.state = state


def test_margin_cloud_matches_jax():
    """A window state with a rotated, offset extrinsic and pose and rows
    anchored at the oldest frame and later, in JAX's layout and bridged."""
    rng = np.random.default_rng(6)
    cfg = jest.EstimatorConfig(maxf=16, max_imu=8, acc_n=0.1, gyr_n=0.01, acc_w=1e-4,
                               gyr_w=1e-5)
    ric = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    st = jax.device_get(jest.init_estimator_state(cfg, ric, np.array([0.05, 0.02, 0.01]),
                                                  0.0, jnp.float64))
    t, x = st.table, st.x
    n = 10
    ids = np.full(16, -1, np.int32)
    ids[:n] = np.arange(n) + 3
    start = np.where(np.arange(16) % 3 == 0, 0, 2).astype(np.int32)
    dep = np.where(np.arange(16) == 4, -1.0, rng.uniform(1, 5, 16))
    pts = np.asarray(t.pts).copy()
    pts[:, 0] = rng.uniform(-0.5, 0.5, (16, 2))
    q = np.array([0.9, 0.1, -0.2, 0.3])
    Q = np.asarray(x.Q).copy()
    Q[0] = q / np.linalg.norm(q)
    P = np.asarray(x.P).copy()
    P[0] = [0.4, -1.2, 0.3]
    st = st._replace(table=t._replace(ids=ids, start=start, est_depth=dep, pts=pts),
                     x=x._replace(P=P, Q=Q))
    ref = jviz.margin_cloud(_Estimator(jax.tree.map(jnp.asarray, st)))
    out = tviz.margin_cloud(_Estimator(bridge.to_torch(bridge.stack([st]))))
    assert ref.shape == out.shape and out.shape[0] >= 2
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-9)
    empty = st._replace(table=st.table._replace(ids=np.full(16, -1, np.int32)))
    assert tviz.margin_cloud(_Estimator(bridge.to_torch(bridge.stack([empty])))).shape == (0, 3)


def test_extrinsic_yaml_matches_jax(tmp_path):
    ric = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    tic = np.array([0.05, 0.02, 0.01])
    tviz.write_extrinsic_yaml(str(tmp_path / "t.yaml"), ric, tic, td=0.0031)
    jviz.write_extrinsic_yaml(str(tmp_path / "j.yaml"), ric, tic, td=0.0031)
    assert (tmp_path / "t.yaml").read_bytes() == (tmp_path / "j.yaml").read_bytes()
