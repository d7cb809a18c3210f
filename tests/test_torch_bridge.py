"""The state bridge round trip, and the port's independence from JAX: every
module of ``vins_rgbd_fast_torch`` and ``chip_smoke`` import with JAX
blocked, and ``chip_smoke.py`` refuses to run without a GPU."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import jax
import numpy as np

from tests.torch_parity import f32
from vins_rgbd_fast_torch import bridge
from vins_rgbd_fast_tpu.backend import estimator as jest
from vins_rgbd_fast_tpu.frontend import feature_tracker as jft

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "vins_rgbd_fast_torch"


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == bool:
            return rng.random(a.shape) < 0.5
        if a.dtype.kind == "i":
            return rng.integers(-1, 50, a.shape).astype(a.dtype)
        return rng.normal(size=a.shape).astype(np.float32)
    return jax.tree.map(fill, tree)


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


def test_bridge_round_trip_is_identity():
    tcfg = jft.TrackerConfig(width=64, height=48, max_cnt=20)
    ecfg = jest.EstimatorConfig(maxf=24, max_imu=8)
    trk = _random_like(jax.device_get(f32(jft.init_state(tcfg))), 0)
    st = _random_like(jax.device_get(f32(jest.init_estimator_state(
        ecfg, np.eye(3), np.zeros(3), 0.0))), 1)
    for tree in (trk, st, bridge.stack([st, _random_like(st, 2)])):
        port = bridge.to_torch(tree)
        assert type(port).__module__.startswith("vins_rgbd_fast_torch")
        back = bridge.to_numpy(port)
        assert type(back).__name__ == type(tree).__name__
        assert back._fields == tree._fields
        _leaves_equal(back, tree)


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.startswith('vins_rgbd_fast_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    for p in list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py"]:
        assert not pat.search(p.read_text()), p


def test_chip_smoke_needs_a_gpu_and_the_repo(tmp_path):
    """Without CUDA the script exits non-zero and prints no result; alone
    in a directory it cannot even import the port."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", lone / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=lone, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_kernel_ab_needs_a_gpu():
    """The A/B timing script refuses to run without CUDA (exit 2), before
    it builds anything."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "kernel_ab.py", "--old", str(ROOT)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 2, res.stderr
    assert "CUDA is not available" in res.stderr
