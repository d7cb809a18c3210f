"""The port's native host runtime (``vins_rgbd_fast_torch/runtime``) against
the JAX package's (``vins_rgbd_fast_tpu/runtime``) and against the port's
Python stream pairer and IMU buffer, on the cases of
``tests/test_runtime_native.py`` and ``tests/test_rosbag_golden.py``.

Exact throughout: the C++ sources are the same code, and pairing, gates
and intervals are comparisons and copies.  A failed ``g++`` build raises
with the compiler's message; nothing here skips on a failed build.
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from tests.test_rosbag_golden import _build_golden_bag
from tests.test_runtime_native import _bag_record, _write_tiny_bag
from vins_rgbd_fast_torch import runtime as trt
from vins_rgbd_fast_torch.backend.estimator import ImuIntervalBuffer
from vins_rgbd_fast_torch.io import rosbag as trb
from vins_rgbd_fast_torch.io import stream as tstream
from vins_rgbd_fast_tpu import runtime as jrt
from vins_rgbd_fast_tpu.io import rosbag as jrb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _code(path: str) -> bytes:
    """A C++ file without its leading ``//`` comment block."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    k = 0
    while lines[k].startswith(b"//"):
        k += 1
    return b"\n".join(lines[k:])


@pytest.mark.parametrize("name", ["bag_reader.cpp", "stream_runtime.cpp"])
def test_csrc_copies_match_jax(name):
    """The port's copies are JAX's code byte for byte below the header comment."""
    port = os.path.join(ROOT, "vins_rgbd_fast_torch", "runtime", "csrc", name)
    orig = os.path.join(ROOT, "vins_rgbd_fast_tpu", "runtime", "csrc", name)
    assert _code(port) == _code(orig)


def _frames(rt):
    out = []
    while True:
        f = rt.next_frame()
        if f is None:
            return out
        if isinstance(f, dict):
            out.append((round(f["t"], 6), f["publish"], f["reset"], float(f["image"][0, 0])))
        else:
            out.append((round(f.t, 6), f.publish, rt.consume_reset(), float(f.image[0, 0])))


@pytest.mark.parametrize("times,freqs", [
    ([k / 30.0 for k in range(40)], (20.0, 10.0)),  # a 30 Hz stream through the 20 Hz gate
    ([0.0, 0.05, 5.0, 5.05], (0.0, 0.0)),  # a 5 s gap: reset
    ([0.0, 0.05, 0.10, 0.07, 0.12], (0.0, 0.0)),  # time going backwards: reset
], ids=["gates", "gap", "backwards"])
def test_stream_runtime_matches_pairer_and_jax(times, freqs):
    port = trt.NativeStreamRuntime(frontend_freq=freqs[0], publish_freq=freqs[1])
    jax_rt = jrt.NativeStreamRuntime(frontend_freq=freqs[0], publish_freq=freqs[1])
    py = tstream.StreamPairer(frontend_freq=freqs[0], publish_freq=freqs[1])
    for k, t in enumerate(times):
        img = np.full((2, 2), k, np.float32)
        dep = np.ones((2, 2), np.float32)
        for rt in (port, jax_rt):
            rt.push_image(t, img)
            rt.push_depth(t + 0.001, dep)
        py.push_image(tstream.ImageMsg(t=t, image=img))
        py.push_depth(tstream.DepthMsg(t=t + 0.001, depth=dep))
    got = _frames(port)
    assert got == _frames(jax_rt)
    assert got == _frames(py)
    assert len(got) > 0


def test_interval_matches_imu_buffer_and_jax():
    rng = np.random.default_rng(0)
    ts = np.cumsum(rng.uniform(0.004, 0.006, 40))
    accs = rng.normal(0, 1, (40, 3))
    gyrs = rng.normal(0, 0.1, (40, 3))
    buf = ImuIntervalBuffer(32)
    port, jax_rt = trt.NativeStreamRuntime(), jrt.NativeStreamRuntime()
    for t, a, g in zip(ts, accs, gyrs):
        buf.push(t, a, g)
        assert port.push_imu(t, a, g) == jax_rt.push_imu(t, a, g)
    assert port.imu_available(float(ts[-1])) and not port.imu_available(float(ts[-1]) + 0.1)
    for t0, t1 in ((float(ts[5]), float(ts[25])), (float(ts[0]) - 0.01, float(ts[3]) + 0.001)):
        got = port.collect_interval(t0, t1, 32)
        for a, b in zip(got, jax_rt.collect_interval(t0, t1, 32)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got, buf.collect(t0, t1)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def _messages(reader):
    return [(topic, stamp, payload) for topic, stamp, payload in reader.messages()]


def _order_bag(path):
    """test_runtime_native's out-of-order bag: 101.1 s written before 100.9 s."""
    conn = b""
    for k, v in {"topic": b"/imu", "type": b"sensor_msgs/Imu", "md5sum": b"0",
                 "message_definition": b""}.items():
        field = k.encode() + b"=" + v
        conn += struct.pack("<I", len(field)) + field
    conn = _bag_record({"op": b"\x07", "conn": struct.pack("<I", 0), "topic": b"/imu"}, conn)

    def msg(secs, nsecs, payload):
        return _bag_record({"op": b"\x02", "conn": struct.pack("<I", 0),
                            "time": struct.pack("<II", secs, nsecs)}, payload)

    inner = conn + msg(101, 100_000_000, b"late") + msg(100, 900_000_000, b"early")
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(_bag_record({"op": b"\x05", "compression": b"none",
                             "size": struct.pack("<I", len(inner))}, inner))


@pytest.mark.parametrize("build", [_build_golden_bag, _write_tiny_bag, _order_bag],
                         ids=["golden", "tiny", "order"])
def test_bag_readers_agree(tmp_path, build):
    path = str(tmp_path / "x.bag")
    build(path)
    port, ref = trb.BagReader(path), jrb.BagReader(path)
    assert port.topics() == ref.topics()
    assert len(port) == len(ref)
    got = _messages(port)
    assert got == _messages(ref) and len(got) >= 2
    assert [m[1] for m in got] == sorted(m[1] for m in got)


def test_golden_bag_decodes_exactly(tmp_path):
    """test_rosbag_golden's hand-built bytes through the port's decoders."""
    path = str(tmp_path / "golden.bag")
    _build_golden_bag(path)
    msgs = _messages(trb.BagReader(path))
    np.testing.assert_allclose([m[1] for m in msgs], [100.999999999, 101.0, 102.5], atol=1e-9)
    for m in msgs[:2]:
        t, acc, gyr = trb.decode_imu(m[2])
        assert abs(t - m[1]) < 1e-9
        np.testing.assert_array_equal(acc, [0.1, 0.2, 9.8])
        np.testing.assert_array_equal(gyr, [0.01, -0.02, 0.03])
    t, enc, img = trb.decode_image(msgs[2][2])
    assert enc == "mono8" and abs(t - 102.5) < 1e-9
    np.testing.assert_array_equal(img, np.arange(12, dtype=np.uint8).reshape(3, 4))


@pytest.mark.parametrize("how", ["compiler fails", "no compiler"])
def test_failed_build_raises(tmp_path, monkeypatch, how):
    """No fallback: a build that fails raises RuntimeError with the
    compiler's message, and ``BagReader`` does not open."""
    _write_tiny_bag(str(tmp_path / "tiny.bag"))
    monkeypatch.setattr(trt, "BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(trt, "_libs", {})
    if how == "compiler fails":
        monkeypatch.setattr(trt, "CXX_FLAGS", trt.CXX_FLAGS + ["-fno-such-flag"])
        match = "(?s)g\\+\\+ failed on bag_reader.cpp.*no-such-flag"
    else:
        monkeypatch.setenv("PATH", str(tmp_path))
        match = "g\\+\\+ could not be run"
    with pytest.raises(RuntimeError, match=match):
        trb.BagReader(str(tmp_path / "tiny.bag"))
    assert os.listdir(str(tmp_path / "build")) == []  # no partial library left behind


def test_concurrent_builds_each_load_a_whole_library(tmp_path):
    """Three processes build the same library into one empty directory at
    once (the test workers do); each loads it and reads a bag."""
    _write_tiny_bag(str(tmp_path / "tiny.bag"))
    code = ("import sys; from vins_rgbd_fast_torch import runtime as r; "
            "r.BUILD = sys.argv[1]; from vins_rgbd_fast_torch.io.rosbag import BagReader; "
            "print(len(list(BagReader(sys.argv[2]).messages())))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "build"),
                               str(tmp_path / "tiny.bag")], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    assert [o[0].strip() for o in outs] == ["2", "2", "2"]
    assert os.listdir(str(tmp_path / "build")) == ["libvins_bag.so"]
