"""The port's native host runtime: C++ built on first use, bound with
ctypes (twin of ``vins_rgbd_fast_tpu/runtime/__init__.py``).

``csrc/stream_runtime.cpp`` (stamp pairing, rate gates, IMU intervals) and
``csrc/bag_reader.cpp`` (the rosbag v2.0 container) are copies of the JAX
package's sources; ``csrc/png_unfilter.cpp`` undoes the PNG row filters for
``io/images.decode_png``.  Each builds with ``g++ -O2 -shared -fPIC
-std=c++17`` into ``vins_rgbd_fast_torch/build/runtime/`` the first time it
is used, never at import.  Two things differ from JAX's ``_build``: a
failed build raises ``RuntimeError`` with the compiler's message (nothing
falls back to Python), and the library is written to a temporary file
beside its target and renamed into place, so processes that build it at
the same time each load a whole library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD = os.path.join(os.path.dirname(_DIR), "build", "runtime")
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_libs: dict = {}
_lock = threading.Lock()

_c_double_p = ctypes.POINTER(ctypes.c_double)
_c_int64_p = ctypes.POINTER(ctypes.c_int64)
_c_int_p = ctypes.POINTER(ctypes.c_int)
_c_uint8_p = ctypes.POINTER(ctypes.c_uint8)


def _build(name: str, src: str) -> str:
    """Compile ``csrc/<src>`` into ``build/runtime/<name>`` unless a library
    newer than the source is there; returns its path or raises."""
    os.makedirs(BUILD, exist_ok=True)
    out = os.path.join(BUILD, name)
    src_path = os.path.join(CSRC, src)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src_path):
        return out
    fd, tmp = tempfile.mkstemp(prefix=name + ".", suffix=".tmp", dir=BUILD)
    os.close(fd)
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, src_path, "-o", tmp],
                             capture_output=True, text=True, timeout=240)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {src} ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
    except FileNotFoundError as e:  # no g++ on the PATH
        raise RuntimeError(f"g++ could not be run to build {src}: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load(name: str, src: str, signatures: dict) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(_build(name, src))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return _libs[name]


def stream_lib() -> ctypes.CDLL:
    vp, d = ctypes.c_void_p, ctypes.c_double
    return _load("libvins_runtime.so", "stream_runtime.cpp", {
        "vins_stream_create": (vp, [d] * 4),
        "vins_stream_destroy": (None, [vp]),
        "vins_stream_push_image": (None, [vp, d, ctypes.c_int64]),
        "vins_stream_push_depth": (None, [vp, d, ctypes.c_int64]),
        "vins_stream_push_imu": (ctypes.c_int, [vp, d, _c_double_p, _c_double_p]),
        "vins_stream_imu_available": (ctypes.c_int, [vp, d]),
        "vins_stream_next_frame": (ctypes.c_int, [vp, _c_double_p, _c_int64_p, _c_int64_p,
                                                  _c_int_p, _c_int_p]),
        "vins_stream_collect_interval": (ctypes.c_int, [vp, d, d, ctypes.c_int, _c_double_p,
                                                        _c_double_p, _c_double_p]),
    })


def bag_lib() -> ctypes.CDLL:
    vp, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
    return _load("libvins_bag.so", "bag_reader.cpp", {
        "vins_bag_open": (vp, [s]),
        "vins_bag_error": (s, [vp]),
        "vins_bag_num_messages": (i, [vp]),
        "vins_bag_num_connections": (i, [vp]),
        "vins_bag_connection": (i, [vp, i, s, i, s, i]),
        "vins_bag_message_info": (i, [vp, i, _c_int_p, _c_double_p]),
        "vins_bag_message_data": (i, [vp, i, _c_uint8_p, i]),
        "vins_bag_close": (None, [vp]),
    })


def png_lib() -> ctypes.CDLL:
    i = ctypes.c_int
    return _load("libvins_png.so", "png_unfilter.cpp", {
        "vins_png_unfilter": (i, [_c_uint8_p, i, i, i, _c_uint8_p]),
    })


class NativeStreamRuntime:
    """ctypes front for the C++ stream runtime (the pairer and the IMU
    interval assembly of ``io/stream.py`` and the estimator, natively)."""

    def __init__(self, frontend_freq=20.0, publish_freq=10.0, pair_tol=0.003, gap_reset=1.0):
        lib = stream_lib()
        self._lib = lib
        self._ctx = lib.vins_stream_create(frontend_freq, publish_freq, pair_tol, gap_reset)
        self._payloads: dict = {}
        self._next_id = 0

    def __del__(self):
        try:
            self._lib.vins_stream_destroy(self._ctx)
        except Exception:
            pass

    def _store(self, arr) -> int:
        pid = self._next_id
        self._next_id += 1
        self._payloads[pid] = arr
        return pid

    def push_image(self, t: float, image):
        self._lib.vins_stream_push_image(self._ctx, t, self._store(image))

    def push_depth(self, t: float, depth):
        self._lib.vins_stream_push_depth(self._ctx, t, self._store(depth))

    def push_imu(self, t: float, acc, gyr) -> bool:
        a = np.ascontiguousarray(acc, np.float64)
        g = np.ascontiguousarray(gyr, np.float64)
        return bool(self._lib.vins_stream_push_imu(
            self._ctx, t, a.ctypes.data_as(_c_double_p), g.ctypes.data_as(_c_double_p)))

    def imu_available(self, t: float) -> bool:
        return bool(self._lib.vins_stream_imu_available(self._ctx, t))

    def next_frame(self):
        t, ip, dp = ctypes.c_double(), ctypes.c_int64(), ctypes.c_int64()
        pub, rst = ctypes.c_int(), ctypes.c_int()
        ok = self._lib.vins_stream_next_frame(self._ctx, ctypes.byref(t), ctypes.byref(ip),
                                              ctypes.byref(dp), ctypes.byref(pub),
                                              ctypes.byref(rst))
        if not ok:
            return None
        img = self._payloads.pop(ip.value)
        dep = self._payloads.pop(dp.value)
        return dict(t=t.value, image=img, depth=dep, publish=bool(pub.value),
                    reset=bool(rst.value))

    def collect_interval(self, t0: float, t1: float, maxi: int):
        dts = np.zeros(maxi, np.float64)
        acc = np.zeros((maxi + 1, 3), np.float64)
        gyr = np.zeros((maxi + 1, 3), np.float64)
        self._lib.vins_stream_collect_interval(
            self._ctx, t0, t1, maxi, dts.ctypes.data_as(_c_double_p),
            acc.ctypes.data_as(_c_double_p), gyr.ctypes.data_as(_c_double_p))
        return dts, acc, gyr
