"""rosbag v2.0 replay (twin of ``vins_rgbd_fast_tpu/io/rosbag.py``): the
native container parser (``runtime/csrc/bag_reader.cpp``) and the
decoding of the ROS 1 messages the pipeline consumes (sensor_msgs/Imu,
sensor_msgs/Image and sensor_msgs/CompressedImage) into numpy arrays.

The reference consumes its D435i/OpenLORIS datasets through live ROS
topics; this replays the same ``.bag`` files with no ROS.  The parser is
built with ``g++`` on first use and a failed build raises.  PNG payloads
(image_transport "png" and compressed_depth_image_transport) are decoded
by the port's own decoder; JPEG ones need Pillow (``io/images.py``).
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..runtime import bag_lib
from ..utils.timing import TRACER
from .images import PNG_MAGIC, decode_depth as _decode_png16, decode_gray
from .stream import decode_depth


class BagReader:
    """Iterates (topic, stamp, raw_payload) over a rosbag v2.0 file."""

    def __init__(self, path: str):
        lib = bag_lib()
        self._lib = lib
        self._ctx = lib.vins_bag_open(path.encode())
        err = lib.vins_bag_error(self._ctx).decode()
        if err:
            raise IOError(f"bag open failed: {err}")
        self._conn_topic: Dict[int, str] = {}
        self._conn_type: Dict[int, str] = {}
        for i in range(lib.vins_bag_num_connections(self._ctx)):
            topic = ctypes.create_string_buffer(256)
            typ = ctypes.create_string_buffer(256)
            conn = lib.vins_bag_connection(self._ctx, i, topic, 256, typ, 256)
            if conn >= 0:
                self._conn_topic[conn] = topic.value.decode()
                self._conn_type[conn] = typ.value.decode()

    def __del__(self):
        try:
            self._lib.vins_bag_close(self._ctx)
        except Exception:
            pass

    def topics(self) -> Dict[str, str]:
        return {t: self._conn_type[c] for c, t in self._conn_topic.items()}

    def __len__(self) -> int:
        return self._lib.vins_bag_num_messages(self._ctx)

    def messages(self) -> Iterator[Tuple[str, float, bytes]]:
        """The messages in time order.  The generator holds the reader, so
        the native handle stays open while it is iterated."""
        n = len(self)
        conn = ctypes.c_int()
        stamp = ctypes.c_double()
        for i in range(n):
            size = self._lib.vins_bag_message_info(self._ctx, i, ctypes.byref(conn),
                                                   ctypes.byref(stamp))
            if size < 0:
                continue
            buf = (ctypes.c_uint8 * size)()
            self._lib.vins_bag_message_data(self._ctx, i, buf, size)
            yield self._conn_topic.get(conn.value, "?"), stamp.value, bytes(buf)


# ---------------------------------------------------------------------------
# ROS 1 message decoding (little-endian serialized streams)
# ---------------------------------------------------------------------------


def _read_string(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return buf[off:off + n].decode(errors="replace"), off + n


def _read_header(buf: bytes, off: int) -> Tuple[float, str, int]:
    """std_msgs/Header: seq(u32), stamp(sec u32, nsec u32), frame_id(string)."""
    seq, sec, nsec = struct.unpack_from("<III", buf, off)
    off += 12
    frame_id, off = _read_string(buf, off)
    return sec + 1e-9 * nsec, frame_id, off


def decode_imu(payload: bytes):
    """sensor_msgs/Imu -> (stamp, acc (3,), gyr (3,))."""
    stamp, _, off = _read_header(payload, 0)
    off += 4 * 8 + 9 * 8  # orientation (4 f64) + its covariance (9 f64)
    gyr = np.frombuffer(payload, np.float64, 3, off)
    off += 3 * 8 + 9 * 8
    acc = np.frombuffer(payload, np.float64, 3, off)
    return stamp, np.asarray(acc), np.asarray(gyr)


def decode_image(payload: bytes):
    """sensor_msgs/Image -> (stamp, encoding, array (H,W) or (H,W,C))."""
    stamp, _, off = _read_header(payload, 0)
    height, width = struct.unpack_from("<II", payload, off)
    off += 8
    encoding, off = _read_string(payload, off)
    off += 1 + 4  # is_bigendian (u8) + step (u32)
    (n,) = struct.unpack_from("<I", payload, off)
    off += 4
    raw = payload[off:off + n]
    if encoding in ("mono8", "8UC1"):
        img = np.frombuffer(raw, np.uint8).reshape(height, width)
    elif encoding in ("mono16", "16UC1"):
        img = np.frombuffer(raw, np.uint16).reshape(height, width)
    elif encoding == "32FC1":
        img = np.frombuffer(raw, np.float32).reshape(height, width)
    elif encoding in ("rgb8", "bgr8"):
        img = np.frombuffer(raw, np.uint8).reshape(height, width, 3)
    else:
        raise ValueError(f"unsupported image encoding {encoding}")
    return stamp, encoding, img


def decode_compressed_image(payload: bytes):
    """sensor_msgs/CompressedImage -> (stamp, format, array).

    Plain image_transport payloads (PNG or JPEG bytes) decode to grey
    float32; compressed_depth_image_transport ("...; compressedDepth png")
    prepends a 12-byte ConfigHeader (format enum u32 + 2 f32 quantization
    parameters) to a 16UC1 PNG, which decodes to float32 millimetres."""
    stamp, _, off = _read_header(payload, 0)
    fmt, off = _read_string(payload, off)
    (n,) = struct.unpack_from("<I", payload, off)
    off += 4
    data = payload[off:off + n]
    if "compressedDepth" in fmt:
        body = data[12:] if not data.startswith(PNG_MAGIC) else data
        if not body.startswith(PNG_MAGIC):
            raise ValueError(f"compressedDepth payload is not PNG ({fmt!r})")
        return stamp, fmt, _decode_png16(body)
    return stamp, fmt, decode_gray(data)


def to_grayscale(img: np.ndarray, encoding: str) -> np.ndarray:
    if img.ndim == 2:
        return img.astype(np.float32)
    # rgb8/bgr8: luminance (the reference converts with cv_bridge mono8)
    w = np.asarray([0.299, 0.587, 0.114], np.float32)
    if encoding == "bgr8":
        w = w[::-1]
    return img.astype(np.float32) @ w


def replay_into_pipeline(bag: BagReader, pipeline, image_topic: str, depth_topic: str,
                         imu_topic: str, max_messages: Optional[int] = None):
    """Feed a bag into a ``VinsPipeline`` in time order; each depth message
    is followed by one ``spin_once``.

    Raw and compressed transports replay: topics typed
    ``sensor_msgs/CompressedImage`` are decoded as PNG (or JPEG, with
    Pillow), and a topic also matches as ``<topic>/compressed`` or
    ``<topic>/compressedDepth``.  The decoding of the image and depth
    messages is traced as the span ``io::decode`` (``utils/timing``)."""
    types = bag.topics()

    def _match(topic, want):
        return topic in (want, want + "/compressed", want + "/compressedDepth")

    count = 0
    for topic, stamp, payload in bag.messages():
        if max_messages is not None and count >= max_messages:
            break
        count += 1
        compressed = types.get(topic, "") == "sensor_msgs/CompressedImage"
        if topic == imu_topic:
            t, acc, gyr = decode_imu(payload)
            pipeline.push_imu(t, acc, gyr)
        elif _match(topic, image_topic):
            with TRACER.span("io::decode"):
                if compressed:
                    t, _, img = decode_compressed_image(payload)
                    img = img.astype(np.float32)
                else:
                    t, enc, img = decode_image(payload)
                    img = to_grayscale(img, enc)
            pipeline.push_image(t, img)
        elif _match(topic, depth_topic):
            with TRACER.span("io::decode"):
                if compressed:
                    t, _, img = decode_compressed_image(payload)
                    dep = decode_depth(img.astype(np.uint16), "16UC1")
                else:
                    t, enc, img = decode_image(payload)
                    dep = decode_depth(img, enc)
            pipeline.push_depth(t, dep)
            pipeline.spin_once()
