"""Dataset writers: rosbag v2.0 files and TUM RGB-D directories (twin of
``vins_rgbd_fast_tpu/io/writers.py``, whose output it matches byte for
byte; ``tests/test_torch_io.py`` holds it so).

They let the real-data path (native bag parser → message decode → stream
pairing → pipeline → CSV) run end to end on rendered sequences in the
on-disk formats the reference consumes (D435i/OpenLORIS rosbags, TUM
directories), on a machine without JAX or ROS.  Beyond the JAX writer,
``serialize_image`` also writes ``rgb8``/``bgr8`` (which both readers
decode), and ``serialize_compressed_image`` JPEG through Pillow.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterable, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# rosbag v2.0 writer (uncompressed chunks; spec: http://wiki.ros.org/Bags/Format/2.0)
# ---------------------------------------------------------------------------


def _field(name: str, value: bytes) -> bytes:
    body = name.encode() + b"=" + value
    return struct.pack("<I", len(body)) + body


def _record(fields: dict, data: bytes) -> bytes:
    hdr = b"".join(_field(k, v) for k, v in fields.items())
    return struct.pack("<I", len(hdr)) + hdr + struct.pack("<I", len(data)) + data


def _time_field(t: float) -> bytes:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    if nsecs >= 1_000_000_000:
        secs += 1
        nsecs -= 1_000_000_000
    return struct.pack("<II", secs, nsecs)


def _ros_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def _ros_header(t: float, seq: int, frame_id: str = "cam") -> bytes:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    if nsecs >= 1_000_000_000:
        secs += 1
        nsecs -= 1_000_000_000
    return struct.pack("<III", seq, secs, nsecs) + _ros_string(frame_id)


def serialize_imu(t: float, acc, gyr, seq: int = 0) -> bytes:
    """sensor_msgs/Imu (orientation identity, covariances zero)."""
    out = _ros_header(t, seq, "imu")
    out += struct.pack("<4d", 0.0, 0.0, 0.0, 1.0)  # orientation xyzw
    out += struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *np.asarray(gyr, np.float64))
    out += struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *np.asarray(acc, np.float64))
    out += struct.pack("<9d", *([0.0] * 9))
    return out


def serialize_image(t: float, img: np.ndarray, encoding: str, seq: int = 0) -> bytes:
    """sensor_msgs/Image."""
    h, w = img.shape[:2]
    if encoding in ("mono8", "8UC1"):
        raw = np.ascontiguousarray(img, np.uint8).tobytes()
        step = w
    elif encoding in ("mono16", "16UC1"):
        raw = np.ascontiguousarray(img, np.uint16).tobytes()
        step = 2 * w
    elif encoding == "32FC1":
        raw = np.ascontiguousarray(img, np.float32).tobytes()
        step = 4 * w
    elif encoding in ("rgb8", "bgr8"):
        raw = np.ascontiguousarray(img, np.uint8).tobytes()
        step = 3 * w
    else:
        raise ValueError(encoding)
    out = _ros_header(t, seq, "cam")
    out += struct.pack("<II", h, w)
    out += _ros_string(encoding)
    out += struct.pack("<BI", 0, step)
    out += struct.pack("<I", len(raw)) + raw
    return out


def serialize_compressed_image(t: float, img: np.ndarray, seq: int = 0,
                               depth_transport: bool = False, fmt: str = "png") -> bytes:
    """sensor_msgs/CompressedImage with a PNG payload (the reference's
    Atlas200 compressed transport, launch/atlas200/*), or with ``fmt``
    "jpeg" a JPEG one (Pillow only).  With ``depth_transport`` the payload
    follows compressed_depth_image_transport: format "16UC1; compressedDepth
    png" and a 12-byte ConfigHeader before the PNG stream."""
    out = _ros_header(t, seq, "cam")
    if depth_transport:
        out += _ros_string("16UC1; compressedDepth png")
        data = struct.pack("<Iff", 0, 0.0, 0.0) + encode_png(
            np.ascontiguousarray(img, np.uint16))
    elif fmt == "jpeg":
        out += _ros_string("jpeg")
        data = _encode_jpeg(np.ascontiguousarray(img, np.uint8))
    else:
        out += _ros_string("png")
        data = encode_png(np.ascontiguousarray(img, np.uint8))
    out += struct.pack("<I", len(data)) + data
    return out


def _encode_jpeg(img: np.ndarray) -> bytes:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("writing JPEG payloads needs Pillow installed") from e
    import io

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


_MSG_MD5 = {
    "sensor_msgs/Imu": "6a62c6daae103f4ff57a132d6f95cec2",
    "sensor_msgs/Image": "060021388200f6f0f447d0fcd9c64743",
    "sensor_msgs/CompressedImage": "8f7a12909da2c9d3332d540a0977563f",
}


def write_rosbag(path: str, messages: Iterable[Tuple[str, str, float, bytes]],
                 chunk_size: int = 768 * 1024):
    """Write a rosbag v2.0 with uncompressed chunks.

    ``messages``: iterable of (topic, msg_type, stamp, serialized_payload),
    msg_type e.g. "sensor_msgs/Imu".  Messages are written in the given
    order; pass them time-sorted for a well-formed bag."""
    msgs = list(messages)
    topics = {}
    for (topic, typ, _, _) in msgs:
        if topic not in topics:
            topics[topic] = (len(topics), typ)

    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        # bag header record (op=0x03), padded to 4096 like real bags
        bag_hdr = _record(
            {"op": b"\x03", "index_pos": struct.pack("<Q", 0),
             "conn_count": struct.pack("<I", len(topics)),
             "chunk_count": struct.pack("<I", 0)},
            b"",
        )
        pad = 4096 - len(bag_hdr)
        f.write(_record(
            {"op": b"\x03", "index_pos": struct.pack("<Q", 0),
             "conn_count": struct.pack("<I", len(topics)),
             "chunk_count": struct.pack("<I", 0)},
            b" " * max(pad, 0),
        ))

        def connection_record(topic, conn_id, typ):
            conn_hdr = (
                _field("topic", topic.encode())
                + _field("type", typ.encode())
                + _field("md5sum", _MSG_MD5.get(typ, "0" * 32).encode())
                + _field("message_definition", b"")
            )
            return _record(
                {"op": b"\x07", "conn": struct.pack("<I", conn_id),
                 "topic": topic.encode()},
                conn_hdr,
            )

        # chunks: connection records first inside the first chunk (real
        # bags store connections inside chunks; readers accept either)
        pending = b"".join(
            connection_record(t, cid, typ) for t, (cid, typ) in topics.items()
        )
        t_lo: Optional[float] = None
        t_hi: Optional[float] = None

        def flush_chunk(payload: bytes, lo: float, hi: float):
            f.write(_record(
                {"op": b"\x05", "compression": b"none",
                 "size": struct.pack("<I", len(payload))},
                payload,
            ))
            # connection index records after each chunk are optional for
            # our reader; omitted (rosbag tools re-index with `rosbag reindex`)

        for (topic, typ, t, payload) in msgs:
            cid = topics[topic][0]
            rec = _record(
                {"op": b"\x02", "conn": struct.pack("<I", cid),
                 "time": _time_field(t)},
                payload,
            )
            pending += rec
            t_lo = t if t_lo is None else min(t_lo, t)
            t_hi = t if t_hi is None else max(t_hi, t)
            if len(pending) >= chunk_size:
                flush_chunk(pending, t_lo, t_hi)
                pending = b""
                t_lo = t_hi = None
        if pending:
            flush_chunk(pending, t_lo or 0.0, t_hi or 0.0)


# ---------------------------------------------------------------------------
# PNG writer (grayscale 8/16-bit, filter 0) + TUM RGB-D directory writer
# ---------------------------------------------------------------------------


def encode_png(img: np.ndarray) -> bytes:
    """Encode a grayscale PNG (uint8 or uint16, big-endian sample order)."""
    h, w = img.shape
    if img.dtype == np.uint16:
        depth = 16
        raw = img.astype(">u2").tobytes()
        stride = 2 * w
    else:
        depth = 8
        raw = np.ascontiguousarray(img, np.uint8).tobytes()
        stride = w
    scan = b"".join(
        b"\x00" + raw[y * stride:(y + 1) * stride] for y in range(h)
    )

    def chunk(ctype: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + ctype + data
                + struct.pack(">I", zlib.crc32(ctype + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(scan, 6)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray):
    """Write a grayscale PNG (uint8 or uint16, big-endian sample order)."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def write_tum_sequence(root: str, frames, depth_scale: float = 5000.0,
                       gt: Optional[list] = None):
    """Write a TUM RGB-D directory: rgb/, depth/, rgb.txt, depth.txt
    (+ groundtruth.txt).  ``frames``: iterable of (t, gray (H,W) float
    [0,255], depth_m (H,W) float meters)."""
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_lines = ["# color images", "# timestamp filename"]
    d_lines = ["# depth images", "# timestamp filename"]
    for (t, gray, depth_m) in frames:
        name = f"{t:.6f}.png"
        write_png(os.path.join(root, "rgb", name),
                  np.clip(np.asarray(gray), 0, 255).astype(np.uint8))
        dd = np.clip(np.asarray(depth_m) * depth_scale, 0, 65535).astype(np.uint16)
        write_png(os.path.join(root, "depth", name), dd)
        rgb_lines.append(f"{t:.6f} rgb/{name}")
        d_lines.append(f"{t:.6f} depth/{name}")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("\n".join(rgb_lines) + "\n")
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("\n".join(d_lines) + "\n")
    if gt is not None:
        with open(os.path.join(root, "groundtruth.txt"), "w") as f:
            f.write("# timestamp tx ty tz qx qy qz qw\n")
            for (t, P, Q) in gt:
                f.write(f"{t:.6f} {P[0]:.6f} {P[1]:.6f} {P[2]:.6f} "
                        f"{Q[1]:.6f} {Q[2]:.6f} {Q[3]:.6f} {Q[0]:.6f}\n")
