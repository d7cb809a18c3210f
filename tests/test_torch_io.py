"""The port's real-data I/O (``vins_rgbd_fast_torch/io``: writers, images,
tum, rosbag, the trajectory writers of stream, and the rig file's topics
and fisheye mask in config) against the JAX package's modules on the same
inputs, made from a numpy seed.

Exact throughout: writers byte for byte, readers and decoders array for
array.  The JAX modules decode with PIL (and its TUM reader with imageio
first); the port's PNG decoder is its own.  The PNGs with filter types 1-4
come from ``chip_smoke.encode_png_rows`` (the writers use type 0 only).
"""

import dataclasses
import io
import os
import sys

import numpy as np
import pytest

import chip_smoke
from vins_rgbd_fast_torch import config as tconfig
from vins_rgbd_fast_torch.io import images as timages
from vins_rgbd_fast_torch.io import rosbag as trb
from vins_rgbd_fast_torch.io import stream as tstream
from vins_rgbd_fast_torch.io import tum as ttum
from vins_rgbd_fast_torch.io import writers as tw
from vins_rgbd_fast_tpu import config as jconfig
from vins_rgbd_fast_tpu.io import images as jimages
from vins_rgbd_fast_tpu.io import rosbag as jrb
from vins_rgbd_fast_tpu.io import stream as jstream
from vins_rgbd_fast_tpu.io import tum as jtum
from vins_rgbd_fast_tpu.io import writers as jw

RNG = np.random.default_rng(0)
H, W = 24, 32
GRAY8 = RNG.integers(0, 256, (H, W), dtype=np.uint8)
GRAY16 = RNG.integers(0, 65536, (H, W), dtype=np.uint16)
RGB8 = RNG.integers(0, 256, (H, W, 3), dtype=np.uint8)
DEPTH_M = RNG.uniform(0.2, 9.0, (H, W)).astype(np.float32)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _messages(n=4, t0=100.25):
    """(topic, type, stamp, payload maker args) of a small RGB-D + IMU stream."""
    out = []
    for k in range(n):
        t = t0 + 0.05 * k
        for j in range(10):
            ti = t + 0.005 * j
            out.append(("/imu", "sensor_msgs/Imu", ti,
                        ("imu", ti, RNG.normal(size=3), RNG.normal(size=3), j)))
        out.append(("/cam", "sensor_msgs/Image", t, ("image", t, GRAY8, "mono8", k)))
        out.append(("/depth", "sensor_msgs/Image", t, ("image", t, GRAY16, "16UC1", k)))
        out.append(("/depth/compressedDepth", "sensor_msgs/CompressedImage", t,
                    ("compressed", t, GRAY16, k, True)))
        out.append(("/cam/compressed", "sensor_msgs/CompressedImage", t,
                    ("compressed", t, GRAY8, k, False)))
    return out


def _serialize(mod, spec):
    kind, *args = spec
    return {"imu": mod.serialize_imu, "image": mod.serialize_image,
            "compressed": mod.serialize_compressed_image}[kind](*args)


@pytest.mark.parametrize("spec", [
    ("imu", 1.6e9 + 0.123456, [0.1, 0.2, 9.8], [0.01, -0.02, 0.03], 7),
    ("image", 3.5, GRAY8, "mono8", 1), ("image", 3.5, GRAY8, "8UC1", 1),
    ("image", 3.5, GRAY16, "mono16", 2), ("image", 3.5, GRAY16, "16UC1", 2),
    ("image", 3.5, DEPTH_M, "32FC1", 3),
    ("compressed", 4.0, GRAY8, 5, False), ("compressed", 4.0, GRAY16, 5, True),
], ids=["imu", "mono8", "8UC1", "mono16", "16UC1", "32FC1", "png", "compressedDepth"])
def test_serializers_match_jax(spec):
    assert _serialize(tw, spec) == _serialize(jw, spec)


def test_rosbag_and_png_writers_match_jax(tmp_path):
    msgs = _messages()
    port = [(topic, typ, t, _serialize(tw, spec)) for topic, typ, t, spec in msgs]
    ref = [(topic, typ, t, _serialize(jw, spec)) for topic, typ, t, spec in msgs]
    tw.write_rosbag(str(tmp_path / "t.bag"), port, chunk_size=4096)
    jw.write_rosbag(str(tmp_path / "j.bag"), ref, chunk_size=4096)
    assert _read(tmp_path / "t.bag") == _read(tmp_path / "j.bag")
    for img in (GRAY8, GRAY16):
        assert tw.encode_png(img) == jw.encode_png(img)
        tw.write_png(str(tmp_path / "t.png"), img)
        jw.write_png(str(tmp_path / "j.png"), img)
        assert _read(tmp_path / "t.png") == _read(tmp_path / "j.png")


def test_tum_writer_matches_jax(tmp_path):
    frames = [(1.0 + k / 30.0, GRAY8.astype(np.float32) + 0.4, DEPTH_M) for k in range(3)]
    gt = [(f[0], RNG.normal(size=3), np.array([0.9, 0.1, -0.3, 0.3])) for f in frames]
    tw.write_tum_sequence(str(tmp_path / "t"), frames, gt=gt)
    jw.write_tum_sequence(str(tmp_path / "j"), frames, gt=gt)
    names = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "t")
                   for d, _, fs in os.walk(tmp_path / "t") for f in fs)
    assert len(names) == 9
    assert names == sorted(os.path.relpath(os.path.join(d, f), tmp_path / "j")
                           for d, _, fs in os.walk(tmp_path / "j") for f in fs)
    for n in names:
        assert _read(tmp_path / "t" / n) == _read(tmp_path / "j" / n), n


def test_written_bag_reads_and_decodes_as_jax(tmp_path):
    msgs = [(topic, typ, t, _serialize(tw, spec)) for topic, typ, t, spec in _messages()]
    msgs.append(("/rgb", "sensor_msgs/Image", 100.4,
                 tw.serialize_image(100.4, RGB8, "rgb8", 9)))
    msgs.append(("/bgr", "sensor_msgs/Image", 100.4,
                 tw.serialize_image(100.4, RGB8, "bgr8", 9)))
    tw.write_rosbag(str(tmp_path / "x.bag"), msgs)
    port = list(trb.BagReader(str(tmp_path / "x.bag")).messages())
    ref = list(jrb.BagReader(str(tmp_path / "x.bag")).messages())
    assert port == ref and len(port) == len(msgs)
    types = trb.BagReader(str(tmp_path / "x.bag")).topics()
    n_checked = 0
    for topic, _, payload in port:
        if types[topic] == "sensor_msgs/Imu":
            a, b = trb.decode_imu(payload), jrb.decode_imu(payload)
        elif types[topic] == "sensor_msgs/Image":
            a, b = trb.decode_image(payload), jrb.decode_image(payload)
            assert a[1] == b[1]
            np.testing.assert_array_equal(trb.to_grayscale(a[2], a[1]),
                                          jrb.to_grayscale(b[2], b[1]))
        else:
            a, b = trb.decode_compressed_image(payload), jrb.decode_compressed_image(payload)
            assert a[1] == b[1]
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        n_checked += 1
    assert n_checked == len(msgs)


def test_compressed_jpeg_decodes_as_jax():
    """JPEG payloads go through Pillow (here it is installed), as in JAX."""
    payload = tw.serialize_compressed_image(2.0, GRAY8, 1, fmt="jpeg")
    a, b = trb.decode_compressed_image(payload), jrb.decode_compressed_image(payload)
    assert a[1] == b[1] == "jpeg" and a[0] == b[0]
    np.testing.assert_array_equal(a[2], b[2])


def test_jpeg_without_pillow_raises(monkeypatch):
    payload = tw.serialize_compressed_image(2.0, GRAY8, 1, fmt="jpeg")
    png = tw.serialize_compressed_image(2.0, GRAY8, 1)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        trb.decode_compressed_image(payload)
    with pytest.raises(ImportError, match="Pillow"):
        tw.serialize_compressed_image(2.0, GRAY8, 1, fmt="jpeg")
    np.testing.assert_array_equal(trb.decode_compressed_image(png)[2], GRAY8)


def test_real_bag_stamps_round_trip_to_the_microsecond(tmp_path):
    """Real bags carry stamps near 1.6e9 s, packed as two uint32."""
    stamps = [1.6e9 + 0.123456, 1.6e9 + 0.999999, 1.7e9 + 86399.000001]
    tw.write_rosbag(str(tmp_path / "s.bag"), [
        ("/imu", "sensor_msgs/Imu", t, tw.serialize_imu(t, np.zeros(3), np.zeros(3), k))
        for k, t in enumerate(stamps)])
    msgs = list(trb.BagReader(str(tmp_path / "s.bag")).messages())
    for t, (_, stamp, payload) in zip(stamps, msgs):
        assert abs(stamp - t) < 1e-6
        assert abs(trb.decode_imu(payload)[0] - t) < 1e-6


@pytest.mark.filterwarnings("ignore:overflow encountered:RuntimeWarning")  # JAX's decoder
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, -1], ids=["none", "sub", "up", "average",
                                                          "paeth", "mixed"])
@pytest.mark.parametrize("img", [GRAY8, GRAY16, RGB8], ids=["gray8", "gray16", "rgb8"])
def test_png_decoder_matches_jax(tmp_path, img, filt):
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(chip_smoke.encode_png_rows(img, filt))
    got = ttum._decode_png(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jtum._decode_png(path))
    np.testing.assert_array_equal(ttum.load_image(path), jtum.load_image(path))


@pytest.mark.parametrize("img", [GRAY8, RGB8, np.minimum(GRAY16, 400).astype(np.uint16),
                                 np.dstack([GRAY8, GRAY8[::-1]]),
                                 np.dstack([RGB8, GRAY8])], ids=["gray8", "rgb8", "gray16",
                                                                 "gray-alpha", "rgba"])
def test_load_gray_and_mask_match_jax(tmp_path, img):
    """PIL's ``convert("L")`` without PIL; masks resized to the frame."""
    path = str(tmp_path / "m.png")
    with open(path, "wb") as f:
        f.write(chip_smoke.encode_png_rows(img, -1))
    np.testing.assert_array_equal(timages.load_gray(path), jimages.load_gray(path))
    for shape in ((H, W), (37, 51)):
        np.testing.assert_array_equal(timages.load_mask(path, *shape),
                                      jimages.load_mask(path, *shape))


def test_tum_sequence_matches_jax(tmp_path):
    frames = [(1.0 + k / 30.0, np.roll(GRAY8, k, 1).astype(np.float32), DEPTH_M)
              for k in range(4)]
    gt = [(f[0], RNG.normal(size=3), np.array([1.0, 0, 0, 0])) for f in frames]
    tw.write_tum_sequence(str(tmp_path), frames, gt=gt)
    with open(tmp_path / "depth.txt", "a") as f:  # an unmatched depth stamp
        f.write("9.000000 depth/1.000000.png\n")
    with open(tmp_path / "rgb" / "rgb.png", "wb") as f:  # one RGB frame, Paeth rows
        f.write(chip_smoke.encode_png_rows(RGB8, 4))
    with open(tmp_path / "rgb.txt", "a") as f:
        f.write(f"{1.0 + 4 / 30.0:.6f} rgb/rgb.png\n")
    with open(tmp_path / "depth.txt", "a") as f:
        f.write(f"{1.0 + 4 / 30.0 + 0.004:.6f} depth/1.000000.png\n")
    port, ref = ttum.TumSequence(str(tmp_path)), jtum.TumSequence(str(tmp_path))
    assert port.pairs == ref.pairs and len(port) == 5
    np.testing.assert_array_equal(port.groundtruth, ref.groundtruth)
    n = 0
    for (ta, ia, da), (tb, ib, db) in zip(port.frames(), ref.frames()):
        assert ta == tb and ia.dtype == ib.dtype == da.dtype == db.dtype == np.float32
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(da, db)
        n += 1
    assert n == 5


def test_stream_io_matches_jax(tmp_path):
    for raw, enc in ((GRAY16, "16UC1"), (GRAY16, "mono16"), (DEPTH_M, "32FC1")):
        np.testing.assert_array_equal(tstream.decode_depth(raw, enc),
                                      jstream.decode_depth(raw, enc))
    with pytest.raises(ValueError):
        tstream.decode_depth(GRAY8, "mono8")
    traj = [dict(t=1.6e9 + 0.05 * k, P=RNG.normal(size=3), Q=RNG.normal(size=4),
                 V=RNG.normal(size=3)) for k in range(5)]
    for writer in ("write_trajectory_csv", "write_tum_trajectory"):
        getattr(tstream, writer)(str(tmp_path / "t.txt"), traj)
        getattr(jstream, writer)(str(tmp_path / "j.txt"), traj)
        assert _read(tmp_path / "t.txt") == _read(tmp_path / "j.txt"), writer
    assert tstream.ImuMsg._fields == jstream.ImuMsg._fields


@pytest.mark.parametrize("where", ["beside", "one up", "named", "none"])
def test_rig_topics_and_fisheye_mask_match_jax(tmp_path, where):
    """The bag topics and the fisheye mask a rig file names, or the
    reference's fisheye_mask.jpg found beside it or one directory up."""
    rig_dir = tmp_path / "config" / "rig"
    rig_dir.mkdir(parents=True)
    text = ("%YAML:1.0\nimu: 1\nimage_topic: \"/cam0/image_raw\"\n"
            "imu_topic: /imu0\nfisheye: 1\nequalize: 1\n")
    if where == "beside":
        (rig_dir / "fisheye_mask.jpg").write_bytes(b"")
    elif where == "one up":
        (tmp_path / "config" / "fisheye_mask.jpg").write_bytes(b"")
    elif where == "named":
        text += "fisheye_mask: \"/masks/m.png\"\n"
    path = rig_dir / "rig.yaml"
    path.write_text(text)
    t, j = tconfig.load_config(str(path)), jconfig.load_config(str(path))
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.image_topic == "/cam0/image_raw" and t.imu_topic == "/imu0"
    assert t.depth_topic == "/camera/depth/image_raw" and t.equalize and t.fisheye
    assert bool(t.fisheye_mask) == (where != "none")


def test_rig_yaml_reads_back_as_its_config(tmp_path):
    """chip_smoke's rig files (phases 14 and 14b) read back, in both
    packages, as the configs they were written from."""
    rig, seq, cfg = chip_smoke.realsense_scene(4, 320, 240)
    vo, _ = chip_smoke.vo_config(rig, seq, 250)
    for c in (dataclasses.replace(cfg, equalize=True, fisheye=True, fisheye_mask="/m.png"),
              vo):
        path = tmp_path / "rig.yaml"
        path.write_text(chip_smoke.rig_yaml(c))
        assert tconfig.load_config(str(path)) == c
        j = jconfig.load_config(str(path))
        for f in dataclasses.fields(c):
            assert getattr(j, f.name) == getattr(c, f.name), f.name


def test_decode_png_refuses_what_it_cannot_decode():
    import struct
    import zlib

    def chunk(ctype, data):
        return (struct.pack(">I", len(data)) + ctype + data
                + struct.pack(">I", zlib.crc32(ctype + data) & 0xFFFFFFFF))

    with pytest.raises(ValueError, match="not a PNG"):
        timages.decode_png(b"GIF89a")
    rows = [b"\x00" + GRAY8[y].tobytes() for y in range(H)]
    rows[3] = b"\x07" + rows[3][1:]  # row 3: no such filter type
    bad = (tw.encode_png(GRAY8)[:33] + chunk(b"IDAT", zlib.compress(b"".join(rows)))
           + chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="row 3"):
        timages.decode_png(bad)
    interlaced = bytearray(tw.encode_png(GRAY8))
    interlaced[28] = 1  # IHDR's interlace method
    with pytest.raises(ValueError, match="interlace 1"):
        timages.decode_png(bytes(interlaced))


def test_jpeg_mask_through_pillow_matches_jax(tmp_path):
    """A fisheye_mask.jpg (the reference ships JPEG masks) loads through
    Pillow where it is installed, as in JAX."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.where(GRAY8 > 100, 255, 0).astype(np.uint8)).save(buf, format="JPEG")
    path = tmp_path / "fisheye_mask.jpg"
    path.write_bytes(buf.getvalue())
    np.testing.assert_array_equal(timages.load_mask(str(path), 48, 64),
                                  jimages.load_mask(str(path), 48, 64))
