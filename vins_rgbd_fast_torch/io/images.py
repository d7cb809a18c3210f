"""Host-side image decoding: fisheye masks, TUM frames and compressed bag
payloads (twin of ``vins_rgbd_fast_tpu/io/images.py``).

The JAX module decodes with PIL.  The machine with the card has no PIL, so
the port decodes PNG itself: ``decode_png`` inflates the IDAT stream with
``zlib`` and undoes the row filters in the native runtime
(``runtime/csrc/png_unfilter.cpp``).  Grey conversions follow PIL's
``convert("L")`` (ITU-R 601-2 luma in integers, 16-bit grey clipped at
255), so ``load_gray``/``decode_gray`` give PIL's arrays.  JPEG is decoded
through PIL where PIL is installed; elsewhere it raises ``ImportError``.
"""

from __future__ import annotations

import ctypes
import io as _io
import struct
import zlib

import numpy as np

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel
_U8P = ctypes.POINTER(ctypes.c_uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> samples: (H, W) for grey, else (H, W, C); uint8 or
    uint16 by bit depth.  Grey, grey+alpha, RGB and RGBA at 8 or 16 bits,
    not interlaced, all five row filters."""
    from ..runtime import png_lib

    if not data.startswith(PNG_MAGIC):
        raise ValueError("not a PNG")
    off, idat, ihdr = 8, [], None
    while off < len(data):
        (length,) = struct.unpack_from(">I", data, off)
        ctype = data[off + 4:off + 8]
        chunk = data[off + 8:off + 8 + length]
        if ctype == b"IHDR":
            ihdr = struct.unpack_from(">IIBBBBB", chunk, 0)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
        off += 12 + length
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    width, height, bitdepth, colortype, _, _, interlace = ihdr
    if colortype not in _CHANNELS or bitdepth not in (8, 16) or interlace:
        raise ValueError(f"unsupported PNG: colour type {colortype}, bit depth {bitdepth}, "
                         f"interlace {interlace}")
    channels = _CHANNELS[colortype]
    bpp = channels * (bitdepth // 8)
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data too short")
    src = np.frombuffer(raw, np.uint8, height * (stride + 1))
    out = np.empty((height, stride), np.uint8)
    rc = png_lib().vins_png_unfilter(src.ctypes.data_as(_U8P), height, stride, bpp,
                                     out.ctypes.data_as(_U8P))
    if rc != 0:
        raise ValueError(f"PNG row {-rc - 1} has an unknown filter type")
    if bitdepth == 16:
        arr = out.view(">u2").astype(np.uint16).reshape(height, width, channels)
    else:
        arr = out.reshape(height, width, channels)
    return arr[..., 0] if channels == 1 else arr


def _pil_decode(data: bytes):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("only PNG is decoded without Pillow: JPEG (and any other "
                          "non-PNG) payloads need Pillow installed") from e
    return Image.open(_io.BytesIO(data))


def _to_gray(arr: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")`` of decoded PNG samples, as float32."""
    if arr.ndim == 2:
        if arr.dtype == np.uint16:
            return np.minimum(arr, 255).astype(np.float32)
        return arr.astype(np.float32)
    if arr.dtype != np.uint8:
        raise ValueError("16-bit colour PNGs are not converted to grey")
    if arr.shape[2] == 2:  # grey + alpha
        return arr[..., 0].astype(np.float32)
    r, g, b = (arr[..., i].astype(np.int64) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.float32)


def decode_gray(data: bytes) -> np.ndarray:
    """An in-memory PNG/JPEG payload to grayscale float32 (H, W)
    (``sensor_msgs/CompressedImage`` replay)."""
    if data.startswith(PNG_MAGIC):
        return _to_gray(decode_png(data))
    with _pil_decode(data) as im:
        return np.asarray(im.convert("L"), np.float32)


def decode_depth(data: bytes) -> np.ndarray:
    """An in-memory 16-bit PNG depth payload to float32 millimetres (the
    compressedDepth transport re-encodes mono16 as PNG)."""
    return decode_png(data).astype(np.float32)


def load_gray(path: str) -> np.ndarray:
    """An image file to grayscale float32 (H, W) in [0, 255]."""
    with open(path, "rb") as f:
        return decode_gray(f.read())


def resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Nearest-neighbour resize (mask images: interpolation would blur the
    valid/invalid boundary)."""
    H, W = img.shape[:2]
    ys = np.clip((np.arange(height) * H) // height, 0, H - 1)
    xs = np.clip((np.arange(width) * W) // width, 0, W - 1)
    return img[ys[:, None], xs[None, :]]


def load_mask(path: str, height: int, width: int) -> np.ndarray:
    """A fisheye-mask image as (height, width) bool: nonzero = valid field
    of view (the reference intersects FISHEYE_MASK in setMask,
    ``feature_tracker.cpp:173-208``)."""
    m = load_gray(path)
    if m.shape != (height, width):
        m = resize_nearest(m, height, width)
    return m > 127.0
