"""A PNG reader and writer in numpy + zlib.

The port's counterpart of the reference's image decode
(object_slam_tpu/native/loader.py::decode_image, which falls back to PIL):
the TUM driver and the semantic loader read their PNGs here, so the port
needs neither PIL nor the native host runtime.

``read_png`` covers what TUM sequences and YOLACT mask folders hold:
non-interlaced 8-bit gray, RGB and RGBA, and 16-bit gray (big-endian
samples, the TUM depth encoding), with the five scanline filters. Other
color types, bit depths and interlaced files raise ValueError.
``write_png`` writes the same types with filter 0 (none).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (color type, bit depth) -> channels
_TYPES = {(0, 8): 1, (0, 16): 1, (2, 8): 3, (6, 8): 4}


def _paeth_row(cur: bytearray, up: bytes, bpp: int):
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, up: bytes, bpp: int):
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + up[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected "
                         f"{height * (stride + 1)}")
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        pos = y * (stride + 1)
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1)
        if ftype == 0:                          # none
            cur = line
        elif ftype == 1:                        # sub: running sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:                        # up
            cur = line + prev
        elif ftype in (3, 4):                   # average, paeth
            buf = bytearray(line.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(
                buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG scanline {y} has filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """[H, W] uint8 or uint16 (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA)
    uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    channels = _TYPES.get((ctype, depth))
    if channels is None:
        raise ValueError(f"{path}: PNG color type {ctype} at bit depth "
                         f"{depth} is not supported")
    bpp = channels * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp,
                     bpp)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(height, width)
    return rows.reshape((height, width) if channels == 1
                        else (height, width, channels))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """Write [H, W] uint8 / uint16, [H, W, 3] or [H, W, 4] uint8 as a PNG
    with filter 0 on every scanline."""
    img = np.asarray(img)
    channels = 1 if img.ndim == 2 else img.shape[2]
    depth = 16 if img.dtype == np.uint16 else 8
    ctype = {1: 0, 3: 2, 4: 6}.get(channels)
    if ctype is None or (ctype, depth) not in _TYPES or \
            img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"cannot write a {img.dtype} image of shape "
                         f"{img.shape} as PNG")
    height, width = img.shape[:2]
    rows = np.ascontiguousarray(img, dtype=">u2" if depth == 16 else np.uint8)
    rows = rows.reshape(height, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                            ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes())))
        f.write(_chunk(b"IEND", b""))
