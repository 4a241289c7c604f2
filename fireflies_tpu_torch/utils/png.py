"""Minimal dependency-free PNG writer and reader for datasets (port of
fireflies_tpu/utils/png.py): 8-bit grayscale or RGB, filter-0 scanlines,
zlib level 6, so the same array gives the same bytes in both packages."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, image: np.ndarray) -> None:
    """Write (H, W) or (H, W, 3) uint8/float arrays as PNG.

    Floats are assumed in [0, 1] and quantized to 8 bits.
    """
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 2:
        color_type = 0  # grayscale
        arr = arr[:, :, None]
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color_type = 2  # RGB
    elif arr.ndim == 3 and arr.shape[2] == 1:
        color_type = 0
    else:
        raise ValueError(f"unsupported image shape {arr.shape}")

    h, w = arr.shape[:2]
    # Each scanline prefixed with filter byte 0.
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Minimal reader for PNGs written by write_png (filter-0 scanlines)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = b""
    w = h = None
    color_type = 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, _bits, color_type, *_ = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    channels = 3 if color_type == 2 else 1
    stride = w * channels + 1
    rows = []
    for y in range(h):
        line = raw[y * stride : (y + 1) * stride]
        if line[0] != 0:
            raise ValueError(f"{path}: only filter-0 PNGs are supported")
        rows.append(np.frombuffer(line[1:], np.uint8).reshape(w, channels))
    out = np.stack(rows)
    return out[..., 0] if channels == 1 else out
