"""8-bit PNG read and write with zlib and numpy (the port reads and writes its
images without PIL or imageio).

``read_png`` takes non-interlaced 8-bit grey, grey + alpha, RGB and RGBA files
and undoes all five row filters (None, Sub, Up, Average, Paeth); other bit
depths, palettes and interlacing raise, naming the file. ``write_png`` writes
uint8 [H, W], [H, W, 1 | 2 | 3 | 4] arrays with filter None on every row.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes, path):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: PNG without IEND")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, width: int, bpp: int) -> np.ndarray:
    """The image bytes [H, W, bpp] from the filtered scanlines [H, 1 + W bpp]."""
    ftype = raw[:, 0]
    filt = raw[:, 1:].reshape(height, width, bpp)
    if not ftype.any():
        return filt.copy()
    if ftype.max() > 4:
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    # a pixel depends on its left, upper and upper-left neighbours: walk the
    # anti-diagonals r + x = d, each one vectorized, with every row's filter
    rec = np.zeros((height + 1, width + 1, bpp), np.int32)  # row 0, column 0: outside
    filt = filt.astype(np.int32)
    for d in range(height + width - 1):
        r = np.arange(max(0, d - width + 1), min(height - 1, d) + 1)
        x = d - r
        a = rec[r + 1, x]  # left
        b = rec[r, x + 1]  # up
        c = rec[r, x]  # up-left
        ft = ftype[r][:, None]
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        rec[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """uint8 [H, W] (grey) or [H, W, C] (C = 2, 3, 4) from an 8-bit PNG."""
    path = Path(path)
    data = path.read_bytes()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS:
        raise ValueError(
            f"{path}: PNG bit depth {depth}, colour type {colour}: only 8-bit grey, "
            "grey + alpha, RGB and RGBA are read"
        )
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not read")
    bpp = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + width * bpp):
        raise ValueError(f"{path}: PNG image data of {raw.size} bytes for {width}x{height}")
    try:
        img = _unfilter(raw.reshape(height, 1 + width * bpp), height, width, bpp)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return img[..., 0] if bpp == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, image: np.ndarray) -> None:
    """Write a uint8 image [H, W] or [H, W, C] (C = 1, 2, 3, 4) as an 8-bit PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: write_png takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 2, 3, 4):
        raise ValueError(f"{path}: image of shape {img.shape} is not [H, W(, 1-4)]")
    height, width, bpp = img.shape
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[bpp]
    rows = np.concatenate([np.zeros((height, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(height, width * bpp)], axis=1)
    Path(path).write_bytes(
        _SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )
