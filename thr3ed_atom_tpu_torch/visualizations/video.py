"""Video writing (counterpart of thr3ed_atom_tpu/visualizations/video.py).

The JAX package writes an .mp4 through imageio and ffmpeg and, where no mp4
backend exists, an animated GIF beside the requested path. The port writes
that GIF with its own encoder (numpy and the standard library; no imageio,
PIL or ffmpeg): GIF89a, one global palette of at most 256 colours, LZW-coded
frames, a loop extension (loop forever) and a frame delay of round(100 / fps)
centiseconds.
"""
from pathlib import Path
from typing import Tuple

import numpy as np

from thr3ed_atom_tpu_torch.utils.logging import log

_MAX_CODES = 4096  # GIF's LZW table size (12-bit codes)


def gif_palette(frames: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(palette [P, 3] uint8 with P <= 256, indices [T, H, W] uint8) of
    [T, H, W, 3] uint8 frames: their own colours when there are at most 256,
    else the 6 x 6 x 6 uniform palette (each channel rounded to a multiple of
    51)."""
    flat = frames.reshape(-1, 3)
    keys = (flat[:, 0].astype(np.int32) << 16) | (flat[:, 1].astype(np.int32) << 8) | flat[:, 2]
    colours, inverse = np.unique(keys, return_inverse=True)
    if len(colours) <= 256:
        palette = np.stack([colours >> 16, (colours >> 8) & 255, colours & 255], -1)
        return palette.astype(np.uint8), inverse.reshape(frames.shape[:3]).astype(np.uint8)
    levels = np.rint(frames.astype(np.float32) / 51.0).astype(np.int32)  # 0..5
    indices = (levels[..., 0] * 36 + levels[..., 1] * 6 + levels[..., 2]).astype(np.uint8)
    grid = np.arange(216)
    palette = np.stack([grid // 36, (grid // 6) % 6, grid % 6], -1) * 51
    return palette.astype(np.uint8), indices


def _lzw_codes(pixels: np.ndarray, min_code_size: int):
    """GIF LZW of a flat uint8 index stream: (codes, their bit widths). The
    table restarts with a clear code when it is full; the widths follow the
    decoder, which adds an entry for every code after the first one after a
    clear."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    codes, widths = [clear], [min_code_size + 1]
    table = {}
    next_code, width = eoi + 1, min_code_size + 1
    data = pixels.tolist()
    prefix = data[0]
    for p in data[1:]:
        key = (prefix << 8) | p
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        widths.append(width)
        table[key] = next_code
        if next_code == 1 << width and width < 12:
            width += 1
        next_code += 1
        if next_code == _MAX_CODES:
            codes.append(clear)
            widths.append(width)
            table = {}
            next_code, width = eoi + 1, min_code_size + 1
        prefix = p
    codes.append(prefix)
    widths.append(width)
    # the decoder adds an entry for that last code before it reads the end code
    if next_code == 1 << width and width < 12:
        width += 1
    codes.append(eoi)
    widths.append(width)
    return codes, widths


def _pack_bits(codes, widths) -> bytes:
    """Codes of the given widths, least significant bit first."""
    codes = np.asarray(codes, np.int64)
    widths = np.asarray(widths, np.int64)
    bit = np.arange(12)
    bits = ((codes[:, None] >> bit[None, :]) & 1)[bit[None, :] < widths[:, None]]
    return np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


def encode_gif(frames: np.ndarray, fps: float) -> bytes:
    """An animated GIF89a of [T, H, W, 3] uint8 frames (see ``gif_palette``),
    looping forever, round(100 / fps) centiseconds a frame."""
    frames = np.asarray(frames)
    if frames.ndim != 4 or frames.shape[-1] != 3 or frames.dtype != np.uint8:
        raise ValueError(f"frames must be [T, H, W, 3] uint8, got {frames.shape} {frames.dtype}")
    T, H, W, _ = frames.shape
    palette, indices = gif_palette(frames)
    size_bits = max(1, int(np.ceil(np.log2(len(palette)))))  # table of 2^size_bits colours
    table = np.zeros((1 << size_bits, 3), np.uint8)
    table[:len(palette)] = palette
    min_code_size = max(2, size_bits)
    delay = int(round(100.0 / fps))
    out = bytearray(b"GIF89a")
    out += np.array([W, H], "<u2").tobytes()
    out += bytes([0x80 | ((size_bits - 1) << 4) | (size_bits - 1), 0, 0])
    out += table.tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"  # loop forever
    for t in range(T):
        out += b"\x21\xf9\x04\x04" + np.array([delay], "<u2").tobytes() + b"\x00\x00"
        out += b"\x2c" + np.array([0, 0, W, H], "<u2").tobytes() + b"\x00"
        out.append(min_code_size)
        out += _sub_blocks(_pack_bits(*_lzw_codes(indices[t].reshape(-1), min_code_size)))
    out += b"\x3b"
    return bytes(out)


def write_video(path, frames: np.ndarray, fps: float) -> Path:
    """Write [T, H, W, 3] uint8 frames as an animated GIF beside ``path``
    (``path`` with the suffix .gif: the JAX package's fallback when it has no
    mp4 backend, and the card's machine has none); returns the path
    written."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    gif_path = path.with_suffix(".gif")
    if gif_path != path:
        log.info(f"no mp4 writer in the port; writing {gif_path}")
    gif_path.write_bytes(encode_gif(frames, fps))
    return gif_path
