"""TensorBoard scalar event files written by the port itself (no tensorboardX,
no protobuf package): the JAX package's trainers write them with
tensorboardX's SummaryWriter.add_scalar, and the card's machine has neither.

A file ``events.out.tfevents.<unix time>.<host name>`` holds TFRecords, each
a little-endian uint64 length, its masked CRC32C, the payload and the
payload's masked CRC32C; the payloads are ``Event`` protos: first
``file_version = "brain.Event:2"``, then one per scalar with its wall time,
step and a ``Summary`` of one ``Value(tag, simple_value)``, encoded here by
hand (the fields' numbers are TensorBoard's event.proto and summary.proto).
"""
from __future__ import annotations

import re
import socket
import struct
import time
from pathlib import Path


# tensorboardX's tag cleaning: characters outside [-/\w.] become "_", and
# leading slashes go
_INVALID_TAG_CHARACTERS = re.compile(r"[^-/\w\.]")


def clean_tag(tag: str) -> str:
    return _INVALID_TAG_CHARACTERS.sub("_", tag).lstrip("/")


def _crc32c_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rotate right by 15, add 0xa282ead8 (mod 2^32)."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(payload: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the payload, its masked CRC."""
    length = struct.pack("<Q", len(payload))
    return (length + struct.pack("<I", masked_crc32c(length)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # a negative int64 as protobuf encodes it: ten bytes
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, wire: int) -> bytes:
    return _varint(number << 3 | wire)


def _bytes_field(number: int, data: bytes) -> bytes:
    return _field(number, 2) + _varint(len(data)) + data


def event_bytes(wall_time: float, step: int = 0, *, file_version: str = None,
                tag: str = None, simple_value: float = None) -> bytes:
    """An ``Event`` proto: wall_time (field 1, double), step (2, int64),
    and either file_version (3, string) or summary (5) = Summary{value (1) =
    Value{tag (1, string), simple_value (2, float)}}."""
    out = _field(1, 1) + struct.pack("<d", float(wall_time))
    if step:
        out += _field(2, 0) + _varint(int(step))
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    else:
        value = (_bytes_field(1, tag.encode()) + _field(2, 5)
                 + struct.pack("<f", float(simple_value)))
        out += _bytes_field(5, _bytes_field(1, value))
    return out


class EventFileWriter:
    """Scalars into a new event file under ``log_dir`` (the directory is made
    when the first scalar is written), their tags cleaned as tensorboardX
    cleans them; every record is flushed at once."""

    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.path = None

    def _open(self):
        self.log_dir.mkdir(parents=True, exist_ok=True)
        now = time.time()
        self.path = self.log_dir / f"events.out.tfevents.{int(now)}.{socket.gethostname()}"
        with open(self.path, "ab") as f:
            f.write(tfrecord(event_bytes(now, file_version="brain.Event:2")))

    def add_scalar(self, tag: str, value: float, global_step: int = 0,
                   walltime: float = None) -> None:
        if self.path is None:
            self._open()
        record = tfrecord(event_bytes(time.time() if walltime is None else walltime,
                                      global_step, tag=clean_tag(tag), simple_value=value))
        with open(self.path, "ab") as f:
            f.write(record)
