"""TensorBoard scalar event files with the standard library only (the JAX
package's ``utils/events.py``, byte for byte the same files).

``report_to: tensorboard`` (the reference logs through HF Trainer's
tensorboard integration, scripts/train.py:290) needs no tensorboard
package: this module encodes the two protobuf messages a scalar stream
needs (``Event`` and ``Summary``) and the TFRecord framing (length +
masked CRC32C), producing ``events.out.tfevents.*`` files any TensorBoard
reads.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# --- CRC32C (Castagnoli), table-driven --------------------------------------

_POLY = 0x82F63B78


def _make_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _make_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """TFRecord masking: rotate right by 15, then add the masking delta."""
    crc = _crc32c(data)
    rot = ((crc >> 15) | (crc << 17)) & 0xFFFFFFFF
    return (rot + 0xA282EAD8) & 0xFFFFFFFF


# --- protobuf fields ----------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _float_field(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _double_field(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _int_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _scalar_event(tag: str, value: float, step: int, wall: float) -> bytes:
    # Summary.Value{tag=1, simple_value=2} inside Summary{value=1}
    summary = _len_field(1, _len_field(1, tag.encode()) + _float_field(2, value))
    # Event{wall_time=1 (double), step=2 (int64), summary=5}
    return _double_field(1, wall) + _int_field(2, step) + _len_field(5, summary)


def _file_version_event(wall: float) -> bytes:
    return _double_field(1, wall) + _len_field(3, b"brain.Event:2")


class EventWriter:
    """Append-only scalar event file in ``log_dir``."""

    def __init__(self, log_dir: str, suffix: Optional[str] = None):
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        if suffix:
            name += f".{suffix}"
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        self._write_record(_file_version_event(time.time()))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(_scalar_event(tag, float(value), step, time.time()))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str):
    """The payloads of an event file's records; raises ``ValueError`` where
    a length or payload CRC does not hold."""
    records = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return records
            (hcrc,) = struct.unpack("<I", f.read(4))
            if len(header) != 8 or hcrc != _masked_crc(header):
                raise ValueError(f"{path}: record {len(records)}: bad length CRC")
            payload = f.read(struct.unpack("<Q", header)[0])
            (pcrc,) = struct.unpack("<I", f.read(4))
            if pcrc != _masked_crc(payload):
                raise ValueError(f"{path}: record {len(records)}: bad payload CRC")
            records.append(payload)


def _fields(buf: bytes):
    """(field, wire type, value) of one protobuf message's fields."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = struct.unpack("<d", buf[pos: pos + 8])[0], pos + 8
        elif wire == 5:
            value, pos = struct.unpack("<f", buf[pos: pos + 4])[0], pos + 4
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos: pos + n], pos + n
        else:
            raise ValueError(f"protobuf wire type {wire} is not written here")
        yield field, wire, value


def _read_varint(buf: bytes, pos: int):
    shift = value = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos


def read_scalars(path: str):
    """[(tag, step, value)] of the scalar events in an event file, in file
    order (the records' CRCs checked)."""
    out = []
    for payload in read_records(path):
        fields = {f: v for f, _, v in _fields(payload)}
        if 5 not in fields:
            continue
        for _, _, value in _fields(fields[5]):
            sv = {f: v for f, _, v in _fields(value)}
            out.append((sv[1].decode(), fields.get(2, 0), sv[2]))
    return out
