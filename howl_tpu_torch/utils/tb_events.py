"""Minimal TensorBoard event-file writer (no tensorflow/tensorboardX).

The reference logs training scalars through torch's SummaryWriter into the
workspace ``logs/`` dir (ref: howl/workspace.py:29, training/run/train.py:312-315)
so standard TensorBoard tooling can watch a run. This module writes the same
on-disk format from scratch:

  * TFRecord framing: uint64-LE length, masked-crc32c(length), payload,
    masked-crc32c(payload), with the Castagnoli CRC and TensorFlow's mask.
  * Hand-encoded ``tensorflow.Event`` protobuf messages — only the fields
    TensorBoard needs for scalars: wall_time (1, double), step (2, varint),
    file_version (3, string) and summary (5) -> Summary.value (1) ->
    {tag (1, string), simple_value (2, float)}.

Verified loadable by TensorBoard's own EventFileLoader when available (the
test suite checks the CRC framing and proto bytes independently).
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time
from pathlib import Path

_CRC_TABLE = []
_POLY = 0x82F63B78  # Castagnoli, reversed


def _build_table():
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ _POLY if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ byte) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # proto int64 wire encoding
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _len_delimited(field_num: int, payload: bytes) -> bytes:
    return bytes([(field_num << 3) | 2]) + _varint(len(payload)) + payload


def _event_proto(wall_time: float, step: int = 0, file_version: str = None, summary: bytes = None) -> bytes:
    msg = b"\x09" + struct.pack("<d", wall_time)  # field 1, double
    if step:
        msg += b"\x10" + _varint(step)  # field 2, varint
    if file_version is not None:
        msg += _len_delimited(3, file_version.encode())
    if summary is not None:
        msg += _len_delimited(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _len_delimited(1, tag.encode()) + b"\x15" + struct.pack("<f", value)
    return _len_delimited(1, val)  # Summary.value


class EventFileWriter:
    """Append scalar events to ``logdir/events.out.tfevents.<ts>.<host>.<pid>.<n>``.

    The pid + per-process counter suffix (the same scheme TensorFlow uses)
    keeps two writers created in the same second from appending interleaved
    records to one file, which would corrupt the TFRecord framing."""

    _counter = itertools.count()

    def __init__(self, logdir: Path):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        name = (
            f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
            f".{os.getpid()}.{next(self._counter)}"
        )
        self._file = (self.logdir / name).open("ab")
        self._write_record(_event_proto(time.time(), file_version="brain.Event:2"))

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc(header)))
        self._file.write(payload)
        self._file.write(struct.pack("<I", _masked_crc(payload)))
        self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int = 0):
        self._write_record(_event_proto(time.time(), step=step, summary=_scalar_summary(tag, float(value))))

    def close(self):
        self._file.close()


def read_scalars(path: Path):
    """Parse an event file back into [(step, tag, value)] — the inverse of the
    writer, used by tests and the jsonl<->TB converter."""
    out = []
    data = Path(path).read_bytes()
    pos = 0
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        header = data[pos : pos + 8]
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        if hcrc != _masked_crc(header):
            raise ValueError(f"corrupt record header at byte {pos}")
        payload = data[pos + 12 : pos + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        if pcrc != _masked_crc(payload):
            raise ValueError(f"corrupt record payload at byte {pos}")
        pos += 12 + length + 4
        out.extend(_parse_event(payload))
    return out


def _parse_event(msg: bytes):
    step, summaries = 0, []
    pos = 0
    while pos < len(msg):
        tag_byte = msg[pos]
        field, wire = tag_byte >> 3, tag_byte & 7
        pos += 1
        if wire == 1:  # double
            pos += 8
        elif wire == 0:
            val, pos = _read_varint(msg, pos)
            if field == 2:
                step = val
        elif wire == 5:
            pos += 4
        elif wire == 2:
            length, pos = _read_varint(msg, pos)
            if field == 5:
                summaries.extend(_parse_summary(msg[pos : pos + length]))
            pos += length
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return [(step, tag, value) for tag, value in summaries]


def _parse_summary(msg: bytes):
    out = []
    pos = 0
    while pos < len(msg):
        field, wire = msg[pos] >> 3, msg[pos] & 7
        pos += 1
        length, pos = _read_varint(msg, pos)
        if field == 1 and wire == 2:
            out.append(_parse_value(msg[pos : pos + length]))
        pos += length
    return [x for x in out if x is not None]


def _parse_value(msg: bytes):
    tag, value = None, None
    pos = 0
    while pos < len(msg):
        field, wire = msg[pos] >> 3, msg[pos] & 7
        pos += 1
        if wire == 2:
            length, pos = _read_varint(msg, pos)
            if field == 1:
                tag = msg[pos : pos + length].decode()
            pos += length
        elif wire == 5:
            if field == 2:
                (value,) = struct.unpack_from("<f", msg, pos)
            pos += 4
        elif wire == 0:
            _, pos = _read_varint(msg, pos)
        else:
            pos += 8
    if tag is None or value is None:
        return None
    return tag, value


def _read_varint(data: bytes, pos: int):
    result = shift = 0
    while True:
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def convert_jsonl(metrics_jsonl: Path, logdir: Path):
    """One-shot metrics.jsonl -> TensorBoard event file (observability bridge
    for workspaces recorded before TB logging existed)."""
    import json

    writer = EventFileWriter(logdir)
    with Path(metrics_jsonl).open() as fh:
        for line in fh:
            if line.strip():
                rec = json.loads(line)
                writer.add_scalar(rec["name"], rec["value"], rec.get("step", 0))
    writer.close()
