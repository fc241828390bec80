"""TensorBoard event files without tensorboard or tensorflow.

`EventFileWriter` writes what `torch.utils.tensorboard.SummaryWriter`
writes for `add_scalar` (its old-style `simple_value` summaries), byte for
byte apart from the wall times:

- the file `events.out.tfevents.<time, 10 digits>.<host>.<pid>.<uid>` in
  the log directory (tensorboard's `event_file_writer.py`);
- records in TFRecord framing: the data's length as a little-endian u64,
  the masked CRC-32C of those 8 bytes, the data, the masked CRC-32C of the
  data;
- each record one serialized `Event` protobuf: first `{wall_time,
  file_version: "brain.Event:2", source_metadata {writer}}`, then one
  `{wall_time, step, summary {value {tag, simple_value}}}` per scalar,
  the value as float32.

The protobuf fields are encoded by hand, in field-number order and with
proto3's rule that a zero scalar outside a oneof is left out, as
`tools/flax_msgpack.py` writes flax's msgpack. Here `import
torch.utils.tensorboard` would pull in tensorflow (and through it JAX);
the card's machine has neither package.
"""

from __future__ import annotations

import itertools
import math
import os
import socket
import struct
import time
from typing import Optional

FILE_VERSION = "brain.Event:2"
SOURCE_WRITER = "tensorboard.summary.writer.event_file_writer"
_UIDS = itertools.count()  # tensorboard's _global_uid: one per writer


def _crc32c_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected, initial and final XOR all ones)."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's mask: the CRC rotated right by 15 bits plus 0xa282ead8."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def record(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the data, the data's."""
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


# -- protobuf wire format ---------------------------------------------------


def _varint(n: int) -> bytes:
    n &= 0xFFFFFFFFFFFFFFFF  # a negative int64 takes ten bytes
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _key(field: int, wire_type: int) -> bytes:
    return _varint(field << 3 | wire_type)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _float32(value: float) -> bytes:
    """`value` rounded to float32 as protobuf's setter rounds it: past the
    largest float32 it is an infinity."""
    try:
        return struct.pack("<f", value)
    except OverflowError:
        return struct.pack("<f", math.copysign(math.inf, value))


def _event(wall_time: float, step: int = 0, file_version: str = "",
           summary: Optional[bytes] = None,
           source_writer: str = "") -> bytes:
    """A serialized `tensorboard.Event` (event.proto): wall_time = 1
    (double), step = 2 (int64), file_version = 3, summary = 5,
    source_metadata = 10 (`SourceMetadata.writer` = 1)."""
    out = b""
    if wall_time != 0.0:
        out += _key(1, 1) + struct.pack("<d", wall_time)
    if step != 0:
        out += _key(2, 0) + _varint(step)
    if file_version:
        out += _bytes_field(3, file_version.encode())
    if summary is not None:
        out += _bytes_field(5, summary)
    if source_writer:
        out += _bytes_field(10, _bytes_field(1, source_writer.encode()))
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    """A `Summary` of one `Summary.Value` (summary.proto): tag = 1,
    simple_value = 2 (float, in the `value` oneof, so written even when
    it is 0)."""
    val = (_bytes_field(1, tag.encode()) if tag else b"") + _key(2, 5) \
        + _float32(value)
    return _bytes_field(1, val)


class EventFileWriter:
    """An event file in `log_dir`, opened with its file-version event as
    tensorboard's `EventFileWriter` opens one."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(
            log_dir, "events.out.tfevents.%010d.%s.%s.%s" % (
                time.time(), socket.gethostname(), os.getpid(),
                next(_UIDS)))
        self._file = open(self.path, "wb")
        self._write(_event(time.time(), file_version=FILE_VERSION,
                           source_writer=SOURCE_WRITER))
        self.flush()

    def _write(self, event: bytes) -> None:
        self._file.write(record(event))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        """`SummaryWriter.add_scalar(tag, value, step)`."""
        self._write(_event(time.time() if wall_time is None else wall_time,
                           step=int(step),
                           summary=_scalar_summary(tag, float(value))))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()
