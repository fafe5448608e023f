"""TensorBoard scalar events without TensorBoard (the port's
``ssd_tpu/utils/tensorboard.py``).

An ``events.out.tfevents.*`` file is TFRecord framing (``uint64 length |
masked crc32c of it | payload | masked crc32c of it``), so the records go
through ``data/tfrecord.RecordWriter``. Each payload is an ``Event``
protobuf (``tensorflow/core/util/event.proto``), encoded by hand with the
same varint helpers ``data/tfrecord.py`` uses for ``tf.train.Example``;
only the scalar subset is written:

    Event:  double wall_time = 1; int64 step = 2;
            oneof what { string file_version = 3; Summary summary = 5; }
    Summary: repeated Value value = 1
    Summary.Value: string tag = 1; float simple_value = 2;

The first record is the ``brain.Event:2`` version event that TensorBoard
expects. For the same scalars at the same wall time the file is byte for
byte the JAX package's, and each package's ``read_scalars`` reads the
other's files.
"""

from __future__ import annotations

import os
import socket
import struct
import time

from ssd_tpu_torch.data.tfrecord import (RecordWriter, _field, _len_delim,
                                         _read_varint, _varint, read_records)

FILE_VERSION = "brain.Event:2"


def _encode_event(wall_time: float, step: int | None = None,
                  file_version: str | None = None,
                  scalars: dict[str, float] | None = None) -> bytes:
    out = _field(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        out += _field(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        out += _len_delim(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _len_delim(1, _len_delim(1, tag.encode())
                       + _field(2, 5) + struct.pack("<f", float(val)))
            for tag, val in scalars.items())
        out += _len_delim(5, summary)
    return out


class SummaryWriter:
    """A ``tf.summary``-style scalar writer into
    ``logdir/events.out.tfevents.{time}.{host}.{pid}``.

    >>> w = SummaryWriter(logdir)
    >>> w.add_scalar("loss", 0.5, step=100)
    >>> w.add_scalars({"loss": 0.5, "lr": 1e-3}, step=100)  # one Event
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}")
        self.path = os.path.join(logdir, name)
        self._writer = RecordWriter(self.path)
        self._writer.write(_encode_event(time.time(),
                                         file_version=FILE_VERSION))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.add_scalars({tag: value}, step)

    def add_scalars(self, scalars: dict[str, float], step: int) -> None:
        """One ``Event`` at ``step`` holding every scalar (host floats)."""
        self._writer.write(_encode_event(time.time(), step=step,
                                         scalars=scalars))

    def flush(self) -> None:
        self._writer._f.flush()

    def close(self) -> None:
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _skip(buf: bytes, pos: int, wire: int) -> int:
    """The position after a field of ``wire`` type starting at ``pos``."""
    if wire == 0:
        return _read_varint(buf, pos)[1]
    if wire == 1:
        return pos + 8
    if wire == 5:
        return pos + 4
    if wire == 2:
        ln, pos = _read_varint(buf, pos)
        return pos + ln
    raise ValueError(f"unsupported wire type {wire}")


def read_scalars(path: str) -> list[tuple[int, str, float]]:
    """A tfevents file -> its ``(step, tag, value)`` rows, in order (every
    record's crc checked)."""
    rows = []
    for payload in read_records(path, verify_crc=True):
        pos, step, values = 0, 0, []
        while pos < len(payload):
            tag_wire, pos = _read_varint(payload, pos)
            num, wire = tag_wire >> 3, tag_wire & 7
            if num == 2 and wire == 0:
                step, pos = _read_varint(payload, pos)
            elif num == 5 and wire == 2:  # Summary
                ln, pos = _read_varint(payload, pos)
                values.extend(_parse_summary(payload[pos:pos + ln]))
                pos += ln
            else:
                pos = _skip(payload, pos, wire)
        rows.extend((step, tag, val) for tag, val in values)
    return rows


def _parse_summary(buf: bytes) -> list[tuple[str, float]]:
    out = []
    pos = 0
    while pos < len(buf):
        tag_wire, pos = _read_varint(buf, pos)
        if tag_wire != (1 << 3 | 2):  # not a Value
            pos = _skip(buf, pos, tag_wire & 7)
            continue
        ln, pos = _read_varint(buf, pos)
        v, vpos = buf[pos:pos + ln], 0
        pos += ln
        tag, val = "", float("nan")
        while vpos < len(v):
            tw, vpos = _read_varint(v, vpos)
            num, wire = tw >> 3, tw & 7
            if num == 1 and wire == 2:
                ln2, vpos = _read_varint(v, vpos)
                tag = v[vpos:vpos + ln2].decode()
                vpos += ln2
            elif num == 2 and wire == 5:
                (val,) = struct.unpack("<f", v[vpos:vpos + 4])
                vpos += 4
            else:
                vpos = _skip(v, vpos, wire)
        out.append((tag, val))
    return out
