"""TFRecord container and the ``tf.train.Example`` wire format, without
TensorFlow.

The port's own copy of the JAX package's ``ssd_tpu/data/tfrecord.py``: the
same on-disk format, so datasets written by either package read in both.
The record framing (length + masked crc32c) and the subset of protobuf
wire format that ``Example`` uses are written out here; the shard index and
the crc run in the host library (``data/native.py``).

Record framing: ``uint64 length | uint32 crc(length) | payload |
uint32 crc(payload)``, crc = masked crc32c (the Castagnoli polynomial with
TF's rotate-and-offset mask).

Example schema (TF Object Detection API conventions):
  * ``image/encoded``            bytes   — jpeg bytes
  * ``image/object/bbox/ymin``   floats  — normalized, one per box
  * ``image/object/bbox/xmin``   floats
  * ``image/object/bbox/ymax``   floats
  * ``image/object/bbox/xmax``   floats
  * ``image/object/class/label`` int64s  — foreground ids in [0, C)
  * ``image/source_id``, ``image/height``, ``image/width``,
    ``image/object/is_crowd``    int64s  — optional
"""

from __future__ import annotations

import os
import struct
from typing import Iterator

import numpy as np

# ----------------------------------------------------------------- crc32c

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78  # Castagnoli, reflected
        table = np.zeros(256, dtype=np.uint32)
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table[i] = c
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    """crc32c in Python, byte by byte (the library's ``native.crc32c`` is
    the fast one and equals it)."""
    table = _crc_table()
    crc = np.uint32(0xFFFFFFFF)
    arr = np.frombuffer(data, dtype=np.uint8)
    # vectorized-ish table walk (byte-serial but numpy-indexed)
    c = int(crc)
    t = table
    for b in arr.tobytes():
        c = (c >> 8) ^ int(t[(c ^ b) & 0xFF])
    return c ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    """TF's masked crc32c of ``data``, the crc from the host library."""
    from ssd_tpu_torch.data import native

    crc = native.crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ------------------------------------------------------------ record io

class RecordWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", masked_crc(payload)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            hcrc_raw = f.read(4)
            payload = f.read(length)
            pcrc_raw = f.read(4)
            if len(hcrc_raw) < 4 or len(payload) < length or len(pcrc_raw) < 4:
                return  # truncated tail (partial write/crash): stop cleanly
            (hcrc,) = struct.unpack("<I", hcrc_raw)
            (pcrc,) = struct.unpack("<I", pcrc_raw)
            if verify_crc:
                if masked_crc(header) != hcrc:
                    raise IOError(f"{path}: corrupt record header")
                if masked_crc(payload) != pcrc:
                    raise IOError(f"{path}: corrupt record payload")
            yield payload


def record_offsets(path: str) -> list[tuple[int, int]]:
    """(offset, length) of every record payload — for random access.

    Validates the header CRC of every record so a non-TFRecord file (a
    ``*-label_map.json`` sidecar swept in by a too-broad file pattern, a
    stray text file) fails with a clear error naming the file instead of
    a garbage length driving ``seek`` into EINVAL. A truncated final
    record (partial write/crash) still terminates cleanly, matching
    :func:`read_records`.
    """
    out = []
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        pos = 0
        while True:
            header = f.read(8)
            if len(header) < 8:
                return out
            (length,) = struct.unpack("<Q", header)
            hcrc_raw = f.read(4)
            if len(hcrc_raw) < 4:
                return out  # truncated tail: stop cleanly
            (hcrc,) = struct.unpack("<I", hcrc_raw)
            if masked_crc(header) != hcrc:
                raise IOError(
                    f"{path}: not a TFRecord file (header CRC mismatch at "
                    f"offset {pos}). Is the file pattern matching "
                    "non-tfrecord files (e.g. the *-label_map.json / "
                    "*-category_ids.json sidecars)? Use a pattern like "
                    "'<prefix>-*-of-*'."
                )
            if pos + 12 + length + 4 > size:
                return out  # truncated tail: stop cleanly
            out.append((pos + 12, length))
            f.seek(length + 4, 1)
            pos += 12 + length + 4


# ----------------------------------------------------- protobuf (subset)

def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _field(num: int, wire: int) -> bytes:
    return _varint(num << 3 | wire)


def _len_delim(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _bytes_list(values: list[bytes]) -> bytes:
    return b"".join(_len_delim(1, v) for v in values)


def _float_list(values) -> bytes:
    packed = struct.pack(f"<{len(values)}f", *values)
    return _len_delim(1, packed) if values else b""


def _int64_list(values) -> bytes:
    packed = b"".join(_varint(v & 0xFFFFFFFFFFFFFFFF) for v in values)
    return _len_delim(1, packed) if values else b""


def encode_example(features: dict) -> bytes:
    """dict of {key: bytes | list[float] | list[int]} -> Example proto."""
    entries = b""
    for key, value in sorted(features.items()):
        if isinstance(value, bytes):
            feature = _len_delim(1, _bytes_list([value]))       # bytes_list=1
        elif len(value) and isinstance(value[0], float) or (
            hasattr(value, "dtype") and np.issubdtype(value.dtype, np.floating)
        ):
            feature = _len_delim(2, _float_list([float(v) for v in value]))
        else:
            feature = _len_delim(3, _int64_list([int(v) for v in value]))
        entry = _len_delim(1, key.encode()) + _len_delim(2, feature)
        entries += _len_delim(1, entry)  # map entry in Features.feature
    return _len_delim(1, entries)  # Example.features


def _parse_message(buf: bytes) -> dict[int, list]:
    """Generic wire-format parse: field number -> list of raw values."""
    fields: dict[int, list] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        num, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            val = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(num, []).append(val)
    return fields


def decode_example(payload: bytes) -> dict:
    """Example proto -> {key: bytes | np.ndarray(float32) |
    np.ndarray(int64)}."""
    example = _parse_message(payload)
    out: dict = {}
    for features_blob in example.get(1, []):
        features = _parse_message(features_blob)
        for entry in features.get(1, []):
            kv = _parse_message(entry)
            key = kv[1][0].decode()
            feature = _parse_message(kv[2][0])
            if 1 in feature:  # bytes_list
                values = _parse_message(feature[1][0]).get(1, [])
                out[key] = values[0] if len(values) == 1 else values
            elif 2 in feature:  # float_list (packed)
                inner = _parse_message(feature[2][0])
                packed = inner.get(1, [b""])[0]
                out[key] = np.frombuffer(packed, dtype="<f4").astype(
                    np.float32)
            elif 3 in feature:  # int64_list (packed varints)
                inner = _parse_message(feature[3][0])
                packed = inner.get(1, [b""])[0]
                vals = []
                p = 0
                while p < len(packed):
                    v, p = _read_varint(packed, p)
                    if v >= 1 << 63:
                        v -= 1 << 64
                    vals.append(v)
                out[key] = np.asarray(vals, dtype=np.int64)
            else:  # empty feature
                out[key] = np.asarray([], dtype=np.float32)
    return out


# --------------------------------------------------------- detection io

def encode_detection_example(jpeg_bytes: bytes, boxes: np.ndarray,
                             labels: np.ndarray,
                             source_id: int | None = None,
                             image_hw: tuple[int, int] | None = None,
                             is_crowd=None) -> bytes:
    """boxes: (M, 4) normalized ymin/xmin/ymax/xmax; labels: (M,) ints.

    ``source_id`` (optional) carries the dataset's original image id
    (e.g. the COCO image_id) and ``image_hw`` the original pixel dims, so
    eval can emit pycocotools-compatible results JSON without re-opening
    the jpeg; ``is_crowd`` (M,) 0/1 marks COCO crowd annotations (eval
    ignore regions — excluded from training targets). Older records
    without these features still decode fine.
    """
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    feats = {
        "image/encoded": jpeg_bytes,
        "image/object/bbox/ymin": boxes[:, 0].tolist(),
        "image/object/bbox/xmin": boxes[:, 1].tolist(),
        "image/object/bbox/ymax": boxes[:, 2].tolist(),
        "image/object/bbox/xmax": boxes[:, 3].tolist(),
        "image/object/class/label": [int(v) for v in labels],
    }
    if source_id is not None:
        feats["image/source_id"] = [int(source_id)]
    if image_hw is not None:
        feats["image/height"] = [int(image_hw[0])]
        feats["image/width"] = [int(image_hw[1])]
    if is_crowd is not None:
        feats["image/object/is_crowd"] = [int(v) for v in is_crowd]
    return encode_example(feats)


def decode_source_id(payload: bytes) -> int | None:
    """The example's original image id, or None for records without one."""
    return decode_detection_record(payload)["source_id"]


def decode_detection_record(payload: bytes) -> dict:
    """ONE parse of a detection Example -> everything the pipeline needs:
    ``{jpeg, boxes (M,4) f32, labels (M,) i32, source_id int|None,
    height int|None, width int|None}`` (None = written by an older
    version that didn't carry that feature)."""
    d = decode_example(payload)
    boxes = np.stack([
        np.asarray(d.get("image/object/bbox/" + k, np.zeros(0)), np.float32)
        for k in ("ymin", "xmin", "ymax", "xmax")
    ], axis=-1) if len(d.get("image/object/bbox/ymin", ())) else np.zeros(
        (0, 4), np.float32
    )
    labels = np.asarray(
        d.get("image/object/class/label", np.zeros(0, np.int64)), np.int64
    )

    def scalar(key):
        v = d.get(key)
        return int(v[0]) if v is not None and len(v) else None

    crowd = d.get("image/object/is_crowd")
    if crowd is None or len(crowd) != len(labels):
        crowd = np.zeros(len(labels), np.int64)
    return {
        "jpeg": d["image/encoded"],
        "boxes": boxes.astype(np.float32),
        "labels": labels.astype(np.int32),
        "is_crowd": np.asarray(crowd, np.int32),
        "source_id": scalar("image/source_id"),
        "height": scalar("image/height"),
        "width": scalar("image/width"),
    }


def decode_detection_example(payload: bytes
                             ) -> tuple[bytes, np.ndarray, np.ndarray]:
    r = decode_detection_record(payload)
    return r["jpeg"], r["boxes"], r["labels"]
