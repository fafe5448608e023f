"""The port's tfrecord format against the JAX package's, on the CPU.

crc32c (the library's and the Python one) and the masked crc, the record
writer's bytes, the Example encoding both ways, the shard index (the
library's walker and the Python one) with its truncated tail and its
refusal of a file that is not a tfrecord, and the COCO converter.
"""

import json
import os

import numpy as np
import pytest

from ssd_tpu.data import native as jax_native
from ssd_tpu.data import tfrecord as jax_tfrecord
from ssd_tpu.data.create_tfrecords import load_coco as jax_load_coco
from ssd_tpu_torch.data import create_tfrecords, native, synthetic, tfrecord


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000, 4099])
def test_crc32c_equals_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    want = jax_tfrecord.crc32c(data)
    assert tfrecord.crc32c(data) == want
    assert native.crc32c(data) == want
    assert tfrecord.masked_crc(data) == jax_tfrecord.masked_crc(data)


def test_crc32c_known_value():
    # the Castagnoli check value of "123456789"
    assert native.crc32c(b"123456789") == 0xE3069283
    assert tfrecord.crc32c(b"123456789") == 0xE3069283


def _examples(rng, n: int) -> list:
    out = []
    for i in range(n):
        m = int(rng.integers(0, 6))
        lo = rng.uniform(0, 0.6, (m, 2))
        boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (m, 2))], -1)
        labels = rng.integers(0, 90, m)
        jpeg = rng.integers(0, 256, int(rng.integers(1, 300)),
                            np.uint8).tobytes()
        kw = {}
        if i % 2:
            kw = dict(source_id=int(rng.integers(0, 1 << 40)),
                      image_hw=(int(rng.integers(1, 2000)),
                                int(rng.integers(1, 2000))),
                      is_crowd=rng.integers(0, 2, m))
        out.append((jpeg, boxes.astype(np.float32), labels, kw))
    return out


def test_writer_bytes_and_records_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    examples = _examples(rng, 12)
    ours, theirs = str(tmp_path / "a.tfrecords"), str(tmp_path / "b.tfrecords")
    with tfrecord.RecordWriter(ours) as w:
        for jpeg, boxes, labels, kw in examples:
            w.write(tfrecord.encode_detection_example(jpeg, boxes, labels,
                                                      **kw))
    with jax_tfrecord.RecordWriter(theirs) as w:
        for jpeg, boxes, labels, kw in examples:
            w.write(jax_tfrecord.encode_detection_example(jpeg, boxes,
                                                          labels, **kw))
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    got = list(tfrecord.read_records(ours, verify_crc=True))
    want = list(jax_tfrecord.read_records(theirs, verify_crc=True))
    assert got == want and len(got) == len(examples)
    for payload, (jpeg, boxes, labels, kw) in zip(got, examples):
        a = tfrecord.decode_detection_record(payload)
        b = jax_tfrecord.decode_detection_record(payload)
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype, k
            else:
                assert a[k] == b[k], k
        assert a["jpeg"] == jpeg
        np.testing.assert_array_equal(a["boxes"], boxes.reshape(-1, 4))
        np.testing.assert_array_equal(a["labels"], labels)
        assert tfrecord.decode_source_id(payload) == kw.get("source_id")
    # generic Examples decode alike too
    feats = {"a": b"xyz", "f": [1.5, -2.0], "i": [3, -4, 1 << 40]}
    payload = tfrecord.encode_example(feats)
    assert payload == jax_tfrecord.encode_example(feats)
    a, b = tfrecord.decode_example(payload), jax_tfrecord.decode_example(
        payload)
    assert a["a"] == b["a"] == b"xyz"
    np.testing.assert_array_equal(a["f"], b["f"])
    np.testing.assert_array_equal(a["i"], b["i"])


def _shard(path: str, n: int) -> list:
    rng = np.random.default_rng(n)
    payloads = [rng.integers(0, 256, int(rng.integers(1, 5000)),
                             np.uint8).tobytes() for _ in range(n)]
    with tfrecord.RecordWriter(path) as w:
        for p in payloads:
            w.write(p)
    return payloads


def test_index_and_truncated_tail(tmp_path):
    path = str(tmp_path / "s.tfrecords")
    payloads = _shard(path, 40)
    want = jax_tfrecord.record_offsets(path)
    assert len(want) == 40
    assert tfrecord.record_offsets(path) == want
    assert native.tfrecord_index(path) == want
    assert native.tfrecord_index(path) == jax_native.tfrecord_index(path)
    with open(path, "rb") as f:
        data = f.read()
    # a partial last record (a crash mid-write) ends the index cleanly
    for cut in (3, 10, 14, len(payloads[-1]) // 2):
        trunc = str(tmp_path / f"t{cut}.tfrecords")
        with open(trunc, "wb") as f:
            f.write(data[:len(data) - cut])
        want = jax_tfrecord.record_offsets(trunc)
        assert len(want) == 39
        assert tfrecord.record_offsets(trunc) == want
        assert native.tfrecord_index(trunc) == want
        assert list(tfrecord.read_records(trunc)) == payloads[:39]


def test_index_refuses_a_file_that_is_not_a_tfrecord(tmp_path):
    path = str(tmp_path / "x-label_map.json")
    with open(path, "w") as f:
        json.dump({str(i): f"class {i}" for i in range(40)}, f)
    for walker in (native.tfrecord_index, tfrecord.record_offsets,
                   jax_tfrecord.record_offsets):
        with pytest.raises(IOError, match="not a TFRecord file"):
            walker(path)
    corrupt = str(tmp_path / "c.tfrecords")
    _shard(corrupt, 3)
    with open(corrupt, "r+b") as f:
        f.seek(9)
        f.write(b"\x00")
    with pytest.raises(IOError, match="not a TFRecord file"):
        native.tfrecord_index(corrupt)
    with pytest.raises(OSError):
        native.tfrecord_index(str(tmp_path / "missing"))
    with pytest.raises(OSError):
        native.tfrecord_index(str(tmp_path))  # a directory


def test_coco_shards_equal_jax_conversion(tmp_path):
    """The CLI's shards hold the JAX converter's entries, and its sidecars
    name the classes."""
    root = str(tmp_path)
    synthetic.write_coco_scenes(os.path.join(root, "img"),
                                os.path.join(root, "inst.json"), 7,
                                [(40, 56), (64, 48)], 5, 0, objects=(0, 6),
                                sides=(4, 30))
    create_tfrecords.main(["--annotations", os.path.join(root, "inst.json"),
                           "--images", os.path.join(root, "img"),
                           "--output", os.path.join(root, "d"),
                           "--num-shards", "2"])
    entries = jax_load_coco(os.path.join(root, "inst.json"))
    assert entries == create_tfrecords.load_coco(
        os.path.join(root, "inst.json"))
    shards = sorted(f for f in os.listdir(root) if f.endswith(".tfrecords"))
    assert shards == ["d-00000-of-00002.tfrecords",
                      "d-00001-of-00002.tfrecords"]
    records = [tfrecord.decode_detection_record(p) for s in shards
               for p in tfrecord.read_records(os.path.join(root, s),
                                              verify_crc=True)]
    assert len(records) == 7
    by_id = {e["source_id"]: e for e in entries}
    for r in records:
        e = by_id[r["source_id"]]
        np.testing.assert_allclose(r["boxes"], np.asarray(
            e["boxes"], np.float32).reshape(-1, 4))
        assert r["labels"].tolist() == e["labels"]
        assert r["is_crowd"].tolist() == e["is_crowd"]
        assert (r["height"], r["width"]) == (e["height"], e["width"])
    with open(os.path.join(root, "d-label_map.json")) as f:
        assert json.load(f) == {str(i): f"class_{i}" for i in range(5)}
