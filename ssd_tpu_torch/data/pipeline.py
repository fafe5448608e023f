"""The host input pipeline: tfrecords -> batched uint8 arrays.

The port's own copy of the JAX package's ``ssd_tpu/data/pipeline.py``, the
same deterministic, exactly resumable state machine, so that one seed gives
the same batches in both packages:

  * an offset index over all shards (``ShardIndex``, walked in the host
    library) gives random access; each epoch is a permutation of the
    example ids seeded by ``(seed, epoch)``, and the iterator's state is
    the number of batches handed out (``state``/``restore``), checkpointed
    with the train state;
  * training decodes each JPEG at full size, draws its mosaic partners and
    its augmentation (``data/augment.py``) from generators seeded by the
    example's id, and resizes in the host library, in ``num_workers``
    threads; evaluation decodes at the model size in the library's batch
    decoder;
  * multi-scale training: batch ``i``'s resolution is a pure function of
    ``i`` (``train.multiscale``, changing every ``multiscale_every``);
  * host sharding: host ``i`` of ``k`` owns the example ids with
    ``id % k == i``;
  * a background thread prefetches ``prefetch`` batches; an error there is
    raised in the consumer, and the thread stops when the consumer closes
    the iterator.

Batch contract: ``images (B, S, S, 3) uint8``, ``boxes (B, M, 4) float32``
(zero-padded), ``labels (B, M) int32``, ``num_boxes (B,) int32``; eval
batches also carry ``valid (B,) bool`` (the tail batch is padded to the
batch size, never dropped, and ``valid`` marks its real rows),
``is_crowd (B, M) bool``, ``source_ids (B,) int64`` and ``orig_hw (B, 2)
int32``.
"""

from __future__ import annotations

import concurrent.futures
import glob as globlib
import queue
import threading

import numpy as np

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.data import native
from ssd_tpu_torch.data.augment import augment_example, mosaic_example
from ssd_tpu_torch.data.tfrecord import decode_detection_record

MOSAIC_SALT = 0x90A51C  # the mosaic draw's generator: (seed, epoch, id, salt)


class ShardIndex:
    """Random-access index over a set of tfrecord shards."""

    def __init__(self, files: list[str]):
        if not files:
            raise FileNotFoundError("no tfrecord files given")
        self.files = sorted(files)
        self._handles: dict[int, object] = {}
        self.entries: list[tuple[int, int, int]] = []  # (file, offset, len)
        for fi, path in enumerate(self.files):
            for off, length in native.tfrecord_index(path):
                self.entries.append((fi, off, length))

    def __len__(self) -> int:
        return len(self.entries)

    def read(self, idx: int) -> bytes:
        fi, off, length = self.entries[idx]
        handle = self._handles.get(fi)
        if handle is None:
            handle = open(self.files[fi], "rb")
            self._handles[fi] = handle
        handle.seek(off)
        return handle.read(length)


class Pipeline:
    """Deterministic, resumable batched loader."""

    def __init__(
        self,
        file_pattern: str | list[str],
        cfg: Config,
        is_training: bool = True,
        batch_size: int | None = None,
        host_id: int = 0,
        num_hosts: int = 1,
        seed: int = 0,
        prefetch: int = 2,
    ):
        files = (
            sorted(globlib.glob(file_pattern))
            if isinstance(file_pattern, str) else list(file_pattern)
        )
        self.index = ShardIndex(files)
        self.cfg = cfg
        self.is_training = is_training
        self.batch_size = batch_size or cfg.train.batch_size
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0      # production cursor (prefetch thread)
        self.position = 0
        self.consumed = 0   # batches handed to the consumer
        # host-local example ids
        self._local = np.arange(len(self.index))[host_id::num_hosts]
        if self.is_training and len(self._local) < self.batch_size:
            # tiny datasets: repeat to fill one batch
            reps = -(-self.batch_size // max(len(self._local), 1))
            self._local = np.tile(self._local, reps)
        if not self.is_training:
            # Eval covers every example once: the last partial batch is
            # padded (``valid`` marks the real rows), and every host runs
            # the same number of batches.
            largest_host = -(-len(self.index) // num_hosts)
            self._eval_batches = -(-largest_host // self.batch_size)

    # ------------------------------------------------------------ state

    def state(self) -> dict:
        """Exact-resume state, from the batches CONSUMED (the prefetch
        thread's production cursor runs ahead; checkpointing that would
        skip the prefetched batches on resume)."""
        nb = max(self.batches_per_epoch(), 1)
        return {"epoch": self.consumed // nb, "position": self.consumed % nb,
                "seed": self.seed}

    def restore(self, state: dict) -> None:
        self.seed = int(state["seed"])
        nb = max(self.batches_per_epoch(), 1)
        self.consumed = int(state["epoch"]) * nb + int(state["position"])
        self.epoch = self.consumed // nb
        self.position = self.consumed % nb

    # ------------------------------------------------------------ epochs

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = self._local
        if self.is_training:
            rng = np.random.default_rng((self.seed, epoch))
            order = rng.permutation(order)
        return order

    def batches_per_epoch(self) -> int:
        if not self.is_training:
            return self._eval_batches
        return len(self._local) // self.batch_size

    # ------------------------------------------------------------ build

    def _scale_for(self, ordinal: int) -> tuple[int, int]:
        """Train resolution of the batch with this global ordinal (epoch *
        batches_per_epoch + position): a pure function of it, so the
        multi-scale schedule replays exactly on resume."""
        ms = self.cfg.train.multiscale
        if not self.is_training or not ms:
            return self.cfg.image_hw()
        s = ms[(ordinal // max(self.cfg.train.multiscale_every, 1)) % len(ms)]
        return (s, s)

    def _make_batch(self, example_ids: np.ndarray, epoch: int,
                    image_hw: tuple[int, int] | None = None) -> dict:
        cfg = self.cfg
        ih, iw = image_hw or cfg.image_hw()
        m = cfg.data.max_gt_boxes
        # Eval pads a short tail batch to the batch size; training ids
        # always fill the batch.
        n_real = len(example_ids)
        b = n_real if self.is_training else self.batch_size

        decoded = [decode_detection_record(self.index.read(i))
                   for i in example_ids]

        images_out = np.zeros((b, ih, iw, 3), np.uint8)
        boxes_out = np.zeros((b, m, 4), np.float32)
        labels_out = np.zeros((b, m), np.int32)
        num_out = np.zeros((b,), np.int32)

        if self.is_training:
            # Mosaic partners are drawn and read serially up front, from
            # the (seed, epoch, id) generators; the workers only decode and
            # augment, each example from its own generator, so the batch
            # does not depend on thread scheduling.
            mosaic_extra = [None] * b
            if cfg.data.mosaic_probability > 0.0:
                for j in range(n_real):
                    mrng = np.random.default_rng(
                        (self.seed, epoch, int(example_ids[j]), MOSAIC_SALT))
                    if mrng.random() < cfg.data.mosaic_probability:
                        ids = self._local[
                            mrng.integers(0, len(self._local), 3)]
                        mosaic_extra[j] = [
                            decode_detection_record(self.index.read(int(i)))
                            for i in ids]

            def _clean(d):
                # crowd annotations never become training targets
                keep = d["is_crowd"] == 0
                if keep.all():
                    return d["boxes"], d["labels"]
                return d["boxes"][keep], d["labels"][keep]

            def one(j):
                d = decoded[j]
                boxes, labels = _clean(d)
                img = native.decode_jpeg(d["jpeg"])
                rng = np.random.default_rng(
                    (self.seed, epoch, int(example_ids[j])))
                if mosaic_extra[j] is not None:
                    parts = [(img, boxes, labels)]
                    for ex in mosaic_extra[j]:
                        eb, el = _clean(ex)
                        parts.append((native.decode_jpeg(ex["jpeg"]), eb, el))
                    img, boxes, labels = mosaic_example(
                        [p[0] for p in parts], [p[1] for p in parts],
                        [p[2] for p in parts], rng, (ih, iw))
                img, boxes, labels = augment_example(
                    img, boxes, labels, rng, cfg.data)
                images_out[j] = native.resize(img, ih, iw)
                k = min(len(boxes), m)
                if k:
                    boxes_out[j, :k] = np.clip(boxes[:k], 0.0, 1.0)
                    labels_out[j, :k] = labels[:k]
                num_out[j] = k

            workers = max(1, min(cfg.data.num_workers, b))
            if workers == 1:
                for j in range(b):
                    one(j)
            else:
                with concurrent.futures.ThreadPoolExecutor(workers) as pool:
                    list(pool.map(one, range(b)))
        else:
            if decoded:
                images_out[:n_real] = native.decode_jpeg_batch(
                    [d["jpeg"] for d in decoded], ih, iw,
                    n_threads=cfg.data.num_workers)
            crowd_out = np.zeros((b, m), bool)
            for j, d in enumerate(decoded):
                boxes, labels = d["boxes"], d["labels"]
                k = min(len(boxes), m)
                if k:
                    boxes_out[j, :k] = np.clip(boxes[:k], 0.0, 1.0)
                    labels_out[j, :k] = labels[:k]
                    crowd_out[j, :k] = d["is_crowd"][:k] != 0
                num_out[j] = k

        batch = {
            "images": images_out,
            "boxes": boxes_out,
            "labels": labels_out,
            "num_boxes": num_out,
        }
        if not self.is_training:
            valid = np.zeros((b,), bool)
            valid[:n_real] = True
            batch["valid"] = valid
            batch["is_crowd"] = crowd_out
            # the dataset's image id (falling back to the local example
            # index) and the image's size before the resize, for COCO
            # results
            sids = np.full((b,), -1, np.int64)
            ohw = np.zeros((b, 2), np.int32)
            for j, d in enumerate(decoded):
                sid = d["source_id"]
                sids[j] = int(example_ids[j]) if sid is None else sid
                if d["height"] is not None and d["width"] is not None:
                    ohw[j] = (d["height"], d["width"])
                else:  # older records carry no size: the JPEG header's
                    ohw[j] = native.jpeg_dims(d["jpeg"])
            batch["source_ids"] = sids
            batch["orig_hw"] = ohw
        return batch

    # --------------------------------------------------------- iterate

    def _generate(self):
        while True:
            order = self._epoch_order(self.epoch)
            nb = self.batches_per_epoch()
            while self.position < nb:
                pos = self.position
                ids = order[pos * self.batch_size:(pos + 1) * self.batch_size]
                # advance BEFORE yielding: a batch handed out counts as
                # consumed, so a checkpointed state never replays it
                self.position = pos + 1
                yield self._make_batch(
                    ids, self.epoch,
                    image_hw=self._scale_for(self.epoch * nb + pos))
            if not self.is_training:
                return
            self.epoch += 1
            self.position = 0

    def __iter__(self):
        """Prefetching iterator. Closing it (or leaving a ``for`` loop)
        stops the prefetch thread and waits for it."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            # An error here must reach the consumer: a producer that died
            # quietly would look like a clean end of data.
            try:
                for batch in self._generate():
                    if not put(batch):
                        return
                put(None)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                put(e)

        thread = threading.Thread(target=producer, daemon=True,
                                  name="pipeline-prefetch")
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                self.consumed += 1
                yield batch
        finally:
            stop.set()
            thread.join()
