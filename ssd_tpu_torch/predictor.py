"""Inference front-end: the public ``predict`` contract on the card.

    predict(images uint8 (N, H, W, 3) | (H, W, 3) | list of (H, W, 3)) ->
        {boxes (N, max_boxes, 4), scores (N, max_boxes),
         labels (N, max_boxes), num_boxes (N,)}  (+ names with a label map)

Host-side resize to the model resolution (bilinear, uint8 in and out, in
the native host library ``data/native.py``), power-of-two batch buckets,
and the feed: for dense4 configs the packed s8 feed (the host packs the
batch space-to-depth(4) in native threads and the stem consumes it as is),
otherwise the raw uint8 batch, normalized on the card. int8 artifacts serve
the same way, their calibrated scales loaded with the weights; a resolution
they were not calibrated at raises at the first request
(``models/layers.QuantConv``). Boxes are normalized ``(ymin, xmin, ymax,
xmax)``; with ``preserve_aspect`` they are mapped back from the letterbox
canvas to the original frame.

On the card, ``predict_dispatch`` returns without waiting for the device:
the host feed is written into a pinned staging buffer and copied
asynchronously (``device.PinnedStaging``: a pool of buffers per feed
shape, each reused only after an event says its last copy has left it), the model and
postprocess are enqueued behind it, then asynchronous copies of the four
outputs into pinned host tensors, and one event. ``predict_collect`` waits
on that event alone, so collecting batch k never waits for batch k + 1,
and it issues no device work.

    python -m ssd_tpu_torch.predictor --export DIR_OR_FILE.npz \\
        --images a.jpg b.png \\
        [--out dets.json] [--batch-size 8] [--score-threshold 0.3] \\
        [--letterbox] [--device cpu] \\
        [--tta | --tiled [--tile-overlap 0.25] [--edge-penalty 0.5]]

``--tta``: flip test-time augmentation fused by weighted box fusion
(``tta.py``); ``--tiled``: native-resolution tiled inference of each image
(``tiling.py``, one predict of its tiles per image); ``--mesh``:
data-parallel serving over every visible card (``Predictor(mesh=True)``).

Data-parallel serving (``mesh``, the JAX package's meshed predict): a
replica of the model on each of the mesh's devices, batch buckets rounded
up to a multiple of the device count, and each replica predicting its
contiguous block of the bucket's rows (its own K1 launch on its own device
and stream); the rows come back in order, the same as one device's.
"""


from __future__ import annotations

import json

import numpy as np
import torch
from torch.profiler import record_function

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.data import native
from ssd_tpu_torch.device import PinnedStaging
from ssd_tpu_torch.export import (add_artifact_args,
                                  load_artifact_label_map,
                                  load_inference_artifact)
from ssd_tpu_torch.models.detector import Detector
from ssd_tpu_torch.ops.ingest import packed_shape
from ssd_tpu_torch.parallel import mesh as mesh_lib

DET_KEYS = ("boxes", "scores", "labels", "num_boxes")


def _as_hw(size) -> tuple[int, int]:
    return (size, size) if isinstance(size, int) else tuple(size)


def resize_image(image: np.ndarray, size_hw) -> np.ndarray:
    """Bilinear uint8 resize to ``size_hw`` (square int or (height, width))
    in the native library, as the train and eval decode paths resize."""
    th, tw = _as_hw(size_hw)
    return native.resize(np.ascontiguousarray(image), th, tw)


def letterbox_image(image: np.ndarray,
                    size_hw) -> tuple[np.ndarray, float, float]:
    """Aspect-preserving resize onto a zero canvas (padding at the bottom and
    right). Returns ``(canvas, valid_h_frac, valid_w_frac)``."""
    h, w = image.shape[:2]
    th, tw = _as_hw(size_hw)
    scale = min(th / h, tw / w)
    nh, nw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
    nh, nw = min(nh, th), min(nw, tw)
    canvas = np.zeros((th, tw, 3), np.uint8)
    canvas[:nh, :nw] = native.resize(np.ascontiguousarray(image), nh, nw)
    return canvas, nh / th, nw / tw


class Predictor:
    """Serves batched inference from a config and a state dict (``None``:
    weights seeded from 0).

    ``label_map``: class id -> name; results then carry ``names``.
    ``device=None`` runs on the card (and raises without one);
    ``device="cpu"`` runs the plain versions. ``packed_ingest=None`` packs
    the feed for dense4 configs and feeds raw uint8 otherwise; ``False``
    forces the raw feed. ``staging.depth``: pinned staging buffers per feed
    shape, at least the number of batches in flight plus one (a serving
    loop raises it to its own depth).

    ``mesh``: ``True`` (every visible card; ``[device]`` when one is
    given) or a ``parallel.mesh.Mesh`` for data-parallel serving (the
    module docstring); the replicas copy the weights once, here.
    ``spatial_shard`` (height-sharded images) needs a mesh and is not
    ported (M11b).
    """

    def __init__(self, cfg: Config, state: dict | None,
                 label_map: dict[int, str] | None = None,
                 preserve_aspect: bool = False, device=None,
                 packed_ingest: bool | None = None, mesh=None,
                 spatial_shard: bool = False):
        if spatial_shard:
            if mesh is None:
                raise ValueError("spatial_shard requires a mesh")
            raise NotImplementedError(f"spatial_shard {mesh_lib.M11B}")
        if mesh is True:
            mesh = mesh_lib.create_mesh(None if device is None else [device])
        elif mesh is not None and not isinstance(mesh, mesh_lib.Mesh):
            raise TypeError(f"mesh must be True or a parallel.mesh.Mesh, "
                            f"not {type(mesh).__name__}")
        self.cfg = cfg
        self.mesh = mesh
        self.detector = Detector(cfg, state, device=(
            device if mesh is None else mesh.device))
        self.device = self.detector.device
        self.replicas = ([self.detector] if mesh is None
                         else mesh_lib.replicate(self.detector, mesh))
        self.label_map = label_map
        self.preserve_aspect = preserve_aspect
        dense4 = cfg.model.stem_schedule == "dense4"
        if packed_ingest is None:
            packed_ingest = dense4
        elif packed_ingest and not dense4:
            raise ValueError("the packed feed is the dense4 stem's")
        self._packed = bool(packed_ingest)
        # pinned staging on the card; False copies from pageable memory
        # (kept to measure the two against each other)
        self._pinned = self.device.type == "cuda"
        self.staging = PinnedStaging(depth=3)

    @classmethod
    def from_checkpoint(cls, path: str, **kwargs) -> "Predictor":
        """A predictor for an inference artifact: a directory
        (``export.save_inference_artifact``) or a single-file ``.npz``,
        with its label map where it has one."""
        cfg, state = load_inference_artifact(path)
        kwargs.setdefault("label_map", load_artifact_label_map(path))
        return cls(cfg, state, **kwargs)

    @classmethod
    def from_npz(cls, path: str, **kwargs) -> "Predictor":
        """A predictor for an ``.npz`` artifact (``convert.save_npz_artifact``,
        its label map from ``label_map_array``): ``from_checkpoint``."""
        return cls.from_checkpoint(path, **kwargs)

    # -------------------------------------------------------------- serving

    def _min_bucket(self) -> int:
        """Buckets are multiples of this: the data-parallel width, the
        number of replicas."""
        return len(self.replicas)

    def _bucket_for(self, n: int) -> int:
        """Batch bucket for n images: the next power of two, rounded up to
        a multiple of ``_min_bucket``."""
        bucket = 1 << (max(n, 1) - 1).bit_length()
        m = self._min_bucket()
        return -(-bucket // m) * m

    def __call__(self, images) -> dict:
        return self.predict(images)

    def predict(self, images) -> dict:
        """``images``: uint8 ``(H, W, 3)`` or ``(N, H, W, 3)``, or a list of
        ``(H, W, 3)`` arrays of any sizes (each is resized, or letterboxed,
        to the model resolution; the set runs as one batch), or, with the
        packed feed, a list of packed ``(H/4, W/4, 48)`` s8 arrays."""
        return self.predict_collect(self.predict_dispatch(images))

    def _feed_shape(self, n: int) -> tuple:
        """The device feed's shape for a batch of ``n``: packed or raw."""
        if self._packed:
            return packed_shape(self.cfg.image_hw(), n)
        return (n, *self.cfg.image_hw(), 3)

    def _feed_dtype(self):
        return np.int8 if self._packed else np.uint8

    def _feed(self, images: np.ndarray, out: np.ndarray | None = None
              ) -> np.ndarray:
        """Host-side ingest: a raw uint8 batch -> the device feed, packed in
        the native library for the packed feed (into ``out`` if given)."""
        if self._packed:
            return native.pack_s2d(images, out=out)
        if out is None:
            return images
        out[...] = images
        return out

    def _host_feed(self, image_list: list, batch: np.ndarray | None = None
                   ) -> tuple[callable, int, object]:
        """-> (fill, n, valid_frac): ``fill(out)`` writes the bucket-padded
        feed of these images into the array ``out``. ``batch``: the same
        images as one ``(N, H, W, 3)`` array, where the caller passed one
        (packed from as it is at the model resolution)."""
        hw = self.cfg.image_hw()
        n = len(image_list)
        # Pre-packed: an upstream tier (the serve daemon's handler threads)
        # already packed each image; stack into the feed and zero-pad.
        if self._packed and image_list and all(
                im.ndim == 3 and im.dtype == np.int8
                and im.shape == packed_shape(hw) for im in image_list):
            def fill(out):
                for i, im in enumerate(image_list):
                    out[i] = im
                out[n:] = 0
            return fill, n, None
        valid_frac = None
        if self.preserve_aspect:
            canvases, fracs = [], []
            for im in image_list:
                canvas, fh, fw = letterbox_image(im, hw)
                canvases.append(canvas)
                fracs.append((fh, fw))
            batch = np.stack(canvases)
            valid_frac = np.asarray(fracs, np.float32)  # (N, 2)
        elif batch is None or batch.shape[1:3] != hw:
            batch = np.stack([
                im if im.shape[:2] == hw else resize_image(im, hw)
                for im in image_list])
        batch = batch.astype(np.uint8, copy=False)

        def fill(out):
            self._feed(batch, out=out[:n])
            # the padding rows are zero images, packed or raw
            out[n:] = -128 if self._packed else 0
        return fill, n, valid_frac

    @torch.inference_mode()
    def _enqueue(self, images) -> dict:
        """Host feed, copy to the card, model and postprocess enqueued; the
        detections stay on the device."""
        batch = None
        if isinstance(images, (list, tuple)):
            single = False
            image_list = [np.asarray(im) for im in images]
        else:
            images = np.asarray(images)
            single = images.ndim == 3
            image_list = [images] if single else list(images)
            batch = images[None] if single else images
        with record_function("predict.feed"):
            fill, n, valid_frac = self._host_feed(image_list, batch)
            shape = self._feed_shape(self._bucket_for(n))
            if self._pinned:
                # the pool is allocated at a shape's first use (``warmup``
                # does that off the request path)
                buf, event = self.staging.take(
                    shape, torch.int8 if self._packed else torch.uint8)
                host = buf.numpy()
            else:
                host = np.empty(shape, self._feed_dtype())
            fill(host)
        bounds = mesh_lib.row_bounds(shape[0], len(self.replicas))
        devices = [r.device for r in self.replicas]
        with record_function("predict.copy"):
            if self._pinned:
                feeds = self.staging.upload_rows(buf, event, devices, bounds)
            else:
                feeds = [torch.from_numpy(host[lo:hi]).to(
                    d, non_blocking=True) for d, (lo, hi) in zip(devices,
                                                                 bounds)]
        with record_function("predict.launch"):
            outs = [r.predict(f) for r, f in zip(self.replicas, feeds)]
        return {"outs": outs, "bounds": bounds, "n": n,
                "valid_frac": valid_frac, "single": single}

    @staticmethod
    def _real_rows(part: dict) -> list:
        """``(replica index, its first row, the rows)`` of a part's real
        rows (the first ``n`` of the bucket), in row order."""
        return [(i, lo, min(hi, part["n"]) - lo)
                for i, (lo, hi) in enumerate(part["bounds"])
                if lo < part["n"]]

    def _readback(self, parts: list[dict]) -> tuple[dict, list | None]:
        """The detections of ``parts`` (their real rows, concatenated) on
        their way to the host: on the card asynchronous copies into pinned
        tensors and an event a device marking their end; on the CPU the
        tensors themselves and no events."""
        blocks = [(p["outs"][i], rows) for p in parts
                  for i, _, rows in self._real_rows(p)]
        with torch.inference_mode(), record_function("predict.launch"):
            if self.device.type != "cuda":
                if len(blocks) == 1:
                    out, rows = blocks[0]
                    return {k: getattr(out, k)[:rows] for k in DET_KEYS}, None
                return {k: torch.cat([getattr(o, k)[:rows]
                                      for o, rows in blocks])
                        for k in DET_KEYS}, None
            total = sum(rows for _, rows in blocks)
            first = blocks[0][0]
            host = {k: torch.empty((total, *getattr(first, k).shape[1:]),
                                   dtype=getattr(first, k).dtype,
                                   pin_memory=True) for k in DET_KEYS}
            events, lo = {}, 0
            for out, rows in blocks:
                dev = out.num_boxes.device
                with torch.cuda.device(dev):
                    for k in DET_KEYS:
                        host[k][lo:lo + rows].copy_(getattr(out, k)[:rows],
                                                    non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                events[dev] = event  # a device's last copy ends its others
                lo += rows
        return host, list(events.values())

    def predict_dispatch(self, images) -> dict:
        """Preprocess and enqueue the device work and the readback without
        waiting for them. Returns a handle for ``predict_collect``."""
        part = self._enqueue(images)
        host, events = self._readback([part])
        return {"host": host, "events": events, "n": part["n"],
                "valid_frac": part["valid_frac"], "single": part["single"]}

    def _finish(self, arrays: dict, valid_frac, single: bool) -> dict:
        boxes = arrays["boxes"]
        if valid_frac is not None:
            # map letterboxed coords back to the original image frame
            fh = valid_frac[:, 0][:, None, None]
            fw = valid_frac[:, 1][:, None, None]
            boxes = boxes.copy()
            boxes[..., 0::2] = np.clip(boxes[..., 0::2] / fh, 0.0, 1.0)
            boxes[..., 1::2] = np.clip(boxes[..., 1::2] / fw, 0.0, 1.0)
        result = {"boxes": boxes, "scores": arrays["scores"],
                  "labels": arrays["labels"],
                  "num_boxes": arrays["num_boxes"]}
        if self.label_map is not None:
            result["names"] = np.array([
                [self.label_map.get(int(l), str(int(l))) for l in row]
                for row in result["labels"]])
        if single:
            result = {k: v[0] for k, v in result.items()}
        return result

    @staticmethod
    def _wait(handle: dict) -> dict:
        """Waits on a handle's events alone; its outputs as numpy."""
        with record_function("predict.readback"):
            for event in handle["events"] or ():
                event.synchronize()
            return {k: v.numpy() for k, v in handle["host"].items()}

    def predict_collect(self, handle: dict) -> dict:
        """Wait for a ``predict_dispatch`` handle; numpy results."""
        return self._finish(self._wait(handle), handle["valid_frac"],
                            handle["single"])

    # ------------------------------------------------- grouped dispatch

    def predict_dispatch_group(self, batches: list) -> dict:
        """Dispatch several independent batches under one handle: each is
        enqueued as ``predict_dispatch`` would (its own bucket, feed and
        letterbox), back to back on the stream, followed by one readback of
        all their detections and one event. ``batches``: lists of images
        in the forms ``predict_dispatch`` takes. Returns a handle for
        ``predict_collect_group``."""
        parts = [self._enqueue(list(b)) for b in batches]
        host, events = self._readback(parts)
        return {"host": host, "events": events,
                "ns": [p["n"] for p in parts],
                "valid_frac": [p["valid_frac"] for p in parts]}

    def predict_collect_group(self, handle: dict) -> list[dict]:
        """Wait for a ``predict_dispatch_group`` handle -> one result dict
        per batch, each as ``predict_collect`` returns it."""
        arrays = self._wait(handle)
        out, lo = [], 0
        for n, valid_frac in zip(handle["ns"], handle["valid_frac"]):
            out.append(self._finish({k: v[lo:lo + n] for k, v in
                                     arrays.items()}, valid_frac, False))
            lo += n
        return out

    def warmup(self, batch_size: int = 1) -> None:
        """Run one zero batch of this size's bucket through the whole path
        (first-call set-up off the request path: cuDNN's algorithm choice,
        the kernel build and load, the pinned staging pool)."""
        bucket = self._bucket_for(batch_size)
        self.predict(np.zeros((bucket, *self.cfg.image_hw(), 3), np.uint8))

    def warmup_group(self, batch_size: int, k: int) -> None:
        """Run ``k`` zero batches of this size's bucket as one group."""
        bucket = self._bucket_for(batch_size)
        zeros = np.zeros((bucket, *self.cfg.image_hw(), 3), np.uint8)
        self.predict_collect_group(self.predict_dispatch_group(
            [list(zeros)] * k))


def read_image(path: str) -> np.ndarray:
    """An image file at its native size, uint8 RGB: libjpeg in the native
    library, PIL for other formats where it is installed."""
    with open(path, "rb") as f:
        return native.decode_jpeg(f.read())


def detection_rows(result: dict, score_threshold: float) -> list[dict]:
    """One image's result (as ``predict`` returns it for a single image)
    -> its detections at or above ``score_threshold`` as JSON rows, boxes
    and scores rounded to 4 decimals (the JAX package's CLI and daemon
    format)."""
    rows = []
    for i in range(int(result["num_boxes"])):
        score = float(result["scores"][i])
        if score < score_threshold:
            continue
        row = {"box_yxyx": [round(float(v), 4) for v in result["boxes"][i]],
               "score": round(score, 4), "label": int(result["labels"][i])}
        if "names" in result:
            row["name"] = str(result["names"][i])
        rows.append(row)
    return rows


def detections_arrays(rows: list[list[dict]], max_boxes: int) -> dict:
    """Per-image JSON rows (``detection_rows``) -> padded ``{boxes, scores,
    labels, num_boxes}`` arrays, labels -1 past ``num_boxes``."""
    n = len(rows)
    out = {"boxes": np.zeros((n, max_boxes, 4), np.float32),
           "scores": np.zeros((n, max_boxes), np.float32),
           "labels": np.full((n, max_boxes), -1, np.int32),
           "num_boxes": np.zeros((n,), np.int32)}
    for i, dets in enumerate(rows):
        out["num_boxes"][i] = len(dets)
        for j, d in enumerate(dets):
            out["boxes"][i, j] = d["box_yxyx"]
            out["scores"][i, j] = d["score"]
            out["labels"][i, j] = d["label"]
    return out


def main(argv=None) -> None:
    """Batch-predict CLI: images in, JSON detections out."""
    import argparse
    import sys

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_artifact_args(p)
    p.add_argument("--images", nargs="+", required=True)
    p.add_argument("--out", default=None, help="JSON output (default stdout)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--score-threshold", type=float, default=0.3)
    p.add_argument("--letterbox", action="store_true",
                   help="preserve aspect ratio (zero-pad) instead of stretch")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--tiled", action="store_true",
                   help="native-resolution tiled inference for images far "
                        "above the model resolution (ssd_tpu_torch.tiling)")
    p.add_argument("--tile-overlap", type=float, default=0.25)
    p.add_argument("--edge-penalty", type=float, default=0.5)
    p.add_argument("--tta", action="store_true",
                   help="flip test-time augmentation with weighted box "
                        "fusion (ssd_tpu_torch.tta)")
    p.add_argument("--mesh", action="store_true",
                   help="shard batches over every visible card "
                        "(data-parallel serving)")
    args = p.parse_args(argv)
    if args.tta and args.tiled:
        p.error("--tta and --tiled are mutually exclusive")

    predictor = Predictor.from_checkpoint(args.artifact,
                                          preserve_aspect=args.letterbox,
                                          device=args.device,
                                          mesh=args.mesh or None)
    results = []
    if args.tiled:
        from ssd_tpu_torch.tiling import TiledPredictor
        tiler = TiledPredictor(predictor, overlap=args.tile_overlap,
                               edge_penalty=args.edge_penalty)
        for path in args.images:  # tiles are the batch: a predict an image
            results.append({"image": path, "detections": detection_rows(
                tiler.predict(read_image(path)), args.score_threshold)})
    else:
        if args.tta:
            from ssd_tpu_torch.tta import TTAPredictor
            predictor = TTAPredictor(predictor)
        for lo in range(0, len(args.images), args.batch_size):
            chunk = args.images[lo:lo + args.batch_size]
            # one batched predict per chunk; mixed sizes are resized first
            out = predictor.predict([read_image(path) for path in chunk])
            for j, path in enumerate(chunk):
                results.append({"image": path, "detections": detection_rows(
                    {k: v[j] for k, v in out.items()},
                    args.score_threshold)})
    text = json.dumps(results, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {sum(len(r['detections']) for r in results)} "
              f"detections for {len(results)} images to {args.out}")
    else:
        sys.stdout.write(text + "\n")


if __name__ == "__main__":
    main()
