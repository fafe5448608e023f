"""Inference front-end: the public ``predict`` contract on the card.

    predict(images uint8 (N, H, W, 3) | (H, W, 3) | list of (H, W, 3)) ->
        {boxes (N, max_boxes, 4), scores (N, max_boxes),
         labels (N, max_boxes), num_boxes (N,)}

Host-side resize to the model resolution (bilinear, uint8 in and out),
power-of-two batch buckets, and the feed: for dense4 configs the packed s8
feed (the host packs the batch space-to-depth(4) and the stem consumes it
as is), otherwise the raw uint8 batch, normalized on the card.
Boxes are normalized ``(ymin, xmin, ymax, xmax)``; with ``preserve_aspect``
they are mapped back from the letterbox canvas to the original frame.
"""

from __future__ import annotations

import numpy as np
import torch

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.convert import load_npz_artifact
from ssd_tpu_torch.data.resize import resize
from ssd_tpu_torch.models.detector import Detector
from ssd_tpu_torch.ops.ingest import pack_s2d, packed_shape


def _as_hw(size) -> tuple[int, int]:
    return (size, size) if isinstance(size, int) else tuple(size)


def resize_image(image: np.ndarray, size_hw) -> np.ndarray:
    """Bilinear uint8 resize to ``size_hw`` (square int or (height, width))."""
    th, tw = _as_hw(size_hw)
    return resize(np.ascontiguousarray(image), th, tw)


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
    canvas[:nh, :nw] = resize(np.ascontiguousarray(image), nh, nw)
    return canvas, nh / th, nw / tw


class Predictor:
    """Serves batched inference from a config and a state dict (``None``:
    weights seeded from 0).

    ``device=None`` runs on the card (and raises without one);
    ``device="cpu"`` runs the plain versions. ``packed_ingest=None`` packs
    the feed for dense4 configs and feeds raw uint8 otherwise; ``False``
    forces the raw feed.
    """

    def __init__(self, cfg: Config, state: dict | None,
                 preserve_aspect: bool = False, device=None,
                 packed_ingest: bool | None = None):
        self.cfg = cfg
        self.detector = Detector(cfg, state, device=device)
        self.device = self.detector.device
        self.preserve_aspect = preserve_aspect
        dense4 = cfg.model.stem_schedule == "dense4"
        if packed_ingest is None:
            packed_ingest = dense4
        elif packed_ingest and not dense4:
            raise ValueError("the packed feed is the dense4 stem's")
        self._packed = bool(packed_ingest)

    @classmethod
    def from_npz(cls, path: str, **kwargs) -> "Predictor":
        """A predictor for an ``.npz`` artifact (``convert.save_npz_artifact``)."""
        cfg, state = load_npz_artifact(path)
        return cls(cfg, state, **kwargs)

    # -------------------------------------------------------------- serving

    @staticmethod
    def _bucket_for(n: int) -> int:
        """Batch bucket for n images: the next power of two."""
        return 1 << (max(n, 1) - 1).bit_length()

    def predict(self, images) -> dict:
        """``images``: uint8 ``(H, W, 3)`` or ``(N, H, W, 3)``, or a list of
        ``(H, W, 3)`` arrays of any sizes (each is resized, or letterboxed,
        to the model resolution; the set runs as one batch), or, with the
        packed feed, a list of packed ``(H/4, W/4, 48)`` s8 arrays."""
        return self.predict_collect(self.predict_dispatch(images))

    def _launch(self, feed: np.ndarray, n: int) -> dict:
        bucket = self._bucket_for(n)
        if bucket != n:
            feed = np.concatenate(
                [feed, np.zeros((bucket - n,) + feed.shape[1:], feed.dtype)])
        return self.detector.predict(feed)

    def predict_dispatch(self, images) -> dict:
        """Preprocess and enqueue the device work without waiting for it.
        Returns a handle for ``predict_collect``."""
        if isinstance(images, (list, tuple)):
            single = False
            image_list = [np.asarray(im) for im in images]
        else:
            images = np.asarray(images)
            single = images.ndim == 3
            image_list = [images] if single else list(images)
        hw = self.cfg.image_hw()

        # Pre-packed fast path: an upstream tier already packed the images.
        if self._packed and image_list and all(
                im.ndim == 3 and im.dtype == np.int8
                and im.shape == packed_shape(hw) for im in image_list):
            out = self._launch(np.stack(image_list), len(image_list))
            return {"out": out, "n": len(image_list), "valid_frac": None,
                    "single": single}
        valid_frac = None
        if self.preserve_aspect:
            canvases, fracs = [], []
            for im in image_list:
                canvas, fh, fw = letterbox_image(im, hw)
                canvases.append(canvas)
                fracs.append((fh, fw))
            batch = np.stack(canvases)
            valid_frac = np.asarray(fracs, np.float32)  # (N, 2)
        else:
            batch = np.stack([
                im if im.shape[:2] == hw else resize_image(im, hw)
                for im in image_list
            ])
        batch = batch.astype(np.uint8)
        out = self._launch(self._feed(batch), batch.shape[0])
        return {"out": out, "n": batch.shape[0], "valid_frac": valid_frac,
                "single": single}

    def predict_collect(self, handle: dict) -> dict:
        """Wait for a ``predict_dispatch`` handle; numpy results."""
        out, n = handle["out"], handle["n"]
        valid_frac, single = handle["valid_frac"], handle["single"]
        boxes = out.boxes[:n].cpu().numpy()
        if valid_frac is not None:
            # map letterboxed coords back to the original image frame
            fh = valid_frac[:, 0][:, None, None]
            fw = valid_frac[:, 1][:, None, None]
            boxes = boxes.copy()
            boxes[..., 0::2] = np.clip(boxes[..., 0::2] / fh, 0.0, 1.0)
            boxes[..., 1::2] = np.clip(boxes[..., 1::2] / fw, 0.0, 1.0)
        result = {
            "boxes": boxes,
            "scores": out.scores[:n].cpu().numpy(),
            "labels": out.labels[:n].cpu().numpy(),
            "num_boxes": out.num_boxes[:n].cpu().numpy(),
        }
        if single:
            result = {k: v[0] for k, v in result.items()}
        return result

    def _feed_shape(self, n: int) -> tuple:
        """The device feed's shape for a batch of ``n``: packed or raw."""
        if self._packed:
            return packed_shape(self.cfg.image_hw(), n)
        return (n, *self.cfg.image_hw(), 3)

    def _feed(self, images: np.ndarray) -> np.ndarray:
        """Host-side ingest: a raw uint8 batch -> the device feed."""
        return pack_s2d(images) if self._packed else images

    def warmup(self, batch_size: int = 1) -> None:
        """Run one zero batch of this size's bucket (first-call set-up:
        cuDNN algorithm choice, the kernel build and load)."""
        shape = self._feed_shape(self._bucket_for(batch_size))
        dtype = np.int8 if self._packed else np.uint8
        self.detector.predict(np.zeros(shape, dtype))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
