"""Streaming inference, one frame a call (the port's ``ssd_tpu/streaming.py``;
the shipped ``configs/streaming_1024.json``: the reference stem at
1024x1024).

A bounded window of frames in flight (``depth``, default 2): the host
feeds frame N+1 while the card runs frame N. It sits on the predictor's
machinery (``predictor.Predictor``): the host feed (the packed s8 feed for
dense4 configs, the raw uint8 frame otherwise) goes into a pinned staging
buffer (``device.PinnedStaging``) and up without waiting, the model and
postprocess (K1 doing the NMS) are enqueued behind it, then asynchronous
copies of the detections into pinned host tensors and one event. ``push``
never waits for the card; ``_fetch_one`` waits on its frame's event alone.

    s = StreamingDetector(cfg, state)       # cfg.image_size = 1024
    s.warmup()
    for frame in video:                      # uint8 (H, W, 3), any size
        for det in s.push(frame): consume(det)
    for det in s.flush(): consume(det)

A frame of another size is stretched to the model resolution by the
native bilinear resize (``data/native.resize``), not letterboxed. Each
result is ``{boxes (max_boxes, 4), scores, labels, num_boxes: int}``;
``stats()`` gives the p50/p95 latency from push to fetch and the fps of
the recent fetches.
"""

from __future__ import annotations

import collections
import time

import numpy as np
from torch.profiler import record_function

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.data import native
from ssd_tpu_torch.predictor import Predictor, check_spatial

PUSH_SPAN = "streaming.push"  # a push's host work: resize and enqueue


class StreamingDetector:
    """``state``: a state dict (``None``: weights seeded from 0);
    ``device=None`` runs on the card. ``mesh``: a ``parallel.mesh.Mesh``
    (or ``True``) for the predictor's data-parallel replicas, as the JAX
    package takes a mesh alone: a frame is bucketed to one row a replica
    and every replica runs on its block, the others on padding rows, as
    JAX's meshed bucket does. ``spatial_shard`` with a mesh: each frame's
    height split over the mesh's ``model`` axis (``parallel/spatial.py``),
    on the raw uint8 feed; without a mesh it is ignored, as the JAX
    package ignores it."""

    def __init__(self, cfg: Config, state: dict | None, depth: int = 2,
                 mesh=None, spatial_shard: bool = False, device=None):
        if depth < 1:
            raise ValueError(f"depth must be at least 1, got {depth}")
        spatial_shard = spatial_shard and mesh is not None
        if spatial_shard and mesh is not True:
            check_spatial(cfg, mesh, "frame")
        self.cfg = cfg
        self.predictor = Predictor(cfg, state, device=device, mesh=mesh,
                                   spatial_shard=spatial_shard)
        self.detector = self.predictor.detector
        self.device = self.predictor.device
        self.depth = depth
        # a buffer for each frame in flight (depth + 1 right after a push)
        # and the one being filled; the event guards keep reuse correct
        # with fewer, the depth decides only whether staging waits
        self.predictor.staging.depth = max(self.predictor.staging.depth,
                                           depth + 2)
        self._inflight: collections.deque = collections.deque()
        self._lat = collections.deque(maxlen=256)
        self._done_t = collections.deque(maxlen=256)  # fetch times

    @property
    def packed(self) -> bool:
        """Whether frames go up as the packed s8 feed (dense4 configs)."""
        return self.predictor._packed

    def warmup(self) -> None:
        """One zero frame through the whole path (cuDNN's algorithm
        choice, the kernel build, the staging pool), off the stream, and
        the native library that resizes frames of another size (built at
        its first use)."""
        native.library()
        self.predictor.predict(
            np.zeros((*self.cfg.image_hw(), 3), np.uint8))

    def _fetch_one(self) -> dict:
        t0, handle = self._inflight.popleft()
        out = self.predictor.predict_collect(handle)  # this frame's event
        now = time.perf_counter()
        self._lat.append(now - t0)
        self._done_t.append(now)
        return {"boxes": out["boxes"], "scores": out["scores"],
                "labels": out["labels"], "num_boxes": int(out["num_boxes"])}

    def push(self, frame: np.ndarray):
        """Submit one uint8 frame; yields the oldest results while more
        than ``depth`` frames are in flight."""
        ih, iw = self.cfg.image_hw()
        frame = np.asarray(frame)
        with record_function(PUSH_SPAN):
            if frame.shape[:2] != (ih, iw):
                frame = native.resize(np.ascontiguousarray(frame), ih, iw)
            handle = self.predictor.predict_dispatch(frame)
        self._inflight.append((time.perf_counter(), handle))
        while len(self._inflight) > self.depth:
            yield self._fetch_one()

    def flush(self):
        """Yields the results of the frames still in flight, oldest first."""
        while self._inflight:
            yield self._fetch_one()

    def stats(self) -> dict:
        """p50/p95 latency (seconds, push to fetch) over the last 256
        frames, and ``fps``: fetches per second over the same window."""
        lat = sorted(self._lat)
        if not lat:
            return {}
        out = {"p50_latency_s": lat[len(lat) // 2],
               "p95_latency_s": lat[int(len(lat) * 0.95)]}
        if len(self._done_t) >= 2:
            span = self._done_t[-1] - self._done_t[0]
            out["fps"] = (len(self._done_t) - 1) / max(span, 1e-9)
        return out
