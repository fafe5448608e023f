"""HTTP serving daemon with cross-request dynamic batching (the port's
``ssd_tpu/serve.py``).

The card wants large batches, but HTTP clients arrive one image at a time,
so request handling is decoupled from device work:

  * handler threads (``ThreadingHTTPServer``) decode each JPEG with the
    native fused decode+resize straight to the model resolution and, for
    the packed dense4 feed, pack it, then enqueue ``(image, Future)``;
    ctypes releases the GIL, so these overlap across requests;
  * one dispatcher thread owns the device: it drains the queue into a
    batch (waiting at most ``max_wait_ms`` for stragglers, up to
    ``max_batch``), optionally groups up to ``scan_depth`` batches already
    queued into one handle, and issues them with
    ``Predictor.predict_dispatch`` (or ``_group``), which returns before
    the device finishes;
  * a collector thread waits on each handle's event (at most
    ``pipeline_depth`` handles in flight) and resolves the futures, so the
    device computes batch k while batch k + 1 is formed, packed and
    copied; it issues no device work, except with ``--tta``, where it runs
    the fusion of each batch's two views (``tta.TTAPredictor``, on the
    card) and ``scan_depth`` is 1, as in the JAX package;
  * ``--mesh``: data-parallel serving over every visible card
    (``Predictor(mesh=True)``: a replica a card, each batch's rows split
    among them); ``scan_depth`` is 1 under a mesh, as in the JAX package.

Endpoints:
  POST /v1/detect[?score_threshold=]  image bytes -> detections JSON
  GET  /healthz                       liveness and model identity
  GET  /v1/stats                      counters, batch sizes, latencies

    python -m ssd_tpu_torch.serve --export DIR_OR_FILE.npz --port 8000 \\
        [--max-batch 32] [--max-wait-ms 5] [--scan-depth 1] \\
        [--warmup-batches all] [--score-threshold 0.3] [--letterbox] \\
        [--device cpu] [--tta] [--mesh]
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ssd_tpu_torch.data import native
from ssd_tpu_torch.export import add_artifact_args
from ssd_tpu_torch.predictor import Predictor, detection_rows


class ServerStats:
    """Thread-safe counters and bounded latency and batch-size reservoirs."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self._window = window
        self.requests = 0
        self.errors = 0
        self.batches = 0
        self.images = 0
        self._lat_ms: list[float] = []
        self._batch_sizes: list[int] = []
        self._dispatch_ms: list[float] = []

    def record_request(self, ok: bool) -> None:
        with self._lock:
            self.requests += 1
            if not ok:
                self.errors += 1

    def _keep(self, buf: list, value) -> None:
        buf.append(value)
        if len(buf) > self._window:
            del buf[: len(buf) - self._window]

    def record_batch(self, size: int, latency_s: float) -> None:
        with self._lock:
            self.batches += 1
            self.images += size
            self._keep(self._lat_ms, latency_s * 1e3)
            self._keep(self._batch_sizes, size)

    def record_dispatch(self, seconds: float) -> None:
        """The dispatcher's host time to issue one batch or group."""
        with self._lock:
            self._keep(self._dispatch_ms, seconds * 1e3)

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat_ms)
            issue = sorted(self._dispatch_ms)
            sizes = self._batch_sizes[:]
            counts = {"requests": self.requests, "errors": self.errors,
                      "batches": self.batches, "images": self.images}

        def pct(values, p):
            return (round(values[int(p * (len(values) - 1))], 2)
                    if values else None)
        return {**counts,
                "mean_batch_size": (round(sum(sizes) / len(sizes), 2)
                                    if sizes else None),
                "batch_latency_ms": {f"p{q}": pct(lat, q / 100)
                                     for q in (50, 90, 99)},
                "dispatch_ms": {f"p{q}": pct(issue, q / 100)
                                for q in (50, 90, 99)}}


class _Dispatcher(threading.Thread):
    """The one device-owning thread: drains the request queue into batches
    and issues them without waiting (``Predictor.predict_dispatch``). A
    bounded in-flight queue (``pipeline_depth``) feeds the collector
    thread, which waits on each handle's event and resolves the futures."""

    def __init__(self, predictor: Predictor, requests: "queue.Queue",
                 stats: ServerStats, max_batch: int, max_wait_ms: float,
                 pipeline_depth: int = 2, scan_depth: int = 1):
        super().__init__(daemon=True, name="ssd-torch-dispatcher")
        self.predictor = predictor
        self.requests = requests
        self.stats = stats
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        # scan_depth > 1: group up to K batches ALREADY queued into one
        # handle (one readback, one event); it adds no wait. Under a mesh
        # each batch is dispatched alone, as in the JAX package.
        self.scan_depth = (1 if getattr(predictor, "mesh", None) is not None
                           else max(1, int(scan_depth)))
        self.in_flight: "queue.Queue" = queue.Queue(maxsize=pipeline_depth)
        if predictor is not None:
            # a staging buffer for every batch that can be ahead of the card
            predictor.staging.depth = max(
                predictor.staging.depth,
                pipeline_depth * self.scan_depth + 1)
        self.collector = threading.Thread(
            target=self._collect_loop, daemon=True, name="ssd-torch-collector")
        # threading.Thread has a private ``_stop``; the event must not
        # shadow it
        self._stop_event = threading.Event()

    def start(self) -> None:
        self.collector.start()
        super().start()

    def stop(self) -> None:
        self._stop_event.set()
        self.requests.put(None)   # wake the blocking get
        self.in_flight.put(None)  # wake the collector

    def join(self, timeout=None) -> None:
        super().join(timeout)
        self.collector.join(timeout)

    def _drain(self, batch: list) -> list:
        """Appends requests already queued to ``batch``, up to
        ``max_batch``, without waiting."""
        while len(batch) < self.max_batch:
            try:
                item = self.requests.get_nowait()
            except queue.Empty:
                break
            if item is None:
                break
            batch.append(item)
        return batch

    def run(self) -> None:
        while not self._stop_event.is_set():
            try:
                first = self.requests.get(timeout=0.25)
            except queue.Empty:
                continue
            if first is None:
                continue
            # what is queued already joins at once; then wait at most
            # max_wait for stragglers
            batch = self._drain([first])
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self.requests.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    break
                batch.append(item)
            groups = [batch]
            while len(groups) < self.scan_depth:
                extra = self._drain([])
                if not extra:
                    break
                groups.append(extra)
            if len(groups) == 1:
                self._dispatch_batch(batch)
            else:
                self._dispatch_group(groups)
        # Shutdown: dispatched batches still drain through the collector
        # (the stop sentinel is behind them), but requests never dispatched
        # fail now rather than hang their handler threads to the timeout.
        while True:
            try:
                item = self.requests.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._fail([item], RuntimeError("server shutting down"))

    def _dispatch_batch(self, batch) -> None:
        t0 = time.monotonic()
        try:
            handle = self.predictor.predict_dispatch([im for im, _ in batch])
        except Exception as exc:  # every future resolves; HTTP 500
            self._fail(batch, exc)
            return
        self.stats.record_dispatch(time.monotonic() - t0)
        # a blocking put is the backpressure: at most pipeline_depth
        # handles on the device
        self.in_flight.put((batch, handle, t0))

    def _dispatch_group(self, groups) -> None:
        t0 = time.monotonic()
        try:
            handle = self.predictor.predict_dispatch_group(
                [[im for im, _ in g] for g in groups])
        except Exception as exc:
            for g in groups:
                self._fail(g, exc)
            return
        self.stats.record_dispatch(time.monotonic() - t0)
        self.in_flight.put((groups, handle, t0))

    def _collect_loop(self) -> None:
        while True:
            item = self.in_flight.get()
            if item is None:
                if self._stop_event.is_set():
                    return
                continue
            batch, handle, t0 = item
            grouped = "ns" in handle
            groups = batch if grouped else [batch]
            try:
                outs = (self.predictor.predict_collect_group(handle)
                        if grouped else
                        [self.predictor.predict_collect(handle)])
            except Exception as exc:
                for g in groups:
                    self._fail(g, exc)
                continue
            dt = time.monotonic() - t0
            for g, out in zip(groups, outs):
                self.stats.record_batch(len(g), dt)
                for j, (_, fut) in enumerate(g):
                    if not fut.done():
                        fut.set_result({k: v[j] for k, v in out.items()})

    @staticmethod
    def _fail(batch, exc: Exception) -> None:
        for _, fut in batch:
            if not fut.done():
                fut.set_exception(exc)


class DetectionServer:
    """Owns the HTTP server, the request queue and the dispatcher."""

    def __init__(self, predictor: Predictor, host: str = "0.0.0.0",
                 port: int = 8000, max_batch: int = 32,
                 max_wait_ms: float = 5.0,
                 default_score_threshold: float = 0.3,
                 max_queue: int = 1024, request_timeout_s: float = 30.0,
                 scan_depth: int = 1):
        self.predictor = predictor
        self.stats = ServerStats()
        self.requests: "queue.Queue" = queue.Queue(maxsize=max_queue)
        if not hasattr(predictor, "predict_dispatch_group"):
            scan_depth = 1  # a wrapper such as tta.TTAPredictor
        self.dispatcher = _Dispatcher(predictor, self.requests, self.stats,
                                      max_batch, max_wait_ms,
                                      scan_depth=scan_depth)
        self.default_score_threshold = default_score_threshold
        self.request_timeout_s = request_timeout_s
        self._model_info = {
            "backbone": predictor.cfg.model.backbone,
            "image_size": list(predictor.cfg.image_hw()),
            "num_classes": predictor.cfg.num_classes,
            "device": str(predictor.device),
        }

        server = self  # closed over by the handler class

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # no per-request stderr line
                pass

            def _reply(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"status": "ok",
                                      "model": server._model_info})
                elif self.path.startswith("/v1/stats"):
                    self._reply(200, server.stats.snapshot())
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                if not self.path.startswith("/v1/detect"):
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    data = self.rfile.read(length)
                    result = server.handle_image(
                        data, self._score_threshold())
                    server.stats.record_request(True)
                    self._reply(200, result)
                except Exception as exc:  # the client gets a 500
                    server.stats.record_request(False)
                    self._reply(500, {"error": str(exc)})

            def _score_threshold(self) -> float:
                from urllib.parse import parse_qs, urlparse
                q = parse_qs(urlparse(self.path).query)
                if "score_threshold" in q:
                    return float(q["score_threshold"][0])
                return server.default_score_threshold

        class _HTTPServer(ThreadingHTTPServer):
            daemon_threads = True
            # the default backlog (5) resets connections under a burst of
            # concurrent clients, which a batching server invites
            request_queue_size = 128

        self.httpd = _HTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    def warmup(self) -> None:
        """Runs every batch bucket the dispatcher can form, and with
        ``scan_depth > 1`` every group size at the largest bucket, before
        traffic: a cold bucket (cuDNN's algorithm choice, the pinned
        staging pool) must not land on the request path."""
        p = self.predictor
        buckets = sorted({p._bucket_for(n)
                          for n in range(1, self.dispatcher.max_batch + 1)})
        for b in buckets:
            p.warmup(b)
        for k in range(2, self.dispatcher.scan_depth + 1):
            p.warmup_group(buckets[-1], k)

    # ----------------------------------------------------------- request path

    def submit(self, image: np.ndarray) -> Future:
        """Enqueues one decoded image (as ``_decode`` returns it) for the
        dispatcher; the future resolves to its result dict."""
        fut: Future = Future()
        self.requests.put((image, fut), timeout=self.request_timeout_s)
        return fut

    def handle_image(self, data: bytes, score_threshold: float) -> dict:
        """Decode -> enqueue -> await the dispatcher's batched result."""
        fut = self.submit(self._decode(data))
        result = fut.result(timeout=self.request_timeout_s)
        return {"detections": detection_rows(result, score_threshold)}

    def _decode(self, data: bytes) -> np.ndarray:
        if not data:
            raise ValueError("empty request body")
        if self.predictor.preserve_aspect:
            # letterboxing needs the original frame; the predictor resizes
            return native.decode_jpeg(data)
        th, tw = self.predictor.cfg.image_hw()
        return self._prepare(native.decode_jpeg(data, th, tw))

    def _prepare(self, image: np.ndarray) -> np.ndarray:
        """A decoded model-resolution image -> what the dispatcher stacks:
        for the packed feed, packed here, in the handler thread, so the
        pack overlaps across requests and the dispatcher only copies."""
        if self.predictor._packed:
            return native.pack_s2d(image[None], n_threads=1)[0]
        return image

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self.dispatcher.start()
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name="ssd-torch-http")
        self._serve_thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.dispatcher.stop()
        self._serve_thread.join(timeout=5)
        self.dispatcher.join(timeout=5)

    def serve_forever(self) -> None:
        self.dispatcher.start()
        try:
            self.httpd.serve_forever()
        finally:
            self.dispatcher.stop()
            self.httpd.server_close()


def build(argv=None) -> tuple["DetectionServer", argparse.Namespace]:
    """The daemon of ``main``'s arguments, warmed up, not yet serving."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_artifact_args(p)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--scan-depth", type=int, default=1,
                   help="group up to K queued batches under one handle")
    p.add_argument("--score-threshold", type=float, default=0.3)
    p.add_argument("--letterbox", action="store_true")
    p.add_argument("--warmup-batches", default="all",
                   help="comma list of batch sizes to warm up, or 'all' "
                        "(default): every bucket up to --max-batch")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--tta", action="store_true",
                   help="serve with flip TTA + weighted box fusion (2x the "
                        "device work a request; scan_depth drops to 1)")
    p.add_argument("--mesh", action="store_true",
                   help="data-parallel serving over every visible card "
                        "(scan_depth drops to 1)")
    args = p.parse_args(argv)

    predictor = Predictor.from_checkpoint(args.artifact,
                                          preserve_aspect=args.letterbox,
                                          device=args.device,
                                          mesh=args.mesh or None)
    if args.tta:
        from ssd_tpu_torch.tta import TTAPredictor
        predictor = TTAPredictor(predictor)
    server = DetectionServer(
        predictor, host=args.host, port=args.port, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        default_score_threshold=args.score_threshold,
        scan_depth=args.scan_depth)
    if args.warmup_batches.strip() == "all":
        server.warmup()
    else:
        for b in args.warmup_batches.split(","):
            if b.strip():
                predictor.warmup(int(b))
    return server, args


def main(argv=None) -> None:
    import signal

    server, args = build(argv)
    print(f"serving {server._model_info} on {args.host}:{server.port} "
          f"(max_batch={args.max_batch}, max_wait_ms={args.max_wait_ms})",
          flush=True)
    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
        target=server.httpd.shutdown, daemon=True).start())
    server.serve_forever()


if __name__ == "__main__":
    main()
