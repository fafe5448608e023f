"""End-to-end HTTP serving benchmark: the daemon path, measured (the port's
``ssd_tpu/tools/bench_http.py``).

Starts the port's serving stack in-process (HTTP handlers -> native JPEG
decode and pack -> dynamic batcher -> pipelined ``Predictor``), fires
``--clients`` concurrent closed-loop clients of ``--requests`` requests each
over loopback HTTP, and reports request throughput, latency percentiles
and the batch sizes the dispatcher formed.

The request bodies are JPEGs of seeded crowded scenes (``data/synthetic``):
encoded here by PIL where it is installed, at ``--image-size``; read from
``assets/serve_golden_v1.npz`` (eight 640 px bodies, written by the same
code) where it is not. Nothing is downloaded.

    python -m ssd_tpu_torch.tools.bench_http \\
        --config configs/coco_mobilenet_640_flagship.json \\
        | --export DIR_OR_FILE.npz \\
        [--clients 64] [--requests 20] [--max-batch 32] [--max-wait-ms 5] \\
        [--scan-depth 1] [--image-size 640] [--device cpu]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import threading
import time
import urllib.request

import numpy as np

from ssd_tpu_torch.data import native, synthetic
from ssd_tpu_torch.export import add_artifact_args

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "serve_golden_v1.npz")
BODY_SEED = 3
BODY_CLASSES = 80
BODY_SIDE = 640  # the asset's bodies
BODY_COUNT = 8


def unpack_blobs(blob: np.ndarray, offsets: np.ndarray) -> list[bytes]:
    """Byte strings stored as one uint8 blob and ``n + 1`` offsets."""
    data = blob.tobytes()
    return [data[int(a):int(b)] for a, b in zip(offsets[:-1], offsets[1:])]


def pack_blobs(items: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    offsets = np.concatenate([[0], np.cumsum([len(b) for b in items])])
    return (np.frombuffer(b"".join(items), np.uint8).copy(),
            offsets.astype(np.int64))


def encode_bodies(side: int, count: int = BODY_COUNT) -> list[bytes]:
    """JPEGs (PIL's default quality) of seeded crowded ``side`` px scenes of
    80 classes: their objects and borders compress, unlike pure noise."""
    from PIL import Image
    rng = np.random.default_rng([BODY_SEED, side])
    bodies = []
    for _ in range(count):
        image, _, _ = synthetic.crowded_example(rng, BODY_CLASSES, side)
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, format="JPEG")
        bodies.append(buf.getvalue())
    return bodies


def request_bodies(side: int) -> tuple[list[bytes], str]:
    """-> (bodies, where they came from)."""
    if native.pil_available():
        return encode_bodies(side), f"encoded by PIL at {side} px"
    with np.load(ASSET, allow_pickle=False) as z:
        bodies = unpack_blobs(z["http_jpeg_blob"], z["http_jpeg_offsets"])
    return bodies, (f"{os.path.relpath(ASSET)} at {BODY_SIDE} px (PIL is "
                    "not installed)")


def run(server, bodies: list[bytes], clients: int, requests: int) -> dict:
    """``clients`` closed-loop clients of ``requests`` requests each against
    a started ``DetectionServer``; request rate, latencies, and the server's
    batch sizes over the run."""
    url = f"http://127.0.0.1:{server.port}/v1/detect"
    latencies: list[float] = []
    failures: list[str] = []
    lock = threading.Lock()
    barrier = threading.Barrier(clients + 1)
    before = server.stats.snapshot()

    def client(ci: int) -> None:
        barrier.wait()
        for ri in range(requests):
            body = bodies[(ci + ri) % len(bodies)]
            t0 = time.monotonic()
            try:
                req = urllib.request.Request(url, data=body, method="POST")
                with urllib.request.urlopen(req, timeout=120) as resp:
                    json.loads(resp.read())
            except Exception as exc:  # counted and reported, not raised here
                with lock:
                    failures.append(repr(exc))
                continue
            with lock:
                latencies.append(time.monotonic() - t0)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.monotonic()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    after = server.stats.snapshot()
    total = clients * requests
    lat = np.asarray(latencies, np.float64) * 1e3
    batches = after["batches"] - before["batches"]
    images = after["images"] - before["images"]
    return {"requests": total, "ok": len(latencies),
            "failed": len(failures), "first_failure": (failures or [None])[0],
            "wall_s": wall, "req_per_s": len(latencies) / wall,
            "latency_ms": {f"p{q}": (float(np.percentile(lat, q))
                                     if len(lat) else None)
                           for q in (50, 90, 99)},
            "batches": batches, "images": images,
            "mean_batch_size": images / batches if batches else None,
            "server_batch_latency_ms": after["batch_latency_ms"],
            "server_dispatch_ms": after["dispatch_ms"]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default=None)
    add_artifact_args(p, required=False)
    p.add_argument("--clients", type=int, default=64)
    p.add_argument("--requests", type=int, default=20,
                   help="requests per client")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--scan-depth", type=int, default=1)
    p.add_argument("--image-size", type=int, default=0,
                   help="client image side (0: the model resolution)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    artifact = args.artifact
    if (args.config is None) == (artifact is None):
        p.error("pass exactly one of --config and --export")

    from ssd_tpu_torch.config import Config
    from ssd_tpu_torch.predictor import Predictor
    from ssd_tpu_torch.serve import DetectionServer

    if artifact:
        predictor = Predictor.from_checkpoint(artifact, device=args.device)
    else:  # weights seeded from 0
        predictor = Predictor(Config.load(args.config), None,
                              device=args.device)
    server = DetectionServer(predictor, host="127.0.0.1", port=0,
                             max_batch=args.max_batch,
                             max_wait_ms=args.max_wait_ms,
                             default_score_threshold=0.3,
                             scan_depth=args.scan_depth)
    bodies, source = request_bodies(args.image_size
                                    or predictor.cfg.image_hw()[0])
    server.warmup()  # every reachable bucket, before traffic
    server.start()
    try:
        result = run(server, bodies, args.clients, args.requests)
    finally:
        server.stop()
    result = {"config": args.config or artifact, "bodies": source,
              "clients": args.clients, "max_batch": args.max_batch,
              "max_wait_ms": args.max_wait_ms,
              "scan_depth": args.scan_depth,
              "device": str(predictor.device), **result}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
