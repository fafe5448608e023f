"""The port's serving host path and daemon against the JAX package's, on the
CPU.

Mirrors ``tests/test_serve.py`` on its 64 px, width 0.25, f32 ``CFG``, with
one set of seeded weights carried to the port by ``convert.
convert_variables``. Both daemons run their real HTTP stacks on loopback
ports:

* the HTTP contract (``/healthz``, ``/v1/detect?score_threshold=``,
  ``/v1/stats``, 404, 500), batching of concurrent requests, per-request
  errors from dispatch and from collect, fail-fast shutdown, a bounded
  stats reservoir, warmup of every reachable bucket and group size;
* parity: the port's daemon returns the JAX daemon's detections for the
  same JPEG bytes (boxes within 1e-5, labels, names and counts equal; over
  HTTP, the same JSON up to its 4-decimal rounding);
* grouped dispatch (``scan_depth``) and pipelined dispatch equal per-batch
  and serial predicts, letterboxed too;
* the predictor CLI's JSON, and ``bench_serve`` and ``bench_http`` run
  with ``--device cpu``;
* ``ssd_tpu_torch/assets/serve_golden_v1.npz`` (for the card, which has no
  JAX) matches what ``regen`` writes, and the port's daemon serves the
  sanity artifact's detections stored in it:

      python tests/test_torch_serve.py regen
"""

import concurrent.futures
import dataclasses
import io
import json
import os
import queue
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

if __name__ == "__main__":  # regen: JAX on the CPU, as tests/conftest.py sets
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
from PIL import Image  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # for ``python tests/test_torch_serve.py regen``
    sys.path.insert(0, ROOT)

from ssd_tpu import serve as jax_serve  # noqa: E402
from ssd_tpu.config import Config as JaxConfig  # noqa: E402
from ssd_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ssd_tpu.config import NMSConfig as JaxNMSConfig  # noqa: E402
from ssd_tpu.data import native as jax_native  # noqa: E402
from ssd_tpu.eval import sanity as jax_sanity  # noqa: E402
from ssd_tpu.export import load_inference_artifact  # noqa: E402
from ssd_tpu.models.detector import Detector as JaxDetector  # noqa: E402
from ssd_tpu.predictor import Predictor as JaxPredictor  # noqa: E402
from ssd_tpu_torch import serve  # noqa: E402
from ssd_tpu_torch.config import Config  # noqa: E402
from ssd_tpu_torch.convert import (convert_variables,  # noqa: E402
                                   label_map_array, load_npz_artifact,
                                   save_npz_artifact)
from ssd_tpu_torch.data import native, synthetic  # noqa: E402
from ssd_tpu_torch.predictor import (Predictor,  # noqa: E402
                                     detections_arrays,
                                     main as predictor_main)
from ssd_tpu_torch.tools import bench_http, bench_serve  # noqa: E402
from tests.test_torch_model import seeded_variables  # noqa: E402
from tests.test_torch_slice import assert_set_match  # noqa: E402

ASSET = os.path.join(ROOT, "ssd_tpu_torch", "assets", "serve_golden_v1.npz")
DET_KEYS = ("boxes", "scores", "labels", "num_boxes")
LABELS = {1: "cat", 2: "dog"}

JCFG = JaxConfig(
    num_classes=3, image_size=64,
    model=JaxModelConfig(backbone="mobilenet", width_multiplier=0.25,
                         fpn_channels=32, head_depth=1,
                         compute_dtype="float32"),
    nms=JaxNMSConfig(max_boxes=8, num_candidates=64, pre_nms_top_k=32),
)
CFG = Config.from_json(JCFG.to_json())

# the golden asset: 16 sanity scenes re-encoded at these sizes for 128 px
# targets (direct, resize only, DCT scales 1/2, 1/4 and 1/8)
GOLDEN_SEED = 77
GOLDEN_SIZES = [(128, 128), (96, 160), (256, 256), (300, 420), (520, 600),
                (160, 112), (400, 260), (1100, 1030), (128, 128), (112, 144),
                (256, 300), (260, 400), (600, 520), (144, 96), (384, 300),
                (640, 700)]


def _jpeg(image: np.ndarray, quality: int = 75) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _jpegs(seed: int, sizes) -> list[bytes]:
    """Seeded sanity scenes at ``sizes`` (resized, so objects fill them)."""
    rng = np.random.default_rng(seed)
    out = []
    for hw in sizes:
        image, _, _ = synthetic.sanity_scene(rng)
        if image.shape[:2] != hw:
            image = np.asarray(Image.fromarray(image).resize(
                hw[::-1], Image.BILINEAR))
        out.append(_jpeg(image))
    return out


@pytest.fixture(scope="module")
def variables():
    abstract = jax.eval_shape(
        lambda: JaxDetector(JCFG).init(jax.random.PRNGKey(0)))
    # class-head bias -1: live candidates in every class, so NMS has work
    return seeded_variables(abstract, seed=5, class_bias=-1.0)


@pytest.fixture(scope="module")
def servers(variables):
    """(JAX daemon, port daemon) on the same weights and label map."""
    jpred = JaxPredictor(JCFG, variables, label_map=LABELS)
    jpred.warmup(1)
    ppred = Predictor(CFG, convert_variables(variables, CFG),
                      label_map=LABELS, device="cpu")
    made = []
    for pred, mod in ((jpred, jax_serve), (ppred, serve)):
        srv = mod.DetectionServer(pred, host="127.0.0.1", port=0,
                                  max_batch=8, max_wait_ms=30.0,
                                  default_score_threshold=0.0)
        srv.start()
        made.append(srv)
    yield tuple(made)
    for srv in made:
        srv.stop()


@pytest.fixture(scope="module")
def server(servers):
    return servers[1]


def _post(srv, body: bytes, path="/v1/detect"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _get(srv, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}{path}", timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _status(fn, *args) -> tuple[int, dict]:
    try:
        return fn(*args)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ------------------------------------------------------------ HTTP contract

def test_healthz_reports_model(server):
    status, body = _get(server, "/healthz")
    assert status == 200 and body["status"] == "ok"
    assert body["model"]["image_size"] == [64, 64]
    assert body["model"]["num_classes"] == 3
    assert body["model"]["device"] == "cpu"


def test_detect_single_image(server):
    status, body = _post(server, _jpegs(0, [(50, 70)])[0])
    assert status == 200 and body["detections"]
    for det in body["detections"]:
        assert len(det["box_yxyx"]) == 4
        assert 0.0 <= det["score"] <= 1.0
        assert det["name"] == LABELS.get(det["label"], str(det["label"]))


def test_score_threshold_query_param(server):
    body = _jpegs(1, [(50, 70)])[0]
    _, all_dets = _post(server, body, "/v1/detect?score_threshold=0")
    _, none = _post(server, body, "/v1/detect?score_threshold=1.01")
    assert none["detections"] == [] and all_dets["detections"]


def test_concurrent_requests_are_batched(server):
    before = server.stats.snapshot()
    bodies = _jpegs(2, [(50, 70)] * 8)
    results = [None] * 8
    barrier = threading.Barrier(8)

    def worker(i):
        barrier.wait()
        results[i] = _post(server, bodies[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert all(r[0] == 200 for r in results)
    after = server.stats.snapshot()
    assert after["images"] - before["images"] == 8
    assert after["batches"] - before["batches"] < 8  # coalesced


def test_bad_request_returns_500_and_counts_error(server):
    errors = server.stats.errors
    status, body = _status(_post, server, b"not an image")
    assert status == 500 and "error" in body
    assert server.stats.errors == errors + 1


def test_unknown_path_404(server):
    assert _status(_get, server, "/nope")[0] == 404
    assert _status(_post, server, b"x", "/v2/detect")[0] == 404


def test_stats_endpoint_shape(server):
    status, body = _get(server, "/v1/stats")
    assert status == 200
    assert {"requests", "errors", "batches", "images", "mean_batch_size",
            "batch_latency_ms"} <= set(body)
    assert body["images"] >= body["batches"]


def test_stats_reservoir_is_bounded():
    s = serve.ServerStats(window=16)
    for _ in range(100):
        s.record_batch(4, 0.01)
        s.record_dispatch(0.002)
    snap = s.snapshot()
    assert snap["batches"] == 100 and snap["images"] == 400
    assert len(s._lat_ms) == len(s._batch_sizes) == len(s._dispatch_ms) == 16
    assert snap["batch_latency_ms"]["p50"] == 10.0
    assert snap["dispatch_ms"]["p99"] == 2.0


@pytest.mark.parametrize("half", ["predict_dispatch", "predict_collect"])
def test_errors_propagate_per_request(server, monkeypatch, half):
    """A raise in dispatch or in collect fails that request with a 500; the
    dispatcher and collector keep serving."""
    def boom(*args):
        raise RuntimeError(f"{half} boom")
    with monkeypatch.context() as m:
        m.setattr(server.predictor, half, boom)
        status, body = _status(_post, server, _jpegs(5, [(64, 64)])[0])
    assert status == 500 and "boom" in body["error"]
    assert _get(server, "/healthz")[0] == 200
    status, body = _post(server, _jpegs(6, [(64, 64)])[0])
    assert status == 200 and "detections" in body


def test_stop_fails_queued_requests_fast():
    q = queue.Queue()
    d = serve._Dispatcher(predictor=None, requests=q,
                          stats=serve.ServerStats(), max_batch=4,
                          max_wait_ms=1.0)
    fut = concurrent.futures.Future()
    d.start()
    d.stop()
    q.put((np.zeros((4, 4, 3), np.uint8), fut))  # lands after stop
    d.join(timeout=5)
    assert not d.is_alive()
    with pytest.raises(RuntimeError, match="shutting down"):
        fut.result(timeout=5)


def _record_buckets(pred: Predictor) -> list:
    """Wraps the detector's predict to record each feed's batch size."""
    seen = []
    inner = pred.detector.predict

    def spy(feed):
        seen.append(int(feed.shape[0]))
        return inner(feed)
    pred.detector.predict = spy
    return seen


@pytest.mark.parametrize("scan_depth", [1, 3])
def test_warmup_covers_every_reachable_bucket(variables, scan_depth):
    pred = Predictor(CFG, convert_variables(variables, CFG), device="cpu")
    seen = _record_buckets(pred)
    srv = serve.DetectionServer(pred, host="127.0.0.1", port=0, max_batch=8,
                                scan_depth=scan_depth)
    try:
        srv.warmup()
    finally:
        srv.httpd.server_close()
    assert set(seen) == {1, 2, 4, 8}
    # each group size 2..K at the largest bucket
    assert len(seen) == 4 + sum(range(2, scan_depth + 1))


# ---------------------------------------------------------- parity with JAX

PARITY_SIZES = [(64, 64), (50, 70), (130, 129), (300, 420), (96, 48)]


def test_daemon_matches_jax_daemon(servers):
    """The same JPEG bytes to both daemons: decoded (the fused native path)
    to the same pixels, and the same detections, raw (through each
    daemon's queue) and over HTTP."""
    jax_srv, port_srv = servers
    for body in _jpegs(11, PARITY_SIZES):
        j_image, p_image = jax_srv._decode(body), port_srv._decode(body)
        np.testing.assert_array_equal(p_image, j_image)
        fut = concurrent.futures.Future()
        jax_srv.requests.put((j_image, fut))
        want = fut.result(timeout=60)
        got = port_srv.submit(p_image).result(timeout=60)
        assert int(want["num_boxes"]) > 0
        assert int(got["num_boxes"]) == int(want["num_boxes"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_array_equal(got["names"], want["names"])
        np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-5)
        np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5)
        _, j_json = _post(jax_srv, body)
        _, p_json = _post(port_srv, body)
        assert len(p_json["detections"]) == len(j_json["detections"])
        for a, b in zip(p_json["detections"], j_json["detections"]):
            assert (a["label"], a["name"]) == (b["label"], b["name"])
            # the JSON rounds to 4 decimals
            np.testing.assert_allclose(a["box_yxyx"], b["box_yxyx"],
                                       atol=1.01e-4)
            assert abs(a["score"] - b["score"]) <= 1.01e-4


def test_batched_results_match_direct_predict(server):
    body = _jpegs(3, [(50, 70)])[0]
    _, via_http = _post(server, body, "/v1/detect?score_threshold=0")
    direct = server.predictor.predict(native.decode_jpeg(body, 64, 64))
    n = int(direct["num_boxes"])
    assert len(via_http["detections"]) == n > 0
    for i, det in enumerate(via_http["detections"]):
        np.testing.assert_allclose(det["box_yxyx"], direct["boxes"][i],
                                   atol=1e-4)
        assert det["label"] == int(direct["labels"][i])
        assert det["name"] == str(direct["names"][i])


# ------------------------------------------------------- grouped, pipelined

def _equal(a: dict, b: dict) -> None:
    """Counts, labels and names equal; boxes and scores within 1e-6 (as
    ``tests/test_serve.py`` holds its grouped dispatch: a CPU conv may sum
    in another order between two calls)."""
    assert set(a) == set(b)
    for k in a:
        if k in ("boxes", "scores"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(a[k], b[k])


def test_scan_depth_groups_queued_batches(variables, monkeypatch):
    """Requests queued before the dispatcher starts form K batches of
    ``max_batch`` grouped under one handle; each image's result equals a
    per-batch predict of its batch."""
    pred = Predictor(CFG, convert_variables(variables, CFG),
                     label_map=LABELS, device="cpu")
    groups = []
    inner = pred.predict_dispatch_group
    monkeypatch.setattr(pred, "predict_dispatch_group",
                        lambda b: groups.append(len(b)) or inner(b))
    srv = serve.DetectionServer(pred, host="127.0.0.1", port=0,
                                max_batch=2, max_wait_ms=0.0, scan_depth=3)
    images = [np.random.default_rng(i).integers(0, 256, (64, 64, 3),
                                                dtype=np.uint8)
              for i in range(6)]
    futs = [srv.submit(im) for im in images]
    srv.dispatcher.start()
    try:
        for i, fut in enumerate(futs):
            out = fut.result(timeout=60)
            want = pred.predict(images[i - i % 2:i - i % 2 + 2])
            _equal(out, {k: v[i % 2] for k, v in want.items()})
    finally:
        srv.dispatcher.stop()
        srv.dispatcher.join(timeout=10)
        srv.httpd.server_close()
    assert groups == [3]


@pytest.mark.parametrize("letterbox", [False, True])
def test_group_dispatch_equals_per_batch(variables, letterbox):
    pred = Predictor(CFG, convert_variables(variables, CFG),
                     preserve_aspect=letterbox, device="cpu")
    rng = np.random.default_rng(4)
    batches = [[rng.integers(0, 256, hw + (3,), dtype=np.uint8)
                for hw in sizes]
               for sizes in ([(50, 70), (64, 64), (90, 40)], [(64, 64)],
                             [(33, 77), (100, 100)])]
    got = pred.predict_collect_group(pred.predict_dispatch_group(batches))
    assert len(got) == 3
    for g, b in zip(got, batches):
        _equal(g, pred.predict(b))


def test_pipelined_dispatch_equals_serial(variables):
    pred = Predictor(CFG, convert_variables(variables, CFG), device="cpu")
    batches = bench_serve.seeded_batches(CFG, 4, count=3)
    handles = [pred.predict_dispatch(b) for b in batches]
    for h, b in zip(handles, batches):
        _equal(pred.predict_collect(h), pred.predict(b))


def test_label_map_round_trip_and_predictor_cli(variables, tmp_path, capsys):
    state = convert_variables(variables, CFG)
    npz = str(tmp_path / "model.npz")
    save_npz_artifact(npz, CFG, state, label_map=label_map_array(LABELS))
    pred = Predictor.from_npz(npz, device="cpu")
    assert pred.label_map == LABELS
    paths = []
    for i, body in enumerate(_jpegs(8, [(50, 70), (64, 64), (120, 90)])):
        paths.append(str(tmp_path / f"{i}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(body)
    predictor_main(["--npz", npz, "--images", *paths, "--batch-size", "2",
                    "--score-threshold", "0.2", "--device", "cpu"])
    rows = json.loads(capsys.readouterr().out)
    assert [r["image"] for r in rows] == paths
    direct = pred.predict([native.decode_jpeg(open(p, "rb").read())
                           for p in paths[:2]])
    for j in range(2):
        keep = [i for i in range(int(direct["num_boxes"][j]))
                if direct["scores"][j][i] >= 0.2]
        assert len(rows[j]["detections"]) == len(keep) > 0
        for det, i in zip(rows[j]["detections"], keep):
            assert det["name"] == str(direct["names"][j][i])
            assert det["label"] == int(direct["labels"][j][i])
            np.testing.assert_allclose(det["box_yxyx"], direct["boxes"][j][i],
                                       atol=1e-4)
    out = str(tmp_path / "dets.json")
    predictor_main(["--npz", npz, "--images", paths[0], "--out", out,
                    "--device", "cpu"])
    with open(out) as f:
        assert json.load(f)[0]["image"] == paths[0]


# ------------------------------------------------------------ the bench tools

@pytest.fixture(scope="module")
def config_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cfg") / "cfg.json")
    with open(path, "w") as f:
        f.write(CFG.to_json())
    return path


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_bench_serve_runs_on_cpu(config_file, dtype, capsys):
    argv = ["--config", config_file, "--batch", "2", "--iters", "2",
            "--warmup", "1", "--device", "cpu",
            "--set", "nms.pre_nms_top_k=16"]
    result = bench_serve.main(argv + (["--dtype", dtype] if dtype else []))
    assert json.loads(capsys.readouterr().out.strip()) == result
    assert result["iters"] == 2 and result["img_per_s"] > 0
    assert result["device"] == "cpu"
    assert set(result["batch_ms"]) == {"p50", "p90", "p99"}
    assert result["dtype"] == (dtype or "float32")
    assert (result["calibration_s"] is not None) == (dtype == "int8")


def test_bench_http_runs_on_cpu(config_file, capsys):
    result = bench_http.main(["--config", config_file, "--clients", "2",
                              "--requests", "2", "--max-batch", "4",
                              "--image-size", "64", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip()) == result
    assert result["ok"] == 4 and result["failed"] == 0
    assert result["images"] == 4 and result["req_per_s"] > 0
    assert set(result["latency_ms"]) == {"p50", "p90", "p99"}


def test_bench_http_reads_the_asset_without_pil(monkeypatch):
    monkeypatch.setattr(native, "pil_available", lambda: False)
    bodies, source = bench_http.request_bodies(64)
    assert "serve_golden_v1.npz" in source and len(bodies) == 8
    assert all(native.jpeg_dims(b) == (640, 640) for b in bodies)


# ------------------------------------------------------------ the golden asset

def _jax_golden_detections(jpegs: list[bytes]) -> dict:
    """The sanity artifact in f32 through the JAX daemon over HTTP, one
    request at a time, every detection (threshold 0), as padded arrays."""
    jcfg, jvars = load_inference_artifact(jax_sanity.ARTIFACT_DIR)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, compute_dtype="float32"))
    srv = jax_serve.DetectionServer(JaxPredictor(jcfg, jvars),
                                    host="127.0.0.1", port=0, max_batch=1,
                                    default_score_threshold=0.0)
    srv.start()
    try:
        rows = [_post(srv, body)[1]["detections"] for body in jpegs]
    finally:
        srv.stop()
        srv.httpd.server_close()
    return detections_arrays(rows, jcfg.nms.max_boxes)


def golden_arrays() -> dict:
    jpegs = _jpegs(GOLDEN_SEED, GOLDEN_SIZES)
    blob, offsets = bench_http.pack_blobs(jpegs)
    http_blob, http_offsets = bench_http.pack_blobs(
        bench_http.encode_bodies(bench_http.BODY_SIDE))
    version = native.jpeg_version()
    det = _jax_golden_detections(jpegs)
    return {
        "golden_jpeg_blob": blob, "golden_jpeg_offsets": offsets,
        "golden_source_hw": np.asarray(GOLDEN_SIZES, np.int32),
        "golden_pixels": np.stack([jax_native.decode_jpeg(d, 128, 128)
                                   for d in jpegs]),
        "jpeg_lib_version": np.int32(version["jpeg_lib_version"]),
        "libjpeg_turbo_version_number": np.int32(
            version["libjpeg_turbo_version_number"]),
        **{f"jax_f32_{k}": v for k, v in det.items()},
        "http_jpeg_blob": http_blob, "http_jpeg_offsets": http_offsets}


@pytest.fixture(scope="module")
def golden():
    return golden_arrays()


def test_committed_asset_matches_regen(golden):
    with np.load(ASSET, allow_pickle=False) as z:
        got = {k: z[k] for k in z.files}
    assert set(got) == set(golden)
    for k, v in golden.items():
        if not k.startswith("jax_"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    # JAX's CPU detections may move in the last bits across CPUs
    assert_set_match({k: got[f"jax_f32_{k}"] for k in DET_KEYS},
                     {k: golden[f"jax_f32_{k}"] for k in DET_KEYS})
    assert int(golden["jax_f32_num_boxes"].sum()) > 16


def test_port_daemon_serves_the_golden_detections():
    """What the card checks, here: the stored JPEGs decode to the stored
    pixels, and the port's daemon (f32 sanity artifact, concurrent
    requests) returns JAX's stored detections under the golden rule."""
    with np.load(ASSET, allow_pickle=False) as z:
        jpegs = bench_http.unpack_blobs(z["golden_jpeg_blob"],
                                        z["golden_jpeg_offsets"])
        pixels = z["golden_pixels"]
        want = {k: z[f"jax_f32_{k}"] for k in DET_KEYS}
    for d, p in zip(jpegs, pixels):
        np.testing.assert_array_equal(native.decode_jpeg(d, 128, 128), p)
    cfg, state = load_npz_artifact(os.path.join(
        ROOT, "ssd_tpu_torch", "assets", "sanity_v1.npz"))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))
    srv = serve.DetectionServer(Predictor(cfg, state, device="cpu"),
                                host="127.0.0.1", port=0, max_batch=8,
                                max_wait_ms=20.0, default_score_threshold=0.0)
    srv.start()
    try:
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            rows = list(ex.map(lambda b: _post(srv, b)[1]["detections"],
                               jpegs))
    finally:
        srv.stop()
    assert srv.stats.batches < len(jpegs)
    assert_set_match(detections_arrays(rows, cfg.nms.max_boxes), want)


if __name__ == "__main__":
    if sys.argv[1:] == ["regen"]:
        arrays = golden_arrays()
        np.savez_compressed(ASSET, **arrays)
        print(f"wrote {ASSET} ({os.path.getsize(ASSET)} bytes), "
              f"{int(arrays['jax_f32_num_boxes'].sum())} JAX detections")
    else:
        sys.exit("usage: python tests/test_torch_serve.py regen")
