"""Streaming inference (``ssd_tpu_torch/streaming.py``) against the JAX
package's ``StreamingDetector`` on the CPU, on the 64 px f32 model of
``tests/test_streaming.py`` with seeded weights in JAX's tree
(``convert.convert_variables``):

* seven 80x100 frames (stretched to 64x64 by the native resize) through
  both, on the ``reference`` stem (the raw uint8 feed) and on ``dense4``
  (the packed s8 feed), at depth 1 and 2: the results in push order, as
  many as pushed, the oldest yielded once more than ``depth`` are in
  flight; each frame's detections within the golden set rule of JAX's;
  ``num_boxes`` an ``int``; ``stats()`` with JAX's keys;
* ``spatial_shard=`` raises, naming M11b; ``mesh=`` is taken;
* ``python -m ssd_tpu_torch.tools.bench_streaming --device cpu`` prints
  JAX's keys (bf16 and ``--int8``).
"""

import jax
import numpy as np
import pytest
import torch

from ssd_tpu.config import Config as JaxConfig
from ssd_tpu.models.detector import Detector as JaxDetector
from ssd_tpu.streaming import StreamingDetector as JaxStreamingDetector
from ssd_tpu_torch.config import Config
from ssd_tpu_torch.convert import convert_variables
from ssd_tpu_torch.streaming import StreamingDetector
from ssd_tpu_torch.tools import bench_streaming
from tests.test_torch_model import seeded_variables
from tests.test_torch_slice import assert_set_match

TORCH_THREADS = 1
DET_KEYS = ("boxes", "scores", "labels", "num_boxes")
FRAMES = 7
STATS_KEYS = {"p50_latency_s", "p95_latency_s", "fps"}
BENCH_KEYS = {"resolution", "depth", "frames", "fps", "p50_latency_ms",
              "p95_latency_ms", "compute_dtype", "p50_device_ms",
              "device_fps"}
SMALL = ["image_size=64", "num_classes=3", "model.width_multiplier=0.25",
         "model.fpn_channels=16", "model.head_depth=1",
         "nms.num_candidates=64", "nms.pre_nms_top_k=32"]


def model_dict(stem: str) -> dict:
    return dict(num_classes=3, image_size=64,
                model=dict(backbone="mobilenet", width_multiplier=0.25,
                           fpn_channels=32, head_depth=1,
                           compute_dtype="float32", stem_schedule=stem),
                nms=dict(max_boxes=5, num_candidates=64, pre_nms_top_k=32))


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


def frames() -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (80, 100, 3)).astype(np.uint8)
            for _ in range(FRAMES)]


def run(stream, pushes: list) -> tuple[list, list]:
    """All results in order, and how many had come out after each push."""
    stream.warmup()
    results, seen = [], []
    for f in pushes:
        results.extend(stream.push(f))
        seen.append(len(results))
    results.extend(stream.flush())
    return results, seen


@pytest.fixture(scope="module", params=["reference", "dense4"])
def streams(request):
    """(stem, port config, port state, JAX's results at depth 2)."""
    d = model_dict(request.param)
    jcfg = JaxConfig.from_dict(d)
    abstract = jax.eval_shape(
        lambda: JaxDetector(jcfg).init(jax.random.PRNGKey(0)))
    variables = seeded_variables(abstract, seed=4, class_bias=-1.0)
    want, seen = run(JaxStreamingDetector(jcfg, variables, depth=2),
                     frames())
    assert seen == [0, 0, 1, 2, 3, 4, 5]
    cfg = Config.from_dict(d)
    return request.param, cfg, convert_variables(variables, cfg), want


@pytest.mark.parametrize("depth", [1, 2])
def test_streaming_matches_jax(streams, depth):
    stem, cfg, state, want = streams
    s = StreamingDetector(cfg, state, depth=depth, device="cpu")
    assert s.packed == (stem == "dense4")
    got, seen = run(s, frames())
    assert seen == [max(0, i + 1 - depth) for i in range(FRAMES)]
    assert len(got) == len(want) == FRAMES
    for g, w in zip(got, want):
        assert g["boxes"].shape == (5, 4)
        assert isinstance(g["num_boxes"], int)
        assert_set_match({k: np.asarray(g[k])[None] for k in DET_KEYS},
                         {k: np.asarray(w[k])[None] for k in DET_KEYS})
    assert sum(g["num_boxes"] for g in got) > 0
    stats = s.stats()
    assert set(stats) == STATS_KEYS
    assert stats["p50_latency_s"] > 0 and stats["fps"] > 0


def test_mesh_and_spatial_shard_raise():
    """``spatial_shard`` raises, naming M11b; ``mesh`` is taken as JAX
    takes it alone (a mesh of this process's devices), and anything else
    given as a mesh raises."""
    from ssd_tpu_torch.parallel import create_mesh
    cfg = Config.from_dict(model_dict("reference"))
    for kwargs in ({}, {"mesh": create_mesh(["cpu"])}):
        with pytest.raises(NotImplementedError, match="M11b"):
            StreamingDetector(cfg, None, device="cpu", spatial_shard=True,
                              **kwargs)
    with pytest.raises(TypeError, match="mesh"):
        StreamingDetector(cfg, None, device="cpu", mesh=object())
    meshed = StreamingDetector(cfg, None, mesh=create_mesh(["cpu"]))
    assert meshed.device.type == "cpu" and meshed.stats() == {}
    assert StreamingDetector(cfg, None, device="cpu").stats() == {}


@pytest.mark.parametrize("int8", [False, True])
def test_bench_streaming_prints_jax_keys(int8, capsys):
    args = ["--frames", "3", "--device", "cpu"]
    for kv in SMALL:
        args += ["--set", kv]
    out = bench_streaming.main(args + ["--int8"] * int8)
    assert set(out) == BENCH_KEYS | {"device"}
    assert out["frames"] == 3 and out["resolution"] == "64x64"
    assert out["compute_dtype"] == ("int8" if int8 else "bfloat16")
    assert out["p50_device_ms"] is None  # no card: no device time
    assert capsys.readouterr().out.strip().endswith("}")
