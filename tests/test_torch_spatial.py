"""The height split (``ssd_tpu_torch/parallel/spatial.py``) against the
JAX package's spatially sharded paths and the port's own plain ones, on
the CPU, in one process.

* ``tests/test_spatial.py``'s three cases, with the same weights
  (``convert``, its seed-3 init with the class bias raised to -1 so that
  every image has detections) and the same rng images: the ``(2, 4)``
  predict and the ``(1, 8)`` streamed frame against JAX's own spatial
  predictor and streamer and the port's plain ones, at that file's bars
  (equal ``num_boxes`` and ``labels``, scores and boxes within atol 1e-5);
  and the two refusals, with JAX's messages;
* the ops that read across rows, alone: SAME convs at strides 1 and 2
  with kernels 1 to 7, the -inf max pool and the nearest upsample at 2x
  and other ratios, split over strips whose heights are odd or empty,
  against the whole op;
* whole models through the split against the plain predictor: group
  norm, a non-2x FPN ratio (80 px: C5 3 rows to C4's 5), 96 px over 4
  strips (odd strip heights from stride 8 down, P6 and P7 on some strips
  only), the dense4 stem with the fused head in bf16, and ShuffleNet's max
  pool.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.convert import convert_variables
from ssd_tpu_torch.models import fpn, layers
from ssd_tpu_torch.parallel import create_mesh
from ssd_tpu_torch.parallel.spatial import SpatialRunner, current
from ssd_tpu_torch.predictor import Predictor
from ssd_tpu_torch.streaming import StreamingDetector

# tests/test_spatial.py's CFG
CFG = {"num_classes": 3, "image_size": 128,
       "model": {"backbone": "mobilenet", "width_multiplier": 0.25,
                 "fpn_channels": 32, "head_depth": 1,
                 "compute_dtype": "float32"},
       "nms": {"max_boxes": 8, "num_candidates": 64, "pre_nms_top_k": 32}}
CLASS_BIAS = -1.0
DET_KEYS = ("boxes", "scores", "labels", "num_boxes")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_of(**changes) -> Config:
    d = {**CFG, "model": {**CFG["model"], **changes.pop("model", {})},
         **changes}
    return Config.from_dict(d)


def assert_spatial_bars(a: dict, b: dict) -> None:
    """``tests/test_spatial.py``'s bars."""
    np.testing.assert_array_equal(a["num_boxes"], b["num_boxes"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-5)
    np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-5)


@pytest.fixture(scope="module")
def jax_weights():
    """JAX's seed-3 variables of CFG (the class bias raised) and the
    port's state of them."""
    import jax

    from ssd_tpu.config import Config as JaxConfig
    from ssd_tpu.models.detector import Detector as JaxDetector
    cfg = cfg_of()
    jcfg = JaxConfig.from_json(cfg.to_json())
    variables = jax.device_get(jax.jit(JaxDetector(jcfg).init)(
        jax.random.PRNGKey(3)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    bias = variables["params"]["head"]["class_net"]["predict"]["bias"]
    variables["params"]["head"]["class_net"]["predict"]["bias"] = np.full_like(
        bias, CLASS_BIAS)
    return jcfg, variables, convert_variables(variables, cfg)


def test_spatial_sharded_predict_matches_jax(jax_weights):
    """``(data=2, model=4)``: the batch on data, each image's H in 4
    strips: the detections of JAX's spatial predictor and of the port's
    plain one."""
    from ssd_tpu.parallel import create_mesh as jax_create_mesh
    from ssd_tpu.predictor import Predictor as JaxPredictor
    jcfg, variables, state = jax_weights
    imgs = np.random.default_rng(0).integers(
        0, 255, (2, 128, 128, 3)).astype(np.uint8)
    mesh = create_mesh(["cpu"] * 8, model_parallelism=4)
    assert mesh.shape == {"data": 2, "model": 4}
    spatial = Predictor(cfg_of(), state, mesh=mesh, spatial_shard=True)
    assert len(spatial.replicas) == 2 and not spatial._packed
    got = spatial.predict(imgs)
    assert int(got["num_boxes"].min()) > 0
    want = JaxPredictor(jcfg, variables, mesh=jax_create_mesh(
        model_parallelism=4), spatial_shard=True).predict(imgs)
    assert_spatial_bars(got, want)
    assert_spatial_bars(got, Predictor(cfg_of(), state,
                                       device="cpu").predict(imgs))


def test_spatial_shard_requires_divisible_height(jax_weights):
    """The two refusals, with the JAX package's messages."""
    from ssd_tpu.parallel import create_mesh as jax_create_mesh
    from ssd_tpu.predictor import Predictor as JaxPredictor
    jcfg, variables, state = jax_weights
    mesh = create_mesh(["cpu"] * 8, model_parallelism=4)
    messages = []
    for make in (lambda: Predictor(cfg_of(image_size=126), state, mesh=mesh,
                                   spatial_shard=True),
                 lambda: JaxPredictor(
                     dataclasses.replace(jcfg, image_size=126), variables,
                     mesh=jax_create_mesh(model_parallelism=4),
                     spatial_shard=True),
                 lambda: Predictor(cfg_of(), state, device="cpu",
                                   spatial_shard=True),
                 lambda: JaxPredictor(jcfg, variables, spatial_shard=True)):
        with pytest.raises(ValueError) as e:
            make()
        messages.append(str(e.value))
    assert messages[0] == messages[1] == ("image height 126 not divisible "
                                          "by model axis 4")
    assert messages[2] == messages[3] == "spatial_shard requires a mesh"


def test_streaming_spatial_shard_matches_jax(jax_weights):
    """``(1, 8)``: a streamed frame's H in 8 strips (P6 and P7 on the
    first strips alone): JAX's spatially sharded stream and the port's
    unsharded one."""
    from ssd_tpu.parallel import create_mesh as jax_create_mesh
    from ssd_tpu.streaming import StreamingDetector as JaxStreaming
    jcfg, variables, state = jax_weights
    frame = np.random.default_rng(1).integers(
        0, 255, (128, 128, 3)).astype(np.uint8)

    def run(s) -> dict:
        list(s.push(frame))
        out = list(s.flush())[0]
        return {k: np.asarray(out[k])[None] for k in DET_KEYS}

    sharded = StreamingDetector(
        cfg_of(), state, spatial_shard=True,
        mesh=create_mesh(["cpu"] * 8, model_parallelism=8))
    assert sharded.predictor.spatial_shard and not sharded.packed
    got = run(sharded)
    assert int(got["num_boxes"][0]) > 0
    assert_spatial_bars(got, run(JaxStreaming(
        jcfg, variables, mesh=jax_create_mesh(model_parallelism=8),
        spatial_shard=True)))
    assert_spatial_bars(got, run(StreamingDetector(cfg_of(), state,
                                                   device="cpu")))


# ------------------------------------------------------------ the ops alone

def _split_run(strips: int, x: torch.Tensor, fn, dim: int = 2) -> list:
    """``fn`` over ``x`` cut into ``strips`` pieces of near-equal rows
    (the first take the remainder, so heights may be odd or differ), each
    in its strip's thread."""
    h = x.shape[dim]
    sizes = [h // strips + (i < h % strips) for i in range(strips)]
    parts = list(torch.split(x, sizes, dim))
    runner = SpatialRunner(["cpu"] * strips)
    try:
        return runner.run(lambda j, p: fn(p), parts)
    finally:
        runner.pool.shutdown()


@pytest.mark.parametrize("kernel,stride,height,strips", [
    (3, 1, 13, 3), (3, 2, 13, 3), (3, 2, 12, 5), (1, 2, 11, 4),
    (5, 2, 9, 4), (7, 2, 16, 3), (3, 2, 3, 4), (1, 1, 5, 3)])
def test_strip_conv_is_the_whole_conv(kernel, stride, height, strips):
    """A SAME conv over strips: the strips' outputs, in order, are the
    whole conv's output rows (the stride's phase and the halo from the
    strips beyond the neighbour), every strip its share or none."""
    torch.manual_seed(kernel * 100 + height)
    conv = layers.Conv(4, 6, kernel, stride)
    conv.reset_parameters(torch.Generator().manual_seed(0), bias_value=0.3)
    x = torch.randn(2, 4, height, 10)
    with torch.no_grad():
        want = conv(x)
        got = torch.cat(_split_run(strips, x, conv), 2)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("height,strips", [(13, 3), (8, 3), (5, 4)])
def test_strip_max_pool_is_the_whole_pool(height, strips):
    x = torch.randn(1, 3, height, 9)
    got = torch.cat(_split_run(strips, x, layers.max_pool_same), 2)
    assert torch.equal(got, layers.max_pool_same(x))


@pytest.mark.parametrize("h_in,h_out,strips", [(3, 5, 2), (4, 8, 3),
                                               (5, 13, 4), (2, 3, 3)])
def test_strip_upsample_is_the_whole_upsample(h_in, h_out, strips):
    """The nearest upsample's strips take the target's rows (a strip's
    share of the target map it is added to) and read the source rows of
    the whole map."""
    x = torch.randn(1, 2, h_in, 4)
    target = torch.zeros(1, 2, h_out, 7)
    sizes = [h_out // strips + (i < h_out % strips) for i in range(strips)]
    src = [h_in // strips + (i < h_in % strips) for i in range(strips)]
    pairs = list(zip(torch.split(x, src, 2), torch.split(target, sizes, 2)))
    runner = SpatialRunner(["cpu"] * strips)
    try:
        got = runner.run(lambda j, p: fpn.upsample_nearest(
            p[0], p[1].shape[-2:]), pairs)
    finally:
        runner.pool.shutdown()
    assert torch.equal(torch.cat(got, 2),
                       fpn.upsample_nearest(x, (h_out, 7)))
    assert current() is None


# ------------------------------------------------------------ whole models

MODELS = {
    "group_norm": (128, 4, {"norm": "group"}),
    "fpn_ratio_80px": (80, 4, {}),
    "odd_strips_96px": (96, 4, {}),
    "dense4_fused_bf16": (128, 4, {"stem_schedule": "dense4",
                                   "head_final_kernel": 1,
                                   "compute_dtype": "bfloat16"}),
    "shufflenet_max_pool": (96, 2, {"backbone": "shufflenet",
                                    "width_multiplier": 0.5}),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_split_model_matches_plain(name):
    """The model's per-level outputs through the split equal the plain
    model's (within 1e-5 in f32; bf16 within a rounding of the largest
    value), and its detections are the plain predictor's at
    ``tests/test_spatial.py``'s bars (bf16: the same boxes and labels)."""
    size, strips, model = MODELS[name]
    cfg = cfg_of(image_size=size, model=model)
    plain = Predictor(cfg, None, device="cpu", packed_ingest=False)
    with torch.no_grad():
        plain.detector.model.head.class_net.predict.bias.fill_(CLASS_BIAS)
    state = plain.detector.model.state_dict()
    split = Predictor(cfg, state, spatial_shard=True,
                      mesh=create_mesh(["cpu"] * strips,
                                       model_parallelism=strips))
    imgs = np.random.default_rng(size).integers(
        0, 255, (2, size, size, 3)).astype(np.uint8)
    x = torch.from_numpy(imgs)
    trunk = cfg.model.head_final_kernel == 1
    with torch.no_grad():
        want = plain.detector.model.eval().levels(x, trunk_only=trunk)
        got = split.replicas[0].levels(x)
    bf16 = cfg.model.compute_dtype == "bfloat16"
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            atol = float(a.abs().max()) * 2 ** -7 if bf16 else 1e-5
            torch.testing.assert_close(b.float(), a.float(), rtol=0,
                                       atol=atol)
    a, b = plain.predict(imgs), split.predict(imgs)
    assert int(a["num_boxes"].min()) > 0
    if bf16:
        np.testing.assert_array_equal(a["num_boxes"], b["num_boxes"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
        np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-2)
    else:
        assert_spatial_bars(a, b)
