"""``ssd_tpu_torch/assets/backbones_golden_v1.npz``: JAX's numbers for each
new backbone at full width, which ``chip_smoke.py`` holds the card to.

One case per shipped config the port now builds (``mobilenet_v2``,
``efficientnet_lite``, ``shufflenet``, ``resnet50``: their configs at 128
px and 8 classes, full backbone width, FPN and head as shipped, f32) and
MobileNet-v1 with ``norm="group"`` (``mobilenet_group``: the reference
config so). The weights are ``convert.seeded_state(cfg, seed,
class_bias)``: numpy draws over the port's state in sorted-name order, the
same on any machine; the flax tree is built from those arrays (OIHW ->
HWIO here only). For each case the asset holds its config, seed and class
bias, and JAX's

* per-level raw maps of the batch's 2 images (eval mode);
* detections (``postprocess_cells``, as JAX's ``Detector.predict`` runs
  it);
* the train-mode loss terms of the batch and the global norm of the
  gradient (step 0, f32);

and the float64 truth of that norm: JAX's f32 model run in f64
(``tests/test_torch_backbones.jax_float64``). JAX's f32 norm is up to 5e-3
off it (MobileNet-v2: flax's fast variance cancels; ROADMAP.md section 3),
the port's f32 norm 1.2e-3.

Held here on the CPU, the port: raw maps at the golden bars (atol 2e-4,
rtol 2e-3), detections under the golden set rule, loss terms within 1e-4,
the gradient norm within 2e-3 of the f64 truth and within 2e-3 plus JAX's
own distance from the truth of JAX's (relative; the bars ``chip_smoke.py``
applies on the card). A test checks the committed asset is what ``regen``
writes:

    python tests/test_torch_backbones_golden.py regen
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

if __name__ == "__main__":  # regen: JAX on the CPU, as tests/conftest.py sets
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # for ``python tests/test_torch_backbones_golden.py``
    sys.path.insert(0, ROOT)

from ssd_tpu.config import Config as JaxConfig  # noqa: E402
from ssd_tpu.models.detector import Detector as JaxDetector  # noqa: E402
from ssd_tpu.ops.postprocess import postprocess_cells  # noqa: E402
from ssd_tpu_torch.config import Config  # noqa: E402
from ssd_tpu_torch.convert import (_LEAF_NAMES,  # noqa: E402
                                   convert_variables, seeded_state)
from ssd_tpu_torch.data import synthetic  # noqa: E402
from ssd_tpu_torch.models.detector import Detector  # noqa: E402
from tests.test_torch_backbones import (f64_tree, jax_float64,  # noqa: E402
                                        torch_threads)  # noqa: F401
from tests.test_torch_slice import assert_set_match  # noqa: E402

ASSET = os.path.join(ROOT, "ssd_tpu_torch", "assets",
                     "backbones_golden_v1.npz")
GOLDEN_BARS = dict(atol=2e-4, rtol=2e-3)
LOSS_RTOL = 1e-4
GRAD_NORM_RTOL = 2e-3
DET_KEYS = ("boxes", "scores", "labels", "num_boxes")
LOSS_KEYS = ("loss", "classification_loss", "localization_loss",
             "regularization_loss", "num_positives")
SIZE, CLASSES, BATCH_SEED = 128, 8, 21
# name: (config, model overrides, weight seed, class bias). The bias puts
# each case's detections at 16-89 an image, under max_boxes (100), so no
# near-tie at the cut decides the set.
CASES = {
    "mobilenet_v2": ("coco_mobilenet_v2_640.json", {}, 1, -3.4),
    "efficientnet_lite": ("coco_efficientnet_lite0_640.json", {}, 2, -3.3),
    "shufflenet": ("coco_shufflenet_512.json", {}, 3, -3.4),
    "resnet50": ("coco_retinanet_resnet50_640.json", {}, 4, -6.0),
    "mobilenet_group": ("coco_mobilenet_640.json", {"norm": "group"}, 5,
                        -3.7),
}


def case_config(name: str) -> Config:
    path, model, _, _ = CASES[name]
    cfg = Config.load(os.path.join(ROOT, "configs", path))
    return dataclasses.replace(
        cfg, image_size=SIZE, num_classes=CLASSES,
        model=dataclasses.replace(cfg.model, compute_dtype="float32",
                                  **model))


def golden_batch(cfg: Config) -> dict:
    rng = np.random.default_rng(BATCH_SEED)
    return synthetic.pad_batch(
        [synthetic.crowded_example(rng, CLASSES, SIZE) for _ in range(2)],
        cfg.data.max_gt_boxes)


def grad_norm(det: Detector, data: dict) -> float:
    """The global norm of the gradient of ``det.loss(data)``."""
    total, _ = det.loss(data)
    total.backward()
    return float(torch.sqrt(sum(p.grad.double().square().sum()
                                for p in det.model.parameters())))


def global_norm(grads) -> float:
    return float(jnp.sqrt(sum(jnp.sum(jnp.square(g)) for g in
                              jax.tree_util.tree_leaves(grads))))


def jax_grad_norm_f64(jdet, variables: dict, data: dict) -> float:
    """The global norm of JAX's gradient with the f32 model run in float64
    (``jax_float64``): the truth the f32 norms are held to."""
    with jax_float64():
        v64 = f64_tree(variables)
        grads = jax.jit(jax.grad(lambda p: jdet.loss(
            dict(v64, params=p), data)[0]))(v64["params"])
        return global_norm(grads)


def grad_norm_errors(got: float, case: dict) -> dict:
    """The port's f32 norm against the f64 truth and against JAX's, and the
    bar against JAX's: 2e-3 plus JAX's own distance from the truth."""
    truth, want = float(case["grad_norm_f64"]), float(case["grad_norm"])
    return {"truth": abs(got / truth - 1), "jax": abs(got / want - 1),
            "jax_bar": GRAD_NORM_RTOL + abs(want / truth - 1)}


def flax_tree(state: dict, abstract) -> dict:
    """The flax variable tree of ``abstract``'s shapes filled from a port
    state dict: the inverse of ``convert_variables``."""
    def leaf(path, value):
        keys = [p.key for p in path]
        name = ".".join(keys[1:-1] + [_LEAF_NAMES[keys[0], keys[-1]]])
        v = state[name].numpy()
        if v.ndim == 4:
            v = v.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        assert v.shape == value.shape, (name, v.shape, value.shape)
        return np.ascontiguousarray(v)

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def jax_case(name: str) -> dict:
    """JAX's numbers for one case, keyed ``name/...``."""
    cfg = case_config(name)
    _, _, seed, bias = CASES[name]
    state = seeded_state(cfg, seed, class_bias=bias)
    jcfg = JaxConfig.from_json(cfg.to_json())
    jdet = JaxDetector(jcfg)
    abstract = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0)))
    variables = flax_tree(state, abstract)
    round_trip = convert_variables(variables, cfg)
    assert all(torch.equal(round_trip[k], state[k]) for k in state)
    data = golden_batch(cfg)

    raw = jax.jit(lambda v, x: jdet.model.apply(
        v, x, train=False, flatten=False, raw_input=True))(
            variables, data["images"])
    dets = jax.jit(lambda r: postprocess_cells(
        r, jdet.anchors, jcfg.num_classes, jcfg.nms))(raw)

    def loss_fn(params):
        return jdet.loss(dict(variables, params=params), data)

    (_, (metrics, _)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    jax_norm = global_norm(grads)
    truth = jax_grad_norm_f64(jdet, variables, data)
    out = {f"{name}/config_json": np.array(cfg.to_json()),
           f"{name}/grad_norm_f64": np.array(truth, np.float64),
           f"{name}/seed": np.array(seed),
           f"{name}/class_bias": np.array(bias, np.float32),
           f"{name}/grad_norm": np.asarray(jax_norm, np.float32)}
    for i, (cls, box) in enumerate(raw):
        out[f"{name}/raw/{i}/cls"] = np.asarray(cls, np.float32)
        out[f"{name}/raw/{i}/box"] = np.asarray(box, np.float32)
    for k in DET_KEYS:
        out[f"{name}/det/{k}"] = np.asarray(getattr(dets, k))
    for k in LOSS_KEYS:
        out[f"{name}/loss/{k}"] = np.asarray(metrics[k], np.float32)
    return out


# the cases by their time on one host, longest first, and how many run at
# once: each compiles JAX's f32 and f64 gradient and runs the f64 one (about
# 35-60 s a case; 230 s one after another)
CASE_ORDER = ("efficientnet_lite", "mobilenet_v2", "resnet50", "shufflenet",
              "mobilenet_group")
CASE_JOBS = 3


def _case_in_process(name: str, tmp: str) -> dict:
    """``jax_case(name)`` in a process of its own (this file's ``case``
    command), its arrays through a ``.npz``."""
    out = os.path.join(tmp, f"{name}.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "case",
                        name, out], env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def golden_arrays() -> dict:
    """The asset's arrays: the batch, and each case's JAX numbers computed
    ``CASE_JOBS`` cases at a time, each in its own process (the JAX
    numbers do not depend on it)."""
    assert sorted(CASE_ORDER) == sorted(CASES)
    cfg = case_config("resnet50")
    data = golden_batch(cfg)
    arrays = {f"batch/{k}": v for k, v in data.items()}
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(CASE_JOBS) as pool:
        for case in pool.map(lambda n: _case_in_process(n, tmp), CASE_ORDER):
            arrays.update(case)
    return arrays


def case_arrays(arrays: dict, name: str) -> dict:
    """One case of the asset, its keys without the ``name/`` prefix."""
    pre = name + "/"
    return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}


# ------------------------------------------------------------------ tests

@pytest.fixture(scope="module")
def asset():
    with np.load(ASSET) as z:
        return {k: z[k] for k in z.files}


def test_asset_is_small_and_complete(asset):
    assert os.path.getsize(ASSET) < 2_200_000
    for name in CASES:
        case = case_arrays(asset, name)
        cfg = Config.from_json(str(case["config_json"]))
        assert cfg == case_config(name)
        assert 0 < int(case["det/num_boxes"].min()), name
        assert int(case["det/num_boxes"].max()) < cfg.nms.max_boxes, name
        assert float(case["loss/num_positives"]) > 10, name


@pytest.mark.parametrize("name", list(CASES))
def test_port_matches_golden_on_cpu(asset, name):
    """The port on the CPU at full width against JAX's stored numbers, at
    the bars ``chip_smoke.py`` holds the card to."""
    case = case_arrays(asset, name)
    cfg = Config.from_json(str(case["config_json"]))
    state = seeded_state(cfg, int(case["seed"]),
                         class_bias=float(case["class_bias"]))
    data = {k[len("batch/"):]: v for k, v in asset.items()
            if k.startswith("batch/")}
    det = Detector(cfg, state, device="cpu")
    raw = det.raw(data["images"])
    for i, (cls, box) in enumerate(raw):
        np.testing.assert_allclose(cls.numpy(), case[f"raw/{i}/cls"],
                                   **GOLDEN_BARS, err_msg=f"{name} P{i + 3}")
        np.testing.assert_allclose(box.numpy(), case[f"raw/{i}/box"],
                                   **GOLDEN_BARS, err_msg=f"{name} P{i + 3}")
    out = det.predict(data["images"])
    assert_set_match({k: getattr(out, k).numpy() for k in DET_KEYS},
                     {k: case[f"det/{k}"] for k in DET_KEYS})
    _, metrics = det.loss(data)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(metrics[k]),
                                   float(case[f"loss/{k}"]), rtol=LOSS_RTOL,
                                   err_msg=f"{name} {k}")
    det.model.zero_grad()
    err = grad_norm_errors(grad_norm(det, data), case)
    assert err["truth"] <= GRAD_NORM_RTOL, err
    assert err["jax"] <= err["jax_bar"], err


@pytest.fixture(scope="module")
def regen():
    return golden_arrays()


def test_committed_asset_matches_regen(asset, regen):
    assert set(asset) == set(regen)
    for k, v in regen.items():
        if k.endswith("config_json"):
            assert str(asset[k]) == str(v), k
        elif "/det/" in k or k.startswith("batch/"):
            continue  # detections: the set rule below; the batch: equal
        else:
            np.testing.assert_allclose(asset[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    for k, v in regen.items():
        if k.startswith("batch/"):
            np.testing.assert_array_equal(asset[k], v, err_msg=k)
    for name in CASES:
        assert_set_match({k: asset[f"{name}/det/{k}"] for k in DET_KEYS},
                         {k: regen[f"{name}/det/{k}"] for k in DET_KEYS})


if __name__ == "__main__":
    if sys.argv[1:] == ["regen"]:
        arrays = golden_arrays()
        np.savez_compressed(ASSET, **arrays)
        summary = {name: int(arrays[f"{name}/det/num_boxes"].sum())
                   for name in CASES}
        print(f"wrote {ASSET} ({os.path.getsize(ASSET)} bytes); "
              f"detections {json.dumps(summary)}")
    elif len(sys.argv) == 4 and sys.argv[1] == "case":
        np.savez(sys.argv[3], **jax_case(sys.argv[2]))
    else:
        sys.exit("usage: python tests/test_torch_backbones_golden.py regen")
