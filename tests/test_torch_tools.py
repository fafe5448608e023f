"""The port's planning and debugging tools against the JAX package's: the
TensorBoard writer (and the trainer's ``tb/``), the numerics checks, the
trace capture and tables, the cost summary, the anchor coverage report and
the demo.

Bars: the tfevents files byte-equal at a fixed wall time; the anchor
reports equal (integers exactly, floats at their 4-decimal rounding); the
demo's pixels equal. The cost summary's FLOPs equal ``FlopCounterMode``'s,
the predict's exactly and the train step's less what that formula counts
too much (a grouped conv's weight gradient, ``groups`` times over).

Against XLA's ``cost_analysis`` of JAX's predict the port counts 1.09x on
``test_e2e.make_cfg`` at b4 (58.70 M against 53.86 M). Two terms make the
gap: the convolutions' padded border taps, which torch's formulas count
and XLA does not (the port's convs over their taps inside the image:
51.36 M, the dense count over 1.1428), and XLA's elementwise and NMS
flops, which no torch formula counts (4.9% over the in-image count here).
So the bar: XLA's count lies between the port's in-image conv count and
6% above it.
"""

import dataclasses
import glob
import importlib.util
import json
import os
import socket
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tests.test_e2e import make_cfg, write_synth_dataset  # noqa: E402

from ssd_tpu_torch.config import Config  # noqa: E402

XLA_OVER_INIMAGE_BAR = 1.06  # XLA's elementwise + NMS flops: 4.9% here


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ tensorboard

def _write_both(tmp_path, monkeypatch, scalars_by_step):
    """The same scalars through both writers at a fixed wall time."""
    from ssd_tpu.utils import tensorboard as jtb
    from ssd_tpu_torch.utils import tensorboard as ttb

    monkeypatch.setattr("time.time", lambda: 1_700_000_000.25)
    paths = []
    for mod, name in ((jtb, "jax"), (ttb, "port")):
        with mod.SummaryWriter(str(tmp_path / name)) as w:
            for step, scalars in scalars_by_step:
                w.add_scalars(scalars, step)
            w.add_scalar("lr", 1e-3, step=7)
        (path,) = glob.glob(str(tmp_path / name / "events.out.tfevents.*"))
        paths.append(path)
    return paths


def test_tfevents_byte_equal_and_cross_read(tmp_path, monkeypatch):
    from ssd_tpu.utils.tensorboard import read_scalars as jread
    from ssd_tpu_torch.utils.tensorboard import read_scalars as tread

    scalars = [(0, {"loss": 2.5, "num_positives": 7.0}),
               (100, {"loss": 0.75, "grad_norm": 1e-3, "mAP": 0.123456})]
    jpath, tpath = _write_both(tmp_path, monkeypatch, scalars)
    assert os.path.basename(jpath) == os.path.basename(tpath)
    assert os.path.basename(tpath).startswith(
        f"events.out.tfevents.1700000000.{socket.gethostname()}.")
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    want = [(s, k, float(np.float32(v))) for s, d in scalars
            for k, v in d.items()] + [(7, "lr", float(np.float32(1e-3)))]
    assert tread(jpath) == want
    assert jread(tpath) == want


def test_train_writes_tb_equal_to_metrics(tmp_path):
    """The port's ``train`` on the CPU leaves ``workdir/tb/`` events whose
    scalars are ``metrics.jsonl``'s numeric keys (rounded to f32, as
    tfevents stores them)."""
    from tests.test_torch_train import loop_batches, loop_cfg

    from ssd_tpu_torch.train import train
    from ssd_tpu_torch.utils.tensorboard import read_scalars

    cfg = loop_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, log_every=1))
    workdir = str(tmp_path / "run")
    train(cfg, workdir, loop_batches(), max_steps=2, device="cpu")
    (path,) = glob.glob(os.path.join(workdir, "tb", "events.out.tfevents.*"))
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    want = [(r["step"], k, float(np.float32(v))) for r in records
            for k, v in r.items()
            if k != "step" and isinstance(v, (int, float))]
    assert len(records) == 2 and len(want) > 10
    assert read_scalars(path) == want


# ------------------------------------------------------------------ debug

def test_debug_cases_of_jax():
    """JAX's four cases (``tests/test_debug_utils.py``) on the port."""
    from ssd_tpu_torch.utils.debug import (assert_all_finite, checked,
                                           disable_jit)

    with pytest.raises(FloatingPointError, match="non-finite"):
        checked(torch.log)(torch.tensor([-1.0]))
    out = checked(lambda x: x * 2)(torch.ones(3))
    np.testing.assert_allclose(out.numpy(), 2.0)
    assert_all_finite({"a": torch.ones(3)}, "params")
    with pytest.raises(FloatingPointError, match="non-finite"):
        assert_all_finite({"a": torch.tensor([1.0, float("nan")])}, "params")
    with disable_jit():
        assert float(torch.ones(4).sum()) == 4.0


def test_debug_names_the_leaf():
    from ssd_tpu_torch.utils.debug import assert_all_finite, checked

    tree = {"params": [torch.ones(2), torch.tensor([np.inf, 1.0])],
            "step": torch.tensor(3)}
    with pytest.raises(FloatingPointError,
                       match=r"state\['params'\]\[1\]: 1 bad of 2"):
        assert_all_finite(tree, "state")
    with pytest.raises(FloatingPointError, match="loss"):
        checked(lambda: {"loss": torch.tensor(float("nan"))})()


# ------------------------------------------------------------ trace tools

def test_trace_capture_and_tables(tmp_path):
    from ssd_tpu_torch.utils import profiling, trace_tools

    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("step.matmul"):
            (x @ x).sum()
    path = trace_tools.find_trace(str(tmp_path))
    assert path == str(tmp_path / "trace.json")
    # no card in this window: the device lookup fails, naming the kinds
    with pytest.raises(ValueError, match="cpu_op"):
        trace_tools.load_device_ops(path, device="cuda")
    ops = trace_tools.load_device_ops(path, device="cpu")
    assert ops and all(len(t) == 4 for t in ops)
    names = {n: c for n, c, _, _ in ops}
    assert names["aten::mm"] == "conv/gemm"
    t = trace_tools.tables(path, iters=2, device="cpu")
    assert t["total_ms"] == pytest.approx(
        sum(t["by_category_ms"].values()))
    assert t["ops"][0]["name"] == "aten::mm"  # own time, not its parent's
    text = trace_tools.summarize(path, iters=2, top=3, device="cpu")
    assert "host op time" in text and "[conv/gemm] aten::mm" in text


def test_trace_missing_and_server(tmp_path):
    from ssd_tpu_torch.utils import trace_tools

    with pytest.raises(FileNotFoundError):
        trace_tools.find_trace(str(tmp_path))


# -------------------------------------------------------------- summarize

@pytest.fixture(scope="module")
def summary_cfgs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("summ")
    jcfg = make_cfg(tmp)
    return jcfg, Config.from_json(jcfg.to_json())


def test_summary_physics(summary_cfgs):
    """JAX's ``test_report_physics`` on the port, and the parameter counts
    equal JAX's module by module."""
    import jax

    from ssd_tpu.models.detector import Detector as JaxDetector
    from ssd_tpu_torch.tools.summarize import summarize

    jcfg, cfg = summary_cfgs
    r = summarize(cfg, batch=4, train=True, device="cpu")
    p = r["params"]
    assert set(p["by_module"]) == {"backbone", "fpn", "head"}
    assert sum(v["params"] for v in p["by_module"].values()) == p["total"]
    shapes = jax.eval_shape(lambda: JaxDetector(jcfg).init(
        jax.random.PRNGKey(0)))["params"]
    for mod, v in p["by_module"].items():
        assert v["params"] == sum(int(np.prod(x.shape)) for x in
                                  jax.tree_util.tree_leaves(shapes[mod]))
    assert r["serve"]["flops"] > 0
    assert r["train"]["flops"] > 1.5 * r["serve"]["flops"]
    for s in (r["serve"], r["train"]):
        assert s["bound"] in ("compute", "bandwidth")
        assert s["roofline_ms"] > 0


def test_summary_flops_scale_with_batch(summary_cfgs):
    from ssd_tpu_torch.tools.summarize import summarize

    _, cfg = summary_cfgs
    r2 = summarize(cfg, batch=2, device="cpu")
    r4 = summarize(cfg, batch=4, device="cpu")
    ratio = r4["serve"]["flops"] / r2["serve"]["flops"]
    assert 1.7 < ratio < 2.3, ratio


def test_summary_counts_the_int8_conv(summary_cfgs):
    """An int8 predict's ``int8`` FLOPs are 2 M K N of every int8 dense
    conv (the operator ``ssd_tpu_torch::conv_s8``, K4 on the card), every
    tap counted, K the conv's unpadded depth."""
    from ssd_tpu_torch.models.detector import Detector
    from ssd_tpu_torch.models.layers import QuantConv
    from ssd_tpu_torch.models.mobilenet import Int8FoldedS2DConv
    from ssd_tpu_torch.tools.summarize import CostCounter

    _, cfg = summary_cfgs
    qcfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="int8", int8_neck=False))
    det = Detector(qcfg, device="cpu")
    want = [0]

    def hook(mod, inp, y):
        o, c, kh, kw = mod.weight.shape
        want[0] += 2 * y.shape[0] * y.shape[2] * y.shape[3] * kh * kw * c * o

    hooks = [m.register_forward_hook(hook) for m in det.model.modules()
             if isinstance(m, (QuantConv, Int8FoldedS2DConv))]
    with CostCounter() as counter:
        det.predict(np.zeros((2, *qcfg.image_hw(), 3), np.uint8))
    for h in hooks:
        h.remove()
    assert counter.flops["int8"] == want[0] > 0


def _conv_taps(det, images) -> tuple[int, int]:
    """(every tap, the taps inside the image) FLOPs of ``det.predict``'s
    convolutions, from each conv's unpadded input and SAME padding."""
    from ssd_tpu_torch.models.layers import Conv

    def taps(n, k, s):
        out = -(-n // s)
        p0 = max((out - 1) * s + k - n, 0) // 2
        inside = sum(1 for o in range(out) for t in range(k)
                     if 0 <= o * s - p0 + t < n)
        return out * k, inside

    sums = [0, 0]

    def hook(mod, inp, _):
        x, (co, ci, kh, kw) = inp[0], mod.weight.shape
        (dh, ih), (dw, iw) = (taps(x.shape[-2], kh, mod.stride),
                              taps(x.shape[-1], kw, mod.stride))
        sums[0] += 2 * x.shape[0] * co * ci * dh * dw
        sums[1] += 2 * x.shape[0] * co * ci * ih * iw

    hooks = [m.register_forward_hook(hook) for m in det.model.modules()
             if isinstance(m, Conv)]
    det.predict(images)
    for h in hooks:
        h.remove()
    return sums[0], sums[1]


def _grouped_wgrads(det) -> list:
    """Hooks recording, for each grouped conv the next forward runs, its
    groups and its true weight-gradient FLOPs, 2 N Cout (Cin / g) k^2 H'W'
    (the list fills as the forward runs)."""
    from ssd_tpu_torch.models.layers import Conv

    out = []

    def hook(mod, inp, y):
        co, ci_g, kh, kw = mod.weight.shape
        out.append((mod.groups, 2 * y.shape[0] * co * ci_g * kh * kw
                    * y.shape[2] * y.shape[3]))

    for m in det.model.modules():
        if isinstance(m, Conv) and m.groups > 1:
            m.register_forward_hook(hook)
    return out


def test_summary_flops_against_flop_counter_and_xla(summary_cfgs):
    from torch.utils.flop_counter import FlopCounterMode

    from ssd_tpu.tools.summarize import summarize as jax_summarize
    from ssd_tpu_torch.models.detector import Detector
    from ssd_tpu_torch.tools.summarize import CostCounter, summarize

    jcfg, cfg = summary_cfgs
    r = summarize(cfg, batch=4, train=True, device="cpu")
    det = Detector(cfg, device="cpu")
    images = torch.zeros((4, *cfg.image_hw(), 3), dtype=torch.uint8)
    with FlopCounterMode(display=False) as fc:
        det.predict(images)
    assert r["serve"]["flops"] == fc.get_total_flops()
    from ssd_tpu_torch.tools.bench_train import synthetic_batch
    from ssd_tpu_torch.train_step import (Optimizer, create_train_state,
                                          make_train_step)
    opt = Optimizer(cfg)
    state = create_train_state(det, opt)
    step = make_train_step(det, opt)
    data = {k: torch.from_numpy(v) for k, v in synthetic_batch(cfg, 4)
            .items()}
    wgrads = _grouped_wgrads(det)
    with FlopCounterMode(display=False) as fc, CostCounter() as cc:
        step(state, data)
    # FlopCounterMode counts a grouped conv's weight gradient `groups` times
    # over; the tool once
    excess = sum((g - 1) * w for g, w in wgrads)
    assert excess > 0
    assert cc.cost()["flops"] == fc.get_total_flops() - excess

    dense, inside = _conv_taps(det, images)
    assert dense == r["serve"]["flops"]
    xla = jax_summarize(jcfg, batch=4)["serve"]["flops"]
    assert inside <= xla <= XLA_OVER_INIMAGE_BAR * inside, (dense, inside,
                                                            xla)
    ratio = r["serve"]["flops"] / xla
    assert dense / inside / XLA_OVER_INIMAGE_BAR <= ratio <= dense / inside


def test_summary_cli(summary_cfgs, tmp_path, capsys):
    from ssd_tpu_torch.tools.summarize import main

    _, cfg = summary_cfgs
    cfg.save(str(tmp_path / "cfg.json"))
    r = main(["--config", str(tmp_path / "cfg.json"), "--batch", "2",
              "--json", str(tmp_path / "r.json"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "H100 SXM roofline" in out and "serve @b2" in out
    with open(tmp_path / "r.json") as f:
        assert json.load(f)["serve"]["flops"] == r["serve"]["flops"]


# ------------------------------------------------------- analyze_anchors

@pytest.fixture(scope="module")
def anchor_data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("anchors")
    write_synth_dataset(tmp / "train.tfrecords", 24, seed=0)
    write_synth_dataset(tmp / "val.tfrecords", 24, seed=1)
    jcfg = make_cfg(tmp)
    return tmp, jcfg, Config.from_json(jcfg.to_json())


def _same_report(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, abs=1e-12), k
        else:
            assert got[k] == v, k


def test_anchor_report_equals_jax(anchor_data):
    from ssd_tpu.tools.analyze_anchors import analyze as jax_analyze
    from ssd_tpu_torch.tools.analyze_anchors import analyze

    _, jcfg, cfg = anchor_data
    # the toy spec and one matched to the boxes (JAX's third case)
    for scale in (None, 2.5):
        if scale is not None:
            jcfg = dataclasses.replace(jcfg, anchors=dataclasses.replace(
                jcfg.anchors, anchor_scale=scale))
            cfg = Config.from_json(jcfg.to_json())
        _same_report(analyze(cfg, split="val", batch_size=8, device="cpu"),
                     jax_analyze(jcfg, split="val", batch_size=8))


def test_anchor_cases_of_jax(anchor_data, tmp_path):
    """JAX's four cases (``tests/test_analyze_anchors.py``) on the port."""
    import io

    from PIL import Image

    from ssd_tpu_torch.data.tfrecord import (RecordWriter,
                                             encode_detection_example)
    from ssd_tpu_torch.tools.analyze_anchors import analyze

    _, _, cfg = anchor_data
    r = analyze(cfg, split="val", batch_size=8, device="cpu")
    assert r["images"] == 24 and r["gts"] > 0
    assert 0.0 <= r["matched_recall"] <= 1.0
    assert 0.0 <= r["forced_only_frac"] <= 1.0
    assert r["matched_recall"] + r["forced_only_frac"] <= 1.0 + 1e-9
    assert 0.0 <= r["best_iou_mean"] <= 1.0
    n_levels = cfg.anchors.max_level - cfg.anchors.min_level + 1
    assert len(r["level_positive_share"]) == n_levels
    assert abs(sum(r["level_positive_share"]) - 1.0) < 0.01
    assert sum(r["bucket_gts"].values()) == r["gts"]

    assert analyze(cfg, split="val", limit=5, batch_size=8,
                   device="cpu")["images"] == 5

    matched = dataclasses.replace(cfg, anchors=dataclasses.replace(
        cfg.anchors, anchor_scale=2.5))
    r = analyze(matched, split="val", batch_size=8, device="cpu")
    assert r["matched_recall"] > 0.9 and r["forced_only_frac"] < 0.1, r

    buf = io.BytesIO()
    Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(buf, "JPEG")
    empty = str(tmp_path / "empty.tfrecords")
    with RecordWriter(empty) as w:
        for _ in range(4):
            w.write(encode_detection_example(
                buf.getvalue(), np.zeros((0, 4), np.float32),
                np.zeros(0, np.int64)))
    r = analyze(cfg, batch_size=2, data_pattern=empty, device="cpu")
    assert r["images"] == 4 and r["gts"] == 0
    assert r["matched_recall"] == 0.0


def test_anchor_cli(anchor_data, tmp_path, capsys):
    from ssd_tpu_torch.tools.analyze_anchors import main

    tmp, _, cfg = anchor_data
    cfg.save(str(tmp_path / "cfg.json"))
    r = main(["--config", str(tmp_path / "cfg.json"), "--limit", "8",
              "--json", str(tmp_path / "r.json"), "--device", "cpu"])
    assert "anchor coverage over 8 images" in capsys.readouterr().out
    with open(tmp_path / "r.json") as f:
        assert json.load(f) == r


# ------------------------------------------------------------------ demo

def _jax_demo():
    spec = importlib.util.spec_from_file_location(
        "try_detector", os.path.join(ROOT, "demo", "try_detector.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_draw_detections_equals_jax():
    from ssd_tpu_torch.demo import draw_detections

    rng = np.random.default_rng(0)
    image = rng.integers(0, 255, (120, 160, 3)).astype(np.uint8)
    y0x0 = rng.uniform(-0.1, 0.8, (12, 2))
    boxes = np.concatenate([y0x0, y0x0 + rng.uniform(0.0, 0.5, (12, 2))], 1)
    out = {"boxes": boxes.astype(np.float32), "num_boxes": np.int32(9)}
    want = _jax_demo().draw_detections(image, out)
    np.testing.assert_array_equal(draw_detections(image, out), want)
    assert (want != image).any()


def test_demo_selftest_on_cpu(tmp_path, capsys):
    from PIL import Image

    from ssd_tpu_torch.demo import main

    out = main(["--selftest", "--device", "cpu",
                "--output", str(tmp_path / "d.png")])
    assert "wrote" in capsys.readouterr().out
    assert np.asarray(Image.open(tmp_path / "d.png")).shape == (480, 640, 3)
    assert out["boxes"].shape == (100, 4)
