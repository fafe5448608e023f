"""The port stands alone: no JAX, no ``ssd_tpu``, and the card by default.

The machine with the card has no JAX, so ``ssd_tpu_torch`` and
``chip_smoke.py`` must import with both blocked. Entry points default to
CUDA and raise where it is absent; CPU tensors never reach the kernel.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "ssd_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import ssd_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    ssd_tpu_torch.__path__, "ssd_tpu_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "optax", "orbax", "ssd_tpu")
    and sys.modules[m] is not None)
assert not leaked, leaked
for name in ("quant", "eval.coco_map", "eval.sanity", "serve", "data.native",
             "tools.bench_serve", "tools.bench_http", "data.tfrecord",
             "data.augment", "data.pipeline", "data.create_tfrecords",
             "ops.distill", "train", "tools.bench_train", "utils.profiling",
             "models.mobilenet_v2", "models.efficientnet",
             "models.shufflenet", "models.resnet", "ops.fused_head",
             "tools.train_memory", "tiling", "tta", "ops.wbf",
             "eval.__main__", "streaming", "export",
             "tools.bench_streaming", "parallel", "parallel.mesh",
             "tools.scaleout_check"):
    assert "ssd_tpu_torch." + name in names, name
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30  # every module of the package


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from ssd_tpu_torch.config import Config
    from ssd_tpu_torch.models.detector import Detector
    from ssd_tpu_torch.predictor import Predictor
    cfg = Config.load(os.path.join(ROOT, "bench_assets", "sanity_artifact",
                                   "config.json"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(cfg, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        Detector(cfg)
    Predictor(cfg, None, device="cpu")  # the explicit CPU path builds
    reference = Config.load(os.path.join(ROOT, "configs",
                                         "coco_mobilenet_640.json"))
    assert reference.model.stem_schedule == "reference"
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(reference, None)
    from ssd_tpu_torch.tools import bench_fused_early
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_fused_early.reference_backbone()
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_fused_early.main(["--batch", "1", "--size", "16"])
    from ssd_tpu_torch import export
    from ssd_tpu_torch.streaming import StreamingDetector
    from ssd_tpu_torch.tools import bench_streaming
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingDetector(cfg, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_streaming.main(["--config", os.path.join(
            ROOT, "configs", "streaming_1024.json"), "--frames", "1"])
    cfg.save(str(tmp_path / "config.json"))
    with pytest.raises(RuntimeError, match="CUDA"):  # before any restore
        export.main(["--workdir", str(tmp_path)])


def test_cpu_tensors_never_launch_the_kernel():
    from ssd_tpu_torch.config import NMSConfig
    from ssd_tpu_torch.ops import nms_cuda
    rng = np.random.default_rng(0)
    lo = rng.uniform(0, 0.7, (2, 50, 2))
    boxes = np.concatenate([lo, lo + 0.2], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (2, 50, 3)).astype(np.float32)
    nms_cuda.launches = 0
    det = nms_cuda.batched_nms_cuda(torch.from_numpy(boxes),
                                    torch.from_numpy(scores), NMSConfig())
    assert int(det.num_boxes.sum()) > 0
    assert nms_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        nms_cuda.suppress_cuda(torch.from_numpy(boxes),
                               torch.zeros(2, 3, 8, dtype=torch.int32),
                               torch.zeros(2, 3, 8), 0.5)


def test_cpu_matching_never_loads_the_kernel():
    """``match_anchors`` on CPU tensors takes the plain version: no launch,
    and ``match.cu`` is never built or loaded."""
    from ssd_tpu_torch import _build
    from ssd_tpu_torch.config import MatcherConfig
    from ssd_tpu_torch.ops import matching_cuda
    rng = np.random.default_rng(1)
    lo = rng.uniform(0, 0.7, (300, 2))
    anchors = np.concatenate([lo, lo + 0.2], -1).astype(np.float32)
    gt = anchors[None, ::37].copy()
    matching_cuda.launches = 0
    matches = matching_cuda.match_anchors(
        torch.from_numpy(anchors), torch.from_numpy(gt),
        torch.tensor([len(gt[0])], dtype=torch.int32), MatcherConfig())
    assert int((matches >= 0).sum()) >= len(gt[0])
    assert matching_cuda.launches == 0
    assert matching_cuda._lib is None and "match" not in _build._libs
    with pytest.raises(ValueError, match="CUDA"):
        matching_cuda.match_core_cuda(torch.from_numpy(anchors),
                                      torch.from_numpy(gt),
                                      torch.tensor([1], dtype=torch.int32))


def test_cpu_fused_early_never_loads_the_kernel():
    """``fused_ds1_ds2`` on CPU tensors takes the plain version: no launch,
    and ``fused_early.cu`` is never built or loaded."""
    from ssd_tpu_torch import _build
    from ssd_tpu_torch.ops import fused_early, fused_early_cuda
    from ssd_tpu_torch.tools import bench_fused_early
    backbone = bench_fused_early.reference_backbone(0.25, device="cpu")
    folded = fused_early.fold_early_params(backbone)
    x = bench_fused_early.make_input(1, 8, 8, device="cpu")
    fused_early_cuda.launches = 0
    out = fused_early_cuda.fused_ds1_ds2(x, folded)
    assert tuple(out.shape) == (1, 32, 4, 4)
    assert fused_early_cuda.launches == 0
    assert fused_early_cuda._lib is None and "fused_early" not in _build._libs
    with pytest.raises(ValueError, match="CUDA"):
        fused_early_cuda.fused_ds1_ds2_cuda(x, folded)
