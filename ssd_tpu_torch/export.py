"""Inference artifacts and the exported predict program (the port's
``ssd_tpu/export.py``).

The artifact is a directory in the JAX package's layout:

* ``config.json``;
* ``label_map.json`` where there is a label map (``{"class id": name}``);
* ``variables.npz``: the state dict (weights, BN statistics and any
  calibrated int8 scales) by parameter name, in place of the JAX
  package's orbax checkpoint ``variables/``.

The port reads no orbax: a JAX artifact directory raises, naming the way
across (``convert.convert_variables`` where JAX is installed). The
single-file ``.npz`` (``convert.save_npz_artifact``) loads too.

``export_program`` is ``torch.export`` of ``Detector.predict`` at one
(batch, resolution), weights included, saved as
``predict_b{B}_{H}x{W}.pt2``; ``load_program`` runs it without the model
code or the config. Its dependencies besides torch are the suppression
operator ``ssd_tpu_torch::nms_suppress`` (``ops/nms_cuda.py``) and, in an
int8 program, the conv operator ``ssd_tpu_torch::conv_s8``
(``ops/conv_s8_cuda.py``), which ``load_program`` registers by importing
those modules: K1 and K4 launch through ctypes, which ``torch.export``
cannot trace, so the program calls the operators and the operators the
kernels (the plain versions on the CPU). An int8 program holds its conv
weights quantized and packed, as constants (``layers.prepared_buffers``).
A StableHLO program needs only jax; this one needs torch and those modules.
A TensorFlow SavedModel (``export_savedmodel``) has no counterpart: the
port does not import TensorFlow.

    python -m ssd_tpu_torch.export --workdir runs/r1 [--step N] \\
        [--output runs/r1/export] [--program --batch-size 1] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
from torch import nn

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.convert import (check_scales, load_label_map,
                                   load_npz_artifact)
from ssd_tpu_torch.models import layers
from ssd_tpu_torch.models.detector import Detector, select_for_nms
from ssd_tpu_torch.ops.postprocess import run_nms

CONFIG_FILE = "config.json"
LABEL_MAP_FILE = "label_map.json"
VARIABLES_FILE = "variables.npz"
ORBAX_DIR = "variables"  # the JAX package's weights
DET_KEYS = ("boxes", "scores", "labels", "num_boxes")


def save_inference_artifact(path: str, cfg: Config, state: dict,
                            label_map: dict | None = None) -> None:
    """Writes the artifact directory ``path``. An ``int8_neck`` config
    without calibrated scales raises: it could not serve."""
    check_scales(cfg, state)
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    cfg.save(os.path.join(path, CONFIG_FILE))
    labels = os.path.join(path, LABEL_MAP_FILE)
    if label_map:
        with open(labels, "w") as f:
            json.dump({str(k): v for k, v in label_map.items()}, f, indent=2)
    elif os.path.exists(labels):  # not another artifact's
        os.unlink(labels)
    arrays = {k: v.detach().cpu().numpy() for k, v in state.items()}
    tmp = os.path.join(path, VARIABLES_FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, os.path.join(path, VARIABLES_FILE))


def _check_port_artifact(path: str) -> None:
    if os.path.exists(os.path.join(path, VARIABLES_FILE)):
        return
    if os.path.isdir(os.path.join(path, ORBAX_DIR)):
        raise ValueError(
            f"{path} is a JAX package artifact: its weights are an orbax "
            f"checkpoint ({ORBAX_DIR}/), which the port does not read. "
            "Convert it where JAX is installed: ssd_tpu.export."
            "load_inference_artifact, then ssd_tpu_torch.convert."
            "convert_variables(jax.device_get(variables), cfg) and "
            "ssd_tpu_torch.export.save_inference_artifact")
    raise FileNotFoundError(f"no inference artifact at {path} "
                            f"(no {VARIABLES_FILE})")


def load_inference_artifact(path: str) -> tuple[Config, dict]:
    """-> ``(cfg, state)`` from an artifact directory or a single-file
    ``.npz``. The config loads leniently (keys of other versions are
    skipped)."""
    if os.path.isfile(path):
        return load_npz_artifact(path)
    _check_port_artifact(path)
    cfg = Config.load(os.path.join(path, CONFIG_FILE), strict=False)
    with np.load(os.path.join(path, VARIABLES_FILE),
                 allow_pickle=False) as z:
        state = {k: torch.from_numpy(z[k]) for k in z.files}
    return cfg, state


def load_artifact_label_map(path: str) -> dict[int, str] | None:
    """The label map of an artifact directory or ``.npz``, if it has one."""
    if os.path.isfile(path):
        return load_label_map(path)
    labels = os.path.join(path, LABEL_MAP_FILE)
    if not os.path.exists(labels):
        return None
    with open(labels) as f:
        return {int(k): v for k, v in json.load(f).items()}


def add_artifact_args(p, required: bool = True) -> None:
    """The CLIs' artifact flag, parsed into ``args.artifact``: ``--export
    PATH`` (as the JAX package's CLIs take it), a directory or a
    single-file ``.npz``; ``--npz PATH`` is the same flag under its older
    name, and the two together are refused."""
    group = p.add_mutually_exclusive_group(required=required)
    group.add_argument("--export", dest="artifact", metavar="PATH",
                       help="inference artifact: a directory or a .npz")
    group.add_argument("--npz", dest="artifact", metavar="PATH",
                       help="the same as --export")


class PredictProgram(nn.Module):
    """``Detector.predict`` as a module: uint8 ``(B, H, W, 3)`` -> ``{boxes,
    scores, labels, num_boxes}``, the model's weights and the anchors its
    own tensors."""

    def __init__(self, detector: Detector):
        super().__init__()
        self.cfg = detector.cfg
        self.model = detector.model.eval()
        self.register_buffer("anchors", detector.anchors)

    def forward(self, images: torch.Tensor) -> dict:
        out = run_nms(*select_for_nms(self.model, self.anchors, self.cfg,
                                      images), self.cfg.nms)
        return {k: getattr(out, k) for k in DET_KEYS}


def export_program(path: str, cfg: Config, state: dict | None,
                   batch_size: int = 1, device=None) -> str:
    """Serialize the predict program (weights included) for a uint8
    ``(batch_size, H, W, 3)`` batch on ``device`` (``None``: the card);
    returns the ``.pt2`` file's path."""
    program = PredictProgram(Detector(cfg, state, device=device))
    spec = torch.zeros((batch_size, *cfg.image_hw(), 3), dtype=torch.uint8,
                       device=program.anchors.device)
    with layers.prepared_buffers(program):  # int8 weights as constants
        exported = torch.export.export(program, (spec,))
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "predict_b{}_{}x{}.pt2".format(
        batch_size, *cfg.image_hw()))
    torch.export.save(exported, out)
    return out


def load_program(file: str):
    """Load an exported predict program. Returns ``fn(images) -> {boxes,
    scores, labels, num_boxes}``: ``images`` uint8 numpy or a tensor of the
    exported shape; the outputs are tensors on the program's device."""
    from ssd_tpu_torch.ops import conv_s8_cuda, nms_cuda  # noqa: F401
    # (the operators)

    program = torch.export.load(file)
    device = program.state_dict["anchors"].device
    module = program.module()

    def fn(images) -> dict:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        with torch.no_grad():
            return module(images.to(device, non_blocking=True))
    return fn


def export_savedmodel(*args, **kwargs):
    """The JAX package's jax2tf SavedModel has no counterpart here."""
    raise NotImplementedError(
        "export_savedmodel: a TensorFlow SavedModel is written by jax2tf in "
        "the JAX package; the port does not import TensorFlow. Use "
        "export_program (torch.export) or the artifact directory")


def main(argv=None) -> None:
    """CLI: training checkpoint -> inference artifact (the EMA weights where
    the run tracks them), with the label map found beside the training
    shards as the train loop's export has it."""
    from ssd_tpu_torch.train import find_label_map
    from ssd_tpu_torch.train_step import (Optimizer, create_train_state,
                                          inference_variables)
    from ssd_tpu_torch.utils.checkpoint import TrainCheckpointer

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True,
                   help="training workdir (config.json, checkpoints/)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    p.add_argument("--output", default=None,
                   help="artifact dir (default: <workdir>/export)")
    p.add_argument("--program", action="store_true",
                   help="also write the exported predict program (.pt2)")
    p.add_argument("--savedmodel", action="store_true",
                   help="refused: the port does not import TensorFlow")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    if args.savedmodel:
        export_savedmodel()

    cfg = Config.load(os.path.join(args.workdir, CONFIG_FILE))
    detector = Detector(cfg, device=args.device)
    state = create_train_state(detector, Optimizer(cfg), cfg.train.ema_decay)
    state, _ = TrainCheckpointer(os.path.join(
        args.workdir, "checkpoints")).restore(state, step=args.step)
    variables = {k: v.cpu() for k, v in inference_variables(state).items()}
    out = args.output or os.path.join(args.workdir, "export")
    save_inference_artifact(out, cfg, variables,
                            find_label_map(cfg.data.train_file_pattern))
    print(f"wrote inference artifact (step {state.step}) to {out}",
          flush=True)
    if args.program:
        f = export_program(out, cfg, variables, batch_size=args.batch_size,
                           device=args.device)
        print(f"wrote exported predict program to {f}", flush=True)


if __name__ == "__main__":
    main()
