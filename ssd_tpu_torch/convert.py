"""Weight bridge: the JAX package's variable tree -> the port's state dict,
and a single-file ``.npz`` artifact that carries both weights and config.

The flax tree ``{"params": {...}, "batch_stats": {...}}`` maps to the port's
module paths one to one (``params/backbone/ds3/depthwise/conv/kernel`` ->
``backbone.ds3.depthwise.conv.weight``):

* conv ``kernel`` HWIO ``(kh, kw, in, out)`` -> ``weight`` OIHW; a depthwise
  kernel ``(3, 3, 1, C)`` becomes ``(C, 1, 3, 3)`` by the same transpose;
* batch norm ``scale``/``bias`` -> ``weight``/``bias``, and
  ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``;
* conv ``bias`` -> ``bias``;
* the ``quant`` collection's calibrated int8 activation scales, one to one
  by path: ``quant/head/class_net/conv0/act_scale_16x16`` ->
  ``head.class_net.conv0.act_scale_16x16``, the scale of that conv for a
  16x16 input (``models/layers.QuantConv``).

A JAX ``TrainState`` maps by its ``params`` and ``batch_stats``
(``convert_variables({"params": s.params, "batch_stats": s.batch_stats},
cfg)``), and a gradient tree, shaped like ``params``, by
``convert_params`` under the same HWIO -> OIHW rule.

The input is plain nested dicts of numpy arrays (``jax.device_get`` of a
restored tree), so this module needs no JAX. Any leaf left unused, and any
port parameter left unfilled, raises. For an int8 config the scales
expected are those a calibration at the config's image size records; they
must all be filled when the tree has a ``quant`` collection or the config
has ``int8_neck``, and are absent otherwise (the backbone's static scales).
"""

from __future__ import annotations

import json
from collections.abc import Mapping

import numpy as np
import torch

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.models.detector import SSDModel
from ssd_tpu_torch.models.layers import SCALE_PREFIX, calibrating

_LEAF_NAMES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}

_STATE_PREFIX = "state/"
_CONFIG_KEY = "config_json"
LABEL_MAP_KEY = "label_map"  # the npz entry: JSON {class id: name}


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _module(target):
    if isinstance(target, Config):
        with torch.device("meta"), torch.no_grad():
            model = SSDModel(target).to("meta")  # numpy-made buffers too
            if target.model.compute_dtype == "int8":
                # the scales a calibration at this image size records
                images = torch.empty(1, *target.image_hw(), 3,
                                     dtype=torch.uint8)
                with calibrating(model):
                    model.eval()(images)
        return model
    return target


def scale_name(path: str) -> str:
    """A ``quant`` collection path -> the state-dict name of that scale:
    ``quant/head/class_net/conv0/act_scale_16x16`` ->
    ``head.class_net.conv0.act_scale_16x16``."""
    parts = path.split("/")
    if parts[0] != "quant" or not parts[-1].startswith(SCALE_PREFIX):
        raise ValueError(f"not a calibrated scale's path: {path!r}")
    return ".".join(parts[1:])


def is_scale(name: str) -> bool:
    """Whether a state-dict name is a calibrated activation scale."""
    return name.rsplit(".", 1)[-1].startswith(SCALE_PREFIX)


def expected_state(target) -> dict[str, tuple]:
    """Name -> shape of every tensor ``target`` loads: a module (with the
    scales it holds), or a Config (the full model for that config, built
    without memory, with the scales a calibration records)."""
    return {k: tuple(v.shape) for k, v in _module(target).state_dict().items()}


def seeded_state(target, seed: int,
                 class_bias: float | None = None) -> dict[str, torch.Tensor]:
    """A state dict of seeded values for ``target`` (a Config or a module),
    drawn by ``np.random.default_rng(seed)`` over ``expected_state(target)``
    in sorted-name order, so that any machine draws the same values: conv
    weights normal with std ``1/sqrt(fan_in)``, norm scales and running
    variances uniform in [0.5, 1.5], biases and running means normal with
    std 0.1. ``class_bias``: the class head's ``predict`` bias, every
    entry. No calibrated scales."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, shape in sorted(expected_state(target).items()):
        if is_scale(name):
            continue
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and len(shape) == 4:
            v = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[1:])), shape)
        elif leaf in ("weight", "running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        state[name] = torch.from_numpy(v.astype(np.float32))
    if class_bias is not None:
        state["head.class_net.predict.bias"].fill_(class_bias)
    return state


def convert_variables(variables: dict, target) -> dict[str, torch.Tensor]:
    """Flax variable tree (numpy leaves) -> state dict (f32) for ``target``,
    a Config (the full model) or any module of the port."""
    want = expected_state(target)
    need_scales = "quant" in variables or (
        isinstance(target, Config) and target.model.int8_neck
        and target.model.compute_dtype == "int8")
    if not need_scales:
        want = {k: v for k, v in want.items() if not is_scale(k)}
    return _convert(variables, want)


def convert_params(params: dict, target) -> dict[str, torch.Tensor]:
    """A flax ``params`` tree, or a gradient tree of the same shape ->
    ``{parameter name: f32 tensor}`` for ``target``'s parameters."""
    want = {k: tuple(v.shape)
            for k, v in _module(target).named_parameters()}
    return _convert({"params": params}, want)


def _convert(variables: dict, want: dict[str, tuple]) -> dict[str, torch.Tensor]:
    state, unused = {}, []
    for path, value in _flatten(variables).items():
        if path[0] == "quant" and path[-1].startswith(SCALE_PREFIX):
            name = scale_name("/".join(path))
        elif (path[0], path[-1]) in _LEAF_NAMES:
            name = ".".join(path[1:-1] + (_LEAF_NAMES[path[0], path[-1]],))
        else:
            unused.append("/".join(path))
            continue
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if name not in want or tuple(value.shape) != want[name]:
            unused.append("/".join(path) + f" {value.shape}")
            continue
        state[name] = torch.from_numpy(np.array(value, np.float32))
    missing = sorted(set(want) - set(state))
    if unused or missing:
        raise ValueError(
            f"variable tree does not match the model: unused leaves "
            f"{unused}, unfilled parameters {missing}")
    return state


def check_scales(cfg: Config, state: dict) -> None:
    """Raises for an ``int8_neck`` config whose state carries no calibrated
    scales: such an artifact could not serve."""
    if (cfg.model.compute_dtype == "int8" and cfg.model.int8_neck
            and not any(is_scale(k) for k in state)):
        raise ValueError(
            "cfg.model.int8_neck is set but the state carries no calibrated "
            "scales (the JAX package's 'quant' collection): calibrate first "
            "(ssd_tpu_torch.quant.calibrate or python -m ssd_tpu_torch.quant)")


def save_npz_artifact(path: str, cfg: Config, state: dict,
                      **extra: np.ndarray) -> None:
    """One compressed ``.npz``: the state dict (calibrated scales included),
    the config text, and any ``extra`` arrays under their own names. An
    ``int8_neck`` config without scales raises: it could not serve."""
    check_scales(cfg, state)
    arrays = {_STATE_PREFIX + k: v.detach().cpu().numpy()
              for k, v in state.items()}
    clash = set(extra) & (set(arrays) | {_CONFIG_KEY})
    if clash:
        raise ValueError(f"extra arrays clash with artifact keys: {clash}")
    arrays[_CONFIG_KEY] = np.array(cfg.to_json())
    np.savez_compressed(path, **arrays, **extra)


def load_npz_artifact(path: str) -> tuple[Config, dict[str, torch.Tensor]]:
    """-> ``(cfg, state)`` from ``save_npz_artifact``'s file."""
    with np.load(path, allow_pickle=False) as z:
        cfg = Config.from_json(str(z[_CONFIG_KEY]), strict=False)
        state = {k[len(_STATE_PREFIX):]: torch.from_numpy(z[k])
                 for k in z.files if k.startswith(_STATE_PREFIX)}
    return cfg, state


def label_map_array(label_map: dict[int, str]) -> np.ndarray:
    """A label map as the npz entry ``save_npz_artifact(..., label_map=)``
    stores and ``load_label_map`` reads."""
    return np.array(json.dumps({str(k): v for k, v in label_map.items()}))


def load_label_map(path: str) -> dict[int, str] | None:
    """The label map of ``save_npz_artifact``'s file, if it carries one."""
    with np.load(path, allow_pickle=False) as z:
        if LABEL_MAP_KEY not in z.files:
            return None
        return {int(k): v for k, v in json.loads(str(z[LABEL_MAP_KEY])).items()}
