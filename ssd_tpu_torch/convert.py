"""Weight bridge: the JAX package's variable tree -> the port's state dict,
and a single-file ``.npz`` artifact that carries both weights and config.

The flax tree ``{"params": {...}, "batch_stats": {...}}`` maps to the port's
module paths one to one (``params/backbone/ds3/depthwise/conv/kernel`` ->
``backbone.ds3.depthwise.conv.weight``):

* conv ``kernel`` HWIO ``(kh, kw, in, out)`` -> ``weight`` OIHW; a depthwise
  kernel ``(3, 3, 1, C)`` becomes ``(C, 1, 3, 3)`` by the same transpose;
* batch norm ``scale``/``bias`` -> ``weight``/``bias``, and
  ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``;
* conv ``bias`` -> ``bias``.

A JAX ``TrainState`` maps by its ``params`` and ``batch_stats``
(``convert_variables({"params": s.params, "batch_stats": s.batch_stats},
cfg)``), and a gradient tree, shaped like ``params``, by
``convert_params`` under the same HWIO -> OIHW rule.

The input is plain nested dicts of numpy arrays (``jax.device_get`` of a
restored tree), so this module needs no JAX. Any leaf left unused, and any
port parameter left unfilled, raises.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.models.detector import SSDModel

_LEAF_NAMES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}

_STATE_PREFIX = "state/"
_CONFIG_KEY = "config_json"


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
        with torch.device("meta"):
            return SSDModel(target)
    return target


def expected_state(target) -> dict[str, tuple]:
    """Name -> shape of every tensor ``target`` loads: a module, or a Config
    (the full model for that config, built without memory)."""
    return {k: tuple(v.shape) for k, v in _module(target).state_dict().items()}


def convert_variables(variables: dict, target) -> dict[str, torch.Tensor]:
    """Flax variable tree (numpy leaves) -> state dict (f32) for ``target``,
    a Config (the full model) or any module of the port."""
    return _convert(variables, expected_state(target))


def convert_params(params: dict, target) -> dict[str, torch.Tensor]:
    """A flax ``params`` tree, or a gradient tree of the same shape ->
    ``{parameter name: f32 tensor}`` for ``target``'s parameters."""
    want = {k: tuple(v.shape)
            for k, v in _module(target).named_parameters()}
    return _convert({"params": params}, want)


def _convert(variables: dict, want: dict[str, tuple]) -> dict[str, torch.Tensor]:
    state, unused = {}, []
    for path, value in _flatten(variables).items():
        leaf = _LEAF_NAMES.get((path[0], path[-1]))
        if leaf is None:
            unused.append("/".join(path))
            continue
        name = ".".join(path[1:-1] + (leaf,))
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


def save_npz_artifact(path: str, cfg: Config, state: dict,
                      **extra: np.ndarray) -> None:
    """One compressed ``.npz``: the state dict, the config text, and any
    ``extra`` arrays under their own names."""
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
