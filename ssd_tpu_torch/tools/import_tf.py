"""Imports TF/Keras detector weights into an inference artifact of the port
(the port's ``ssd_tpu/tools/import_tf.py``), without TensorFlow.

The importable variables are derived from the port's own state
(``convert.expected_state(cfg)``), whose names are the JAX package's flax
paths one for one (``backbone.ds3.pointwise.conv.weight`` is
``params/backbone/ds3/pointwise/conv/kernel``). Each entry is the JAX
tool's: the flax path, the dotted layer name, the Keras suffix
(``kernel``/``bias``, ``depthwise_kernel`` for a depthwise conv,
``gamma``/``beta``/``moving_mean``/``moving_variance`` for a batch norm)
and the flax shape; a Keras kernel is HWIO, a depthwise one ``(k, k, C,
1)``, and both become the port's OIHW / ``(C, 1, k, k)`` by
``convert.py``'s rules. The JAX tool's refusals stand: only the
``reference`` stem (dense4 has no TF counterpart) and only batch norm.

Two sources, each a ``read(entry) -> array | None``:

* ``checkpoint_reader(prefix, name_map)``: a TF checkpoint (a TF1
  ``Saver``'s or a TF2 one's), read by hand. The ``.index`` file is an
  SSTable of ``BundleEntryProto`` values by tensor name (blocks stored
  uncompressed; footer magic ``0xdb4775248b80fb57``); each entry gives
  the tensor's dtype, shape, shard, offset and size in the raw
  little-endian ``.data-NNNNN-of-NNNNN`` shards. The header entry (the
  empty key) and ``_CHECKPOINTABLE_OBJECT_GRAPH`` are skipped; a
  compressed block, a sliced tensor or a dtype other than f32 raises.
  ``name_map`` ({our layer name: checkpoint scope}) bridges other scope
  names; variables resolve as ``<scope>/<suffix>``.
* ``keras_reader(path)``: a ``.keras`` file (Keras 3): ``config.json``
  names each layer and its class, ``model.weights.h5`` holds its
  variables in the class's order under ``layers/<class>_<n>/vars``. It
  needs ``h5py``, imported there; where h5py is missing it raises,
  naming the TF checkpoint as the way in without it.

The import is strict: every expected parameter must resolve with the right
shape, or the run fails listing what is missing, with the JAX tool's
message.

    python -m ssd_tpu_torch.tools.import_tf --config cfg.json \\
        (--keras-model m.keras | --tf-ckpt PREFIX) [--name-map map.json] \\
        (--output ART_DIR | --dry-run)
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
import struct
import zipfile
from typing import Callable

import numpy as np
import torch

from ssd_tpu_torch.config import Config

# flax leaf name -> Keras/TF variable suffix, per layer kind
_CONV_SUFFIX = {"kernel": "kernel", "bias": "bias"}
_DW_SUFFIX = {"kernel": "depthwise_kernel", "bias": "bias"}
_BN_SUFFIX = {"scale": "gamma", "bias": "beta",
              "mean": "moving_mean", "var": "moving_variance"}
# port state-dict leaf -> (flax collection, flax leaf); a 4-dim weight is a
# conv kernel, any other a norm's scale
_FLAX_LEAF = {"bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


@dataclasses.dataclass
class _Entry:
    collection: str          # "params" | "batch_stats"
    path: tuple[str, ...]    # flax tree path, e.g. (backbone, ds1, bn, scale)
    layer: str               # dotted layer name, e.g. backbone.ds1.bn
    suffix: str              # TF variable suffix, e.g. gamma
    depthwise: bool          # kernel needs the (k,k,C,1)<->(k,k,1,C) swap
    shape: tuple[int, ...]   # expected flax shape
    name: str = ""           # the port's state-dict name


def parameter_spec(cfg: Config) -> list[_Entry]:
    """Every importable leaf, in the JAX tool's order (``params`` then
    ``batch_stats``, each by flax path)."""
    if cfg.model.stem_schedule != "reference":
        raise ValueError(
            "import_tf: only stem_schedule='reference' trees map onto TF "
            f"checkpoints (got {cfg.model.stem_schedule!r}; dense4 is a "
            "TPU-native architecture with no TF counterpart)")
    if cfg.model.norm != "batch":
        raise ValueError("import_tf: requires norm='batch'")
    from ssd_tpu_torch.convert import expected_state, is_scale

    entries = []
    for name, shape in expected_state(cfg).items():
        if is_scale(name):
            continue
        *layer_parts, leaf = name.split(".")
        if leaf == "weight":
            collection, leaf_name = "params", ("kernel" if len(shape) == 4
                                               else "scale")
        else:
            collection, leaf_name = _FLAX_LEAF[leaf]
        if len(shape) == 4:  # OIHW -> HWIO
            shape = (shape[2], shape[3], shape[1], shape[0])
        layer = ".".join(layer_parts)
        if collection == "batch_stats" or layer_parts[-1] == "bn":
            suffix, depthwise = _BN_SUFFIX[leaf_name], False
        else:
            depthwise = (leaf_name == "kernel" and len(shape) == 4
                         and shape[2] == 1 and shape[3] > 1)
            suffix = (_DW_SUFFIX if depthwise else _CONV_SUFFIX)[leaf_name]
        entries.append(_Entry(collection, tuple(layer_parts) + (leaf_name,),
                              layer, suffix, depthwise, tuple(shape), name))
    order = {"params": 0, "batch_stats": 1}
    return sorted(entries, key=lambda e: (order[e.collection], e.path))


def _layer_candidates(layer: str) -> list[str]:
    """Names to try for a layer path: the path, then (for a bare conv,
    which Keras names without its ``.conv``) the path without it."""
    cands = [layer]
    if layer.endswith(".conv"):
        cands.append(layer[: -len(".conv")])
    return cands


# ------------------------------------------------------------ TF checkpoint

_TABLE_MAGIC = 0xdb4775248b80fb57
_FOOTER_BYTES = 48
_DT_FLOAT = 1
_SKIPPED = ("", "_CHECKPOINTABLE_OBJECT_GRAPH")


def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> list[tuple[int, int, object]]:
    """A protobuf message -> ``[(field, wire type, value)]`` (varints as
    ints, length-delimited as bytes, fixed as raw bytes)."""
    out, pos = [], 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        num, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 2:
            ln, pos = _varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        elif wire == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        out.append((num, wire, val))
    return out


def _block(data: bytes, handle: bytes, path: str) -> list[tuple[bytes, bytes]]:
    """The ``(key, value)`` entries of the block at a ``BlockHandle``."""
    offset, pos = _varint(handle, 0)
    size, _ = _varint(handle, pos)
    block = data[offset:offset + size]
    if data[offset + size] != 0:
        raise ValueError(f"{path}: compressed table block (type "
                         f"{data[offset + size]}): not supported")
    (num_restarts,) = struct.unpack("<I", block[-4:])
    end = len(block) - 4 * (num_restarts + 1)
    entries, pos, key = [], 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        vlen, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        entries.append((key, block[pos:pos + vlen]))
        pos += vlen
    return entries


def _bundle_entry(value: bytes) -> dict:
    """A ``BundleEntryProto``: dtype, shape, shard, offset, size, slices."""
    e = {"dtype": 0, "shape": [], "shard_id": 0, "offset": 0, "size": 0,
         "slices": 0}
    for num, _, val in _fields(value):
        if num == 1:
            e["dtype"] = val
        elif num == 2:  # TensorShapeProto: repeated Dim dim = 2
            for dnum, _, dim in _fields(val):
                if dnum == 2:
                    size = [v for n, _, v in _fields(dim) if n == 1]
                    e["shape"].append(size[0] if size else 0)
        elif num == 3:
            e["shard_id"] = val
        elif num == 4:
            e["offset"] = val
        elif num == 5:
            e["size"] = val
        elif num == 7:
            e["slices"] += 1
    return e


class TensorBundle:
    """A TF checkpoint read without TensorFlow: ``names()``,
    ``shape(name)`` and ``get_tensor(name)`` (f32)."""

    def __init__(self, prefix: str):
        index = prefix + ".index"
        with open(index, "rb") as f:
            data = f.read()
        if len(data) < _FOOTER_BYTES:
            raise ValueError(f"{index}: too short for a table")
        (magic,) = struct.unpack("<Q", data[-8:])
        if magic != _TABLE_MAGIC:
            raise ValueError(f"{index}: not a TF checkpoint index "
                             f"(magic {magic:#x})")
        # the footer: the metaindex block's handle, then the index block's,
        # each a varint offset and size
        footer = data[-_FOOTER_BYTES:]
        pos = 0
        for _ in range(2):
            _, pos = _varint(footer, pos)
        start = pos
        for _ in range(2):
            _, pos = _varint(footer, pos)
        self.prefix = prefix
        self.entries = {}
        num_shards = 1
        for _, handle in _block(data, footer[start:pos], index):
            for key, value in _block(data, handle, index):
                name = key.decode()
                if name == "":
                    for num, _, val in _fields(value):
                        if num == 1:
                            num_shards = val
                    continue
                if name in _SKIPPED:
                    continue
                self.entries[name] = _bundle_entry(value)
        self.num_shards = num_shards

    def names(self) -> list[str]:
        return sorted(self.entries)

    def shape(self, name: str) -> tuple[int, ...]:
        return tuple(self.entries[name]["shape"])

    def get_tensor(self, name: str) -> np.ndarray:
        e = self.entries[name]
        if e["slices"]:
            raise ValueError(f"{name}: a sliced (partitioned) tensor is "
                             "not supported")
        if e["dtype"] != _DT_FLOAT:
            raise ValueError(f"{name}: dtype enum {e['dtype']} is not "
                             "DT_FLOAT (only f32 tensors are read)")
        shard = (f"{self.prefix}.data-{e['shard_id']:05d}-of-"
                 f"{self.num_shards:05d}")
        with open(shard, "rb") as f:
            f.seek(e["offset"])
            raw = f.read(e["size"])
        shape = tuple(e["shape"])
        if len(raw) != 4 * int(np.prod(shape)):
            raise ValueError(f"{name}: {len(raw)} bytes for shape {shape}")
        return np.frombuffer(raw, "<f4").reshape(shape).copy()


def checkpoint_reader(ckpt_path: str,
                      name_map: dict[str, str] | None = None
                      ) -> Callable[[_Entry], np.ndarray | None]:
    """Reads from a TF checkpoint; ``name_map`` rewrites layer scopes."""
    bundle = TensorBundle(ckpt_path)
    names = set(bundle.names())

    def read(e: _Entry) -> np.ndarray | None:
        mapped = (name_map or {}).get(e.layer)
        scopes = [mapped] if mapped else _layer_candidates(e.layer)
        suffixes = [e.suffix]
        if e.suffix == "depthwise_kernel":
            suffixes.append("kernel")  # Keras-3-written checkpoints
        for scope in scopes:
            for suffix in suffixes:
                if f"{scope}/{suffix}" in names:
                    return bundle.get_tensor(f"{scope}/{suffix}")
        return None
    return read


# -------------------------------------------------------------- .keras file

def _snake(name: str) -> str:
    """Keras's ``to_snake_case``: the h5 group name of a layer class."""
    name = re.sub(r"\W+", "", name)
    name = re.sub("(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub("([a-z])([A-Z])", r"\1_\2", name).lower()


def _layer_vars(class_name: str, config: dict) -> list[str]:
    """A layer's variable suffixes in the order Keras saves them."""
    if class_name in ("Conv2D", "Dense", "DepthwiseConv2D"):
        return ["kernel"] + (["bias"] if config.get("use_bias", True)
                             else [])
    if class_name == "BatchNormalization":
        return ((["gamma"] if config.get("scale", True) else [])
                + (["beta"] if config.get("center", True) else [])
                + ["moving_mean", "moving_variance"])
    return []


def keras_reader(path: str) -> Callable[[_Entry], np.ndarray | None]:
    """Reads from a saved ``.keras`` model (Keras 3) whose layers are named
    by the port's layer paths (the convention of the JAX package's Keras
    mirror)."""
    try:
        import h5py
    except ImportError as err:
        raise ImportError(
            "import_tf.keras_reader needs h5py, which is not installed: "
            "import a TF checkpoint instead (--tf-ckpt PREFIX, read without "
            "TensorFlow or h5py), written where Keras is installed "
            "(tf.train.Checkpoint or a TF1 Saver)") from err
    import io

    with zipfile.ZipFile(path) as z:
        config = json.loads(z.read("config.json"))
        weights = h5py.File(io.BytesIO(z.read("model.weights.h5")), "r")
    layers, used = {}, {}
    for layer in config["config"]["layers"]:
        group = _snake(layer["class_name"])
        if group in used:
            used[group] += 1
            group = f"{group}_{used[group]}"
        else:
            used[group] = 0
        layers[layer["config"]["name"]] = (
            f"layers/{group}/vars",
            _layer_vars(layer["class_name"], layer["config"]))

    def read(e: _Entry) -> np.ndarray | None:
        for name in _layer_candidates(e.layer):
            if name in layers:
                group, suffixes = layers[name]
                suffix = ("kernel" if e.suffix == "depthwise_kernel"
                          else e.suffix)  # Keras 3 names it plain "kernel"
                if suffix not in suffixes:
                    return None
                return np.asarray(weights[group][str(suffixes.index(suffix))])
        return None
    return read


# ------------------------------------------------------------------- import

def import_weights(cfg: Config,
                   read: Callable[[_Entry], np.ndarray | None],
                   ) -> dict[str, torch.Tensor]:
    """Resolves every expected leaf through ``read`` -> the port's state
    dict (f32); strict on coverage, with the JAX tool's message."""
    state, missing, bad_shape = {}, [], []
    for e in parameter_spec(cfg):
        w = read(e)
        if w is None:
            missing.append(f"{e.layer}/{e.suffix}")
            continue
        w = np.asarray(w)
        if e.depthwise:  # keras (k, k, C, 1) -> flax (k, k, 1, C)
            w = w.transpose(0, 1, 3, 2)
        if tuple(w.shape) != e.shape:
            bad_shape.append(
                f"{e.layer}/{e.suffix}: got {tuple(w.shape)}, want {e.shape}")
            continue
        if w.ndim == 4:  # HWIO -> OIHW
            w = w.transpose(3, 2, 0, 1)
        state[e.name] = torch.from_numpy(np.array(w, np.float32))
    if missing or bad_shape:
        raise ValueError(
            "import_tf: incomplete import —\n  missing: "
            + (", ".join(missing) or "none")
            + "\n  shape mismatches: " + ("; ".join(bad_shape) or "none"))
    return state


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--keras-model", help="saved Keras model (.keras) with "
                     "the port's layer names")
    src.add_argument("--tf-ckpt", help="TF checkpoint prefix")
    p.add_argument("--name-map", default="",
                   help="JSON {our layer name: checkpoint scope}")
    p.add_argument("--output",
                   help="inference-artifact directory to write "
                        "(required unless --dry-run)")
    p.add_argument("--dry-run", action="store_true",
                   help="print the resolved mapping and exit")
    args = p.parse_args(argv)
    if not args.dry_run and not args.output:
        p.error("--output is required unless --dry-run")

    cfg = Config.load(args.config)
    name_map = {}
    if args.name_map:
        with open(args.name_map) as f:
            name_map = json.load(f)
    if args.dry_run:
        for e in parameter_spec(cfg):
            scope = name_map.get(e.layer, e.layer)
            print(f"{e.collection:11s} {'.'.join(e.path):55s} "
                  f"<- {scope}/{e.suffix} {e.shape}")
        return

    if args.keras_model:
        read = keras_reader(args.keras_model)
    else:
        if not glob.glob(args.tf_ckpt + ".index"):
            p.error(f"no checkpoint index {args.tf_ckpt}.index")
        read = checkpoint_reader(args.tf_ckpt, name_map or None)
    state = import_weights(cfg, read)
    from ssd_tpu_torch.export import save_inference_artifact

    save_inference_artifact(args.output, cfg, state)
    print(f"imported {len(state)} arrays -> {os.path.abspath(args.output)}")


if __name__ == "__main__":
    main()
