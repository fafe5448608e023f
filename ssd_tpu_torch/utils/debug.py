"""Numerics checks for debugging (the port's ``ssd_tpu/utils/debug.py``).

* ``checked(fn)``: calls ``fn``, then raises ``FloatingPointError`` naming
  the first non-finite floating leaf of its outputs: the counterpart of
  checkify's NaN/Inf check. An out-of-range index needs no check here: it
  already raises in torch (on the card as a device-side assert).
* ``assert_all_finite(tree, name)``: a host-side sweep over nested dicts,
  lists, tuples and tensors (metrics, parameters, a state dict), one read
  of all the leaves' flags.
* ``disable_jit()``: a context manager that does nothing. Eager PyTorch
  compiles nothing, so every op already runs as it is called and a
  debugger can step through it; it is kept so that code written for the
  JAX package's helper runs unchanged.

The port's one aliasing rule, in place of the JAX package's donated
``TrainState``: the training step updates the model's parameters, the
optimizer's moments and the EMA in place (``train_step.make_train_step``),
so a tensor taken from the state before a step holds the values after it.
Clone what must be kept.
"""

from __future__ import annotations

import contextlib
from collections.abc import Mapping

import numpy as np
import torch


def _leaves(tree, path: str = ""):
    """``(path, leaf)`` of every tensor or array in nested containers,
    in order; paths as ``['a'][0]``."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(tree, (torch.Tensor, np.ndarray, float)):
        yield path, tree


def _floating(tree) -> list[tuple[str, torch.Tensor]]:
    out = []
    for path, leaf in _leaves(tree):
        t = torch.as_tensor(leaf)
        if t.is_floating_point() or t.is_complex():
            out.append((path, t.detach()))
    return out


def _first_bad(tree, name: str) -> str | None:
    """The message for the first non-finite floating leaf, or ``None``.
    Each leaf's count is computed where it lives; the counts come back in
    one copy a device."""
    leaves = _floating(tree)
    if not leaves:
        return None
    by_device: dict = {}
    for i, (_, t) in enumerate(leaves):
        by_device.setdefault(t.device, []).append(i)
    bads = [0] * len(leaves)
    for dev, idx in by_device.items():
        counts = torch.stack([(~torch.isfinite(leaves[i][1])).sum()
                              for i in idx]).tolist()
        for i, c in zip(idx, counts):
            bads[i] = c
    for (path, t), bad in zip(leaves, bads):
        if bad:
            return (f"non-finite values in {name}{path}: {bad} bad of "
                    f"{t.numel()}")
    return None


def checked(fn):
    """``fn`` wrapped so that a NaN or Inf in its outputs raises
    ``FloatingPointError`` on the host. Debug only: it reads the outputs'
    flags back after every call."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        msg = _first_bad(out, getattr(fn, "__name__", "output"))
        if msg:
            raise FloatingPointError(msg)
        return out

    return wrapper


def assert_all_finite(tree, name: str = "tree") -> None:
    msg = _first_bad(tree, name)
    if msg:
        raise FloatingPointError(msg)


@contextlib.contextmanager
def disable_jit():
    """Does nothing: eager PyTorch compiles nothing (the module docstring)."""
    yield
