"""The plain references, one module a family of architectures, and the one
lookup that finds a configuration's.

A configuration file (``bench_port/configs/<config>.json``) names its
reference under ``reference``: a module ``bench_port/reference/<name>.py``,
by default ``model``. That module exports

* ``Model(cfg, params, quant=None)``: the network over a params dict, with
  ``training``, ``group`` (a process group over which train-mode batch
  norm takes its statistics, or ``None``), ``features(images, run=None)``
  (the backbone's taps; ``run(fn, *args)`` is how each block is called,
  an activation checkpoint in training), ``fpn``, ``level`` and
  ``__call__`` (images -> per-level raw maps);
* ``param_shapes(cfg)``: state-dict name -> shape;
* optionally ``wgrad_excess(params, cfg, batch)``: the FLOPs that
  ``FlopCounterMode`` over-counts in its grouped convs' weight gradients;
* optionally ``seed_means(cfg)``: state-dict name -> the value that a
  parameter which is neither a 4-d kernel nor a ``.bn.`` norm vector
  starts from in its source (a fusion weight's 1, say), which
  ``weights.seeded_state`` draws it around; every other such parameter is
  seeded as a zero bias (the class head's as the mix's class bias).

A new architecture joins with a module of its own and a configuration
that names it; no file here needs an edit.
"""

from __future__ import annotations

import importlib
import os
import re

DEFAULT = "model"
_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def for_config(conf: dict):
    """The reference module of ``conf`` (a configuration file's object):
    the module its ``reference`` key names, ``model`` without one. A name
    that is no module here raises at once, naming the key."""
    name = conf.get("reference", DEFAULT)
    here = os.path.dirname(os.path.abspath(__file__))
    mod = None
    if (isinstance(name, str) and _NAME.match(name) and name != "__init__"
            and os.path.exists(os.path.join(here, name + ".py"))):
        mod = importlib.import_module(f"{__name__}.{name}")
    if not (hasattr(mod, "Model") and hasattr(mod, "param_shapes")):
        raise ValueError(
            f"configuration {conf.get('name')!r}: its 'reference' key names "
            f"{name!r}, which is no reference module under "
            "bench_port/reference/ (one with Model and param_shapes)")
    return mod
