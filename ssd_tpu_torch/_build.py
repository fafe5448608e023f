"""Builds the CUDA sources under ``csrc/`` at first use and loads them.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for ``sm_90a`` into ``_kernels/<name>-<hash>.so`` beside this file (the
directory is listed in ``.gitignore``) and loaded with ``ctypes``. The hash
covers the source and the flags, so a changed source is rebuilt and an
unchanged one is reused. ``build_all`` starts one ``nvcc`` per source, all
at once, and waits for them together.

Nothing here runs at import: this module imports on a machine without
``nvcc`` or a GPU, and fails only when a kernel is asked for.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_kernels")

# -fmad=false: no FMA contraction anywhere, so the kernels round every f32
# op as PyTorch's separate elementwise ops do (the NMS kernel also spells
# its IoU with _rn intrinsics). No fast math; IEEE division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) per freshly built source
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "ssd_tpu_torch are built from csrc/ on the machine with the card")


def _source(name: str) -> str:
    path = os.path.join(CSRC_DIR, f"{name}.cu")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def _target(name: str) -> str:
    h = hashlib.sha256()
    with open(_source(name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def build_all(names: list[str] | None = None) -> list[str]:
    """Compile every missing library in parallel; returns the names built.

    Each library is written to a temporary file and renamed into place, so
    a concurrent builder never sees a partial one.
    """
    names = sources() if names is None else names
    todo = [(n, _target(n)) for n in names if not os.path.exists(_target(n))]
    if not todo:
        return []
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name, target in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, _source(name)]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, target, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            os.unlink(tmp)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return [n for n, _ in todo]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            build_all([name])
            _libs[name] = ctypes.CDLL(_target(name))
        return _libs[name]
