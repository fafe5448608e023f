"""Builds the CUDA sources under ``csrc/`` at first use and loads them.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for ``sm_90a`` into ``_kernels/<name>-<hash>.so`` beside this file (the
directory is listed in ``.gitignore``) and loaded with ``ctypes``. The hash
covers the source and the flags, so a changed source is rebuilt and an
unchanged one is reused; a source of the same name from another
directory (``csrc_dir``) builds beside it without collision. ``build_all``
starts one ``nvcc`` per source, all at once, and waits for them together.

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
_device_values: dict[tuple[str, str, int, int], int] = {}
# nvcc's output (with ptxas's report) per freshly built source: keyed by
# name for csrc/, by source path for another directory
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


def _source(name: str, csrc_dir: str = CSRC_DIR) -> str:
    path = os.path.join(csrc_dir, f"{name}.cu")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def target(name: str, csrc_dir: str = CSRC_DIR) -> str:
    """Path of the library built from ``<csrc_dir>/<name>.cu``."""
    h = hashlib.sha256()
    with open(_source(name, csrc_dir), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def build_all(names: list[str] | None = None,
              csrc_dir: str = CSRC_DIR) -> list[str]:
    """Compile every missing library in parallel; returns the names built.

    Each library is written to a temporary file and renamed into place, so
    a concurrent builder never sees a partial one.
    """
    names = sources() if names is None else names
    todo = [(n, target(n, csrc_dir)) for n in names
            if not os.path.exists(target(n, csrc_dir))]
    if not todo:
        return []
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name, out in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, _source(name, csrc_dir)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name if csrc_dir == CSRC_DIR
                   else _source(name, csrc_dir)] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
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
            _libs[name] = ctypes.CDLL(target(name))
        return _libs[name]


def device_query(name: str, query: str, index: int,
                 lib: ctypes.CDLL | None = None) -> int:
    """``csrc/<name>.cu``'s ``ssd_<name>_<query>(device, &out)`` for CUDA
    device ``index`` (a limit of the card, such as the largest problem a
    kernel takes), from ``lib`` (another build of the source) or the
    package's library: asked once per device and library, then cached, so
    a launch pays no ctypes call for it."""
    lib = load(name) if lib is None else lib
    key = (name, query, index, lib._handle)
    value = _device_values.get(key)
    if value is None:
        fn = getattr(lib, f"ssd_{name}_{query}")
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = ctypes.c_int(0)
        rc = fn(index, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"ssd_{name}_{query} failed: CUDA error {rc}")
        value = _device_values[key] = out.value
    return value


def ptxas_lines(log: str) -> list[str]:
    """The non-empty lines of an nvcc log: with ``-Xptxas -v``, each
    kernel's registers, shared memory, stack frame and spills."""
    return [line.strip() for line in log.splitlines() if line.strip()]
