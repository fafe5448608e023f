"""Anchor matching with the IoU reductions in a hand-written CUDA kernel.

Counterpart of ``ssd_tpu/ops/matching_pallas.py::match_anchors_pallas``.
``csrc/match.cu`` computes the per-anchor best gt and IoU and the per-gt
best anchor in one pass over each image's IoUs, four anchors a thread,
each warp skipping the gts that overlap none of its anchors; thresholds and
the forced match stay plain PyTorch (``ops.matching.finish_matches``),
shared with the plain version.

Dispatch follows the tensors' device. CUDA tensors launch the kernel, or
raise: there is no fallback. CPU tensors take the plain version,
``ops.matching.match_core``. None of the TPU kernel's layout is kept: no
2048-anchor lane blocks, no coordinate-major ``(4, A_pad)`` transpose, no
``(1, 1, BLK)`` output rows.

``launches`` counts the wrapper's launches (one call of the C entry point,
which runs the matching kernel and its key-unpacking kernel) in this
process; a caller resets it to 0 before a run it wants to account for.
"""

from __future__ import annotations

import ctypes

import torch

from ssd_tpu_torch import _build
from ssd_tpu_torch.config import MatcherConfig
from ssd_tpu_torch.ops import matching

launches = 0

# a key's starting value, "IoU +0 at anchor 0" (csrc/match.cu)
_ZERO_IOU_KEY = 0xFFFFFFFF
_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a library built from a ``match.cu``."""
    lib.ssd_match.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.ssd_match.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = bind(_build.load("match"))
        lib.ssd_match_listed.argtypes = (
            lib.ssd_match.argtypes[:10] + [ctypes.c_void_p]
            + lib.ssd_match.argtypes[10:])
        lib.ssd_match_listed.restype = ctypes.c_int
        _lib = lib
    return _lib


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


def _max_gts(device: torch.device) -> int:
    """Largest M whose gts fit one block's shared memory (``csrc/match.cu``
    lays it out)."""
    return _build.device_query("match", "max_gts", _index(device))


def _launch(lib: ctypes.CDLL | None, entry: str, anchors: torch.Tensor,
            gt_boxes: torch.Tensor, num_boxes: torch.Tensor,
            *counter: torch.Tensor):
    """Checks the inputs and calls ``entry`` of ``lib`` (the package's
    library by default): ``ssd_match``, or ``ssd_match_listed`` with its
    ``counter``."""
    global launches
    dev = anchors.device
    if dev.type != "cuda":
        raise ValueError(f"match_core_cuda needs CUDA tensors, got {dev}")
    n, m = gt_boxes.shape[:2]
    a = anchors.shape[0]
    for t, name, dtype, shape in ((anchors, "anchors", torch.float32, (a, 4)),
                                  (gt_boxes, "gt_boxes", torch.float32,
                                   (n, m, 4)),
                                  (num_boxes, "num_boxes", torch.int32, (n,))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if anchors.data_ptr() % 16 or gt_boxes.data_ptr() % 16:
        raise ValueError("anchors and gt_boxes must be 16-byte aligned "
                         "(read as float4)")
    if not 1 <= n <= 65535:
        raise ValueError(f"N={n} images must lie in [1, 65535]")
    limit = _max_gts(dev)
    if m > limit:
        raise ValueError(f"M={m} gts per image do not fit one block's shared "
                         f"memory: this card takes at most {limit}")
    best_gt = torch.empty((n, a), dtype=torch.int32, device=dev)
    best_iou = torch.empty((n, a), dtype=torch.float32, device=dev)
    best_anchor = torch.empty((n, m), dtype=torch.int32, device=dev)
    keys = torch.full((n, m), _ZERO_IOU_KEY, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib or _library(), entry)(
        ctypes.c_void_p(anchors.data_ptr()),
        ctypes.c_void_p(gt_boxes.data_ptr()),
        ctypes.c_void_p(num_boxes.data_ptr()), n, a, m,
        ctypes.c_void_p(best_gt.data_ptr()),
        ctypes.c_void_p(best_iou.data_ptr()),
        ctypes.c_void_p(keys.data_ptr()),
        ctypes.c_void_p(best_anchor.data_ptr()),
        *(ctypes.c_void_p(t.data_ptr()) for t in counter), _index(dev),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"match kernel launch failed: CUDA error {rc}")
    launches += 1
    return best_gt, best_iou, best_anchor


def match_core_cuda(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                    num_boxes: torch.Tensor, lib: ctypes.CDLL | None = None):
    """The kernel: ``(best_gt (N, A) int32, best_iou (N, A) f32,
    best_anchor (N, M) int32)``, as ``ops.matching.match_core``.

    ``anchors (A, 4)`` f32, ``gt_boxes (N, M, 4)`` f32 and ``num_boxes
    (N,)`` int32, all contiguous on one CUDA device. ``lib``: a library
    from another ``match.cu`` (``bind``) to launch instead of the package's.
    """
    return _launch(lib, "ssd_match", anchors, gt_boxes, num_boxes)


def listed_pairs(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                 num_boxes: torch.Tensor) -> int:
    """The (valid gt, anchor) pairs whose IoUs the kernel computes after
    its cull on these inputs, as the kernel counts them (one more launch,
    through ``ssd_match_listed``); arguments as ``match_core_cuda``'s."""
    listed = torch.zeros((), dtype=torch.int64, device=anchors.device)
    _launch(None, "ssd_match_listed", anchors, gt_boxes, num_boxes, listed)
    return int(listed)


def match_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  num_boxes: torch.Tensor,
                  cfg: MatcherConfig) -> torch.Tensor:
    """``ops.matching.match_anchors`` with the reductions in the kernel for
    CUDA tensors; the plain version for CPU tensors."""
    dev = anchors.device
    if dev.type == "cuda":
        core = match_core_cuda(
            anchors.float().contiguous(), gt_boxes.float().contiguous(),
            num_boxes.to(dev, torch.int32).contiguous())
    elif dev.type == "cpu":
        core = matching.match_core(anchors, gt_boxes, num_boxes)
    else:
        raise ValueError(f"unsupported device {dev}")
    return matching.finish_matches(*core, num_boxes.to(dev), cfg)
