"""Class-wise greedy NMS with the suppression in a hand-written CUDA kernel.

Counterpart of ``ssd_tpu/ops/nms_pallas.py::batched_nms_pallas``. The
per-class top-k and the class merge are ordinary PyTorch (``ops/nms.py``);
the suppression scan runs in ``csrc/nms.cu``: one warp per (image, class)
problem, its K boxes gathered by index into the warp's slice of shared
memory, its keep flags one 32-bit word per 32 candidates.

Dispatch follows the tensors' device. CUDA tensors launch the kernel, or
raise: there is no fallback. CPU tensors take the plain version,
``ops.nms.suppress``. Neither the TPU kernel's K padding to 128 nor its
activity sort is needed: the kernel takes any K whose boxes fit in shared
memory, and an empty problem exits on its own.

``suppress`` goes through the operator ``ssd_tpu_torch::nms_suppress``
(``torch.library``), so that an exported predict program (``export.py``)
calls the kernel as eager PyTorch does. ``launches`` counts the kernel's
launches in this process, from a loaded program's too; a caller resets it
to 0 before a run it wants to account for.
"""

from __future__ import annotations

import ctypes

import torch

from ssd_tpu_torch import _build
from ssd_tpu_torch.config import NMSConfig
from ssd_tpu_torch.ops import nms
from ssd_tpu_torch.ops.nms import Detections

launches = 0

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a library built from an ``nms.cu``."""
    lib.ssd_nms_suppress.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.ssd_nms_suppress.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(_build.load("nms"))
    return _lib


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _max_k(device: torch.device) -> int:
    """Largest K the kernel takes on ``device``: one problem's candidates
    in one block's shared memory (``csrc/nms.cu`` lays it out)."""
    return _build.device_query("nms", "max_k", _index(device))


def suppress_cuda(boxes: torch.Tensor, top_idx: torch.Tensor,
                  top_scores: torch.Tensor, iou_threshold: float,
                  lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """The kernel: kept scores ``(N, C, K)`` f32, -1 for dropped or invalid.

    ``boxes (N, Q, 4)`` f32; ``top_idx (N, C, K)`` int32 in ``[0, Q)`` (not
    range-checked: that would wait for the device; ``class_topk`` produces
    it); ``top_scores (N, C, K)`` f32 sorted descending per problem.
    ``lib``: a library from another ``nms.cu`` (``bind``) to launch
    instead of the package's.
    """
    global launches
    if boxes.device.type != "cuda":
        raise ValueError(f"suppress_cuda needs CUDA tensors, got {boxes.device}")
    n, q, _ = boxes.shape
    _, c, k = top_idx.shape
    dev = boxes.device
    _check(boxes, "boxes", torch.float32, (n, q, 4), dev)
    _check(top_idx, "top_idx", torch.int32, (n, c, k), dev)
    _check(top_scores, "top_scores", torch.float32, (n, c, k), dev)
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (read as float4)")
    if not 1 <= k <= q:
        raise ValueError(f"K={k} must lie in [1, Q={q}]")
    limit = _max_k(dev)
    if k > limit:
        raise ValueError(
            f"K={k} candidates per problem do not fit one block's shared "
            f"memory: this card takes at most {limit}")
    out = torch.empty_like(top_scores)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = (lib or _library()).ssd_nms_suppress(
        ctypes.c_void_p(boxes.data_ptr()),
        ctypes.c_void_p(top_idx.data_ptr()),
        ctypes.c_void_p(top_scores.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), n * c, c, q, k,
        ctypes.c_float(nms.f32(iou_threshold)), _index(dev),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"nms kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


@torch.library.custom_op("ssd_tpu_torch::nms_suppress", mutates_args=(),
                         device_types="cpu")
def nms_suppress(boxes: torch.Tensor, top_idx: torch.Tensor,
                 top_scores: torch.Tensor,
                 iou_threshold: float) -> torch.Tensor:
    """The suppression as one operator, so that ``torch.export`` records it
    as a call (it cannot trace the kernel's ctypes launch): on CPU tensors
    the plain version, on CUDA tensors the kernel, which launches or
    raises. Loading an exported program needs this module imported."""
    return nms.suppress(boxes, top_idx, top_scores, iou_threshold)


@nms_suppress.register_kernel("cuda")
def _nms_suppress_cuda(boxes, top_idx, top_scores, iou_threshold):
    return suppress_cuda(boxes, top_idx, top_scores, iou_threshold)


@nms_suppress.register_fake
def _nms_suppress_fake(boxes, top_idx, top_scores, iou_threshold):
    return torch.empty_like(top_scores)


def suppress(boxes: torch.Tensor, top_idx: torch.Tensor,
             top_scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors, through the
    operator ``ssd_tpu_torch::nms_suppress``."""
    if boxes.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {boxes.device}")
    return nms_suppress(boxes, top_idx, top_scores, float(iou_threshold))


def batched_nms_cuda(boxes: torch.Tensor, scores: torch.Tensor,
                     cfg: NMSConfig) -> Detections:
    """``ops.nms.batched_nms`` with the suppression in the kernel.

    ``boxes (N, Q, 4)`` decoded and clipped, ``scores (N, Q, C)``
    post-sigmoid, both f32.
    """
    if cfg.method != "hard":
        raise NotImplementedError(
            f"nms.method={cfg.method!r}: only 'hard' is ported")
    boxes = boxes.float().contiguous()
    top_scores, top_idx = nms.class_topk(scores.float(), cfg)
    kept = suppress(boxes, top_idx, top_scores, cfg.iou_threshold)
    return nms.merge_classes_lazy(boxes, top_idx, kept, cfg)
