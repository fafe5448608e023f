"""ds1 + ds2 of the reference MobileNet-v1 schedule in a hand-written CUDA
kernel.

Counterpart of ``ssd_tpu/ops/fused_early.py::fused_ds1_ds2``.
``csrc/fused_early.cu`` computes the four convs of the two blocks with batch
norm folded (``ops.fused_early.fold_early_params``) in one pass, the
intermediates in shared memory: the depthwise convs in f32 on the CUDA
cores, the pointwise ones on the tensor cores from bf16 operands with f32
sums, rounding where ``ops/fused_early.py`` says.

Dispatch follows the tensors' device. CUDA tensors launch the kernel, or
raise: there is no fallback. CPU tensors take the plain version,
``ops.fused_early.fused_ds1_ds2_plain``. Both take ``x (N, C1, H, W)`` bf16
in ``channels_last`` memory (the port's activations after the stem; its
bytes are NHWC) with H and W even and C1, C2, C3 multiples of 8 (the
widths MobileNet's ``_width`` gives), and return ``(N, C3, H/2, W/2)`` bf16
in ``channels_last``. Nothing on the kernel's path makes an NCHW copy.

``launches`` counts the wrapper's kernel launches in this process; a caller
resets it to 0 before a run it wants to account for.
"""

from __future__ import annotations

import ctypes

import torch

from ssd_tpu_torch import _build
from ssd_tpu_torch.ops.fused_early import FOLDED_KEYS, fused_ds1_ds2_plain

launches = 0

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a library built from a
    ``fused_early.cu``."""
    lib.ssd_fused_early.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.ssd_fused_early.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = bind(_build.load("fused_early"))
        lib.ssd_fused_early_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ssd_fused_early_smem_bytes.restype = ctypes.c_long
        _lib = lib
    return _lib


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


def check_inputs(x: torch.Tensor, folded: dict) -> tuple[int, int, int]:
    """Raise on what neither version takes; returns ``(C1, C2, C3)``."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C1, H, W), got shape {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x has dtype {x.dtype}, expected torch.bfloat16")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be contiguous in channels_last memory")
    n, c1, h, w = x.shape
    if n < 1 or h < 2 or w < 2 or h % 2 or w % 2:
        raise ValueError(f"N={n}, H={h}, W={w}: need N >= 1 and even H, W")
    c2 = folded["pw1_k"].shape[1]
    c3 = folded["pw2_k"].shape[1]
    if c1 % 8 or c2 % 8 or c3 % 8:
        raise ValueError(f"C1={c1}, C2={c2}, C3={c3}: each must be a "
                         "multiple of 8")
    shapes = {"dw1_k": (c1, 3, 3), "dw1_b": (c1,), "pw1_k": (c1, c2),
              "pw1_b": (c2,), "dw2_k": (c2, 3, 3), "dw2_b": (c2,),
              "pw2_k": (c2, c3), "pw2_b": (c3,)}
    for key in FOLDED_KEYS:
        t = folded[key]
        if t.device != x.device:
            raise ValueError(f"{key} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{key} has dtype {t.dtype}, expected float32")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{key} has shape {tuple(t.shape)}, expected "
                             f"{shapes[key]} for C1={c1}")
        if not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous")
    return c1, c2, c3


def fused_ds1_ds2_cuda(x: torch.Tensor, folded: dict,
                       lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """The kernel, on CUDA tensors only. ``lib``: a library from another
    ``fused_early.cu`` with the same C interface (``bind``) to launch
    instead of the package's."""
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_ds1_ds2_cuda needs CUDA tensors, got {dev}")
    c1, c2, c3 = check_inputs(x, folded)
    n, _, h, w = x.shape
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (copied 8 channels at "
                         "a time)")
    if n * -(-h // 16) * -(-w // 16) >= 2 ** 31:
        raise ValueError(f"N={n}, H={h}, W={w}: too many tiles of 8 x 8 "
                         "outputs for one launch")
    index = _index(dev)
    # the package's kernel's need, which bounds another build's (same
    # design, or the older one that needs less)
    need = _library().ssd_fused_early_smem_bytes(c1, c2, c3)
    limit = _build.device_query("fused_early", "smem_limit", index, lib=lib)
    if need > limit:
        raise ValueError(f"C1={c1}, C2={c2}, C3={c3} need {need} bytes of "
                         f"shared memory a block; this card allows {limit}")
    out = torch.empty((n, c3, h // 2, w // 2), dtype=torch.bfloat16,
                      device=dev, memory_format=torch.channels_last)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [ctypes.c_void_p(t.data_ptr())
            for t in (x, *(folded[k] for k in FOLDED_KEYS), out)]
    rc = (lib or _library()).ssd_fused_early(
        *ptrs, n, h, w, c1, c2, c3, index, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_early kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def fused_ds1_ds2(x: torch.Tensor, folded: dict) -> torch.Tensor:
    """ds1 + ds2 on the folded operands: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if x.device.type == "cuda":
        return fused_ds1_ds2_cuda(x, folded)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    check_inputs(x, folded)
    return fused_ds1_ds2_plain(x, folded)
