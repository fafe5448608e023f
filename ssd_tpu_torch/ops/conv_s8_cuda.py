"""The int8 dense SAME conv as one hand-written CUDA kernel, K4
(``csrc/conv_s8.cu``): implicit GEMM s8 x s8 -> s32 on the tensor cores,
the activation quantize in its loads, the dequantize and bias in its
epilogue, no im2col.

It replaces no TPU kernel: the JAX package leaves its int8 convs to XLA's
``lax.conv`` (``ssd_tpu/models/layers.py`` ``_quantized_conv``). Its plain
version is the port's eager composition, ``models/layers.conv_s8_plain``
(``quantize_activation``, ``im2col_padded``, ``int_mm``, ``dequantize``),
which CPU tensors take; CUDA tensors launch the kernel, or raise: there is
no fallback. The function, on ``x`` an ``(N, C, H, W)`` view with any strides:

* bf16 ``x``: quantized with ``a = max(a_scale, 1e-8)`` (divided, or
  multiplied by ``reciprocal``, the static scale's), the product
  dequantized by ``a * k_scale`` plus ``bias`` and rounded once to bf16;
* s8 ``x`` (``layers.conv_int8``'s callers): taken as it is, the raw s32
  sums returned.

Padding is explicit and the output size given (``geometry``), so a height
strip (``parallel.spatial``) passes its halo'd rows with the whole map's
padding. The output is ``(N, Ho, Wo, O)`` contiguous.

Weights are prepared once per weight version (``prepare_weight``:
``layers.quantize_weight``, then ``pack_weight`` into the kernel's K-major
padded layout); ``preparations`` counts how many times, ``launches`` the
kernel's launches in this process (a caller resets either to 0 before a
run it wants to account for). ``conv_s8`` goes through the operator
``ssd_tpu_torch::conv_s8`` (``torch.library``), so that an exported int8
program (``export.py``) records it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ssd_tpu_torch import _build

launches = 0
preparations = 0

BK = 64           # bytes of K a weight K-block (csrc/conv_s8.cu kBK)
MAX_KERNEL = 7    # the largest kh, kw taken
PATCH_LIMIT = 64 * 1024  # bytes of a block's input patch
# (TH, TW) output tiles of 128 pixels (the kernel's block); the first of
# the least padded wins
TILE_SHAPES = ((8, 16), (16, 8), (4, 32), (2, 64), (1, 128))
# geometry: out_ch, in_ch, kh, kw, stride, pad_top, pad_bottom, pad_left,
# pad_right, out_h, out_w
GEOMETRY = ("out_ch", "in_ch", "kh", "kw", "stride", "pad_top",
            "pad_bottom", "pad_left", "pad_right", "out_h", "out_w")

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a library built from a ``conv_s8.cu``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_conv_s8.argtypes = (
        [p, i, ll, ll, ll, ll, i, i, i, i, p, ll] + [i] * 15
        + [p] * 5 + [i, p])
    lib.ssd_conv_s8.restype = ctypes.c_int
    lib.ssd_conv_s8_smem_bytes.argtypes = [i] * 4
    lib.ssd_conv_s8_smem_bytes.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(_build.load("conv_s8"))
    return _lib


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index



# ------------------------------------------------------------ weight layout

def tile_n(o: int) -> int:
    """Output channels a block: 32, 64 or 128 by ``o``."""
    return 32 if o <= 32 else 64 if o <= 64 else 128


def chunk_bytes(c: int) -> int:
    """Bytes of one channel chunk of the input patch: the least of 16, 32
    and 64 that holds ``c``, else 64."""
    return 16 if c <= 16 else 32 if c <= 32 else 64


def weight_layout(o: int, c: int, kh: int, kw: int) -> tuple:
    """-> ``(o_pad, ck, chunks, kblocks)``: rows rounded up to the tile
    width, chunk bytes, chunks of the channels, 64-byte K-blocks a chunk."""
    ck = chunk_bytes(c)
    return (-(-o // tile_n(o)) * tile_n(o), ck, -(-c // ck),
            -(-(kh * kw * ck) // BK))


def pack_weight(k_q: torch.Tensor) -> torch.Tensor:
    """s8 OIHW ``k_q`` -> the kernel's layout, ``(o_pad, chunks * kblocks *
    64)`` s8: chunk ``j``'s byte ``t * ck + cc`` holds ``k_q[o, j * ck + cc,
    dy, dx]`` (tap ``t = dy * kw + dx``), zero past C, the taps and O."""
    o, c, kh, kw = k_q.shape
    o_pad, ck, chunks, kblocks = weight_layout(o, c, kh, kw)
    w = k_q.permute(0, 2, 3, 1).reshape(o, kh * kw, c)
    w = F.pad(w, (0, chunks * ck - c)).reshape(o, kh * kw, chunks, ck)
    w = w.permute(0, 2, 1, 3).reshape(o, chunks, kh * kw * ck)
    w = F.pad(w, (0, kblocks * BK - kh * kw * ck, 0, 0, 0, o_pad - o))
    return w.reshape(o_pad, chunks * kblocks * BK).contiguous()


def unpack_weight(w: torch.Tensor, o: int, c: int, kh: int,
                  kw: int) -> torch.Tensor:
    """``pack_weight``'s inverse as the im2col's weights: ``(o, kh * kw *
    c)`` s8, ``k_q[o, i, dy, dx]`` in column ``(dy * kw + dx) * c + i``."""
    o_pad, ck, chunks, kblocks = weight_layout(o, c, kh, kw)
    w = w.reshape(o_pad, chunks, kblocks * BK)[:o, :, :kh * kw * ck]
    w = w.reshape(o, chunks, kh * kw, ck).permute(0, 2, 1, 3)
    return w.reshape(o, kh * kw, chunks * ck)[:, :, :c].reshape(o, -1)


def prepare_weight(weight: torch.Tensor) -> tuple:
    """f32 OIHW weight -> ``(packed k_q, k_scale (O,) f32)``:
    ``layers.quantize_weight``, then ``pack_weight``. Counted in
    ``preparations``."""
    global preparations
    from ssd_tpu_torch.models.layers import quantize_weight
    k_q, k_scale = quantize_weight(weight)
    preparations += 1
    return pack_weight(k_q), k_scale


# ------------------------------------------------------------------ tiles

def plan(ho: int, wo: int, kh: int, kw: int, stride: int,
         ck: int) -> tuple[int, int]:
    """The output tile ``(TH, TW)`` for an ``ho x wo`` map: of
    ``TILE_SHAPES``, those whose input patch fits ``PATCH_LIMIT``, the one
    with the fewest tiles, then the smallest patch."""
    best = None
    for th, tw in TILE_SHAPES:
        patch = ((th - 1) * stride + kh) * ((tw - 1) * stride + kw)
        if patch * ck > PATCH_LIMIT:
            continue
        key = (-(-ho // th) * -(-wo // tw), patch)
        if best is None or key < best[0]:
            best = (key, (th, tw))
    if best is None:
        raise ValueError(f"a {kh}x{kw} stride-{stride} conv's input patch "
                         f"does not fit {PATCH_LIMIT} bytes of shared memory")
    return best[1]


# ----------------------------------------------------------------- checks

def _check_vector(t, name: str, n: int, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != (n,) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({n},) tensor, got "
                         f"shape {tuple(t.shape)}")


def _check_scalar(t, name: str, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != torch.float32 or t.dim() != 0:
        raise TypeError(f"{name} must be a 0-dim float32 tensor, got "
                        f"{t.dtype} of shape {tuple(t.shape)}")


def check_args(x: torch.Tensor, w: torch.Tensor, geometry: list,
               k_scale, bias, a_scale, reciprocal) -> dict:
    """Raise on what neither version takes; returns the geometry by name."""
    if len(geometry) != len(GEOMETRY):
        raise ValueError(f"geometry has {len(geometry)} values, expected "
                         f"{len(GEOMETRY)}: {', '.join(GEOMETRY)}")
    g = dict(zip(GEOMETRY, (int(v) for v in geometry)))
    if x.dim() != 4:
        raise ValueError(f"x must be an (N, C, H, W) view, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"x has dtype {x.dtype}: the conv takes bfloat16 "
                        "(quantized in the load) or int8")
    if x.shape[1] != g["in_ch"]:
        raise ValueError(f"x has {x.shape[1]} channels, the weights "
                         f"{g['in_ch']}")
    if not (1 <= g["kh"] <= MAX_KERNEL and 1 <= g["kw"] <= MAX_KERNEL
            and g["stride"] >= 1 and g["out_ch"] >= 1):
        raise ValueError(f"kernel {g['kh']}x{g['kw']}, stride {g['stride']}, "
                         f"{g['out_ch']} outputs: the conv takes kernels up "
                         f"to {MAX_KERNEL}x{MAX_KERNEL}")
    if min(g["pad_top"], g["pad_bottom"], g["pad_left"], g["pad_right"],
           g["out_h"], g["out_w"]) < 0:
        raise ValueError(f"negative padding or output size: {g}")
    for out, k, pad0, pad1, size in (
            (g["out_h"], g["kh"], g["pad_top"], g["pad_bottom"], x.shape[2]),
            (g["out_w"], g["kw"], g["pad_left"], g["pad_right"], x.shape[3])):
        if out and (out - 1) * g["stride"] + k > pad0 + size + pad1:
            raise ValueError(f"{out} outputs of a {k}-tap stride-"
                             f"{g['stride']} window read past {size} inputs "
                             f"padded ({pad0}, {pad1})")
    o_pad, _, chunks, kblocks = weight_layout(g["out_ch"], g["in_ch"],
                                              g["kh"], g["kw"])
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if w.dtype != torch.int8:
        raise TypeError(f"w has dtype {w.dtype}, expected torch.int8")
    if tuple(w.shape) != (o_pad, chunks * kblocks * BK) or \
            not w.is_contiguous():
        raise ValueError(f"w must be the contiguous packed layout "
                         f"{(o_pad, chunks * kblocks * BK)} (pack_weight), "
                         f"got {tuple(w.shape)}")
    if x.dtype == torch.int8:
        if any(t is not None for t in (k_scale, bias, a_scale, reciprocal)):
            raise ValueError("an int8 x gives the raw s32 sums: no scales "
                             "or bias")
    else:
        if a_scale is None or k_scale is None:
            raise ValueError("a bfloat16 x needs a_scale and k_scale")
        _check_scalar(a_scale, "a_scale", x.device)
        if reciprocal is not None:
            _check_scalar(reciprocal, "reciprocal", x.device)
        _check_vector(k_scale, "k_scale", g["out_ch"], x.device)
        if bias is not None:
            _check_vector(bias, "bias", g["out_ch"], x.device)
    return g


def _output(x: torch.Tensor, g: dict) -> torch.Tensor:
    dtype = torch.int32 if x.dtype == torch.int8 else torch.bfloat16
    return torch.empty((x.shape[0], g["out_h"], g["out_w"], g["out_ch"]),
                       dtype=dtype, device=x.device)


# ----------------------------------------------------------------- kernel

_plans: dict = {}  # a call's signature -> its launch's fixed arguments
_PLANS_MAX = 4096


def _signature(x, w, geometry, optional, lib) -> tuple:
    """What the checks and the launch plan depend on: shapes, strides,
    types and devices (the alignment of ``x``'s data), the geometry."""
    return (x.shape, x.stride(), x.dtype, x.device, x.data_ptr() % 16,
            w.shape, w.stride(), w.dtype, w.device, tuple(geometry),
            tuple(None if t is None else (t.shape, t.stride(), t.dtype,
                                          t.device) for t in optional),
            None if lib is None else lib._handle)


def _plan_launch(x, w, geometry, k_scale, bias, a_scale, reciprocal,
                 lib) -> tuple:
    """Checks the call, then its launch's fixed arguments: ``(output
    shape, output dtype, the C interface's integer arguments before and
    after the weights)`` (``None`` arguments for an empty output)."""
    g = check_args(x, w, geometry, k_scale, bias, a_scale, reciprocal)
    dtype = torch.int32 if x.dtype == torch.int8 else torch.bfloat16
    shape = (x.shape[0], g["out_h"], g["out_w"], g["out_ch"])
    if 0 in shape:
        return shape, dtype, None, None
    n, c, h, wd = x.shape
    sn, sc, sh, sw = x.stride()
    kh, kw, s = g["kh"], g["kw"], g["stride"]
    ho, wo = g["out_h"], g["out_w"]
    if kh == kw == s == 1 and sh == wd * sw:
        # a 1x1 stride-1 conv reads each pixel alone: one row of pixels
        if sn == h * sh:
            n, wd, sn = 1, n * h * wd, 0
        else:
            wd *= h
        h, sh, ho, wo = 1, 0, 1, wd
    _, ck, chunks, kblocks = weight_layout(g["out_ch"], c, kh, kw)
    th, tw = plan(ho, wo, kh, kw, s, ck)
    bn = tile_n(g["out_ch"])
    esize = x.element_size()
    vec = int(sc == 1 and x.data_ptr() % 16 == 0 and all(
        v * esize % 16 == 0 for v in (c, sn, sh, sw)))
    index = _index(x.device)
    limit = _build.device_query("conv_s8", "smem_limit", index, lib=lib)
    ph, pw = (th - 1) * s + kh, (tw - 1) * s + kw
    need = _library().ssd_conv_s8_smem_bytes(ph, pw, ck, bn)
    if need > limit:
        raise ValueError(f"a {th}x{tw} tile of a {kh}x{kw} stride-{s} conv "
                         f"needs {need} bytes of shared memory a block; this "
                         f"card allows {limit}")
    before = (int(x.dtype == torch.int8), sn, sc, sh, sw, n, c, h, wd)
    after = (w.shape[1], g["out_ch"], bn, kh, kw, s, g["pad_top"],
             g["pad_left"], ho, wo, ck, chunks, kblocks, th,
             tw.bit_length() - 1, vec)
    return shape, dtype, before, (after, index)


def conv_s8_cuda(x: torch.Tensor, w: torch.Tensor, geometry: list,
                 k_scale=None, bias=None, a_scale=None, reciprocal=None,
                 lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """The kernel, on CUDA tensors only (arguments as ``conv_s8``). ``lib``:
    a library from another ``conv_s8.cu`` with the same C interface
    (``bind``) to launch instead of the package's. A call's checks and
    launch plan are kept by its signature (``_signature``), so a repeated
    shape pays neither again."""
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"conv_s8_cuda needs CUDA tensors, got {dev}")
    optional = (k_scale, bias, a_scale, reciprocal)
    key = _signature(x, w, geometry, optional, lib)
    planned = _plans.get(key)
    if planned is None:
        planned = _plan_launch(x, w, geometry, *optional, lib)
        if len(_plans) >= _PLANS_MAX:
            _plans.clear()
        _plans[key] = planned
    shape, dtype, before, after = planned
    out = torch.empty(shape, dtype=dtype, device=dev)
    if before is None:
        return out
    ints, index = after

    def ptr(t):
        return None if t is None else ctypes.c_void_p(t.data_ptr())

    rc = (lib or _library()).ssd_conv_s8(
        ptr(x), *before, ptr(w), *ints, ptr(a_scale), ptr(reciprocal),
        ptr(k_scale), ptr(bias), ptr(out), index,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"conv_s8 kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


# --------------------------------------------------------------- operator

@torch.library.custom_op("ssd_tpu_torch::conv_s8", mutates_args=(),
                         device_types="cpu")
def conv_s8_op(x: torch.Tensor, w: torch.Tensor, geometry: list[int],
               k_scale: torch.Tensor | None, bias: torch.Tensor | None,
               a_scale: torch.Tensor | None,
               reciprocal: torch.Tensor | None) -> torch.Tensor:
    """The conv as one operator, so that ``torch.export`` records it as a
    call (it cannot trace the kernel's ctypes launch): on CPU tensors the
    plain version, on CUDA tensors the kernel, which launches or raises.
    Loading an exported program needs this module imported."""
    from ssd_tpu_torch.models import layers
    check_args(x, w, geometry, k_scale, bias, a_scale, reciprocal)
    return layers.conv_s8_plain(x, w, geometry, k_scale, bias, a_scale,
                                reciprocal)


@conv_s8_op.register_kernel("cuda")
def _conv_s8_op_cuda(x, w, geometry, k_scale, bias, a_scale, reciprocal):
    return conv_s8_cuda(x, w, geometry, k_scale, bias, a_scale, reciprocal)


@conv_s8_op.register_fake
def _conv_s8_op_fake(x, w, geometry, k_scale, bias, a_scale, reciprocal):
    return _output(x, dict(zip(GEOMETRY, geometry)))


def conv_s8(x: torch.Tensor, w: torch.Tensor, geometry: list,
            k_scale: torch.Tensor | None = None,
            bias: torch.Tensor | None = None,
            a_scale: torch.Tensor | None = None,
            reciprocal: torch.Tensor | None = None) -> torch.Tensor:
    """SAME-padded int8 conv -> ``(N, Ho, Wo, O)``: the kernel for CUDA
    tensors, the plain version for CPU tensors, through the operator
    ``ssd_tpu_torch::conv_s8``. ``x (N, C, H, W)`` bf16 or s8 (any
    strides); ``w`` from ``pack_weight``; ``geometry`` the ``GEOMETRY``
    ints; for a bf16 ``x``, ``a_scale`` (0-dim, floored at 1e-8 inside),
    ``reciprocal`` (0-dim, the static scale's: multiply instead of divide)
    or None, ``k_scale (O,)`` and ``bias (O,)`` or None, all f32."""
    if x.device.type not in ("cuda", "cpu", "meta"):  # meta: shapes alone
        raise ValueError(f"unsupported device {x.device}")
    return conv_s8_op(x, w, [int(v) for v in geometry], k_scale, bias,
                      a_scale, reciprocal)
