"""Device selection and numeric precision, in one place.

Entry points (``Detector``, ``Predictor``, the model builders) run on the
card: ``device=None`` means ``"cuda"``, and that raises where no GPU is
present. They run on the CPU only when the caller passes ``device="cpu"``.

TF32 is off for convolutions and matrix products. The folded dense4 stem
subtracts a border-correction map from a conv result of comparable
magnitude, and every IoU compares against a threshold: both need full f32.
(On the TPU, truncating box coordinates to bf16 flipped suppressions;
TF32 keeps about the same number of mantissa bits.)
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises if a CUDA device is asked for and absent.
    Also sets the precision flags: full f32 for every f32 conv and matrix
    product on the card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ssd_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
