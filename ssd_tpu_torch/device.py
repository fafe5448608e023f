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

import itertools

import torch

STAGING_WAIT = "staging.wait"  # the span of a staging buffer's wait


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


class PinnedStaging:
    """Pinned host buffers for asynchronous uploads to the card.

    A copy from pageable memory waits for the stream; one from a pinned
    buffer with ``non_blocking=True`` does not, but the buffer must not be
    refilled before the copy has left it. Each (shape, dtype) gets
    ``depth`` buffers in turn (at least the uploads in flight plus one),
    allocated at its first use, each with the event recorded behind its
    last upload. The wait on that event runs under the span
    ``STAGING_WAIT``, so that a profile tells it from other waits.
    """

    def __init__(self, depth: int = 3):
        self.depth = depth
        self._rings: dict[tuple, itertools.cycle] = {}

    def take(self, shape: tuple, dtype: torch.dtype
             ) -> tuple[torch.Tensor, torch.cuda.Event]:
        """The next buffer of ``shape`` and ``dtype`` and its event, once
        the upload last issued from it has left it."""
        key = (tuple(shape), dtype)
        if key not in self._rings:
            self._rings[key] = itertools.cycle([
                (torch.empty(shape, dtype=dtype, pin_memory=True),
                 torch.cuda.Event()) for _ in range(self.depth)])
        buf, event = next(self._rings[key])
        with torch.profiler.record_function(STAGING_WAIT):
            event.synchronize()
        return buf, event

    @staticmethod
    def upload(buf: torch.Tensor, event: torch.cuda.Event,
               device: torch.device) -> torch.Tensor:
        """``buf`` on ``device`` without waiting; ``event`` marks the end
        of the copy, so ``take`` hands ``buf`` out again only after it."""
        out = buf.to(device, non_blocking=True)
        event.record()
        return out

    @staticmethod
    def upload_rows(buf: torch.Tensor, event: torch.cuda.Event,
                    devices: list, bounds: list) -> list:
        """Row blocks ``buf[lo:hi]`` (``bounds``), each on its device,
        without waiting; the first device's stream then waits for the
        others' copies and records ``event``, so that it marks the end of
        every copy."""
        outs, copied = [], []
        for dev, (lo, hi) in zip(devices, bounds):
            with torch.cuda.device(dev):
                outs.append(buf[lo:hi].to(dev, non_blocking=True))
                if dev != devices[0]:
                    done = torch.cuda.Event()
                    done.record()
                    copied.append(done)
        with torch.cuda.device(devices[0]):
            for done in copied:
                torch.cuda.current_stream().wait_event(done)
            event.record()
        return outs
