"""The height split: each image's rows over the model axis of a data row,
the halo exchange written out (the port's counterpart of GSPMD's spatial
partitioning under ``P("data", "model")`` in the JAX package's
``Predictor(spatial_shard=True)`` and ``StreamingDetector``).

An image batch is cut into ``m`` strips of ``H / m`` rows, one a device of
the data row (a device may repeat: ``("cuda:0",) * 4`` runs four strips on
one card). Each strip runs the model in its own thread
(``SpatialDetector``), in lockstep with the others: every op that reads
across rows first posts its strip on a board and waits for the other
strips' (``Strips.exchange``), then takes the rows it needs from them, a
device-to-device copy where the devices differ. No process group is
involved. The ops that do so, with their sites:

* SAME convs (``layers.Conv``, the dense4 stem ``FoldedS2DConv`` and its
  int8 form, the int8 convs through ``layers.same_geometry``) and
  ``layers.max_pool_same`` (``Strips.
  halo``): the padding is the whole image's. A strip of rows ``[r0, r1)``
  computes the output rows ``o`` with ``s * o`` in it, ``[ceil(r0 / s),
  ceil(r1 / s))``, so a stride-2 strip starts on the stride's phase and its
  halo (the rows above and below it that its outputs read, ``k``, ``s``
  and that phase decide how many) comes from the strips that hold them.
  Only the top strip takes the "before" pad and only the bottom strip the
  "after" pad (-inf for the pool). A 1x1 stride-1 conv reads no other row
  and posts nothing;
* ``layers.GroupNorm``: each strip posts its per-image, per-group sums of
  ``x`` and ``x^2`` and its element count; every strip adds them in strip
  order, so all take the same statistics (eval-mode batch norm is per
  element and needs nothing);
* ``fpn.upsample_nearest`` (``Strips.upsample_nearest``): the output rows
  of a strip are those of the strip that holds the target (the lateral
  map it is added to), and each reads its source row ``floor((o + 1/2) *
  H_in / H_out)`` of the whole map, as the unsplit op does, from whichever
  strip holds it: any ratio, 2x included;
* the heads' outputs: each level's class and box maps (or the fused head's
  trunks) are gathered to whole on the data row's first device, where
  cell selection, top-k and the NMS (K1) run once a predict.

No level is gathered back to whole: a strip whose halo reaches past its
neighbour reads from the strips beyond, and a strip may hold no rows of a
deep level (an op on it then yields no rows and posts its empty strip).
For the configs ``chip_smoke.py`` splits: ``streaming_1024`` on 4 strips
keeps 2 of P7's 8 rows a strip, every level split evenly; the flagship at
640 on 2 strips splits P7's 5 rows 3 and 2; the tests' 128 px model on 8
strips leaves P6 (2 rows) and P7 (1 row) on the first strips alone.

The strips' rows are the model's own rows, so a split predict computes
what the whole one does, in another summation order only where a group
norm's sums are split.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F
from torch.profiler import record_function

STRIP_SPAN = "spatial.strip"  # a strip's forward in its thread
BARRIER_TIMEOUT_S = 600.0

_local = threading.local()


def current() -> "Strips | None":
    """The strip this thread computes, inside ``SpatialRunner.run``."""
    return getattr(_local, "strips", None)


def same_pad(in_size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's SAME split along one axis: ``(before, after)``.

    ``total = max((out - 1) * stride + kernel - in, 0)`` with
    ``out = ceil(in / stride)`` and ``before = total // 2``: a stride-2 3x3
    conv on an even input pads 0 before and 1 after, where torch's
    ``padding=1`` would shift every output. Inside a height split ``in``
    is the whole map's height (``Strips.halo``).
    """
    out = -(-in_size // stride)
    total = max((out - 1) * stride + kernel - in_size, 0)
    return total // 2, total - total // 2


class _Board:
    """Where the strips of one run post what they share: one slot a strip
    for each exchange, kept until every strip has read it."""

    def __init__(self, size: int):
        self.size = size
        self.posts: dict[int, list] = {}
        self.lock = threading.Lock()
        self.barrier = threading.Barrier(size, timeout=BARRIER_TIMEOUT_S)

    def exchange(self, seq: int, index: int, value) -> list:
        with self.lock:
            self.posts.setdefault(seq, [None] * self.size)[index] = value
        self.barrier.wait()
        values = self.posts[seq]
        if index == 0:
            # every strip has posted ``seq``, so every strip has read
            # ``seq - 1``
            with self.lock:
                self.posts.pop(seq - 1, None)
        return values


class Strips:
    """Strip ``index`` of ``size`` on ``device``: the exchanges of one run,
    in program order (every strip runs the same ops)."""

    def __init__(self, index: int, size: int, device: torch.device,
                 board: _Board):
        self.index = index
        self.size = size
        self.device = device
        self.board = board
        self._seq = 0

    def exchange(self, value) -> list:
        """Posts ``value`` and waits for every strip's: the list of all
        strips' values, in strip order."""
        self._seq += 1
        return self.board.exchange(self._seq, self.index, value)

    def bounds(self, x: torch.Tensor, dim: int = 2):
        """Exchanges ``x`` -> ``(parts, bounds, height)``: every strip's
        ``x``, each one's global rows ``[lo, hi)`` along ``dim``, and the
        whole height."""
        parts = self.exchange(x)
        bounds, lo = [], 0
        for p in parts:
            bounds.append((lo, lo + p.shape[dim]))
            lo += p.shape[dim]
        return parts, bounds, lo

    def height(self, x: torch.Tensor, dim: int = 2) -> int:
        """The whole height of the map ``x`` is a strip of."""
        return self.bounds(x, dim)[2]

    def fetch(self, parts: list, bounds: list, lo: int, hi: int,
              dim: int) -> torch.Tensor:
        """Global rows ``[lo, hi)`` along ``dim``, from the strips that
        hold them, on this strip's device."""
        pieces = []
        for part, (a, b) in zip(parts, bounds):
            a2, b2 = max(a, lo), min(b, hi)
            if a2 < b2:
                pieces.append(part.narrow(dim, a2 - a, b2 - a2).to(
                    self.device, non_blocking=True))
        if not pieces:
            own = parts[self.index]
            return own.narrow(dim, 0, 0)
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)

    def halo(self, x: torch.Tensor, kernel: int, stride: int,
             dim: int = 2) -> tuple[torch.Tensor, tuple[int, int], tuple]:
        """The input rows of this strip's outputs of a SAME window op over
        the whole map -> ``(rows, (pad_before, pad_after), (o0, o1,
        out_height))``: pad ``rows`` by the two counts and run the op
        unpadded along ``dim`` to get output rows ``[o0, o1)``. No rows
        (``o0 == o1``) come back as an empty slice and no padding; a 1x1
        stride-1 op reads its own rows, posts nothing and gets ``x`` back
        with no row range."""
        if kernel == 1 and stride == 1:  # reads its own rows alone
            return x, (0, 0), None
        parts, bounds, h = self.bounds(x, dim)
        r0, r1 = bounds[self.index]
        o0, o1 = -(-r0 // stride), -(-r1 // stride)
        rows = (o0, o1, -(-h // stride))
        if o1 <= o0:
            return x.narrow(dim, 0, 0), (0, 0), rows
        before, _ = same_pad(h, kernel, stride)
        a = stride * o0 - before
        b = stride * (o1 - 1) - before + kernel
        pads = (max(0, -a), max(0, b - h))
        return (self.fetch(parts, bounds, max(a, 0), min(b, h), dim), pads,
                rows)

    def upsample_nearest(self, x: torch.Tensor,
                         target_hw: tuple[int, int]) -> torch.Tensor:
        """``fpn.upsample_nearest`` of the whole map, this strip's rows of
        it: ``target_hw[0]`` is this strip's rows of the target."""
        posts = self.exchange((x, int(target_hw[0])))
        parts = [p for p, _ in posts]
        bounds, lo = [], 0
        for p in parts:
            bounds.append((lo, lo + p.shape[2]))
            lo += p.shape[2]
        h_in = lo
        heights = [t for _, t in posts]
        t0 = sum(heights[:self.index])
        t1 = t0 + heights[self.index]
        h_out = sum(heights)
        n, c = x.shape[:2]
        if t1 <= t0:
            return x.new_empty((n, c, 0, target_hw[1]))
        # each output row's source row, as the whole op computes it (on
        # the device: no wait), and on the host a range that holds them
        src = torch.arange(h_in, device=x.device, dtype=torch.float32)
        src = F.interpolate(src.view(1, 1, h_in, 1), size=(h_out, 1),
                            mode="nearest-exact").view(-1)[t0:t1].long()
        lo = max(int((t0 + 0.5) * h_in / h_out) - 1, 0)
        hi = min(int((t1 - 0.5) * h_in / h_out) + 2, h_in)
        rows = self.fetch(parts, bounds, lo, hi, 2).index_select(2, src - lo)
        return F.interpolate(rows, size=(t1 - t0, target_hw[1]),
                             mode="nearest-exact")

    def group_sums(self, sums: torch.Tensor, count: int
                   ) -> tuple[torch.Tensor, int]:
        """Adds every strip's ``sums`` (on this device) and counts, in
        strip order."""
        parts = self.exchange((sums, count))
        total = None
        for s, _ in parts:
            s = s.to(self.device, non_blocking=True)
            total = s if total is None else total + s
        return total, sum(c for _, c in parts)


class SpatialRunner:
    """Runs ``fn(j, inputs[j])`` for every strip ``j`` in a thread of its
    own, under strip ``j``'s context on ``devices[j]``, in inference mode
    and, on the card, with that card current. A strip that raises breaks
    the others' wait, and the first error (not a broken wait) is
    raised."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        self.pool = ThreadPoolExecutor(len(self.devices),
                                       thread_name_prefix="strip")

    def run(self, fn, inputs: list) -> list:
        m = len(self.devices)
        board = _Board(m)

        def work(j: int):
            dev = self.devices[j]
            _local.strips = Strips(j, m, dev, board)
            try:
                with contextlib.ExitStack() as stack:
                    stack.enter_context(torch.inference_mode())
                    if dev.type == "cuda":
                        stack.enter_context(torch.cuda.device(dev))
                    stack.enter_context(record_function(STRIP_SPAN))
                    return fn(j, inputs[j])
            except BaseException:
                board.barrier.abort()
                raise
            finally:
                _local.strips = None

        futures = [self.pool.submit(work, j) for j in range(m)]
        results, errors = [], []
        for f in futures:
            try:
                results.append(f.result())
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
        if errors:
            real = [e for e in errors
                    if not isinstance(e, threading.BrokenBarrierError)]
            raise (real or errors)[0]
        return results


def split_rows(x: torch.Tensor, devices, dim: int = 1) -> list:
    """``x``'s rows along ``dim`` in ``len(devices)`` equal strips, each on
    its device (a view where the device is ``x``'s)."""
    h = x.shape[dim] // len(devices)
    return [x.narrow(dim, j * h, h).to(d, non_blocking=True)
            for j, d in enumerate(devices)]


def gather_rows(parts: list, dim: int, device) -> torch.Tensor:
    """The strips' rows along ``dim``, whole, on ``device``."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts], dim)


class SpatialDetector:
    """A data row's predict with each image's height split over the row's
    ``devices`` (the module docstring): ``detectors`` is one
    ``models.detector.Detector`` a strip, on its device (one object where a
    device repeats). ``predict`` takes the row's images on the first
    device and returns its detections there, like ``Detector.predict``."""

    def __init__(self, detectors: list, devices):
        self.detectors = list(detectors)
        self.devices = tuple(torch.device(d) for d in devices)
        self.detector = self.detectors[0]
        self.device = self.detector.device
        self.cfg = self.detector.cfg
        self.runner = SpatialRunner(self.devices)

    def levels(self, images: torch.Tensor) -> list:
        """The per-level head outputs of the whole images, gathered from
        the strips: ``[(cls, box) NHWC, ...]``, or with the fused head the
        trunks ``[(cls, box) NCHW, ...]``."""
        trunk = self.cfg.model.head_final_kernel == 1
        for det in self.detectors:
            det.model.eval()
        strips = split_rows(images, self.devices)
        outs = self.runner.run(
            lambda j, x: self.detectors[j].model.levels(x, trunk_only=trunk),
            strips)
        dim = 2 if trunk else 1
        return [tuple(gather_rows([o[lv][t] for o in outs], dim, self.device)
                      for t in (0, 1)) for lv in range(len(outs[0]))]

    @torch.inference_mode()
    def predict(self, images):
        from ssd_tpu_torch.models.detector import select_from_levels
        from ssd_tpu_torch.ops.postprocess import run_nms
        det = self.detector
        levels = self.levels(det.as_input(images))
        return run_nms(*select_from_levels(levels, det.model, det.anchors,
                                           self.cfg), self.cfg.nms)
