"""Where a training step's device memory goes: one forward and backward of
the config's loss at each ``--batch``, with every tensor the forward saves
for the backward tallied by the module that saved it and by its dtype.

    python -m ssd_tpu_torch.tools.train_memory \\
        --config configs/coco_retinanet_resnet50_640.json \\
        --batch 32 --batch 64 [--set key=val ...] [--device cpu]

Prints one JSON line a batch: the parameters' bytes; the saved tensors
(``saved``: bytes by ``"<module class>/<dtype>"``, the innermost module
running when the tensor was saved, ``loss`` outside the model; a storage
counted once, where it was first saved; parameters left out); the bytes
allocated before the step, after the forward and at its peak (the card
only). A batch that does not fit reports the phase it ran out in
(``oom``) and what was allocated and saved by then. The optimizer's and
EMA's state (a few copies of the parameters) are not in the step.
"""

from __future__ import annotations

import argparse
import collections
import json

import torch

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.models.detector import Detector
from ssd_tpu_torch.tools.bench_serve import apply_overrides
from ssd_tpu_torch.tools.bench_train import synthetic_batch
from ssd_tpu_torch.train import DeviceFeed


class SavedTally:
    """Context that tallies the tensors autograd saves in ``model``'s
    forward by the innermost running module's class and the dtype."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.stack: list[str] = []
        self.seen: set[int] = set()
        self.bytes: collections.Counter = collections.Counter()
        self.skip = {p.untyped_storage().data_ptr()
                     for p in model.parameters()}

    def _pack(self, t: torch.Tensor) -> torch.Tensor:
        storage = t.untyped_storage()
        ptr = storage.data_ptr()
        if ptr not in self.seen and ptr not in self.skip:
            self.seen.add(ptr)
            where = self.stack[-1] if self.stack else "loss"
            dtype = str(t.dtype).removeprefix("torch.")
            self.bytes[f"{where}/{dtype}"] += storage.nbytes()
        return t

    def __enter__(self):
        self.handles = []

        def enter(mod, args):
            self.stack.append(type(mod).__name__)

        def leave(mod, args, out):
            self.stack.pop()

        for m in self.model.modules():
            self.handles.append(m.register_forward_pre_hook(enter))
            self.handles.append(m.register_forward_hook(leave))
        self.hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda t: t)
        self.hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self.hooks.__exit__(*exc)
        for h in self.handles:
            h.remove()
        self.stack.clear()


def gib(n: int) -> float:
    return n / 2 ** 30


def measure(det: Detector, batch: dict) -> dict:
    """One forward and backward of ``det.loss`` on ``batch`` (on the
    device), its saved tensors tallied."""
    cuda = det.device.type == "cuda"
    allocated = (lambda: gib(torch.cuda.memory_allocated(det.device))
                 ) if cuda else (lambda: None)
    det.model.zero_grad(set_to_none=True)
    if cuda:
        torch.cuda.synchronize(det.device)
        torch.cuda.reset_peak_memory_stats(det.device)
    out = {"before_gib": allocated(), "oom": None}
    tally = SavedTally(det.model)
    phase = "forward"
    try:
        with tally:
            total, _ = det.loss(batch)
        out["after_forward_gib"] = allocated()
        phase = "backward"
        total.backward()
        del total
    except torch.OutOfMemoryError:
        out["oom"] = phase
        out["allocated_at_oom_gib"] = allocated()
    if cuda:
        torch.cuda.synchronize(det.device)
        out["peak_gib"] = gib(torch.cuda.max_memory_allocated(det.device))
    saved = dict(tally.bytes.most_common())
    out["saved_gib"] = gib(sum(saved.values()))
    out["saved"] = {k: gib(v) for k, v in saved.items()}
    return out


def run(cfg: Config, batches: list[int], device=None) -> list[dict]:
    det = Detector(cfg, device=device)
    params = sum(p.numel() * p.element_size()
                 for p in det.model.parameters())
    feed = DeviceFeed(det.device)
    rows = []
    for n in batches:
        row = {"batch": n, "image_size": cfg.image_size,
               "dtype": cfg.model.compute_dtype,
               "backbone": cfg.model.backbone, "params_gib": gib(params),
               **measure(det, feed(synthetic_batch(cfg, n)))}
        rows.append(row)
        if det.device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config",
                   default="configs/coco_retinanet_resnet50_640.json")
    p.add_argument("--batch", type=int, action="append", default=None)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="config override, e.g. model.width_multiplier=0.5")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    with open(args.config) as f:
        cfg = Config.from_dict(apply_overrides(json.load(f), args.set),
                               strict=False)
    rows = run(cfg, args.batch or [32], args.device)
    for row in rows:
        print(json.dumps({"config": args.config, **row}))
    return rows


if __name__ == "__main__":
    main()
