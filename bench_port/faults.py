"""Faults planted in the program's serving path and training step, each a
way the timed path can break: the CPU tests see each come out not
correct, and ``controls.py`` reads them at a cell's own size on the card.

    with planted("weaker_kept"):
        ...  # the program runs with the fault underneath

* ``half_rows``: the second half of each batch's rows served empty;
* ``answers``: each image given the next one's detections;
* ``no_nms``: the suppression left out;
* ``nms_at_0.3``: the suppression at IoU 0.3, so it suppresses too much;
* ``weaker_kept``: each problem's greedy pass run from its weakest
  candidate up, so that of two overlapping boxes the weaker is kept;
* ``merge_skips_top``: the class merge returning the survivors after the
  best ``max_boxes``: as many detections, none of the top ones;
* ``selection_drops_best``: the cell selection with its best tenth of
  candidates dropped.

Training (``TRAINING``; a data-parallel cell plants them in every rank):

* ``unchanged_state``: the optimizer's update leaves the parameters and
  its state as they were (only its count moves);
* ``half_batch``: the feed uploads the first half of each batch's rows, so
  the step's mean is over them;
* ``unreduced_grads``: the exchange between the ranks left out of the
  gradients (the metrics are still summed): each rank updates on its own
  rows' share;
* ``same_rows``: every rank takes the rows of data index 0.

A step that keeps an EMA (``EMA``):

* ``ema_unchanged``: the EMA's update writes to copies of its tensors,
  so the EMA stays where it started.

Sound variants, which must come out correct (``SOUND``):

* ``ema_lerp``: the step's EMA as one ``torch._foreach_lerp_`` toward the
  updated parameters, ``e + (1 - d) (p - e)``: another formula than the
  port's ``e d + p (1 - d)``, and a more exact one.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

SERVING = ("half_rows", "answers", "no_nms", "nms_at_0.3", "weaker_kept",
           "merge_skips_top", "selection_drops_best")
TRAINING = ("unchanged_state", "half_batch", "unreduced_grads", "same_rows")
EMA = ("ema_unchanged",)
SOUND = ("ema_lerp",)


def _collect_altered(real, alter):
    def collect(self, handle):
        out = {k: np.array(v, copy=True)
               for k, v in real(self, handle).items()}
        alter(out)
        return out
    return collect


def _half_rows_left_out(out: dict) -> None:
    rows = slice(len(out["num_boxes"]) // 2, None)
    out["num_boxes"][rows] = 0
    out["scores"][rows] = 0.0
    out["labels"][rows] = -1
    out["boxes"][rows] = 0.0


def _answers_swapped(out: dict) -> None:
    """Each image given the next one's detections (the last the first's);
    one image alone gets its labels shifted by one class."""
    if len(out["num_boxes"]) > 1:
        for key in out:
            out[key][:] = np.roll(out[key], 1, axis=0)
    else:
        out["labels"][:] = np.where(out["labels"] >= 0,
                                    (out["labels"] + 1) % 80, -1)


def _no_suppression(real):
    def suppress(boxes, top_idx, top_scores, iou_threshold):
        return top_scores
    return suppress


def _suppress_at(iou: float):
    def wrap(real):
        def suppress(boxes, top_idx, top_scores, iou_threshold):
            return real(boxes, top_idx, top_scores, iou)
        return suppress
    return wrap


def _weaker_kept(real):
    def suppress(boxes, top_idx, top_scores, iou_threshold):
        kept = real(boxes, top_idx.flip(-1).contiguous(),
                    top_scores.flip(-1).contiguous(), iou_threshold)
        return kept.flip(-1).contiguous()
    return suppress


def _merge_skips_the_top(real):
    def merge(cand_boxes, top_idx, kept_scores, cfg):
        n = kept_scores.shape[0]
        flat = kept_scores.reshape(n, -1).clone()
        _, top = torch.topk(flat, cfg.max_boxes, dim=1)
        flat.scatter_(1, top, -1.0)
        return real(cand_boxes, top_idx, flat.view_as(kept_scores), cfg)
    return merge


def _selection_drops_the_best(real):
    def select(raw, anchors, num_classes, cfg):
        boxes, scores = real(raw, anchors, num_classes, cfg)
        best = scores.amax(-1)
        _, top = torch.topk(best, best.shape[1] // 10, dim=1)
        scores = scores.scatter(1, top[..., None].expand(
            *top.shape, scores.shape[-1]), 0.0)
        return boxes, scores
    return select


def _update_unchanged(real):
    def update(self, grads, opt_state, params):
        opt_state["count"] += 1
    return update


def _feed_half(real):
    def feed(self, batch):
        half = len(batch["images"]) // 2
        return real(self, {k: v[:half] for k, v in batch.items()})
    return feed


class _Copies(dict):
    """Tensors by name whose ``items()`` hands out copies: what is written
    to them is lost."""

    def items(self):
        return ((k, v.clone()) for k, v in super().items())


def _ema_left_unchanged(real):
    def create(*args, **kwargs):
        ts = real(*args, **kwargs)
        if ts.ema_params is not None:
            ts.ema_params = _Copies(ts.ema_params)
        return ts
    return create


def _ema_by_lerp(real):
    def make(*args, ema_decay: float = 0.0, **kwargs):
        step = real(*args, ema_decay=ema_decay, **kwargs)

        def lerped(state, batch):
            ema, state.ema_params = state.ema_params, None
            try:
                out = step(state, batch)
            finally:
                state.ema_params = ema
            if ema is not None:
                with torch.no_grad():
                    torch._foreach_lerp_(
                        list(ema.values()),
                        [state.params[k].detach() for k in ema],
                        1.0 - ema_decay)
            return out
        return lerped
    return make


def _reduce_metrics_only(real):
    def reduce(grads, metrics, group):
        real({}, metrics, group)
    return reduce


def _first_rows(real):
    def index_and_size(mesh=None):
        return 0, real(mesh)[1]
    return index_and_size


def _site(name: str):
    """-> (object, attribute, wrapper of the real one)."""
    from ssd_tpu_torch import train, train_step
    from ssd_tpu_torch.models import detector
    from ssd_tpu_torch.ops import nms, nms_cuda
    from ssd_tpu_torch.parallel import mesh
    from ssd_tpu_torch.predictor import Predictor
    return {
        "unchanged_state": (train_step.Optimizer, "update",
                            _update_unchanged),
        "half_batch": (train.DeviceFeed, "__call__", _feed_half),
        "ema_unchanged": (train_step, "create_train_state",
                          _ema_left_unchanged),
        "ema_lerp": (train_step, "make_train_step", _ema_by_lerp),
        "unreduced_grads": (train_step, "_reduce", _reduce_metrics_only),
        "same_rows": (mesh, "data_index_and_size", _first_rows),
        "half_rows": (Predictor, "predict_collect",
                      lambda r: _collect_altered(r, _half_rows_left_out)),
        "answers": (Predictor, "predict_collect",
                    lambda r: _collect_altered(r, _answers_swapped)),
        "no_nms": (nms_cuda, "suppress", _no_suppression),
        "nms_at_0.3": (nms_cuda, "suppress", _suppress_at(0.3)),
        "weaker_kept": (nms_cuda, "suppress", _weaker_kept),
        "merge_skips_top": (nms, "merge_classes_lazy", _merge_skips_the_top),
        "selection_drops_best": (detector, "select_candidates_cells",
                                 _selection_drops_the_best),
    }[name]


@contextlib.contextmanager
def planted(name: str):
    obj, attr, wrap = _site(name)
    real = getattr(obj, attr)
    setattr(obj, attr, wrap(real))
    try:
        yield
    finally:
        setattr(obj, attr, real)
