"""The comparisons that decide ``correct``.

Served detections (``boxes, scores, labels, num_boxes`` of a batch)
against the reference on the same images, stage by stage: the model's
outputs at the served detections against the reference model's
(``serve_gaps``), then the program's raw maps, its selection and its NMS
and class merge (``stage_gaps``).

``serve_gaps``: each served detection must be an output of the model: one
of the anchors whose reference boxes it overlaps nearly as well as the
best (``NEAR``: boxes clipped at the image's edge coincide, or shrink to
slivers), and that anchor's reference logit for the served label. Its gap
is the distance between the logits that give the served score and the
reference's; a detection missing against the reference's count reads
the ceiling ``CAP``. A label, score or box altered where it is made, an
answer given to another image, or rows left out read large; a
suppression left out shows in ``nms_overlap``, two kept detections of a
class overlapping past the configuration's IoU threshold.

``stage_gaps``: which detections make the final set is not compared with
the reference model's own set: with every (image, class) problem live,
thousands of candidates lie within a rounding of one another, and bf16's
rounding alone changes a tenth to a quarter of the set (PERF.md). So the
set is judged from the program's own raw maps, as the program's detector
gives them for the same images after the window: the reference's
selection on them against the program's candidates (``select_gap``), and
the reference's NMS and class merge on those candidates against what the
window served, slot by slot (``nms_mismatch``, an exact comparison). The
raw maps themselves are held to the reference model's over every anchor
(``raw_gap``, ``raw_off_share``), so that no stage is taken on trust.

A training run's first steps against the reference's from the same
parameters on the same batches:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first gradient as the optimizer takes it (its momentum
  trace after one step), leaf by leaf: the gap between the program's norm
  and the reference's, over the reference's norm of that leaf or of the
  median leaf, whichever is larger; the median leaf's gap (the worst
  leaf's swings: see PERF.md);
* ``update_gap``: the same of each leaf's change after the steps, over
  the leaves whose reference gradient is not nought to rounding (under a
  thousandth of the median leaf's), which move by round-off alone.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port.reference import detect

CAP = 10.0  # a logit gap's ceiling, and what a missing detection counts
NEAR = 0.9  # an anchor is a served detection's if its IoU is this x the best
OFF = 0.2  # a detection is off if its logit lies farther than this


def logit_interval(s: torch.Tensor, tol: float) -> tuple:
    """The logits whose sigmoid, as a float32 score, is ``s`` to within
    ``tol`` or half a float32 step either way (near 1 a score's step is
    wide: from logit 13 on, one step spans tenths of a logit, and 1.0 all
    above 16.6) -> (low, high), in float64."""
    s64 = s.double()
    up = torch.nextafter(s, torch.ones_like(s)).double() - s64
    down = s64 - torch.nextafter(s, torch.zeros_like(s)).double()
    lo = s64 - torch.clamp_min(down / 2, tol)
    hi = s64 + torch.clamp_min(up / 2, tol)

    def logit(p):
        return torch.where(p <= 0, -torch.inf, torch.where(
            p >= 1, torch.inf, torch.log(p) - torch.log1p(-p)))
    return logit(lo), logit(hi)


def serve_gaps(served: dict, logits: torch.Tensor, boxes: torch.Tensor,
               final: dict, score_tol: float = 0.0,
               worst: dict | None = None) -> dict:
    """``served``: numpy arrays of one batch; ``logits (N, A, C)`` and
    ``boxes (N, A, 4)`` the reference's per-anchor outputs (boxes decoded
    and clipped); ``final`` the reference's detections. ``score_tol``:
    how far a served score may lie from the program's own (a reply's
    rounding); the logit gap is measured from the interval of logits
    that round to it.

    ``logit_gap`` is the worst image's mean over its detections,
    ``logit_gap_max`` the worst detection's, ``off_share`` the worst
    image's share of detections whose gap passes ``OFF``; ``nms_overlap``
    the largest IoU of two served detections of one class. A detection
    short of the reference's count counts ``CAP`` (and as off).
    ``worst``: filled with what the detection of the largest gap was
    matched to (for a look)."""
    dev = logits.device
    sb = torch.as_tensor(served["boxes"], device=dev, dtype=torch.float32)
    ss = torch.as_tensor(served["scores"], device=dev, dtype=torch.float32)
    sl = torch.as_tensor(served["labels"], device=dev, dtype=torch.long)
    sn = torch.as_tensor(served["num_boxes"], device=dev, dtype=torch.long)
    rn = final["num_boxes"].long()
    n, m = ss.shape
    c = logits.shape[-1]
    out = dict.fromkeys(SERVE_GAPS, 0.0)
    for i in range(n):
        k, kr = int(sn[i]), int(rn[i])
        lab = sl[i, :max(k, 0)]
        if k < 0 or k > m or bool(((lab < 0) | (lab >= c)).any()):
            return dict.fromkeys(SERVE_GAPS, float("inf"))
        slots = max(k, kr, 1)
        miss = max(kr - k, 0)
        gaps = {"logit_gap": CAP * miss, "logit_gap_max": CAP if miss else 0.0,
                "off_share": float(miss), "nms_overlap": 0.0}
        if k:
            ov = detect.iou(sb[i, :k], boxes[i])  # (k, A)
            best = ov.max(dim=1).values
            # the anchors whose boxes overlap it nearly as well as the
            # best: boxes clipped to a sliver at the image's edge, or
            # alike, are told apart by their logits
            near = ov >= NEAR * best[:, None]
            ref = logits[i][:, lab].T.double()  # (k, A)
            lo, hi = logit_interval(ss[i, :k], score_tol)
            gap = torch.clamp_min(torch.maximum(lo[:, None] - ref,
                                                ref - hi[:, None]), 0.0)
            gap = torch.where(near, gap, torch.inf).min(dim=1).values
            gap = gap.clamp_max(CAP)
            if worst is not None and float(gap.max()) > worst.get(
                    "gap", -1.0):
                j = int(gap.argmax())
                top = ov[j].topk(4)
                worst.update(
                    gap=float(gap[j]), image=i, rank=j,
                    box=sb[i, j].tolist(), score=float(ss[i, j]),
                    label=int(lab[j]), best_iou=float(best[j]),
                    anchors=top.indices.tolist(), ious=top.values.tolist(),
                    ref_logits=ref[j, top.indices].tolist(),
                    ref_boxes=boxes[i][top.indices].tolist())
            gaps["logit_gap"] += float(gap.sum())
            gaps["off_share"] += float((gap > OFF).sum())
            gaps["logit_gap_max"] = max(gaps["logit_gap_max"],
                                        float(gap.max()))
            same = lab[:, None] == lab[None, :]
            pair = detect.iou(sb[i, :k], sb[i, :k])
            pair = torch.where(same & ~torch.eye(k, dtype=torch.bool,
                                                 device=dev), pair, 0.0)
            gaps["nms_overlap"] = float(pair.max())
        for key in ("logit_gap", "off_share"):
            gaps[key] /= slots
        out = {key: max(out[key], gaps[key]) for key in out}
    return out


def stage_gaps(served: dict, raw: torch.Tensor, ref_raw: torch.Tensor,
               cand: tuple, ref_cand: tuple, ref_final: dict) -> dict:
    """``raw``, ``ref_raw``: the program's and the reference's raw outputs
    of one batch, ``(N, A, C + 4)`` (logits and box codes); ``cand``: the
    program's candidates ``(boxes (N, Q, 4), scores (N, Q, C))`` from its
    raw maps, ``ref_cand`` the reference's selection on the same maps;
    ``ref_final``: the reference's NMS and merge on ``cand``.

    ``raw_gap`` is the worst image's mean gap over every anchor's outputs,
    ``raw_off_share`` its share of outputs farther than ``OFF``;
    ``select_gap`` the largest gap of a candidate's box or score;
    ``nms_mismatch`` the worst image's share of detection slots (of the
    larger count) that differ from the reference's in label, score or
    box."""
    d = (raw.float() - ref_raw.float()).abs().flatten(1)
    out = {"raw_gap": float(d.mean(1).max()),
           "raw_off_share": float((d > OFF).float().mean(1).max())}
    if cand[1].shape != ref_cand[1].shape:
        out["select_gap"] = float("inf")
    else:
        out["select_gap"] = max(
            float((a.float() - b.float()).abs().max())
            for a, b in zip(cand, ref_cand))
    dev = ref_final["scores"].device
    sn = torch.as_tensor(served["num_boxes"], device=dev).long()
    rn = ref_final["num_boxes"].long()
    slots = torch.maximum(torch.maximum(sn, rn), torch.ones_like(sn))
    differ = (
        (torch.as_tensor(served["labels"], device=dev).long()
         != ref_final["labels"].long())
        | (torch.as_tensor(served["scores"], device=dev)
           != ref_final["scores"])
        | (torch.as_tensor(served["boxes"], device=dev)
           != ref_final["boxes"]).any(-1))
    rank = torch.arange(differ.shape[1], device=dev)
    differ &= rank[None] < slots[:, None]
    out["nms_mismatch"] = float((differ.sum(1) / slots).max())
    return out


SERVE_GAPS = ("logit_gap", "logit_gap_max", "off_share", "nms_overlap")
GAPS = SERVE_GAPS + ("raw_gap", "raw_off_share", "select_gap",
                     "nms_mismatch")


def _leaf_norms(tensors: dict) -> dict:
    return {k: float(v.detach().float().norm()) for k, v in tensors.items()}


def _leaf_gaps(norms: dict, ref: dict, keys: list) -> list:
    med = float(np.median([ref[k] for k in keys]))
    return [abs(norms[k] - ref[k]) / max(ref[k], med) for k in keys]


def train_gaps(losses: list, ref_losses: list, grad: dict, ref_grad: dict,
               change: dict, ref_change: dict) -> dict:
    """Each dict maps a parameter's name to a tensor (any device). The
    leaf gaps are given as the median leaf's (``grad_gap``,
    ``update_gap``) and the worst leaf's (``*_worst``)."""
    loss = max(abs(a - b) / max(abs(b), 1e-12)
               for a, b in zip(losses, ref_losses))
    g, rg = _leaf_norms(grad), _leaf_norms(ref_grad)
    med_g = float(np.median(list(rg.values())))
    moved = [k for k in rg if rg[k] >= 1e-3 * med_g]
    grads = _leaf_gaps(g, rg, list(rg))
    updates = _leaf_gaps(_leaf_norms(change), _leaf_norms(ref_change), moved)
    return {"loss_gap": loss,
            "grad_gap": float(np.median(grads)), "grad_gap_worst": max(grads),
            "update_gap": float(np.median(updates)),
            "update_gap_worst": max(updates),
            "leaves_left_out": len(rg) - len(moved)}
