"""Inputs that hold the NMS kernel (``csrc/nms.cu``) and the matching kernel
(``csrc/match.cu``) to their plain versions.

``chip_smoke.py`` runs every case on the card, kernel against plain, at the
main paths' shapes; ``tests/test_torch_kernel_cases.py`` runs the same
cases on the CPU at small sizes, the plain versions against the JAX
package. Every case is numpy, made from a seed. This module imports numpy
only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

NMS_CASES = ("serve", "k100", "k512", "all_empty", "chain", "k1", "k32",
             "k33", "identical", "iou_at_threshold", "iou_0", "iou_negative",
             "iou_1", "max_k")
MATCH_CASES = ("crowded", "no_gts", "duplicates", "no_overlap", "m1", "m13",
               "no_force_match", "dup_anchors", "edge_on_bound",
               "outside_unit")
# the seeds of the cases' own draws
NMS_SEED = 0
MATCH_SEED = 2


class NMSCase(NamedTuple):
    name: str
    boxes: np.ndarray   # (N, Q, 4) f32
    scores: np.ndarray  # (N, Q, C) f32
    cfg: dict           # the NMSConfig fields the case sets
    kept: int | None    # candidates greedy NMS keeps, where the case fixes it


class MatchCase(NamedTuple):
    name: str
    anchors: np.ndarray  # (A, 4) f32
    gt: np.ndarray       # (N, M, 4) f32, padded
    num: np.ndarray      # (N,) int32
    force_match: bool


# ------------------------------------------------------------------ NMS

def clustered_problem(rng, n: int, q: int, c: int, cluster: int = 16):
    """Boxes in dense overlapping clusters of ``cluster`` and tie-free
    scores: ``boxes (n, q, 4)``, ``scores (n, q, c)``, f32. ``q`` is a
    multiple of ``cluster``."""
    k = q // cluster
    centre = rng.uniform(0.1, 0.9, (n, k, 1, 2))
    size = rng.uniform(0.05, 0.3, (n, k, 1, 2))
    centre = centre + rng.normal(0.0, 0.02, (n, k, cluster, 2))
    size = size * rng.uniform(0.8, 1.2, (n, k, cluster, 2))
    boxes = np.concatenate([centre - size / 2, centre + size / 2], -1)
    boxes = np.clip(boxes, 0.0, 1.0).reshape(n, q, 4).astype(np.float32)
    scores = rng.permutation(n * q * c).astype(np.float32) / (n * q * c)
    return boxes, scores.reshape(n, q, c)


def chain_problem(n: int, q: int, c: int):
    """Boxes in a chain, each overlapping the next at IoU 0.25 and not the
    one after; scores fall along it."""
    x0 = 0.06 * np.arange(q) / (0.06 * q + 0.1)
    w = 0.1 / (0.06 * q + 0.1)
    one = np.stack([np.zeros(q), x0, np.full(q, 0.2), x0 + w], -1)
    boxes = np.broadcast_to(one, (n, q, 4)).astype(np.float32)
    s = np.linspace(0.9, 0.5, q)[None, :, None] - 1e-3 * np.arange(c)
    return boxes.copy(), np.broadcast_to(s, (n, q, c)).astype(np.float32)


def _nms_cfg(k: int, iou: float = 0.5, score: float = 0.05,
             max_boxes: int = 100) -> dict:
    return dict(pre_nms_top_k=k, iou_threshold=iou, score_threshold=score,
                max_boxes=max_boxes)


def nms_cases(n: int, q: int, c: int, max_k: int) -> list[NMSCase]:
    """The cases of ``NMS_CASES``, in that order. ``serve`` is ``n`` images
    of ``q`` clustered candidates and ``c`` classes at K = 128 (``q`` >= 512
    and a multiple of 16); ``max_k`` is the largest K the kernel admits
    (a multiple of 32)."""
    rng = np.random.default_rng(NMS_SEED)
    boxes, scores = clustered_problem(rng, n, q, c)
    b8, s8 = clustered_problem(rng, min(n, 8), q, c)
    cb, cs = chain_problem(2, 128, 4)
    # every candidate of an image on one box: each problem keeps its first
    same = np.broadcast_to(np.float32([0.2, 0.3, 0.6, 0.7]), (2, 64, 4))
    same_s = 0.1 + 0.8 * rng.permutation(2 * 64 * 3).astype(np.float32) / (
        2 * 64 * 3)
    # dyadic boxes: IoU(0, 1) = IoU(0, 2) = 0.5 exactly, which does not
    # exceed a threshold of 0.5; 1 and 2 only touch; 3 repeats 0
    tie = np.float32([[[0, 0, 1, 1], [0, 0, 1, 0.5], [0, 0.5, 1, 1],
                       [0, 0, 1, 1]]])
    tie_s = np.float32([0.9, 0.8, 0.7, 0.6]).reshape(1, 4, 1)
    bk, sk = clustered_problem(rng, 1, max_k, 2)
    cases = [
        NMSCase("serve", boxes, scores, _nms_cfg(128), None),
        NMSCase("k100", boxes, scores, _nms_cfg(100), None),
        NMSCase("k512", b8, s8, _nms_cfg(512), None),
        NMSCase("all_empty", boxes, scores * 0.04, _nms_cfg(128), 0),
        NMSCase("chain", cb, cs, _nms_cfg(128, iou=0.2, score=0.1),
                2 * 4 * 64),
        NMSCase("k1", boxes, scores, _nms_cfg(1), None),
        NMSCase("k32", boxes, scores, _nms_cfg(32), None),
        NMSCase("k33", boxes, scores, _nms_cfg(33), None),
        NMSCase("identical", same.copy(), same_s.reshape(2, 64, 3),
                _nms_cfg(64), 2 * 3),
        NMSCase("iou_at_threshold", tie, tie_s, _nms_cfg(4), 3),
        # thresholds outside the usual range: any overlap drops; every
        # later candidate drops (an IoU is never negative); nothing drops
        NMSCase("iou_0", b8, s8, _nms_cfg(128, iou=0.0), None),
        NMSCase("iou_negative", b8, s8, _nms_cfg(128, iou=-0.5),
                min(n, 8) * c),
        NMSCase("iou_1", b8, s8, _nms_cfg(128, iou=1.0), None),
        NMSCase("max_k", bk, sk, _nms_cfg(max_k), None),
    ]
    assert tuple(x.name for x in cases) == NMS_CASES
    return cases


# ------------------------------------------------------------------ matching

def random_boxes(rng, shape: tuple, lo: float = 0.1,
                 hi: float = 0.9) -> np.ndarray:
    """Boxes of centre U(lo, hi) and sides U(0.02, 0.3), clipped to [0, 1]:
    ``shape + (4,)`` f32."""
    c = rng.uniform(lo, hi, shape + (2,))
    size = rng.uniform(0.02, 0.3, shape + (2,))
    return np.concatenate([c - size / 2, c + size / 2], -1).astype(
        np.float32).clip(0, 1)


def _bound_gts(anchors: np.ndarray) -> np.ndarray:
    """Gts on the bounding box of runs of consecutive anchors (32, 128 and
    1024 of them, as a kernel's warps and blocks take them): one touching
    each side from outside, so it overlaps no anchor of the run, and one
    inside with two edges on the bound."""
    a = len(anchors)
    out = []
    for size in (32, 128, 1024):
        for start in (0, size, 5 * size):
            if start + size > a:
                continue
            run = anchors[start:start + size]
            y0, x0 = run[:, 0].min(), run[:, 1].min()
            y1, x1 = run[:, 2].max(), run[:, 3].max()
            d = np.float32(0.1)
            out += [[y1, x0, y1 + d, x1], [y0 - d, x0, y0, x1],
                    [y0, x1, y1, x1 + d], [y0, x0 - d, y1, x0],
                    [y0, x0, (y0 + y1) / 2, (x0 + x1) / 2]]
    return np.asarray(out, np.float32)


def match_cases(anchors: np.ndarray, boxes: np.ndarray,
                num_boxes: np.ndarray) -> list[MatchCase]:
    """The cases of ``MATCH_CASES``, in that order. ``crowded`` is the batch
    ``boxes (N, M, 4)``, ``num_boxes (N,)`` (N >= 8, M >= 13) on
    ``anchors (A, 4)``; the others take its first 8 images or draw their
    own gts."""
    rng = np.random.default_rng(MATCH_SEED)
    anchors = np.asarray(anchors, np.float32)
    m = boxes.shape[1]
    gt = random_boxes(rng, (8, m))
    num = rng.integers(0, m + 1, 8).astype(np.int32)
    num[:3] = 0
    dup = boxes[:8].copy()
    dup[:, 1::2] = dup[:, 0:-1:2]  # every odd gt repeats the even one before
    far = gt.copy()
    far[:, :10] = [0.5, 0.5, 0.5, 0.6]  # zero height: IoU 0 with every anchor

    # anchor 5's box again at 700 and further blocks: a gt on it ties
    # across blocks, and the lowest index must win
    twins = anchors.copy()
    for i in (700, 1500, 5000):
        if i < len(twins):
            twins[i] = twins[5]
    tg = random_boxes(rng, (4, 20))
    tg[:, 0] = twins[5]
    side = twins[5, 2:] - twins[5, :2]
    tg[:, 1] = twins[5] + np.float32(0.01) * np.concatenate([side, side])
    tg[:, 2] = tg[:, 0]  # ties on every anchor: the lower gt wins

    edge = _bound_gts(anchors)
    edge_gt = np.zeros((2, len(edge), 4), np.float32)
    edge_gt[0] = edge
    edge_gt[1] = edge[rng.permutation(len(edge))]

    c = rng.uniform(-0.1, 1.1, (4, 30, 2))
    size = rng.uniform(0.05, 0.6, (4, 30, 2))
    outside = np.concatenate([c - size / 2, c + size / 2], -1).astype(
        np.float32)

    cases = [
        MatchCase("crowded", anchors, boxes, num_boxes.astype(np.int32), True),
        MatchCase("no_gts", anchors, gt, num, True),
        MatchCase("duplicates", anchors, dup,
                  num_boxes[:8].astype(np.int32), True),
        MatchCase("no_overlap", anchors, far, np.full(8, m, np.int32), True),
        MatchCase("m1", anchors, gt[:, :1].copy(), np.ones(8, np.int32),
                  True),
        MatchCase("m13", anchors, gt[:, :13].copy(), np.minimum(num, 13),
                  True),
        MatchCase("no_force_match", anchors, boxes[:8].copy(),
                  num_boxes[:8].astype(np.int32), False),
        MatchCase("dup_anchors", twins, tg, np.int32([20, 20, 3, 1]), True),
        MatchCase("edge_on_bound", anchors, edge_gt,
                  np.int32([len(edge), len(edge) // 2]), True),
        MatchCase("outside_unit", anchors, outside, np.int32([30, 17, 5, 30]),
                  True),
    ]
    assert tuple(x.name for x in cases) == MATCH_CASES
    return cases
