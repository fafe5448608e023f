"""What a traced window leaves behind, reduced to a summary the per-layer
metric readers take their numbers from.

The window runs under ``torch.profiler`` (host and device activity); its
events are read in memory (``kineto_results``), not written out:

* device operations: kernels, copies and fills, by name and category
  (the categories of ``ssd_tpu_torch/utils/trace_tools.py``, copied, and
  ``collective`` for NCCL's kernels);
* the device's busy time: the union of those operations' intervals (a
  plain sum counts overlapping kernels twice); and the collectives'
  exposed time, the part of theirs that no other operation overlaps;
* host spans: the program's ``record_function`` ranges and the
  harness's own, by name, with their durations;
* idle gaps: the stretches inside the window where no device operation
  runs, each labelled by the innermost host span open at its start.
"""

from __future__ import annotations

import collections

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# (category, substrings of the op name), first match wins: trace_tools'
CATEGORIES = (
    ("collective", ("nccl",)),
    ("K1 nms", ("nms_kernel",)),
    ("K2 match", ("match_kernel", "unpack_kernel")),
    ("K3 fused_early", ("fused_early_kernel",)),
    ("copy", ("memcpy", "memset", "copy", "aten::to", "aten::_to_copy",
              "contiguous", "aten::clone", "aten::cat", "catarraybatched",
              "aten::index", "gather", "scatter")),
    ("conv/gemm", ("conv", "gemm", "aten::mm", "aten::addmm", "aten::bmm",
                   "aten::_int_mm", "aten::matmul", "xmma", "cutlass",
                   "cudnn", "winograd", "implicit", "dgrad", "wgrad", "sm90",
                   "sm80")),
    ("elementwise", ("elementwise_kernel", "vectorized", "unrolled",
                     "foreach")),
    ("reduction", ("reduce", "sum", "mean", "amax", "max", "min", "norm",
                   "argmax", "softmax", "sort", "topk", "cumsum", "var")),
    ("elementwise", ("aten::",)),
)
TOP = 10


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def _kind(event) -> str:
    """The event's activity kind; torch releases without
    ``activity_type`` tell it by device and by ``is_user_annotation``."""
    if hasattr(event, "activity_type"):
        return event.activity_type()
    note = event.is_user_annotation()
    if "CUDA" in str(event.device_type()):
        return "gpu_user_annotation" if note else "kernel"
    return "user_annotation" if note else "cpu_op"


def _union(intervals: list) -> tuple[float, list]:
    """-> (covered ns, the gaps between covered stretches as (start,
    end))."""
    covered, gaps = 0, []
    end = None
    for s, e in sorted(intervals):
        if end is None:
            covered, start, end = e - s, s, e
        elif s > end:
            gaps.append((end, s))
            covered += e - s
            end = e
        elif e > end:
            covered += e - end
            end = e
    return covered, gaps


def summarize(events, start_ns: int, end_ns: int) -> dict:
    """``events``: the profiler's kineto events; ``[start_ns, end_ns]``:
    the window on the same clock. Everything outside is cut off."""
    ops, spans = [], []
    for e in events:
        kind = _kind(e)
        s = e.start_ns()
        t = s + e.duration_ns()
        if t <= start_ns or s >= end_ns:
            continue
        s, t = max(s, start_ns), min(t, end_ns)
        if kind in DEVICE_KINDS:
            ops.append((e.name(), s, t))
        elif kind == "user_annotation":
            spans.append((e.name(), s, t))
    busy_ns, gaps = _union([(s, t) for _, s, t in ops])
    others_ns, _ = _union([(s, t) for n, s, t in ops
                           if category(n) != "collective"])
    if ops:  # idle before the first and after the last operation too
        first = min(s for _, s, _ in ops)
        last = max(t for _, _, t in ops)
        gaps = [(start_ns, first)] + gaps + [(last, end_ns)]
    by_op = collections.defaultdict(float)
    calls = collections.Counter()
    by_cat = collections.defaultdict(float)
    for name, s, t in ops:
        by_op[name] += (t - s) * 1e-9
        calls[name] += 1
        by_cat[category(name)] += (t - s) * 1e-9
    span_s = collections.defaultdict(list)
    for name, s, t in spans:
        span_s[name].append((t - s) * 1e-9)
    idle = collections.defaultdict(float)
    spans.sort(key=lambda sp: sp[1])
    active, nxt = [], 0
    for gs, ge in sorted(gaps):  # a sweep: the spans open at each gap
        if ge <= gs:
            continue
        while nxt < len(spans) and spans[nxt][1] <= gs:
            active.append(spans[nxt])
            nxt += 1
        active = [sp for sp in active if sp[2] > gs]
        label = (min(active, key=lambda sp: sp[2] - sp[1])[0] if active
                 else "(no span)")
        idle[label] += (ge - gs) * 1e-9
    return {
        "window_s": (end_ns - start_ns) * 1e-9,
        "busy_s": busy_ns * 1e-9,
        "collective_exposed_s": (busy_ns - others_ns) * 1e-9,
        "ops": {n: {"s": v, "calls": calls[n], "category": category(n)}
                for n, v in by_op.items()},
        "category_s": dict(by_cat),
        "spans": dict(span_s),
        "idle_by_span": dict(idle),
    }


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the device ops that took most time
    and the idle time by what the host was doing, at most ``TOP`` each."""
    ops = sorted(((n, v["s"]) for n, v in summary["ops"].items()),
                 key=lambda t: -t[1])[:TOP]
    idle = sorted(summary["idle_by_span"].items(), key=lambda t: -t[1])[:TOP]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[n[:200], s] for n, s in idle]}
