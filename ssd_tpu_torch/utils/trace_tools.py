"""Per-op and per-category time tables from a ``torch.profiler`` trace (the
port's ``ssd_tpu/utils/trace_tools.py``).

The capture side is ``utils/profiling.py`` (``trace(log_dir)``), ``python
-m ssd_tpu_torch.train --profile N`` (``workdir/profile/trace.json``) and
``tools/bench_train.py --profile DIR`` (``DIR/trace.json``); each writes a
chrome trace, which this module reads back without TensorBoard:

* ``device="cuda"``: the card's events (kernels, copies and fills; not the
  annotations that mirror host spans), each op by its kernel name. Their
  sum is ``utils/profiling.summarize``'s ``device_busy_ms`` of the same
  window.
* ``device="cpu"``: the host's ``aten`` ops, each by its own time (its
  children's time taken out, so that nested ops are not counted twice).

Categories: ``K1 nms``, ``K2 match`` and ``K3 fused_early`` (the port's
hand-written kernels, by their symbols in ``csrc/``), ``conv/gemm``,
``elementwise``, ``reduction``, ``copy`` and ``other``.

    python -m ssd_tpu_torch.utils.trace_tools <trace dir or .json> \\
        [--iters N] [--top K] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# (category, substrings of the op name), first match wins
_CATEGORIES = (
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


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def find_trace(path: str) -> str:
    """A trace file (``*.json``) as it is, or the newest-named
    ``trace.json`` / ``*.pt.trace.json`` under a directory."""
    if path.endswith(".json") and os.path.isfile(path):
        return path
    hits = sorted(
        glob.glob(os.path.join(path, "**", "trace.json"), recursive=True)
        + glob.glob(os.path.join(path, "**", "*.pt.trace.json"),
                    recursive=True))
    if not hits:
        raise FileNotFoundError(f"no trace.json or *.pt.trace.json under "
                                f"{path}")
    return hits[-1]


def _exclusive(events: list[dict]) -> list[tuple[str, float]]:
    """``(name, own µs)`` of nested host ops: each op's duration less its
    direct children's, per thread."""
    out = []
    by_tid = collections.defaultdict(list)
    for e in events:
        by_tid[(e.get("pid"), e.get("tid"))].append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list[list] = []  # [end, name, own]
        for e in evs:
            start, dur = e["ts"], e["dur"]
            while stack and stack[-1][0] <= start:
                out.append((stack[-1][1], stack.pop()[2]))
            if stack:
                stack[-1][2] -= dur
            stack.append([start + dur, e["name"], dur])
        out.extend((name, own) for _, name, own in stack)
    return out


def load_device_ops(path: str, device: str = "cuda"
                    ) -> list[tuple[str, str, int, int]]:
    """One trace -> ``[(op name, category, total ps, calls)]``, an op's
    events summed (the JAX tool's picoseconds). ``device``: ``"cuda"``
    for the card's events, ``"cpu"`` for the host's ops. A trace with no
    event of that kind raises, naming the kinds it has."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if device == "cuda":
        timed = [(e["name"], e["dur"]) for e in events
                 if e.get("cat") in DEVICE_CATS]
    elif device == "cpu":
        timed = _exclusive([e for e in events if e.get("cat") == "cpu_op"])
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not timed:
        kinds = sorted({str(e.get("cat")) for e in events})
        raise ValueError(f"no {device} events in {path}; event kinds: "
                         f"{kinds}")
    total = collections.defaultdict(float)
    calls = collections.Counter()
    for name, us in timed:
        total[name] += us
        calls[name] += 1
    return [(name, category(name), int(round(us * 1e6)), calls[name])
            for name, us in total.items()]


def tables(path: str, iters: int = 1, device: str = "cuda") -> dict:
    """The numbers behind ``summarize``: total ms, ms by category and the
    ops by time (ms and calls), each divided by ``iters``."""
    ops = load_device_ops(path, device)
    by_cat = collections.Counter()
    for _, cat, ps, _ in ops:
        by_cat[cat] += ps
    scale = 1e-9 / iters  # ps -> ms an iteration
    return {
        "trace": path, "device": device, "iters": iters,
        "total_ms": sum(by_cat.values()) * scale,
        "by_category_ms": {c: ps * scale for c, ps in by_cat.most_common()},
        "ops": [{"name": n, "category": c, "ms": ps * scale,
                 "calls": k / iters}
                for n, c, ps, k in sorted(ops, key=lambda t: -t[2])],
    }


def summarize(path: str, iters: int = 1, top: int = 15,
              device: str = "cuda") -> str:
    """The per-category table and the top ``top`` ops (ms and calls an
    iteration)."""
    t = tables(path, iters, device)
    where = "device" if device == "cuda" else "host op"
    lines = [f"{where} time: {t['total_ms']:.2f} ms "
             f"(over {iters} iteration(s))", "", "by category:"]
    for cat, ms in t["by_category_ms"].items():
        lines.append(f"  {ms:8.2f} ms  {cat}")
    lines += ["", f"top {top} ops:"]
    for op in t["ops"][:top]:
        lines.append(f"  {op['ms']:8.2f} ms  {op['calls']:7.1f}x  "
                     f"[{op['category']}] {op['name'][:100]}")
    return "\n".join(lines)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("trace", help="trace dir (workdir/profile) or .json")
    p.add_argument("--iters", type=int, default=1,
                   help="steps captured in the trace (divides the totals)")
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card's kernels or the host's ops")
    args = p.parse_args(argv)
    print(summarize(find_trace(args.trace), args.iters, args.top,
                    args.device))


if __name__ == "__main__":
    main()
