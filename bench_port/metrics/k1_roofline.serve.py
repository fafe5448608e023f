"""The NMS kernel's (K1) share of its roofline: its bound for the
window's batches over its device time, %."""

from bench_port import readers


def read(summary: dict):
    return readers.roofline_pct(summary, "K1 nms", "k1_bound_s")
