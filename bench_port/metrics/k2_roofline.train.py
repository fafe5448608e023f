"""The matching kernel's (K2) share of its roofline: its bound for the
window's steps over its device time, %."""

from bench_port import readers


def read(summary: dict):
    return readers.roofline_pct(summary, "K2 match", "k2_bound_s")
