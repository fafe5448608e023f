"""The share of the window with no device operation running, %."""

from bench_port import readers


def read(summary: dict):
    return readers.idle_pct(summary)
