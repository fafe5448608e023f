"""The whole step's share of the card's dense bf16 peak: training FLOPs
an image (forward and backward, no recompute) times images a second, %."""

from bench_port import readers


def read(summary: dict):
    return readers.mfu_pct(summary)
