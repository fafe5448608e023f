"""The whole predict's share of the card's dense peak in the cell's
compute dtype: FLOPs an image times images a second, %."""

from bench_port import readers


def read(summary: dict):
    return readers.mfu_pct(summary)
