"""Device time a step in the collectives' kernels (NCCL's: the gradients'
flat all-reduce, batch norm's statistics, the positive count and the
metrics), on rank 0's card, ms. A collective's kernel runs until every
rank has joined it, so this holds the wait for the slowest rank too."""

from bench_port import readers


def read(summary: dict):
    return readers.category_ms_per_unit(summary, "collective")
