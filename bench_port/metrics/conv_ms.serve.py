"""Device time of the conv and GEMM category a batch, ms."""

from bench_port import readers


def read(summary: dict):
    return readers.category_ms_per_unit(summary, "conv/gemm")
