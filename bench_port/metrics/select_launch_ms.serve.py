"""The candidate selection's launch a batch (``select_from_levels``: the
cells, flat or fused-head selection): the program's ``predict.select``
spans, ms."""

from bench_port import readers


def read(summary: dict):
    return readers.span_ms_per_unit(summary, "predict.select")
