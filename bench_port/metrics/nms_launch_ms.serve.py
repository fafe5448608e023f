"""NMS and the class merge's launch a batch (``run_nms``: K1 or
Soft-NMS): the program's ``predict.nms`` spans, ms."""

from bench_port import readers


def read(summary: dict):
    return readers.span_ms_per_unit(summary, "predict.nms")
