"""Launch a batch (``Predictor._enqueue`` and the readback's enqueue):
the program's ``predict.launch`` spans, ms."""

from bench_port import readers


def read(summary: dict):
    return readers.span_ms_per_unit(summary, "predict.launch")
