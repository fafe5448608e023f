"""The forward's launch a batch (``Detector.predict``'s model, the int8
convs' im2col and dequantize passes): the program's ``predict.model``
spans, ms."""

from bench_port import readers


def read(summary: dict):
    return readers.span_ms_per_unit(summary, "predict.model")
