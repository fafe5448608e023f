"""Host ingest a batch (``Predictor._feed``, the native pack): the
program's ``predict.feed`` span, ms."""

from bench_port import readers


def read(summary: dict):
    return readers.span_ms_per_unit(summary, "predict.feed")
