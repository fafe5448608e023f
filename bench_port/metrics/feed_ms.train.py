"""Host ingest a step (``train.DeviceFeed``: the pinned copy and the
upload): the program's ``train.feed`` span, ms."""

from bench_port import readers


def read(summary: dict):
    return readers.span_ms_per_unit(summary, "train.feed")
