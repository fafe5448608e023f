"""The optimizer update's host time a step (L2, the global norm, the
clip, the momentum or adam update leaf by leaf, the EMA): the program's
``train.update`` span, ms."""

from bench_port import readers


def read(summary: dict):
    return readers.span_ms_per_unit(summary, "train.update")
