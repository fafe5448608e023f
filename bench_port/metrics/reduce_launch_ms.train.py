"""The data-parallel step's gradient exchange on the host a step
(``train_step._reduce``: the flat all-reduce of the gradients and the
metrics' shares, enqueued): the program's ``train.reduce`` span on rank
0, ms."""

from bench_port import readers


def read(summary: dict):
    return readers.span_ms_per_unit(summary, "train.reduce")
