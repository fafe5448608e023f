"""The step's host time (``make_train_step``'s step: forward, targets,
loss, backward and update enqueued): the program's ``train.step`` span,
ms."""

from bench_port import readers


def read(summary: dict):
    return readers.span_ms_per_unit(summary, "train.step")
