"""Device time of the elementwise and reduction categories a step
(the loss, the norms, the optimizer), ms."""

from bench_port import readers


def read(summary: dict):
    return readers.category_ms_per_unit(summary, "elementwise", "reduction")
