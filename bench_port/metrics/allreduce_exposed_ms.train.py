"""The part of ``allreduce_ms.train`` in which no other device operation
runs on rank 0's card (the collectives' time not hidden behind compute),
ms a step."""

from bench_port import readers


def read(summary: dict):
    return readers.exposed_collective_ms_per_unit(summary)
