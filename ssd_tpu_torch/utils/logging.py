"""Metric logging: stdout lines, a JSONL file, and step-vs-data time.

Counterpart of ``ssd_tpu/utils/logging.py``'s ``MetricLogger`` without the
TensorBoard writer. ``tick_data`` after the next batch is ready and
``tick_step`` after the step is dispatched split each iteration into input
time and step time, so an input-bound run shows from its first log line.
Eager CUDA work is asynchronous, so a single step tick measures the host's
dispatch plus any wait; ``log`` reads the metrics back (a synchronisation)
every ``log_every`` steps, so the windowed mean converges to the step time.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque


class MetricLogger:
    def __init__(self, log_dir: str | None = None, window: int = 100):
        self._file = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._step_times = deque(maxlen=window)
        self._data_times = deque(maxlen=window)
        self._last = time.perf_counter()

    def reset_clock(self) -> None:
        """Restart the step/data timers (call right before the loop)."""
        self._last = time.perf_counter()

    def tick_data(self) -> None:
        """Call after the next batch is ready (input-pipeline time)."""
        now = time.perf_counter()
        self._data_times.append(now - self._last)
        self._last = now

    def tick_step(self) -> None:
        """Call after the train step is dispatched."""
        now = time.perf_counter()
        self._step_times.append(now - self._last)
        self._last = now

    def log(self, step: int, metrics: dict, extra: dict | None = None) -> None:
        """Prints one record and appends it to ``metrics.jsonl``."""
        record = {"step": step}
        for k, v in metrics.items():
            record[k] = float(v)
        if self._step_times:
            record["step_time_s"] = sum(self._step_times) / len(self._step_times)
        if self._data_times:
            record["data_time_s"] = sum(self._data_times) / len(self._data_times)
        if extra:
            record.update(extra)
        print(" ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in record.items()), flush=True)
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
