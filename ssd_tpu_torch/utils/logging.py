"""Metric logging: stdout lines, a JSONL file, TensorBoard events, and
step-vs-data time.

Counterpart of ``ssd_tpu/utils/logging.py``'s ``MetricLogger``. With a
``log_dir`` each record is appended to ``log_dir/metrics.jsonl`` and, with
``tensorboard`` (the default), written as one event of its numeric keys but
``step`` into ``log_dir/tb/events.out.tfevents.*`` (``utils/tensorboard.py``,
no TensorBoard import), flushed at each ``log``. ``tick_data`` after the
next batch is ready and ``tick_step`` at the end of the iteration split
each iteration into input
time and step time, so an input-bound run shows from its first log line.
Eager CUDA work is asynchronous, so a single step tick measures the host's
dispatch plus any wait; ``log`` reads the metrics back (one copy of them
all, which waits for the card) every ``log_every`` steps, so the windowed
mean converges to the step time. Each record also carries this step's
wait for its batch (``data_wait_s``) and the host clock (``time``, seconds
of ``time.perf_counter``), so consecutive records give each step's time.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque

import torch

from ssd_tpu_torch.utils.tensorboard import SummaryWriter

TB_DIR = "tb"


class MetricLogger:
    def __init__(self, log_dir: str | None = None, window: int = 100,
                 tensorboard: bool = True):
        self.log_dir = log_dir
        self._file = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if tensorboard:
                self._tb = SummaryWriter(os.path.join(log_dir, TB_DIR))
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
        """Prints one record, appends it to ``metrics.jsonl`` and writes
        its numeric keys as one TensorBoard event (the floats read back
        here: the writer reads nothing from the device)."""
        record = {"step": step}
        if metrics:
            values = torch.stack([torch.as_tensor(v).float().reshape(())
                                  for v in metrics.values()]).tolist()
            record.update(zip(metrics, values))
        if self._step_times:
            record["step_time_s"] = sum(self._step_times) / len(self._step_times)
        if self._data_times:
            record["data_time_s"] = sum(self._data_times) / len(self._data_times)
            record["data_wait_s"] = self._data_times[-1]
        record["time"] = time.perf_counter()
        if extra:
            record.update(extra)
        print(" ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in record.items()), flush=True)
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._tb:
            self._tb.add_scalars(
                {k: v for k, v in record.items()
                 if k != "step" and isinstance(v, (int, float))}, step)
            self._tb.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
        if self._tb:
            self._tb.close()
            self._tb = None
