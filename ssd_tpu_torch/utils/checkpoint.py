"""Training checkpoints with exact resume.

Counterpart of ``ssd_tpu/utils/checkpoint.py``'s ``TrainCheckpointer``,
with ``torch.save`` in place of orbax. A checkpoint holds the whole
``TrainState`` (step, params, BN statistics, optimizer state, EMA) and the
data iterator's state, so a resumed run consumes the batches the
interrupted one would have. Saves are synchronous: written to a temporary
file and renamed into place, so a crash never leaves a partial checkpoint.
The newest ``keep`` are kept.

Restore copies into the given state's tensors, which are the model's own,
so the model is restored with it. Toggling ``train.ema_decay`` between the
run that wrote a checkpoint and the one that reads it is tolerated as the
JAX package tolerates it: saved EMA weights are dropped, or a missing EMA is
re-seeded from the restored params.
"""

from __future__ import annotations

import glob
import os
import re

import torch

from ssd_tpu_torch.train_step import TrainState

_NAME = "ckpt_{:010d}.pt"
_PATTERN = re.compile(r"ckpt_(\d{10})\.pt$")


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def _copy_into(dst: dict, src: dict, what: str) -> None:
    if set(dst) != set(src):
        raise ValueError(
            f"checkpoint {what} do not match the model: missing "
            f"{sorted(set(dst) - set(src))}, unexpected "
            f"{sorted(set(src) - set(dst))}")
    with torch.no_grad():
        for k, t in dst.items():
            if isinstance(t, torch.Tensor):
                t.copy_(src[k])
            elif isinstance(t, dict):
                _copy_into(t, src[k], f"{what}/{k}")
            else:
                dst[k] = src[k]


class TrainCheckpointer:
    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        steps = []
        for path in glob.glob(os.path.join(self.directory, "ckpt_*.pt")):
            m = _PATTERN.search(path)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState,
             iterator_state: dict | None = None) -> None:
        """Writes step ``state.step`` unless it is already saved (the final
        save after a periodic one)."""
        if state.step in self.all_steps():
            return
        payload = {
            "step": state.step,
            "params": _to_cpu(state.params),
            "batch_stats": _to_cpu(state.batch_stats),
            "opt_state": _to_cpu(state.opt_state),
            "ema_params": _to_cpu(state.ema_params),
            "iterator": iterator_state,
        }
        path = os.path.join(self.directory, _NAME.format(state.step))
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.keep] if self.keep > 0 else []:
            os.unlink(os.path.join(self.directory, _NAME.format(old)))

    def restore(self, state: TrainState,
                step: int | None = None) -> tuple[TrainState, dict | None]:
        """Loads a checkpoint (the latest unless ``step``) into ``state`` in
        place; returns ``(state, iterator_state)``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = os.path.join(self.directory, _NAME.format(step))
        payload = torch.load(path, map_location="cpu", weights_only=True)
        _copy_into(state.params, payload["params"], "params")
        _copy_into(state.batch_stats, payload["batch_stats"], "batch stats")
        _copy_into(state.opt_state, payload["opt_state"], "optimizer state")
        saved_ema = payload["ema_params"]
        if state.ema_params is not None and saved_ema is not None:
            _copy_into(state.ema_params, saved_ema, "EMA params")
        elif state.ema_params is not None:
            print("checkpoint: no saved ema_params (checkpoint written with "
                  "train.ema_decay=0); re-seeding EMA from params", flush=True)
            with torch.no_grad():
                for k, e in state.ema_params.items():
                    e.copy_(state.params[k])
        elif saved_ema is not None:
            print("checkpoint: dropping saved ema_params "
                  "(train.ema_decay is now 0)", flush=True)
        state.step = int(payload["step"])
        return state, payload["iterator"]
