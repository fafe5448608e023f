"""Channel tensor parallelism on the model axis and its composition with
FSDP, against the JAX package's placements and the port's one-process
step, on the CPU.

Four gloo ranks, a ``(data 2, model 2)`` mesh, run as four processes of
this file (``python tests/test_torch_tensor_parallel.py rank R WORLD PORT
DIR``), started once for the module by a fixture and retried once, on a
fresh port, on a non-zero exit only. The ranks import no JAX and run on
one torch thread each. At ``tests/test_train_step.py``'s ``TINY`` size
(MobileNet x0.25, 64 px, 3 classes, batch 8: 4 rows a data index, read by
both ranks of its model group) the cases are:

* (a) the parameters ``model_sharded`` splits, leaf for leaf, against
  JAX's ``model_sharded`` over the same state on a ``(4, 2)`` mesh, and
  those ``fsdp_sharded(base=)`` shards over ``data`` against JAX's on a
  ``(2, 2)`` mesh;
* (b) the TP step (adam, 2 steps, global batch-norm statistics, weight
  decay) against the one-process step on the 8 rows, every rank's state
  bit-identical, and a split conv's forward run on its ``O / 2`` rows;
  and JAX's own TP test's setting (one step of TINY's momentum) at its
  bars;
* (c) FSDP over ``data`` composed with TP, 2 accumulation steps, against
  the one-process step at the same accumulation (the loss) and the TP
  step at the same accumulation (everything), and its checkpoint loaded
  into one process bit-equal;

The one-process references run on one torch thread, as the ranks do. At
TINY the deepest batch norms see 2x2 maps, where flax's fast variance
cancels: after the first step any f32 reordering is amplified (the
one-process step on 8 threads parts from itself on 1 by up to 1.4e-3 in a
weight after two adam steps, as a data split with accumulation does), so
the parameters are held at 1e-5 where that reordering is TP's alone.
* ``train(model_parallelism=2)`` with FSDP over data, one step;
* (d) the dry run's body (``tools/dryrun.run_rank``) on the ranks' group:
  JAX's line, ``meshed_predict_max_delta=0.0``;
* (e) the eval forward at TP 2 of MobileNet-v2, EfficientNet-lite0,
  ShuffleNet-v2 and ResNet-50 (``test_torch_backbones``' widths) against
  one process.
"""

import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
for path in (ROOT, HERE):  # the ranks run this file as a script
    if path not in sys.path:
        sys.path.insert(0, path)

from ssd_tpu_torch.config import Config  # noqa: E402
from ssd_tpu_torch.models import layers  # noqa: E402
from ssd_tpu_torch.models.detector import Detector  # noqa: E402
from ssd_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from ssd_tpu_torch.train_step import (Optimizer,  # noqa: E402
                                      create_train_state, make_train_step)
from ssd_tpu_torch.utils.checkpoint import TrainCheckpointer  # noqa: E402
from test_torch_distributed import (ADAM, L2, MOMENTUM, TINY,  # noqa: E402
                                    _floats, _whole, tiny_batch, tiny_cfg)

WORLD, MODEL = 4, 2
RANK_TIMEOUT_S = 300
STEPS = 2
ACCUM = 2
BAR = 1e-5  # JAX's bar for its TP step against its replicated one
# adam's update g / (|g| + 1e-8) is ill-conditioned where |g| is near
# 1e-8: there the f32 reordering of the split convs' input gradients moves
# a weight by up to a learning rate, for about 1e-5 of the weights at TINY
ADAM_FLIP_SHARE = 1e-3
# test_torch_backbones' widths, each with TINY's neck at 64 px
BACKBONES = {"mobilenet_v2": 0.25, "efficientnet_lite": 0.25,
             "shufflenet": 0.5, "resnet50": 1.0}
BACKBONE_IMAGES = 2


def backbone_cfg(name: str) -> Config:
    return Config.from_dict({**TINY, "model": {
        **TINY["model"], "backbone": name,
        "width_multiplier": BACKBONES[name]}})


def backbone_images() -> torch.Tensor:
    return torch.from_numpy(tiny_batch(7)["images"][:BACKBONE_IMAGES])


def run_steps(cfg: Config, mesh=None, steps: int = STEPS, fsdp=False,
              ckpt: str | None = None) -> dict:
    """``steps`` steps from the seed-0 weights on ``tiny_batch(i)``: all 8
    rows in one process, this data index's 4 on a mesh (TP, and FSDP over
    it with ``fsdp``) -> metrics, whole state and EMA, the split leaves
    and, under FSDP, the placements."""
    det = Detector(cfg, device="cpu")
    split, placed = [], None
    if mesh is not None:
        split = mesh_lib.model_sharded(mesh, det.model)
        if fsdp:
            mesh_lib.fsdp_sharded(mesh, det.model, base=split)
            placed = _placements(det.model)
    opt = Optimizer(cfg)
    state = create_train_state(det, opt, cfg.train.ema_decay)
    step = make_train_step(det, opt, cfg.train.ema_decay,
                           cfg.train.grad_accum_steps, mesh=mesh)
    metrics = []
    for i in range(steps):
        batch = tiny_batch(i)
        if mesh is not None:
            d, n = mesh_lib.data_index_and_size(mesh)
            k = len(batch["images"]) // n
            batch = {key: v[d * k:(d + 1) * k] for key, v in batch.items()}
        state, m = step(state, batch)
        metrics.append(_floats(m))
    if ckpt is not None:
        TrainCheckpointer(ckpt).save(state)
    return {"metrics": metrics, "model": _whole(det.model.state_dict()),
            "ema": _whole(state.ema_params), "split": split,
            "placed": placed}


# ------------------------------------------------------------------ the ranks

def _placements(model) -> dict:
    """The parameters split over ``model`` and those sharded over
    ``data``, by name."""
    out = {mesh_lib.DATA_AXIS: [], mesh_lib.MODEL_AXIS: []}
    for name, p in model.named_parameters():
        if mesh_lib.is_sharded(p):
            for dim, pl in zip(p.device_mesh.mesh_dim_names, p.placements):
                if not pl.is_replicate():
                    out[dim].append(name)
    return out


def _case_tp(rank, mesh, workdir) -> dict:
    seen = []
    plain_conv = layers.Conv._conv

    def conv(self, x, weight, bias, groups=None):
        if self.tp is not None:
            seen.append((tuple(self.weight.shape), tuple(weight.shape)))
        return plain_conv(self, x, weight, bias, groups)

    layers.Conv._conv = conv
    try:
        out = run_steps(tiny_cfg(L2, **ADAM), mesh)
    finally:
        layers.Conv._conv = plain_conv
    out["seen"] = seen
    return out


def _case_tp_accum(rank, mesh, workdir) -> dict:
    return run_steps(tiny_cfg(L2, **ADAM, grad_accum_steps=ACCUM), mesh)


def _case_momentum(rank, mesh, workdir) -> dict:
    return run_steps(tiny_cfg(L2, **MOMENTUM), mesh, steps=1)


def _case_fsdp(rank, mesh, workdir) -> dict:
    return run_steps(tiny_cfg(L2, **ADAM, grad_accum_steps=ACCUM), mesh,
                     fsdp=True, ckpt=os.path.join(workdir, "fsdp_tp_ckpt"))


def _case_train(rank, mesh, workdir) -> dict:
    """``train()`` at TP 2 with FSDP over data: each model group's ranks
    on their data index's rows."""
    from ssd_tpu_torch.data.synthetic import SceneBatches
    from ssd_tpu_torch.train import train
    d, n = mesh_lib.data_index_and_size(mesh)

    def rows(i: int) -> dict:
        batch = tiny_batch(i)
        k = len(batch["images"]) // n
        return {key: v[d * k:(d + 1) * k] for key, v in batch.items()}

    cfg = tiny_cfg(L2, **MOMENTUM, param_sharding="fsdp", log_every=1,
                   checkpoint_every=1)
    loop = os.path.join(workdir, "loop")
    last = train(cfg, loop, SceneBatches(rows), device="cpu", max_steps=1,
                 model_parallelism=MODEL)
    return {"last": last, "files": sorted(os.listdir(loop))}


def _case_dryrun(rank, mesh, workdir) -> dict:
    from ssd_tpu_torch.tools import dryrun
    return dryrun.run_rank(mesh, WORLD)


def _case_backbones(rank, mesh, workdir) -> dict:
    out = {}
    for name in BACKBONES:
        det = Detector(backbone_cfg(name), device="cpu")
        split = mesh_lib.model_sharded(mesh, det.model)
        with torch.no_grad():
            levels = det.model.eval().levels(backbone_images())
        out[name] = {"levels": levels, "split": len(split)}
    return out


CASES = (("tp", _case_tp), ("tp_accum", _case_tp_accum),
         ("momentum", _case_momentum), ("fsdp", _case_fsdp),
         ("train", _case_train),
         ("dryrun", _case_dryrun), ("backbones", _case_backbones))


def rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank: every case in turn (each case's error is its result, so
    that the others still run), then its results in ``rankR.pt``."""
    torch.set_num_threads(1)
    mesh_lib.initialize_distributed("cpu", f"tcp://localhost:{port}",
                                    world, rank)
    mesh = mesh_lib.create_mesh(model_parallelism=MODEL)
    out = {"index": (mesh_lib.data_index_and_size(mesh), mesh.model_index)}
    for name, case in CASES:
        t0 = time.perf_counter()
        try:
            out[name] = case(rank, mesh, workdir)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
        out.setdefault("seconds", {})[name] = time.perf_counter() - t0
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    mesh_lib.shutdown_distributed()


# ------------------------------------------------------------------ the parent

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_ranks(workdir: str) -> list:
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "rank", str(r),
         str(WORLD), str(port), workdir],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]


def _wait_ranks(procs: list) -> tuple[list[int], list[str]]:
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    return [p.returncode for p in procs], outs


def _one_process() -> dict:
    """What the ranks are held to, computed while they run: JAX's
    placements and the one-process steps and forwards."""
    out = {"jax": _jax_placements(),
           "tp": run_steps(tiny_cfg(L2, **ADAM)),
           "momentum": run_steps(tiny_cfg(L2, **MOMENTUM), steps=1),
           "fsdp": run_steps(tiny_cfg(L2, **ADAM, grad_accum_steps=ACCUM))}
    with torch.no_grad():
        out["backbones"] = {
            name: Detector(backbone_cfg(name), device="cpu").model.eval()
            .levels(backbone_images()) for name in BACKBONES}
    return out


def _restore_one_process(directory: str) -> dict:
    """The FSDP x TP ranks' checkpoint in one process: model and EMA."""
    cfg = tiny_cfg(L2, **ADAM, grad_accum_steps=ACCUM)
    det = Detector(cfg, device="cpu")
    state = create_train_state(det, Optimizer(cfg), cfg.train.ema_decay)
    TrainCheckpointer(directory).restore(state)
    return {"model": _whole(det.model.state_dict()),
            "ema": _whole(state.ema_params)}


@pytest.fixture(scope="module")
def ranks():
    """The four ranks' results, what the parent restores of them, and the
    one-process references (``want``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with tempfile.TemporaryDirectory() as workdir:
            procs = _start_ranks(workdir)
            want = _one_process()
            codes, outs = _wait_ranks(procs)
            if any(codes):  # a gloo rendezvous on a loaded host: once more
                codes, outs = _wait_ranks(_start_ranks(workdir))
            for code, out in zip(codes, outs):
                assert code == 0, f"rank failed:\n{out[-4000:]}"
            results = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                                  weights_only=False) for r in range(WORLD)]
            ckpt = os.path.join(workdir, "fsdp_tp_ckpt")
            restored = (_restore_one_process(ckpt) if os.path.isdir(ckpt)
                        else None)
        yield {"rank": results, "restored": restored, "want": want}
    finally:
        torch.set_num_threads(n)


def _ok(ranks, case: str) -> list:
    out = [r[case] for r in ranks["rank"]]
    for r, o in enumerate(out):
        assert "error" not in o, f"rank {r}:\n{o['error']}"
    return out


def _assert_state_close(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=BAR, err_msg=f"{what} {k}")


def _assert_bit_identical(a: dict, b: dict, what: str) -> None:
    assert set(a) == set(b), what
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what} {k}"


def _jax_placements() -> tuple[set, set]:
    """JAX's split leaves on a ``(4, 2)`` mesh and its data-sharded leaves
    under ``fsdp_sharded(base=)`` on a ``(2, 2)`` mesh, over TINY's
    initial parameters, in the port's names (``convert.convert_params`` of
    a tree of ones where sharded, zeros elsewhere)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from ssd_tpu.config import Config as JaxConfig
    from ssd_tpu.models.detector import Detector as JaxDetector
    from ssd_tpu.parallel.mesh import (create_mesh, fsdp_sharded,
                                       model_sharded)
    from ssd_tpu_torch.convert import convert_params

    cfg = tiny_cfg()
    det = JaxDetector(JaxConfig.from_json(cfg.to_json()))
    params = jax.eval_shape(lambda: det.init(jax.random.PRNGKey(0)))[
        "params"]

    def names(shardings, uses) -> set:
        marks = jax.tree_util.tree_map(
            lambda x, s: np.full(x.shape, float(uses(s.spec)), np.float32),
            params, shardings)
        return {k for k, v in convert_params(marks, cfg).items()
                if float(v.min()) == 1.0}

    devices = jax.devices()
    split = names(model_sharded(create_mesh(devices[:8], MODEL), params),
                  lambda spec: spec != P())
    small = create_mesh(devices[:4], MODEL)
    data = names(fsdp_sharded(small, params,
                              base=model_sharded(small, params)),
                 lambda spec: mesh_lib.DATA_AXIS in spec)
    return split, data


def test_model_sharded_splits_jax_leaves(ranks):
    """(a) ``model_sharded`` splits JAX's leaves, leaf for leaf (depthwise
    kernels too: flax keeps their channels trailing, and JAX's rule splits
    them), and every rank agrees; under ``fsdp_sharded(base=)`` every leaf
    JAX shards over ``data`` is sharded over ``data`` and every split leaf
    stays split over ``model``."""
    tp, fsdp = _ok(ranks, "tp"), _ok(ranks, "fsdp")
    assert all(g["split"] == tp[0]["split"] for g in tp + fsdp)
    split, data = ranks["want"]["jax"]
    assert split and set(tp[0]["split"]) == split
    assert any(".depthwise." in k for k in split)
    placed = fsdp[0]["placed"]
    assert all(g["placed"] == placed for g in fsdp[1:])
    assert data and data <= set(placed[mesh_lib.DATA_AXIS])
    assert set(placed[mesh_lib.MODEL_AXIS]) == split


def _assert_adam_close(got: dict, want: dict, lr: float, what: str) -> None:
    """Every weight within atol 1e-5 of ``want``'s, but for at most
    ``ADAM_FLIP_SHARE`` of each leaf, each within one learning rate."""
    assert set(got) == set(want), what
    for k, w in want.items():
        d = (got[k].double() - w.double()).abs()
        beyond = int((d > BAR).sum())
        assert beyond <= ADAM_FLIP_SHARE * d.numel(), (what, k, beyond)
        assert float(d.max()) <= lr, (what, k, float(d.max()))


def test_tp_step_matches_one_process(ranks):
    """(b) Two adam steps at TP 2 from the seed-0 weights: the loss within
    1e-5 of the one-process step's at each step, ``num_positives`` equal,
    the parameters within atol 1e-5 but for adam's ill-conditioned
    updates (``ADAM_FLIP_SHARE``), the four ranks' states bit-identical,
    and every split conv's forward on its ``O / 2`` rows alone."""
    out = _ok(ranks, "tp")
    want = ranks["want"]["tp"]
    for i, (g, w) in enumerate(zip(out[0]["metrics"], want["metrics"])):
        assert abs(g["loss"] - w["loss"]) < BAR, (i, g["loss"], w["loss"])
        assert g["num_positives"] == w["num_positives"]
    lr = tiny_cfg(**ADAM).train.learning_rate
    _assert_adam_close(out[0]["model"], want["model"], lr, "tp")
    for r in range(1, WORLD):
        _assert_bit_identical(out[r]["model"], out[0]["model"], f"rank {r}")
        _assert_bit_identical(out[r]["ema"], out[0]["ema"], f"rank {r} ema")
        assert out[r]["metrics"] == out[0]["metrics"]
    seen = out[0]["seen"]
    assert seen and all(used[0] * MODEL == full[0] and used[1:] == full[1:]
                        for full, used in seen)


def test_tp_momentum_step_at_jax_bars(ranks):
    """(b) JAX's ``test_channel_tp_matches_replicated`` setting, one step
    of TINY's momentum: loss within 1e-5 and every parameter within atol
    1e-5 of the one-process step's."""
    out = _ok(ranks, "momentum")
    want = ranks["want"]["momentum"]
    assert abs(out[0]["metrics"][0]["loss"]
               - want["metrics"][0]["loss"]) < BAR
    _assert_state_close(out[0]["model"], want["model"], "momentum")
    _assert_state_close(out[0]["ema"], want["ema"], "momentum ema")


def test_fsdp_tp_accumulation_matches_one_process(ranks):
    """(c) FSDP over data composed with TP, 2 accumulation steps, 2 adam
    steps: the loss within 1e-5 of the one-process step's at the same
    accumulation at each step; metrics, parameters and EMA within 1e-5 of
    the TP step's at the same accumulation without FSDP; the ranks
    bit-identical; and the checkpoint written under it loads bit-equal into
    one process."""
    out, tp = _ok(ranks, "fsdp"), _ok(ranks, "tp_accum")
    want = ranks["want"]["fsdp"]
    for i, (g, w) in enumerate(zip(out[0]["metrics"], want["metrics"])):
        assert abs(g["loss"] - w["loss"]) < BAR, (i, g["loss"], w["loss"])
    for g, w in zip(out[0]["metrics"], tp[0]["metrics"]):
        for k in w:
            assert abs(g[k] - w[k]) <= BAR * max(1.0, abs(w[k])), (k, g, w)
    _assert_state_close(out[0]["model"], tp[0]["model"], "fsdp x tp")
    _assert_state_close(out[0]["ema"], tp[0]["ema"], "fsdp x tp ema")
    for r in range(1, WORLD):
        _assert_bit_identical(out[r]["model"], out[0]["model"], f"rank {r}")
    restored = ranks["restored"]
    _assert_bit_identical(restored["model"], out[0]["model"], "restored")
    _assert_bit_identical(restored["ema"], out[0]["ema"], "restored ema")


def test_train_loop_at_tp2(ranks):
    """``train(model_parallelism=2)`` with FSDP: the same finite metrics
    on every rank, rank 0's log, checkpoint and export."""
    out = _ok(ranks, "train")
    assert all(o["last"] == out[0]["last"] for o in out[1:])
    assert np.isfinite(out[0]["last"]["loss"])
    assert {"export", "checkpoints", "metrics.jsonl"} <= set(out[0]["files"])


def test_dryrun_line(ranks):
    """(d) The dry run on the four ranks: JAX's line, the ranks agreeing,
    something split on ``model`` and sharded on ``data``, the meshed
    predict equal to one device's."""
    out = _ok(ranks, "dryrun")
    line = out[0]["line"]
    assert line.startswith("dryrun_multichip(4): ok, loss=")
    for key in ("mesh={'data': 2, 'model': 2}", "meshed_predict_max_delta=0.0",
                "meshed_predict_boxes=(8, 100, 4)"):
        assert key in line, (key, line)
    assert out[0]["tp_sharded_leaves"] > 0 and out[0]["fsdp_sharded_leaves"]
    assert all(o["line"] == line for o in out[1:])


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone_forward_at_tp2(ranks, name):
    """(e) The eval forward at TP 2 equals one process's within 1e-5 on
    every level's class and box maps: grouped (depthwise), channel-shuffle
    and max-pool layers over split convs."""
    out = _ok(ranks, "backbones")
    got = out[0][name]
    assert got["split"] > 0
    want = ranks["want"]["backbones"][name]
    for lv, (g, w) in enumerate(zip(got["levels"], want)):
        for t in range(2):
            np.testing.assert_allclose(g[t].numpy(), w[t].numpy(), rtol=0,
                                       atol=BAR, err_msg=f"{name} {lv} {t}")
    for r in range(1, WORLD):
        for g, w in zip(out[r][name]["levels"], got["levels"]):
            assert all(torch.equal(a, b) for a, b in zip(g, w))


if __name__ == "__main__" and sys.argv[1:2] == ["rank"]:
    rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
              sys.argv[5])
