"""The port's scale-out against the JAX package's mesh, on the CPU.

Two gloo ranks run as two processes of this file (``python
tests/test_torch_distributed.py rank R WORLD PORT DIR``), started once for
the module by a fixture and retried once, on a fresh port, on a non-zero
exit only. The ranks import no JAX: JAX runs only here, in the test
process, on ``tests/conftest.py``'s 8-device CPU mesh. Each rank runs on
one torch thread. At ``tests/test_train_step.py``'s ``TINY`` size
(MobileNet x0.25, 64 px, 3 classes, batch 8) the cases are:

* three data-parallel adam steps against JAX's ``jit_train_step`` on the
  8-device mesh with the same 8 rows, at
  ``test_torch_train.py::test_three_train_steps_match_jax``'s bars (each
  step from JAX's state), batch-norm running statistics included: they
  are the global batch's, which a per-rank batch norm misses; the
  parameters are bit-identical across the ranks;
* two ranks against the port's one-process step on the concatenated
  batch, with 2 accumulation steps and weight decay, to rtol 1e-5;
* FSDP against replicated to 1e-5, the largest leaf really sharded, and a
  checkpoint written under FSDP loading bit-equal into one process;
* ``train()`` under the group (FSDP, rank 0 alone writing) and the
  microbatch refusal, with the JAX package's message;
* ``train.evaluate`` with the mesh and the gather over
  ``assets/eval_golden_v1.npz``'s shard at 6 rows a rank: both ranks give
  JAX's stored numbers to 1e-6.

Without the ranks: the evaluator's ``_pack``/``_load_packed`` against
JAX's, and ``Predictor(mesh=)`` over two CPU devices, bit-equal to the
plain predictor and within the golden set rule of JAX's meshed predictor.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import traceback

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # the ranks run this file as a script
    sys.path.insert(0, ROOT)

from ssd_tpu_torch.config import Config  # noqa: E402
from ssd_tpu_torch.convert import load_npz_artifact  # noqa: E402
from ssd_tpu_torch.eval import sanity  # noqa: E402
from ssd_tpu_torch.models.detector import Detector  # noqa: E402
from ssd_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from ssd_tpu_torch.train_step import (Optimizer,  # noqa: E402
                                      create_train_state, make_train_step)
from ssd_tpu_torch.utils.checkpoint import TrainCheckpointer  # noqa: E402

WORLD = 2
RANK_TIMEOUT_S = 240
EVAL_ASSET = os.path.join(ROOT, "ssd_tpu_torch", "assets",
                          "eval_golden_v1.npz")
EVAL_ROWS_PER_RANK = 6
EVAL_KEYS = ("mAP", "AP50", "AP75", "AP_small", "AP_medium", "AP_large",
             "AR@1", "AR@10", "AR@100", "AR_small", "AR_medium", "AR_large")
# tests/test_train_step.py's TINY, as JSON the two packages both read
TINY = {"num_classes": 3, "image_size": 64,
        "model": {"backbone": "mobilenet", "width_multiplier": 0.25,
                  "fpn_channels": 32, "head_depth": 1,
                  "compute_dtype": "float32"},
        "train": {"batch_size": 8, "num_steps": 100, "learning_rate": 0.01,
                  "warmup_steps": 0, "lr_schedule": "cosine"}}
ADAM = {"optimizer": "adam", "learning_rate": 1e-3, "ema_decay": 0.9}
MOMENTUM = {"optimizer": "momentum", "learning_rate": 0.01,
            "ema_decay": 0.5}


def tiny_cfg(losses: dict | None = None, **train) -> Config:
    d = {**TINY, "train": {**TINY["train"], **train},
         "losses": dict(losses or {})}
    return Config.from_dict(d)


def tiny_batch(index: int, n: int = 8, size: int = 64, max_gt: int = 4
               ) -> dict:
    """``test_train_step._tiny_batch``'s rows, seeded by ``index``."""
    rng = np.random.default_rng([31, index])
    images = rng.integers(0, 255, (n, size, size, 3)).astype(np.uint8)
    boxes = np.zeros((n, max_gt, 4), np.float32)
    labels = np.zeros((n, max_gt), np.int32)
    num = np.ones((n,), np.int32)
    for i in range(n):
        boxes[i, 0] = [0.2, 0.2, 0.7, 0.7]
        labels[i, 0] = i % 3
    return {"images": images, "boxes": boxes, "labels": labels,
            "num_boxes": num}


def rows(batch: dict, rank: int, world: int = WORLD) -> dict:
    """Rank ``rank``'s contiguous rows of a global batch."""
    n = len(batch["images"]) // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


ACCUM_CFG = dict(MOMENTUM, grad_accum_steps=2)
L2 = {"weight_decay": 1e-3}
# one step: at 64 px the deepest norms see 2x2 maps, where flax's fast
# variance cancels, so a free run parts within a few steps whatever sums
# the statistics in another order (one process included)
STEPS = 1
LOOP_STEPS = 2


def _floats(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def _whole(tensors: dict) -> dict:
    return {k: mesh_lib.full_tensor(v.detach()).clone()
            for k, v in tensors.items()}


def run_steps(cfg: Config, mesh, rank: int, fsdp: bool = False) -> tuple:
    """``STEPS`` steps from the seed-0 weights on this rank's rows (all of
    them without a mesh) -> ``({metrics, model, ema}, detector, state)``,
    the model's state and the EMA as whole tensors."""
    det = Detector(cfg, device="cpu")
    if fsdp:
        mesh_lib.fsdp_sharded(mesh, det.model)
    opt = Optimizer(cfg)
    state = create_train_state(det, opt, cfg.train.ema_decay)
    step = make_train_step(det, opt, cfg.train.ema_decay,
                           cfg.train.grad_accum_steps, mesh=mesh)
    metrics = []
    for i in range(STEPS):
        batch = tiny_batch(i)
        state, m = step(state, batch if mesh is None else rows(batch, rank))
        metrics.append(_floats(m))
    out = {"metrics": metrics, "model": _whole(det.model.state_dict()),
           "ema": _whole(state.ema_params)}
    return out, det, state


# ------------------------------------------------------------------ the ranks

def _case_adam(rank, mesh, inputs) -> dict:
    cfg = Config.from_json(inputs["adam_cfg"])
    det = Detector(cfg, device="cpu")
    opt = Optimizer(cfg)
    state = create_train_state(det, opt, cfg.train.ema_decay)
    step = make_train_step(det, opt, cfg.train.ema_decay, mesh=mesh)
    steps = []
    for i, pre in enumerate(inputs["adam_pre"]):
        det.model.load_state_dict(pre["model"])
        with torch.no_grad():
            for k in ("ema", "mu", "nu"):
                dst = state.ema_params if k == "ema" else state.opt_state[k]
                for name, v in pre[k].items():
                    dst[name].copy_(v)
        state.opt_state["count"] = pre["count"]
        state, m = step(state, rows(inputs["adam_batches"][i], rank))
        steps.append({"metrics": _floats(m),
                      "model": _whole(det.model.state_dict()),
                      "ema": _whole(state.ema_params)})
    return {"steps": steps}


def _case_accum(rank, mesh, inputs) -> dict:
    return run_steps(tiny_cfg(L2, **ACCUM_CFG), mesh, rank)[0]


def _case_fsdp(rank, mesh, inputs, workdir) -> dict:
    cfg = tiny_cfg(L2, **MOMENTUM)
    replicated = run_steps(cfg, mesh, rank)[0]
    sharded, det, state = run_steps(cfg, mesh, rank, fsdp=True)
    big = max(state.params.values(), key=lambda p: p.numel())
    ckpt = TrainCheckpointer(os.path.join(workdir, "fsdp_ckpt"))
    ckpt.save(state, {"position": STEPS})
    # every rank restores its own shards of the whole tensors
    det2 = Detector(cfg, device="cpu")
    mesh_lib.fsdp_sharded(mesh, det2.model)
    opt = Optimizer(cfg)
    state2, it = ckpt.restore(create_train_state(det2, opt,
                                                 cfg.train.ema_decay))
    restored = (_whole(det2.model.state_dict()), _whole(state2.ema_params),
                _whole(state2.opt_state["trace"]))
    saved = (sharded["model"], sharded["ema"],
             _whole(state.opt_state["trace"]))
    return {"replicated": replicated, "fsdp": sharded,
            "big": (big.to_local().numel(), big.numel()),
            "sharded_leaves": sum(mesh_lib.is_sharded(p)
                                  for p in state.params.values()),
            "restored_equal": all(
                torch.equal(a[k], b[k]) for a, b in zip(restored, saved)
                for k in a) and it == {"position": STEPS}}


def _case_refusal(rank, mesh, inputs, workdir) -> dict:
    from ssd_tpu_torch.train import train
    out = {}
    for name, kw in (("micro", dict(batch_size=8, grad_accum_steps=8)),
                     ("batch", dict(batch_size=7))):
        try:
            train(tiny_cfg(**kw), os.path.join(workdir, f"refuse_{name}"),
                  device="cpu", max_steps=1)
        except ValueError as e:
            out[name] = str(e)
    return out


def _case_train(rank, mesh, inputs, workdir) -> dict:
    from ssd_tpu_torch.data.synthetic import SceneBatches
    from ssd_tpu_torch.train import train
    cfg = tiny_cfg(L2, **MOMENTUM, param_sharding="fsdp", log_every=1,
                   checkpoint_every=1)
    batches = SceneBatches(lambda i: rows(tiny_batch(i), rank))
    last = train(cfg, os.path.join(workdir, "loop"), batches, device="cpu",
                 max_steps=LOOP_STEPS)
    return {"last": last}


def _case_evaluate(rank, mesh, inputs, workdir) -> dict:
    from ssd_tpu_torch.train import evaluate
    cfg = Config.from_json(inputs["eval_cfg"])
    _, state = load_npz_artifact(sanity.SANITY_NPZ)
    got = evaluate(Detector(cfg, state, device="cpu"), cfg, rank, WORLD,
                   mesh=mesh)
    return {k: got[k] for k in EVAL_KEYS}


def rank_main(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank: every case in turn (each case's error is its result, so
    that the others still run), then its results in ``rankR.pt``."""
    torch.set_num_threads(1)
    mesh_lib.initialize_distributed("cpu", f"tcp://localhost:{port}",
                                    world, rank)
    mesh = mesh_lib.create_mesh()
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    out = {}
    for name, case in (("adam", _case_adam), ("accum", _case_accum),
                       ("fsdp", _case_fsdp), ("refusal", _case_refusal),
                       ("train", _case_train),
                       ("evaluate", _case_evaluate)):
        try:
            args = (rank, mesh, inputs) + ((workdir,) if case not in (
                _case_adam, _case_accum) else ())
            out[name] = case(*args)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    mesh_lib.shutdown_distributed()


# ------------------------------------------------------------------ the parent

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_adam_reference(workdir: str) -> dict:
    """JAX's three adam steps on the 8-device mesh: the state before each
    (in the port's names) and the metrics and state after each."""
    import jax

    from ssd_tpu.config import Config as JaxConfig
    from ssd_tpu.models.detector import Detector as JaxDetector
    from ssd_tpu.parallel import (create_mesh, create_train_state,
                                  jit_train_step, make_optimizer,
                                  make_train_step, shard_batch)
    from ssd_tpu_torch.convert import convert_params, convert_variables

    cfg = tiny_cfg(**ADAM)
    jcfg = JaxConfig.from_json(cfg.to_json())
    det = JaxDetector(jcfg)
    tx = make_optimizer(jcfg)
    jstate = create_train_state(det, jax.random.PRNGKey(0), tx,
                                jcfg.train.ema_decay)
    mesh = create_mesh()
    assert mesh.shape["data"] == 8
    jstep = jit_train_step(make_train_step(det, tx, jcfg.train.ema_decay),
                           mesh)

    def port_state(s) -> dict:
        s = jax.device_get(s)
        adam = s.opt_state[-1][0]
        return {"model": convert_variables({"params": s.params,
                                            "batch_stats": s.batch_stats},
                                           cfg),
                "ema": convert_params(s.ema_params, cfg),
                "mu": convert_params(adam.mu, cfg),
                "nu": convert_params(adam.nu, cfg),
                "count": int(adam.count)}

    pre, post, metrics, batches = [], [], [], []
    for i in range(3):
        batch = tiny_batch(10 + i)
        batches.append(batch)
        pre.append(port_state(jstate))
        jstate, m = jstep(jstate, shard_batch(mesh, batch))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
        post.append(port_state(jstate))
    return {"adam_cfg": cfg.to_json(), "adam_pre": pre,
            "adam_batches": batches, "jax_post": post,
            "jax_metrics": metrics}


def _eval_inputs(workdir: str) -> dict:
    with np.load(EVAL_ASSET, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    shard = os.path.join(workdir, "val-00000-of-00001.tfrecords")
    arrays["shard"].tofile(shard)
    cfg = Config.from_json(str(arrays["config_json"]))
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, val_file_pattern=shard),
        train=dataclasses.replace(
            cfg.train, batch_size=EVAL_ROWS_PER_RANK * WORLD))
    return {"eval_cfg": cfg.to_json(),
            "jax_eval": {k: float(arrays[f"jax/{k}"]) for k in EVAL_KEYS}}


def _run_ranks(workdir: str) -> tuple[list[int], list[str]]:
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "rank", str(r),
         str(WORLD), str(port), workdir],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
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


@pytest.fixture(scope="module")
def ranks():
    """The two ranks' results, with the JAX references they are held to."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as workdir:
        inputs = _jax_adam_reference(workdir)
        inputs.update(_eval_inputs(workdir))
        torch.save(inputs, os.path.join(workdir, "inputs.pt"))
        codes, outs = _run_ranks(workdir)
        if any(codes):  # a gloo rendezvous on a loaded host: once more
            codes, outs = _run_ranks(workdir)
        for code, out in zip(codes, outs):
            assert code == 0, f"rank failed:\n{out[-4000:]}"
        results = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                              weights_only=False) for r in range(WORLD)]
        out = {"rank": results, "inputs": inputs,
               "loop": _loop_files(os.path.join(workdir, "loop")),
               "one_process": _restore_one_process(
                   os.path.join(workdir, "fsdp_ckpt"))}
    torch.set_num_threads(n)
    return out


def _loop_files(loop: str) -> dict | None:
    """What the ranks' ``train()`` left: rank 0's log records, the files,
    the checkpoint steps and a prediction of its export."""
    from ssd_tpu_torch.predictor import Predictor
    if not os.path.isdir(os.path.join(loop, "export")):
        return None
    with open(os.path.join(loop, "metrics.jsonl")) as f:
        records = f.read().splitlines()
    pred = Predictor.from_checkpoint(os.path.join(loop, "export"),
                                     device="cpu")
    return {"records": records, "files": sorted(os.listdir(loop)),
            "ckpt_steps": TrainCheckpointer(
                os.path.join(loop, "checkpoints")).all_steps(),
            "served": pred.predict(tiny_batch(0)["images"][:2])}


def _restore_one_process(directory: str) -> tuple | None:
    """The FSDP ranks' checkpoint restored into one process: the model's
    state and the EMA."""
    if not os.path.isdir(directory):
        return None
    cfg = tiny_cfg(L2, **MOMENTUM)
    det = Detector(cfg, device="cpu")
    state = create_train_state(det, Optimizer(cfg), cfg.train.ema_decay)
    TrainCheckpointer(directory).restore(state)
    return _whole(det.model.state_dict()), _whole(state.ema_params)


def _ok(ranks, case: str) -> list:
    out = [r[case] for r in ranks["rank"]]
    for r, o in enumerate(out):
        assert "error" not in o, f"rank {r}:\n{o['error']}"
    return out


def _assert_bit_identical(a: dict, b: dict, what: str) -> None:
    assert set(a) == set(b), what
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what} {k}"


def _halves_norm(self, x, weight, bias, group=None):
    """``BatchNorm._train_norm`` with the two ranks' arithmetic in one
    process: each half's means, then their average."""
    xf = x.float()
    n = xf.shape[0] // 2

    def avg(v):
        return torch.stack([v[:n].mean(dim=(0, 2, 3)),
                            v[n:].mean(dim=(0, 2, 3))]).sum(0) / 2

    mean, mean_sq = avg(xf), avg(xf.square())
    var = torch.maximum(mean_sq - mean.square(), mean.new_zeros(()))
    return self._affine(x, xf, mean, var, weight, bias), mean, var


def test_three_dp_adam_steps_match_jax_mesh(ranks, monkeypatch):
    """Each step from JAX's state: loss terms rtol 3e-4, grad_norm 1e-3,
    num_positives equal; after it every weight within 2 lr of JAX's and,
    of each leaf, at most 5% (or one weight) beyond 2e-5, every EMA weight
    within 0.2 lr of JAX's (decay 0.9: a weight's flip of 2 lr moves its
    EMA by 0.2 lr), and the BN running statistics, the global batch's,
    within rtol 1e-5, atol 5e-6; both ranks bit-equal.

    The one weight: a 16-channel BN weight moves 3.1e-5 from JAX's in the
    second step. Flax's fast variance ``E[x^2] - E[x]^2`` cancels on the
    2x2 maps of the deepest blocks, so the statistics' summation order
    shows in the gradient (grad_norm 7.6e-4 from JAX's, where the
    one-process port is 9e-7 away). The one-process step whose batch norm
    averages the two halves' means, the ranks' arithmetic, gives the
    ranks' metrics to rtol 1e-6: the deviation is that order, no
    collective's."""
    r0, r1 = _ok(ranks, "adam")
    inputs = ranks["inputs"]
    cfg = Config.from_json(inputs["adam_cfg"])
    lr = cfg.train.learning_rate
    from ssd_tpu_torch.models import layers
    monkeypatch.setattr(layers.BatchNorm, "_train_norm", _halves_norm)
    det = Detector(cfg, device="cpu")
    opt = Optimizer(cfg)
    state = create_train_state(det, opt, cfg.train.ema_decay)
    step = make_train_step(det, opt, cfg.train.ema_decay)
    for i, pre in enumerate(inputs["adam_pre"]):
        det.model.load_state_dict(pre["model"])
        with torch.no_grad():
            for k in ("ema", "mu", "nu"):
                dst = state.ema_params if k == "ema" else state.opt_state[k]
                for name, v in pre[k].items():
                    dst[name].copy_(v)
        state.opt_state["count"] = pre["count"]
        state, m = step(state, inputs["adam_batches"][i])
        _assert_close(_floats(m), r0["steps"][i]["metrics"], 1e-6, 0,
                      f"halves step {i}")
    for i, (s0, s1) in enumerate(zip(r0["steps"], r1["steps"])):
        _assert_bit_identical(s0["model"], s1["model"], f"step {i}")
        _assert_bit_identical(s0["ema"], s1["ema"], f"step {i} ema")
        assert s0["metrics"] == s1["metrics"]
        jm = inputs["jax_metrics"][i]
        m = s0["metrics"]
        assert m["num_positives"] == jm["num_positives"]
        for k in ("loss", "classification_loss", "localization_loss",
                  "regularization_loss"):
            np.testing.assert_allclose(m[k], jm[k], rtol=3e-4,
                                       err_msg=f"step {i} {k}")
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                   rtol=1e-3)
        jax_post = inputs["jax_post"][i]
        assert set(s0["ema"]) == set(jax_post["ema"])
        for k, w in jax_post["ema"].items():
            diff = float((s0["ema"][k] - w).abs().max())
            assert diff <= 0.2 * lr * 1.01, (i, k, diff)
        for k, w in jax_post["model"].items():
            got = s0["model"][k]
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got.numpy(), w.numpy(),
                                           rtol=1e-5, atol=5e-6,
                                           err_msg=f"step {i} {k}")
                continue
            diff = (got - w).abs()
            assert float(diff.max()) <= 2 * lr * 1.001, (i, k)
            off = int((diff > 2e-5).sum())
            assert off <= max(0.05 * diff.numel(), 1), (i, k, off)


def _assert_close(got: dict, want: dict, rtol: float, atol: float,
                  what: str) -> None:
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(
            np.asarray(got[k], np.float64), np.asarray(want[k], np.float64),
            rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def test_two_ranks_equal_one_process_step(ranks):
    """Accumulation over 2 strided microbatches and weight decay: two ranks
    of 4 rows give the one-process step on the 8 rows to rtol 1e-5 (the
    global batch's statistics and normalizers summed in another order),
    metrics exactly so, weights, BN statistics and EMA with atol 1e-6
    besides (a ten-thousandth of the learning rate: the stem's weights,
    downstream of every norm, move up to 3e-7 from the one-process
    step's)."""
    r0, r1 = _ok(ranks, "accum")
    cfg = tiny_cfg(L2, **ACCUM_CFG)
    want = run_steps(cfg, None, 0)[0]
    _assert_bit_identical(r0["model"], r1["model"], "ranks")
    for got_m, want_m in zip(r0["metrics"], want["metrics"]):
        _assert_close(got_m, want_m, 1e-5, 0, "metrics")
    _assert_close(r0["model"], want["model"], 1e-5, 1e-6, "state")
    _assert_close(r0["ema"], want["ema"], 1e-5, 1e-6, "ema")


def test_fsdp_matches_replicated_and_checkpoints_whole(ranks):
    """FSDP's step equals the replicated step within 1e-5 (loss and every
    tensor), the largest leaf's local shard is smaller than the leaf, and
    a checkpoint written under FSDP restores bit-equal into FSDP ranks and
    into one process."""
    r0, r1 = _ok(ranks, "fsdp")
    for got_m, want_m in zip(r0["fsdp"]["metrics"],
                             r0["replicated"]["metrics"]):
        assert abs(got_m["loss"] - want_m["loss"]) < 1e-5
        _assert_close(got_m, want_m, 1e-5, 1e-5, "metrics")
    for part in ("model", "ema"):
        _assert_close(r0["fsdp"][part], r0["replicated"][part], 1e-5, 1e-5,
                      part)
        _assert_bit_identical(r0["fsdp"][part], r1["fsdp"][part], part)
    local, whole = r0["big"]
    assert local < whole and r1["big"][0] < whole
    assert r0["sharded_leaves"] > 0
    assert r0["restored_equal"] and r1["restored_equal"]
    model, ema = ranks["one_process"]
    _assert_bit_identical(model, r0["fsdp"]["model"], "restored model")
    _assert_bit_identical(ema, r0["fsdp"]["ema"], "restored ema")


def test_train_loop_under_the_group(ranks):
    """``train()`` under the group with FSDP: the same final metrics on
    both ranks, rank 0 alone logging (one record a step), checkpoints of
    both steps, and an export that serves."""
    r0, r1 = _ok(ranks, "train")
    assert r0["last"] == r1["last"] and np.isfinite(r0["last"]["loss"])
    loop = ranks["loop"]
    assert len(loop["records"]) == LOOP_STEPS
    assert loop["ckpt_steps"] == list(range(1, LOOP_STEPS + 1))
    assert {"export", "checkpoints", "metrics.jsonl"} <= set(loop["files"])
    assert loop["served"]["boxes"].shape[0] == 2


def test_microbatch_refusal(ranks):
    """JAX's refusal, with its message: a microbatch the data axis does
    not divide; and a batch the ranks do not divide."""
    r0, r1 = _ok(ranks, "refusal")
    assert r0 == r1
    assert r0["micro"] == ("microbatch (8//8) must divide by the data axis "
                           "(2) for grad accumulation")
    assert r0["batch"] == ("train.batch_size (7) must divide by the data "
                           "axis (2)")


def test_unknown_param_sharding_raises(tmp_path):
    from ssd_tpu_torch.train import train
    with pytest.raises(ValueError,
                       match="unknown train.param_sharding: 'zero'"):
        train(tiny_cfg(param_sharding="zero"), str(tmp_path), device="cpu")


def test_gathered_evaluate_gives_jax_numbers(ranks):
    """The trained sanity weights over the eval golden's shard, 6 rows a
    rank, gathered: both ranks the same numbers, JAX's stored ones to
    1e-6."""
    r0, r1 = _ok(ranks, "evaluate")
    want = ranks["inputs"]["jax_eval"]
    assert want["mAP"] > 0.1
    for k in EVAL_KEYS:
        assert r0[k] == r1[k] or (np.isnan(r0[k]) and np.isnan(r1[k])), k
        assert r0[k] == pytest.approx(want[k], abs=1e-6, nan_ok=True), k


# ------------------------------------------------------------ without ranks

def test_pack_and_load_packed_match_jax():
    """The evaluator's packed statistics equal JAX's ``_pack`` on the same
    images, and folding them back gives the same numbers."""
    from ssd_tpu.eval.coco_map import DetectionEvaluator as JaxEvaluator
    from ssd_tpu_torch.eval.coco_map import DetectionEvaluator
    rng = np.random.default_rng(3)
    port, ref = DetectionEvaluator(4), JaxEvaluator(4)
    for _ in range(6):
        d, g = int(rng.integers(0, 9)), int(rng.integers(1, 5))
        lo = rng.uniform(0, 0.6, (d + g, 2))
        boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (d + g, 2))],
                               -1).astype(np.float32)
        args = (boxes[:d], rng.uniform(0, 1, d).astype(np.float32),
                rng.integers(0, 4, d), boxes[d:], rng.integers(0, 4, g))
        kw = dict(gt_is_crowd=rng.uniform(size=g) < 0.2, image_hw=(480, 640))
        port.add_image(*args, **kw)
        ref.add_image(*args, **kw)
    got, want = port._pack(), ref._pack()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    folded = DetectionEvaluator(4)
    padded = dict(got, cls=np.concatenate([got["cls"], [-1, -1]]),
                  scores=np.concatenate([got["scores"], [0.9, 0.8]]),
                  rank=np.concatenate([got["rank"], [0, 0]]),
                  tp=np.concatenate([got["tp"], got["tp"][:2] * 0]),
                  ig=np.concatenate([got["ig"], got["ig"][:2] * 0]))
    folded._load_packed(padded)
    a, b = folded.result(), ref.result()
    for k in EVAL_KEYS:
        assert a[k] == pytest.approx(b[k], abs=0, nan_ok=True), k


def test_meshed_predictor_is_the_plain_one():
    """``Predictor(mesh=)`` over two CPU devices: buckets of multiples of
    2, detections bit-equal to the plain predictor's (an even batch, an
    odd one and one image), and within the golden set rule of JAX's
    ``Predictor(mesh=create_mesh(jax.devices()[:2]))``; the two
    ``spatial_shard`` refusals; ``serve --mesh`` dispatches batch by
    batch (``scan_depth`` 1)."""
    import jax

    from ssd_tpu.export import load_inference_artifact
    from ssd_tpu.parallel import create_mesh as jax_create_mesh
    from ssd_tpu.predictor import Predictor as JaxPredictor
    from ssd_tpu_torch import serve
    from ssd_tpu_torch.data import synthetic
    from ssd_tpu_torch.predictor import Predictor
    from test_torch_slice import assert_set_match

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg, state = load_npz_artifact(sanity.SANITY_NPZ)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype="float32"))
        mesh = mesh_lib.create_mesh(["cpu", "cpu"])
        assert mesh.shape == {"data": 2, "model": 1}
        plain = Predictor(cfg, state, device="cpu")
        meshed = Predictor(cfg, state, mesh=mesh)
        assert len(meshed.replicas) == 2
        assert [meshed._bucket_for(k) for k in (1, 2, 3, 5, 8)] == [
            2, 2, 4, 8, 8]
        images = next(synthetic.sanity_batches(8, sanity.SANITY_SEED_VAL))[0]
        for batch in (images, images[:5], images[3]):
            a, b = plain.predict(batch), meshed.predict(batch)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        got = meshed.predict(images)
        assert int(got["num_boxes"].sum()) > 0

        _, jvars = load_inference_artifact(os.path.join(
            ROOT, "bench_assets", "sanity_artifact"))
        from ssd_tpu.config import Config as JaxConfig
        jpred = JaxPredictor(JaxConfig.from_json(cfg.to_json()), jvars,
                             mesh=jax_create_mesh(jax.devices()[:2]))
        assert_set_match(got, jpred.predict(images))

        with pytest.raises(ValueError, match="spatial_shard requires a mesh"):
            Predictor(cfg, state, device="cpu", spatial_shard=True)
        with pytest.raises(NotImplementedError, match="M11b"):
            Predictor(cfg, state, mesh=mesh, spatial_shard=True)
        server, _ = serve.build(["--export", sanity.SANITY_NPZ, "--device",
                                 "cpu", "--mesh", "--scan-depth", "4",
                                 "--port", "0", "--warmup-batches", ""])
        try:
            assert server.predictor.mesh is not None
            assert server.dispatcher.scan_depth == 1
        finally:
            server.httpd.server_close()
    finally:
        torch.set_num_threads(n)


if __name__ == "__main__" and sys.argv[1:2] == ["rank"]:
    rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
              sys.argv[5])
