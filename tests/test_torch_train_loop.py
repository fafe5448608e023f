"""The rest of the port's training path against the JAX package's, on the
CPU: warm start, evaluation during training, the loop on the tfrecord
pipeline and the CLI (distillation: ``test_torch_distill.py``).

Small sizes (64 px, MobileNet x0.25, FPN 16, head depth 1, 8 classes,
batch 4; the trained 128 px sanity artifact for the mAP). Held here:

* ``warm_start`` from a donor of another class count copies JAX's leaves;
* ``evaluate`` gives JAX's mAP on the same weights, over the shard of
  ``ssd_tpu_torch/assets/eval_golden_v1.npz`` (the card's reference for
  ``evaluate``: the sanity scenes' JPEG bytes, the config and JAX's
  numbers; a test checks it is current, ``python
  tests/test_torch_train_loop.py regen`` rewrites it);
* the loop on a PIL-written tfrecord dataset: 2 + 2 resumed steps equal 4
  bit for bit, evaluation (on the EMA) leaves training bit-identical,
  ``best/`` serves, a teacher run logs ``distill_loss``, a bad teacher
  fails before any checkpoint, and the CLI (``--device cpu``) resumes.
"""

import dataclasses
import io
import json
import os
import sys
import tempfile

if __name__ == "__main__":  # regen: JAX on the CPU, as tests/conftest.py sets
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np
import pytest
import torch

from ssd_tpu import train as jax_train
from ssd_tpu.export import load_inference_artifact, save_inference_artifact
from ssd_tpu.models.detector import Detector as JaxDetector
from ssd_tpu.parallel.train_step import (
    create_train_state as jax_create_train_state)
from ssd_tpu.parallel.train_step import (
    make_optimizer as jax_make_optimizer)
from ssd_tpu_torch.config import Config, DataConfig
from ssd_tpu_torch.convert import (convert_params, convert_variables,
                                   load_npz_artifact, save_npz_artifact)
from ssd_tpu_torch.data import synthetic
from ssd_tpu_torch.data.tfrecord import RecordWriter, encode_detection_example
from ssd_tpu_torch.eval import sanity
from ssd_tpu_torch.export import load_inference_artifact as load_artifact
from ssd_tpu_torch.models.detector import Detector
from ssd_tpu_torch.predictor import Predictor
from ssd_tpu_torch.train import (BEST_NAME, EXPORT_NAME, evaluate, main,
                                 train, warm_start)
from ssd_tpu_torch.train_step import Optimizer, create_train_state
from test_torch_pipeline import write_dataset
from test_torch_train import jax_cfg, small_batch, small_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SANITY_ARTIFACT = os.path.join(ROOT, "bench_assets", "sanity_artifact")
EVAL_ASSET = os.path.join(ROOT, "ssd_tpu_torch", "assets",
                          "eval_golden_v1.npz")
EVAL_KEYS = ("mAP", "AP50", "AP75", "AP_small", "AP_medium", "AP_large",
             "AR@1", "AR@10", "AR@100", "AR_small", "AR_medium", "AR_large")
EVAL_BATCH = 12  # 32 scenes: two full batches and a padded tail


# ------------------------------------------------------------------ warm start

def test_warm_start_copies_jax_leaves(tmp_path, capsys):
    """A donor of another class count: both packages copy every leaf but
    the class head's prediction conv, the same values, and re-seed the
    EMA."""
    cfg = small_cfg(ema_decay=0.9)
    donor_cfg = dataclasses.replace(cfg, num_classes=5)
    donor = jax.device_get(jax.jit(JaxDetector(jax_cfg(donor_cfg)).init)(
        jax.random.PRNGKey(7)))
    save_inference_artifact(str(tmp_path / "donor"), jax_cfg(donor_cfg),
                            donor)
    save_npz_artifact(str(tmp_path / "donor.npz"), donor_cfg,
                      convert_variables(donor, donor_cfg))
    jcfg = jax_cfg(cfg)
    jdet = JaxDetector(jcfg)
    jstate = jax.jit(lambda key: jax_create_train_state(
        jdet, key, jax_make_optimizer(jcfg), 0.9))(jax.random.PRNGKey(0))
    jstate = jax_train.warm_start(jstate, str(tmp_path / "donor"))
    jax_out = capsys.readouterr().out
    det = Detector(cfg, device="cpu")
    opt = Optimizer(cfg)
    state = warm_start(create_train_state(det, opt, 0.9, seed=0),
                       str(tmp_path / "donor.npz"))
    out = capsys.readouterr().out
    counts = [line.split(" from ")[0] for line in out.splitlines()]
    assert counts == [line.split(" from ")[0]
                      for line in jax_out.splitlines()]
    assert counts[0].startswith("warm_start: copied ")
    n, total = counts[0].split()[2].split("/")
    assert int(n) == int(total) - 2  # all but class_net.predict's two
    jstate = jax.device_get(jstate)
    want = convert_variables({"params": jstate.params,
                              "batch_stats": jstate.batch_stats}, cfg)
    donor_state = convert_variables(donor, donor_cfg)
    got = det.model.state_dict()
    for k, v in donor_state.items():
        if got[k].shape == v.shape:
            assert torch.equal(got[k], v), k
            assert torch.equal(want[k], v), k
    for k, v in convert_params(jstate.ema_params, cfg).items():
        assert torch.equal(state.ema_params[k], state.params[k]), k
        if k in donor_state and v.shape == donor_state[k].shape:
            assert torch.equal(v, donor_state[k]), k


# ------------------------------------------------------------------ evaluate

def _sanity_val_shard(path: str) -> None:
    """The 32 held-out sanity scenes as JPEGs (PIL, quality 95)."""
    from PIL import Image
    with RecordWriter(path) as w:
        i = 0
        for images, boxes, labels, num, valid in synthetic.sanity_batches(
                sanity.SANITY_VAL_IMAGES, sanity.SANITY_SEED_VAL):
            for j in np.flatnonzero(valid):
                buf = io.BytesIO()
                Image.fromarray(images[j]).save(buf, format="JPEG",
                                                quality=95)
                w.write(encode_detection_example(
                    buf.getvalue(), boxes[j, :num[j]], labels[j, :num[j]],
                    source_id=i, image_hw=images[j].shape[:2]))
                i += 1


def eval_cfg(val_pattern: str) -> Config:
    """The sanity artifact's config in f32, evaluated in batches of
    ``EVAL_BATCH`` from ``val_pattern``."""
    cfg, _ = load_npz_artifact(sanity.SANITY_NPZ)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, val_file_pattern=val_pattern),
        train=dataclasses.replace(cfg.train, batch_size=EVAL_BATCH))


def eval_golden_arrays() -> dict:
    """The eval golden's arrays: the shard's bytes, the config (no val
    pattern) and JAX's ``evaluate`` of the trained sanity artifact over
    the shard."""
    with tempfile.TemporaryDirectory() as root:
        shard = os.path.join(root, "val-00000-of-00001.tfrecords")
        _sanity_val_shard(shard)
        jcfg = jax_cfg(eval_cfg(os.path.join(root, "val-*-of-*")))
        _, jvars = load_inference_artifact(SANITY_ARTIFACT)
        want = jax_train.evaluate(
            JaxDetector(jcfg), dataclasses.make_dataclass(
                "S", ["params", "batch_stats"])(
                jvars["params"], jvars["batch_stats"]), jcfg, 0, 1)
        blob = np.fromfile(shard, np.uint8)
    out = {"shard": blob, "config_json": np.array(eval_cfg("").to_json())}
    out.update({f"jax/{k}": np.float64(want[k]) for k in EVAL_KEYS})
    return out


def test_evaluate_gives_jax_map(tmp_path):
    """The trained sanity artifact in f32 on its 32 held-out scenes, read
    from a tfrecord shard in eval batches of 12 (a padded tail): the port's
    ``evaluate`` gives JAX's mAP, APs and ARs to 1e-6, and the committed
    eval golden holds this shard and these numbers."""
    want = eval_golden_arrays()
    with np.load(EVAL_ASSET, allow_pickle=False) as z:
        committed = {k: z[k] for k in z.files}
    assert set(committed) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(committed[k], v, err_msg=k)
    assert want["jax/mAP"] > 0.1
    assert os.path.getsize(EVAL_ASSET) < 1 << 20
    committed["shard"].tofile(str(tmp_path / "val-00000-of-00001.tfrecords"))
    cfg = eval_cfg(str(tmp_path / "val-*-of-*"))
    assert Config.from_json(str(committed["config_json"])) == eval_cfg("")
    _, state = load_npz_artifact(sanity.SANITY_NPZ)
    got = evaluate(Detector(cfg, state, device="cpu"), cfg)
    for k in EVAL_KEYS:
        assert got[k] == pytest.approx(float(want[f"jax/{k}"]), abs=1e-6,
                                       nan_ok=True), k


# ------------------------------------------------------------------ the loop

@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loop"))
    train_pattern = write_dataset(root, 24, 3, [(48, 64), (96, 80), (64, 64)],
                                  5)
    val_pattern = write_dataset(root, 6, 1, [(64, 64), (80, 60)], 6, "val")
    return train_pattern, val_pattern


def loop_cfg(datasets, **train_kw) -> Config:
    train_pattern, val_pattern = datasets
    kw = dict(optimizer="adam", learning_rate=1e-3, warmup_steps=2,
              ema_decay=0.9, checkpoint_every=100, log_every=1,
              keep_checkpoints=3, multiscale=(64, 96), multiscale_every=2,
              eval_every=2)
    kw.update(train_kw)
    cfg = small_cfg(**kw)
    return dataclasses.replace(cfg, data=DataConfig(
        train_file_pattern=train_pattern, val_file_pattern=val_pattern,
        max_gt_boxes=12, mosaic_probability=0.5, num_workers=2))


def _ckpt(workdir: str, step: int) -> dict:
    return torch.load(os.path.join(workdir, "checkpoints",
                                   f"ckpt_{step:010d}.pt"), weights_only=True)


def _assert_same_state(a: dict, b: dict) -> None:
    for key in ("params", "batch_stats", "ema_params"):
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    for k in ("mu", "nu"):
        for name in a["opt_state"][k]:
            assert torch.equal(a["opt_state"][k][name],
                               b["opt_state"][k][name]), (k, name)


def test_resume_through_the_pipeline_is_exact(datasets, tmp_path):
    """train() to 4 == train() to 2, then resumed to 4, on the tfrecord
    pipeline at two scales with an evaluation every 2 steps: every weight,
    statistic, moment and EMA weight bit for bit, and the pipeline's
    position. ``best/`` holds the EMA weights of its step and serves."""
    cfg = loop_cfg(datasets)
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    train(cfg, full, max_steps=4, device="cpu")
    train(cfg, part, max_steps=2, device="cpu")
    train(cfg, part, max_steps=4, device="cpu")
    a, b = _ckpt(full, 4), _ckpt(part, 4)
    assert a["iterator"] == b["iterator"] == {"epoch": 0, "position": 4,
                                              "seed": 0}
    _assert_same_state(a, b)
    with open(os.path.join(full, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    evals = [r for r in records if "mAP" in r]
    assert [r["step"] for r in evals] == [2, 4]
    assert {tuple(r["image_hw"]) for r in records if "image_hw" in r} == {
        (64, 64), (96, 96)}
    best_cfg, best = load_artifact(os.path.join(full, BEST_NAME))
    assert best_cfg.to_json() == cfg.to_json()
    # the first evaluation writes it; a later one only if mAP improves
    best_step = 4 if evals[1]["mAP"] > evals[0]["mAP"] else 2
    ema = (a if best_step == 4 else _ckpt(part, 2))["ema_params"]
    for k, v in ema.items():
        assert torch.equal(best[k], v), k
    pred = Predictor.from_checkpoint(os.path.join(full, BEST_NAME),
                                     device="cpu")
    assert pred.label_map == {i: f"class_{i}" for i in range(8)}
    out = pred.predict(small_batch(0)["images"])
    assert np.isfinite(out["scores"]).all()


def test_evaluation_leaves_training_bit_identical(datasets, tmp_path):
    """Evaluating after every step (on a separate detector loaded with the
    EMA weights) changes nothing: the same checkpoint as without it, and
    the training model stays in train mode with its own weights."""
    with_eval, without = str(tmp_path / "a"), str(tmp_path / "b")
    train(loop_cfg(datasets, eval_every=1), with_eval, max_steps=3,
          device="cpu")
    train(loop_cfg(datasets, eval_every=0), without, max_steps=3,
          device="cpu")
    _assert_same_state(_ckpt(with_eval, 3), _ckpt(without, 3))
    ema_export = load_artifact(os.path.join(without, EXPORT_NAME))[1]
    for k, v in _ckpt(without, 3)["ema_params"].items():
        assert torch.equal(ema_export[k], v), k


def test_teacher_run_and_warm_start(datasets, tmp_path, capsys):
    """A student warm-started from a run's export and distilled from it:
    every leaf copied, ``distill_loss`` finite in every record; a teacher
    of another class count fails before any checkpoint is written."""
    first = str(tmp_path / "first")
    train(loop_cfg(datasets, eval_every=0), first, max_steps=1, device="cpu")
    export = os.path.join(first, EXPORT_NAME)
    cfg = loop_cfg(datasets, eval_every=0, distill_from=export,
                   init_from=export)
    capsys.readouterr()
    second = str(tmp_path / "second")
    last = train(cfg, second, max_steps=2, device="cpu")
    out = capsys.readouterr().out
    copied = [line for line in out.splitlines()
              if line.startswith("warm_start: copied")]
    for line in copied:
        n, total = line.split()[2].split("/")
        assert n == total
    assert len(copied) == 2 and "distillation: teacher" in out
    assert np.isfinite(last["distill_loss"])
    with open(os.path.join(second, "metrics.jsonl")) as f:
        assert all(np.isfinite(json.loads(line)["distill_loss"])
                   for line in f)
    other = str(tmp_path / "other.npz")
    cfg5, state5 = load_artifact(export)
    cfg5 = dataclasses.replace(cfg5, num_classes=5)
    det5 = Detector(cfg5, device="cpu")
    save_npz_artifact(other, cfg5, det5.model.state_dict())
    bad = str(tmp_path / "bad")
    with pytest.raises(ValueError, match="classes"):
        train(loop_cfg(datasets, distill_from=other), bad, max_steps=1,
              device="cpu")
    assert not os.path.exists(os.path.join(bad, "checkpoints"))


def test_cli_on_the_cpu_profiles_and_resumes(datasets, tmp_path, capsys):
    cfg = loop_cfg(datasets, eval_every=0)
    path = str(tmp_path / "cfg.json")
    cfg.save(path)
    workdir = str(tmp_path / "run")
    args = ["--config", path, "--workdir", workdir, "--device", "cpu",
            "--max-steps", "11", "--profile", "1"]
    main(args)
    first = capsys.readouterr().out
    assert "step=11 " in first and "profiler: tracing 1 steps" in first
    summary = json.loads(first.strip().splitlines()[-1])
    assert summary["kernel_launches"] == {"match": 0, "nms": 0}
    assert Config.load(os.path.join(workdir, "config.json")).to_json() \
        == cfg.to_json()
    # the 11th step profiled: its spans, and no wait for a card here
    with open(os.path.join(workdir, "profile", "summary.json")) as f:
        prof = json.load(f)
    assert prof["span_calls"] == {"train.feed": 1, "train.step": 1,
                                  "train.log": 1}
    assert prof["syncs"] == [] and prof["device_ops"] == 0
    assert os.path.getsize(os.path.join(workdir, "profile", "trace.json"))
    main(args)
    again = capsys.readouterr().out
    assert "resumed from step 11" in again and "step=" not in again
    assert os.path.exists(os.path.join(workdir, EXPORT_NAME))
    with pytest.raises(SystemExit):
        main(["--config", str(tmp_path / "missing.json"), "--workdir",
              workdir])


def test_quant_calibrates_from_tfrecords(tmp_path):
    """``quant --data``: the eval pipeline's batches of a tfrecord glob,
    JAX's calibration batches bit for bit, calibrate the artifact as the
    same arrays passed in directly do."""
    from ssd_tpu.quant import _batches_from_tfrecords as jax_batches
    from ssd_tpu_torch import quant
    _sanity_val_shard(str(tmp_path / "val-00000-of-00001.tfrecords"))
    pattern = str(tmp_path / "val-*-of-*")
    cfg, _ = load_npz_artifact(sanity.SANITY_NPZ)
    got = list(quant.batches_from_tfrecords(pattern, cfg, 8, 2))
    want = list(jax_batches(pattern, jax_cfg(cfg), 8, 2))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    out, direct = str(tmp_path / "a"), str(tmp_path / "b")
    quant.main(["--npz", sanity.SANITY_NPZ, "--output", out, "--data",
                pattern, "--batch-size", "8", "--batches", "2", "--device",
                "cpu"])
    quant.quantize_artifact(sanity.SANITY_NPZ, direct, got, device="cpu")
    a, b = load_artifact(out)[1], load_artifact(direct)[1]
    assert set(a) == set(b) and any(k.rsplit(".", 1)[-1].startswith(
        "act_scale_") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_bench_train_on_the_cpu(tmp_path, capsys):
    """``tools/bench_train``: JAX's synthetic batch draw for draw, and the
    protocol runs (``--set`` applied, finite loss, one JSON line)."""
    from ssd_tpu.tools.bench_train import synthetic_batch as jax_batch
    from ssd_tpu_torch.tools import bench_train
    cfg = small_cfg()
    got = bench_train.synthetic_batch(cfg, 3, seed=2)
    want = jax_batch(jax_cfg(cfg), 3, seed=2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype, k
    path = str(tmp_path / "cfg.json")
    cfg.save(path)
    result = bench_train.main(["--config", path, "--batch", "2", "--steps",
                               "2", "--warmup", "1", "--set",
                               "train.ema_decay=0.9", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip()) == result
    assert result["step_ms"] > 0 and np.isfinite(result["loss"])
    assert result["match_launches"] == 0 and result["device"] == "cpu"


def test_scaleout_check_two_gloo_ranks_on_the_cpu():
    """``tools/scaleout_check``, as ``chip_smoke.py``'s phase ``scaleout``
    (e) runs it on the card, at 128 px and width 0.25: ``torchrun`` of
    bench_train as two gloo ranks, with FSDP, against the one-process step
    on the same 4 rows over three steps of the flagship's recipe: the
    ranks bit-identical, within the tool's f32 bars."""
    from ssd_tpu_torch.tools import scaleout_check
    path = os.path.join(ROOT, "configs", "coco_mobilenet_640_flagship.json")
    row = scaleout_check.run(path, 2, 4, device="cpu", overrides=[
        "image_size=128", "model.width_multiplier=0.25",
        "model.compute_dtype=float32", "model.fpn_channels=16",
        "model.head_depth=1", "train.param_sharding=fsdp"])
    assert row["ok"] and row["ranks_bit_identical"], row
    assert row["param_sharding"] == "fsdp" and row["ranks"] == 2
    assert row["vs_one_process"]["max_abs_diff"] < 1e-5, row


if __name__ == "__main__":
    if sys.argv[1:] == ["regen"]:
        np.savez_compressed(EVAL_ASSET, **eval_golden_arrays())
        print(f"wrote {EVAL_ASSET} ({os.path.getsize(EVAL_ASSET)} bytes)")
