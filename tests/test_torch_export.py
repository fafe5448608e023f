"""The inference artifact directory and the exported predict program
(``ssd_tpu_torch/export.py``) against the JAX package's ``export.py`` on
the CPU, on the 64 px f32 model of ``tests/test_export.py`` with seeded
weights in JAX's tree (``convert.convert_variables``):

* the artifact round trip keeps the config equal, the state bit-equal and
  the label map; an ``int8_neck`` config without scales raises on save; a
  single-file ``.npz`` of the earlier layout loads, and a JAX (orbax)
  directory raises, naming the way across;
* ``Predictor.from_checkpoint`` gives ``names``; ``warm_start`` from a
  directory of another class count copies the stem and keeps the class
  head fresh;
* the loaded ``.pt2`` program bit-equal to eager ``Detector.predict`` at
  b2, K1's operator in its graph, and within the golden set rule of JAX's
  StableHLO program; ``export_savedmodel`` refuses;
* the CLI: a training checkpoint to the artifact (the train loop's own
  export, bit for bit) and the program; ``--savedmodel`` refuses; every
  CLI takes ``--export DIR``.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from ssd_tpu.config import Config as JaxConfig
from ssd_tpu.export import export_stablehlo, load_stablehlo
from ssd_tpu.export import save_inference_artifact as jax_save_artifact
from ssd_tpu.models.detector import Detector as JaxDetector
from ssd_tpu_torch import export, quant, serve
from ssd_tpu_torch.config import Config
from ssd_tpu_torch.convert import convert_variables, load_npz_artifact
from ssd_tpu_torch.eval import __main__ as eval_cli
from ssd_tpu_torch.eval import sanity
from ssd_tpu_torch.models.detector import Detector
from ssd_tpu_torch.predictor import Predictor
from ssd_tpu_torch.predictor import main as predictor_main
from ssd_tpu_torch.tools import bench_http
from ssd_tpu_torch.train import EXPORT_NAME, train, warm_start
from ssd_tpu_torch.train_step import Optimizer, create_train_state
from tests.test_torch_model import seeded_variables
from tests.test_torch_slice import assert_set_match
from tests.test_torch_train import loop_batches, loop_cfg

TORCH_THREADS = 1
DET_KEYS = ("boxes", "scores", "labels", "num_boxes")
MODEL = dict(num_classes=3, image_size=64,
             model=dict(backbone="mobilenet", width_multiplier=0.25,
                        fpn_channels=32, head_depth=1,
                        compute_dtype="float32"),
             nms=dict(max_boxes=8, num_candidates=64, pre_nms_top_k=32))
LABELS = {0: "a", 1: "b", 2: "c"}


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


def _jax_model(seed: int):
    """JAX's variable tree of MODEL, seeded, class bias -1 (detections)."""
    jcfg = JaxConfig.from_dict(MODEL)
    abstract = jax.eval_shape(
        lambda: JaxDetector(jcfg).init(jax.random.PRNGKey(0)))
    return jcfg, seeded_variables(abstract, seed=seed, class_bias=-1.0)


@pytest.fixture(scope="module")
def model():
    """(JAX config, JAX variables, port config, port state)."""
    jcfg, variables = _jax_model(3)
    cfg = Config.from_dict(MODEL)
    return jcfg, variables, cfg, convert_variables(variables, cfg)


def _images(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 255, (n, 64, 64, 3)).astype(np.uint8)


# ------------------------------------------------------------- the artifact

def test_artifact_roundtrip(model, tmp_path):
    _, _, cfg, state = model
    path = str(tmp_path / "e")
    export.save_inference_artifact(path, cfg, state, label_map=LABELS)
    assert sorted(os.listdir(path)) == ["config.json", "label_map.json",
                                        "variables.npz"]
    cfg2, state2 = export.load_inference_artifact(path)
    assert cfg2 == cfg
    assert set(state2) == set(state)
    for k, v in state.items():
        assert torch.equal(state2[k], v), k
    with open(tmp_path / "e" / "label_map.json") as f:
        assert json.load(f)["1"] == "b"
    assert export.load_artifact_label_map(path) == LABELS
    # written again without a label map: none is left behind
    export.save_inference_artifact(path, cfg, state)
    assert export.load_artifact_label_map(path) is None


def test_int8_neck_without_scales_raises(model, tmp_path):
    _, _, cfg, state = model
    qcfg = quant.int8_config(cfg)
    with pytest.raises(ValueError, match="calibrate"):
        export.save_inference_artifact(str(tmp_path / "q"), qcfg, state)
    assert not os.path.exists(tmp_path / "q" / "variables.npz")


def test_single_file_npz_and_jax_directory(model, tmp_path):
    """The ``.npz`` of the earlier layout loads as it did; JAX's own
    directory (orbax weights) raises, naming the route across."""
    jcfg, variables, _, _ = model
    cfg, state = export.load_inference_artifact(sanity.SANITY_NPZ)
    want_cfg, want = load_npz_artifact(sanity.SANITY_NPZ)
    assert cfg == want_cfg and set(state) == set(want)
    assert all(torch.equal(state[k], want[k]) for k in want)
    assert export.load_artifact_label_map(sanity.SANITY_NPZ) is None
    jax_dir = str(tmp_path / "jax")
    jax_save_artifact(jax_dir, jcfg, variables)
    with pytest.raises(ValueError, match="orbax.*convert_variables"):
        export.load_inference_artifact(jax_dir)
    with pytest.raises(FileNotFoundError):
        export.load_inference_artifact(str(tmp_path / "nothing"))


def test_predictor_names(model, tmp_path):
    _, _, cfg, state = model
    path = str(tmp_path / "e")
    export.save_inference_artifact(path, cfg, state, label_map=LABELS)
    p = Predictor.from_checkpoint(path, device="cpu")
    image = _images(1)[0]
    out = p.predict(image)
    assert out["names"].shape == (cfg.nms.max_boxes,)
    n = int(out["num_boxes"])
    assert n > 0
    assert list(out["names"][:n]) == [LABELS[int(x)]
                                      for x in out["labels"][:n]]


def test_warm_start_copies_matching_leaves(model, tmp_path):
    cfg = model[2]
    donor = convert_variables(_jax_model(7)[1], cfg)
    export.save_inference_artifact(str(tmp_path / "donor"), cfg, donor)
    # a new task: another class count, so the class head's predict differs
    cfg2 = dataclasses.replace(cfg, num_classes=5)
    state = create_train_state(Detector(cfg2, device="cpu"), Optimizer(cfg2),
                               seed=0)
    fresh = state.params["head.class_net.predict.weight"].clone()
    state2 = warm_start(state, str(tmp_path / "donor"))
    stem = "backbone.stem.conv.weight"
    assert torch.equal(state2.params[stem], donor[stem])
    assert torch.equal(state2.params["head.class_net.predict.weight"], fresh)


# ------------------------------------------------------------- the program

def test_program_matches_eager_and_stablehlo(model, tmp_path):
    jcfg, variables, cfg, state = model
    images = _images(2)
    want = Detector(cfg, state, device="cpu").predict(images)
    path = export.export_program(str(tmp_path / "p"), cfg, state,
                                 batch_size=2, device="cpu")
    assert os.path.basename(path) == "predict_b2_64x64.pt2"
    assert "ssd_tpu_torch.nms_suppress" in (
        torch.export.load(path).graph_module.code)
    program = export.load_program(path)
    got = program(images)
    for k in DET_KEYS:
        assert torch.equal(got[k], getattr(want, k)), k
    with pytest.raises(Exception):  # one (batch, resolution) a program
        program(_images(1))
    hlo = load_stablehlo(export_stablehlo(str(tmp_path / "hlo"), jcfg,
                                          variables, batch_size=2))(images)
    assert int(got["num_boxes"].min()) > 0
    assert_set_match({k: got[k].numpy() for k in DET_KEYS},
                     {k: np.asarray(hlo[k]) for k in DET_KEYS})


def test_savedmodel_refuses(model, tmp_path):
    _, _, cfg, state = model
    with pytest.raises(NotImplementedError, match="TensorFlow"):
        export.export_savedmodel(str(tmp_path), cfg, state)


# ------------------------------------------------------------- the CLIs

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2-step run of the train loop (config.json beside it, as the train
    CLI writes it), with its own ``export/``."""
    workdir = str(tmp_path_factory.mktemp("run"))
    cfg = loop_cfg()
    cfg.save(os.path.join(workdir, "config.json"))
    train(cfg, workdir, loop_batches(), max_steps=2, device="cpu")
    return workdir, cfg


def test_export_cli(trained, tmp_path, capsys):
    workdir, cfg = trained
    out = str(tmp_path / "art")
    export.main(["--workdir", workdir, "--output", out, "--program",
                 "--batch-size", "2", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "(step 2)" in printed and "predict_b2_64x64.pt2" in printed
    got_cfg, got = export.load_inference_artifact(out)
    want_cfg, want = export.load_inference_artifact(
        os.path.join(workdir, EXPORT_NAME))
    assert got_cfg == want_cfg == cfg and set(got) == set(want)
    for k in want:  # the EMA weights, as the loop's export has them
        assert torch.equal(got[k], want[k]), k
    program = export.load_program(os.path.join(out, "predict_b2_64x64.pt2"))
    images = _images(2, seed=1)
    eager = Detector(cfg, got, device="cpu").predict(images)
    ran = program(images)
    for k in DET_KEYS:
        assert torch.equal(ran[k], getattr(eager, k)), k
    with pytest.raises(NotImplementedError, match="TensorFlow"):
        export.main(["--workdir", workdir, "--savedmodel", "--device",
                     "cpu"])


def test_every_cli_takes_export(trained, tmp_path, capsys):
    """``--export DIR`` on the predictor, serve, quant, eval and bench_http
    CLIs; quant writes a directory; ``--export`` and ``--npz`` (its older
    name) together are refused."""
    workdir, _ = trained
    art = os.path.join(workdir, EXPORT_NAME)
    image = str(tmp_path / "a.png")
    from PIL import Image
    Image.fromarray(_images(1, seed=2)[0]).save(image)
    out = str(tmp_path / "dets.json")
    predictor_main(["--export", art, "--images", image, "--out", out,
                    "--device", "cpu"])
    with open(out) as f:
        assert json.load(f)[0]["image"] == image
    qdir = str(tmp_path / "int8")
    quant.main(["--export", art, "--output", qdir, "--images", image,
                "--batch-size", "1", "--device", "cpu"])
    qcfg, qstate = export.load_inference_artifact(qdir)
    assert qcfg.model.compute_dtype == "int8"
    assert any("act_scale_" in k for k in qstate)
    # the older flag name takes a directory as well as a file
    bdir = str(tmp_path / "int8_backbone")
    quant.main(["--npz", art, "--output", bdir, "--backbone-only",
                "--device", "cpu"])
    assert os.path.isfile(os.path.join(bdir, export.VARIABLES_FILE))
    assert not export.load_inference_artifact(bdir)[0].model.int8_neck
    npz = sanity.SANITY_NPZ
    for main in (predictor_main, serve.main, eval_cli.main, quant.main,
                 bench_http.main):
        with pytest.raises(SystemExit):
            main(["--export", art, "--npz", npz, "--images", image,
                  "--output", qdir])
        assert "not allowed with argument" in capsys.readouterr().err
    # the eval CLI loads the directory, then finds no val shards
    with pytest.raises(FileNotFoundError):
        eval_cli.main(["--export", art, "--val-pattern",
                       str(tmp_path / "none-*"), "--device", "cpu"])
