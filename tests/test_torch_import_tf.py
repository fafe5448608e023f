"""``ssd_tpu_torch/tools/import_tf.py`` against ``ssd_tpu/tools/import_tf.py``.

The weights are ``convert.seeded_state`` of a TINY reference-schedule
config (every leaf distinct, the class head's bias -2.5 so that the model
detects), and the flax tree made from them. Held here:

* the port's ``parameter_spec`` equals JAX's entry for entry (TINY and
  the shipped reference config);
* ``ssd_tpu_torch/assets/tf_ckpt_v1/``, a TF1 ``Saver`` checkpoint of those
  weights under foreign scopes (``FeatureExtractor/...``, a name map
  beside it), written by TensorFlow in a subprocess by ``regen`` (as
  ``tests/test_import_tf.py`` writes its own): read by the port's own
  bundle reader, every tensor equals the weights bit for bit; imported by
  the port, it equals ``convert_variables`` of JAX's import of the same
  checkpoint (TensorFlow's reader) bit for bit;
* a ``.keras`` file of the JAX package's Keras mirror
  (``tests/test_tf_parity.build_keras_mirror``) with the weights
  transplanted: the port's import of the file equals ``convert_variables``
  of JAX's import of the live model bit for bit;
* a missing layer, a wrong shape and dense4 fail with JAX's messages;
* the CLI writes an artifact that serves (``--device cpu``), and
  ``--dry-run`` prints JAX's lines; without h5py the Keras reader raises,
  naming the checkpoint path.

    python tests/test_torch_import_tf.py regen
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":  # regen: JAX on the CPU, as tests/conftest.py sets
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from ssd_tpu.config import Config as JaxConfig  # noqa: E402
from ssd_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from ssd_tpu.config import NMSConfig as JaxNMSConfig  # noqa: E402
from ssd_tpu.models.detector import Detector as JaxDetector  # noqa: E402
from ssd_tpu.tools import import_tf as jax_import  # noqa: E402
from ssd_tpu_torch.config import Config  # noqa: E402
from ssd_tpu_torch.convert import convert_variables, seeded_state  # noqa: E402
from ssd_tpu_torch.tools import import_tf  # noqa: E402
from tests.test_torch_backbones_golden import flax_tree  # noqa: E402

ASSET = os.path.join(ROOT, "ssd_tpu_torch", "assets", "tf_ckpt_v1")
PREFIX = os.path.join(ASSET, "model.ckpt")
SEED, CLASS_BIAS = 3, -2.5
SPEC_FIELDS = ("collection", "path", "layer", "suffix", "depthwise", "shape")

_WRITE_CKPT = """\
import sys, numpy as np, tensorflow as tf
tf1 = tf.compat.v1
tf1.disable_eager_execution()
data = np.load(sys.argv[1])
g = tf1.Graph()
with g.as_default():
    for name in data.files:
        tf1.get_variable(name, initializer=data[name])
    saver = tf1.train.Saver()
    with tf1.Session() as sess:
        sess.run(tf1.global_variables_initializer())
        saver.save(sess, sys.argv[2], write_meta_graph=False)
"""


def tiny_jax_config(width: float = 0.125) -> JaxConfig:
    """A TINY reference-schedule config: 64 px, MobileNet-v1 x0.125 (under
    100 000 weights; the Keras mirror is built at x0.25 only), FPN 16, one
    head layer, 4 classes, f32."""
    return JaxConfig(
        num_classes=4, image_size=64,
        model=JaxModelConfig(backbone="mobilenet", width_multiplier=width,
                             fpn_channels=16, head_depth=1,
                             compute_dtype="float32"),
        nms=JaxNMSConfig(use_pallas=False, score_threshold=0.05))


def weights(width: float = 0.125) -> tuple[Config, dict, dict]:
    """-> (port config, port state, JAX variables) of the same weights."""
    jcfg = tiny_jax_config(width)
    cfg = Config.from_json(jcfg.to_json())
    state = seeded_state(cfg, SEED, class_bias=CLASS_BIAS)
    jdet = JaxDetector(jcfg)
    abstract = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0)))
    return cfg, state, flax_tree(state, abstract)


def checkpoint_dump(cfg: Config, variables: dict) -> tuple[dict, dict]:
    """The checkpoint's tensors ({TF name: array in TF layout}) under
    ``FeatureExtractor/<layer path>`` scopes, and the name map."""
    name_map, dump = {}, {}
    for e in jax_import.parameter_spec(JaxConfig.from_json(cfg.to_json())):
        scope = "FeatureExtractor/" + e.layer.replace(".", "/")
        name_map[e.layer] = scope
        w = variables[e.collection]
        for k in e.path:
            w = w[k]
        w = np.asarray(w)
        if e.depthwise:  # TF layout
            w = w.transpose(0, 1, 3, 2)
        dump[f"{scope}/{e.suffix}"] = w
    return dump, name_map


def write_checkpoint(dump: dict, prefix: str, tmp: str) -> None:
    """TensorFlow's TF1 ``Saver`` writes ``dump`` at ``prefix``, in a
    subprocess (graph mode is global and would poison Keras here)."""
    np.savez(os.path.join(tmp, "vars.npz"), **dump)
    script = os.path.join(tmp, "write_ckpt.py")
    with open(script, "w") as f:
        f.write(_WRITE_CKPT)
    r = subprocess.run([sys.executable, script,
                        os.path.join(tmp, "vars.npz"), prefix],
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def regen() -> None:
    import shutil
    import tempfile

    cfg, _, variables = weights()
    dump, name_map = checkpoint_dump(cfg, variables)
    shutil.rmtree(ASSET, ignore_errors=True)
    os.makedirs(ASSET)
    with tempfile.TemporaryDirectory() as tmp:
        write_checkpoint(dump, PREFIX, tmp)
    for f in os.listdir(ASSET):  # the Saver's "checkpoint" state file
        if not f.startswith("model.ckpt."):
            os.unlink(os.path.join(ASSET, f))
    cfg.save(os.path.join(ASSET, "config.json"))
    with open(os.path.join(ASSET, "name_map.json"), "w") as f:
        json.dump(name_map, f, indent=1)


def _jax_state(cfg: Config, jax_vars: dict) -> dict:
    return convert_variables(jax.device_get(jax_vars), cfg)


def _assert_equal_states(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


# ------------------------------------------------------------------ tests

@pytest.fixture(scope="module")
def donor():
    cfg, state, variables = weights()
    with open(os.path.join(ASSET, "name_map.json")) as f:
        name_map = json.load(f)
    return cfg, state, variables, name_map


@pytest.mark.parametrize("which", ["tiny", "reference"])
def test_spec_equals_jax(which):
    jcfg = (tiny_jax_config() if which == "tiny" else
            JaxConfig.load(os.path.join(ROOT, "configs",
                                        "coco_mobilenet_640.json")))
    want = [tuple(getattr(e, f) for f in SPEC_FIELDS)
            for e in jax_import.parameter_spec(jcfg)]
    got = [tuple(getattr(e, f) for f in SPEC_FIELDS)
           for e in import_tf.parameter_spec(Config.from_json(jcfg.to_json()))]
    assert got == want


def test_committed_checkpoint_is_current(donor):
    """The asset holds these weights, read by the port's bundle reader bit
    for bit, and its config and name map are regen's."""
    cfg, _, variables, name_map = donor
    assert os.path.getsize(PREFIX + ".data-00000-of-00001") < 600_000
    assert Config.load(os.path.join(ASSET, "config.json")) == cfg
    dump, want_map = checkpoint_dump(cfg, variables)
    assert name_map == want_map
    bundle = import_tf.TensorBundle(PREFIX)
    assert bundle.names() == sorted(dump)
    for name, w in dump.items():
        got = bundle.get_tensor(name)
        assert got.dtype == np.float32 and bundle.shape(name) == w.shape
        np.testing.assert_array_equal(got, w, err_msg=name)


def test_checkpoint_imports_like_jax(donor):
    """Port (its own reader) vs JAX (TensorFlow's reader), bit for bit, and
    both equal the weights."""
    pytest.importorskip("tensorflow")
    cfg, state, _, name_map = donor
    jcfg = JaxConfig.from_json(cfg.to_json())
    want = _jax_state(cfg, jax_import.import_weights(
        jcfg, jax_import.checkpoint_reader(PREFIX, name_map)))
    got = import_tf.import_weights(
        cfg, import_tf.checkpoint_reader(PREFIX, name_map))
    _assert_equal_states(got, want)
    _assert_equal_states(got, state)


def test_keras_file_imports_like_jax(tmp_path):
    """A ``.keras`` file of the JAX package's mirror: the port's import of
    the file vs JAX's import of the live model, bit for bit."""
    pytest.importorskip("tensorflow")
    from tests.test_tf_parity import build_keras_mirror, transplant

    cfg, state, variables = weights(0.25)
    jcfg = JaxConfig.from_json(cfg.to_json())
    kmodel = build_keras_mirror(jcfg)
    transplant(kmodel, variables["params"], variables["batch_stats"])
    path = str(tmp_path / "mirror.keras")
    kmodel.save(path)
    want = _jax_state(cfg, jax_import.import_weights(
        jcfg, jax_import.keras_reader(kmodel)))
    got = import_tf.import_weights(cfg, import_tf.keras_reader(path))
    _assert_equal_states(got, want)
    _assert_equal_states(got, state)


def _dict_readers(cfg: Config, variables: dict, name_map: dict):
    """The same reads for both packages from the checkpoint's tensors."""
    dump, _ = checkpoint_dump(cfg, variables)

    def read(e):
        return dump.get(f"{name_map[e.layer]}/{e.suffix}")
    return read


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_faults_fail_with_jax_message(donor, fault):
    cfg, _, variables, name_map = donor
    read = _dict_readers(cfg, variables, name_map)

    def broken(e):
        if fault == "missing" and e.layer == "backbone.ds3.pointwise.conv":
            return None
        w = read(e)
        if (fault == "shape" and e.layer.startswith("fpn.lateral3")
                and e.suffix == "kernel"):
            return w[..., :-1]
        return w

    with pytest.raises(ValueError) as want:
        jax_import.import_weights(JaxConfig.from_json(cfg.to_json()),
                                  broken)
    with pytest.raises(ValueError) as got:
        import_tf.import_weights(cfg, broken)
    assert str(got.value) == str(want.value)
    assert ("ds3.pointwise" if fault == "missing" else "lateral3") in str(
        got.value)


@pytest.mark.parametrize("change", [{"stem_schedule": "dense4"},
                                    {"norm": "group"}])
def test_refusals_match_jax(change):
    jcfg = tiny_jax_config()
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, **change))
    with pytest.raises(ValueError) as want:
        jax_import.parameter_spec(jcfg)
    with pytest.raises(ValueError) as got:
        import_tf.parameter_spec(Config.from_json(jcfg.to_json()))
    assert str(got.value) == str(want.value)


def test_cli_artifact_serves(tmp_path, capsys):
    from ssd_tpu_torch.predictor import Predictor

    cfg_path = os.path.join(ASSET, "config.json")
    out = str(tmp_path / "art")
    import_tf.main(["--config", cfg_path, "--tf-ckpt", PREFIX,
                    "--name-map", os.path.join(ASSET, "name_map.json"),
                    "--output", out])
    pred = Predictor.from_checkpoint(out, device="cpu")
    res = pred.predict(np.random.default_rng(0).integers(
        0, 255, (64, 64, 3), dtype=np.uint8))
    assert 0 < int(res["num_boxes"]) <= pred.cfg.nms.max_boxes
    capsys.readouterr()
    import_tf.main(["--config", cfg_path, "--tf-ckpt", PREFIX,
                    "--dry-run"])
    lines = capsys.readouterr().out.splitlines()
    spec = import_tf.parameter_spec(Config.load(cfg_path))
    assert len(lines) == len(spec)
    assert lines[0].split() == ["params", ".".join(spec[0].path), "<-",
                                f"{spec[0].layer}/{spec[0].suffix}",
                                *str(spec[0].shape).split()]


def test_keras_reader_without_h5py(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="--tf-ckpt"):
        import_tf.keras_reader("any.keras")


if __name__ == "__main__":
    if sys.argv[1:] == ["regen"]:
        regen()
        print(f"wrote {ASSET}: {sorted(os.listdir(ASSET))}")
    else:
        sys.exit("usage: python tests/test_torch_import_tf.py regen")
