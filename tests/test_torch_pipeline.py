"""The port's input pipeline against the JAX package's, on the CPU.

Every augmentation and the mosaic give JAX's bytes on seeded inputs; the
port's ``Pipeline`` gives JAX's batches, array for array and bit for bit,
on a small PIL-written dataset (24 scenes of 48-96 px in 3 shards, written
by the port's ``create_tfrecords``): in train mode over two epochs with
mosaic, crop, flip, colour and multi-scale, on a second host's shard, in
eval mode with its padded tail, and after a mid-epoch ``restore``. An
error in the prefetch thread reaches the consumer, and closing the
iterator stops the thread.

The card's reference, ``ssd_tpu_torch/assets/train_golden_v1.npz``: a
16-JPEG shard (the bytes themselves) and JAX's first three training batches
(two scales, mosaic and colour on) and its padded eval batch; a test checks
it is current and that the port reproduces it. Rewrite it with

    python tests/test_torch_pipeline.py regen
"""

import dataclasses
import os
import sys
import tempfile
import threading

import numpy as np
import pytest

if __name__ == "__main__":  # regen: JAX on the CPU, as tests/conftest.py sets
    os.environ["JAX_PLATFORMS"] = "cpu"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # for ``python tests/test_torch_pipeline.py regen``
    sys.path.insert(0, ROOT)

from ssd_tpu.config import Config as JaxConfig  # noqa: E402
from ssd_tpu.config import DataConfig as JaxDataConfig  # noqa: E402
from ssd_tpu.data import augment as jax_augment  # noqa: E402
from ssd_tpu.data.pipeline import Pipeline as JaxPipeline  # noqa: E402
from ssd_tpu_torch.config import Config, DataConfig, TrainConfig  # noqa: E402
from ssd_tpu_torch.data import (augment, create_tfrecords,  # noqa: E402
                                synthetic)
from ssd_tpu_torch.data.pipeline import Pipeline  # noqa: E402

ASSET = os.path.join(ROOT, "ssd_tpu_torch", "assets", "train_golden_v1.npz")
SIZES = [(48, 64), (96, 80), (64, 64), (72, 96)]
GOLDEN_SIZES = [(128, 96), (80, 128), (112, 112), (64, 100)]
GOLDEN_SEED = 88
GOLDEN_TRAIN_BATCHES = 3


# ------------------------------------------------------------------ augment

def _scene(seed: int, h: int = 60, w: int = 84, m: int = 5):
    rng = np.random.default_rng([seed, 1])
    image = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    lo = rng.uniform(0, 0.7, (m, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.3, (m, 2))],
                           -1).astype(np.float32)
    labels = rng.integers(0, 8, m)
    return image, boxes, labels


def _equal(got, want):
    assert type(got) is type(want)
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _both(fn_port, fn_jax, seed: int, *args, **kw):
    got = fn_port(*args, rng=np.random.default_rng(seed), **kw)
    want = fn_jax(*args, rng=np.random.default_rng(seed), **kw)
    _equal(got, want)
    return got


@pytest.mark.parametrize("seed", range(8))
def test_crop_flip_color_equal_jax(seed):
    image, boxes, labels = _scene(seed, m=seed % 5)
    _both(augment.random_crop_with_boxes, jax_augment.random_crop_with_boxes,
          seed, image, boxes, labels)
    _both(augment.random_flip, jax_augment.random_flip, seed, image, boxes)
    for p in (1.0, 0.5):
        _both(augment.random_color, jax_augment.random_color, seed, image,
              probability=p)


@pytest.mark.parametrize("seed", range(6))
def test_augment_and_mosaic_equal_jax(seed):
    dc = DataConfig(color_jitter_probability=0.9, crop_probability=0.85)
    jdc = JaxDataConfig(**dataclasses.asdict(dc))
    image, boxes, labels = _scene(seed)
    got = augment.augment_example(image, boxes, labels,
                                  np.random.default_rng(seed), dc)
    want = jax_augment.augment_example(image, boxes, labels,
                                       np.random.default_rng(seed), jdc)
    _equal(got, want)
    parts = [_scene(10 * seed + i, 40 + 9 * i, 70 - 7 * i, i % 4)
             for i in range(4)]
    args = ([p[0] for p in parts], [p[1] for p in parts],
            [p[2] for p in parts])
    got = augment.mosaic_example(*args, np.random.default_rng(seed), (48, 64))
    want = jax_augment.mosaic_example(*args, np.random.default_rng(seed),
                                      (48, 64))
    _equal(got, want)


# ------------------------------------------------------------------ pipeline

def write_dataset(root: str, n: int, shards: int, sizes, seed: int,
                  name: str = "train") -> str:
    """Seeded scenes as PIL JPEGs -> ``create_tfrecords`` shards; returns
    the shard pattern."""
    synthetic.write_coco_scenes(os.path.join(root, f"{name}_img"),
                                os.path.join(root, f"{name}.json"), n, sizes,
                                8, seed, objects=(1, 9), sides=(6, 44))
    create_tfrecords.main(["--annotations", os.path.join(root, f"{name}.json"),
                           "--images", os.path.join(root, f"{name}_img"),
                           "--output", os.path.join(root, name),
                           "--num-shards", str(shards)])
    return os.path.join(root, f"{name}-*-of-*")


def pipeline_cfg(pattern: str, **data_kw) -> Config:
    data = dict(train_file_pattern=pattern, val_file_pattern=pattern,
                max_gt_boxes=12, mosaic_probability=0.5,
                color_jitter_probability=0.9, num_workers=3)
    data.update(data_kw)
    return Config(num_classes=8, image_size=64,
                  train=TrainConfig(batch_size=4, multiscale=(64, 96),
                                    multiscale_every=2, seed=3),
                  data=DataConfig(**data))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("pipeline")), 24, 3,
                         SIZES, 5)


def _pair(pattern, cfg, **kw):
    port = Pipeline(pattern, cfg, **kw)
    jax_ = JaxPipeline(pattern, JaxConfig.from_json(cfg.to_json()), **kw)
    return port, jax_


def _take(pipeline, n: int) -> list:
    out = []
    it = iter(pipeline)
    for batch in it:
        out.append(batch)
        if len(out) == n:
            break
    it.close()
    return out


def assert_batches_equal(got: list, want: list) -> None:
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert set(a) == set(b), i
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, \
                (i, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")


def test_train_batches_equal_jax_over_two_epochs(dataset):
    cfg = pipeline_cfg(dataset)
    port, jax_ = _pair(dataset, cfg, seed=cfg.train.seed)
    nb = port.batches_per_epoch()
    assert nb == jax_.batches_per_epoch() == 6
    got, want = _take(port, 2 * nb), _take(jax_, 2 * nb)
    assert_batches_equal(got, want)
    assert {b["images"].shape[1] for b in got} == {64, 96}
    assert any(b["num_boxes"].any() for b in got)
    assert port.state() == jax_.state() == {"epoch": 2, "position": 0,
                                            "seed": 3}


def test_second_host_shard_equals_jax(dataset):
    cfg = pipeline_cfg(dataset, mosaic_probability=0.0)
    port, jax_ = _pair(dataset, cfg, seed=1, host_id=1, num_hosts=2)
    assert_batches_equal(_take(port, 4), _take(jax_, 4))


def test_eval_batches_equal_jax_with_the_padded_tail(dataset):
    cfg = pipeline_cfg(dataset)
    port, jax_ = _pair(dataset, cfg, is_training=False, batch_size=5)
    got, want = list(port), list(jax_)
    assert_batches_equal(got, want)
    assert len(got) == 5
    assert got[-1]["valid"].tolist() == [True] * 4 + [False]
    for k in ("valid", "is_crowd", "source_ids", "orig_hw"):
        assert k in got[-1]
    assert (np.concatenate([b["source_ids"] for b in got])[:24]
            >= 1000).all()


def test_restore_mid_epoch_equals_jax(dataset):
    """4 batches (mid-epoch), ``state()``, a new pipeline ``restore()``d:
    its next 5 batches (across the epoch boundary) are JAX's batches 4-8,
    and JAX's own restore gives the same."""
    cfg = pipeline_cfg(dataset)
    port, jax_ = _pair(dataset, cfg, seed=cfg.train.seed)
    want = _take(jax_, 9)
    _take(port, 4)
    state = port.state()
    assert state == {"epoch": 0, "position": 4, "seed": 3}
    resumed, jax_resumed = _pair(dataset, cfg, seed=0)
    resumed.restore(state)
    jax_resumed.restore(state)
    got = _take(resumed, 5)
    assert_batches_equal(got, want[4:])
    assert_batches_equal(got, _take(jax_resumed, 5))


def test_producer_error_reaches_the_consumer(dataset):
    cfg = pipeline_cfg(dataset)
    port = Pipeline(dataset, cfg)
    real = port._make_batch
    calls = []

    def failing(ids, epoch, image_hw=None):
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("corrupt example")
        return real(ids, epoch, image_hw)

    port._make_batch = failing
    it = iter(port)
    next(it)
    with pytest.raises(ValueError, match="corrupt example"):
        next(it)
    assert port.consumed == 1


def test_closing_the_iterator_stops_the_prefetch_thread(dataset):
    port = Pipeline(dataset, pipeline_cfg(dataset), prefetch=1)
    it = iter(port)
    next(it)
    it.close()
    assert not [t for t in threading.enumerate()
                if t.name == "pipeline-prefetch"]
    assert port.consumed == 1


def test_missing_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        Pipeline(str(tmp_path / "none-*"), pipeline_cfg("x"))


# ------------------------------------------------------------------ golden

def golden_cfg(pattern: str) -> Config:
    return Config(num_classes=8, image_size=96,
                  train=TrainConfig(batch_size=4, multiscale=(64, 96),
                                    multiscale_every=1, seed=3),
                  data=DataConfig(train_file_pattern=pattern,
                                  val_file_pattern=pattern, max_gt_boxes=16,
                                  mosaic_probability=0.5,
                                  color_jitter_probability=0.9,
                                  num_workers=4))


def golden_arrays() -> dict:
    """The golden's arrays: the shard's bytes, the config, JAX's first
    training batches and its last (padded) eval batch of 6."""
    with tempfile.TemporaryDirectory() as root:
        pattern = write_dataset(root, 16, 1, GOLDEN_SIZES, GOLDEN_SEED)
        shard = os.path.join(root, "train-00000-of-00001.tfrecords")
        with open(shard, "rb") as f:
            blob = np.frombuffer(f.read(), np.uint8)
        cfg = golden_cfg("golden-*-of-*")
        jcfg = JaxConfig.from_json(cfg.to_json())
        train = _take(JaxPipeline(shard, jcfg, seed=cfg.train.seed),
                      GOLDEN_TRAIN_BATCHES)
        evals = list(JaxPipeline(pattern, jcfg, is_training=False,
                                 batch_size=6))
    out = {"shard": blob, "config_json": np.array(cfg.to_json())}
    for i, b in enumerate(train):
        out.update({f"train{i}/{k}": v for k, v in b.items()})
    out.update({f"eval/{k}": v for k, v in evals[-1].items()})
    return out


@pytest.fixture(scope="module")
def golden():
    return golden_arrays()


def test_committed_golden_matches_regen(golden):
    with np.load(ASSET, allow_pickle=False) as z:
        got = {k: z[k] for k in z.files}
    assert set(got) == set(golden)
    for k, v in golden.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert {got[f"train{i}/images"].shape[1]
            for i in range(GOLDEN_TRAIN_BATCHES)} == {64, 96}
    assert got["eval/valid"].tolist() == [True] * 4 + [False] * 2
    assert os.path.getsize(ASSET) < 1 << 20


def test_port_reproduces_the_golden(tmp_path):
    """What the card checks: the port's pipeline on the stored shard gives
    the stored batches, bit for bit."""
    with np.load(ASSET, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    shard = str(tmp_path / "g-00000-of-00001.tfrecords")
    arrays["shard"].tofile(shard)
    cfg = Config.from_json(str(arrays["config_json"]))
    got = _take(Pipeline(shard, cfg, seed=cfg.train.seed),
                GOLDEN_TRAIN_BATCHES)
    got.append(list(Pipeline(shard, cfg, is_training=False,
                             batch_size=6))[-1])
    want = [{k.split("/", 1)[1]: v for k, v in arrays.items()
             if k.startswith(f"train{i}/")}
            for i in range(GOLDEN_TRAIN_BATCHES)]
    want.append({k.split("/", 1)[1]: v for k, v in arrays.items()
                 if k.startswith("eval/")})
    assert_batches_equal(got, want)


if __name__ == "__main__":
    if sys.argv[1:] == ["regen"]:
        os.makedirs(os.path.dirname(ASSET), exist_ok=True)
        np.savez_compressed(ASSET, **golden_arrays())
        print(f"wrote {ASSET} ({os.path.getsize(ASSET)} bytes)")
