"""The seeded weights: each cell's state as it was before a reference
could name starting values (``seed_means``), bit for bit, and a named
parameter drawn around its value while the kernels and norms stay as
they were; and where the EMA starts."""

from __future__ import annotations

import hashlib
import types

import pytest
import torch

from conftest import SEED, manifest

from bench_port import harness
from bench_port.weights import ema_start, reference_state, seeded_state

# sha256 of each cell's CPU-seeded state at seed SEED (names, shapes and
# float32 bytes in the state's order), as the harness seeded it before
# ``seed_means``: these configurations name none, so none may move
DIGESTS = {
    "ssd_mnv1_fpn_640.serve_int8_b32":
        "d3287a81f089277be19e33a5c84f65888ceb74b537f43b2c2b563302e19fa2da",
    "ssd_mnv1_fpn_640.serve_bf16_b32":
        "d3287a81f089277be19e33a5c84f65888ceb74b537f43b2c2b563302e19fa2da",
    "ssd_mnv1_fpn_640.train_b64":
        "f4766d90d4948e01992300460c6ea32548b7bd1c695ac928c72485c3a4e145a2",
    "retinanet_r50_fpn_640.train_b64":
        "1ac7cc05f3d43d2f95c1d5a5f313a9382ebc0e76be4450942537e36ed63a6678",
    "retinanet_r50_fpn_640.train_dp4_b256":
        "1ac7cc05f3d43d2f95c1d5a5f313a9382ebc0e76be4450942537e36ed63a6678",
}
CPU = torch.device("cpu")


def digest(state: dict) -> str:
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("workload", sorted(DIGESTS))
def test_each_cells_state_is_seeded_as_before(workload):
    """At the configuration's own shapes, through the drivers' own call."""
    cell = harness.Cell(manifest(), workload, SEED, 1.0, False, CPU, 0.0)
    t = cell.traffic
    state = reference_state(cell.reference, cell.repo_config, SEED, CPU,
                            t["class_bias"], t.get("predict_std"))
    assert digest(state) == DIGESTS[workload]


SHAPES = {"stem.conv.weight": (16, 3, 3, 3),
          "stem.bn.weight": (16,), "stem.bn.bias": (16,),
          "stem.bn.running_mean": (16,), "stem.bn.running_var": (16,),
          "neck.fuse0.weight": (4096,), "neck.fuse1.weight": (2,),
          "neck.conv.bias": (16,),
          "head.class_net.predict.weight": (9, 16, 3, 3),
          "head.class_net.predict.bias": (9,)}
MEANS = {"neck.fuse0.weight": 1.0, "neck.fuse1.weight": -0.5}


def test_a_named_parameter_is_drawn_around_its_value():
    plain = seeded_state(SHAPES, SEED, CPU, -4.6, 0.01)
    named = seeded_state(SHAPES, SEED, CPU, -4.6, 0.01, MEANS)
    fuse = named["neck.fuse0.weight"]
    assert abs(float(fuse.mean()) - 1.0) < 0.01
    assert abs(float(fuse.std()) - 0.1) < 0.01
    assert bool((named["neck.fuse1.weight"] + 0.5).abs().lt(0.5).all())
    assert not torch.equal(named["neck.fuse1.weight"],
                           plain["neck.fuse1.weight"])
    for k in SHAPES:  # kernels, norms and biases as without the map
        if k not in MEANS:
            assert torch.equal(named[k], plain[k]), k
    assert bool((plain["neck.fuse0.weight"] == 0).all())
    assert bool((named["head.class_net.predict.bias"] == -4.6).all())


def test_the_named_draw_is_the_seeds():
    one = seeded_state(SHAPES, SEED, CPU, -4.6, means=MEANS)
    assert all(torch.equal(one[k], v) for k, v in seeded_state(
        SHAPES, SEED, CPU, -4.6, means=MEANS).items())
    other = seeded_state(SHAPES, SEED + 1, CPU, -4.6, means=MEANS)
    assert not torch.equal(one["neck.fuse0.weight"],
                           other["neck.fuse0.weight"])


@pytest.mark.parametrize("name", ["stem.conv.weight", "stem.bn.weight",
                                  "neck.missing.weight"])
def test_a_map_that_names_a_kernel_a_norm_or_nothing_is_refused(name):
    with pytest.raises(ValueError, match="seed_means"):
        seeded_state(SHAPES, SEED, CPU, -4.6, means={name: 1.0})


def test_a_reference_names_its_map_through_seed_means():
    """The drivers' call takes the map from the reference module."""
    ref = types.SimpleNamespace(param_shapes=lambda cfg: dict(SHAPES),
                                seed_means=lambda cfg: dict(MEANS))
    got = reference_state(ref, {}, SEED, CPU, -4.6, 0.01)
    want = seeded_state(SHAPES, SEED, CPU, -4.6, 0.01, MEANS)
    assert all(torch.equal(got[k], want[k]) for k in SHAPES)
    bare = types.SimpleNamespace(param_shapes=lambda cfg: dict(SHAPES))
    assert digest(reference_state(bare, {}, SEED, CPU, -4.6, 0.01)) \
        == digest(seeded_state(SHAPES, SEED, CPU, -4.6, 0.01))


def test_the_ema_starts_apart_from_the_parameters():
    """Every parameter's EMA starts off it by a tenth of its rms (a
    hundredth at the least), the running statistics have none, and the
    same parameters and seed give the same bits."""
    state = seeded_state(SHAPES, SEED, CPU, -4.6, 0.01, MEANS)
    start = ema_start(state, SEED, CPU)
    assert set(start) == {k for k in SHAPES if "running" not in k}
    for k, e in start.items():
        p = state[k]
        scale = 0.1 * max(float(p.square().mean().sqrt()), 0.01)
        off = (e - p) / scale
        if off.numel() >= 16:
            assert 0.5 < float(off.std()) < 1.5, k
        assert bool((off != 0).all()), k
    again = ema_start({k: v.clone() for k, v in state.items()}, SEED, CPU)
    assert all(torch.equal(start[k], again[k]) for k in start)
    other = ema_start(state, SEED + 1, CPU)
    assert not torch.equal(start["stem.conv.weight"],
                           other["stem.conv.weight"])
    # its own generator: the weights' draw is not the EMA's
    assert not torch.equal(start["stem.conv.weight"] - state[
        "stem.conv.weight"], state["stem.conv.weight"])
