"""Process group, mesh, placements and the collectives of a step.

Counterpart of ``ssd_tpu/parallel/mesh.py`` over ``torch.distributed``.
JAX compiles one program over a global ``(data, model)`` mesh and GSPMD
inserts the collectives; here each rank is one process on one device
(one JAX process), running its own rows of the global batch, and the
collectives are explicit:

  * ``data``: one rank per device. Train-mode batch norm reduces its two
    per-channel means over the data group, the loss normalizers are global
    sums, and the gradients are summed (``train_step.make_train_step``),
    so a step is the one-device step at the global batch, as under GSPMD;
  * ``model``: channel tensor parallelism, not ported (ROADMAP.md M11b):
    a model axis above 1 raises.

The process group comes from ``torchrun``'s environment
(``initialize_distributed``): NCCL on the card, gloo on the CPU, and on the
card a second, gloo group for host objects (the evaluation's statistics).
A rank's device is ``cuda:LOCAL_RANK``, set before NCCL starts.

Serving needs no process group: a ``Mesh`` without one holds this
process's devices, one predictor replica each (``predictor.Predictor``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
# a top-level child of the model with a leaf this large is its own FSDP
# unit (gathered just before its own forward and backward); the root unit
# takes the rest. Every leaf is sharded, the small ones too: unlike JAX's
# fsdp_sharded, whose leaves under this size stay replicated.
FSDP_UNIT_MIN_ELEMENTS = 2 ** 11
M11B = ("is not ported yet: channel tensor parallelism and spatial "
        "sharding are ROADMAP.md M11b")

_device: torch.device | None = None  # this rank's device, once initialized
_host_group = None  # gloo group for host objects when the default is NCCL
_step_group = None  # the data group of the train step now running


def initialize_distributed(device=None, init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           backend: str | None = None) -> bool:
    """Starts the process group; returns whether one is running.

    Without arguments it reads ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), and
    without a launcher it is a no-op (one process, no group).
    ``init_method`` (``tcp://localhost:PORT``), ``world_size`` and
    ``rank`` start a group without a launcher. ``device``: ``None`` is the
    card, where ``cuda:LOCAL_RANK`` becomes the current device before NCCL
    starts; ``"cpu"`` takes gloo. ``backend="gloo"`` on the card is a
    caller's explicit choice (several ranks on one card); a failing NCCL
    start raises."""
    global _device, _host_group
    if dist.is_initialized():
        return True
    env = "WORLD_SIZE" in os.environ
    if init_method is None and not env:
        return False
    world = int(world_size if world_size is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group needs a CUDA device; "
                               "pass device='cpu' for gloo on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        if dev.index is not None:
            local = dev.index
        elif local >= torch.cuda.device_count():
            if backend != "gloo":
                raise RuntimeError(
                    f"local rank {local} has no card of its own "
                    f"({torch.cuda.device_count()} visible): NCCL takes one "
                    "rank a card")
            local %= torch.cuda.device_count()
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {} if init_method is None else {"init_method": init_method}
    if backend == "nccl":
        kwargs["device_id"] = dev
    dist.init_process_group(backend, world_size=world, rank=rank, **kwargs)
    _device = dev
    _host_group = (dist.new_group(backend="gloo") if backend == "nccl"
                   else None)
    return True


def shutdown_distributed() -> None:
    """Ends the process group started by ``initialize_distributed``."""
    global _device, _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = _host_group = None


def rank_and_world() -> tuple[int, int]:
    """``(rank, world size)``; ``(0, 1)`` without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_group():
    """The group for host objects (CPU tensors): gloo beside NCCL, else
    the default group."""
    return _host_group


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's devices and, under a process group, the ranks.

    ``devices``: the devices this process serves on, one replica each
    (one, the rank's own, under a process group). ``group``: the data
    group (the default process group), or ``None``. ``shape``: the JAX
    mesh's ``{"data": ranks x devices, "model": 1}``."""

    devices: tuple
    group: object = None
    _fsdp_mesh: list = dataclasses.field(default_factory=list)

    @property
    def shape(self) -> dict:
        ranks = dist.get_world_size(self.group) if self.group else 1
        return {DATA_AXIS: ranks * len(self.devices), MODEL_AXIS: 1}

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def device_mesh(self):
        """The 1-D ``DeviceMesh`` over the ranks (FSDP's), made once."""
        if self.group is None:
            raise ValueError("FSDP needs a process group "
                             "(initialize_distributed)")
        if not self._fsdp_mesh:
            from torch.distributed.device_mesh import init_device_mesh
            self._fsdp_mesh.append(init_device_mesh(
                self.device.type, (dist.get_world_size(),),
                mesh_dim_names=(DATA_AXIS,)))
        return self._fsdp_mesh[0]


def create_mesh(devices=None, model_parallelism: int = 1) -> Mesh:
    """The mesh: under a process group this rank's device over all ranks;
    without one ``devices`` (default: every visible card) in this
    process. ``model_parallelism > 1`` raises (M11b)."""
    if model_parallelism != 1:
        raise NotImplementedError(f"model_parallelism={model_parallelism} "
                                  f"{M11B}")
    if dist.is_initialized():
        own = _device or torch.device("cpu")
        devs = (own,) if devices is None else tuple(
            torch.device(d) for d in devices)
        if len(devs) != 1:
            raise ValueError("a rank runs on one device")
        return Mesh(devs, dist.group.WORLD)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "create_mesh() spans the visible cards and none is "
                "available; pass devices=['cpu', ...]")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs)


def model_sharded(mesh: Mesh, tree=None):
    """Channel tensor parallelism on the model axis: not ported (M11b)."""
    raise NotImplementedError(f"model_sharded {M11B}")


def fsdp_sharded(mesh: Mesh, model: torch.nn.Module, base=None) -> None:
    """ZeRO-3 over the data axis with FSDP2's ``fully_shard``, in place:
    each top-level submodule that holds a leaf of at least
    ``FSDP_UNIT_MIN_ELEMENTS`` elements becomes a unit (its parameters
    all-gathered just before its forward and again before its backward),
    then the whole model, which takes the rest. Every parameter then lives
    as a dim-0-sharded ``DTensor`` and its gradient arrives
    reduce-scattered, summed over the ranks (no division). Compute is the
    replicated step's. Shard before ``train_step.create_train_state``, so the
    optimizer state and the EMA are made sharded beside their parameters.
    On the card the parameters are made contiguous first (FSDP2 shards no
    other layout). ``base`` (composition with channel TP) raises: M11b."""
    if base is not None:
        raise NotImplementedError(f"fsdp_sharded(base=) {M11B}")
    from torch.distributed.fsdp import fully_shard
    dm = mesh.device_mesh()
    model.to(memory_format=torch.contiguous_format)
    units = [m for m in model.children()
             if any(p.numel() >= FSDP_UNIT_MIN_ELEMENTS
                    for p in m.parameters())]
    for m in units + [model]:
        fully_shard(m, mesh=dm)
        # the plain sum over the ranks (gloo has no pre-multiplied sum)
        m.set_gradient_divide_factor(1.0)
        if hasattr(m, "set_force_sum_reduction_for_comms"):
            m.set_force_sum_reduction_for_comms(True)


def is_sharded(t) -> bool:
    """Whether ``t`` is a ``DTensor`` (an FSDP-sharded tensor), which
    exists only under a process group. DTensor is imported there alone:
    importing it costs a process more than a second."""
    if not dist.is_initialized():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a sharded one (a collective: every rank calls
    it), a plain tensor as it is."""
    return t.full_tensor() if is_sharded(t) else t


def assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copies the whole tensor ``src`` into ``dst``; a sharded ``dst``
    takes its own shard of it (no communication)."""
    if is_sharded(dst):
        from torch.distributed.tensor import distribute_tensor
        src = distribute_tensor(src.to(dst.device), dst.device_mesh,
                                dst.placements, src_data_rank=None)
    dst.copy_(src)


def shard_batch(mesh: Mesh, batch: dict, feed=None) -> dict:
    """This rank's rows (the pipeline's host shard) on its device, through
    ``train.DeviceFeed``'s pinned staging (``feed``, made once a device
    when not given)."""
    if feed is None:
        feed = _feeds.get(mesh.device)
        if feed is None:
            from ssd_tpu_torch.train import DeviceFeed
            feed = _feeds[mesh.device] = DeviceFeed(mesh.device)
    return feed(batch)


_feeds: dict = {}


def replicate(detector, mesh: Mesh) -> list:
    """A ``Detector`` on each of the mesh's devices: ``detector`` itself on
    its own device, copies of its weights (its state dict) elsewhere."""
    from ssd_tpu_torch.models.detector import Detector
    state = None
    out = []
    for d in mesh.devices:
        if d == detector.device and not out:
            out.append(detector)
            continue
        if state is None:
            state = {k: v.detach().cpu()
                     for k, v in detector.model.state_dict().items()}
        out.append(Detector(detector.cfg, state, device=d))
    return out


def row_bounds(n: int, parts: int) -> list[tuple[int, int]]:
    """Contiguous row blocks of ``n`` rows over ``parts`` devices (``n``
    divides by ``parts`` for a bucket)."""
    step = -(-n // parts)
    return [(min(i * step, n), min((i + 1) * step, n)) for i in range(parts)]


def local_rows(parts) -> np.ndarray:
    """The per-device row blocks of one output, in row order, as one host
    array: a meshed predict's rows back on the host."""
    return np.concatenate([p.detach().cpu().numpy() for p in parts], axis=0)


# ------------------------------------------------------------ step collectives

@contextlib.contextmanager
def data_parallel(group):
    """Within the block, train-mode batch norm takes global statistics and
    the loss normalizers are global, over ``group`` (``None``: the local
    ones, unchanged). Process-wide, not per thread: the backward, which
    runs in the autograd engine's thread, reruns the norms' collectives."""
    global _step_group
    prev = _step_group
    _step_group = group
    try:
        yield
    finally:
        _step_group = prev


def step_group():
    """The data group of the running step, or ``None``."""
    return _step_group


class _AllReduceSum(torch.autograd.Function):
    """``sum over ranks`` with its gradient: the sum of the ranks'
    gradients of the (replicated) result, another all-reduce."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, differentiable. Every
    rank must call it at the same point of the same program."""
    return _AllReduceSum.apply(t, group)


def all_reduce_mean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean over the ranks; the global mean of per-rank means when the
    ranks hold the same number of rows."""
    return all_reduce_sum(t, group) / dist.get_world_size(group)


def all_reduce_(tensors: list, group) -> None:
    """Sums the tensors over the ranks in place, as one flat buffer (one
    collective) for each dtype."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        off = 0
        for t in same:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
