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
  * ``model``: channel tensor parallelism (``model_sharded``). Rank ``r``
    sits at data index ``r // m`` and model index ``r % m`` (JAX's
    row-major reshape of the devices to ``(n // m, m)``); the ranks of one
    model group read the same rows. A split conv holds its ``O / m``
    output channels as a ``DTensor`` shard, computes only those, and the
    pair of ``TensorParallel`` writes out what GSPMD inserts: the input's
    gradient summed over the model group, the output all-gathered along
    channels (its gradient: this rank's slice). The data collectives then
    run over the data sub-group, not the default group.

A model axis without a process group is the height split of
``parallel/spatial.py``: the devices of a data row each take a strip of
every image.

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

    ``devices``: without a process group the devices this process serves
    on, row-major over ``(data, model)`` (a data row is
    ``model_parallelism`` consecutive devices; a device may repeat); under
    one, the rank's own device. ``group``: the data group (the default
    group when ``model_parallelism`` is 1, else the data sub-group), or
    ``None``. ``model_group``: the rank's model sub-group. ``shape``: the
    JAX mesh's ``{"data": ..., "model": model_parallelism}``."""

    devices: tuple
    group: object = None
    model_parallelism: int = 1
    model_group: object = None
    _device_mesh: list = dataclasses.field(default_factory=list)

    @property
    def shape(self) -> dict:
        m = self.model_parallelism
        if self.group is not None:
            return {DATA_AXIS: dist.get_world_size(self.group),
                    MODEL_AXIS: m}
        return {DATA_AXIS: len(self.devices) // m, MODEL_AXIS: m}

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def rows(self) -> list[tuple]:
        """The data rows of this process's devices, each ``model`` devices
        (under a process group the rank's one device)."""
        if self.group is not None:
            return [self.devices]
        m = self.model_parallelism
        return [self.devices[i:i + m]
                for i in range(0, len(self.devices), m)]

    @property
    def model_index(self) -> int:
        """This rank's index in its model group (0 without a group)."""
        return rank_and_world()[0] % self.model_parallelism

    def device_mesh(self):
        """FSDP's and the TP shards' ``DeviceMesh`` over the ranks, made
        once: 1-D ``(data,)`` at model 1, else 2-D ``(data, model)``."""
        if self.group is None:
            raise ValueError("FSDP needs a process group "
                             "(initialize_distributed)")
        if not self._device_mesh:
            from torch.distributed.device_mesh import init_device_mesh
            self._device_mesh.append(init_device_mesh(
                self.device.type, (dist.get_world_size(),),
                mesh_dim_names=(DATA_AXIS,)))
        return self._device_mesh[0]

    def data_mesh(self):
        """The ``DeviceMesh`` of the data axis (FSDP's)."""
        dm = self.device_mesh()
        return dm if self.model_parallelism == 1 else dm[DATA_AXIS]


def data_index_and_size(mesh: Mesh | None = None) -> tuple[int, int]:
    """``(data index, data size)`` of this rank: the host split of the
    input (``rank // model``, ``world // model``); ``(0, 1)`` without a
    process group. The ranks of one model group read the same rows."""
    rank, world = rank_and_world()
    m = 1 if mesh is None else mesh.model_parallelism
    return rank // m, world // m


def create_mesh(devices=None, model_parallelism: int = 1) -> Mesh:
    """The mesh: under a process group this rank's device over all ranks
    (a ``(world // m, m)`` grid of ranks, ``m = model_parallelism``, with
    its data and model sub-groups); without one ``devices`` (default:
    every visible card) in this process, as a ``(n // m, m)`` grid. A
    device count ``m`` does not divide raises, with JAX's message."""
    m = int(model_parallelism)
    if m < 1:
        raise ValueError(f"model_parallelism must be at least 1, got {m}")
    if dist.is_initialized():
        own = _device or torch.device("cpu")
        devs = (own,) if devices is None else tuple(
            torch.device(d) for d in devices)
        if len(devs) != 1:
            raise ValueError("a rank runs on one device")
        world = dist.get_world_size()
        if world % m:
            raise ValueError(f"{world} devices not divisible by model={m}")
        if m == 1:
            return Mesh(devs, dist.group.WORLD)
        from torch.distributed.device_mesh import init_device_mesh
        dm = init_device_mesh(devs[0].type, (world // m, m),
                              mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
        return Mesh(devs, dm.get_group(DATA_AXIS), m,
                    dm.get_group(MODEL_AXIS), [dm])
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
    if len(devs) % m:
        raise ValueError(f"{len(devs)} devices not divisible by model={m}")
    return Mesh(devs, model_parallelism=m)


# -------------------------------------------------- channel tensor parallelism

class _ToModel(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the model group
    (each rank's shard contributes its output channels' share)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherChannels(torch.autograd.Function):
    """All-gather along channels (dim 1) forward; backward takes this
    rank's slice of the gradient. Not a reduce-scatter: the layers after
    the gather run replicated, so every model rank holds the whole,
    identical gradient already, and a sum would scale it by the model
    size."""

    @staticmethod
    def forward(ctx, y, group, index, size):
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(parts, y, group=group)
        ctx.index, ctx.channels = index, y.shape[1]
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.channels
        return grad[:, lo:lo + ctx.channels], None, None, None


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """A split module's model group: its ``size`` ranks and this rank's
    ``index`` (the channel block it holds)."""

    group: object
    index: int
    size: int

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The split op's input: identity, its gradient summed over the
        model group."""
        return _ToModel.apply(x, self.group)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The split op's output block -> the whole output, on every model
        rank."""
        return _GatherChannels.apply(y, self.group, self.index, self.size)

    def channels(self, x: torch.Tensor, groups: int) -> tuple:
        """``(input, groups)`` of this rank's shard of a grouped conv: a
        shard of whole groups reads only their input channels."""
        if groups == 1:
            return x, 1
        c = x.shape[1] // self.size
        return x[:, self.index * c:(self.index + 1) * c], groups // self.size


def local(t: torch.Tensor) -> torch.Tensor:
    """A sharded tensor's local shard (differentiable), a plain one as it
    is."""
    return t.to_local() if is_sharded(t) else t


def splits_on_model(shape, m: int) -> bool:
    """JAX's ``model_sharded`` rule in torch's layout: rank >= 2 and the
    output-channel dim (torch's dim 0, JAX's trailing one) at least ``2m``
    and divisible by ``m``."""
    return m > 1 and len(shape) >= 2 and shape[0] >= 2 * m and not shape[0] % m


def model_sharded(mesh: Mesh, model: torch.nn.Module) -> list[str]:
    """Channel tensor parallelism on the model axis, in place: every
    parameter that ``splits_on_model`` becomes a ``DTensor`` split on dim 0
    over the model sub-mesh, each rank keeping its ``O / m`` rows; its
    module (a ``layers.Conv`` or ``mobilenet.FoldedS2DConv``) then runs on
    its shard between ``TensorParallel.enter`` and ``gather``. Biases,
    norm scales, running statistics and convs whose width does not divide
    stay whole on every model rank. Call it before
    ``train_step.create_train_state``, so that the optimizer moments and
    the EMA are made beside their shards. Returns the split parameters'
    names (``fsdp_sharded``'s ``base``)."""
    m = mesh.model_parallelism
    if m == 1:
        return []
    if mesh.group is None:
        raise ValueError("channel tensor parallelism needs a process group "
                         "(initialize_distributed)")
    from torch.distributed.tensor import Shard, distribute_tensor
    tp_mesh = mesh.device_mesh()[MODEL_AXIS]
    tp = TensorParallel(mesh.model_group, mesh.model_index, m)
    split = []
    for prefix, mod in model.named_modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            if not splits_on_model(p.shape, m):
                continue
            groups = getattr(mod, "groups", 1)
            if not hasattr(mod, "tp") or (groups > 1 and groups % m):
                raise TypeError(f"{prefix}.{name}: {type(mod).__name__} "
                                f"(groups={groups}) has no channel split "
                                f"over {m} ranks")
            shard = distribute_tensor(p.detach().contiguous(), tp_mesh,
                                      [Shard(0)], src_data_rank=None)
            setattr(mod, name, torch.nn.Parameter(shard))
            mod.tp = tp
            split.append(f"{prefix}.{name}" if prefix else name)
    return split


def fsdp_sharded(mesh: Mesh, model: torch.nn.Module, base=None) -> None:
    """ZeRO-3 over the data axis with FSDP2's ``fully_shard``, in place:
    each top-level submodule that holds a leaf of at least
    ``FSDP_UNIT_MIN_ELEMENTS`` elements becomes a unit (its parameters
    all-gathered just before its forward and again before its backward),
    then the whole model, which takes the rest. Every parameter then lives
    as a dim-0-sharded ``DTensor`` and its gradient arrives
    reduce-scattered, summed over the data ranks (no division). Compute is
    the replicated step's. Shard before ``train_step.create_train_state``,
    so the optimizer state and the EMA are made sharded beside their
    parameters. On the card the parameters are made contiguous first
    (FSDP2 shards no other layout).

    ``base``: the split parameters ``model_sharded`` returned (channel TP,
    applied first): each stays split over ``model`` and gains the data
    shard on the same dim 0 (FSDP2's strided shard), the rest are sharded
    over ``data`` alone."""
    from torch.distributed.fsdp import fully_shard
    if base is not None:
        params = dict(model.named_parameters())
        whole = [k for k in base if not is_sharded(params.get(k))]
        if whole:
            raise ValueError(f"fsdp_sharded(base=): {whole[:4]} are not "
                             "split over the model axis (model_sharded)")
    dm = mesh.data_mesh()
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


def sharded_sum(tensors, fn) -> torch.Tensor:
    """``sum(fn(t))`` over the whole tensors, for an ``fn`` that sums over
    elements (a sum of squares): a plain tensor counts once (a replicated
    leaf is the same on every rank), a sharded one's local ``fn`` is summed
    over the groups of the mesh dims it is split on, once per dim (a
    collective: every rank calls it in the same order). A plain 0-dim
    tensor, the same on every rank."""
    total = None
    pending: dict = {}
    for t in tensors:
        if is_sharded(t):
            # a shard of any kind (FSDP's over a model shard is strided)
            groups = tuple(t.device_mesh.get_group(d)
                           for d, p in enumerate(t.placements)
                           if not p.is_replicate())
            v = fn(t.to_local())
            if groups:
                pending.setdefault(groups, []).append(v)
                continue
        else:
            v = fn(t)
        total = v if total is None else total + v
    for groups, values in pending.items():
        s = torch.stack(values).sum()
        for g in groups:
            dist.all_reduce(s, group=g)
        total = s if total is None else total + s
    return total


def _chunks(n: int, parts: int) -> list[int]:
    """The rows of each of ``parts`` shards of ``n`` (``torch.chunk``'s
    split, as ``Shard`` takes it; trailing shards may be empty)."""
    c = -(-n // parts)
    return [max(0, min(c, n - i * c)) for i in range(parts)]


def _gather_rows(x: torch.Tensor, group, sizes: list[int]) -> torch.Tensor:
    """The ranks' row blocks of ``sizes`` rows each, in group order: one
    ``all_gather`` of the blocks padded to the largest."""
    pad = max(sizes) - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
    parts = [torch.empty_like(x) for _ in sizes]
    dist.all_gather(parts, x, group=group)
    return torch.cat([p[:n] for p, n in zip(parts, sizes)])


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a sharded one (a collective: every rank calls
    it), a plain tensor as it is. The shards are gathered with plain
    ``all_gather``s over each split mesh dim, innermost first (FSDP's
    strided shard over a model shard is inside it): ``DTensor``'s own
    gather goes through functional collectives, which gloo on the card
    does not survive."""
    if not is_sharded(t):
        return t
    mesh = t.device_mesh
    split = [(d, p) for d, p in enumerate(t.placements)
             if not p.is_replicate()]
    if any(getattr(p, "dim", None) != 0 for _, p in split):
        raise ValueError(f"full_tensor gathers dim-0 shards, not "
                         f"{t.placements}")
    # outermost first: plain shards by mesh dim, then the strided ones
    split.sort(key=lambda dp: (hasattr(dp[1], "split_factor"), dp[0]))
    levels, n = [], t.shape[0]
    for d, _ in split:
        sizes = _chunks(n, mesh.size(d))
        levels.append((d, sizes))
        n = sizes[mesh.get_local_rank(d)]
    x = t.to_local().detach().contiguous()
    for d, sizes in reversed(levels):
        x = _gather_rows(x, mesh.get_group(d), sizes)
    return x


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


def replicate(detector, mesh: Mesh, devices=None) -> list:
    """A ``Detector`` on each data row's first device (or on each of
    ``devices``): ``detector`` itself on its own device, copies of its
    weights (its state dict) elsewhere."""
    from ssd_tpu_torch.models.detector import Detector
    state = None
    out = []
    for d in devices or [row[0] for row in mesh.rows]:
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
