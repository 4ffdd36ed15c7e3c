"""Device meshes and sharded placement: the communication layer.

Port of ``photon_ml_tpu/parallel/mesh.py``. The reference's distributed
backend is Spark (treeAggregate to the driver, then a broadcast of the
coefficients each evaluation, ValueAndGradientAggregator.scala:243-247);
the JAX package replaces it with sharding annotations over a
``jax.sharding.Mesh`` and lets XLA insert the all-reduces.

Here a :class:`Mesh` is a small grid of ``torch.device``s with axis names
(``data``, and ``feat`` for the 2-D grid of ``grid_features.py``). One
process drives every device of its grid, as XLA does: a reduction over an
axis moves each tile's partial to the output's device and sums the
partials there in a fixed order (tile order), with no atomics, so it
repeats bitwise. A :class:`ShardedTensor` is a global array laid out over
a mesh by a :class:`PartitionSpec` (``P``): each device of the mesh holds
its block. The devices of a mesh may repeat (``devices=[cuda:0] * 4``):
then every block sits on the one card, the analog of the JAX tests'
forced host devices. On ``cpu`` every block lives on the host.

When the process group of ``torch.distributed`` has more than one rank,
a mesh position may belong to another rank (``Mesh.ranks``): this process
holds only its own positions' blocks, and :func:`fetch_global` assembles a
global array with ``dist.all_gather``, a collective every rank must call
in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.ops.features import DenseFeatures, EllFeatures

DATA_AXIS = "data"


class PartitionSpec(tuple):
    """Per array dimension, the mesh axis it is split over (or None):
    ``P("data")`` splits dimension 0 over the data axis, ``P()``
    replicates (the JAX ``PartitionSpec``)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


P = PartitionSpec


def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def default_devices(device: DeviceLike = DEFAULT_DEVICE,
                    count: Optional[int] = None) -> List[torch.device]:
    """The devices a mesh spans by default: the visible cards on ``cuda``
    (raises without one); on ``cpu`` the host, ``count`` times (one
    position when ``count`` is None)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * max(int(count or 1), 1)


class Mesh:
    """A grid of ``torch.device``s with named axes (the JAX ``Mesh``).

    ``devices`` is an object array of the grid's shape; ``ranks`` (same
    shape) the process rank owning each position, all this process's by
    default. ``shape`` maps axis name to size."""

    def __init__(self, devices, axis_names: Sequence[str], ranks=None):
        src = np.asarray(devices, dtype=object)
        grid = np.empty(src.shape, dtype=object)
        for pos in np.ndindex(grid.shape):
            grid[pos] = torch.device(src[pos])
        if grid.ndim != len(axis_names):
            raise ValueError(f"devices of shape {grid.shape} for axes {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        rank = world()[0]
        self.ranks = (np.full(grid.shape, rank, dtype=np.int64) if ranks is None
                      else np.asarray(ranks, dtype=np.int64).reshape(grid.shape))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def is_local(self, pos) -> bool:
        return int(self.ranks[pos]) == world()[0]

    def local_positions(self) -> List[tuple]:
        return [pos for pos in np.ndindex(self.devices.shape) if self.is_local(pos)]

    @property
    def fully_local(self) -> bool:
        return all(self.is_local(pos) for pos in np.ndindex(self.devices.shape))

    @property
    def home(self) -> torch.device:
        """Where a reduction's output lands: the first device of this
        process's positions."""
        local = self.local_positions()
        return self.devices[local[0]] if local else self.devices.flat[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def data_parallel_mesh(
    num_devices: Optional[int] = None,
    devices: Optional[Sequence[DeviceLike]] = None,
    device: DeviceLike = DEFAULT_DEVICE,
) -> Mesh:
    """1-D mesh over the batch ("data") axis: ``devices`` (may repeat), or
    the first ``num_devices`` of :func:`default_devices`."""
    if devices is None:
        devices = default_devices(device, num_devices)
    devices = list(devices)
    if num_devices is not None:
        if len(devices) < num_devices:
            raise ValueError(f"need {num_devices} devices, have {len(devices)}")
        devices = devices[:num_devices]
    return Mesh(devices, (DATA_AXIS,))


def pad_batch_to_multiple(data: LabeledData, multiple: int) -> LabeledData:
    """Pad the batch with weight-0 rows so it divides evenly across devices.

    Padding rows have features 0, label 0, offset 0, weight 0: exact
    algebraic no-ops in every objective."""
    n = data.labels.shape[0]
    rem = n % multiple
    if rem == 0:
        return data
    pad = multiple - rem

    def pad0(a: torch.Tensor) -> torch.Tensor:
        return torch.cat([a, torch.zeros((pad,) + tuple(a.shape[1:]), dtype=a.dtype,
                                         device=a.device)])

    feats = data.features
    if isinstance(feats, DenseFeatures):
        feats = DenseFeatures(matrix=pad0(feats.matrix))
    else:
        feats = EllFeatures(values=pad0(feats.values), indices=pad0(feats.indices),
                            num_cols=feats.num_cols)
    return LabeledData(features=feats, labels=pad0(data.labels), offsets=pad0(data.offsets),
                       weights=pad0(data.weights), norm=data.norm)


@dataclasses.dataclass
class ShardedTensor:
    """A global array laid out over ``mesh`` by ``spec``: ``shards`` maps
    a mesh position to the block that position's device holds (this
    process's positions only)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    mesh: Mesh
    spec: PartitionSpec
    shards: Dict[tuple, torch.Tensor]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def addressable_shards(self) -> List[torch.Tensor]:
        return [self.shards[pos] for pos in sorted(self.shards)]

    @property
    def is_fully_addressable(self) -> bool:
        return self.mesh.fully_local

    def block_index(self, pos) -> Tuple[slice, ...]:
        """The global index of the block at mesh position ``pos``."""
        out = []
        for dim, size in enumerate(self.shape):
            axis = self.spec[dim] if dim < len(self.spec) else None
            if axis is None:
                out.append(slice(0, size))
                continue
            n = self.mesh.shape[axis]
            k = pos[self.mesh.axis_names.index(axis)]
            step = -(-size // n)
            out.append(slice(min(k * step, size), min((k + 1) * step, size)))
        return tuple(out)

    def full(self, device: Optional[DeviceLike] = None) -> torch.Tensor:
        """The global array on ``device`` (default the mesh's home),
        assembled from the blocks; needs every block in this process."""
        if not self.is_fully_addressable:
            raise ValueError("the array spans other processes; use fetch_global")
        dev = torch.device(device) if device is not None else self.mesh.home
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for pos, blk in self.shards.items():
            out[self.block_index(pos)] = blk.to(dev)
        return out


def _check_spec(shape, mesh: Mesh, spec: PartitionSpec) -> None:
    if len(spec) > len(shape):
        raise ValueError(f"spec {tuple(spec)} has more dims than shape {tuple(shape)}")
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if axis not in mesh.axis_names:
            raise ValueError(f"spec axis {axis!r} not in mesh axes {mesh.axis_names}")
        if shape[dim] % mesh.shape[axis]:
            raise ValueError(
                f"dimension {dim} of size {shape[dim]} does not divide over "
                f"{mesh.shape[axis]} devices of axis {axis!r}"
            )


def place(x, mesh: Mesh, spec: PartitionSpec) -> ShardedTensor:
    """Lay a global array (numpy or tensor, the same value in every
    process) out over ``mesh`` by ``spec``: each of this process's
    positions gets its block on its device."""
    if isinstance(x, ShardedTensor):
        if x.mesh is mesh and tuple(x.spec) == tuple(spec):
            return x  # already placed
        x = fetch_global(x)
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    _check_spec(tuple(t.shape), mesh, spec)
    st = ShardedTensor(tuple(t.shape), t.dtype, mesh, PartitionSpec(*spec), {})
    for pos in mesh.local_positions():
        st.shards[pos] = t[st.block_index(pos)].to(mesh.devices[pos])
    return st


def shard_batch(data: LabeledData, mesh: Mesh) -> LabeledData:
    """Pad the batch to the data axis and place its row arrays split over
    it (features split by rows); the normalization context is replicated."""
    data = pad_batch_to_multiple(data, mesh.shape[DATA_AXIS])

    def put_rows(a):
        return place(a, mesh, P(DATA_AXIS))

    def put_mat(a):
        return place(a, mesh, P(DATA_AXIS, None))

    feats = data.features
    if isinstance(feats, DenseFeatures):
        feats = DenseFeatures(matrix=put_mat(feats.matrix))
    else:
        feats = EllFeatures(values=put_mat(feats.values), indices=put_mat(feats.indices),
                            num_cols=feats.num_cols)
    norm = data.norm
    if norm is not None:
        norm = replicate(norm, mesh)
    return LabeledData(features=feats, labels=put_rows(data.labels),
                       offsets=put_rows(data.offsets), weights=put_rows(data.weights), norm=norm)


def replicate(x, mesh: Mesh):
    """A full copy on every device of the mesh: a tensor or array becomes a
    replicated :class:`ShardedTensor`; dicts, lists, tuples and dataclasses
    are walked (None stays None)."""
    if x is None:
        return None
    if isinstance(x, (np.ndarray, torch.Tensor, ShardedTensor)):
        return place(x, mesh, P())
    if isinstance(x, dict):
        return {k: replicate(v, mesh) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(replicate(v, mesh) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: replicate(getattr(x, f.name), mesh) for f in dataclasses.fields(x)
            if f.init and isinstance(getattr(x, f.name), (np.ndarray, torch.Tensor))
        })
    return x


def all_gather_blocks(local: Dict[tuple, torch.Tensor], positions: Sequence[tuple],
                      mesh: Mesh, like: torch.Tensor) -> Dict[tuple, torch.Tensor]:
    """Every position's block in every process, from each process's own
    blocks (all of the same shape as ``like``): one ``dist.all_gather`` of
    a [positions, ...] stack, each position read from its owner. A
    collective: every rank calls it in the same order. Single-process, the
    identity."""
    rank, size = world()
    if size <= 1:
        return dict(local)
    import torch.distributed as dist

    stack = torch.zeros((len(positions),) + tuple(like.shape), dtype=like.dtype,
                        device=like.device)
    for i, pos in enumerate(positions):
        if pos in local:
            stack[i] = local[pos].to(like.device)
    gathered = [torch.empty_like(stack) for _ in range(size)]
    dist.all_gather(gathered, stack)
    return {pos: gathered[int(mesh.ranks[pos])][i] for i, pos in enumerate(positions)}


# Device->host fetch observers: callbacks invoked with the byte size of
# every device array fetch_global materializes on the host. The tests of
# the device score plane install one to show that no code path pulls a
# row-length score array; fetches of host numpy inputs are not observed.
_FETCH_OBSERVERS: list = []


def add_fetch_observer(callback) -> None:
    """Register ``callback(nbytes)`` to fire on every device->host fetch."""
    _FETCH_OBSERVERS.append(callback)


def remove_fetch_observer(callback) -> None:
    _FETCH_OBSERVERS.remove(callback)


def fetch_global(a) -> np.ndarray:
    """``np.asarray`` for arrays that may be sharded or on a device: a
    :class:`ShardedTensor` is assembled (all-gathered first when it spans
    processes), a tensor copied to the host, numpy passed through. In a
    multi-process run this is a collective for a sharded array: every
    process calls it in the same order."""
    if isinstance(a, ShardedTensor):
        mesh = a.mesh
        if a.is_fully_addressable:
            out = a.full("cpu").numpy()
        else:
            positions = list(np.ndindex(mesh.devices.shape))
            like = next(iter(a.shards.values()))
            dev = like.device
            if world()[1] > 1 and _backend_is_nccl() and dev.type != "cuda":
                raise ValueError("an nccl process group gathers cuda blocks only")
            blocks = all_gather_blocks(a.shards, positions, mesh, like)
            full = torch.empty(a.shape, dtype=a.dtype)
            for pos, blk in blocks.items():
                full[a.block_index(pos)] = blk.cpu()
            out = full.numpy()
        was_device = True
    elif isinstance(a, torch.Tensor):
        out = a.detach().cpu().numpy()
        was_device = True
    else:
        out = np.asarray(a)
        was_device = False
    if was_device and _FETCH_OBSERVERS:
        for cb in list(_FETCH_OBSERVERS):
            cb(out.nbytes)
    return out


def _backend_is_nccl() -> bool:
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_backend() == "nccl"
