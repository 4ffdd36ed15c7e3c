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

A :class:`BlockVector` is a vector split into equal blocks along one mesh
axis, block k on the device of the first of this process's positions
with index k on that axis (positions sharing a device share one tensor):
the layout of a grid fixed effect's solver state (``feat``) and row arrays
(``data``), as the JAX package keeps them ``P(FEAT_AXIS)`` and
``P(DATA_AXIS)``. Its blocks may carry leading dimensions (``[E, d_loc]``
for E solver lanes, ``[E, m, d_loc]`` for the s/y rings); indexing and the
arithmetic operators act on the leading dimensions block by block, with
plain tensors (per-lane scalars) moved to each block's device. A
reduction over the vector axis (``sum(-1)``, ``any(-1)``) moves each
block's partial to the mesh's home device and adds the partials there in
block order: only those scalars travel, so a solve repeats bitwise. The
solvers reach the operations that are torch functions (``where``,
elementwise maps, norms) through ``opt/state.py``'s vector helpers, which
call :meth:`BlockVector.blockwise`.

When the process group of ``torch.distributed`` has more than one rank,
a mesh position may belong to another rank (``Mesh.ranks``): this process
holds only its own positions' blocks, and :func:`fetch_global` assembles a
global array with ``dist.all_gather``, a collective every rank must call
in the same order; a block vector's reduction gathers the partials of the
blocks a rank lacks the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


def block_devices(mesh: Mesh, axis: str) -> Dict[int, torch.device]:
    """Block index -> device for the blocks of ``axis`` this process holds:
    the device of its first position with that index."""
    a = mesh.axis_names.index(axis)
    out: Dict[int, torch.device] = {}
    for pos in mesh.local_positions():
        out.setdefault(pos[a], mesh.devices[pos])
    return dict(sorted(out.items()))


def _canonical_positions(mesh: Mesh, axis: str) -> list:
    """Per block index, the first mesh position with that index: its owner
    rank supplies the block's value in a gather."""
    a = mesh.axis_names.index(axis)
    canon: Dict[int, tuple] = {}
    for pos in np.ndindex(mesh.devices.shape):
        canon.setdefault(pos[a], pos)
    return [canon[k] for k in range(mesh.devices.shape[a])]


def gather_needed(mesh: Mesh, axis: str) -> bool:
    """Whether some rank of the mesh lacks a block of ``axis`` (then the
    blocks' partials must be all-gathered). The same answer on every rank."""
    if world()[1] <= 1:
        return False
    a = mesh.axis_names.index(axis)
    n = mesh.devices.shape[a]
    for r in np.unique(mesh.ranks):
        held = {pos[a] for pos in np.ndindex(mesh.devices.shape) if mesh.ranks[pos] == r}
        if len(held) < n:
            return True
    return False


def _move(x, dev: torch.device):
    if isinstance(x, torch.Tensor) and x.device != dev:
        return x.to(dev)
    return x


def _move_index(idx, dev: torch.device):
    if isinstance(idx, tuple):
        return tuple(_move(i, dev) for i in idx)
    return _move(idx, dev)


class BlockVector:
    """A vector of length ``length`` split into ``mesh.shape[axis]`` blocks
    (``blocks``: block index -> tensor ``[..., length // n]`` on its
    device, this process's blocks only)."""

    __slots__ = ("mesh", "axis", "length", "blocks")

    def __init__(self, mesh: Mesh, axis: str, length: int, blocks: Dict[int, torch.Tensor]):
        n = mesh.shape[axis]
        if length % n:
            raise ValueError(f"a vector of {length} does not split over {n} {axis!r} blocks")
        self.mesh = mesh
        self.axis = axis
        self.length = int(length)
        self.blocks = dict(sorted(blocks.items()))

    # ------------------------------------------------------------ layout

    @property
    def n_blocks(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def block_len(self) -> int:
        return self.length // self.n_blocks

    def _any(self) -> torch.Tensor:
        return next(iter(self.blocks.values()))

    @property
    def shape(self) -> torch.Size:
        return torch.Size(tuple(self._any().shape[:-1]) + (self.length,))

    @property
    def ndim(self) -> int:
        return self._any().dim()

    def dim(self) -> int:
        return self.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self._any().dtype

    @property
    def device(self) -> torch.device:
        """Where reductions land: the mesh's home device."""
        return self.mesh.home

    def __repr__(self) -> str:
        return (f"BlockVector(shape={tuple(self.shape)}, axis={self.axis!r}, "
                f"blocks={ {k: tuple(b.shape) for k, b in self.blocks.items()} })")

    def _like(self, blocks: Dict[int, torch.Tensor]) -> "BlockVector":
        return BlockVector(self.mesh, self.axis, self.length, blocks)

    # -------------------------------------------------------- construction

    @classmethod
    def place(cls, x, mesh: Mesh, axis: str) -> "BlockVector":
        """A whole vector (tensor or numpy, the same in every process; the
        vector axis last) cut into this process's blocks on their devices."""
        if isinstance(x, BlockVector):
            if x.mesh is mesh and x.axis == axis:
                return x
            x = x.full()
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        length = t.shape[-1]
        n = mesh.shape[axis]
        if length % n:
            raise ValueError(f"a vector of {length} does not split over {n} {axis!r} blocks")
        bl = length // n
        return cls(mesh, axis, length, {
            k: t[..., k * bl:(k + 1) * bl].contiguous().to(dev)
            for k, dev in block_devices(mesh, axis).items()
        })

    @classmethod
    def full_of(cls, mesh: Mesh, axis: str, length: int, value: float, lead=(),
                dtype=torch.float32) -> "BlockVector":
        bl = length // mesh.shape[axis]
        return cls(mesh, axis, length, {
            k: torch.full(tuple(lead) + (bl,), value, dtype=dtype, device=dev)
            for k, dev in block_devices(mesh, axis).items()
        })

    def new_full(self, lead, value: float, dtype=None) -> "BlockVector":
        """A vector of this layout with leading dimensions ``lead``, filled."""
        return BlockVector.full_of(self.mesh, self.axis, self.length, value, lead,
                                   dtype or self.dtype)

    def zeros_like(self) -> "BlockVector":
        return self._like({k: torch.zeros_like(b) for k, b in self.blocks.items()})

    def clone(self) -> "BlockVector":
        return self._like({k: b.clone() for k, b in self.blocks.items()})

    def to(self, dtype: torch.dtype) -> "BlockVector":
        return self._like({k: b.to(dtype) for k, b in self.blocks.items()})

    def unsqueeze(self, dim: int) -> "BlockVector":
        if dim != 0:
            raise ValueError("a block vector grows leading dimensions only")
        return self._like({k: b.unsqueeze(0) for k, b in self.blocks.items()})

    # ---------------------------------------------------------- blockwise

    def blockwise(self, fn: Callable, *args) -> "BlockVector":
        """``fn`` block by block over ``args``: block vectors of this layout
        give their block, tensors (per-lane values) move to the block's
        device, other values pass as they are."""
        out = {}
        for k, blk in self.blocks.items():
            dev = blk.device
            out[k] = fn(*[a.blocks[k] if isinstance(a, BlockVector) else _move(a, dev)
                          for a in args])
        return self._like(out)

    def _binary(self, other, fn, reflected=False):
        if reflected:
            return self.blockwise(lambda a, b: fn(b, a), self, other)
        return self.blockwise(fn, self, other)

    def __add__(self, other):
        return self._binary(other, torch.add)

    def __radd__(self, other):
        return self._binary(other, torch.add, True)

    def __sub__(self, other):
        return self._binary(other, torch.sub)

    def __rsub__(self, other):
        return self._binary(other, torch.sub, True)

    def __mul__(self, other):
        return self._binary(other, torch.mul)

    def __rmul__(self, other):
        return self._binary(other, torch.mul, True)

    def __truediv__(self, other):
        return self._binary(other, torch.div)

    def __rtruediv__(self, other):
        return self._binary(other, torch.div, True)

    def __neg__(self):
        return self._like({k: -b for k, b in self.blocks.items()})

    # --------------------------------------------------------- reductions

    def _combine(self, partials: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        """Every block's partial on the home device, gathered from the other
        ranks where this one lacks blocks."""
        home = self.mesh.home
        vals = {k: p.to(home) for k, p in partials.items()}
        if gather_needed(self.mesh, self.axis):
            canon = _canonical_positions(self.mesh, self.axis)
            got = all_gather_blocks({canon[k]: v for k, v in vals.items()}, canon,
                                    self.mesh, next(iter(vals.values())))
            vals = {k: got[canon[k]] for k in range(self.n_blocks)}
        return vals

    def _reduce(self, fn: Callable, combine: Callable) -> torch.Tensor:
        vals = self._combine({k: fn(b) for k, b in self.blocks.items()})
        acc = vals[0]
        for k in range(1, self.n_blocks):
            acc = combine(acc, vals[k])
        return acc

    def sum(self, dim: Optional[int] = None) -> torch.Tensor:
        """The sum over the vector axis (``dim`` = -1: per leading index; None:
        of everything), block partials added in block order on home."""
        if dim is None:
            return self._reduce(lambda b: b.sum(), torch.add)
        if dim not in (-1, self.ndim - 1):
            raise ValueError("a block vector reduces over its vector axis only")
        return self._reduce(lambda b: b.sum(-1), torch.add)

    def any(self, dim: int = -1) -> torch.Tensor:
        if dim not in (-1, self.ndim - 1):
            raise ValueError("a block vector reduces over its vector axis only")
        return self._reduce(lambda b: b.any(-1), torch.logical_or)

    # ----------------------------------------------------------- indexing

    def _element(self, i: int):
        i = i + self.length if i < 0 else i
        return divmod(int(i), self.block_len)

    def __getitem__(self, idx):
        """Leading dimensions block by block; on a 1-D vector an int is an
        element (a 0-d tensor on home)."""
        if self.ndim == 1 and isinstance(idx, int):
            k, j = self._element(idx)
            part = {k: self.blocks[k][j]} if k in self.blocks else {}
            home = self.mesh.home
            if gather_needed(self.mesh, self.axis):
                canon = _canonical_positions(self.mesh, self.axis)
                like = torch.zeros((), dtype=self.dtype, device=home)
                got = all_gather_blocks({canon[k]: v.to(home) for k, v in part.items()},
                                        [canon[k]], self.mesh, like)
                return got[canon[k]]
            return part[k].to(home)
        return self._like({k: b[_move_index(idx, b.device)] for k, b in self.blocks.items()})

    def __setitem__(self, idx, value) -> None:
        if self.ndim == 1 and isinstance(idx, int):
            k, j = self._element(idx)
            if k in self.blocks:
                self.blocks[k][j] = _move(value, self.blocks[k].device)
            return
        for k, b in self.blocks.items():
            v = value.blocks[k] if isinstance(value, BlockVector) else _move(value, b.device)
            b[_move_index(idx, b.device)] = v

    # -------------------------------------------------------- assembling

    def full(self, device=None, length: Optional[int] = None) -> torch.Tensor:
        """The whole vector on ``device`` (default home), its first ``length``
        entries only when given: the one place a whole vector is made.
        Gathers the other ranks' blocks where this one lacks some."""
        dev = torch.device(device) if device is not None else self.mesh.home
        vals = self._combine(dict(self.blocks)) if gather_needed(self.mesh, self.axis) \
            else self.blocks
        length = self.length if length is None else int(length)
        out = torch.empty(tuple(self._any().shape[:-1]) + (length,), dtype=self.dtype,
                          device=dev)
        bl = self.block_len
        for k in range(self.n_blocks):
            lo, hi = k * bl, min((k + 1) * bl, length)
            if hi > lo:
                out[..., lo:hi] = vals[k][..., :hi - lo].to(dev)
        return out


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
    processes), a tensor copied to the host, numpy passed through; a
    ``BlockVector`` likewise. In a multi-process run this is a collective
    for a sharded array: every process calls it in the same order."""
    if isinstance(a, BlockVector):
        out = a.full("cpu").numpy()
        was_device = True
    elif isinstance(a, ShardedTensor):
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
