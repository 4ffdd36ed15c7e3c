"""Multi-process runtime: process-group init and host-sharded input.

Port of ``photon_ml_tpu/parallel/multihost.py`` onto ``torch.distributed``.
The reference's multi-node story is Spark/YARN (executors pull partitions,
the driver coordinates); the JAX package's is one process per host joined
by ``jax.distributed``. Here each process joins one process group by
``init_process_group`` with a ``tcp://`` rendezvous at
``--coordinator-address``: gloo when the process trains on the host, nccl
on cards. Nothing on a machine announces a cluster, so a process with no
explicit request stays a single process; a single process is not a
cluster.

These are the seams the CLIs call first (``initialize_from_args``) and
that multi-process input pipelines use (file sharding, global batch
assembly); in one process they are the identity.
"""

from __future__ import annotations

import datetime
import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.parallel.mesh import Mesh, ShardedTensor, place, world

logger = logging.getLogger("photon_ml_tpu_torch")

# the process group's collectives time out after this long (a dead peer
# otherwise wedges a collective for the default 10 minutes)
TIMEOUT_S = 300.0


def _device_in_use(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_initialized()


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = DEFAULT_DEVICE,
) -> bool:
    """Join this process to the process group. Returns True when a
    multi-process group is (or already was) established.

    MUST run before the first use of the device (the CLIs call it first):
    on ``cuda`` each rank takes card ``process_id % device_count`` before
    any CUDA context exists. With no arguments the process stays single
    (returns False); an explicit request with a missing part, or one made
    after the device is in use, raises. The backend is gloo on ``cpu``,
    nccl on ``cuda``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if not explicit:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "an explicit cluster launch needs --coordinator-address, "
            "--num-processes and --process-id together"
        )
    if int(num_processes) <= 1:
        return False  # a single process is not a cluster
    dev = resolve_device(device)
    if _device_in_use(dev):
        raise RuntimeError(
            "initialize_distributed(coordinator_address=...) must run before "
            "the first use of the device"
        )
    if dev.type == "cuda":
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    address = coordinator_address
    if not address.startswith(("tcp://", "env://", "file://")):
        address = f"tcp://{address}"
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=address,
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    logger.info("process %d of %d joined %s", int(process_id), int(num_processes), address)
    return dist.get_world_size() > 1


def barrier(name: str = "photon-ml-tpu-barrier") -> None:
    """Block until every process reaches this point (no-op in one process).
    Use after single-writer persistence (process 0 writes, the others then
    read) and before tearing down shared resources."""
    if world()[1] <= 1:
        return
    import torch.distributed as dist

    logger.debug("barrier %s", name)
    dist.barrier()


def add_distributed_args(parser) -> None:
    """CLI flags for an explicit cluster launch (torchrun-style): every
    process of the job runs the same command with its own --process-id."""
    parser.add_argument(
        "--coordinator-address", default=None,
        help="host:port of process 0's rendezvous (explicit multi-process launch)",
    )
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)


def initialize_from_args(args) -> bool:
    """``initialize_distributed`` from parsed CLI args (the CLIs call this
    first, before any device use); the device is ``args.device``."""
    return initialize_distributed(
        coordinator_address=getattr(args, "coordinator_address", None),
        num_processes=getattr(args, "num_processes", None),
        process_id=getattr(args, "process_id", None),
        device=getattr(args, "device", DEFAULT_DEVICE),
    )


def host_shard_files(paths: Sequence[str]) -> List[str]:
    """This process's slice of the input files: a round-robin over the
    sorted list, so every process computes the same assignment."""
    ordered = sorted(paths)
    i, n = world()
    if n <= 1:
        return ordered
    return [p for k, p in enumerate(ordered) if k % n == i]


def global_batch_from_host_rows(rows: np.ndarray, mesh: Mesh, spec,
                                global_rows: Optional[int] = None) -> ShardedTensor:
    """Assemble a globally sharded batch array from this process's row
    block.

    ``rows`` is the process-local data; ``spec`` a ``P`` placing the
    global batch over ``mesh``. In one process this is :func:`place`. With
    several, each process's block must be exactly the rows its own mesh
    positions address (the rows of those positions, in order); this helper
    never moves rows between processes. File sharding
    (:func:`host_shard_files`) generally gives unequal row counts, so input
    pipelines equalize first (zero-weight padding rows are exact no-ops in
    every objective); a block of the wrong size raises with that remedy."""
    if world()[1] <= 1:
        return place(rows, mesh, spec)
    rows_t = torch.as_tensor(np.asarray(rows))
    n_global = (int(global_rows) if global_rows is not None
                else None)
    axis = spec[0] if len(spec) else None
    local = mesh.local_positions()
    if axis is None:
        want = rows_t.shape[0] if n_global is None else n_global
        blocks = None
    else:
        k_axis = mesh.axis_names.index(axis)
        parts = sorted({pos[k_axis] for pos in local})
        n_parts = mesh.shape[axis]
        if n_global is None:
            n_global = rows_t.shape[0] * n_parts // max(len(parts), 1)
        step = -(-n_global // n_parts)
        want = step * len(parts)
        blocks = {p: i for i, p in enumerate(parts)}
    if rows_t.shape[0] != want:
        raise ValueError(
            f"this process holds {rows_t.shape[0]} rows but its devices address "
            f"{want} rows of the global batch under spec {tuple(spec)}\n"
            "Each host must supply exactly the rows its own devices "
            "address under the given spec (or the full global batch when "
            "the batch dimension is replicated); this helper never moves "
            "rows between hosts. Equalize per-host batches first — pad "
            "with zero-weight rows (exact no-ops in every objective) or "
            "trim to the share."
        )
    shape = (n_global if axis is not None else rows_t.shape[0],) + tuple(rows_t.shape[1:])
    st = ShardedTensor(shape, rows_t.dtype, mesh, spec, {})
    for pos in local:
        if blocks is None:
            st.shards[pos] = rows_t.to(mesh.devices[pos])
        else:
            i = blocks[pos[mesh.axis_names.index(axis)]]
            st.shards[pos] = rows_t[i * step:(i + 1) * step].to(mesh.devices[pos])
    return st
