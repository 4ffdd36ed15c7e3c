"""The parallel plane: device meshes, the (data x feat) grid of
fixed-effect tiles, the multi-process runtime on ``torch.distributed``
and the cluster plane (``parallel/cluster``).

Port of ``photon_ml_tpu/parallel`` with its module paths and names.
"""

from photon_ml_tpu_torch.parallel.grid_features import (
    GridShardedFeatures,
    grid_from_coo,
    grid_mesh,
)
from photon_ml_tpu_torch.parallel.mesh import (
    data_parallel_mesh,
    fetch_global,
    pad_batch_to_multiple,
    replicate,
    shard_batch,
)
from photon_ml_tpu_torch.parallel.multihost import (
    barrier,
    global_batch_from_host_rows,
    host_shard_files,
    initialize_distributed,
)

__all__ = [
    "GridShardedFeatures",
    "barrier",
    "data_parallel_mesh",
    "fetch_global",
    "global_batch_from_host_rows",
    "grid_from_coo",
    "grid_mesh",
    "host_shard_files",
    "initialize_distributed",
    "pad_batch_to_multiple",
    "replicate",
    "shard_batch",
]
