"""Cluster plane: multi-host streaming data-parallel coordinate descent.

Port of ``photon_ml_tpu/parallel/cluster`` with its module paths and public
names: the streamed full-batch solve of ``streaming/`` run data-parallel
across worker processes, the gap ledger generalized into cross-host block
assignment, and the failure plane extended with a host-failure protocol
(heartbeat and socket-EOF detection, block reassignment instead of an
abort). The workers run on the card (``device``, default ``cuda``).
"""

from photon_ml_tpu_torch.parallel.cluster.assigner import BlockAssigner
from photon_ml_tpu_torch.parallel.cluster.coordinator import ClusterCoordinator, ClusterError
from photon_ml_tpu_torch.parallel.cluster.launcher import ClusterPlane
from photon_ml_tpu_torch.parallel.cluster.protocol import (
    MessageSocket,
    ProtocolError,
    connect,
    recv_msg,
    send_msg,
)
from photon_ml_tpu_torch.parallel.cluster.worker import ClusterWorker, serve_worker_in_thread

__all__ = [
    "BlockAssigner",
    "ClusterCoordinator",
    "ClusterError",
    "ClusterPlane",
    "ClusterWorker",
    "MessageSocket",
    "ProtocolError",
    "connect",
    "recv_msg",
    "send_msg",
    "serve_worker_in_thread",
]
