"""Cluster launcher: spawn and supervise the worker processes.

Port of ``photon_ml_tpu/parallel/cluster/launcher.py``.
``ClusterPlane.launch`` starts one coordinator in this process (the trainer
IS the coordinator, like the reference's Spark driver) and ``num_hosts``
worker processes running ``python -m
photon_ml_tpu_torch.parallel.cluster.worker``. Unlike the JAX package,
whose emulated mesh pins every worker to the host CPU, the workers run on
``device`` (default ``cuda``; ``"cpu"`` only when asked): on a machine with
one card every worker shares ``cuda:0``, each with its own CUDA context,
stream and pinned staging ring. Worker output goes to per-host log FILES,
not pipes (an unread pipe can wedge a worker mid-print).

The same object shape (``set_residual`` / ``distributed_pass`` /
``drain_events``) is what
:class:`~photon_ml_tpu_torch.streaming.StreamingFixedEffectCoordinate`
takes as its ``cluster``; a bare :class:`ClusterCoordinator` with
thread-hosted workers satisfies it too.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.parallel.cluster.coordinator import ClusterCoordinator

STARTUP_TIMEOUT_ENV = "PHOTON_CLUSTER_STARTUP_TIMEOUT_S"
_DEFAULT_STARTUP_TIMEOUT_S = 300.0


class ClusterPlane:
    """A live cluster: in-process coordinator + spawned worker processes."""

    def __init__(
        self,
        coordinator: ClusterCoordinator,
        procs: Sequence[subprocess.Popen],
        log_paths: Sequence[str],
    ):
        self.coordinator = coordinator
        self.procs = list(procs)
        self.log_paths = list(log_paths)
        self._closed = False

    # -- construction ------------------------------------------------------

    @classmethod
    def launch(
        cls,
        num_hosts: int,
        num_blocks: int,
        train_dirs: Sequence[str],
        coordinate_config: str,
        task: str,
        feature_shard: str,
        block_rows: int,
        input_columns_names: Optional[str] = None,
        on_block_error: str = "fail",
        prefetch_depth: int = 2,
        block_cache_dir: Optional[str] = None,
        block_latency_s: Optional[float] = None,
        kill_host: Optional[Tuple[int, int]] = None,
        heartbeat_timeout_s: Optional[float] = None,
        startup_timeout_s: Optional[float] = None,
        log_dir: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
        telemetry_dir: Optional[str] = None,
        offheap_indexmap_dir: Optional[str] = None,
        device: DeviceLike = DEFAULT_DEVICE,
    ) -> "ClusterPlane":
        """Spawn ``num_hosts`` workers over the same training files and
        block plan; ``kill_host=(h, n)`` arms host ``h`` to chaos-die after
        streaming ``n`` blocks (the killed-host-mid-epoch drill).
        ``telemetry_dir`` federates observability across the mesh: the
        coordinator profiles every pass (skew/straggler attribution) and
        each worker writes its own ledger to
        ``{telemetry_dir}/worker-{host}-ledger.jsonl``. ``device`` is every
        worker's device (``--device``); ``offheap_indexmap_dir`` gives every
        worker the coordinator's off-heap index stores."""
        dev = resolve_device(device)
        coordinator = ClusterCoordinator(
            num_hosts, num_blocks, heartbeat_timeout_s=heartbeat_timeout_s
        )
        if telemetry_dir is not None:
            os.makedirs(telemetry_dir, exist_ok=True)
            coordinator.enable_telemetry()
        if log_dir is None:
            log_dir = tempfile.mkdtemp(prefix="photon-cluster-")
        os.makedirs(log_dir, exist_ok=True)
        worker_env = dict(os.environ)
        # the workers share one box: keep each worker's BLAS pool from
        # oversubscribing it
        worker_env.setdefault("OPENBLAS_NUM_THREADS", "1")
        # the workers import this checkout's package, wherever they start
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
        worker_env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in worker_env.get("PYTHONPATH", "").split(os.pathsep) if p])
        if env:
            worker_env.update(env)
        addr = f"{coordinator.address[0]}:{coordinator.address[1]}"
        procs: List[subprocess.Popen] = []
        log_paths: List[str] = []
        try:
            for host in range(num_hosts):
                cmd = [
                    sys.executable, "-m",
                    "photon_ml_tpu_torch.parallel.cluster.worker",
                    "--coordinator-address", addr,
                    "--host-id", str(host),
                    "--train-data-dirs", *list(train_dirs),
                    "--coordinate-config", coordinate_config,
                    "--task", task,
                    "--feature-shard", feature_shard,
                    "--block-rows", str(block_rows),
                    "--prefetch-depth", str(prefetch_depth),
                    "--on-block-error", on_block_error,
                    "--device", str(dev),
                ]
                if offheap_indexmap_dir:
                    cmd += ["--offheap-indexmap-dir", offheap_indexmap_dir]
                if input_columns_names:
                    cmd += ["--input-columns-names", input_columns_names]
                if block_cache_dir:
                    # per-host subdirs: the decoded entries are identical
                    # but concurrent writers should not share files
                    cmd += [
                        "--block-cache-dir",
                        os.path.join(block_cache_dir, f"host-{host}"),
                    ]
                if block_latency_s is not None:
                    cmd += ["--block-latency-s", str(block_latency_s)]
                if kill_host is not None and kill_host[0] == host:
                    cmd += ["--chaos-kill-after", str(kill_host[1])]
                if telemetry_dir is not None:
                    cmd += [
                        "--telemetry-out",
                        os.path.join(
                            telemetry_dir, f"worker-{host}-ledger.jsonl"
                        ),
                    ]
                log_path = os.path.join(log_dir, f"worker-{host}.log")
                log_paths.append(log_path)
                log_f = open(log_path, "wb")
                try:
                    procs.append(
                        subprocess.Popen(
                            cmd, stdout=log_f, stderr=subprocess.STDOUT,
                            env=worker_env,
                        )
                    )
                finally:
                    log_f.close()
            if startup_timeout_s is None:
                startup_timeout_s = float(
                    os.environ.get(
                        STARTUP_TIMEOUT_ENV, _DEFAULT_STARTUP_TIMEOUT_S
                    )
                )
            coordinator.wait_for_workers(timeout_s=startup_timeout_s)
        except BaseException:
            for p in procs:
                p.kill()
                p.wait()
            coordinator.shutdown()
            raise
        return cls(coordinator, procs, log_paths)

    # -- training-plane interface (what the coordinate calls) --------------

    @property
    def num_blocks(self) -> int:
        return self.coordinator.num_blocks

    def set_residual(self, residual: Optional[np.ndarray]) -> None:
        self.coordinator.set_residual(residual)

    def distributed_pass(self, w: np.ndarray):
        return self.coordinator.distributed_pass(w)

    def drain_events(self) -> List[dict]:
        return self.coordinator.drain_events()

    def drain_pass_profiles(self) -> List[dict]:
        return self.coordinator.drain_pass_profiles()

    # -- lifecycle ---------------------------------------------------------

    def worker_logs(self) -> Dict[int, str]:
        out = {}
        for host, path in enumerate(self.log_paths):
            try:
                with open(path, "r", errors="replace") as f:
                    out[host] = f.read()
            except OSError:
                out[host] = ""
        return out

    def close(self, reap_timeout_s: float = 30.0) -> None:
        if self._closed:
            return
        self._closed = True
        self.coordinator.shutdown()
        for p in self.procs:
            try:
                p.wait(timeout=reap_timeout_s)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def __enter__(self) -> "ClusterPlane":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
