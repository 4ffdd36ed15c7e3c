"""Worker side of the cluster plane.

Port of ``photon_ml_tpu/parallel/cluster/worker.py``. Each worker owns a
full :class:`~photon_ml_tpu_torch.streaming.StreamingSource` over the SAME
training files as every other host (the plan is rebuilt deterministically
from a sorted file scan, or from the off-heap index stores given to every
host, and the hello handshake verifies the block counts agree), but per
pass it streams only the blocks the coordinator assigned, through the
``order=`` seam of :class:`~photon_ml_tpu_torch.streaming.BlockPrefetcher`.
Over its blocks it accumulates ``StreamPrograms.acc_vg_probe`` on its
``device`` exactly like the single-host solver's full pass (l2 = 0: the
regularization is finalized once, on the coordinator) and replies with the
partial ``(f, g)`` sums as numpy, plus per-block stats for the shared gap
ledger.

The worker runs on ``device`` (default ``cuda``; raises without a card
unless ``device="cpu"``). Before ``hello`` it makes its CUDA context and a
stream of its own: thread-hosted workers (:func:`serve_worker_in_thread`)
share one context, and each runs its passes on its own stream. A streamed
block's features are ELL (``ops.features.EllFeatures``), as in the JAX
package, so a worker's pass launches no hand-written kernel.

Failure semantics are coarse on purpose: ANY exception while streaming a
pass (an armed ``cluster.worker_block`` fault, the chaos kill of
``chaos_kill_after``) kills the worker, whose closed socket is the
coordinator's failure signal; the coordinator reassigns the dead host's
blocks. A heartbeat thread sends ``heartbeat`` every
``HEARTBEAT_INTERVAL_S`` seconds from ``hello`` on.

Run as a module (the launcher does)::

    python -m photon_ml_tpu_torch.parallel.cluster.worker \\
        --coordinator-address 127.0.0.1:PORT --host-id 0 \\
        --train-data-dirs DIR --coordinate-config CFG.json \\
        --task LOGISTIC_REGRESSION --feature-shard global --block-rows 4096 \\
        [--offheap-indexmap-dir IDX] [--device cpu]

or on a thread via :func:`serve_worker_in_thread`.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.parallel.cluster.protocol import connect
from photon_ml_tpu_torch.resilience.faultpoints import (
    FatalInjectedFault,
    fault_point,
    register_fault_site,
)
from photon_ml_tpu_torch.streaming.blocks import StreamingSource
from photon_ml_tpu_torch.streaming.coordinate import _fuse_block_offsets, _objective_for_task
from photon_ml_tpu_torch.streaming.prefetch import BlockPrefetcher
from photon_ml_tpu_torch.streaming.solver import StreamPrograms
from photon_ml_tpu_torch.telemetry.metrics import get_registry
from photon_ml_tpu_torch.telemetry.span import span
from photon_ml_tpu_torch.types import TaskType

logger = logging.getLogger(__name__)

FAULT_SITE = "cluster.worker_block"
register_fault_site(
    FAULT_SITE,
    "cluster worker, before streaming each assigned block: an armed fault "
    "kills the worker mid-pass, exercising host-loss reassignment",
)

BLOCK_LATENCY_ENV = "PHOTON_CLUSTER_BLOCK_LATENCY_S"
HEARTBEAT_INTERVAL_S = 2.0


class ClusterWorker:
    """One host's streaming + partial-accumulation loop."""

    def __init__(
        self,
        host_id: int,
        source: StreamingSource,
        shard_id: str,
        task: TaskType,
        prefetch_depth: int = 2,
        block_latency_s: Optional[float] = None,
        chaos_kill_after: Optional[int] = None,
        device: DeviceLike = DEFAULT_DEVICE,
    ):
        self.host_id = int(host_id)
        self.source = source
        self.shard_id = shard_id
        self.device = resolve_device(device)
        self.objective = _objective_for_task(task)
        self.programs = StreamPrograms.for_objective(self.objective)
        self.prefetch_depth = int(prefetch_depth)
        if block_latency_s is None:
            block_latency_s = float(os.environ.get(BLOCK_LATENCY_ENV, "0"))
        # emulated per-block latency for scaling measurements on one box:
        # sleeps in separate worker processes overlap as device time would
        self.block_latency_s = float(block_latency_s)
        self.chaos_kill_after = None if chaos_kill_after is None else int(chaos_kill_after)
        self._blocks_done = 0
        self._residual_padded: Optional[torch.Tensor] = None
        self._dim = source.plan.shard_dims[shard_id]
        self._stream = None

    def _prepare_device(self) -> None:
        """The CUDA context and this worker's own stream, made before
        ``hello`` (the first use of a card takes seconds)."""
        if self.device.type == "cuda" and self._stream is None:
            torch.cuda.init()
            self._stream = torch.cuda.Stream(self.device)

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # -- one pass fragment -------------------------------------------------

    def _partial(self, w: np.ndarray, blocks: List[int], telemetry: bool = False) -> dict:
        with self._on_stream():
            return self._partial_on_stream(w, blocks, telemetry)

    def _partial_on_stream(self, w: np.ndarray, blocks: List[int], telemetry: bool) -> dict:
        t0 = time.perf_counter() if telemetry else 0.0
        w_dev = torch.as_tensor(np.asarray(w), dtype=torch.float32).to(self.device)
        f = torch.zeros((), dtype=torch.float32, device=self.device)
        g = torch.zeros((self._dim,), dtype=torch.float32, device=self.device)
        stats: List[Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor]] = []
        prefetcher = BlockPrefetcher(
            self.source, shards=(self.shard_id,), depth=self.prefetch_depth,
            order=[int(b) for b in blocks], device=self.device,
        )
        t_decode = time.perf_counter() if telemetry else 0.0
        for blk in prefetcher:
            fault_point(FAULT_SITE)
            if self.chaos_kill_after is not None and self._blocks_done >= self.chaos_kill_after:
                raise FatalInjectedFault(
                    f"chaos: host {self.host_id} killed after {self._blocks_done} blocks"
                )
            data = blk.data[self.shard_id]
            if self._residual_padded is not None:
                data = _fuse_block_offsets(data, self._residual_padded, blk.start)
            f, g, bf, bg, bgap = self.programs.acc_vg_probe(w_dev, data, f, g)
            stats.append((int(blk.index), bf, bg, bgap))
            self._blocks_done += 1
            if self.block_latency_s > 0:
                time.sleep(self.block_latency_s)
        # one pull of every per-block scalar, then the reply in numpy
        host = (torch.stack([torch.stack([bf, bg, bgap]) for _, bf, bg, bgap in stats]).cpu()
                .numpy() if stats else np.zeros((0, 3), np.float32))
        reply = {
            "f": float(f),
            "g": g.cpu().numpy().astype(np.float64),
            "block_stats": [
                {
                    "block": idx,
                    "partial_loss": float(host[i, 0]),
                    "partial_grad_norm": float(host[i, 1]),
                    "gap": float(host[i, 2]),
                }
                for i, (idx, _, _, _) in enumerate(stats)
            ],
        }
        if telemetry:
            # decode (weight upload + prefetcher setup), solve (the block
            # loop), blocks visited and H2D bytes; busy_s/reply_s are
            # stamped by run() just before the send
            reply["telemetry"] = {
                "decode_s": t_decode - t0,
                "solve_s": time.perf_counter() - t_decode,
                "blocks": len(stats),
                "h2d_bytes": int(prefetcher.stats.h2d_bytes),
            }
        return reply

    def _set_residual(self, residual) -> None:
        if residual is None:
            self._residual_padded = None
            return
        r = torch.as_tensor(np.asarray(residual), dtype=torch.float32).to(self.device)
        self._residual_padded = torch.nn.functional.pad(
            r, (0, self.source.plan.padded_rows - r.shape[0])
        )

    # -- protocol loop -----------------------------------------------------

    def run(self, address: Tuple[str, int], connect_timeout_s: float = 60.0) -> None:
        self._prepare_device()
        msock = connect(address, timeout=connect_timeout_s)
        stop_beat = threading.Event()

        def _heartbeat():
            while not stop_beat.wait(HEARTBEAT_INTERVAL_S):
                try:
                    msock.send({"type": "heartbeat", "host": self.host_id})
                except OSError:
                    return

        try:
            msock.send({
                "type": "hello",
                "host": self.host_id,
                "num_blocks": self.source.plan.num_blocks,
            })
            threading.Thread(
                target=_heartbeat, daemon=True, name=f"cluster-heartbeat-{self.host_id}",
            ).start()
            while True:
                msg = msock.recv()
                kind = msg.get("type")
                if kind == "stop":
                    break
                if kind == "residual":
                    with self._on_stream():
                        self._set_residual(msg["residual"])
                elif kind == "pass":
                    # "telemetry" is set only when the coordinator's own
                    # telemetry is on; without it the reply has no extra key
                    want_tele = bool(msg.get("telemetry"))
                    t_recv = time.perf_counter() if want_tele else 0.0
                    with span("cluster/fragment", host=self.host_id,
                              pass_id=int(msg["pass_id"]), frag=int(msg["frag"]),
                              blocks=len(msg["blocks"])):
                        reply = self._partial(msg["w"], msg["blocks"], telemetry=want_tele)
                    reply.update(type="partial", pass_id=msg["pass_id"], frag=msg["frag"],
                                 host=self.host_id)
                    if want_tele:
                        wt = reply["telemetry"]
                        t_send = time.perf_counter()
                        wt["reply_s"] = max(0.0, t_send - t_recv - wt["decode_s"] - wt["solve_s"])
                        wt["busy_s"] = t_send - t_recv
                        reg = get_registry()
                        reg.count("cluster.worker.fragments")
                        reg.count("cluster.worker.blocks", wt["blocks"])
                        reg.count("cluster.worker.h2d_bytes", wt["h2d_bytes"])
                        reg.observe("cluster.worker.solve_s", wt["solve_s"])
                    msock.send(reply)
        except EOFError:
            logger.info("host %d: coordinator closed connection", self.host_id)
        finally:
            stop_beat.set()
            msock.close()


def serve_worker_in_thread(worker: ClusterWorker, address: Tuple[str, int]) -> threading.Thread:
    """Run a worker's protocol loop on a daemon thread (the full wire
    protocol without a process start). A fatal injected fault ends the
    thread and closes the socket: the same death signal a killed process
    gives."""

    def _run():
        try:
            worker.run(address)
        except FatalInjectedFault as exc:
            logger.info("host %d chaos-killed: %s", worker.host_id, exc)
        except Exception:
            logger.exception("host %d worker died", worker.host_id)

    t = threading.Thread(target=_run, daemon=True, name=f"cluster-worker-{worker.host_id}")
    t.start()
    return t


# -- subprocess entry ------------------------------------------------------


def _parse_address(spec: str) -> Tuple[str, int]:
    host, _, port = spec.rpartition(":")
    return host or "127.0.0.1", int(port)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="photon-ml-tpu-torch cluster worker (spawned by the launcher)"
    )
    p.add_argument("--coordinator-address", required=True)
    p.add_argument("--host-id", type=int, required=True)
    p.add_argument("--train-data-dirs", nargs="+", required=True)
    p.add_argument("--coordinate-config", required=True)
    p.add_argument("--task", required=True)
    p.add_argument("--feature-shard", required=True)
    p.add_argument("--block-rows", type=int, default=4096)
    p.add_argument("--input-columns-names", default=None)
    p.add_argument("--prefetch-depth", type=int, default=2)
    p.add_argument("--on-block-error", default="fail")
    p.add_argument("--block-cache-dir", default=None)
    p.add_argument("--offheap-indexmap-dir", default=None,
                   help="read features through build_index's off-heap stores "
                        "(one subdirectory a feature shard), as the coordinator does")
    p.add_argument("--block-latency-s", type=float, default=None)
    p.add_argument("--chaos-kill-after", type=int, default=None)
    p.add_argument("--telemetry-out", default=None, metavar="LEDGER.jsonl",
                   help="write this worker's own run ledger (fragment spans, "
                        "cluster.worker.* counters) here; enables span tracing "
                        "in the worker process")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of this worker: 'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format=f"[host {args.host_id}] %(levelname)s %(message)s")
    from photon_ml_tpu_torch.cli.common import (
        expand_data_dirs,
        id_tags_needed,
        load_game_config,
        load_index_maps,
        parse_input_columns,
    )

    device = resolve_device(args.device)
    shard_configs, coordinates, _, _ = load_game_config(args.coordinate_config)
    col_names = parse_input_columns(args.input_columns_names)
    train_dirs = expand_data_dirs(args.train_data_dirs, None, None)
    # index_maps=None rebuilds the maps from the sorted file scan; with
    # stores every host reads the same ones: either way every host and the
    # coordinator plan the same blocks
    source = StreamingSource.open(
        train_dirs, shard_configs,
        index_maps=load_index_maps(args.offheap_indexmap_dir, shard_configs),
        block_rows=args.block_rows, id_tags=id_tags_needed(coordinates),
        cache_dir=args.block_cache_dir, **col_names,
    )
    source.on_block_error = args.on_block_error
    worker = ClusterWorker(
        host_id=args.host_id, source=source, shard_id=args.feature_shard,
        task=TaskType[args.task], prefetch_depth=args.prefetch_depth,
        block_latency_s=args.block_latency_s, chaos_kill_after=args.chaos_kill_after,
        device=device,
    )
    run = None
    if args.telemetry_out:
        from photon_ml_tpu_torch.telemetry import start_run

        run = start_run(f"cluster-worker-{args.host_id}", ledger_path=args.telemetry_out)
    try:
        worker.run(_parse_address(args.coordinator_address))
    except FatalInjectedFault as exc:
        logger.error("chaos-killed: %s", exc)
        return 17
    finally:
        if device.type == "cuda":
            logger.info("peak device memory %d bytes",
                        torch.cuda.max_memory_allocated(device))
        if run is not None:
            try:
                run.finish()
            except Exception:
                logger.exception("worker telemetry finish failed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
