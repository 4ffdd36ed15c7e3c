"""Coordinator side of the cluster plane.

Port of ``photon_ml_tpu/parallel/cluster/coordinator.py``, the same code:
host numpy and sockets, no device work. One coordinator (the trainer)
drives N worker processes. Each full-batch pass partitions the live blocks
across live hosts (:class:`~.assigner.BlockAssigner`), sends each host a
``pass`` message with the current weights, and sums the partial ``(f, g)``
replies in float64: that sum is the allreduce. The solver then finalizes
the regularization on the coordinator exactly as the single-host path
does. The sum is the same full-batch value and gradient as one host
streaming every block; only the order of the floating-point additions
differs, so parity with a single host is held at tolerances, not bitwise.

Replies are summed in arrival order. With two hosts the float64 sum of two
partials is the same in either order, so a 2-host fit on a fresh
coordinator repeats bitwise; with three or more hosts the arrival order,
and so the last bits of the sum, may change from run to run. A later fit
on the same coordinator starts from the gap ledger the earlier one left in
the assigner, so its partitions, and so each host's f32 partial, may
differ from a fresh coordinator's.

Failure protocol:

* a worker that DIES closes its socket; its reader thread sees EOF and
  enqueues a death sentinel;
* a worker that WEDGES stops heartbeating; the pass loop sees ``last_seen``
  older than the heartbeat timeout;
* either way the coordinator calls ``assigner.mark_host_failed``, records
  ``record_failure("cluster_host_lost", ...)`` into the failure ring, and
  re-sends the dead host's unfinished blocks to the survivors as a fresh
  fragment of the SAME pass. Only when no host survives does the pass raise
  :class:`ClusterError`.

Observability (off by default, ``enable_telemetry()``): per-fragment
dispatch and arrival times, the workers' piggybacked timings, and one skew
profile a pass (busy, allreduce wait, the coordinator's fold bubble, the
straggler index, measured against predicted per-host shares), drained by
:meth:`ClusterCoordinator.drain_pass_profiles` into the progress ledger's
``cluster_pass``/``host_pass`` records. With telemetry off the messages
carry no extra key.
"""

from __future__ import annotations

import os
import queue
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.resilience.failures import record_failure
from photon_ml_tpu_torch.telemetry.metrics import get_registry
from photon_ml_tpu_torch.parallel.cluster.assigner import BlockAssigner
from photon_ml_tpu_torch.parallel.cluster.protocol import MessageSocket, recv_msg, send_msg

HEARTBEAT_TIMEOUT_ENV = "PHOTON_CLUSTER_HEARTBEAT_TIMEOUT_S"
_DEFAULT_HEARTBEAT_TIMEOUT_S = 30.0


class ClusterError(RuntimeError):
    """The cluster cannot make progress (no live hosts, bad handshake)."""


class _WorkerHandle:
    def __init__(self, host: int, msock: MessageSocket):
        self.host = host
        self.msock = msock
        self.alive = True
        self.last_seen = time.monotonic()
        # Heartbeat inter-arrival tracking (timeout tuning): last beat time
        # and a bounded window of deltas for the p99 gauge.
        self.last_beat: Optional[float] = None
        self.beat_deltas: List[float] = []


class ClusterCoordinator:
    """Accepts worker connections, drives distributed passes, survives
    worker death mid-pass."""

    def __init__(
        self,
        num_hosts: int,
        num_blocks: int,
        decay: float = 0.6,
        heartbeat_timeout_s: Optional[float] = None,
        bind_host: str = "127.0.0.1",
    ):
        if num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
        self.num_hosts = int(num_hosts)
        self.num_blocks = int(num_blocks)
        self.assigner = BlockAssigner(
            num_blocks, hosts=range(self.num_hosts), decay=decay
        )
        if heartbeat_timeout_s is None:
            heartbeat_timeout_s = float(
                os.environ.get(
                    HEARTBEAT_TIMEOUT_ENV, _DEFAULT_HEARTBEAT_TIMEOUT_S
                )
            )
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        # Bind in __init__ so the port is known before workers spawn.
        self._server = socket.create_server((bind_host, 0))
        self.address: Tuple[str, int] = self._server.getsockname()[:2]
        self.workers: Dict[int, _WorkerHandle] = {}
        self._inbox: "queue.Queue[Tuple[int, Optional[dict]]]" = queue.Queue()
        self._reader_threads: List[threading.Thread] = []
        self._pass_id = 0
        self._next_frag = 0
        self._events: List[dict] = []
        self._closed = False
        # Telemetry (off by default; the wire protocol is unchanged and
        # byte-identical until enable_telemetry() is called).
        self.telemetry_enabled = False
        self._pass_profiles: List[dict] = []
        self._frag_meta: Dict[Tuple[int, int], dict] = {}
        self._pass_t0 = 0.0
        self._pass_requeued = 0

    # -- membership --------------------------------------------------------

    def wait_for_workers(self, timeout_s: float = 300.0) -> None:
        """Accept ``num_hosts`` hellos; reject config-skewed workers whose
        locally planned block count disagrees with ours."""
        deadline = time.monotonic() + timeout_s
        self._server.settimeout(5.0)
        while len(self.workers) < self.num_hosts:
            if time.monotonic() > deadline:
                raise ClusterError(
                    f"only {len(self.workers)}/{self.num_hosts} workers "
                    f"connected within {timeout_s:.0f}s"
                )
            try:
                sock, _ = self._server.accept()
            except socket.timeout:
                continue
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            hello = recv_msg(sock)
            if hello.get("type") != "hello":
                sock.close()
                raise ClusterError(f"expected hello, got {hello!r}")
            host = int(hello["host"])
            if hello.get("num_blocks") != self.num_blocks:
                send_msg(sock, {"type": "stop"})
                sock.close()
                raise ClusterError(
                    f"host {host} planned {hello.get('num_blocks')} blocks, "
                    f"coordinator planned {self.num_blocks}: the workers "
                    "must see the same files and --block-rows"
                )
            if host in self.workers:
                sock.close()
                raise ClusterError(f"duplicate hello from host {host}")
            handle = _WorkerHandle(host, MessageSocket(sock))
            self.workers[host] = handle
            t = threading.Thread(
                target=self._reader, args=(handle,), daemon=True,
                name=f"cluster-reader-{host}",
            )
            t.start()
            self._reader_threads.append(t)

    def _reader(self, handle: _WorkerHandle) -> None:
        try:
            while True:
                msg = handle.msock.recv()
                handle.last_seen = time.monotonic()
                if msg.get("type") == "heartbeat":
                    self._note_heartbeat(handle)
                    continue
                self._inbox.put((handle.host, msg))
        except (EOFError, OSError):
            self._inbox.put((handle.host, None))

    def _note_heartbeat(self, handle: _WorkerHandle) -> None:
        """Track per-host heartbeat inter-arrival so the timeout can be
        tuned from data: ``cluster.heartbeat_interarrival_p99_s{host=h}``
        far below the timeout means the timeout has headroom; near it
        means false host-lost verdicts are imminent."""
        now = time.monotonic()
        if handle.last_beat is not None:
            delta = now - handle.last_beat
            deltas = handle.beat_deltas
            deltas.append(delta)
            if len(deltas) > 256:
                del deltas[: len(deltas) - 256]
            scoped = get_registry().scoped({"host": str(handle.host)})
            scoped.observe("cluster.heartbeat_interarrival_s", delta)
            scoped.gauge(
                "cluster.heartbeat_interarrival_p99_s",
                float(np.percentile(deltas, 99)),
            )
        handle.last_beat = now

    # -- failure -----------------------------------------------------------

    def _lose_host(self, host: int, why: str) -> None:
        handle = self.workers.get(host)
        if handle is None or not handle.alive:
            return
        handle.alive = False
        handle.msock.close()
        self.assigner.mark_host_failed(host)
        record_failure(
            "cluster_host_lost",
            site=f"cluster.host{host}",
            detail=why,
            host=host,
        )
        get_registry().count("cluster.host_failures")
        self._events.append({"event": "host_lost", "host": host, "why": why})

    def _live(self) -> List[_WorkerHandle]:
        return [h for h in self.workers.values() if h.alive]

    def _check_heartbeats(self) -> List[int]:
        now = time.monotonic()
        stale = [
            h.host
            for h in self._live()
            if now - h.last_seen > self.heartbeat_timeout_s
        ]
        for host in stale:
            self._lose_host(host, "heartbeat timeout")
        return stale

    # -- control plane -----------------------------------------------------

    def _send(self, handle: _WorkerHandle, msg: dict) -> bool:
        try:
            handle.msock.send(msg)
            return True
        except OSError:
            self._lose_host(handle.host, "send failed")
            return False

    def set_residual(self, residual: Optional[np.ndarray]) -> None:
        """Broadcast the CD residual plane for the next solve (once per
        outer iteration, not per pass)."""
        payload = None if residual is None else np.asarray(residual)
        for handle in list(self._live()):
            self._send(handle, {"type": "residual", "residual": payload})

    # -- the distributed pass ----------------------------------------------

    def distributed_pass(
        self, w: np.ndarray
    ) -> Tuple[float, np.ndarray, Dict[int, float], List[dict]]:
        """One full-batch pass over every live block, data-parallel.

        Returns ``(f_sum, g_sum, gaps, block_stats)`` — the UNregularized
        sums; the solver's ``finalize`` adds the L2 term on the
        coordinator, exactly as the single-host path does.
        """
        self._pass_id += 1
        pass_id = self._pass_id
        if not self._live():
            raise ClusterError("no live hosts")
        assignment = self.assigner.assign()
        w = np.asarray(w)
        self._next_frag = 0
        tele = self.telemetry_enabled
        self._pass_t0 = time.monotonic()
        self._frag_meta = {}
        self._pass_requeued = 0
        start_unix = time.time() if tele else 0.0
        predicted = self.assigner.predicted_shares(assignment) if tele else {}
        # pending: (host, frag) -> blocks in flight
        pending: Dict[Tuple[int, int], List[int]] = {}
        dropped: List[int] = []
        for host, blocks in assignment.items():
            if not blocks:
                continue
            handle = self.workers[host]
            frag = self._next_frag
            if self._send_fragment(handle, pass_id, frag, w, blocks):
                pending[(host, frag)] = blocks
                self._next_frag += 1
            else:
                # died on send; requeue once the healthy sends are out
                dropped.extend(blocks)
        if dropped:
            self._requeue(pass_id, dropped, pending, w)
        f_sum = 0.0
        g_sum = np.zeros_like(w, dtype=np.float64)
        gaps: Dict[int, float] = {}
        block_stats: List[dict] = []
        arrivals: List[dict] = []
        stray = 0
        # Check heartbeats on a monotonic interval even when the inbox is
        # busy — a chatty inbox must not defer dead-host detection.
        hb_interval = min(1.0, self.heartbeat_timeout_s / 4.0)
        last_hb_check = time.monotonic()
        while pending:
            now = time.monotonic()
            if now - last_hb_check >= hb_interval:
                last_hb_check = now
                for dead in self._check_heartbeats():
                    self._recover(dead, pass_id, pending, w)
                if not pending:
                    break
            try:
                host, msg = self._inbox.get(timeout=hb_interval)
            except queue.Empty:
                continue  # heartbeat check runs at the top of the loop
            if msg is None:
                self._lose_host(host, "connection closed")
                self._recover(host, pass_id, pending, w)
                continue
            if msg.get("type") != "partial" or msg.get("pass_id") != pass_id:
                # stray reply from an abandoned fragment
                get_registry().count("cluster.stray_partials")
                stray += 1
                continue
            key = (host, msg["frag"])
            if key not in pending:
                get_registry().count("cluster.stray_partials")
                stray += 1
                continue
            del pending[key]
            if tele:
                meta = self._frag_meta.pop(key, None) or {
                    "host": host,
                    "frag": int(msg["frag"]),
                    "blocks": 0,
                    "dispatch_s": 0.0,
                }
                meta["arrival_s"] = time.monotonic() - self._pass_t0
                meta["worker"] = dict(msg.get("telemetry") or {})
                arrivals.append(meta)
            f_sum += float(msg["f"])
            g_sum += np.asarray(msg["g"], dtype=np.float64)
            for st in msg.get("block_stats", ()):
                gaps[int(st["block"])] = float(st.get("gap", 0.0))
                block_stats.append(dict(st, host=host))
        self.assigner.update(gaps)
        if tele:
            self._profile_pass(pass_id, start_unix, arrivals, predicted, stray)
        return f_sum, g_sum, gaps, block_stats

    def _send_fragment(
        self,
        handle: _WorkerHandle,
        pass_id: int,
        frag: int,
        w: np.ndarray,
        blocks: List[int],
    ) -> bool:
        """Send one ``pass`` fragment, stamping dispatch time when
        telemetry is on. With telemetry off the message is byte-identical
        to the plain plane (no extra keys)."""
        msg = {
            "type": "pass",
            "pass_id": pass_id,
            "frag": frag,
            "w": w,
            "blocks": blocks,
        }
        if self.telemetry_enabled:
            msg["telemetry"] = True
        if not self._send(handle, msg):
            return False
        if self.telemetry_enabled:
            self._frag_meta[(handle.host, frag)] = {
                "host": handle.host,
                "frag": frag,
                "blocks": len(blocks),
                "dispatch_s": time.monotonic() - self._pass_t0,
            }
        return True

    def _profile_pass(
        self,
        pass_id: int,
        start_unix: float,
        arrivals: List[dict],
        predicted: Dict[int, float],
        stray: int,
    ) -> None:
        """Fold one pass's fragment timeline into a skew profile.

        The decomposition is exact by construction: ``busy_s`` (start →
        first arrival, the fully overlapped compute window) +
        ``allreduce_wait_s`` (first → last arrival, the skew window where
        the coordinator waits on stragglers) + ``bubble_s`` (last arrival
        → end, the coordinator's own fold + assigner update) == wall.
        """
        t_end = time.monotonic()
        wall = max(t_end - self._pass_t0, 1e-12)
        if arrivals:
            first = min(a["arrival_s"] for a in arrivals)
            last = max(a["arrival_s"] for a in arrivals)
        else:
            first = last = wall
        hosts: Dict[int, dict] = {}
        fragments: List[dict] = []
        for a in arrivals:
            worker = a.get("worker") or {}
            h = hosts.setdefault(
                int(a["host"]),
                {
                    "busy_s": 0.0,
                    "wall_s": 0.0,
                    "blocks": 0,
                    "frags": 0,
                    "decode_s": 0.0,
                    "solve_s": 0.0,
                    "reply_s": 0.0,
                    "h2d_bytes": 0,
                },
            )
            h["frags"] += 1
            h["blocks"] += int(worker.get("blocks", a.get("blocks", 0)))
            h["wall_s"] = max(h["wall_s"], float(a["arrival_s"]))
            h["busy_s"] += float(worker.get("busy_s", 0.0))
            h["decode_s"] += float(worker.get("decode_s", 0.0))
            h["solve_s"] += float(worker.get("solve_s", 0.0))
            h["reply_s"] += float(worker.get("reply_s", 0.0))
            h["h2d_bytes"] += int(worker.get("h2d_bytes", 0))
            fragments.append(
                {
                    "host": int(a["host"]),
                    "frag": int(a["frag"]),
                    "blocks": int(a.get("blocks", 0)),
                    "dispatch_s": float(a.get("dispatch_s", 0.0)),
                    "arrival_s": float(a["arrival_s"]),
                    "busy_s": float(worker.get("busy_s", 0.0)),
                }
            )
        total_busy = sum(h["busy_s"] for h in hosts.values())
        for host, h in hosts.items():
            if host in predicted:
                h["predicted_share"] = float(predicted[host])
            if total_busy > 0:
                h["actual_share"] = h["busy_s"] / total_busy
        walls = [h["wall_s"] for h in hosts.values()]
        straggler_index = (
            max(walls) / max(sum(walls) / len(walls), 1e-12) if walls else 1.0
        )
        straggler_host = (
            max(hosts, key=lambda k: hosts[k]["wall_s"]) if hosts else -1
        )
        profile = {
            "pass_id": pass_id,
            "start_unix": start_unix,
            "wall_s": wall,
            "busy_s": first,
            "allreduce_wait_s": max(last - first, 0.0),
            "bubble_s": max(wall - last, 0.0),
            "straggler_index": float(straggler_index),
            "straggler_host": int(straggler_host),
            "blocks": sum(h["blocks"] for h in hosts.values()),
            "hosts": hosts,
            "fragments": fragments,
            "stray_partials": stray,
            "requeued_blocks": self._pass_requeued,
        }
        self._pass_profiles.append(profile)
        get_registry().record_cluster_pass(profile)

    def _recover(
        self,
        dead_host: int,
        pass_id: int,
        pending: Dict[Tuple[int, int], List[int]],
        w: np.ndarray,
    ) -> None:
        """Re-send a dead host's unfinished blocks to the survivors as new
        fragments of the same pass."""
        lost: List[int] = []
        for key in [k for k in pending if k[0] == dead_host]:
            lost.extend(pending.pop(key))
        if not lost:
            return
        if not self._live():
            raise ClusterError(
                f"host {dead_host} died and no hosts survive to take over "
                f"blocks {lost}"
            )
        self._requeue(pass_id, lost, pending, w)

    def _requeue(
        self,
        pass_id: int,
        blocks: List[int],
        pending: Dict[Tuple[int, int], List[int]],
        w: np.ndarray,
    ) -> None:
        if not self._live():
            raise ClusterError("no live hosts to requeue blocks on")
        targets = self.assigner.reassign(blocks)
        get_registry().count("cluster.blocks_reassigned", len(blocks))
        get_registry().count("cluster.requeued_blocks", len(blocks))
        self._pass_requeued += len(blocks)
        self._events.append(
            {
                "event": "blocks_reassigned",
                "blocks": sorted(blocks),
                "targets": {str(h): b for h, b in targets.items()},
            }
        )
        for host, blks in targets.items():
            handle = self.workers[host]
            frag = self._next_frag
            if self._send_fragment(handle, pass_id, frag, np.asarray(w), blks):
                pending[(host, frag)] = blks
                self._next_frag += 1
            else:
                # that survivor died too; recurse onto whoever is left
                self._requeue(pass_id, blks, pending, w)

    # -- bookkeeping -------------------------------------------------------

    def enable_telemetry(self, enabled: bool = True) -> None:
        """Turn on per-pass skew profiling and worker timing piggyback.
        Off by default: the disabled path sends byte-identical messages
        and builds no profiles."""
        self.telemetry_enabled = bool(enabled)

    def drain_pass_profiles(self) -> List[dict]:
        """Return and clear the skew profiles accumulated since the last
        drain (one per :meth:`distributed_pass` with telemetry on)."""
        out = self._pass_profiles
        self._pass_profiles = []
        return out

    def drain_events(self) -> List[dict]:
        out = self._events + self.assigner.drain_decisions()
        self._events = []
        return out

    def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        for handle in self.workers.values():
            if handle.alive:
                try:
                    handle.msock.send({"type": "stop"})
                except OSError:
                    pass
                handle.msock.close()
        try:
            self._server.close()
        except OSError:
            pass
