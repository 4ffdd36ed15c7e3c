"""Request-stream replay: drive the serving stack from a scoring dataset.

Turns ``GameData`` rows into ``ScoreRequest``s (one per row: sparse
features per shard the artifact consumes, the row's entity id per
random-effect type, its offset) and pumps them through a microbatcher with
full metrics/event instrumentation. This is the shared replay loop behind
``cli/serve_game.py`` and the serving mode of ``bench.py``; tests use it to
prove the online path reproduces the offline ``GameModel.score``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.data.game_data import GameData
from photon_ml_tpu_torch.serving.artifact import ServingArtifact
from photon_ml_tpu_torch.serving.batcher import DEFAULT_BUCKET_SIZES, MicroBatcher
from photon_ml_tpu_torch.serving.continuous import ContinuousBatcher
from photon_ml_tpu_torch.serving.metrics import ServingMetrics
from photon_ml_tpu_torch.serving.scorer import GameScorer, ScoreRequest, ScoreResult
from photon_ml_tpu_torch.telemetry import span


def requests_from_game_data(
    data: GameData,
    artifact: ServingArtifact,
    uids: Optional[Sequence[Optional[str]]] = None,
    max_requests: Optional[int] = None,
) -> List[ScoreRequest]:
    """One ScoreRequest per dataset row, restricted to the shards and
    random-effect types the artifact actually consumes."""
    n = data.num_rows
    if max_requests is not None:
        n = min(n, int(max_requests))
    shards = sorted({t.feature_shard for t in artifact.tables.values()})
    re_types = [t for t in artifact.random_effect_types() if t in data.id_tags]

    per_row: Dict[str, List[Dict[int, float]]] = {}
    for shard_name in shards:
        shard = data.feature_shards[shard_name]
        feats: List[Dict[int, float]] = [{} for _ in range(n)]
        keep = shard.rows < n
        for r, c, v in zip(
            shard.rows[keep], shard.cols[keep], shard.vals[keep]
        ):
            feats[int(r)][int(c)] = float(v)
        per_row[shard_name] = feats

    requests = []
    for i in range(n):
        rid = None
        if uids is not None and i < len(uids):
            rid = uids[i]
        requests.append(
            ScoreRequest(
                request_id=str(rid) if rid is not None else f"row-{i}",
                features={s: per_row[s][i] for s in shards},
                entity_ids={t: str(data.id_tags[t][i]) for t in re_types},
                offset=float(data.offsets[i]),
            )
        )
    return requests


def max_nnz_of(
    requests: Sequence[ScoreRequest], round_pow2: bool = True
) -> Dict[str, int]:
    """Per-shard max nonzero count over a request stream — a tight
    ``GameScorer(max_nnz=...)`` choice for replay (rounded up to a power of
    two so near-boundary streams do not split compile signatures)."""
    out: Dict[str, int] = {}
    for req in requests:
        for shard, feats in req.features.items():
            out[shard] = max(out.get(shard, 1), len(feats))
    if round_pow2:
        out = {s: 1 << (int(k - 1)).bit_length() for s, k in out.items()}
    return out


def replay_requests(
    scorer: GameScorer,
    requests: Sequence[ScoreRequest],
    bucket_sizes: Sequence[int] = DEFAULT_BUCKET_SIZES,
    metrics: Optional[ServingMetrics] = None,
    emitter=None,
    model_id: str = "game-model",
    swap_manager=None,
    watch_dir: Optional[str] = None,
    poll_every: int = 256,
    continuous: bool = False,
    max_wait_s: float = 0.002,
    max_queue: Optional[int] = None,
    admission=None,
    plane=None,
    overload=None,
    quota=None,
) -> Tuple[List[ScoreResult], dict]:
    """Pump a request stream through a fresh microbatcher.

    Returns (results in submission order, metrics snapshot). When an
    ``EventEmitter`` is given, a ``ScoringStartEvent`` fires before the
    first request and a ``ScoringFinishEvent`` (carrying the snapshot)
    after the flush. When a ``HotSwapManager`` and ``watch_dir`` are given,
    the batcher is flushed and ``swap_manager.poll_directory(watch_dir)``
    called every ``poll_every`` requests — new deltas land between batches,
    never under an in-flight one; swap reports ride in the snapshot under
    ``"swap_reports"``.

    ``continuous=True`` drives a :class:`ContinuousBatcher` instead of the
    sealed ``MicroBatcher``: ``scorer`` may then be ONE scorer or a list
    of replicas (multi-scorer mode), requests are submitted in bursts and
    scored by the batcher's threads, and ``max_wait_s``/``max_queue``
    bound deadline and backpressure. An ``AdmissionController`` passed as
    ``admission`` runs for the duration of the replay (started/stopped
    here when not already running) and its stats ride in the snapshot.

    A :class:`~photon_ml_tpu_torch.serving.requestplane.RequestPlane` passed as
    ``plane`` is threaded through the batcher (lifecycle sampling + SLO
    feed), the metrics (hot-swap pauses become interference spans), and
    the admission controller (admit windows likewise); its summary — and
    the SLO status when the plane carries a tracker — ride in the
    snapshot under ``"request_plane"`` / ``"slo"``. ``plane=None`` (the
    default) is the bitwise-pinned zero-cost path.

    An :class:`~photon_ml_tpu_torch.serving.overload.OverloadController` passed
    as ``overload`` is attached to the batcher for the duration of the
    replay (deadline shrink + FE-only shed, detached on exit; its scorer
    binding defaults to the lead scorer when not already bound) and its
    status rides in the snapshot under ``"overload"``. A ``quota``
    (tenancy token bucket) is forwarded to the batcher for drain-time
    tenant admission.
    """
    from photon_ml_tpu_torch.event import ScoringFinishEvent, ScoringStartEvent

    scorers = list(scorer) if isinstance(scorer, (list, tuple)) else [scorer]
    lead = scorers[0]
    metrics = metrics if metrics is not None else ServingMetrics()
    if plane is not None:
        # interference producers: hot-swap pauses via the metrics hook,
        # admission windows via the controller hook
        metrics.request_plane = plane
        if admission is not None:
            admission.request_plane = plane
    if emitter is not None:
        emitter.send_event(
            ScoringStartEvent(model_id=model_id, num_requests=len(requests))
        )
    watching = swap_manager is not None and watch_dir is not None
    poll_every = max(1, int(poll_every))
    swap_reports: List[object] = []
    results: List[ScoreResult] = []

    started_admission = False
    if admission is not None and admission._thread is None:
        admission.start()
        started_admission = True
    try:
        t0 = time.perf_counter()
        with span(
            "serve/replay", num_requests=len(requests), model_id=model_id
        ):
            if overload is not None and overload._scorer is None:
                overload.attach_scorer(lead)
            if continuous:
                batcher = ContinuousBatcher(
                    scorers,
                    bucket_sizes=bucket_sizes,
                    metrics=metrics,
                    max_wait_s=max_wait_s,
                    max_queue=max_queue,
                    plane=plane,
                    quota=quota,
                ).start()
                if overload is not None:
                    overload.attach(batcher)
                try:
                    handles = []
                    chunk = batcher.max_bucket
                    for i in range(0, len(requests), chunk):
                        if watching and (i // chunk) % max(
                            1, poll_every // chunk
                        ) == 0:
                            batcher.flush()
                            swap_reports.extend(
                                swap_manager.poll_directory(watch_dir)
                            )
                        handles.extend(
                            batcher.submit_many(requests[i : i + chunk])
                        )
                    batcher.flush()
                finally:
                    if overload is not None:
                        overload.detach(batcher)
                    batcher.stop()
                if quota is None:
                    results = [h.result(timeout=0) for h in handles]
                else:
                    results = []
                    for h in handles:
                        try:
                            results.append(h.result(timeout=0))
                        except RuntimeError:
                            # drain-time quota shed: the request was
                            # answered with an error and charged to its
                            # tenant; the replay stream continues
                            pass
            else:
                if len(scorers) != 1:
                    raise ValueError(
                        "sealed replay drives one scorer; pass "
                        "continuous=True for multi-scorer mode"
                    )
                batcher = MicroBatcher(
                    lead, bucket_sizes=bucket_sizes, metrics=metrics,
                    plane=plane, quota=quota,
                )
                if overload is not None:
                    overload.attach(batcher)
                for i, req in enumerate(requests):
                    if watching and i % poll_every == 0:
                        results.extend(batcher.flush())
                        swap_reports.extend(
                            swap_manager.poll_directory(watch_dir)
                        )
                    results.extend(batcher.submit(req))
                results.extend(batcher.flush())
                if overload is not None:
                    overload.detach(batcher)
        wall = time.perf_counter() - t0
    finally:
        if started_admission:
            admission.stop()

    residency = None
    if hasattr(lead, "residency_stats"):
        residency = lead.residency_stats() or None
    snapshot = metrics.snapshot(
        cache_stats=lead.cache_stats() or None,
        compile_count=max(s.compile_count for s in scorers),
        residency=residency,
        admission=admission.stats() if admission is not None else None,
    )
    snapshot["replay_wall_seconds"] = round(wall, 6)
    if wall > 0:
        snapshot["replay_requests_per_s"] = round(len(requests) / wall, 3)
    if plane is not None:
        report = plane.live_report()
        slo = report.pop("slo", None)
        snapshot["request_plane"] = report
        if slo is not None:
            snapshot["slo"] = slo
    if overload is not None:
        snapshot["overload"] = overload.status()
    if watching:
        snapshot["swap_reports"] = [
            {
                "generation": r.generation,
                "fingerprint": r.fingerprint,
                "rows_updated": r.rows_updated,
                "rolled_back": r.rolled_back,
                "blackout_s": round(r.blackout_s, 6),
            }
            for r in swap_reports
        ]
    if emitter is not None:
        emitter.send_event(
            ScoringFinishEvent(
                model_id=model_id,
                num_requests=len(results),
                wall_seconds=wall,
                metrics=dict(snapshot),
            )
        )
    return results, snapshot
