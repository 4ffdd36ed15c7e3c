"""GAME online serving CLI: export a serving artifact and replay a
request stream against it.

Port of ``photon_ml_tpu/cli/serve_game.py``: the single-tenant path, with
the same flags and report, on ``--device`` (default ``cuda``; ``cpu`` only
when asked): every flag of the JAX CLI, the nearline loop's
``--watch-deltas`` and the variant plane's ``--variants`` included.

The offline CLI (``score_game``) reloads the Avro model and scores a
static dataset in one pass; this CLI exercises the *online* path: the
model is packed into a serving artifact (dense FE coefficients +
contiguous per-entity RE tables behind off-heap entity indexes), requests
are drawn row-by-row from a scoring dataset, coalesced by the continuous
microbatcher into fixed-bucket batches, and scored against sharded
device-resident RE tables (entity→(shard, slot) routing, async admission
of the cold tail, optionally one scorer replica per device). Passing
``--cache-capacity`` instead selects the legacy sealed path: a single
``GameScorer`` behind an LRU hot-entity row cache. Prints a one-line JSON
metrics report (latency percentiles, sustained request rate, batch fill,
device residency, score-signature count).

Usage:
    # pack a trained model and serve a replayed stream
    python -m photon_ml_tpu_torch.cli.serve_game \
        --model-dir out/best --data-dirs data/test \
        --export-artifact-dir out/artifact --max-requests 10000

    # serve from a previously exported artifact
    python -m photon_ml_tpu_torch.cli.serve_game \
        --artifact-dir out/artifact --data-dirs data/test

    # additionally hot-swap nearline deltas (update_game output) into the
    # live scorer between request chunks — no restart, no new signature
    python -m photon_ml_tpu_torch.cli.serve_game \
        --artifact-dir out/artifact --data-dirs data/test \
        --watch-deltas out/deltas

    # the same on the host
    python -m photon_ml_tpu_torch.cli.serve_game \
        --artifact-dir out/artifact --data-dirs data/test --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from photon_ml_tpu_torch.cli.common import (
    add_telemetry_args,
    finish_telemetry,
    parse_input_columns,
    setup_logger,
    start_telemetry,
)
from photon_ml_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from photon_ml_tpu_torch.utils.timer import Timer

DEFAULT_BUCKETS = "1,2,4,8,16,32"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu serve-game", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--model-dir",
                     help="trained GAME model directory to pack on the fly")
    src.add_argument("--artifact-dir",
                     help="previously exported serving artifact directory")
    p.add_argument("--data-dirs", nargs="+", default=None,
                   help="scoring dataset dirs replayed as the request stream")
    p.add_argument("--export-artifact-dir", default=None,
                   help="write the packed serving artifact here "
                        "(with --model-dir; train → export → serve)")
    p.add_argument("--bucket-sizes", default=DEFAULT_BUCKETS,
                   help="comma-separated microbatch bucket sizes "
                        f"(default {DEFAULT_BUCKETS}); one score signature "
                        "per bucket")
    p.add_argument("--cache-capacity", type=int, default=None,
                   help="legacy mode: hot-entity LRU cache rows per RE "
                        "coordinate behind a single sealed scorer (default: "
                        "sharded device-resident serving)")
    p.add_argument("--scorers", type=int, default=1,
                   help="scorer replicas, one per serving device; replicas "
                        "share one routing index and round-robin drained "
                        "buckets (default 1)")
    p.add_argument("--shards", type=int, default=None,
                   help="device shards per RE table in sharded mode "
                        "(default 4)")
    p.add_argument("--device-budget-rows", type=int, default=None,
                   help="cap device-resident RE rows per coordinate; rows "
                        "beyond it serve FE-only until admitted (default: "
                        "full residency plus hot-swap headroom)")
    p.add_argument("--admit-batch", type=int, default=None,
                   help="rows per async admission step in sharded mode "
                        "(default 64); one fixed-shape table write per step")
    p.add_argument("--eviction-policy", choices=("oldest", "importance"),
                   default="oldest",
                   help="victim selection when admission needs headroom: "
                        "'oldest' evicts FIFO (default); 'importance' evicts "
                        "the lowest request-frequency x coefficient-norm "
                        "score (docs/SERVING.md)")
    p.add_argument("--batch-deadline-ms", type=float, default=None,
                   help="continuous-batching deadline: a forming bucket is "
                        "scored once its oldest request has waited this "
                        "long (default 2.0)")
    p.add_argument("--max-queue", type=int, default=None,
                   help="backpressure cap on pending requests in continuous "
                        "mode (default: 2x the largest bucket)")
    p.add_argument("--sealed", action="store_true",
                   help="drive the sealed single-thread MicroBatcher loop "
                        "instead of continuous batching (single scorer)")
    p.add_argument("--max-requests", type=int, default=None,
                   help="replay at most this many rows")
    p.add_argument("--watch-deltas", default=None,
                   help="directory of nearline delta artifacts "
                        "(update_game output); polled between request "
                        "chunks and hot-swapped into the live scorer")
    p.add_argument("--watch-chunk", type=int, default=256,
                   help="requests replayed between delta polls "
                        "(with --watch-deltas; default 256)")
    p.add_argument("--max-nnz", type=int, default=None,
                   help="padded nonzeros per shard (default: tight "
                        "power-of-two fit to the request stream)")
    p.add_argument("--metrics-output", default=None,
                   help="also write the metrics snapshot JSON to this file")
    p.add_argument("--model-id", default=None,
                   help="model id stamped on scoring events")
    p.add_argument("--event-listeners", nargs="*", default=[],
                   help="dotted class paths registered on the event emitter")
    p.add_argument("--input-columns-names", default=None,
                   help="JSON map overriding input field names")
    p.add_argument("--log-file", default=None)
    p.add_argument("--auto-tune", action="store_true",
                   help="A/B candidate serving configs on warmup replay "
                        "traffic (judged by the metrics registry), serve "
                        "with the winner, and persist it as the artifact's "
                        "tuned config")
    p.add_argument("--auto-tune-warmup", type=int, default=256,
                   help="requests replayed per auto-tune trial (default 256)")
    p.add_argument("--auto-tune-judge", default="serving.latency_p99_ms",
                   help="registry metric that judges auto-tune trials, "
                        "minimized (default serving.latency_p99_ms)")
    p.add_argument("--introspect-port", type=int, default=None,
                   help="serve /metrics, /healthz, /varz on this local port "
                        "while replaying (0 = ephemeral)")
    p.add_argument("--introspect-port-file", default=None,
                   help="write the bound introspection port to this file "
                        "(useful with --introspect-port 0)")
    p.add_argument("--introspect-hold", type=float, default=0.0,
                   help="after the replay, keep the introspection endpoints "
                        "up for this many seconds (or until "
                        "/quitquitquit is hit)")
    p.add_argument("--request-sample-rate", type=int, default=0,
                   help="request-plane lifecycle sampling: trace ~1/N "
                        "requests' per-stage timings (0 = off, the default; "
                        "1 = every request). Sampled records land in the "
                        "--telemetry-out ledger (analyze_run --requests) "
                        "and the live /requests introspection route")
    p.add_argument("--request-sample-seed", type=int, default=0,
                   help="seed for the request-plane sampler hash "
                        "(default 0); the same (id, seed) always samples "
                        "identically")
    p.add_argument("--slo-latency-ms", type=float, default=None,
                   help="enable SLO tracking with this per-request latency "
                        "threshold in ms: rolling availability + latency "
                        "objectives with error-budget burn accounting; "
                        "budget exhaustion flips /healthz degraded and the "
                        "serving.slo.* gauges")
    p.add_argument("--slo-latency-objective", type=float, default=0.99,
                   help="fraction of requests that must beat the latency "
                        "threshold (default 0.99)")
    p.add_argument("--slo-availability-objective", type=float, default=0.999,
                   help="fraction of requests that must not error "
                        "(default 0.999)")
    p.add_argument("--overload-control", action="store_true",
                   help="closed-loop overload control (needs "
                        "--slo-latency-ms): when the error-budget burn "
                        "rate crosses --overload-burn-high, batch "
                        "deadlines shrink by --overload-shrink and "
                        "requests scoreable FE-only (all RE entities "
                        "absent/non-resident) are answered on the host "
                        "without queueing; recovers below "
                        "--overload-burn-low (serving.overload.* gauges, "
                        "/varz overload doc)")
    p.add_argument("--overload-burn-high", type=float, default=1.0,
                   help="burn rate at/above which overload actuation "
                        "engages (default 1.0 = budget burning faster "
                        "than it accrues)")
    p.add_argument("--overload-burn-low", type=float, default=0.5,
                   help="burn rate at/below which overload actuation "
                        "releases (default 0.5; the gap to "
                        "--overload-burn-high is the hysteresis band)")
    p.add_argument("--overload-shrink", type=float, default=0.5,
                   help="batch-deadline multiplier while overloaded, in "
                        "(0, 1] (default 0.5)")
    p.add_argument("--tenants", default=None,
                   help="comma-separated tenant names: the replayed stream "
                        "is tagged round-robin across them and, with "
                        "--slo-latency-ms, each tenant gets an INDEPENDENT "
                        "SLO error budget (tenant-labeled serving.slo.* "
                        "series in /metrics, per-tenant burn in /healthz "
                        "and /varz)")
    p.add_argument("--variants", default=None,
                   help="comma-separated candidate variant names: serve "
                        "through the full tenancy plane (quota -> seeded "
                        "router -> one per-variant batcher over the shared "
                        "sharded scorer) instead of the plain replay path; "
                        "each variant starts undiverged from the base "
                        "(sharded mode only)")
    p.add_argument("--variant-ramp", type=float, default=None,
                   help="percent of traffic routed to EACH --variants "
                        "entry (default: an even split with the base, "
                        "100/(n+1)); ramps must sum to <= 100")
    p.add_argument("--variant-seed", type=int, default=0,
                   help="router hash seed: the same (tenant, request id, "
                        "seed) always routes identically (default 0)")
    p.add_argument("--tenant-rate", type=float, default=None,
                   help="with --tenants and --variants: per-tenant token "
                        "refill rate (requests/s) for quota admission; "
                        "over-budget tenants shed alone")
    p.add_argument("--tenant-burst", type=float, default=None,
                   help="per-tenant token bucket burst capacity (with "
                        "--tenant-rate; default: the rate)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device to serve on: 'cuda' (default) or 'cpu'")
    add_telemetry_args(p)
    return p.parse_args(argv)


def _load_or_pack(args, logger, timer, device):
    from photon_ml_tpu_torch.serving import load_artifact, pack_game_model

    if args.artifact_dir:
        with timer.time("load artifact"):
            artifact = load_artifact(args.artifact_dir)
        logger.info(
            "loaded artifact: %d coordinates, %s entities",
            len(artifact.tables),
            sum(t.n_entities for t in artifact.tables.values()),
        )
        return artifact

    from photon_ml_tpu_torch.io.model_io import (
        load_game_model,
        load_game_model_metadata,
    )

    metadata = load_game_model_metadata(args.model_dir)
    with timer.time("load model"):
        model, index_maps = load_game_model(args.model_dir, device=device)
    with timer.time("pack artifact"):
        artifact = pack_game_model(
            model,
            index_maps=index_maps,
            model_name=metadata.get("modelName", "game-model"),
            configurations=metadata.get("configurations") or {},
        )
    return artifact


def _effective_config(args, artifact, logger) -> dict:
    """Resolve the serving config the replay will actually use.

    Explicit CLI flags always win; flags left at their defaults fall back
    to the artifact's ``tuned_config`` (a previous --auto-tune winner) and
    finally to the built-in defaults — the "boots tuned" path. Returns the
    /varz-ready dict of active values."""
    tuned = dict(artifact.tuned_config or {})
    bucket_sizes = tuple(
        int(b) for b in str(args.bucket_sizes).split(",") if b.strip()
    )
    cache_capacity = args.cache_capacity
    max_nnz = args.max_nnz
    shards = args.shards
    admit_batch = args.admit_batch
    deadline_ms = args.batch_deadline_ms
    applied = {}
    if tuned:
        if args.bucket_sizes == DEFAULT_BUCKETS and "serving.bucket_sizes" in tuned:
            bucket_sizes = tuple(int(b) for b in tuned["serving.bucket_sizes"])
            applied["serving.bucket_sizes"] = list(bucket_sizes)
        if cache_capacity is None and tuned.get("serving.cache_capacity"):
            # a tuned cache capacity only matters on the legacy cached
            # path; it must not silently flip the serving mode, so it is
            # recorded but applied only when --cache-capacity selected it
            pass
        if max_nnz is None and tuned.get("serving.max_nnz"):
            max_nnz = int(tuned["serving.max_nnz"])
            applied["serving.max_nnz"] = max_nnz
        if shards is None and tuned.get("serving.shards"):
            shards = int(tuned["serving.shards"])
            applied["serving.shards"] = shards
        if admit_batch is None and tuned.get("serving.admit_batch"):
            admit_batch = int(tuned["serving.admit_batch"])
            applied["serving.admit_batch"] = admit_batch
        if deadline_ms is None and tuned.get("serving.batch_deadline_ms"):
            deadline_ms = float(tuned["serving.batch_deadline_ms"])
            applied["serving.batch_deadline_ms"] = deadline_ms
        if applied:
            logger.info("booting with tuned config: %s", applied)
    mode = "cached" if cache_capacity is not None else "sharded"
    return {
        "mode": mode,
        "bucket_sizes": list(bucket_sizes),
        "cache_capacity": cache_capacity,
        "max_nnz": max_nnz,
        "scorers": max(1, int(args.scorers)),
        "shards": int(shards) if shards else 4,
        "device_budget_rows": args.device_budget_rows,
        "admit_batch": int(admit_batch) if admit_batch else 64,
        "eviction_policy": args.eviction_policy,
        "batch_deadline_ms": (
            float(deadline_ms) if deadline_ms is not None else 2.0
        ),
        "max_queue": args.max_queue,
        "sealed": bool(args.sealed or mode == "cached"),
        "tuned": bool(applied),
        "tuned_config": tuned or None,
        "tuned_applied": applied or None,
    }


def _auto_tune_serving(args, artifact, requests, active, logger, device):
    """Warmup-replay A/B over the serve-side knob space.

    A baseline warmup replay produces the evidence (its metrics snapshot,
    replayed through ``analyze_records`` into a RunReport); the tuner
    proposes candidates; each candidate replays the same warmup slice
    against a fresh scorer and a FRESH MetricsRegistry, judged by
    ``--auto-tune-judge``. Returns (winner_knob_values, ab_result_dict)."""
    import time as _time

    from photon_ml_tpu_torch.serving import GameScorer, ServingMetrics, replay_requests
    from photon_ml_tpu_torch.serving.replay import max_nnz_of
    from photon_ml_tpu_torch.telemetry.analyze import analyze_records
    from photon_ml_tpu_torch.tuning import ab_candidates, get_knob, propose, run_ab_trials

    warmup = requests[: max(1, min(args.auto_tune_warmup, len(requests)))]
    default_nnz = max_nnz_of(requests)

    def _replay_with(config, registry):
        buckets = get_knob("serving.bucket_sizes").parse(
            config.get("serving.bucket_sizes") or active["bucket_sizes"]
        )
        nnz = int(config.get("serving.max_nnz") or 0) or (
            active["max_nnz"] or default_nnz
        )
        cache = config.get("serving.cache_capacity") or active["cache_capacity"]
        scorer = GameScorer(
            artifact,
            max_nnz=nnz,
            cache_capacity=int(cache) if cache else None,
            device=device,
        )
        metrics = ServingMetrics()
        _, snap = replay_requests(
            scorer, warmup, bucket_sizes=buckets, metrics=metrics
        )
        registry.record_serving_snapshot(snap)

    # evidence pass: the control config IS the baseline trial; wrap its
    # snapshot in a minimal ledger so the tuner sees a real RunReport
    from photon_ml_tpu_torch.telemetry.metrics import MetricsRegistry

    baseline_registry = MetricsRegistry()
    t0 = _time.time()
    _replay_with({}, baseline_registry)
    t1 = _time.time()
    report = analyze_records(
        [
            {"type": "meta", "ts": t0, "phase": "start", "label": "serve-warmup"},
            {"type": "metrics", "ts": t1, "snapshot": baseline_registry.snapshot()},
            {"type": "meta", "ts": t1, "phase": "finish"},
        ],
        source_path=None,
    )
    proposal = propose(report)
    candidates = ab_candidates(proposal, "serve")
    logger.info(
        "auto-tune: %d warmup requests, %d candidate config(s)",
        len(warmup), len(candidates),
    )
    result = run_ab_trials(
        candidates,
        _replay_with,
        judge_metric=args.auto_tune_judge,
        minimize=True,
        logger=logger,
    )
    winner = result.winner
    logger.info(
        "auto-tune winner: trial %d %s=%s config=%s",
        winner.index,
        args.auto_tune_judge,
        f"{winner.score:.6g}" if winner.score is not None else "n/a",
        winner.config,
    )
    return dict(winner.config), result.to_dict()


def _serve_tenancy(
    args, logger, active, tenants, scorers, admission, bucket_sizes,
    requests, metrics, plane,
) -> dict:
    """Replay through the full tenancy plane: per-tenant quota admission,
    seeded variant routing, and one sealed batcher per variant over the
    shared sharded scorer. Every ``--variants`` entry starts undiverged
    (bitwise the base) — this is the rollout topology; deltas diverge
    variants later via the registry. Returns the metrics snapshot with a
    ``tenancy`` status block (variants, router ramps, quota, tenant SLOs)."""
    import time as _time

    from photon_ml_tpu_torch.serving import (
        TenancyPlane,
        TenantBudget,
        TenantQuota,
        VariantRegistry,
        VariantRouter,
    )
    from photon_ml_tpu_torch.telemetry.metrics import get_registry

    registry = VariantRegistry(scorers[0])
    router = VariantRouter(seed=active["variant_seed"])
    names = active["variants"]
    ramp = (
        active["variant_ramp"]
        if active["variant_ramp"] is not None
        else 100.0 / (len(names) + 1)
    )
    for name in names:
        registry.add_variant(name)
        router.set_ramp(name, ramp)
    quota = None
    if tenants and args.tenant_rate is not None:
        burst = (
            args.tenant_burst
            if args.tenant_burst is not None
            else args.tenant_rate
        )
        quota = TenantQuota({
            t: TenantBudget(rate=args.tenant_rate, burst=burst)
            for t in tenants
        })
    tenancy = TenancyPlane(
        registry,
        router=router,
        plane=plane,
        quota=quota,
        metrics=metrics,
        bucket_sizes=tuple(bucket_sizes),
        max_wait_s=active["batch_deadline_ms"] / 1e3,
        metrics_registry=get_registry(),
    )
    logger.info(
        "tenancy plane: base + %d variant(s) at %.1f%% each%s",
        len(names), ramp, ", per-tenant quota" if quota is not None else "",
    )
    started_admission = False
    if admission is not None and admission._thread is None:
        admission.start()
        started_admission = True
    try:
        t0 = _time.perf_counter()
        results = tenancy.replay(requests, poll_every=64)
        wall = _time.perf_counter() - t0
    finally:
        if started_admission:
            admission.stop()
    lead = scorers[0]
    residency = None
    if hasattr(lead, "residency_stats"):
        residency = lead.residency_stats() or None
    snapshot = metrics.snapshot(
        cache_stats=lead.cache_stats() or None,
        compile_count=lead.compile_count,
        residency=residency,
        admission=admission.stats() if admission is not None else None,
    )
    snapshot["replay_wall_seconds"] = round(wall, 6)
    if wall > 0:
        snapshot["replay_requests_per_s"] = round(len(requests) / wall, 3)
    snapshot["num_results"] = len(results)
    if plane is not None:
        report = plane.live_report()
        slo_doc = report.pop("slo", None)
        snapshot["request_plane"] = report
        if slo_doc is not None:
            snapshot["slo"] = slo_doc
    snapshot["tenancy"] = tenancy.status()
    return snapshot


def run(args: argparse.Namespace) -> Optional[dict]:
    from photon_ml_tpu_torch.event import EventEmitter

    device = resolve_device(args.device)
    logger = setup_logger(args.log_file)
    timer = Timer()
    emitter = EventEmitter()
    for name in args.event_listeners:
        emitter.register_listener_class(name)
    telemetry = start_telemetry(args, "serve_game", emitter=emitter)
    try:
        return _run_serving(args, logger, timer, emitter, device, telemetry)
    finally:
        # listeners must flush/close even when the run fails; telemetry
        # finishes after them so every bridged event is in the ledger
        emitter.clear_listeners()
        finish_telemetry(telemetry, phases=dict(timer.durations))


def _run_serving(args, logger, timer, emitter, device, telemetry=None) -> Optional[dict]:
    artifact = _load_or_pack(args, logger, timer, device)
    model_id = args.model_id or artifact.model_name
    active = _effective_config(args, artifact, logger)
    active["model_id"] = model_id
    bucket_sizes = tuple(active["bucket_sizes"])

    # request plane + SLO tracker (both off unless asked for)
    slo = None
    plane = None
    if args.slo_latency_ms is not None:
        from photon_ml_tpu_torch.serving import SLOTracker
        from photon_ml_tpu_torch.telemetry.metrics import get_registry

        slo = SLOTracker(
            latency_threshold_s=args.slo_latency_ms / 1e3,
            latency_objective=args.slo_latency_objective,
            availability_objective=args.slo_availability_objective,
            registry=get_registry(),
        )
    overload = None
    if args.overload_control:
        if slo is None:
            raise SystemExit(
                "--overload-control needs --slo-latency-ms: the controller "
                "actuates on the SLO burn rate"
            )
        from photon_ml_tpu_torch.serving import OverloadController
        from photon_ml_tpu_torch.telemetry.metrics import get_registry

        overload = OverloadController(
            slo,
            shrink_factor=args.overload_shrink,
            burn_high=args.overload_burn_high,
            burn_low=args.overload_burn_low,
            registry=get_registry(),
        )
        logger.info(
            "overload control on: burn >= %.2f shrinks deadlines x%.2f and "
            "sheds FE-only-able load; recovers at burn <= %.2f",
            args.overload_burn_high, args.overload_shrink,
            args.overload_burn_low,
        )
    tenants = [
        t.strip() for t in (args.tenants or "").split(",") if t.strip()
    ]
    tenant_slos = None
    if tenants:
        if args.slo_latency_ms is not None:
            from photon_ml_tpu_torch.serving import build_tenant_slos
            from photon_ml_tpu_torch.telemetry.metrics import get_registry

            tenant_slos = build_tenant_slos(
                tenants,
                registry=get_registry(),
                latency_threshold_s=args.slo_latency_ms / 1e3,
                latency_objective=args.slo_latency_objective,
                availability_objective=args.slo_availability_objective,
            )
            logger.info(
                "per-tenant SLO budgets for %s", ", ".join(tenants)
            )
        else:
            logger.warning(
                "--tenants without --slo-latency-ms: requests are tagged "
                "but no per-tenant SLO budgets are tracked"
            )
    if (
        args.request_sample_rate > 0
        or slo is not None
        or tenant_slos is not None
    ):
        from photon_ml_tpu_torch.serving import RequestPlane

        plane = RequestPlane(
            sample_rate=max(0, args.request_sample_rate),
            seed=args.request_sample_seed,
            ledger=telemetry.ledger if telemetry is not None else None,
            slo=slo,
            tenant_slos=tenant_slos,
        )
        logger.info(
            "request plane: sampling ~1/%d requests (seed %d)%s",
            max(1, args.request_sample_rate), args.request_sample_seed,
            ", SLO tracking on" if slo is not None else "",
        )
    active["request_sample_rate"] = args.request_sample_rate
    active["slo_latency_ms"] = args.slo_latency_ms
    active["overload_control"] = overload is not None
    active["tenants"] = tenants or None

    variants = [
        v.strip() for v in (args.variants or "").split(",") if v.strip()
    ]
    if variants:
        if active["mode"] == "cached":
            raise SystemExit(
                "--variants needs variant views over the sharded scorer; "
                "drop --cache-capacity"
            )
        if args.watch_deltas or args.auto_tune:
            raise SystemExit(
                "--variants replaces the plain replay path; it is not "
                "combinable with --watch-deltas or --auto-tune (apply "
                "per-variant deltas through the variant registry instead)"
            )
    active["variants"] = variants or None
    active["variant_ramp"] = args.variant_ramp
    active["variant_seed"] = args.variant_seed

    if args.export_artifact_dir:
        from photon_ml_tpu_torch.serving import save_artifact

        with timer.time("export artifact"):
            save_artifact(artifact, args.export_artifact_dir)
        logger.info("exported serving artifact to %s", args.export_artifact_dir)

    state = {"manager": None, "admission": None, "phase": "starting"}
    introspect = None
    if args.introspect_port is not None:
        from photon_ml_tpu_torch.serving import IntrospectionServer

        def _health():
            manager = state["manager"]
            doc = {
                "healthy": True,
                "phase": state["phase"],
                "model_id": model_id,
                "watching_deltas": bool(args.watch_deltas),
            }
            if manager is not None:
                doc["swap_generation"] = manager.generation
            # degraded modes: a dead supervised daemon (admission past its
            # restart cap) flips /healthz to 503 with the reason, while
            # serving itself keeps answering (cold entities score FE-only)
            degraded = []
            admission = state["admission"]
            if admission is not None:
                adm = admission.health()
                doc["admission"] = adm
                if not adm.get("healthy", True):
                    degraded.append(adm.get("degraded", "admission dead"))
            # an exhausted error budget degrades health (still serving,
            # but the SLO says users are feeling it)
            if slo is not None:
                sh = slo.health()
                doc["slo"] = sh
                if not sh.get("healthy", True):
                    degraded.append(sh.get("degraded", "slo budget exhausted"))
            # per-tenant burn: ONE tenant's exhausted budget degrades
            # health with the tenant named, while the others stay readable
            if tenant_slos:
                tdoc = {}
                for t, tracker in sorted(tenant_slos.items()):
                    th = tracker.health()
                    tdoc[t] = th
                    if not th.get("healthy", True):
                        degraded.append(
                            f"tenant {t}: "
                            + th.get("degraded", "slo budget exhausted")
                        )
                doc["tenant_slo"] = tdoc
            if degraded:
                doc["healthy"] = False
                doc["degraded"] = "; ".join(degraded)
            return doc

        def _varz():
            doc = dict(active)
            if slo is not None:
                doc["slo"] = slo.status()
            if overload is not None:
                doc["overload"] = overload.status()
            if tenant_slos:
                doc["tenant_slo"] = {
                    t: tracker.status()
                    for t, tracker in sorted(tenant_slos.items())
                }
            return doc

        extra = {}
        if plane is not None:
            extra["/requests"] = plane.live_report
        introspect = IntrospectionServer(
            varz=_varz,
            health=_health,
            port=args.introspect_port,
            extra_json=extra or None,
        ).start()
        logger.info("introspection endpoints on 127.0.0.1:%d", introspect.port)
        if args.introspect_port_file:
            with open(args.introspect_port_file, "w") as f:
                f.write(str(introspect.port))
    try:
        snapshot = _serve_stream(
            args, logger, timer, emitter, artifact, model_id, active,
            bucket_sizes, state, device, plane, overload,
        )
        state["phase"] = "drained"
        if introspect is not None and args.introspect_hold > 0:
            logger.info(
                "holding introspection endpoints for %.1fs (POST "
                "/quitquitquit to release)", args.introspect_hold,
            )
            introspect.wait_quit(args.introspect_hold)
        return snapshot
    finally:
        if introspect is not None:
            introspect.stop()


def _serve_stream(
    args, logger, timer, emitter, artifact, model_id, active, bucket_sizes,
    state, device, plane=None, overload=None,
) -> Optional[dict]:
    snapshot: Optional[dict] = None
    if args.data_dirs:
        from photon_ml_tpu_torch.io.data_reader import (
            FeatureShardConfiguration,
            read_game_data,
        )
        from photon_ml_tpu_torch.serving import GameScorer, replay_requests
        from photon_ml_tpu_torch.serving.replay import (
            max_nnz_of,
            requests_from_game_data,
        )

        shard_bags = {}
        for sid, s in (
            (artifact.configurations.get("feature_shards") or {}).items()
        ):
            shard_bags[sid] = FeatureShardConfiguration(
                feature_bags=s["feature_bags"],
                add_intercept=bool(s.get("add_intercept", True)),
            )
        for sid in artifact.shard_dims():
            shard_bags.setdefault(
                sid, FeatureShardConfiguration(feature_bags=[sid])
            )
        index_maps = dict(artifact.feature_index) or None
        if index_maps is None:
            logger.warning(
                "artifact carries no feature index maps; indexes will be "
                "rebuilt from the request data and may not match the model"
            )
        col_names = parse_input_columns(args.input_columns_names)
        with timer.time("read data"):
            data, _, uids = read_game_data(
                args.data_dirs,
                {
                    sid: cfg for sid, cfg in shard_bags.items()
                    if sid in artifact.shard_dims()
                },
                index_maps,
                id_tags=artifact.random_effect_types(),
                is_response_required=False,
                **col_names,
            )
        with timer.time("build requests"):
            requests = requests_from_game_data(
                data, artifact, uids=uids, max_requests=args.max_requests
            )
        tenants = active.get("tenants") or []
        if tenants:
            from photon_ml_tpu_torch.serving.tenancy import tag_request

            requests = [
                tag_request(r, tenants[i % len(tenants)])
                for i, r in enumerate(requests)
            ]
            logger.info(
                "tagged requests round-robin across %d tenant(s): %s",
                len(tenants), ", ".join(tenants),
            )
        logger.info("replaying %d requests", len(requests))

        ab_result = None
        if args.auto_tune:
            state["phase"] = "auto-tune"
            with timer.time("auto-tune"):
                winner, ab_result = _auto_tune_serving(
                    args, artifact, requests, active, logger, device
                )
            tuned_now = {k: v for k, v in winner.items() if v}
            if "serving.bucket_sizes" in winner:
                bucket_sizes = tuple(int(b) for b in winner["serving.bucket_sizes"])
                active["bucket_sizes"] = list(bucket_sizes)
            if active["mode"] == "cached" and winner.get("serving.cache_capacity"):
                active["cache_capacity"] = int(winner["serving.cache_capacity"])
            if winner.get("serving.max_nnz"):
                active["max_nnz"] = int(winner["serving.max_nnz"])
            if winner.get("serving.shards"):
                active["shards"] = int(winner["serving.shards"])
            if winner.get("serving.admit_batch"):
                active["admit_batch"] = int(winner["serving.admit_batch"])
            if winner.get("serving.batch_deadline_ms"):
                active["batch_deadline_ms"] = float(
                    winner["serving.batch_deadline_ms"]
                )
            active["tuned"] = True
            active["tuned_config"] = {
                k: (list(v) if isinstance(v, tuple) else v)
                for k, v in tuned_now.items()
            }
            from photon_ml_tpu_torch.serving import save_tuned_config

            provenance = {
                "source": "serve_game --auto-tune",
                "judge_metric": args.auto_tune_judge,
                "warmup_requests": int(args.auto_tune_warmup),
            }
            for target in (args.artifact_dir, args.export_artifact_dir):
                if target:
                    path = save_tuned_config(
                        target, active["tuned_config"], provenance=provenance
                    )
                    logger.info("persisted tuned config to %s", path)

        state["phase"] = "replaying"
        nnz = active["max_nnz"] if active["max_nnz"] else max_nnz_of(requests)
        admission = None
        if active["mode"] == "cached":
            scorers = [GameScorer(
                artifact,
                max_nnz=nnz,
                cache_capacity=active["cache_capacity"],
                growth_headroom=bool(args.watch_deltas),
                device=device,
            )]
        else:
            from photon_ml_tpu_torch.serving import (
                AdmissionController,
                ShardedGameScorer,
                serving_mesh,
            )

            # replicas go round the serving mesh's devices: on one card
            # each replica holds its own copy of the tables there
            mesh_devices = list(serving_mesh(device=device).devices.flat)
            routing = None
            scorers = []
            for i in range(active["scorers"]):
                s = ShardedGameScorer(
                    artifact,
                    max_nnz=nnz,
                    num_shards=active["shards"],
                    device_budget_rows=active["device_budget_rows"],
                    eviction_policy=active["eviction_policy"],
                    routing=routing,
                    device=mesh_devices[i % len(mesh_devices)],
                )
                routing = s.routing
                scorers.append(s)
            admission = AdmissionController(
                scorers, admit_batch=active["admit_batch"]
            )
            for s in scorers:
                s.attach_admission(admission)
            # run the fixed-shape admission write once before traffic
            admission.warmup()
            state["admission"] = admission
        continuous = not active["sealed"]
        if active["sealed"] and len(scorers) > 1:
            logger.warning(
                "--sealed drives a single scorer; ignoring %d extra "
                "replica(s)", len(scorers) - 1,
            )
            scorers = scorers[:1]
        from photon_ml_tpu_torch.serving import ServingMetrics

        metrics = ServingMetrics()
        manager = None
        if active.get("variants"):
            if len(scorers) > 1:
                logger.warning(
                    "--variants serves through ONE shared scorer; ignoring "
                    "%d extra replica(s)", len(scorers) - 1,
                )
                scorers = scorers[:1]
            active["mode"] = "sharded-tenancy"
            if overload is not None:
                logger.warning(
                    "--overload-control drives the plain replay batcher; "
                    "it is ignored on the tenancy path"
                )
            with timer.time("replay"):
                snapshot = _serve_tenancy(
                    args, logger, active, tenants, scorers, admission,
                    bucket_sizes, requests, metrics, plane,
                )
        else:
            if args.watch_deltas:
                from photon_ml_tpu_torch.incremental import fingerprint_dir
                from photon_ml_tpu_torch.serving import (
                    CoordinatedHotSwap,
                    HotSwapManager,
                )

                fingerprint = (
                    fingerprint_dir(args.artifact_dir)
                    if args.artifact_dir else None
                )
                managers = [
                    HotSwapManager(
                        s,
                        fingerprint=fingerprint,
                        # only the lead manager records swap metrics/events;
                        # replica swaps are the same delta fanned out
                        metrics=metrics if i == 0 else None,
                        emitter=emitter if i == 0 else None,
                        model_id=model_id,
                    )
                    for i, s in enumerate(scorers)
                ]
                manager = (
                    managers[0] if len(managers) == 1
                    else CoordinatedHotSwap(managers)
                )
                state["manager"] = manager
                logger.info(
                    "watching %s for delta artifacts (poll every %d "
                    "requests)", args.watch_deltas, args.watch_chunk,
                )
            with timer.time("replay"):
                results, snapshot = replay_requests(
                    scorers if continuous else scorers[0], requests,
                    bucket_sizes=bucket_sizes,
                    metrics=metrics,
                    emitter=emitter,
                    model_id=model_id,
                    swap_manager=manager,
                    watch_dir=args.watch_deltas,
                    poll_every=args.watch_chunk,
                    continuous=continuous,
                    max_wait_s=active["batch_deadline_ms"] / 1e3,
                    max_queue=active["max_queue"],
                    admission=admission,
                    plane=plane,
                    overload=overload,
                )
            if manager is not None:
                logger.info(
                    "served through generation %d (%d swap(s))",
                    manager.generation,
                    len(snapshot.get("swap_reports", [])),
                )

        snapshot["model_id"] = model_id
        snapshot["bucket_sizes"] = list(bucket_sizes)
        snapshot["serving_mode"] = active["mode"]
        snapshot["num_scorers"] = len(scorers)
        if ab_result is not None:
            snapshot["auto_tune"] = ab_result
        # fold the final serving snapshot into the process registry so the
        # /metrics endpoint reflects the replay even without --telemetry-out
        from photon_ml_tpu_torch.telemetry.metrics import get_registry

        get_registry().record_serving_snapshot(snapshot)
        if args.metrics_output:
            with open(args.metrics_output, "w") as f:
                json.dump(snapshot, f, indent=2)
        print(json.dumps(snapshot))

    for name, seconds in timer.durations.items():
        logger.info("timing %-20s %.3fs", name, seconds)
    return snapshot


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if not args.data_dirs and not args.export_artifact_dir:
        print(
            "nothing to do: pass --data-dirs to serve and/or "
            "--export-artifact-dir to export",
            file=sys.stderr,
        )
        return 2
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
