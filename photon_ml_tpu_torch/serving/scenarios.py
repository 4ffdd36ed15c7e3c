"""Seeded traffic-shape scenarios for the serving replay harness.

Steady-state replay (``bench.py --serving``) regression-gates one traffic
shape. Production regressions live in the others: a diurnal ramp that
outruns admission, a burst storm that fills the backpressure queue, a
cold-entity flood that craters device residency, a hot-swap landing under
load. Each scenario here is a deterministic (seeded) reshaping of a base
request stream into phases driven through
:func:`~photon_ml_tpu_torch.serving.replay.replay_requests`, with the request
plane sampling lifecycles and the SLO tracker keeping the verdict — so
``bench.py --scenarios`` emits one per-stage p50/p99 breakdown, residency
rate, and SLO verdict per traffic shape into ``BENCH_SCENARIOS.json``,
and the CI scenario sentinel gates them all.

Scenario catalog (``SCENARIO_NAMES``):

``steady``
    The base stream in even phases — the control arm; matches the
    ``--serving`` bench's shape.
``diurnal``
    A one-day load curve compressed into the replay: sinusoidal phase
    sizes (peak ~3x trough) with idle gaps before the troughs, so the
    batcher's deadline path and the admission tier see both regimes.
``burst_storm``
    Quiet trickle phases alternating with full-queue bursts — the shape
    that exposes backpressure and queue-wait tails.
``cold_entity_flood``
    A steady warmup, then phases whose entity ids are remapped (seeded)
    to the least-popular tail — device residency collapses and the
    admission tier has to re-admit under traffic.
``hot_swap_under_load``
    The steady shape with concurrent hot-swap row updates during the
    middle phases (a swapper thread contends with scoring through the
    write locks) — the arm that proves swap pauses land in the p99
    breakdown as ``swap_pause`` interference, not as unexplained time.

Tenancy scenarios (``TENANCY_SCENARIOS``, run through a
:class:`~photon_ml_tpu_torch.serving.tenancy.TenancyPlane` instead of plain
replay; their requests are tenant-tagged and their result docs carry
per-tenant SLO verdicts):

``tenant_isolation``
    Round-robin multi-tenant traffic, with the FIRST tenant flooding at
    several times its contracted rate during the middle phases. The
    quota must shed the flood onto the flooder's own error budget while
    every other tenant's p99 and budget hold — the noisy-neighbour gate.
``ramped_rollout``
    Steady multi-tenant traffic while a candidate variant's ramp walks
    1% -> 50% -> 100% across phases, hot, without draining the server;
    variant routing stays sticky per request id as the boundary moves.
``nearline_loop``
    The end-to-end loop: a nearline trainer emits fingerprint-chained
    per-variant deltas (save -> discover -> chain-check -> apply) while
    the scorer hot-swaps them per variant under replayed multi-tenant
    traffic.

Port of ``photon_ml_tpu/serving/scenarios.py``: the same seeded phase
layouts, entity remaps and tenant tags, driven through the port's
``replay_requests`` and tenancy plane.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.serving.replay import replay_requests
from photon_ml_tpu_torch.serving.scorer import ScoreRequest

SCENARIO_NAMES = (
    "steady",
    "diurnal",
    "burst_storm",
    "cold_entity_flood",
    "hot_swap_under_load",
    "tenant_isolation",
    "ramped_rollout",
    "nearline_loop",
)

# the scenarios that need a TenancyPlane (multi-tenant, variant-routed)
TENANCY_SCENARIOS = (
    "tenant_isolation",
    "ramped_rollout",
    "nearline_loop",
)

DEFAULT_TENANTS = ("alpha", "beta", "gamma")

# how much harder the flooding tenant pushes than its round-robin share
# in ``tenant_isolation``
FLOOD_FACTOR = 3

# stable per-scenario seed offsets: the same (seed, name) always produces
# the same phase layout and entity remapping
_NAME_SEEDS = {name: 1000 + i for i, name in enumerate(SCENARIO_NAMES)}


@dataclasses.dataclass
class ScenarioPhase:
    """One replay leg: a request slice, an optional idle gap before it,
    and whether hot-swap updates run concurrently with it. Tenancy
    phases may additionally move a variant ramp before replaying
    (``ramp_percent``) or run the nearline emit->swap loop concurrently
    (``nearline``)."""

    requests: List[ScoreRequest]
    pause_before_s: float = 0.0
    swap: bool = False
    ramp_percent: Optional[float] = None
    nearline: bool = False


@dataclasses.dataclass
class Scenario:
    name: str
    seed: int
    phases: List[ScenarioPhase]
    description: str = ""
    # tenancy scenarios: the tenants the stream is tagged with, and the
    # variant whose ramp the phases' ``ramp_percent`` steps drive
    tenants: tuple = ()
    ramp_variant: Optional[str] = None

    @property
    def num_requests(self) -> int:
        return sum(len(p.requests) for p in self.phases)


def _cold_remap(
    requests: Sequence[ScoreRequest], rng: np.random.Generator
) -> List[ScoreRequest]:
    """Rewrite entity ids to the least-popular half of the observed id
    population (per RE type) — a flood of entities that are known to the
    model but unlikely to be device-resident."""
    freq: Dict[str, Counter] = {}
    for req in requests:
        for re_type, eid in req.entity_ids.items():
            freq.setdefault(re_type, Counter())[eid] += 1
    tails: Dict[str, List[str]] = {}
    for re_type, counts in freq.items():
        ranked = [e for e, _ in counts.most_common()]
        tail = ranked[len(ranked) // 2:]
        tails[re_type] = tail if tail else ranked
    out: List[ScoreRequest] = []
    for req in requests:
        remapped = {
            re_type: tails[re_type][int(rng.integers(len(tails[re_type])))]
            for re_type in req.entity_ids
        }
        out.append(
            ScoreRequest(
                request_id=f"{req.request_id}-cold",
                features=req.features,
                entity_ids=remapped,
                offset=req.offset,
            )
        )
    return out


def _tag(request: ScoreRequest, tenant: str) -> ScoreRequest:
    """Tenant-tag one request (see ``requestplane.TENANT_SEP``)."""
    from photon_ml_tpu_torch.serving.requestplane import TENANT_SEP

    return dataclasses.replace(
        request, request_id=f"{tenant}{TENANT_SEP}{request.request_id}"
    )


# ramp walk for ``ramped_rollout``: interpolated onto num_phases, always
# starting dark and ending fully ramped
_RAMP_STEPS = (0.0, 1.0, 5.0, 10.0, 25.0, 50.0, 75.0, 100.0)


def build_scenario(
    name: str,
    requests: Sequence[ScoreRequest],
    seed: int = 0,
    num_phases: int = 8,
    pause_s: float = 0.01,
    tenants: Sequence[str] = DEFAULT_TENANTS,
    ramp_variant: str = "candidate",
) -> Scenario:
    """Deterministically reshape ``requests`` into the named scenario.

    ``pause_s`` scales the idle gaps (diurnal troughs, storm quiets);
    smoke/CI callers shrink it, the committed bench uses the default.
    ``tenants``/``ramp_variant`` apply only to the tenancy scenarios:
    the stream is tagged round-robin across ``tenants``, and the
    ``ramped_rollout`` phases drive ``ramp_variant``'s ramp.
    """
    if name not in SCENARIO_NAMES:
        raise ValueError(
            f"unknown scenario {name!r} (expected one of {SCENARIO_NAMES})"
        )
    requests = list(requests)
    n = len(requests)
    if n == 0:
        raise ValueError("scenario needs a non-empty request stream")
    num_phases = max(2, int(num_phases))
    rng = np.random.default_rng(int(seed) + _NAME_SEEDS[name])
    if name in TENANCY_SCENARIOS:
        tenants = tuple(tenants)
        if len(tenants) < 2:
            raise ValueError(
                f"tenancy scenario {name!r} needs >= 2 tenants, got {tenants}"
            )
        requests = [
            _tag(req, tenants[i % len(tenants)])
            for i, req in enumerate(requests)
        ]
    even = [
        requests[(k * n) // num_phases : ((k + 1) * n) // num_phases]
        for k in range(num_phases)
    ]

    if name == "steady":
        phases = [ScenarioPhase(chunk) for chunk in even if chunk]
        desc = "even phases, no idle gaps (control arm)"
    elif name == "diurnal":
        # sinusoidal weights, peak ~3x trough; idle gaps ahead of troughs
        w = np.array(
            [
                1.0 + 0.5 * math.sin(2.0 * math.pi * k / num_phases)
                for k in range(num_phases)
            ]
        )
        bounds = np.floor(np.cumsum(w) / w.sum() * n).astype(int)
        lo = 0
        phases = []
        w_min, w_max = float(w.min()), float(w.max())
        for k, hi in enumerate(bounds):
            chunk = requests[lo:int(hi)]
            lo = int(hi)
            if not chunk:
                continue
            # trough phases idle first: low weight -> long gap
            frac = (w_max - float(w[k])) / max(w_max - w_min, 1e-9)
            phases.append(ScenarioPhase(chunk, pause_before_s=pause_s * frac))
        desc = "sinusoidal load curve, peak ~3x trough, idle troughs"
    elif name == "burst_storm":
        # odd phases are trickles, even phases dump a double share at once
        phases = []
        for k, chunk in enumerate(even):
            if not chunk:
                continue
            if k % 2 == 0:
                phases.append(ScenarioPhase(chunk, pause_before_s=pause_s))
            else:
                keep = chunk[: max(1, len(chunk) // 8)]
                spill = chunk[len(keep):]
                phases.append(ScenarioPhase(keep))
                if spill:
                    if k + 1 < num_phases:
                        # the spilled share rides the NEXT storm
                        even[k + 1] = spill + even[k + 1]
                    else:
                        # trailing trickle: its spill lands as a closing
                        # burst so the stream is preserved exactly
                        phases.append(
                            ScenarioPhase(spill, pause_before_s=pause_s)
                        )
        desc = "idle gaps then full-queue bursts (backpressure shape)"
    elif name == "cold_entity_flood":
        warm = num_phases // 2
        phases = [ScenarioPhase(chunk) for chunk in even[:warm] if chunk]
        for chunk in even[warm:]:
            if chunk:
                phases.append(ScenarioPhase(_cold_remap(chunk, rng)))
        desc = "steady warmup, then entity ids remapped to the cold tail"
    elif name == "hot_swap_under_load":
        phases = []
        for k, chunk in enumerate(even):
            if not chunk:
                continue
            swap = 0 < k < num_phases - 1  # swaps land mid-run, under load
            phases.append(ScenarioPhase(chunk, swap=swap))
        desc = "steady load with concurrent hot-swap row updates mid-run"
    elif name == "tenant_isolation":
        flooder = tenants[0]
        phases = []
        for k, chunk in enumerate(even):
            if not chunk:
                continue
            if num_phases // 3 <= k < (2 * num_phases) // 3:
                # the flooder replays its share FLOOD_FACTOR extra times
                # on top of everyone's normal traffic, same instant
                flood = [
                    _tag(
                        dataclasses.replace(
                            req, request_id=f"{req.request_id}-f{j}"
                        ),
                        flooder,
                    )
                    for j in range(FLOOD_FACTOR)
                    for req in chunk
                ]
                chunk = chunk + flood
            phases.append(ScenarioPhase(chunk))
        desc = (
            f"tenant {flooder!r} floods {FLOOD_FACTOR + 1}x mid-run; other "
            "tenants' latency and error budgets must hold"
        )
    elif name == "ramped_rollout":
        steps = np.interp(
            np.linspace(0.0, 1.0, num_phases),
            np.linspace(0.0, 1.0, len(_RAMP_STEPS)),
            _RAMP_STEPS,
        )
        phases = []
        for k, chunk in enumerate(even):
            if not chunk:
                continue
            phases.append(
                ScenarioPhase(chunk, ramp_percent=float(steps[k]))
            )
        desc = (
            f"variant {ramp_variant!r} ramps "
            f"{'->'.join(f'{s:g}%' for s in _RAMP_STEPS)} under steady "
            "multi-tenant load"
        )
    else:  # nearline_loop
        phases = []
        for k, chunk in enumerate(even):
            if not chunk:
                continue
            nearline = 0 < k < num_phases - 1  # deltas land mid-run
            phases.append(ScenarioPhase(chunk, nearline=nearline))
        desc = (
            "nearline trainer emits chained per-variant deltas; the "
            "scorer discovers and hot-swaps them under replayed traffic"
        )
    return Scenario(
        name=name,
        seed=int(seed),
        phases=phases,
        description=desc,
        tenants=tuple(tenants) if name in TENANCY_SCENARIOS else (),
        ramp_variant=ramp_variant if name in TENANCY_SCENARIOS else None,
    )


def make_row_swap_fn(
    scorers,
    metrics,
    rows_per_swap: int = 32,
    scale: float = 0.01,
    seed: int = 0,
) -> Optional[Callable[[], None]]:
    """A hot-swap loop body for ``hot_swap_under_load``: each call rewrites
    ``rows_per_swap`` random rows of one RE coordinate in place through
    the lead scorer's ``update_random_effect_rows`` (fanning out to every
    replica) and reports the measured pause via ``metrics.observe_swap``
    — the real write-lock contention path, generation bumps included.
    Returns None when the scorer exposes no updatable RE coordinate."""
    scorers = list(scorers) if isinstance(scorers, (list, tuple)) else [scorers]
    lead = scorers[0]
    artifact = getattr(lead, "artifact", None)
    if artifact is None:
        return None
    re_cids = [
        cid for cid, t in sorted(artifact.tables.items()) if t.is_random_effect
    ]
    if not re_cids:
        return None
    rng = np.random.default_rng(seed + 77)
    state = {"generation": getattr(metrics, "current_generation", 0)}

    def _swap() -> None:
        cid = re_cids[int(rng.integers(len(re_cids)))]
        table = artifact.tables[cid]
        n_rows, dim = table.weights.shape
        k = min(rows_per_swap, n_rows)
        rows = rng.choice(n_rows, size=k, replace=False)
        values = (
            np.asarray(table.weights[rows], dtype=np.float32)
            + rng.standard_normal((k, dim)).astype(np.float32) * scale
        )
        t0 = time.perf_counter()
        ret = lead.update_random_effect_rows(cid, rows, values)
        # sharded scorers stage into the spare generation half and return
        # the request-path blocking seconds (the flip window) — that is
        # the pause scoring threads actually saw; a None return (the
        # single-table scorer mutates live tables) keeps wall clock
        pause = ret if isinstance(ret, float) else time.perf_counter() - t0
        state["generation"] += 1
        if metrics is not None:
            metrics.observe_swap(
                generation=state["generation"], rows_updated=k,
                blackout_s=pause,
            )

    return _swap


def run_scenario(
    scenario: Scenario,
    scorers,
    bucket_sizes: Sequence[int],
    metrics,
    plane=None,
    slo=None,
    admission=None,
    continuous: bool = True,
    max_wait_s: float = 0.002,
    max_queue: Optional[int] = None,
    swap_fn: Optional[Callable[[], None]] = None,
    swap_interval_s: float = 0.01,
    tenancy=None,
    nearline_fn: Optional[Callable[[], object]] = None,
    nearline_interval_s: float = 0.02,
    overload=None,
) -> dict:
    """Drive one scenario through ``replay_requests`` phase by phase and
    return its result document: per-stage p50/p99 breakdown (from the
    request plane), residency rate, throughput, and the SLO verdict.

    The caller owns the metrics/plane/slo objects (fresh per scenario for
    isolated verdicts) and the scorers/admission (shared across scenarios
    for realistic warm state, or fresh for isolation).

    Tenancy scenarios additionally take ``tenancy`` (a
    :class:`~photon_ml_tpu_torch.serving.tenancy.TenancyPlane`; phases then
    replay through it — quota, router, per-variant batchers — instead of
    plain replay) and, for ``nearline_loop``, ``nearline_fn`` (one
    nearline trainer tick: emit + swap one delta generation per variant),
    which runs concurrently with every ``nearline`` phase the way
    ``swap_fn`` does for hot-swap phases. The result doc then carries
    per-tenant requests/sheds/SLO verdicts, observed variant shares, and
    the nearline swap ledger.

    ``overload`` (an
    :class:`~photon_ml_tpu_torch.serving.overload.OverloadController`) closes
    the SLO-burn loop on the non-tenancy path: ``replay_requests``
    attaches it to the batcher it builds, and the doc carries its final
    ``status()``."""
    if tenancy is None and scenario.tenants:
        raise ValueError(
            f"scenario {scenario.name!r} declares tenants "
            f"{scenario.tenants} and needs a TenancyPlane (tenancy=...)"
        )
    results = []
    nearline_reports: List[object] = []
    t0 = time.perf_counter()
    for phase in scenario.phases:
        if phase.pause_before_s > 0:
            time.sleep(phase.pause_before_s)
        if phase.ramp_percent is not None and tenancy is not None:
            # hot ramp move: no drain, no pause — the router boundary
            # shifts and the very next routed request sees it
            tenancy.router.set_ramp(
                scenario.ramp_variant, phase.ramp_percent
            )
        stop_swapper = None
        swapper = None
        background = swap_fn if phase.swap else None
        interval = swap_interval_s
        if phase.nearline and nearline_fn is not None:

            def _nearline_tick():
                nearline_reports.extend(nearline_fn() or ())

            background = _nearline_tick
            interval = nearline_interval_s
        if background is not None:
            stop_swapper = threading.Event()

            def _swap_loop(evt=stop_swapper, fn=background, wait=interval):
                while not evt.is_set():
                    fn()
                    evt.wait(wait)

            swapper = threading.Thread(
                target=_swap_loop, name="scenario-swapper", daemon=True
            )
            swapper.start()
        try:
            if tenancy is not None:
                res = tenancy.replay(phase.requests)
                snapshot = None
            else:
                res, snapshot = replay_requests(
                    scorers,
                    phase.requests,
                    bucket_sizes=bucket_sizes,
                    metrics=metrics,
                    model_id=f"scenario-{scenario.name}",
                    continuous=continuous,
                    max_wait_s=max_wait_s,
                    max_queue=max_queue,
                    admission=admission,
                    plane=plane,
                    overload=overload,
                )
            results.extend(res)
        finally:
            if stop_swapper is not None:
                stop_swapper.set()
                swapper.join()
    wall = time.perf_counter() - t0
    if tenancy is not None:
        # the tenancy path batches in-process; build the same snapshot
        # replay_requests would have, from the shared metrics object
        lead = tenancy.registry.lead
        snapshot = metrics.snapshot(
            cache_stats=lead.cache_stats(),
            compile_count=lead.compile_count,
            residency=(
                lead.residency_stats()
                if hasattr(lead, "residency_stats")
                else None
            ),
        )

    doc: dict = {
        "name": scenario.name,
        "description": scenario.description,
        "seed": scenario.seed,
        "num_phases": len(scenario.phases),
        "num_requests": len(results),
        "wall_seconds": round(wall, 6),
        "requests_per_s": round(len(results) / wall, 3) if wall > 0 else 0.0,
    }
    for key in (
        "latency_p50_s", "latency_p99_s", "batch_fill_ratio",
        "device_resident_rate", "deferred_rate",
    ):
        if key in snapshot:
            doc[key] = snapshot[key]
    if "swaps" in snapshot:
        doc["swaps"] = snapshot["swaps"]
    if plane is not None:
        report = plane.live_report()
        report.pop("slo", None)
        doc["request_plane"] = report
    tracker = slo if slo is not None else getattr(plane, "_slo", None)
    if tracker is not None:
        status = tracker.status()
        doc["slo"] = status
        doc["slo_verdict"] = status["verdict"]
    if overload is not None:
        doc["overload"] = overload.status()
    if tenancy is not None:
        doc["tenants"] = {}
        flooder = scenario.tenants[0] if scenario.tenants else None
        for tenant, tslo in sorted(tenancy.plane.tenant_slos.items()):
            status = tslo.status()
            doc["tenants"][tenant] = {
                "requests": tenancy.plane.tenant_requests.get(tenant, 0),
                "errors": tenancy.plane.tenant_errors.get(tenant, 0),
                "slo": status,
                "slo_verdict": status["verdict"],
            }
        if tenancy.quota is not None:
            qstats = tenancy.quota.stats()["tenants"]
            doc["tenant_shed"] = {
                t: s["shed"] for t, s in qstats.items() if s["shed"]
            }
        doc["variant_shares"] = {
            v: round(s, 6) for v, s in tenancy.router.shares().items()
        }
        doc["variants"] = tenancy.registry.stats()
        if scenario.name == "tenant_isolation" and flooder is not None:
            # the gate: every NON-flooding tenant's budget must hold
            doc["isolation_ok"] = all(
                info["slo_verdict"] == "ok"
                for tenant, info in doc["tenants"].items()
                if tenant != flooder
            )
            doc["flooding_tenant"] = flooder
            if tenancy.quota is not None:
                # the quota gate: the flood was shed onto the FLOODER's
                # budget only — a shed landing on any other tenant means
                # the token bucket charged the wrong neighbour
                qstats = tenancy.quota.stats()["tenants"]
                doc["flood_shed_ok"] = qstats.get(flooder, {}).get(
                    "shed", 0
                ) > 0 and all(
                    s["shed"] == 0
                    for t, s in qstats.items()
                    if t != flooder
                )
        if nearline_reports:
            doc["nearline"] = {
                "deltas_applied": sum(
                    1 for r in nearline_reports if not r.rolled_back
                ),
                "rollbacks": sum(
                    1 for r in nearline_reports if r.rolled_back
                ),
                "generations": {
                    vid: tenancy.registry.state(vid).generation
                    for vid in sorted(
                        {r.variant_id for r in nearline_reports}
                    )
                },
            }
    return doc
