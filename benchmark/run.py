"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<config>.json``: the deployment, its widths, scale and
solver) and a traffic mix (``benchmark/traffic/<traffic>.json``: how the
data is drawn); the configuration names its job (``benchmark/jobs/<job>.py``:
the program's entry points) and the cell its limits
(``benchmark/limits/<workload>.json``). A run

1. makes its data on the card from ``--seed`` and hands host copies to the
   program's entry points; builds the program's layouts; warms up the
   job's path (all of this is ``setup_s``, from the process's start);
2. runs whole jobs back to back for ``--seconds``: a job is started while
   it is expected to end inside the window (the previous job's time as the
   estimate; the first always), and the window ends with the last job;
3. frees the program's state, makes the data again and judges every job's
   answers against the plain reference (``benchmark/reference``);
4. prints each number compared beside its limit as the last lines of
   standard error, and one JSON line as the last line of standard output.

With ``--trace 1`` the window runs under ``torch.profiler`` (the card's
activity), the program's spans and a log of its kernels' launch shapes, and
the line carries the per-layer metrics (``benchmark/metrics/<name>.py``)
in place of the end-to-end ones. A metric's reader is the module named by
the part of its name before the first dot: ``train_mfu.glm`` and
``train_mfu.glmix`` are one quantity, read by ``metrics/train_mfu.py``, in
cells that report different end-to-end metrics.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "photon_ml_tpu")
GIB = float(1 << 30)
TOP = 10


def log(msg: str) -> None:
    print(f"[bench {time.perf_counter() - T0:8.2f}s] {msg}", file=sys.stderr, flush=True)


def load(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def cell_inputs(bench: dict, workload: str) -> tuple:
    """(cell, configuration, traffic, limits) of a workload of BENCHMARK.json."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    config_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return (cell, load(config_entry["file"]), load(f"benchmark/traffic/{cell['traffic']}.json"),
            load(f"benchmark/limits/{workload}.json"))


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _host_label(spans: list, starts: list, t: float) -> str:
    """The innermost span open at host time ``t`` (the latest-starting one
    that contains it), or "no span"."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 500), -1):
        s = spans[j]
        if s["start"] <= t <= s["start"] + s["dur"]:
            return s["name"]
    return "no span"


def breakdown(events: list, busy: list, spans: list, offset_ns: int, window_ns: tuple) -> dict:
    """The device operations that took most time, and the idle time of the
    window by what the host was doing (the innermost span open at each
    gap's start)."""
    by_op = {}
    for name, a, b in events:
        by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e9
    spans = sorted(spans, key=lambda s: s["start"])
    starts = [s["start"] for s in spans]
    idle = {}
    edges = [window_ns[0]] + [x for ab in busy for x in ab] + [window_ns[1]]
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, window_ns[0]), min(b, window_ns[1])
        if b > a:
            label = _host_label(spans, starts, (a - offset_ns) / 1e9)
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e9

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"device_ops": top(by_op), "idle_gaps": top(idle)}


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = T0, inputs: tuple = None) -> tuple:
    """One run of a cell; returns (the result line's object, the numbers
    compared with their limits). ``inputs`` replaces the cell's
    (cell, configuration, traffic, limits) (the tests' small sizes)."""
    import torch

    from benchmark import datagen, reading, roofline
    from benchmark.reference import judge
    from benchmark.spans import Spans

    cell, config, traffic, limits = inputs or cell_inputs(bench, workload)
    job_module = importlib.import_module(f"benchmark.jobs.{config['job']}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    spans = Spans()
    data = datagen.make(config, traffic, seed, dev)
    job = job_module.Job(config, data, dev, spans)
    del data
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    log("data made and handed over")
    job.build()
    log("layouts built")
    job.warm_up()
    sync()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s")

    if trace:
        from benchmark.trace import DeviceTrace, ShapeLog, busy_intervals, kernel_seconds
        from photon_ml_tpu_torch.telemetry.span import disable_tracing, enable_tracing, get_tracer

        from photon_ml_tpu_torch.ops import launches

        job.trace_on()
        launches_before = launches.counts()
        tracer = enable_tracing(device_sync=True)
        shapes = ShapeLog().__enter__()
        device_trace = DeviceTrace()
        device_trace.start()
    records, last = [], 0.0
    start = time.perf_counter()
    while not records or (time.perf_counter() - start) + last <= seconds:
        t = time.perf_counter()
        record = job.run()
        sync()
        record["end"] = time.perf_counter()
        last = record["end"] - t
        records.append(record)
    end = records[-1]["end"]
    if trace:
        device_trace.stop()
        shapes.__exit__(None, None, None)
        program_spans = [{"name": s.name, "start": tracer.origin_perf + s.start_s,
                          "dur": s.duration_s, "attrs": s.attrs} for s in get_tracer().spans()]
        disable_tracing()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    train_s = (end - start) / len(records)
    log(f"window {end - start:.3f} s, {len(records)} jobs, {train_s:.4f} s a job")
    for rec in records:
        log(f"job {rec['end'] - start:.3f} s into the window, {job.summary(rec)}")

    result = {"correct": False, "attempted": len(records), "failed": len(records)}
    if trace:
        window_ns = (int(start * 1e9) + device_trace.offset_ns,
                     int(end * 1e9) + device_trace.offset_ns)
        events = device_trace.window(start, end)
        busy = [(max(a, window_ns[0]), min(b, window_ns[1])) for a, b in busy_intervals(events)]
        busy_s = sum(b - a for a, b in busy) / 1e9

        r = reading.Reading(
            spans=spans.records + program_spans, window=(start, end), jobs=len(records),
            fe_iterations=[job.fe_iterations(rec) for rec in records],
            model_work_s=[roofline.model_work_s(*job.model_work(rec)) for rec in records],
            kernel_bound_s=shapes.bound_seconds(), kernel_device_s=kernel_seconds(events),
            busy_s=busy_s)
        metrics = {}
        for m in bench["per_layer"]:
            if applies(m, workload):
                reader = importlib.import_module(f"benchmark.metrics.{m['name'].split('.')[0]}")
                value = reader.read(r)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = breakdown(events, busy, r.spans, device_trace.offset_ns, window_ns)
        counted = {k: v - launches_before.get(k, 0) for k, v in launches.counts().items()
                   if v != launches_before.get(k, 0)}
        log(f"launches logged {shapes.counts()}, counted by the program {counted}")
    else:
        values = {"setup_s": setup_s, "train_s": train_s, "peak_mem_gib": peak / GIB}
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if applies(m, workload)}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        result["device"].update(busy_s=busy_s, window_s=end - start)

    # the check: the program's state freed, the inputs made again
    answers = [job.answers(rec) for rec in records]
    answers[-1].update(job.last_answers())
    job.free()
    del job, records
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = getattr(judge, config["job"])(datagen.make(config, traffic, seed, dev),
                                           config, answers)
    failed = sum(any(not (n[k] <= lim) for k, lim in limits.items()) for n in numbers)
    checks = {k: [max(n[k] for n in numbers), lim] for k, lim in limits.items()}
    info = {k: max(n[k] for n in numbers) for k in numbers[0] if k not in limits}
    for k, v in info.items():
        log(f"(not compared) {k} {v!r}")
    log(f"check {time.perf_counter() - t:.3f} s")
    result.update(correct=failed == 0 and all(math.isfinite(v) for v, _ in checks.values()),
                  failed=failed, checks=checks)
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # caches at fixed paths inside the checkout; no library loads JAX
    os.environ["USE_FLAX"] = "0"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    bench = load("BENCHMARK.json")
    cell = cell_inputs(bench, args.workload)[0]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"this cell needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, checks = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package loaded in this process: {bad}", file=sys.stderr)
        return 3
    for name, (value, limit) in checks.items():
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
