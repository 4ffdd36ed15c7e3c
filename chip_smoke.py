"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed 0] [--phases env,build,kernel,score_full_width,score_game_cli]

Phases, in order, each printing one JSON line (any failure raises, so the
exit code is not 0):

1. env              — torch/CUDA versions, the card's name and power limit,
                      where nvcc resolves, whether triton imports.
2. build            — build every kernel library from ops/csrc with nvcc
                      (one process per source, all started together).
3. kernel           — csr_matvec_f32 against its plain PyTorch version and a
                      float64 computation, on the card, over random CSR
                      matrices (n in {1, 31, 4097, 2^20}, rows of 0/1/16/33/
                      4096 nonzeros, dim in {2^17, 2^24}).
4. score_full_width — GameModel.score of a GLMix logistic model at full width
                      (FE: 2^20 rows x 2^24 dims x 16 nonzeros a row; per-user
                      RE 65,536 x 16; per-item RE 16,384 x 16; ~3% unseen
                      entities), checked against the same scoring through the
                      plain versions, with kernel/plain/library/bound times.
5. score_game_cli   — photon_ml_tpu_torch.cli.score_game on an Avro fixture
                      written by the port's own writers (65,536 rows x 16 FE
                      nonzeros), on cuda and on cpu: same AUC to 1e-6.

Then a line with the card's name and power limit (nvidia-smi), a JSON line
with one entry per kernel, and last {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when torch.cuda.is_available() is False.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

ALL_PHASES = ("env", "build", "kernel", "score_full_width", "score_game_cli")
KERNEL_REPLACES = {
    "csr_matvec_f32": "photon_ml_tpu/ops/fused_perm.py:325 (_descend_call), "
                      ":466 (_base_call), :421 (_ascend_call)",
}
KERNEL_SOURCE = {"csr_matvec_f32": "photon_ml_tpu_torch/ops/csrc/spmv.cu"}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fns: dict, reps: int = 20, warmup: int = 3) -> dict:
    """Median milliseconds of each function on the card over ``reps`` calls,
    each call timed with CUDA events. The functions take turns in blocks of
    reps/2 calls, in order and then in reverse (a b c c b a), so that a
    drift of the card's clock falls on all of them alike."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    times = {name: [] for name in fns}
    for order in (list(fns), list(reversed(list(fns)))):
        for name in order:
            for _ in range(reps // 2):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fns[name]()
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def csr_bound_ms(n: int, nnz: int, dim: int) -> tuple:
    """Least time for z = X w on the card: each input read once (row_ptr
    8(n+1), col_idx 4 nnz, vals 4 nnz, w 4 dim), z written once (4n), over
    the HBM rate; or 2 flops a nonzero over the f32 rate, whichever is
    larger."""
    bytes_ms = (8 * (n + 1) + 8 * nnz + 4 * dim + 4 * n) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * nnz / F32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


# ---------------------------------------------------------------- phases


def phase_env() -> dict:
    from photon_ml_tpu_torch.utils import cudalib

    try:
        import triton  # noqa: F401

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    info = {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvidia_smi": nvidia_smi(),
        "nvcc": cudalib.find_nvcc(),
        "triton": triton_version,
        "device_count": torch.cuda.device_count(),
    }
    emit("env", **info)
    return info


def phase_build() -> dict:
    from photon_ml_tpu_torch.utils import cudalib

    sources = sorted(p.stem for p in cudalib.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    logs = cudalib.build_libraries(sources)
    seconds = time.perf_counter() - t0
    ptxas = {name: [l for l in log.splitlines() if "registers" in l or "spill" in l]
             for name, log in logs.items()}
    emit("build", seconds=seconds, sources=sources, ptxas=ptxas)
    return {"seconds": seconds}


def _random_csr(n: int, dim: int, gen: torch.Generator, dev) -> tuple:
    """Rows of 0/1/16/33 nonzeros in turn, and 4096 nonzeros in every
    4099th row (row 0 included)."""
    pattern = torch.tensor([0, 1, 16, 33], dtype=torch.int64, device=dev)
    r = torch.arange(n, device=dev)
    lengths = pattern[r % 4]
    lengths[r % 4099 == 0] = 4096
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    row_ptr[1:] = torch.cumsum(lengths, 0)
    nnz = int(row_ptr[-1])
    col_idx = torch.randint(0, dim, (nnz,), generator=gen, device=dev, dtype=torch.int64)
    vals = torch.randn(nnz, generator=gen, device=dev)
    return row_ptr, col_idx.to(torch.int32), vals


def phase_kernel(seed: int) -> dict:
    from photon_ml_tpu_torch.ops import fused_perm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = []
    worst = 0.0
    for dim in (1 << 17, 1 << 24):
        w = torch.randn(dim, generator=gen, device=dev)
        for n in (1, 31, 4097, 1 << 20):
            row_ptr, col_idx, vals = _random_csr(n, dim, gen, dev)
            z = fused_perm.csr_matvec_f32(row_ptr, col_idx, vals, w, dim)
            torch.cuda.synchronize()
            z_plain = fused_perm.csr_matvec_plain(row_ptr, col_idx, vals, w)
            rows = torch.repeat_interleave(torch.arange(n, device=dev), row_ptr.diff())
            prod = vals.double() * w.double()[col_idx.long()]
            z64 = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(0, rows, prod)
            row_abs = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
                0, rows, prod.abs()
            )
            # sums are taken in another order than the plain version's
            tol = 1e-5 * torch.clamp(row_abs, min=1.0)
            d_plain = (z.double() - z_plain.double()).abs()
            d_64 = (z.double() - z64).abs()
            ok = bool((d_plain <= tol).all() and (d_64 <= tol).all())
            if not bool(torch.isfinite(z).all()) or z.shape != (n,):
                ok = False
            case = {
                "n": n, "dim": dim, "nnz": int(row_ptr[-1]),
                "max_abs_err_plain": float(d_plain.max()),
                "max_abs_err_f64": float(d_64.max()),
                "ok": ok,
            }
            cases.append(case)
            worst = max(worst, case["max_abs_err_plain"])
            if not ok:
                emit("kernel", cases=cases)
                raise AssertionError(f"csr_matvec_f32 disagrees with its plain version: {case}")
    emit("kernel", tolerance="atol = 1e-5 * max(1, sum |v*w| over the row)",
         cases=cases)
    return {"max_abs_err": worst}


def _distinct_cols(rng, rows: int, k: int, dim: int) -> np.ndarray:
    """[rows, k] columns in [0, dim), distinct within each row: a random
    start and a random stride below dim / k."""
    start = rng.integers(0, dim, rows)
    stride = rng.integers(1, dim // k, rows)
    return (start[:, None] + stride[:, None] * np.arange(k)) % dim


def make_glmix(seed: int, n: int, fe_dim: int, fe_k: int, n_users: int, n_items: int,
               re_dim: int = 4096, re_local: int = 16, re_k: int = 8,
               unseen: float = 0.03):
    """A GLMix dataset (host numpy COO) and the coordinates of a random model
    for it (``convert.game_model_from_numpy`` input), made from ``seed``."""
    from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData

    rng = np.random.default_rng(seed)
    fe_rows = np.repeat(np.arange(n, dtype=np.int64), fe_k)
    fe_cols = np.sort(rng.integers(0, fe_dim, (n, fe_k)), axis=1).reshape(-1)
    fe_vals = rng.standard_normal(n * fe_k, dtype=np.float32)
    shards = {"global": FeatureShard(fe_rows, fe_cols, fe_vals, fe_dim)}
    id_tags = {}
    coords = {
        "fixed": {
            "feature_shard": "global",
            "means": (rng.standard_normal(fe_dim, dtype=np.float32) * 0.1),
        }
    }
    for re_type, shard, prefix, count in (
        ("userId", "per_user", "u", n_users), ("itemId", "per_item", "i", n_items)
    ):
        # each entity's projected space: re_local distinct sorted features
        pidx = np.sort(_distinct_cols(rng, count, re_local, re_dim), axis=1)
        valid = np.ones((count, re_local), dtype=bool)
        valid[rng.random(count) < 0.25, re_local - 2:] = False  # shorter spaces
        pidx = np.where(valid, pidx, re_dim)
        ent = rng.integers(0, count, n)
        is_unseen = rng.random(n) < unseen
        ids = np.where(
            is_unseen,
            np.char.add(f"unseen_{prefix}", ent.astype(str)),
            np.char.add(prefix, ent.astype(str)),
        )
        # re_k nonzeros a row: most inside the entity's space, some outside
        picks = pidx[ent[:, None], rng.integers(0, re_local - 2, (n, re_k))]
        outside = rng.random((n, re_k)) < 0.25
        cols = np.where(outside, rng.integers(0, re_dim, (n, re_k)), picks)
        shards[shard] = FeatureShard(
            np.repeat(np.arange(n, dtype=np.int64), re_k),
            cols.reshape(-1).astype(np.int64),
            rng.standard_normal(n * re_k, dtype=np.float32),
            re_dim,
        )
        id_tags[re_type] = ids
        entity_ids = [f"{prefix}{e}" for e in range(count)]
        coords[f"per_{re_type}"] = {
            "feature_shard": shard,
            "random_effect_type": re_type,
            "coefficients": [rng.standard_normal((count, re_local), dtype=np.float32) * 0.3],
            "proj_indices": [pidx],
            "proj_valid": [valid],
            "entity_ids": [entity_ids],
            "entity_to_loc": {eid: (0, e) for e, eid in enumerate(entity_ids)},
            "global_dim": re_dim,
        }
    labels = (rng.random(n) < 0.5).astype(np.float32)
    return GameData(labels=labels, feature_shards=shards, id_tags=id_tags), coords


def phase_score_full_width(seed: int) -> dict:
    from photon_ml_tpu_torch.convert import game_model_from_numpy
    from photon_ml_tpu_torch.ops import fused_perm, launches
    from photon_ml_tpu_torch.types import TaskType

    n, fe_dim, fe_k = 1 << 20, 1 << 24, 16
    t0 = time.perf_counter()
    data, coords = make_glmix(seed, n, fe_dim, fe_k, n_users=65_536, n_items=16_384)
    model = game_model_from_numpy(coords, TaskType.LOGISTIC_REGRESSION, device="cuda")
    setup_s = time.perf_counter() - t0

    # the main path: counts set to 0 just before, read just after
    launches.reset()
    t0 = time.perf_counter()
    z = model.score(data)
    torch.cuda.synchronize()
    first_score_s = time.perf_counter() - t0
    counts = launches.counts()
    if counts["csr_matvec_f32"] < 1:
        raise AssertionError(f"score did not launch csr_matvec_f32: {counts}")
    feats = data.sparse_features("global", engine="auto", device="cuda")
    if not isinstance(feats, fused_perm.FusedSparseFeatures):
        raise AssertionError(f"auto engine picked {type(feats).__name__}, not fused")

    # the same scoring through the plain versions, on the card
    means = model.models["fixed"].coefficients.means
    z_plain = fused_perm.csr_matvec_plain(feats.row_ptr, feats.col_idx, feats.vals, means)
    for cid in model.models:
        if cid != "fixed":
            z_plain = z_plain + model.score_coordinate(cid, data)
    rows = torch.repeat_interleave(torch.arange(n, device="cuda"), feats.row_ptr.diff())
    row_abs = torch.zeros(n, device="cuda").index_add_(
        0, rows, (feats.vals * means[feats.col_idx.long()]).abs()
    )
    tol = 1e-5 * torch.clamp(row_abs, min=1.0)
    diff = (z - z_plain).abs()
    if z.shape != (n,) or not bool(torch.isfinite(z).all()) or not bool((diff <= tol).all()):
        raise AssertionError(f"full-width score disagrees: max |d| {float(diff.max())}")

    # times at the main path's shapes
    kernel = lambda: fused_perm.csr_matvec_f32(  # noqa: E731
        feats.row_ptr, feats.col_idx, feats.vals, means, fe_dim)
    plain = lambda: fused_perm.csr_matvec_plain(  # noqa: E731
        feats.row_ptr, feats.col_idx, feats.vals, means)
    csr = torch.sparse_csr_tensor(
        feats.row_ptr, feats.col_idx.long(), feats.vals, size=(n, fe_dim),
        check_invariants=True,
    )
    library = lambda: torch.mv(csr, means)  # noqa: E731
    ms = cuda_ms({"kernel": kernel, "plain": plain, "library": library})
    lib_diff = float((library() - kernel()).abs().max())
    score_times = []
    for _ in range(5):
        t0 = time.perf_counter()
        model.score(data)
        torch.cuda.synchronize()
        score_times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for cid, sub in model.models.items():
        if cid != "fixed":
            sub.entity_positions(data.id_tags[model.meta[cid].random_effect_type])
    re_lookup_ms = (time.perf_counter() - t0) * 1e3
    bound_ms, bound_by = csr_bound_ms(n, feats.nnz, fe_dim)
    result = {
        "n": n, "fe_dim": fe_dim, "fe_nnz": feats.nnz,
        "setup_s": setup_s, "first_score_s": first_score_s,
        "launches": counts["csr_matvec_f32"],
        "max_abs_err_vs_plain_path": float(diff.max()),
        "kernel_ms": ms["kernel"], "plain_ms": ms["plain"], "library_ms": ms["library"],
        "library_max_abs_diff": lib_diff,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "score_ms_median_of_5": statistics.median(score_times),
        "re_entity_lookup_ms": re_lookup_ms,
        **profile_score(model, data),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit("score_full_width", **result)
    return result


def profile_score(model, data) -> dict:
    """One GameModel.score call under torch.profiler: the device's busy
    time (the device-side events alone, kernels and copies: a host operator
    also reports the device time of what it launched, so counting both would
    count it twice), its idle share of the call's wall time, and the top
    device consumers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.score(data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    busy_ms = sum(device_us(e) for e in events) / 1e3
    top = sorted(events, key=device_us, reverse=True)[:6]
    return {
        "profiled_score_wall_ms": wall_ms,
        "profiled_device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
        "profiled_device_idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else "not measured",
        "profiled_top_device_ms": {e.key[:60]: device_us(e) / 1e3 for e in top if device_us(e) > 0},
    }


def write_cli_fixture(root: str, seed: int, n: int = 65_536, fe_dim: int = 1 << 16,
                      fe_k: int = 16, n_users: int = 4096, n_items: int = 1024,
                      re_dim: int = 256, re_k: int = 4) -> None:
    """An Avro dataset and an Avro GAME model, written by the port's own
    writers, under ``root``/data and ``root``/model."""
    from photon_ml_tpu_torch.convert import game_model_from_numpy
    from photon_ml_tpu_torch.indexmap import INTERCEPT_KEY, DefaultIndexMap, feature_key
    from photon_ml_tpu_torch.io.data_reader import write_training_examples
    from photon_ml_tpu_torch.io.model_io import save_game_model
    from photon_ml_tpu_torch.types import TaskType

    rng = np.random.default_rng(seed)
    fe_cols = _distinct_cols(rng, n, fe_k, fe_dim)
    fe_vals = rng.standard_normal((n, fe_k))
    w_fe = rng.standard_normal(fe_dim + 1).astype(np.float32) * 0.2  # + intercept
    margin = (fe_vals * w_fe[fe_cols]).sum(axis=1) + w_fe[fe_dim]
    labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float64)
    users = rng.integers(0, n_users, n)
    items = rng.integers(0, n_items, n)
    unseen_u = rng.random(n) < 0.03
    unseen_i = rng.random(n) < 0.03
    u_cols = rng.integers(0, re_dim, (n, re_k))
    i_cols = rng.integers(0, re_dim, (n, re_k))
    records = (
        {
            "uid": f"r{r}",
            "label": float(labels[r]),
            "features": [("f", str(c), float(v)) for c, v in zip(fe_cols[r], fe_vals[r])],
            "userFeatures": [("u", str(c), 1.0) for c in u_cols[r]],
            "itemFeatures": [("i", str(c), 1.0) for c in i_cols[r]],
            "metadataMap": {
                "userId": f"{'new' if unseen_u[r] else 'u'}{users[r]}",
                "itemId": f"{'new' if unseen_i[r] else 'i'}{items[r]}",
            },
        }
        for r in range(n)
    )
    os.makedirs(os.path.join(root, "data"))
    write_training_examples(os.path.join(root, "data", "part-00000.avro"), records)

    fe_names = {feature_key("f", str(c)): c for c in range(fe_dim)}
    fe_names[INTERCEPT_KEY] = fe_dim
    index_maps = {"global": DefaultIndexMap(fe_names)}
    coords = {"fixed": {"feature_shard": "global", "means": w_fe}}
    for re_type, shard, prefix, count in (
        ("userId", "per_user", "u", n_users), ("itemId", "per_item", "i", n_items)
    ):
        index_maps[shard] = DefaultIndexMap(
            {feature_key(prefix, str(c)): c for c in range(re_dim)}
        )
        pidx = np.sort(_distinct_cols(rng, count, 16, re_dim), axis=1)
        ids = [f"{prefix}{e}" for e in range(count)]
        coords[f"per_{re_type}"] = {
            "feature_shard": shard,
            "random_effect_type": re_type,
            "coefficients": [rng.standard_normal((count, 16)).astype(np.float32) * 0.3],
            "proj_indices": [pidx],
            "proj_valid": [np.ones((count, 16), dtype=bool)],
            "entity_ids": [ids],
            "entity_to_loc": {eid: (0, e) for e, eid in enumerate(ids)},
            "global_dim": re_dim,
        }
    model = game_model_from_numpy(coords, TaskType.LOGISTIC_REGRESSION, device="cpu")
    save_game_model(
        model, os.path.join(root, "model"), index_maps=index_maps,
        configurations={"feature_shards": {
            "global": {"feature_bags": ["features"], "add_intercept": True},
            "per_user": {"feature_bags": ["userFeatures"], "add_intercept": False},
            "per_item": {"feature_bags": ["itemFeatures"], "add_intercept": False},
        }},
    )


def phase_score_game_cli(seed: int) -> dict:
    from photon_ml_tpu_torch.cli import score_game
    from photon_ml_tpu_torch.io.scores_io import load_scores
    from photon_ml_tpu_torch.ops import launches

    n = 65_536
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as root:
        t0 = time.perf_counter()
        write_cli_fixture(root, seed, n=n)
        fixture_s = time.perf_counter() - t0
        result = {"rows": n, "fixture_s": fixture_s}
        for device in ("cuda", "cpu"):
            out = os.path.join(root, f"scores_{device}")
            argv = [
                "--data-dirs", os.path.join(root, "data"),
                "--model-dir", os.path.join(root, "model"),
                "--output-dir", out, "--evaluator", "AUC", "--device", device,
            ]
            launches.reset()
            t0 = time.perf_counter()
            auc = score_game.run(score_game.parse_args(argv))
            result[f"{device}_s"] = time.perf_counter() - t0
            result[f"{device}_launches"] = launches.counts()["csr_matvec_f32"]
            result[f"{device}_auc"] = auc
            result[f"{device}_records"] = sum(1 for _ in load_scores(out))
    if result["cuda_launches"] < 1:
        raise AssertionError(f"score_game on cuda did not launch csr_matvec_f32: {result}")
    for device in ("cuda", "cpu"):
        if result[f"{device}_records"] != n:
            raise AssertionError(f"{device} scores file has {result[f'{device}_records']} records")
    if not np.isfinite(result["cuda_auc"]) or abs(result["cuda_auc"] - result["cpu_auc"]) > 1e-6:
        raise AssertionError(f"AUC on cuda and cpu differ: {result}")
    emit("score_game_cli", **result)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--phases", default=",".join(ALL_PHASES))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to check",
              file=sys.stderr)
        return 1
    import photon_ml_tpu_torch  # noqa: F401  (fails outside a checkout)

    phases = args.phases.split(",")
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")
    results = {}
    if "env" in phases:
        results["env"] = phase_env()
    if "build" in phases:
        results["build"] = phase_build()
    if "kernel" in phases:
        results["kernel"] = phase_kernel(args.seed)
    if "score_full_width" in phases:
        results["score_full_width"] = phase_score_full_width(args.seed)
    if "score_game_cli" in phases:
        results["score_game_cli"] = phase_score_game_cli(args.seed)

    full = results.get("score_full_width")
    kernels = [{
        "name": "csr_matvec_f32",
        "route": "cuda",
        "source": KERNEL_SOURCE["csr_matvec_f32"],
        "replaces": KERNEL_REPLACES["csr_matvec_f32"],
        "launches": full["launches"] if full else None,
        "max_abs_err": results["kernel"]["max_abs_err"] if "kernel" in results else None,
        "ms": full["kernel_ms"] if full else None,
        "plain_ms": full["plain_ms"] if full else None,
        "bound_ms": full["bound_ms"] if full else None,
        "bound_by": full["bound_by"] if full else None,
        "library_ms": full["library_ms"] if full else None,
    }]
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
