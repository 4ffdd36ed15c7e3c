"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed 0] [--phases env,build,kernel,...]

Phases, in order, each printing one JSON line (any failure raises, so the
exit code is not 0):

1. env              — torch/CUDA versions, the card's name and power limit,
                      where nvcc resolves, whether triton imports.
2. build            — build every kernel library from ops/csrc with nvcc
                      (one process per source, all started together).
3. kernel           — each kernel against its plain PyTorch version and a
                      float64 computation, on the card: csr_matvec_f32 over
                      random CSR matrices (n in {1, 31, 4097, 2^20}, rows of
                      0/1/16/33/4096 nonzeros, dim in {2^17, 2^24});
                      csc_rmatvec_f32 with all four value transforms over
                      random CSC matrices (n in {1, 4097, 2^20}, dim in
                      {2^17, 2^24}; empty columns, duplicate rows, a column
                      holding every row, long columns);
                      fused_value_grad_batched_f32 with the four losses over
                      batches (E, s, d) from E in {1, 7, 65,536}, s in {1,
                      16, 33, 512}, d in {1, 16, 100}, weight-0 rows whose
                      loss overflows.
4. score_full_width — GameModel.score of a GLMix logistic model at full width
                      (FE: 2^20 rows x 2^24 dims x 16 nonzeros a row; per-user
                      RE 65,536 x 16; per-item RE 16,384 x 16; ~3% unseen
                      entities), checked against the same scoring through the
                      plain versions and for bitwise repeats, with
                      kernel/plain/library/bound times.
5. score_game_cli   — photon_ml_tpu_torch.cli.score_game on an Avro fixture
                      written by the port's own writers (65,536 rows x 16 FE
                      nonzeros), on cuda and on cpu: same AUC to 1e-6.
6. train_full_width — GameEstimator.fit of a GLMix logistic model at the same
                      full width (FE 2^20 rows x 2^24 dims x 16 nonzeros +
                      an intercept; per-user RE 65,536 x 16, per-item
                      16,384 x 16), one outer iteration fixed -> per_user ->
                      per_item, L-BFGS 10 iterations, lambda 1, validation AUC
                      on 2^18 held-out rows; checked against the same training
                      through the plain versions on the card (objective rtol
                      1e-4, AUC 1e-4), with seconds per coordinate, launches,
                      kernel/plain/library/bound times, each kernel against
                      its plain version at those shapes, and the device idle
                      share of one random-effect solve.
7. train_game_cli   — photon_ml_tpu_torch.cli.train_game on the committed
                      ratings fixture (LINEAR_REGRESSION, FE + per_user +
                      per_movie, 2 outer iterations, RMSE), on cuda and on
                      cpu: RMSE < 0.45 on both and equal to 1e-4, two cuda
                      runs bitwise equal; then score_game on the saved
                      model reproduces the RMSE.

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

ALL_PHASES = ("env", "build", "kernel", "score_full_width", "score_game_cli",
              "train_full_width", "train_game_cli")
KERNELS = ("csr_matvec_f32", "csc_rmatvec_f32", "fused_value_grad_batched_f32")
KERNEL_REPLACES = {
    "csr_matvec_f32": "photon_ml_tpu/ops/fused_perm.py:325 (_descend_call), "
                      ":466 (_base_call), :421 (_ascend_call); matvec configuration",
    "csc_rmatvec_f32": "photon_ml_tpu/ops/fused_perm.py:325 (_descend_call), "
                       ":466 (_base_call), :421 (_ascend_call); rmatvec configuration",
    "fused_value_grad_batched_f32": "photon_ml_tpu/ops/pallas_kernels.py:186 "
                                    "(fused_value_grad_single, _single_kernel :140)",
}
KERNEL_SOURCE = {
    "csr_matvec_f32": "photon_ml_tpu_torch/ops/csrc/spmv.cu",
    "csc_rmatvec_f32": "photon_ml_tpu_torch/ops/csrc/spmv_t.cu",
    "fused_value_grad_batched_f32": "photon_ml_tpu_torch/ops/csrc/value_grad.cu",
}
RATINGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "ratings")


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


def _bound(nbytes: float, flops: float) -> tuple:
    """The larger of bytes over the HBM rate and flops over the f32 rate,
    in ms, and which of the two it is."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def csr_bound_ms(n: int, nnz: int, dim: int) -> tuple:
    """Least time for z = X w on the card: each input read once (row_ptr
    8(n+1), col_idx 4 nnz, vals 4 nnz, w 4 dim), z written once (4n); 2 flops
    a nonzero."""
    return _bound(8 * (n + 1) + 8 * nnz + 4 * dim + 4 * n, 2 * nnz)


def csc_bound_ms(n: int, nnz: int, dim: int) -> tuple:
    """Least time for g = X^T c: col_ptr 8(dim+1), row_idx 4 nnz, vals 4 nnz
    and c 4n read once, g written once (4 dim); 2 flops a nonzero."""
    return _bound(8 * (dim + 1) + 8 * nnz + 4 * n + 4 * dim, 2 * nnz)


def value_grad_bound_ms(E: int, s: int, d: int) -> tuple:
    """Least time for the fused value+gradient pass: X, y, off, wt, w read
    once and value, grad, csum written once, 4E(s d + 3s + 2d + 2) bytes;
    4 s d flops an entity (z and the gradient, 2 each)."""
    return _bound(4 * E * (s * d + 3 * s + 2 * d + 2), 4 * E * s * d)


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


def _check_csr_kernel(gen, dev) -> tuple:
    from photon_ml_tpu_torch.ops import fused_perm

    cases, worst = [], 0.0
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
            case = _compare(z, z_plain, z64, row_abs, row_ptr.diff(), (n,),
                            n=n, dim=dim, nnz=int(row_ptr[-1]))
            cases.append(case)
            worst = max(worst, case["max_abs_err_plain"])
            if not case["ok"]:
                emit("kernel", csr_matvec_f32=cases)
                raise AssertionError(f"csr_matvec_f32 disagrees with its plain version: {case}")
    return cases, worst


def _compare(out, plain, ref64, abs_sum, terms, shape, **info) -> dict:
    """out against a float64 computation within atol = 1e-5 * max(1, sum of
    |terms|), elementwise, and against its plain version within that plus
    the plain version's own rounding bound, terms * 2^-24 * max(1, sum of
    |terms|) (it adds one term at a time in f32, with atomics on the card;
    ``terms`` is the number of terms of each output)."""
    scale = torch.clamp(abs_sum, min=1.0)
    tol = 1e-5 * scale
    tol_plain = tol + terms * 2.0 ** -24 * scale
    d_plain = (out.double() - plain.double()).abs()
    d_64 = (out.double() - ref64).abs()
    ok = (
        tuple(out.shape) == tuple(shape)
        and bool(torch.isfinite(out).all())
        and bool((d_plain <= tol_plain).all())
        and bool((d_64 <= tol).all())
    )
    return {**info, "max_abs_err_plain": float(d_plain.max()) if out.numel() else 0.0,
            "max_abs_err_f64": float(d_64.max()) if out.numel() else 0.0, "ok": ok}


def _random_csc(n: int, dim: int, gen: torch.Generator, dev) -> tuple:
    """Columns of 0/1/1/2/1/0/3/1 nonzeros in turn (empty columns), 40 in
    every 1021st column and 9000 in every 65,537th (long columns, one and
    two segments), every row in column 0; row indices drawn with
    replacement, so a column may name a row twice."""
    pattern = torch.tensor([0, 1, 1, 2, 1, 0, 3, 1], dtype=torch.int64, device=dev)
    j = torch.arange(dim, device=dev)
    lengths = pattern[j % 8]
    lengths[j % 1021 == 5] = 40
    lengths[j % 65537 == 7] = 9000
    lengths[0] = n
    col_ptr = torch.zeros(dim + 1, dtype=torch.int64, device=dev)
    col_ptr[1:] = torch.cumsum(lengths, 0)
    nnz = int(col_ptr[-1])
    row_idx = torch.randint(0, n, (nnz,), generator=gen, device=dev)
    row_idx[: n] = torch.arange(n, device=dev)  # column 0: every row once
    vals = torch.randn(nnz, generator=gen, device=dev)
    vals[torch.rand(nnz, generator=gen, device=dev) < 0.01] = 0.0  # for "nnz"
    return col_ptr, row_idx.to(torch.int32), vals


def _check_csc_kernel(gen, dev) -> tuple:
    from photon_ml_tpu_torch.ops import fused_perm

    transforms = {
        "id": lambda v: v, "sq": lambda v: v * v, "abs": lambda v: v.abs(),
        "nnz": lambda v: (v != 0).to(v.dtype),
    }
    cases, worst = [], 0.0
    for dim in (1 << 17, 1 << 24):
        for n in (1, 4097, 1 << 20):
            col_ptr, row_idx, vals = _random_csc(n, dim, gen, dev)
            c = torch.randn(n, generator=gen, device=dev)
            seg = fused_perm.CscSegments.of(col_ptr)
            cols = torch.repeat_interleave(torch.arange(dim, device=dev), col_ptr.diff())
            for name, t in transforms.items():
                g = fused_perm.csc_rmatvec_f32(col_ptr, row_idx, vals, c, n, name, seg)
                torch.cuda.synchronize()
                g_plain = fused_perm.csc_rmatvec_plain(col_ptr, row_idx, vals, c, name)
                prod = t(vals.double()) * c.double()[row_idx.long()]
                g64 = torch.zeros(dim, dtype=torch.float64, device=dev).index_add_(0, cols, prod)
                col_abs = torch.zeros(dim, dtype=torch.float64, device=dev).index_add_(
                    0, cols, prod.abs()
                )
                case = _compare(g, g_plain, g64, col_abs, col_ptr.diff(), (dim,), n=n, dim=dim,
                                nnz=int(col_ptr[-1]), transform=name,
                                long_columns=int(seg.long_cols.numel()),
                                segments=int(seg.seg_begin.numel()))
                repeat = fused_perm.csc_rmatvec_f32(col_ptr, row_idx, vals, c, n, name, seg)
                case["bitwise_repeatable"] = bool(torch.equal(g, repeat))
                case["ok"] = case["ok"] and case["bitwise_repeatable"]
                cases.append(case)
                worst = max(worst, case["max_abs_err_plain"])
                if not case["ok"]:
                    emit("kernel", csc_rmatvec_f32=cases)
                    raise AssertionError(f"csc_rmatvec_f32 disagrees with its plain version: {case}")
    return cases, worst


VALUE_GRAD_SHAPES = ((1, 1, 1), (1, 512, 100), (7, 33, 16), (7, 16, 100),
                     (65_536, 16, 16), (65_536, 33, 1))


def _value_grad_f64(X, y, off, wt, w, kind):
    """The pass in float64, and the sums of |terms| that bound its f32
    rounding."""
    X, y, off, wt, w = (t.double() for t in (X, y, off, wt, w))
    z = (X * w.unsqueeze(-2)).sum(-1) + off
    pos = wt > 0
    lw = torch.where(pos, wt * kind.value(z, y), torch.zeros_like(z))
    dz = torch.where(pos, wt * kind.d1(z, y), torch.zeros_like(z))
    return (
        (lw.sum(-1), (dz.unsqueeze(-1) * X).sum(-2), dz.sum(-1)),
        (lw.abs().sum(-1), (dz.unsqueeze(-1) * X).abs().sum(-2), dz.abs().sum(-1)),
    )


def _value_grad_inputs(E, s, d, gen, dev) -> tuple:
    X = torch.randn(E, s, d, generator=gen, device=dev) / max(d, 1) ** 0.5
    y = (torch.rand(E, s, generator=gen, device=dev) < 0.5).float()
    off = torch.randn(E, s, generator=gen, device=dev) * 0.5
    wt = torch.rand(E, s, generator=gen, device=dev) + 0.5
    # weight-0 rows, a quarter of them with an offset that makes the squared
    # and Poisson losses overflow to inf
    zero = torch.rand(E, s, generator=gen, device=dev) < 0.2
    wt[zero] = 0.0
    off[zero & (torch.rand(E, s, generator=gen, device=dev) < 0.25)] = 1e20
    w = torch.randn(E, d, generator=gen, device=dev)
    return X, y, off, wt, w


def _check_value_grad_kernel(gen, dev) -> tuple:
    from photon_ml_tpu_torch.losses.pointwise import (
        LogisticLoss, PoissonLoss, SmoothedHingeLoss, SquaredLoss,
    )
    from photon_ml_tpu_torch.ops import pallas_kernels

    cases, worst = [], 0.0
    for E, s, d in VALUE_GRAD_SHAPES:
        inputs = _value_grad_inputs(E, s, d, gen, dev)
        for kind in (LogisticLoss, SquaredLoss, PoissonLoss, SmoothedHingeLoss):
            out = pallas_kernels.fused_value_grad_batched_f32(*inputs, kind)
            torch.cuda.synchronize()
            plain = pallas_kernels.fused_value_grad_plain(*inputs, kind)
            ref, scale = _value_grad_f64(*inputs, kind)
            parts = [
                _compare(o, p, r, a, terms, o.shape, part=name)
                for name, o, p, r, a, terms in zip(
                    ("value", "grad", "csum"), out, plain, ref, scale, (s, s, s))
            ]
            case = {"E": E, "s": s, "d": d, "loss": kind.__name__,
                    "max_abs_err_plain": max(p["max_abs_err_plain"] for p in parts),
                    "max_abs_err_f64": max(p["max_abs_err_f64"] for p in parts),
                    "ok": all(p["ok"] for p in parts)}
            cases.append(case)
            worst = max(worst, case["max_abs_err_plain"])
            if not case["ok"]:
                emit("kernel", fused_value_grad_batched_f32=cases)
                raise AssertionError(
                    f"fused_value_grad_batched_f32 disagrees with its plain version: {case} {parts}"
                )
    return cases, worst


def phase_kernel(seed: int) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    results, worst = {}, {}
    for name, check in (
        ("csr_matvec_f32", _check_csr_kernel),
        ("csc_rmatvec_f32", _check_csc_kernel),
        ("fused_value_grad_batched_f32", _check_value_grad_kernel),
    ):
        results[name], worst[name] = check(gen, dev)
        torch.cuda.empty_cache()
    emit("kernel", tolerance="vs float64: atol = 1e-5 * max(1, sum of |terms|); vs plain: "
         "that + terms * 2^-24 * max(1, sum of |terms|), elementwise", **results)
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
        z_again = model.score(data)
        torch.cuda.synchronize()
        score_times.append((time.perf_counter() - t0) * 1e3)
    if not torch.equal(z, z_again):
        raise AssertionError("two full-width score calls differ")
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
        "score_profile": profile_device_idle(lambda: model.score(data)),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit("score_full_width", **result)
    return result


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


def make_glmix_training(seed: int, n: int, n_val: int, fe_dim: int, fe_k: int,
                        n_users: int, n_items: int, re_dim: int = 4096,
                        re_local: int = 16, re_k: int = 8, unseen: float = 0.03):
    """Training and validation GameData drawn from one random GLMix logistic
    model, made from ``seed``: FE rows of ``fe_k`` distinct features out of
    ``fe_dim`` plus an intercept (column ``fe_dim``); each user and item an
    entity with ``re_local`` features of its own out of ``re_dim``, each row
    ``re_k`` of them. Validation rows name an unseen entity with
    probability ``unseen``."""
    from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData

    rng = np.random.default_rng(seed)
    total = n + n_val
    fe_cols = np.sort(_distinct_cols(rng, total, fe_k, fe_dim), axis=1)
    fe_cols = np.concatenate([fe_cols, np.full((total, 1), fe_dim)], axis=1)
    fe_vals = np.concatenate(
        [rng.standard_normal((total, fe_k), dtype=np.float32) / np.sqrt(fe_k),
         np.ones((total, 1), np.float32)], axis=1)
    w_fe = rng.standard_normal(fe_dim + 1, dtype=np.float32)
    margin = (fe_vals * w_fe[fe_cols]).sum(axis=1)
    cols = {"global": fe_cols}
    vals = {"global": fe_vals}
    id_tags = {}
    for re_type, shard, prefix, count in (
        ("userId", "per_user", "u", n_users), ("itemId", "per_item", "i", n_items)
    ):
        space = np.sort(_distinct_cols(rng, count, re_local, re_dim), axis=1)
        w_re = rng.standard_normal((count, re_local), dtype=np.float32) * 0.5
        ent = rng.integers(0, count, total)
        slot = np.sort(_distinct_cols(rng, total, re_k, re_local), axis=1)
        v = rng.standard_normal((total, re_k), dtype=np.float32) / np.sqrt(re_k)
        margin += (v * w_re[ent[:, None], slot]).sum(axis=1)
        cols[shard] = space[ent[:, None], slot]
        vals[shard] = v
        new = np.zeros(total, dtype=bool)
        new[n:] = rng.random(n_val) < unseen
        id_tags[re_type] = np.where(
            new, np.char.add(f"new_{prefix}", ent.astype(str)),
            np.char.add(prefix, ent.astype(str)),
        )
    labels = (rng.random(total) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    dims = {"global": fe_dim + 1, "per_user": re_dim, "per_item": re_dim}

    def part(lo, hi):
        shards = {}
        for shard, c in cols.items():
            k = c.shape[1]
            shards[shard] = FeatureShard(
                np.repeat(np.arange(hi - lo, dtype=np.int64), k),
                c[lo:hi].reshape(-1).astype(np.int64),
                vals[shard][lo:hi].reshape(-1), dims[shard],
            )
        return GameData(labels=labels[lo:hi], feature_shards=shards,
                        id_tags={t: v[lo:hi] for t, v in id_tags.items()})

    return part(0, n), part(n, total)


def _glmix_estimator(device: str):
    """FE + per_user + per_item, L-BFGS 10 iterations, L2 lambda 1, one
    outer iteration."""
    from photon_ml_tpu_torch.data.random_effect import RandomEffectDataConfiguration
    from photon_ml_tpu_torch.estimators.game import (
        FixedEffectCoordinateConfiguration as FE,
        GameEstimator,
        RandomEffectCoordinateConfiguration as RE,
    )
    from photon_ml_tpu_torch.opt.config import (
        GlmOptimizationConfiguration, OptimizerConfig, RegularizationContext,
    )
    from photon_ml_tpu_torch.types import RegularizationType, TaskType

    opt = GlmOptimizationConfiguration(
        optimizer_config=OptimizerConfig(max_iterations=10),
        regularization=RegularizationContext(RegularizationType.L2),
        regularization_weight=1.0,
    )
    return GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {
            "fixed": FE("global", opt),
            "per_user": RE("per_user", RandomEffectDataConfiguration("userId"), opt),
            "per_item": RE("per_item", RandomEffectDataConfiguration("itemId"), opt),
        },
        update_order=["fixed", "per_user", "per_item"],
        num_outer_iterations=1,
        device=device,
    )


class plain_versions:
    """Within the block, every kernel wrapper of the path computes its plain
    PyTorch version on the card instead of launching its kernel (a
    comparison run; the package has no such switch)."""

    def __enter__(self):
        from photon_ml_tpu_torch.ops import fused_perm, pallas_kernels

        self._saved = [
            (fused_perm, "csr_matvec_f32", fused_perm.csr_matvec_f32),
            (fused_perm, "csc_rmatvec_f32", fused_perm.csc_rmatvec_f32),
            (pallas_kernels, "fused_value_grad_batched_f32",
             pallas_kernels.fused_value_grad_batched_f32),
        ]
        fused_perm.csr_matvec_f32 = (
            lambda row_ptr, col_idx, vals, w, dim: fused_perm.csr_matvec_plain(
                row_ptr, col_idx, vals, w))
        fused_perm.csc_rmatvec_f32 = (
            lambda col_ptr, row_idx, vals, c, n, transform="id", segments=None:
            fused_perm.csc_rmatvec_plain(col_ptr, row_idx, vals, c, transform))
        pallas_kernels.fused_value_grad_batched_f32 = pallas_kernels.fused_value_grad_plain
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)


def profile_device_idle(fn) -> dict:
    """One call of ``fn`` under torch.profiler: the device's busy time (the
    device-side events alone, kernels and copies: a host operator also
    reports the device time of what it launched, so counting both would
    count it twice), its idle share of the call's wall time, and the top
    device consumers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    busy_ms = sum(device_us(e) for e in events) / 1e3
    top = sorted(events, key=device_us, reverse=True)[:6]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
        "device_idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else "not measured",
        "top_device_ms": {e.key[:60]: device_us(e) / 1e3 for e in top if device_us(e) > 0},
    }


def phase_train_full_width(seed: int) -> dict:
    from photon_ml_tpu_torch.losses.pointwise import LogisticLoss
    from photon_ml_tpu_torch.ops import fused_perm, launches, pallas_kernels

    n, n_val, fe_dim, fe_k = 1 << 20, 1 << 18, 1 << 24, 16
    t0 = time.perf_counter()
    train, val = make_glmix_training(seed, n, n_val, fe_dim, fe_k, 65_536, 16_384)
    data_s = time.perf_counter() - t0
    estimator = _glmix_estimator("cuda")
    t0 = time.perf_counter()
    coords = estimator.build_coordinates(train)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    feats = coords["fixed"].data.features
    if not isinstance(feats, fused_perm.FusedSparseFeatures):
        raise AssertionError(f"auto engine picked {type(feats).__name__}, not fused")
    buckets = {cid: [tuple(b.X.shape) for b in coords[cid].dataset.buckets]
               for cid in ("per_user", "per_item")}

    # the main path: counts set to 0 just before, read just after
    launches.reset()
    t0 = time.perf_counter()
    fit = estimator.fit(train, val, coordinates=coords)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = launches.counts()
    missing = [k for k in KERNELS if counts[k] < 1]
    if missing:
        raise AssertionError(f"training did not launch {missing}: {counts}")

    labels = torch.from_numpy(train.labels).cuda()
    before = float(LogisticLoss.value(torch.zeros_like(labels), labels).sum())
    after = fit.objective_history[-1][1]
    if not after < before:
        raise AssertionError(f"training objective did not fall: {before} -> {after}")

    # the same training through the plain versions, on the card
    launches.reset()
    with plain_versions():
        t0 = time.perf_counter()
        plain_fit = estimator.fit(train, val, coordinates=coords)
        torch.cuda.synchronize()
        plain_fit_s = time.perf_counter() - t0
    if any(launches.counts()[k] for k in KERNELS):
        raise AssertionError(f"the plain run launched kernels: {launches.counts()}")
    obj_rel = abs(after - plain_fit.objective_history[-1][1]) / abs(after)
    auc_diff = abs(fit.validation_metric - plain_fit.validation_metric)
    if not (np.isfinite(fit.validation_metric) and obj_rel <= 1e-4 and auc_diff <= 1e-4):
        raise AssertionError(
            f"kernel and plain training differ: objective rel {obj_rel}, AUC {auc_diff}"
        )

    # kernel times at the main path's shapes
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = fit.model.models["fixed"].coefficients.means
    c = torch.randn(n, generator=gen, device="cuda")
    seg = fused_perm.CscSegments.of(feats.col_ptr)
    csr = torch.sparse_csr_tensor(feats.row_ptr, feats.col_idx.long(), feats.vals,
                                  size=(n, feats.dim))
    csr_t = torch.sparse_csr_tensor(feats.col_ptr, feats.row_idx.long(), feats.vals_csc,
                                    size=(feats.dim, n))
    times = {
        "csr_matvec_f32": cuda_ms({
            "kernel": lambda: fused_perm.csr_matvec_f32(
                feats.row_ptr, feats.col_idx, feats.vals, w, feats.dim),
            "plain": lambda: fused_perm.csr_matvec_plain(
                feats.row_ptr, feats.col_idx, feats.vals, w),
            "library": lambda: torch.mv(csr, w),
        }),
        "csc_rmatvec_f32": cuda_ms({
            "kernel": lambda: fused_perm.csc_rmatvec_f32(
                feats.col_ptr, feats.row_idx, feats.vals_csc, c, n, "id", seg),
            "plain": lambda: fused_perm.csc_rmatvec_plain(
                feats.col_ptr, feats.row_idx, feats.vals_csc, c),
            "library": lambda: torch.mv(csr_t, c),
        }),
    }
    bucket = coords["per_user"].dataset.buckets[0]
    E, s, d = bucket.X.shape
    w_re = torch.randn(E, d, generator=gen, device="cuda") * 0.1
    vg_in = (bucket.X, bucket.labels, bucket.offsets, bucket.weights, w_re)

    def library_value_grad():
        z = torch.bmm(bucket.X, w_re.unsqueeze(-1)).squeeze(-1) + bucket.offsets
        pos = bucket.weights > 0
        lw = torch.where(pos, bucket.weights * LogisticLoss.value(z, bucket.labels), 0.0)
        dz = torch.where(pos, bucket.weights * LogisticLoss.d1(z, bucket.labels), 0.0)
        return lw.sum(-1), torch.bmm(dz.unsqueeze(1), bucket.X).squeeze(1), dz.sum(-1)

    times["fused_value_grad_batched_f32"] = cuda_ms({
        "kernel": lambda: pallas_kernels.fused_value_grad_batched_f32(*vg_in, LogisticLoss),
        "plain": lambda: pallas_kernels.fused_value_grad_plain(*vg_in, LogisticLoss),
        "library": library_value_grad,
    })

    # each kernel against its plain version and float64, on the inputs timed
    # above (the main path's shapes)
    rows = torch.repeat_interleave(torch.arange(n, device="cuda"), feats.row_ptr.diff())
    prod = feats.vals.double() * w.double()[feats.col_idx.long()]
    z64 = torch.zeros(n, dtype=torch.float64, device="cuda").index_add_(0, rows, prod)
    row_abs = torch.zeros(n, dtype=torch.float64, device="cuda").index_add_(0, rows, prod.abs())
    g_plain = fused_perm.csc_rmatvec_plain(feats.col_ptr, feats.row_idx, feats.vals_csc, c)
    col_abs = fused_perm.csc_rmatvec_plain(
        feats.col_ptr, feats.row_idx, feats.vals_csc.abs(), c.abs()).double()
    vg_ref, vg_scale = _value_grad_f64(*vg_in, LogisticLoss)
    checks = {
        "csr_matvec_f32": [_compare(
            fused_perm.csr_matvec_f32(feats.row_ptr, feats.col_idx, feats.vals, w, feats.dim),
            fused_perm.csr_matvec_plain(feats.row_ptr, feats.col_idx, feats.vals, w),
            z64, row_abs, feats.row_ptr.diff(), (n,))],
        "csc_rmatvec_f32": [_compare(
            fused_perm.csc_rmatvec_f32(feats.col_ptr, feats.row_idx, feats.vals_csc, c, n,
                                       "id", seg),
            g_plain, g_plain.double(), col_abs, feats.col_ptr.diff(), (feats.dim,))],
        "fused_value_grad_batched_f32": [
            _compare(o, p, r, a, s, o.shape, part=part)
            for part, o, p, r, a in zip(
                ("value", "grad", "csum"),
                pallas_kernels.fused_value_grad_batched_f32(*vg_in, LogisticLoss),
                pallas_kernels.fused_value_grad_plain(*vg_in, LogisticLoss), vg_ref, vg_scale)
        ],
    }
    if not all(case["ok"] for cases in checks.values() for case in cases):
        raise AssertionError(f"kernels disagree with their plain versions at the main "
                             f"path's shapes: {checks}")
    bounds = {
        "csr_matvec_f32": csr_bound_ms(n, feats.nnz, feats.dim),
        "csc_rmatvec_f32": csc_bound_ms(n, feats.nnz, feats.dim),
        "fused_value_grad_batched_f32": value_grad_bound_ms(E, s, d),
    }
    kernels = {
        k: {"launches": counts[k], "ms": times[k]["kernel"], "plain_ms": times[k]["plain"],
            "library_ms": times[k]["library"], "bound_ms": bounds[k][0],
            "bound_by": bounds[k][1]}
        for k in KERNELS
    }
    kernels["fused_value_grad_batched_f32"]["shape"] = [E, s, d]

    # device idle share of one random-effect solve (per_user, warm start)
    re_coord = coords["per_user"]
    residual = torch.zeros(n, device="cuda")
    idle = profile_device_idle(
        lambda: re_coord.update_model_device(fit.model.models["per_user"], residual)
    )
    result = {
        "rows": n, "validation_rows": n_val, "fe_dim": feats.dim, "fe_nnz": feats.nnz,
        "buckets": buckets, "data_s": data_s, "build_coordinates_s": build_s,
        "fit_s": fit_s, "plain_fit_s": plain_fit_s,
        "seconds_per_coordinate": fit.update_seconds,
        "plain_seconds_per_coordinate": plain_fit.update_seconds,
        "objective_before": before, "objective_history": fit.objective_history,
        "plain_objective_history": plain_fit.objective_history,
        "objective_rel_diff_vs_plain": obj_rel,
        "validation_auc": fit.validation_metric,
        "plain_validation_auc": plain_fit.validation_metric,
        "auc_diff_vs_plain": auc_diff,
        "launches": counts, "kernels": kernels, "main_path_kernel_checks": checks,
        "re_solve_profile": idle,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit("train_full_width", **result)
    return result


def ratings_config(root: str) -> str:
    """The ratings fixture's GLMix config (FE with L-BFGS + per_user +
    per_movie), written under ``root``."""
    optimizer = {"optimizer": "LBFGS", "regularization": "L2"}
    cfg = {
        "feature_shards": {
            "global": {"feature_bags": ["features"], "add_intercept": True},
            "per_user": {"feature_bags": ["userFeatures"], "add_intercept": False},
            "per_movie": {"feature_bags": ["movieFeatures"], "add_intercept": False},
        },
        "coordinates": {
            "fixed": {"type": "fixed", "feature_shard": "global",
                      "optimizer": {**optimizer, "regularization_weight": 10.0}},
            "per_user": {"type": "random", "feature_shard": "per_user",
                         "random_effect_type": "userId",
                         "optimizer": {**optimizer, "regularization_weight": 1.0}},
            "per_movie": {"type": "random", "feature_shard": "per_movie",
                          "random_effect_type": "movieId",
                          "optimizer": {**optimizer, "regularization_weight": 1.0}},
        },
        "update_order": ["fixed", "per_user", "per_movie"],
    }
    path = os.path.join(root, "game.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def phase_train_game_cli(seed: int) -> dict:
    from photon_ml_tpu_torch.cli import score_game, train_game
    from photon_ml_tpu_torch.ops import launches

    result = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        config = ratings_config(root)
        for run, device in (("cuda", "cuda"), ("cuda_again", "cuda"), ("cpu", "cpu")):
            argv = [
                "--train-data-dirs", os.path.join(RATINGS, "train"),
                "--validation-data-dirs", os.path.join(RATINGS, "test"),
                "--coordinate-config", config, "--task", "LINEAR_REGRESSION",
                "--output-dir", os.path.join(root, run), "--evaluator", "RMSE",
                "--num-outer-iterations", "2", "--device", device,
            ]
            launches.reset()
            t0 = time.perf_counter()
            fit = train_game.run(train_game.parse_args(argv))
            result[f"{run}_s"] = time.perf_counter() - t0
            result[f"{run}_launches"] = launches.counts()
            result[f"{run}_rmse"] = fit.validation_metric
            result[f"{run}_objectives"] = [v for _, v in fit.objective_history]
        launches.reset()
        rescored = score_game.run(score_game.parse_args([
            "--data-dirs", os.path.join(RATINGS, "test"),
            "--model-dir", os.path.join(root, "cuda", "best"),
            "--output-dir", os.path.join(root, "scores"), "--evaluator", "RMSE",
        ]))
        result["score_game_rmse"] = rescored
        result["score_game_launches"] = launches.counts()
    if result["cuda_launches"]["fused_value_grad_batched_f32"] < 1:
        raise AssertionError(f"train_game on cuda did not launch the RE kernel: {result}")
    for device in ("cuda", "cpu"):
        if not result[f"{device}_rmse"] < 0.45:
            raise AssertionError(f"{device} RMSE {result[f'{device}_rmse']} not under 0.45")
    if abs(result["cuda_rmse"] - result["cpu_rmse"]) > 1e-4:
        raise AssertionError(f"RMSE on cuda and cpu differ: {result}")
    # the sync schedule, and scoring, repeat bitwise on one device
    if (result["cuda_objectives"] != result["cuda_again_objectives"]
            or result["cuda_rmse"] != result["cuda_again_rmse"]):
        raise AssertionError(f"two cuda trainings differ: {result}")
    if abs(rescored - result["cuda_rmse"]) > 1e-5:
        raise AssertionError(f"score_game does not reproduce the RMSE: {result}")
    emit("train_game_cli", **result)
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
    torch.cuda.empty_cache()
    if "train_full_width" in phases:
        results["train_full_width"] = phase_train_full_width(args.seed)
    torch.cuda.empty_cache()
    if "train_game_cli" in phases:
        results["train_game_cli"] = phase_train_game_cli(args.seed)

    # launches and times from the training path, which runs all three
    train = results.get("train_full_width", {}).get("kernels", {})
    errors = results.get("kernel", {}).get("max_abs_err", {})
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": KERNEL_SOURCE[name],
        "replaces": KERNEL_REPLACES[name],
        "launches": train.get(name, {}).get("launches"),
        "max_abs_err": errors.get(name),
        "ms": train.get(name, {}).get("ms"),
        "plain_ms": train.get(name, {}).get("plain_ms"),
        "bound_ms": train.get(name, {}).get("bound_ms"),
        "bound_by": train.get(name, {}).get("bound_by"),
        "library_ms": train.get(name, {}).get("library_ms"),
    } for name in KERNELS]
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
