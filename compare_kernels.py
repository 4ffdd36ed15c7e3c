"""Time the port's redesigned kernels against another commit's, in turns, on
one NVIDIA card.

    git archive <commit> photon_ml_tpu_torch/ops | tar -x -C build/parent
    python3 compare_kernels.py --parent build/parent [--seed 0] [--rounds 2]
    python3 compare_kernels.py --blocks 1,2,3,5,8


Builds the other checkout's ``value_grad.cu``, ``spmv.cu``, ``spmv_t.cu``
and ``permute.cu`` with nvcc into separately named libraries under
``build/compare/``, binds them by their C signatures at that commit (the
batched value+gradient and the CSR matvec before their redesign; the CSC
rmatvec's and the two shuffles' signatures are unchanged), and times each
against this checkout's kernel on the same inputs with chip_smoke.cuda_ms
(one call between two events, and 32 back-to-back calls over 32: device
time), the two taking turns "parent, change, change, parent" in each of
``--rounds`` rounds:

- fused_value_grad_batched_f32 at the random-effect buckets of
  chip_smoke's train_full_width, [65,536, 38, 16] and [16,384, 96, 16]
  (random inputs made as chip_smoke's kernel phase makes them);
- csr_matvec_f32 and csc_rmatvec_f32 on that phase's fixed-effect shard
  (2^20 rows x (2^24 + 1) columns, 16 nonzeros a row + an intercept), and
  csr_matvec_bf16 and csc_rmatvec_bf16 on the rounded set of its bf16
  engine; each CSR kernel on its commit's layout of the same matrix (this
  one's column blocks, the other's row-major CSR);
- the bf16 engine's matvec: this one's single csr_matvec_bf16 pass over
  both entry sets against the other's two passes (csr_matvec_bf16 on the
  rounded set, csr_matvec_f32 on the exact set) and their sum;
- lane_shuffle_f32 at [2^15, 128] and [2^17, 128], sublane_shuffle_f32 at
  [2^15, 128] (R = 2) and [2^17, 128] (R = 8), each through the other
  checkout's ``ops/permute_net.py`` wrapper (loaded from its file, bound to
  its library) and this one's, and as bare ctypes calls with pointers made
  once (the device time alone), outputs bitwise;
- a whole plan of routing's structure (chip_smoke.structured_plan) at
  2^22 and 2^24 slots through the other checkout's ``apply_plan`` (its
  stages one at a time) and this one's (three launches), outputs
  bitwise.

The outputs of the two are compared (the CSC rmatvec bitwise: its
arithmetic did not change; the others within chip_smoke's tolerance).

With ``--blocks`` (and no ``--parent``) it times this checkout's
csr_matvec_f32 and csr_matvec_bf16 on the same shard stored in each given
number of column blocks instead (device time, and the largest difference
from one block).
Prints a JSON line per kernel and the card's name and power limit; exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

import chip_smoke

C_PTR, C_I64, C_INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# the other commit's C signatures (argument types, last the stream)
PARENT_SIGNATURES = {
    "fused_value_grad_batched_f32": [C_PTR] * 8 + [C_I64] * 3 + [C_INT, C_PTR],
    "csr_matvec_f32": [C_PTR] * 5 + [C_I64, C_PTR],
    "csr_matvec_bf16": [C_PTR] * 6 + [C_I64, C_I64, C_PTR],
    "csc_rmatvec_f32": [C_PTR] * 5 + [C_I64, C_I64, C_INT, C_PTR, C_I64, C_I64] + [C_PTR] * 3,
    "csc_rmatvec_bf16": [C_PTR] * 5 + [C_I64, C_I64, C_INT, C_PTR, C_I64, C_I64] + [C_PTR] * 3,
    "lane_shuffle_f32": [C_PTR] * 3 + [C_I64, C_PTR],
    "sublane_shuffle_f32": [C_PTR] * 3 + [C_I64, C_INT, C_PTR],
}
LIBRARY_OF = {"fused": "value_grad", "csr": "spmv", "csc": "spmv_t", "lane": "permute",
              "sublane": "permute"}


def build_parent(parent: str) -> dict:
    """The other checkout's kernel libraries, built together."""
    from photon_ml_tpu_torch.utils import cudalib

    csrc = os.path.join(parent, "photon_ml_tpu_torch", "ops", "csrc")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "compare")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in ("value_grad", "spmv", "spmv_t", "permute"):
        lib = os.path.join(out_dir, f"lib{name}-parent.so")
        cmd = [cudalib.find_nvcc(), *cudalib.NVCC_FLAGS, "-I", csrc, "-o", lib,
               os.path.join(csrc, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{out}")
        libs[name] = ctypes.CDLL(lib)
    fns = {}
    for entry, argtypes in PARENT_SIGNATURES.items():
        fn = getattr(libs[LIBRARY_OF[entry.split("_")[0]]], entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[entry] = fn
    libs["permute"].permute_error_string.argtypes = [C_INT]
    libs["permute"].permute_error_string.restype = ctypes.c_char_p
    fns["permute_library"] = libs["permute"]
    return fns


def parent_permute_net(parent: str, lib: ctypes.CDLL):
    """The other checkout's ``ops/permute_net.py``, loaded from its file as
    a module of its own and bound to its own kernel library."""
    import importlib.util

    path = os.path.join(parent, "photon_ml_tpu_torch", "ops", "permute_net.py")
    spec = importlib.util.spec_from_file_location("parent_permute_net", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses look their module up
    spec.loader.exec_module(module)
    module._library = lambda: lib
    return module


def compare_shuffles(parent: dict, parent_pn, gen, rounds: int) -> list:
    """The standalone shuffles and whole plans, the other checkout's
    against this one's, outputs bitwise."""
    from photon_ml_tpu_torch.ops import permute_net

    out = []
    for m, rows in ((1 << 15, 0), (1 << 17, 0), (1 << 15, 2), (1 << 17, 8)):
        v = torch.randn(m, 128, generator=gen, device="cuda")
        idx = torch.randint(0, rows or 128, (m, 128), generator=gen, device="cuda").to(
            torch.int8)
        dst = torch.empty_like(v)
        st = _stream()
        if rows == 0:
            name = "lane_shuffle_f32"
            old, new = (lambda: parent_pn.lane_shuffle_f32(v, idx),
                        lambda: permute_net.lane_shuffle_f32(v, idx))
            args = (v.data_ptr(), idx.data_ptr(), dst.data_ptr(), m)
        else:
            name = "sublane_shuffle_f32"
            old, new = (lambda: parent_pn.sublane_shuffle_f32(v, idx, rows),
                        lambda: permute_net.sublane_shuffle_f32(v, idx, rows))
            args = (v.data_ptr(), idx.data_ptr(), dst.data_ptr(), m, rows)
        fn_old, fn_new = parent[name], getattr(permute_net._library(), name)
        entry = {"kernel": name, "m": m, "rows": rows,
                 "bitwise_equal": bool(torch.equal(old(), new())),
                 "bound_ms": chip_smoke.shuffle_bound_ms(m)[0],
                 "turns": turns({"parent": old, "change": new,
                                 "parent_bare": lambda: fn_old(*args, st),
                                 "change_bare": lambda: fn_new(*args, st)}, rounds)}
        if not entry["bitwise_equal"]:
            raise AssertionError(f"{name} changed its output: {entry}")
        out.append(entry)
        print(json.dumps(entry), flush=True)
    for log_size in (22, 24):
        plan = chip_smoke.structured_plan(1 << log_size, log_size)
        old_plan = parent_pn.device_plan(plan, "cuda")
        new_plan = permute_net.device_plan(plan, "cuda")
        x = torch.randn(1 << log_size, generator=gen, device="cuda")
        old = lambda: parent_pn.apply_plan(old_plan, x)  # noqa: E731
        new = lambda: permute_net.apply_plan(new_plan, x)  # noqa: E731
        entry = {"kernel": "apply_plan", "size": 1 << log_size,
                 "bitwise_equal": bool(torch.equal(old(), new())),
                 "host_us": {"parent": chip_smoke.host_us(old, n=50),
                             "change": chip_smoke.host_us(new, n=50)},
                 "turns": turns({"parent": old, "change": new}, rounds)}
        if not entry["bitwise_equal"]:
            raise AssertionError(f"the plan changed its output: {entry}")
        out.append(entry)
        print(json.dumps(entry), flush=True)
        del old_plan, new_plan, x
        torch.cuda.empty_cache()
    return out


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _call(fn, *args) -> None:
    rc = fn(*args, _stream())
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed ({rc})")


def parent_value_grad(fn, X, y, off, wt, w):
    E, s, d = X.shape
    value = torch.empty(E, device="cuda")
    grad = torch.empty(E, d, device="cuda")
    csum = torch.empty(E, device="cuda")
    _call(fn, X.data_ptr(), y.data_ptr(), off.data_ptr(), wt.data_ptr(), w.data_ptr(),
          value.data_ptr(), grad.data_ptr(), csum.data_ptr(), E, s, d, 0)
    return value, grad, csum


def parent_csr(fn, csr, w, bf16: bool):
    """The other commit's CSR kernel on a row-major CSR (row_ptr, col_idx,
    vals)."""
    row_ptr, col_idx, vals = csr
    n = row_ptr.numel() - 1
    z = torch.empty(n, device="cuda")
    if bf16:
        w_bf16 = torch.empty(w.numel(), dtype=torch.bfloat16, device="cuda")
        _call(fn, row_ptr.data_ptr(), col_idx.data_ptr(), vals.data_ptr(), w.data_ptr(),
              w_bf16.data_ptr(), z.data_ptr(), n, w.numel())
    else:
        _call(fn, row_ptr.data_ptr(), col_idx.data_ptr(), vals.data_ptr(), w.data_ptr(),
              z.data_ptr(), n)
    return z


def parent_csc(fn, feats, c, split):
    from photon_ml_tpu_torch.ops import fused_perm

    ctas = split.shape[1] - 1
    g = torch.empty(feats.dim, device="cuda")
    keys = torch.empty(2 * ctas, dtype=torch.int32, device="cuda")
    sums = torch.empty(2 * ctas, device="cuda")
    _call(fn, feats.col_ptr.data_ptr(), feats.row_idx.data_ptr(), feats.vals_csc.data_ptr(),
          c.data_ptr(), g.data_ptr(), feats.dim, feats.row_idx.numel(), 0, split.data_ptr(),
          ctas, fused_perm.MERGE_ITEMS, keys.data_ptr(), sums.data_ptr())
    return g


def rounded_set(feats):
    """An f32-layout engine of a bf16 engine's rounded entries (those its
    CSR copy stores with their column, not ~col)."""
    from photon_ml_tpu_torch.ops import fused_perm

    row_ptr, col_idx, vals = chip_smoke.row_major_csr(feats)
    keep = col_idx >= 0
    rows = torch.repeat_interleave(torch.arange(feats.num_rows, device=col_idx.device),
                                   row_ptr.diff())
    return fused_perm.from_coo(rows[keep].cpu().numpy(), col_idx[keep].cpu().numpy(),
                               vals[keep].cpu().numpy(), (feats.num_rows, feats.dim),
                               device=col_idx.device)


def column_blocks(row_major, dim: int, blocks: int) -> tuple:
    """A row-major CSR (row_ptr, col_idx, vals) stored in ``blocks`` column
    blocks, as fused_perm.from_coo stores a wide matrix."""
    row_ptr, col_idx, vals = row_major
    n = row_ptr.numel() - 1
    rows = torch.repeat_interleave(torch.arange(n, device=col_idx.device), row_ptr.diff())
    block = torch.where(col_idx < 0, ~col_idx, col_idx).long() // -(-dim // blocks)
    order = torch.argsort(block, stable=True)
    ptr = torch.zeros(blocks * n + 1, dtype=torch.int64, device=col_idx.device)
    ptr[1:] = torch.cumsum(torch.bincount(block * n + rows, minlength=blocks * n), 0)
    return ptr, col_idx[order].contiguous(), vals[order].contiguous()


def sweep_blocks(shard, n: int, blocks_list, gen) -> None:
    """csr_matvec_f32 and csr_matvec_bf16 on the shard's f32 and bf16
    engines stored in each number of column blocks."""
    from photon_ml_tpu_torch.ops import fused_perm

    for dtype, kernel in (("float32", fused_perm.csr_matvec_f32),
                          ("bfloat16", fused_perm.csr_matvec_bf16)):
        feats = fused_perm.from_coo(shard.rows, shard.cols, shard.vals, (n, shard.dim),
                                    payload_dtype=dtype, device="cuda")
        w = torch.randn(feats.dim, generator=gen, device="cuda") * 0.1
        row_major = chip_smoke.row_major_csr(feats)
        entry, ref = {"kernel": kernel.__name__, "nnz": feats.vals.numel()}, None
        for blocks in blocks_list:
            ptr, col_idx, vals = column_blocks(row_major, feats.dim, blocks)
            split = fused_perm.merge_path_split(ptr, col_idx.numel())
            fn = lambda: kernel(ptr, col_idx, vals, w, feats.dim, split, blocks)  # noqa: E731
            z = fn()
            ref = z if ref is None else ref
            entry[f"blocks_{blocks}"] = {"device_ms": chip_smoke.cuda_ms({"k": fn})["k_device"],
                                         "max_abs_diff": float((z - ref).abs().max())}
        print(json.dumps(entry), flush=True)
        del feats
        torch.cuda.empty_cache()


def turns(fns: dict, rounds: int) -> list:
    """``rounds`` runs of chip_smoke.cuda_ms over the functions (each run
    in the order a b b a)."""
    return [chip_smoke.cuda_ms(fns) for _ in range(rounds)]


def close(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max(1, max |b|)."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", help="checkout of the other commit")
    p.add_argument("--blocks", help="comma list of column-block counts to time instead")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--shuffles-only", action="store_true",
                   help="with --parent: only the shuffles and whole plans")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: no card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from photon_ml_tpu_torch.losses.pointwise import LogisticLoss
    from photon_ml_tpu_torch.ops import fused_perm, pallas_kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n, fe_dim = 1 << 20, 1 << 24
    if args.blocks:
        train, _ = chip_smoke.make_glmix_training(args.seed, n, 1 << 10, fe_dim, 16, 65_536,
                                                  16_384)
        sweep_blocks(train.feature_shards["global"], n,
                     [int(b) for b in args.blocks.split(",")], gen)
        print(chip_smoke.nvidia_smi(), flush=True)
        return 0
    if not args.parent:
        p.error("give --parent (or --blocks)")
    parent = build_parent(args.parent)
    out = compare_shuffles(parent, parent_permute_net(args.parent, parent["permute_library"]),
                           gen, args.rounds)
    if args.shuffles_only:
        print(chip_smoke.nvidia_smi(), flush=True)
        return 0

    for E, s, d in ((65_536, 38, 16), (16_384, 96, 16)):
        inputs = chip_smoke._value_grad_inputs(E, s, d, gen, dev)
        old = parent_value_grad(parent["fused_value_grad_batched_f32"], *inputs)
        new = pallas_kernels.fused_value_grad_batched_f32(*inputs, LogisticLoss)
        ms = turns({
            "parent": lambda: parent_value_grad(parent["fused_value_grad_batched_f32"], *inputs),
            "change": lambda: pallas_kernels.fused_value_grad_batched_f32(*inputs, LogisticLoss),
        }, args.rounds)
        out.append({"kernel": "fused_value_grad_batched_f32", "shape": [E, s, d],
                    "rel_diff": max(close(a, b) for a, b in zip(new, old)),
                    "bound_ms": chip_smoke.value_grad_bound_ms(E, s, d)[0], "turns": ms})
        print(json.dumps(out[-1]), flush=True)
        del inputs, old, new

    train, _ = chip_smoke.make_glmix_training(args.seed, n, 1 << 10, fe_dim, 16, 65_536, 16_384)
    shard = train.feature_shards["global"]
    for dtype in ("float32", "bfloat16"):
        feats = fused_perm.from_coo(shard.rows, shard.cols, shard.vals, (n, shard.dim),
                                    payload_dtype=dtype, device="cuda")
        bf16 = dtype == "bfloat16"
        suffix = "bf16" if bf16 else "f32"
        w = torch.randn(feats.dim, generator=gen, device=dev) * 0.1
        c = torch.randn(n, generator=gen, device=dev)
        # the CSR kernels on the rounded set alone (the bf16 engine's CSR
        # copy holds its exact set too), each on its commit's layout
        csr = rounded_set(feats) if bf16 else feats
        nnz, csc_nnz = csr.col_idx.numel(), feats.row_idx.numel()
        row_split = fused_perm.merge_path_split(csr.row_ptr, nnz)
        split = fused_perm.merge_path_split(feats.col_ptr, csc_nnz)
        csr_fn = fused_perm.csr_matvec_bf16 if bf16 else fused_perm.csr_matvec_f32
        csc_fn = fused_perm.csc_rmatvec_bf16 if bf16 else fused_perm.csc_rmatvec_f32
        csr_new = lambda: csr_fn(csr.row_ptr, csr.col_idx, csr.vals, w,  # noqa: E731
                                 csr.dim, row_split, csr.row_blocks)
        row_major = chip_smoke.row_major_csr(csr)  # the parent's layout
        csr_old = lambda: parent_csr(parent[f"csr_matvec_{suffix}"], row_major, w,  # noqa: E731
                                     bf16)
        csc_new = lambda: csc_fn(feats.col_ptr, feats.row_idx, feats.vals_csc, c, n,  # noqa: E731
                                 "id", split)
        csc_old = lambda: parent_csc(parent[f"csc_rmatvec_{suffix}"], feats, c, split)  # noqa: E731
        pairs = [
            (f"csr_matvec_{suffix}", nnz, csr_new, csr_old,
             chip_smoke.csr_bound_ms(n, nnz, feats.dim)),
            (f"csc_rmatvec_{suffix}", csc_nnz, csc_new, csc_old,
             chip_smoke.csc_bound_ms(n, csc_nnz, feats.dim)),
        ]
        if bf16:
            # the engine's matvec: one pass over both sets here, the
            # parent's rounded-set kernel, its f32 kernel on the exact set
            # and the sum
            exact_rm = chip_smoke.row_major_csr(feats.exact)
            pairs.append(("bf16_engine_matvec", feats.vals.numel(), lambda: feats.matvec(w),
                          lambda: parent_csr(parent["csr_matvec_bf16"], row_major, w, True)
                          + parent_csr(parent["csr_matvec_f32"], exact_rm, w, False),
                          chip_smoke.csr_bound_ms(n, feats.vals.numel(), feats.dim)))
        for name, count, new, old, bound in pairs:
            a, b = new(), old()
            entry = {"kernel": name, "nnz": count, "rel_diff": close(a, b),
                     "bitwise_equal": bool(torch.equal(a, b)), "bound_ms": bound[0],
                     "turns": turns({"parent": old, "change": new}, args.rounds)}
            if name.startswith("csc") and not entry["bitwise_equal"]:
                raise AssertionError(f"{name} changed its bits: {entry}")
            if entry["rel_diff"] > 1e-5:
                raise AssertionError(f"{name} disagrees with the parent's: {entry}")
            out.append(entry)
            print(json.dumps(entry), flush=True)
        del feats, csr
        torch.cuda.empty_cache()
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
