"""The yardstick's arithmetic: published peaks of one NVIDIA H100, the least
time of each hand-written kernel of the fixed-effect and random-effect
paths at a shape, and the model work of a training job.

Frozen copies of ``chip_smoke.py``'s bound functions (``_bound``,
``csr_bound_ms``, ``csc_bound_ms``, ``value_grad_bound_ms``): each input
byte is counted once and each output byte written once, whatever a kernel
reads again, and the least time is the larger of bytes over the HBM rate
and operations over the f32 rate.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bytes a second, dense float32 FLOP/s
# outside the tensor cores (the kernels here use none)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """Least seconds for ``nbytes`` moved and ``flops`` done on the card."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def csr_matvec_s(n: int, nnz: int, dim: int) -> float:
    """z = X w, X [n, dim] in CSR: row_ptr 8(n+1), col_idx 4 nnz, vals 4 nnz
    and w 4 dim read once, z 4n written once; 2 flops a nonzero."""
    return bound_s(8 * (n + 1) + 8 * nnz + 4 * dim + 4 * n, 2 * nnz)


def csc_rmatvec_s(n: int, nnz: int, dim: int) -> float:
    """g = X^T c: col_ptr 8(dim+1), row_idx 4 nnz, vals 4 nnz and c 4n read
    once, g 4 dim written once; 2 flops a nonzero."""
    return bound_s(8 * (dim + 1) + 8 * nnz + 4 * n + 4 * dim, 2 * nnz)


def value_grad_s(E: int, s: int, d: int) -> float:
    """The batched fused value+gradient pass over E dense [s, d] problems:
    X, y, offsets, weights, w read once and value, gradient, column sums
    written once, 4E(s d + 3s + 2d + 2) bytes; 4 s d flops an entity."""
    return bound_s(4 * E * (s * d + 3 * s + 2 * d + 2), 4 * E * s * d)


def fe_pass_s(n: int, nnz: int, dim: int) -> float:
    """One value-and-gradient pass of the fixed effect: a CSR matvec for the
    margins and a CSC rmatvec for the gradient."""
    return csr_matvec_s(n, nnz, dim) + csc_rmatvec_s(n, nnz, dim)


def model_work_s(fe_passes, re_passes) -> float:
    """Least seconds of a job's model work: ``fe_passes`` is a list of
    (iterations, n, nnz, dim), one value-and-gradient pass an iteration of
    each fixed-effect solve; ``re_passes`` a list of (entity iterations, s,
    d), one pass an entity iteration over its [s, d] block of each bucket."""
    fe = sum(it * fe_pass_s(n, nnz, dim) for it, n, nnz, dim in fe_passes)
    re = sum(it * value_grad_s(1, s, d) for it, s, d in re_passes)
    return fe + re
