"""The fused value-and-gradient pass of the random-effect solves, as a CUDA
kernel.

Counterpart of ``photon_ml_tpu/ops/pallas_kernels.py`` (the module keeps the
reference's path so that a reader finds it; it holds CUDA kernels, not
Pallas). The reference's per-entity kernel ``fused_value_grad_single``
(K6, ``_single_kernel``) computes, over one dense block X [s, d] in one pass,
Σ wt·l(z, y), Xᵀ·(wt·l′) and Σ wt·l′ with z = X·w + off, and runs under
``jax.vmap`` over a bucket's entities. Here one launch of
:func:`fused_value_grad_batched_f32` (``csrc/value_grad.cu``) covers the
whole bucket [E, s, d]: persistent CTAs stream tiles of whole entities (or
chunks of rows of one large entity) through a ring of bulk copies into
shared memory, as :func:`entity_tiling` plans.

The reference's blocked kernel ``fused_value_grad`` (K7, ``_kernel``), the
same sums over one dense [n, d] problem of any size in 256-row grid steps,
is :func:`fused_value_grad` here: :func:`fused_value_grad_f32`
(``csrc/value_grad.cu``, persistent CTAs fed full-row tiles through a ring
of bulk copies into shared memory, a deterministic second pass over the
CTAs' partial sums). As in the
reference, no objective routes to it: :func:`fused_value_grad_auto` takes
only the single-block kernel.

On a CPU tensor each wrapper takes the kernels' plain version,
:func:`fused_value_grad_plain`; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import torch

from photon_ml_tpu_torch.losses.pointwise import (
    LogisticLoss,
    PoissonLoss,
    SmoothedHingeLoss,
    SquaredLoss,
)
from photon_ml_tpu_torch.ops import launches
from photon_ml_tpu_torch.utils import cudalib

KERNEL = "fused_value_grad_batched_f32"
KERNEL_BLOCKED = "fused_value_grad_f32"
SOURCE = "value_grad"  # ops/csrc/value_grad.cu
launches.register(KERNEL)
launches.register(KERNEL_BLOCKED)

# the kernel's run-time loss codes
LOSS_CODES = {LogisticLoss: 0, SquaredLoss: 1, PoissonLoss: 2, SmoothedHingeLoss: 3}

# At most this many elements an entity (s·d) go through the fused kernel
# (the reference's routing rule, photon_ml_tpu/ops/pallas_kernels.py:200)
SINGLE_BLOCK_MAX_ELEMENTS = 2_000_000

# A lone [s, d] problem goes through the single-block kernel as a batch of
# one, where the plain maps spread over the card; one CTA streams it, so
# the route pays only up to a size: on an H100 it won up to 2^18 elements
# and lost from about 10^6 (PERF.md), short of the reference's 2 M.
LONE_PROBLEM_MAX_ELEMENTS = 1 << 18

# The batched kernel's rings (csrc/value_grad.cu; the library refuses a
# plan that breaks these): "tiles" slots of TILE_FLOATS floats holding at
# most TILE_MAX_ROWS rows, "rows" slots of CHUNK_FLOATS floats holding at
# most CHUNK_MAX_ROWS rows of at most RING_MAX_COLS columns; constant grids
# of at most TILE_GRID (three an SM of an H100) and RING_GRID (two) CTAs of
# WARPS warps; the "warp" kernel's grid is at most WARP_MAX_BLOCKS blocks
# of 4 entities. The grid changes no bits: an entity is one warp's or one
# CTA's work, whichever CTA takes it.
TILE_FLOATS = 8192
TILE_MAX_ROWS = 1024
CHUNK_FLOATS = 8192
CHUNK_MAX_ROWS = 256
RING_MAX_COLS = 2048
TILE_GRID = 396
RING_GRID = 264
WARPS = 8
WARP_MAX_BLOCKS = 1 << 16
_MODES = {"tiles": 0, "rows": 1, "warp": 2}


@dataclasses.dataclass(frozen=True)
class EntityTiling:
    """How :func:`fused_value_grad_batched_f32` cuts a batch [E, s, d]:
    ``mode`` "tiles" (``per_tile`` whole entities a tile), "rows" (one
    entity a time, ``per_tile`` rows a chunk) or "warp" (a warp an entity,
    ``per_tile`` 0), on ``grid`` CTAs."""

    mode: str
    per_tile: int
    grid: int


def tile_floats(k: int, s: int, d: int) -> int:
    """Floats of a slot that a tile of k entities takes: its spans of X, y,
    off, wt and w, each rounded up to 16 bytes with 16 bytes of room for its
    offset within a 16-byte line (csrc/value_grad.cu ``tile_layout``)."""
    def round4(x):
        return -(-x // 4) * 4
    return round4(k * s * d) + 3 * round4(k * s) + round4(k * d) + 20


def entity_tiling(E: int, s: int, d: int) -> EntityTiling:
    """The batched kernel's plan for [E, s, d]. "tiles": the most entities
    k that fit a tile slot (and TILE_MAX_ROWS rows), rounded down to a
    multiple of the CTA's 8 warps (a warp takes whole entities) when k
    reaches it, else to a multiple of the period that puts every tile's
    start on a 16-byte boundary in X, y, off, wt and w (4 / gcd(4, s),
    4 / gcd(4, d) entities; 8 is a multiple of it) when k reaches that;
    "rows" for an entity too large for a slot: chunks of the most rows, a
    multiple of 4, that fit (at most CHUNK_MAX_ROWS); "warp" for rows wider
    than RING_MAX_COLS (or s = 0, d = 0). The mode depends only on (s, d),
    so an entity's outputs do not depend on E."""
    if s < 1 or d < 1 or d > RING_MAX_COLS:
        return EntityTiling("warp", 0, max(1, min(-(-E // 4), WARP_MAX_BLOCKS)))
    k = min(TILE_MAX_ROWS // s, TILE_FLOATS // (s * d + 3 * s + d))
    while k > 0 and tile_floats(k, s, d) > TILE_FLOATS:
        k -= 1
    if k >= 1:
        period = math.lcm(4 // math.gcd(4, s), 4 // math.gcd(4, d))
        for step in (WARPS, period):
            if k >= step:
                k -= k % step
                break
        return EntityTiling("tiles", k, max(1, min(-(-E // k), TILE_GRID)))
    rows = min(CHUNK_MAX_ROWS, CHUNK_FLOATS // d // 4 * 4)
    return EntityTiling("rows", rows, max(1, min(E, RING_GRID)))


def _library() -> ctypes.CDLL:
    lib = cudalib.load_library(SOURCE)
    lib.fused_value_grad_batched_f32.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 3 + [ctypes.c_int] * 2
        + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
    )
    lib.fused_value_grad_batched_f32.restype = ctypes.c_int
    lib.fused_value_grad_f32.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int64] * 2 + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.fused_value_grad_f32.restype = ctypes.c_int
    lib.fused_value_grad_f32_grid.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.fused_value_grad_f32_grid.restype = ctypes.c_int64
    lib.value_grad_error_string.argtypes = [ctypes.c_int]
    lib.value_grad_error_string.restype = ctypes.c_char_p
    return lib


def _check(kernel, X, y, off, wt, w, kind) -> None:
    """Operand checks: X [*batch, s, d], the row vectors [*batch, s], w
    [*batch, d]; f32, contiguous, on one device."""
    if kind not in LOSS_CODES:
        raise ValueError(f"{kernel}: no kernel loss code for {kind!r}")
    rank = 3 if kernel == KERNEL else 2
    if X.dim() != rank:
        want = "[E, s, d]" if rank == 3 else "[n, d]"
        raise ValueError(f"{kernel}: X must be {want}, got shape {tuple(X.shape)}")
    *batch, s, d = X.shape
    batch = tuple(batch)
    for name, t, shape in (
        ("X", X, (*batch, s, d)), ("labels", y, (*batch, s)), ("offsets", off, (*batch, s)),
        ("weights", wt, (*batch, s)), ("w", w, (*batch, d)),
    ):
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} must be torch.float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if t.device != X.device:
            raise ValueError(
                f"{kernel}: {name} on {t.device}, X on {X.device}; all operands "
                "must share one device"
            )


def fused_value_grad_plain(X, y, off, wt, w, kind) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of both kernels: the same sums, elementwise
    products reduced over the row and column axes, for one problem X [n, d]
    or a batch X [E, s, d]."""
    z = (X * w.unsqueeze(-2)).sum(-1) + off
    pos = wt > 0
    lw = torch.where(pos, wt * kind.value(z, y), torch.zeros_like(z))
    dz = torch.where(pos, wt * kind.d1(z, y), torch.zeros_like(z))
    return lw.sum(-1), (dz.unsqueeze(-1) * X).sum(-2), dz.sum(-1)


def fused_value_grad_batched_f32(X, y, off, wt, w, kind) -> Tuple[torch.Tensor, ...]:
    """Per entity e of X [E, s, d]: (Σ wt·l, Xᵀ·dz, Σ dz) with
    dz = where(wt > 0, wt·l′, 0), z = X·w + off, l = ``kind`` (a
    PointwiseLoss class). Launches the CUDA kernel for CUDA tensors (and
    counts the launch); takes :func:`fused_value_grad_plain` for CPU
    tensors."""
    _check(KERNEL, X, y, off, wt, w, kind)
    if X.device.type == "cpu":
        return fused_value_grad_plain(X, y, off, wt, w, kind)
    if X.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {X.device}")
    lib = _library()
    E, s, d = X.shape
    plan = entity_tiling(E, s, d)
    value = torch.empty(E, dtype=torch.float32, device=X.device)
    grad = torch.empty(E, d, dtype=torch.float32, device=X.device)
    csum = torch.empty(E, dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.fused_value_grad_batched_f32(
            X.data_ptr(), y.data_ptr(), off.data_ptr(), wt.data_ptr(), w.data_ptr(),
            value.data_ptr(), grad.data_ptr(), csum.data_ptr(), E, s, d,
            LOSS_CODES[kind], _MODES[plan.mode], plan.per_tile, plan.grid, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"{KERNEL} launch failed: {lib.value_grad_error_string(rc).decode()} ({rc})"
        )
    launches.record(KERNEL)
    return value, grad, csum


def fused_value_grad_f32(X, y, off, wt, w, kind) -> Tuple[torch.Tensor, ...]:
    """(Σ wt·l, Xᵀ·dz, Σ dz) for one dense problem X [n, d] with
    dz = where(wt > 0, wt·l′, 0), z = X·w + off, l = ``kind``; value and
    csum are 0-d. Launches the CUDA kernel for CUDA tensors (and counts the
    launch); takes :func:`fused_value_grad_plain` for CPU tensors."""
    _check(KERNEL_BLOCKED, X, y, off, wt, w, kind)
    if X.device.type == "cpu":
        return fused_value_grad_plain(X, y, off, wt, w, kind)
    if X.device.type != "cuda":
        raise ValueError(f"{KERNEL_BLOCKED}: unsupported device {X.device}")
    lib = _library()
    n, d = X.shape
    if X.data_ptr() % 16:
        X = X.clone()  # the kernel's bulk tile copies need a 16-byte aligned X
    grid = lib.fused_value_grad_f32_grid(n, d)
    value = torch.empty((), dtype=torch.float32, device=X.device)
    grad = torch.empty(d, dtype=torch.float32, device=X.device)
    csum = torch.empty((), dtype=torch.float32, device=X.device)
    partial_grad = torch.empty(grid, d, dtype=torch.float32, device=X.device)
    partial_sums = torch.empty(2, grid, dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.fused_value_grad_f32(
            X.data_ptr(), y.data_ptr(), off.data_ptr(), wt.data_ptr(), w.data_ptr(),
            value.data_ptr(), grad.data_ptr(), csum.data_ptr(), partial_grad.data_ptr(),
            partial_sums[0].data_ptr(), partial_sums[1].data_ptr(), n, d,
            LOSS_CODES[kind], stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"{KERNEL_BLOCKED} launch failed: {lib.value_grad_error_string(rc).decode()} ({rc})"
        )
    launches.record(KERNEL_BLOCKED)
    return value, grad, csum


def fused_value_grad(matrix, labels, offsets, weights, w, kind=None) -> Tuple[torch.Tensor, ...]:
    """One pass (Σ wᵢ·l, Σ wᵢ·l′·xᵢ, Σ wᵢ·l′) over a dense [n, d] problem:
    the loss sum, the gradient and the coefficient sum that the
    normalization shift needs (the reference's blocked ``fused_value_grad``;
    ``kind`` a PointwiseLoss class, required)."""
    if kind is None:
        raise ValueError("kind (a PointwiseLoss class) is required")
    f32 = [t.to(torch.float32).contiguous() for t in (matrix, labels, offsets, weights, w)]
    return fused_value_grad_f32(*f32, kind)


def fused_value_grad_auto(matrix, labels, offsets, weights, w, kind) -> Optional[tuple]:
    """The objective's entry (the reference's routing rule): a batch of
    dense problems [E, s, d] of at most ``SINGLE_BLOCK_MAX_ELEMENTS``
    elements each, or a lone problem [s, d] of at most
    ``LONE_PROBLEM_MAX_ELEMENTS``, goes through the single-block kernel (a
    lone problem as a batch of one); anything else returns None and the
    caller stays on the plain maps. The blocked kernel is never routed
    here, as in the reference."""
    limit = {2: LONE_PROBLEM_MAX_ELEMENTS, 3: SINGLE_BLOCK_MAX_ELEMENTS}.get(matrix.dim())
    if limit is None or matrix.shape[-2] * matrix.shape[-1] > limit:
        return None
    if matrix.dim() == 3:
        return fused_value_grad_batched_f32(matrix, labels, offsets, weights, w, kind)
    value, grad, csum = fused_value_grad_batched_f32(
        matrix.unsqueeze(0), labels.unsqueeze(0), offsets.unsqueeze(0),
        weights.unsqueeze(0), w.unsqueeze(0), kind,
    )
    return value[0], grad[0], csum[0]
