"""The fused value-and-gradient pass of the random-effect solves, as a CUDA
kernel.

Counterpart of ``photon_ml_tpu/ops/pallas_kernels.py`` (the module keeps the
reference's path so that a reader finds it; it holds CUDA kernels, not
Pallas). The reference's per-entity kernel ``fused_value_grad_single``
(K6, ``_single_kernel``) computes, over one dense block X [s, d] in one pass,
Σ wt·l(z, y), Xᵀ·(wt·l′) and Σ wt·l′ with z = X·w + off, and runs under
``jax.vmap`` over a bucket's entities. Here one launch of
:func:`fused_value_grad_batched_f32` (``csrc/value_grad.cu``, one warp an
entity) covers the whole bucket [E, s, d].

On a CPU tensor the wrapper takes the kernel's plain version,
:func:`fused_value_grad_plain`; on a CUDA tensor it launches the kernel or
raises. The reference's blocked multi-row kernel ``fused_value_grad`` (K7)
is not on the training path and is not ported yet (ROADMAP.md, Queue B).
"""

from __future__ import annotations

import ctypes
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
SOURCE = "value_grad"  # ops/csrc/value_grad.cu
launches.register(KERNEL)

# the kernel's run-time loss codes
LOSS_CODES = {LogisticLoss: 0, SquaredLoss: 1, PoissonLoss: 2, SmoothedHingeLoss: 3}

# At most this many elements an entity (s·d) go through the fused kernel
# (the reference's routing rule, photon_ml_tpu/ops/pallas_kernels.py:200)
SINGLE_BLOCK_MAX_ELEMENTS = 2_000_000


def _library() -> ctypes.CDLL:
    lib = cudalib.load_library(SOURCE)
    lib.fused_value_grad_batched_f32.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.fused_value_grad_batched_f32.restype = ctypes.c_int
    lib.value_grad_error_string.argtypes = [ctypes.c_int]
    lib.value_grad_error_string.restype = ctypes.c_char_p
    return lib


def _check(X, y, off, wt, w, kind) -> None:
    if kind not in LOSS_CODES:
        raise ValueError(f"{KERNEL}: no kernel loss code for {kind!r}")
    if X.dim() != 3:
        raise ValueError(f"{KERNEL}: X must be [E, s, d], got shape {tuple(X.shape)}")
    E, s, d = X.shape
    for name, t, shape in (
        ("X", X, (E, s, d)), ("labels", y, (E, s)), ("offsets", off, (E, s)),
        ("weights", wt, (E, s)), ("w", w, (E, d)),
    ):
        if t.dtype != torch.float32:
            raise TypeError(f"{KERNEL}: {name} must be torch.float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{KERNEL}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{KERNEL}: {name} must be contiguous")
        if t.device != X.device:
            raise ValueError(
                f"{KERNEL}: {name} on {t.device}, X on {X.device}; all operands "
                "must share one device"
            )


def fused_value_grad_plain(X, y, off, wt, w, kind) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel: the same sums, elementwise
    products reduced over the row and column axes."""
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
    _check(X, y, off, wt, w, kind)
    if X.device.type == "cpu":
        return fused_value_grad_plain(X, y, off, wt, w, kind)
    if X.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {X.device}")
    lib = _library()
    E, s, d = X.shape
    value = torch.empty(E, dtype=torch.float32, device=X.device)
    grad = torch.empty(E, d, dtype=torch.float32, device=X.device)
    csum = torch.empty(E, dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.fused_value_grad_batched_f32(
            X.data_ptr(), y.data_ptr(), off.data_ptr(), wt.data_ptr(), w.data_ptr(),
            value.data_ptr(), grad.data_ptr(), csum.data_ptr(), E, s, d,
            LOSS_CODES[kind], stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"{KERNEL} launch failed: {lib.value_grad_error_string(rc).decode()} ({rc})"
        )
    launches.record(KERNEL)
    return value, grad, csum


def fused_value_grad_auto(matrix, labels, offsets, weights, w, kind) -> Optional[tuple]:
    """The objective's entry (the reference's routing rule): a batch of
    dense problems whose entities hold at most ``SINGLE_BLOCK_MAX_ELEMENTS``
    elements each goes through the fused kernel; anything else returns None
    and the caller stays on the plain maps."""
    if matrix.dim() != 3 or matrix.shape[1] * matrix.shape[2] > SINGLE_BLOCK_MAX_ELEMENTS:
        return None
    return fused_value_grad_batched_f32(matrix, labels, offsets, weights, w, kind)
