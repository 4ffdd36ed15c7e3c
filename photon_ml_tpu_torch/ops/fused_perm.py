"""The large-d sparse fixed-effect engine: CSR layout + a hand-written CUDA
matvec.

Counterpart of ``FusedBenesFeatures`` in ``photon_ml_tpu/ops/fused_perm.py``.
The reference routes a gather through a Benes permutation network — with a
hot-column side matrix and a spill side to bound the network's padding —
because the TPU cannot gather; ``fused_execute`` chains three Pallas kernels
(``_descend_call`` → ``_base_call`` → ``_ascend_call``) to compute
z = X·w. Hopper gathers, so :class:`FusedSparseFeatures` keeps a plain CSR
layout of the coalesced COO (``row_ptr`` int64 [n+1], ``col_idx`` int32
[nnz], ``vals`` f32 [nnz]) and :func:`csr_matvec_f32` computes the same
composite function in one kernel (``csrc/spmv.cu``, one warp per row).

On a CPU tensor the wrapper takes the kernel's plain version,
:func:`csr_matvec_plain`; on a CUDA tensor it launches the kernel or raises.
The transposed maps and the bf16 payload belong to the training slice and
raise here.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.ops import launches
from photon_ml_tpu_torch.ops.features import coalesce_coo
from photon_ml_tpu_torch.utils import cudalib

KERNEL = "csr_matvec_f32"
SOURCE = "spmv"  # ops/csrc/spmv.cu
launches.register(KERNEL)

_TRAINING_SLICE = (
    "belongs to the training slice of the port (ROADMAP.md, Queue A item 1 "
    "and Queue B: the rmatvec configuration of K1/K3)"
)


def _library() -> ctypes.CDLL:
    lib = cudalib.load_library(SOURCE)
    lib.csr_matvec_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_void_p]
    lib.csr_matvec_f32.restype = ctypes.c_int
    lib.spmv_error_string.argtypes = [ctypes.c_int]
    lib.spmv_error_string.restype = ctypes.c_char_p
    return lib


def _check_csr(row_ptr, col_idx, vals, w, dim: int) -> None:
    for name, t, dtype in (
        ("row_ptr", row_ptr, torch.int64),
        ("col_idx", col_idx, torch.int32),
        ("vals", vals, torch.float32),
        ("w", w, torch.float32),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{KERNEL}: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{KERNEL}: {name} must be a contiguous 1-D tensor")
        if t.device != w.device:
            raise ValueError(
                f"{KERNEL}: {name} on {t.device}, w on {w.device}; all operands "
                "must share one device"
            )
    if w.numel() != dim:
        raise ValueError(f"{KERNEL}: w has {w.numel()} entries, matrix has {dim} columns")
    if col_idx.numel() != vals.numel():
        raise ValueError(f"{KERNEL}: col_idx and vals differ in length")
    if row_ptr.numel() < 1:
        raise ValueError(f"{KERNEL}: row_ptr needs n+1 >= 1 entries")


def csr_matvec_plain(
    row_ptr: torch.Tensor, col_idx: torch.Tensor, vals: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: z[r] = Σ_p vals[p]·w[col_idx[p]]
    over row r's nonzeros, by ``index_add_``."""
    n = row_ptr.numel() - 1
    row_of_nnz = torch.repeat_interleave(
        torch.arange(n, device=row_ptr.device), row_ptr.diff()
    )
    z = torch.zeros(n, dtype=torch.float32, device=w.device)
    return z.index_add_(0, row_of_nnz, vals * w[col_idx.long()])


def csr_matvec_f32(
    row_ptr: torch.Tensor, col_idx: torch.Tensor, vals: torch.Tensor,
    w: torch.Tensor, dim: int,
) -> torch.Tensor:
    """z = X·w for the CSR matrix (row_ptr, col_idx, vals) with ``dim``
    columns. Launches the CUDA kernel for CUDA tensors (and counts the
    launch); takes :func:`csr_matvec_plain` for CPU tensors."""
    _check_csr(row_ptr, col_idx, vals, w, dim)
    if w.device.type == "cpu":
        return csr_matvec_plain(row_ptr, col_idx, vals, w)
    if w.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {w.device}")
    lib = _library()
    n = row_ptr.numel() - 1
    z = torch.empty(n, dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = lib.csr_matvec_f32(
            row_ptr.data_ptr(), col_idx.data_ptr(), vals.data_ptr(),
            w.data_ptr(), z.data_ptr(), n, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"{KERNEL} launch failed: {lib.spmv_error_string(rc).decode()} ({rc})"
        )
    launches.record(KERNEL)
    return z


@dataclasses.dataclass
class FusedSparseFeatures:
    """Sparse [n, d] matrix in CSR on one device; ``matvec`` runs the
    ``csr_matvec_f32`` kernel on the card.

    The port's counterpart of the reference ``FusedBenesFeatures``: same
    margins z = X·w, without the Benes routing, hot-column split or KP spill
    cap that exist only because the TPU cannot gather.
    """

    row_ptr: torch.Tensor   # [n+1] int64
    col_idx: torch.Tensor   # [nnz] int32
    vals: torch.Tensor      # [nnz] float32
    num_rows_: int
    num_cols_: int

    @property
    def num_rows(self) -> int:
        return self.num_rows_

    @property
    def dim(self) -> int:
        return self.num_cols_

    @property
    def nnz(self) -> int:
        return self.vals.numel()

    def matvec(self, w: torch.Tensor) -> torch.Tensor:
        return csr_matvec_f32(self.row_ptr, self.col_idx, self.vals, w, self.num_cols_)

    def rmatvec(self, c: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(f"FusedSparseFeatures.rmatvec {_TRAINING_SLICE}")

    def rmatvec_sq(self, c: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(f"FusedSparseFeatures.rmatvec_sq {_TRAINING_SLICE}")


def from_coo(
    rows, cols, vals, shape, payload_dtype: str = "float32",
    device: DeviceLike = DEFAULT_DEVICE,
) -> FusedSparseFeatures:
    """CSR layout of COO triplets on ``device``; duplicate (row, col)
    entries are coalesced by summation, as every reference engine does."""
    if payload_dtype != "float32":
        raise NotImplementedError(f"payload_dtype={payload_dtype!r} {_TRAINING_SLICE}")
    dev = resolve_device(device)
    n, d = int(shape[0]), int(shape[1])
    if d >= 2**31:
        raise ValueError(f"dim {d} does not fit the kernel's int32 column index")
    rows, cols, vals, counts = coalesce_coo(rows, cols, vals, n, d)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return FusedSparseFeatures(
        row_ptr=torch.from_numpy(row_ptr).to(dev),
        col_idx=torch.from_numpy(cols.astype(np.int32)).to(dev),
        vals=torch.from_numpy(np.ascontiguousarray(vals, dtype=np.float32)).to(dev),
        num_rows_=n,
        num_cols_=d,
    )
