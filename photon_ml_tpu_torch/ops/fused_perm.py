"""The large-d sparse fixed-effect engine: CSR and CSC layouts + two
hand-written CUDA kernels.

Counterpart of ``FusedBenesFeatures`` in ``photon_ml_tpu/ops/fused_perm.py``.
The reference routes a gather through a Benes permutation network — with a
hot-column side matrix and a spill side to bound the network's padding —
because the TPU cannot gather; ``fused_execute`` chains three Pallas kernels
(``_descend_call`` → ``_base_call`` → ``_ascend_call``) to compute z = X·w
(matvec configuration) and g = Xᵀ·(t(vals)·c) (rmatvec configuration).
Hopper gathers, so :class:`FusedSparseFeatures` keeps the coalesced COO in
two plain layouts:

- CSR (``row_ptr`` int64 [n+1], ``col_idx`` int32 [nnz], ``vals`` f32
  [nnz]) for :func:`csr_matvec_f32` (``csrc/spmv.cu``, one warp per row);
- CSC (``col_ptr`` int64 [d+1], ``row_idx`` int32 [nnz], ``vals_csc`` f32
  [nnz]) for :func:`csc_rmatvec_f32` (``csrc/spmv_t.cu``, short columns a
  thread each, long columns split into segments a block each, no atomics).

On a CPU tensor each wrapper takes its kernel's plain version
(:func:`csr_matvec_plain`, :func:`csc_rmatvec_plain`); on a CUDA tensor it
launches the kernel or raises. The bf16 payload is not ported yet
(ROADMAP.md, Queue B).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.ops import launches
from photon_ml_tpu_torch.ops.features import coalesce_coo
from photon_ml_tpu_torch.utils import cudalib

KERNEL = "csr_matvec_f32"
SOURCE = "spmv"  # ops/csrc/spmv.cu
launches.register(KERNEL)

KERNEL_T = "csc_rmatvec_f32"
SOURCE_T = "spmv_t"  # ops/csrc/spmv_t.cu
launches.register(KERNEL_T)

# value transforms of the rmatvec configuration (the reference's
# _apply_transform): "id" and "sq" serve the objective, "abs" and "nnz"
# the feature statistics
TRANSFORMS = {"id": 0, "sq": 1, "abs": 2, "nnz": 3}

# columns with more nonzeros than this are summed in segments of at most
# SEGMENT nonzeros, one thread block each (csrc/spmv_t.cu)
SHORT_MAX = 32
SEGMENT = 8192


def _library() -> ctypes.CDLL:
    lib = cudalib.load_library(SOURCE)
    lib.csr_matvec_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_void_p]
    lib.csr_matvec_f32.restype = ctypes.c_int
    lib.spmv_error_string.argtypes = [ctypes.c_int]
    lib.spmv_error_string.restype = ctypes.c_char_p
    return lib


def _library_t() -> ctypes.CDLL:
    lib = cudalib.load_library(SOURCE_T)
    lib.csc_rmatvec_f32.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64]
        + [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_void_p] * 2
        + [ctypes.c_int64, ctypes.c_void_p]
    )
    lib.csc_rmatvec_f32.restype = ctypes.c_int
    lib.spmv_t_error_string.argtypes = [ctypes.c_int]
    lib.spmv_t_error_string.restype = ctypes.c_char_p
    return lib


def _check_compressed(kernel: str, names, ptr, idx, vals, vec, vec_len: int) -> None:
    """Operand checks shared by both kernels: ``ptr`` int64 [m+1], ``idx``
    int32 [nnz], ``vals`` f32 [nnz], the dense operand ``vec`` f32
    [vec_len], all contiguous 1-D tensors on one device."""
    ptr_name, idx_name, vec_name = names
    for name, t, dtype in (
        (ptr_name, ptr, torch.int64),
        (idx_name, idx, torch.int32),
        ("vals", vals, torch.float32),
        (vec_name, vec, torch.float32),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a contiguous 1-D tensor")
        if t.device != vec.device:
            raise ValueError(
                f"{kernel}: {name} on {t.device}, {vec_name} on {vec.device}; all "
                "operands must share one device"
            )
    if vec.numel() != vec_len:
        raise ValueError(
            f"{kernel}: {vec_name} has {vec.numel()} entries, the matrix needs {vec_len}"
        )
    if idx.numel() != vals.numel():
        raise ValueError(f"{kernel}: {idx_name} and vals differ in length")
    if ptr.numel() < 1:
        raise ValueError(f"{kernel}: {ptr_name} needs at least one entry")


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
    _check_compressed(KERNEL, ("row_ptr", "col_idx", "w"), row_ptr, col_idx, vals, w, dim)
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
class CscSegments:
    """Where :func:`csc_rmatvec_f32` splits its work: the columns with more
    than ``SHORT_MAX`` nonzeros (``long_cols`` int32 [L]), cut into
    segments of at most ``SEGMENT`` nonzeros (``seg_begin``/``seg_end``
    int64 [S], positions in the CSC arrays); long column ``l`` owns the
    segments ``seg_ptr[l]:seg_ptr[l+1]`` (int64 [L+1])."""

    long_cols: torch.Tensor
    seg_begin: torch.Tensor
    seg_end: torch.Tensor
    seg_ptr: torch.Tensor

    @classmethod
    def of(cls, col_ptr: torch.Tensor) -> "CscSegments":
        lengths = col_ptr.diff()
        long_cols = torch.nonzero(lengths > SHORT_MAX).flatten()
        long_len = lengths[long_cols]
        nseg = (long_len + SEGMENT - 1) // SEGMENT
        seg_ptr = torch.zeros(long_cols.numel() + 1, dtype=torch.int64, device=col_ptr.device)
        torch.cumsum(nseg, 0, out=seg_ptr[1:])
        owner = torch.repeat_interleave(
            torch.arange(long_cols.numel(), device=col_ptr.device), nseg
        )
        within = torch.arange(owner.numel(), device=col_ptr.device) - seg_ptr[owner]
        seg_begin = col_ptr[long_cols][owner] + within * SEGMENT
        seg_end = torch.minimum(seg_begin + SEGMENT, col_ptr[long_cols + 1][owner])
        return cls(long_cols.to(torch.int32), seg_begin, seg_end, seg_ptr)


def _check_csc(col_ptr, row_idx, vals, c, num_rows: int, transform: str) -> None:
    _check_compressed(KERNEL_T, ("col_ptr", "row_idx", "c"), col_ptr, row_idx, vals, c, num_rows)
    if transform not in TRANSFORMS:
        raise ValueError(f"{KERNEL_T}: unknown value transform {transform!r}")


def _transformed(vals: torch.Tensor, transform: str) -> torch.Tensor:
    if transform == "id":
        return vals
    if transform == "sq":
        return vals * vals
    if transform == "abs":
        return vals.abs()
    return (vals != 0).to(vals.dtype)


def csc_rmatvec_plain(
    col_ptr: torch.Tensor, row_idx: torch.Tensor, vals: torch.Tensor,
    c: torch.Tensor, transform: str = "id",
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: g[j] = Σ_p t(vals[p])·c[row_idx[p]]
    over column j's nonzeros, by ``index_add_``. It accumulates in float64:
    added one at a time into an f32 running sum, the small terms of a long
    column (an intercept holds every row) would be lost against the sum."""
    d = col_ptr.numel() - 1
    col_of_nnz = torch.repeat_interleave(
        torch.arange(d, device=col_ptr.device), col_ptr.diff()
    )
    prod = _transformed(vals, transform).double() * c.double()[row_idx.long()]
    g = torch.zeros(d, dtype=torch.float64, device=c.device)
    return g.index_add_(0, col_of_nnz, prod).float()


def csc_rmatvec_f32(
    col_ptr: torch.Tensor, row_idx: torch.Tensor, vals: torch.Tensor,
    c: torch.Tensor, num_rows: int, transform: str = "id",
    segments: Optional[CscSegments] = None,
) -> torch.Tensor:
    """g = Xᵀ·(t(vals)·c) for the CSC matrix (col_ptr, row_idx, vals) with
    ``num_rows`` rows, t one of :data:`TRANSFORMS`. Launches the CUDA kernel
    for CUDA tensors (and counts the launch); takes
    :func:`csc_rmatvec_plain` for CPU tensors. ``segments`` is the matrix's
    :class:`CscSegments`, built here when not given."""
    _check_csc(col_ptr, row_idx, vals, c, num_rows, transform)
    if c.device.type == "cpu":
        return csc_rmatvec_plain(col_ptr, row_idx, vals, c, transform)
    if c.device.type != "cuda":
        raise ValueError(f"{KERNEL_T}: unsupported device {c.device}")
    seg = segments if segments is not None else CscSegments.of(col_ptr)
    lib = _library_t()
    d = col_ptr.numel() - 1
    g = torch.empty(d, dtype=torch.float32, device=c.device)
    partial = torch.empty(seg.seg_begin.numel(), dtype=torch.float32, device=c.device)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        rc = lib.csc_rmatvec_f32(
            col_ptr.data_ptr(), row_idx.data_ptr(), vals.data_ptr(), c.data_ptr(),
            g.data_ptr(), d, TRANSFORMS[transform], SHORT_MAX,
            seg.seg_begin.data_ptr(), seg.seg_end.data_ptr(), partial.data_ptr(),
            seg.seg_begin.numel(), seg.long_cols.data_ptr(), seg.seg_ptr.data_ptr(),
            seg.long_cols.numel(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"{KERNEL_T} launch failed: {lib.spmv_t_error_string(rc).decode()} ({rc})"
        )
    launches.record(KERNEL_T)
    return g


@dataclasses.dataclass
class FusedSparseFeatures:
    """Sparse [n, d] matrix in CSR and CSC on one device; ``matvec`` runs the
    ``csr_matvec_f32`` kernel on the card, ``rmatvec``/``rmatvec_sq`` the
    ``csc_rmatvec_f32`` kernel.

    The port's counterpart of the reference ``FusedBenesFeatures``: the
    same three maps, without the Benes routing, hot-column split or KP
    spill cap that exist only because the TPU cannot gather.
    """

    row_ptr: torch.Tensor   # [n+1] int64
    col_idx: torch.Tensor   # [nnz] int32
    vals: torch.Tensor      # [nnz] float32, row-major
    col_ptr: torch.Tensor   # [d+1] int64
    row_idx: torch.Tensor   # [nnz] int32
    vals_csc: torch.Tensor  # [nnz] float32, column-major
    num_rows_: int
    num_cols_: int
    segments: Optional[CscSegments] = dataclasses.field(default=None, repr=False)

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
        return self._rmatvec_impl(c, "id")

    def rmatvec_sq(self, c: torch.Tensor) -> torch.Tensor:
        return self._rmatvec_impl(c, "sq")

    def _rmatvec_impl(self, c: torch.Tensor, transform: str) -> torch.Tensor:
        """Xᵀ·c with the stored values elementwise-transformed first
        ("id" / "sq" / "abs" / "nnz", the reference's ``_rmatvec_impl``)."""
        if self.segments is None and self.col_ptr.device.type == "cuda":
            self.segments = CscSegments.of(self.col_ptr)
        return csc_rmatvec_f32(
            self.col_ptr, self.row_idx, self.vals_csc, c, self.num_rows_,
            transform, self.segments,
        )


def from_coo(
    rows, cols, vals, shape, payload_dtype: str = "float32",
    device: DeviceLike = DEFAULT_DEVICE,
) -> FusedSparseFeatures:
    """CSR and CSC layouts of COO triplets on ``device``; duplicate
    (row, col) entries are coalesced by summation, as every reference
    engine does."""
    if payload_dtype != "float32":
        raise NotImplementedError(
            f"payload_dtype={payload_dtype!r}: the bf16 payload of the fused "
            "engine is not ported yet (ROADMAP.md, Queue B)"
        )
    dev = resolve_device(device)
    n, d = int(shape[0]), int(shape[1])
    if d >= 2**31 or n >= 2**31:
        raise ValueError(f"shape {shape} does not fit the kernels' int32 indices")
    rows, cols, vals, counts = coalesce_coo(rows, cols, vals, n, d)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    row_ptr_t = torch.from_numpy(row_ptr).to(dev)
    cols_t = torch.from_numpy(cols).to(dev)
    vals_t = torch.from_numpy(np.ascontiguousarray(vals, dtype=np.float32)).to(dev)
    # the CSC copy, transposed on the device: a stable sort by column keeps
    # row order within each column
    by_col = torch.argsort(cols_t, stable=True)
    row_of_nnz = torch.repeat_interleave(torch.arange(n, device=dev), row_ptr_t.diff())
    col_ptr = torch.zeros(d + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(cols_t, minlength=d), 0, out=col_ptr[1:])
    return FusedSparseFeatures(
        row_ptr=row_ptr_t,
        col_idx=cols_t.to(torch.int32),
        vals=vals_t,
        col_ptr=col_ptr,
        row_idx=row_of_nnz[by_col].to(torch.int32),
        vals_csc=vals_t[by_col],
        num_rows_=n,
        num_cols_=d,
    )
