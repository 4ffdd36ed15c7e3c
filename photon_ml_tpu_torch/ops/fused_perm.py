"""The large-d sparse fixed-effect engine: CSR and CSC layouts + four
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
  [nnz]) for :func:`csr_matvec_f32` (``csrc/spmv.cu``);
- CSC (``col_ptr`` int64 [d+1], ``row_idx`` int32 [nnz], ``vals_csc`` f32
  [nnz]) for :func:`csc_rmatvec_f32` (``csrc/spmv_t.cu``).

Both kernels are one merge path (``csrc/merge_path.cuh``): the row (or
column) ends and the nonzeros cut into equal shares
(:func:`merge_path_split`, cached on the matrix), a fixed-order segmented
reduction in each share, no atomics.

The reference's bfloat16 payload (``from_coo(payload_dtype="bfloat16")``)
rounds each network input once: the broadcast coefficient bf16(w[col]) in
the matvec, the product bf16(t(vals)·c[row]) in the rmatvec; stored values
and sums stay f32. Only the entries that its layout routes through the
network round — its hot columns and each block's spill stay exact — so the
port builds the same partition (``sparse_perm.fused_payload_partition``)
and keeps two entry sets: the rounded set, evaluated by
:func:`csc_rmatvec_bf16`, and the exact set, an f32 engine of its own in
``exact``. The matvec takes both in one :func:`csr_matvec_bf16` pass over
a CSR copy of every entry, an exact entry's column stored as ~col.

On a CPU tensor each wrapper takes its kernel's plain version
(:func:`csr_matvec_plain`, :func:`csc_rmatvec_plain`,
:func:`csr_matvec_bf16_plain`, :func:`csc_rmatvec_bf16_plain`); on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.ops import launches, sparse_perm
from photon_ml_tpu_torch.ops.features import coalesce_coo, scatter_add
from photon_ml_tpu_torch.utils import cudalib

KERNEL = "csr_matvec_f32"
KERNEL_BF16 = "csr_matvec_bf16"
SOURCE = "spmv"  # ops/csrc/spmv.cu
launches.register(KERNEL)
launches.register(KERNEL_BF16)

KERNEL_T = "csc_rmatvec_f32"
KERNEL_T_BF16 = "csc_rmatvec_bf16"
SOURCE_T = "spmv_t"  # ops/csrc/spmv_t.cu
launches.register(KERNEL_T)
launches.register(KERNEL_T_BF16)

PAYLOAD_DTYPES = ("float32", "bfloat16")

# value transforms of the rmatvec configuration (the reference's
# _apply_transform): "id" and "sq" serve the objective, "abs" and "nnz"
# the feature statistics
TRANSFORMS = {"id": 0, "sq": 1, "abs": 2, "nnz": 3}

# The CSR copy is cut into column blocks of at most this many bytes of an
# f32 w, stored one after another (each a CSR of all the rows): the
# matvec's gathers of w then stay within a slice that L2 (50 MB on an H100)
# holds while the CTAs walk that block (PERF.md: the gather of a 64 MB w
# cost more than the rest of the kernel). A block adds a segment end a row
# to the merge path, so a matrix of fewer than CSR_BLOCK_MIN_ROW_NNZ
# nonzeros a row stays one block (the bf16 engine's exact set: 2.7 a row).
CSR_BLOCK_BYTES = 16 << 20
CSR_BLOCK_MIN_ROW_NNZ = 8

# items of the merged list (segment ends + nonzeros) one CTA of the
# merge-path kernels takes (csrc/merge_path.cuh kItems; the library checks
# it)
MERGE_ITEMS = 2048


def _library() -> ctypes.CDLL:
    lib = cudalib.load_library(SOURCE)
    for entry in (KERNEL, KERNEL_BF16):
        fn = getattr(lib, entry)
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
            + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 3
        )
        fn.restype = ctypes.c_int
    lib.spmv_error_string.argtypes = [ctypes.c_int]
    lib.spmv_error_string.restype = ctypes.c_char_p
    return lib


def _library_t() -> ctypes.CDLL:
    lib = cudalib.load_library(SOURCE_T)
    for entry in (KERNEL_T, KERNEL_T_BF16):
        fn = getattr(lib, entry)
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2 + [ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 3
        )
        fn.restype = ctypes.c_int
    lib.spmv_t_error_string.argtypes = [ctypes.c_int]
    lib.spmv_t_error_string.restype = ctypes.c_char_p
    return lib


def _launch(kernel: str, entry, error_string, device: torch.device, *args) -> None:
    """Call a library entry with PyTorch's current stream on ``device`` as
    its last argument; raise on a non-zero code, count the launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = entry(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: {error_string(rc).decode()} ({rc})")
    launches.record(kernel)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest, ties to even) and back to f32."""
    return x.to(torch.bfloat16).float()


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


def csr_blocks(dim: int, nnz: int, n: int) -> int:
    """Column blocks of the CSR copy of an [n, dim] matrix with ``nnz``
    nonzeros: the fewest that keep a block's slice of an f32 w within
    :data:`CSR_BLOCK_BYTES`, or 1 below :data:`CSR_BLOCK_MIN_ROW_NNZ`
    nonzeros a row."""
    if nnz < CSR_BLOCK_MIN_ROW_NNZ * n:
        return 1
    return max(1, -(-4 * dim // CSR_BLOCK_BYTES))


def csr_rows_of_nonzeros(row_ptr: torch.Tensor, blocks: int = 1) -> torch.Tensor:
    """The row of every stored nonzero of a CSR copy in ``blocks`` column
    blocks (``row_ptr`` int64 [blocks·n + 1])."""
    segments = row_ptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(segments, device=row_ptr.device) % (segments // blocks), row_ptr.diff()
    )


def csr_matvec_plain(
    row_ptr: torch.Tensor, col_idx: torch.Tensor, vals: torch.Tensor, w: torch.Tensor,
    blocks: int = 1,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: z[r] = Σ_p vals[p]·w[col_idx[p]]
    over row r's nonzeros (in every column block), by ``scatter_add``."""
    n = (row_ptr.numel() - 1) // blocks
    z = torch.zeros(n, dtype=torch.float32, device=w.device)
    return scatter_add(z, csr_rows_of_nonzeros(row_ptr, blocks), vals * w[col_idx.long()])


def csr_matvec_f32(
    row_ptr: torch.Tensor, col_idx: torch.Tensor, vals: torch.Tensor,
    w: torch.Tensor, dim: int, split: Optional[torch.Tensor] = None, blocks: int = 1,
) -> torch.Tensor:
    """z = X·w for the CSR matrix (row_ptr, col_idx, vals) with ``dim``
    columns, stored in ``blocks`` column blocks (``row_ptr`` [blocks·n + 1];
    1: the plain CSR). Launches the CUDA kernel for CUDA tensors (and
    counts the launch); takes :func:`csr_matvec_plain` for CPU tensors.
    ``split`` is the matrix's :func:`merge_path_split` over ``row_ptr``,
    computed here when not given."""
    _check_csr(KERNEL, row_ptr, col_idx, vals, w, dim, blocks)
    if w.device.type == "cpu":
        return csr_matvec_plain(row_ptr, col_idx, vals, w, blocks)
    return _csr_matvec(KERNEL, row_ptr, col_idx, vals, w, split, blocks)


def csr_matvec_bf16_plain(
    row_ptr: torch.Tensor, col_idx: torch.Tensor, vals: torch.Tensor, w: torch.Tensor,
    blocks: int = 1,
) -> torch.Tensor:
    """Plain PyTorch version of the bf16 kernel: z[r] = Σ_p vals[p]·bf16(w[col_idx[p]])
    in f32 (the reference rounds the broadcast coefficient on network entry),
    and vals[p]·w[c] for an exact entry stored as col_idx[p] = ~c."""
    exact = col_idx < 0
    cols = torch.where(exact, ~col_idx, col_idx).long()
    terms = vals * torch.where(exact, w[cols], _round_bf16(w)[cols])
    n = (row_ptr.numel() - 1) // blocks
    z = torch.zeros(n, dtype=torch.float32, device=w.device)
    return scatter_add(z, csr_rows_of_nonzeros(row_ptr, blocks), terms)


def csr_matvec_bf16(
    row_ptr: torch.Tensor, col_idx: torch.Tensor, vals: torch.Tensor,
    w: torch.Tensor, dim: int, split: Optional[torch.Tensor] = None, blocks: int = 1,
) -> torch.Tensor:
    """z = X·bf16(w) with f32 products and sums, for the CSR matrix
    (row_ptr, col_idx, vals) with ``dim`` columns in ``blocks`` column
    blocks; the kernel rounds each gathered coefficient, except for an
    entry stored with col_idx = ~c (negative): that one is exact,
    vals·w[c]. Launches the CUDA kernel for CUDA tensors (and counts the
    launch); takes :func:`csr_matvec_bf16_plain` for CPU tensors.
    ``split`` as for :func:`csr_matvec_f32`."""
    _check_csr(KERNEL_BF16, row_ptr, col_idx, vals, w, dim, blocks)
    if w.device.type == "cpu":
        return csr_matvec_bf16_plain(row_ptr, col_idx, vals, w, blocks)
    return _csr_matvec(KERNEL_BF16, row_ptr, col_idx, vals, w, split, blocks)


def _check_csr(kernel, row_ptr, col_idx, vals, w, dim: int, blocks: int) -> None:
    _check_compressed(kernel, ("row_ptr", "col_idx", "w"), row_ptr, col_idx, vals, w, dim)
    if blocks < 1 or (row_ptr.numel() - 1) % blocks:
        raise ValueError(f"{kernel}: row_ptr has {row_ptr.numel()} entries, not "
                         f"{blocks} blocks of rows + 1")


def _merge_split(kernel: str, ptr: torch.Tensor, nnz: int, split, device) -> torch.Tensor:
    """``split`` checked as :func:`merge_path_split`'s result for ``ptr``,
    or computed when None."""
    if device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {device}")
    if split is None:
        return merge_path_split(ptr, nnz)
    if (split.dtype != torch.int64 or split.dim() != 2 or split.shape[0] != 2
            or not split.is_contiguous() or split.device != device):
        raise ValueError(f"{kernel}: split must be merge_path_split's int64 [2, ctas+1] "
                         "on the operands' device")
    return split


def _carries(ctas: int, device) -> tuple:
    """Scratch of the merge path's carry rounds: keys and partial sums."""
    return (torch.empty(2 * ctas, dtype=torch.int32, device=device),
            torch.empty(2 * ctas, dtype=torch.float32, device=device))


def _csr_matvec(kernel, row_ptr, col_idx, vals, w, split, blocks):
    """Launch the CSR kernel ``kernel`` (csr_matvec_f32 or _bf16, one
    signature) on CUDA tensors."""
    nnz = col_idx.numel()
    split = _merge_split(kernel, row_ptr, nnz, split, w.device)
    lib = _library()
    n = (row_ptr.numel() - 1) // blocks
    ctas = split.shape[1] - 1
    # the copies stay referenced until the launch is queued
    col_idx, vals = _aligned16(col_idx), _aligned16(vals)
    z = torch.empty(n, dtype=torch.float32, device=w.device)
    partial = torch.empty(n * blocks if blocks > 1 else 0, dtype=torch.float32, device=w.device)
    carry_key, carry_val = _carries(ctas, w.device)
    _launch(kernel, getattr(lib, kernel), lib.spmv_error_string, w.device,
            row_ptr.data_ptr(), col_idx.data_ptr(), vals.data_ptr(), w.data_ptr(),
            z.data_ptr(), partial.data_ptr(), n, blocks, nnz, split.data_ptr(), ctas,
            MERGE_ITEMS, carry_key.data_ptr(), carry_val.data_ptr())
    return z


def merge_path_split(ptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Where the merge-path kernels cut their work (``csrc/merge_path.cuh``;
    :func:`csc_rmatvec_f32` over a CSC ``col_ptr``, :func:`csr_matvec_f32`
    over a CSR ``row_ptr``): the merge of the m segment ends and the ``nnz``
    nonzeros, cut every :data:`MERGE_ITEMS` items, as int64 [2, ctas+1]
    coordinates (segments ended, nonzeros taken); the last is (m, nnz).

    Segment end i stands at position ptr[i+1] + i of the merged list (after
    its nonzeros and the earlier ends), so the segments ended before item k
    are those with ptr[i+1] + i + 1 <= k: one ``searchsorted`` on the
    device, no host sync. The cut depends only on ``ptr``."""
    m = ptr.numel() - 1
    total = m + int(nnz)
    ctas = max(1, -(-total // MERGE_ITEMS))
    dev = ptr.device
    diag = torch.clamp(torch.arange(ctas + 1, device=dev) * MERGE_ITEMS, max=total)
    ends = ptr[1:] + torch.arange(1, m + 1, device=dev)
    segs = torch.searchsorted(ends, diag, right=True)
    return torch.stack([segs, diag - segs])


def _check_csc(kernel, col_ptr, row_idx, vals, c, num_rows: int, transform: str) -> None:
    _check_compressed(kernel, ("col_ptr", "row_idx", "c"), col_ptr, row_idx, vals, c, num_rows)
    if transform not in TRANSFORMS:
        raise ValueError(f"{kernel}: unknown value transform {transform!r}")


def _transformed(vals: torch.Tensor, transform: str) -> torch.Tensor:
    if transform == "id":
        return vals
    if transform == "sq":
        return vals * vals
    if transform == "abs":
        return vals.abs()
    return (vals != 0).to(vals.dtype)


def _column_sums64(col_ptr: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """g[j] = Σ of column j's terms, accumulated in float64 by
    ``scatter_add``, returned in f32: added one at a time into an f32
    running sum, the small terms of a long column (an intercept holds every
    row) would be lost against the sum."""
    d = col_ptr.numel() - 1
    col_of_nnz = torch.repeat_interleave(
        torch.arange(d, device=col_ptr.device), col_ptr.diff()
    )
    g = torch.zeros(d, dtype=torch.float64, device=terms.device)
    return scatter_add(g, col_of_nnz, terms.double()).float()


def csc_rmatvec_plain(
    col_ptr: torch.Tensor, row_idx: torch.Tensor, vals: torch.Tensor,
    c: torch.Tensor, transform: str = "id",
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: g[j] = Σ_p t(vals[p])·c[row_idx[p]]
    over column j's nonzeros (:func:`_column_sums64`)."""
    return _column_sums64(
        col_ptr, _transformed(vals, transform).double() * c.double()[row_idx.long()]
    )


def csc_rmatvec_bf16_plain(
    col_ptr: torch.Tensor, row_idx: torch.Tensor, vals: torch.Tensor,
    c: torch.Tensor, transform: str = "id",
) -> torch.Tensor:
    """Plain PyTorch version of the bf16 kernel: g[j] = Σ_p bf16(t(vals[p])·c[row_idx[p]]),
    the f32 product rounded once (the reference's network input), summed
    as :func:`_column_sums64` sums."""
    return _column_sums64(
        col_ptr, _round_bf16(_transformed(vals, transform) * c[row_idx.long()])
    )


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start 16-byte aligned
    (the kernel loads it 16 bytes at a time)."""
    return t.clone() if t.data_ptr() % 16 else t


def _csc_rmatvec(kernel, col_ptr, row_idx, vals, c, num_rows, transform, split):
    """Launch the CSC kernel ``kernel`` (csc_rmatvec_f32 or _bf16, one
    signature) on CUDA tensors."""
    nnz = row_idx.numel()
    split = _merge_split(kernel, col_ptr, nnz, split, c.device)
    lib = _library_t()
    d = col_ptr.numel() - 1
    ctas = split.shape[1] - 1
    # the copies stay referenced until the launch is queued
    row_idx, vals = _aligned16(row_idx), _aligned16(vals)
    g = torch.empty(d, dtype=torch.float32, device=c.device)
    carry_key, carry_val = _carries(ctas, c.device)
    _launch(kernel, getattr(lib, kernel), lib.spmv_t_error_string, c.device,
            col_ptr.data_ptr(), row_idx.data_ptr(), vals.data_ptr(), c.data_ptr(),
            g.data_ptr(), d, nnz, TRANSFORMS[transform], split.data_ptr(), ctas,
            MERGE_ITEMS, carry_key.data_ptr(), carry_val.data_ptr())
    return g


def csc_rmatvec_f32(
    col_ptr: torch.Tensor, row_idx: torch.Tensor, vals: torch.Tensor,
    c: torch.Tensor, num_rows: int, transform: str = "id",
    split: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """g = Xᵀ·(t(vals)·c) for the CSC matrix (col_ptr, row_idx, vals) with
    ``num_rows`` rows, t one of :data:`TRANSFORMS`. Launches the CUDA kernel
    for CUDA tensors (and counts the launch); takes
    :func:`csc_rmatvec_plain` for CPU tensors. ``split`` is the matrix's
    :func:`merge_path_split`, computed here when not given."""
    _check_csc(KERNEL_T, col_ptr, row_idx, vals, c, num_rows, transform)
    if c.device.type == "cpu":
        return csc_rmatvec_plain(col_ptr, row_idx, vals, c, transform)
    return _csc_rmatvec(KERNEL_T, col_ptr, row_idx, vals, c, num_rows, transform, split)


def csc_rmatvec_bf16(
    col_ptr: torch.Tensor, row_idx: torch.Tensor, vals: torch.Tensor,
    c: torch.Tensor, num_rows: int, transform: str = "id",
    split: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """g[j] = Σ bf16(t(vals)·c[row]) with f32 sums, for the CSC matrix
    (col_ptr, row_idx, vals) with ``num_rows`` rows. Launches the CUDA
    kernel for CUDA tensors (and counts the launch); takes
    :func:`csc_rmatvec_bf16_plain` for CPU tensors."""
    _check_csc(KERNEL_T_BF16, col_ptr, row_idx, vals, c, num_rows, transform)
    if c.device.type == "cpu":
        return csc_rmatvec_bf16_plain(col_ptr, row_idx, vals, c, transform)
    return _csc_rmatvec(KERNEL_T_BF16, col_ptr, row_idx, vals, c, num_rows, transform, split)


@dataclasses.dataclass
class FusedSparseFeatures:
    """Sparse [n, d] matrix in CSR and CSC on one device; ``matvec`` runs the
    ``csr_matvec_f32`` kernel on the card, ``rmatvec``/``rmatvec_sq`` the
    ``csc_rmatvec_f32`` kernel. ``row_split`` and ``split`` cache the
    merge-path splits of ``row_ptr`` and ``col_ptr`` on the card. The CSR
    copy is stored in ``row_blocks`` column blocks (:func:`csr_blocks`),
    one after another, each a CSR of all the rows.

    The port's counterpart of the reference ``FusedBenesFeatures``: the
    same three maps, without the Benes routing, hot-column split or KP
    spill cap that exist only because the TPU cannot gather. With the
    bfloat16 payload the CSC arrays hold the entries the reference rounds,
    run through ``csc_rmatvec_bf16``, and ``exact`` (an f32 engine) the
    ones it keeps exact; the CSR arrays hold both sets, the exact entries'
    columns stored as ~col, for one ``csr_matvec_bf16`` pass; ``layout``
    then describes the partition.
    """

    row_ptr: torch.Tensor   # [row_blocks·n + 1] int64
    col_idx: torch.Tensor   # [nnz] int32
    vals: torch.Tensor      # [nnz] float32, row-major in each column block
    col_ptr: torch.Tensor   # [d+1] int64
    row_idx: torch.Tensor   # [nnz] int32
    vals_csc: torch.Tensor  # [nnz] float32, column-major
    num_rows_: int
    num_cols_: int
    split: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)
    row_split: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)
    row_blocks: int = 1
    payload_dtype: str = "float32"
    exact: Optional["FusedSparseFeatures"] = None
    layout: Optional[dict] = dataclasses.field(default=None, repr=False)

    @property
    def num_rows(self) -> int:
        return self.num_rows_

    @property
    def dim(self) -> int:
        return self.num_cols_

    @property
    def nnz(self) -> int:
        return self.vals_csc.numel() + (0 if self.exact is None else self.exact.nnz)

    def matvec(self, w: torch.Tensor) -> torch.Tensor:
        """X·w in one pass over the CSR copy (with the bf16 payload, over
        both entry sets: the exact entries flagged by ~col)."""
        if self.row_split is None and self.row_ptr.device.type == "cuda":
            self.row_split = merge_path_split(self.row_ptr, self.col_idx.numel())
        kernel = csr_matvec_bf16 if self.payload_dtype == "bfloat16" else csr_matvec_f32
        return kernel(self.row_ptr, self.col_idx, self.vals, w, self.num_cols_,
                      self.row_split, self.row_blocks)

    def rmatvec(self, c: torch.Tensor) -> torch.Tensor:
        return self._rmatvec_impl(c, "id")

    def rmatvec_sq(self, c: torch.Tensor) -> torch.Tensor:
        return self._rmatvec_impl(c, "sq")

    def row_norms_sq(self) -> torch.Tensor:
        """Σ_col x² of every row: the CSR kernel over the squared values
        against a vector of ones (exact in either payload)."""
        if self.row_split is None and self.row_ptr.device.type == "cuda":
            self.row_split = merge_path_split(self.row_ptr, self.col_idx.numel())
        kernel = csr_matvec_bf16 if self.payload_dtype == "bfloat16" else csr_matvec_f32
        ones = torch.ones(self.num_cols_, dtype=torch.float32, device=self.vals.device)
        return kernel(self.row_ptr, self.col_idx, self.vals * self.vals, ones, self.num_cols_,
                      self.row_split, self.row_blocks)

    def _rmatvec_impl(self, c: torch.Tensor, transform: str) -> torch.Tensor:
        """Xᵀ·c with the stored values elementwise-transformed first
        ("id" / "sq" / "abs" / "nnz", the reference's ``_rmatvec_impl``)."""
        if self.split is None and self.col_ptr.device.type == "cuda":
            self.split = merge_path_split(self.col_ptr, self.row_idx.numel())
        kernel = csc_rmatvec_bf16 if self.payload_dtype == "bfloat16" else csc_rmatvec_f32
        g = kernel(self.col_ptr, self.row_idx, self.vals_csc, c, self.num_rows_,
                   transform, self.split)
        return g if self.exact is None else g + self.exact._rmatvec_impl(c, transform)


def from_coo(
    rows, cols, vals, shape, payload_dtype: str = "float32",
    device: DeviceLike = DEFAULT_DEVICE, *, max_nnz_row: Optional[int] = None,
    hot_col_threshold: Optional[int] = None, max_hot_cols: int = 128,
    kp_cap="auto", col_split="auto", size_floor: int = 0,
    partition: Optional[sparse_perm.PayloadPartition] = None,
) -> FusedSparseFeatures:
    """CSR and CSC layouts of COO triplets on ``device``; duplicate
    (row, col) entries are coalesced by summation, as every reference
    engine does.

    ``payload_dtype`` is "float32" (every entry exact) or "bfloat16" (the
    entries the reference routes through its network round on entry). The
    layout arguments are the reference fused builder's and decide only
    which entries round (``sparse_perm.fused_payload_partition``): with
    float32 they change nothing. A bfloat16 grid tile passes its
    ``partition`` instead (``sparse_perm.grid_payload_partitions``: the
    decision is the grid's, over every tile), which replaces the triplets
    and the layout arguments."""
    if payload_dtype not in PAYLOAD_DTYPES:
        raise ValueError(
            f"payload_dtype={payload_dtype!r}: the fused engine takes {PAYLOAD_DTYPES}"
        )
    dev = resolve_device(device)
    n, d = int(shape[0]), int(shape[1])
    if d >= 2**31 or n >= 2**31:
        raise ValueError(f"shape {shape} does not fit the kernels' int32 indices")
    if payload_dtype == "float32":
        rows, cols, vals, _ = coalesce_coo(rows, cols, vals, n, d)
        return _compressed(rows, cols, vals, n, d, dev)
    part = partition if partition is not None else sparse_perm.fused_payload_partition(
        rows, cols, vals, (n, d), max_nnz_row=max_nnz_row,
        hot_col_threshold=hot_col_threshold, max_hot_cols=max_hot_cols,
        kp_cap=kp_cap, col_split=col_split, size_floor=size_floor,
    )
    exact = ~part.payload
    feats = _compressed(part.rows, part.cols, part.vals, n, d, dev,
                        exact if exact.any() else None)
    feats.payload_dtype = payload_dtype
    feats.layout = part.summary()
    return feats


def _compressed(rows, cols, vals, n: int, d: int, dev: torch.device,
                exact: Optional[np.ndarray] = None) -> FusedSparseFeatures:
    """CSR (in :func:`csr_blocks` column blocks) and CSC copies of
    coalesced, (row, col)-sorted triplets. With ``exact`` (a mask over the
    triplets: the bf16 engine's exact set) the CSR copy holds every entry,
    an exact one's column stored as ~col, and the CSC copy and ``exact``
    (an engine of its own) split the entries."""
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=row_ptr[1:])
    row_ptr_t = torch.from_numpy(row_ptr).to(dev)
    cols_t = torch.from_numpy(np.ascontiguousarray(cols, dtype=np.int64)).to(dev)
    vals_t = torch.from_numpy(np.ascontiguousarray(vals, dtype=np.float32)).to(dev)
    row_of_nnz = torch.repeat_interleave(torch.arange(n, device=dev), row_ptr_t.diff())
    if exact is None:
        rounded = slice(None)
        exact_feats = None
    else:
        exact_t = torch.from_numpy(np.asarray(exact, dtype=bool)).to(dev)
        rounded = ~exact_t
        exact_feats = _compressed(rows[exact], cols[exact], vals[exact], n, d, dev)
    # the CSC copy, transposed on the device: a stable sort by column keeps
    # row order within each column
    csc_cols, csc_rows, csc_vals = cols_t[rounded], row_of_nnz[rounded], vals_t[rounded]
    by_col = torch.argsort(csc_cols, stable=True)
    col_ptr = torch.zeros(d + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(csc_cols, minlength=d), 0, out=col_ptr[1:])
    row_idx, vals_csc = csc_rows[by_col].to(torch.int32), csc_vals[by_col]
    col_idx = cols_t if exact is None else torch.where(exact_t, ~cols_t, cols_t)
    blocks = csr_blocks(d, vals_t.numel(), n)
    if blocks > 1:
        # block-major, then row, then column: a stable sort by block of the
        # (row, col)-sorted entries
        block = cols_t // -(-d // blocks)
        order = torch.argsort(block, stable=True)
        row_ptr_t = torch.zeros(blocks * n + 1, dtype=torch.int64, device=dev)
        torch.cumsum(torch.bincount(block * n + row_of_nnz, minlength=blocks * n), 0,
                     out=row_ptr_t[1:])
        col_idx, vals_t = col_idx[order], vals_t[order]
    return FusedSparseFeatures(
        row_ptr=row_ptr_t,
        col_idx=col_idx.to(torch.int32),
        vals=vals_t,
        col_ptr=col_ptr,
        row_idx=row_idx,
        vals_csc=vals_csc,
        num_rows_=n,
        num_cols_=d,
        row_blocks=blocks,
        exact=exact_feats,
    )
