"""Device execution of static-permutation plans (see ops/routing.py).

Counterpart of ``photon_ml_tpu/ops/permute_net.py``. A plan is a sequence
of within-row 128-lane shuffles, within-group sublane shuffles and
relayouts (Enter/Leave). The two shuffles are hand-written CUDA kernels
(``csrc/permute.cu``):

- :func:`lane_shuffle_f32` (K4, the reference's ``_lane_shuffle_pallas``);
- :func:`sublane_shuffle_f32` (K5, ``_sublane_shuffle_pallas``).

On a CUDA tensor every shuffle stage launches its kernel, whatever the
number of rows; on a CPU tensor each wrapper takes its plain version
(:func:`lane_shuffle_plain`, :func:`sublane_shuffle_plain`). Enter and
Leave stay torch ``reshape``/``transpose`` copies, as the reference
computes them outside any Pallas kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.ops import launches
from photon_ml_tpu_torch.ops.routing import LANES, Enter, LaneShuffle, Leave, PermPlan, SublaneShuffle
from photon_ml_tpu_torch.utils import cudalib

LANE_KERNEL = "lane_shuffle_f32"
SUBLANE_KERNEL = "sublane_shuffle_f32"
SOURCE = "permute"  # ops/csrc/permute.cu
launches.register(LANE_KERNEL)
launches.register(SUBLANE_KERNEL)

SUBLANE_ROWS = (2, 4, 8)


@dataclasses.dataclass
class DevicePlan:
    """A plan on a device: the shuffle stages' indices as int8 tensors
    (lane indices are < 128, sublane indices < 8), the stage structure as
    plain tuples: ``("lane",)``, ``("sublane", rows)``, ``("enter", blocks,
    rows)``, ``("leave", blocks, rows)``."""

    idx: Tuple[torch.Tensor, ...]
    kinds: Tuple[tuple, ...]
    size: int


def device_plan(plan: PermPlan, device: DeviceLike = DEFAULT_DEVICE) -> DevicePlan:
    dev = resolve_device(device)
    idx, kinds = [], []
    for st in plan.stages:
        if isinstance(st, LaneShuffle):
            idx.append(torch.from_numpy(st.idx.astype("int8")).to(dev))
            kinds.append(("lane",))
        elif isinstance(st, SublaneShuffle):
            idx.append(torch.from_numpy(st.idx.astype("int8")).to(dev))
            kinds.append(("sublane", st.rows))
        elif isinstance(st, Enter):
            kinds.append(("enter", st.blocks, st.rows))
        elif isinstance(st, Leave):
            kinds.append(("leave", st.blocks, st.rows))
        else:  # pragma: no cover
            raise TypeError(st)
    return DevicePlan(idx=tuple(idx), kinds=tuple(kinds), size=plan.size)


def _library() -> ctypes.CDLL:
    lib = cudalib.load_library(SOURCE)
    lib.lane_shuffle_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p]
    lib.lane_shuffle_f32.restype = ctypes.c_int
    lib.sublane_shuffle_f32.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    )
    lib.sublane_shuffle_f32.restype = ctypes.c_int
    lib.permute_error_string.argtypes = [ctypes.c_int]
    lib.permute_error_string.restype = ctypes.c_char_p
    return lib


def _check(kernel: str, v: torch.Tensor, idx: torch.Tensor) -> None:
    """``v`` f32 and ``idx`` int8, both contiguous [m, 128] on one device;
    on the card both 16-byte aligned (the kernels load 16 bytes a lane)."""
    for name, t, dtype in (("v", v, torch.float32), ("idx", idx, torch.int8)):
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != LANES or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a contiguous [m, {LANES}] tensor, "
                             f"got {tuple(t.shape)}")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned on the card")
    if idx.shape != v.shape:
        raise ValueError(f"{kernel}: idx {tuple(idx.shape)} and v {tuple(v.shape)} differ")
    if idx.device != v.device:
        raise ValueError(f"{kernel}: idx on {idx.device}, v on {v.device}; all operands "
                         "must share one device")


def _launch(kernel: str, fn, v: torch.Tensor, idx: torch.Tensor, *args) -> torch.Tensor:
    if v.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {v.device}")
    lib = _library()
    out = torch.empty_like(v)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = getattr(lib, fn)(v.data_ptr(), idx.data_ptr(), out.data_ptr(), v.shape[0],
                              *args, stream)
    if rc != 0:
        raise RuntimeError(
            f"{kernel} launch failed: {lib.permute_error_string(rc).decode()} ({rc})"
        )
    launches.record(kernel)
    return out


def lane_shuffle_plain(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the lane kernel: out[r, c] = v[r, idx[r, c]]
    (the reference's ``_lane_shuffle_xla``)."""
    return torch.gather(v, 1, idx.long())


def lane_shuffle_f32(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, c] = v[r, idx[r, c]] for v f32 [m, 128], idx int8 [m, 128].
    Launches the CUDA kernel for CUDA tensors (and counts the launch); takes
    :func:`lane_shuffle_plain` for CPU tensors."""
    _check(LANE_KERNEL, v, idx)
    if v.device.type == "cpu":
        return lane_shuffle_plain(v, idx)
    return _launch(LANE_KERNEL, "lane_shuffle_f32", v, idx)


def sublane_shuffle_plain(v: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """Plain PyTorch version of the sublane kernel:
    out[g*R + i, c] = v[g*R + idx[g*R + i, c], c] (the reference's
    ``_sublane_shuffle_xla``: a gather on the [m/R, R, 128] view along its
    middle axis)."""
    m = v.shape[0]
    blk = v.reshape(m // rows, rows, LANES)
    sel = idx.long().reshape(m // rows, rows, LANES)
    return torch.gather(blk, 1, sel).reshape(m, LANES)


def sublane_shuffle_f32(v: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """The sublane shuffle for v f32 [m, 128], idx int8 [m, 128] in groups of
    ``rows`` in {2, 4, 8} rows (m a multiple of it). Launches the CUDA
    kernel for CUDA tensors (and counts the launch); takes
    :func:`sublane_shuffle_plain` for CPU tensors."""
    _check(SUBLANE_KERNEL, v, idx)
    if rows not in SUBLANE_ROWS or v.shape[0] % rows:
        raise ValueError(f"{SUBLANE_KERNEL}: rows must be one of {SUBLANE_ROWS} and divide "
                         f"m = {v.shape[0]}, got {rows}")
    if v.device.type == "cpu":
        return sublane_shuffle_plain(v, idx, rows)
    return _launch(SUBLANE_KERNEL, "sublane_shuffle_f32", v, idx, rows)


def apply_plan(dplan: DevicePlan, x: torch.Tensor) -> torch.Tensor:
    """Apply the permutation plan to ``x`` (f32, length the plan's size).
    Returns the permuted vector of the same length."""
    if x.shape[-1] != dplan.size or x.dim() != 1:
        raise ValueError(f"apply_plan: x has shape {tuple(x.shape)}, the plan size {dplan.size}")
    v = x.reshape(-1, LANES)
    if not v.is_contiguous() or v.data_ptr() % 16:
        # a view at an odd offset (a block's slice of w when KP is 1): the
        # kernels load 16 bytes a lane, so take a fresh, aligned copy
        v = v.clone(memory_format=torch.contiguous_format)
    ai = 0
    for kind in dplan.kinds:
        if kind[0] == "lane":
            v = lane_shuffle_f32(v, dplan.idx[ai])
            ai += 1
        elif kind[0] == "sublane":
            idx = dplan.idx[ai]
            ai += 1
            if kind[1] == 1:
                continue  # single-row groups: identity movement
            v = sublane_shuffle_f32(v, idx, kind[1])
        elif kind[0] == "enter":
            _, b, r = kind
            v = v.reshape(b, r, LANES).transpose(1, 2).reshape(-1, LANES).contiguous()
        elif kind[0] == "leave":
            _, b, r = kind
            v = v.reshape(b, LANES, r).transpose(1, 2).reshape(-1, LANES).contiguous()
        else:  # pragma: no cover
            raise ValueError(kind)
    return v.reshape(-1)
