"""Device execution of static-permutation plans (see ops/routing.py).

Counterpart of ``photon_ml_tpu/ops/permute_net.py``. A plan is a sequence
of within-row 128-lane shuffles, within-group sublane shuffles and
relayouts (Enter/Leave), the reference's stages; the reference runs them
one at a time (a Pallas kernel a shuffle, an XLA copy a relayout). Here
:func:`device_plan` compiles the stages once into groups
(:func:`compile_plan`), each one launch of a hand-written CUDA kernel
(``csrc/permute.cu``):

- ``lane_relayout_f32``: a lane stage, an Enter or a Leave, a lane stage
  (the two outer levels of a plan; the reference's ``_lane_shuffle_pallas``
  twice and the relayout between);
- ``inner_shuffle_f32``: Enter, lane, sublane, lane, Leave (the innermost
  level; ``_lane_shuffle_pallas`` and ``_sublane_shuffle_pallas``), or
  lane, sublane, lane on groups of whole rows when the plan has no
  relayout;
- ``lane_shuffle_f32`` (K4): a lane stage that fits no group (a plan of
  one level keeps its first and last).

:func:`apply_plan` hands every launch of a plan to one C entry point
(:func:`plan_f32`) on a CUDA tensor, and runs the same groups through their
plain PyTorch versions (:func:`plan_plain`) on a CPU tensor; a group's
plain version is the composition of the plain stages, so both equal the
stage-by-stage plan bitwise. :func:`lane_shuffle_f32` and
:func:`sublane_shuffle_f32` (K5) remain the standalone stages.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike, resolve_device
from photon_ml_tpu_torch.ops import launches
from photon_ml_tpu_torch.ops.routing import LANES, Enter, LaneShuffle, Leave, PermPlan, SublaneShuffle
from photon_ml_tpu_torch.utils import cudalib

LANE_KERNEL = "lane_shuffle_f32"
SUBLANE_KERNEL = "sublane_shuffle_f32"
RELAYOUT_KERNEL = "lane_relayout_f32"
INNER_KERNEL = "inner_shuffle_f32"
SOURCE = "permute"  # ops/csrc/permute.cu
for _name in (LANE_KERNEL, SUBLANE_KERNEL, RELAYOUT_KERNEL, INNER_KERNEL):
    launches.register(_name)

SUBLANE_ROWS = (2, 4, 8)
INNER_ROWS = (1, 2, 4, 8)
_RELAYOUT_CODE = {None: 0, "enter": 1, "leave": 2}


@dataclasses.dataclass(frozen=True, eq=False)
class PlanGroup:
    """One launch of a compiled plan: ``kernel`` (RELAYOUT_KERNEL,
    INNER_KERNEL or LANE_KERNEL), ``relayout`` (``("enter" | "leave",
    blocks, rows)``, or None), the index tensors of its stages (``a`` the
    lane stage before the relayout, ``s`` the sublane stage, ``b`` the lane
    stage after; None where the group has none), ``rows`` the sublane group
    of an inner group (c in 1, 2, 4, 8), and ``stages`` the plan's stage
    positions it runs."""

    kernel: str
    relayout: Optional[Tuple[str, int, int]]
    a: Optional[torch.Tensor]
    s: Optional[torch.Tensor]
    b: Optional[torch.Tensor]
    rows: int
    stages: Tuple[int, ...]


class _Group(ctypes.Structure):
    """permute.cu's ``PlanGroup``: seven 8-byte fields."""

    _fields_ = [("kernel", ctypes.c_int64), ("relayout", ctypes.c_int64),
                ("blocks", ctypes.c_int64), ("rows", ctypes.c_int64),
                ("a", ctypes.c_void_p), ("s", ctypes.c_void_p), ("b", ctypes.c_void_p)]


@dataclasses.dataclass
class DevicePlan:
    """A plan on a device: the shuffle stages' indices as int8 tensors
    (lane indices are < 128, sublane indices < 8), the stage structure as
    plain tuples: ``("lane",)``, ``("sublane", rows)``, ``("enter", blocks,
    rows)``, ``("leave", blocks, rows)``; ``groups`` the compiled launches
    and, on the card, ``launch`` their C descriptors."""

    idx: Tuple[torch.Tensor, ...]
    kinds: Tuple[tuple, ...]
    size: int
    groups: Tuple[PlanGroup, ...] = ()
    launch: Optional[ctypes.Array] = dataclasses.field(default=None, repr=False,
                                                       compare=False)


def device_plan(plan: PermPlan, device: DeviceLike = DEFAULT_DEVICE) -> DevicePlan:
    """Move the plan's indices to ``device``, check them once (int8, [size /
    128, 128], contiguous, on ``device``; 16-byte aligned on the card) and
    compile the stages into launches."""
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
    m = plan.size // LANES
    for t in idx:
        _check("device_plan", t, torch.int8, m)
    groups = compile_plan(tuple(kinds), tuple(idx))
    launch = _descriptors(groups) if dev.type == "cuda" else None
    return DevicePlan(idx=tuple(idx), kinds=tuple(kinds), size=plan.size, groups=groups,
                      launch=launch)


def compile_plan(kinds: Sequence[tuple], idx: Sequence[torch.Tensor]) -> Tuple[PlanGroup, ...]:
    """Group a plan's stages into launches, by the plan's structure alone:
    the innermost level (the sublane stage with the lane stages around it,
    and the Enter/Leave of (B, c 128) around those) is one
    ``inner_shuffle_f32``; the rest, read from the outside in, go to
    ``lane_relayout_f32`` as [lane] relayout [lane], and a lane stage next
    to no relayout to ``lane_shuffle_f32``."""
    stages: List[tuple] = []  # (position, kind, index tensor or None)
    ai = 0
    for pos, kind in enumerate(kinds):
        if kind[0] in ("lane", "sublane"):
            stages.append((pos, kind, idx[ai]))
            ai += 1
        else:
            stages.append((pos, kind, None))
    subs = [i for i, (_, kind, _) in enumerate(stages) if kind[0] == "sublane"]

    def is_(i: int, name: str) -> bool:
        return 0 <= i < len(stages) and stages[i][1][0] == name

    p = subs[0] if len(subs) == 1 else -1
    if not (is_(p - 1, "lane") and is_(p + 1, "lane") and stages[p][1][1] in INNER_ROWS):
        raise ValueError(f"not a routed plan (one sublane stage of 1, 2, 4 or 8 rows between "
                         f"two lane stages): {kinds}")
    c = stages[p][1][1]
    if is_(p - 2, "enter"):
        # routing's innermost level: Enter(B, c 128) .. Leave(B, c 128)
        lo, hi, relayout = p - 2, p + 2, stages[p - 2][1]
    else:
        lo, hi, relayout = p - 1, p + 1, None
    inner = PlanGroup(INNER_KERNEL, relayout, stages[p - 1][2], stages[p][2] if c > 1 else None,
                      stages[p + 1][2], c, tuple(st[0] for st in stages[lo:hi + 1]))
    return tuple(_outer_groups(stages[:lo]) + [inner] + _outer_groups(stages[hi + 1:]))


def _outer_groups(stages: List[tuple]) -> List[PlanGroup]:
    """[lane] relayout [lane] groups, greedily from the left; a lane stage
    with no relayout after it alone."""
    out, i = [], 0
    while i < len(stages):
        a = None
        if stages[i][1][0] == "lane":
            if i + 1 >= len(stages) or stages[i + 1][1][0] not in ("enter", "leave"):
                out.append(PlanGroup(LANE_KERNEL, None, stages[i][2], None, None, 0,
                                     (stages[i][0],)))
                i += 1
                continue
            a = stages[i][2]
            i += 1
        kind = stages[i][1]
        if kind[0] not in ("enter", "leave"):
            raise ValueError(f"stage {kind} cannot start a group")
        first = i - (a is not None)
        b = None
        if i + 1 < len(stages) and stages[i + 1][1][0] == "lane":
            b = stages[i + 1][2]
            i += 1
        i += 1
        out.append(PlanGroup(RELAYOUT_KERNEL, kind, a, None, b, 0,
                             tuple(st[0] for st in stages[first:i])))
    return out


def _descriptors(groups: Sequence[PlanGroup]) -> ctypes.Array:
    """The C descriptors of a compiled plan's launches (pointers of its
    index tensors, which the DevicePlan keeps alive)."""
    arr = (_Group * len(groups))()
    for d, g in zip(arr, groups):
        kind, blocks, rows = g.relayout or (None, 0, 0)
        if g.kernel == INNER_KERNEL:
            # an inner group's relayout is Enter .. Leave (code 1), its rows c
            d.kernel, d.relayout, d.blocks, d.rows = 1, int(kind is not None), blocks, g.rows
        else:
            d.kernel, d.relayout, d.blocks, d.rows = 0, _RELAYOUT_CODE[kind], blocks, rows
        d.a, d.s, d.b = _ptr(g.a), _ptr(g.s), _ptr(g.b)
    return arr


_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The kernel library, built and bound once (argument types set at
    first load)."""
    global _LIB
    if _LIB is None:
        lib = cudalib.load_library(SOURCE)
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        for name, args in (
            ("lane_shuffle_f32", [p] * 3 + [i64, p]),
            ("sublane_shuffle_f32", [p] * 3 + [i64, ctypes.c_int, p]),
            ("lane_relayout_f32", [p] * 4 + [i64, ctypes.c_int, i64, i64, p]),
            ("inner_shuffle_f32", [p] * 5 + [i64, i64, i64, p]),
            ("apply_plan_f32", [p] * 3 + [i64, p, i64, p]),
        ):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        lib.permute_error_string.argtypes = [ctypes.c_int]
        lib.permute_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(kernel: str, t: torch.Tensor, dtype: torch.dtype, m: int = -1) -> None:
    """``t`` of ``dtype``, a contiguous [m, 128] tensor (any m when m < 0);
    16-byte aligned on the card (the kernels copy 16 bytes a lane)."""
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: expected {dtype}, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != LANES or not t.is_contiguous() or (
            m >= 0 and t.shape[0] != m):
        want = f"[{m if m >= 0 else 'm'}, {LANES}]"
        raise ValueError(f"{kernel}: expected a contiguous {want} tensor, got "
                         f"{tuple(t.shape)}")
    if t.is_cuda and t.data_ptr() % 16:
        raise ValueError(f"{kernel}: operands must be 16-byte aligned on the card")


def _check_operands(kernel: str, v: torch.Tensor, *indices: Optional[torch.Tensor]) -> None:
    """``v`` f32 [m, 128] and each index int8 of v's shape on v's device
    (the cheap comparisons first; :func:`_check` words a refusal)."""
    if (v.dtype != torch.float32 or v.dim() != 2 or v.shape[1] != LANES
            or not v.is_contiguous() or (v.is_cuda and v.data_ptr() % 16)):
        _check(kernel, v, torch.float32)
    shape, dev = v.shape, v.get_device()
    for t in indices:
        if t is None:
            continue
        if t.shape != shape:
            raise ValueError(f"{kernel}: idx {tuple(t.shape)} and v {tuple(shape)} differ")
        if t.dtype != torch.int8 or not t.is_contiguous() or (t.is_cuda and t.data_ptr() % 16):
            _check(kernel, t, torch.int8)
        if t.get_device() != dev:
            raise ValueError(f"{kernel}: idx on {t.device}, v on {v.device}; all operands "
                             "must share one device")


def _launch(device_index: int, fn, *args) -> int:
    """``fn(*args, stream)`` on the current stream of card ``device_index``,
    made the current card only when it is not."""
    if device_index == torch._C._cuda_getDevice():
        return fn(*args, torch._C._cuda_getCurrentRawStream(device_index))
    with torch.cuda.device(device_index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(device_index))


def _call(kernel: str, fn: str, v: torch.Tensor, indices: tuple, sizes: tuple) -> torch.Tensor:
    """One launch through the C entry point ``fn(v, *indices, out, *sizes,
    stream)`` (index pointers, None for an absent stage); counts
    ``kernel``."""
    if not v.is_cuda:
        raise ValueError(f"{kernel}: unsupported device {v.device}")
    out = torch.empty_like(v)
    rc = _launch(v.get_device(), getattr(_library(), fn), v.data_ptr(), *indices,
                 out.data_ptr(), *sizes)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{_library().permute_error_string(rc).decode()} ({rc})")
    launches.record(kernel)
    return out


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------- the standalone stages


def lane_shuffle_plain(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the lane kernel: out[r, c] = v[r, idx[r, c]]
    (the reference's ``_lane_shuffle_xla``)."""
    return torch.gather(v, 1, idx.long())


def lane_shuffle_f32(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, c] = v[r, idx[r, c]] for v f32 [m, 128], idx int8 [m, 128].
    Launches the CUDA kernel for CUDA tensors (and counts the launch); takes
    :func:`lane_shuffle_plain` for CPU tensors."""
    _check_operands(LANE_KERNEL, v, idx)
    if not v.is_cuda:
        return lane_shuffle_plain(v, idx)
    return _call(LANE_KERNEL, "lane_shuffle_f32", v, (idx.data_ptr(),), (v.shape[0],))


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
    _check_operands(SUBLANE_KERNEL, v, idx)
    if rows not in SUBLANE_ROWS or v.shape[0] % rows:
        raise ValueError(f"{SUBLANE_KERNEL}: rows must be one of {SUBLANE_ROWS} and divide "
                         f"m = {v.shape[0]}, got {rows}")
    if not v.is_cuda:
        return sublane_shuffle_plain(v, idx, rows)
    return _call(SUBLANE_KERNEL, "sublane_shuffle_f32", v, (idx.data_ptr(),),
                 (v.shape[0], rows))


# -------------------------------------------------------------- the two groups


def _relayout(v: torch.Tensor, relayout: Tuple[str, int, int]) -> torch.Tensor:
    """Enter(B, R): view [B, R, 128], swap the last two axes; Leave its
    inverse (the reference's relayouts, torch copies)."""
    kind, b, r = relayout
    if kind == "enter":
        return v.reshape(b, r, LANES).transpose(1, 2).reshape(-1, LANES).contiguous()
    return v.reshape(b, LANES, r).transpose(1, 2).reshape(-1, LANES).contiguous()


def lane_relayout_plain(v: torch.Tensor, a: Optional[torch.Tensor],
                        b: Optional[torch.Tensor],
                        relayout: Tuple[str, int, int]) -> torch.Tensor:
    """Plain PyTorch version of ``lane_relayout_f32``: the lane stage ``a``
    (if any), the relayout, the lane stage ``b`` (if any)."""
    if a is not None:
        v = lane_shuffle_plain(v, a)
    v = _relayout(v, relayout)
    return v if b is None else lane_shuffle_plain(v, b)


def lane_relayout_f32(v: torch.Tensor, a: Optional[torch.Tensor], b: Optional[torch.Tensor],
                      relayout: Tuple[str, int, int]) -> torch.Tensor:
    """Lane stage ``a`` on v's rows, ``relayout`` (``("enter" | "leave",
    blocks, rows)``, rows a multiple of 128, blocks rows = m), lane stage
    ``b`` on the relaid rows, in one pass. Launches the CUDA kernel for
    CUDA tensors (and counts the launch); takes :func:`lane_relayout_plain`
    for CPU tensors."""
    _check_operands(RELAYOUT_KERNEL, v, a, b)
    kind, blocks, rows = relayout
    if kind not in ("enter", "leave") or rows % LANES or blocks * rows != v.shape[0]:
        raise ValueError(f"{RELAYOUT_KERNEL}: relayout {relayout} does not fit "
                         f"{v.shape[0]} rows")
    if not v.is_cuda:
        return lane_relayout_plain(v, a, b, relayout)
    return _call(RELAYOUT_KERNEL, "lane_relayout_f32", v, (_ptr(a), _ptr(b)),
                 (v.shape[0], _RELAYOUT_CODE[kind], blocks, rows))


def inner_shuffle_plain(v: torch.Tensor, a: Optional[torch.Tensor], s: Optional[torch.Tensor],
                        b: Optional[torch.Tensor], rows: int, blocks: int = 0) -> torch.Tensor:
    """Plain PyTorch version of ``inner_shuffle_f32``: Enter(blocks, rows
    128) when ``blocks``, the lane stage ``a``, the sublane stage ``s`` in
    groups of ``rows``, the lane stage ``b`` (each if any), then Leave."""
    if blocks:
        v = _relayout(v, ("enter", blocks, rows * LANES))
    if a is not None:
        v = lane_shuffle_plain(v, a)
    if s is not None:
        v = sublane_shuffle_plain(v, s, rows)
    if b is not None:
        v = lane_shuffle_plain(v, b)
    return _relayout(v, ("leave", blocks, rows * LANES)) if blocks else v


def inner_shuffle_f32(v: torch.Tensor, a: Optional[torch.Tensor], s: Optional[torch.Tensor],
                      b: Optional[torch.Tensor], rows: int, blocks: int = 0) -> torch.Tensor:
    """The innermost level of a plan in one pass: Enter(blocks, rows 128),
    lane stage ``a``, sublane stage ``s`` in groups of ``rows`` in {1, 2, 4,
    8}, lane stage ``b``, Leave; with ``blocks`` 0 the three stages on
    groups of ``rows`` whole rows. Launches the CUDA kernel for CUDA
    tensors (and counts the launch); takes :func:`inner_shuffle_plain` for
    CPU tensors."""
    _check_operands(INNER_KERNEL, v, a, s, b)
    m = v.shape[0]
    if rows not in INNER_ROWS or m % rows or (blocks and blocks * rows * LANES != m):
        raise ValueError(f"{INNER_KERNEL}: groups of {rows} rows in {blocks} blocks do not "
                         f"fit {m} rows")
    if not v.is_cuda:
        return inner_shuffle_plain(v, a, s, b, rows, blocks)
    return _call(INNER_KERNEL, "inner_shuffle_f32", v, (_ptr(a), _ptr(s), _ptr(b)),
                 (m, rows, blocks))


# ------------------------------------------------------------------ the plan


def _group_plain(g: PlanGroup, v: torch.Tensor) -> torch.Tensor:
    if g.kernel == LANE_KERNEL:
        return lane_shuffle_plain(v, g.a)
    if g.kernel == RELAYOUT_KERNEL:
        return lane_relayout_plain(v, g.a, g.b, g.relayout)
    return inner_shuffle_plain(v, g.a, g.s, g.b, g.rows,
                               g.relayout[1] if g.relayout else 0)


def plan_plain(dplan: DevicePlan, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`plan_f32`: each group's plain
    version in turn."""
    for g in dplan.groups:
        v = _group_plain(g, v)
    return v


def plan_stages_plain(dplan: DevicePlan, v: torch.Tensor) -> torch.Tensor:
    """The plan one stage at a time through the plain stages, as the
    reference's ``apply_plan`` runs it (the yardstick the grouped plan is
    held to bitwise)."""
    ai = 0
    for kind in dplan.kinds:
        if kind[0] in ("enter", "leave"):
            v = _relayout(v, kind)
            continue
        idx = dplan.idx[ai]
        ai += 1
        if kind[0] == "lane":
            v = lane_shuffle_plain(v, idx)
        elif kind[1] > 1:
            v = sublane_shuffle_plain(v, idx, kind[1])
    return v


def plan_f32(dplan: DevicePlan, v: torch.Tensor) -> torch.Tensor:
    """The plan on v f32 [size / 128, 128] on the card: every group's
    launch from one C call, on the current stream, ping-ponging between two
    buffers from the caching allocator (allocated on that stream); counts
    each group's kernel."""
    if dplan.launch is None:
        raise ValueError("plan_f32: the plan's indices are not on the card")
    dev = v.get_device()
    if v.dtype != torch.float32 or dev != dplan.idx[0].get_device():
        raise ValueError(f"plan_f32: v {v.dtype} on {v.device}, the plan on "
                         f"{dplan.idx[0].device}")
    n = len(dplan.groups)
    bufs = (torch.empty_like(v), torch.empty_like(v) if n > 1 else None)
    rc = _launch(dev, _library().apply_plan_f32, v.data_ptr(), bufs[0].data_ptr(),
                 _ptr(bufs[1]), v.shape[0], ctypes.addressof(dplan.launch), n)
    if rc != 0:
        raise RuntimeError(f"apply_plan_f32 failed: "
                           f"{_library().permute_error_string(rc).decode()} ({rc})")
    for g in dplan.groups:
        launches.record(g.kernel)
    return bufs[(n - 1) % 2]


def apply_plan(dplan: DevicePlan, x: torch.Tensor) -> torch.Tensor:
    """Apply the permutation plan to ``x`` (f32, length the plan's size).
    Returns the permuted vector of the same length: :func:`plan_f32` on the
    card, :func:`plan_plain` on the CPU."""
    if x.shape[-1] != dplan.size or x.dim() != 1:
        raise ValueError(f"apply_plan: x has shape {tuple(x.shape)}, the plan size {dplan.size}")
    v = x.reshape(-1, LANES)
    if not v.is_contiguous() or v.data_ptr() % 16:
        # a view at an odd offset (a block's slice of w when KP is 1): the
        # kernels load 16 bytes a lane, so take a fresh, aligned copy
        v = v.clone(memory_format=torch.contiguous_format)
    if v.is_cuda:
        return plan_f32(dplan, v).reshape(-1)
    return plan_plain(dplan, v).reshape(-1)
