"""Static-permutation routing through a radix-128 Clos/Benes network.

Counterpart of ``photon_ml_tpu/ops/routing.py``, host numpy plus the
Euler-split colorer ``native/eulercolor.cpp`` (the port's copy of the
reference's source). Any static permutation of an ``[R, 128]`` array
factors (Slepian–Duguid / Clos routing) into

    (within-row lane shuffle) o (per-lane row movement) o (within-row shuffle)

where the middle stage recurses with R -> R/128 until R <= 8, at which point
it is a sublane shuffle inside a group of at most 8 rows. Routing is a
proper 128-edge-coloring of the (source row, destination row) incidence
multigraph, computed once at data-prep time.

This module builds the stage plan and a reference ``host_apply``; device
execution lives in ``ops/permute_net.py`` and the sparse-feature engine
built on top in ``ops/sparse_perm.py``. The reference and the port run the
same colorer source, so one permutation gives the same plan in both, stage
for stage and index for index.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np

from photon_ml_tpu_torch.utils import nativelib

LANES = 128
MAX_SUBLANES = 8  # rows a sublane shuffle moves within


def _library() -> ctypes.CDLL:
    lib = nativelib.load_library("eulercolor")
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.euler_color.restype = ctypes.c_int
    lib.euler_color.argtypes = [
        ctypes.c_int64, ctypes.c_int32, i32p, i32p, ctypes.c_int32, ctypes.c_int32, i32p,
    ]
    return lib


def _euler_color_numpy(src: np.ndarray, dst: np.ndarray, deg: int,
                       n_src: int, n_dst: int) -> np.ndarray:
    """Euler-split halving with a sequential cycle walk in Python: the
    oracle the native colorer is tested against (small sizes only)."""
    n_edges = src.shape[0]
    color = np.zeros(n_edges, dtype=np.int32)
    levels = int(deg).bit_length() - 1

    def pair(subset: np.ndarray, key: np.ndarray) -> np.ndarray:
        order = subset[np.argsort(key[subset], kind="stable")]
        partner = np.empty(n_edges, dtype=np.int64)
        partner[order[0::2]] = order[1::2]
        partner[order[1::2]] = order[0::2]
        return partner

    classes = [np.arange(n_edges, dtype=np.int64)]
    for level in range(levels):
        next_classes = []
        for subset in classes:
            ps = pair(subset, src)
            pd = pair(subset, dst)
            visited = np.zeros(n_edges, dtype=bool)
            bit = np.zeros(n_edges, dtype=bool)
            for e0 in subset.tolist():
                if visited[e0]:
                    continue
                e, b, via_src = e0, False, True
                while True:
                    visited[e] = True
                    bit[e] = b
                    e = int(ps[e] if via_src else pd[e])
                    via_src = not via_src
                    b = not b
                    if e == e0:
                        break
            sel = bit[subset]
            color[subset[sel]] |= 1 << (levels - 1 - level)
            next_classes.append(subset[~sel])
            next_classes.append(subset[sel])
        classes = next_classes
    return color


def euler_color(src: np.ndarray, dst: np.ndarray, deg: int, n_src: int,
                n_dst: int) -> np.ndarray:
    """Proper ``deg``-edge-coloring of a regular bipartite multigraph.

    Every src node and dst node must have exactly ``deg`` incident edges;
    ``deg`` must be a power of two. Returns ``color[e] in [0, deg)`` with no
    two edges of equal color sharing a src node or a dst node. Runs the
    native colorer; raises when it cannot be built or refuses the graph.
    """
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    n_edges = src.shape[0]
    if deg <= 0 or deg & (deg - 1):
        raise ValueError(f"deg {deg} must be a power of two")
    if not n_edges == n_src * deg == n_dst * deg:
        raise ValueError(f"{n_edges} edges is not {deg}-regular on {n_src} x {n_dst} nodes")
    color = np.zeros(n_edges, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = _library().euler_color(
        ctypes.c_int64(n_edges), ctypes.c_int32(deg),
        src.ctypes.data_as(i32p), dst.ctypes.data_as(i32p),
        ctypes.c_int32(n_src), ctypes.c_int32(n_dst), color.ctypes.data_as(i32p),
    )
    if rc != 0:
        raise RuntimeError(f"native euler_color failed (rc {rc})")
    return color


# --------------------------------------------------------------------------
# Stage types. All arrays are host numpy; permute_net moves them to a device.
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class LaneShuffle:
    """y[r, c] = x[r, idx[r, c]] — within-row 128-lane gather."""

    idx: np.ndarray  # [rows, 128] int32 in [0, 128)


@dataclass(frozen=True)
class SublaneShuffle:
    """Within consecutive blocks of ``rows`` rows (rows <= 8):
    y[g*rows + i, c] = x[g*rows + idx[g*rows + i, c], c]."""

    idx: np.ndarray  # [total_rows, 128] int32 in [0, rows)
    rows: int


@dataclass(frozen=True)
class Enter:
    """Relayout into the recursion: view [B, R, 128], transpose the last two
    axes, reshape to [B*128*(R//128), 128]."""

    blocks: int
    rows: int


@dataclass(frozen=True)
class Leave:
    """Inverse of :class:`Enter` with the same (blocks, rows)."""

    blocks: int
    rows: int


Stage = Union[LaneShuffle, SublaneShuffle, Enter, Leave]


@dataclass
class PermPlan:
    """Executable decomposition of ``y = x[perm]`` into shuffle stages."""

    size: int  # padded network size (multiple of 128)
    stages: List[Stage]

    def invert(self) -> "PermPlan":
        """Plan for the inverse permutation (stages reversed + inverted)."""
        inv_stages: List[Stage] = []
        for st in reversed(self.stages):
            if isinstance(st, LaneShuffle):
                rows = st.idx.shape[0]
                inv = np.empty_like(st.idx)
                r = np.arange(rows)[:, None]
                inv[r, st.idx] = np.broadcast_to(
                    np.arange(LANES, dtype=st.idx.dtype), st.idx.shape
                )
                inv_stages.append(LaneShuffle(idx=inv))
            elif isinstance(st, SublaneShuffle):
                total, R = st.idx.shape[0], st.rows
                blk = st.idx.reshape(total // R, R, LANES)
                inv = np.empty_like(blk)
                g = np.arange(total // R)[:, None, None]
                c = np.arange(LANES)[None, None, :]
                i = np.broadcast_to(
                    np.arange(R, dtype=st.idx.dtype)[None, :, None], blk.shape
                )
                inv[g, blk, c] = i
                inv_stages.append(SublaneShuffle(idx=inv.reshape(total, LANES), rows=R))
            elif isinstance(st, Enter):
                inv_stages.append(Leave(blocks=st.blocks, rows=st.rows))
            elif isinstance(st, Leave):
                inv_stages.append(Enter(blocks=st.blocks, rows=st.rows))
            else:  # pragma: no cover
                raise TypeError(st)
        return PermPlan(size=self.size, stages=inv_stages)


def valid_size(n: int) -> int:
    """Smallest routable network size >= n: c * 128**(m+1), c in {1,2,4,8}
    (c a power of two, so the recursion base emits sublane groups of 1, 2,
    4 or 8 rows)."""
    if n <= 0:
        raise ValueError("size must be positive")
    base = LANES
    while True:
        for c in (1, 2, 4, 8):
            if c * base >= n:
                return c * base
        base *= LANES


def _route(sigma: np.ndarray, B: int, R: int, stages: List[Stage]) -> None:
    """Emit stages for per-block permutations.

    sigma: [B, R, 128] int64 — for each block, destination position (r, c)
    holds the *source* flat position (rs*128 + cs) within the same block.
    """
    rs, cs = np.divmod(sigma, LANES)  # [B, R, 128]
    b_ids = np.arange(B, dtype=np.int64)[:, None, None]
    rd = np.broadcast_to(np.arange(R, dtype=np.int64)[None, :, None], sigma.shape)
    src_node = (b_ids * R + rs).ravel()
    dst_node = (b_ids * R + rd).ravel()
    color = euler_color(src_node, dst_node, LANES, B * R, B * R).astype(np.int64)

    # First lane shuffle: x1[rs, color] = x[rs, cs]
    la = np.empty(B * R * LANES, dtype=np.int32)
    la[src_node * LANES + color] = cs.ravel().astype(np.int32)
    stages.append(LaneShuffle(idx=la.reshape(B * R, LANES)))

    # Middle stage: per-lane row movement m[rd, color] = rs (block-local).
    m = np.empty(B * R * LANES, dtype=np.int64)
    m[dst_node * LANES + color] = rs.ravel()
    m = m.reshape(B, R, LANES)

    if R <= MAX_SUBLANES:
        stages.append(SublaneShuffle(idx=m.reshape(B * R, LANES).astype(np.int32), rows=R))
    else:
        if R % LANES:
            raise ValueError(f"unroutable row count {R}")
        R1 = R // LANES
        # Relayout: new block (b, lane c); new position (g, j) holds old
        # (b, g*128 + j, c). Element wanted at new (b, c, gd, jd) comes from
        # old row m[b, gd*128+jd, c] = gs*128 + js -> new (b, c, gs, js).
        stages.append(Enter(blocks=B, rows=R))
        m_t = np.transpose(m, (0, 2, 1))  # [B, 128, R] indexed by (b, c, rd)
        sigma2 = m_t.reshape(B * LANES, R1, LANES)  # values are rs = gs*128+js
        _route(sigma2, B * LANES, R1, stages)
        stages.append(Leave(blocks=B, rows=R))

    # Final lane shuffle: y[rd, cd] = x2[rd, color]
    stages.append(LaneShuffle(idx=color.astype(np.int32).reshape(B * R, LANES)))


def build_plan(perm: Sequence[int] | np.ndarray, size: Optional[int] = None) -> PermPlan:
    """Build a plan computing ``y = x[perm]`` (gather convention).

    ``perm`` must be a bijection over [0, len(perm)). The network size is
    padded up to :func:`valid_size`; padded positions map identically.
    """
    perm = np.asarray(perm, dtype=np.int64)
    n = perm.shape[0]
    S = valid_size(max(n, 1) if size is None else size)
    if S < n:
        raise ValueError(f"requested size {size} < permutation length {n}")
    if np.unique(perm).shape[0] != n or (n and (perm.min() < 0 or perm.max() >= n)):
        raise ValueError("perm is not a bijection over its domain")
    full = np.arange(S, dtype=np.int64)
    full[:n] = perm
    stages: List[Stage] = []
    _route(full.reshape(1, S // LANES, LANES), 1, S // LANES, stages)
    return PermPlan(size=S, stages=stages)


def host_apply(plan: PermPlan, x: np.ndarray) -> np.ndarray:
    """Reference execution of a plan on the host (numpy). Returns the full
    padded [size] result (callers slice what they need). For tests."""
    S = plan.size
    v = np.zeros(S, dtype=x.dtype)
    v[: x.shape[0]] = x
    v = v.reshape(S // LANES, LANES)
    for st in plan.stages:
        if isinstance(st, LaneShuffle):
            v = np.take_along_axis(v, st.idx, axis=1)
        elif isinstance(st, SublaneShuffle):
            rows = v.shape[0]
            blk = v.reshape(rows // st.rows, st.rows, LANES)
            idx = st.idx.reshape(rows // st.rows, st.rows, LANES)
            v = np.take_along_axis(blk, idx, axis=1).reshape(rows, LANES)
        elif isinstance(st, Enter):
            B, R = st.blocks, st.rows
            v = v.reshape(B, R, LANES).transpose(0, 2, 1).reshape(B * LANES * (R // LANES), LANES)
        elif isinstance(st, Leave):
            B, R = st.blocks, st.rows
            v = v.reshape(B, LANES, R).transpose(0, 2, 1).reshape(B * R, LANES)
        else:  # pragma: no cover
            raise TypeError(st)
    return v.reshape(S)
