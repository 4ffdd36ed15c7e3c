"""2-D (data x feat) tiled fixed-effect features: the large-coefficient path.

Port of ``photon_ml_tpu/parallel/grid_features.py``. The reference scales
the fixed effect by partitioning examples across executors and
broadcasting the full coefficient vector to every task each evaluation
(DistributedObjectiveFunction; treeAggregate,
ValueAndGradientAggregator.scala:243-247). Here the [n, d] matrix is cut
into an (n_data x n_feat) grid of tiles, tile (i, j) holding rows
[i n_loc, (i+1) n_loc) and columns [j d_loc, (j+1) d_loc), each tile an
engine of its own on its mesh device:

- ``matvec``:  z_i = sum_j X_ij w_j (margins summed over ``feat``);
- ``rmatvec``: g_j = sum_i X_ij^T c_i (gradients summed over ``data``).

Each sum runs on the output's device in tile order, no atomics, so it
repeats bitwise (``parallel/mesh.py``). Vectors arrive whole (a tensor on
the mesh's home device; each tile's block is sliced from it and moved to
the tile's device) or as a :class:`~.mesh.ShardedTensor` from
:func:`shard_vector_feat` / :func:`shard_vector_data`, and leave the same
way. When the mesh spans ranks of ``torch.distributed``, this process
builds and runs only its own tiles; the partials of the others arrive by
one ``all_gather`` a map, and every rank sums all of them in tile order,
so the result is bitwise that of one process.

Tile engines: ``fused`` (``ops/fused_perm.py``: ``csr_matvec_f32`` and
``csc_rmatvec_f32`` on the card, the bf16 payload by ``payload_dtype``),
``benes`` (``ops/sparse_perm.py``: ``lane_shuffle_f32`` and
``sublane_shuffle_f32``) and ``ell`` (``ops/features.EllFeatures`` with a
dense hot side, :class:`_EllWithHot`). The JAX package runs every tile in
one ``shard_map`` program, so its tiles must share shapes and it pins one
layout over the whole grid; a tile here is called on its own, so each
``fused`` or ``benes`` tile gets the single-device builder's own layout
planning over its entries (the same linear map; only the order of the
floating-point additions differs). The padded shapes follow the JAX
package exactly: rows to a multiple of n_data, columns of n_feat, and a
1 x 1 grid delegates to the single-device builder unpadded.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.device import DEFAULT_DEVICE, DeviceLike
from photon_ml_tpu_torch.ops.features import EllFeatures, coalesce_coo, scatter_add
from photon_ml_tpu_torch.ops.sparse_perm import select_hot_cols, split_hot_entries
from photon_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    P,
    ShardedTensor,
    all_gather_blocks,
    default_devices,
    place,
    world,
)
from photon_ml_tpu_torch.utils.nativesort import lexsort_pairs

FEAT_AXIS = "feat"
ENGINES = ("benes", "ell", "fused")


def grid_mesh(n_data: int, n_feat: int, devices=None, device: DeviceLike = DEFAULT_DEVICE,
              ranks=None) -> Mesh:
    """(n_data x n_feat) mesh over the flat device list ``devices`` (may
    repeat one device), by default the visible cards on ``cuda`` or the
    host on ``cpu``. Under a process group of several ranks with no
    ``devices``, each rank drives an equal run of positions on its own
    devices (``ranks`` may name the owner of each position instead)."""
    need = n_data * n_feat
    rank, size = world()
    if devices is None and size > 1 and ranks is None:
        if need % size:
            raise ValueError(f"a grid of {need} positions over {size} ranks")
        per = need // size
        local = default_devices(device, per)
        if len(local) < per:
            raise ValueError(f"need {per} devices a rank, have {len(local)}")
        ranks = [i // per for i in range(need)]
        devices = [local[i % per] for i in range(need)]
    if devices is None:
        devices = default_devices(device, need)
    devices = list(devices)
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.empty((n_data, n_feat), dtype=object)
    for i, dev in enumerate(devices[:need]):
        grid[i // n_feat, i % n_feat] = torch.device(dev)
    return Mesh(grid, (DATA_AXIS, FEAT_AXIS),
                ranks=None if ranks is None else np.asarray(ranks[:need]).reshape(n_data, n_feat))


def _as_blocks(x, mesh: Mesh, axis: int, length: int) -> Dict[tuple, torch.Tensor]:
    """The input block of every local tile: from a ShardedTensor's shards,
    or sliced from a whole tensor along the tile axis ``axis`` (0: data,
    1: feat) and moved to the tile's device."""
    out = {}
    for pos in mesh.local_positions():
        dev = mesh.devices[pos]
        if isinstance(x, ShardedTensor):
            out[pos] = x.shards[pos].to(dev)
        else:
            k = pos[axis]
            out[pos] = x[..., k * length:(k + 1) * length].to(dev)
    return out


@dataclasses.dataclass
class GridShardedFeatures:
    """[n, d] sparse matrix tiled over a (data, feat) mesh: the
    ``matvec``/``rmatvec``/``rmatvec_sq``/``row_norms_sq`` protocol over
    the padded global shapes. ``shards[i][j]`` is tile (i, j)'s engine (None
    where another rank owns the tile)."""

    shards: List[List[object]]
    mesh: Mesh
    num_rows_: int  # padded global rows
    num_cols_: int  # padded global cols

    @property
    def num_rows(self) -> int:
        return self.num_rows_

    @property
    def dim(self) -> int:
        return self.num_cols_

    def _n_dd(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    def _n_df(self) -> int:
        return self.mesh.shape[FEAT_AXIS]

    @property
    def n_loc(self) -> int:
        return self.num_rows_ // self._n_dd()

    @property
    def d_loc(self) -> int:
        return self.num_cols_ // self._n_df()

    def tiles(self):
        """(position, engine) of this process's tiles, in tile order."""
        return [(pos, self.shards[pos[0]][pos[1]]) for pos in self.mesh.local_positions()]

    def _reduce(self, partial: Dict[tuple, torch.Tensor], over: int,
                out_device: torch.device) -> List[torch.Tensor]:
        """Per output block k (a data block when summing over feat, ``over``
        = 1; a feat block when summing over data, ``over`` = 0), the sum of
        its tiles' partials in tile order on ``out_device``."""
        positions = list(np.ndindex(self.mesh.devices.shape))
        if world()[1] > 1:
            like = next(iter(partial.values()))
            partial = all_gather_blocks(partial, positions, self.mesh,
                                        torch.empty_like(like, device=out_device))
        n_out = self.mesh.devices.shape[1 - over]
        sums = []
        for k in range(n_out):
            acc = None
            for t in range(self.mesh.devices.shape[over]):
                pos = (k, t) if over == 1 else (t, k)
                p = partial[pos].to(out_device)
                acc = p if acc is None else acc + p
            sums.append(acc)
        return sums

    def _out(self, sums: List[torch.Tensor], like, axis_name: str):
        if isinstance(like, ShardedTensor):
            axis = self.mesh.axis_names.index(axis_name)
            n = sum(s.shape[-1] for s in sums)
            st = ShardedTensor((n,), sums[0].dtype, self.mesh, P(axis_name), {})
            for pos in self.mesh.local_positions():
                st.shards[pos] = sums[pos[axis]].to(self.mesh.devices[pos])
            return st
        return torch.cat(sums, dim=-1)

    def _home(self, x) -> torch.device:
        return self.mesh.home if isinstance(x, ShardedTensor) else x.device

    def matvec(self, w):
        """X·w: data-split margins, each summed over the feat axis."""
        if isinstance(w, torch.Tensor) and w.dim() == 2:
            return torch.stack([self.matvec(wi) for wi in w])
        blocks = _as_blocks(w, self.mesh, 1, self.d_loc)
        partial = {pos: tile.matvec(blocks[pos]) for pos, tile in self.tiles()}
        return self._out(self._reduce(partial, 1, self._home(w)), w, DATA_AXIS)

    def rmatvec(self, c):
        return self._rmatvec(c, squared=False)

    def rmatvec_sq(self, c):
        return self._rmatvec(c, squared=True)

    def _rmatvec(self, c, squared: bool):
        """Xᵀ·c (or (X∘X)ᵀ·c): feat-split gradients, each summed over the
        data axis."""
        if isinstance(c, torch.Tensor) and c.dim() == 2:
            return torch.stack([self._rmatvec(ci, squared) for ci in c])
        blocks = _as_blocks(c, self.mesh, 0, self.n_loc)
        partial = {
            pos: (tile.rmatvec_sq(blocks[pos]) if squared else tile.rmatvec(blocks[pos]))
            for pos, tile in self.tiles()
        }
        return self._out(self._reduce(partial, 0, self._home(c)), c, FEAT_AXIS)

    def row_norms_sq(self) -> torch.Tensor:
        partial = {pos: tile.row_norms_sq() for pos, tile in self.tiles()}
        return torch.cat(self._reduce(partial, 1, self.mesh.home))


def shard_vector_feat(x, mesh: Mesh) -> ShardedTensor:
    """A [d_pad] vector split over the feat axis (replicated over data):
    the layout of w and the gradient."""
    return place(x, mesh, P(FEAT_AXIS))


def shard_vector_data(x, mesh: Mesh) -> ShardedTensor:
    """An [n_pad] vector split over the data axis (labels, offsets,
    weights, margins)."""
    return place(x, mesh, P(DATA_AXIS))


def grid_from_coo(
    rows,
    cols,
    vals,
    shape: Tuple[int, int],
    mesh: Mesh,
    engine: str = "benes",
    plan_cache: Optional[str] = None,
    hot_col_threshold: Optional[int] = None,
    max_hot_cols: int = 128,
    kp_cap="auto",
    col_split="auto",
    payload_dtype: str = "float32",
) -> GridShardedFeatures:
    """Tile COO entries over the (data, feat) mesh and build each tile's
    engine on its device.

    Rows pad to a multiple of the data-axis size, columns to a multiple of
    the feat-axis size; callers padding labels and weights must give the
    padding rows weight 0 (padded columns are never touched)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected benes/ell/fused")
    if payload_dtype != "float32" and engine != "fused":
        raise ValueError(
            "payload_dtype applies to the fused engine only (the stage-by-"
            "stage and ELL engines have no half-width payload path)"
        )
    n, d = int(shape[0]), int(shape[1])
    n_dd, n_df = mesh.shape[DATA_AXIS], mesh.shape[FEAT_AXIS]
    rows, cols, vals, _ = coalesce_coo(rows, cols, vals, n, d)
    layout = dict(plan_cache=plan_cache, hot_col_threshold=hot_col_threshold,
                  max_hot_cols=max_hot_cols, kp_cap=kp_cap, col_split=col_split)

    if n_dd == 1 and n_df == 1 and engine in ("benes", "fused"):
        # single tile: the full single-device builder, unpadded (its layout
        # planner applies as it does on one device)
        tile = None
        if mesh.is_local((0, 0)):
            tile = _single_device_tile(engine, rows, cols, vals, (n, d), mesh.devices[0, 0],
                                       payload_dtype, layout)
        return GridShardedFeatures(shards=[[tile]], mesh=mesh, num_rows_=n, num_cols_=d)

    n_loc = -(-n // n_dd)
    d_loc = -(-d // n_df)
    tile_id = (rows // n_loc) * n_df + cols // d_loc
    # one sort by tile id, then slices: O(nnz log nnz) once
    order = lexsort_pairs(tile_id)
    rows, cols, vals, tile_id = rows[order], cols[order], vals[order], tile_id[order]
    bounds = np.searchsorted(tile_id, np.arange(n_dd * n_df + 1))

    def entries(dd: int, df: int):
        lo, hi = bounds[dd * n_df + df], bounds[dd * n_df + df + 1]
        return rows[lo:hi] - dd * n_loc, cols[lo:hi] - df * d_loc, vals[lo:hi]

    shards: List[List[object]] = [[None] * n_df for _ in range(n_dd)]
    if engine == "ell":
        tiles = _ell_tiles(entries, n_dd, n_df, n_loc, d_loc, hot_col_threshold, max_hot_cols,
                           mesh)
        for dd, df in mesh.local_positions():
            shards[dd][df] = tiles[dd, df]
    else:
        # only this process's tiles are built (their routing is the
        # expensive step)
        for dd, df in mesh.local_positions():
            tr, tc, tv = entries(dd, df)
            shards[dd][df] = _single_device_tile(engine, tr, tc, tv, (n_loc, d_loc),
                                                 mesh.devices[dd, df], payload_dtype, layout)
    return GridShardedFeatures(shards=shards, mesh=mesh, num_rows_=n_loc * n_dd,
                               num_cols_=d_loc * n_df)


def _single_device_tile(engine, rows, cols, vals, shape, device, payload_dtype, layout):
    """One tile through the single-device builder of ``engine``; a tile
    with no entries is an exact zero map."""
    from photon_ml_tpu_torch.ops import fused_perm, sparse_perm

    if rows.size == 0:
        return sparse_perm._ZeroColumnsBlock(int(shape[0]), int(shape[1]), torch.device(device))
    if engine == "benes":
        return sparse_perm.from_coo(
            rows, cols, vals, shape, plan_cache=layout["plan_cache"],
            max_hot_cols=layout["max_hot_cols"], kp_cap=layout["kp_cap"],
            col_split=layout["col_split"], hot_col_threshold=layout["hot_col_threshold"],
            device=device,
        )
    return fused_perm.from_coo(
        rows, cols, vals, shape, payload_dtype=payload_dtype, device=device,
        hot_col_threshold=layout["hot_col_threshold"], max_hot_cols=layout["max_hot_cols"],
        kp_cap=layout["kp_cap"], col_split=layout["col_split"],
    )


def _ell_tiles(entries, n_dd: int, n_df: int, n_loc: int, d_loc: int,
               hot_col_threshold: Optional[int], max_hot_cols: int, mesh: Mesh) -> dict:
    """This process's tiles in padded ELL layout with one row width K over
    every tile and, when any tile has hot columns, a dense hot side of one
    width H (padded with repeats of the tile's first hot id over zero
    columns: exact no-ops), each on its mesh device."""
    cold, hot = {}, {}
    h_common = 0
    for dd in range(n_dd):
        for df in range(n_df):
            tr, tc, tv = entries(dd, df)
            ids = select_hot_cols(tr, tc, n_loc, d_loc, max_hot_cols, hot_col_threshold)
            cold[dd, df], hot[dd, df] = (tr, tc, tv), ids
            if ids is not None:
                h_common = max(h_common, ids.size)
    K = 1
    tiles_in = {}
    for key, (tr, tc, tv) in cold.items():
        hm = None
        ids = hot[key]
        if h_common:
            ids = np.zeros(0, dtype=np.int64) if ids is None else ids
            if ids.size:
                tr, tc, tv, hm_real = split_hot_entries(tr, tc, tv, n_loc, d_loc, ids)
            else:
                hm_real = np.zeros((n_loc, 0), np.float32)
            hm = np.zeros((n_loc, h_common), dtype=np.float32)
            hm[:, : hm_real.shape[1]] = hm_real
            full = np.full(h_common, int(ids[0]) if ids.size else 0, dtype=np.int64)
            full[: ids.size] = ids
            ids = full
        tiles_in[key] = (tr, tc, tv, hm, ids)
        if tr.size:
            K = max(K, int(np.bincount(tr).max()))
    out = {}
    for key in mesh.local_positions():
        tr, tc, tv, hm, ids = tiles_in[key]
        dev = mesh.devices[key]
        ell = _ell_tile(tr, tc, tv, n_loc, d_loc, K, dev)
        out[key] = ell if hm is None else _EllWithHot(
            ell=ell, hot_matrix=torch.from_numpy(hm).to(dev),
            hot_cols=torch.from_numpy(ids).to(dev))
    return out


def _ell_tile(tr, tc, tv, n_loc: int, d_loc: int, K: int, device) -> EllFeatures:
    """One tile in padded ELL layout with pinned row width K, on ``device``."""
    order = np.argsort(tr, kind="stable")
    tr, tc, tv = tr[order], tc[order], tv[order]
    counts = np.bincount(tr, minlength=n_loc)
    starts = np.zeros(n_loc + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slots = np.arange(tr.size, dtype=np.int64) - starts[tr]
    values = np.zeros((n_loc, K), dtype=np.float32)
    indices = np.zeros((n_loc, K), dtype=np.int64)
    values[tr, slots] = tv
    indices[tr, slots] = tc
    return EllFeatures(values=torch.from_numpy(values).to(device),
                       indices=torch.from_numpy(indices).to(device), num_cols=d_loc)


@dataclasses.dataclass
class _EllWithHot:
    """ELL tile + dense hot side (the Benes engine's hot-column split, for
    the ELL engine)."""

    ell: EllFeatures
    hot_matrix: torch.Tensor
    hot_cols: torch.Tensor

    def matvec(self, w):
        return self.ell.matvec(w) + self.hot_matrix @ w[self.hot_cols]

    def rmatvec(self, c):
        return scatter_add(self.ell.rmatvec(c), self.hot_cols, self.hot_matrix.T @ c)

    def rmatvec_sq(self, c):
        hm2 = self.hot_matrix * self.hot_matrix
        return scatter_add(self.ell.rmatvec_sq(c), self.hot_cols, hm2.T @ c)

    def row_norms_sq(self):
        return self.ell.row_norms_sq() + (self.hot_matrix * self.hot_matrix).sum(-1)
