"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card (the same checks as chip_smoke.py's kernel phase, at smaller sizes:
several test workers may share one card): csr_matvec_f32, csc_rmatvec_f32
(also on skewed columns that stress its merge-path split),
their bf16-payload twins csr_matvec_bf16 and csc_rmatvec_bf16,
fused_value_grad_batched_f32 (also at the latent widths of a factored
coordinate), the blocked fused_value_grad_f32, the two
shuffles of a Benes plan, lane_shuffle_f32 and sublane_shuffle_f32, and the
kernels of a compiled plan, lane_relayout_f32 and inner_shuffle_f32, and
whole plans through apply_plan (bitwise: they move values without
arithmetic).

Run on a machine with a card: ``python -m pytest tests/test_torch_kernels_cuda.py``.
Without one, every test here skips.
"""

import pytest
import torch

from photon_ml_tpu_torch.losses import pointwise
from photon_ml_tpu_torch.ops import fused_perm, launches, pallas_kernels, permute_net

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _csr(n, dim, gen, dev):
    """Rows of 0/1/16/33 nonzeros in turn, 4096 in every 4099th row."""
    pattern = torch.tensor([0, 1, 16, 33], dtype=torch.int64, device=dev)
    r = torch.arange(n, device=dev)
    lengths = pattern[r % 4]
    lengths[r % 4099 == 0] = 4096
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    row_ptr[1:] = torch.cumsum(lengths, 0)
    nnz = int(row_ptr[-1])
    col = torch.randint(0, dim, (nnz,), generator=gen, device=dev).to(torch.int32)
    return row_ptr, col, torch.randn(nnz, generator=gen, device=dev)


@pytest.mark.parametrize("n", [1, 31, 4097, 1 << 16])
@pytest.mark.parametrize("dim", [1 << 17, 1 << 20])
def test_csr_matvec_f32_matches_plain(card, n, dim):
    gen = torch.Generator(device=card).manual_seed(n + dim)
    row_ptr, col, vals = _csr(n, dim, gen, card)
    w = torch.randn(dim, generator=gen, device=card)
    before = launches.counts()[fused_perm.KERNEL]
    z = fused_perm.csr_matvec_f32(row_ptr, col, vals, w, dim)
    torch.cuda.synchronize()
    assert launches.counts()[fused_perm.KERNEL] == before + 1
    plain = fused_perm.csr_matvec_plain(row_ptr, col, vals, w)
    rows = torch.repeat_interleave(torch.arange(n, device=card), row_ptr.diff())
    row_abs = torch.zeros(n, dtype=torch.float64, device=card).index_add_(
        0, rows, (vals.double() * w.double()[col.long()]).abs()
    )
    # sums are taken in another order than the plain version's
    tol = 1e-5 * torch.clamp(row_abs, min=1.0)
    assert z.shape == (n,) and bool(torch.isfinite(z).all())
    assert bool(((z.double() - plain.double()).abs() <= tol).all())
    # no atomics: the same bits every call
    assert torch.equal(z, fused_perm.csr_matvec_f32(row_ptr, col, vals, w, dim))


def _skewed_csr(layout, dim, gen, dev):
    """CSR matrices of skewed rows: 0, 1, 17 and 4096 nonzeros in a ragged
    number of rows (4099), and one row holding every column among short
    ones."""
    if layout == "0_1_17_4096":
        pattern = torch.tensor([0, 1, 17, 17, 17], dtype=torch.int64, device=dev)
        lengths = pattern[torch.arange(4099, device=dev) % 5]
        lengths[1000] = 4096
        cols = torch.randint(0, dim, (int(lengths.sum()),), generator=gen, device=dev)
    else:  # every_column
        lengths = torch.tensor([3, 0, dim, 1, 17], dtype=torch.int64, device=dev)
        cols = torch.cat([torch.randint(0, dim, (3,), generator=gen, device=dev),
                          torch.arange(dim, device=dev),
                          torch.randint(0, dim, (18,), generator=gen, device=dev)])
    row_ptr = torch.zeros(lengths.numel() + 1, dtype=torch.int64, device=dev)
    row_ptr[1:] = torch.cumsum(lengths, 0)
    return row_ptr, cols.to(torch.int32), torch.randn(cols.numel(), generator=gen, device=dev)


def _column_blocks(row_ptr, col, vals, dim, blocks):
    """The CSR in ``blocks`` column blocks, as fused_perm.from_coo stores a
    wide matrix (an exact entry, stored as ~col, by its column)."""
    n = row_ptr.numel() - 1
    rows = torch.repeat_interleave(torch.arange(n, device=col.device), row_ptr.diff())
    block = torch.where(col < 0, ~col, col).long() // -(-dim // blocks)
    order = torch.argsort(block, stable=True)
    ptr = torch.zeros(blocks * n + 1, dtype=torch.int64, device=col.device)
    ptr[1:] = torch.cumsum(torch.bincount(block * n + rows, minlength=blocks * n), 0)
    return ptr, col[order].contiguous(), vals[order].contiguous()


@pytest.mark.parametrize("blocks", [1, 4])
@pytest.mark.parametrize("kernel", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["0_1_17_4096", "every_column"])
def test_csr_matvec_on_skewed_rows(card, layout, kernel, blocks):
    """The merge path over rows: rows much longer than a CTA's share and
    empty rows, stored as one CSR or in column blocks, against the plain
    version, bitwise repeats, and col_idx / vals at an offset that is not
    16-byte aligned (copied)."""
    dim = 70_001
    gen = torch.Generator(device=card).manual_seed(dim + len(layout))
    row_ptr, col, vals = _skewed_csr(layout, dim, gen, card)
    n = row_ptr.numel() - 1
    w = torch.randn(dim, generator=gen, device=card)
    rows = torch.repeat_interleave(torch.arange(n, device=card), row_ptr.diff())
    wq = w[col.long()]
    if kernel == "bf16":  # every 5th entry exact, stored as ~col
        exact = torch.arange(col.numel(), device=card) % 5 == 2
        wq = torch.where(exact, wq, w.to(torch.bfloat16).float()[col.long()])
        col = torch.where(exact, ~col, col)
    row_abs = torch.zeros(n, dtype=torch.float64, device=card).index_add_(
        0, rows, (vals.double() * wq.double()).abs())
    plain = {"f32": fused_perm.csr_matvec_plain,
             "bf16": fused_perm.csr_matvec_bf16_plain}[kernel]
    want = plain(row_ptr, col, vals, w)
    row_ptr, col, vals = _column_blocks(row_ptr, col, vals, dim, blocks)
    fn = {"f32": fused_perm.csr_matvec_f32, "bf16": fused_perm.csr_matvec_bf16}[kernel]
    z = fn(row_ptr, col, vals, w, dim, None, blocks)
    torch.cuda.synchronize()
    tol = 1e-5 * torch.clamp(row_abs, min=1.0)
    assert z.shape == (n,) and bool(torch.isfinite(z).all())
    assert bool(((z.double() - want.double()).abs() <= tol).all())
    assert bool((z[row_abs == 0] == 0).all())  # empty rows written as 0
    assert torch.equal(z, fn(row_ptr, col, vals, w, dim, None, blocks))
    col_off = torch.empty(col.numel() + 1, dtype=torch.int32, device=card)[1:]
    vals_off = torch.empty(vals.numel() + 1, device=card)[1:]
    col_off.copy_(col)
    vals_off.copy_(vals)
    assert torch.equal(fn(row_ptr, col_off, vals_off, w, dim, None, blocks), z)


def test_csr_matvec_f32_rejects_host_and_device_mix(card):
    f = fused_perm.from_coo([0], [1], [1.0], (1, 3), device="cuda")
    with pytest.raises(ValueError, match="one device"):
        f.matvec(torch.zeros(3))


def _csc(n, dim, gen, dev):
    """Columns of 0/1/3 nonzeros in turn, 40 in every 101st (long, one
    segment), 9000 in column 1 (two segments), every row in column 0; rows
    drawn with replacement (duplicates)."""
    pattern = torch.tensor([0, 1, 3], dtype=torch.int64, device=dev)
    j = torch.arange(dim, device=dev)
    lengths = pattern[j % 3]
    lengths[j % 101 == 5] = 40
    lengths[1] = 9000
    lengths[0] = n
    col_ptr = torch.zeros(dim + 1, dtype=torch.int64, device=dev)
    col_ptr[1:] = torch.cumsum(lengths, 0)
    nnz = int(col_ptr[-1])
    row = torch.randint(0, n, (nnz,), generator=gen, device=dev).to(torch.int32)
    vals = torch.randn(nnz, generator=gen, device=dev)
    vals[::37] = 0.0
    return col_ptr, row, vals


@pytest.mark.parametrize("transform", ["id", "sq", "abs", "nnz"])
@pytest.mark.parametrize("n", [1, 4097, 1 << 16])
def test_csc_rmatvec_f32_matches_plain(card, n, transform):
    dim = 1 << 17
    gen = torch.Generator(device=card).manual_seed(n)
    col_ptr, row, vals = _csc(n, dim, gen, card)
    c = torch.randn(n, generator=gen, device=card)
    before = launches.counts()[fused_perm.KERNEL_T]
    g = fused_perm.csc_rmatvec_f32(col_ptr, row, vals, c, n, transform)
    torch.cuda.synchronize()
    assert launches.counts()[fused_perm.KERNEL_T] == before + 1
    plain = fused_perm.csc_rmatvec_plain(col_ptr, row, vals, c, transform)
    cols = torch.repeat_interleave(torch.arange(dim, device=card), col_ptr.diff())
    t = {"id": vals, "sq": vals * vals, "abs": vals.abs(), "nnz": (vals != 0).float()}[transform]
    col_abs = torch.zeros(dim, dtype=torch.float64, device=card).index_add_(
        0, cols, (t.double() * c.double()[row.long()]).abs()
    )
    # f32 sums in another order than the plain version's (float64) sums
    tol = 1e-5 * torch.clamp(col_abs, min=1.0)
    assert g.shape == (dim,) and bool(torch.isfinite(g).all())
    assert bool(((g.double() - plain.double()).abs() <= tol).all())
    # deterministic: no atomics, the same bits every call
    assert torch.equal(g, fused_perm.csc_rmatvec_f32(col_ptr, row, vals, c, n, transform))


def _skewed_csc(layout, n, dim, gen, dev):
    """CSC matrices that stress the merge-path split: empty columns around
    one column longer than a CTA's share, a column cut by several shares,
    every nonzero in the last column."""
    share = fused_perm.MERGE_ITEMS
    lengths = torch.zeros(dim, dtype=torch.int64, device=dev)
    if layout == "empty_and_one_long":
        lengths[dim // 2] = share + 5
    elif layout == "cut_by_several_shares":
        lengths[::3] = 1
        lengths[7] = 5 * share + 123
    else:  # all_in_last_column
        lengths[-1] = 3 * share + 1
    col_ptr = torch.zeros(dim + 1, dtype=torch.int64, device=dev)
    col_ptr[1:] = torch.cumsum(lengths, 0)
    nnz = int(col_ptr[-1])
    row = torch.randint(0, n, (nnz,), generator=gen, device=dev).to(torch.int32)
    return col_ptr, row, torch.randn(nnz, generator=gen, device=dev)


@pytest.mark.parametrize("kernel", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["empty_and_one_long", "cut_by_several_shares",
                                    "all_in_last_column"])
def test_csc_rmatvec_on_skewed_columns(card, layout, kernel):
    n, dim = 5000, 3001
    gen = torch.Generator(device=card).manual_seed(dim + len(layout))
    col_ptr, row, vals = _skewed_csc(layout, n, dim, gen, card)
    c = torch.randn(n, generator=gen, device=card)
    fn, plain = {
        "f32": (fused_perm.csc_rmatvec_f32, fused_perm.csc_rmatvec_plain),
        "bf16": (fused_perm.csc_rmatvec_bf16, fused_perm.csc_rmatvec_bf16_plain),
    }[kernel]
    g = fn(col_ptr, row, vals, c, n)
    torch.cuda.synchronize()
    want = plain(col_ptr, row, vals, c)
    cols = torch.repeat_interleave(torch.arange(dim, device=card), col_ptr.diff())
    col_abs = torch.zeros(dim, dtype=torch.float64, device=card).index_add_(
        0, cols, (vals.double() * c.double()[row.long()]).abs())
    tol = 1e-5 * torch.clamp(col_abs, min=1.0)
    assert g.shape == (dim,) and bool(torch.isfinite(g).all())
    assert bool(((g.double() - want.double()).abs() <= tol).all())
    assert bool((g[col_ptr.diff() == 0] == 0).all())  # empty columns written as 0
    assert torch.equal(g, fn(col_ptr, row, vals, c, n))
    # row_idx / vals at an offset that is not 16-byte aligned are copied
    row_off = torch.empty(row.numel() + 1, dtype=torch.int32, device=card)[1:]
    vals_off = torch.empty(vals.numel() + 1, device=card)[1:]
    row_off.copy_(row)
    vals_off.copy_(vals)
    assert torch.equal(fn(col_ptr, row_off, vals_off, c, n), g)


def test_fused_engine_rmatvec_launches_the_kernel(card):
    f = fused_perm.from_coo([0, 1, 1], [2, 0, 2], [1.0, 2.0, 3.0], (2, 4), device="cuda")
    before = launches.counts()[fused_perm.KERNEL_T]
    g = f.rmatvec(torch.tensor([1.0, 10.0], device=card))
    assert g.tolist() == [20.0, 0.0, 31.0, 0.0]
    assert launches.counts()[fused_perm.KERNEL_T] == before + 1


@pytest.mark.parametrize("n", [1, 31, 4097, 1 << 16])
@pytest.mark.parametrize("dim", [1 << 17, 1 << 20])
def test_csr_matvec_bf16_matches_plain(card, n, dim):
    """The kernel agrees with the plain version (the same rounded
    coefficients, f32 sums in another order) and repeats bitwise."""
    gen = torch.Generator(device=card).manual_seed(n + dim + 1)
    row_ptr, col, vals = _csr(n, dim, gen, card)
    w = torch.randn(dim, generator=gen, device=card)
    before = launches.counts()[fused_perm.KERNEL_BF16]
    z = fused_perm.csr_matvec_bf16(row_ptr, col, vals, w, dim)
    torch.cuda.synchronize()
    assert launches.counts()[fused_perm.KERNEL_BF16] == before + 1
    assert torch.equal(z, fused_perm.csr_matvec_bf16(row_ptr, col, vals, w, dim))
    plain = fused_perm.csr_matvec_bf16_plain(row_ptr, col, vals, w)
    rows = torch.repeat_interleave(torch.arange(n, device=card), row_ptr.diff())
    wb = w.to(torch.bfloat16).double()
    row_abs = torch.zeros(n, dtype=torch.float64, device=card).index_add_(
        0, rows, (vals.double() * wb[col.long()]).abs())
    tol = 1e-5 * torch.clamp(row_abs, min=1.0)
    assert z.shape == (n,) and bool(torch.isfinite(z).all())
    assert bool(((z.double() - plain.double()).abs() <= tol).all())


@pytest.mark.parametrize("transform", ["id", "sq", "abs", "nnz"])
@pytest.mark.parametrize("n", [1, 4097, 1 << 16])
def test_csc_rmatvec_bf16_matches_plain(card, n, transform):
    dim = 1 << 17
    gen = torch.Generator(device=card).manual_seed(n + 2)
    col_ptr, row, vals = _csc(n, dim, gen, card)
    c = torch.randn(n, generator=gen, device=card)
    before = launches.counts()[fused_perm.KERNEL_T_BF16]
    g = fused_perm.csc_rmatvec_bf16(col_ptr, row, vals, c, n, transform)
    torch.cuda.synchronize()
    assert launches.counts()[fused_perm.KERNEL_T_BF16] == before + 1
    plain = fused_perm.csc_rmatvec_bf16_plain(col_ptr, row, vals, c, transform)
    cols = torch.repeat_interleave(torch.arange(dim, device=card), col_ptr.diff())
    t = {"id": vals, "sq": vals * vals, "abs": vals.abs(), "nnz": (vals != 0).float()}[transform]
    terms = (t * c[row.long()]).to(torch.bfloat16).double()
    col_abs = torch.zeros(dim, dtype=torch.float64, device=card).index_add_(0, cols, terms.abs())
    tol = 1e-5 * torch.clamp(col_abs, min=1.0)
    assert g.shape == (dim,) and bool(torch.isfinite(g).all())
    assert bool(((g.double() - plain.double()).abs() <= tol).all())
    assert torch.equal(g, fused_perm.csc_rmatvec_bf16(col_ptr, row, vals, c, n, transform))


def test_bf16_engine_launches_both_sets(card):
    """A bf16 engine with a hot column and spill takes both entry sets in
    one csr_matvec_bf16 pass (the exact entries flagged), and its rounded
    and exact sets' rmatvec by csc_rmatvec_bf16 and csc_rmatvec_f32; it
    agrees with the same engine on the host."""
    import numpy as np

    rng = np.random.default_rng(5)
    n, d = 2048, 70000
    rows = np.concatenate([np.repeat(np.arange(n), 16), np.arange(n)])
    cols = np.concatenate([rng.integers(0, d, n * 16), np.full(n, 3)])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    f = fused_perm.from_coo(rows, cols, vals, (n, d), payload_dtype="bfloat16", device="cuda")
    host = fused_perm.from_coo(rows, cols, vals, (n, d), payload_dtype="bfloat16", device="cpu")
    assert f.exact is not None and f.layout["spilled_entries"] > 0
    w = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    launches.reset()
    z, g = f.matvec(w.to(card)), f.rmatvec(c.to(card))
    counts = launches.counts()
    for k in (fused_perm.KERNEL_BF16, fused_perm.KERNEL_T, fused_perm.KERNEL_T_BF16):
        assert counts[k] == 1, counts
    assert counts[fused_perm.KERNEL] == 0, counts
    np.testing.assert_allclose(z.cpu().numpy(), host.matvec(w).numpy(), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(g.cpu().numpy(), host.rmatvec(c).numpy(), atol=1e-4, rtol=1e-5)


LOSSES = [pointwise.LogisticLoss, pointwise.SquaredLoss, pointwise.PoissonLoss,
          pointwise.SmoothedHingeLoss]


def _value_grad_inputs(E, s, d, gen, dev):
    X = torch.randn(E, s, d, generator=gen, device=dev) / d ** 0.5
    y = (torch.rand(E, s, generator=gen, device=dev) < 0.5).float()
    off = torch.randn(E, s, generator=gen, device=dev) * 0.5
    wt = torch.rand(E, s, generator=gen, device=dev) + 0.5
    zero = torch.rand(E, s, generator=gen, device=dev) < 0.2
    wt[zero] = 0.0
    off[zero] = 1e20  # weight-0 rows whose squared / Poisson loss overflows
    w = torch.randn(E, d, generator=gen, device=dev)
    return X, y, off, wt, w


# tiles of whole entities (s d odd: (7, 33, 5)), entities larger than a
# ring slot ((3, 512, 100); (2, 1000, 33) with s d odd), rows wider than
# 2048 columns (the warp kernel), the two random-effect buckets of the
# full-width fit, and the latent widths of a factored coordinate (d in
# {1, 2, 8}: many entities a tile), up to a full-width latent bucket
@pytest.mark.parametrize("kind", LOSSES, ids=lambda k: k.__name__)
@pytest.mark.parametrize("shape", [(1, 1, 1), (7, 33, 16), (3, 512, 100), (4096, 16, 16),
                                   (7, 33, 5), (2, 1000, 33), (2, 5, 2100), (65_536, 38, 16),
                                   (16_384, 96, 16), (7, 33, 1), (4097, 17, 2), (7, 33, 8),
                                   (65_536, 40, 8)])
def test_fused_value_grad_batched_f32_matches_plain(card, kind, shape):
    E, s, d = shape
    gen = torch.Generator(device=card).manual_seed(E + s + d)
    X, y, off, wt, w = _value_grad_inputs(E, s, d, gen, card)
    before = launches.counts()[pallas_kernels.KERNEL]
    out = pallas_kernels.fused_value_grad_batched_f32(X, y, off, wt, w, kind)
    torch.cuda.synchronize()
    assert launches.counts()[pallas_kernels.KERNEL] == before + 1
    plain = pallas_kernels.fused_value_grad_plain(X, y, off, wt, w, kind)
    # the sums of |terms| bound the f32 rounding of either order
    z = (X * w.unsqueeze(1)).sum(-1) + off
    pos = wt > 0
    lw = torch.where(pos, wt * kind.value(z, y), torch.zeros_like(z)).abs()
    dz = torch.where(pos, wt * kind.d1(z, y), torch.zeros_like(z))
    scales = (lw.sum(-1), (dz.unsqueeze(-1) * X).abs().sum(1), dz.abs().sum(-1))
    for o, p, scale in zip(out, plain, scales):
        assert bool(torch.isfinite(o).all())
        assert bool(((o - p).abs() <= 2e-5 * torch.clamp(scale, min=1.0)).all())
    # no atomics: the same bits every call
    again = pallas_kernels.fused_value_grad_batched_f32(X, y, off, wt, w, kind)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("shape", [(701, 33, 5), (64, 38, 16), (9, 600, 17), (3, 4, 2100),
                                   (701, 33, 1), (701, 33, 2), (4097, 40, 8)])
def test_fused_value_grad_batched_f32_is_invariant_to_its_batch(card, shape):
    """An entity's outputs have the same bits alone (a batch of 1, X a view
    that may start off a 16-byte boundary), at another position (the batch
    rolled), in a batch of 7 and in the whole batch: the random-effect
    solver compacts unconverged entities into smaller batches."""
    E, s, d = shape
    gen = torch.Generator(device=card).manual_seed(E * s + d)
    inputs = _value_grad_inputs(E, s, d, gen, card)

    def run(args):
        return pallas_kernels.fused_value_grad_batched_f32(*args, pointwise.LogisticLoss)

    full = run(inputs)
    rolled = run(tuple(t.roll(5, 0).contiguous() for t in inputs))
    assert all(torch.equal(a.roll(5, 0), b) for a, b in zip(full, rolled))
    for e in sorted({0, E // 2 + 1, E - 1}):
        alone = run(tuple(t[e:e + 1] for t in inputs))
        assert all(torch.equal(a[e:e + 1], b) for a, b in zip(full, alone)), e
        idx = torch.tensor([(e + i) % E for i in range(-3, 4)], device=card)
        seven = run(tuple(t[idx].contiguous() for t in inputs))
        assert all(torch.equal(a[e], b[3]) for a, b in zip(full, seven)), e


def test_fused_value_grad_rejects_host_and_device_mix(card):
    X = torch.zeros(2, 3, 4, device=card)
    with pytest.raises(ValueError, match="one device"):
        pallas_kernels.fused_value_grad_batched_f32(
            X, torch.zeros(2, 3, device=card), torch.zeros(2, 3), torch.ones(2, 3, device=card),
            torch.zeros(2, 4, device=card), pointwise.LogisticLoss,
        )


@pytest.mark.parametrize("kind", LOSSES, ids=lambda k: k.__name__)
@pytest.mark.parametrize("shape", [(1, 1), (700, 37), (1000, 130), (65_537, 129), (4097, 300),
                                   (4097, 1), (257, 4), (1001, 2500), "unaligned"])
def test_fused_value_grad_f32_matches_plain(card, kind, shape):
    """Ragged last tiles, d % 4 != 0, d = 1, rows wider than 256 and than
    2048 columns, and X a view 4 bytes past a 16-byte boundary."""
    n, d = (1000, 128) if shape == "unaligned" else shape
    gen = torch.Generator(device=card).manual_seed(n + d)
    X = torch.randn(n, d, generator=gen, device=card) / d ** 0.5
    if shape == "unaligned":
        X = torch.empty(n * d + 1, device=card)[1:].view(n, d).copy_(X)
        assert X.data_ptr() % 16 != 0
    y = (torch.rand(n, generator=gen, device=card) < 0.5).float()
    off = torch.randn(n, generator=gen, device=card) * 0.5
    wt = torch.rand(n, generator=gen, device=card) + 0.5
    zero = torch.rand(n, generator=gen, device=card) < 0.2
    wt[zero] = 0.0
    off[zero] = 1e20  # weight-0 rows whose squared / Poisson loss overflows
    w = torch.randn(d, generator=gen, device=card)
    before = launches.counts()[pallas_kernels.KERNEL_BLOCKED]
    out = pallas_kernels.fused_value_grad_f32(X, y, off, wt, w, kind)
    torch.cuda.synchronize()
    assert launches.counts()[pallas_kernels.KERNEL_BLOCKED] == before + 1
    plain = pallas_kernels.fused_value_grad_plain(X, y, off, wt, w, kind)
    z = X @ w + off
    pos = wt > 0
    lw = torch.where(pos, wt * kind.value(z, y), torch.zeros_like(z)).abs()
    dz = torch.where(pos, wt * kind.d1(z, y), torch.zeros_like(z))
    scales = (lw.sum(), (dz.unsqueeze(-1) * X).abs().sum(0), dz.abs().sum())
    for o, p, scale in zip(out, plain, scales):
        assert o.shape == p.shape and bool(torch.isfinite(o).all())
        assert bool(((o - p).abs() <= 2e-5 * torch.clamp(scale, min=1.0)).all())
    # a fixed grid and fixed-order sums: the same bits every call
    again = pallas_kernels.fused_value_grad_f32(X, y, off, wt, w, kind)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_ell_rmatvec_repeats_bitwise_on_the_card(card):
    """The ELL engine's scatter (the fixed effect below 2^20 nonzeros) gives
    the same bits every call, as the sync schedule promises."""
    from photon_ml_tpu_torch.ops.features import from_scipy_like

    gen = torch.Generator().manual_seed(3)
    n, d = 1 << 16, 512
    rows = torch.arange(n).repeat_interleave(8)
    cols = torch.randint(0, d, (n * 8,), generator=gen)
    cols[::8] = 0  # an intercept-like column holding every row
    vals = torch.randn(n * 8, generator=gen)
    ell = from_scipy_like(rows.numpy(), cols.numpy(), vals.numpy(), (n, d), device="cuda")
    c = torch.randn(n, generator=gen).to(card)
    first = ell.rmatvec(c)
    for _ in range(3):
        assert torch.equal(ell.rmatvec(c), first)


def _shuffle_indices(kind, m, hi, gen, dev):
    """[m, 128] int8 indices in [0, hi): the identity, reversed, or random
    (for a sublane shuffle, hi = R and index i of row r points within r's
    group of R rows)."""
    if kind == "random":
        idx = torch.randint(0, hi, (m, 128), generator=gen, device=dev)
    else:
        pos = torch.arange(128, device=dev).expand(m, 128) if hi == 128 else (
            torch.arange(m, device=dev).remainder(hi).unsqueeze(1).expand(m, 128))
        idx = pos if kind == "identity" else hi - 1 - pos
    return idx.to(torch.int8).contiguous()


@pytest.mark.parametrize("kind", ["identity", "reversed", "random"])
@pytest.mark.parametrize("m", [1, 31, 32, 4097, 1 << 17])
def test_lane_shuffle_f32_equals_plain_bitwise(card, m, kind):
    gen = torch.Generator(device=card).manual_seed(m)
    v = torch.randn(m, 128, generator=gen, device=card)
    idx = _shuffle_indices(kind, m, 128, gen, card)
    before = launches.counts()[permute_net.LANE_KERNEL]
    out = permute_net.lane_shuffle_f32(v, idx)
    torch.cuda.synchronize()
    assert launches.counts()[permute_net.LANE_KERNEL] == before + 1
    assert torch.equal(out, permute_net.lane_shuffle_plain(v, idx))


@pytest.mark.parametrize("kind", ["identity", "reversed", "random"])
@pytest.mark.parametrize("rows", [2, 4, 8])
@pytest.mark.parametrize("groups", [1, 31, 32, 4097, "2^17 rows"])
def test_sublane_shuffle_f32_equals_plain_bitwise(card, groups, rows, kind):
    m = (1 << 17) if groups == "2^17 rows" else groups * rows
    gen = torch.Generator(device=card).manual_seed(m + rows)
    v = torch.randn(m, 128, generator=gen, device=card)
    idx = _shuffle_indices(kind, m, rows, gen, card)
    before = launches.counts()[permute_net.SUBLANE_KERNEL]
    out = permute_net.sublane_shuffle_f32(v, idx, rows)
    torch.cuda.synchronize()
    assert launches.counts()[permute_net.SUBLANE_KERNEL] == before + 1
    assert torch.equal(out, permute_net.sublane_shuffle_plain(v, idx, rows))


def _stages(m, hi, gen, dev, present=True):
    """[m, 128] int8 stage indices in [0, hi) on the card (None when not
    present: the stage is absent)."""
    if not present:
        return None
    return torch.randint(0, hi, (m, 128), generator=gen, device=dev).to(torch.int8)


@pytest.mark.parametrize("stages", ["both", "first", "second"])
@pytest.mark.parametrize("relayout", [("enter", 1, 128), ("leave", 3, 256), ("enter", 5, 384),
                                      ("leave", 1, 1 << 15)])
def test_lane_relayout_f32_equals_plain_bitwise(card, relayout, stages):
    """Odd tile counts (1, 6, 15 tiles of 128 rows) and a 2^22-slot
    plan's outer level; either lane stage absent."""
    m = relayout[1] * relayout[2]
    gen = torch.Generator(device=card).manual_seed(m)
    v = torch.randn(m, 128, generator=gen, device=card)
    a = _stages(m, 128, gen, card, stages != "second")
    b = _stages(m, 128, gen, card, stages != "first")
    before = launches.counts()[permute_net.RELAYOUT_KERNEL]
    out = permute_net.lane_relayout_f32(v, a, b, relayout)
    torch.cuda.synchronize()
    assert launches.counts()[permute_net.RELAYOUT_KERNEL] == before + 1
    assert torch.equal(out, permute_net.lane_relayout_plain(v, a, b, relayout))


@pytest.mark.parametrize("stages", ["all", "sublane", "lanes"])
@pytest.mark.parametrize("blocks", [0, 1, 3, 128])
@pytest.mark.parametrize("rows", [1, 2, 4, 8])
def test_inner_shuffle_f32_equals_plain_bitwise(card, rows, blocks, stages):
    """Enter(blocks, rows 128) .. Leave at 1, 3 and 128 blocks (the
    2^(21..24)-slot plans' innermost level), and groups of whole rows (31
    groups, no relayout); each stage present or not."""
    if rows == 1 and stages == "sublane":
        pytest.skip("a group of one row has no sublane stage")
    m = blocks * rows * 128 if blocks else 31 * rows
    gen = torch.Generator(device=card).manual_seed(m + rows)
    v = torch.randn(m, 128, generator=gen, device=card)
    a = _stages(m, 128, gen, card, stages != "sublane")
    s = _stages(m, rows, gen, card, rows > 1 and stages != "lanes")
    b = _stages(m, 128, gen, card, stages != "sublane")
    before = launches.counts()[permute_net.INNER_KERNEL]
    out = permute_net.inner_shuffle_f32(v, a, s, b, rows, blocks)
    torch.cuda.synchronize()
    assert launches.counts()[permute_net.INNER_KERNEL] == before + 1
    assert torch.equal(out, permute_net.inner_shuffle_plain(v, a, s, b, rows, blocks))


def _structured_plan(size, rng):
    """A plan with routing's stage structure for ``size`` slots (c 128^(m+1))
    and seeded random stage indices: what the kernels see, without the
    host routing of a real permutation."""
    import numpy as np

    from photon_ml_tpu_torch.ops import routing

    stages = []

    def level(blocks, rows):
        m = blocks * rows
        stages.append(routing.LaneShuffle(rng.integers(0, 128, (m, 128)).astype(np.int32)))
        if rows <= routing.MAX_SUBLANES:
            stages.append(routing.SublaneShuffle(
                rng.integers(0, rows, (m, 128)).astype(np.int32), rows))
        else:
            stages.append(routing.Enter(blocks, rows))
            level(blocks * 128, rows // 128)
            stages.append(routing.Leave(blocks, rows))
        stages.append(routing.LaneShuffle(rng.integers(0, 128, (m, 128)).astype(np.int32)))

    level(1, size // 128)
    return routing.PermPlan(size=size, stages=stages)


@pytest.mark.parametrize("size", [1 << 22, 1 << 24, 8 * 128 * 128, 128])
def test_apply_plan_runs_three_launches_bitwise(card, size):
    """A whole plan on the card equals the stage-by-stage plain plan
    bitwise; a plan of c 128^3 slots (2^22: the Benes grid's tiles; 2^24:
    train_benes_full_width's networks) takes three launches, one of c 128^2
    slots three, one of c 128 one."""
    import numpy as np

    dplan = permute_net.device_plan(_structured_plan(size, np.random.default_rng(size)), card)
    gen = torch.Generator(device=card).manual_seed(size)
    x = torch.randn(size, generator=gen, device=card)
    launches.reset()
    got = permute_net.apply_plan(dplan, x)
    torch.cuda.synchronize()
    counts = launches.counts()
    want = {1 << 22: {"lane_relayout_f32": 2, "inner_shuffle_f32": 1},
            1 << 24: {"lane_relayout_f32": 2, "inner_shuffle_f32": 1},
            8 * 128 * 128: {"lane_shuffle_f32": 2, "inner_shuffle_f32": 1},
            128: {"inner_shuffle_f32": 1}}[size]
    assert {k: n for k, n in counts.items() if n} == want
    assert torch.equal(got, permute_net.plan_stages_plain(dplan, x.reshape(-1, 128)).reshape(-1))


def test_plan_kernels_refuse_what_does_not_fit(card):
    v = torch.zeros(256, 128, device=card)
    idx = torch.zeros(256, 128, dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="does not fit"):
        permute_net.lane_relayout_f32(v, idx, None, ("enter", 3, 128))
    with pytest.raises(ValueError, match="do not fit"):
        permute_net.inner_shuffle_f32(v, idx, None, None, 2, 3)
    with pytest.raises(ValueError, match="aligned"):
        permute_net.lane_shuffle_f32(v.reshape(-1)[1:1 + 255 * 128].view(255, 128), idx[:255])


def test_benes_engine_runs_its_plans_through_the_kernels(card, monkeypatch):
    """The engine's maps launch the shuffle kernels, agree with the same
    engine on the host, and equal the same maps through the plain versions
    on the card bitwise."""
    import numpy as np

    from photon_ml_tpu_torch.ops import sparse_perm

    rng = np.random.default_rng(4)
    n, d = 3000, 5000
    rows = np.repeat(np.arange(n), 6)
    cols = rng.integers(0, d, n * 6)
    vals = rng.standard_normal(n * 6).astype(np.float32)
    w = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    # a flat engine, and a column split with KP 1 (each block's matvec then
    # routes a slice of w at an odd offset)
    for layout in ({}, {"col_split": 2, "kp_cap": 1}):
        f = sparse_perm.from_coo(rows, cols, vals, (n, d), plan_cache="", device="cuda", **layout)
        host = sparse_perm.from_coo(rows, cols, vals, (n, d), plan_cache="", device="cpu",
                                    **layout)
        launches.reset()
        z, g = f.matvec(w.to(card)), f.rmatvec(c.to(card))
        assert launches.counts()[permute_net.INNER_KERNEL] > 0
        np.testing.assert_allclose(z.cpu().numpy(), host.matvec(w).numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(g.cpu().numpy(), host.rmatvec(c).numpy(), atol=1e-5, rtol=1e-5)
        with monkeypatch.context() as mp:
            mp.setattr(permute_net, "plan_f32", permute_net.plan_plain)
            assert torch.equal(f.matvec(w.to(card)), z) and torch.equal(f.rmatvec(c.to(card)), g)


def test_game_data_caches_one_layout_per_card(card):
    """"cuda" and "cuda:<current>" name one card, so scoring on a model's
    device reuses the layout that training built (a Benes layout takes
    seconds to route)."""
    import numpy as np

    from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData

    data = GameData(labels=np.zeros(2), id_tags={}, feature_shards={
        "g": FeatureShard(np.array([0, 1]), np.array([1, 2]), np.ones(2, np.float32), 4)})
    first = data.sparse_features("g", engine="benes", device="cuda")
    assert data.sparse_features("g", engine="benes",
                                device=f"cuda:{torch.cuda.current_device()}") is first


def _grid_problem(n=4099, d=3001, k=9, seed=3):
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k + 1)
    cols = np.concatenate([rng.integers(1, d, (n, k)), np.zeros((n, 1), np.int64)],
                          axis=1).reshape(-1)
    return rows, cols, rng.standard_normal(rows.size).astype(np.float32), (n, d)


@pytest.mark.parametrize("engine,kernels", [
    ("fused", ("csr_matvec_f32", "csc_rmatvec_f32")),
    ("benes", ("inner_shuffle_f32",)),
])
def test_grid_tiles_run_the_kernels(card, engine, kernels):
    """A (data x feat) grid with every tile on the one card: each tile's
    map launches its engine's kernels, and the grid's maps equal the same
    grid's on the CPU (plain versions) and repeat bitwise."""
    from photon_ml_tpu_torch.parallel.grid_features import grid_from_coo, grid_mesh

    rows, cols, vals, shape = _grid_problem()
    grid = (2, 2) if engine == "fused" else (2, 1)
    n_tiles = grid[0] * grid[1]
    on_card = grid_from_coo(rows, cols, vals, shape,
                            grid_mesh(*grid, devices=[card] * n_tiles), engine=engine)
    on_host = grid_from_coo(rows, cols, vals, shape, grid_mesh(*grid, device="cpu"),
                            engine=engine)
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(on_card.dim, generator=gen)
    c = torch.randn(on_card.num_rows, generator=gen)
    before = launches.counts()
    z = on_card.matvec(w.to(card))
    g = on_card.rmatvec(c.to(card))
    after = launches.counts()
    for name in kernels:
        assert after[name] - before[name] >= n_tiles, name
    torch.testing.assert_close(z.cpu(), on_host.matvec(w), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(g.cpu(), on_host.rmatvec(c), rtol=1e-4, atol=1e-4)
    assert torch.equal(on_card.matvec(w.to(card)), z)
    assert torch.equal(on_card.rmatvec(c.to(card)), g)


def test_placed_random_effect_runs_k6_a_device_slice(card):
    """A random-effect dataset split over 4 grid positions on the one card:
    fused_value_grad_batched_f32 runs once a device slice (4 times a
    solver evaluation) and the model is the unsplit solve's."""
    import numpy as np

    from photon_ml_tpu_torch.data.random_effect import (
        RandomEffectDataConfiguration, build_random_effect_dataset, pad_entities_to_multiple,
        place_dataset)
    from photon_ml_tpu_torch.estimators.random_effect import train_random_effects
    from photon_ml_tpu_torch.opt.config import GlmOptimizationConfiguration, OptimizerConfig
    from photon_ml_tpu_torch.parallel.grid_features import grid_mesh
    from photon_ml_tpu_torch.types import TaskType

    rng = np.random.default_rng(1)
    n, d, ents = 3000, 12, 101
    e_of = rng.integers(0, ents, n)
    rows, cols = np.repeat(np.arange(n), 4), rng.integers(0, d, 4 * n)
    vals = rng.standard_normal(4 * n).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    ds = build_random_effect_dataset(np.array([f"e{e}" for e in e_of]), rows, cols, vals, d, y,
                                     RandomEffectDataConfiguration("e"), device=card)
    placed = place_dataset(pad_entities_to_multiple(ds, 4),
                           grid_mesh(2, 2, devices=[card] * 4), ("data", "feat"))
    cfg = GlmOptimizationConfiguration(optimizer_config=OptimizerConfig.lbfgs(max_iterations=20))
    whole, _ = train_random_effects(ds, TaskType.LOGISTIC_REGRESSION, cfg)
    before = launches.counts()["fused_value_grad_batched_f32"]
    split, _ = train_random_effects(placed, TaskType.LOGISTIC_REGRESSION, cfg)
    assert launches.counts()["fused_value_grad_batched_f32"] - before >= 4
    for a, b in zip(whole.coefficients, split.coefficients):
        torch.testing.assert_close(b[: a.shape[0]], a, rtol=0, atol=2e-3)
