"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card (the same checks as chip_smoke.py's kernel phase, at smaller sizes:
several test workers may share one card): csr_matvec_f32, csc_rmatvec_f32
and fused_value_grad_batched_f32.

Run on a machine with a card: ``python -m pytest tests/test_torch_kernels_cuda.py``.
Without one, every test here skips.
"""

import pytest
import torch

from photon_ml_tpu_torch.losses import pointwise
from photon_ml_tpu_torch.ops import fused_perm, launches, pallas_kernels

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


def test_fused_engine_rmatvec_launches_the_kernel(card):
    f = fused_perm.from_coo([0, 1, 1], [2, 0, 2], [1.0, 2.0, 3.0], (2, 4), device="cuda")
    before = launches.counts()[fused_perm.KERNEL_T]
    g = f.rmatvec(torch.tensor([1.0, 10.0], device=card))
    assert g.tolist() == [20.0, 0.0, 31.0, 0.0]
    assert launches.counts()[fused_perm.KERNEL_T] == before + 1


LOSSES = [pointwise.LogisticLoss, pointwise.SquaredLoss, pointwise.PoissonLoss,
          pointwise.SmoothedHingeLoss]


@pytest.mark.parametrize("kind", LOSSES, ids=lambda k: k.__name__)
@pytest.mark.parametrize("shape", [(1, 1, 1), (7, 33, 16), (3, 512, 100), (4096, 16, 16)])
def test_fused_value_grad_batched_f32_matches_plain(card, kind, shape):
    E, s, d = shape
    gen = torch.Generator(device=card).manual_seed(E + s + d)
    X = torch.randn(E, s, d, generator=gen, device=card) / d ** 0.5
    y = (torch.rand(E, s, generator=gen, device=card) < 0.5).float()
    off = torch.randn(E, s, generator=gen, device=card) * 0.5
    wt = torch.rand(E, s, generator=gen, device=card) + 0.5
    zero = torch.rand(E, s, generator=gen, device=card) < 0.2
    wt[zero] = 0.0
    off[zero] = 1e20  # weight-0 rows whose squared / Poisson loss overflows
    w = torch.randn(E, d, generator=gen, device=card)
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


def test_fused_value_grad_rejects_host_and_device_mix(card):
    X = torch.zeros(2, 3, 4, device=card)
    with pytest.raises(ValueError, match="one device"):
        pallas_kernels.fused_value_grad_batched_f32(
            X, torch.zeros(2, 3, device=card), torch.zeros(2, 3), torch.ones(2, 3, device=card),
            torch.zeros(2, 4, device=card), pointwise.LogisticLoss,
        )


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
