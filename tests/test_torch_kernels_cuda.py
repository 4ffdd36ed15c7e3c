"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card (the same check as chip_smoke.py's kernel phase, at smaller sizes:
several test workers may share one card).

Run on a machine with a card: ``python -m pytest tests/test_torch_kernels_cuda.py``.
Without one, every test here skips.
"""

import pytest
import torch

from photon_ml_tpu_torch.ops import fused_perm, launches

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
