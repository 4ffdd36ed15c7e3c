"""The shuffle stages of the port (ops/permute_net.py) against the JAX
package's Pallas kernels, run under the Pallas interpreter as
tests/test_benes.py runs them (``permute_net._INTERPRET``, monkeypatched
for the test; the JAX package is not edited), and ``apply_plan`` against
the JAX ``apply_plan``. The stages move values without arithmetic, so
every comparison is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import permute_net as jax_permute_net
from photon_ml_tpu.ops import routing as jax_routing
from photon_ml_tpu_torch.ops import launches, permute_net, routing


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jax_permute_net, "_INTERPRET", True)


def _inputs(m, hi, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((m, 128)).astype(np.float32)
    idx = rng.integers(0, hi, (m, 128)).astype(np.int8)
    return v, idx


@pytest.mark.parametrize("m", [8, 256, 4096])
def test_lane_shuffle_plain_equals_pallas(interpret, m):
    v, idx = _inputs(m, 128, m)
    want = np.asarray(jax_permute_net._lane_shuffle_pallas(jnp.asarray(v), jnp.asarray(idx)))
    before = launches.counts()[permute_net.LANE_KERNEL]
    got = permute_net.lane_shuffle_f32(torch.from_numpy(v), torch.from_numpy(idx))
    assert launches.counts()[permute_net.LANE_KERNEL] == before  # the plain version ran
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        permute_net.lane_shuffle_plain(torch.from_numpy(v), torch.from_numpy(idx)).numpy(), want)


@pytest.mark.parametrize("rows", [2, 4, 8])
@pytest.mark.parametrize("m", [8, 256, 4096])
def test_sublane_shuffle_plain_equals_pallas(interpret, m, rows):
    v, idx = _inputs(m, rows, m + rows)
    want = np.asarray(jax_permute_net._sublane_shuffle_pallas(
        jnp.asarray(v), jnp.asarray(idx), rows))
    before = launches.counts()[permute_net.SUBLANE_KERNEL]
    got = permute_net.sublane_shuffle_f32(torch.from_numpy(v), torch.from_numpy(idx), rows)
    assert launches.counts()[permute_net.SUBLANE_KERNEL] == before
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_check_their_operands():
    v = torch.zeros(8, 128)
    idx = torch.zeros(8, 128, dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        permute_net.lane_shuffle_f32(v, idx.long())
    with pytest.raises(TypeError, match="float32"):
        permute_net.lane_shuffle_f32(v.double(), idx)
    with pytest.raises(ValueError, match="128"):
        permute_net.lane_shuffle_f32(torch.zeros(8, 64), idx[:, :64])
    with pytest.raises(ValueError, match="differ"):
        permute_net.lane_shuffle_f32(v, idx[:4])
    with pytest.raises(ValueError, match="rows"):
        permute_net.sublane_shuffle_f32(v, idx, 3)
    with pytest.raises(ValueError, match="rows"):
        permute_net.sublane_shuffle_f32(v[:6], idx[:6], 4)


@pytest.mark.parametrize("n", [100, 300, 1000, 5000, 16_384 + 5, 131_072 + 3])
def test_apply_plan_equals_jax(n):
    rng = np.random.default_rng(n)
    perm = rng.permutation(n)
    x = np.zeros(routing.valid_size(n), dtype=np.float32)
    x[:n] = rng.standard_normal(n)
    dplan = permute_net.device_plan(routing.build_plan(perm), device="cpu")
    assert all(t.dtype == torch.int8 for t in dplan.idx)
    got = permute_net.apply_plan(dplan, torch.from_numpy(x))
    jplan = jax_permute_net.device_plan(jax_routing.build_plan(perm))
    assert dplan.kinds == jplan.kinds
    want = np.asarray(jax_permute_net.apply_plan(jplan, jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:n], x[perm])


def test_apply_plan_checks_the_length():
    dplan = permute_net.device_plan(routing.build_plan(np.arange(100)), device="cpu")
    with pytest.raises(ValueError, match="plan size"):
        permute_net.apply_plan(dplan, torch.zeros(100))
