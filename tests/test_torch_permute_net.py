"""The shuffle stages of the port (ops/permute_net.py) against the JAX
package's Pallas kernels, run under the Pallas interpreter as
tests/test_benes.py runs them (``permute_net._INTERPRET``, monkeypatched
for the test; the JAX package is not edited), and ``apply_plan`` against
the JAX ``apply_plan``. The stages move values without arithmetic, so
every comparison is bitwise.
"""

import functools

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


# ------------------------------------------------- the compiled plan (groups)

SIZE_CLASSES = [(c, m) for m in (0, 1) for c in (1, 2, 4, 8)] + [(1, 2)]  # up to 2^21 slots


@functools.lru_cache(maxsize=None)
def _routed(c, m, kind):
    size = c * 128 ** (m + 1)
    perm = {"identity": np.arange(size), "reversed": np.arange(size)[::-1].copy(),
            "random": np.random.default_rng(size + c).permutation(size)}[kind]
    return perm, routing.build_plan(perm)


def _jax_plan(plan):
    """The port's plan as the JAX package's (the same stage arrays)."""
    kinds = {routing.LaneShuffle: lambda st: jax_routing.LaneShuffle(idx=st.idx),
             routing.SublaneShuffle: lambda st: jax_routing.SublaneShuffle(idx=st.idx,
                                                                           rows=st.rows),
             routing.Enter: lambda st: jax_routing.Enter(blocks=st.blocks, rows=st.rows),
             routing.Leave: lambda st: jax_routing.Leave(blocks=st.blocks, rows=st.rows)}
    return jax_routing.PermPlan(size=plan.size, stages=[kinds[type(st)](st) for st in plan.stages])


@pytest.mark.parametrize("inverted", [False, True])
@pytest.mark.parametrize("kind", ["identity", "reversed", "random"])
@pytest.mark.parametrize("c,m", SIZE_CLASSES)
def test_grouped_plan_equals_jax_and_host_apply(c, m, kind, inverted):
    """apply_plan on the CPU runs the compiled groups through their plain
    versions: bitwise the JAX package's apply_plan (its XLA path on the CPU)
    and routing.host_apply, for a plan and its inverse."""
    perm, plan = _routed(c, m, kind)
    if inverted:
        plan = plan.invert()
    size = plan.size
    x = np.random.default_rng(size).standard_normal(size).astype(np.float32)
    dplan = permute_net.device_plan(plan, device="cpu")
    got = permute_net.apply_plan(dplan, torch.from_numpy(x)).numpy()
    want = np.asarray(jax_permute_net.apply_plan(
        jax_permute_net.device_plan(_jax_plan(plan)), jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, routing.host_apply(plan, x))
    inv = np.argsort(perm)
    np.testing.assert_array_equal(got, x[inv] if inverted else x[perm])
    assert len(dplan.groups) == (1 if m == 0 else 3)


def _kinds(c, m):
    """The stage kinds routing emits for c 128^(m+1) slots."""
    out = []

    def level(blocks, rows):
        out.append(("lane",))
        if rows <= routing.MAX_SUBLANES:
            out.append(("sublane", rows))
        else:
            out.extend([("enter", blocks, rows)])
            level(blocks * 128, rows // 128)
            out.append(("leave", blocks, rows))
        out.append(("lane",))

    level(1, c * 128 ** m)
    return tuple(out)


@pytest.mark.parametrize("m", [0, 1, 2, 3])
@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_compile_plan_groups_by_structure(c, m):
    """Which stages go to which kernel, for every size class: the innermost
    level to inner_shuffle_f32, each outer level's lane stages and relayout
    to lane_relayout_f32 (from the outside in, greedily), a lane stage with
    no relayout beside it (one level) to lane_shuffle_f32; each stage in
    exactly one group, in order."""
    kinds = _kinds(c, m)
    idx = tuple(torch.full((1, 128), i, dtype=torch.int8)
                for i, k in enumerate(kinds) if k[0] in ("lane", "sublane"))
    groups = permute_net.compile_plan(kinds, idx)
    R = c * 128 ** m
    inner = ("inner_shuffle_f32", ("enter", 128 ** (m - 1), c * 128) if m else None, c)
    want = {
        0: [inner],
        1: [("lane_shuffle_f32", None, 0), inner, ("lane_shuffle_f32", None, 0)],
        2: [("lane_relayout_f32", ("enter", 1, R), 0), inner,
            ("lane_relayout_f32", ("leave", 1, R), 0)],
        3: [("lane_relayout_f32", ("enter", 1, R), 0),
            ("lane_relayout_f32", ("enter", 128, R // 128), 0), inner,
            ("lane_relayout_f32", ("leave", 128, R // 128), 0),
            ("lane_relayout_f32", ("leave", 1, R), 0)],
    }[m]
    assert [(g.kernel, g.relayout, g.rows) for g in groups] == want
    assert [p for g in groups for p in g.stages] == list(range(len(kinds)))
    inner_group = next(g for g in groups if g.kernel == permute_net.INNER_KERNEL)
    assert (inner_group.s is None) == (c == 1)  # groups of one row: no sublane stage
    if m == 3:
        # read from the outside in, the second Enter and the last Leave
        # keep one lane stage each
        assert groups[1].a is None and groups[1].b is not None
        assert groups[4].a is None and groups[4].b is not None


def test_plan_descriptors_name_each_launch():
    """The C descriptors of a compiled plan (what apply_plan_f32 reads):
    kernel and relayout codes, blocks, rows and the stage pointers."""
    _, plan = _routed(1, 2, "random")
    dplan = permute_net.device_plan(plan, device="cpu")
    assert dplan.launch is None  # descriptors are made for the card only
    desc = permute_net._descriptors(dplan.groups)
    fields = [(d.kernel, d.relayout, d.blocks, d.rows) for d in desc]
    assert fields == [(0, 1, 1, 128 * 128), (1, 1, 128, 1), (0, 2, 1, 128 * 128)]
    pointers = [(d.a, d.s, d.b) for d in desc]
    assert pointers[1][1] is None  # groups of one row: no sublane stage
    lane_ptrs = {t.data_ptr() for t, k in zip(dplan.idx, [k for k in dplan.kinds
                                                          if k[0] != "enter" and k[0] != "leave"])
                 if k[0] == "lane"}
    assert {p for g in pointers for p in g if p is not None} == lane_ptrs


def test_group_wrappers_check_what_fits():
    v = torch.zeros(256, 128)
    idx = torch.zeros(256, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="does not fit"):
        permute_net.lane_relayout_f32(v, idx, None, ("enter", 3, 128))
    with pytest.raises(ValueError, match="does not fit"):
        permute_net.lane_relayout_f32(v, idx, None, ("sideways", 2, 128))
    with pytest.raises(ValueError, match="do not fit"):
        permute_net.inner_shuffle_f32(v, idx, None, None, 2, 3)
    with pytest.raises(ValueError, match="do not fit"):
        permute_net.inner_shuffle_f32(v, idx, None, None, 3)
    with pytest.raises(TypeError, match="int8"):
        permute_net.inner_shuffle_f32(v, idx.long(), None, None, 2)
    with pytest.raises(ValueError, match="differ"):
        permute_net.lane_relayout_f32(v, None, idx[:128], ("enter", 2, 128))
    with pytest.raises(ValueError, match="not on the card"):
        permute_net.plan_f32(permute_net.device_plan(routing.build_plan(np.arange(128)), "cpu"),
                             torch.zeros(1, 128))


def test_device_plan_checks_its_indices():
    plan = routing.build_plan(np.arange(300))
    bad = routing.PermPlan(size=plan.size, stages=[routing.LaneShuffle(
        idx=plan.stages[0].idx[:1])] + plan.stages[1:])
    with pytest.raises(ValueError, match=r"\[4, 128\]"):
        permute_net.device_plan(bad, device="cpu")
