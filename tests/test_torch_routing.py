"""Routing plans of the port (ops/routing.py) against the JAX package's.

Both run the same Euler-split colorer source, so for one permutation the
plans must be identical: the same stage kinds in the same order and the
same index arrays, bitwise (tolerance: none). The native colorer is held
against the numpy oracle, and the native argsort against numpy's.
"""

import numpy as np
import pytest

from photon_ml_tpu.ops import routing as jax_routing
from photon_ml_tpu_torch.ops import routing
from photon_ml_tpu_torch.utils import nativesort

# sizes that reach every stage kind: a lone sublane group of 1/2/4/8 rows,
# one Enter/Leave level (128^2 slots) and two (past 8 * 128^2)
SIZES = [1, 100, 128, 300, 1000, 1024, 5000, 16_384 + 5, 131_072 + 3]


def _stages_equal(a, b):
    assert len(a.stages) == len(b.stages)
    for sa, sb in zip(a.stages, b.stages):
        assert type(sa).__name__ == type(sb).__name__
        if hasattr(sa, "idx"):
            assert sa.idx.dtype == sb.idx.dtype
            np.testing.assert_array_equal(sa.idx, sb.idx)
        for field in ("rows", "blocks"):
            assert getattr(sa, field, None) == getattr(sb, field, None)


@pytest.mark.parametrize("n", SIZES)
def test_build_plan_equals_jax(n):
    perm = np.random.default_rng(n).permutation(n)
    plan = routing.build_plan(perm)
    ref = jax_routing.build_plan(perm)
    assert plan.size == ref.size == routing.valid_size(n)
    _stages_equal(plan, ref)
    _stages_equal(plan.invert(), ref.invert())


@pytest.mark.parametrize("n", SIZES)
def test_host_apply_permutes_like_jax(n):
    rng = np.random.default_rng(n + 1)
    perm = rng.permutation(n)
    x = rng.standard_normal(n).astype(np.float32)
    plan = routing.build_plan(perm)
    y = routing.host_apply(plan, x)
    np.testing.assert_array_equal(y[:n], x[perm])
    np.testing.assert_array_equal(y, jax_routing.host_apply(jax_routing.build_plan(perm), x))
    # the inverse plan undoes it
    np.testing.assert_array_equal(routing.host_apply(plan.invert(), y)[:n], x)


def test_valid_size_equals_jax():
    for n in list(range(1, 2000, 7)) + [2**14, 2**14 + 1, 2**17, 2**21 + 1, 2**24, 2**24 + 1]:
        assert routing.valid_size(n) == jax_routing.valid_size(n)
    with pytest.raises(ValueError):
        routing.valid_size(0)


def test_build_plan_rejects_a_non_bijection():
    with pytest.raises(ValueError, match="bijection"):
        routing.build_plan(np.array([0, 0, 1]))
    with pytest.raises(ValueError, match="size"):
        routing.build_plan(np.arange(300), size=200)


@pytest.mark.parametrize("deg,nodes", [(8, 16), (16, 8), (128, 4), (128, 33)])
def test_native_colorer_matches_numpy_oracle(deg, nodes):
    rng = np.random.default_rng(deg + nodes)
    perm = rng.permutation(nodes * deg)
    src = (perm // deg).astype(np.int32)
    dst = np.repeat(np.arange(nodes, dtype=np.int32), deg)
    color = routing.euler_color(src, dst, deg, nodes, nodes)
    np.testing.assert_array_equal(color, routing._euler_color_numpy(src, dst, deg, nodes, nodes))
    # proper on both sides
    assert color.min() >= 0 and color.max() < deg
    assert len(set(zip(src.tolist(), color.tolist()))) == src.size
    assert len(set(zip(dst.tolist(), color.tolist()))) == dst.size


def test_colorer_refuses_an_irregular_graph():
    with pytest.raises(ValueError, match="power of two"):
        routing.euler_color(np.zeros(3), np.zeros(3), 3, 1, 1)
    with pytest.raises(ValueError, match="regular"):
        routing.euler_color(np.zeros(5), np.zeros(5), 4, 1, 1)


@pytest.mark.parametrize("n", [10, 1 << 16, 200_000])
def test_lexsort_pairs_matches_numpy(n):
    rng = np.random.default_rng(n)
    major = rng.integers(0, 1000, n)
    minor = rng.integers(0, 1 << 40, n)
    np.testing.assert_array_equal(nativesort.lexsort_pairs(major, minor),
                                  np.lexsort((minor, major)))
    np.testing.assert_array_equal(nativesort.lexsort_pairs(major),
                                  np.argsort(major, kind="stable"))
    # negative keys take numpy's sort, with the same result
    np.testing.assert_array_equal(nativesort.lexsort_pairs(major - 500, minor),
                                  np.lexsort((minor, major - 500)))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No fallback: a source g++ refuses, or no g++ at all, raises."""
    from photon_ml_tpu_torch.utils import nativelib

    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(nativelib, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(nativelib, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for native/broken.cpp"):
        nativelib.load_library("broken")
    (tmp_path / "fine.cpp").write_text('extern "C" int one() { return 1; }\n')
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        nativelib.load_library("fine")
    assert not (tmp_path / "build").exists() or not list((tmp_path / "build").glob("*.so"))
