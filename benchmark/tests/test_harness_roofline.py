"""The bound and train_mfu arithmetic on hand-counted shapes, and how the
trace's events are given to the kernels' launches."""

import pytest

from benchmark import roofline, trace
from benchmark.metrics import device_idle_share, fe_kernels_roofline, re_kernel_roofline, train_mfu
from benchmark.reading import Reading

HBM, F32 = 3.35e12, 67e12


def test_csr_and_csc_bounds_count_each_byte_once():
    # n = 4 rows, 10 nonzeros, 8 columns
    assert roofline.csr_matvec_s(4, 10, 8) == pytest.approx((8 * 5 + 8 * 10 + 4 * 8 + 4 * 4) / HBM)
    assert roofline.csc_rmatvec_s(4, 10, 8) == pytest.approx((8 * 9 + 8 * 10 + 4 * 4 + 4 * 8) / HBM)
    assert roofline.fe_pass_s(4, 10, 8) == pytest.approx(
        roofline.csr_matvec_s(4, 10, 8) + roofline.csc_rmatvec_s(4, 10, 8))


def test_value_grad_bound_and_the_larger_of_bytes_and_flops():
    assert roofline.value_grad_s(2, 3, 4) == pytest.approx(4 * 2 * (12 + 9 + 8 + 2) / HBM)
    assert roofline.bound_s(1e6, 1e12) == pytest.approx(1e12 / F32)
    assert roofline.bound_s(1e9, 1.0) == pytest.approx(1e9 / HBM)


def test_model_work_sums_fe_passes_and_entity_passes():
    fe = [(10, 4, 10, 8), (3, 4, 10, 8)]
    re = [(100, 3, 4), (7, 5, 2)]
    want = 13 * roofline.fe_pass_s(4, 10, 8) + 100 * roofline.value_grad_s(1, 3, 4) + \
        7 * roofline.value_grad_s(1, 5, 2)
    assert roofline.model_work_s(fe, re) == pytest.approx(want)
    # an entity's pass is the bucket's pass over its entity count
    assert 100 * roofline.value_grad_s(1, 3, 4) == pytest.approx(roofline.value_grad_s(100, 3, 4))


def _reading(**kw):
    base = dict(spans=[], window=(0.0, 2.0), jobs=2, fe_iterations=[5, 5],
                model_work_s=[0.1, 0.3], kernel_bound_s={}, kernel_device_s={},
                busy_s=1.5)
    base.update(kw)
    return Reading(**base)


def test_train_mfu_and_idle_share():
    assert train_mfu.read(_reading()) == pytest.approx(20.0)
    assert device_idle_share.read(_reading()) == pytest.approx(25.0)
    assert device_idle_share.read(_reading(busy_s=0.0)) is None


def test_rooflines_read_nothing_without_device_time():
    r = _reading(kernel_bound_s={"csr_matvec_f32": 1.0, "csc_rmatvec_f32": 1.0},
                 kernel_device_s={"csr_matvec_f32": 4.0, "csc_rmatvec_f32": 4.0})
    assert fe_kernels_roofline.read(r) == pytest.approx(25.0)
    assert re_kernel_roofline.read(r) is None


def test_trace_events_go_to_their_launch():
    merge = "void merge_path::merge_kernel<(anonymous namespace)::{}>(long const*)"
    events = [
        (merge.format("GatherF32"), 0, 10),
        ("void merge_path::carry_kernel(int const*)", 10, 12),
        ("(anonymous namespace)::sum_blocks_kernel(float const*)", 12, 13),
        ("void at::native::vectorized_elementwise_kernel<4>", 13, 20),
        ("void merge_path::carry_kernel(int const*)", 20, 21),  # after no merge kernel
        (merge.format("Product"), 30, 40),
        ("void merge_path::carry_kernel(int const*)", 40, 41),
        ("void (anonymous namespace)::batched_tiles_kernel<4, 2>(float const*)", 50, 55),
    ]
    got = trace.kernel_seconds(events)
    assert got == pytest.approx({"csr_matvec_f32": 13e-9, "csc_rmatvec_f32": 11e-9,
                                 "fused_value_grad_batched_f32": 5e-9})
    assert trace.busy_intervals([("a", 0, 5), ("b", 3, 8), ("c", 10, 12)]) == [(0, 8), (10, 12)]
