"""The parallel plane's bottom layers in the port (``parallel/mesh.py``,
``parallel/multihost.py``), case for case the 18 of
``tests/test_parallel_units.py``: mesh construction, batch padding and
placement, fetches, and the single-process paths of the multi-process
seams. On ``cpu`` a mesh's positions are the host, repeated (the analog of
conftest's forced host devices); the multi-process paths are
``tests/test_torch_multihost.py``'s.
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.ops.data import LabeledData
from photon_ml_tpu_torch.ops.features import DenseFeatures, EllFeatures
from photon_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    P,
    ShardedTensor,
    add_fetch_observer,
    data_parallel_mesh,
    default_devices,
    fetch_global,
    pad_batch_to_multiple,
    place,
    remove_fetch_observer,
    replicate,
    shard_batch,
)
from photon_ml_tpu_torch.parallel.multihost import (
    barrier,
    global_batch_from_host_rows,
    host_shard_files,
    initialize_distributed,
)


def _dense_batch(n=10, d=4, seed=3):
    rng = np.random.default_rng(seed)
    return LabeledData(
        features=DenseFeatures(
            matrix=torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))),
        labels=torch.from_numpy(rng.integers(0, 2, n).astype(np.float32)),
        offsets=torch.zeros(n),
        weights=torch.ones(n),
    )


# ===================================================================== mesh


class TestMeshConstruction:
    def test_default_mesh_spans_all_devices(self):
        mesh = data_parallel_mesh(device="cpu")
        assert mesh.axis_names == (DATA_AXIS,)
        assert mesh.shape[DATA_AXIS] == len(default_devices("cpu"))

    def test_num_devices_takes_a_prefix(self):
        devices = [torch.device("cpu")] * 6
        mesh = data_parallel_mesh(num_devices=4, devices=devices)
        assert mesh.shape[DATA_AXIS] == 4
        assert list(mesh.devices.flat) == devices[:4]
        with pytest.raises(ValueError, match="need 8 devices, have 6"):
            data_parallel_mesh(num_devices=8, devices=devices)

    def test_single_device_mesh_is_valid(self):
        mesh = data_parallel_mesh(num_devices=1, device="cpu")
        assert mesh.shape[DATA_AXIS] == 1 and mesh.home == torch.device("cpu")

    def test_mesh_sum_is_global_sum(self):
        """The port's reduction over an axis: each position's partial moved
        to the output's device and summed in position order (the JAX test's
        shard_map psum)."""
        mesh = data_parallel_mesh(num_devices=4, device="cpu")
        x = torch.arange(8, dtype=torch.float32)
        xs = place(x, mesh, P(DATA_AXIS))
        total = sum(blk.sum().to(mesh.home) for blk in xs.addressable_shards)
        assert float(total) == float(x.sum())


# ================================================================== padding


class TestPadBatch:
    def test_divisible_batch_is_untouched(self):
        data = _dense_batch(n=8)
        assert pad_batch_to_multiple(data, 4) is data

    def test_padding_rows_are_algebraic_noops(self):
        data = _dense_batch(n=10)
        padded = pad_batch_to_multiple(data, 4)
        assert padded.labels.shape[0] == 12
        assert torch.equal(padded.weights[10:], torch.zeros(2))
        assert torch.equal(padded.labels[10:], torch.zeros(2))
        assert torch.equal(padded.features.matrix[10:], torch.zeros(2, 4))
        assert torch.equal(padded.features.matrix[:10], data.features.matrix)

    def test_ell_features_pad_values_and_indices(self):
        n, k = 6, 3
        data = LabeledData(
            features=EllFeatures(values=torch.ones(n, k),
                                 indices=torch.zeros(n, k, dtype=torch.int64), num_cols=5),
            labels=torch.ones(n), offsets=torch.zeros(n), weights=torch.ones(n),
        )
        padded = pad_batch_to_multiple(data, 4)
        assert padded.features.values.shape == (8, k)
        assert padded.features.indices.shape == (8, k)
        assert padded.features.num_cols == 5
        assert torch.equal(padded.features.values[6:], torch.zeros(2, k))


# ================================================================ placement


class TestPlacement:
    def test_place_rows_shards_over_data_axis(self):
        mesh = data_parallel_mesh(num_devices=4, device="cpu")
        x = np.arange(12, dtype=np.float32)
        placed = place(x, mesh, P(DATA_AXIS))
        assert isinstance(placed, ShardedTensor) and tuple(placed.spec) == (DATA_AXIS,)
        assert {tuple(s.shape) for s in placed.addressable_shards} == {(3,)}
        np.testing.assert_array_equal(fetch_global(placed), x)

    def test_replicate_puts_full_copy_on_every_device(self):
        mesh = data_parallel_mesh(num_devices=4, device="cpu")
        rep = replicate({"w": np.arange(5, dtype=np.float32)}, mesh)
        assert {tuple(s.shape) for s in rep["w"].addressable_shards} == {(5,)}
        assert len(rep["w"].addressable_shards) == 4

    def test_shard_batch_pads_then_places(self):
        mesh = data_parallel_mesh(num_devices=4, device="cpu")
        sharded = shard_batch(_dense_batch(n=10, d=4), mesh)
        assert sharded.labels.shape == (12,)
        assert tuple(sharded.labels.spec) == (DATA_AXIS,)
        assert tuple(sharded.features.matrix.spec) == (DATA_AXIS, None)
        assert {tuple(s.shape) for s in sharded.features.matrix.addressable_shards} == {(3, 4)}
        np.testing.assert_array_equal(fetch_global(sharded.weights)[10:], 0.0)


# ============================================================== fetch_global


class TestFetchGlobal:
    def test_numpy_passthrough(self):
        x = np.arange(4.0)
        np.testing.assert_array_equal(fetch_global(x), x)

    def test_sharded_array_roundtrips(self):
        mesh = data_parallel_mesh(num_devices=4, device="cpu")
        x = np.arange(8, dtype=np.float32)
        np.testing.assert_array_equal(fetch_global(place(x, mesh, P(DATA_AXIS))), x)

    def test_observer_sees_device_fetches_only(self):
        seen = []
        add_fetch_observer(seen.append)
        try:
            fetch_global(np.zeros(4))  # host input: not a device fetch
            assert seen == []
            fetch_global(torch.zeros(4))
            assert seen == [16]
        finally:
            remove_fetch_observer(seen.append)


# ======================================================== multihost seams


class TestMultihostDegeneratePaths:
    """One process: every seam is the identity (the multi-process branches
    are tests/test_torch_multihost.py's)."""

    def test_host_shard_files_returns_all_sorted(self):
        files = ["b.avro", "a.avro", "c.avro"]
        assert host_shard_files(files) == sorted(files)

    def test_barrier_is_noop(self):
        barrier("unit-test")

    def test_global_batch_is_plain_placement(self):
        mesh = data_parallel_mesh(num_devices=4, device="cpu")
        rows = np.arange(8, dtype=np.float32).reshape(4, 2)
        got = global_batch_from_host_rows(rows, mesh, P(DATA_AXIS, None))
        assert tuple(got.spec) == (DATA_AXIS, None)
        np.testing.assert_array_equal(fetch_global(got), rows)

    def test_initialize_without_a_request_is_false(self):
        # nothing on a machine announces a cluster: a single process
        assert initialize_distributed(device="cpu") is False
        assert initialize_distributed("127.0.0.1:1", 1, 0, device="cpu") is False

    def test_partial_cluster_request_raises(self):
        with pytest.raises(ValueError, match="together"):
            initialize_distributed(coordinator_address="127.0.0.1:1234", device="cpu")
