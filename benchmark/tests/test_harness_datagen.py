"""The data maker: deterministic from the seed, every seed the same rows in
another order, each row's columns sorted and distinct."""

import pytest
import torch

from benchmark import datagen
from benchmark.tests import tiny


def _make(workload, seed):
    _, config, traffic, _ = tiny.inputs(workload)
    return datagen.make(config, traffic, seed, "cpu"), config


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_same_seed_same_data(workload):
    a, _ = _make(workload, 5)
    b, _ = _make(workload, 5)
    for ra, rb in ((a.train, b.train), (a.heldout, b.heldout)):
        assert torch.equal(ra.labels, rb.labels)
        for name in ra.shards:
            assert torch.equal(ra.shards[name].cols, rb.shards[name].cols)
            assert torch.equal(ra.shards[name].vals, rb.shards[name].vals)
        for name in ra.entity:
            assert torch.equal(ra.entity[name], rb.entity[name])


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_another_seed_is_the_same_rows_in_another_order(workload):
    a, _ = _make(workload, 5)
    b, _ = _make(workload, 2**31 + 6)
    assert not torch.equal(a.train.labels, b.train.labels)
    assert a.train.labels.sum() == b.train.labels.sum()
    va, vb = a.train.shards["global"].vals, b.train.shards["global"].vals
    assert torch.equal(torch.sort(va.reshape(-1)).values, torch.sort(vb.reshape(-1)).values)


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_rows_sorted_and_free_of_duplicates(workload):
    data, config = _make(workload, 2**31 + 3)
    for rows in (data.train, data.heldout):
        fe = rows.shards["global"]
        assert bool((fe.cols[:, 1:] > fe.cols[:, :-1]).all())
        assert bool((fe.cols[:, -1] == config["fixed_effect"]["features"]).all())
        assert bool((fe.vals[:, -1] == 1).all())
        for name in rows.entity:
            sh = rows.shards[name]
            assert bool((sh.cols[:, 1:] > sh.cols[:, :-1]).all())
            assert int(sh.cols.max()) < sh.dim
        r, c, _ = datagen.coo(fe)
        # the order the port's coalescing takes without a sort
        assert ((r[1:] > r[:-1]) | ((r[1:] == r[:-1]) & (c[1:] > c[:-1]))).all()


def test_entity_names():
    import numpy as np

    names = datagen.entity_names("per_user", np.array([0, 3, 3]), np.array([False, True, False]))
    assert list(names) == ["u0", "new_u3", "u3"]


def test_entities_are_zipf_popular():
    """The entity of popularity rank 1 holds about 1 / sum_k k^-s of the
    rows, and every seed renumbers the entities, not their counts."""
    _, config, traffic, _ = tiny.inputs("glmix_fit.rows_2p22")
    s = traffic["entity_zipf_exponent"]
    for seed in (7, 2**31 + 8):
        data = datagen.make(config, traffic, seed, "cpu")
        for name, re in config["random_effects"].items():
            counts = torch.bincount(data.train.entity[name], minlength=re["entities"])
            head = 1 / sum(k ** -s for k in range(1, re["entities"] + 1))
            share = float(counts.max()) / data.train.num_rows
            assert abs(share - head) < 0.1 * head, (name, share, head)
            assert counts.max() > 10 * counts.float().median()
