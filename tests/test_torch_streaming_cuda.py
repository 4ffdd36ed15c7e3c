"""Streaming on the card: the pinned prefetcher's uploads, the streamed
solver and the residency plane on cuda, against the same work on the host.

- every block uploaded through the ring of pinned staging slots equals its
  HostBlock, at depths that make the ring wrap many times (a slot reused
  before its copy finished would upload a wrong block), with the same h2d
  bytes as the host's;
- ``solve_streaming`` on cuda: objective rtol 1e-4 and coefficients atol
  2e-3 of the host's solve, and bitwise the same on a second run; a
  coordinate with resident blocks bitwise the one without.

Run on a machine with a card: ``python -m pytest --noconftest
tests/test_torch_streaming_cuda.py``. Without one, every test here skips.
"""

import os

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch import streaming
from photon_ml_tpu_torch.io import data_reader
from photon_ml_tpu_torch.opt.config import GlmOptimizationConfiguration, RegularizationContext
from photon_ml_tpu_torch.types import RegularizationType, TaskType

pytestmark = pytest.mark.cuda

ROWS, FILES, DIM, K, BLOCK_ROWS = 2000, 3, 64, 6, 128


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    rng = np.random.default_rng(5)
    root = tmp_path_factory.mktemp("stream_cuda")
    w = rng.normal(size=DIM)
    paths, per = [], ROWS // FILES
    for fi in range(FILES):
        recs = []
        for i in range(fi * per, (fi + 1) * per):
            cols = rng.choice(DIM, K, replace=False)
            vals = rng.normal(size=K)
            label = float(rng.random() < 1 / (1 + np.exp(-vals @ w[cols])))
            recs.append({"uid": f"r{i}", "label": label,
                         "features": [("g", str(c), float(v)) for c, v in zip(cols, vals)],
                         "metadataMap": {"userId": f"u{i % 7}"}})
        path = os.path.join(str(root), f"part-{fi:05d}.avro")
        data_reader.write_training_examples(path, recs)
        paths.append(path)
    shards = {"global": data_reader.FeatureShardConfiguration(("features",), add_intercept=True)}
    return streaming.StreamingSource.open(
        paths, shards, index_maps=data_reader.build_index_maps(paths, shards),
        block_rows=BLOCK_ROWS, id_tags=("userId",))


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_pinned_uploads_equal_the_host_blocks(card, source, depth):
    order = list(range(source.plan.num_blocks)) * 3
    p = streaming.BlockPrefetcher(source, shards=("global",), depth=depth, order=order,
                                  device=card)
    uploaded = list(p)  # all kept alive: no buffer of one may be reused by another
    torch.cuda.synchronize()
    assert [b.index for b in uploaded] == order
    for blk in uploaded:
        host = source.build_block(blk.index, shards=("global",))
        d = blk.data["global"]
        vals, idx = host.shards["global"]
        assert torch.equal(d.features.values.cpu(), torch.from_numpy(np.array(vals)))
        assert torch.equal(d.features.indices.cpu(), torch.from_numpy(np.array(idx, np.int64)))
        for f in ("labels", "offsets", "weights"):
            assert torch.equal(getattr(d, f).cpu(), torch.from_numpy(np.array(getattr(host, f))))
    host_p = streaming.BlockPrefetcher(source, shards=("global",), depth=depth, order=order,
                                       device="cpu")
    list(host_p)
    assert p.stats.h2d_bytes == host_p.stats.h2d_bytes


def _coordinate(source, device, **kw):
    cfg = GlmOptimizationConfiguration(
        regularization=RegularizationContext(RegularizationType.L2), regularization_weight=0.5)
    return streaming.StreamingFixedEffectCoordinate(
        source=source, shard_id="global", task=TaskType.LOGISTIC_REGRESSION,
        configuration=cfg, device=device, **kw)


def test_streamed_solve_on_the_card_matches_the_host(card, source):
    zeros = torch.zeros(source.plan.total_rows)
    host = _coordinate(source, "cpu").update_model_device(None, zeros)
    models = [_coordinate(source, card, **kw).update_model_device(None, zeros.to(card))
              for kw in ({}, {}, {"resident_blocks": 3})]
    w = [m.coefficients.means for m in models]
    assert torch.equal(w[0], w[1]) and torch.equal(w[0], w[2])
    np.testing.assert_allclose(w[0].cpu().numpy(), host.coefficients.means.numpy(), atol=2e-3)
    coord = _coordinate(source, card)
    coord.update_model_device(None, zeros.to(card))
    f_card = coord.last_tracker.states.values[-1]
    coord_host = _coordinate(source, "cpu")
    coord_host.update_model_device(None, zeros)
    assert f_card == pytest.approx(coord_host.last_tracker.states.values[-1], rel=1e-4)
