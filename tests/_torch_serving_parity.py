"""Shared set-up of the port's serving parity tests: one seeded GLMix model
packed by both packages, and the same request stream for each."""

from __future__ import annotations

import numpy as np

from _torch_parity import (
    coordinates_of_jax_model,
    glmix_numpy,
    jax_game_data,
    jax_game_model,
    torch_game_data,
)

RTOL, ATOL = 2e-4, 1e-6


def serving_pair(seed: int = 1, n: int = 48, counts=None, task: str = "LOGISTIC_REGRESSION"):
    """(jax artifact, port artifact, jax requests, port requests) of one
    GLMix model with two random effects (~10 % unseen entities), small
    widths."""
    import photon_ml_tpu.serving as J
    import photon_ml_tpu_torch.serving as T
    from photon_ml_tpu_torch.convert import game_model_from_numpy

    kw = {} if counts is None else {"counts": counts}
    labels, shards, id_tags, coords = glmix_numpy(
        seed=seed, n=n, fe_dim=16, fe_k=4, re_dim=12, re_local=5, re_k=3, **kw
    )
    jm = jax_game_model(coords, task)
    tm = game_model_from_numpy(coordinates_of_jax_model(jm), jm.task, device="cpu")
    ja, ta = J.pack_game_model(jm), T.pack_game_model(tm)
    jr = J.requests_from_game_data(jax_game_data(labels, shards, id_tags), ja)
    tr = T.requests_from_game_data(torch_game_data(labels, shards, id_tags), ta)
    return ja, ta, jr, tr


def assert_results_close(port, jax, rtol=RTOL, atol=ATOL):
    """Same ids and cold coordinates; scores and means within tolerance."""
    assert [r.request_id for r in port] == [r.request_id for r in jax]
    assert [r.cold_coordinates for r in port] == [r.cold_coordinates for r in jax]
    np.testing.assert_allclose([r.score for r in port], [r.score for r in jax],
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose([r.mean for r in port], [r.mean for r in jax],
                               rtol=rtol, atol=atol)


class ManualClock:
    """A clock the test advances by hand."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt
