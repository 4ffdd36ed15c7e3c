"""Shared set-up of the port's nearline-loop parity tests: one GLMix model
(a fixed effect and a per-user random effect) fitted once by the JAX
package and carried into the port, both packages' serving artifacts of it,
and one events batch that touches some users and brings new ones."""

from __future__ import annotations

import contextlib
import os

import numpy as np

from _torch_parity import coordinates_of_jax_model

N_USERS, ROWS, DG, DU = 8, 20, 6, 3
TOUCHED = [f"u{i}" for i in range(4)]
UNTOUCHED = [f"u{i}" for i in range(4, N_USERS)]
NEW = ["v0", "v1"]


@contextlib.contextmanager
def jax_plain_phix_writer():
    """The JAX package writes its PHIX stores with its pure-Python writer:
    then its artifacts are byte-equal to the port's, and so are their
    fingerprints (its native writer leaves unread bytes of empty slots
    unset)."""
    from photon_ml_tpu.indexmap import offheap as joffheap

    saved = joffheap._lib, joffheap._lib_failed
    joffheap._lib, joffheap._lib_failed = None, True
    try:
        yield
    finally:
        joffheap._lib, joffheap._lib_failed = saved


def _rows(rng, users, rows, wg, wu):
    """(labels, shards, id_tags) of a linear GLMix over ``users``."""
    n = len(users) * rows
    Xg = rng.normal(size=(n, DG)).astype(np.float32)
    Xu = rng.normal(size=(n, DU)).astype(np.float32)
    ids = np.repeat(users, rows)
    y = Xg @ wg + np.array([Xu[i] @ wu[ids[i]] for i in range(n)], np.float32)
    y = (y + 0.05 * rng.normal(size=n)).astype(np.float32)
    shards = {}
    for name, X in (("g", Xg), ("u", Xu)):
        r, c = np.nonzero(X)
        shards[name] = (r, c, X[r, c], X.shape[1])
    return y, shards, {"userId": ids}


def dataset(pkg: str, rows):
    """``rows`` as the JAX package's (``pkg="jax"``) or the port's GameData."""
    if pkg == "jax":
        from photon_ml_tpu.data.game_data import FeatureShard, GameData
    else:
        from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData
    y, shards, ids = rows
    return GameData(labels=y, feature_shards={k: FeatureShard(*v) for k, v in shards.items()},
                    id_tags=ids)


def estimators(num_outer: int = 1, factored: bool = False):
    """(JAX estimator, port estimator on the CPU): fixed + per_user, L2, and
    with ``factored`` a factored coordinate over userId as well."""
    from photon_ml_tpu.algorithm import factored_random_effect as jfre
    from photon_ml_tpu.data import RandomEffectDataConfiguration as JRe
    from photon_ml_tpu.estimators import game as jg
    from photon_ml_tpu.opt import GlmOptimizationConfiguration as JOpt
    from photon_ml_tpu.opt import RegularizationContext as JReg
    from photon_ml_tpu.types import RegularizationType as JRT
    from photon_ml_tpu.types import TaskType as JTask
    from photon_ml_tpu_torch.algorithm import factored_random_effect as tfre
    from photon_ml_tpu_torch.data.random_effect import RandomEffectDataConfiguration as TRe
    from photon_ml_tpu_torch.estimators import game as tg
    from photon_ml_tpu_torch.opt.config import GlmOptimizationConfiguration as TOpt
    from photon_ml_tpu_torch.opt.config import RegularizationContext as TReg
    from photon_ml_tpu_torch.types import RegularizationType as TRT
    from photon_ml_tpu_torch.types import TaskType as TTask

    def coords(g, Re, Opt, Reg, RT, fre):
        l2 = lambda lam: Opt(regularization=Reg(RT.L2), regularization_weight=lam)  # noqa: E731
        c = {"fixed": g.FixedEffectCoordinateConfiguration("g", l2(0.1)),
             "per_user": g.RandomEffectCoordinateConfiguration(
                 "u", Re(random_effect_type="userId"), l2(1.0))}
        if factored:
            c["mf"] = g.FactoredRandomEffectCoordinateConfiguration(
                "u", Re(random_effect_type="userId"), fre.MFOptimizationConfiguration(2, 1),
                l2(1.0))
        return c

    order = ["fixed", "per_user"] + (["mf"] if factored else [])
    j = jg.GameEstimator(task=JTask.LINEAR_REGRESSION,
                         coordinates=coords(jg, JRe, JOpt, JReg, JRT, jfre),
                         update_order=order, num_outer_iterations=num_outer,
                         **({"score_plane": "host"} if factored else {}))
    t = tg.GameEstimator(task=TTask.LINEAR_REGRESSION,
                         coordinates=coords(tg, TRe, TOpt, TReg, TRT, tfre),
                         update_order=order, num_outer_iterations=num_outer, device="cpu")
    return j, t


def make_nearline(root: str) -> dict:
    """The base fit, both packages' models and saved artifacts, the events
    batch, the base rows (``base_rows``) and the fingerprint of each
    artifact directory."""
    import photon_ml_tpu.serving as J
    import photon_ml_tpu_torch.serving as T
    from photon_ml_tpu_torch.convert import game_model_from_numpy

    rng = np.random.default_rng(7)
    wg = rng.normal(size=DG).astype(np.float32)
    users = [f"u{i}" for i in range(N_USERS)]
    wu = {u: rng.normal(size=DU).astype(np.float32) for u in users + NEW}
    base_rows = _rows(rng, users, ROWS, wg, wu)
    event_rows = _rows(rng, TOUCHED + NEW, ROWS // 2, wg, wu)
    je, _ = estimators(num_outer=2)
    jmodel = je.fit(dataset("jax", base_rows)).model
    tmodel = game_model_from_numpy(coordinates_of_jax_model(jmodel), "LINEAR_REGRESSION",
                                   device="cpu")
    ja = J.pack_game_model(jmodel, model_name="nearline-test")
    ta = T.pack_game_model(tmodel, model_name="nearline-test")
    jdir, tdir = os.path.join(root, "jax_artifact"), os.path.join(root, "port_artifact")
    with jax_plain_phix_writer():
        J.save_artifact(ja, jdir)
    T.save_artifact(ta, tdir)
    return {"jmodel": jmodel, "tmodel": tmodel, "ja": ja, "ta": ta, "jdir": jdir,
            "tdir": tdir, "base_rows": base_rows, "event_rows": event_rows,
            "jevents": dataset("jax", event_rows), "tevents": dataset("port", event_rows)}


def scores(scorer, requests, bucket: int = 16) -> dict:
    """request id -> score, in buckets of ``bucket``."""
    out = {}
    for i in range(0, len(requests), bucket):
        for r in scorer.score_batch(requests[i:i + bucket], bucket_size=bucket):
            out[r.request_id] = r.score
    return out


def assert_scores_close(port: dict, jax: dict, rtol: float = 2e-4, atol: float = 1e-5):
    assert sorted(port) == sorted(jax)
    np.testing.assert_allclose([port[k] for k in sorted(port)], [jax[k] for k in sorted(jax)],
                               rtol=rtol, atol=atol)
