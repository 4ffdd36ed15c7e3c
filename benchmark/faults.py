"""Faults planted in the program's timed path, each of which a cell's
comparison has to find not correct: a solver step that returns its state
unchanged (every solve's, or the fixed effect's alone), half of the rows
left out with the rest weighted twice, an AUC or an objective altered
where the program produces it. Each takes a
``pytest.MonkeyPatch`` (or anything with its ``setattr``) and patches the
program's modules; ``benchmark/tests/test_harness_faults.py`` plants them
in tiny runs, ``benchmark/control.py --variants`` in runs at a cell's own
size. The cells run on one card, so no exchange between cards can be left
out.
"""

import dataclasses


def _stuck_step(monkeypatch):
    """Every L-BFGS step (fixed and random effects) returns its state
    unchanged, its iteration counted."""
    from photon_ml_tpu_torch.opt import lbfgs

    def step(evaluate, s, lanes, config, box):
        return dataclasses.replace(s, it=s.it + lanes.long())

    monkeypatch.setattr(lbfgs, "_lbfgs_step", step)


def _stuck_fixed_effect(monkeypatch):
    """The fixed effect's solve (``train_glm``, alone in the sweep, one
    coordinate of GLMix) steps with its state unchanged; the random
    effects' solves run as they are."""
    from photon_ml_tpu_torch.algorithm import coordinate
    from photon_ml_tpu_torch.estimators import model_training
    from photon_ml_tpu_torch.opt import lbfgs

    real_train, real_step = model_training.train_glm, lbfgs._lbfgs_step

    def step(evaluate, s, lanes, config, box):
        return dataclasses.replace(s, it=s.it + lanes.long())

    def train_glm(*args, **kwargs):
        lbfgs._lbfgs_step = step
        try:
            return real_train(*args, **kwargs)
        finally:
            lbfgs._lbfgs_step = real_step

    monkeypatch.setattr(model_training, "train_glm", train_glm)
    monkeypatch.setattr(coordinate, "train_glm", train_glm)


def _half_batch(monkeypatch):
    """The solvers' objective over the first half of the rows (of each
    entity), weighted twice: the mean taken over the rest."""
    from photon_ml_tpu_torch.estimators import model_training, random_effect

    for module in (model_training, random_effect):
        real = module.make_glm_objective

        def make(loss, real=real):
            obj = real(loss)

            def half(data):
                w = data.weights.clone()
                n = w.shape[-1]
                w[..., n // 2:] = 0
                return dataclasses.replace(data, weights=2 * w)

            return obj._replace(
                value=lambda w, d, l2: obj.value(w, half(d), l2),
                value_and_grad=lambda w, d, l2: obj.value_and_grad(w, half(d), l2),
                hessian_vec=lambda w, v, d, l2: obj.hessian_vec(w, v, half(d), l2),
                hessian_diag=lambda w, d, l2: obj.hessian_diag(w, half(d), l2))

        monkeypatch.setattr(module, "make_glm_objective", make)


def _auc_altered(monkeypatch):
    """Every AUC the program's evaluator produces, 0.01 higher."""
    from photon_ml_tpu_torch.evaluation import evaluators

    real = evaluators.Evaluator.evaluate
    monkeypatch.setattr(evaluators.Evaluator, "evaluate",
                        lambda self, *a, **k: real(self, *a, **k) + 0.01)


def _objective_altered(monkeypatch):
    """Every solve's reported objective 0.1 % high, where the solver
    produces it (fixed effect), and every training objective of coordinate
    descent (GLMix)."""
    from photon_ml_tpu_torch.algorithm import coordinate_descent
    from photon_ml_tpu_torch.estimators import model_training

    real = model_training.solve

    def solve(*args, **kwargs):
        result = real(*args, **kwargs)
        return dataclasses.replace(result, value=result.value * 1.001)

    monkeypatch.setattr(model_training, "solve", solve)
    real_record = coordinate_descent._Run.record

    def record(self, outer, cid, seconds, prev_model):
        real_record(self, outer, cid, seconds, prev_model)
        if self.objective_history and self.objective_history[-1][0] == cid:
            c, v = self.objective_history[-1]
            self.objective_history[-1] = (c, v * 1.001)

    monkeypatch.setattr(coordinate_descent._Run, "record", record)


FAULTS = {"stuck_step": _stuck_step, "stuck_fixed_effect": _stuck_fixed_effect,
          "half_batch": _half_batch, "auc_altered": _auc_altered,
          "objective_altered": _objective_altered}
