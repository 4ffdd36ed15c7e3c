"""Milliseconds a fixed-effect L-BFGS iteration: the fixed-effect solves'
seconds (the program's ``fe/solve`` spans in a GLMix fit; the benchmark's
span around ``train_glm`` in a sweep) over their iterations. Moves
``train_s``."""


def read(r):
    iters = sum(r.fe_iterations)
    if not iters:
        return None
    name = "fe/solve" if r.has("fe/solve") else "job/train_glm"
    return 1e3 * r.total(name) / iters if r.has(name) else None
