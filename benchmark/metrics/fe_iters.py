"""L-BFGS iterations of the fixed-effect solves a job, from the solves'
results (a count). Moves ``train_s``."""


def read(r):
    return sum(r.fe_iterations) / r.jobs if r.fe_iterations else None
