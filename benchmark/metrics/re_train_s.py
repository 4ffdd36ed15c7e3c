"""Seconds a job in the program's ``re/train`` spans (every random-effect
coordinate update: the batched solves of its buckets). Moves ``train_s``."""


def read(r):
    return r.total("re/train") / r.jobs if r.has("re/train") else None
