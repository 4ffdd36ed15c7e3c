"""The jobs' model work at the card's peak over the window's wall time, in
%: one value-and-gradient pass a solver iteration over the fixed-effect
matrix and over each random-effect entity's block, each at the larger of
its bytes and f32 bounds (``roofline.model_work_s``). Moves ``train_s``."""


def read(r):
    start, end = r.window
    if not r.model_work_s or end <= start:
        return None
    return 100.0 * sum(r.model_work_s) / (end - start)
