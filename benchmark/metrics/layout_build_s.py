"""Seconds of set-up spent building the program's fixed-effect layouts (CSR
and CSC of the training and held-out rows on the card): the benchmark's
span around ``GameData.sparse_features``. Moves ``setup_s``."""


def read(r):
    return r.total("setup/layout_build", in_window=False) if r.has(
        "setup/layout_build", in_window=False) else None
