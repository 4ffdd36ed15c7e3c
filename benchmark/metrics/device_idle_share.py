"""Share of the traced window in which no operation ran on the card:
1 - (union of the device's event intervals) / window, in %. Moves
``train_s``."""


def read(r):
    start, end = r.window
    if end <= start or r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / (end - start))
