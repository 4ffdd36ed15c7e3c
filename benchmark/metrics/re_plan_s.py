"""Seconds of set-up spent building the random-effect coordinates (the host
bucket planning and the padded blocks placed on the card): the benchmark's
span around ``GameEstimator.build_coordinates`` once the fixed-effect
layouts are built. Moves ``setup_s``."""


def read(r):
    return r.total("setup/build_coordinates", in_window=False) if r.has(
        "setup/build_coordinates", in_window=False) else None
