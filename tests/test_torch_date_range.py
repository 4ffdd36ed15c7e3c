"""The port's date ranges (its own copy of ``utils/date_range.py``) and the
CLIs' date-range expansion of the data dirs, against the JAX package's."""

import datetime
import os

import pytest

from photon_ml_tpu.cli.common import expand_data_dirs as jax_expand
from photon_ml_tpu.utils import date_range as jdr
from photon_ml_tpu_torch.cli.common import expand_data_dirs
from photon_ml_tpu_torch.utils import date_range as tdr

TODAY = datetime.date(2026, 3, 2)


@pytest.mark.parametrize("spec", ["20260225-20260302", "20251231-20260101", "20260301-20260301"])
def test_from_dates_equals_jax(spec):
    ours, theirs = tdr.DateRange.from_dates(spec), jdr.DateRange.from_dates(spec)
    assert (ours.start_date, ours.end_date) == (theirs.start_date, theirs.end_date)
    assert str(ours) == str(theirs)
    assert list(ours.days()) == list(theirs.days())


@pytest.mark.parametrize("spec", ["5-1", "0-0", "400-365"])
def test_from_days_ago_equals_jax(spec):
    ours = tdr.DateRange.from_days_ago(spec, today=TODAY)
    theirs = jdr.DateRange.from_days_ago(spec, today=TODAY)
    assert (ours.start_date, ours.end_date) == (theirs.start_date, theirs.end_date)


@pytest.mark.parametrize("bad", ["2026-0301", "20260302-20260301", "x-y"])
def test_bad_specs_raise_as_jax(bad):
    with pytest.raises(ValueError) as ours:
        tdr.DateRange.from_dates(bad)
    with pytest.raises(ValueError) as theirs:
        jdr.DateRange.from_dates(bad)
    assert str(ours.value) == str(theirs.value)
    for fn in (tdr.DateRange.from_days_ago, jdr.DateRange.from_days_ago):
        with pytest.raises(ValueError, match="couldn't parse days ago"):
            fn("-3-1", today=TODAY)


def _daily_layout(root):
    """Two base dirs of daily yyyy/MM/dd subdirs with gaps."""
    bases = [str(root / "a"), str(root / "b")]
    for base, days in zip(bases, ([25, 27, 28], [26, 28])):
        for d in days:
            os.makedirs(os.path.join(base, "2026", "02", f"{d:02d}"))
    os.makedirs(os.path.join(bases[0], "2026", "03", "01"))
    return bases


def test_paths_for_date_range_equal_jax(tmp_path):
    bases = _daily_layout(tmp_path)
    cases = [
        ("20260226-20260301", None), (None, "5-2"), (None, None), ("20260101-20260102", None),
    ]
    for rng_spec, ago in cases:
        ours = tdr.paths_for_date_range(bases, rng_spec, ago, today=TODAY)
        theirs = jdr.paths_for_date_range(bases, rng_spec, ago, today=TODAY)
        assert ours == theirs
    assert tdr.paths_for_date_range(bases, "20260226-20260301") == [
        os.path.join(bases[0], "2026", "02", d) for d in ("27", "28")
    ] + [os.path.join(bases[0], "2026", "03", "01")] + [
        os.path.join(bases[1], "2026", "02", d) for d in ("26", "28")
    ]
    with pytest.raises(ValueError, match="only one"):
        tdr.paths_for_date_range(bases, "20260226-20260301", "3-1")
    with pytest.raises(FileNotFoundError):
        tdr.input_paths_within_date_range(
            bases, tdr.DateRange.from_dates("20260225-20260226"), error_on_missing=True)


def test_expand_data_dirs_equals_jax(tmp_path):
    bases = _daily_layout(tmp_path)
    assert expand_data_dirs(bases, "20260227-20260228", None) == jax_expand(
        bases, "20260227-20260228", None)
    assert expand_data_dirs(bases, None, None) == bases
    for fn in (expand_data_dirs, jax_expand):
        with pytest.raises(FileNotFoundError, match="no input dirs"):
            fn(bases, "20250101-20250102", None)
