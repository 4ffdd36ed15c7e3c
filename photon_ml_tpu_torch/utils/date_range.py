"""Date ranges as dataset coordinates.

Reference parity: util/DateRange.scala (range specs ``yyyyMMdd-yyyyMMdd``
and days-ago ``start-end``), IOUtils.getInputPathsWithinDateRange (daily
``<base>/yyyy/MM/dd`` subdirectories), and GameDriver.pathsForDateRange
(GameDriver.scala:103: date-range XOR days-ago, else the base dirs as-is;
missing daily dirs tolerated).

Own copy of ``photon_ml_tpu/utils/date_range.py``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class DateRange:
    start_date: datetime.date
    end_date: datetime.date

    def __post_init__(self) -> None:
        if self.start_date > self.end_date:
            raise ValueError(
                f"invalid range: start date {self.start_date} comes after "
                f"end date {self.end_date}"
            )

    def __str__(self) -> str:
        return f"{self.start_date}-{self.end_date}"

    def days(self):
        d = self.start_date
        while d <= self.end_date:
            yield d
            d += datetime.timedelta(days=1)

    @classmethod
    def from_dates(cls, spec: str) -> "DateRange":
        """``yyyyMMdd-yyyyMMdd``."""
        try:
            start, end = spec.split("-", 1)
            fmt = "%Y%m%d"
            return cls(
                datetime.datetime.strptime(start.strip(), fmt).date(),
                datetime.datetime.strptime(end.strip(), fmt).date(),
            )
        except (ValueError, AttributeError) as e:
            raise ValueError(f"couldn't parse the date range: {spec}") from e

    @classmethod
    def from_days_ago(
        cls, spec: str, today: Optional[datetime.date] = None
    ) -> "DateRange":
        """``startDaysAgo-endDaysAgo`` (e.g. ``90-1``)."""
        today = today or datetime.date.today()
        try:
            start_ago, end_ago = (int(x) for x in spec.split("-", 1))
        except ValueError as e:
            raise ValueError(f"couldn't parse days ago: {spec}") from e
        if start_ago < 0 or end_ago < 0:
            raise ValueError("days ago cannot be negative")
        return cls(
            today - datetime.timedelta(days=start_ago),
            today - datetime.timedelta(days=end_ago),
        )


def input_paths_within_date_range(
    base_dirs: Sequence[str],
    date_range: DateRange,
    error_on_missing: bool = False,
) -> List[str]:
    """``<base>/yyyy/MM/dd`` per day in range; missing days skipped unless
    ``error_on_missing``."""
    out: List[str] = []
    for base in base_dirs:
        for day in date_range.days():
            p = os.path.join(
                base, f"{day.year:04d}", f"{day.month:02d}", f"{day.day:02d}"
            )
            if os.path.isdir(p):
                out.append(p)
            elif error_on_missing:
                raise FileNotFoundError(p)
    return out


def paths_for_date_range(
    base_dirs: Sequence[str],
    date_range_spec: Optional[str] = None,
    days_ago_spec: Optional[str] = None,
    today: Optional[datetime.date] = None,
) -> List[str]:
    """GameDriver.pathsForDateRange: range XOR days-ago, else base dirs."""
    if date_range_spec and days_ago_spec:
        raise ValueError(
            "both date range and days ago given; specify only one format"
        )
    if date_range_spec:
        rng = DateRange.from_dates(date_range_spec)
    elif days_ago_spec:
        rng = DateRange.from_days_ago(days_ago_spec, today=today)
    else:
        return list(base_dirs)
    return input_paths_within_date_range(base_dirs, rng)
