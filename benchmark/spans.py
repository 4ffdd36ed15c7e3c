"""The benchmark's own spans, around its calls into the program's layers,
on the host's ``time.perf_counter`` clock."""

from __future__ import annotations

import contextlib
import time
from typing import List

import torch


class Spans:
    def __init__(self) -> None:
        self.records: List[dict] = []

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.records.append({"name": name, "start": start,
                                 "dur": time.perf_counter() - start, "attrs": attrs})

    @staticmethod
    def sync(device) -> None:
        """Wait for the device's queued work, so that a span ends with it."""
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
