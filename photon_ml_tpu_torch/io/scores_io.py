"""Scored-item persistence (ScoringResultAvro).

Reference parity: data/avro/ScoreProcessingUtils.scala:29 — ScoredItem
(predictionScore, label?, weight?, uid?, idTag map) ↔ ScoringResultAvro.
Copy of ``photon_ml_tpu/io/scores_io.py``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Iterator, List, Optional

from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro import read_avro_dir, write_avro_file


@dataclasses.dataclass
class ScoredItem:
    """One scored datum (reference scoring/ScoredItem.scala)."""

    prediction_score: float
    label: Optional[float] = None
    weight: Optional[float] = None
    uid: Optional[str] = None
    id_tags: Dict[str, str] = dataclasses.field(default_factory=dict)


def save_scores(
    path: str,
    items: Iterable[ScoredItem],
    model_id: str,
    records_per_file: int = 1_000_000,
    file_sizes: Optional[List[int]] = None,
) -> int:
    """Write ScoringResultAvro part files under ``path``; returns count.

    ``file_sizes`` forces an exact per-file record partition (the reference
    --num-files contract: exactly N part files, empty ones included);
    zero-sized entries may only TRAIL the list (records are assigned in
    order). Otherwise files roll over every ``records_per_file`` records."""
    os.makedirs(path, exist_ok=True)
    schema = schemas.scoring_result_schema()
    total = 0
    part = 0
    batch: List[dict] = []
    sizes = list(file_sizes) if file_sizes is not None else None

    def _current_cap() -> int:
        if sizes is None:
            return records_per_file
        return sizes[part] if part < len(sizes) else max(sizes[-1], 1)

    def flush(force: bool = False) -> None:
        nonlocal part, batch
        if batch or force:
            write_avro_file(
                os.path.join(path, f"part-{part:05d}.avro"), schema, batch
            )
            part += 1
            batch = []

    for item in items:
        batch.append(
            {
                "uid": item.uid,
                "label": None if item.label is None else float(item.label),
                "modelId": model_id,
                "predictionScore": float(item.prediction_score),
                "weight": None if item.weight is None else float(item.weight),
                "metadataMap": dict(item.id_tags) or None,
            }
        )
        total += 1
        if len(batch) >= _current_cap():
            flush()
    flush()
    if sizes is not None:
        while part < len(sizes):
            flush(force=True)  # empty trailing parts keep the exact count
    return total


def load_scores(path: str) -> Iterator[ScoredItem]:
    for rec in read_avro_dir(path):
        yield ScoredItem(
            prediction_score=rec["predictionScore"],
            label=rec.get("label"),
            weight=rec.get("weight"),
            uid=rec.get("uid"),
            id_tags=rec.get("metadataMap") or {},
        )
