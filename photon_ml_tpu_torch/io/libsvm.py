"""LibSVM text input, and the LibSVM → TrainingExampleAvro converter.

Port of ``photon_ml_tpu/io/libsvm.py`` (reference
io/deprecated/LibSVMInputDataFormat.scala:31: ``[label] [idx]:[val] ...``,
1-based indices unless ``zero_based``, classification labels mapped to
{0, 1} by sign, an optional intercept as the last column with an identity
index map; dev-scripts/libsvm_text_to_trainingexample_avro.py: feature name
= index, empty term). Host numpy; it builds the port's own ``GameData``.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.data.game_data import FeatureShard, GameData
from photon_ml_tpu_torch.indexmap import INTERCEPT_KEY, DefaultIndexMap, IndexMap


def _parse_line(line: str, zero_based: bool) -> Tuple[float, List[int], List[float]]:
    parts = line.split()
    label = float(parts[0])
    idxs: List[int] = []
    vals: List[float] = []
    for item in parts[1:]:
        if item.startswith("#"):  # trailing comment
            break
        i, _, v = item.partition(":")
        idx = int(i) - (0 if zero_based else 1)
        if idx < 0:
            raise ValueError(f"feature index {i} underflows (zero_based={zero_based})")
        idxs.append(idx)
        vals.append(float(v))
    return label, idxs, vals


def iter_libsvm(path: str, zero_based: bool = False) -> Iterator[Tuple[float, List[int], List[float]]]:
    """(label, indices, values) of every data line of a file, or of the
    part files of a directory (hidden and ``_``-marker files skipped)."""
    paths = [path]
    if os.path.isdir(path):
        paths = sorted(
            p for n in os.listdir(path)
            if not n.startswith((".", "_")) and os.path.isfile(p := os.path.join(path, n))
        )
    for p in paths:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                yield _parse_line(line, zero_based)


def read_libsvm(
    path: str,
    feature_dimension: Optional[int] = None,
    use_intercept: bool = True,
    zero_based: bool = False,
    binarize_labels: bool = True,
) -> Tuple[GameData, IndexMap]:
    """LibSVM file or directory → GameData with one "features" shard.

    ``binarize_labels`` maps labels by sign to {0, 1} (the reference's
    classification path; a1a uses ±1). The index map is identity-style
    (key = column index as a string; the intercept last). Features at or
    beyond a given ``feature_dimension`` are dropped, as scoring over a
    fixed training index drops unseen features."""
    rows: List[int] = []
    cols: List[int] = []
    vals: List[float] = []
    labels: List[float] = []
    max_idx = -1
    for r, (label, idxs, vs) in enumerate(iter_libsvm(path, zero_based)):
        labels.append((1.0 if label > 0 else 0.0) if binarize_labels else label)
        rows.extend([r] * len(idxs))
        cols.extend(idxs)
        vals.extend(vs)
        if idxs:
            max_idx = max(max_idx, max(idxs))
    n = len(labels)
    d = feature_dimension if feature_dimension is not None else max_idx + 1
    rows_a = np.asarray(rows, dtype=np.int64)
    cols_a = np.asarray(cols, dtype=np.int64)
    vals_a = np.asarray(vals, dtype=np.float32)
    if max_idx >= d:
        keep = cols_a < d
        rows_a, cols_a, vals_a = rows_a[keep], cols_a[keep], vals_a[keep]
    name_to_index = {str(i): i for i in range(d)}
    dim = d
    if use_intercept:
        rows_a = np.concatenate([rows_a, np.arange(n, dtype=np.int64)])
        cols_a = np.concatenate([cols_a, np.full(n, d, dtype=np.int64)])
        vals_a = np.concatenate([vals_a, np.ones(n, dtype=np.float32)])
        name_to_index[INTERCEPT_KEY] = d
        dim = d + 1
    data = GameData(
        labels=np.asarray(labels, dtype=np.float32),
        feature_shards={"features": FeatureShard(rows=rows_a, cols=cols_a, vals=vals_a, dim=dim)},
        id_tags={},
    )
    return data, DefaultIndexMap(name_to_index)


def libsvm_to_training_example_avro(
    input_path: str, output_path: str, regression: bool = False, zero_based: bool = False,
) -> int:
    """dev-scripts/libsvm_text_to_trainingexample_avro.py: feature name =
    index string, empty term; classification labels mapped by sign to
    {0, 1} unless ``regression``. Returns the records written."""
    from photon_ml_tpu_torch.io.data_reader import write_training_examples

    records = []
    for label, idxs, vs in iter_libsvm(input_path, zero_based):
        if not regression:
            label = 1.0 if label > 0 else 0.0
        records.append({
            "label": float(label),
            "features": [(str(i), "", float(v)) for i, v in zip(idxs, vs)],
        })
    return write_training_examples(output_path, records)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="libsvm-to-avro",
        description="Convert LibSVM text to TrainingExampleAvro "
                    "(dev-scripts/libsvm_text_to_trainingexample_avro.py).",
    )
    p.add_argument("input_path")
    p.add_argument("output_path")
    p.add_argument("-r", "--regression", action="store_true",
                   help="keep raw labels instead of sign-binarizing")
    p.add_argument("--zero-based", action="store_true")
    args = p.parse_args(argv)
    n = libsvm_to_training_example_avro(
        args.input_path, args.output_path, regression=args.regression, zero_based=args.zero_based,
    )
    print(f"wrote {n} records to {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
