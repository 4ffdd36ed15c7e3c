"""Feature indexing job: build partitioned off-heap index maps from Avro.

Port of ``photon_ml_tpu/cli/build_index.py`` (reference
FeatureIndexingJob.scala:56): scan Avro input dirs for distinct
(name, term) features per feature shard, hash-partition, and write an
off-heap PHIX store per shard (:92-179; PalDB there) that ``score_game``,
``train_game`` and ``train_glm`` open with ``--offheap-indexmap-dir``
without loading it into the heap. The key scan runs through the native
columnar decoder (``io/data_reader.feature_keys``) and the keys stay
packed bytes; the builder sorts and deduplicates them natively, so the
stores are byte-equal to the JAX CLI's.

Usage:
    python -m photon_ml_tpu_torch.cli.build_index \\
        --data-dirs data/train --output-dir indexes/ \\
        --feature-shard global=features,userFeatures --feature-shard user=userFeatures
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from photon_ml_tpu_torch.cli.common import expand_data_dirs, setup_logger
from photon_ml_tpu_torch.indexmap import INTERCEPT_KEY
from photon_ml_tpu_torch.indexmap.offheap import build_offheap_index_map_packed
from photon_ml_tpu_torch.io.data_reader import FeatureShardConfiguration, feature_keys
from photon_ml_tpu_torch.utils.timer import Timer


def parse_shard_spec(specs: List[str]) -> Dict[str, List[str]]:
    """'shard=bagA,bagB' flags → {shard: [bags]}."""
    out: Dict[str, List[str]] = {}
    for spec in specs:
        shard, _, bags = spec.partition("=")
        if not bags:
            raise ValueError(f"bad --feature-shard spec: {spec!r}")
        out[shard.strip()] = [b.strip() for b in bags.split(",") if b.strip()]
    return out


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu-torch build-index", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--data-dirs", nargs="+", required=True)
    p.add_argument("--date-range", default=None,
                   help="yyyyMMdd-yyyyMMdd; expands each data dir to its "
                        "daily yyyy/MM/dd subdirs (reference --date-range)")
    p.add_argument("--date-days-ago", default=None,
                   help="start-end days ago, e.g. 90-1 (reference "
                        "--date-range-days-ago)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--feature-shard", action="append", required=True,
                   dest="feature_shards", metavar="SHARD=BAG[,BAG...]")
    p.add_argument("--num-partitions", type=int, default=1)
    p.add_argument("--add-intercept", dest="add_intercept",
                   action="store_true", default=True)
    p.add_argument("--no-intercept", dest="add_intercept", action="store_false")
    p.add_argument("--log-file", default=None)
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> Dict[str, int]:
    logger = setup_logger(args.log_file)
    timer = Timer()
    shards = parse_shard_spec(args.feature_shards)
    data_dirs = expand_data_dirs(args.data_dirs, args.date_range, args.date_days_ago)
    with timer.time("scan"):
        keys = feature_keys(data_dirs, {
            sid: FeatureShardConfiguration(feature_bags=bags, add_intercept=False)
            for sid, bags in shards.items()
        })
    sizes = {}
    for sid, (blob, offs, lens) in keys.items():
        if args.add_intercept:
            icpt = INTERCEPT_KEY.encode("utf-8")
            blob, offs, lens = (blob + icpt, np.append(offs, len(blob)),
                                np.append(lens, len(icpt)))
        out = os.path.join(args.output_dir, sid)
        with timer.time(f"build [{sid}]"):
            m = build_offheap_index_map_packed(blob, offs, lens, out,
                                               num_partitions=args.num_partitions)
            sizes[sid] = len(m)
            m.close()
        logger.info("shard %s: %d features -> %s", sid, sizes[sid], out)
    for name, seconds in timer.durations.items():
        logger.info("timing %-16s %.3fs", name, seconds)
    return sizes


def main(argv: Optional[List[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
