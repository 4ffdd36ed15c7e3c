"""The one traffic generator: a cell's training data, made on the device
by a ``torch.Generator`` on the card, in a few large calls.

A configuration file fixes the deployment (widths, entities, rows, the
solver); a traffic file (``traffic/<name>.json``) fixes how the data is
drawn: the scale of the true coefficients and of the values, the Zipf
exponent of the entities' popularity (the entity of popularity rank k,
from 1, is drawn with a probability in proportion to k^-s, over the
configured entities; s = 0 draws them uniformly), the share of held-out
rows that name an entity the training rows never saw, and ``base_seed``,
from which the rows' values are drawn.
``--seed`` then draws the order: a permutation of the rows, new column
numbers of every feature space and new entity numbers. Every seed so gives
the same problem in another order, and the solvers do the same work on
each (fresh values would change the L-BFGS iterations, and so the work, by
seed).

Rows come out (row, col)-sorted and free of duplicates: within a row the
fixed-effect columns are distinct and sorted, and the intercept, the last
column, comes last. Labels are drawn from a seeded logistic model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

# rows drawn a call: bounds the generator's temporaries on the card
BLOCK_ROWS = 1 << 21

# id tag and name prefix of each random-effect shard
ENTITY_TAGS = {"per_user": ("userId", "u"), "per_item": ("itemId", "i")}


@dataclasses.dataclass
class Shard:
    """One feature shard with a fixed number of nonzeros a row: ``cols`` and
    ``vals`` [n, k] over a space of ``dim`` columns."""

    cols: torch.Tensor
    vals: torch.Tensor
    dim: int


@dataclasses.dataclass
class Rows:
    """Training or held-out rows: labels [n], the fixed-effect shard
    ("global") and, for GLMix, the random-effect shards with the entity of
    each row (``entity`` [n] int64) and whether it is one the training rows
    never saw (``unseen`` [n] bool)."""

    labels: torch.Tensor
    shards: Dict[str, Shard]
    entity: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    unseen: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def num_rows(self) -> int:
        return self.labels.numel()


@dataclasses.dataclass
class CellData:
    train: Rows
    heldout: Rows


def _distinct_sorted(gen, rows: int, k: int, dim: int, device) -> torch.Tensor:
    """[rows, k] columns in [0, dim), distinct and sorted within each row: a
    random start and a random stride below dim / k (k strides of less than
    dim / k never wrap onto a column already taken)."""
    start = torch.randint(0, dim, (rows, 1), generator=gen, device=device)
    stride = torch.randint(1, max(2, dim // k), (rows, 1), generator=gen, device=device)
    cols = (start + stride * torch.arange(k, device=device)) % dim
    return torch.sort(cols, dim=1).values


def _fe_block(gen, rows: int, cfg: dict, w_fe: torch.Tensor, scale: float, device):
    """A block of fixed-effect rows: k distinct features and the intercept,
    values N(0, 1)/sqrt(k) (the intercept 1), and their margins."""
    dim, k = cfg["features"], cfg["nonzeros_per_row"]
    cols = torch.cat([_distinct_sorted(gen, rows, k, dim, device),
                      torch.full((rows, 1), dim, dtype=torch.int64, device=device)], dim=1)
    vals = torch.cat([torch.randn(rows, k, generator=gen, device=device) * (scale / math.sqrt(k)),
                      torch.ones(rows, 1, device=device)], dim=1)
    return cols, vals, (vals * w_fe[cols]).sum(1)


def _zipf_cdf(count: int, exponent: float, device) -> torch.Tensor:
    """The cumulative popularity of entities 0..count-1 (rank k + 1), in
    float64: entity k is drawn where a uniform draw times the total falls
    in (cdf[k - 1], cdf[k]]."""
    ranks = torch.arange(1, count + 1, dtype=torch.float64, device=device)
    return torch.cumsum(ranks ** -float(exponent), 0)


def make(config: dict, traffic: dict, seed: int, device) -> CellData:
    """The training and held-out rows of a cell: ``traffic``'s base draw, in
    the order ``seed`` draws."""
    return _permuted(_draw(config, traffic, traffic["base_seed"], device), config, seed)


def _sorted_rows(cols: torch.Tensor, vals: torch.Tensor):
    """Each row's columns sorted, its values with them."""
    cols, order = torch.sort(cols, dim=1)
    return cols, torch.gather(vals, 1, order)


def _permuted(data: CellData, config: dict, seed: int) -> CellData:
    """The rows in a random order, every feature space's columns and every
    random effect's entities renumbered (the intercept stays the last
    column), each row's columns sorted again."""
    device = data.train.labels.device
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    fe_dim = config["fixed_effect"]["features"]
    col_map = {"global": torch.cat([torch.randperm(fe_dim, generator=gen, device=device),
                                    torch.tensor([fe_dim], device=device)])}
    ent_map = {}
    for shard, re in config.get("random_effects", {}).items():
        col_map[shard] = torch.randperm(re["features"], generator=gen, device=device)
        ent_map[shard] = torch.randperm(re["entities"], generator=gen, device=device)
    for rows in (data.train, data.heldout):
        order = torch.randperm(rows.num_rows, generator=gen, device=device)
        rows.labels = rows.labels[order]
        for name, sh in rows.shards.items():
            sh.cols, sh.vals = _sorted_rows(col_map[name][sh.cols[order]], sh.vals[order])
        for name in rows.entity:
            rows.entity[name] = ent_map[name][rows.entity[name][order]]
            rows.unseen[name] = rows.unseen[name][order]
    return data


def _draw(config: dict, traffic: dict, seed: int, device) -> CellData:
    """The rows drawn from ``seed``, in the order drawn."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    fe = config["fixed_effect"]
    w_fe = torch.randn(fe["features"] + 1, generator=gen, device=device) * traffic["fe_coef_scale"]
    entities = {}
    for shard, re in config.get("random_effects", {}).items():
        count, local, dim = re["entities"], re["features_per_entity"], re["features"]
        space = _distinct_sorted(gen, count, local, dim, device)
        w_re = torch.randn(count, local, generator=gen, device=device) * traffic["re_coef_scale"]
        entities[shard] = (space, w_re, _zipf_cdf(count, traffic["entity_zipf_exponent"], device))
    parts = {}
    for part, n in (("train", config["rows"]), ("heldout", config["heldout_rows"])):
        labels, fe_cols, fe_vals = [], [], []
        re_parts = {s: ([], [], [], []) for s in entities}
        for lo in range(0, n, BLOCK_ROWS):
            rows = min(BLOCK_ROWS, n - lo)
            cols, vals, margin = _fe_block(gen, rows, fe, w_fe, traffic["value_scale"], device)
            fe_cols.append(cols)
            fe_vals.append(vals)
            for shard, (space, w_re, cdf) in entities.items():
                re = config["random_effects"][shard]
                k, local = re["nonzeros_per_row"], re["features_per_entity"]
                u_ent = torch.rand(rows, generator=gen, device=device, dtype=torch.float64)
                ent = torch.searchsorted(cdf, u_ent * cdf[-1]).clamp(max=re["entities"] - 1)
                slot = torch.sort(torch.argsort(
                    torch.rand(rows, local, generator=gen, device=device), dim=1)[:, :k],
                    dim=1).values
                v = torch.randn(rows, k, generator=gen, device=device) * (
                    traffic["value_scale"] / math.sqrt(k))
                margin = margin + (v * w_re[ent[:, None], slot]).sum(1)
                new = torch.rand(rows, generator=gen, device=device) < traffic["unseen_share"]
                if part == "train":
                    new = torch.zeros_like(new)
                lists = re_parts[shard]
                lists[0].append(space[ent[:, None], slot])
                lists[1].append(v)
                lists[2].append(ent)
                lists[3].append(new)
            u = torch.rand(rows, generator=gen, device=device)
            labels.append((u < torch.sigmoid(margin)).float())
        shards = {"global": Shard(torch.cat(fe_cols), torch.cat(fe_vals), fe["features"] + 1)}
        rows_ = Rows(labels=torch.cat(labels), shards=shards)
        for shard, (c, v, e, new) in re_parts.items():
            shards[shard] = Shard(torch.cat(c), torch.cat(v),
                                  config["random_effects"][shard]["features"])
            rows_.entity[shard] = torch.cat(e)
            rows_.unseen[shard] = torch.cat(new)
        parts[part] = rows_
    return CellData(train=parts["train"], heldout=parts["heldout"])


def entity_names(shard: str, entity: np.ndarray, unseen: Optional[np.ndarray] = None):
    """The id strings the program is given: "u<e>" / "i<e>", and
    "new_u<e>" for a held-out row whose entity the training rows never saw."""
    prefix = ENTITY_TAGS[shard][1]
    top = int(entity.max()) + 1 if entity.size else 1
    names = np.char.add(prefix, np.arange(top).astype(str))
    out = names[entity]
    if unseen is not None and unseen.any():
        out = np.where(unseen, np.char.add("new_", out), out)
    return out


def coo(shard: Shard):
    """Host COO triplets of a shard (rows int64, cols int64, vals f32),
    (row, col)-sorted and free of duplicates."""
    n, k = shard.cols.shape
    rows = torch.arange(n, device=shard.cols.device).repeat_interleave(k)
    return (rows.cpu().numpy(), shard.cols.reshape(-1).cpu().numpy(),
            shard.vals.reshape(-1).float().cpu().numpy())
