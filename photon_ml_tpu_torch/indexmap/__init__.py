"""Feature index maps: feature name <-> dense int index.

Reference parity: photon-api util/IndexMap.scala:22 (the name->index
contract), DefaultIndexMap.scala:27 (in-heap map built by
distinct+zipWithIndex :78), DefaultIndexMapLoader.scala, and the PalDB
off-heap path (PalDBIndexMap.scala:43) whose equivalent here is the
mmap'd PHIX store in :mod:`photon_ml_tpu_torch.indexmap.offheap`. A copy of
``photon_ml_tpu/indexmap/__init__.py``.

Feature names follow the reference's ``name + INTERCEPT_DELIMITER + term``
convention (Constants.scala): a feature is identified by a single string key.
"""

from __future__ import annotations

import abc
import hashlib
from itertools import repeat
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

# reference Constants.scala: the intercept pseudo-feature's key
INTERCEPT_KEY = "(INTERCEPT)"
NAME_TERM_DELIMITER = "\x01"


def feature_key(name: str, term: str = "") -> str:
    """name/term pair -> single map key (reference NameAndTerm semantics)."""
    return name if not term else f"{name}{NAME_TERM_DELIMITER}{term}"


class IndexMap(abc.ABC):
    """name -> dense index contract (reference util/IndexMap.scala:22)."""

    @abc.abstractmethod
    def get_index(self, name: str) -> int:
        """Dense index of a feature name, or -1 when unmapped."""

    @abc.abstractmethod
    def get_feature_name(self, index: int) -> Optional[str]:
        """Inverse lookup; None when the index is absent."""

    @abc.abstractmethod
    def __len__(self) -> int:
        ...

    def get_indices(self, names: Sequence[str]) -> np.ndarray:
        """Vectorized lookup; -1 for unmapped names."""
        return np.fromiter(
            (self.get_index(n) for n in names), dtype=np.int64, count=len(names)
        )

    def __contains__(self, name: str) -> bool:
        return self.get_index(name) >= 0

    def content_digest(self) -> str:
        """Hex digest committing to the full name->index assignment.

        Decoded feature columns are a function of this mapping, so anything
        caching decoded data (the streaming block cache) must include it in
        its fingerprint — two same-size maps with permuted assignments
        otherwise collide. The generic implementation walks the dense index
        space; subclasses override with cheaper equivalents."""
        h = hashlib.sha256()
        for i in range(len(self)):
            h.update(f"{self.get_feature_name(i)}\x00{i}\x01".encode("utf-8"))
        return h.hexdigest()


class DefaultIndexMap(IndexMap):
    """In-heap dict map (reference DefaultIndexMap.scala:27)."""

    def __init__(self, name_to_index: Dict[str, int]):
        self._forward = dict(name_to_index)
        self._reverse = {i: n for n, i in self._forward.items()}
        if len(self._reverse) != len(self._forward):
            raise ValueError("index map has duplicate indices")

    @classmethod
    def from_names(
        cls, names: Iterable[str], add_intercept: bool = False
    ) -> "DefaultIndexMap":
        """distinct + sort + enumerate (the deterministic analog of the
        reference's distinct().sort().zipWithIndex(), DefaultIndexMap.scala:78)."""
        uniq: List[str] = sorted(set(names))
        if add_intercept and INTERCEPT_KEY not in uniq:
            uniq.append(INTERCEPT_KEY)
        return cls({n: i for i, n in enumerate(uniq)})

    def get_index(self, name: str) -> int:
        return self._forward.get(name, -1)

    def get_indices(self, names: Sequence[str]) -> np.ndarray:
        # hot on the serving route path: map(dict.get, names, repeat(-1))
        # stays entirely in C, vs one Python frame per name via get_index
        return np.fromiter(
            map(self._forward.get, names, repeat(-1)),
            dtype=np.int64,
            count=len(names),
        )

    def get_feature_name(self, index: int) -> Optional[str]:
        return self._reverse.get(int(index))

    def __len__(self) -> int:
        return len(self._forward)

    def content_digest(self) -> str:
        # index order, matching the base implementation byte-for-byte
        h = hashlib.sha256()
        for name, idx in sorted(self._forward.items(), key=lambda kv: kv[1]):
            h.update(f"{name}\x00{idx}\x01".encode("utf-8"))
        return h.hexdigest()

    def items(self):
        return self._forward.items()
