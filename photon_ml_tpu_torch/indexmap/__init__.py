"""Feature index maps: feature name <-> dense int index.

Reference parity: photon-api util/IndexMap.scala:22 (the name->index
contract), DefaultIndexMap.scala:27 (in-heap map built by
distinct+zipWithIndex :78) and DefaultIndexMapLoader.scala. A copy of
``photon_ml_tpu/indexmap/__init__.py`` without the vectorized lookup and
the content digest; the off-heap store is not ported yet.

Feature names follow the reference's ``name + INTERCEPT_DELIMITER + term``
convention (Constants.scala): a feature is identified by a single string key.
"""

from __future__ import annotations

import abc
from typing import Dict, Optional

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

    def __contains__(self, name: str) -> bool:
        return self.get_index(name) >= 0


class DefaultIndexMap(IndexMap):
    """In-heap dict map (reference DefaultIndexMap.scala:27)."""

    def __init__(self, name_to_index: Dict[str, int]):
        self._forward = dict(name_to_index)
        self._reverse = {i: n for n, i in self._forward.items()}
        if len(self._reverse) != len(self._forward):
            raise ValueError("index map has duplicate indices")

    def get_index(self, name: str) -> int:
        return self._forward.get(name, -1)

    def get_feature_name(self, index: int) -> Optional[str]:
        return self._reverse.get(int(index))

    def __len__(self) -> int:
        return len(self._forward)

    def items(self):
        return self._forward.items()
