"""The port's one device rule.

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``.
With no card present and no explicit CPU request it raises: nothing carries
on quietly on the host.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: DeviceLike = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}; use 'cuda' or 'cpu'")
    return dev
