"""photon-ml-tpu in PyTorch, for NVIDIA Hopper (H100).

The second package of the repository: the same GLM / GLMix (GAME) system as
``photon_ml_tpu``, written in plain PyTorch, with every Pallas kernel of the
JAX package replaced by a kernel written by hand for ``sm_90a``. The JAX
package is the reference; this package imports nothing of it (and never
``jax``) and keeps its own copies of the pure-Python modules it needs, at
the same relative module paths.

Device rules: every entry point takes a ``device`` argument that defaults to
``"cuda"`` and raises when no card is present; the CPU is used only when the
caller asks for it (``device="cpu"``), as the tests do.

Numerics: the reference forces ``Precision.HIGHEST`` in its kernels, so TF32
is switched off here for matmuls and convolutions alike.
"""

import torch

from photon_ml_tpu_torch import types
from photon_ml_tpu_torch.types import TaskType

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = ["types", "TaskType", "__version__"]
