from photon_ml_tpu_torch.losses.pointwise import (
    LogisticLoss,
    PointwiseLoss,
    PoissonLoss,
    SmoothedHingeLoss,
    SquaredLoss,
    loss_for_task,
    mean_function,
)

__all__ = [
    "LogisticLoss",
    "PointwiseLoss",
    "PoissonLoss",
    "SmoothedHingeLoss",
    "SquaredLoss",
    "loss_for_task",
    "mean_function",
]
