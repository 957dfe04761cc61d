"""Channel-estimation loss (reference ChannelEstimationLoss,
src/ai_models.py:378-428). Port of ``ce5g_tpu.models.loss``: the base
MSE/MAE/Huber (or per-sample NMSE) × channel_weight, plus an optional
pilot-masked term × pilot_weight that applies the SAME base loss to the
masked tensors (the reference feeds pred·mask and target·mask through its
own criterion). Computed in float32 whatever the model's compute dtype."""
from __future__ import annotations

import torch


def _base_loss(err: torch.Tensor, loss_type: str, target=None) -> torch.Tensor:
    """Mean elementwise loss of an error tensor: torch MSELoss / L1Loss /
    SmoothL1Loss (δ = 1), or 'nmse', the mean over the batch of each
    sample's ‖err‖²/‖target‖² (the evaluation metric)."""
    if loss_type == "mse":
        return (err ** 2).mean()
    if loss_type == "mae":
        return err.abs().mean()
    if loss_type == "huber":
        a = err.abs()
        return torch.where(a <= 1.0, 0.5 * err ** 2, a - 0.5).mean()
    if loss_type == "nmse":
        axes = tuple(range(1, err.ndim))
        e = (err ** 2).mean(dim=axes)
        p = (target.to(torch.float32) ** 2).mean(dim=axes)
        return (e / (p + 1e-8)).mean()
    raise ValueError(f"Unknown loss type: {loss_type!r}")


def channel_estimation_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    pilot_mask=None,
    loss_type: str = "mse",
    channel_weight: float = 1.0,
    pilot_weight: float = 0.0,
) -> torch.Tensor:
    """The weighted estimation loss.

    Args:
        pred, target: (..., 2) real/imag grids of matching shapes.
        pilot_mask: optional mask broadcastable to ``pred[..., 0]``; with
            ``pilot_weight`` > 0 it adds base_loss(mask·err, mask·target)
            under the same ``loss_type`` (reference ai_models.py:424-426).
        loss_type: 'mse' | 'mae' | 'huber' (δ = 1) | 'nmse'.
    """
    err = (pred - target).to(torch.float32)
    loss = channel_weight * _base_loss(err, loss_type, target)
    if pilot_mask is not None and pilot_weight > 0.0:
        m = pilot_mask.to(torch.float32)[..., None]
        loss = loss + pilot_weight * _base_loss(m * err, loss_type, m * target)
    return loss
