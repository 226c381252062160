"""Loss functions with per-example masking.

Counterpart of ``deeplearning4j_tpu/ops/losses.py``. Every loss takes
activated outputs ("predictions") against labels, sums over the feature
axis and reduces to the mean over examples (or over the unmasked ones);
``from_logits=True`` selects the fused log-softmax formulation for
mcxent/nll and sigmoid cross-entropy with logits for xent. Integer
class-id labels (one rank below the predictions) take the sparse path:
the target is gathered from the logits, and negative ids are ignored.
"""

from __future__ import annotations

import enum
from typing import Optional, Union

import torch

_EPS = 1e-7


def _masked_mean(per_ex: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the unmasked rows whose value and gradients are those of
    a plain mean over just those rows: the gradient flows through the
    true division ``total / count``, and the value is corrected to
    ``total * (1 / count)``, the rounding of a mean over a fixed count,
    by a term that carries no gradient (``d + (r - d).detach() == r``
    exactly: r and d are within one ulp)."""
    mask = mask.to(per_ex.dtype)
    total = torch.sum(per_ex * mask)
    count = torch.clamp_min(torch.sum(mask), 1.0)
    d = total / count
    r = total * (1.0 / count)
    return d + (r - d).detach()


class LossFunction(str, enum.Enum):
    MSE = "mse"
    L1 = "l1"
    L2 = "l2"
    XENT = "xent"  # binary cross-entropy
    MCXENT = "mcxent"  # multi-class cross-entropy
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"  # == MCXENT
    COSINE_PROXIMITY = "cosine_proximity"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    KL_DIVERGENCE = "kl_divergence"
    MEAN_ABSOLUTE_ERROR = "mean_absolute_error"
    MEAN_ABSOLUTE_PERCENTAGE_ERROR = "mean_absolute_percentage_error"
    MEAN_SQUARED_LOGARITHMIC_ERROR = "mean_squared_logarithmic_error"
    POISSON = "poisson"
    RECONSTRUCTION_CROSSENTROPY = "reconstruction_crossentropy"


def _per_example(f: LossFunction, labels: torch.Tensor,
                 preds: torch.Tensor) -> torch.Tensor:
    """Per-example loss: the sum over the feature axis (last)."""
    if f in (LossFunction.MSE, LossFunction.L2):
        d = labels - preds
        return torch.sum(d * d, dim=-1)
    if f in (LossFunction.L1, LossFunction.MEAN_ABSOLUTE_ERROR):
        return torch.sum(torch.abs(labels - preds), dim=-1)
    if f in (LossFunction.XENT, LossFunction.RECONSTRUCTION_CROSSENTROPY):
        p = torch.clamp(preds, _EPS, 1.0 - _EPS)
        return -torch.sum(labels * torch.log(p)
                          + (1.0 - labels) * torch.log1p(-p), dim=-1)
    if f in (LossFunction.MCXENT, LossFunction.NEGATIVELOGLIKELIHOOD):
        p = torch.clamp(preds, _EPS, 1.0)
        return -torch.sum(labels * torch.log(p), dim=-1)
    if f is LossFunction.COSINE_PROXIMITY:
        ln = labels / (torch.linalg.norm(labels, dim=-1, keepdim=True) + _EPS)
        pn = preds / (torch.linalg.norm(preds, dim=-1, keepdim=True) + _EPS)
        return -torch.sum(ln * pn, dim=-1)
    if f is LossFunction.HINGE:
        return torch.sum(torch.relu(1.0 - labels * preds), dim=-1)
    if f is LossFunction.SQUARED_HINGE:
        h = torch.relu(1.0 - labels * preds)
        return torch.sum(h * h, dim=-1)
    if f is LossFunction.KL_DIVERGENCE:
        lab = torch.clamp(labels, _EPS, 1.0)
        p = torch.clamp(preds, _EPS, 1.0)
        return torch.sum(lab * (torch.log(lab) - torch.log(p)), dim=-1)
    if f is LossFunction.MEAN_ABSOLUTE_PERCENTAGE_ERROR:
        # sign-preserving clamp of the denominator (zero labels as +eps)
        sign = torch.where(labels >= 0, 1.0, -1.0).to(labels.dtype)
        denom = sign * torch.clamp_min(torch.abs(labels), _EPS)
        return torch.sum(torch.abs((labels - preds) / denom), dim=-1) * 100.0
    if f is LossFunction.MEAN_SQUARED_LOGARITHMIC_ERROR:
        d = (torch.log1p(torch.clamp_min(preds, -1.0 + _EPS))
             - torch.log1p(torch.clamp_min(labels, -1.0 + _EPS)))
        return torch.sum(d * d, dim=-1)
    if f is LossFunction.POISSON:
        p = torch.clamp_min(preds, _EPS)
        return torch.sum(p - labels * torch.log(p), dim=-1)
    raise ValueError(f"unknown loss function {f}")


def compute_loss(name: Union[str, LossFunction], labels: torch.Tensor,
                 predictions: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 from_logits: bool = False,
                 reduction: str = "mean") -> torch.Tensor:
    """Masked mean-over-examples loss (a 0-dim tensor).

    ``labels``/``predictions``: [batch, nOut] or [batch, T, nOut];
    ``mask`` is [batch] or [batch, T] and broadcasts over the features.
    Sparse labels ([batch] or [batch, T] class ids, mcxent/nll only)
    must lie in [0, nOut); negative ids are ignored (zero loss, left out
    of the mean). ``reduction="batch"`` divides the (masked) sum by the
    batch size instead, the reference's RNN score convention."""
    f = LossFunction(name)
    sparse = labels.ndim == predictions.ndim - 1
    if sparse and f not in (LossFunction.MCXENT,
                            LossFunction.NEGATIVELOGLIKELIHOOD):
        raise ValueError(
            f"sparse integer labels (shape {tuple(labels.shape)} vs "
            f"predictions {tuple(predictions.shape)}) are only supported "
            "for mcxent/nll")
    if sparse:
        ids = labels.long()
        ignore = ids < 0
        nout = predictions.shape[-1]
        pred2 = predictions.reshape(-1, nout)
        tgt = pred2.gather(1, ids.clamp_min(0).reshape(-1, 1))[:, 0]
        if from_logits:
            # -log_softmax[target] == logsumexp - target logit
            per_ex = (torch.logsumexp(pred2, dim=-1) - tgt).reshape(ids.shape)
        else:
            per_ex = -torch.log(torch.clamp(tgt, _EPS, 1.0)).reshape(ids.shape)
        keep = (~ignore).to(per_ex.dtype)
        mask = keep if mask is None else mask.to(per_ex.dtype) * keep
    elif from_logits and f in (LossFunction.MCXENT,
                               LossFunction.NEGATIVELOGLIKELIHOOD):
        per_ex = -torch.sum(labels * torch.log_softmax(predictions, dim=-1),
                            dim=-1)
    elif from_logits and f is LossFunction.XENT:
        z, y = predictions, labels
        per_ex = torch.sum(torch.relu(z) - z * y
                           + torch.log1p(torch.exp(-torch.abs(z))), dim=-1)
    else:
        per_ex = _per_example(f, labels, predictions)

    if reduction == "batch":
        if mask is not None:
            per_ex = per_ex * mask.to(per_ex.dtype)
        return torch.sum(per_ex) / per_ex.shape[0]
    if reduction != "mean":
        raise ValueError(f"unknown reduction {reduction!r} (use 'mean' or 'batch')")
    if mask is not None:
        return _masked_mean(per_ex, mask)
    return torch.mean(per_ex)
