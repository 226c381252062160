"""Per-variable gradient-transform updaters.

Counterpart of ``deeplearning4j_tpu/nn/updater/updaters.py``: SGD, Adam,
AdaGrad, AdaDelta, Nesterovs, RMSProp and none; every learning-rate
policy; the six gradient-normalization modes. Each updater is a function
``(cfg, grad, state, iteration) -> (update, state')`` on tensors; like
the reference's ``StepFunction`` (params -= update), :func:`apply_updater`
returns the quantity to SUBTRACT from the parameters.

The iteration is a Python int (the container's step counter). Scalar
math (the learning rate, Adam's bias correction, Nesterov momentum) runs
as 0-dim tensors in the gradient's precision (f32 in production, f64
for f64 gradients) and enters the elementwise math as that exact value,
so every product rounds as the reference's does.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional, Tuple

import torch


class Updater(str, enum.Enum):
    SGD = "sgd"
    ADAM = "adam"
    ADAGRAD = "adagrad"
    ADADELTA = "adadelta"
    NESTEROVS = "nesterovs"
    RMSPROP = "rmsprop"
    NONE = "none"


class GradientNormalization(str, enum.Enum):
    """Applied to one layer's gradients before its updater."""

    NONE = "none"
    RENORMALIZE_L2_PER_LAYER = "renormalize_l2_per_layer"
    RENORMALIZE_L2_PER_PARAM_TYPE = "renormalize_l2_per_param_type"
    CLIP_ELEMENTWISE_ABSOLUTE_VALUE = "clip_elementwise_absolute_value"
    CLIP_L2_PER_LAYER = "clip_l2_per_layer"
    CLIP_L2_PER_PARAM_TYPE = "clip_l2_per_param_type"


class LearningRatePolicy(str, enum.Enum):
    """Learning-rate decay applied per iteration."""

    NONE = "none"
    EXPONENTIAL = "exponential"  # lr * decayRate^iter
    INVERSE = "inverse"  # lr / (1 + decayRate*iter)^power
    POLY = "poly"  # lr * (1 - iter/maxIter)^power
    SIGMOID = "sigmoid"  # lr / (1 + exp(-decayRate*(iter - steps)))
    STEP = "step"  # lr * decayRate^floor(iter/steps)
    SCHEDULE = "schedule"  # explicit {iteration: lr} map


@dataclasses.dataclass(frozen=True)
class UpdaterConfig:
    """Updater hyperparameters for one variable."""

    updater: Updater = Updater.SGD
    learning_rate: float = 1e-1
    momentum: float = 0.9  # nesterovs
    momentum_schedule: Optional[Dict[int, float]] = None
    adam_mean_decay: float = 0.9
    adam_var_decay: float = 0.999
    rho: float = 0.95  # adadelta
    rms_decay: float = 0.95
    epsilon: float = 1e-8
    lr_policy: LearningRatePolicy = LearningRatePolicy.NONE
    lr_policy_decay_rate: float = 0.0
    lr_policy_power: float = 0.0
    lr_policy_steps: float = 1.0
    lr_schedule: Optional[Dict[int, float]] = None
    max_iterations: int = 1  # for POLY

    def __post_init__(self):
        object.__setattr__(self, "updater", Updater(self.updater))
        object.__setattr__(self, "lr_policy", LearningRatePolicy(self.lr_policy))


def _scalar(x, dtype) -> torch.Tensor:
    return torch.tensor(x, dtype=dtype)


def _piecewise(base: torch.Tensor, it: torch.Tensor,
               schedule: Dict[int, float]) -> torch.Tensor:
    """The value of the largest schedule key <= ``it``, else ``base``."""
    out = base
    for k, v in sorted(schedule.items()):
        out = torch.where(it >= k, _scalar(v, base.dtype), out)
    return out


def effective_learning_rate(cfg: UpdaterConfig, iteration: int,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The learning rate at ``iteration`` under ``cfg.lr_policy``, as a
    0-dim tensor of ``dtype``."""
    lr = _scalar(cfg.learning_rate, dtype)
    it = _scalar(iteration, dtype)
    p = cfg.lr_policy
    if p is LearningRatePolicy.NONE:
        return lr
    if p is LearningRatePolicy.EXPONENTIAL:
        return lr * torch.pow(_scalar(cfg.lr_policy_decay_rate, dtype), it)
    if p is LearningRatePolicy.INVERSE:
        return lr / torch.pow(1.0 + cfg.lr_policy_decay_rate * it,
                              cfg.lr_policy_power)
    if p is LearningRatePolicy.POLY:
        frac = torch.clamp(it / max(cfg.max_iterations, 1), 0.0, 1.0)
        return lr * torch.pow(1.0 - frac, cfg.lr_policy_power)
    if p is LearningRatePolicy.SIGMOID:
        return lr / (1.0 + torch.exp(-cfg.lr_policy_decay_rate
                                     * (it - cfg.lr_policy_steps)))
    if p is LearningRatePolicy.STEP:
        return lr * torch.pow(_scalar(cfg.lr_policy_decay_rate, dtype),
                              torch.floor(it / cfg.lr_policy_steps))
    if p is LearningRatePolicy.SCHEDULE:
        return _piecewise(lr, it, cfg.lr_schedule or {})
    raise ValueError(f"unknown lr policy {p}")


def _effective_momentum(cfg: UpdaterConfig, iteration: int,
                        dtype: torch.dtype) -> torch.Tensor:
    mu = _scalar(cfg.momentum, dtype)
    if cfg.momentum_schedule:
        mu = _piecewise(mu, _scalar(iteration, dtype), cfg.momentum_schedule)
    return mu


def init_updater_state(cfg: UpdaterConfig,
                       param: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Zero-initialized per-variable state, keyed as in the reference."""
    z = lambda: torch.zeros_like(param)  # noqa: E731
    u = cfg.updater
    if u is Updater.ADAM:
        return {"m": z(), "v": z()}
    if u is Updater.ADAGRAD:
        return {"h": z()}
    if u is Updater.ADADELTA:
        return {"msg": z(), "msdx": z()}
    if u is Updater.NESTEROVS:
        return {"v": z()}
    if u is Updater.RMSPROP:
        return {"cache": z()}
    return {}


def apply_updater(cfg: UpdaterConfig, grad: torch.Tensor,
                  state: Dict[str, torch.Tensor], iteration: int
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The update to subtract and the new state; the formulas are the
    reference's, term for term."""
    u = cfg.updater
    sdtype = torch.promote_types(grad.dtype, torch.float32)
    lr = float(effective_learning_rate(cfg, iteration, sdtype))
    eps = cfg.epsilon
    if u is Updater.SGD:
        return lr * grad, state
    if u is Updater.NONE:
        return grad, state
    if u is Updater.ADAM:
        t = _scalar(iteration, sdtype) + 1.0
        b1, b2 = cfg.adam_mean_decay, cfg.adam_var_decay
        m = b1 * state["m"] + (1.0 - b1) * grad
        v = b2 * state["v"] + (1.0 - b2) * grad * grad
        alpha = float(lr * torch.sqrt(1.0 - torch.pow(_scalar(b2, sdtype), t))
                      / (1.0 - torch.pow(_scalar(b1, sdtype), t)))
        return alpha * m / (torch.sqrt(v) + eps), {"m": m, "v": v}
    if u is Updater.ADAGRAD:
        h = state["h"] + grad * grad
        return lr * grad / (torch.sqrt(h) + eps), {"h": h}
    if u is Updater.ADADELTA:
        rho = cfg.rho
        msg = rho * state["msg"] + (1.0 - rho) * grad * grad
        update = grad * torch.sqrt(state["msdx"] + eps) / torch.sqrt(msg + eps)
        msdx = rho * state["msdx"] + (1.0 - rho) * update * update
        return update, {"msg": msg, "msdx": msdx}
    if u is Updater.NESTEROVS:
        mu_t = _effective_momentum(cfg, iteration, sdtype)
        mu, one_mu = float(mu_t), float(1.0 + mu_t)
        v_prev = state["v"]
        v = mu * v_prev - lr * grad
        # the reference's Nesterovs: update = mu*vPrev - (1+mu)*vNew
        update = mu * v_prev - one_mu * v
        return update, {"v": v}
    if u is Updater.RMSPROP:
        d = cfg.rms_decay
        cache = d * state["cache"] + (1.0 - d) * grad * grad
        return lr * grad / (torch.sqrt(cache) + eps), {"cache": cache}
    raise ValueError(f"unknown updater {u}")


def normalize_gradient(norm_type, grads: Dict[str, torch.Tensor],
                       threshold: float = 1.0) -> Dict[str, torch.Tensor]:
    """Pre-update normalization over one layer's {param name: grad};
    layer-wide norms sum the parameters in sorted-name order (the
    reference's pytree order)."""
    nt = GradientNormalization(norm_type)
    if nt is GradientNormalization.NONE:
        return grads
    if nt is GradientNormalization.CLIP_ELEMENTWISE_ABSOLUTE_VALUE:
        return {k: torch.clamp(g, -threshold, threshold) for k, g in grads.items()}

    def clip_scale(norm):
        return torch.where(norm > threshold, threshold / norm,
                           torch.ones_like(norm))

    if nt in (GradientNormalization.RENORMALIZE_L2_PER_LAYER,
              GradientNormalization.CLIP_L2_PER_LAYER):
        sq = sum(torch.sum(grads[k] * grads[k]) for k in sorted(grads))
        norm = torch.sqrt(sq + 1e-12)
        if nt is GradientNormalization.RENORMALIZE_L2_PER_LAYER:
            scale = 1.0 / norm
        else:
            scale = clip_scale(norm)
        return {k: g * scale for k, g in grads.items()}
    out: Dict[str, Any] = {}
    for k, g in grads.items():
        norm = torch.sqrt(torch.sum(g * g) + 1e-12)
        if nt is GradientNormalization.RENORMALIZE_L2_PER_PARAM_TYPE:
            out[k] = g / norm
        else:
            out[k] = g * clip_scale(norm)
    return out
