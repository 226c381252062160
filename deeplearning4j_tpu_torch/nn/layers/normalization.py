"""Batch normalization and local response normalization.

Counterpart of ``deeplearning4j_tpu/nn/layers/normalization.py``. BN's
moving statistics are the layer's state, carried by the container from
step to step as the LSTM carries are.

- BN in training normalizes with the batch's one-pass biased moments
  (E[x], E[x^2] - E[x]^2, in at least f32) and moves the state to
  ``d * old + (1 - d) * batch`` with that biased variance, the
  reference's update (``F.batch_norm``'s running update uses the
  unbiased variance, so it is not used).
- LRN is ``x / (k + alpha * sum x^2)^beta`` over a window of ``n``
  channels, the extra channel of an even window after the centre
  (``F.local_response_norm`` divides alpha by n and centres the window
  the other way).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.base import LayerImpl, register_impl


@register_impl(L.BatchNormalization)
class BatchNormalizationImpl(LayerImpl):
    """Normalizes over the batch (FF [b, f]) or batch and space (NHWC
    [b, h, w, c], per channel)."""

    # padded rows would change the batch moments
    batch_statistics = True

    def init_params(self, gen, device) -> Dict[str, torch.Tensor]:
        c = self.conf
        if c.lock_gamma_beta:
            return {}
        return {"gamma": torch.full((c.n_out,), float(c.gamma), device=device),
                "beta": torch.full((c.n_out,), float(c.beta), device=device)}

    def init_state(self, device):
        n = self.conf.n_out
        return {"mean": torch.zeros(n, device=device),
                "var": torch.ones(n, device=device)}

    def forward(self, params, x, state, train, rng=None, mask=None):
        c = self.conf
        dims = tuple(range(x.ndim - 1))
        if train:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = torch.mean(xf, dim=dims)
            var = torch.clamp(torch.mean(xf * xf, dim=dims) - mean * mean,
                              min=0.0)
            d = c.decay
            new_state = {"mean": d * state["mean"] + (1 - d) * mean,
                         "var": d * state["var"] + (1 - d) * var}
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        # one per-element multiply-add with [c] vectors computed in f32
        inv = torch.rsqrt(var + c.eps)
        if c.lock_gamma_beta:
            scale = c.gamma * inv
            shift = c.beta - mean * scale
        else:
            scale = params["gamma"] * inv
            shift = params["beta"] - mean * scale
        return x * scale.to(x.dtype) + shift.to(x.dtype), new_state

    def regularization_penalty(self, params):
        return torch.zeros((), dtype=torch.float32)  # no l1/l2 on BN


@register_impl(L.LocalResponseNormalization)
class LocalResponseNormalizationImpl(LayerImpl):
    """Cross-channel LRN on NHWC."""

    def forward(self, params, x, state, train, rng=None, mask=None):
        c = self.conf
        n = int(c.n)
        half = n // 2
        s = F.pad(x * x, (half, n - 1 - half)).unfold(-1, n, 1).sum(-1)
        return x / torch.pow(c.k + c.alpha * s, c.beta), state
