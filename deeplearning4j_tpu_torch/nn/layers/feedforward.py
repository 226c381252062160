"""Feed-forward layer family: Dense, Output/RnnOutput/Loss, Embedding,
Activation, Dropout, GlobalPooling.

Counterpart of ``deeplearning4j_tpu/nn/layers/feedforward.py`` (its
AutoEncoder and RBM wait for ROADMAP Queue A3). Scoring takes the fused
from-logits loss where the activation and loss allow it (softmax +
mcxent/nll, sigmoid + xent).
"""

from __future__ import annotations

from typing import Dict

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.base import (
    LayerImpl,
    apply_dropout,
    register_impl,
)
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import Activation, activate
from deeplearning4j_tpu_torch.ops.losses import LossFunction, compute_loss
from deeplearning4j_tpu_torch.util.rng import generator


def _fused_logits_pair(activation: str, loss_function: str) -> bool:
    """True when activation + loss compute through the numerically
    stable fused from-logits path (the same function)."""
    act = Activation(activation)
    lf = LossFunction(loss_function)
    return (act is Activation.SOFTMAX and lf in (
        LossFunction.MCXENT, LossFunction.NEGATIVELOGLIKELIHOOD)) or \
        (act is Activation.SIGMOID and lf is LossFunction.XENT)


def _score(activation: str, loss_function: str, z, labels, mask):
    """Mean-over-examples loss of pre-activations ``z``."""
    if _fused_logits_pair(activation, loss_function):
        return compute_loss(loss_function, labels, z, mask=mask,
                            from_logits=True)
    return compute_loss(loss_function, labels, activate(activation, z),
                        mask=mask)


class BaseDenseImpl(LayerImpl):
    """z = x.W + b, a = act(z)."""

    supports_no_bias = True
    applies_drop_connect = True

    def init_params(self, gen, device) -> Dict[str, torch.Tensor]:
        c = self.conf
        W = init_weights(gen, (c.n_in, c.n_out), self.weight_init, c.n_in,
                         c.n_out, c.dist_mean, c.dist_std, dist=c.dist,
                         device=device)
        if not c.has_bias:
            return {"W": W}
        return {"W": W, "b": torch.full((c.n_out,), float(self.bias_init),
                                        device=device)}

    def preout(self, params, x: torch.Tensor) -> torch.Tensor:
        """In the promoted dtype of x and W, as the reference's matmul."""
        W = params["W"]
        dt = torch.promote_types(x.dtype, W.dtype)
        z = x.to(dt) @ W.to(dt)
        return z + params["b"] if "b" in params else z

    def forward(self, params, x, state, train, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        params = self.maybe_drop_connect(params, train, rng)
        return activate(self.activation, self.preout(params, x)), state


@register_impl(L.DenseLayer)
class DenseImpl(BaseDenseImpl):
    pass


@register_impl(L.OutputLayer)
class OutputImpl(BaseDenseImpl):
    """Dense + loss head."""

    def has_loss(self) -> bool:
        return True

    def preout(self, params, x: torch.Tensor) -> torch.Tensor:
        """Logits. On half-precision operands the product accumulates in
        f32 and the logits stay f32 (never rounded to bf16 in between):
        both operands are upcast after their half-precision cast, which
        gives the exact products the reference's
        ``preferred_element_type=f32`` matmul sums. Mixed operands (f32
        activations on a bf16 head) compute in the promoted dtype, as the
        reference's matmul does."""
        W = params["W"]
        dt = torch.promote_types(x.dtype, W.dtype)
        if dt in (torch.bfloat16, torch.float16):
            z = x.float() @ W.float()
        else:
            z = x.to(dt) @ W.to(dt)
        return z + params["b"].to(z.dtype) if "b" in params else z

    @property
    def loss_function(self) -> str:
        return self.conf.loss_function

    def score(self, params, x, labels, state, train, rng=None, mask=None):
        """Mean-over-examples data loss of this head (f32 logits)."""
        x = self.maybe_dropout_input(x, train, rng)
        params = self.maybe_drop_connect(params, train, rng)
        return _score(self.activation, self.loss_function,
                      self.preout(params, x), labels, mask)


@register_impl(L.RnnOutputLayer)
class RnnOutputImpl(OutputImpl):
    """Per-timestep head over [b, t, f]; the product broadcasts over t."""


@register_impl(L.LossLayer)
class LossImpl(LayerImpl):
    """A parameterless activation + loss head."""

    def has_loss(self) -> bool:
        return True

    @property
    def loss_function(self) -> str:
        return self.conf.loss_function

    def forward(self, params, x, state, train, rng=None, mask=None):
        return activate(self.activation, x), state

    def score(self, params, x, labels, state, train, rng=None, mask=None):
        return _score(self.activation, self.loss_function, x, labels, mask)


@register_impl(L.EmbeddingLayer)
class EmbeddingImpl(LayerImpl):
    """Index lookup: int ids [b] or [b, 1] -> [b, n_out], plus the bias."""

    cast_input = False  # ids must stay exact (see LayerImpl.cast_input)

    def init_params(self, gen, device):
        c = self.conf
        W = init_weights(gen, (c.n_in, c.n_out), self.weight_init, c.n_in,
                         c.n_out, c.dist_mean, c.dist_std, dist=c.dist,
                         device=device)
        return {"W": W, "b": torch.full((c.n_out,), float(self.bias_init),
                                        device=device)}

    def forward(self, params, x, state, train, rng=None, mask=None):
        idx = x.long()
        if idx.ndim == 2:
            idx = idx[:, 0]
        return activate(self.activation, params["W"][idx] + params["b"]), state


@register_impl(L.ActivationLayer)
class ActivationImpl(LayerImpl):
    def forward(self, params, x, state, train, rng=None, mask=None):
        return activate(self.activation, x), state


@register_impl(L.DropoutLayer)
class DropoutImpl(LayerImpl):
    def forward(self, params, x, state, train, rng=None, mask=None):
        rate = self.dropout_rate
        if train and rate > 0.0 and rng is not None:
            x = apply_dropout(x, rate, generator(rng, x.device))
        return x, state


@register_impl(L.GlobalPoolingLayer)
class GlobalPoolingImpl(LayerImpl):
    """Pool over time ([b, t, f] -> [b, f], honoring the features mask)
    or space ([b, h, w, c] -> [b, c])."""

    def forward(self, params, x, state, train, rng=None, mask=None):
        pt = self.conf.pooling_type
        if pt == L.PoolingType.PNORM:
            # the reference reads conf.pnorm, which GlobalPoolingLayer
            # does not have (ROADMAP Queue C)
            raise ValueError("GlobalPoolingLayer has no pnorm field: PNORM "
                             "global pooling is unavailable")
        if x.ndim == 3:
            if mask is not None:
                m = mask[:, :, None].to(x.dtype)
                if pt == L.PoolingType.MAX:
                    big_neg = torch.tensor(-1e30, dtype=x.dtype, device=x.device)
                    return torch.amax(torch.where(m > 0, x, big_neg), dim=1), state
                s = torch.sum(x * m, dim=1)
                if pt == L.PoolingType.SUM:
                    return s, state
                return s / torch.clamp(torch.sum(m, dim=1), min=1.0), state
            dims = (1,)
        else:
            dims = (1, 2)
        if pt == L.PoolingType.MAX:
            return torch.amax(x, dim=dims), state
        if pt == L.PoolingType.SUM:
            return torch.sum(x, dim=dims), state
        return torch.mean(x, dim=dims), state
