"""Output heads: ``OutputLayer`` / ``RnnOutputLayer`` forward and score.

Counterpart of the head part of ``deeplearning4j_tpu/nn/layers/
feedforward.py``. Scoring takes the fused from-logits loss where the
activation and loss allow it (softmax + mcxent/nll, sigmoid + xent).
"""

from __future__ import annotations

from typing import Dict

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.base import LayerImpl, register_impl
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import Activation, activate
from deeplearning4j_tpu_torch.ops.losses import LossFunction, compute_loss


def _fused_logits_pair(activation: str, loss_function: str) -> bool:
    """True when activation + loss compute through the numerically
    stable fused from-logits path (the same function)."""
    act = Activation(activation)
    lf = LossFunction(loss_function)
    return (act is Activation.SOFTMAX and lf in (
        LossFunction.MCXENT, LossFunction.NEGATIVELOGLIKELIHOOD)) or \
        (act is Activation.SIGMOID and lf is LossFunction.XENT)


@register_impl(L.OutputLayer)
class OutputImpl(LayerImpl):
    """Dense + loss head: z = x.W + b, a = act(z)."""

    applies_drop_connect = True

    def has_loss(self) -> bool:
        return True

    def init_params(self, gen, device) -> Dict[str, torch.Tensor]:
        c = self.conf
        W = init_weights(gen, (c.n_in, c.n_out), self.weight_init, c.n_in,
                         c.n_out, c.dist_mean, c.dist_std, dist=c.dist,
                         device=device)
        b = torch.full((c.n_out,), float(self.bias_init), device=device)
        return {"W": W, "b": b}

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

    def forward(self, params, x, state, train, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        params = self.maybe_drop_connect(params, train, rng)
        return activate(self.activation, self.preout(params, x)), state

    def score(self, params, x, labels, state, train, rng=None, mask=None):
        """Mean-over-examples data loss of this head (f32 logits)."""
        x = self.maybe_dropout_input(x, train, rng)
        params = self.maybe_drop_connect(params, train, rng)
        z = self.preout(params, x)
        if _fused_logits_pair(self.activation, self.loss_function):
            return compute_loss(self.loss_function, labels, z, mask=mask,
                                from_logits=True)
        return compute_loss(self.loss_function, labels,
                            activate(self.activation, z), mask=mask)


@register_impl(L.RnnOutputLayer)
class RnnOutputImpl(OutputImpl):
    """Per-timestep head over [b, t, f]; the product broadcasts over t."""
