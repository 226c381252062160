"""Output heads: ``OutputLayer`` / ``RnnOutputLayer`` forward.

Counterpart of the head part of ``deeplearning4j_tpu/nn/layers/
feedforward.py``. Scoring (the losses) waits for the training slice.
"""

from __future__ import annotations

from typing import Dict

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.base import LayerImpl, register_impl
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import activate


@register_impl(L.OutputLayer)
class OutputImpl(LayerImpl):
    """Dense + loss head: z = x.W + b, a = act(z)."""

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
        ``preferred_element_type=f32`` matmul sums."""
        W = params["W"]
        if torch.promote_types(x.dtype, W.dtype) in (torch.bfloat16,
                                                     torch.float16):
            z = x.float() @ W.float()
        else:
            z = x @ W
        return z + params["b"].to(z.dtype) if "b" in params else z

    def forward(self, params, x, state, train, mask=None):
        if train:
            raise NotImplementedError("training is not ported yet")
        return activate(self.activation, self.preout(params, x)), state


@register_impl(L.RnnOutputLayer)
class RnnOutputImpl(OutputImpl):
    """Per-timestep head over [b, t, f]; the product broadcasts over t."""
