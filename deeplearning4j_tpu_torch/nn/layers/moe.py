"""Mixture-of-experts layer impl.

Counterpart of ``deeplearning4j_tpu/nn/layers/moe.py``; the routing
math lives in ``ops/moe.py``. The Switch load-balancing aux loss depends
on the activations, so it rides the layer-state seam: ``forward`` writes
the weighted aux into ``state["__aux_loss__"]`` and the containers add
every such entry to the training objective, inside the autograd graph
of the step.
"""

from __future__ import annotations

from typing import Dict

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.base import LayerImpl, register_impl
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.moe import moe_ffn

AUX_LOSS_KEY = "__aux_loss__"


def init_moe_params(gen, d: int, f: int, e: int, weight_init: str,
                    dist_mean: float, dist_std: float, dist=None,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """Router and expert FFN weights (shared by MoEImpl and the MoE
    variant of TransformerBlock)."""
    def mk(shape, fi, fo):
        return init_weights(gen, shape, weight_init, fi, fo, dist_mean,
                            dist_std, dist=dist, device=device)

    return {
        "Wg": mk((d, e), d, e),
        "W1": mk((e, d, f), d, f),
        "b1": torch.zeros((e, f), device=device),
        "W2": mk((e, f, d), f, d),
        "b2": torch.zeros((e, d), device=device),
    }


def run_moe_ffn(params, x2: torch.Tensor, capacity_factor: float,
                aux_loss_weight: float, mask=None):
    """Flattened-token MoE forward with the weighted aux packaged for
    the layer-state seam: returns (y2, {AUX_LOSS_KEY: weighted aux})."""
    valid = mask.reshape(-1) if mask is not None else None
    y2, aux = moe_ffn(x2, params["Wg"], params["W1"], params["b1"],
                      params["W2"], params["b2"],
                      capacity_factor=capacity_factor, valid=valid)
    return y2, {AUX_LOSS_KEY: aux_loss_weight * aux.float()}


@register_impl(L.MoELayer)
class MoEImpl(LayerImpl):
    # the aux loss and the capacity are batch-level quantities: padded
    # rows would skew both
    batch_statistics = True

    def init_params(self, gen, device) -> Dict[str, torch.Tensor]:
        c = self.conf
        if c.n_out != c.n_in:
            raise ValueError("MoELayer needs n_in == n_out (FFN block)")
        return init_moe_params(gen, c.n_in, c.ffn_mult * c.n_in,
                               c.num_experts, self.weight_init, c.dist_mean,
                               c.dist_std, dist=c.dist, device=device)

    def init_state(self, device) -> Dict[str, torch.Tensor]:
        return {AUX_LOSS_KEY: torch.zeros((), device=device)}

    def forward(self, params, x, state, train, rng=None, mask=None):
        c = self.conf
        x = self.maybe_dropout_input(x, train, rng)
        shape = tuple(x.shape)
        if x.ndim not in (2, 3):
            raise ValueError(f"MoELayer needs [b, d] or [b, t, d], got {shape}")
        x2 = x.reshape(-1, shape[-1])
        # masked timesteps must not occupy capacity or skew the aux
        routing_mask = mask if (mask is not None and x.ndim == 3) else None
        y2, new_state = run_moe_ffn(params, x2, c.capacity_factor,
                                    c.aux_loss_weight, mask=routing_mask)
        y = y2.reshape(shape[:-1] + (c.n_out,))
        if c.residual:
            y = y + x
        if mask is not None and y.ndim == 3:
            y = y * mask[:, :, None].to(y.dtype)
        return y, new_state
