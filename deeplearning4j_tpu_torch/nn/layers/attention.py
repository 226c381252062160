"""Multi-head self-attention: the dispatch shared by the attention-bearing
layers, and the ``AttentionLayer`` impl.

Counterpart of ``deeplearning4j_tpu/nn/layers/attention.py`` without a
sequence mesh: ``dispatch_attention`` is the flash wrapper, whose own
rules send key masks and awkward lengths to the plain formulation (the
reference's dispatch gate). Ring attention and the ``xla_attention()``
override wait for ROADMAP Queue A10.
"""

from __future__ import annotations

from typing import Dict

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.base import LayerImpl, register_impl
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention


def dispatch_attention(q, k, v, causal: bool, mask=None):
    """[b, t, h, d] attention for every attention-bearing layer."""
    return flash_attention(q, k, v, causal=causal, mask=mask)


@register_impl(L.AttentionLayer)
class AttentionImpl(LayerImpl):
    """[b, t, f] -> [b, t, n_out]: the Q, K and V projections, attention
    over ``num_heads`` heads (causal or not, keys masked by the features
    mask), the output projection with its bias, then the residual (which
    needs n_in == n_out) and the mask."""

    def init_params(self, gen, device) -> Dict[str, torch.Tensor]:
        c = self.conf
        if c.n_out % c.num_heads != 0:
            raise ValueError(f"n_out {c.n_out} not divisible by num_heads "
                             f"{c.num_heads}")

        def mk(shape):
            return init_weights(gen, shape, self.weight_init, shape[0],
                                shape[1], c.dist_mean, c.dist_std,
                                dist=c.dist, device=device)

        return {
            "Wq": mk((c.n_in, c.n_out)),
            "Wk": mk((c.n_in, c.n_out)),
            "Wv": mk((c.n_in, c.n_out)),
            "Wo": mk((c.n_out, c.n_out)),
            "bo": torch.zeros(c.n_out, device=device),
        }

    def forward(self, params, x, state, train, rng=None, mask=None):
        c = self.conf
        if x.ndim != 3:
            raise ValueError(
                f"AttentionLayer needs [batch, time, features] input, got "
                f"shape {tuple(x.shape)}. Stepwise rnn_time_step inference is "
                f"not supported for attention (no KV cache) — feed full "
                f"windows.")
        x = self.maybe_dropout_input(x, train, rng)
        b, t, _ = x.shape
        h = c.num_heads
        split = lambda z: z.reshape(b, t, h, c.n_out // h)  # noqa: E731
        q = split(x @ params["Wq"].to(x.dtype))
        k = split(x @ params["Wk"].to(x.dtype))
        v = split(x @ params["Wv"].to(x.dtype))
        o = dispatch_attention(q, k, v, causal=c.causal, mask=mask)
        out = o.reshape(b, t, c.n_out) @ params["Wo"].to(x.dtype) \
            + params["bo"].to(x.dtype)
        if c.residual:
            if c.n_in != c.n_out:
                raise ValueError("residual attention needs n_in == n_out")
            out = out + x
        if mask is not None:
            out = out * mask[:, :, None].to(out.dtype)
        return out, state
