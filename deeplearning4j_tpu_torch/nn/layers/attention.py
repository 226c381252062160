"""Attention dispatch shared by the attention-bearing layers.

Counterpart of ``deeplearning4j_tpu/nn/layers/attention.py``,
``dispatch_attention`` without a sequence mesh: the flash wrapper, whose
own rules send key masks and awkward lengths to the plain formulation.
Ring attention, the ``xla_attention()`` override and ``AttentionLayer``
wait for ROADMAP Queue A10.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention


def dispatch_attention(q, k, v, causal: bool, mask=None):
    """[b, t, h, d] attention for every attention-bearing layer."""
    return flash_attention(q, k, v, causal=causal, mask=mask)
