"""Scaled-dot-product attention, the plain formulation.

Counterpart of ``deeplearning4j_tpu/ops/attention.py``. It is the
oracle the flash kernel is held against and the path the flash wrapper
takes where the kernel does not apply. Shapes follow
[batch, time, heads, head_dim] throughout.
"""

from __future__ import annotations

from typing import Optional

import torch


def softmax_scale(d: int, dtype: torch.dtype) -> float:
    """1/sqrt(d) computed in ``dtype`` as the reference computes it
    (sqrt, then reciprocal, each rounded), returned as the exact Python
    float of that value so no device tensor is made for it."""
    return (1.0 / torch.sqrt(torch.tensor(d, dtype=dtype))).item()


def scaled_dot_product_attention(
    q: torch.Tensor,  # [b, tq, h, d]
    k: torch.Tensor,  # [b, tk, h, d]
    v: torch.Tensor,  # [b, tk, h, d]
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,  # [b, tk] key validity
) -> torch.Tensor:
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * softmax_scale(
        q.shape[-1], q.dtype)
    neg = torch.finfo(scores.dtype).min
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        keep = torch.ones(tq, tk, dtype=torch.bool,
                          device=q.device).tril(diagonal=tk - tq)
        scores = scores.masked_fill(~keep[None, None], neg)
    if mask is not None:
        scores = scores.masked_fill(~(mask[:, None, None, :] > 0), neg)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)
