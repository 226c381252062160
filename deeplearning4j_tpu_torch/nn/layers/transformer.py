"""Transformer block + sequence embedding layer impls.

Counterpart of ``deeplearning4j_tpu/nn/layers/transformer.py``, dense
blocks with a dense KV cache: ``forward`` (inference or training, with
dropout on the attention and MLP outputs; the gradient of attention runs
through the flash backward kernels), ``prefill`` (through the
flash-attention kernel) and ``decode_step`` (plain attention over the
cache, as in the reference). Routed experts (``num_experts > 0``), the
paged-pool branch and quantized weights are not ported yet and raise
``NotImplementedError``.

Pre-LN wiring (x + Attn(LN(x)), x + MLP(LN(x))); LayerNorm runs in f32
with the population variance even under a bf16 compute policy, and the
MLP's GELU is the tanh approximation, both as in the reference.

Unlike the reference's pure functions, ``prefill`` and ``decode_step``
write K/V into the cache tensors in place and return the same tensors:
the cache is the largest buffer of a generate call and is never shared.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.attention import dispatch_attention
from deeplearning4j_tpu_torch.nn.layers.base import (
    LayerImpl,
    apply_dropout,
    register_impl,
)
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.attention import softmax_scale
from deeplearning4j_tpu_torch.util.rng import fold_in, generator


def _layer_norm(x, gamma, beta, eps=1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps) * gamma + beta
    return out.to(x.dtype)


@register_impl(L.SequenceEmbeddingLayer)
class SequenceEmbeddingImpl(LayerImpl):
    """int ids [b, t] -> [b, t, d]: token gather + learned positions. In
    training the gather's gradient scatter-adds into W."""

    cast_input = False

    def init_params(self, gen, device) -> Dict[str, torch.Tensor]:
        c = self.conf
        W = init_weights(gen, (c.n_in, c.n_out), self.weight_init, c.n_in,
                         c.n_out, c.dist_mean, c.dist_std, dist=c.dist,
                         device=device)
        P = 0.01 * torch.randn(c.max_len, c.n_out, generator=gen,
                               device=device)
        return {"W": W, "P": P}

    def forward(self, params, x, state, train, rng=None, mask=None):
        idx = x
        if idx.ndim == 3:  # one-hot input tolerated
            idx = idx.argmax(dim=-1)
        idx = idx.long()
        t = idx.shape[1]
        if t > self.conf.max_len:
            raise ValueError(
                f"sequence length {t} > max_len {self.conf.max_len}")
        return params["W"][idx] + params["P"][:t][None], state


@register_impl(L.TransformerBlock)
class TransformerBlockImpl(LayerImpl):
    def __init__(self, global_conf, conf, name):
        super().__init__(global_conf, conf, name)
        if conf.num_experts > 0:
            raise NotImplementedError(
                "TransformerBlock(num_experts > 0): routed experts are not "
                "ported yet (ROADMAP Queue A)")
        if conf.n_out != conf.n_in:
            raise ValueError("TransformerBlock needs n_in == n_out (d_model)")
        if conf.n_out % conf.num_heads != 0:
            raise ValueError(f"d_model {conf.n_out} not divisible by "
                             f"num_heads {conf.num_heads}")

    def init_params(self, gen, device) -> Dict[str, torch.Tensor]:
        c = self.conf
        d, f = c.n_out, c.ffn_mult * c.n_out

        def mk(shape):
            return init_weights(gen, shape, self.weight_init, shape[0],
                                shape[1], c.dist_mean, c.dist_std,
                                dist=c.dist, device=device)

        ones = lambda n: torch.ones(n, device=device)  # noqa: E731
        zeros = lambda n: torch.zeros(n, device=device)  # noqa: E731
        return {
            "Wqkv": mk((d, 3 * d)), "Wo": mk((d, d)),
            "ln1_g": ones(d), "ln1_b": zeros(d),
            "ln2_g": ones(d), "ln2_b": zeros(d),
            "W1": mk((d, f)), "b1": zeros(f),
            "W2": mk((f, d)), "b2": zeros(d),
        }

    def _qkv(self, params, x):
        """LN1 -> fused QKV projection, split into [..., h, hd] each."""
        c = self.conf
        h = _layer_norm(x, params["ln1_g"], params["ln1_b"])
        qkv = h @ params["Wqkv"].to(h.dtype)
        shape = x.shape[:-1] + (c.num_heads, c.n_out // c.num_heads)
        return [z.reshape(shape) for z in qkv.split(c.n_out, dim=-1)]

    def _ffn(self, params, h2):
        """Post-LN2 dense GELU MLP over [..., d]."""
        mlp = F.gelu(h2 @ params["W1"].to(h2.dtype)
                     + params["b1"].to(h2.dtype), approximate="tanh")
        return mlp @ params["W2"].to(h2.dtype) + params["b2"].to(h2.dtype)

    def _attn_ffn(self, params, x, o, rng=None):
        """x + o.Wo, then + MLP(LN2(.)); o is [b, t, h, hd]. With a
        training stream key ``rng`` and a dropout rate, the attention
        output and the MLP output each take dropout on their own stream
        (``rng`` folded with 1 and with 2, as in the reference)."""
        rate = self.dropout_rate if rng is not None else 0.0

        def drop(z, stream):
            if rate <= 0.0:
                return z
            return apply_dropout(z, rate, generator(fold_in(rng, stream), z.device))

        x = x + drop(o.reshape(x.shape) @ params["Wo"].to(x.dtype), 1)
        h2 = _layer_norm(x, params["ln2_g"], params["ln2_b"])
        return x + drop(self._ffn(params, h2), 2)

    def forward(self, params, x, state, train, rng=None, mask=None):
        if x.ndim != 3:
            raise ValueError(f"TransformerBlock needs [b, t, d], got "
                             f"{tuple(x.shape)}")
        q, k, v = self._qkv(params, x)
        o = dispatch_attention(q, k, v, causal=self.conf.causal, mask=mask)
        out = self._attn_ffn(params, x, o, rng if train else None)
        if mask is not None:
            out = out * mask[:, :, None].to(out.dtype)
        return out, state

    # ------------------------------------------- incremental decoding

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   device="cpu"):
        """Dense KV cache [batch, max_len, h, hd] for K and for V."""
        c = self.conf
        shape = (batch, max_len, c.num_heads, c.n_out // c.num_heads)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def prefill(self, params, x, cache):
        """Prompt forward [b, t, d] that also writes every position's
        K/V into ``cache`` (causal flash attention, maskless). Padded
        positions write garbage K/V that a decode step overwrites before
        any query can attend to it."""
        if "table" in cache:
            raise NotImplementedError("the paged KV pool is not ported yet")
        q, k, v = self._qkv(params, x)
        t = x.shape[1]
        cache["k"][:, :t] = k.to(cache["k"].dtype)
        cache["v"][:, :t] = v.to(cache["v"].dtype)
        o = dispatch_attention(q, k, v, causal=self.conf.causal, mask=None)
        return self._attn_ffn(params, x, o), cache

    def decode_step(self, params, x_t, cache, pos):
        """One-token forward [b, d] over the cache. ``pos`` is the
        current position: an int (whole batch) or a [b] tensor (one per
        row). Writes slot ``pos`` first, then attends to slots <= pos;
        masked scores take ``finfo(dtype).min`` and the softmax runs in
        the compute dtype, as in the reference."""
        if "table" in cache:
            raise NotImplementedError("the paged KV pool is not ported yet")
        c = self.conf
        b, d = x_t.shape
        hd = c.n_out // c.num_heads
        q, k, v = self._qkv(params, x_t)
        ck, cv = cache["k"], cache["v"]
        slots = torch.arange(ck.shape[1], device=ck.device)
        if isinstance(pos, int) or pos.ndim == 0:
            ck[:, pos] = k.to(ck.dtype)
            cv[:, pos] = v.to(cv.dtype)
            live = (slots <= pos)[None, :]
        else:
            rows = torch.arange(b, device=ck.device)
            ck[rows, pos] = k.to(ck.dtype)
            cv[rows, pos] = v.to(cv.dtype)
            live = slots[None, :] <= pos[:, None]
        s = torch.einsum("bhd,bkhd->bhk", q, ck.to(q.dtype)) \
            * softmax_scale(hd, q.dtype)
        s = s.masked_fill(~live[:, None, :], torch.finfo(s.dtype).min)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhk,bkhd->bhd", w, cv.to(q.dtype))
        return self._attn_ffn(params, x_t, o), cache
