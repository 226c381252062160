"""Transformer block + sequence embedding layer impls.

Counterpart of ``deeplearning4j_tpu/nn/layers/transformer.py``, blocks
with a dense KV cache: ``forward`` (inference or training, with dropout
on the attention and MLP outputs; the gradient of attention runs through
the flash backward kernels), ``prefill`` (through the flash-attention
kernel) and ``decode_step`` (plain attention over the cache, as in the
reference). The feed-forward is a dense GELU MLP or, with
``num_experts > 0``, Mixtral-style top-1 routed experts (``_ffn``, the
one implementation the three paths share): training routes with the
configured capacity and writes the weighted aux loss into the block's
state; prefill and decode route with capacity n, so no token overflows.
Projections and the token gather go through ``qmatmul`` / ``qtake``, so
int8/fp8 weights (``nn/quantize.py``) serve on every path. With a paged
pool (``nn/kvpool.py``), ``decode_step`` (a cache carrying ``"table"``)
and ``prefill_paged`` scatter K/V into the pool through each row's block
table, then gather the table back and attend causally; a quantized pool
quantizes on the scatter and dequantizes on the gather.

Pre-LN wiring (x + Attn(LN(x)), x + MLP(LN(x))); LayerNorm runs in f32
with the population variance even under a bf16 compute policy, and the
MLP's GELU is the tanh approximation, both as in the reference.

Unlike the reference's pure functions, ``prefill``, ``prefill_paged``
and ``decode_step`` write K/V into the cache or pool tensors in place
and return the same tensors: the cache is the largest buffer of a
generate call and is never shared.
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
from deeplearning4j_tpu_torch.nn.layers.moe import (
    AUX_LOSS_KEY,
    init_moe_params,
    run_moe_ffn,
)
from deeplearning4j_tpu_torch.nn.quantize import (
    kv_dequantize,
    kv_quantize,
    qmatmul,
    qtake,
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
        return qtake(params, "W", idx) + params["P"][:t][None], state


@register_impl(L.TransformerBlock)
class TransformerBlockImpl(LayerImpl):
    def __init__(self, global_conf, conf, name):
        super().__init__(global_conf, conf, name)
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
        params = {
            "Wqkv": mk((d, 3 * d)), "Wo": mk((d, d)),
            "ln1_g": ones(d), "ln1_b": zeros(d),
            "ln2_g": ones(d), "ln2_b": zeros(d),
        }
        if c.num_experts > 0:  # Mixtral-style routed MLP (shared init)
            params.update(init_moe_params(
                gen, d, f, c.num_experts, self.weight_init, c.dist_mean,
                c.dist_std, dist=c.dist, device=device))
        else:
            params.update({"W1": mk((d, f)), "b1": zeros(f),
                           "W2": mk((f, d)), "b2": zeros(d)})
        return params

    def init_state(self, device) -> Dict[str, torch.Tensor]:
        if self.conf.num_experts > 0:
            return {AUX_LOSS_KEY: torch.zeros((), device=device)}
        return {}

    def _qkv(self, params, x):
        """LN1 -> fused QKV projection, split into [..., h, hd] each."""
        c = self.conf
        h = _layer_norm(x, params["ln1_g"], params["ln1_b"])
        qkv = qmatmul(h, params, "Wqkv")
        shape = x.shape[:-1] + (c.num_heads, c.n_out // c.num_heads)
        return [z.reshape(shape) for z in qkv.split(c.n_out, dim=-1)]

    def _ffn(self, params, h2, state, mask=None, capacity_factor=None):
        """Post-LN2 feed-forward over [..., d]: the dense GELU MLP, or
        the routed experts over the flattened tokens (``mask`` [b, t]
        keeps masked tokens out of the routing). Returns (output, the
        new state: the weighted aux loss for experts, else ``state``)."""
        c = self.conf
        if c.num_experts > 0:
            d = h2.shape[-1]
            y2, new_state = run_moe_ffn(params, h2.reshape(-1, d),
                                        capacity_factor, c.aux_loss_weight,
                                        mask=mask)
            return y2.reshape(h2.shape), new_state
        mlp = F.gelu(qmatmul(h2, params, "W1") + params["b1"].to(h2.dtype),
                     approximate="tanh")
        return qmatmul(mlp, params, "W2") + params["b2"].to(h2.dtype), state

    def _attn_ffn(self, params, x, o, state, rng=None, mask=None,
                  capacity_factor=None):
        """x + o.Wo, then + FFN(LN2(.)); o is [b, t, h, hd] (or [b, h,
        hd]). With a training stream key ``rng`` and a dropout rate, the
        attention output and the FFN output each take dropout on their
        own stream (``rng`` folded with 1 and with 2, as in the
        reference). Returns (output, the FFN's new state)."""
        rate = self.dropout_rate if rng is not None else 0.0

        def drop(z, stream):
            if rate <= 0.0:
                return z
            return apply_dropout(z, rate, generator(fold_in(rng, stream), z.device))

        x = x + drop(qmatmul(o.reshape(x.shape), params, "Wo"), 1)
        h2 = _layer_norm(x, params["ln2_g"], params["ln2_b"])
        mlp, new_state = self._ffn(params, h2, state, mask=mask,
                                   capacity_factor=capacity_factor)
        return x + drop(mlp, 2), new_state

    def _serving_capacity(self) -> float:
        """Prefill and decode route no-drop: capacity = n tokens."""
        return float(max(1, self.conf.num_experts))

    def forward(self, params, x, state, train, rng=None, mask=None):
        if x.ndim != 3:
            raise ValueError(f"TransformerBlock needs [b, t, d], got "
                             f"{tuple(x.shape)}")
        q, k, v = self._qkv(params, x)
        o = dispatch_attention(q, k, v, causal=self.conf.causal, mask=mask)
        out, new_state = self._attn_ffn(params, x, o, state,
                                        rng if train else None, mask,
                                        self.conf.capacity_factor)
        if mask is not None:
            out = out * mask[:, :, None].to(out.dtype)
        return out, new_state

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
        q, k, v = self._qkv(params, x)
        t = x.shape[1]
        cache["k"][:, :t] = k.to(cache["k"].dtype)
        cache["v"][:, :t] = v.to(cache["v"].dtype)
        o = dispatch_attention(q, k, v, causal=self.conf.causal, mask=None)
        out, _ = self._attn_ffn(params, x, o, {},
                                capacity_factor=self._serving_capacity())
        return out, cache

    def prefill_paged(self, params, x, pool, table, pos, write_ok):
        """Tail prefill through the paged pool: ``x`` [b, t, d] tail
        activations, ``pos`` [b, t] each token's absolute position,
        ``write_ok`` [b, t] masking padding (its writes go to trash
        block 0, offset 0). The tail's K/V scatter into the table's
        blocks first; then the whole table is gathered back and the tail
        queries attend causally to the cached prefix and themselves.
        Returns ([b, t, d], the pool)."""
        q, k, v = self._qkv(params, x)
        # a padding position may lie past the table; its write is masked
        blk = table.gather(1, (pos // pool["k"].shape[1]).clamp(
            max=table.shape[1] - 1))
        o = self._paged_attention(q, k, v, pool, table, blk, pos,
                                  write_ok)
        out, _ = self._attn_ffn(params, x, o, {},
                                capacity_factor=self._serving_capacity())
        return out, pool

    def _paged_attention(self, q, k, v, pool, table, blk, pos, write):
        """Scatter ``k``/``v`` [b, (t,) h, hd] at (``blk``, ``pos`` %
        bs), masked entries of ``write`` to (0, 0); gather every row's
        table into [b, MB*bs, h, hd]; attend with scores past ``pos``
        at ``finfo.min``. Returns o shaped as q."""
        kp, vp = pool["k"], pool["v"]
        bs, mb = kp.shape[1], table.shape[1]
        off = pos % bs
        if write is not None:
            blk = torch.where(write, blk, 0)
            off = torch.where(write, off, 0)
        quant = "k_scale" in pool
        if quant:
            kq, ksc = kv_quantize(k, kp.dtype)
            vq, vsc = kv_quantize(v, vp.dtype)
            kp[blk, off] = kq
            vp[blk, off] = vq
            pool["k_scale"][blk, off] = ksc
            pool["v_scale"][blk, off] = vsc
        else:
            kp[blk, off] = k.to(kp.dtype)
            vp[blk, off] = v.to(vp.dtype)
        b = table.shape[0]
        kg = kp[table].reshape(b, mb * bs, *kp.shape[2:])
        vg = vp[table].reshape(b, mb * bs, *vp.shape[2:])
        if quant:
            h = kp.shape[2]
            kg = kv_dequantize(kg, pool["k_scale"][table].reshape(
                b, mb * bs, h), q.dtype)
            vg = kv_dequantize(vg, pool["v_scale"][table].reshape(
                b, mb * bs, h), q.dtype)
        slots = torch.arange(mb * bs, device=kp.device)
        if q.ndim == 3:   # one token a row: [b, h, hd]
            s = torch.einsum("bhd,bkhd->bhk", q, kg.to(q.dtype))
            live = (slots[None, :] <= pos[:, None])[:, None, :]
        else:             # [b, t, h, hd]
            s = torch.einsum("bqhd,bkhd->bhqk", q, kg.to(q.dtype))
            live = (slots[None, None, :] <= pos[:, :, None])[:, None]
        s = s * softmax_scale(q.shape[-1], q.dtype)
        s = s.masked_fill(~live, torch.finfo(s.dtype).min)
        w = torch.softmax(s, dim=-1)
        if q.ndim == 3:
            return torch.einsum("bhk,bkhd->bhd", w, vg.to(q.dtype))
        return torch.einsum("bhqk,bkhd->bqhd", w, vg.to(q.dtype))

    def decode_step(self, params, x_t, cache, pos, write_mask=None):
        """One-token forward [b, d] over the cache. ``pos`` is the
        current position: an int (whole batch) or a [b] tensor (one per
        row). Writes slot ``pos`` first, then attends to slots <= pos;
        masked scores take ``finfo(dtype).min`` and the softmax runs in
        the compute dtype, as in the reference.

        Paged mode: a cache with ``"table"`` [b, MB] holds the shared
        pool tensors ``[num_blocks, block_size, h, hd]`` (and the scales
        of a quantized pool); ``pos`` is a [b] tensor. The token's K/V
        land at (table[pos // bs], pos % bs), or at trash block 0 where
        ``write_mask`` [b] is False, and the row's blocks are gathered
        back in causal order."""
        c = self.conf
        b, d = x_t.shape
        hd = c.n_out // c.num_heads
        q, k, v = self._qkv(params, x_t)
        if "table" in cache:
            table = cache["table"]
            # a finished row's position may sit one past its last block;
            # its write is masked, so any in-range block will do
            blk_of = (pos // cache["k"].shape[1]).clamp(
                max=table.shape[1] - 1)
            blk = table.gather(1, blk_of[:, None])[:, 0]
            o = self._paged_attention(q, k, v, cache, table, blk, pos,
                                      write_mask)
            out, _ = self._attn_ffn(params, x_t, o, {},
                                    capacity_factor=self._serving_capacity())
            return out, cache
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
        out, _ = self._attn_ffn(params, x_t, o, {},
                                capacity_factor=self._serving_capacity())
        return out, cache
