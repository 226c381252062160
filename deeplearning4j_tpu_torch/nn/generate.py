"""Autoregressive generation: bucketed prefill + decode.

Counterpart of ``deeplearning4j_tpu/nn/generate.py``:

- **transformer stacks** (SequenceEmbedding -> TransformerBlock* ->
  head): one batched prefill over the prompt, right-padded up the
  power-of-two bucket ladder, writes every block's KV cache through the
  flash-attention kernel and returns the logits of each row's last real
  token (``lengths - 1``); then one ``decode_step`` per new token over
  the dense caches, with per-row positions;
- **recurrent stacks** (layers with ``rnn_time_step`` under a head, the
  char-RNN): the one-hot prompt, padded to a power of two, streams
  through the stack one timestep at a time (the fused LSTM scan at
  t = 1), each row's carries held past its own length; then one step
  per token, the sampled ids fed back as one-hot rows. No positions:
  the carry is the history;
- ``run`` keeps tokens, positions and the EOS done-mask on the device
  and fetches the tokens once at the end; ``run_eager`` is the
  per-token host-loop reference (one fetch per token). Both give the
  same tokens;
- **sampling**: greedy, or temperature with the reference's top-k and
  top-p filters and a Gumbel-max draw. The noise of row ``r`` at step
  ``s`` comes from a ``torch.Generator`` seeded from the row's key
  (itself from ``(seed, r)``) folded with ``s``, so a row's draws never
  depend on its batch mates. ``jax.random`` cannot be replayed, so
  sampled paths match the reference in distribution, not draw for draw.

The reference's decode metrics and spans, the paged pool programs and
the speculative programs wait for later slices (ROADMAP Queue A).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.datasets.iterators import bucket_for, bucket_sizes
from deeplearning4j_tpu_torch.nn.layers.transformer import (
    SequenceEmbeddingImpl,
    TransformerBlockImpl,
)
from deeplearning4j_tpu_torch.util.dtypes import cast_floats
from deeplearning4j_tpu_torch.util.rng import MASK64, mix64 as _mix

#: (temperature, top_k, top_p, eos_token-or-None)
SamplerSig = Tuple[float, int, float, Optional[int]]


def sampler_sig(temperature: float = 0.0, top_k: int = 0,
                top_p: float = 0.0, eos_token: Optional[int] = None
                ) -> SamplerSig:
    """Normalize sampler knobs into one signature."""
    return (float(temperature), int(top_k), float(top_p),
            None if eos_token is None else int(eos_token))


def row_keys(seed: int, rows: int) -> List[int]:
    """Per-row 63-bit keys from ``(seed, row)``."""
    base = _mix(int(seed) & MASK64)
    return [_mix(base ^ r) >> 1 for r in range(rows)]


def _pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (the bucket ladder of recurrent
    prompts, which have no max_len to cap at)."""
    return 1 << max(0, int(n) - 1).bit_length() if n > 1 else 1


def _gumbel(keys: Sequence[int], folds: Sequence[int], vocab: int,
            device) -> torch.Tensor:
    """[b, vocab] standard Gumbel noise; row i from a generator seeded
    with ``keys[i]`` folded with ``folds[i]``."""
    rows = []
    for key, fold in zip(keys, folds):
        g = torch.Generator(device=device)
        g.manual_seed(_mix(int(key) ^ _mix(int(fold))) >> 1)
        rows.append(torch.rand(vocab, generator=g, device=device))
    u = torch.stack(rows).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, keys: Sequence[int], step: int,
                  temperature: float, top_k: int, top_p: float
                  ) -> torch.Tensor:
    """Sampler over [b, V] logits: greedy (temperature <= 0), else
    temperature softmax, optionally restricted to the ``top_k`` highest
    logits and/or the smallest nucleus with cumulative probability >=
    ``top_p``, drawn by Gumbel-max at ``step``."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    lg = logits.float() / float(temperature)
    neg = torch.finfo(torch.float32).min
    vocab = lg.shape[-1]
    if top_k and top_k < vocab:
        kth = lg.topk(int(top_k), dim=-1).values[:, -1:]
        lg = lg.masked_fill(lg < kth, neg)
    if top_p and top_p < 1.0:
        srt = lg.sort(dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        keep = probs.cumsum(dim=-1) - probs < top_p
        cutoff = torch.where(keep, srt, torch.inf).amin(dim=-1, keepdim=True)
        lg = lg.masked_fill(lg < cutoff, neg)
    g = _gumbel(keys, [step] * lg.shape[0], vocab, lg.device)
    return (lg + g).argmax(dim=-1)


def _filter_logits(logits: torch.Tensor, temp_v: torch.Tensor,
                   top_k_v: torch.Tensor, top_p_v: torch.Tensor
                   ) -> torch.Tensor:
    """The rowwise sampler's filter over [b, V] logits with per-row knob
    vectors: scaled f32 logits with every filtered entry at
    ``finfo.min``. Top-k first, then top-p over the k-filtered logits."""
    vocab = logits.shape[-1]
    lg = logits.float() / temp_v.float().clamp_min(1e-6)[:, None]
    neg = torch.finfo(torch.float32).min
    srt = lg.sort(dim=-1, descending=True).values
    k_idx = (top_k_v.long() - 1).clamp(0, vocab - 1)
    kth = srt.gather(1, k_idx[:, None])
    use_k = ((top_k_v > 0) & (top_k_v < vocab))[:, None]
    lg = lg.masked_fill(use_k & (lg < kth), neg)
    srt2 = lg.sort(dim=-1, descending=True).values
    probs = torch.softmax(srt2, dim=-1)
    keep = probs.cumsum(dim=-1) - probs < top_p_v.float()[:, None]
    cutoff = torch.where(keep, srt2, torch.inf).amin(dim=-1, keepdim=True)
    use_p = ((top_p_v > 0.0) & (top_p_v < 1.0))[:, None]
    return lg.masked_fill(use_p & (lg < cutoff), neg)


def sample_tokens_rowwise(logits, keys, folds, temp_v, top_k_v, top_p_v):
    """Per-row sampler: every knob is a [b] vector and the fold index is
    per row (each sequence's own token counter); ``temp_v <= 0`` rows
    are greedy."""
    greedy = logits.argmax(dim=-1)
    lg = _filter_logits(logits, temp_v, top_k_v, top_p_v)
    folds = folds.tolist() if torch.is_tensor(folds) else list(folds)
    g = _gumbel(keys, folds, lg.shape[-1], lg.device)
    sampled = (lg + g).argmax(dim=-1)
    return torch.where(temp_v > 0.0, sampled, greedy)


class _Generator:
    """The sampling loop both generators share. A generator supplies
    ``_start(params, ids, lengths, max_new) -> (state, logits of each
    row's last prompt token)`` (ids and lengths on the device) and
    ``_next(state, tok) -> (state, next logits)``."""

    def _begin(self, params, ids, lengths, max_new):
        dev = self.net.device
        ids_d = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=dev)
        len_d = torch.as_tensor(np.asarray(lengths), dtype=torch.long,
                                device=dev)
        return (len_d, *self._start(params, ids_d, len_d, max_new))

    def run(self, params, ids: np.ndarray, lengths: np.ndarray, max_new: int,
            sampler: SamplerSig, keys: Sequence[int]) -> np.ndarray:
        """Generation over a bucket-padded prompt batch: ``ids`` [b, t_pad]
        (rows right-padded past ``lengths``) -> the [b, max_new]
        generated ids. Tokens and the done-mask stay on the device; the
        tokens are fetched once."""
        temperature, top_k, top_p, eos = sampler
        len_d, state, logits0 = self._begin(params, ids, lengths, max_new)
        tok = sample_tokens(logits0, keys, 0, temperature, top_k, top_p)
        if eos is not None:
            tok = torch.where(len_d == 0, eos, tok)
            done = tok == eos
        out = [tok]
        for s in range(1, max_new):
            state, logits = self._next(state, tok)
            nxt = sample_tokens(logits, keys, s, temperature, top_k, top_p)
            if eos is not None:
                nxt = torch.where(done, eos, nxt)
                done = done | (nxt == eos)
            out.append(nxt)
            tok = nxt
        return torch.stack(out, dim=1).cpu().numpy()

    def run_eager(self, params, ids, lengths, max_new, sampler, keys
                  ) -> np.ndarray:
        """Per-token host-loop reference for :meth:`run`: same prefill
        and math, the tokens and the done-mask kept on the host and
        fetched after every step."""
        temperature, top_k, top_p, eos = sampler
        dev = self.net.device
        _, state, logits0 = self._begin(params, ids, lengths, max_new)
        tok = sample_tokens(logits0, keys, 0, temperature, top_k,
                            top_p).cpu().numpy()
        done = np.zeros(tok.shape[0], bool)
        if eos is not None:
            tok = np.where(np.asarray(lengths) == 0, eos, tok)
            done |= tok == eos
        out = [tok]
        for s in range(1, max_new):
            state, logits = self._next(state, torch.as_tensor(tok, device=dev))
            nxt = sample_tokens(logits, keys, s, temperature, top_k,
                                top_p).cpu().numpy()
            if eos is not None:
                nxt = np.where(done, eos, nxt)
                done |= nxt == eos
            out.append(nxt)
            tok = nxt
        return np.stack(out, axis=1)


class TransformerGenerator(_Generator):
    """KV-cache generation for SequenceEmbedding -> TransformerBlock* ->
    head stacks: bucketed batched prefill + per-token decode."""

    def __init__(self, net, impls: List[Any]):
        self.net = net
        self.impls = impls
        self.emb: SequenceEmbeddingImpl = impls[0]
        self.blocks: List[TransformerBlockImpl] = list(impls[1:-1])
        self.head = impls[-1]
        self.cd = net._cd

    def prompt_bucket(self, t_in: int, max_new: int) -> int:
        max_len = self.emb.conf.max_len
        if t_in < 1:
            raise ValueError(f"empty prompt (length {t_in})")
        if t_in + max_new > max_len:
            raise ValueError(f"prompt {t_in} + {max_new} new tokens exceeds "
                             f"max_len {max_len}")
        return bucket_for(t_in, bucket_sizes(max_len))

    # ----------------------------------------------------- programs
    # every program takes ``pc``, the compute-dtype copy of the params

    def _head_logits(self, pc, h) -> torch.Tensor:
        return self.head.preout(pc[self.head.name], h).float()

    def _embed_token(self, pc, tok, pos) -> torch.Tensor:
        p = pc[self.emb.name]
        return p["W"][tok] + p["P"][pos]

    @torch.no_grad()
    def prefill(self, pc, ids: torch.Tensor, lengths: torch.Tensor,
                cache_len: int):
        """ids [b, t_pad] -> (caches, logits of each row's last real
        token [b, V] f32). Length-0 rows (serving padding) read garbage
        that their done-mask discards."""
        b, t_pad = ids.shape
        p_emb = pc[self.emb.name]
        x = p_emb["W"][ids] + p_emb["P"][:t_pad][None]
        cache_dtype = self.cd if self.cd is not None else torch.float32
        caches = []
        for blk in self.blocks:
            cache = blk.init_cache(b, cache_len, cache_dtype, ids.device)
            x, cache = blk.prefill(pc[blk.name], x, cache)
            caches.append(cache)
        last = x[torch.arange(b, device=ids.device), lengths - 1]
        return caches, self._head_logits(pc, last)

    @torch.no_grad()
    def decode(self, pc, caches, tok: torch.Tensor, pos: torch.Tensor
               ) -> torch.Tensor:
        """Feed tokens [b] at positions [b]; returns next logits [b, V]."""
        x = self._embed_token(pc, tok, pos)
        for blk, cache in zip(self.blocks, caches):
            x, _ = blk.decode_step(pc[blk.name], x, cache, pos)
        return self._head_logits(pc, x)

    # --------------------------------------------------------- run
    # state: (compute-dtype params, caches, each row's next position)

    def _start(self, params, ids, lengths, max_new):
        pc = self.net.cast_params(params)
        caches, logits0 = self.prefill(pc, ids, lengths,
                                       ids.shape[1] + max_new)
        return (pc, caches, lengths.clone()), logits0

    def _next(self, state, tok):
        pc, caches, pos = state
        return (pc, caches, pos + 1), self.decode(pc, caches, tok, pos)


class RecurrentGenerator(_Generator):
    """Char-RNN generation for stacks of recurrent (``rnn_time_step``)
    layers under a head: the prompt streams through the stack's
    one-timestep forward (the ``MultiLayerNetwork.rnn_time_step``
    recurrence, on the f32 parameters), then one step per token."""

    def __init__(self, net, impls: List[Any]):
        self.net = net
        self.impls = impls
        self.head = impls[-1]
        self.cd = net._cd
        self.n_in = impls[0].conf.n_in
        self._head_in = impls[-2].conf.n_out

    def prompt_bucket(self, t_in: int, max_new: int) -> int:
        if t_in < 1:
            raise ValueError(f"empty prompt (length {t_in})")
        return _pow2_bucket(t_in)

    def _one_step(self, params, rstate, xt):
        """The stack below the head, one timestep: returns (the head's
        input [b, f], the new carries)."""
        return self.net._rnn_step(params, rstate, xt, self.impls[:-1])

    def _head_logits(self, params, h) -> torch.Tensor:
        """f32 logits: the head's product on compute-dtype operands."""
        p = params[self.head.name]
        if self.cd is not None and "W" in p:
            p = cast_floats(p, self.cd)
        return self.head.preout(p, h).float()

    @torch.no_grad()
    def prefill(self, params, ids: torch.Tensor, lengths: torch.Tensor):
        """ids [b, t_pad] -> (carries after each row's last real token,
        that token's logits [b, V] f32)."""
        b, t_pad = ids.shape
        xs = F.one_hot(ids, self.n_in).float()
        rstate = self.net._init_rnn_state(b)
        last_h = torch.zeros(b, self._head_in, device=ids.device)
        for t in range(t_pad):
            h, new = self._one_step(params, rstate, xs[:, t])
            upd = (t < lengths)[:, None]  # hold carries past each row's end
            rstate = {k: {s: torch.where(upd, new[k][s], rstate[k][s])
                          for s in rstate[k]} for k in rstate}
            last_h = torch.where((t == lengths - 1)[:, None], h, last_h)
        return rstate, self._head_logits(params, last_h)

    @torch.no_grad()
    def step(self, params, rstate, tok: torch.Tensor):
        """Feed tokens [b]; returns (the new carries, next logits [b, V])."""
        h, rstate = self._one_step(params, rstate,
                                   F.one_hot(tok, self.n_in).float())
        return rstate, self._head_logits(params, h)

    # state: (params, the carries)

    def _start(self, params, ids, lengths, max_new):
        rstate, logits0 = self.prefill(params, ids, lengths)
        return (params, rstate), logits0

    def _next(self, state, tok):
        params, rstate = state
        rstate, logits = self.step(params, rstate, tok)
        return (params, rstate), logits


def build_generator(net):
    """Build (or return the cached) generator: SequenceEmbedding ->
    TransformerBlock* -> head stacks get KV-cache prefill/decode; stacks
    with ``rnn_time_step`` layers under a head get the recurrent path.
    Anything else raises."""
    gen = net.__dict__.get("_generator")
    if gen is not None and gen.net is net:
        return gen
    impls = net.impls
    if (len(impls) >= 3 and isinstance(impls[0], SequenceEmbeddingImpl)
            and all(isinstance(i, TransformerBlockImpl) for i in impls[1:-1])
            and impls[-1].has_loss()):
        gen = TransformerGenerator(net, impls)
    elif (len(impls) >= 2 and impls[-1].has_loss()
          and any(hasattr(i, "rnn_time_step") for i in impls[:-1])):
        gen = RecurrentGenerator(net, impls)
    else:
        raise ValueError(
            "generate() needs a SequenceEmbedding + TransformerBlock stack "
            "or a recurrent (rnn_time_step) stack under an output head; "
            f"got {[type(i).__name__ for i in impls]}")
    net.__dict__["_generator"] = gen
    return gen


def _prep(net, prompt_ids, max_new_tokens: int):
    gen = build_generator(net)
    prompt = np.asarray(prompt_ids)
    if prompt.ndim != 2:
        raise ValueError(
            f"prompt_ids must be [batch, t] int tokens, got {prompt.shape}")
    max_new = int(max_new_tokens)
    if max_new < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
    b, t_in = prompt.shape
    t_pad = gen.prompt_bucket(t_in, max_new)
    ids = np.zeros((b, t_pad), np.int64)
    ids[:, :t_in] = prompt
    lengths = np.full((b,), t_in, np.int64)
    return gen, prompt, ids, lengths, max_new


def generate(net, prompt_ids, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             eos_token: Optional[int] = None, seed: int = 0) -> np.ndarray:
    """``prompt_ids`` [b, t0] int tokens -> [b, t0 + max_new_tokens]
    int64 (prompt + generated). With ``eos_token`` set, a finished row's
    remaining slots hold the EOS id. ``temperature`` 0 is greedy; else
    softmax sampling through the optional ``top_k``/``top_p`` filters,
    seeded per row by ``seed``."""
    gen, prompt, ids, lengths, max_new = _prep(net, prompt_ids,
                                               max_new_tokens)
    toks = gen.run(net.params, ids, lengths, max_new,
                   sampler_sig(temperature, top_k, top_p, eos_token),
                   row_keys(seed, prompt.shape[0]))
    return np.concatenate([prompt.astype(np.int64),
                           toks.astype(np.int64)], axis=1)


def generate_eager(net, prompt_ids, max_new_tokens: int, *,
                   temperature: float = 0.0, top_k: int = 0,
                   top_p: float = 0.0, eos_token: Optional[int] = None,
                   seed: int = 0) -> np.ndarray:
    """Per-token host-loop reference for :func:`generate`: identical math
    and noise schedule, one fetch per token."""
    gen, prompt, ids, lengths, max_new = _prep(net, prompt_ids,
                                               max_new_tokens)
    toks = gen.run_eager(net.params, ids, lengths, max_new,
                         sampler_sig(temperature, top_k, top_p, eos_token),
                         row_keys(seed, prompt.shape[0]))
    return np.concatenate([prompt.astype(np.int64),
                           toks.astype(np.int64)], axis=1)
