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

A ComputationGraph generates through its single-input linear layer
chain (``_ordered_impls``), on the same two paths.

**Paged programs** (``TransformerGenerator``; ``serving/continuous.py``
drives them over ``nn/kvpool.py``): ``prefill_program`` (the bucketed
prefill above), ``scatter_program`` (dense prefill caches into pool
blocks), ``tail_prefill_program`` (a prompt's tail through the pool),
``block_copy_program`` (copy-on-write), ``row_sample_program`` (the
admission's first token) and ``burst_program`` (K paged decode steps
with a done-mask, EOS and max-new quotas, no host sync inside). Each
is a cached callable keyed as the reference keys its compiled program;
each takes the compute-dtype params and writes the pool tensors in
place. ``export_prefill`` waits for the serving fleet (ROADMAP A11) and
the speculative programs for the serving engine (A10).

**Metrics** (``monitor``), the reference's: ``generate`` ticks
``dl4j_decode_requests_total``; ``run`` labels its prefill and decode
``compile`` at the first dispatch of their signature (else
``inference``; paths ``generate_prefill``/``generate_decode``) and
adds the prompt and generated tokens and the two phases' latencies to
the decode family. ``run`` still waits on the card once, at its token
fetch: the reference fences its prefill with a second wait to time it,
which the port does not. Its phase times come from CUDA events recorded
between the phases and read after the fetch (``perf_counter`` on the
CPU), so they are the card's times, the host's enqueue gaps included.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import time

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.datasets.iterators import bucket_for, bucket_sizes
from deeplearning4j_tpu_torch.monitor import (
    DECODE_LATENCY_HISTOGRAM,
    DECODE_PREFILL_LATENCY_HISTOGRAM,
    DECODE_PREFILL_TOKENS_COUNTER,
    DECODE_REQUESTS_COUNTER,
    DECODE_TOKENS_COUNTER,
    get_registry,
    span,
)
from deeplearning4j_tpu_torch.nn.layers.transformer import (
    SequenceEmbeddingImpl,
    TransformerBlockImpl,
)
from deeplearning4j_tpu_torch.nn.quantize import kv_quantize, qtake
from deeplearning4j_tpu_torch.ops.lstm_kernel import pack_wr
from deeplearning4j_tpu_torch.optimize.deferred import note_dispatch
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


class _PhaseClock:
    """Phase boundaries of one call: CUDA events recorded on the
    device's current stream (read with ``ms`` only after the call's
    fetch has waited for them, so reading adds no wait), or
    ``perf_counter`` readings on the CPU."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.marks: list = []

    def mark(self) -> None:
        if self.device.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record(torch.cuda.current_stream(self.device))
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> List[float]:
        """The milliseconds between consecutive marks."""
        pairs = zip(self.marks, self.marks[1:])
        if self.device.type == "cuda":
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def _observe(rows: int, prompt_tokens: int, max_new: int, pre_ms: float,
             dec_ms: float) -> None:
    """The decode family of one ``run`` (the reference's ``_observe``)."""
    reg = get_registry()
    reg.counter(DECODE_PREFILL_TOKENS_COUNTER,
                "Prompt tokens prefilled into decode caches").inc(
        prompt_tokens)
    reg.counter(DECODE_TOKENS_COUNTER,
                "Tokens produced by fused decode dispatches").inc(
        rows * max_new)
    reg.histogram(DECODE_PREFILL_LATENCY_HISTOGRAM,
                  "Prefill dispatch latency (one batched prompt "
                  "forward)").observe(pre_ms)
    reg.histogram(DECODE_LATENCY_HISTOGRAM,
                  "Fused decode dispatch latency (all of "
                  "max_new_tokens in one scan)").observe(dec_ms)


class _Generator:
    """The sampling loop both generators share. A generator supplies
    ``_start(params, ids, lengths, max_new) -> (state, logits of each
    row's last prompt token)`` (ids and lengths on the device),
    ``_next(state, tok) -> (state, next logits)`` and the reference's
    dispatch signatures of its two phases (``_signatures``)."""

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
        b, t_pad = np.shape(ids)
        pre_sig, dec_sig = self._signatures(b, t_pad, max_new)
        clock = _PhaseClock(self.net.device)
        fresh = note_dispatch(self.net, pre_sig)
        clock.mark()
        with span("compile" if fresh else "inference",
                  path="generate_prefill", bucket=t_pad, rows=b):
            len_d, state, logits0 = self._begin(params, ids, lengths, max_new)
        clock.mark()
        fresh = note_dispatch(self.net, dec_sig + tuple(sampler))
        with span("compile" if fresh else "inference",
                  path="generate_decode", rows=b, max_new=max_new):
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
            toks = torch.stack(out, dim=1)
            clock.mark()
            toks = toks.cpu().numpy()  # the call's one wait on the card
        _observe(b, int(np.sum(lengths)), max_new, *clock.ms())
        return toks

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
        return qtake(p, "W", tok) + p["P"][pos]

    @torch.no_grad()
    def prefill(self, pc, ids: torch.Tensor, lengths: torch.Tensor,
                cache_len: int):
        """ids [b, t_pad] -> (caches, logits of each row's last real
        token [b, V] f32). Length-0 rows (serving padding) read garbage
        that their done-mask discards."""
        b, t_pad = ids.shape
        p_emb = pc[self.emb.name]
        x = qtake(p_emb, "W", ids) + p_emb["P"][:t_pad][None]
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

    @staticmethod
    def _signatures(b: int, t_pad: int, max_new: int):
        cache_len = t_pad + max_new
        return (("gen_prefill", None, b, t_pad, cache_len),
                ("gen_decode", None, b, cache_len, max_new))

    def _next(self, state, tok):
        pc, caches, pos = state
        return (pc, caches, pos + 1), self.decode(pc, caches, tok, pos)

    # ------------------------------------ continuous paged decoding

    def _program(self, key, builder):
        """The cached callable of ``key`` (built once per generator)."""
        progs = self.__dict__.setdefault("_programs", {})
        if key not in progs:
            progs[key] = builder()
        return progs[key]

    def _dev(self, a, dtype=torch.long) -> torch.Tensor:
        """A host array (or tensor) as a ``dtype`` tensor on the net's
        device."""
        if not torch.is_tensor(a):
            a = np.asarray(a)
        return torch.as_tensor(a, dtype=dtype, device=self.net.device)

    def kv_layout(self) -> Tuple[int, int, int, torch.dtype]:
        """(num_layers, num_heads, head_dim, cache dtype) of this net's
        paged caches."""
        c = self.blocks[0].conf
        dtype = self.cd if self.cd is not None else torch.float32
        return (len(self.blocks), c.num_heads, c.n_out // c.num_heads,
                dtype)

    def max_context(self) -> int:
        return int(self.emb.conf.max_len)

    def prefill_program(self, cache_len: int):
        """``(pc, ids [b, t_pad], lengths [b]) -> (dense caches [b,
        cache_len, h, hd] per block, last-token logits [b, V] f32)``:
        the bucketed prefill, which ``scatter_program`` then pages into
        pool blocks."""
        def builder():
            def prefill(pc, ids, lengths):
                return self.prefill(pc, self._dev(ids), self._dev(lengths),
                                    cache_len)
            return prefill
        return self._program(("gen_prefill", cache_len), builder)

    def scatter_program(self, rows: int, t_blk: int, block_size: int):
        """``(pools, caches, tables [rows, t_blk / block_size]) -> pools``:
        each layer's dense [rows, t_blk, h, hd] K/V, cut into blocks,
        written to the rows' table ids (0, the trash block, past a
        row's allocation). A quantized pool quantizes each position per
        head, as the burst's own writes do."""
        if t_blk % block_size != 0:
            raise ValueError(
                f"t_blk {t_blk} not a multiple of block_size {block_size}")
        nb = t_blk // block_size

        def builder():
            @torch.no_grad()
            def scatter(pools, caches, tables):
                tables = self._dev(tables)
                for pool, cache in zip(pools, caches):
                    tail = cache["k"].shape[2:]
                    kr = cache["k"].reshape(rows, nb, block_size, *tail)
                    vr = cache["v"].reshape(rows, nb, block_size, *tail)
                    if "k_scale" in pool:
                        kr, ksc = kv_quantize(kr, pool["k"].dtype)
                        vr, vsc = kv_quantize(vr, pool["v"].dtype)
                        pool["k_scale"][tables] = ksc
                        pool["v_scale"][tables] = vsc
                    pool["k"][tables] = kr.to(pool["k"].dtype)
                    pool["v"][tables] = vr.to(pool["v"].dtype)
                return pools
            return scatter
        return self._program(("gen_pool_scatter", rows, t_blk, block_size),
                             builder)

    def tail_prefill_program(self, rows: int, t_tail: int, tier: int,
                             num_blocks: int, block_size: int):
        """``(pc, pools, ids [rows, t_tail], starts [rows], lens [rows],
        tables [rows, tier]) -> (pools, logits of each row's last tail
        token [rows, V])``: only the tail of a prompt whose prefix
        already lies in the table's blocks; tail token j of a row sits
        at ``start + j``, and positions past ``lens`` are padding."""
        def builder():
            @torch.no_grad()
            def tail_prefill(pc, pools, ids, starts, lens, tables):
                ids, lens = self._dev(ids), self._dev(lens)
                tables = self._dev(tables)
                steps = torch.arange(t_tail, device=ids.device)
                pos = self._dev(starts)[:, None] + steps[None, :]
                p_emb = pc[self.emb.name]
                # a padding position may lie past max_len: its row of P
                # is any row, since its writes are masked
                x = qtake(p_emb, "W", ids) \
                    + p_emb["P"][pos.clamp(max=self.max_context() - 1)]
                write_ok = steps[None, :] < lens[:, None]
                for blk, pool in zip(self.blocks, pools):
                    x, _ = blk.prefill_paged(pc[blk.name], x, pool, tables,
                                             pos, write_ok)
                last = x[torch.arange(rows, device=ids.device),
                         (lens - 1).clamp(min=0)]
                return pools, self._head_logits(pc, last)
            return tail_prefill
        return self._program(("gen_tail_prefill", rows, t_tail, tier,
                              num_blocks, block_size), builder)

    def block_copy_program(self, n: int, num_blocks: int, block_size: int):
        """``(pools, src [n], dst [n]) -> pools``: copy-on-write, every
        pool tensor's blocks ``src`` copied to ``dst`` (scales too)."""
        def builder():
            @torch.no_grad()
            def copy(pools, src, dst):
                src, dst = self._dev(src), self._dev(dst)
                for pool in pools:
                    for arr in pool.values():
                        arr[dst] = arr[src]
                return pools
            return copy
        return self._program(("gen_block_copy", n, num_blocks, block_size),
                             builder)

    def row_sample_program(self):
        """``(logits [b, V], keys, folds [b], temp [b], top_k [b], top_p
        [b]) -> tokens [b]``: the rowwise sampler off prefill logits,
        each row on its own key and fold (a resumed sequence continues
        its token clock)."""
        def builder():
            @torch.no_grad()
            def rsample(logits, keys, folds, temp_v, top_k_v, top_p_v):
                return sample_tokens_rowwise(
                    logits, keys, folds, self._dev(temp_v, torch.float32),
                    self._dev(top_k_v), self._dev(top_p_v, torch.float32))
            return rsample
        return self._program(("gen_row_sample",), builder)

    def burst_program(self, slots: int, k_burst: int, max_blocks: int,
                      num_blocks: int, block_size: int,
                      sampling: bool = True):
        """One scheduler burst: ``(pc, pools, tables [slots, max_blocks],
        pos, tok, n_gen, done, keys, temp, top_k, top_p, eos, max_new)
        -> (pools, ys [slots, K], tok, pos, n_gen, done)``, K paged
        decode steps over ``slots`` rows. A done row's writes go to the
        trash block, its outputs are 0, its state freezes; a row finishes
        on its EOS (``eos >= 0``) or when ``n_gen`` reaches ``max_new``.
        The results stay on the device: nothing inside the K steps waits
        on the host. A sampling row's fold at step s is its ``n_gen`` at
        the burst's start plus s (``n_gen`` comes in as host ints); the
        folds of a finished row draw nothing that is kept.
        ``sampling=False`` is the greedy variant (an argmax, no
        sampler)."""
        def builder():
            @torch.no_grad()
            def burst(pc, pools, tables, pos, tok, n_gen, done, keys,
                      temp_v, top_k_v, top_p_v, eos_v, max_new_v):
                folds0 = np.asarray(n_gen).tolist() if sampling else None
                tables, pos, tok = (self._dev(tables), self._dev(pos),
                                    self._dev(tok))
                n_gen, done = self._dev(n_gen), self._dev(done, torch.bool)
                eos_v, max_new_v = self._dev(eos_v), self._dev(max_new_v)
                if sampling:
                    temp_v = self._dev(temp_v, torch.float32)
                    top_k_v = self._dev(top_k_v)
                    top_p_v = self._dev(top_p_v, torch.float32)
                caches = [dict(pool, table=tables) for pool in pools]
                ys = []
                for s in range(k_burst):
                    active = ~done
                    x = self._embed_token(pc, tok, pos)
                    for blk, cache in zip(self.blocks, caches):
                        x, _ = blk.decode_step(pc[blk.name], x, cache, pos,
                                               write_mask=active)
                    logits = self._head_logits(pc, x)
                    if sampling:
                        nxt = sample_tokens_rowwise(
                            logits, keys, [f + s for f in folds0], temp_v,
                            top_k_v, top_p_v)
                    else:
                        nxt = logits.argmax(dim=-1)
                    step = active.long()
                    n_gen = n_gen + step
                    done = done | (active & (eos_v >= 0) & (nxt == eos_v)) \
                        | (n_gen >= max_new_v)
                    ys.append(torch.where(active, nxt, 0))
                    tok = torch.where(active, nxt, tok)
                    pos = pos + step
                return pools, torch.stack(ys, dim=1), tok, pos, n_gen, done
            return burst
        return self._program(("gen_burst", slots, k_burst, max_blocks,
                              num_blocks, block_size, bool(sampling)),
                             builder)


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

    def serving_params(self, params, b: int):
        """The parameters a call runs on: each recurrent layer's Wr also
        packed for the f32 forward kernel at batch b (``Wr_packed``,
        ``pack_wr``), once per call, where the kernel would read it; the
        other entries are the same tensors."""
        out = dict(params)
        for impl in self.impls[:-1]:
            p = params[impl.name]
            if hasattr(impl, "rnn_time_step") and "Wr" in p:
                packed = pack_wr(p["Wr"], b)
                if packed is not None:
                    out[impl.name] = dict(p, Wr_packed=packed)
        return out

    def _start(self, params, ids, lengths, max_new):
        params = self.serving_params(params, ids.shape[0])
        rstate, logits0 = self.prefill(params, ids, lengths)
        return (params, rstate), logits0

    @staticmethod
    def _signatures(b: int, t_pad: int, max_new: int):
        return (("gen_rnn_prefill", None, b, t_pad),
                ("gen_rnn_decode", None, b, max_new))

    def _next(self, state, tok):
        params, rstate = state
        rstate, logits = self.step(params, rstate, tok)
        return (params, rstate), logits


def _ordered_impls(net) -> List[Any]:
    """The net's layer impls in forward order: a MultiLayerNetwork's
    stack as it is; a ComputationGraph's single-input linear layer chain
    in topological order (anything else, such as several inputs or
    outputs or an op vertex, has no decode order and raises)."""
    impls = net.impls
    if isinstance(impls, list):
        return impls
    if len(net.input_names) != 1 or len(net.output_names) != 1:
        raise ValueError(
            "generate() serves single-input/single-output graphs; this "
            f"one has inputs {net.input_names} and outputs "
            f"{net.output_names}")
    chain: List[Any] = []
    for name in net.order:
        v = net.defs[name]
        if v.kind == "input":
            continue
        if v.kind != "layer" or len(v.inputs) != 1:
            raise ValueError(
                "generate() supports linear layer chains; vertex "
                f"'{name}' ({v.kind}, inputs {v.inputs}) breaks the chain")
        chain.append(impls[name])
    return chain


def build_generator(net):
    """Build (or return the cached) generator over ``_ordered_impls``:
    SequenceEmbedding -> TransformerBlock* -> head stacks get KV-cache
    prefill/decode; stacks with ``rnn_time_step`` layers under a head get
    the recurrent path. Anything else raises."""
    gen = net.__dict__.get("_generator")
    if gen is not None and gen.net is net:
        return gen
    impls = _ordered_impls(net)
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
    get_registry().counter(DECODE_REQUESTS_COUNTER,
                           "generate() requests").inc()
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
