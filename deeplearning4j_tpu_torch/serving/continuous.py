"""Continuous batching: iteration-level decode scheduling over a paged
KV-cache block pool.

Counterpart of ``deeplearning4j_tpu/serving/continuous.py``, its
single-net scheduler (Orca's iteration-level scheduling over vLLM's
paged pool):

- decode runs in **short fixed-K bursts** (``TransformerGenerator.
  burst_program``) over the active rows, compacted into the smallest
  power-of-two slot bucket and the smallest power-of-two block tier
  that cover them; between bursts the scheduler **retires** EOS and
  max-new rows (their blocks freed at once) and **admits** queued
  prompts into the free slots, so a new request waits at most K tokens;
- admissions with the same prompt bucket coalesce into one prefill (the
  flash-attention kernel), one scatter of the dense caches into pool
  blocks and one rowwise sample of each row's first token, on its own
  PRNG clock;
- KV state lives in a :class:`~deeplearning4j_tpu_torch.nn.kvpool.
  PagedKVCachePool`: a sequence grows by whole blocks ahead of each
  burst. When the pool is exhausted the scheduler **preempts**
  deterministically: the lowest priority, then the youngest admission,
  loses its blocks and is re-queued at the front with prompt plus
  generated prefix, resuming on its own token clock, so its tokens are
  an uninterrupted run's. A sequence that cannot fit even alone fails
  with :class:`KVPoolExhausted`; a full queue sheds with
  ``InferenceBackpressure``;
- ``prefix_cache=True`` indexes every retiring or preempted sequence's
  written blocks in a :class:`~deeplearning4j_tpu_torch.serving.
  prefixcache.PrefixCache` per pool; an admission whose prompt matches
  a cached prefix shares those blocks, copies a matched partial block
  on write (``block_copy_program``) and prefills only its tail over the
  pool (``tail_prefill_program``, plain torch, as the reference leaves
  it to XLA); ``prefix_cache_blocks`` caps the cache. The cache keeps
  its blocks past a drain: ``prefix_caches()`` and ``clear()`` release
  them;
- ``on_tokens(offset, tokens)`` streams a single-row request's new
  tokens after its admission and after every burst that extends it,
  from the burst's one fetch: append-only across preemptions;
- one fetch per admission group (its first tokens) and one per burst
  (its tokens and row state) are the host's only waits on the card.

``start=False`` skips the scheduler thread: :meth:`step` then drives a
fully deterministic schedule. Transformer (KV-cache) stacks only; the
scheduler runs on its net's device. ``on_resolve(n)`` tells the engine
of every resolved request.

Left for later slices, each raising ``NotImplementedError`` that names
its ROADMAP item: ``registry=`` lanes, ``speculative=True`` /
``draft_net=``, ``host_kv_blocks=`` and ``submit``'s ``model=`` /
``version=`` and ``session=`` / ``hibernate=`` (A10b); ``kv_state=``
(A11).

Telemetry (``monitor``), the reference's for the single-net scheduler:

- counters ``dl4j_sched_admitted_rows_total``, ``_retired_rows_total``,
  ``_preemptions_total``, ``_bursts_total`` and the burst-latency
  histogram, the ``dl4j_sched_active_sequences`` /
  ``dl4j_sched_queued_prefills`` gauges and their time series
  (``dl4j_ts_sched_*``, with the pool's occupancy and the prefix
  cache's hit rate) after every step, the per-owner ``dl4j_attr_*``
  counters, ``dl4j_stream_chunks_total`` per streamed chunk; the pool
  and the prefix cache publish their own (``nn/kvpool.py``,
  ``serving/prefixcache.py``);
- spans: ``compile`` at the first dispatch of a program signature
  (``optimize/deferred.py`` ``note_dispatch``), else ``inference``,
  around each admission group's prefill (dense or tail) and each burst
  (the burst's span holds its token fetch, the host's wait that was
  there before); ``stage`` around ``warmup``;
- request traces (``monitor/reqtrace.py``): with a request tracer
  enabled, each request without an ambient trace context roots a
  ``decode_request`` trace; its rows record ``queue_wait`` and
  ``prefill`` spans from the admission's timestamps, a ``decode_burst``
  span for every burst they ride, a ``chunk_deliver`` span for every
  streamed chunk and a ``preempt`` event, and the trace is sealed when
  the request resolves or fails. Every span is built from host
  timestamps the loop takes anyway: no wait on the card.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.iterators import bucket_for, bucket_sizes
from deeplearning4j_tpu_torch.monitor import (
    ATTR_DECODE_TOKENS_COUNTER,
    ATTR_PREFILL_TOKENS_COUNTER,
    ATTR_QUEUE_MS_COUNTER,
    SCHED_ACTIVE_GAUGE,
    SCHED_ADMITTED_COUNTER,
    SCHED_BURST_LATENCY_HISTOGRAM,
    SCHED_BURSTS_COUNTER,
    SCHED_PREEMPTIONS_COUNTER,
    SCHED_QUEUED_GAUGE,
    SCHED_RETIRED_COUNTER,
    STREAM_CHUNKS_COUNTER,
    TS_SCHED_ACTIVE,
    TS_SCHED_POOL_OCCUPANCY,
    TS_SCHED_PREFIX_HIT_RATE,
    TS_SCHED_QUEUED,
    get_registry,
    mark,
    record_fault,
    reqtrace,
    span,
    timeseries_enabled,
    to_origin_us,
    ts_record,
)
from deeplearning4j_tpu_torch.nn.generate import (
    TransformerGenerator,
    build_generator,
    row_keys,
)
from deeplearning4j_tpu_torch.nn.kvpool import PagedKVCachePool, pool_spec
from deeplearning4j_tpu_torch.nn.quantize import quant_modes
from deeplearning4j_tpu_torch.optimize.deferred import note_dispatch
from deeplearning4j_tpu_torch.parallel.inference import (
    EngineShutdown,
    InferenceBackpressure,
)
from deeplearning4j_tpu_torch.serving.prefixcache import PrefixCache


class DecodeBurstError(RuntimeError):
    """A burst or prefill died under a sequence: its future carries this
    (the error as ``__cause__``), its blocks are freed, and the
    scheduler keeps serving everyone else."""


class KVPoolExhausted(RuntimeError):
    """A sequence needs more KV blocks than the pool can ever provide,
    even with every other sequence preempted: a sizing error."""


def _later(feature: str, item: str = "A10b") -> NotImplementedError:
    return NotImplementedError(
        f"ContinuousDecodeScheduler: {feature} is not ported yet "
        f"(ROADMAP {item})")


def _owner_key(lane_key: Tuple) -> str:
    """Attribution owner tag of a lane (``default`` for the net's)."""
    model, version = lane_key
    base = model if model is not None else "default"
    return base if version is None else f"{base}@v{version}"


def _pow2_ladder(top: int) -> Tuple[int, ...]:
    """1, 2, 4, ... below ``top``, then ``top``."""
    out, t = [], 1
    while t < top:
        out.append(t)
        t *= 2
    out.append(top)
    return tuple(out)


class _DecodeRequest:
    """One ``submit()``: n prompt rows sharing a sampler and seed; the
    future resolves to [n, t0 + max_new] ids once every row retires.
    ``on_tokens`` (one row) receives ``(offset, tokens)`` deltas;
    ``prefix`` makes it a resume: the row re-prefills prompt + prefix,
    its token clock starts at ``len(prefix)``, and its stream offsets
    continue after the prefix."""

    __slots__ = ("prompt", "n", "t_in", "max_new", "temperature", "top_k",
                 "top_p", "eos", "seed", "priority", "future", "rows_done",
                 "t_submit", "t_first", "rows", "prefix", "trace", "root",
                 "on_tokens")

    def __init__(self, prompt: np.ndarray, max_new: int, temperature: float,
                 top_k: int, top_p: float, eos: Optional[int], seed: int,
                 priority: int, prefix: Optional[np.ndarray] = None,
                 on_tokens=None):
        self.prompt = np.asarray(prompt, np.int64)
        self.n, self.t_in = self.prompt.shape
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos = None if eos is None else int(eos)
        self.seed = int(seed)
        self.priority = int(priority)
        self.prefix = prefix  # [p] int64 generated so far (row 0)
        self.on_tokens = on_tokens
        self.future: "Future[np.ndarray]" = Future()
        self.rows_done = 0
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.rows: List["_Seq"] = []
        # the ambient request-trace context at submit; without one (and
        # with a tracer on) the scheduler roots the request's own trace
        self.trace = reqtrace.current_trace()
        self.root = None


class _Seq:
    """One decode row, the schedulable unit. ``fed`` is what the next
    (re)prefill feeds: the prompt plus everything generated before the
    last preemption; ``generated`` the output so far; ``n_gen`` the
    row's token clock (the fold of its next draw); ``emitted`` the
    tokens already streamed through ``on_tokens`` (only advances, so a
    resumed row never re-delivers)."""

    __slots__ = ("req", "row", "fed", "generated", "key", "n_gen", "slot",
                 "blocks", "pos", "seq_id", "preemptions", "t_queued",
                 "emitted")

    def __init__(self, req: _DecodeRequest, row: int, key: int,
                 seq_id: int):
        self.req = req
        self.row = row
        self.t_queued = time.perf_counter()
        self.fed = req.prompt[row].astype(np.int64)
        self.generated: List[int] = []
        self.key = key
        self.n_gen = 0
        self.slot: Optional[int] = None
        self.blocks: List[int] = []
        self.pos = 0
        self.seq_id = seq_id
        self.preemptions = 0
        self.emitted = 0
        if req.prefix is not None and len(req.prefix):
            pre = np.asarray(req.prefix, np.int64)
            self.fed = np.concatenate([self.fed, pre])
            self.generated = [int(t) for t in pre]
            self.n_gen = len(self.generated)
            # the prefix was delivered by the engine the stream left
            self.emitted = self.n_gen

    @property
    def priority(self) -> int:
        return self.req.priority

    @property
    def remaining(self) -> int:
        return self.req.max_new - self.n_gen


class _AdmitPlan:
    """One admission's claimed blocks in table order (shared prefix
    blocks first, then the copy of a matched partial block, then fresh
    ones), the ``start`` cached tokens its tail prefill skips, the
    shared partial block ``cow_src`` still referenced until its copy
    lands, and the group signature that decides which admissions share
    a prefill: ``("dense", t_pad)`` or ``("tail", t_tail_pad, tier)``."""

    __slots__ = ("seq", "blocks", "start", "cow_src", "sig")

    def __init__(self, seq: _Seq, blocks: List[int], start: int,
                 cow_src: Optional[int], sig: Tuple):
        self.seq = seq
        self.blocks = blocks
        self.start = start
        self.cow_src = cow_src
        self.sig = sig


class _Lane:
    """A net's slot batch: host mirrors of the slots' state vectors and
    the pool. Empty slots are done rows with all-trash tables."""

    def __init__(self, key: Tuple, net, gen: TransformerGenerator,
                 pool: PagedKVCachePool, slots: int):
        self.key = key
        self.net = net
        self.gen = gen
        self.pool = pool
        self.slots = slots
        self.mb = pool.blocks_for(gen.max_context())
        self.seqs: List[Optional[_Seq]] = [None] * slots
        self.tables = np.zeros((slots, self.mb), np.int64)
        self.pos = np.zeros(slots, np.int64)
        self.tok = np.zeros(slots, np.int64)
        self.n_gen = np.zeros(slots, np.int64)
        self.done = np.ones(slots, bool)
        self.keys = np.zeros(slots, np.int64)
        self.temp = np.zeros(slots, np.float32)
        self.top_k = np.zeros(slots, np.int64)
        self.top_p = np.zeros(slots, np.float32)
        self.eos = np.full(slots, -1, np.int64)
        self.max_new_v = np.zeros(slots, np.int64)

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.seqs):
            if s is None:
                return i
        return None

    def active(self) -> List[_Seq]:
        return [s for s in self.seqs if s is not None]

    def clear_slot(self, slot: int) -> None:
        self.seqs[slot] = None
        self.tables[slot] = 0
        self.pos[slot] = 0
        self.tok[slot] = 0
        self.n_gen[slot] = 0
        self.done[slot] = True
        self.keys[slot] = 0
        self.temp[slot] = 0.0
        self.top_k[slot] = 0
        self.top_p[slot] = 0.0
        self.eos[slot] = -1
        self.max_new_v[slot] = 0


class ContinuousDecodeScheduler:
    """Iteration-level decode scheduler over a paged KV block pool, for
    one transformer net on ``net.device``.

    Knobs: ``slots`` batch rows, ``burst_tokens`` = K (a new request
    waits at most K steps), ``block_size`` tokens per KV block,
    ``num_blocks`` pool budget (default: every slot at full context, so
    nothing is preempted unless oversubscribed) or ``kv_bytes_budget``
    (blocks from a byte budget), ``kv_quant`` ("int8" / "fp8" pool
    values), ``queue_capacity`` bounded admission, ``admit_rows`` the
    widest admission group.

    ``prefix_cache=True`` turns on the cross-request prefix cache
    (``prefix_cache_blocks`` caps it); its blocks outlive a drain, so a
    drained pool holds ``free + cached == total`` until
    ``prefix_caches()``' ``clear()``.

    ``start=False`` skips the scheduler thread; tests drive :meth:`step`
    for deterministic schedules. ``burst_hook(lane_key, burst_index)``
    runs before each burst; an error it raises fails the burst's
    sequences with :class:`DecodeBurstError`, frees their blocks, and
    the scheduler serves on."""

    def __init__(self, net=None, registry=None, slots: int = 8,
                 burst_tokens: int = 8, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 queue_capacity: int = 256, admit_rows: int = 4,
                 start: bool = True, burst_hook=None, on_resolve=None,
                 prefix_cache: bool = False,
                 prefix_cache_blocks: Optional[int] = None,
                 kv_quant: Optional[str] = None,
                 kv_bytes_budget: Optional[int] = None,
                 speculative: bool = False, draft_net=None,
                 host_kv_blocks: Optional[int] = None):
        if registry is not None:
            raise _later("registry= (model/version lanes)")
        if speculative or draft_net is not None:
            raise _later("speculative=/draft_net= (speculative decoding)")
        if host_kv_blocks:
            raise _later("host_kv_blocks= (host-tier preemption and "
                         "hibernation)")
        if net is None:
            raise ValueError("ContinuousDecodeScheduler needs a net")
        self.device = net.device
        if kv_quant is not None and kv_quant not in quant_modes():
            raise ValueError(f"unknown kv_quant {kv_quant!r}; pick from "
                             f"{quant_modes()}")
        if kv_bytes_budget is not None and num_blocks is not None:
            raise ValueError("kv_bytes_budget= and num_blocks= are "
                             "exclusive — the budget derives num_blocks")
        self.net = net
        self.slots = max(1, int(slots))
        self.burst_tokens = max(1, int(burst_tokens))
        self.block_size = max(1, int(block_size))
        self._num_blocks = num_blocks
        self.kv_quant = kv_quant
        self._kv_bytes_budget = kv_bytes_budget
        self.queue_capacity = max(1, int(queue_capacity))
        # same-bucket admissions coalesce into one prefill up this ladder
        self.admit_rows = max(1, min(int(admit_rows), self.slots))
        self._admit_ladder = _pow2_ladder(self.admit_rows)
        # a burst runs the smallest slot bucket covering its active rows
        self._slot_ladder = _pow2_ladder(self.slots)
        self._burst_hook = burst_hook
        self._on_resolve = on_resolve
        # burst-coalesced emit: while a retire pass is open, deltas for
        # callbacks marked with a ``burst_sink`` gather here and flush
        # as one call per sink
        self._emit_batch: Optional[List[Tuple[Any, int, np.ndarray]]] = None
        # one PrefixCache per pool spec, radix roots per lane inside
        self.prefix_cache = bool(prefix_cache)
        self._prefix_cache_blocks = prefix_cache_blocks
        self._caches: Dict[Tuple, PrefixCache] = {}
        self._prefill_computed_tokens = 0
        self._resume_reprefill_tokens = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: Deque[_Seq] = deque()
        self._lanes: Dict[Tuple, _Lane] = {}
        self._pools: Dict[Tuple, PagedKVCachePool] = {}
        self._params_cache: Dict[Tuple, Any] = {}
        self._seq_counter = 0
        # per-owner prefill/decode tokens and queue milliseconds
        self._attr: Dict[str, Dict[str, float]] = {}
        self._accepted = 0
        self._resolved = 0
        self._admitted_rows = 0
        self._retired_rows = 0
        self._preemptions = 0
        self._bursts = 0
        # the last accounted burst's (t0, ms, slot bucket, tier, rows),
        # for its riders' trace spans
        self._last_burst: Optional[Tuple] = None
        # per-owner dl4j_attr_* counters, made once per owner
        self._attr_metrics: Dict[str, Tuple] = {}
        self._warmed = False
        self._stopping = False
        self._cancel = False
        self._closed = False
        #: bounded audit trail: every admit/retire/preempt/burst-fail
        #: event, in schedule order
        self.events: Deque[str] = deque(maxlen=4096)
        #: per-request completion log: t_submit/t_first/t_done/rows/
        #: tokens of every resolved request
        self.completed: Deque[Dict[str, float]] = deque(maxlen=65536)
        self._thread: Optional[threading.Thread] = None
        self._lane_for(None, None)  # built eagerly so submit validates fast
        if start:
            self.start()

    # ---------------------------------------------------------- public

    def start(self) -> "ContinuousDecodeScheduler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="dl4j-decode-sched")
            self._thread.start()
        return self

    def submit(self, prompt_ids: np.ndarray, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
               eos_token: Optional[int] = None, seed: int = 0,
               priority: int = 0, model: Optional[str] = None,
               version: Optional[int] = None,
               session: Optional[str] = None, on_tokens=None,
               prefix: Optional[np.ndarray] = None, kv_state=None,
               hibernate: bool = False) -> "Future[np.ndarray]":
        """Enqueue one decode request; the future resolves to the [n, t0
        + max_new_tokens] ids a solo ``generate`` of the same rows
        returns (greedy: token for token; sampled: the same seeded draws
        whatever the admission timing, co-tenants or preemptions).
        Higher ``priority`` sequences are preempted last.
        ``on_tokens(offset, tokens)`` (one row) receives the row's new
        tokens as admission and bursts produce them, tagged with their
        offset: append-only, no gap, no repeat, across preemptions.
        ``prefix`` (one row) resumes a stream: the row re-prefills
        prompt + prefix, its token clock starts at ``len(prefix)``,
        ``max_new_tokens`` still counts the prefix, and the prefix is
        not streamed again."""
        if model is not None or version is not None:
            raise _later("model=/version= (registry lanes)")
        if session is not None or hibernate:
            raise _later("session=/hibernate= (session hibernation)")
        if kv_state is not None:
            raise _later("kv_state= (the disaggregated prefill handoff)",
                         "A11")
        if self._closed:
            raise EngineShutdown("ContinuousDecodeScheduler is shut down")
        prompt = np.asarray(prompt_ids)
        if prompt.ndim != 2:
            raise ValueError(
                f"prompt_ids must be [n, t0] int tokens, got {prompt.shape}")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        pre = None
        if prefix is not None:
            pre = np.asarray(prefix, np.int64).reshape(-1)
        if (on_tokens is not None or pre is not None) \
                and prompt.shape[0] != 1:
            raise ValueError(
                "token streaming / prefix resume are per-stream: prompt "
                f"must be [1, t0], got {prompt.shape}")
        if pre is not None and len(pre) >= max_new:
            # every token was generated before: only the result was lost
            out = np.concatenate(
                [np.asarray(prompt, np.int64), pre[None, :max_new]], axis=1)
            req = _DecodeRequest(prompt, max_new, temperature, top_k, top_p,
                                 eos_token, seed, priority, pre, on_tokens)
            self._trace_begin(req)
            with self._cv:
                self._accepted += 1
            reqtrace.finish_trace(req.root, outcome="short_circuit",
                                  tokens=max_new)
            req.future.set_result(out)
            self._count_resolved()
            return req.future
        lane = self._lane_for(None, None)
        # validates prompt(+prefix) length and max_new against the context
        n_pre = 0 if pre is None else len(pre)
        lane.gen.prompt_bucket(prompt.shape[1] + n_pre,
                               max(1, max_new - n_pre))
        req = _DecodeRequest(prompt, max_new, temperature, top_k, top_p,
                             eos_token, seed, priority, pre, on_tokens)
        self._trace_begin(req)
        keys = row_keys(req.seed, req.n)
        with self._cv:
            if len(self._queue) + req.n > self.queue_capacity:
                raise InferenceBackpressure(
                    f"decode admission queue full "
                    f"({self.queue_capacity} rows)")
            for row in range(req.n):
                self._seq_counter += 1
                seq = _Seq(req, row, keys[row], self._seq_counter)
                req.rows.append(seq)
                self._queue.append(seq)
            self._accepted += 1
            self._cv.notify_all()
        self._gauges()
        return req.future

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            active = sum(len(lane.active()) for lane in self._lanes.values())
            out = {
                "slots": self.slots,
                "burst_tokens": self.burst_tokens,
                "block_size": self.block_size,
                "kv_quant": self.kv_quant,
                "lanes": len(self._lanes),
                "active_sequences": active,
                "queued_prefills": len(self._queue),
                "accepted": self._accepted,
                "resolved": self._resolved,
                "admitted_rows": self._admitted_rows,
                "retired_rows": self._retired_rows,
                "preemptions": self._preemptions,
                "bursts": self._bursts,
                "warmed": self._warmed,
                "prefill_tokens_computed": self._prefill_computed_tokens,
                "resume_reprefill_tokens": self._resume_reprefill_tokens,
            }
            pools = [p.stats() for _, p in sorted(self._pools.items())]
            caches = self._sorted_caches()
        agg = {"blocks_total": sum(p["blocks_total"] for p in pools),
               "blocks_free": sum(p["blocks_free"] for p in pools),
               "shared_blocks": sum(p["shared_blocks"] for p in pools),
               "alloc_failures": sum(p["alloc_failures"] for p in pools)}
        agg["occupancy"] = (
            (agg["blocks_total"] - agg["blocks_free"]) / agg["blocks_total"]
            if agg["blocks_total"] else 0.0)
        out["pool"] = agg
        out["pools"] = pools
        out["attribution"] = self.attribution()
        if self.prefix_cache:
            cs = [c.stats() for c in caches]
            hits = sum(c["hits"] for c in cs)
            misses = sum(c["misses"] for c in cs)
            out["prefix_cache"] = {
                "cached_blocks": sum(c["cached_blocks"] for c in cs),
                "cached_bytes": sum(c["cached_bytes"] for c in cs),
                "shared_blocks": sum(c["shared_blocks"] for c in cs),
                "hits": hits, "misses": misses,
                "hit_rate": hits / (hits + misses) if hits + misses
                else 0.0,
                "evictions": sum(c["evictions"] for c in cs),
                "cow_copies": sum(c["cow_copies"] for c in cs),
                "saved_prefill_tokens": sum(c["saved_prefill_tokens"]
                                            for c in cs),
            }
        return out

    def attribution(self) -> Dict[str, Any]:
        """Per-owner prefill/decode tokens and queue milliseconds, plus
        each pool's byte-second attribution."""
        with self._lock:
            models = {k: dict(v) for k, v in self._attr.items()}
            pools = [p for _, p in sorted(self._pools.items())]
        return {"models": models,
                "kv_pools": [p.attribution() for p in pools]}

    def drain(self, timeout: Optional[float] = None,
              poll_s: float = 2e-3) -> bool:
        """Block until every accepted request has resolved (a drained
        scheduler's pool is fully free). False when ``timeout`` passes
        first. Without the thread, drives :meth:`step` itself."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                idle = self._resolved >= self._accepted
            if idle:
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            if self._thread is None:
                self.step()
            else:
                time.sleep(poll_s)

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop accepting work; drain (default) or fail what is queued
        and in flight, then join the scheduler thread."""
        if self._closed:
            return
        self._closed = True
        if drain and self._thread is not None:
            self.drain(timeout)
        with self._cv:
            self._stopping = True
            self._cancel = not drain
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        elif drain:
            self.drain(timeout)
        else:
            self._fail_everything(
                EngineShutdown("scheduler shut down before dispatch"))

    def warmup(self, prompt_lengths, max_new_tokens: int = 1,
               model: Optional[str] = None,
               version: Optional[int] = None, tail_lengths=None) -> int:
        """Run the program set once, all masked (every write lands in
        the trash block; accounting untouched): the rowwise sampler at
        every admission row count, each covering prompt bucket's prefill
        and scatter, and the burst over every (block tier x slot bucket)
        in its greedy and sampling forms, for the tiers that requests of
        ``prompt_lengths`` and up to ``max_new_tokens`` new tokens reach
        (from the shortest prompt's blocks to the longest's at its last
        token); with the prefix cache on, the
        block copy and the tail prefill over every (tail bucket x block
        tier x admission rows) that a prompt of ``prompt_lengths`` can
        give (``tail_lengths`` narrows the tails, and then the tiers to
        the prompts' own). Returns how many programs were built."""
        if model is not None or version is not None:
            raise _later("model=/version= (registry lanes)")
        lane = self._lane_for(None, None)
        pool, gen = lane.pool, lane.gen
        before = len(gen.__dict__.get("_programs", {}))
        params = self._params(lane)
        with span("stage", path="warmup_continuous", slots=self.slots,
                  burst=self.burst_tokens):
            rs = gen.row_sample_program()
            vocab = int(gen.emb.conf.n_in)
            for rows in self._admit_ladder:
                note_dispatch(lane.net, ("gen_row_sample", "sched", rows))
                rs(torch.zeros(rows, vocab, device=self.net.device),
                   [0] * rows, [0] * rows, np.zeros(rows, np.float32),
                   np.zeros(rows, np.int64), np.zeros(rows, np.float32))
            done_buckets = set()
            for t_in in prompt_lengths:
                t_pad = gen.prompt_bucket(int(t_in), int(max_new_tokens))
                t_blk = self._round_blocks(t_pad)
                if (t_pad, t_blk) in done_buckets:
                    continue
                done_buckets.add((t_pad, t_blk))
                for rows in self._admit_ladder:
                    fresh = note_dispatch(
                        lane.net, ("gen_prefill", "sched", rows, t_pad, t_blk))
                    with span("compile" if fresh else "inference",
                              path="warmup_continuous_prefill",
                              bucket=t_pad, rows=rows):
                        caches, _ = gen.prefill_program(t_blk)(
                            params, np.zeros((rows, t_pad), np.int64),
                            np.full(rows, min(int(t_in), t_pad), np.int64))
                    scat = gen.scatter_program(rows, t_blk, self.block_size)
                    note_dispatch(lane.net,
                                  ("gen_pool_scatter", "sched", rows, t_blk))
                    pool.set_layers(scat(
                        pool.layers, caches,
                        np.zeros((rows, t_blk // self.block_size), np.int64)))
            lo = self._tier_cover(lane, pool.blocks_for(
                min(int(t) for t in prompt_lengths)))
            hi = self._tier_cover(lane, pool.blocks_for(
                max(int(t) for t in prompt_lengths) + int(max_new_tokens)))
            for tier in self._burst_tiers(lane):
                if not lo <= tier <= hi:
                    continue
                for rows in self._slot_ladder:
                    for sampling in (False, True):
                        self._dispatch_burst(lane, params, tier=tier,
                                             sampling=sampling, rows=rows)
            if self.prefix_cache:
                self._warm_tail_programs(lane, params, prompt_lengths,
                                         tail_lengths)
        self._warmed = True
        return len(gen.__dict__.get("_programs", {})) - before

    def _warm_tail_programs(self, lane: _Lane, params, prompt_lengths,
                            tail_lengths) -> None:
        """The cached admissions' programs, on all-trash tables: the
        copy-on-write block copy and the tail-prefill ladder."""
        pool, gen = lane.pool, lane.gen
        cp = gen.block_copy_program(1, pool.num_blocks, self.block_size)
        note_dispatch(lane.net, ("gen_block_copy", "sched", 1))
        pool.set_layers(cp(pool.layers, np.zeros(1, np.int64),
                           np.zeros(1, np.int64)))
        sizes = bucket_sizes(gen.max_context())
        if tail_lengths is None:
            max_tail = max(int(t) for t in prompt_lengths)
            tail_buckets = sorted({bucket_for(t, sizes)
                                   for t in range(1, max_tail + 1)})
            tiers = list(self._burst_tiers(lane))
        else:
            tail_buckets = sorted({bucket_for(int(t), sizes)
                                   for t in tail_lengths})
            tiers = sorted({self._tier_cover(lane, pool.blocks_for(int(t)))
                            for t in prompt_lengths})
        for t_tail in tail_buckets:
            for tier in tiers:
                for rows in self._admit_ladder:
                    tp = gen.tail_prefill_program(
                        rows, t_tail, tier, pool.num_blocks, self.block_size)
                    fresh = note_dispatch(lane.net, ("gen_tail_prefill",
                                                     "sched", rows, t_tail,
                                                     tier))
                    with span("compile" if fresh else "inference",
                              path="warmup_continuous_tail_prefill",
                              bucket=t_tail, rows=rows, tier=tier):
                        pools, _ = tp(params, pool.layers,
                                      np.zeros((rows, t_tail), np.int64),
                                      np.zeros(rows, np.int64),
                                      np.full(rows, t_tail, np.int64),
                                      np.zeros((rows, tier), np.int64))
                    pool.set_layers(pools)

    def step(self) -> bool:
        """One scheduling iteration: admit queued prompts into free
        slots, top up every active sequence's blocks (preempting when
        the pool is exhausted), dispatch one burst, retire finished
        rows. Returns whether any work happened."""
        progressed = self._admit()
        for key in sorted(self._lanes, key=repr):
            lane = self._lanes[key]
            if not lane.active():
                continue
            self._ensure_blocks(lane)
            if not lane.active():
                continue
            try:
                outs = self._dispatch_burst(lane, self._params(lane),
                                            accounted=True)
            except Exception as e:
                self._burst_failed(lane, e)
                progressed = True
                continue
            self._trace_burst(lane)
            self._retire(lane, outs)
            progressed = True
        self._gauges()
        return progressed

    # ------------------------------------------------------ lanes/pools

    def _lane_for(self, model: Optional[str],
                  version: Optional[int]) -> _Lane:
        key = (model, version)
        with self._lock:
            lane = self._lanes.get(key)
        if lane is not None:
            return lane
        net = self.net
        gen = build_generator(net)
        if not isinstance(gen, TransformerGenerator):
            raise ValueError(
                "continuous batching schedules paged KV caches; "
                f"{type(gen).__name__} nets have none — serve them through "
                "generate()")
        n_layers, heads, hd, dtype = gen.kv_layout()
        spec = pool_spec(n_layers, heads, hd, self.block_size, dtype,
                         self.kv_quant)
        with self._lock:
            pool = self._pools.get(spec)
            if pool is None:
                blocks = self._num_blocks
                if blocks is None and self._kv_bytes_budget is not None:
                    # a quantized pool's smaller blocks buy more of them
                    bb = PagedKVCachePool.bytes_per_block(
                        n_layers, self.block_size, heads, hd, dtype,
                        self.kv_quant)
                    blocks = max(2, int(self._kv_bytes_budget) // bb + 1)
                if blocks is None:
                    # every slot can reach full context: no preemption
                    mb = -(-gen.max_context() // self.block_size)
                    blocks = self.slots * mb + 1
                pool = PagedKVCachePool(
                    int(blocks), self.block_size, n_layers, heads, hd,
                    dtype, device=self.device, name="decode",
                    quant=self.kv_quant)
                self._pools[spec] = pool
                if self.prefix_cache:
                    self._caches[spec] = PrefixCache(
                        pool, capacity_blocks=self._prefix_cache_blocks)
            lane = self._lanes.get(key)
            if lane is None:
                lane = _Lane(key, net, gen, pool, self.slots)
                self._lanes[key] = lane
        return lane

    def _cache_of(self, lane: _Lane) -> Optional[PrefixCache]:
        """The lane's prefix cache (None with the cache off)."""
        if not self.prefix_cache:
            return None
        return self._caches.get(lane.pool.spec)

    def _sorted_caches(self) -> List[PrefixCache]:
        return [c for _, c in sorted(self._caches.items(),
                                     key=lambda kv: repr(kv[0]))]

    def prefix_caches(self) -> List[PrefixCache]:
        """Every prefix cache (in pool-spec order); a drain-time audit
        ``clear()``s them to see the pool fully free."""
        with self._lock:
            return self._sorted_caches()

    def _params(self, lane: _Lane):
        """The lane's compute-dtype parameters, cast once."""
        cached = self._params_cache.get(lane.key)
        if cached is None:
            cached = self._params_cache[lane.key] = \
                lane.net.cast_params(lane.net.params)
        return cached

    def _round_blocks(self, tokens: int) -> int:
        bs = self.block_size
        return -(-int(tokens) // bs) * bs

    # -------------------------------------------------------- admission

    def _admit(self) -> bool:
        """Admit queued sequences FIFO (preempted resumes ride at the
        front); same-bucket neighbours coalesce into one row-bucketed
        prefill. A sequence with no free slot or whose blocks do not fit
        waits for running rows to retire; admission never preempts."""
        admitted = False
        while True:
            group = self._pick_admissions()
            if not group:
                return admitted
            lane, sig, entries = group
            try:
                if sig[0] == "tail":
                    self._prefill_tail_batch(lane, sig[1], sig[2], entries)
                else:
                    self._prefill_batch(lane, sig[1],
                                        [(p.seq, p.blocks) for p in entries])
            except Exception as e:
                record_fault("serving")
                for p in entries:
                    self._rollback_plan(lane, p)
                    self._fail_seq(p.seq, self._typed(e, p.seq))
                continue
            admitted = True

    def _tier_cover(self, lane: _Lane, need: int) -> int:
        return bucket_for(need, self._burst_tiers(lane))

    def _plan_blocks(self, lane: _Lane, seq: _Seq) -> Optional[_AdmitPlan]:
        """Probe the prefix cache and claim every block this admission
        needs: the matched blocks shared, a matched partial block
        replaced by a fresh one for its copy, fresh blocks for the
        rest. None when the pool cannot cover it now (whatever was
        claimed is released)."""
        pool = lane.pool
        owner = _owner_key(lane.key)
        t_full = len(seq.fed)
        need_total = pool.blocks_for(t_full)
        cache = self._cache_of(lane)
        m, shared, partial = (0, [], None)
        if cache is not None:
            m, shared, partial = cache.match(lane.key, seq.fed)
        if m <= 0:
            got = pool.alloc(need_total, owner=owner)
            if got is None:
                return None
            t_pad = lane.gen.prompt_bucket(t_full, max(1, seq.remaining))
            return _AdmitPlan(seq, got, 0, None, ("dense", t_pad))
        have = len(shared) + (1 if partial is not None else 0)
        fresh_need = (need_total - have) + (1 if partial is not None else 0)
        got = pool.alloc(fresh_need, owner=owner)
        if got is None:
            pool.free_blocks(shared + ([partial] if partial is not None
                                       else []))
            return None
        # a matched partial block will be written (the tail starts in
        # it): a fresh block takes its place in the table, its copy
        # lands before the tail prefill, and the shared reference goes
        # after the copy
        blocks = shared + got
        t_tail_pad = bucket_for(t_full - m,
                                bucket_sizes(lane.gen.max_context()))
        tier = self._tier_cover(lane, len(blocks))
        return _AdmitPlan(seq, blocks, m, partial, ("tail", t_tail_pad, tier))

    def _rollback_plan(self, lane: _Lane, plan: _AdmitPlan) -> None:
        owner = _owner_key(lane.key)
        lane.pool.free_blocks(plan.blocks, owner=owner)
        if plan.cow_src is not None:
            lane.pool.free_blocks([plan.cow_src], owner=owner)
            plan.cow_src = None
        plan.seq.blocks = []

    def _pick_admissions(self):
        """Claim the next admissible FIFO group: the first sequence with
        a free slot and allocatable blocks anchors the signature; later
        entries with the same one join while slots, blocks and the admit
        ladder allow (a mismatch is released and left queued). Blocks
        are claimed here and rolled back by the caller on failure."""
        with self._lock:
            pending = list(self._queue)
        anchor = None
        entries: List[_AdmitPlan] = []
        free_slots = 0
        for seq in pending:
            if seq.req.future.done():
                with self._lock:
                    self._queue.remove(seq)
                continue
            lane = self._lane_for(None, None)
            need = lane.pool.blocks_for(len(seq.fed))
            if anchor is None:
                if lane.free_slot() is None:
                    continue
                if need > lane.pool.total_blocks or need > lane.mb:
                    with self._lock:
                        self._queue.remove(seq)
                    self._fail_seq(seq, KVPoolExhausted(
                        f"sequence needs {need} KV blocks; pool holds "
                        f"{lane.pool.total_blocks} (max {lane.mb}"
                        f"/sequence)"))
                    continue
                # validates prompt length and max_new against the context
                lane.gen.prompt_bucket(len(seq.fed), max(1, seq.remaining))
                plan = self._plan_blocks(lane, seq)
                if plan is None:
                    continue  # blocks return as running rows retire
                anchor = (lane, plan.sig)
                free_slots = sum(1 for s in lane.seqs if s is None)
            else:
                if lane is not anchor[0]:
                    continue
                if len(entries) >= min(free_slots, self._admit_ladder[-1]):
                    break
                if need > lane.pool.total_blocks or need > lane.mb:
                    continue  # it fails typed when it anchors
                plan = self._plan_blocks(lane, seq)
                if plan is None:
                    break
                if plan.sig != anchor[1]:
                    self._rollback_plan(lane, plan)
                    continue
            with self._lock:
                self._queue.remove(seq)
            entries.append(plan)
            if anchor is not None and \
                    len(entries) >= min(free_slots, self._admit_ladder[-1]):
                break
        if not entries:
            return None
        return anchor[0], anchor[1], entries

    def _prefill_batch(self, lane: _Lane, t_pad: int,
                       entries: List[Tuple[_Seq, List[int]]]) -> None:
        """One row-bucketed prefill of a same-bucket admission group,
        one scatter of its dense caches into the rows' blocks, one
        rowwise sample of each row's next token on its own clock (the
        group's one fetch), then install into slots (a row that its
        first token already finishes retires at once)."""
        gen, pool = lane.gen, lane.pool
        n = len(entries)
        rows = bucket_for(n, self._admit_ladder)
        t_blk = self._round_blocks(t_pad)
        ids = np.zeros((rows, t_pad), np.int64)
        lens = np.zeros(rows, np.int64)
        tnb = np.zeros((rows, t_blk // self.block_size), np.int64)
        keys = [0] * rows
        folds = [0] * rows
        temp = np.zeros(rows, np.float32)
        top_k = np.zeros(rows, np.int64)
        top_p = np.zeros(rows, np.float32)
        for i, (seq, blocks) in enumerate(entries):
            t_full = len(seq.fed)
            ids[i, :t_full] = seq.fed
            lens[i] = t_full
            tnb[i, :len(blocks)] = blocks
            keys[i] = seq.key
            folds[i] = seq.n_gen
            temp[i] = seq.req.temperature
            top_k[i] = seq.req.top_k
            top_p[i] = seq.req.top_p
        params = self._params(lane)
        pre = gen.prefill_program(t_blk)
        t0p = time.perf_counter()
        fresh = note_dispatch(lane.net,
                              ("gen_prefill", "sched", rows, t_pad, t_blk))
        with span("compile" if fresh else "inference",
                  path="continuous_prefill", bucket=t_pad, rows=n):
            caches, logits = pre(params, ids, lens)
        scat = gen.scatter_program(rows, t_blk, self.block_size)
        note_dispatch(lane.net, ("gen_pool_scatter", "sched", rows, t_blk))
        pool.set_layers(scat(pool.layers, caches, tnb))
        note_dispatch(lane.net, ("gen_row_sample", "sched", rows))
        # the admission group's one wait on the card: its first tokens
        toks = gen.row_sample_program()(logits, keys, folds, temp, top_k,
                                        top_p).cpu().numpy()
        t1p = time.perf_counter()
        self._trace_admitted(
            [(seq, {"bucket": t_pad, "rows": n, "computed": len(seq.fed)})
             for seq, _ in entries], t0p, t1p, "dense")
        cache = self._cache_of(lane)
        for i, (seq, blocks) in enumerate(entries):
            self._note_prefilled(seq, len(seq.fed), t0p)
            if cache is not None:
                cache.note_admitted(0)
            self._install(lane, seq, blocks, int(toks[i]))

    def _prefill_tail_batch(self, lane: _Lane, t_tail_pad: int, tier: int,
                            entries: List[_AdmitPlan]) -> None:
        """One row-bucketed tail prefill of a cache-hit admission group:
        each matched partial block copied to its row's fresh block
        first (the shared reference released after), then one
        ``tail_prefill_program`` writes every row's uncached tail into
        its blocks while the tail attends to the cached prefix and
        itself, then each row's first token is sampled on its own clock
        (the group's one fetch), as on the dense path."""
        gen, pool = lane.gen, lane.pool
        cache = self._cache_of(lane)
        t0p = time.perf_counter()
        # the fresh block standing in at the partial's table index
        copies = [(p.cow_src, p.blocks[p.start // self.block_size])
                  for p in entries if p.cow_src is not None]
        if copies:
            cp = gen.block_copy_program(1, pool.num_blocks, self.block_size)
            for src, dst in copies:
                note_dispatch(lane.net, ("gen_block_copy", "sched", 1))
                pool.set_layers(cp(pool.layers, [src], [dst]))
            for p in entries:
                if p.cow_src is not None:
                    pool.free_blocks([p.cow_src])
                    p.cow_src = None
            if cache is not None:
                cache.note_cow(len(copies))
        n = len(entries)
        rows = bucket_for(n, self._admit_ladder)
        ids = np.zeros((rows, t_tail_pad), np.int64)
        starts = np.zeros(rows, np.int64)
        lens = np.zeros(rows, np.int64)
        tables = np.zeros((rows, tier), np.int64)
        keys = [0] * rows
        folds = [0] * rows
        temp = np.zeros(rows, np.float32)
        top_k = np.zeros(rows, np.int64)
        top_p = np.zeros(rows, np.float32)
        for i, p in enumerate(entries):
            seq = p.seq
            tail = seq.fed[p.start:]
            ids[i, :len(tail)] = tail
            starts[i] = p.start
            lens[i] = len(tail)
            tables[i, :len(p.blocks)] = p.blocks
            keys[i] = seq.key
            folds[i] = seq.n_gen
            temp[i] = seq.req.temperature
            top_k[i] = seq.req.top_k
            top_p[i] = seq.req.top_p
        params = self._params(lane)
        tp = gen.tail_prefill_program(rows, t_tail_pad, tier,
                                      pool.num_blocks, self.block_size)
        fresh = note_dispatch(lane.net, ("gen_tail_prefill", "sched", rows,
                                         t_tail_pad, tier))
        with span("compile" if fresh else "inference",
                  path="continuous_tail_prefill", bucket=t_tail_pad,
                  rows=n, tier=tier):
            pools, logits = tp(params, pool.layers, ids, starts, lens,
                               tables)
        pool.set_layers(pools)
        note_dispatch(lane.net, ("gen_row_sample", "sched", rows))
        # the group's one wait on the card: its first tokens
        toks = gen.row_sample_program()(logits, keys, folds, temp, top_k,
                                        top_p).cpu().numpy()
        t1p = time.perf_counter()
        self._trace_admitted(
            [(p.seq, {"bucket": t_tail_pad, "tier": tier, "rows": n,
                      "computed": len(p.seq.fed) - p.start,
                      "cached": p.start}) for p in entries],
            t0p, t1p, "tail")
        for i, p in enumerate(entries):
            self._note_prefilled(p.seq, len(p.seq.fed) - p.start, t0p)
            if cache is not None:
                cache.note_admitted(p.start)
            self._install(lane, p.seq, p.blocks, int(toks[i]))

    def _note_prefilled(self, seq: _Seq, computed: int, t0p: float) -> None:
        """Count the prompt tokens this admission computed and bill the
        owner its queue time."""
        self._prefill_computed_tokens += int(computed)
        if seq.req.prefix is not None:
            self._resume_reprefill_tokens += int(computed)
        self._attr_note(_owner_key((None, None)), prefill=int(computed),
                        queue_ms=max(0.0, (t0p - seq.t_queued) * 1e3))

    def _attr_note(self, owner: str, prefill: int = 0, decode: int = 0,
                   queue_ms: float = 0.0) -> None:
        """Tick one owner's accumulators and its ``dl4j_attr_*``
        counters (label ``model=owner``)."""
        with self._lock:
            a = self._attr.setdefault(owner, {
                "prefill_tokens": 0, "decode_tokens": 0, "queue_ms": 0.0})
            a["prefill_tokens"] += prefill
            a["decode_tokens"] += decode
            a["queue_ms"] += queue_ms
        m = self._attr_metrics.get(owner)
        if m is None:
            reg = get_registry()
            m = self._attr_metrics[owner] = (
                reg.counter(ATTR_PREFILL_TOKENS_COUNTER,
                            "Prompt tokens actually computed at prefill, "
                            "attributed per model[@version]", model=owner),
                reg.counter(ATTR_DECODE_TOKENS_COUNTER,
                            "Tokens decoded, attributed per "
                            "model[@version]", model=owner),
                reg.counter(ATTR_QUEUE_MS_COUNTER,
                            "Milliseconds sequences spent queued before "
                            "admission, attributed per model[@version]",
                            model=owner))
        if prefill:
            m[0].inc(prefill)
        if decode:
            m[1].inc(decode)
        if queue_ms > 0:
            m[2].inc(queue_ms)

    # ------------------------------------------------- request tracing

    def _trace_begin(self, req: _DecodeRequest) -> None:
        """Root a ``decode_request`` trace for a request with no ambient
        context while a request tracer is on; either way the owning
        trace id rides the future as ``trace_id``."""
        if req.trace is None and reqtrace.request_tracer() is not None:
            req.root = reqtrace.begin_trace(
                "decode_request", rows=req.n, t_in=req.t_in,
                max_new=req.max_new, resume=req.prefix is not None)
            if req.root is not None:
                req.trace = req.root.ctx
        if req.trace is not None:
            req.future.trace_id = req.trace.trace_id

    def _trace_admitted(self, entries, t0: float, t1: float,
                        kind: str) -> None:
        """An admission group's ``queue_wait`` and ``prefill`` spans from
        its dispatch's timestamps, in two passes (every queue_wait, then
        every prefill) so that each trace's spans close in order."""
        if reqtrace.request_tracer() is None:
            return
        for seq, _extra in entries:
            reqtrace.record_span(
                seq.req.trace, "queue_wait", to_origin_us(seq.t_queued),
                (t0 - seq.t_queued) * 1e6, row=seq.row,
                requeued=seq.preemptions)
        for seq, extra in entries:
            reqtrace.record_span(
                seq.req.trace, "prefill", to_origin_us(t0),
                (t1 - t0) * 1e6, kind=kind,
                resume=seq.req.prefix is not None,
                preemptions=seq.preemptions, **extra)

    def _trace_burst(self, lane: _Lane) -> None:
        """One ``decode_burst`` span per traced rider of the burst just
        dispatched: its slot bucket, block tier, K and live rows."""
        info = self._last_burst
        self._last_burst = None
        if info is None or reqtrace.request_tracer() is None:
            return
        t0, dt_ms, rows, tier, n_active = info
        for seq in lane.active():
            reqtrace.record_span(
                seq.req.trace, "decode_burst", to_origin_us(t0),
                dt_ms * 1e3, slot_bucket=rows, tier=tier,
                k=self.burst_tokens, rows=n_active, seq=seq.seq_id)

    def _cache_insert(self, lane: _Lane, seq: _Seq) -> None:
        """Insert-on-retire (and on preempt, so that the victim's resume
        matches its own prefix): pin the sequence's written token run
        into the lane's radix index before its blocks free, so that the
        cache's references keep the full blocks while the private tail
        returns to the free list."""
        cache = self._cache_of(lane)
        if cache is None or not seq.blocks or seq.pos <= 0:
            return
        tokens = np.concatenate(
            [seq.req.prompt[seq.row].astype(np.int64),
             np.asarray(seq.generated, np.int64)])[:seq.pos]
        cache.insert(lane.key, tokens, seq.blocks)

    def _emit_tokens(self, seq: _Seq) -> None:
        """Deliver the row's undelivered tokens through its request's
        ``on_tokens``, tagged with their stream offset. A callback's
        error is the consumer's: it is marked and the scheduler serves
        on."""
        req = seq.req
        if req.on_tokens is None or seq.emitted >= len(seq.generated):
            return
        off = seq.emitted
        new = np.asarray(seq.generated[off:], np.int64)
        seq.emitted = len(seq.generated)
        get_registry().counter(
            STREAM_CHUNKS_COUNTER,
            "Incremental decode-token chunks emitted through the "
            "on_tokens streaming seam").inc()
        traced = req.trace is not None and \
            reqtrace.request_tracer() is not None
        t0c = time.perf_counter() if traced else 0.0
        cb = req.on_tokens
        if self._emit_batch is not None \
                and getattr(cb, "burst_sink", None) is not None:
            # a coalescing callback inside a retire pass: one sink call
            # per burst (_flush_emit_batch)
            self._emit_batch.append((cb, off, new))
        else:
            try:
                cb(off, new)
            except Exception as e:
                mark("stream_callback_error", error=type(e).__name__)
        if traced:
            reqtrace.record_span(
                req.trace, "chunk_deliver", to_origin_us(t0c),
                (time.perf_counter() - t0c) * 1e6, offset=off, n=len(new))

    def _flush_emit_batch(self) -> None:
        batch, self._emit_batch = self._emit_batch, None
        if not batch:
            return
        by_sink: Dict[Any, List[Tuple[Any, int, np.ndarray]]] = {}
        for cb, off, toks in batch:
            by_sink.setdefault(cb.burst_sink, []).append((cb, off, toks))
        for sink, entries in by_sink.items():
            try:
                sink(entries)
            except Exception as e:
                mark("stream_callback_error", error=type(e).__name__)

    def _install(self, lane: _Lane, seq: _Seq, blocks: List[int],
                 tok0: int) -> None:
        req = seq.req
        seq.blocks = blocks
        seq.pos = len(seq.fed)
        seq.generated.append(tok0)
        seq.n_gen += 1
        self._note_first_token(req)
        self._emit_tokens(seq)
        self._admitted_rows += 1
        get_registry().counter(
            SCHED_ADMITTED_COUNTER,
            "Decode rows admitted into batch slots between bursts").inc()
        slot = lane.free_slot()
        self.events.append(
            f"admit seq={seq.seq_id} slot={slot} lane={lane.key} "
            f"t={seq.pos} blocks={len(blocks)}")
        if seq.n_gen >= req.max_new or (req.eos is not None
                                        and tok0 == req.eos):
            # the first token already finished the row
            self._cache_insert(lane, seq)
            lane.pool.free_blocks(seq.blocks, owner=_owner_key(lane.key))
            seq.blocks = []
            self._retire_seq(lane, seq)
            return
        lane.seqs[slot] = seq
        lane.tables[slot] = 0
        lane.tables[slot, :len(blocks)] = blocks
        lane.pos[slot] = seq.pos
        lane.tok[slot] = tok0
        lane.n_gen[slot] = seq.n_gen
        lane.done[slot] = False
        lane.keys[slot] = seq.key
        lane.temp[slot] = req.temperature
        lane.top_k[slot] = req.top_k
        lane.top_p[slot] = req.top_p
        lane.eos[slot] = -1 if req.eos is None else req.eos
        lane.max_new_v[slot] = req.max_new
        seq.slot = slot

    # ------------------------------------------------ pool growth/preempt

    def _ensure_blocks(self, lane: _Lane) -> None:
        """Top up every active sequence's table to cover its next K
        positions (capped at its remaining quota). Exhaustion preempts
        the lowest-priority, youngest active sequence, possibly the
        grower itself."""
        for slot in range(lane.slots):
            seq = lane.seqs[slot]
            if seq is None:
                continue
            horizon = int(lane.pos[slot]) + min(self.burst_tokens,
                                                max(1, seq.remaining))
            while seq.slot is not None:
                delta = lane.pool.blocks_for(horizon) - len(seq.blocks)
                if delta <= 0:
                    break
                got = lane.pool.alloc(delta, owner=_owner_key(lane.key))
                if got is not None:
                    start = len(seq.blocks)
                    seq.blocks.extend(got)
                    lane.tables[slot, start:start + len(got)] = got
                    break
                victim = self._pick_victim(lane.pool)
                if victim is None or victim is seq:
                    # nobody else to evict: the grower yields its slot
                    # (or, alone and still too big, fails typed)
                    if victim is seq and lane.pool.blocks_for(horizon) \
                            <= lane.pool.total_blocks:
                        self._preempt(victim)
                    else:
                        self._evict_fail(lane, seq, KVPoolExhausted(
                            f"sequence {seq.seq_id} needs "
                            f"{lane.pool.blocks_for(horizon)} blocks; pool "
                            f"holds {lane.pool.total_blocks}"))
                    break
                self._preempt(victim)

    def _pick_victim(self, pool: PagedKVCachePool) -> Optional[_Seq]:
        """Lowest priority loses first; the youngest admission breaks
        ties (the oldest work is closest to finishing)."""
        cands: List[_Seq] = []
        for lane in self._lanes.values():
            if lane.pool is pool:
                cands.extend(lane.active())
        if not cands:
            return None
        return min(cands, key=lambda s: (s.priority, -s.seq_id))

    def _preempt(self, seq: _Seq) -> None:
        """Free the victim's blocks and re-queue it at the front with
        prompt + generated prefix; its token clock rides along, so the
        resumed tokens are an uninterrupted run's."""
        lane = self._lane_for(None, None)
        slot = seq.slot
        # insert before the free: with the prefix cache on, the victim's
        # full blocks stay cached and its resume clones them
        self._cache_insert(lane, seq)
        lane.pool.free_blocks(seq.blocks, owner=_owner_key(lane.key))
        seq.blocks = []
        seq.fed = np.concatenate([seq.req.prompt[seq.row],
                                  np.asarray(seq.generated, np.int64)])
        seq.slot = None
        seq.preemptions += 1
        seq.t_queued = time.perf_counter()
        reqtrace.trace_event(seq.req.trace, "preempt", seq=seq.seq_id,
                             n_gen=seq.n_gen, priority=seq.priority)
        if slot is not None:
            lane.clear_slot(slot)
        with self._lock:
            self._queue.appendleft(seq)
            self._preemptions += 1
        get_registry().counter(
            SCHED_PREEMPTIONS_COUNTER,
            "Sequences preempted (blocks freed, re-queued with their "
            "generated prefix) because the KV pool was exhausted").inc()
        mark("decode_preempted", seq=seq.seq_id, priority=seq.priority)
        self.events.append(
            f"preempt seq={seq.seq_id} prio={seq.priority} "
            f"n_gen={seq.n_gen}")

    def _evict_fail(self, lane: _Lane, seq: _Seq,
                    err: BaseException) -> None:
        lane.pool.free_blocks(seq.blocks, owner=_owner_key(lane.key))
        seq.blocks = []
        if seq.slot is not None:
            lane.clear_slot(seq.slot)
            seq.slot = None
        self._fail_seq(seq, err)

    # ----------------------------------------------------------- bursts

    def _burst_tiers(self, lane: _Lane) -> Tuple[int, ...]:
        """The power-of-two ladder of block counts a burst attends: the
        longest active sequence's, rounded up."""
        return _pow2_ladder(lane.mb)

    def _tier_for(self, lane: _Lane) -> int:
        need = max([1] + [len(s.blocks) for s in lane.active()])
        return bucket_for(need, self._burst_tiers(lane))

    def _dispatch_burst(self, lane: _Lane, params, accounted: bool = False,
                        tier: Optional[int] = None,
                        sampling: Optional[bool] = None,
                        rows: Optional[int] = None):
        """One burst over the active rows compacted into the smallest
        slot bucket covering them (``rows``), attending ``tier`` table
        columns, greedy unless an active row samples. One fetch brings
        home the tokens and the rows' state. Returns full-slot (ys, tok,
        pos, n_gen, done) so retirement indexes by slot."""
        pool = lane.pool
        active = [i for i, s in enumerate(lane.seqs) if s is not None]
        if tier is None:
            tier = self._tier_for(lane)
        if sampling is None:
            sampling = any(s.req.temperature > 0.0 for s in lane.active())
        if rows is None:
            rows = bucket_for(max(1, len(active)), self._slot_ladder)
        if self._burst_hook is not None and accounted:
            self._burst_hook(lane.key, self._bursts)
        n = min(len(active), rows)
        sel = active[:n]

        def compact(v, fill):
            out = np.full((rows,) + v.shape[1:], fill, v.dtype)
            out[:n] = v[sel]
            return out

        bp = lane.gen.burst_program(rows, self.burst_tokens, tier,
                                    pool.num_blocks, pool.block_size,
                                    sampling=sampling)
        fresh = note_dispatch(
            lane.net, ("gen_burst", "sched", rows, self.burst_tokens,
                       tier, pool.num_blocks, pool.block_size,
                       bool(sampling)))
        t0 = time.perf_counter()
        with span("compile" if fresh else "inference",
                  path="continuous_burst", slots=rows,
                  k=self.burst_tokens, tier=tier,
                  rows=n if accounted else 0):
            pools, ys, tok2, pos2, ng2, done2 = bp(
                params, pool.layers, compact(lane.tables[:, :tier], 0),
                compact(lane.pos, 0), compact(lane.tok, 0),
                compact(lane.n_gen, 0), compact(lane.done, True),
                compact(lane.keys, 0).tolist(), compact(lane.temp, 0.0),
                compact(lane.top_k, 0), compact(lane.top_p, 0.0),
                compact(lane.eos, -1), compact(lane.max_new_v, 0))
            # the burst's one fetch: tokens and row state together
            got = torch.cat([ys, torch.stack([tok2, pos2, ng2, done2.long()],
                                             dim=1)], dim=1).cpu().numpy()
        pool.set_layers(pools)
        dt_ms = (time.perf_counter() - t0) * 1e3
        if accounted:
            reg = get_registry()
            reg.counter(SCHED_BURSTS_COUNTER,
                        "Fixed-K decode bursts dispatched").inc()
            reg.histogram(SCHED_BURST_LATENCY_HISTOGRAM,
                          "Decode burst dispatch latency (K steps, one "
                          "scan)").observe(dt_ms)
            # the riders' trace spans, recorded after from these host
            # timestamps (_trace_burst)
            self._last_burst = (t0, dt_ms, rows, tier, n)
            with self._lock:
                self._bursts += 1
        k = self.burst_tokens
        ys_f = np.zeros((lane.slots, k), np.int64)
        tok_f, pos_f = lane.tok.copy(), lane.pos.copy()
        ng_f, done_f = lane.n_gen.copy(), lane.done.copy()
        ys_f[sel] = got[:n, :k]
        tok_f[sel] = got[:n, k]
        pos_f[sel] = got[:n, k + 1]
        ng_f[sel] = got[:n, k + 2]
        done_f[sel] = got[:n, k + 3].astype(bool)
        return ys_f, tok_f, pos_f, ng_f, done_f

    def _retire(self, lane: _Lane, outs) -> None:
        ys, tok, pos, n_gen, done = outs
        finished: List[_Seq] = []
        self._emit_batch = []
        try:
            for slot in range(lane.slots):
                seq = lane.seqs[slot]
                if seq is None:
                    continue
                emitted = int(n_gen[slot]) - int(lane.n_gen[slot])
                if emitted > 0:
                    seq.generated.extend(int(t) for t in ys[slot, :emitted])
                    seq.n_gen = int(n_gen[slot])
                    seq.pos = int(pos[slot])
                    self._attr_note(_owner_key(lane.key), decode=emitted)
                    self._note_first_token(seq.req)
                    self._emit_tokens(seq)
                lane.tok[slot] = tok[slot]
                lane.pos[slot] = pos[slot]
                lane.n_gen[slot] = n_gen[slot]
                if bool(done[slot]):
                    self._cache_insert(lane, seq)
                    lane.pool.free_blocks(seq.blocks,
                                          owner=_owner_key(lane.key))
                    seq.blocks = []
                    lane.clear_slot(slot)
                    seq.slot = None
                    finished.append(seq)
        finally:
            # the last chunks go out before any request resolves
            self._flush_emit_batch()
        for seq in finished:
            self._retire_seq(lane, seq)

    def _burst_failed(self, lane: _Lane, err: BaseException) -> None:
        """Every sequence riding a failed burst fails typed and frees
        its blocks at once; the scheduler keeps serving later
        admissions."""
        record_fault("serving")
        mark("decode_burst_failed", lane=str(lane.key),
             error=type(err).__name__)
        self.events.append(f"burst_failed lane={lane.key} "
                           f"err={type(err).__name__}")
        for slot in range(lane.slots):
            seq = lane.seqs[slot]
            if seq is None:
                continue
            lane.pool.free_blocks(seq.blocks, owner=_owner_key(lane.key))
            seq.blocks = []
            lane.clear_slot(slot)
            seq.slot = None
            self._fail_seq(seq, self._typed(err, seq))

    def _typed(self, err: BaseException, seq: _Seq) -> DecodeBurstError:
        e = DecodeBurstError(
            f"decode dispatch failed under sequence {seq.seq_id} "
            f"({type(err).__name__}: {err})")
        e.__cause__ = err
        return e

    # ------------------------------------------------------- completion

    def _note_first_token(self, req: _DecodeRequest) -> None:
        if req.t_first is None:
            req.t_first = time.perf_counter()

    def _retire_seq(self, lane: _Lane, seq: _Seq) -> None:
        req = seq.req
        self._retired_rows += 1
        get_registry().counter(
            SCHED_RETIRED_COUNTER,
            "Decode rows retired (EOS/max-len) between bursts, blocks "
            "freed").inc()
        self.events.append(
            f"retire seq={seq.seq_id} n_gen={seq.n_gen} "
            f"preemptions={seq.preemptions}")
        req.rows_done += 1
        if req.rows_done >= req.n and not req.future.done():
            self._resolve(req)

    def _resolve(self, req: _DecodeRequest) -> None:
        out = np.zeros((req.n, req.t_in + req.max_new), np.int64)
        out[:, :req.t_in] = req.prompt
        tokens = 0
        fill = req.eos if req.eos is not None else 0
        for seq in req.rows:
            row = np.asarray(seq.generated, np.int64)
            tokens += len(row)
            padded = np.full(req.max_new, fill, np.int64)
            padded[:len(row)] = row[:req.max_new]
            out[seq.row, req.t_in:] = padded
        t_done = time.perf_counter()
        t_first = req.t_first if req.t_first is not None else t_done
        self.completed.append({
            "t_submit": req.t_submit, "t_first": t_first,
            "t_done": t_done, "rows": req.n, "tokens": tokens})
        # seal the trace before the future resolves, so that a caller
        # reading it on completion finds it
        reqtrace.finish_trace(
            req.root, outcome="ok", tokens=tokens,
            ttft_ms=round((t_first - req.t_submit) * 1e3, 3))
        req.future.set_result(out)
        self._count_resolved()

    def _fail_seq(self, seq: _Seq, err: BaseException) -> None:
        req = seq.req
        self.events.append(f"fail seq={seq.seq_id} err={type(err).__name__}")
        if not req.future.done():
            reqtrace.finish_trace(req.root, outcome="error",
                                  error=type(err).__name__)
            req.future.set_exception(err)
            self._count_resolved()
        # drop the request's other rows: its future already failed
        with self._lock:
            others = [s for s in self._queue if s.req is req]
            for other in others:
                self._queue.remove(other)
        for lane in self._lanes.values():
            for slot in range(lane.slots):
                s = lane.seqs[slot]
                if s is not None and s.req is req and s is not seq:
                    lane.pool.free_blocks(s.blocks,
                                          owner=_owner_key(lane.key))
                    s.blocks = []
                    lane.clear_slot(slot)
                    s.slot = None

    def _count_resolved(self) -> None:
        with self._lock:
            self._resolved += 1
        if self._on_resolve is not None:
            self._on_resolve(1)

    def _fail_everything(self, err: BaseException) -> None:
        with self._lock:
            queued = list(self._queue)
            self._queue.clear()
        failed = set()

        def fail(req):
            if req not in failed and not req.future.done():
                reqtrace.finish_trace(req.root, outcome="error",
                                      error=type(err).__name__)
                req.future.set_exception(err)
                failed.add(req)
                self._count_resolved()

        for seq in queued:
            fail(seq.req)
        for lane in self._lanes.values():
            for slot in range(lane.slots):
                seq = lane.seqs[slot]
                if seq is None:
                    continue
                lane.pool.free_blocks(seq.blocks,
                                      owner=_owner_key(lane.key))
                seq.blocks = []
                lane.clear_slot(slot)
                seq.slot = None
                fail(seq.req)

    # ----------------------------------------------------------- thread

    def _gauges(self) -> None:
        """The active and queued gauges and, with the time series on,
        their samples and each pool's occupancy: host counts only."""
        reg = get_registry()
        with self._lock:
            active = sum(len(lane.active()) for lane in self._lanes.values())
            queued = len(self._queue)
            pools = list(self._pools.values())
            caches = list(self._caches.values())
        reg.gauge(SCHED_ACTIVE_GAUGE,
                  "Decode sequences currently occupying batch slots"
                  ).set(active)
        reg.gauge(SCHED_QUEUED_GAUGE,
                  "Decode sequences queued awaiting admission").set(queued)
        if not timeseries_enabled():
            return
        ts_record(TS_SCHED_ACTIVE, active)
        ts_record(TS_SCHED_QUEUED, queued)
        for pool in pools:
            ts_record(TS_SCHED_POOL_OCCUPANCY, pool.occupancy())
        hits = misses = 0
        for c in caches:
            st = c.stats()
            hits += st["hits"]
            misses += st["misses"]
        if hits + misses:
            ts_record(TS_SCHED_PREFIX_HIT_RATE, hits / (hits + misses))

    def _work_available(self) -> bool:
        if self._queue:
            return True
        return any(lane.active() for lane in self._lanes.values())

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._stopping and not self._work_available():
                    self._cv.wait(0.05)
                if self._stopping and (self._cancel
                                       or not self._work_available()):
                    break
            try:
                progressed = self.step()
            except Exception as e:  # never die silently
                self._fail_everything(e)
                return
            if not progressed:
                with self._cv:
                    if self._stopping:
                        break
                    self._cv.wait(0.01)
        if self._cancel:
            self._fail_everything(
                EngineShutdown("scheduler shut down before dispatch"))
