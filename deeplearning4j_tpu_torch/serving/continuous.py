"""Continuous batching: iteration-level decode scheduling over a paged
KV-cache block pool.

Counterpart of ``deeplearning4j_tpu/serving/continuous.py``, its
single-net core (Orca's iteration-level scheduling over vLLM's paged
pool):

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
- one fetch per admission group (its first tokens) and one per burst
  (its tokens and row state) are the host's only waits on the card.

``start=False`` skips the scheduler thread: :meth:`step` then drives a
fully deterministic schedule. Transformer (KV-cache) stacks only.

Left for later slices, each raising ``NotImplementedError`` that names
its ROADMAP item: ``registry=`` lanes, ``prefix_cache=True``,
``speculative=True`` / ``draft_net=``, ``host_kv_blocks=`` and
``submit``'s ``model=`` / ``version=``, ``session=`` / ``hibernate=``
and ``on_tokens=`` (A10); ``kv_state=`` (A11). The reference's metrics,
spans and request traces wait for A12.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.iterators import bucket_for
from deeplearning4j_tpu_torch.nn.generate import (
    TransformerGenerator,
    build_generator,
    row_keys,
)
from deeplearning4j_tpu_torch.nn.kvpool import PagedKVCachePool, pool_spec
from deeplearning4j_tpu_torch.nn.quantize import quant_modes
from deeplearning4j_tpu_torch.parallel.inference import (
    EngineShutdown,
    InferenceBackpressure,
)


class DecodeBurstError(RuntimeError):
    """A burst or prefill died under a sequence: its future carries this
    (the error as ``__cause__``), its blocks are freed, and the
    scheduler keeps serving everyone else."""


class KVPoolExhausted(RuntimeError):
    """A sequence needs more KV blocks than the pool can ever provide,
    even with every other sequence preempted: a sizing error."""


def _later(feature: str, item: str = "A10") -> NotImplementedError:
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
    ``prefix`` makes it a resume: the row re-prefills prompt + prefix
    and its token clock starts at ``len(prefix)``."""

    __slots__ = ("prompt", "n", "t_in", "max_new", "temperature", "top_k",
                 "top_p", "eos", "seed", "priority", "future", "rows_done", "t_submit", "t_first", "rows",
                 "prefix")

    def __init__(self, prompt: np.ndarray, max_new: int, temperature: float,
                 top_k: int, top_p: float, eos: Optional[int], seed: int,
                 priority: int, prefix: Optional[np.ndarray] = None):
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
        self.future: "Future[np.ndarray]" = Future()
        self.rows_done = 0
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None
        self.rows: List["_Seq"] = []


class _Seq:
    """One decode row, the schedulable unit. ``fed`` is what the next
    (re)prefill feeds: the prompt plus everything generated before the
    last preemption; ``generated`` the output so far; ``n_gen`` the
    row's token clock (the fold of its next draw)."""

    __slots__ = ("req", "row", "fed", "generated", "key", "n_gen", "slot",
                 "blocks", "pos", "seq_id", "preemptions", "t_queued")

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
        if req.prefix is not None and len(req.prefix):
            pre = np.asarray(req.prefix, np.int64)
            self.fed = np.concatenate([self.fed, pre])
            self.generated = [int(t) for t in pre]
            self.n_gen = len(self.generated)

    @property
    def priority(self) -> int:
        return self.req.priority

    @property
    def remaining(self) -> int:
        return self.req.max_new - self.n_gen


class _AdmitPlan:
    """One admission's claimed blocks (in table order) and the group
    signature that decides which admissions share a prefill."""

    __slots__ = ("seq", "blocks", "sig")

    def __init__(self, seq: _Seq, blocks: List[int], sig: Tuple):
        self.seq = seq
        self.blocks = blocks
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

    ``start=False`` skips the scheduler thread; tests drive :meth:`step`
    for deterministic schedules. ``burst_hook(lane_key, burst_index)``
    runs before each burst; an error it raises fails the burst's
    sequences with :class:`DecodeBurstError`, frees their blocks, and
    the scheduler serves on."""

    def __init__(self, net=None, registry=None, slots: int = 8,
                 burst_tokens: int = 8, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 queue_capacity: int = 256, admit_rows: int = 4,
                 start: bool = True, burst_hook=None,
                 prefix_cache: bool = False,
                 prefix_cache_blocks: Optional[int] = None,
                 kv_quant: Optional[str] = None,
                 kv_bytes_budget: Optional[int] = None,
                 speculative: bool = False, draft_net=None,
                 host_kv_blocks: Optional[int] = None):
        if registry is not None:
            raise _later("registry= (model/version lanes)")
        if prefix_cache or prefix_cache_blocks is not None:
            raise _later("prefix_cache= (serving/prefixcache.py)")
        if speculative or draft_net is not None:
            raise _later("speculative=/draft_net= (speculative decoding)")
        if host_kv_blocks:
            raise _later("host_kv_blocks= (host-tier preemption and "
                         "hibernation)")
        if net is None:
            raise ValueError("ContinuousDecodeScheduler needs a net")
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
        Higher ``priority`` sequences are preempted last. ``prefix``
        (one row) resumes a stream: the row re-prefills prompt + prefix,
        its token clock starts at ``len(prefix)``, and
        ``max_new_tokens`` still counts the prefix."""
        if model is not None or version is not None:
            raise _later("model=/version= (registry lanes)")
        if session is not None or hibernate:
            raise _later("session=/hibernate= (session hibernation)")
        if on_tokens is not None:
            raise _later("on_tokens= (token streaming)")
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
            if prompt.shape[0] != 1:
                raise ValueError(
                    "prefix resume is per-stream: prompt must be [1, t0], "
                    f"got {prompt.shape}")
        if pre is not None and len(pre) >= max_new:
            # every token was generated before: only the result was lost
            out = np.concatenate(
                [np.asarray(prompt, np.int64), pre[None, :max_new]], axis=1)
            req = _DecodeRequest(prompt, max_new, temperature, top_k, top_p,
                                 eos_token, seed, priority, pre)
            with self._cv:
                self._accepted += 1
            req.future.set_result(out)
            self._count_resolved()
            return req.future
        lane = self._lane_for(None, None)
        # validates prompt(+prefix) length and max_new against the context
        n_pre = 0 if pre is None else len(pre)
        lane.gen.prompt_bucket(prompt.shape[1] + n_pre,
                               max(1, max_new - n_pre))
        req = _DecodeRequest(prompt, max_new, temperature, top_k, top_p,
                             eos_token, seed, priority, pre)
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
               version: Optional[int] = None) -> int:
        """Run the program set once, all masked (every write lands in
        the trash block; accounting untouched): the rowwise sampler at
        every admission row count, each covering prompt bucket's prefill
        and scatter, and the burst over every (block tier x slot bucket)
        in its greedy and sampling forms. Returns how many programs were
        built."""
        if model is not None or version is not None:
            raise _later("model=/version= (registry lanes)")
        lane = self._lane_for(None, None)
        pool, gen = lane.pool, lane.gen
        before = len(gen.__dict__.get("_programs", {}))
        params = self._params(lane)
        rs = gen.row_sample_program()
        vocab = int(gen.emb.conf.n_in)
        for rows in self._admit_ladder:
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
                caches, _ = gen.prefill_program(t_blk)(
                    params, np.zeros((rows, t_pad), np.int64),
                    np.full(rows, min(int(t_in), t_pad), np.int64))
                scat = gen.scatter_program(rows, t_blk, self.block_size)
                pool.set_layers(scat(
                    pool.layers, caches,
                    np.zeros((rows, t_blk // self.block_size), np.int64)))
        for tier in self._burst_tiers(lane):
            for rows in self._slot_ladder:
                for sampling in (False, True):
                    self._dispatch_burst(lane, params, tier=tier,
                                         sampling=sampling, rows=rows)
        self._warmed = True
        return len(gen.__dict__.get("_programs", {})) - before

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
            self._retire(lane, outs)
            progressed = True
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
                    dtype, device=net.device, name="decode",
                    quant=self.kv_quant)
                self._pools[spec] = pool
            lane = self._lanes.get(key)
            if lane is None:
                lane = _Lane(key, net, gen, pool, self.slots)
                self._lanes[key] = lane
        return lane

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
                self._prefill_batch(lane, sig[1],
                                    [(p.seq, p.blocks) for p in entries])
            except Exception as e:
                for p in entries:
                    self._rollback_plan(lane, p)
                    self._fail_seq(p.seq, self._typed(e, p.seq))
                continue
            admitted = True

    def _plan_blocks(self, lane: _Lane, seq: _Seq) -> Optional[_AdmitPlan]:
        """Claim every block this admission needs, or None when the pool
        cannot cover it now."""
        t_full = len(seq.fed)
        got = lane.pool.alloc(lane.pool.blocks_for(t_full),
                              owner=_owner_key(lane.key))
        if got is None:
            return None
        t_pad = lane.gen.prompt_bucket(t_full, max(1, seq.remaining))
        return _AdmitPlan(seq, got, ("dense", t_pad))

    def _rollback_plan(self, lane: _Lane, plan: _AdmitPlan) -> None:
        lane.pool.free_blocks(plan.blocks, owner=_owner_key(lane.key))
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
            if len(entries) >= min(free_slots, self._admit_ladder[-1]):
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
        t0p = time.perf_counter()
        caches, logits = gen.prefill_program(t_blk)(params, ids, lens)
        scat = gen.scatter_program(rows, t_blk, self.block_size)
        pool.set_layers(scat(pool.layers, caches, tnb))
        toks = gen.row_sample_program()(logits, keys, folds, temp, top_k,
                                        top_p).cpu().numpy()
        for i, (seq, blocks) in enumerate(entries):
            self._note_prefilled(seq, len(seq.fed), t0p)
            self._install(lane, seq, blocks, int(toks[i]))

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
        with self._lock:
            a = self._attr.setdefault(owner, {
                "prefill_tokens": 0, "decode_tokens": 0, "queue_ms": 0.0})
            a["prefill_tokens"] += prefill
            a["decode_tokens"] += decode
            a["queue_ms"] += queue_ms

    def _install(self, lane: _Lane, seq: _Seq, blocks: List[int],
                 tok0: int) -> None:
        req = seq.req
        seq.blocks = blocks
        seq.pos = len(seq.fed)
        seq.generated.append(tok0)
        seq.n_gen += 1
        self._note_first_token(req)
        self._admitted_rows += 1
        slot = lane.free_slot()
        self.events.append(
            f"admit seq={seq.seq_id} slot={slot} lane={lane.key} "
            f"t={seq.pos} blocks={len(blocks)}")
        if seq.n_gen >= req.max_new or (req.eos is not None
                                        and tok0 == req.eos):
            # the first token already finished the row
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
        lane.pool.free_blocks(seq.blocks, owner=_owner_key(lane.key))
        seq.blocks = []
        seq.fed = np.concatenate([seq.req.prompt[seq.row],
                                  np.asarray(seq.generated, np.int64)])
        seq.slot = None
        seq.preemptions += 1
        seq.t_queued = time.perf_counter()
        if slot is not None:
            lane.clear_slot(slot)
        with self._lock:
            self._queue.appendleft(seq)
            self._preemptions += 1
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
        if accounted:
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
            lane.tok[slot] = tok[slot]
            lane.pos[slot] = pos[slot]
            lane.n_gen[slot] = n_gen[slot]
            if bool(done[slot]):
                lane.pool.free_blocks(seq.blocks, owner=_owner_key(lane.key))
                seq.blocks = []
                lane.clear_slot(slot)
                seq.slot = None
                finished.append(seq)
        for seq in finished:
            self._retire_seq(lane, seq)

    def _burst_failed(self, lane: _Lane, err: BaseException) -> None:
        """Every sequence riding a failed burst fails typed and frees
        its blocks at once; the scheduler keeps serving later
        admissions."""
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
        self.completed.append({
            "t_submit": req.t_submit,
            "t_first": req.t_first if req.t_first is not None else t_done,
            "t_done": t_done, "rows": req.n, "tokens": tokens})
        req.future.set_result(out)
        self._count_resolved()

    def _fail_seq(self, seq: _Seq, err: BaseException) -> None:
        req = seq.req
        self.events.append(f"fail seq={seq.seq_id} err={type(err).__name__}")
        if not req.future.done():
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

    def _fail_everything(self, err: BaseException) -> None:
        with self._lock:
            queued = list(self._queue)
            self._queue.clear()
        failed = set()

        def fail(req):
            if req not in failed and not req.future.done():
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
