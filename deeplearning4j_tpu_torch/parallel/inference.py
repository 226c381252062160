"""ParallelInference: the dynamic micro-batching serving engine.

Counterpart of ``deeplearning4j_tpu/parallel/inference.py`` (DL4J's
``ParallelInference`` in BATCHED mode; INPLACE is ``coalesce=False``),
for one net on torch devices. Concurrent requests are coalesced into
padded micro-batches, so that the card runs a few full batches instead
of one small one, and one round trip, per request:

- ``submit(x)`` (thread-safe, returns a Future) and ``output(x)`` (its
  blocking facade) enqueue onto a bounded admission queue that rejects
  (``reject_when_full=True``, :class:`InferenceBackpressure`) or blocks
  when full;
- a dispatcher thread coalesces same-shaped requests under
  ``max_batch_size`` / ``max_latency_ms`` (holding them only while every
  replica is busy: ``eager_when_idle``), pads the row count up the
  ``bucket_sizes`` ladder, and hands the batch to the workers' FIFO
  (:class:`_BatchQueue`);
- one worker thread per replica (``devices=``: torch devices, every
  CUDA device by default; a device may appear more than once) runs the
  net's ``infer_output_fn`` on its own device copy of the parameters and
  states and delivers each caller's rows; the one ``.cpu()`` of the
  batch's result is the worker's wait on the card, after which the rows
  are the device's final values;
- ``warmup(shapes)`` dispatches every (bucket x replica) signature once,
  so that a kernel's build and cuBLAS/cuDNN's first-call autotuning
  happen there: serving the warmed set afterwards ticks
  ``dl4j_jit_cache_miss_total`` zero times (the port's meaning of that
  counter: the first dispatch of a signature, ``optimize/deferred.py``);
- ``shutdown()`` drains in-flight work and re-raises the first worker
  error, which every affected Future also carries.

Degradation: a batch that raises is retried on its replica
(``max_batch_retries``); then the replica is **quarantined**, its batch
goes to a surviving replica (or, with none left, its futures fail), and
every ``probe_interval_ms`` (or at ``probe_now()``) the replica runs a
one-row probe of the last shape served and rejoins the pool when it
passes. ``poison_hook(replica, shape)`` is the fault-injection seam.
Nets with cross-batch statistics (``_pad_tail_safe`` false: MoE
capacity routing) dispatch each request alone and unpadded.

Generation: ``submit_generate`` / ``generate`` coalesce decode requests
per (prompt bucket, max_new_tokens, sampler) into one
``nn/generate.py`` run per batch, each row on its own length and key,
so a request's tokens are a solo ``generate``'s; ``warmup_generate``
runs the (bucket x row bucket x replica) set. ``continuous=True``
routes them through a :class:`~deeplearning4j_tpu_torch.serving.
continuous.ContinuousDecodeScheduler` on the first replica's device,
which must be the net's (``decode_slots``, ``decode_burst``,
``kv_block_size``, ``kv_blocks``, ``kv_quant``, ``kv_bytes_budget``,
``prefix_cache``, ``prefix_cache_blocks``), with ``on_tokens=``
streaming and ``prefix=`` resumes.

Left for later slices, each raising ``NotImplementedError`` that names
its ROADMAP item: ``registry=`` (multi-model serving), ``session=`` /
``max_sessions``, ``kv_host_blocks=``, ``hibernate=`` and the
``hibernate_*`` methods, ``speculative=`` / ``draft_net=`` and
``warmup_model`` (A10b); ``prefill_export``, ``warmup_prefill`` and
``kv_state=`` (A11); ``slice_plane=`` (A9).

Telemetry (``monitor``): ``dl4j_infer_requests_total``,
``dl4j_infer_batches_total``, the ``dl4j_infer_batch_size`` and
``dl4j_infer_latency_ms`` histograms, the ``dl4j_infer_queue_depth`` and
``dl4j_infer_padded_ratio`` gauges, ``dl4j_decode_requests_total``,
``dl4j_fault_quarantined_replicas`` and the fault counter; spans
``stage`` (``infer_replicas``, ``infer_feed``, ``warmup_generate``),
``compile`` / ``inference`` around dispatches; ``engine_queue`` and
``engine_dispatch`` spans on a request's trace; an engine-private
``TimeSeriesStore`` (batch fill ratio, first-dispatch rate) summarized
in ``stats()``.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.iterators import (bucket_for,
                                                         bucket_sizes,
                                                         pad_rows)
from deeplearning4j_tpu_torch.monitor import (
    DECODE_REQUESTS_COUNTER,
    FAULT_QUARANTINED_GAUGE,
    INFER_BATCH_SIZE_BUCKETS,
    INFER_BATCH_SIZE_HISTOGRAM,
    INFER_BATCHES_COUNTER,
    INFER_LATENCY_HISTOGRAM,
    INFER_PADDED_RATIO_GAUGE,
    INFER_QUEUE_DEPTH_GAUGE,
    INFER_REQUESTS_COUNTER,
    JIT_CACHE_MISS_COUNTER,
    STREAM_CHUNKS_COUNTER,
    TS_ENGINE_FILL_RATIO,
    TS_ENGINE_JIT_MISS,
    TimeSeriesStore,
    get_registry,
    mark,
    record_fault,
    reqtrace,
    span,
    timeseries_enabled,
    to_origin_us,
)
from deeplearning4j_tpu_torch.optimize.deferred import note_dispatch
from deeplearning4j_tpu_torch.util.device import resolve_device, same_device


class InferenceBackpressure(RuntimeError):
    """``submit`` found the admission queue full (``reject_when_full``)."""


class EngineShutdown(RuntimeError):
    """A submit was rejected because the engine (or its decode
    scheduler) is shut down."""


class SliceDegraded(RuntimeError):
    """A chip inside the engine's mesh slice died, poisoning the whole
    slice. Raised by no path of the port until the mesh slices exist
    (ROADMAP A9); defined so that callers can name it."""


def _later(feature: str, item: str = "A10b") -> NotImplementedError:
    return NotImplementedError(
        f"ParallelInference: {feature} is not ported yet (ROADMAP {item})")


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.float16: np.float16}


def _place(tree: Any, device: torch.device) -> Any:
    """``tree`` (nested dicts, lists, tuples) with every tensor on
    ``device``; a tensor already there is the same tensor."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, device) for v in tree)
    return tree


def _host(t: torch.Tensor) -> np.ndarray:
    """A result on the host; half-precision values as f32 (``output``'s
    dtype)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


class _Request:
    __slots__ = ("x", "n", "future", "t_submit", "model", "version",
                 "coalescible", "trace")

    def __init__(self, x: np.ndarray, model: Optional[str] = None,
                 version: Optional[int] = None, coalescible: bool = True):
        self.x = x
        self.n = int(x.shape[0])
        self.future: "Future[np.ndarray]" = Future()
        self.t_submit = time.perf_counter()
        self.model = model
        self.version = version
        self.coalescible = coalescible
        # the request-trace context at submit, on the caller's thread
        self.trace = reqtrace.current_trace()

    def sig(self) -> Tuple:
        """Coalescing signature: only requests of one signature share a
        batch."""
        return (self.model, self.version) + tuple(self.x.shape[1:])

    def finish(self, rows: np.ndarray) -> np.ndarray:
        """This request's Future value from its de-padded rows."""
        return rows


class _GenRequest(_Request):
    """A decode request: bucket-padded prompt rows [n, t_pad], each row's
    true length and key. Coalesces with requests of the same (prompt
    bucket, max_new_tokens, sampler)."""

    __slots__ = ("lengths", "keys", "t_in", "max_new", "sampler")

    def __init__(self, ids_pad: np.ndarray, lengths: np.ndarray,
                 keys: np.ndarray, t_in: int, max_new: int,
                 sampler: Tuple, model: Optional[str] = None,
                 version: Optional[int] = None, coalescible: bool = True):
        super().__init__(ids_pad, model, version, coalescible)
        self.lengths = lengths
        self.keys = keys
        self.t_in = t_in
        self.max_new = max_new
        self.sampler = sampler

    def sig(self) -> Tuple:
        return ("gen", self.model, self.version, self.x.shape[1],
                self.max_new) + self.sampler

    def finish(self, rows: np.ndarray) -> np.ndarray:
        return np.concatenate(
            [self.x[:, :self.t_in].astype(np.int64),
             rows.astype(np.int64)], axis=1)


class _Batch:
    __slots__ = ("requests", "x", "rows", "tried", "payload", "model",
                 "version")

    def __init__(self, requests: List[_Request], x: np.ndarray, rows: int,
                 payload: Optional[Tuple] = None,
                 model: Optional[str] = None,
                 version: Optional[int] = None):
        self.requests = requests
        self.x = x  # bucket-padded
        self.rows = rows  # real rows
        self.tried: set = set()  # replicas that gave up on this batch
        # a generate batch's (lengths, keys, max_new, sampler); None for
        # an output batch
        self.payload = payload
        self.model = model
        self.version = version


_STOP = object()


class _BatchQueue:
    """The formed batches' FIFO. ``_STOP`` pills come out only once no
    batch is left (a batch redispatched after a stop still goes first),
    so workers drain formed work before they exit. The reference keys a
    deficit round robin on the batch's model here; with one net there is
    one key, and that round robin is this FIFO (ROADMAP A10b brings the
    registry's lanes and their weights)."""

    def __init__(self):
        self._cv = threading.Condition()
        self._items: deque = deque()
        self._stops = 0

    def put(self, item) -> None:
        with self._cv:
            if item is _STOP:
                self._stops += 1
            else:
                self._items.append(item)
            self._cv.notify()

    def get(self):
        with self._cv:
            while True:
                if self._items:
                    return self._items.popleft()
                if self._stops:
                    self._stops -= 1
                    return _STOP
                self._cv.wait()

    def get_nowait(self):
        with self._cv:
            if not self._items:
                raise queue.Empty
            return self._items.popleft()

    def qsize(self) -> int:
        with self._cv:
            return len(self._items)


class ParallelInference:
    """Multi-replica micro-batching serving engine for a
    MultiLayerNetwork or a single-input, single-output ComputationGraph.

    ``submit(x)`` with ``x`` [n, ...features] resolves to the [n, ...out]
    rows ``net.output(x)`` returns (masked inputs are not coalescible:
    use ``net.output`` for those).

    Knobs: ``max_batch_size`` / ``max_latency_ms`` bound the coalescing
    window, which holds requests only while every replica is busy
    (``eager_when_idle``); ``queue_capacity`` + ``reject_when_full`` the
    backpressure; ``devices`` the replicas' torch devices (every CUDA
    device by default; on a machine without one, pass ``devices=
    ["cpu"]``), cut to the first ``replicas``; ``buckets`` the row
    ladder; ``coalesce=False`` one dispatch per request, unpadded."""

    def __init__(self, net=None, max_batch_size: int = 32,
                 max_latency_ms: float = 5.0, queue_capacity: int = 256,
                 reject_when_full: bool = False,
                 replicas: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 buckets: Optional[Sequence[int]] = None,
                 coalesce: Optional[bool] = None,
                 eager_when_idle: bool = True, start: bool = True,
                 max_batch_retries: int = 1,
                 probe_interval_ms: float = 50.0,
                 poison_hook=None,
                 registry=None,
                 max_sessions: Optional[int] = None,
                 continuous: bool = False,
                 decode_slots: int = 8,
                 decode_burst: int = 8,
                 kv_block_size: int = 16,
                 kv_blocks: Optional[int] = None,
                 kv_quant: Optional[str] = None,
                 kv_bytes_budget: Optional[int] = None,
                 decode_burst_hook=None,
                 prefix_cache: bool = False,
                 prefix_cache_blocks: Optional[int] = None,
                 speculative: bool = False,
                 draft_net=None,
                 kv_host_blocks: Optional[int] = None,
                 slice_plane=None):
        if registry is not None:
            raise _later("registry= (multi-model serving)")
        if max_sessions is not None:
            raise _later("max_sessions= (decode sessions)")
        if speculative or draft_net is not None:
            raise _later("speculative=/draft_net= (speculative decoding)")
        if kv_host_blocks is not None:
            raise _later("kv_host_blocks= (the host KV tier)")
        if slice_plane is not None:
            raise _later("slice_plane= (mesh-sharded serving)", "A9")
        if net is None:
            raise ValueError("ParallelInference needs a net")
        if net.params is None:
            net.init()
        self.net = net
        self.max_batch_size = int(max_batch_size)
        if self.max_batch_size < 1:
            raise ValueError(
                f"max_batch_size must be >= 1, got {max_batch_size}")
        self.max_latency = max(0.0, float(max_latency_ms)) / 1e3
        self.reject_when_full = bool(reject_when_full)
        if coalesce is None:
            coalesce = net._pad_tail_safe()
        self.coalesce = bool(coalesce)
        self.buckets: Tuple[int, ...] = tuple(sorted(
            buckets if buckets is not None
            else bucket_sizes(self.max_batch_size)))
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ParallelInference places its replicas on every CUDA "
                    "device by default and this machine has none "
                    "(torch.cuda.is_available() is False); pass "
                    "devices=['cpu'] to serve on the CPU")
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        else:
            devs = [resolve_device(d) for d in devices]
        if replicas is not None:
            devs = devs[:max(1, int(replicas))]
        if not devs:
            raise ValueError("no devices to place replicas on")
        if continuous and not same_device(devs[0], net.device):
            raise ValueError(
                f"continuous=True decodes on the first replica's device, "
                f"which must be the net's ({net.device}); got {devs[0]}")
        self._fn = net.infer_output_fn()
        self._np_dtype = np.dtype(_NP_DTYPES.get(net._dtype, np.float32))
        with span("stage", path="infer_replicas", replicas=len(devs)):
            self._replicas = [(d, _place(net.params, d), _place(net.states, d))
                              for d in devs]
        # requests wait out the coalescing window only while every
        # replica is busy: idle capacity dispatches at once
        self.eager_when_idle = bool(eager_when_idle)
        self._inflight = 0  # batches queued or running on a replica
        self._rq: "queue.Queue" = queue.Queue(
            maxsize=max(1, int(queue_capacity)))
        self._bq = _BatchQueue()
        self._closed = False
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self.max_batch_retries = max(0, int(max_batch_retries))
        self.probe_interval = max(1e-3, float(probe_interval_ms)) / 1e3
        self._poison_hook = poison_hook
        self._quarantined: set = set()
        self._probe_wake: Dict[int, threading.Event] = {
            i: threading.Event() for i in range(len(self._replicas))}
        self._stopping = False
        self._probe_shape: Optional[Tuple[int, ...]] = None
        self._fault_log: List[str] = []
        self._rows_dispatched = 0
        self._rows_padded = 0
        # the engine's own windowed series (several engines may share a
        # process): summarized in stats()
        self._ts = TimeSeriesStore()
        self._batches = 0
        self._requests = 0
        self._resolved = 0  # futures delivered (result or error)
        self._warmed = False
        self._started = False
        self._threads: List[threading.Thread] = []
        self.continuous = bool(continuous)
        self.decode_slots = int(decode_slots)
        self.decode_burst = int(decode_burst)
        self.kv_block_size = int(kv_block_size)
        self.kv_blocks = kv_blocks
        self.kv_quant = kv_quant
        self.kv_bytes_budget = kv_bytes_budget
        if (kv_quant is not None or kv_bytes_budget is not None) \
                and not self.continuous:
            raise ValueError(
                "kv_quant=/kv_bytes_budget= size the paged-pool "
                "scheduler: build the engine with continuous=True")
        self._decode_burst_hook = decode_burst_hook
        self.prefix_cache = bool(prefix_cache)
        self.prefix_cache_blocks = prefix_cache_blocks
        if self.prefix_cache and not self.continuous:
            raise ValueError(
                "prefix_cache=True rides the paged-pool scheduler: "
                "build the engine with continuous=True")
        self._scheduler = None
        self._gen = None
        if start:
            self.start()

    # ------------------------------------------------------------ metrics

    def _reg(self):
        return get_registry()

    def _depth_gauge(self):
        return self._reg().gauge(
            INFER_QUEUE_DEPTH_GAUGE,
            "Requests queued awaiting the micro-batch dispatcher")

    # ------------------------------------------------------------- public

    def start(self) -> "ParallelInference":
        if self._started:
            return self
        self._started = True
        t = threading.Thread(target=self._dispatch_loop, daemon=True,
                             name="dl4j-infer-dispatch")
        t.start()
        self._threads = [t]
        for i in range(len(self._replicas)):
            w = threading.Thread(target=self._worker_loop, args=(i,),
                                 daemon=True, name=f"dl4j-infer-w{i}")
            w.start()
            self._threads.append(w)
        if self._scheduler is not None:
            self._scheduler.start()
        return self

    @staticmethod
    def _resolve_model(model: Optional[str], session: Optional[str]):
        """(model, version, coalescible) of a request to the one net."""
        if model is not None:
            raise ValueError(
                "this engine serves one pinned net; model= routing needs "
                "registry= (not ported yet, ROADMAP A10b)")
        if session is not None:
            raise _later("session= (decode sessions)")
        return None, None, True

    def release_session(self, session: str,
                        model: Optional[str] = None) -> None:
        raise _later("release_session (decode sessions)")

    def submit(self, x: np.ndarray, model: Optional[str] = None,
               version: Optional[int] = None,
               session: Optional[str] = None) -> "Future[np.ndarray]":
        """Enqueue one request (``x``: [n, ...features]); the Future
        resolves to the [n, ...out] predictions for exactly those
        rows."""
        if self._closed:
            raise EngineShutdown("ParallelInference is shut down")
        model, v, coalescible = self._resolve_model(model, session)
        x = np.asarray(x, dtype=self._np_dtype)
        if x.ndim < 2:
            raise ValueError(
                f"requests carry their batch dimension: got shape {x.shape}; "
                "a single example must be submitted as x[None, ...]")
        return self._enqueue(_Request(x, model, v, coalescible))

    def _enqueue(self, req: _Request) -> "Future[np.ndarray]":
        try:
            self._rq.put(req, block=not self.reject_when_full)
        except queue.Full:
            raise InferenceBackpressure(
                f"admission queue full ({self._rq.maxsize} requests) and "
                "reject_when_full=True") from None
        with self._lock:
            self._requests += 1
        self._reg().counter(INFER_REQUESTS_COUNTER,
                            "Inference requests submitted to the engine").inc()
        self._depth_gauge().set(self._rq.qsize())
        return req.future

    def output(self, x: np.ndarray, timeout: Optional[float] = None,
               **kwargs) -> np.ndarray:
        """Blocking facade: ``net.output`` through the batching engine."""
        return self.submit(x, **kwargs).result(timeout=timeout)

    # ---------------------------------------------------- generation

    def _generator(self):
        """The net's generator (``nn/generate.py``), built at first use;
        raises on nets with no generation family."""
        if self._gen is None:
            from deeplearning4j_tpu_torch.nn.generate import build_generator
            self._gen = build_generator(self.net)
        return self._gen

    def _continuous_scheduler(self):
        """The engine's iteration-level decode scheduler, built at first
        use (transformer nets only), on the first replica's device: one
        slot batch and one paged KV pool; classification keeps every
        replica."""
        sched = self._scheduler
        if sched is None:
            from deeplearning4j_tpu_torch.serving.continuous import (
                ContinuousDecodeScheduler)
            sched = self._scheduler = ContinuousDecodeScheduler(
                net=self.net,
                slots=self.decode_slots, burst_tokens=self.decode_burst,
                block_size=self.kv_block_size, num_blocks=self.kv_blocks,
                kv_quant=self.kv_quant,
                kv_bytes_budget=self.kv_bytes_budget,
                queue_capacity=self._rq.maxsize,
                burst_hook=self._decode_burst_hook,
                on_resolve=self._note_resolved,
                prefix_cache=self.prefix_cache,
                prefix_cache_blocks=self.prefix_cache_blocks,
                start=self._started)
        return sched

    def submit_generate(self, prompt_ids: np.ndarray, max_new_tokens: int,
                        temperature: float = 0.0, top_k: int = 0,
                        top_p: float = 0.0, eos_token: Optional[int] = None,
                        seed: int = 0, model: Optional[str] = None,
                        version: Optional[int] = None,
                        session: Optional[str] = None,
                        priority: int = 0,
                        on_tokens=None,
                        prefix: Optional[np.ndarray] = None,
                        kv_state=None,
                        hibernate: bool = False
                        ) -> "Future[np.ndarray]":
        """Enqueue one decode request (``prompt_ids``: [n, t0] int
        tokens); the Future resolves to the [n, t0 + max_new_tokens] ids
        a solo ``net.generate`` of the same rows returns. Requests
        coalesce per (prompt bucket, max_new_tokens, sampler); each row
        keeps its own length and key, so coalescing changes no token.

        ``on_tokens(offset, tokens)`` (single-row requests) streams the
        tokens: the continuous scheduler sends a chunk per admission and
        per burst, this whole-run path one terminal chunk when the run
        resolves. ``prefix`` resumes a stream from prompt + generated
        tokens and needs ``continuous=True``."""
        if self._closed:
            raise EngineShutdown("ParallelInference is shut down")
        if hibernate:
            raise _later("hibernate= (session hibernation)")
        if kv_state is not None:
            raise _later("kv_state= (the disaggregated prefill handoff)",
                         "A11")
        from deeplearning4j_tpu_torch.nn.generate import row_keys, sampler_sig
        model, v, coalescible = self._resolve_model(model, session)
        if self.continuous:
            # iteration-level path: admissions and retirements between
            # fixed-K bursts over the paged KV pool
            self._reg().counter(DECODE_REQUESTS_COUNTER,
                                "generate() requests").inc()
            with self._lock:
                self._requests += 1
            try:
                return self._continuous_scheduler().submit(
                    prompt_ids, max_new_tokens, temperature=temperature,
                    top_k=top_k, top_p=top_p, eos_token=eos_token,
                    seed=seed, priority=priority, on_tokens=on_tokens,
                    prefix=prefix)
            except BaseException:
                with self._lock:
                    self._requests -= 1
                raise
        if prefix is not None:
            raise ValueError(
                "prefix resume rides the iteration-level preempt/resume "
                "machinery: build the engine with continuous=True")
        gen = self._generator()
        prompt = np.asarray(prompt_ids)
        if prompt.ndim != 2:
            raise ValueError(
                f"prompt_ids must be [n, t0] int tokens, got {prompt.shape}")
        n, t_in = prompt.shape
        if on_tokens is not None and n != 1:
            raise ValueError(
                f"token streaming is per-stream: prompt must be [1, t0], "
                f"got {prompt.shape}")
        max_new = int(max_new_tokens)
        t_pad = gen.prompt_bucket(t_in, max_new)
        ids = np.zeros((n, t_pad), np.int64)
        ids[:, :t_in] = prompt
        lengths = np.full((n,), t_in, np.int64)
        keys = np.asarray(row_keys(seed, n), np.int64)
        self._reg().counter(DECODE_REQUESTS_COUNTER,
                            "generate() requests").inc()
        fut = self._enqueue(_GenRequest(
            ids, lengths, keys, t_in, max_new,
            sampler_sig(temperature, top_k, top_p, eos_token),
            model, v, coalescible))
        if on_tokens is not None:
            # the whole run's tokens exist only when it resolves: one
            # terminal chunk
            def _emit(f, t0=t_in):
                if f.exception() is not None:
                    return
                self._reg().counter(
                    STREAM_CHUNKS_COUNTER,
                    "Incremental decode-token chunks emitted through "
                    "the on_tokens streaming seam").inc()
                try:
                    on_tokens(0, np.asarray(f.result())[0, t0:]
                              .astype(np.int64))
                except Exception as e:
                    # the consumer's error; the Future carries every token
                    mark("stream_callback_error", error=type(e).__name__)
            fut.add_done_callback(_emit)
        return fut

    def generate(self, prompt_ids: np.ndarray, max_new_tokens: int,
                 timeout: Optional[float] = None, **kwargs) -> np.ndarray:
        """Blocking facade over :meth:`submit_generate`."""
        return self.submit_generate(prompt_ids, max_new_tokens,
                                    **kwargs).result(timeout=timeout)

    # --------------------------------------------- left for later slices

    def hibernate_export(self, session: str) -> Optional[Dict]:
        raise _later("hibernate_export (session hibernation)")

    def hibernate_import(self, session: str, blocks, covered: int, tokens,
                         model: Optional[str] = None,
                         version: Optional[int] = None, prompt=None,
                         generated=None) -> bool:
        raise _later("hibernate_import (session hibernation)")

    def hibernate_release(self, session: str) -> bool:
        raise _later("hibernate_release (session hibernation)")

    def hibernated_count(self) -> int:
        """Hibernated sessions: none until hibernation is ported."""
        return 0

    def prefill_export(self, prompt_ids: np.ndarray) -> Dict:
        raise _later("prefill_export (disaggregated prefill)", "A11")

    def warmup_prefill(self, prompt_lengths: Sequence[int]) -> int:
        raise _later("warmup_prefill (the prefill export's ladder)", "A11")

    def warmup_model(self, model: str, version: Optional[int] = None,
                     shapes: Optional[Sequence[Tuple[int, ...]]] = None
                     ) -> int:
        raise _later("warmup_model (multi-model serving)")

    # ----------------------------------------------------------- warmup

    def warmup_generate(self, prompt_lengths: Sequence[int],
                        max_new_tokens: int, temperature: float = 0.0,
                        top_k: int = 0, top_p: float = 0.0,
                        eos_token: Optional[int] = None,
                        model: Optional[str] = None,
                        version: Optional[int] = None,
                        tail_lengths=None) -> int:
        """Run the decode program set once: for every prompt bucket
        covering ``prompt_lengths``, a zero-prompt batch of every row
        bucket on every replica (prefill + decode); with
        ``continuous=True``, the scheduler's own ``warmup``. Returns the
        first dispatches it made; serving within the covered set after
        it makes none (``dl4j_jit_cache_miss_total``)."""
        from deeplearning4j_tpu_torch.nn.generate import row_keys, sampler_sig
        if model is not None:
            raise ValueError("model= needs a registry-mode engine "
                             "(not ported yet, ROADMAP A10b)")
        reg = self._reg()
        before = reg.family_total(JIT_CACHE_MISS_COUNTER)
        if self.continuous:
            self._continuous_scheduler().warmup(
                prompt_lengths, int(max_new_tokens),
                tail_lengths=tail_lengths)
            return int(reg.family_total(JIT_CACHE_MISS_COUNTER) - before)
        gen = self._generator()
        sampler = sampler_sig(temperature, top_k, top_p, eos_token)
        max_new = int(max_new_tokens)
        sizes = self.buckets if self.coalesce else (1,)
        done = set()
        for t_in in prompt_lengths:
            t_pad = gen.prompt_bucket(int(t_in), max_new)
            for rows in sizes:
                if (t_pad, rows) in done:
                    continue
                done.add((t_pad, rows))
                ids = np.zeros((rows, t_pad), np.int64)
                lengths = np.full((rows,), min(int(t_in), t_pad), np.int64)
                keys = row_keys(0, rows)
                for i, (dev, params, _) in enumerate(self._replicas):
                    with span("stage", path="warmup_generate", bucket=t_pad,
                              rows=rows, replica=i):
                        gen.run(params, ids, lengths, max_new, sampler,
                                keys, replica=i, device=dev)
        self._warmed = True
        return int(reg.family_total(JIT_CACHE_MISS_COUNTER) - before)

    def warmup(self, shapes: Sequence[Tuple[int, ...]]) -> int:
        """Dispatch a zero batch of every bucket size for every
        per-example ``shape`` on every replica (in turn, each waited
        for). Returns the first dispatches among them; serving any
        request mix within the bucket set after it makes none."""
        sizes = self.buckets if self.coalesce else (1,)
        compiled = 0
        for shape in shapes:
            for b in sizes:
                zeros = np.zeros((b,) + tuple(shape), self._np_dtype)
                for i, (dev, params, states) in enumerate(self._replicas):
                    x = torch.as_tensor(zeros, device=dev)
                    fresh = note_dispatch(
                        self.net, self._dispatch_sig(i, zeros.shape))
                    with span("compile" if fresh else "inference",
                              path="warmup", bucket=b, replica=i):
                        _host(self._fn(params, states, x, None))
                    compiled += int(fresh)
            with self._lock:
                # a warmed shape is also the quarantine probe's
                self._probe_shape = tuple(shape)
        self._warmed = True
        return compiled

    @property
    def timeseries(self) -> TimeSeriesStore:
        """This engine's own windowed series (batch fill ratio,
        first-dispatch rate)."""
        return self._ts

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            rows, padded = self._rows_dispatched, self._rows_padded
            quarantined = sorted(self._quarantined)
            out = {
                "requests": self._requests,
                "resolved": self._resolved,
                "batches": self._batches,
                "rows_dispatched": rows,
                "rows_padded": padded,
                "padded_ratio": (padded / rows) if rows else 0.0,
                "queue_depth": self._rq.qsize(),
                "inflight": self._inflight,
                "replicas": len(self._replicas),
                "buckets": list(self.buckets),
                "coalesce": self.coalesce,
                "quarantined": quarantined,
                "healthy_replicas": len(self._replicas) - len(quarantined),
                "degraded": bool(quarantined),
                "warmed": self._warmed,
                "faults": len(self._fault_log),
            }
        if timeseries_enabled():
            out["timeseries"] = self._ts.summary()
        if self.continuous:
            out["scheduler"] = (
                self._scheduler.stats() if self._scheduler is not None
                else {"warmed": False, "active_sequences": 0,
                      "queued_prefills": 0, "pool": {}})
        return out

    def drain(self, timeout: Optional[float] = None,
              poll_s: float = 2e-3) -> bool:
        """Block until every accepted request has resolved, without
        stopping the engine. False when ``timeout`` passes first."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                # resolved vs accepted: a request inside the coalescing
                # window is in no queue, and not resolved either
                idle = self._resolved >= self._requests
            if idle:
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)

    def _note_resolved(self, n: int) -> None:
        with self._lock:
            self._resolved += n

    def probe_now(self) -> None:
        """Wake every quarantined replica's probe at once instead of
        after ``probe_interval_ms``."""
        for ev in self._probe_wake.values():
            ev.set()

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop accepting work; drain (default) or cancel what is queued,
        join the threads, then re-raise the first worker error (which
        every affected Future also carries)."""
        if self._closed:
            return
        self._closed = True
        if self._scheduler is not None:
            self._scheduler.shutdown(drain=drain and self._started,
                                     timeout=timeout)
        if not self._started:
            # never ran: resolve queued futures so no caller hangs
            self._drain_cancel()
            return
        if not drain:
            self._drain_cancel()
        self._rq.put(_STOP)
        for t in self._threads:
            t.join(timeout)
        # a batch redispatched in the shutdown race can outlive every
        # worker: its futures still resolve
        while True:
            try:
                b = self._bq.get_nowait()
            except queue.Empty:
                break
            if isinstance(b, _Batch):
                err = self._error or RuntimeError(
                    "ParallelInference shut down before dispatch")
                for r in b.requests:
                    if not r.future.done():
                        r.future.set_exception(err)
                        self._note_resolved(1)
        if self._error is not None:
            raise self._error

    def __enter__(self) -> "ParallelInference":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # an exception in flight is not masked by a worker error
        try:
            self.shutdown()
        except BaseException:
            if exc_type is None:
                raise

    def _drain_cancel(self):
        err = RuntimeError("ParallelInference shut down before dispatch")
        while True:
            try:
                item = self._rq.get_nowait()
            except queue.Empty:
                return
            if isinstance(item, _Request):
                item.future.set_exception(err)
                self._note_resolved(1)

    # --------------------------------------------------------- dispatcher

    def _dispatch_sig(self, replica: int, shape: Tuple[int, ...],
                      model: Optional[str] = None,
                      version: Optional[int] = None) -> Tuple:
        """The first-dispatch signature of one replica dispatch: program
        kind, operand shape and dtype, replica (each device builds and
        tunes its own), model version."""
        return ("infer_output", replica, tuple(shape),
                str(self._np_dtype), model, version)

    def _dispatch_loop(self):
        pending: Dict[Tuple, List[_Request]] = {}
        oldest: Dict[Tuple, float] = {}

        def flush(sig):
            reqs = pending.pop(sig)
            oldest.pop(sig, None)
            self._bq.put(self._form_batch(reqs))

        def idle_capacity() -> bool:
            with self._lock:
                healthy = len(self._replicas) - len(self._quarantined)
                return self._inflight < healthy

        while True:
            timeout = None
            if oldest:
                timeout = max(1e-4, min(oldest.values()) + self.max_latency
                              - time.perf_counter())
            try:
                item = self._rq.get(timeout=timeout)
            except queue.Empty:
                item = None
            if item is _STOP:
                # a submit racing shutdown may sit behind the pill: it
                # is drained too, so no accepted future strands
                while True:
                    try:
                        late = self._rq.get_nowait()
                    except queue.Empty:
                        break
                    if isinstance(late, _Request):
                        pending.setdefault(late.sig(), []).append(late)
                for sig in list(pending):
                    flush(sig)
                # workers finish what is queued and exit on their pill;
                # quarantined ones from their probe wait (woken here)
                self._stopping = True
                for _ in self._replicas:
                    self._bq.put(_STOP)
                for ev in self._probe_wake.values():
                    ev.set()
                return
            if item is not None:
                self._depth_gauge().set(self._rq.qsize())
                if not self.coalesce or not item.coalescible \
                        or item.n >= self.max_batch_size:
                    # INPLACE mode, a batch-statistics net or an
                    # oversized request: a batch of its own
                    self._bq.put(self._form_batch([item]))
                else:
                    sig = item.sig()
                    group = pending.setdefault(sig, [])
                    if not group:
                        oldest[sig] = time.perf_counter()
                    group.append(item)
                    if sum(r.n for r in group) >= self.max_batch_size:
                        flush(sig)
                    elif (self.eager_when_idle and self._rq.empty()
                          and idle_capacity()):
                        # an idle replica beats a fuller batch
                        flush(sig)
            now = time.perf_counter()
            for sig in [s for s, t0 in oldest.items()
                        if now - t0 >= self.max_latency]:
                flush(sig)

    def _form_batch(self, reqs: List[_Request]) -> _Batch:
        rows = sum(r.n for r in reqs)
        x = reqs[0].x if len(reqs) == 1 else np.concatenate(
            [r.x for r in reqs], axis=0)
        payload = None
        pad_ok = self.coalesce and reqs[0].coalescible
        if isinstance(reqs[0], _GenRequest):
            # a decode batch: each row's length and key ride along; a
            # padding row has length 0 (its tokens are dropped)
            lengths = np.concatenate([r.lengths for r in reqs])
            keys = np.concatenate([r.keys for r in reqs], axis=0)
            if pad_ok:
                pad = bucket_for(rows, self.buckets) - rows
                x = pad_rows(x, pad)
                lengths = pad_rows(lengths, pad)
                keys = pad_rows(keys, pad)
            payload = (lengths, keys, reqs[0].max_new, reqs[0].sampler)
        elif pad_ok:
            x = pad_rows(x, bucket_for(rows, self.buckets) - rows)
        with self._lock:
            self._inflight += 1  # until delivered or failed
            self._batches += 1
            self._rows_dispatched += x.shape[0]
            self._rows_padded += x.shape[0] - rows
            ratio = self._rows_padded / self._rows_dispatched
        reg = self._reg()
        reg.counter(INFER_BATCHES_COUNTER,
                    "Micro-batches dispatched to the replicas").inc()
        reg.histogram(INFER_BATCH_SIZE_HISTOGRAM,
                      "Rows per dispatched micro-batch (after padding)",
                      buckets=INFER_BATCH_SIZE_BUCKETS).observe(x.shape[0])
        reg.gauge(INFER_PADDED_RATIO_GAUGE,
                  "Cumulative fraction of dispatched rows that were bucket "
                  "padding").set(ratio)
        if timeseries_enabled():
            self._ts.record(TS_ENGINE_FILL_RATIO, rows / x.shape[0])
        return _Batch(reqs, x, rows, payload,
                      model=reqs[0].model, version=reqs[0].version)

    # ------------------------------------------------------------ workers

    def _hook(self, idx: int, shape) -> None:
        """The fault-injection seam: ``poison_hook(replica, shape)``
        raises in place of the device."""
        if self._poison_hook is not None:
            self._poison_hook(idx, shape)

    def _dispatch(self, idx: int, params, states, x: torch.Tensor):
        self._hook(idx, tuple(x.shape))
        return self._fn(params, states, x, None)

    def _worker_loop(self, idx: int):
        dev, params, states = self._replicas[idx]
        lat = self._reg().histogram(
            INFER_LATENCY_HISTOGRAM,
            "Per-request submit-to-result latency")
        wake = self._probe_wake[idx]
        while True:
            if idx in self._quarantined:
                wake.wait(self.probe_interval)
                wake.clear()
                if self._stopping:
                    return
                self._probe(idx, dev, params, states)
                continue
            b = self._bq.get()
            if b is _STOP:
                return
            err = self._run_batch(idx, dev, params, states, b, lat)
            if err is not None:
                self._quarantine(idx, b, err)

    def _run_batch(self, idx, dev, params, states, b: _Batch, lat):
        """Run one batch within the replica's retry budget. None when
        its futures resolved, else the last error (the batch is still
        unresolved: the caller quarantines and redispatches)."""
        last: Optional[BaseException] = None
        for attempt in range(1 + self.max_batch_retries):
            t_disp = time.perf_counter()
            try:
                if b.payload is not None:
                    # a decode batch: prefill + decode on this replica's
                    # parameters, its tokens fetched once
                    lengths, keys, max_new, sampler = b.payload
                    self._hook(idx, b.x.shape)
                    y = self._generator().run(
                        params, b.x, lengths, max_new, sampler,
                        [int(k) for k in keys], replica=idx, device=dev)
                else:
                    with span("stage", path="infer_feed", replica=idx):
                        x = torch.as_tensor(b.x, device=dev)
                    fresh = note_dispatch(
                        self.net, self._dispatch_sig(idx, b.x.shape))
                    if timeseries_enabled():
                        # the share of serving dispatches that were a
                        # signature's first (steady state: 0.0)
                        self._ts.record(TS_ENGINE_JIT_MISS,
                                        1.0 if fresh else 0.0)
                    with span("compile" if fresh else "inference",
                              path="parallel_inference", replica=idx,
                              rows=b.rows, batch=int(b.x.shape[0])):
                        # the batch's one wait on the card
                        y = _host(self._dispatch(idx, params, states, x))
            except Exception as e:
                last = e
                record_fault("serving")
                self._fault_log.append(
                    f"replica {idx} attempt {attempt + 1}: "
                    f"{type(e).__name__}: {e}")
                continue
            if b.payload is None:
                with self._lock:
                    self._probe_shape = tuple(b.x.shape[1:])
            off = 0
            now = time.perf_counter()
            for r in b.requests:
                if r.trace is not None:
                    # the request's admission wait and the dispatch it
                    # rode, from timestamps the path takes anyway
                    # (recorded before its future resolves)
                    reqtrace.record_span(
                        r.trace, "engine_queue", to_origin_us(r.t_submit),
                        (t_disp - r.t_submit) * 1e6, replica=idx)
                    reqtrace.record_span(
                        r.trace, "engine_dispatch", to_origin_us(t_disp),
                        (now - t_disp) * 1e6, replica=idx, rows=b.rows,
                        batch=int(b.x.shape[0]),
                        kind="generate" if b.payload is not None
                        else "classify")
                r.future.set_result(r.finish(y[off:off + r.n]))
                off += r.n
                lat.observe((now - r.t_submit) * 1e3)
            with self._lock:
                self._inflight -= 1
                self._resolved += len(b.requests)
            return None
        return last

    # -------------------------------------------- quarantine + probing

    def _quarantined_gauge(self):
        return self._reg().gauge(
            FAULT_QUARANTINED_GAUGE,
            "Serving replicas currently quarantined after device errors")

    def _quarantine(self, idx: int, b: _Batch, err: BaseException) -> None:
        """Pull replica ``idx`` out of the pool and hand its batch to a
        survivor; when every replica gave up on the batch (or none
        survives), fail its futures: a future never strands."""
        with self._lock:
            self._quarantined.add(idx)
            n_quarantined = len(self._quarantined)
            survivors = [i for i in range(len(self._replicas))
                         if i not in self._quarantined and i not in b.tried]
        self._quarantined_gauge().set(n_quarantined)
        mark("replica_quarantined", replica=idx, error=type(err).__name__)
        reqtrace.flight_event("quarantine", replica=idx,
                              error=type(err).__name__)
        b.tried.add(idx)
        if survivors and not self._stopping:
            self._bq.put(b)
            return
        failed = 0
        for r in b.requests:
            if not r.future.done():
                r.future.set_exception(err)
                failed += 1
        if self._error is None:
            self._error = err
        with self._lock:
            self._inflight -= 1
            self._resolved += failed

    def _probe(self, idx: int, dev, params, states) -> None:
        """Reinstatement probe: a one-row dispatch of the last shape
        served on the quarantined replica; it rejoins the pool when it
        passes. With no shape served yet there is nothing to probe with:
        the replica rejoins, and real traffic quarantines it again if it
        is still sick."""
        with self._lock:
            shape = self._probe_shape
        if shape is not None:
            try:
                zeros = np.zeros((1,) + tuple(shape), self._np_dtype)
                x = torch.as_tensor(zeros, device=dev)
                note_dispatch(self.net, self._dispatch_sig(idx, zeros.shape))
                with span("inference", path="quarantine_probe", replica=idx):
                    _host(self._dispatch(idx, params, states, x))
            except Exception as e:
                record_fault("serving")
                self._fault_log.append(
                    f"replica {idx} probe: {type(e).__name__}: {e}")
                return  # still sick: stays quarantined
        with self._lock:
            self._quarantined.discard(idx)
            n_quarantined = len(self._quarantined)
        self._quarantined_gauge().set(n_quarantined)
        mark("replica_reinstated", replica=idx)
