"""Unified telemetry: one registry, one clock, many consumers.

Counterpart of ``deeplearning4j_tpu/monitor/``, with every metric
family name, label and help text of the JAX package, so that one
scraper, dashboard and schema check read both. The pieces:

- :mod:`registry` — process-wide counters/gauges/histograms with
  Prometheus text exposition (``get_registry().prometheus_text()``,
  what a ``/metrics`` endpoint serves);
- :mod:`tracing` — ``span("device_step")`` phase spans against one
  monotonic clock, JSONL events and Chrome ``trace_event`` export
  (Perfetto, beside ``util/profiler.py``'s ``torch.profiler`` traces);
- :mod:`step_health` — the NaN/Inf and slow-step watchdog on the
  listener chain;
- :mod:`timeseries` — windowed time series of sampled gauges;
- :mod:`reqtrace` — per-request traces and the flight recorder.

Canonical span names threaded through the paths: ``data_load`` (a
batch made tensors for the step), ``stage`` (host-to-device staging),
``compile`` (the first dispatch of a new signature: a program kind with
its operand shapes and dtypes; on the card the dispatch that builds and
autotunes kernels), ``device_step`` (a train step), ``all_reduce``,
``checkpoint``, ``eval``, ``broadcast``, ``inference``, ``score_sync``
(the deferred-score ring's one batched fetch). Spans time the host:
around an eager step they time its enqueue (:mod:`tracing`).
``scripts/check_telemetry_schema.py`` validates the emitted streams.
The families of planes the port has no producer for yet (the serving
engine, router, prefix cache, mesh and wire: ROADMAP A9-A11) are named
here already, so that each name keeps one meaning when they land.

The device-feed pipeline (datasets/iterators.py + the fit() paths)
publishes these counters and gauges, so that a run can attribute
per-step fit() throughput to host-side stalls:
``dl4j_feed_h2d_bytes_total`` (host→device staging traffic),
``dl4j_feed_queue_depth`` (batches staged on device, awaiting the step
loop), ``dl4j_feed_padded_batches_total`` (ragged tail batches padded
to the canonical shape), ``dl4j_jit_cache_miss_total`` (train-step
dispatches of a new signature), ``dl4j_score_sync_total``
(device→host score fetches — each one waits on the card).

The serving plane (parallel/inference.py ``ParallelInference``)
publishes ``dl4j_infer_requests_total`` / ``dl4j_infer_batches_total``
(request vs dispatched-batch volume — their ratio is the coalescing
factor), ``dl4j_infer_batch_size`` (rows per dispatched batch, padding
included), ``dl4j_infer_queue_depth`` (admission-queue backlog),
``dl4j_infer_padded_ratio`` (cumulative fraction of dispatched rows
that were bucket padding), and ``dl4j_infer_latency_ms`` (per-request
submit→result latency). ``dl4j_jit_cache_miss_total`` is shared with
the training plane: a serve-loop dispatch of a new signature ticks it
too, which is how the AOT ``warmup()`` contract is asserted.

The continuous-batching plane (serving/continuous.py +
nn/kvpool.py) publishes ``dl4j_kvpool_blocks_total`` /
``dl4j_kvpool_blocks_free`` / ``dl4j_kvpool_alloc_failures_total``
(paged KV pool occupancy and exhaustion) and the ``dl4j_sched_*``
family (rows admitted/retired between bursts, preemptions, burst
count + latency histogram, active-sequence and queued-prefill gauges)
— the iteration-level decode scheduler's health at a glance. The
cross-request prefix cache (serving/prefixcache.py) adds the
``dl4j_prefixcache_*`` family: hit/miss/eviction/copy-on-write
counters, cached/shared block gauges, and the prompt tokens whose
prefill was skipped because their KV blocks were already cached.

The horizontal serving tier (serving/router.py ``InferenceRouter``)
publishes ``dl4j_router_requests_total`` (by ``priority`` class),
``dl4j_router_shed_total`` (deadline-admission rejections — shed beats
queueing past the SLO), ``dl4j_router_hedges_total`` /
``dl4j_router_failovers_total`` (tail-latency duplicates and
post-failure re-dispatches to another endpoint),
``dl4j_router_queue_wait_ms`` (the admission-time queue-wait estimate
the deadline decision used), ``dl4j_router_latency_ms`` (end-to-end
submit→result), and ``dl4j_router_endpoint_healthy`` (per-``endpoint``
gauge: 1 in the dispatch pool, 0 ejected or dead).

The fault-tolerance plane publishes ``dl4j_fault_events_total`` (by
``domain``: checkpoint/training/serving/transport),
``dl4j_fault_rollbacks_total`` (supervisor divergence rollbacks),
``dl4j_fault_quarantined_replicas`` (serving replicas currently out),
``dl4j_fault_dead_letter_total`` (poison messages routed to DLQs), and
``dl4j_fault_checkpoint_integrity_failures_total`` (restores that hit a
torn/checksum-bad unit) — a healthy fleet holds all of them at zero,
and any nonzero value names the recovery path that ran.

The mesh plane (parallel/mesh.py ``MeshPlane``) publishes
``dl4j_mesh_devices`` / ``dl4j_mesh_axis_size{axis}`` (the active
named-axis topology — what ``/healthz`` also reports) and
``dl4j_mesh_restore_relayouts_total`` (checkpoint restores that
re-lowered saved shards onto a different mesh shape).

The generation plane (nn/generate.py fused autoregressive decode)
publishes ``dl4j_decode_requests_total``,
``dl4j_decode_prefill_tokens_total`` / ``dl4j_decode_tokens_total``
(prompt tokens prefilled vs tokens sampled), and the
``dl4j_decode_prefill_latency_ms`` / ``dl4j_decode_latency_ms``
dispatch-latency histograms.
"""

# Device-feed pipeline metric family names (one name, one meaning —
# scripts/check_telemetry_schema.py pins these against drift).
H2D_BYTES_COUNTER = "dl4j_feed_h2d_bytes_total"
FEED_QUEUE_DEPTH_GAUGE = "dl4j_feed_queue_depth"
FEED_PADDED_BATCHES_COUNTER = "dl4j_feed_padded_batches_total"
JIT_CACHE_MISS_COUNTER = "dl4j_jit_cache_miss_total"
SCORE_SYNC_COUNTER = "dl4j_score_sync_total"

# Serving plane (parallel/inference.py ParallelInference — the
# micro-batching engine behind StreamingInference): request/batch
# volume, coalescing quality (batch size distribution, padded-row
# ratio), admission-queue depth, and per-request submit→result latency.
INFER_REQUESTS_COUNTER = "dl4j_infer_requests_total"
INFER_BATCHES_COUNTER = "dl4j_infer_batches_total"
INFER_BATCH_SIZE_HISTOGRAM = "dl4j_infer_batch_size"
INFER_QUEUE_DEPTH_GAUGE = "dl4j_infer_queue_depth"
INFER_PADDED_RATIO_GAUGE = "dl4j_infer_padded_ratio"
INFER_LATENCY_HISTOGRAM = "dl4j_infer_latency_ms"

# Bucket bounds for dl4j_infer_batch_size (rows per dispatched batch).
INFER_BATCH_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                            256.0, 512.0, 1024.0)

# Autoregressive generation plane (nn/generate.py fused decode engine,
# served via ParallelInference.submit_generate): request volume, prompt
# tokens prefilled vs tokens decoded (their ratio is the prompt/decode
# balance of the workload), and the two dispatch latencies — prefill
# (one batched prompt forward, bucketed lengths) and decode (ALL of
# max_new_tokens, timed by CUDA events on the card). dl4j_jit_cache_miss_total
# is shared: a generate dispatch of a new signature ticks it, which
# is how the bucketed-prefill single-compile and AOT warmup contracts
# are asserted.
DECODE_REQUESTS_COUNTER = "dl4j_decode_requests_total"
DECODE_PREFILL_TOKENS_COUNTER = "dl4j_decode_prefill_tokens_total"
DECODE_TOKENS_COUNTER = "dl4j_decode_tokens_total"
DECODE_PREFILL_LATENCY_HISTOGRAM = "dl4j_decode_prefill_latency_ms"
DECODE_LATENCY_HISTOGRAM = "dl4j_decode_latency_ms"

# Continuous batching plane (serving/continuous.py
# ContinuousDecodeScheduler + nn/kvpool.py PagedKVCachePool): paged
# KV-cache pool occupancy (allocatable blocks, free blocks — both
# labeled ``pool=``) and exhaustion (allocations that found no free
# block: the scheduler's preempt-or-shed trigger), and the
# iteration-level decode scheduler — sequences admitted into / retired
# from batch slots between bursts, preemptions (victim freed + re-queued
# with its prompt + generated prefix), burst dispatches and their
# latency histogram, plus live gauges for active sequences and queued
# prefills. dl4j_jit_cache_miss_total is shared: a burst dispatch that
# has a new signature ticks it, which is how the fixed-(slots × K)-shape
# zero-steady-state-compile contract is asserted.
KVPOOL_BLOCKS_TOTAL_GAUGE = "dl4j_kvpool_blocks_total"
KVPOOL_BLOCKS_FREE_GAUGE = "dl4j_kvpool_blocks_free"
KVPOOL_ALLOC_FAILURES_COUNTER = "dl4j_kvpool_alloc_failures_total"
SCHED_ADMITTED_COUNTER = "dl4j_sched_admitted_rows_total"
SCHED_RETIRED_COUNTER = "dl4j_sched_retired_rows_total"
SCHED_PREEMPTIONS_COUNTER = "dl4j_sched_preemptions_total"
SCHED_BURSTS_COUNTER = "dl4j_sched_bursts_total"
SCHED_BURST_LATENCY_HISTOGRAM = "dl4j_sched_burst_latency_ms"
SCHED_ACTIVE_GAUGE = "dl4j_sched_active_sequences"
SCHED_QUEUED_GAUGE = "dl4j_sched_queued_prefills"

# Cross-request prefix cache (serving/prefixcache.py PrefixCache over
# the refcounted paged pool): admission probes that matched a cached
# block-aligned prefix (hits) vs found nothing (misses), deterministic
# LRU evictions of cached-but-unreferenced blocks, copy-on-write block
# duplications (a writer's refcount>1 partial tail block copied before
# its scatter lands), live gauges for blocks the cache holds pinned and
# blocks currently shared by more than one holder, and the cumulative
# prompt tokens whose prefill was SKIPPED because their K/V was already
# cached — the prefill-FLOP savings the bench reports.
PREFIXCACHE_HITS_COUNTER = "dl4j_prefixcache_hits_total"
PREFIXCACHE_MISSES_COUNTER = "dl4j_prefixcache_misses_total"
PREFIXCACHE_EVICTIONS_COUNTER = "dl4j_prefixcache_evictions_total"
PREFIXCACHE_COW_COPIES_COUNTER = "dl4j_prefixcache_cow_copies_total"
PREFIXCACHE_CACHED_BLOCKS_GAUGE = "dl4j_prefixcache_cached_blocks"
PREFIXCACHE_SHARED_BLOCKS_GAUGE = "dl4j_prefixcache_shared_blocks"
PREFIXCACHE_SAVED_TOKENS_COUNTER = \
    "dl4j_prefixcache_saved_prefill_tokens_total"
PREFIXCACHE_DEMOTIONS_COUNTER = "dl4j_prefixcache_demotions_total"

# KV tiering plane (nn/kvpool.py host-RAM tier + serving/continuous.py
# hibernation): block contents moved device→host (swap-outs: preempted
# victims, end-of-turn hibernations, prefix-cache demotions) and
# host→device (swap-ins: resumed sessions restoring without a
# re-prefill), prefix-cache blocks demoted to the host tier instead of
# dropped, sessions hibernated into durable handles at end-of-turn,
# session restores by ``path=`` (host = local swap-in / ship = v4
# raw-segment cross-endpoint / journal = prefix re-prefill fallback),
# the live host-tier occupancy gauge (``pool=``), and the per-block
# swap latency histogram (``dir=out|in``) that feeds the measured
# H2D-vs-recompute resume crossover.
KVTIER_SWAP_OUT_COUNTER = "dl4j_kvtier_swap_out_total"
KVTIER_SWAP_IN_COUNTER = "dl4j_kvtier_swap_in_total"
KVTIER_DEMOTIONS_COUNTER = "dl4j_kvtier_demotions_total"
KVTIER_HIBERNATED_COUNTER = "dl4j_kvtier_hibernated_sessions_total"
KVTIER_RESTORE_COUNTER = "dl4j_kvtier_restore_total"
KVTIER_HOST_BLOCKS_GAUGE = "dl4j_kvtier_host_blocks"
KVTIER_SWAP_LATENCY_HISTOGRAM = "dl4j_kvtier_swap_latency_ms"

# Horizontal serving tier (serving/router.py InferenceRouter — the
# fleet-level plane above ParallelInference): request volume by
# priority class, deadline sheds (admission control rejected with
# RetryAfter rather than queueing past the SLO), hedged dispatches
# (duplicate sent to a second endpoint after the hedge threshold),
# failovers (request re-dispatched to a different endpoint after an
# endpoint error/timeout), the admission-time queue-wait estimate and
# the end-to-end submit→result latency, and a per-endpoint health
# gauge (1 healthy / 0 ejected-or-dead).
ROUTER_REQUESTS_COUNTER = "dl4j_router_requests_total"
ROUTER_SHED_COUNTER = "dl4j_router_shed_total"
ROUTER_HEDGES_COUNTER = "dl4j_router_hedges_total"
ROUTER_FAILOVERS_COUNTER = "dl4j_router_failovers_total"
ROUTER_QUEUE_WAIT_HISTOGRAM = "dl4j_router_queue_wait_ms"
ROUTER_LATENCY_HISTOGRAM = "dl4j_router_latency_ms"
ROUTER_ENDPOINT_HEALTHY_GAUGE = "dl4j_router_endpoint_healthy"

# Wire/transport data plane (serving/wire.py + serving/router.py's
# event-loop core): frames and payload bytes packed for the broker
# channel labeled by framing (``transport="legacy"`` = u32+JSON+npz,
# ``transport="v4"`` = binary prologue + raw zero-copy tensor
# segments), per-stream token deltas that rode a COALESCED v4 burst
# frame instead of a frame of their own (the one-frame-per-burst-
# per-endpoint collapse), and the router reactor's timer-loop lag —
# how late hedge timers / wedge ticks / journal refreshes fire behind
# their shared single-thread clock (the event-loop backpressure
# signal; surfaced in ``fleet_snapshot()``).
WIRE_FRAMES_COUNTER = "dl4j_wire_frames_total"
WIRE_BYTES_COUNTER = "dl4j_wire_bytes_total"
WIRE_COALESCED_COUNTER = "dl4j_wire_coalesced_chunks_total"
ROUTER_LOOP_LAG_HISTOGRAM = "dl4j_router_loop_lag_ms"

# Durable decode streams (the stream/journal/migration plane):
# incremental token chunks emitted by the decode path (the
# ``on_tokens`` seam — scheduler bursts, whole-burst terminal deltas),
# decode-session migrations by ``reason`` (timeout / burst_error /
# endpoint_error / wedged / drain / endpoint_lost — the router re-pins
# the stream and re-submits prompt + received prefix as a resume
# request), the live byte size of the router's per-stream token
# journals (what a migration would re-prefill), and the cumulative
# prefix tokens re-submitted by migrations (the resume cost: prefix
# re-prefill instead of full re-generation).
STREAM_CHUNKS_COUNTER = "dl4j_stream_chunks_total"
SESSION_MIGRATIONS_COUNTER = "dl4j_session_migrations_total"
SESSION_JOURNAL_BYTES_GAUGE = "dl4j_session_journal_bytes"
ROUTER_RESUME_PREFIX_COUNTER = "dl4j_router_resume_prefix_tokens_total"

# Multi-model serving plane (serving/registry.py ModelRegistry + the
# multi-model ParallelInference): per-model request/error volume and
# latency (labeled ``model=``), lifecycle events — deploys by
# ``outcome`` (accepted / rejected-corrupt / canary), rollbacks by
# ``reason`` (manual / canary_error_rate / canary_nan / canary_p99 /
# breaker), device-memory-budget evictions — plus three gauges: the
# active version per model, the per-model circuit breaker (1 = open:
# the model is quarantined and probed without touching its cotenants),
# and the bytes of device-pinned parameters the registry accounts
# against its memory budget.
MODEL_REQUESTS_COUNTER = "dl4j_model_requests_total"
MODEL_ERRORS_COUNTER = "dl4j_model_errors_total"
MODEL_LATENCY_HISTOGRAM = "dl4j_model_latency_ms"
MODEL_DEPLOYS_COUNTER = "dl4j_model_deploys_total"
MODEL_ROLLBACKS_COUNTER = "dl4j_model_rollbacks_total"
MODEL_EVICTIONS_COUNTER = "dl4j_model_evictions_total"
MODEL_ACTIVE_VERSION_GAUGE = "dl4j_model_active_version"
MODEL_BREAKER_OPEN_GAUGE = "dl4j_model_breaker_open"
MODEL_PINNED_BYTES_GAUGE = "dl4j_model_pinned_bytes"

# Mesh plane (parallel/mesh.py MeshPlane — the named-axis GSPMD mesh
# every multi-chip path shares): device count and per-axis size of the
# active plane (``axis=`` label: data/fsdp/tp/seq/pp), and the count of
# checkpoint restores that had to RE-LOWER saved shards onto a
# different mesh shape (the mesh-portability path — save-on-8 /
# restore-on-4 — running in production; zero on a stable topology).
MESH_DEVICES_GAUGE = "dl4j_mesh_devices"
MESH_AXIS_SIZE_GAUGE = "dl4j_mesh_axis_size"
MESH_RESTORE_RELAYOUT_COUNTER = "dl4j_mesh_restore_relayouts_total"

# Mesh-sharded serving slices (parallel/inference.py slice_plane= +
# serving/fleet.py elastic rebuild): per-slice device count and
# degraded flag (``slice=`` label: the slice's sorted device ids), the
# count of elastic slice rebuilds (``width=`` label: the NARROWER width
# the mesh-portable checkpoint was restored onto after a chip died),
# and the count of disaggregated prefill→decode KV handoffs (sessions
# admitted on a decode endpoint from a prefill endpoint's shipped KV,
# zero prompt tokens recomputed).
SLICE_DEVICES_GAUGE = "dl4j_slice_devices"
SLICE_DEGRADED_GAUGE = "dl4j_slice_degraded"
SLICE_REBUILDS_COUNTER = "dl4j_slice_rebuilds_total"
DISAGG_KV_HANDOFFS_COUNTER = "dl4j_disagg_kv_handoffs_total"

# Quantized serving plane (nn/quantize.py post-training weight
# quantization + the nn/kvpool.py quantized paged KV pool): count of
# quantized nets produced by quantize() (``dtype=`` int8/fp8), the
# allocatable block count of every QUANTIZED paged pool (``pool=`` —
# alongside dl4j_kvpool_blocks_total, so "how much of the KV budget is
# 1-byte storage" is a division of two gauges), the largest
# per-output-channel dequant scale of every quantized weight matrix
# (``layer=``/``param=`` — a scale that jumps between deploys means
# an outlier channel is eating the int8 range), and the accuracy-gate
# verdict counter (``outcome=`` pass/fail — the quality bound every
# quantized deploy/bench claim ships with).
QUANT_MODELS_GAUGE = "dl4j_quant_models"
QUANT_KV_BLOCKS_GAUGE = "dl4j_quant_kv_blocks"
QUANT_SCALE_ABSMAX_GAUGE = "dl4j_quant_scale_absmax"
QUANT_GATE_OUTCOME_COUNTER = "dl4j_quant_accuracy_gate_outcome_total"

# Speculative decoding (serving/continuous.py spec rounds over the
# nn/generate.py draft-burst + fused verify/reject programs): proposal
# volume from the draft net, how many of those proposals the target's
# exact rejection sampler accepted vs rejected (``model=`` label — the
# realized acceptance ratio IS the speedup dial; accepted/(accepted+
# rejected) should track the deploy-time accuracy-gate greedy-match
# prior the registry surfaces), the live acceptance-rate gauge the
# scheduler refreshes every spec round, and the draft-phase wall-time
# histogram (the added latency speculation must amortize — a draft
# burst slower than ~K/(1+aK) of a target burst is a net loss).
SPEC_PROPOSED_TOKENS_COUNTER = "dl4j_spec_proposed_tokens_total"
SPEC_ACCEPTED_TOKENS_COUNTER = "dl4j_spec_accepted_tokens_total"
SPEC_REJECTED_TOKENS_COUNTER = "dl4j_spec_rejected_tokens_total"
SPEC_ACCEPT_RATE_GAUGE = "dl4j_spec_accept_rate"
SPEC_DRAFT_LATENCY_HISTOGRAM = "dl4j_spec_draft_latency_ms"

# End-to-end request tracing + SLO attribution (monitor/reqtrace.py —
# the serving plane's Dapper layer): per-request phase durations from
# the merged traces (``phase=`` label: admission / dispatch /
# queue_wait / prefill / decode_burst / chunk_deliver / silence_wait /
# repin / engine_queue / engine_dispatch / wire_ingress — the
# TTFT/TPOT decomposition), TTFT and time-per-output-token histograms
# per model, the per-model SLO burn counter (``outcome=`` met / missed
# / shed — missed+shed burn the error budget), span volume / bounded-
# buffer drops / open-trace gauge, and flight-recorder triggers
# (``reason=`` ejection / wedge / invariant / …; each dumps the
# trace+event rings as JSONL when a dump dir is armed).
REQ_PHASE_HISTOGRAM = "dl4j_req_phase_ms"
REQ_TTFT_HISTOGRAM = "dl4j_req_ttft_ms"
REQ_TPOT_HISTOGRAM = "dl4j_req_tpot_ms"
REQ_SLO_BURN_COUNTER = "dl4j_req_slo_burn_total"
TRACE_SPANS_COUNTER = "dl4j_trace_spans_total"
TRACE_DROPPED_COUNTER = "dl4j_trace_dropped_total"
TRACE_ACTIVE_GAUGE = "dl4j_trace_active"
TRACE_FLIGHT_DUMPS_COUNTER = "dl4j_trace_flight_dumps_total"

# Capacity observatory (monitor/timeseries.py TimeSeriesStore behind
# the registry): windowed time-series of the serving plane's sampled
# gauges — the ``dl4j_ts_*`` series names live in monitor/timeseries.py
# (TS_SCHED_*, TS_ROUTER_*, TS_ENGINE_*, TS_SLO_BURN, TS_WORKER_SERVED,
# re-exported below) and answer ``query(name, window)`` with
# rate/mean/p50/p99 over aligned 1s/10s/60s tiers — served at
# ``UiServer /timeseries`` and carried per-endpoint in ``stats()``
# payloads so ``fleet_snapshot()`` merges fleet-wide window answers.
# The per-model/per-owner resource-attribution families ride alongside:
ATTR_KV_BYTE_SECONDS_GAUGE = "dl4j_attr_kv_byte_seconds"
ATTR_KV_HOST_BYTE_SECONDS_GAUGE = "dl4j_attr_kv_host_byte_seconds"
ATTR_PREFILL_TOKENS_COUNTER = "dl4j_attr_prefill_tokens_total"
ATTR_DECODE_TOKENS_COUNTER = "dl4j_attr_decode_tokens_total"
ATTR_QUEUE_MS_COUNTER = "dl4j_attr_queue_ms_total"

# Fault-tolerance plane (detect → isolate → recover): every recovery
# path in the stack reports through these five families so an operator
# can tell a self-healed fault from a healthy run. ``domain`` label on
# the events counter: "checkpoint" (torn/corrupt persistence),
# "training" (NaN/divergence rollback), "serving" (replica device
# errors/quarantine), "transport" (broker reconnects, poison messages),
# "routing" (endpoint failures the router failed over / ejected).
FAULT_EVENTS_COUNTER = "dl4j_fault_events_total"
FAULT_ROLLBACKS_COUNTER = "dl4j_fault_rollbacks_total"
FAULT_QUARANTINED_GAUGE = "dl4j_fault_quarantined_replicas"
FAULT_DEAD_LETTER_COUNTER = "dl4j_fault_dead_letter_total"
FAULT_CKPT_INTEGRITY_COUNTER = "dl4j_fault_checkpoint_integrity_failures_total"


def record_fault(domain: str) -> None:
    """Tick the per-domain fault counter (the shared entry point every
    recovery path calls when it observes a fault, before recovering)."""
    get_registry().counter(
        FAULT_EVENTS_COUNTER,
        "Faults observed (and handled) by the fault-tolerance layer",
        domain=domain).inc()

from deeplearning4j_tpu_torch.monitor.registry import (  # noqa: F401
    Counter,
    DEFAULT_MS_BUCKETS,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
)
from deeplearning4j_tpu_torch.monitor.step_health import (  # noqa: F401
    NAN_COUNTER,
    SCORE_GAUGE,
    SLOW_COUNTER,
    STEP_HISTOGRAM,
    StepHealthWatchdog,
)
from deeplearning4j_tpu_torch.monitor.tracing import (  # noqa: F401
    PHASE_HISTOGRAM,
    PhaseTracer,
    active_tracer,
    disable_tracing,
    enable_tracing,
    mark,
    now_us,
    span,
    to_origin_us,
)
from deeplearning4j_tpu_torch.monitor.timeseries import (  # noqa: F401
    TS_ENGINE_FILL_RATIO,
    TS_ENGINE_JIT_MISS,
    TS_ROUTER_ADMIT_ERROR,
    TS_ROUTER_QUEUE_DEPTH,
    TS_ROUTER_SHED,
    TS_SCHED_ACTIVE,
    TS_SCHED_POOL_OCCUPANCY,
    TS_SCHED_PREFIX_HIT_RATE,
    TS_SCHED_QUEUED,
    TS_SLO_BURN,
    TS_WORKER_SERVED,
    TimeSeriesStore,
    merge_summaries,
    set_timeseries_enabled,
    timeseries_enabled,
    ts_query,
    ts_record,
)
from deeplearning4j_tpu_torch.monitor.reqtrace import (  # noqa: F401
    FlightRecorder,
    RequestTracer,
    TraceContext,
    begin_trace,
    configure_flight_recorder,
    current_trace,
    disable_request_tracing,
    enable_request_tracing,
    finish_trace,
    flight_event,
    flight_recorder,
    flight_trigger,
    record_span,
    request_tracer,
    start_span,
    trace_event,
    use_trace,
)


def phase_breakdown(registry=None, name: str = PHASE_HISTOGRAM) -> dict:
    """Per-phase timing summary from a ``{phase=...}``-labeled duration
    histogram family (default: the training-plane
    ``dl4j_phase_duration_ms``; pass ``REQ_PHASE_HISTOGRAM`` for the
    serving plane's per-request decomposition) — the attribution a run
    attaches next to end-to-end numbers:
    ``{phase: {count, total_ms, mean_ms, p50_ms, p99_ms}}``."""
    reg = registry if registry is not None else get_registry()
    out = {}
    for labels, hist in sorted(reg.family(name).items()):
        phase = dict(labels).get("phase", "?")
        s = hist.summary()
        out[phase] = {"count": int(s["count"]),
                      "total_ms": round(s["total"], 3),
                      "mean_ms": round(s["mean"], 3),
                      "p50_ms": round(s["p50"], 3),
                      "p99_ms": round(s["p99"], 3)}
    return out
