"""The port's cross-request prefix cache (``serving/prefixcache.py``) and
the scheduler's cached admissions against the JAX package's.

The radix index: the same operation sequence (inserts, matches,
reclaims, ``clear``) drives the JAX ``PrefixCache`` over the JAX pool
and the port's over the port's pool; every match (tokens, full block
ids, partial block id), every eviction and the stats must be equal.
The host tier's demote and promote rungs are held the same way on pools
with a host tier. The scheduler: a tiny JAX ``gpt`` (vocab 11, d_model
16, 2 layers, 2 heads, max_len 32, f32) carries its parameters into the
port's; both schedulers (4 slots, bursts of 4, blocks of 4, ``step()``
driven) serve the same requests with ``prefix_cache=True``: their
tokens equal each other and the port's ``generate_eager`` exactly
(greedy and seeded sampling: a cache hit's tail prefill reads the
cached blocks instead of recomputing them, and must change no token),
their ``events`` are equal string for string (admissions, copies on
write, preemptions, evictions in the same order), and every drained
pool holds ``free + cached == total`` and is fully free after
``clear()``. The card's cases are in ``tests/test_torch_engine_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo.transformer import gpt as jax_gpt
from deeplearning4j_tpu.nn.kvpool import PagedKVCachePool as JaxPool
from deeplearning4j_tpu.serving import continuous as jcont
from deeplearning4j_tpu.serving.prefixcache import PrefixCache as JaxCache
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
from deeplearning4j_tpu_torch.nn.generate import generate_eager
from deeplearning4j_tpu_torch.nn.kvpool import PagedKVCachePool
from deeplearning4j_tpu_torch.serving import PrefixCache
from deeplearning4j_tpu_torch.serving.continuous import (
    ContinuousDecodeScheduler,
    DecodeBurstError,
)
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

VOCAB = 11
SIZE = dict(vocab_size=VOCAB, d_model=16, n_layers=2, num_heads=2, max_len=32)
KNOBS = dict(slots=4, burst_tokens=4, block_size=4, start=False,
             prefix_cache=True)
LANE = ("m", 1)


@pytest.fixture(scope="module")
def nets():
    jn = jax_gpt(compute_dtype="float32", seed=0, **SIZE).init()
    tn = gpt(compute_dtype="float32", seed=0, device="cpu", **SIZE)
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    return jn, tn


@pytest.fixture
def fresh_registry():
    prev = monitor.set_registry(monitor.MetricsRegistry())
    yield monitor.get_registry()
    monitor.set_registry(prev)


def _pools(blocks=9, host_blocks=None):
    """The JAX pool and the port's, the same size."""
    return (JaxPool(blocks, 4, num_layers=1, num_heads=1, head_dim=2,
                    host_blocks=host_blocks),
            PagedKVCachePool(blocks, 4, num_layers=1, num_heads=1,
                             head_dim=2, device="cpu",
                             host_blocks=host_blocks))


def _both(ops, blocks=9, host_blocks=None, **cache_kw):
    """Run ``ops(pool, cache) -> list of results`` over the JAX cache and
    the port's; returns both lists and both (pool, cache) pairs."""
    out = []
    for (pool, cls) in zip(_pools(blocks, host_blocks), (JaxCache, PrefixCache)):
        cache = cls(pool, **cache_kw)
        out.append((ops(pool, cache), pool, cache))
    return out


def _norm(x):
    """Results as plain Python (ints, lists, tuples, dicts)."""
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, (np.integer,)):
        return int(x)
    return x


# -------------------------------------------------- the pool's refcounts

def test_pool_refcount_share_and_double_free():
    for pool in _pools():
        a = pool.alloc(3)
        assert a == [1, 2, 3] and pool.free_count == 5
        pool.share_blocks(a[:2])
        assert pool.ref_count(1) == 2 and pool.ref_count(3) == 1
        pool.free_blocks(a)  # a sharer's free drops one reference each
        assert pool.free_count == 6
        assert (pool.ref_count(1), pool.ref_count(2), pool.ref_count(3)) \
            == (1, 1, 0)
        assert pool.shared_count() == 0
        pool.free_blocks([1, 2])
        assert pool.free_count == 8
        with pytest.raises(RuntimeError, match="double free"):
            pool.free_blocks([1])
        with pytest.raises(ValueError):
            pool.share_blocks([4])  # a free block has no owner
        with pytest.raises(ValueError):
            pool.share_blocks([0])  # the trash block, never


# --------------------------------------------------------- the radix index

def test_reclaimer_evicts_leaves_first_through_the_free_list():
    def ops(pool, cache):
        a = pool.alloc(4)
        res = [cache.insert(LANE, list(range(16)), a)]
        pool.free_blocks(a)  # the sequence is gone; the cache holds 4
        res.append(pool.free_count)
        res.append(pool.alloc(2))  # exhausted: the deepest blocks go
        res.append(cache.cached_blocks())
        m = cache.match(LANE, list(range(16)))
        res.append(m)
        pool.free_blocks(m[1])
        res.append(cache.stats())
        return res

    (want, _, _), (got, pool, _) = _both(ops, blocks=5)
    assert _norm(got) == _norm(want)
    assert got[0] == 4 and got[1] == 0 and got[2] == [3, 4]
    assert got[4][0] == 8 and got[4][1] == [1, 2]


def test_match_caps_at_the_last_token_and_takes_the_best_partial():
    """Full blocks, then the longest partial child (the oldest on a tie);
    never the last prompt token."""
    def ops(pool, cache):
        res = []
        a = pool.alloc(3)
        res.append(cache.insert(LANE, list(range(10)), a))  # 2 full + 2
        b = pool.alloc(3)
        res.append(cache.insert(LANE, list(range(8)) + [8, 7, 6], b))
        c = pool.alloc(3)
        res.append(cache.insert(LANE, list(range(8)) + [8, 9], c))  # dup
        for blocks in (a, b, c):
            pool.free_blocks(blocks)
        for toks in (list(range(8)), list(range(9)), list(range(12)),
                     list(range(8)) + [8, 7, 6, 5], list(range(8)) + [8, 7],
                     [5] * 12, list(range(4)) + [0] * 8):
            m = cache.match(LANE, toks)
            res.append(m)
            pool.free_blocks(m[1] + ([m[2]] if m[2] is not None else []))
        res.append(cache.match(("other", 0), list(range(12))))
        res.append(cache.stats())
        res.append(cache.clear())
        res.append(pool.free_count)
        return res

    (want, _, _), (got, pool, _) = _both(ops, blocks=12)
    assert _norm(got) == _norm(want)
    assert pool.free_count == pool.total_blocks


def test_eviction_never_evicts_a_referenced_block():
    def ops(pool, cache):
        a = pool.alloc(3)
        toks = list(range(12))
        cache.insert(LANE, toks, a)
        pool.free_blocks(a)
        m, full, part = cache.match(LANE, toks)  # 11 usable: 2 full
        res = [m, full, part, cache.reclaim(10), cache.cached_blocks(),
               pool.ref_count(full[0]), pool.ref_count(full[1])]
        pool.free_blocks(full)
        res += [cache.reclaim(10), pool.free_count, cache.stats()]
        return res

    (want, _, _), (got, pool, _) = _both(ops)
    assert _norm(got) == _norm(want)
    assert got[:7] == [8, [1, 2], None, 1, 2, 2, 2]
    assert got[7] == 2 and got[8] == pool.total_blocks


def test_deterministic_lru_eviction_order():
    def ops(pool, cache):
        a = pool.alloc(2)
        cache.insert(LANE, list(range(8)), a)  # the older chain
        pool.free_blocks(a)
        b = pool.alloc(2)
        cache.insert(LANE, [9, 9, 9, 9, 8, 8, 8, 8], b)  # the newer one
        pool.free_blocks(b)
        res = [cache.reclaim(2), pool.free_count]
        m = cache.match(LANE, [9, 9, 9, 9, 8, 8, 8, 8, 1])
        res.append(m)
        pool.free_blocks(m[1])
        res.append(cache.match(LANE, list(range(9))))
        return res

    (want, _, _), (got, _, _) = _both(ops)
    assert _norm(got) == _norm(want)
    assert got[0] == 2 and got[2][0] == 8 and len(got[2][1]) == 2
    assert got[3][0] == 0  # the older chain went, root and leaf


def test_capacity_bounds_the_cache_and_cow_is_counted(fresh_registry):
    def ops(pool, cache):
        res = []
        for k in range(3):
            a = pool.alloc(2)
            res.append(cache.insert(LANE, [k] * 8, a))
            pool.free_blocks(a)
            res.append(cache.cached_blocks())
        cache.note_cow(2)
        cache.note_admitted(5)
        cache.note_admitted(0)
        res.append(cache.stats())
        return res

    (want, _, _), (got, pool, cache) = _both(ops, blocks=12,
                                             capacity_blocks=3)
    assert _norm(got) == _norm(want)
    st = got[-1]
    assert st["cached_blocks"] == 3 and st["evictions"] == 3
    assert (st["cow_copies"], st["hits"], st["misses"],
            st["saved_prefill_tokens"]) == (2, 1, 1, 5)
    reg = fresh_registry
    assert reg.family_total(monitor.PREFIXCACHE_COW_COPIES_COUNTER) == 2
    assert reg.family_total(monitor.PREFIXCACHE_HITS_COUNTER) == 1
    assert reg.family_total(monitor.PREFIXCACHE_SAVED_TOKENS_COUNTER) == 5
    assert reg.family_total(monitor.PREFIXCACHE_EVICTIONS_COUNTER) == 3
    assert reg.get(monitor.PREFIXCACHE_CACHED_BLOCKS_GAUGE,
                   pool=pool.name).value == 3


def _fill(pool):
    """Every K/V entry of the pool its own value, so that a block's
    contents name it."""
    for layer in pool.layers:
        for name in ("k", "v"):
            shape = tuple(layer[name].shape)
            vals = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
            if isinstance(layer[name], torch.Tensor):
                layer[name].copy_(torch.from_numpy(vals))
            else:
                layer[name] = jax.numpy.asarray(vals)


def test_host_tier_demotes_before_it_drops_and_promotes_on_match():
    """With a host tier the first rung demotes cold cached blocks (their
    contents kept, still matchable) and a match swaps them back; only a
    full host tier lets the drop rung evict. Held on the pools directly,
    against the reference's."""
    def ops(pool, cache):
        _fill(pool)
        res = []
        a = pool.alloc(3)
        res.append(cache.insert(LANE, list(range(12)), a))
        pool.free_blocks(a)
        res.append(pool.alloc(3))  # 2 free: the cold leaf is demoted
        st = cache.stats()
        res.append((st["demotions"], st["host_blocks"], st["evictions"],
                    st["cached_blocks"]))
        pool.free_blocks(res[-2])
        m = cache.match(LANE, list(range(13)))  # promotes the leaf back
        res.append(m)
        blk = m[1][-1]
        res.append(np.asarray(pool.layers[0]["k"][blk]).tolist())
        pool.free_blocks(m[1])
        st = cache.stats()
        res.append((st["demotions"], st["host_blocks"], st["cached_blocks"]))
        res.append(cache.clear())
        res.append((pool.free_count, pool.host_blocks_used()))
        return res

    (want, _, _), (got, pool, _) = _both(ops, blocks=6, host_blocks=4)
    assert _norm(got) == _norm(want)
    assert got[2][0] >= 1 and got[2][1] >= 1
    assert got[3][0] == 12 and len(got[3][1]) == 3
    assert got[-1] == (pool.total_blocks, 0)


# ------------------------------------------------------------ the scheduler

def _drive(s, futs, max_steps=400):
    for _ in range(max_steps):
        if all(f.done() for f in futs):
            return
        s.step()
    raise AssertionError(f"did not converge; events={list(s.events)}")


def _drained_clean(s):
    st = s.stats()
    cached = sum(c.cached_blocks() for c in s.prefix_caches())
    assert st["pool"]["blocks_free"] + cached == st["pool"]["blocks_total"]
    for c in s.prefix_caches():
        c.clear()
    st = s.stats()
    assert st["pool"]["blocks_free"] == st["pool"]["blocks_total"]


def _schedulers(nets, plan, **kw):
    """``plan(s) -> futures`` on the reference's scheduler and the
    port's, both with the prefix cache; returns ((s, results), ...)."""
    jn, tn = nets
    out = []
    for cls, net in ((jcont.ContinuousDecodeScheduler, jn),
                     (ContinuousDecodeScheduler, tn)):
        s = cls(net=net, **dict(KNOBS, **kw))
        futs = plan(s)
        _drive(s, futs)
        out.append((s, [f.result(0) for f in futs]))
    return out


@pytest.mark.parametrize("sampler", [{}, {"temperature": 0.8, "top_k": 5,
                                          "seed": 7}])
def test_shared_prefix_output_equals_uncached(nets, sampler):
    """A warm admission (table clone + tail prefill) gives the cold
    run's tokens, the eager run's and the reference's; it computes fewer
    prefill tokens."""
    tn = nets[1]
    pre = np.random.default_rng(0).integers(0, VOCAB, (1, 12))
    want = generate_eager(tn, pre, 8, **sampler)

    def plan(s):
        f0 = s.submit(pre, 8, **sampler)
        _drive(s, [f0])
        return [f0, s.submit(pre, 8, **sampler)]

    (js, jgot), (s, got) = _schedulers(nets, plan)
    for g in got:
        np.testing.assert_array_equal(g, want)
    if not sampler:  # greedy: the reference's tokens too
        for g, w in zip(got, jgot):
            np.testing.assert_array_equal(g, w)
    st = s.stats()
    assert st["prefix_cache"]["hits"] >= 1
    assert st["prefix_cache"]["saved_prefill_tokens"] > 0
    assert st["prefill_tokens_computed"] < 2 * pre.shape[1]
    for key in ("hits", "misses", "saved_prefill_tokens", "cow_copies"):
        assert st["prefix_cache"][key] == js.stats()["prefix_cache"][key]
    assert list(s.events) == list(js.events)
    _drained_clean(s)


def test_distinct_tails_share_one_preamble(nets):
    tn = nets[1]
    rng = np.random.default_rng(1)
    preamble = rng.integers(0, VOCAB, (1, 8))
    prompts = [np.concatenate([preamble, rng.integers(0, VOCAB, (1, 4))],
                              axis=1) for _ in range(4)]

    def plan(s):
        f0 = s.submit(prompts[0], 6)
        _drive(s, [f0])
        return [f0] + [s.submit(p, 6) for p in prompts[1:]]

    (js, jgot), (s, got) = _schedulers(nets, plan)
    for p, g, w in zip(prompts, got, jgot):
        np.testing.assert_array_equal(g, generate_eager(tn, p, 6))
        np.testing.assert_array_equal(g, w)
    assert s.stats()["prefix_cache"]["hits"] >= len(prompts) - 1
    assert list(s.events) == list(js.events)
    _drained_clean(s)
    _drained_clean(js)


def test_cow_partial_tail_block(nets, fresh_registry):
    """A match reaching into a cached partial block copies it on write;
    the sharer's tokens are right and the originator's cached content
    still serves it unchanged."""
    tn = nets[1]
    pA = np.random.default_rng(2).integers(0, VOCAB, (1, 10))
    wantA = generate_eager(tn, pA, 2)
    pB = np.concatenate([pA, wantA[:, 10:11]], axis=1)
    wantB = generate_eager(tn, pB, 6)

    def plan(s):
        fA = s.submit(pA, 2)
        _drive(s, [fA])
        fB = s.submit(pB, 6)
        _drive(s, [fB])
        return [fA, fB, s.submit(pA, 2)]

    (js, jgot), (s, got) = _schedulers(nets, plan)
    np.testing.assert_array_equal(got[0], wantA)
    np.testing.assert_array_equal(got[1], wantB)
    np.testing.assert_array_equal(got[2], wantA)
    for g, w in zip(got, jgot):
        np.testing.assert_array_equal(g, w)
    st = s.stats()["prefix_cache"]
    assert st["cow_copies"] >= 1
    assert st["cow_copies"] == js.stats()["prefix_cache"]["cow_copies"]
    assert fresh_registry.family_total(
        monitor.PREFIXCACHE_COW_COPIES_COUNTER) == st["cow_copies"]
    assert list(s.events) == list(js.events)
    _drained_clean(s)


def test_preempt_sharer_keeps_cache_and_replays(nets):
    """A preempted sharer drops only its own references; every output
    equals the eager run's, and the schedule (admissions, preemptions,
    evictions) replays event for event, as the reference's."""
    tn = nets[1]
    prompts = [np.random.default_rng(3).integers(0, VOCAB, (1, 5))
               for _ in range(3)]

    def plan(s):
        return [s.submit(p, 10) for p in prompts]

    (js, jgot), (s1, got1) = _schedulers(nets, plan, num_blocks=12)
    assert s1.stats()["preemptions"] > 0
    for f, p in zip(got1, prompts):
        np.testing.assert_array_equal(f, generate_eager(tn, p, 10))
    for g, w in zip(got1, jgot):
        np.testing.assert_array_equal(g, w)
    assert list(s1.events) == list(js.events)
    s2 = ContinuousDecodeScheduler(net=tn, **dict(KNOBS, num_blocks=12))
    futs2 = plan(s2)
    _drive(s2, futs2)
    assert list(s1.events) == list(s2.events)
    for a, b in zip(got1, futs2):
        np.testing.assert_array_equal(a, b.result(0))
    _drained_clean(s1)
    _drained_clean(s2)


def test_prefix_resume_probes_the_index(nets):
    """A ``prefix=`` resume on a warm cache re-prefills only the tail
    the cache lacks."""
    tn = nets[1]
    p = np.random.default_rng(4).integers(0, VOCAB, (1, 8))
    want = generate_eager(tn, p, 12)
    prefix = np.asarray([int(t) for t in want[0, 8:14]])

    def plan(s):
        f0 = s.submit(p, 12)
        _drive(s, [f0])
        return [f0, s.submit(p, 12, prefix=prefix)]

    (js, _), (s, got) = _schedulers(nets, plan)
    for g in got:
        np.testing.assert_array_equal(g, want)
    st = s.stats()
    assert st["resume_reprefill_tokens"] < p.shape[1] + len(prefix)
    assert st["resume_reprefill_tokens"] == \
        js.stats()["resume_reprefill_tokens"]
    assert st["prefix_cache"]["hits"] >= 1
    _drained_clean(s)


class _KillOnce:
    """A burst hook that fails the ``after``-th burst once."""

    def __init__(self, after):
        self.after, self.fired = after, False

    def __call__(self, lane_key, burst_index):
        if burst_index >= self.after and not self.fired:
            self.fired = True
            raise RuntimeError("injected burst fault")


def test_kill_preempt_evict_interleaving_zero_leaks(nets, fresh_registry):
    """A killed burst on a pool small enough to preempt and evict: the
    survivors' tokens are right, the killed requests fail typed, and the
    pool drains with nothing leaked and nothing freed twice; the replay
    is the same event for event."""
    tn = nets[1]
    prompts = [np.random.default_rng(5).integers(0, VOCAB, (1, 5))
               for _ in range(4)]

    def run():
        s = ContinuousDecodeScheduler(
            net=tn, **dict(KNOBS, num_blocks=12, burst_hook=_KillOnce(2)))
        futs = [s.submit(p, 10, seed=i) for i, p in enumerate(prompts)]
        _drive(s, futs)
        outcomes = []
        for f in futs:
            try:
                outcomes.append(f.result(0).tolist())
            except DecodeBurstError as e:
                outcomes.append(type(e).__name__)
        return s, outcomes

    s1, out1 = run()
    assert any(isinstance(o, str) for o in out1), "the kill never landed"
    assert any(not isinstance(o, str) for o in out1), "nothing survived"
    for p, o in zip(prompts, out1):
        if not isinstance(o, str):
            np.testing.assert_array_equal(o, generate_eager(tn, p, 10))
    _drained_clean(s1)
    s2, out2 = run()
    assert out1 == out2 and list(s1.events) == list(s2.events)
    _drained_clean(s2)
    assert fresh_registry.family_total(monitor.FAULT_EVENTS_COUNTER) >= 1


def test_cache_off_keeps_pool_strict_and_reports_nothing(nets):
    tn = nets[1]
    s = ContinuousDecodeScheduler(net=tn, **dict(KNOBS, prefix_cache=False))
    p = np.random.default_rng(6).integers(0, VOCAB, (1, 6))
    f = s.submit(p, 4)
    _drive(s, [f])
    st = s.stats()
    assert "prefix_cache" not in st and s.prefix_caches() == []
    assert st["pool"]["blocks_free"] == st["pool"]["blocks_total"]


def test_prefix_cache_metrics_pass_the_schema(nets, fresh_registry):
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "check_telemetry_schema.py")
    spec = importlib.util.spec_from_file_location("check_telemetry_schema",
                                                  path)
    schema = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(schema)
    tn = nets[1]
    s = ContinuousDecodeScheduler(net=tn, **KNOBS)
    p = np.random.default_rng(7).integers(0, VOCAB, (1, 9))
    for _ in range(2):
        f = s.submit(p, 4)
        _drive(s, [f])
    text = fresh_registry.prometheus_text()
    for name in ("dl4j_prefixcache_hits_total",
                 "dl4j_prefixcache_misses_total",
                 "dl4j_prefixcache_cached_blocks",
                 "dl4j_prefixcache_shared_blocks",
                 "dl4j_prefixcache_saved_prefill_tokens_total"):
        assert name in text, name
    assert schema.validate_prometheus_text(text) == []
    assert schema.validate_known_metrics(text) == []
