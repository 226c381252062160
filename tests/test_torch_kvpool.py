"""The port's paged KV pool and its KV quantization against the JAX
package's.

The same scripted sequence of pool operations runs on a reference
``PagedKVCachePool`` and on the port's (``device="cpu"``), each with an
injected integer clock: after every operation the results (block ids,
handles, ``None`` on exhaustion, the error's type), the free count,
every block's refcount, ``stats()`` and ``attribution()`` (byte-seconds
under that clock) must be equal. The script covers allocation,
exhaustion, sharing, frees, double frees, the trash block, a reclaimer
chain, a quantized pool's layout and ``bytes_per_block``, and the host
tier (swap out and in, free, share, export, insert and its typed
errors), whose block contents must come back bit for bit.
``kv_quantize`` matches the reference's (compiled, as its programs run
it) bit for bit in int8 and fp8, including an all-zero row.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import kvpool as jpool
from deeplearning4j_tpu.nn import quantize as jq
from deeplearning4j_tpu_torch.nn import kvpool as tpool
from deeplearning4j_tpu_torch.nn import quantize as tq

LAYERS, HEADS, HD, BS = 2, 2, 8, 4


class _Clock:
    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t


def _pair(num_blocks=9, **kw):
    cj, ct = _Clock(), _Clock()
    jdt = kw.pop("jdtype", jnp.float32)
    tdt = kw.pop("tdtype", torch.float32)
    j = jpool.PagedKVCachePool(num_blocks, BS, LAYERS, HEADS, HD, jdt,
                               name="p", clock=cj, **kw)
    t = tpool.PagedKVCachePool(num_blocks, BS, LAYERS, HEADS, HD, tdt,
                               device="cpu", name="p", clock=ct, **kw)
    return (j, cj), (t, ct)


def _apply(pool, op, args):
    try:
        return getattr(pool, op)(*args)
    except Exception as e:  # the error's type is the result
        return type(e).__name__


def _replay(pair, script):
    (j, cj), (t, ct) = pair
    for op, *args in script:
        cj.t += 1
        ct.t += 1
        got = (_apply(j, op, args), _apply(t, op, args))
        assert got[0] == got[1], (op, args, got)
        assert j.free_count == t.free_count, (op, args)
        assert [j.ref_count(b) for b in range(1, j.num_blocks)] == \
            [t.ref_count(b) for b in range(1, t.num_blocks)], (op, args)
        assert j.stats() == t.stats(), (op, args)
        assert j.attribution() == t.attribution(), (op, args)
        assert j.shared_count() == t.shared_count()
        assert j.occupancy() == t.occupancy()


def test_pool_accounting_replays_the_reference():
    pair = _pair()
    _replay(pair, [
        ("alloc", 3, "a"),              # [1, 2, 3]
        ("alloc", 2, "b"),              # [4, 5]
        ("alloc", 0),                   # []
        ("share_blocks", [2, 3], "c"),
        ("alloc", 10),                  # exhausted: None, nothing claimed
        ("free_blocks", [2], "a"),      # 2 -> 1 reference
        ("free_blocks", [1, 3], "zz"),  # untagged owner: billed to another
        ("free_blocks", [1]),           # double free: RuntimeError
        ("free_blocks", [0]),           # trash block: ValueError
        ("free_blocks", [9]),           # out of range: ValueError
        ("share_blocks", [1], "c"),     # free block: ValueError
        ("share_blocks", [0]),          # trash: ValueError
        ("free_blocks", [2, 3], "c"),
        ("alloc", 4, "d"),              # lowest ids first: [1, 2, 3, 6]
        ("blocks_for", 9),
        ("free_blocks", [4, 5], "b"),
        ("free_blocks", [1, 2, 3, 6], "d"),
    ])
    (j, _), (t, _) = pair
    assert t.free_count == t.total_blocks == 8
    assert t.spec == j.spec == (LAYERS, HEADS, HD, BS, "float32", "")
    assert t.block_bytes() == j.block_bytes()


def test_reclaimer_chain_replays_the_reference():
    pair = _pair()
    calls = {}
    for side, (pool, _) in zip(("j", "t"), pair):
        held = pool.alloc(6, "cache")
        log = calls[side] = []

        def demote(short, log=log):        # frees nothing, only records
            log.append(("demote", short))
            return 0

        def drop(short, pool=pool, held=held, log=log):
            log.append(("drop", short))
            pool.free_blocks(held[:short], "cache")
            del held[:short]
            return short

        def broken(short):
            raise RuntimeError("a broken evictor must not kill alloc")

        pool.register_reclaimer(broken)
        pool.register_reclaimer(demote)
        pool.register_reclaimer(drop)
    _replay(pair, [("alloc", 4, "live"), ("alloc", 2, "live"),
                   ("alloc", 3, "live")])
    assert calls["j"] == calls["t"] and calls["t"]


def test_quantized_pool_layout_and_bytes():
    for quant in ("int8", "fp8"):
        (j, _), (t, _) = _pair(quant=quant)
        assert t.spec == j.spec == tpool.pool_spec(LAYERS, HEADS, HD, BS,
                                                   torch.float32, quant)
        assert t.layers[0]["k"].dtype == tq.kv_qparams(quant)[0]
        assert t.layers[0]["k_scale"].shape == (9, BS, HEADS)
        assert t.layers[0]["k_scale"].dtype == torch.float32
        assert t.stats() == j.stats()
        assert t.block_bytes() == j.block_bytes()
    for kw in ({}, {"quant": "int8"}, {"quant": "fp8"}):
        assert tpool.PagedKVCachePool.bytes_per_block(
            3, 16, 8, 64, torch.bfloat16, **kw) == \
            jpool.PagedKVCachePool.bytes_per_block(
                3, 16, 8, 64, jnp.bfloat16, **kw)
    (_, _), (t, _) = _pair(tdtype=torch.bfloat16, jdtype=jnp.bfloat16)
    assert t.spec[4] == "bfloat16" and t.layers[0]["v"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tpool.PagedKVCachePool(1, BS, 1, 1, 1, device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        tpool.PagedKVCachePool(4, BS, 1, 1, 1, device="cpu", sharding=object())


def _fill(pair, ids, rng):
    """The same random contents into blocks ``ids`` of both pools."""
    (j, _), (t, _) = pair
    for li in range(LAYERS):
        for comp in j.layers[li]:
            shape = j.layers[li][comp].shape[1:]
            for b in ids:
                if comp.endswith("scale"):
                    val = rng.random(shape).astype(np.float32)
                elif j.layers[li][comp].dtype == jnp.int8:
                    val = rng.integers(-127, 128, shape).astype(np.int8)
                else:
                    val = rng.standard_normal(shape).astype(np.float32)
                j.layers[li][comp] = j.layers[li][comp].at[b].set(
                    jnp.asarray(val, j.layers[li][comp].dtype))
                t.layers[li][comp][b] = torch.from_numpy(val)


def _same_contents(pair):
    (j, _), (t, _) = pair
    for jl, tl in zip(j.layers, t.layers):
        for comp in jl:
            np.testing.assert_array_equal(
                tl[comp].float().numpy(),
                np.asarray(jl[comp]).astype(np.float32))


@pytest.mark.parametrize("quant", [None, "int8"])
def test_host_tier_replays_the_reference(quant):
    pair = _pair(quant=quant, host_blocks=3)
    (j, _), (t, _) = pair
    assert t.host_enabled and j.host_enabled
    _replay(pair, [("alloc", 4, "a")])
    _fill(pair, [1, 2, 3, 4], np.random.default_rng(0))
    _replay(pair, [
        ("swap_out", [1, 2], "a"),     # handles [1, 2], blocks 1, 2 freed
        ("swap_out", [3, 4], "a"),     # over the budget of 3: None
        ("share_host", [1], "b"),
        ("free_host", [1], "b"),
        ("share_host", [99]),          # unknown: ValueError
        ("free_host", [99]),           # KVHostTierError
        ("swap_in", [99]),             # KVHostTierError
        ("host_blocks_used",),
        ("swap_in", [2, 1], "a"),      # blocks [1, 2], contents swapped
    ])
    _same_contents(pair)
    _replay(pair, [("swap_out", [3], "a"), ("free_host", [3], "a"),
                   ("free_host", [3], "a")])   # double free: typed
    exported = {}
    for side, (pool, _) in zip(("j", "t"), pair):
        (h,) = pool.swap_out([4], "a")
        exported[side] = pool.host_export([h])
        pool.free_host([h], "a")
    for key, val in exported["j"][0].items():
        np.testing.assert_array_equal(exported["t"][0][key], val)
    _replay(pair, [
        ("host_insert", exported["j"], "c"),
        ("swap_in", [5], "c"),
        ("set_host_budget", 0),
        ("swap_out", [1], "a"),        # tier off: None
        ("host_insert", exported["j"]),
        ("free_blocks", [1, 2, 3], "a"),
        ("free_blocks", [4], "c"),
    ])
    _same_contents(pair)
    assert t.free_count == t.total_blocks
    assert t.swap_in_cost_ms() is not None


def test_host_export_of_a_bfloat16_pool_is_exact():
    pair = _pair(host_blocks=1, jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    (j, _), (t, _) = pair
    for pool in (j, t):
        pool.alloc(1)
    _fill(pair, [1], np.random.default_rng(1))
    (hj,), (ht,) = j.swap_out([1]), t.swap_out([1])
    ej, et = j.host_export([hj])[0], t.host_export([ht])[0]
    for key, val in ej.items():
        assert val.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(et[key], val.astype(np.float32))
    t.free_host([ht])
    (h2,) = t.host_insert([et])
    (b,) = t.swap_in([h2])
    _same_contents(pair)
    assert b == 1


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_kv_quantize_matches_the_reference_bit_for_bit(mode):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((64, 5, 2, 8)) * 4.0).astype(np.float32)
    x[0, 0] = 0.0                      # an all-zero (position, head) row
    x[1, 2, 1] = [1e-30] * 8           # under the scale floor
    jdt, jqmax = jq.kv_qparams(mode)
    tdt, tqmax = tq.kv_qparams(mode)
    assert tqmax == jqmax == tq.kv_qmax(tdt) == jq.kv_qmax(jdt)
    # the reference quantizes inside compiled programs only
    jqv, jsc = jax.jit(jq.kv_quantize, static_argnums=1)(jnp.asarray(x), jdt)
    tqv, tsc = tq.kv_quantize(torch.from_numpy(x), tdt)
    assert tqv.dtype == tdt and tsc.dtype == torch.float32
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    if mode == "int8":
        np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    else:   # the fp8 bits
        np.testing.assert_array_equal(
            tqv.view(torch.uint8).numpy(),
            np.asarray(jqv).view(np.uint8))
    for dt, jdtv in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        back = tq.kv_dequantize(tqv, tsc, dt)
        ref = jq.kv_dequantize(jqv, jsc, jdtv)
        assert back.dtype == dt
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(ref).astype(np.float32))
    assert not tq.kv_dequantize(tqv, tsc, torch.float32)[0, 0].any()
    with pytest.raises(ValueError):
        tq.kv_qparams("int4")
    with pytest.raises(ValueError):
        tq.kv_qmax(torch.float32)
