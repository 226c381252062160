"""The port's paged attention and paged programs against the JAX
package's.

A tiny JAX ``gpt`` (vocab 11, d_model 16, 2 layers, 2 heads, max_len
32, f32) carries its parameters into the port's net. On the same pool
contents (random, so that every masked position holds garbage), tables
and inputs: the paged ``decode_step`` (f32 and int8 pools) and
``prefill_paged`` agree with the reference's within 1e-5, pool contents
included (int8 values exactly, scales within 1e-6), and the paged
decode equals the port's dense ``decode_step``. ``scatter_program`` and
``block_copy_program`` write the reference's blocks bit for bit;
``tail_prefill_program``'s logits agree with the reference's and with a
full prefill of the same tokens; the greedy ``burst_program`` gives the
reference's tokens, positions, token counts and done-mask. The card
cases are in ``tests/test_torch_serve_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo.transformer import gpt as jax_gpt
from deeplearning4j_tpu.nn import generate as jgen
from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
from deeplearning4j_tpu_torch.nn import generate as tgen
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

SIZE = dict(vocab_size=11, d_model=16, n_layers=2, num_heads=2, max_len=32)
H, HD, BS, NB = 2, 8, 4, 10
TOL = 1e-5


def _port(jn):
    tn = gpt(compute_dtype="float32", seed=0, device="cpu", **SIZE)
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    return tn


@pytest.fixture(scope="module")
def nets():
    jn = jax_gpt(compute_dtype="float32", seed=0, **SIZE).init()
    return jn, _port(jn)


def _pool(rng, quant=False, layers=1):
    """``layers`` pools of random contents, as numpy."""
    out = []
    for _ in range(layers):
        if quant:
            p = {n: rng.integers(-127, 128, (NB, BS, H, HD)).astype(np.int8)
                 for n in ("k", "v")}
            p.update({n: rng.random((NB, BS, H)).astype(np.float32) * 0.05
                      for n in ("k_scale", "v_scale")})
        else:
            p = {n: rng.standard_normal((NB, BS, H, HD)).astype(np.float32)
                 for n in ("k", "v")}
        out.append(p)
    return out


def _jp(pools):
    return [{n: jnp.asarray(a) for n, a in p.items()} for p in pools]


def _tp(pools, device="cpu"):
    return [{n: torch.from_numpy(a.copy()).to(device) for n, a in p.items()}
            for p in pools]


def _same_pools(tpools, jpools, tol=TOL):
    for tp, jp in zip(tpools, jpools):
        for n in jp:
            got, want = tp[n].cpu().numpy(), np.asarray(jp[n])
            if want.dtype == np.int8:
                np.testing.assert_array_equal(got, want, err_msg=n)
            else:
                np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                           err_msg=n)


TABLE = np.array([[3, 1, 5], [2, 6, 4]])


@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_step_matches_reference(nets, quant):
    jn, tn = nets
    jb, tb = jn.impls[1], tn.impls[1]
    jpar, tpar = jn.params[jb.name], tn.params[tb.name]
    rng = np.random.default_rng(0)
    (pool,) = _pool(rng, quant)
    jpool, (tpool,) = _jp([pool])[0], _tp([pool])
    pos = np.array([0, 2])
    for step in range(8):
        x = rng.standard_normal((2, 16)).astype(np.float32)
        wm = np.array([True, step != 3])   # row 1 writes the trash once
        jy, jc = jb.decode_step(jpar, jnp.asarray(x),
                                dict(jpool, table=jnp.asarray(TABLE, jnp.int32)),
                                jnp.asarray(pos, jnp.int32),
                                write_mask=jnp.asarray(wm))
        jpool = {n: jc[n] for n in jpool}
        ty, tc = tb.decode_step(tpar, torch.from_numpy(x),
                                dict(tpool, table=torch.from_numpy(TABLE)),
                                torch.from_numpy(pos),
                                write_mask=torch.from_numpy(wm))
        assert tc["k"] is tpool["k"]       # written in place
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL,
                                   atol=TOL)
        _same_pools([tpool], [jpool], 1e-6 if quant else TOL)
        pos += 1


def test_paged_decode_step_matches_dense(nets):
    """The block-table branch reproduces the port's dense decode_step at
    every position, and the pool holds the dense cache's rows."""
    _, tn = nets
    blk = tn.impls[1]
    params = tn.params[blk.name]
    rng = np.random.default_rng(1)
    dense = blk.init_cache(2, 3 * BS)
    pool = {"k": torch.zeros(8, BS, H, HD), "v": torch.zeros(8, BS, H, HD)}
    table = torch.tensor([[3, 1, 5], [2, 6, 4]])
    pos = torch.zeros(2, dtype=torch.long)
    for _ in range(7):
        x = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
        y_dense, _ = blk.decode_step(params, x, dense, pos)
        y_paged, _ = blk.decode_step(params, x, dict(pool, table=table), pos,
                                     write_mask=torch.ones(2, dtype=torch.bool))
        np.testing.assert_allclose(y_paged.numpy(), y_dense.numpy(),
                                   rtol=TOL, atol=TOL)
        pos += 1
    for row in range(2):
        gathered = pool["k"][table[row]].reshape(3 * BS, H, HD)
        assert torch.equal(gathered[:7], dense["k"][row, :7])


@pytest.mark.parametrize("quant", [False, True])
def test_prefill_paged_matches_reference(nets, quant):
    jn, tn = nets
    jb, tb = jn.impls[1], tn.impls[1]
    rng = np.random.default_rng(2)
    (pool,) = _pool(rng, quant)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    pos = np.array([3, 6])[:, None] + np.arange(5)[None, :]
    ok = np.arange(5)[None, :] < np.array([5, 3])[:, None]
    jo, jpool = jb.prefill_paged(jn.params[jb.name], jnp.asarray(x),
                                 _jp([pool])[0],
                                 jnp.asarray(TABLE, jnp.int32),
                                 jnp.asarray(pos, jnp.int32), jnp.asarray(ok))
    (tpool,) = _tp([pool])
    to, _ = tb.prefill_paged(tn.params[tb.name], torch.from_numpy(x), tpool,
                             torch.from_numpy(TABLE), torch.from_numpy(pos),
                             torch.from_numpy(ok))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    _same_pools([tpool], [jpool], 1e-6 if quant else TOL)


def _prefilled(nets, prompts, rng):
    """Both sides' prefill of ``prompts`` (rows of ids, right-padded to
    8) and its scatter into blocks of a random pool. Returns (reference
    pools, port pools, tables, lengths, the reference's logits, the
    port's)."""
    jn, tn = nets
    jg, tg = jgen.build_generator(jn), tgen.build_generator(tn)
    rows = len(prompts)
    ids = np.zeros((rows, 8), np.int64)
    lens = np.array([len(p) for p in prompts])
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    tables = np.zeros((rows, 2), np.int64)
    for i, n in enumerate(lens):
        tables[i, :-(-n // BS)] = [7 - 2 * i, 8 - 2 * i][:-(-n // BS)]
    pools = _pool(rng, layers=2)
    jc, jl = jg.prefill_program(8)(jn.params, jnp.asarray(ids, jnp.int32),
                                   jnp.asarray(lens, jnp.int32))
    jpools = jg.scatter_program(rows, 8, BS)(
        _jp(pools), jc, jnp.asarray(tables, jnp.int32))
    tc, tl = tg.prefill_program(8)(tn.cast_params(tn.params), ids, lens)
    tpools = tg.scatter_program(rows, 8, BS)(_tp(pools), tc, tables)
    return jpools, tpools, tables, lens, np.asarray(jl), tl.numpy()


@pytest.mark.parametrize("quant", [False, True])
def test_scatter_and_block_copy_match_reference(nets, quant):
    """On the same dense caches, both scatters write the same blocks,
    bit for bit (quantized per position and head on an int8 pool), and
    both copies clone the same blocks."""
    jn, tn = nets
    jg, tg = jgen.build_generator(jn), tgen.build_generator(tn)
    rng = np.random.default_rng(3)
    pools = _pool(rng, quant, layers=2)
    caches = [{n: rng.standard_normal((3, 8, H, HD)).astype(np.float32)
               for n in ("k", "v")} for _ in range(2)]
    tables = np.array([[7, 8], [5, 6], [3, 0]])
    jpools = jg.scatter_program(3, 8, BS)(_jp(pools), _jp(caches),
                                          jnp.asarray(tables, jnp.int32))
    tpools = tg.scatter_program(3, 8, BS)(_tp(pools), _tp(caches), tables)
    assert tg.scatter_program(3, 8, BS) is tg.scatter_program(3, 8, BS)
    with pytest.raises(ValueError):
        tg.scatter_program(3, 6, BS)
    live = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9])   # not the trash block
    _same_pools([{n: p[n][live] for n in p} for p in tpools],
                [{n: p[n][live] for n in p} for p in jpools], 0.0)
    src, dst = np.array([7, 5]), np.array([9, 1])
    jpools = jg.block_copy_program(2, NB, BS)(
        jpools, jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32))
    tpools = tg.block_copy_program(2, NB, BS)(tpools, src, dst)
    _same_pools([{n: p[n][live] for n in p} for p in tpools],
                [{n: p[n][live] for n in p} for p in jpools], 0.0)
    for p in tpools:
        for arr in p.values():
            assert torch.equal(arr[dst], arr[src])


def test_tail_prefill_matches_reference_and_full_prefill(nets):
    jn, tn = nets
    jg, tg = jgen.build_generator(jn), tgen.build_generator(tn)
    pc = tn.cast_params(tn.params)
    rng = np.random.default_rng(4)
    full = rng.integers(0, 11, (1, 11))
    # the first 8 tokens paged into blocks 7, 8 by prefill + scatter
    tc, _ = tg.prefill_program(8)(pc, full[:, :8], np.array([8]))
    pools = _pool(rng, False, layers=2)
    tpools = tg.scatter_program(1, 8, BS)(_tp(pools), tc, np.array([[7, 8]]))
    jc, _ = jg.prefill_program(8)(jn.params, jnp.asarray(full[:, :8], jnp.int32),
                                  jnp.asarray([8], jnp.int32))
    jpools = jg.scatter_program(1, 8, BS)(_jp(pools), jc,
                                          jnp.asarray([[7, 8]], jnp.int32))
    # the 3-token tail (bucket 4) through the pool, tier 4
    ids = np.zeros((2, 4), np.int64)
    ids[0, :3] = full[0, 8:]
    tables = np.array([[7, 8, 2, 0], [0, 0, 0, 0]])
    starts, lens = np.array([8, 0]), np.array([3, 0])
    jpools, jl = jg.tail_prefill_program(2, 4, 4, NB, BS)(
        jn.params, jpools, jnp.asarray(ids, jnp.int32),
        jnp.asarray(starts, jnp.int32), jnp.asarray(lens, jnp.int32),
        jnp.asarray(tables, jnp.int32))
    tpools, tl = tg.tail_prefill_program(2, 4, 4, NB, BS)(
        pc, tpools, ids, starts, lens, tables)
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0], rtol=TOL,
                               atol=TOL)
    _same_pools([{n: p[n][[7, 8, 2]] for n in p} for p in tpools],
                [{n: p[n][jnp.asarray([7, 8, 2])] for n in p} for p in jpools])
    _, want = tg.prefill_program(16)(pc, full, np.array([11]))
    np.testing.assert_allclose(tl[0].numpy(), want[0].numpy(), rtol=TOL,
                               atol=TOL)


def _burst_inputs(tl, lens, tables):
    rows = 4
    tab = np.zeros((rows, 8), np.int64)
    tab[:3, :2] = tables
    # growth blocks for the burst's positions (rows 0, 1 and 2 reach
    # positions 11, 13 and 5)
    tab[0, 2], tab[1, 2:4], tab[2, 1] = 1, [2, 4], 9
    pos = np.zeros(rows, np.int64)
    pos[:3] = lens
    tok = np.zeros(rows, np.int64)
    tok[:3] = tl.argmax(-1)
    n_gen = np.array([1, 1, 1, 0])
    done = np.array([False, False, False, True])
    eos = np.array([-1, int(tok[1]), -1, -1])   # row 1 stops on its EOS
    max_new = np.array([7, 9, 4, 0])            # row 2 on its quota
    return tab, pos, tok, n_gen, done, eos, max_new


def test_greedy_burst_matches_reference(nets):
    jn, tn = nets
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 11, n) for n in (5, 8, 3)]
    jpools, tpools, tables, lens, _, tl = _prefilled(nets, prompts, rng)
    tab, pos, tok, n_gen, done, eos, max_new = _burst_inputs(tl, lens, tables)
    z = np.zeros(4)
    jbp = jgen.build_generator(jn).burst_program(4, 6, 8, NB, BS,
                                                 sampling=False)
    jout = jbp(jn.params, jpools, jnp.asarray(tab, jnp.int32),
               jnp.asarray(pos, jnp.int32), jnp.asarray(tok, jnp.int32),
               jnp.asarray(n_gen, jnp.int32), jnp.asarray(done),
               jnp.zeros((4, 2), jnp.uint32), jnp.asarray(z, jnp.float32),
               jnp.asarray(z, jnp.int32), jnp.asarray(z, jnp.float32),
               jnp.asarray(eos, jnp.int32), jnp.asarray(max_new, jnp.int32))
    tbp = tgen.build_generator(tn).burst_program(4, 6, 8, NB, BS,
                                                 sampling=False)
    assert tbp is tgen.build_generator(tn).burst_program(4, 6, 8, NB, BS,
                                                         sampling=False)
    tout = tbp(tn.cast_params(tn.params), tpools, tab, pos, tok, n_gen,
               done, [0] * 4, z, z, z, eos, max_new)
    for name, got, want in zip(("ys", "tok", "pos", "n_gen", "done"),
                               tout[1:], jout[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    _same_pools(tout[0], jout[0])
    assert tout[5].tolist() == [True, bool(tout[5][1]), True, True]
