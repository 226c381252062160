"""The port's GPT serving slice against the JAX package.

A small JAX ``gpt`` (vocab 64, d_model 32, 2 layers, 4 heads, max_len
64) is initialised and its parameters carried into the port's net;
prompts come from a numpy seed. Forward, prefill and decode agree within
1e-4 in f32, and greedy generation agrees token for token on both sides
of the flash dispatch (prompt 3 pads to bucket 4, the plain path;
prompt 16 takes the kernel branch, run by its plain version on the CPU).
Sampled paths cannot replay ``jax.random``: the filters are compared on
identical logits and the draws by their distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo.transformer import gpt as jax_gpt
from deeplearning4j_tpu.nn import generate as jgen
from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.models.zoo.transformer import gpt, generate
from deeplearning4j_tpu_torch.nn import generate as tgen
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

SIZE = dict(vocab_size=64, d_model=32, n_layers=2, num_heads=4, max_len=64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _pair(compute_dtype="float32", seed=3, device="cpu", size=SIZE):
    jn = jax_gpt(compute_dtype=compute_dtype, seed=seed, **size).init()
    tn = gpt(compute_dtype=compute_dtype, seed=seed, device=device, **size)
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    return jn, tn


@pytest.fixture(scope="module")
def nets():
    return _pair()


def _prompt(b, t, seed=0):
    return np.random.default_rng(seed).integers(0, SIZE["vocab_size"], (b, t))


def test_output_matches(nets):
    jn, tn = nets
    x = _prompt(3, 20)
    np.testing.assert_allclose(tn.output(x), np.asarray(jn.output(x)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t", [3, 16])
def test_prefill_caches_and_logits_match(nets, t):
    jn, tn = nets
    b, max_new = 2, 5
    jg, tg = jgen.build_generator(jn), tgen.build_generator(tn)
    t_pad = tg.prompt_bucket(t, max_new)
    assert t_pad == jg.prompt_bucket(t, max_new)
    ids = np.zeros((b, t_pad), np.int64)
    ids[:, :t] = _prompt(b, t)
    lengths = np.array([t, t - 1])
    jc, jl = jg._get_prefill(t_pad + max_new)(
        jn.params, jnp.asarray(ids, jnp.int32), jnp.asarray(lengths, jnp.int32))
    tc, tl = tg.prefill(tn.cast_params(tn.params), torch.tensor(ids),
                        torch.tensor(lengths), t_pad + max_new)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                               rtol=1e-4, atol=1e-4)
    for j, c in zip(jc, tc):
        for name in ("k", "v"):
            np.testing.assert_allclose(c[name].numpy(),
                                       np.asarray(j[name], np.float32),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pos", [7, "rows"])
def test_decode_step_matches(nets, pos):
    jn, tn = nets
    rng = np.random.default_rng(1)
    b, L = 3, 12
    cache = {n: rng.standard_normal((b, L, 4, 8)).astype(np.float32)
             for n in ("k", "v")}
    x = rng.standard_normal((b, 32)).astype(np.float32)
    p = np.array([2, 7, 11]) if pos == "rows" else pos
    jblk, tblk = jn.impls[1], tn.impls[1]
    jy, jc = jblk.decode_step(jn.params["layer1"], jnp.asarray(x),
                              {n: jnp.asarray(a) for n, a in cache.items()},
                              jnp.asarray(p, jnp.int32))
    ty, tc = tblk.decode_step(tn.params["layer1"], torch.tensor(x),
                              {n: torch.tensor(a) for n, a in cache.items()},
                              torch.tensor(p) if pos == "rows" else p)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy, np.float32),
                               rtol=1e-4, atol=1e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(),
                                   np.asarray(jc[n], np.float32),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t", [3, 16])
def test_greedy_generate_matches_token_for_token(nets, t):
    jn, tn = nets
    prompt = _prompt(3, t, seed=t)
    want = np.asarray(jn.generate(prompt, 20))
    got = generate(tn, prompt, 20)
    assert got.dtype == np.int64 and got.shape == (3, t + 20)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tgen.generate_eager(tn, prompt, 20), want)


def test_eos_fills_the_rest_of_a_finished_row(nets):
    jn, tn = nets
    prompt = _prompt(3, 16, seed=5)
    free = np.asarray(jn.generate(prompt, 12))
    eos = int(free[0, 16 + 3])  # row 0 emits it at step 3
    want = np.asarray(jn.generate(prompt, 12, eos_token=eos))
    got = tn.generate(prompt, 12, eos_token=eos)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tgen.generate_eager(tn, prompt, 12, eos_token=eos), want)
    assert (got[0, 16 + 3:] == eos).all()


@pytest.mark.parametrize("eos", [None, 5])
def test_ragged_lengths_run_matches(nets, eos):
    """Rows of one bucket with their own lengths (a zero-length serving
    pad row included) through ``TransformerGenerator.run``."""
    jn, tn = nets
    b, t_pad, max_new = 4, 16, 10
    ids = np.zeros((b, t_pad), np.int64)
    lengths = np.array([16, 9, 1, 0])
    for r, n in enumerate(lengths):
        ids[r, :n] = _prompt(1, max(n, 1), seed=10 + r)[0, :n]
    sig = jgen.sampler_sig(eos_token=eos)
    want = jgen.build_generator(jn).run(jn.params, ids.astype(np.int32),
                                        lengths.astype(np.int32), max_new,
                                        sig, jgen.row_keys(0, b))
    tg = tgen.build_generator(tn)
    keys = tgen.row_keys(0, b)
    got = tg.run(tn.params, ids, lengths, max_new,
                 tgen.sampler_sig(eos_token=eos), keys)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        tg.run_eager(tn.params, ids, lengths, max_new,
                     tgen.sampler_sig(eos_token=eos), keys), np.asarray(want))


def test_bf16_first_step_logits_close():
    jn, tn = _pair("bfloat16")
    b, t, max_new = 2, 16, 4
    ids = _prompt(b, t, seed=2)
    lengths = np.full(b, t)
    _, jl = jgen.build_generator(jn)._get_prefill(t + max_new)(
        jn.params, jnp.asarray(ids, jnp.int32), jnp.asarray(lengths, jnp.int32))
    tg = tgen.build_generator(tn)
    caches, tl = tg.prefill(tn.cast_params(tn.params), torch.tensor(ids),
                            torch.tensor(lengths), t + max_new)
    assert caches[0]["k"].dtype == torch.bfloat16
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("knobs", [
    (1.0, 0, 0.0), (0.7, 5, 0.0), (1.3, 0, 0.8), (0.9, 10, 0.6),
])
def test_filter_logits_match(knobs):
    temp, k, p = knobs
    lg = np.random.default_rng(4).standard_normal((5, 32)).astype(np.float32) * 3
    b = lg.shape[0]
    want = jgen._filter_logits(jnp.asarray(lg), jnp.full(b, temp, jnp.float32),
                               jnp.full(b, k, jnp.int32),
                               jnp.full(b, p, jnp.float32))
    got = tgen._filter_logits(torch.tensor(lg), torch.full((b,), temp),
                              torch.full((b,), k), torch.full((b,), p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("knobs", [(1.0, 0, 0.0), (0.8, 4, 0.0),
                                   (1.2, 0, 0.7), (1.0, 5, 0.9)])
def test_sampled_draws_follow_the_filtered_softmax(knobs):
    """Chi-square over a vocab-8 toy: 4000 rows, each with its own key,
    sample one token from the same logits; the counts must fit the
    reference filter's softmax (df = support - 1, p = 1e-3)."""
    temp, k, p = knobs
    vocab, n = 8, 4000
    lg = np.array([[2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0]], np.float32)
    filt = jgen._filter_logits(jnp.asarray(lg), jnp.full(1, temp, jnp.float32),
                               jnp.full(1, k, jnp.int32),
                               jnp.full(1, p, jnp.float32))
    probs = np.asarray(jax.nn.softmax(filt, axis=-1), np.float64)[0]
    logits = torch.tensor(np.repeat(lg, n, axis=0))
    toks = tgen.sample_tokens(logits, tgen.row_keys(11, n), 0, temp, k, p)
    counts = np.bincount(toks.numpy(), minlength=vocab)
    support = probs > 1e-12
    assert counts[~support].sum() == 0
    expected = probs[support] * n
    chi2 = float((((counts[support] - expected) ** 2) / expected).sum())
    # p = 1e-3 critical values of chi-square for df = 1..7
    crit = [10.83, 13.82, 16.27, 18.47, 20.52, 22.46, 24.32]
    assert chi2 < crit[support.sum() - 2], (chi2, counts, expected)


def test_rowwise_draws_independent_of_batch_mates():
    lg = torch.tensor(np.random.default_rng(6).standard_normal((4, 16)),
                      dtype=torch.float32)
    keys = tgen.row_keys(3, 4)
    knobs = (torch.full((4,), 1.0), torch.zeros(4, dtype=torch.long),
             torch.zeros(4))
    folds = torch.tensor([0, 1, 2, 3])
    both = tgen.sample_tokens_rowwise(lg, keys, folds, *knobs)
    solo = tgen.sample_tokens_rowwise(lg[2:3], keys[2:3], folds[2:3],
                                      *(z[2:3] for z in knobs))
    assert int(both[2]) == int(solo[0])
    greedy = tgen.sample_tokens_rowwise(lg, keys, folds, torch.zeros(4),
                                        *knobs[1:])
    np.testing.assert_array_equal(greedy.numpy(), lg.argmax(-1).numpy())


def test_sampled_generate_is_reproducible_and_matches_eager(nets):
    _, tn = nets
    prompt = _prompt(2, 16, seed=8)
    kw = dict(temperature=0.9, top_k=20, top_p=0.9, seed=4)
    a = tn.generate(prompt, 10, **kw)
    np.testing.assert_array_equal(a, tn.generate(prompt, 10, **kw))
    np.testing.assert_array_equal(a, tgen.generate_eager(tn, prompt, 10, **kw))


def test_moe_block_raises():
    with pytest.raises(NotImplementedError, match="experts"):
        gpt(num_experts=2, compute_dtype="float32", device="cpu", **SIZE)


def test_bad_requests_raise(nets):
    _, tn = nets
    with pytest.raises(ValueError, match="max_len"):
        tn.generate(_prompt(1, 60), 10)
    with pytest.raises(ValueError, match="max_new_tokens"):
        tn.generate(_prompt(1, 4), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [
    SIZE,                                  # head size 8: padded to 64
    dict(SIZE, d_model=128, num_heads=2),  # head size 64
], ids=["head8", "head64"])
def test_generate_on_card_runs_the_kernel(cuda_device, size):
    _, tn = _pair("bfloat16", device=cuda_device, size=size)
    prompt = _prompt(4, 16)
    kernels.reset_launches()
    got = tn.generate(prompt, 12)
    assert kernels.LAUNCHES["flash_fwd"] == size["n_layers"]
    np.testing.assert_array_equal(got, tgen.generate_eager(tn, prompt, 12))
