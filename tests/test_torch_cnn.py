"""The port's CNN layers, pooling op, normalization layers and
preprocessors against the JAX package, layer by layer.

Each case builds the same layer config in both packages, draws its
parameters and inputs with numpy from a seed, and runs both forwards on
them; gradients are those of ``sum(out * r)`` for a seeded ``r``, with
respect to the input and every parameter. Tolerances are relative to the
largest magnitude of the reference's array: f32 outputs and states 1e-5,
f32 gradients 1e-4 (sums in another order), bf16 3e-2 (bf16 rounds at
slightly different places in the two frameworks). Max pooling is held
on inputs with deliberate ties (post-ReLU zeros and repeated values):
both send a window's gradient to its first maximal cell, and
``maxpool2d`` splits it evenly over every maximal cell. The ``cuda``
cases hold the same layers on the card against the port on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conf.preprocessors as JP
import deeplearning4j_tpu_torch.nn.conf.preprocessors as TP
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.layers.base import build_layer as jax_build
from deeplearning4j_tpu.ops.pooling import maxpool2d as jax_maxpool2d
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import build_layer
from deeplearning4j_tpu_torch.ops.pooling import maxpool2d

F32, GRAD, BF16 = 1e-5, 1e-4, 3e-2


def assert_close(got, want, tol):
    """|got - want| <= tol * max |want|; infinities (a window wholly in
    the padding pools to -inf) must sit at the same places."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    got, want = got[fin], want[fin]
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0)) / scale
    assert err <= tol, f"max error {err:.3g} of max |want| {scale:.3g} > {tol}"


def _impls(name, **kw):
    jimpl = jax_build(JaxNNC(activation="identity"), getattr(JL, name)(**kw),
                      "layer0")
    timpl = build_layer(NeuralNetConfiguration(activation="identity"),
                        getattr(L, name)(**kw), "layer0")
    return jimpl, timpl


def _jax_params(jimpl, seed):
    """numpy parameters of the JAX impl's shapes, drawn from a seed."""
    rng = np.random.default_rng(seed)
    shapes = {k: v.shape for k, v in jimpl.init_params(jax.random.PRNGKey(0)).items()}
    return {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
            for k, s in shapes.items()}


def _r(shape, seed):
    """The seeded cotangent: gradients are those of sum(out * r)."""
    return np.random.default_rng(seed).standard_normal(tuple(shape)).astype(np.float32)


def _run_jax(jimpl, p, x, seed, state, train, dtype, mask=None):
    def f(p, x, r):
        out, ns = jimpl.forward({k: v.astype(dtype) for k, v in p.items()},
                                x.astype(dtype), state, train, mask=mask)
        return jnp.sum(out.astype(jnp.float32) * r), (out, ns)

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    r = _r(f(jp, jnp.asarray(x), 0.0)[1][0].shape, seed)
    (_, (out, ns)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x), r)
    return out, ns, gp, gx


def _run_port(timpl, p, x, seed, state, train, dtype, device="cpu", mask=None):
    tp = {k: torch.tensor(v, device=device).requires_grad_() for k, v in p.items()}
    tx = torch.tensor(x, device=device).requires_grad_()
    ts = {k: torch.tensor(np.asarray(v), device=device) for k, v in state.items()}
    tm = None if mask is None else torch.tensor(mask, device=device)
    out, ns = timpl.forward({k: v.to(dtype) for k, v in tp.items()}, tx.to(dtype),
                            ts, train, mask=tm)
    r = torch.tensor(_r(out.shape, seed), device=device)
    torch.sum(out.float() * r).backward()
    gp = {k: v.grad for k, v in tp.items()}
    return out, ns, gp, tx.grad


def _host(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _compare(name, kw, x, seed=0, state=None, train=False, bf16=False, mask=None):
    jimpl, timpl = _impls(name, **kw)
    p = _jax_params(jimpl, seed)
    state = state or {}
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jout, jns, jgp, jgx = _run_jax(jimpl, p, x, seed + 1, state, train, jdt, mask)
    tout, tns, tgp, tgx = _run_port(timpl, p, x, seed + 1, state, train, tdt,
                                    mask=mask)
    assert tout.dtype == tdt
    out_tol, grad_tol = (BF16, BF16) if bf16 else (F32, GRAD)
    assert_close(_host(tout), np.asarray(jout, np.float32), out_tol)
    assert_close(_host(tgx), np.asarray(jgx, np.float32), grad_tol)
    assert set(tgp) == set(jgp)
    for k in jgp:
        assert_close(_host(tgp[k]), np.asarray(jgp[k], np.float32), grad_tol)
    assert set(tns) == set(jns)
    for k in jns:
        assert_close(_host(tns[k]), np.asarray(jns[k], np.float32), out_tol)
    return timpl, p


def _images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


CONV_CASES = {
    "3x3": dict(kernel_size=(3, 3)),
    "stride2_pad1": dict(kernel_size=(3, 3), stride=(2, 2), padding=(1, 1)),
    "pad_h1_w2_no_bias": dict(kernel_size=(3, 2), padding=(1, 2), has_bias=False),
    "same_5x5": dict(kernel_size=(5, 5), convolution_mode="same"),
    "same_stride2": dict(kernel_size=(3, 3), stride=(2, 2), convolution_mode="same"),
    "same_stride2_even_kernel": dict(kernel_size=(4, 2), stride=(2, 3),
                                     convolution_mode="same", has_bias=False),
    "stride_3x1": dict(kernel_size=(2, 3), stride=(3, 1)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_matches_reference(case):
    kw = dict(n_in=3, n_out=5, activation="tanh", **CONV_CASES[case])
    timpl, p = _compare("ConvolutionLayer", kw, _images((2, 9, 8, 3)))
    assert ("b" in p) == kw.get("has_bias", True)
    assert p["W"].shape == (kw["kernel_size"][0], kw["kernel_size"][1], 3, 5)


@pytest.mark.parametrize("case", ["3x3", "same_stride2"])
def test_convolution_bf16_matches_reference(case):
    kw = dict(n_in=3, n_out=5, activation="relu", **CONV_CASES[case])
    _compare("ConvolutionLayer", kw, _images((2, 9, 8, 3)), bf16=True)


def test_convolution_init_fans_and_no_bias():
    """HWIO weights with the receptive-field fans; has_bias=False leaves
    no bias parameter."""
    gc = NeuralNetConfiguration(weight_init="relu")
    impl = build_layer(gc, L.ConvolutionLayer(n_in=4, n_out=64, kernel_size=(5, 5),
                                              has_bias=False), "c")
    p = impl.init_params(torch.Generator().manual_seed(0), "cpu")
    assert set(p) == {"W"} and p["W"].shape == (5, 5, 4, 64)
    assert abs(p["W"].std().item() - (2.0 / (4 * 25)) ** 0.5) < 0.01


POOL_CASES = {
    "max": dict(pooling_type="max"),
    "max_pad": dict(pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
                    padding=(1, 1)),
    "max_wide_pad": dict(pooling_type="max", kernel_size=(2, 2), stride=(1, 1),
                         padding=(2, 1)),
    "avg": dict(pooling_type="avg"),
    "avg_pad": dict(pooling_type="avg", kernel_size=(3, 3), stride=(2, 2),
                    padding=(1, 1)),
    "sum": dict(pooling_type="sum", kernel_size=(3, 2), stride=(1, 2)),
    "sum_pad": dict(pooling_type="sum", kernel_size=(2, 2), padding=(1, 0)),
    "pnorm": dict(pooling_type="pnorm", pnorm=3),
    "pnorm_pad": dict(pooling_type="pnorm", pnorm=2, kernel_size=(3, 3),
                      stride=(1, 1), padding=(1, 1)),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_subsampling_matches_reference(case):
    _compare("SubsamplingLayer", POOL_CASES[case], _images((2, 7, 6, 3)))


@pytest.mark.parametrize("case", ["max", "avg_pad"])
def test_subsampling_bf16_matches_reference(case):
    _compare("SubsamplingLayer", POOL_CASES[case], _images((2, 7, 6, 3)), bf16=True)


def _tied(shape, seed=0):
    """Post-ReLU values on a coarse grid: zero plateaus and repeats."""
    x = np.random.default_rng(seed).standard_normal(shape)
    return np.maximum(np.round(x * 2) / 2, 0).astype(np.float32)


@pytest.mark.parametrize("case", ["max", "max_pad", "max_wide_pad"])
def test_max_pool_gradient_at_ties_matches_reference(case):
    """The reference's default max-pool gradient (XLA's) and the port's
    both send a window's gradient to its first maximal cell; LeNet's
    post-ReLU zeros make such ties common."""
    x = _tied((2, 8, 6, 3))
    assert (x == 0).mean() > 0.4
    _compare("SubsamplingLayer", POOL_CASES[case], x)


@pytest.mark.parametrize("geom", [((2, 2), (2, 2), (0, 0)),
                                  ((3, 3), (2, 2), (1, 1)),
                                  ((3, 2), (1, 2), (1, 0))])
def test_maxpool2d_mask_backward_matches_reference(geom):
    """``maxpool2d``'s equality-mask backward: each window's gradient
    split evenly over all its maximal cells, on inputs with ties."""
    window, strides, pads = geom
    x = _tied((2, 7, 6, 3), seed=4)
    y = np.asarray(jax_maxpool2d(jnp.asarray(x), window, strides, pads))
    r = np.random.default_rng(5).standard_normal(y.shape).astype(np.float32)
    gx = jax.grad(lambda v: jnp.sum(jax_maxpool2d(v, window, strides, pads) * r))(
        jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ty = maxpool2d(tx, window, strides, pads)
    torch.sum(ty * torch.tensor(r)).backward()
    np.testing.assert_array_equal(ty.detach().numpy(), y)
    assert_close(tx.grad.numpy(), np.asarray(gx), F32)
    # the gradient mass of every window is preserved
    assert abs(tx.grad.sum().item() - r.sum()) < 1e-3


BN_CASES = {
    "ff": ((8, 5), dict(n_in=5, n_out=5)),
    "cnn": ((4, 3, 3, 2), dict(n_in=2, n_out=2, decay=0.8, eps=1e-3)),
    "ff_locked": ((6, 4), dict(n_in=4, n_out=4, lock_gamma_beta=True,
                               gamma=1.5, beta=-0.25)),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_normalization_matches_reference(case, train):
    """Training: the batch's one-pass biased moments, and the moving
    state d * old + (1 - d) * batch; inference: the state."""
    shape, kw = BN_CASES[case]
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(shape) * 2.0 + 0.7).astype(np.float32)
    n = kw["n_out"]
    state = {"mean": rng.standard_normal(n).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
    timpl, p = _compare("BatchNormalization", kw, x, state=state, train=train)
    assert set(p) == (set() if kw.get("lock_gamma_beta") else {"gamma", "beta"})


def test_batch_normalization_bf16_matches_reference():
    x = _images((4, 3, 3, 6)) * 3.0
    state = {"mean": np.zeros(6, np.float32), "var": np.ones(6, np.float32)}
    _compare("BatchNormalization", dict(n_in=6, n_out=6), x, state=state,
             train=True, bf16=True)


@pytest.mark.parametrize("n", [5, 4, 3, 2])
def test_local_response_normalization_matches_reference(n):
    """Odd and even windows (the even window's extra channel after the
    centre)."""
    _compare("LocalResponseNormalization", dict(n=float(n), k=1.5, alpha=0.1,
                                                beta=0.75), _images((2, 3, 3, 7)))


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("pt", ["max", "avg", "sum"])
def test_global_pooling_over_time_matches_reference(pt, masked):
    """[b, t, f] -> [b, f]; with a features mask only the kept steps
    count (a row with no kept step averages to 0)."""
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]],
                    np.float32) if masked else None
    _compare("GlobalPoolingLayer", dict(pooling_type=pt), _images((3, 5, 4)),
             mask=mask)


@pytest.mark.parametrize("pt", ["max", "avg", "sum"])
def test_global_pooling_over_space_matches_reference(pt):
    _compare("GlobalPoolingLayer", dict(pooling_type=pt), _images((2, 4, 3, 5)))


def test_global_pnorm_pooling_raises_as_the_reference_does():
    """GlobalPoolingLayer has no pnorm field: the reference's PNORM path
    raises on it too (ROADMAP Queue C)."""
    jimpl, timpl = _impls("GlobalPoolingLayer", pooling_type="pnorm")
    with pytest.raises(AttributeError):
        jimpl.forward({}, jnp.ones((2, 3, 4)), {}, False)
    with pytest.raises(ValueError, match="pnorm"):
        timpl.forward({}, torch.ones(2, 3, 4), {}, False)


@pytest.mark.parametrize("case", ["dense", "dense_no_bias", "activation",
                                  "embedding", "dropout_infer"])
def test_feed_forward_layers_match_reference(case):
    x = _images((6, 4))
    kw = dict(dense=("DenseLayer", dict(n_in=4, n_out=3, activation="tanh")),
              dense_no_bias=("DenseLayer", dict(n_in=4, n_out=3, has_bias=False,
                                                activation="sigmoid")),
              activation=("ActivationLayer", dict(activation="softsign")),
              embedding=("EmbeddingLayer", dict(n_in=7, n_out=3,
                                                activation="relu")),
              dropout_infer=("DropoutLayer", dict(dropout=0.5)))[case]
    if case == "embedding":  # ids as exact floats, as the container feeds them
        x = np.array([[2], [5], [0], [6], [2], [1]], np.float32)
        jimpl, timpl = _impls(*kw[:1], **kw[1])
        p = _jax_params(jimpl, 0)
        jout, _ = jimpl.forward({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), {}, False)
        tout, _ = timpl.forward({k: torch.tensor(v) for k, v in p.items()},
                                torch.tensor(x), {}, False)
        assert_close(tout.numpy(), np.asarray(jout), F32)
        return
    timpl, p = _compare(kw[0], kw[1], x)
    assert ("b" in p) == (case == "dense")


def test_dropout_layer_trains_with_its_rate():
    """Inverted dropout in training: about half the units zeroed, the
    rest scaled by 2 (torch cannot replay jax.random's bits)."""
    _, timpl = _impls("DropoutLayer", dropout=0.5)
    x = torch.ones(64, 64)
    out, _ = timpl.forward({}, x, {}, True, rng=3)
    kept = (out != 0).float().mean().item()
    assert abs(kept - 0.5) < 0.05 and torch.all(out[out != 0] == 2.0)
    assert timpl.forward({}, x, {}, False, rng=3)[0] is x


PREPROCESSORS = {
    "CnnToFeedForwardPreProcessor": ({}, (2, 3, 4, 5), InputType.convolutional(3, 4, 5)),
    "FeedForwardToCnnPreProcessor": (dict(height=2, width=3, channels=4), (2, 24),
                                     InputType.feed_forward(24)),
    "RnnToFeedForwardPreProcessor": ({}, (2, 5, 3), InputType.recurrent(3, 5)),
    "FeedForwardToRnnPreProcessor": (dict(timesteps=5), (10, 3),
                                     InputType(kind="ff", size=3, timesteps=5)),
    "CnnToRnnPreProcessor": ({}, (2, 3, 4, 5), InputType.convolutional(3, 4, 5)),
    "RnnToCnnPreProcessor": (dict(height=2, width=3, channels=4), (2, 5, 24),
                             InputType.recurrent(24, 5)),
    "ReshapePreprocessor": (dict(shape=(6, 4)), (2, 3, 8), InputType.recurrent(8, 3)),
    "ZeroMeanPrePreProcessor": ({}, (3, 4, 5), InputType.recurrent(5, 4)),
    "UnitVarianceProcessor": ({}, (3, 2, 2, 5), InputType.convolutional(2, 2, 5)),
    "ComposableInputPreProcessor": ("chain", (3, 24), InputType.feed_forward(24)),
}


def _pre(mod, name, kw):
    if kw == "chain":
        return mod.ComposableInputPreProcessor(children=(
            mod.ZeroMeanPrePreProcessor(), mod.UnitVarianceProcessor(),
            mod.FeedForwardToCnnPreProcessor(height=2, width=3, channels=4)))
    return getattr(mod, name)(**kw)


@pytest.mark.parametrize("name", sorted(PREPROCESSORS))
def test_preprocessor_matches_reference(name):
    """Output and gradient (1e-5: reshapes are exact; the mean and std
    sum in another order), the output type, and the JSON form, which
    parses back in both packages."""
    kw, shape, in_type = PREPROCESSORS[name]
    jp, tp = _pre(JP, name, kw), _pre(TP, name, kw)
    x = _images(shape, seed=9) * 3 + 1
    jy = np.asarray(jp(jnp.asarray(x)))
    r = np.random.default_rng(2).standard_normal(jy.shape).astype(np.float32)
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jp(v) * r))(jnp.asarray(x)))
    tx = torch.tensor(x, requires_grad=True)
    ty = tp(tx)
    torch.sum(ty * torch.tensor(r)).backward()
    assert_close(ty.detach().numpy(), jy, F32)
    assert_close(tx.grad.numpy(), jg, F32)
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
    j_out = jp.output_type(JaxInputType.from_dict(in_type.to_dict()))
    assert tp.output_type(in_type).to_dict() == j_out.to_dict()
    assert tp.to_dict() == jp.to_dict()
    assert TP.preprocessor_from_dict(jp.to_dict()) == tp
    assert JP.preprocessor_from_dict(tp.to_dict()) == jp


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


CARD_CASES = {
    "conv": ("ConvolutionLayer", dict(n_in=3, n_out=8, kernel_size=(5, 5),
                                      activation="relu")),
    "conv_same_stride2": ("ConvolutionLayer", dict(n_in=3, n_out=8, kernel_size=(3, 3),
                                                   stride=(2, 2), convolution_mode="same",
                                                   has_bias=False)),
    "max_pool": ("SubsamplingLayer", dict(pooling_type="max")),
    "avg_pool_pad": ("SubsamplingLayer", POOL_CASES["avg_pad"]),
    "pnorm_pool": ("SubsamplingLayer", POOL_CASES["pnorm"]),
    "bn_train": ("BatchNormalization", dict(n_in=3, n_out=3)),
    "lrn": ("LocalResponseNormalization", dict(n=4.0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_layers_on_card_match_cpu(cuda_device, case, dtype):
    """Forward and gradients on the card against the port on the CPU:
    f32 within 1e-4 relative, with cuDNN's TF32 switched on around the
    call (PyTorch's default) to show the layer computes in f32 anyway;
    bf16 within 3e-2."""
    name, kw = CARD_CASES[case]
    jimpl, timpl = _impls(name, **kw)
    p = _jax_params(jimpl, 0)
    x = _tied((8, 12, 12, 3)) + _images((8, 12, 12, 3)) * 0.1
    state = ({"mean": np.zeros(3, np.float32), "var": np.ones(3, np.float32)}
             if name == "BatchNormalization" else {})
    train = name == "BatchNormalization"
    tdt = getattr(torch, dtype)
    want = _run_port(timpl, p, x, 1, state, train, tdt)
    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision
    conv.fp32_precision = "tf32"
    try:
        got = _run_port(timpl, p, x, 1, state, train, tdt, device=cuda_device)
    finally:
        conv.fp32_precision = prev
    assert conv.fp32_precision == prev
    tol = 1e-4 if dtype == "float32" else BF16
    for g, w in zip(got[:1] + got[3:], want[:1] + want[3:]):
        assert_close(_host(g), _host(w), tol)
    for k in want[2]:
        assert_close(_host(got[2][k]), _host(want[2][k]), tol)
    for k in want[1]:
        assert_close(_host(got[1][k]), _host(want[1][k]), tol)
