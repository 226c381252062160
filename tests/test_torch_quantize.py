"""The port's weight quantization against the JAX package.

``quantize_array`` gives the reference's int8 and fp8-e4m3 values and
scales bit for bit on numpy-seeded matrices; ``quantize`` of a net with
carried parameters gives the reference's quantized tree bit for bit
(the same keys, dtypes and values; the 3-D MoE experts stay f32), and
its byte count. The quantized nets (a dense classifier and a small
``gpt``, f32) give the reference's outputs and teacher-forced logits
within 1e-5 (relative to the largest magnitude), greedy ``generate``
token for token, and ``accuracy_gate``'s numbers on the same ids (the
match rate exactly, the rest within 1e-5). An int8 zip goes both ways;
an fp8 zip is written as the reference writes it and, as in the
reference, does not restore. ``fit`` refuses a quantized net.
"""

import io
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.quantize as jq
import deeplearning4j_tpu_torch.nn.quantize as tq
from deeplearning4j_tpu.models.zoo.transformer import gpt as jax_gpt
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.configuration import (
    MultiLayerConfiguration as JaxMLC,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import model_serializer as tser
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

F32 = 1e-5
SIZE = dict(vocab_size=64, d_model=32, n_layers=2, num_heads=4, max_len=64,
            compute_dtype="float32")
MODES = ("int8", "fp8")


def _np(tree):
    """The reference's params as numpy, each in its own dtype (fp8 as
    ml_dtypes' float8_e4m3fn)."""
    return jax.tree.map(np.asarray, tree)


def _bits(t):
    """A tensor's values as raw integers (fp8 by its bytes)."""
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max error {err:.3g} of max |want| {scale:.3g} > {tol}"


def _pair(text):
    jn = JaxMLN(JaxMLC.from_json(text)).init()
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(text), device="cpu")
    params_from_numpy(tn, jax.tree.map(lambda a: np.asarray(a, np.float32),
                                       jn.params))
    return jn, tn


def _dense_text():
    return (JaxNNC.builder().seed(4).activation("relu").weight_init("xavier")
            .list()
            .layer(JL.DenseLayer(n_in=10, n_out=16))
            .layer(JL.DenseLayer(n_in=16, n_out=12, activation="tanh"))
            .layer(JL.OutputLayer(n_in=12, n_out=4, activation="softmax",
                                  loss_function="mcxent"))
            .build().to_json())


@pytest.fixture(scope="module")
def gpts():
    return _pair(jax_gpt(seed=2, **SIZE).conf.to_json())


def _assert_same_tree(tparams, jparams):
    assert set(tparams) == set(jparams)
    for layer, p in jparams.items():
        assert list(tparams[layer]) == list(p), layer
        for name, w in p.items():
            t = tparams[layer][name]
            assert str(t.dtype).split(".")[-1] == np.asarray(w).dtype.name, \
                (layer, name, t.dtype, np.asarray(w).dtype)
            np.testing.assert_array_equal(_bits(t), _jbits(w),
                                          err_msg=f"{layer}/{name}")


# ------------------------------------------------------ quantize_array

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 0.02), (2, 300.0)])
def test_quantize_array_bit_for_bit(mode, seed, scale):
    w = (np.random.default_rng(seed).standard_normal((37, 29)) * scale
         ).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column: the scale floor
    w[5, 7] = 4 * scale  # one outlier
    jqv, jsc = jq.quantize_array(jnp.asarray(w), mode)
    tqv, tsc = tq.quantize_array(torch.tensor(w), mode)
    assert tqv.dtype == (torch.int8 if mode == "int8" else torch.float8_e4m3fn)
    np.testing.assert_array_equal(_bits(tqv), _jbits(jqv))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(
        tq.dequantize_array(tqv, tsc).numpy(),
        np.asarray(jq.dequantize_array(jqv, jsc)))


def test_quantize_array_errors():
    with pytest.raises(ValueError, match="unknown quantization dtype"):
        tq.quantize_array(torch.zeros(2, 2), "int4")
    with pytest.raises(ValueError, match="2-D matrix"):
        tq.quantize_array(torch.zeros(2, 2, 2), "int8")
    assert tq.quant_modes() == jq.quant_modes()


@pytest.mark.parametrize("mode", MODES)
def test_qmatmul_and_qtake_scale_after(mode):
    """``(x @ q) * s``, the scale never folded into the weight, and a
    gather that scales its rows; unquantized weights pass through."""
    w = np.random.default_rng(3).standard_normal((6, 5)).astype(np.float32)
    q, sc = tq.quantize_array(torch.tensor(w), mode)
    x = torch.tensor(np.random.default_rng(4).standard_normal((3, 6)),
                     dtype=torch.float32)
    p = {"W": q, "W" + tq.QSCALE: sc}
    assert torch.equal(tq.qmatmul(x, p, "W"), (x @ q.float()) * sc)
    idx = torch.tensor([4, 0, 4])
    assert torch.equal(tq.qtake(p, "W", idx), q[idx].float() * sc)
    plain = {"W": torch.tensor(w)}
    assert torch.equal(tq.qmatmul(x, plain, "W"), x @ plain["W"])
    assert torch.equal(tq.qtake(plain, "W", idx), plain["W"][idx])
    assert tq.is_quantized(p, "W") and not tq.is_quantized(plain, "W")


# ----------------------------------------------------------- quantize

@pytest.mark.parametrize("mode", MODES)
def test_quantize_dense_net_matches(mode):
    jn, tn = _pair(_dense_text())
    jqn, tqn = jq.quantize(jn, mode), tq.quantize(tn, mode)
    _assert_same_tree(tqn.params, jqn.params)
    assert tqn.quantized == mode and tn.quantized is None
    assert tq.quantized_param_bytes(tqn.params) == \
        jq.quantized_param_bytes(jqn.params)
    x = np.random.default_rng(5).standard_normal((7, 10)).astype(np.float32)
    _close(tqn.output(x), np.asarray(jqn.output(x)), F32)
    with pytest.raises(ValueError, match="already quantized"):
        tq.quantize(tqn, mode)


@pytest.mark.parametrize("mode", MODES)
def test_quantize_gpt_logits_and_generate_match(gpts, mode):
    jn, tn = gpts
    jqn, tqn = jq.quantize(jn, mode), tq.quantize(tn, mode)
    _assert_same_tree(tqn.params, jqn.params)
    ids = jq.gate_workload(SIZE["vocab_size"], rows=3, length=16, seed=1)
    _close(tq._sequence_logits(tqn, ids), jq._sequence_logits(jqn, ids), F32)
    prompt = np.random.default_rng(6).integers(0, SIZE["vocab_size"], (2, 9))
    np.testing.assert_array_equal(tqn.generate(prompt, 10),
                                  np.asarray(jqn.generate(prompt, 10)))


def test_moe_experts_stay_float():
    text = jax_gpt(seed=2, num_experts=4, **SIZE).conf.to_json()
    jn, tn = _pair(text)
    jqn, tqn = jq.quantize(jn, "int8"), tq.quantize(tn, "int8")
    _assert_same_tree(tqn.params, jqn.params)
    blk = tqn.params["layer1"]
    assert blk["W1"].dtype == torch.float32 and "W1_qscale" not in blk
    assert blk["Wqkv"].dtype == torch.int8
    prompt = np.random.default_rng(7).integers(0, SIZE["vocab_size"], (2, 9))
    np.testing.assert_array_equal(tqn.generate(prompt, 8),
                                  np.asarray(jqn.generate(prompt, 8)))


@pytest.mark.parametrize("mode", MODES)
def test_accuracy_gate_numbers_match(gpts, mode):
    jn, tn = gpts
    jqn, tqn = jq.quantize(jn, mode), tq.quantize(tn, mode)
    want = jq.accuracy_gate(jn, jqn)
    got = tq.accuracy_gate(tn, tqn)
    assert got["positions"] == want["positions"]
    assert got["greedy_match_rate"] == want["greedy_match_rate"]
    assert got["passed"] == want["passed"]
    assert got["thresholds"] == want["thresholds"]
    for k in ("logit_mse", "eval_metric", "eval_metric_ref"):
        assert got[k] == pytest.approx(want[k], rel=F32, abs=1e-9), k
    assert got["eval_metric_delta"] == pytest.approx(
        want["eval_metric_delta"], abs=1e-5)
    self_gate = tq.accuracy_gate(tn, tn)
    assert self_gate["passed"] and self_gate["greedy_match_rate"] == 1.0
    gate = tq.make_quality_gate(rows=2, length=8)
    assert gate(None, tqn)["passed"]
    assert gate(tn, tqn)["positions"] == 16


def test_fit_refuses_a_quantized_net():
    import deeplearning4j_tpu_torch.nn.conf.layers as TL
    import deeplearning4j_tpu_torch.nn.graph as TG
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration

    _, tn = _pair(_dense_text())
    q = tq.quantize(tn, "int8")
    x = np.zeros((2, 10), np.float32)
    y = np.eye(4, dtype=np.float32)[[0, 1]]
    with pytest.raises(ValueError, match="int8-quantized serving weights"):
        q.fit(DataSet(x, y))
    g = TG.ComputationGraph(
        TG.ComputationGraphConfiguration.builder(
            NeuralNetConfiguration(seed=1, weight_init="xavier"))
        .add_inputs("in")
        .add_layer("out", TL.OutputLayer(n_in=10, n_out=4, activation="softmax"),
                   "in")
        .set_outputs("out").build(), device="cpu").init()
    gq = tq.quantize(g, "fp8")
    assert gq.params["out"]["W"].dtype == torch.float8_e4m3fn
    with pytest.raises(ValueError, match="fp8-quantized serving weights"):
        gq.fit(DataSet(x, y))


# ------------------------------------------------------------ the zip

def test_int8_zip_goes_both_ways(gpts, tmp_path):
    jn, tn = gpts
    jqn = jq.quantize(jn, "int8")
    path = str(tmp_path / "jax_int8.zip")
    jser.write_model(jqn, path)
    back = tser.restore_multi_layer_network(path, device="cpu")
    assert back.quantized == "int8"
    _assert_same_tree(back.params, jqn.params)
    ids = jq.gate_workload(SIZE["vocab_size"], rows=2, length=12)
    _close(tq._sequence_logits(back, ids), jq._sequence_logits(jqn, ids), F32)
    # the port's zip holds the reference's arrays
    tqn = tq.quantize(tn, "int8")
    path2 = str(tmp_path / "port_int8.zip")
    tser.write_model(tqn, path2)
    assert jser.verify_model_file(path2) == []
    with zipfile.ZipFile(path) as zj, zipfile.ZipFile(path2) as zt:
        with np.load(io.BytesIO(zj.read("coefficients.npz"))) as a, \
                np.load(io.BytesIO(zt.read("coefficients.npz"))) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    again = tser.restore_model(path2, device="cpu")
    assert again.quantized == "int8"
    _assert_same_tree(again.params, jqn.params)


def test_fp8_zip_is_written_as_the_reference_and_does_not_restore(gpts, tmp_path):
    jn, tn = gpts
    path = str(tmp_path / "jax_fp8.zip")
    jser.write_model(jq.quantize(jn, "fp8"), path)
    path2 = str(tmp_path / "port_fp8.zip")
    tser.write_model(tq.quantize(tn, "fp8"), path2)
    with zipfile.ZipFile(path) as zj, zipfile.ZipFile(path2) as zt:
        with np.load(io.BytesIO(zj.read("coefficients.npz"))) as a, \
                np.load(io.BytesIO(zt.read("coefficients.npz"))) as b:
            assert a["layer1/Wqkv"].dtype.str == b["layer1/Wqkv"].dtype.str == "|V1"
            for k in a.files:
                np.testing.assert_array_equal(a[k].view(np.uint8)
                                              if a[k].dtype.kind == "V" else a[k],
                                              b[k].view(np.uint8)
                                              if b[k].dtype.kind == "V" else b[k])
    with pytest.raises(TypeError):  # the reference's restore fails too
        jser.restore_model(path)
    for p in (path, path2):
        with pytest.raises(TypeError, match="V1"):
            tser.restore_model(p, device="cpu")


def test_params_from_numpy_takes_fp8_and_checks_scales(gpts):
    jn, tn = gpts
    jqn = jq.quantize(jn, "fp8")
    net = MultiLayerNetwork(tn.conf, device="cpu")
    params_from_numpy(net, _np(jqn.params))
    assert net.quantized == "fp8"
    _assert_same_tree(net.params, jqn.params)
    bad = _np(jqn.params)
    bad["layer1"]["Wx_qscale"] = np.ones(SIZE["d_model"], np.float32)
    with pytest.raises(ValueError, match="layer1: parameters"):
        params_from_numpy(MultiLayerNetwork(tn.conf, device="cpu"), bad)
    bad = _np(jqn.params)
    bad["layer1"]["ln1_g_qscale"] = np.ones(SIZE["d_model"], np.float32)
    with pytest.raises(TypeError, match="layer1/ln1_g"):
        params_from_numpy(MultiLayerNetwork(tn.conf, device="cpu"), bad)
