"""The port's ResNet zoo against the JAX package's.

A tiny bottleneck ResNet (stages (1, 1), widths (8, 16), 4 classes, f32,
32x32x3 images, as ``tests/test_zoo.py``), the reference's parameters
carried across and images from a numpy seed: JSON, outputs, score and
gradients (outputs and scores 1e-5, gradients 1e-4, relative to the
largest magnitude of the reference's array), one nesterovs step and
three ``fit_scan`` steps with their BN moving statistics (1e-5; the
velocity, and the parameters that start at zero, are -lr times the
gradient after a step and are held at the gradients' 1e-4). The
full ResNet-50 graph: its vertex and convolution counts, its parameter
count and its FLOP count are the reference's.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
from deeplearning4j_tpu_torch.models.zoo import resnet as tres
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

# the JAX zoo package exports a function named ``resnet`` over its module
jres = importlib.import_module("deeplearning4j_tpu.models.zoo.resnet")
F32, GRAD = 1e-5, 1e-4
TINY = dict(stages=(1, 1), widths=(8, 16), num_classes=4,
            compute_dtype="float32", learning_rate=0.01)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max error {err:.3g} of max |want| {scale:.3g} > {tol}"


def _trees(got, want, tol, init=None):
    """Each leaf of ``got`` against ``want``; with ``init`` (the trees
    before a step), a leaf that started at zero (BN's beta, the gamma 0
    of each block's last BN) is the step's update alone, -lr times the
    gradient, and is held at the gradients' tolerance."""
    for layer, p in want.items():
        assert set(got[layer]) == set(p), layer
        for name, v in p.items():
            zero = init is not None and not np.abs(init[layer][name]).any()
            _close(got[layer][name].cpu().numpy(), np.asarray(v),
                   GRAD if zero else tol)


def _pair():
    jn = jres.resnet(**TINY).init()
    tn = tres.resnet(device="cpu", **TINY).init()
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    return jn, tn


def _data(n=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


def test_tiny_resnet_config_is_the_references():
    jn, tn = _pair()
    assert tn.conf.to_json() == jn.conf.to_json()
    assert tn.order == jn.order
    assert set(tn.params) == set(jn.params)
    assert tn.num_params() == jn.num_params()


def test_tiny_resnet_forward_score_and_gradients_match_reference():
    jn, tn = _pair()
    x, y = _data()
    _close(tn.output(x), np.asarray(jn.output(x)), F32)
    _close(tn.score(MultiDataSet([x], [y])), jn.score(JaxMDS([x], [y])), F32)
    inputs, labels, fm, lm = jn._tensors(JaxMDS([x], [y]))
    jgrads = jax.grad(lambda p: jn._score_fn(p, jn.states, inputs, labels, False,
                                             None, fm, lm)[0])(jn.params)
    grads, _ = tn.gradient_and_score(MultiDataSet([x], [y]))
    _trees(grads, jgrads, GRAD)


def test_tiny_resnet_nesterovs_step_matches_reference():
    jn, tn = _pair()
    init = jax.tree.map(np.asarray, jn.params)
    x, y = _data()
    jn.fit(JaxMDS([x], [y]))
    tn.fit(MultiDataSet([x], [y]))
    _close(tn.score(), float(jn._score), F32)
    _trees(tn.params, jn.params, F32, init)
    _trees(tn.states, jn.states, F32)
    # the first velocity is -lr g: held as the gradients are
    for layer, p in jn.opt_state["updater"].items():
        for name, st in p.items():
            _close(tn.opt_state["updater"][layer][name]["v"].numpy(),
                   np.asarray(st["v"]), GRAD)


def test_tiny_resnet_fit_scan_matches_reference():
    jn, tn = _pair()
    init = jax.tree.map(np.asarray, jn.params)
    x, y = _data(12, seed=1)
    want = np.asarray(jn.fit_scan(JaxMDS([x], [y]), 4))
    got = tn.fit_scan(MultiDataSet([x], [y]), 4)
    assert got.shape == want.shape == (3,)
    _close(got, want, F32)
    _trees(tn.params, jn.params, F32, init)
    _trees(tn.states, jn.states, F32)
    assert tn.score() == float(got[-1])


def test_resnet50_graph_counts_are_the_references():
    jn = jres.resnet50(num_classes=1000)
    tn = tres.resnet50(num_classes=1000, device="cpu")
    assert tn.conf.to_json() == jn.conf.to_json()
    convs = [v for v in tn.conf.vertices
             if v.layer is not None and type(v.layer).__name__ == "ConvolutionLayer"]
    assert len(convs) == 53
    assert len(tn.order) == len(tn.conf.vertices) == len(jn.order)
    assert tn.order == jn.order
    tn.init()
    jn.init()
    assert tn.num_params() == jn.num_params()
    assert all(t.dtype == torch.float32 for p in tn.params.values()
               for t in p.values())


@pytest.mark.parametrize("size", [224, 64])
def test_resnet50_flops_are_the_references(size):
    assert tres.resnet50_train_flops_per_example(size) == \
        jres.resnet50_train_flops_per_example(size)


def test_benchmarks_keep_the_references_signatures():
    import inspect

    from deeplearning4j_tpu.models.zoo import transformer as jtr
    from deeplearning4j_tpu_torch.models.zoo import transformer as ttr

    for jf, tf in ((jres.resnet50_benchmark, tres.resnet50_benchmark),
                   (jtr.gpt_benchmark, ttr.gpt_benchmark)):
        jp = list(inspect.signature(jf).parameters.values())
        tp = list(inspect.signature(tf).parameters.values())
        assert [(p.name, p.default) for p in tp[:len(jp)]] == \
            [(p.name, p.default) for p in jp]
        assert [p.name for p in tp[len(jp):]] == ["device", "record"]
    assert isinstance(tres.resnet(device="cpu", **TINY), ComputationGraph)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tiny_resnet_on_card_matches_cpu(cuda_device):
    """f32 on the card (the convolutions in f32, not TF32) against the
    CPU: outputs, the score and three fit_scan steps within 1e-4."""
    _, cpu = _pair()
    card = tres.resnet(device=cuda_device, **TINY).init()
    params_from_numpy(card, {l: {n: v.numpy() for n, v in p.items()}
                             for l, p in cpu.params.items()})
    x, y = _data(12, seed=1)
    _close(card.output(x), cpu.output(x), 1e-4)
    _close(card.score(MultiDataSet([x], [y])), cpu.score(MultiDataSet([x], [y])), 1e-4)
    want = cpu.fit_scan(MultiDataSet([x], [y]), 4)
    got = card.fit_scan(MultiDataSet([x], [y]), 4)
    _close(got, want, 1e-4)
    for layer, p in cpu.params.items():
        for name, v in p.items():
            _close(card.params[layer][name].cpu().numpy(), v.numpy(), 1e-4)
