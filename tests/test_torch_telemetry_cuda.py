"""Phase 13 (a)'s telemetry gates on the card at hidden 128 (marked
``cuda``: skipped where ``torch.cuda.is_available()`` is false; no JAX).

A bf16 char-RNN of one ``GravesLSTM(128)`` over 8 ids, b 8, seq 9,
three full minibatches and a ragged tail of 3 rows, ``fit`` through the
feed pipeline with a fresh registry and a tracer: the counters equal
the port's own counts (the stager's bytes, one padded tail, the
deferred ring's fetches, one dispatch miss per signature), a
``compile`` span opens each signature and ``device_step`` spans the
other steps, and the scores and parameters are bit for bit those of the
same fit with tracing off.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch.monitor as tmon
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.staging import stager_of
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.deferred import score_sink
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener,
)

V = 8
SYNC, MISS = tmon.SCORE_SYNC_COUNTER, tmon.JIT_CACHE_MISS_COUNTER
PADDED, H2D = tmon.FEED_PADDED_BATCHES_COUNTER, tmon.H2D_BYTES_COUNTER

CARD_N, CARD_B, CARD_T, CARD_FULL, CARD_TAIL = 128, 8, 9, 3, 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _card_char_net():
    conf = (NeuralNetConfiguration.builder().seed(4).learning_rate(0.01)
            .updater("adam").activation("tanh").compute_dtype("bfloat16").list()
            .layer(L.GravesLSTM(n_in=V, n_out=CARD_N))
            .layer(L.RnnOutputLayer(n_in=CARD_N, n_out=V, activation="softmax",
                                    loss_function="mcxent")).build())
    return MultiLayerNetwork(conf).init()


def _card_fit(traced):
    ids = np.random.default_rng(7).integers(
        0, V, (CARD_FULL * CARD_B + CARD_TAIL, CARD_T))
    eye = np.eye(V, dtype=np.float32)
    ds = DataSet(eye[ids], eye[np.roll(ids, -1, 1)])
    net = _card_char_net()
    reg = tmon.MetricsRegistry()
    old = tmon.set_registry(reg)
    tracer = tmon.enable_tracing() if traced else None
    try:
        scores = CollectScoresIterationListener(frequency=CARD_FULL + 1)
        net.set_listeners(scores)
        net.fit(ListDataSetIterator(ds, CARD_B))
    finally:
        tmon.disable_tracing()
        tmon.set_registry(old)
    return net, reg, tracer, scores.scores


@pytest.mark.cuda
def test_card_fit_counters_and_spans(cuda_device):
    """Phase 13 (a)'s gates at hidden 128: the counters equal the port's
    own counts, one ``compile`` span per signature then ``device_step``,
    and tracing on and off bit for bit."""
    net, reg, tracer, scores = _card_fit(True)
    off, _, _, scores_off = _card_fit(False)
    stager = stager_of(net)
    assert reg.get(H2D).value == stager.nbytes and stager.copies > 0
    assert reg.get(PADDED).value == 1
    assert reg.get(SYNC).value == score_sink(net).flushes
    assert reg.get(MISS).value == len(net.__dict__["_dispatch_sigs"]) == 2
    steps = [e["name"] for e in tracer.events()
             if e["name"] in ("compile", "device_step")]
    assert steps == ["compile"] + ["device_step"] * (CARD_FULL - 1) + ["compile"]
    # the listener acts at step 4 only: one stacked fetch of 4 scores
    assert scores == scores_off and [i for i, _ in scores] == [CARD_FULL + 1]
    for l, p in off.params.items():
        for n, v in p.items():
            assert torch.equal(net.params[l][n], v), f"{l}/{n}"
