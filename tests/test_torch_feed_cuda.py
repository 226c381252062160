"""The feed pipeline on the card (marked ``cuda``: skipped where
``torch.cuda.is_available()`` is false; no JAX).

``chip_smoke.py`` phase 13's gates (a) and (c) at a reduced size, and
the staging's stream contract:

- (a) a bf16 char-RNN of one ``GravesLSTM(128)`` over 16 ids, b 8, seq
  9, over 3 full minibatches and a ragged tail of 3 rows: ``fit`` with
  the pipeline off and on from the same weights gives the full steps'
  scores and parameters bit for bit; the pipelined tail is padded to 8
  rows with an [8, 9] labels mask and launches the LSTM kernels, its
  score within ``LOSS_TOL`` of the unpadded tail's.
- a slow copy: batches of 64 MiB staged by ``DeviceFeedIterator``
  behind a sleep on the feed's stream, and summed on the compute stream
  as soon as they are handed over, equal their host sums; the same feed
  whose hand-over skips the stream wait reads a batch before its copy
  has landed.
- (c) the native IO library builds and loads on the card's machine,
  its gather and one-hot equal NumPy's, and MLP-Iris trains from the
  Iris CSV through DataVec, a fitted ``NormalizerStandardize`` and the
  pipeline.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import kernels, native
from deeplearning4j_tpu_torch.datasets import staging
from deeplearning4j_tpu_torch.datasets import iterators as it_mod
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    DeviceFeedIterator,
    ExistingDataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import lstm_kernel as lk

VOCAB, HIDDEN, B, T, FULL, TAIL = 16, 128, 8, 9, 3, 3
# the padded tail's score against the unpadded one: bf16 roundings of
# the products at another row count (chip_smoke.py's CHAR_LOSS_TOL)
LOSS_TOL = 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _char_net(seed=4):
    conf = (NeuralNetConfiguration.builder().seed(seed).learning_rate(0.01)
            .updater("adam").activation("tanh").compute_dtype("bfloat16").list()
            .layer(L.GravesLSTM(n_in=VOCAB, n_out=HIDDEN))
            .layer(L.RnnOutputLayer(n_in=HIDDEN, n_out=VOCAB, activation="softmax",
                                    loss_function="mcxent")).build())
    return MultiLayerNetwork(conf).init()


def _run(net, ds, pipeline):
    """Each step's (score, rows, labels-mask shape, launches) and the
    parameters before the tail step."""
    steps, snap = [], {}
    inner = net._fit_batch

    def step(batch):
        if net.opt_state["step"] == FULL:
            snap.update({k: {n: t.clone() for n, t in v.items()}
                         for k, v in net.params.items()})
        kernels.reset_launches()
        inner(batch)
        lm = batch.labels_mask
        steps.append((float(net._score), int(batch.features.shape[0]),
                      None if lm is None else tuple(lm.shape), dict(kernels.LAUNCHES)))

    net._fit_batch = step
    net.fit(ListDataSetIterator(ds, B), feed_pipeline=pipeline)
    del net._fit_batch
    return steps, snap


@pytest.mark.cuda
def test_char_rnn_through_the_pipeline_bit_for_bit(cuda_device):
    ids = np.random.default_rng(7).integers(0, VOCAB, (FULL * B + TAIL, T))
    eye = np.eye(VOCAB, dtype=np.float32)
    ds = DataSet(eye[ids], eye[np.roll(ids, -1, 1)])
    off_net, on_net = _char_net(), _char_net()
    off, off_snap = _run(off_net, ds, False)
    on, on_snap = _run(on_net, ds, True)
    assert [s[0] for s in on[:FULL]] == [s[0] for s in off[:FULL]]
    for k, v in off_snap.items():
        for n, t in v.items():
            assert torch.equal(on_snap[k][n], t), f"{k}/{n}"
    assert on[-1][1:3] == (B, (B, T)) and off[-1][1:3] == (TAIL, None)
    want = {lk.FWD_KERNEL: 1, lk.BWD_KERNEL: 1, lk.DW_KERNEL: 1}
    assert all(on[-1][3].get(k, 0) == v for k, v in want.items()), on[-1][3]
    assert abs(on[-1][0] - off[-1][0]) <= LOSS_TOL
    stager = staging.stager_of(on_net)
    assert stager.stream is not None and stager.copies > 0
    assert stager.stream != torch.cuda.current_stream()


def _slow_feed(batches, wait):
    """A feed over ``batches`` whose hand-over waits on each copy's event
    (``wait``) or only takes the tensors over. The feed's stream first
    sleeps ~0.1 s, so every copy lands long after its batch is handed
    over."""
    stager = staging.DeviceStager(torch.device("cuda"), torch.float32)
    stager.stream = torch.cuda.Stream()
    with torch.cuda.stream(stager.stream):
        torch.cuda._sleep(200_000_000)
    feed = DeviceFeedIterator(ExistingDataSetIterator(batches), depth=1,
                              place=stager.stage_ds)
    sums = []
    if not wait:
        def claim(batch):
            staged = batch.__dict__.pop("_staged", None)
            for t in (staged.tensors if staged else ()):
                t.record_stream(torch.cuda.current_stream())
            return batch
    for batch in feed:
        if not wait:
            claim(batch)
        sums.append(batch.features.sum(dtype=torch.float64))
    return [float(s) for s in sums]


@pytest.mark.cuda
def test_a_slow_copy_is_waited_for(cuda_device, monkeypatch):
    rows = 4 * 1024 * 1024  # [rows, 4] f32: 64 MiB of features a batch
    batches = [DataSet(np.full((rows, 4), float(i + 1), np.float32),
                       np.zeros((rows, 1), np.float32)) for i in range(4)]
    want = [float(b.features.sum(dtype=np.float64)) for b in batches]
    assert _slow_feed(batches, wait=True) == want
    # the negative control: without the wait the step reads a batch whose
    # copy has not landed (the memory then holds an earlier batch or none)
    monkeypatch.setattr(it_mod, "claim", lambda b: b)
    assert _slow_feed(batches, wait=False) != want


@pytest.mark.cuda
def test_native_io_builds_and_trains_iris_through_datavec(cuda_device):
    from deeplearning4j_tpu_torch.datasets import native_batcher as nb
    from deeplearning4j_tpu_torch.datasets.iris import IRIS_CSV
    from deeplearning4j_tpu_torch.datasets.normalizers import NormalizerStandardize
    from deeplearning4j_tpu_torch.datavec import (
        CSVRecordReader,
        RecordReaderDataSetIterator,
    )

    assert native.get_lib() is not None
    rng = np.random.default_rng(8)
    src = rng.standard_normal((512, 256)).astype(np.float32)
    idx = rng.integers(0, 512, 512)
    mean, std = src.mean(0), src.std(0)
    np.testing.assert_array_equal(nb.gather_rows(src, idx), src[idx])
    np.testing.assert_array_equal(nb.gather_rows(src, idx, mean, std),
                                  (src[idx] - mean) / std)
    np.testing.assert_array_equal(nb.one_hot(idx, 512),
                                  np.eye(512, dtype=np.float32)[idx])

    def reader():
        return RecordReaderDataSetIterator(CSVRecordReader(IRIS_CSV, skip_lines=1),
                                           32, label_index=-1, num_classes=3)
    it = reader()
    norm = NormalizerStandardize().fit(it)
    it.set_pre_processor(norm)
    whole = norm.transform(DataSet.merge(list(reader())))
    conf = (NeuralNetConfiguration.builder().seed(3).learning_rate(0.1)
            .updater("adam").activation("relu").list()
            .layer(L.DenseLayer(n_in=4, n_out=16))
            .layer(L.OutputLayer(n_in=16, n_out=3, activation="softmax",
                                 loss_function="mcxent")).build())
    net = MultiLayerNetwork(conf).init()
    before = net.score(whole)
    for _ in range(3):
        net.fit(it)
    assert net.score(whole) < before
