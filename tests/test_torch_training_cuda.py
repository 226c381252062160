"""The training services on the card, through the LSTM kernels (marked
``cuda``: skipped where ``torch.cuda.is_available()`` is false; no JAX).

``chip_smoke.py`` phase 12's gates (a), (b) and (e) at a reduced size:
a char-RNN of one ``GravesLSTM(128)`` over 16 ids (bf16 for training,
f32 for the solver), b 8, seq 9, Adam.

- (a) two identical runs of the training step are equal bit for bit;
  then a ``ResumableTrainer`` run preempted after one step and resumed
  in a fresh trainer and a fresh ``ExportedDataSetIterator`` ends with
  the parameters and updater state of the uninterrupted run, bit for
  bit, on the card.
- (b) a fault-free ``TrainingSupervisor`` run equals the unsupervised
  one bit for bit; a batch of NaN features rolls back exactly once, to
  the snapshot, and the next step equals a step taken at half the
  learning rate from it.
- (e) ``Solver`` with ``lbfgs`` on the f32 net lowers the loss, its
  oracle's first gradient through the kernels is within
  ``GRAD_REL`` (relative L2) of the plain versions', and the f32
  ``lstm_fwd``, ``lstm_bwd`` and ``lstm_dw`` launched.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.export import (
    ExportedDataSetIterator,
    export_dataset,
)
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import lstm_kernel as lk
from deeplearning4j_tpu_torch.optimize.resumable import ResumableTrainer
from deeplearning4j_tpu_torch.optimize.solvers import Solver, _FlatOracle
from deeplearning4j_tpu_torch.optimize.supervisor import TrainingSupervisor
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

VOCAB, HIDDEN, B, T, BATCHES = 16, 128, 8, 9, 4
LR = 0.01
# f32 kernels vs plain versions: the same products summed in other
# orders through 9 steps (chip_smoke.py's EXAMPLE_GRAD_REL)
GRAD_REL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def _net(compute_dtype="bfloat16", lr=LR, algo=None):
    b = (NeuralNetConfiguration.builder().seed(1).learning_rate(lr)
         .updater("adam").activation("tanh").compute_dtype(compute_dtype))
    if algo:
        b = b.optimization_algo(algo)
    conf = (b.list()
            .layer(L.GravesLSTM(n_in=VOCAB, n_out=HIDDEN))
            .layer(L.RnnOutputLayer(n_in=HIDDEN, n_out=VOCAB,
                                    activation="softmax",
                                    loss_function="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device="cuda").init()
    rng = np.random.default_rng(31)
    params_from_numpy(net, {
        layer: {n: (0.1 * rng.standard_normal(tuple(t.shape))).astype(np.float32)
                for n, t in p.items()}
        for layer, p in net.params.items()})
    return net


def _batches(n=BATCHES, seed=32):
    rng = np.random.default_rng(seed)
    eye = np.eye(VOCAB, dtype=np.float32)
    out = []
    for _ in range(n):
        ids = rng.integers(0, VOCAB, (B, T + 1))
        out.append(DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]]))
    return out


def _host(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in _host(v).items()})
        else:
            out[k] = v.detach().float().cpu().numpy()
    return out


def _assert_equal(got, want):
    got, want = _host(got), _host(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.cuda
def test_resume_on_the_card_is_bit_for_bit(cuda_device, tmp_path):
    data = _batches()
    a, b = _net(), _net()
    for ds in data:
        a.fit(ds)
        b.fit(ds)
    _assert_equal(a.params, b.params)  # the step is deterministic
    d = str(tmp_path / "data")
    export_dataset(data, d)
    kernels.reset_launches()
    ref = ResumableTrainer(_net(), str(tmp_path / "ref"), checkpoint_every=2)
    ref.fit(ExportedDataSetIterator(d, shuffle=True, seed=9))
    assert kernels.LAUNCHES[lk.FWD_KERNEL] == BATCHES  # one layer, a step each
    ck = str(tmp_path / "ck")
    ResumableTrainer(_net(), ck, checkpoint_every=2).fit(
        ExportedDataSetIterator(d, shuffle=True, seed=9), max_steps=1)
    again = ResumableTrainer(_net(), ck, checkpoint_every=2)
    it = ExportedDataSetIterator(d, shuffle=True, seed=9)
    again.resume_or_start(it)
    assert again.model.device.type == "cuda" and again.steps_done == 1
    again.fit(it)
    _assert_equal(again.model.params, ref.model.params)
    _assert_equal(again.model.opt_state["updater"], ref.model.opt_state["updater"])


@pytest.mark.cuda
def test_supervisor_on_the_card(cuda_device):
    data = _batches()
    plain, guarded = _net(), _net()
    sup = TrainingSupervisor(guarded)
    for ds in data:
        plain.fit(ds)
        assert sup.step(ds)
    _assert_equal(guarded.params, plain.params)
    poisoned = DataSet(data[0].features.copy(), data[0].labels)
    poisoned.features[0, 0, 0] = np.nan
    snapshot = _host(guarded.params)
    assert not sup.step(poisoned)
    assert sup.rollbacks == 1 and sup.batches_skipped == [BATCHES]
    for k, v in _host(guarded.params).items():
        np.testing.assert_array_equal(v, snapshot[k], err_msg=k)
    half = _net(lr=LR * 0.5)
    params_from_numpy(half, {l: {n: t.cpu().numpy() for n, t in p.items()}
                             for l, p in guarded.params.items()})
    half.opt_state = guarded.opt_state
    sup.step(data[1])
    half.fit(data[1])
    _assert_equal(guarded.params, half.params)


@pytest.mark.cuda
def test_solver_lbfgs_on_the_card(cuda_device, monkeypatch):
    net = _net("float32", algo="lbfgs")
    ds = _batches(1)[0]
    oracle = _FlatOracle(net, ds)
    assert oracle.dtype == torch.float32
    kernels.reset_launches()
    _, g = oracle.value_and_grad(oracle.flat0)
    assert {k: kernels.LAUNCHES[k] for k in
            (lk.FWD_KERNEL, lk.BWD_KERNEL, lk.DW_KERNEL)} == {
        lk.FWD_KERNEL: 1, lk.BWD_KERNEL: 1, lk.DW_KERNEL: 1}
    with monkeypatch.context() as m:
        m.setattr(lk, "lstm_fwd", lambda *a, with_residuals=True, wr_packed=None:
                  lk.lstm_fwd_plain(*a, with_residuals=with_residuals))
        m.setattr(lk, "lstm_bwd", lk.lstm_bwd_plain)
        _, g_plain = oracle.value_and_grad(oracle.flat0)
    rel = np.linalg.norm(g - g_plain) / np.linalg.norm(g_plain)
    assert rel <= GRAD_REL, rel
    s0 = net.score(ds)
    kernels.reset_launches()
    f = Solver(net).optimize(ds, iterations=5)
    assert np.isfinite(f) and f < s0
    assert all(kernels.LAUNCHES[k] > 0 for k in
               (lk.FWD_KERNEL, lk.BWD_KERNEL, lk.DW_KERNEL, lk.FWD_ONLY_KERNEL))
