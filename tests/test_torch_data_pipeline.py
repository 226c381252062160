"""The port's feed pipeline and iterator family against the JAX
package's, on the CPU.

- The threaded stages (``AsyncDataSetIterator``, ``DeviceFeedIterator``
  placing through the CPU ``DeviceStager``): order and values over two
  epochs, ``reset`` mid-epoch, the abandon race (``close`` stops a
  worker blocked on a full queue, 20 interleavings), a worker's error
  re-raised on the consumer, ``close`` after that error, and ``__del__``
  releasing an abandoned worker.
- ``ShapeBucketingIterator``: only the ragged tail is padded (its
  batches equal the reference's), masked batches pass untouched, and
  nets with batch statistics (BN, MoE) are not padded.
- ``fit`` with the pipeline on against off, with a ragged tail: scores
  bit for bit and parameters within one f32 ulp (6e-8 at these
  magnitudes), the reference's own bar; then against the JAX package's
  ``fit(feed_pipeline=True)`` on carried parameters at 1e-6 relative
  (scores, and parameters to their largest magnitude). Both for
  MultiLayerNetwork and ComputationGraph.
- Score fetches: without the pipeline, one flush per step, as the
  reference's one score sync per step; with it, one at the end.
- Float-id labels ([b, T], GPT-style) with a ragged tail: both packages
  raise with the pipeline on (the [b] mask does not broadcast) and
  train the tail as it is with it off.
- ``MultipleEpochsIterator``, ``SamplingDataSetIterator``,
  ``ExistingDataSetIterator``, ``ReconstructionDataSetIterator``,
  ``IteratorDataSetIterator``, ``MovingWindowDataSetIterator`` and
  ``DataSet.split_test_and_train``/``batch_by``/``merge`` give the
  reference's batches, exactly (the same numpy code).
"""

import gc
import time

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import monitor
from deeplearning4j_tpu.datasets import iterators as jiters
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.zoo.transformer import gpt as jax_gpt
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.configuration import MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.graph import ComputationGraphConfiguration as JCGC
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize.listeners import (
    CollectScoresIterationListener as JCollect,
)
from deeplearning4j_tpu_torch.datasets import iterators as titers
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.staging import DeviceStager, claim
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import CollectScoresIterationListener
from deeplearning4j_tpu_torch.optimize import deferred
from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

# the port against the JAX package: f32 products in other orders
REL = 1e-6
# pipeline on vs off in the port: one f32 ulp at these magnitudes
ULP = 6e-8


def _data(n, seed=0, nin=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, nin)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


def _jconf(seed=7, bn=False, moe=False):
    b = (JNNC.builder().seed(seed).learning_rate(0.1).updater("sgd")
         .activation("tanh").list().layer(JL.DenseLayer(n_in=4, n_out=8)))
    if bn:
        b = b.layer(JL.BatchNormalization(n_out=8))
    if moe:
        b = b.layer(JL.MoELayer(n_in=8, n_out=8, num_experts=2))
    return b.layer(JL.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                  loss_function="mcxent")).build()


def _mlp(seed=7, **kw):
    """(the JAX net, the port's net on the CPU with its parameters)."""
    jn = JMLN(_jconf(seed, **kw)).init()
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(jn.conf.to_json()),
                           device="cpu")
    params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
    return jn, tn


def _flat(params):
    return np.concatenate([np.asarray(v.detach() if isinstance(v, torch.Tensor)
                                      else v, np.float64).ravel()
                           for layer in params.values() for v in layer.values()])


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _batches(it):
    return [(np.asarray(b.features), None if b.labels is None else np.asarray(b.labels),
             None if b.labels_mask is None else np.asarray(b.labels_mask))
            for b in it]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


def _feed(x, y, batch, depth=2, place=None):
    return titers.DeviceFeedIterator(titers.AsyncDataSetIterator(
        titers.ListDataSetIterator(DataSet(x, y), batch)), depth=depth, place=place)


# ------------------------------------------------------ the threaded stages

def test_device_feed_preserves_order_and_values():
    x, y = _data(70)
    want = _batches(titers.ListDataSetIterator(DataSet(x, y), 16))
    stager = DeviceStager(torch.device("cpu"), torch.float32)
    feed = _feed(x, y, 16, place=stager.stage_ds)
    for _ in range(2):  # the second pass starts from __iter__'s reset
        got = list(feed)
        assert all(isinstance(b.features, torch.Tensor) for b in got)
        _assert_same_batches(_batches(got), want)


def test_device_feed_reset_mid_epoch():
    x, y = _data(80)
    feed = _feed(x, y, 16)
    assert feed.has_next()
    feed.next()
    feed.next()  # two taken, more in flight
    feed.reset()
    _assert_same_batches(_batches(feed),
                         _batches(titers.ListDataSetIterator(DataSet(x, y), 16)))


def test_device_feed_abandon_race():
    """close() stops the worker even while it blocks on a full queue."""
    for trial in range(20):
        x, y = _data(200, seed=trial)
        feed = _feed(x, y, 8, depth=2)
        for _ in range(trial % 5):
            if feed.has_next():
                feed.next()
        if trial % 3 == 0:
            time.sleep(0.002)  # let the worker fill the buffer
        feed.close()
        t = feed._thread
        assert t is None or not t.is_alive(), f"worker leaked on trial {trial}"


class _Boom(titers.DataSetIterator):
    def __init__(self):
        self.i = 0

    def reset(self):
        self.i = 0

    def has_next(self):
        return self.i < 5

    def _next_impl(self):
        self.i += 1
        if self.i == 3:
            raise ValueError("bad record")
        return DataSet(*_data(4))

    def batch(self):
        return 4


@pytest.mark.parametrize("stage", ["device_feed", "async"])
def test_worker_error_is_reraised_and_close_after_it_is_quiet(stage):
    it = (titers.DeviceFeedIterator(_Boom(), depth=2) if stage == "device_feed"
          else titers.AsyncDataSetIterator(_Boom(), queue_size=2))
    got = 0
    with pytest.raises(ValueError, match="bad record"):
        while it.has_next():
            it.next()
            got += 1
    assert got == 2  # the good batches arrived before the error
    it.close()  # neither hangs nor re-raises
    assert it._thread is None


def test_async_iterator_close_stops_worker():
    it = titers.AsyncDataSetIterator(
        titers.ListDataSetIterator(DataSet(*_data(100)), 4), queue_size=2)
    assert it.has_next()
    it.next()
    it.close()
    assert it._thread is None


def test_del_releases_an_abandoned_worker():
    feed = _feed(*_data(200), 4, depth=1)
    assert feed.has_next()
    thread = feed._thread
    del feed
    gc.collect()
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_stager_and_claim_on_the_cpu():
    x, y = _data(6)
    stager = DeviceStager(torch.device("cpu"), torch.float64)
    ds = stager.stage_ds(DataSet(x.astype(np.float16), y.astype(np.uint8)))
    assert ds.features.dtype == torch.float64 and ds.labels_mask is None
    assert claim(ds) is ds and stager.copies == 0
    np.testing.assert_array_equal(ds.labels.numpy(), y)


# ------------------------------------------------------------- bucketing

def test_bucketing_pads_only_the_ragged_tail_as_the_reference():
    x, y = _data(3 * 16 + 5)
    got = list(titers.ShapeBucketingIterator(
        titers.ListDataSetIterator(DataSet(x, y), 16)))
    want = list(jiters.ShapeBucketingIterator(
        jiters.ListDataSetIterator(JDataSet(x, y), 16)))
    assert [b.num_examples() for b in got] == [16] * 4
    assert [b.labels_mask is None for b in got] == [True, True, True, False]
    np.testing.assert_array_equal(got[-1].labels_mask,
                                  np.r_[np.ones(5), np.zeros(11)])
    np.testing.assert_array_equal(got[-1].features[5:], 0.0)
    _assert_same_batches(_batches(got), _batches(want))


def test_bucketing_passes_masked_batches_untouched():
    x, y = _data(20)
    got = list(titers.ShapeBucketingIterator(titers.ListDataSetIterator(
        DataSet(x, y, None, np.ones(20, np.float32)), 16)))
    assert [b.num_examples() for b in got] == [16, 4]


def test_bucketing_pads_tensors_on_their_device():
    labels = torch.zeros(3, 5, dtype=torch.int64)
    m = titers._ones_label_mask(labels, 3, 8)
    assert m.shape == (8, 5) and m.dtype == torch.float32 and m.sum() == 15
    assert titers.pad_rows(torch.ones(3, 2), 2).shape == (5, 2)


@pytest.mark.parametrize("kind", ["bn", "moe"])
def test_nets_with_batch_statistics_are_not_padded(monkeypatch, kind):
    padded = []
    monkeypatch.setattr(titers.ShapeBucketingIterator, "_count_padded",
                        lambda self: padded.append(1))
    jn, tn = _mlp(**{kind: True})
    assert not tn._pad_tail_safe() and not jn._pad_tail_safe()
    tn.fit(titers.ListDataSetIterator(DataSet(*_data(16 + 5)), 16),
           feed_pipeline=True)
    assert padded == [] and np.isfinite(tn.score())
    # a net without them is padded
    _, plain = _mlp()
    assert plain._pad_tail_safe()
    plain.fit(titers.ListDataSetIterator(DataSet(*_data(16 + 5)), 16))
    assert padded == [1]


@pytest.mark.parametrize("dseed", range(4))
def test_pipeline_on_vs_off_and_vs_the_reference(dseed):
    """Scores bit for bit and parameters within one ulp, pipeline on vs
    off; the pipeline's run against the JAX package's at 1e-6."""
    x, y = _data(2 * 16 + 7, seed=dseed)
    jn, on = _mlp(seed=11)
    _, off = _mlp(seed=11)
    c_on, c_off, c_ref = (CollectScoresIterationListener(),
                          CollectScoresIterationListener(), JCollect())
    on.set_listeners(c_on)
    off.set_listeners(c_off)
    jn.set_listeners(c_ref)
    for _ in range(2):
        off.fit(titers.ListDataSetIterator(DataSet(x, y), 16), feed_pipeline=False)
        on.fit(titers.ListDataSetIterator(DataSet(x, y), 16), feed_pipeline=True)
        jn.fit(jiters.ListDataSetIterator(JDataSet(x, y), 16), feed_pipeline=True)
    assert c_on.scores == c_off.scores
    np.testing.assert_allclose(_flat(on.params), _flat(off.params), rtol=0, atol=ULP)
    assert [i for i, _ in c_on.scores] == [i for i, _ in c_ref.scores]
    np.testing.assert_allclose([s for _, s in c_on.scores],
                               [s for _, s in c_ref.scores], rtol=REL)
    assert _rel(_flat(on.params), _flat(jn.params)) <= REL


def _graphs(seed=5):
    jconf = (JCGC.builder(JNNC.builder().seed(seed).learning_rate(0.1)
                          .updater("sgd").activation("tanh").build())
             .add_inputs("in")
             .add_layer("h", JL.DenseLayer(n_in=4, n_out=8), "in")
             .add_layer("out", JL.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                              loss_function="mcxent"), "h")
             .set_outputs("out").build())
    jn = JCG(jconf).init()
    nets = []
    for _ in range(2):
        tn = ComputationGraph(ComputationGraphConfiguration.from_json(
            jconf.to_json()), device="cpu")
        params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
        nets.append(tn)
    return jn, nets


def test_graph_pipeline_on_vs_off_and_vs_the_reference():
    x, y = _data(2 * 16 + 5, seed=3)
    jn, (on, off) = _graphs()
    c_on, c_off = CollectScoresIterationListener(), CollectScoresIterationListener()
    on.set_listeners(c_on)
    off.set_listeners(c_off)
    c_ref = JCollect()
    jn.set_listeners(c_ref)
    off.fit(titers.ListDataSetIterator(DataSet(x, y), 16), feed_pipeline=False)
    on.fit(titers.ListDataSetIterator(DataSet(x, y), 16), epochs=2)
    off.fit(titers.ListDataSetIterator(DataSet(x, y), 16), feed_pipeline=False)
    jn.fit(jiters.ListDataSetIterator(JDataSet(x, y), 16), epochs=2)
    assert c_on.scores == c_off.scores and len(c_on.scores) == 6
    np.testing.assert_allclose(_flat(on.params), _flat(off.params), rtol=0, atol=ULP)
    np.testing.assert_allclose([s for _, s in c_on.scores],
                               [s for _, s in c_ref.scores], rtol=REL)
    assert _rel(_flat(on.params), _flat(jn.params)) <= REL


def test_graph_stages_multidatasets():
    _, (net, _) = _graphs()
    mds = net._stage_mds(DataSet(*_data(4)))
    assert isinstance(mds.features[0], torch.Tensor)
    assert mds.features_masks is None and len(mds.labels) == 1


def test_score_fetches_follow_the_pipeline():
    """Without the pipeline a listener of frequency 5 still sees one
    fetch per step, as the reference syncs once per step; with it, one
    at the end."""
    x, y = _data(4 * 16)
    reg = monitor.MetricsRegistry()
    old = monitor.set_registry(reg)
    try:
        jn, off = _mlp()
        jn.set_listeners(JCollect(5))
        jn.fit(jiters.ListDataSetIterator(JDataSet(x, y), 16), feed_pipeline=False)
        ref_syncs = reg.family_total(monitor.SCORE_SYNC_COUNTER)
    finally:
        monitor.set_registry(old)
    _, on = _mlp()
    for net, pipeline in ((off, False), (on, True)):
        net.set_listeners(CollectScoresIterationListener(5))
        net.fit(titers.ListDataSetIterator(DataSet(x, y), 16),
                feed_pipeline=pipeline)
    assert deferred.score_sink(off).flushes == ref_syncs == 4
    assert deferred.score_sink(on).flushes == 1


def test_fit_takes_a_list_through_the_pipeline():
    x, y = _data(32)
    _, a = _mlp()
    _, b = _mlp()
    a.fit([DataSet(x[:16], y[:16]), DataSet(x[16:], y[16:])])
    b.fit(titers.ListDataSetIterator(DataSet(x, y), 16))
    np.testing.assert_array_equal(_flat(a.params), _flat(b.params))


def test_tbptt_reads_staged_tensors():
    """A truncated-BPTT char net trains the same through the pipeline."""
    def net():
        conf = (NeuralNetConfiguration.builder().seed(3).learning_rate(0.1)
                .updater("sgd").activation("tanh").list()
                .layer(TL.GravesLSTM(n_in=5, n_out=6))
                .layer(TL.RnnOutputLayer(n_in=6, n_out=5, activation="softmax",
                                         loss_function="mcxent"))
                .backprop_type("truncated_bptt").t_bptt_forward_length(3)
                .build())
        return MultiLayerNetwork(conf, device="cpu").init()
    ids = np.random.default_rng(2).integers(0, 5, (8, 7))
    eye = np.eye(5, dtype=np.float32)
    ds = DataSet(eye[ids], eye[np.roll(ids, -1, 1)])
    a, b = net(), net()
    a.fit(titers.ListDataSetIterator(ds, 4), feed_pipeline=False)
    b.fit(titers.ListDataSetIterator(ds, 4), feed_pipeline=True)
    assert a.opt_state["step"] == b.opt_state["step"] == 6
    np.testing.assert_array_equal(_flat(a.params), _flat(b.params))


def test_float_id_labels_with_a_ragged_tail_as_the_reference():
    """GPT-style [b, T] float-id labels: the bucketing's [b] mask does not
    broadcast over them in either package; without the pipeline both
    train the short tail as it is, to the same scores."""
    size = dict(vocab_size=16, d_model=16, n_layers=1, num_heads=2, max_len=16)
    text = jax_gpt(seed=3, **size).conf.to_json()
    ids = np.random.default_rng(1).integers(0, 16, (6, 8))
    x, y = ids.astype(np.float32), np.roll(ids, -1, 1).astype(np.float32)
    outcomes = {}
    for pipeline in (True, False):
        jn = JMLN(JMLC.from_json(text)).init()
        tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(text), device="cpu")
        params_from_numpy(tn, jax.tree.map(np.asarray, jn.params))
        runs = []
        for net, its in ((jn, jiters.ListDataSetIterator(JDataSet(x, y), 4)),
                         (tn, titers.ListDataSetIterator(DataSet(x, y), 4))):
            try:
                net.fit(its, feed_pipeline=pipeline)
                runs.append(("trained", net.score()))
            except Exception as e:  # noqa: BLE001  (the reference's own error)
                runs.append(("raised", type(e).__name__))
        outcomes[pipeline] = runs
    assert [r[0] for r in outcomes[True]] == ["raised", "raised"]
    (jk, js), (tk, ts) = outcomes[False]
    assert jk == tk == "trained" and abs(ts - js) <= 1e-4 * max(1.0, abs(js))


# ------------------------------------------------------- the other iterators

def test_multiple_epochs_iterator():
    x, y = _data(10)
    got = titers.MultipleEpochsIterator(3, titers.ListDataSetIterator(DataSet(x, y), 4))
    want = jiters.MultipleEpochsIterator(3, jiters.ListDataSetIterator(JDataSet(x, y), 4))
    _assert_same_batches(_batches(got), _batches(want))
    assert len(_batches(got)) == 9 and got.batch() == 4


def test_sampling_iterator_draws_as_the_reference():
    x, y = _data(30)
    got = titers.SamplingDataSetIterator(DataSet(x, y), 7, 5, seed=4)
    want = jiters.SamplingDataSetIterator(JDataSet(x, y), 7, 5, seed=4)
    _assert_same_batches(_batches(got), _batches(want))


def test_existing_iterator_and_one_shot_refusal():
    x, y = _data(12)
    parts = [DataSet(x[i:i + 5], y[i:i + 5]) for i in range(0, 12, 5)]
    jparts = [JDataSet(d.features, d.labels) for d in parts]
    got = titers.ExistingDataSetIterator(lambda: iter(parts))
    _assert_same_batches(_batches(got) + _batches(got),
                         2 * _batches(jiters.ExistingDataSetIterator(jparts)))
    assert got.batch() == -1
    with pytest.raises(TypeError, match="one-shot"):
        titers.ExistingDataSetIterator(iter(parts))

    class Double:
        def pre_process(self, ds):
            ds.features *= 2

    it = titers.ExistingDataSetIterator(parts)
    it.set_pre_processor(Double())
    for _ in range(2):  # the copies keep the stored batches as they were
        np.testing.assert_array_equal(list(it)[0].features, 2 * parts[0].features)


def test_reconstruction_iterator():
    x, y = _data(9)
    got = titers.ReconstructionDataSetIterator(titers.ListDataSetIterator(DataSet(x, y), 4))
    want = jiters.ReconstructionDataSetIterator(jiters.ListDataSetIterator(JDataSet(x, y), 4))
    _assert_same_batches(_batches(got), _batches(want))


def test_iterator_dataset_iterator_batches_single_examples():
    x, y = _data(7)
    rows = [DataSet(x[i:i + 1], y[i:i + 1], None,
                    None if i % 2 else np.ones(1, np.float32)) for i in range(7)]
    jrows = [JDataSet(d.features, d.labels, None, d.labels_mask) for d in rows]
    got = titers.IteratorDataSetIterator(rows, 3)
    want = jiters.IteratorDataSetIterator(jrows, 3)
    _assert_same_batches(_batches(got), _batches(want))
    with pytest.raises(ValueError, match="None"):
        list(titers.IteratorDataSetIterator([rows[0], None], 3))


@pytest.mark.parametrize("shuffle", [False, True])
def test_moving_window_iterator(shuffle):
    rng = np.random.default_rng(5)
    x = rng.random((3, 5, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)
    kw = dict(batch_size=16, shuffle=shuffle, seed=2)
    got = titers.MovingWindowDataSetIterator(DataSet(x, y), 3, 4, **kw)
    want = jiters.MovingWindowDataSetIterator(JDataSet(x, y), 3, 4, **kw)
    _assert_same_batches(_batches(got), _batches(want))
    flat = titers.MovingWindowDataSetIterator(
        DataSet(x.reshape(3, -1), y), 3, 4, rows=5, cols=6, rotations=False)
    assert sum(b.num_examples() for b in flat) == 3 * 3 * 3
    with pytest.raises(ValueError, match="rows=/cols="):
        titers.MovingWindowDataSetIterator(DataSet(x.reshape(3, -1), y), 3, 4)


def test_dataset_split_batch_by_merge():
    x, y = _data(11)
    ds, jds = DataSet(x, y, None, np.ones(11, np.float32)), \
        JDataSet(x, y, None, np.ones(11, np.float32))
    for (a, b) in zip(ds.split_test_and_train(7), jds.split_test_and_train(7)):
        _assert_same_batches(_batches([a]), _batches([b]))
    _assert_same_batches(_batches(ds.batch_by(4)), _batches(jds.batch_by(4)))
    _assert_same_batches(_batches([DataSet.merge(ds.batch_by(4))]),
                         _batches([JDataSet.merge(jds.batch_by(4))]))


def test_feed_pipeline_switch_is_the_argument_only(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DISABLE_FEED_PIPELINE", "1")
    assert titers.feed_pipeline_enabled() is True
    assert titers.feed_pipeline_enabled(False) is False
