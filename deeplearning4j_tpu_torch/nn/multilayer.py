"""MultiLayerNetwork, the sequential-stack model container.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: construction,
``init`` (parameters and the updater state), the all-layer forward
(each layer's input preprocessor first), ``output``, ``feed_forward``,
``predict``, ``evaluate``, ``generate``, and training: ``fit`` runs,
per minibatch, ``conf.iterations`` steps of forward, loss
(``_score_fn``: the head's loss plus the L1/L2 penalties and the
layers' ``__aux_loss__`` states, the MoE load-balancing loss),
``torch.autograd`` backward, per-layer
gradient normalization and the updater, ``params -= update``; ``score``
and ``gradient_and_score`` evaluate without dropout. Truncated BPTT
cuts long sequences into ``tbptt_fwd_length`` chunks with the LSTM
carries crossing them as state; ``rnn_time_step`` streams one timestep
(or a burst, step by step) with the carries kept between calls. The
forward and the score return the layers' new states (BN's moving
statistics, the LSTM carries), cast back to the stored dtypes; listeners
(``set_listeners``) see every step's score, fetched from the device in
batches (``optimize/deferred.py``). ``stage_scan`` puts a
dataset on the device once as ``[steps, batch, ...]`` stacks and
``fit_scan`` trains over them for whole epochs through the same step,
keeping every step's score in one device tensor that is fetched at the
end: no step waits on the host. ``pretrain`` trains the RBM and
AutoEncoder layers one by one, each on the frozen activations below it
(``fit`` runs it once first when ``conf.pretrain`` is set); a net
quantized by ``nn/quantize.py`` serves but refuses ``fit``. Parameters
are a dict per
layer of float32 tensors (float64 after ``init(torch.float64)``, the
gradient check's path) on the net's device, in the reference's layout
(``params["layer1"]["Wqkv"]``), and so is the updater state
(``opt_state["updater"]["layer1"]["Wqkv"]["m"]``), so both carry across
in both directions; batches are moved to the parameters' dtype. Under a
bf16 ``compute_dtype`` the layers compute on a bf16 copy of the
parameters, the head's logits and the loss stay f32, and the gradients,
the updater state and the parameters are f32. Unlike the reference,
which compiles the whole step into one program, each step runs eagerly.

Telemetry (``monitor``) as in the reference: ``fit``'s batches in
``data_load`` spans (path ``fit``), each step in a ``compile`` span at
the first dispatch of its signature (``optimize/deferred.py``
``note_dispatch``) and a ``device_step`` span after; ``stage_scan`` in
``data_load`` (path ``stage_scan``), ``fit_scan`` in one
``compile``/``device_step`` span (path ``fit_scan``, its score fetch
inside, as in the reference), ``predict`` in ``inference``,
``evaluate``'s batches and ``score`` in ``eval``. ``output`` has no
span, as in the reference. A span times the host's enqueue
(``monitor/tracing.py``).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

import deeplearning4j_tpu_torch.nn.layers  # noqa: F401  (registers impls)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    ListDataSetIterator,
    feed_pipeline_enabled,
    wrap_feed,
)
from deeplearning4j_tpu_torch.datasets.staging import stager_of
from deeplearning4j_tpu_torch.monitor import span
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    BackpropType,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers.base import build_layer
from deeplearning4j_tpu_torch.nn.layers.moe import AUX_LOSS_KEY
from deeplearning4j_tpu_torch.nn.updater import (
    GradientNormalization,
    apply_updater,
    init_updater_state,
    normalize_gradient,
)
from deeplearning4j_tpu_torch.optimize.deferred import note_dispatch, score_sink
from deeplearning4j_tpu_torch.util.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.util.dtypes import (
    cast_floats,
    cast_like,
    resolve_compute_dtype,
)
from deeplearning4j_tpu_torch.util.rng import fold_in

Params = Dict[str, Dict[str, torch.Tensor]]
#: layer -> (gradient normalization, its threshold, updater config)
UpdateSpecs = Dict[str, Tuple[GradientNormalization, float, Any]]

_log = logging.getLogger("deeplearning4j_tpu_torch")


def update_specs(gc, impls) -> UpdateSpecs:
    """Each layer's gradient normalization, threshold and updater
    config, resolved against the global configuration."""
    return {impl.name: (
        GradientNormalization(gc.resolve(impl.conf, "gradient_normalization")),
        gc.resolve(impl.conf, "gradient_normalization_threshold"),
        gc.updater_config_for(impl.conf)) for impl in impls}


def apply_updates(params: Params, grads: Params, upd_state: Dict[str, Any],
                  specs: UpdateSpecs, it: int) -> Tuple[Params, Dict[str, Any]]:
    """One optimizer step over every layer: per-layer gradient
    normalization, the updater, ``params -= update``. Returns (new
    params, new updater state)."""
    new_params: Params = {}
    new_upd: Dict[str, Any] = {}
    for name, (nt, thr, ucfg) in specs.items():
        g = normalize_gradient(nt, grads[name], thr)
        new_params[name], new_upd[name] = {}, {}
        for pname, gval in g.items():
            upd, ust = apply_updater(ucfg, gval, upd_state[name][pname], it)
            p = params[name][pname]
            new_params[name][pname] = p - upd.to(p.dtype)
            new_upd[name][pname] = ust
    return new_params, new_upd


def stage_arrays(arrays: Dict[Any, Any], batch_size: int, dtype: torch.dtype,
                 device: torch.device) -> Dict[Any, torch.Tensor]:
    """``fit_scan``'s staging: the full minibatches of each named array,
    as one ``[steps, batch_size, ...]`` tensor on ``device`` in
    ``dtype``; the tail that fills no minibatch is dropped with a
    warning."""
    total = int(next(iter(arrays.values())).shape[0])
    n = (total // batch_size) * batch_size
    if n == 0:
        raise ValueError("batch_size larger than dataset")
    if n != total:
        _log.warning("fit_scan: dropping %d tail examples (dataset %d %% batch %d)",
                     total - n, total, batch_size)
    return {k: torch.as_tensor(np.asarray(a[:n]), dtype=dtype, device=device)
            .reshape((-1, batch_size) + tuple(a.shape[1:]))
            for k, a in arrays.items()}


class MultiLayerNetwork:
    # fit's score fetches wait for a batch (the feed pipeline) or not
    _defer_scores = True

    def __init__(self, conf: MultiLayerConfiguration, device: DeviceLike = None):
        """``device`` defaults to ``cuda``; without a card that raises
        unless ``device="cpu"`` is given."""
        self.device = resolve_device(device)
        self.conf = conf
        self.gc = conf.conf
        self.impls = [build_layer(self.gc, lc, f"layer{i}")
                      for i, lc in enumerate(conf.layers)]
        if not self.impls:
            raise ValueError("empty layer list")
        self.out = self.impls[-1]
        if not self.out.has_loss():
            raise ValueError("last layer must be an output/loss layer")
        self.params: Optional[Params] = None
        self.states: Optional[Dict[str, Any]] = None
        #: {"step": int, "updater": {layer: {param: {state name: tensor}}}}
        self.opt_state: Optional[Dict[str, Any]] = None
        self.listeners: List[Callable[["MultiLayerNetwork", int, float], None]] = []
        self._dtype = torch.float32
        self._score: Union[float, torch.Tensor] = float("nan")
        # mixed precision: params stay f32, layer compute in
        # gc.compute_dtype, logits in f32 (util/dtypes.py policy)
        self._cd = resolve_compute_dtype(self.gc.compute_dtype)
        self._specs = update_specs(self.gc, self.impls)
        # the fit path's dropout streams: step key = fold_in(this, step)
        self._train_key = int(self.gc.seed) + 7919
        self._pretrained = False
        #: the storage mode of quantized weights ("int8", "fp8") or None
        self.quantized: Optional[str] = None
        #: rnn_time_step's carries, {layer: {"h", "c"}}; None = no history
        self._rnn_state: Optional[Dict[str, Any]] = None

    def init(self, dtype: torch.dtype = torch.float32) -> "MultiLayerNetwork":
        """Draw every layer's parameters (f32, then cast to ``dtype``)
        from one generator seeded with the config's seed, and zero the
        updater state."""
        self._dtype = dtype
        gen = torch.Generator(device=self.device).manual_seed(int(self.gc.seed))
        self.params = {}
        self.states = {}
        upd = {}
        for impl in self.impls:
            ucfg = self._specs[impl.name][2]
            p = {n: v.to(dtype) for n, v in
                 impl.init_params(gen, self.device).items()}
            self.params[impl.name] = p
            self.states[impl.name] = impl.init_state(self.device)
            upd[impl.name] = {n: init_updater_state(ucfg, v) for n, v in p.items()}
        self.opt_state = {"step": 0, "updater": upd}
        self._pretrained = False
        # fresh parameters: every signature dispatches anew
        self.__dict__.pop("_dispatch_sigs", None)
        self.__dict__.pop("_scan_sigs", None)
        return self

    def set_listeners(self, *listeners) -> None:
        """Callables ``(net, iteration, score)``, called for every
        training step with the step's number (from 1) and score, and
        after each layer's pretraining with its step count and last
        loss. The step scores are fetched in batches
        (``optimize/deferred.py``): the calls arrive when a listener's
        frequency, the ring's capacity or the end of ``fit`` asks."""
        self.listeners = list(listeners)

    def cast_params(self, params: Params) -> Params:
        """The compute-dtype copy of ``params`` (a no-op under f32). The
        output head is cast too: its product accumulates in f32."""
        return cast_floats(params, self._cd) if self._cd is not None else params

    def _cast_input(self, x: torch.Tensor) -> torch.Tensor:
        if self._cd is not None and self.impls[0].cast_input:
            return x.to(self._cd)
        return x

    def _layer_input(self, i: int, p: Dict[str, torch.Tensor], x: torch.Tensor
                     ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Layer i's preprocessor applied to ``x``, and its compute-dtype
        parameters; a matmul-free head (LossLayer) takes its input in
        f32 instead, so the loss runs in f32."""
        pre = self.conf.input_preprocessors.get(i)
        if pre is not None:
            x = pre(x)
        if self._cd is not None:
            if i == len(self.impls) - 1 and self.out.has_loss() and "W" not in p:
                x = x.float()
            else:
                p = cast_floats(p, self._cd)
        return p, x

    def _forward(self, params: Params, states: Dict[str, Any], x: torch.Tensor,
                 train: bool = False, rng: Optional[int] = None,
                 fmask: Optional[torch.Tensor] = None, n: Optional[int] = None
                 ) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
        """The forward of the first ``n`` layers (all by default):
        (each layer's output, their new states)."""
        acts, new_states = [], {}
        x = self._cast_input(x)
        for i, impl in enumerate(self.impls[:n]):
            p, x = self._layer_input(i, params[impl.name], x)
            lrng = fold_in(rng, i) if rng is not None else None
            x, ns = impl.forward(p, x, states[impl.name], train, lrng, mask=fmask)
            new_states[impl.name] = cast_like(ns, states[impl.name])
            acts.append(x)
        return acts, new_states

    @torch.no_grad()
    def output(self, x, train: bool = False,
               features_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Network output for ``x`` (token ids for a GPT stack, [b, t, f]
        features for a recurrent one, with an optional [b, t] features
        mask; NHWC images for a CNN): the head's activations, in the
        parameters' dtype (f32 under bf16 compute), as a numpy array.
        Dropout is off and BN uses its moving statistics."""
        if train:
            raise ValueError("use fit() for training-mode passes")
        return _numpy(self.infer_output_fn()(
            self.params, self.states, self._tensor(x),
            self._tensor(features_mask)))

    def infer_output_fn(self):
        """The serving engine's batched output program, shared with
        ``output()``: a pure ``(params, states, x, fmask) ->
        predictions`` (a tensor on x's device). ``ParallelInference``
        replicas call it with their own device copies of the parameters
        and states."""
        return self._infer_output

    @torch.no_grad()
    def _infer_output(self, params: Params, states: Dict[str, Any],
                      x: torch.Tensor, fmask: Optional[torch.Tensor]
                      ) -> torch.Tensor:
        acts, _ = self._forward(params, states, x, fmask=fmask)
        return acts[-1]

    @torch.no_grad()
    def feed_forward(self, x, train: bool = False) -> List[np.ndarray]:
        """Every layer's activations. ``train=True`` runs the training
        forward (dropout from a fixed key, BN on the batch's moments)
        without keeping its new states."""
        acts, _ = self._forward(self.params, self.states, self._tensor(x),
                                train=train, rng=0 if train else None)
        return [_numpy(a) for a in acts]

    def predict(self, x) -> np.ndarray:
        """Class ids: the argmax of ``output``, taken on the device."""
        with span("inference", path="predict"):
            return self._predict_ids(x)

    @torch.no_grad()
    def _predict_ids(self, x) -> np.ndarray:
        acts, _ = self._forward(self.params, self.states, self._tensor(x))
        return torch.argmax(acts[-1], dim=-1).cpu().numpy().astype(np.int64)

    def evaluate(self, data, num_classes: Optional[int] = None,
                 batch_size: Optional[int] = None, labels_list=None):
        """Classification ``Evaluation`` over a DataSet (in batches of
        ``batch_size``, all at once by default) or an iterable of them.
        For unmasked one-hot [b, C] labels only the predicted ids leave
        the device; masked or time-series batches go through ``output``
        and ``Evaluation.eval``."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        if isinstance(data, DataSet):
            data = ListDataSetIterator(data, batch_size or data.num_examples())
        ev = Evaluation(num_classes=num_classes, labels_list=labels_list)
        pad_safe = self._pad_tail_safe()
        canon: Optional[int] = None
        for ds in data:
            labels = np.asarray(ds.labels)
            masked = ds.features_mask is not None or ds.labels_mask is not None
            fast = (not masked and labels.ndim == 2
                    and not np.issubdtype(labels.dtype, np.integer))
            n = int(np.shape(ds.features)[0])
            canon = n if canon is None else canon
            # the reference pads a short tail to the first batch's rows so
            # that one program serves every batch; the port runs the tail
            # as it is, and signs it as the reference's padded dispatch
            rows = canon if pad_safe and not masked and n < canon else n
            compiling = note_dispatch(self, (
                "predict" if fast else "output", False, None,
                (rows,) + tuple(np.shape(ds.features)[1:]),
                str(_dtype_of(ds.features))))
            with span("eval", path="evaluate", compile=bool(compiling),
                      rows=n):
                if fast:
                    ev._ensure(labels.shape[-1])
                    ev.confusion.add_batch(np.argmax(labels, axis=-1),
                                           self._predict_ids(ds.features))
                else:
                    ev.eval(labels, self.output(
                        ds.features, features_mask=ds.features_mask),
                        mask=ds.labels_mask)
        return ev

    # ------------------------------------------------------------ training

    def _tensor(self, a) -> Optional[torch.Tensor]:
        """A batch array on the net's device in the parameters' dtype:
        features and labels are float, as in the reference (ids become
        exact floats and the layers take them back to ints). A tensor
        already there (a staged batch's) passes as it is."""
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=self._dtype)
        return torch.as_tensor(np.asarray(a), dtype=self._dtype,
                               device=self.device)

    def _batch(self, ds: DataSet):
        return (self._tensor(ds.features), self._tensor(ds.labels),
                self._tensor(ds.features_mask), self._tensor(ds.labels_mask))

    def _score_fn(self, params: Params, states: Dict[str, Any],
                  x: torch.Tensor, y: torch.Tensor, train: bool,
                  rng: Optional[int], fmask: Optional[torch.Tensor],
                  lmask: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """(data loss (the output layer's) plus the L1/L2 penalties and
        every ``__aux_loss__`` of the layers' new states, the layers' new
        states): the quantity a step minimizes. Layers compute on the
        compute-dtype copy of ``params``; the penalties read the f32
        parameters."""
        hidden, new_states = self._forward(params, states, x, train, rng,
                                           fmask, n=-1)
        x = hidden[-1] if hidden else self._cast_input(x)
        i_out = len(self.impls) - 1
        p_out, x = self._layer_input(i_out, params[self.out.name], x)
        lrng = fold_in(rng, i_out) if rng is not None else None
        score = self.out.score(p_out, x, y, states[self.out.name], train,
                               lrng, mask=lmask)
        new_states[self.out.name] = states[self.out.name]
        for impl in self.impls:
            score = score + impl.regularization_penalty(
                params[impl.name]).to(score.dtype)
        return add_aux_losses(score, new_states), new_states

    @staticmethod
    def _grads(params: Params, loss_fn
               ) -> Tuple[torch.Tensor, Params, Dict[str, Any]]:
        """(loss, d loss / d params, the new states) by
        ``torch.autograd``; ``loss_fn`` returns (loss, new states). The
        states leave detached: a carry crosses into the next step as
        data, so gradients stop there (truncated BPTT)."""
        leaves = {l: {n: t.detach().requires_grad_() for n, t in p.items()}
                  for l, p in params.items()}
        with torch.enable_grad():
            loss, new_states = loss_fn(leaves)
            flat = [t for p in leaves.values() for t in p.values()]
            gs = iter(torch.autograd.grad(loss, flat, allow_unused=True))
        grads: Params = {}
        for l, p in leaves.items():
            grads[l] = {}
            for n, t in p.items():
                g = next(gs)  # None: the loss does not read this parameter
                grads[l][n] = torch.zeros_like(t) if g is None else g
        return loss.detach(), grads, _detach(new_states)

    def _train_step(self, x, y, fmask, lmask) -> torch.Tensor:
        """One optimization step; returns the step's score (a device
        scalar, fetched only when asked for)."""
        it = self.opt_state["step"]
        rng = fold_in(self._train_key, it)
        score, grads, new_states = self._grads(
            self.params, lambda p: self._score_fn(
                p, self.states, x, y, True, rng, fmask, lmask))
        self.params, new_upd = apply_updates(
            self.params, grads, self.opt_state["updater"], self._specs, it)
        self.states = new_states
        self.opt_state = {"step": it + 1, "updater": new_upd}
        return score

    def _pad_tail_safe(self) -> bool:
        """Tail padding is exact only where no layer takes statistics
        over the batch (``ShapeBucketingIterator``)."""
        return not any(getattr(i, "batch_statistics", False) for i in self.impls)

    def _stage_ds(self, ds):
        """The feed's placement, on ``DeviceFeedIterator``'s thread: the
        batch on the net's device in the parameters' dtype
        (``datasets/staging.py``: on the card, from pinned memory on the
        feed's side stream)."""
        if not isinstance(ds, DataSet):
            return ds
        return stager_of(self).stage_ds(ds)

    def fit(self, data: Union[DataSet, Iterable[DataSet], np.ndarray],
            labels: Optional[np.ndarray] = None,
            batch_size: Optional[int] = None,
            feed_pipeline: Optional[bool] = None) -> None:
        """Train on a DataSet (one minibatch, or minibatches of
        ``batch_size``), a ``DataSetIterator`` or another iterable of
        DataSets, or features + ``labels`` arrays; ``conf.iterations``
        steps per minibatch. With ``conf.pretrain`` set, the first call
        pretrains first. An iterator goes through the feed pipeline
        (``datasets/iterators.py``), unless ``feed_pipeline=False``: its
        short tail padded to the canonical batch (not for nets with
        batch statistics), batches prepared on a host thread and staged
        on the device by another while the step before runs. With the
        pipeline the scores are fetched in batches
        (``optimize/deferred.py``); without it, after every step."""
        refuse_quantized(self)
        if self.params is None:
            self.init()
        if isinstance(data, np.ndarray):
            data = DataSet(data, labels)
        pipeline = feed_pipeline_enabled(feed_pipeline)
        prev_defer, self._defer_scores = self._defer_scores, pipeline
        threads = []
        try:
            if self.conf.pretrain and not self._pretrained:
                self.pretrain(data, batch_size=batch_size)
                self._pretrained = True
            if isinstance(data, DataSet):
                if batch_size is None:
                    self._fit_batch(data)
                    return
                data = ListDataSetIterator(data, batch_size)
            it, threads = wrap_feed(data, pipeline, self._pad_tail_safe(),
                                    self._stage_ds)
            for ds in it:
                self._fit_batch(ds)
        finally:
            for stage in reversed(threads):
                stage.close()
            score_sink(self).flush()
            self._defer_scores = prev_defer

    def _pretrain_step(self, i: int, ustate: Dict[str, Any], it: int,
                       x: torch.Tensor, rng: int):
        """One unsupervised update of layer i on the frozen stack below
        it (inference forward on the stored parameters): CD-k for an RBM
        (its gradient supplied), autograd of the reconstruction loss for
        an AutoEncoder. Returns (layer i's new parameters, its new
        updater state, the loss)."""
        impl = self.impls[i]
        with torch.no_grad():
            for j in range(i):
                pre = self.conf.input_preprocessors.get(j)
                if pre is not None:
                    x = pre(x)
                x, _ = self.impls[j].forward(self.params[self.impls[j].name], x,
                                             self.states[self.impls[j].name],
                                             False, None)
            pre = self.conf.input_preprocessors.get(i)
            if pre is not None:
                x = pre(x)
        return pretrain_update(impl, self.params[impl.name], ustate, it, x, rng,
                               self._specs[impl.name][2])

    def pretrain(self, data, epochs: int = 1,
                 batch_size: Optional[int] = None) -> Dict[str, float]:
        """Layer-wise greedy unsupervised pretraining: each RBM and
        AutoEncoder layer in order trains on the frozen activations of
        the layers below it, over ``data`` (a DataSet in minibatches of
        ``batch_size``, 32 by default, or an iterable of DataSets) for
        ``epochs`` passes, with its own updater state; its draws come
        from the stream ``seed + 104729 * (i + 1)`` folded with the
        iteration. Returns each trained layer's last loss; listeners are
        called after each layer."""
        if self.params is None:
            self.init()
        if isinstance(data, DataSet):
            data = ListDataSetIterator(data, batch_size or 32)
        losses: Dict[str, float] = {}
        for i, impl in enumerate(self.impls):
            if not hasattr(impl, "pretrain_loss"):
                continue
            ucfg = self._specs[impl.name][2]
            ustate = {n: init_updater_state(ucfg, v)
                      for n, v in self.params[impl.name].items()}
            key = int(self.gc.seed) + 104729 * (i + 1)
            it, loss = 0, float("nan")
            for _ in range(max(1, epochs)):
                for ds in data:
                    new_p, ustate, loss = self._pretrain_step(
                        i, ustate, it, self._tensor(ds.features),
                        fold_in(key, it))
                    self.params = {**self.params, impl.name: new_p}
                    it += 1
            losses[impl.name] = self._score = float(loss)
            for cb in self.listeners:
                cb(self, it, self._score)
        return losses

    def _fit_batch(self, ds: DataSet) -> None:
        if (self.conf.backprop_type == BackpropType.TRUNCATED_BPTT
                and np.ndim(ds.features) == 3
                and ds.features.shape[1] > self.conf.tbptt_fwd_length):
            self._fit_tbptt(ds)
            return
        with span("data_load", path="fit"):
            # a staged batch's tensors pass as they are
            x, y, fm, lm = self._batch(ds)
        compiling = note_dispatch(self, train_signature(x, y, fm, lm))
        sink = score_sink(self)
        for _ in range(max(1, self.gc.iterations)):
            with span("compile" if compiling else "device_step"):
                score = self._train_step(x, y, fm, lm)
            compiling = False
            # the score stays on the device until a listener's frequency,
            # the ring's capacity or the end of fit() asks for it; without
            # the feed pipeline, at once
            sink.push(self.opt_state["step"], score)
            if not self._defer_scores:
                sink.flush()

    # ------------------------------------------------------ scanned fit

    def stage_scan(self, ds: DataSet, batch_size: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The dataset on the net's device, once, as scan-ready minibatch
        stacks (features [steps, batch, ...], labels likewise) in the
        parameters' dtype, for ``fit_scan(staged=...)``. Masked data
        raises; a tail that fills no minibatch is dropped with a
        warning."""
        if ds.features_mask is not None or ds.labels_mask is not None:
            raise ValueError("fit_scan does not support masked DataSets; use fit()")
        n = (ds.num_examples() // batch_size) * batch_size
        with span("data_load", path="stage_scan", examples=n):
            staged = stage_arrays({"x": ds.features, "y": ds.labels},
                                  batch_size, self._dtype, self.device)
        return staged["x"], staged["y"]

    def fit_scan(self, ds: Optional[DataSet], batch_size: int, epochs: int = 1,
                 staged=None) -> np.ndarray:
        """``epochs`` passes over the staged minibatches (``staged``, or
        ``stage_scan(ds, batch_size)``), ``conf.iterations`` steps of
        ``_train_step`` each; listeners are not called. Each minibatch's
        last score lands in one preallocated device tensor, fetched once
        at the end: the host only queues work. Returns the scores
        [epochs * steps]; ``score()`` is the last."""
        if self.params is None:
            self.init()
        xb, yb = staged if staged is not None else self.stage_scan(ds, batch_size)
        steps, iters = xb.shape[0], max(1, self.gc.iterations)
        scores = torch.empty(epochs * steps, device=self.device,
                             dtype=torch.promote_types(self._dtype, torch.float32))
        with span("compile" if scan_dispatch(self, epochs) else "device_step",
                  path="fit_scan", epochs=epochs):
            for e in range(epochs):
                for s in range(steps):
                    for _ in range(iters):
                        score = self._train_step(xb[s], yb[s], None, None)
                    scores[e * steps + s] = score
            out = scores.cpu().numpy()
        self._score = float(out[-1])
        return out

    def score(self, ds: Optional[DataSet] = None) -> float:
        """Loss on ``ds`` in eval mode (no dropout), or the last training
        step's score."""
        if ds is None:
            return float(self._score)
        x, y, fm, lm = self._batch(ds)
        with span("eval", path="score"), torch.no_grad():
            return float(self._score_fn(self.params, self.states, x, y,
                                        False, None, fm, lm)[0])

    def gradient_and_score(self, ds: DataSet) -> Tuple[Params, float]:
        """Gradients and score in eval mode (no dropout), the
        gradient-check entry point."""
        x, y, fm, lm = self._batch(ds)
        score, grads, _ = self._grads(self.params, lambda p: self._score_fn(
            p, self.states, x, y, False, None, fm, lm))
        return grads, float(score)

    # ----------------------------------------------------------- tbptt

    def _recurrent_impls(self) -> list:
        from deeplearning4j_tpu_torch.nn.layers.recurrent import GravesLSTMImpl
        return [i for i in self.impls if isinstance(i, GravesLSTMImpl)]

    def _fit_tbptt(self, ds: DataSet) -> None:
        """Truncated BPTT: the sequence is cut into ``tbptt_fwd_length``
        chunks, one step each; the LSTM carries cross the chunks as
        state (gradients stop at the boundaries) and the stored states
        come back after the last chunk."""
        T = ds.features.shape[1]
        L = self.conf.tbptt_fwd_length
        b = ds.features.shape[0]
        labels = ds.labels
        if not isinstance(labels, torch.Tensor):
            labels = np.asarray(labels)
        # sparse ids must be integers, so that a dense [b, nOut] label
        # matrix with nOut == T is never read as per-timestep ids (a
        # staged batch's labels are in the parameters' float dtype, as
        # the reference's are)
        sparse_ids = (labels.ndim == 2 and tuple(labels.shape) == (b, T)
                      and _integer(labels))
        if not (labels.ndim == 3 or sparse_ids):
            hint = ""
            if labels.ndim == 2 and tuple(labels.shape) == (b, T):
                hint = (f" Labels have the [batch, T] shape but float dtype "
                        f"{labels.dtype}; cast to an integer dtype to use "
                        f"the sparse-id path.")
            raise ValueError(
                f"TBPTT requires per-timestep labels [batch, T, nOut] (or "
                f"sparse INT ids [batch, T]); got shape {tuple(labels.shape)}. "
                f"For sequence-level labels use backprop_type='standard'."
                + hint)
        rec = self._recurrent_impls()
        if not rec:
            raise ValueError("TBPTT configured but no recurrent layers present")
        saved = {}
        for impl in rec:
            saved[impl.name] = self.states[impl.name]
            zeros = torch.zeros(b, impl.conf.n_out, dtype=self._dtype,
                                device=self.device)
            self.states[impl.name] = {"h": zeros, "c": zeros.clone()}
        cut = lambda a, sl: None if a is None else a[:, sl]  # noqa: E731
        try:
            for t0 in range(0, T, L):
                sl = slice(t0, t0 + L)
                self._fit_batch(DataSet(ds.features[:, sl], ds.labels[:, sl],
                                        cut(ds.features_mask, sl),
                                        cut(ds.labels_mask, sl)))
        finally:
            for impl in rec:  # rnnClearPreviousState after the fit
                self.states[impl.name] = saved[impl.name]

    # --------------------------------------------------- streaming rnn

    def _init_rnn_state(self, b: int) -> Dict[str, Any]:
        state = {}
        for impl in self.impls:
            if hasattr(impl, "rnn_time_step"):
                zeros = torch.zeros(b, impl.conf.n_out, dtype=self._dtype,
                                    device=self.device)
                state[impl.name] = {"h": zeros, "c": zeros.clone()}
        return state

    @torch.no_grad()
    def _rnn_step(self, params: Params, rstate: Dict[str, Any],
                  xt: torch.Tensor, impls: Optional[list] = None):
        """One timestep through ``impls`` (the whole stack by default):
        recurrent layers advance their carries, the others run their
        inference forward. Returns (the last layer's output, the new
        carries)."""
        new_rstate = dict(rstate)
        for impl in self.impls if impls is None else impls:
            if hasattr(impl, "rnn_time_step"):
                xt, new_rstate[impl.name] = impl.rnn_time_step(
                    params[impl.name], xt, rstate[impl.name])
            else:
                xt, _ = impl.forward(params[impl.name], xt,
                                     self.states[impl.name], False, None)
        return xt, new_rstate

    def rnn_time_step(self, x) -> np.ndarray:
        """Stateful streaming inference: one timestep [b, f] -> [b, out],
        or a burst [b, t, f] -> [b, t, out] run step by step; the LSTM
        carries persist across calls until
        :meth:`rnn_clear_previous_state`. The stack runs on the f32
        parameters, as the reference's."""
        x = np.asarray(x)
        if self._rnn_state is None:
            self._rnn_state = self._init_rnn_state(x.shape[0])
        xt = self._tensor(x)
        if x.ndim == 3:
            outs = []
            for s in range(xt.shape[1]):
                o, self._rnn_state = self._rnn_step(self.params,
                                                    self._rnn_state, xt[:, s])
                outs.append(o)
            out = torch.stack(outs, dim=1)
        else:
            out, self._rnn_state = self._rnn_step(self.params,
                                                  self._rnn_state, xt)
        return _numpy(out)

    def rnn_clear_previous_state(self) -> None:
        self._rnn_state = None

    # ----------------------------------------------------- flat param views

    def _flat_order(self) -> List[Tuple[str, str]]:
        """(layer, param) in the reference's ``ravel_pytree`` order:
        sorted keys at each level, so "layer10" sorts before "layer2"."""
        return [(l, n) for l in sorted(self.params) for n in sorted(self.params[l])]

    def params_flat(self) -> np.ndarray:
        """One flat vector of every parameter."""
        return torch.cat([self.params[l][n].reshape(-1)
                          for l, n in self._flat_order()]).cpu().numpy()

    def set_params_flat(self, vec) -> None:
        flat = self._tensor(vec)
        if flat.numel() != self.num_params():
            raise ValueError(f"flat vector of {flat.numel()} values, the net "
                             f"has {self.num_params()} parameters")
        new: Params = {l: {} for l in self.params}
        at = 0
        for l, n in self._flat_order():
            t = self.params[l][n]
            new[l][n] = flat[at:at + t.numel()].reshape(t.shape).clone()
            at += t.numel()
        self.params = {l: {n: new[l][n] for n in p} for l, p in self.params.items()}

    def num_params(self) -> int:
        return sum(t.numel() for p in self.params.values() for t in p.values())

    def clone(self) -> "MultiLayerNetwork":
        """A second net on the same configuration and device holding the
        same parameters, states and updater state. The trees are new
        dicts around the same tensors: no training op writes a tensor in
        place (each step builds new ones), so the copy stays as it was
        while this net trains on."""
        other = MultiLayerNetwork(self.conf, device=self.device)
        if self.params is not None:
            other._dtype = self._dtype
            other.params = _tree_copy(self.params)
            other.states = _tree_copy(self.states)
            other.opt_state = _tree_copy(self.opt_state)
        return other

    def generate(self, prompt_ids, max_new_tokens: int, **kwargs) -> np.ndarray:
        """Autoregressive generation (``nn/generate.py``): for a GPT
        stack a bucketed prefill through the flash kernel, then a
        KV-cache decode loop; for a recurrent stack the prompt streamed
        step by step through the LSTM scan, then one step per token.
        Knobs: ``temperature`` / ``top_k`` / ``top_p`` / ``eos_token`` /
        ``seed``. Returns [b, t0 + max_new_tokens] int64 token ids."""
        from deeplearning4j_tpu_torch.nn.generate import generate
        return generate(self, prompt_ids, max_new_tokens, **kwargs)


def add_aux_losses(score: torch.Tensor, states: Dict[str, Any]) -> torch.Tensor:
    """``score`` plus every layer's ``__aux_loss__`` state (the MoE
    load-balancing loss, produced inside the step, so it stays in the
    autograd graph), in layer order."""
    for ns in states.values():
        if isinstance(ns, dict) and AUX_LOSS_KEY in ns:
            score = score + ns[AUX_LOSS_KEY].to(score.dtype)
    return score


def train_signature(x, y, fm, lm) -> tuple:
    """A train step's dispatch signature, the reference's: the masks'
    presence, the mesh token (None until ROADMAP A9), the operands'
    shapes and dtypes (an absent mask as the reference's 0-d one)."""
    shape = lambda t: () if t is None else tuple(t.shape)  # noqa: E731
    return ("train", fm is not None, lm is not None, None,
            tuple(x.shape), str(x.dtype), tuple(y.shape), str(y.dtype),
            shape(fm), shape(lm))


def scan_dispatch(net, epochs: int) -> bool:
    """Whether ``fit_scan`` at ``epochs`` runs for the first time since
    ``init``: the reference labels that call ``compile`` (its scan over
    ``epochs`` is one program), without counting a dispatch miss."""
    seen = net.__dict__.setdefault("_scan_sigs", set())
    fresh = epochs not in seen
    seen.add(epochs)
    return fresh


def _dtype_of(a):
    return a.dtype if hasattr(a, "dtype") else np.asarray(a).dtype


def refuse_quantized(net) -> None:
    """``fit`` refuses a net whose weights are quantized: the round()
    in them has no useful gradient."""
    if getattr(net, "quantized", None) is not None:
        raise ValueError(
            f"this net holds {net.quantized}-quantized serving weights "
            "(nn/quantize.py): the round() in them has no useful "
            "gradient; train the fp32 original and re-quantize")


def pretrain_update(impl, p: Dict[str, torch.Tensor], ustate: Dict[str, Any],
                    it: int, x: torch.Tensor, rng: int, ucfg):
    """One pretraining update of one layer on its input ``x``: the CD-k
    gradient of an RBM, or autograd of an AutoEncoder's reconstruction
    loss, then the updater. Returns (new parameters, new updater state,
    the loss)."""
    if hasattr(impl, "cd_gradients"):
        with torch.no_grad():
            g, loss = impl.cd_gradients(p, x, rng)
    else:
        leaves = {n: t.detach().requires_grad_() for n, t in p.items()}
        with torch.enable_grad():
            loss = impl.pretrain_loss(leaves, x, rng)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        g = {n: torch.zeros_like(t) if gr is None else gr
             for (n, t), gr in zip(leaves.items(), grads)}
        loss = loss.detach()
    new_p, new_u = {}, {}
    for pname, gval in g.items():
        u, ust = apply_updater(ucfg, gval, ustate[pname], it)
        new_p[pname] = p[pname] - u.to(p[pname].dtype)
        new_u[pname] = ust
    return new_p, new_u, loss


def _integer(a) -> bool:
    """Whether an array's or a tensor's dtype is an integer one."""
    if isinstance(a, torch.Tensor):
        return not (a.is_floating_point() or a.is_complex() or a.dtype == torch.bool)
    return np.issubdtype(a.dtype, np.integer)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A result on the host; half-precision values as f32."""
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


def _tree_copy(tree: Any) -> Any:
    """New dicts around the same leaves."""
    if isinstance(tree, dict):
        return {k: _tree_copy(v) for k, v in tree.items()}
    return tree


def _detach(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach() if isinstance(tree, torch.Tensor) else tree
