"""ComputationGraph, the DAG model container.

Counterpart of ``deeplearning4j_tpu/nn/graph.py``: the configuration
(``VertexDef``, ``ComputationGraphConfiguration`` and its
``GraphBuilder``, JSON and YAML byte for byte the reference's),
``topological_order`` (Kahn's algorithm; cycles and unknown inputs
raise), and the container. Its forward visits the vertices in
topological order (layer ``vi``'s dropout stream is ``fold_in(rng,
vi)``; a mask survives only 3-D outputs); its score sums the loss
outputs' losses (streams ``fold_in(rng, 10_000 + vi)``), the L1/L2
penalties and any ``__aux_loss__``; a step is autograd's backward and
the MultiLayerNetwork's per-layer gradient normalization and updater.
``fit`` takes DataSets, MultiDataSets and their iterators (truncated
BPTT when configured; an iterator through the MultiLayerNetwork's feed
pipeline, its batches staged as MultiDataSets by ``_stage_mds``),
``stage_scan``/``fit_scan`` train over staged minibatch stacks with one
fetch at the end, ``rnn_time_step`` streams
single steps or [b, t, f] bursts through the recurrent vertices, and
``generate`` serves a single-input linear layer chain. Features map
onto the inputs in ``add_inputs`` order, labels onto the outputs in
``set_outputs`` order. Parameters, states and the updater state are the
reference's trees, so they carry across both ways
(``util/model_serializer.py``). ``pretrain`` trains the RBM and
AutoEncoder vertices one by one on the frozen activations of their
inputs; a quantized graph (``nn/quantize.py``) refuses ``fit``. Each
step runs eagerly. Its spans are the reference's: ``data_load`` (path
``graph_fit``, and ``stage_scan``), ``compile``/``device_step`` per step
and around ``fit_scan`` (path ``graph_fit_scan``), ``eval`` (path
``graph_score``), as ``MultiLayerNetwork``'s.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

import deeplearning4j_tpu_torch.nn.layers  # noqa: F401  (registers impls)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    ListMultiDataSetIterator,
    feed_pipeline_enabled,
    wrap_feed,
)
from deeplearning4j_tpu_torch.datasets.staging import stager_of
from deeplearning4j_tpu_torch.monitor import span
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    BackpropType,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.graph import GraphVertex, vertex_from_dict
from deeplearning4j_tpu_torch.nn.layers.base import build_layer
from deeplearning4j_tpu_torch.nn.multilayer import (
    MultiLayerNetwork,
    Params,
    _numpy,
    add_aux_losses,
    apply_updates,
    pretrain_update,
    refuse_quantized,
    scan_dispatch,
    stage_arrays,
    update_specs,
)
from deeplearning4j_tpu_torch.nn.updater import init_updater_state
from deeplearning4j_tpu_torch.optimize.deferred import note_dispatch, score_sink
from deeplearning4j_tpu_torch.util.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.util.dtypes import (
    cast_floats,
    cast_like,
    resolve_compute_dtype,
)
from deeplearning4j_tpu_torch.util.rng import fold_in


@dataclasses.dataclass
class VertexDef:
    name: str
    kind: str  # "input" | "layer" | "op"
    inputs: List[str]
    layer: Optional[L.Layer] = None
    vertex: Optional[GraphVertex] = None


@dataclasses.dataclass
class ComputationGraphConfiguration:
    conf: NeuralNetConfiguration
    vertices: List[VertexDef]
    outputs: List[str]
    pretrain: bool = False
    backprop_type: str = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20

    class GraphBuilder:
        """The fluent graph builder."""

        def __init__(self, conf: Optional[NeuralNetConfiguration] = None):
            self._conf = conf or NeuralNetConfiguration()
            self._vertices: List[VertexDef] = []
            self._outputs: List[str] = []
            self._pretrain = False
            self._backprop_type = BackpropType.STANDARD
            self._tbptt_fwd = 20
            self._tbptt_back = 20

        def pretrain(self, flag: bool):
            self._pretrain = flag
            return self

        def backprop_type(self, t: str):
            self._backprop_type = t
            return self

        def t_bptt_forward_length(self, n: int):
            self._tbptt_fwd = n
            return self

        def t_bptt_backward_length(self, n: int):
            self._tbptt_back = n
            return self

        def add_inputs(self, *names: str):
            for n in names:
                self._vertices.append(VertexDef(n, "input", []))
            return self

        def add_layer(self, name: str, layer: L.Layer, *inputs: str):
            self._vertices.append(VertexDef(name, "layer", list(inputs), layer=layer))
            return self

        def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str):
            self._vertices.append(VertexDef(name, "op", list(inputs), vertex=vertex))
            return self

        def set_outputs(self, *names: str):
            self._outputs = list(names)
            return self

        def build(self) -> "ComputationGraphConfiguration":
            return ComputationGraphConfiguration(
                conf=self._conf, vertices=copy.deepcopy(self._vertices),
                outputs=list(self._outputs), pretrain=self._pretrain,
                backprop_type=self._backprop_type,
                tbptt_fwd_length=self._tbptt_fwd,
                tbptt_back_length=self._tbptt_back)

    @staticmethod
    def builder(conf: Optional[NeuralNetConfiguration] = None):
        return ComputationGraphConfiguration.GraphBuilder(conf)

    def to_json(self) -> str:
        def vd(v: VertexDef):
            d = {"name": v.name, "kind": v.kind, "inputs": v.inputs}
            if v.layer is not None:
                d["layer"] = v.layer.to_dict()
            if v.vertex is not None:
                d["vertex"] = v.vertex.to_dict()
            return d

        return json.dumps({
            "conf": self.conf.to_dict(),
            "vertices": [vd(v) for v in self.vertices],
            "outputs": self.outputs,
            "pretrain": self.pretrain,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
        }, indent=2)

    def to_yaml(self) -> str:
        from deeplearning4j_tpu_torch.util.yaml_io import json_to_yaml
        return json_to_yaml(self.to_json())

    @staticmethod
    def from_yaml(s: str) -> "ComputationGraphConfiguration":
        from deeplearning4j_tpu_torch.util.yaml_io import yaml_to_json
        return ComputationGraphConfiguration.from_json(yaml_to_json(s))

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        d = json.loads(s)
        verts = [VertexDef(
            name=v["name"], kind=v["kind"], inputs=v["inputs"],
            layer=L.layer_from_dict(v["layer"]) if "layer" in v else None,
            vertex=vertex_from_dict(v["vertex"]) if "vertex" in v else None,
        ) for v in d["vertices"]]
        return ComputationGraphConfiguration(
            conf=NeuralNetConfiguration.from_dict(d["conf"]),
            vertices=verts, outputs=d["outputs"],
            pretrain=d.get("pretrain", False),
            backprop_type=d.get("backprop_type", BackpropType.STANDARD),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20))


def topological_order(vertices: Sequence[VertexDef]) -> List[str]:
    """Kahn's algorithm, vertices of in-degree 0 first in definition
    order; an unknown input or a cycle raises ``ValueError``."""
    by_name = {v.name: v for v in vertices}
    for v in vertices:
        for i in v.inputs:
            if i not in by_name:
                raise ValueError(f"vertex '{v.name}' references unknown input '{i}'")
    in_deg = {v.name: len(v.inputs) for v in vertices}
    children: Dict[str, List[str]] = {v.name: [] for v in vertices}
    for v in vertices:
        for i in v.inputs:
            children[i].append(v.name)
    queue = [n for n, d in in_deg.items() if d == 0]
    order: List[str] = []
    while queue:
        n = queue.pop(0)
        order.append(n)
        for c in children[n]:
            in_deg[c] -= 1
            if in_deg[c] == 0:
                queue.append(c)
    if len(order) != len(vertices):
        cyc = [n for n, d in in_deg.items() if d > 0]
        raise ValueError(f"cycle detected in graph involving {cyc}")
    return order


Tensors = Dict[str, torch.Tensor]


class ComputationGraph:
    # fit's score fetches wait for a batch (the feed pipeline) or not
    _defer_scores = True

    def __init__(self, conf: ComputationGraphConfiguration,
                 device: DeviceLike = None):
        """``device`` defaults to ``cuda``; without a card that raises
        unless ``device="cpu"`` is given."""
        self.device = resolve_device(device)
        self.conf = conf
        self.gc = conf.conf
        self.defs = {v.name: v for v in conf.vertices}
        self.order = topological_order(conf.vertices)
        self.input_names = [v.name for v in conf.vertices if v.kind == "input"]
        self.output_names = conf.outputs
        if not self.output_names:
            raise ValueError("graph has no outputs set")
        self.impls = {v.name: build_layer(self.gc, v.layer, v.name)
                      for v in conf.vertices if v.kind == "layer"}
        self.loss_outputs = [n for n in self.output_names
                             if n in self.impls and self.impls[n].has_loss()]
        if not self.loss_outputs:
            raise ValueError("at least one output must be an output/loss layer")
        self.params: Optional[Params] = None
        self.states: Optional[Dict[str, Any]] = None
        self.opt_state: Optional[Dict[str, Any]] = None
        self.listeners: List[Callable[["ComputationGraph", int, float], None]] = []
        self._score: Union[float, torch.Tensor] = float("nan")
        self._dtype = torch.float32
        self._cd = resolve_compute_dtype(self.gc.compute_dtype)
        self._specs = update_specs(self.gc, self.impls.values())
        # inputs that feed an index-input layer (an embedding) keep their
        # dtype under a compute dtype; the walk passes through op vertices
        # (they hand ids on unchanged) and ends at layers
        self._input_casts = {}
        for name in self.input_names:
            ok, frontier, seen = True, [name], set()
            while frontier and ok:
                src = frontier.pop()
                if src in seen:
                    continue
                seen.add(src)
                for v in conf.vertices:
                    if src not in v.inputs:
                        continue
                    if v.kind == "layer":
                        ok = ok and self.impls[v.name].cast_input
                    elif v.kind != "input":
                        frontier.append(v.name)
            self._input_casts[name] = ok
        self._train_key = int(self.gc.seed) + 7919
        self._pretrained = False
        #: the storage mode of quantized weights ("int8", "fp8") or None
        self.quantized: Optional[str] = None
        #: rnn_time_step's carries, {layer: {"h", "c"}}; empty = no history
        self._rnn_state: Dict[str, Any] = {}

    def init(self, dtype: torch.dtype = torch.float32) -> "ComputationGraph":
        """Draw every layer's parameters (f32, then cast to ``dtype``),
        layers in sorted name order from one generator seeded with the
        config's seed, and zero the updater state."""
        self._dtype = dtype
        gen = torch.Generator(device=self.device).manual_seed(int(self.gc.seed))
        self.params, self.states, upd = {}, {}, {}
        for name in sorted(self.impls):
            impl = self.impls[name]
            p = {n: v.to(dtype) for n, v in
                 impl.init_params(gen, self.device).items()}
            self.params[name] = p
            self.states[name] = impl.init_state(self.device)
            ucfg = self._specs[name][2]
            upd[name] = {n: init_updater_state(ucfg, v) for n, v in p.items()}
        self.opt_state = {"step": 0, "updater": upd}
        # fresh parameters: every signature dispatches anew
        self.__dict__.pop("_dispatch_sigs", None)
        self.__dict__.pop("_scan_sigs", None)
        self._pretrained = False
        return self

    def set_listeners(self, *listeners) -> None:
        """Callables ``(graph, iteration, score)``, called for every
        training step with the step's number (from 1) and score; the
        scores are fetched in batches (``optimize/deferred.py``), so the
        calls arrive when a listener's frequency or the end of ``fit``
        asks."""
        self.listeners = list(listeners)

    def cast_params(self, params: Params) -> Params:
        """The compute-dtype copy of ``params`` (a no-op under f32)."""
        return cast_floats(params, self._cd) if self._cd is not None else params

    # -------------------------------------------------------- functional core

    def _forward_all(self, params: Params, states: Dict[str, Any],
                     inputs: Tensors, train: bool, rng: Optional[int],
                     fmasks: Tensors):
        """(every vertex's activation, its mask, the layers' new states)."""
        acts: Tensors = {}
        masks: Dict[str, Optional[torch.Tensor]] = {}
        new_states = dict(states)
        for vi, name in enumerate(self.order):
            v = self.defs[name]
            if v.kind == "input":
                x_in = inputs[name]
                if self._cd is not None and self._input_casts.get(name, True):
                    x_in = x_in.to(self._cd)
                acts[name], masks[name] = x_in, fmasks.get(name)
            elif v.kind == "layer":
                impl = self.impls[name]
                x, m, p = acts[v.inputs[0]], masks[v.inputs[0]], params[name]
                if self._cd is not None:
                    if impl.has_loss() and "W" not in p:
                        x = x.float()  # matmul-free heads: the loss in f32
                    else:
                        p = cast_floats(p, self._cd)
                lrng = fold_in(rng, vi) if rng is not None else None
                out, ns = impl.forward(p, x, states[name], train, lrng, mask=m)
                acts[name] = out
                new_states[name] = cast_like(ns, states[name])
                # recurrent outputs keep the mask; pooling over time ends it
                masks[name] = m if out.ndim == 3 else None
            else:
                ins = [acts[i] for i in v.inputs]
                ms = [masks[i] for i in v.inputs]
                acts[name] = v.vertex.forward(ins, ms)
                masks[name] = ms[0] if acts[name].ndim == 3 else None
        return acts, masks, new_states

    def _score_fn(self, params: Params, states: Dict[str, Any], inputs: Tensors,
                  labels: Tensors, train: bool, rng: Optional[int],
                  fmasks: Tensors, lmasks: Tensors
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """(the loss outputs' losses summed, plus the L1/L2 penalties and
        any ``__aux_loss__``; the layers' new states)."""
        acts, _, new_states = self._forward_all(params, states, inputs, train,
                                                rng, fmasks)
        score = None
        for vi, name in enumerate(self.loss_outputs):
            impl = self.impls[name]
            x, p_head = acts[self.defs[name].inputs[0]], params[name]
            if self._cd is not None:
                if "W" in p_head:  # compute-dtype head product, f32 logits
                    p_head = cast_floats(p_head, self._cd)
                else:
                    x = x.float()
            lrng = fold_in(rng, 10_000 + vi) if rng is not None else None
            s = impl.score(p_head, x, labels[name], states[name], train, lrng,
                           mask=lmasks.get(name) if lmasks else None)
            score = s if score is None else score + s
        for name, impl in self.impls.items():
            score = score + impl.regularization_penalty(params[name]).to(score.dtype)
        return add_aux_losses(score, new_states), new_states

    def _train_step(self, inputs: Tensors, labels: Tensors, fmasks: Tensors,
                    lmasks: Tensors) -> torch.Tensor:
        """One optimization step; returns the step's score (a device
        scalar, fetched only when asked for)."""
        it = self.opt_state["step"]
        rng = fold_in(self._train_key, it)
        score, grads, new_states = MultiLayerNetwork._grads(
            self.params, lambda p: self._score_fn(
                p, self.states, inputs, labels, True, rng, fmasks, lmasks))
        self.params, new_upd = apply_updates(
            self.params, grads, self.opt_state["updater"], self._specs, it)
        self.states = new_states
        self.opt_state = {"step": it + 1, "updater": new_upd}
        return score

    # ----------------------------------------------------------------- train

    def _tensor(self, a) -> Optional[torch.Tensor]:
        """An array (or tensor) on the net's device in the parameters'
        dtype."""
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=self._dtype)
        return torch.as_tensor(np.asarray(a), dtype=self._dtype,
                               device=self.device)

    @staticmethod
    def _to_mds(data) -> MultiDataSet:
        if isinstance(data, DataSet):
            return MultiDataSet(
                features=[data.features], labels=[data.labels],
                features_masks=([data.features_mask]
                                if data.features_mask is not None else None),
                labels_masks=([data.labels_mask]
                              if data.labels_mask is not None else None))
        return data

    def _tensors(self, mds: MultiDataSet):
        """(inputs, labels, features masks, labels masks) as tensors:
        features in ``add_inputs`` order, labels and their masks in
        ``set_outputs`` order (the loss outputs picked by name)."""
        inputs = {n: self._tensor(f) for n, f in zip(self.input_names, mds.features)}
        by_output = dict(zip(self.output_names, mds.labels))
        labels = {n: self._tensor(by_output[n]) for n in self.loss_outputs}
        fmasks = {n: self._tensor(m) for n, m in
                  zip(self.input_names, mds.features_masks or []) if m is not None}
        lmasks = {n: self._tensor(m) for n, m in
                  zip(self.output_names, mds.labels_masks or [])
                  if m is not None and n in self.loss_outputs}
        return inputs, labels, fmasks, lmasks

    def _pad_tail_safe(self) -> bool:
        """Tail padding is exact only where no layer takes statistics
        over the batch (``ShapeBucketingIterator``)."""
        return not any(getattr(i, "batch_statistics", False)
                       for i in self.impls.values())

    def _stage_mds(self, b) -> MultiDataSet:
        """The feed's placement, on ``DeviceFeedIterator``'s thread: the
        batch as a MultiDataSet with every array on the net's device in
        the parameters' dtype (``datasets/staging.py``)."""
        return stager_of(self).stage_mds(self._to_mds(b))

    def fit(self, data, epochs: int = 1, batch_size: Optional[int] = None,
            feed_pipeline: Optional[bool] = None) -> None:
        """Train on a DataSet or MultiDataSet (one minibatch, staged on
        the device once, or minibatches of ``batch_size``) or an
        iterator (or other iterable) of them, ``epochs`` times;
        ``conf.iterations`` steps per minibatch. An iterator goes through
        the feed pipeline as in ``MultiLayerNetwork.fit``, unless
        ``feed_pipeline=False``, which also fetches every step's score
        at once."""
        refuse_quantized(self)
        if self.params is None:
            self.init()
        pipeline = feed_pipeline_enabled(feed_pipeline)
        prev_defer, self._defer_scores = self._defer_scores, pipeline
        threads = []
        try:
            if self.conf.pretrain and not self._pretrained:
                self.pretrain(data, batch_size=batch_size)
                self._pretrained = True
            if isinstance(data, (DataSet, MultiDataSet)):
                mds = self._to_mds(data)
                if batch_size is None:
                    mds = self._device_mds(mds)
                    for _ in range(epochs):
                        self._fit_batch(mds)
                    return
                data = ListMultiDataSetIterator(mds, batch_size)
            it, threads = wrap_feed(data, pipeline, self._pad_tail_safe(),
                                    self._stage_mds)
            for _ in range(epochs):
                for mds in it:
                    self._fit_batch(self._to_mds(mds))
        finally:
            for stage in reversed(threads):
                stage.close()
            score_sink(self).flush()
            self._defer_scores = prev_defer

    def pretrain(self, data, epochs: int = 1,
                 batch_size: Optional[int] = None) -> Dict[str, float]:
        """Layer-wise greedy pretraining over the DAG: each RBM and
        AutoEncoder layer vertex, in topological order, trains on the
        frozen activations of its input (the whole graph's inference
        forward, taken to f32), over ``data`` (a DataSet or MultiDataSet
        in minibatches of ``batch_size``, 32 by default, or an iterable of
        them) for ``epochs`` passes, with its own updater state; its
        draws come from the stream ``seed + 104729 * (vi + 1)`` (``vi``
        the vertex's topological index) folded with the iteration.
        Returns each trained layer's last loss."""
        if self.params is None:
            self.init()
        if isinstance(data, (DataSet, MultiDataSet)):
            data = ListMultiDataSetIterator(self._to_mds(data), batch_size or 32)
        losses: Dict[str, float] = {}
        for vi, name in enumerate(self.order):
            v = self.defs[name]
            if v.kind != "layer" or not hasattr(self.impls[name], "pretrain_loss"):
                continue
            impl, ucfg = self.impls[name], self._specs[name][2]
            ustate = {n: init_updater_state(ucfg, t)
                      for n, t in self.params[name].items()}
            key = int(self.gc.seed) + 104729 * (vi + 1)
            it, loss = 0, float("nan")
            for _ in range(max(1, epochs)):
                for mds in data:
                    mds = self._to_mds(mds)
                    inputs = {n: self._tensor(f)
                              for n, f in zip(self.input_names, mds.features)}
                    with torch.no_grad():
                        acts, _, _ = self._forward_all(
                            self.params, self.states, inputs, False, None, {})
                    new_p, ustate, loss = pretrain_update(
                        impl, self.params[name], ustate, it,
                        acts[v.inputs[0]].float(), fold_in(key, it), ucfg)
                    self.params = {**self.params, name: new_p}
                    it += 1
            losses[name] = float(loss)
        return losses

    def _device_mds(self, mds: MultiDataSet) -> MultiDataSet:
        devs = lambda arrs: None if arrs is None else [  # noqa: E731
            self._tensor(a) for a in arrs]
        return MultiDataSet(devs(mds.features), devs(mds.labels),
                            devs(mds.features_masks), devs(mds.labels_masks))

    def _fit_batch(self, mds: MultiDataSet) -> None:
        if (self.conf.backprop_type == BackpropType.TRUNCATED_BPTT
                and any(f.ndim == 3 and f.shape[1] > self.conf.tbptt_fwd_length
                        for f in mds.features)):
            self._fit_tbptt(mds)
            return
        with span("data_load", path="graph_fit"):
            # a staged batch's tensors pass as they are
            inputs, labels, fmasks, lmasks = self._tensors(mds)
        sig = lambda d, dt=False: tuple(sorted(  # noqa: E731
            (n, tuple(a.shape)) + ((str(a.dtype),) if dt else ())
            for n, a in d.items()))
        compiling = note_dispatch(self, ("train", None, sig(inputs, True),
                                         sig(labels), sig(fmasks),
                                         sig(lmasks)))
        sink = score_sink(self)
        for _ in range(max(1, self.gc.iterations)):
            with span("compile" if compiling else "device_step"):
                score = self._train_step(inputs, labels, fmasks, lmasks)
            compiling = False
            sink.push(self.opt_state["step"], score)  # fetched in batches
            if not self._defer_scores:
                sink.flush()

    # ----------------------------------------------------------- tbptt

    def _recurrent_names(self) -> List[str]:
        from deeplearning4j_tpu_torch.nn.layers.recurrent import GravesLSTMImpl
        return [n for n, impl in self.impls.items()
                if isinstance(impl, GravesLSTMImpl)]

    def _zero_carries(self, names: List[str], b: int) -> Dict[str, Any]:
        out = {}
        for name in names:
            zeros = torch.zeros(b, self.impls[name].conf.n_out,
                                dtype=self._dtype, device=self.device)
            out[name] = {"h": zeros, "c": zeros.clone()}
        return out

    def _fit_tbptt(self, mds: MultiDataSet) -> None:
        """Truncated BPTT over the DAG: every 3-D features and labels
        tensor is cut into ``tbptt_fwd_length`` chunks (2-D ones are fed
        whole to each chunk), one step each; the LSTM carries cross the
        chunks as state and the stored states come back after."""
        rec = self._recurrent_names()
        if not rec:
            raise ValueError("TBPTT configured but no recurrent layers present")
        T = max(f.shape[1] for f in mds.features if f.ndim == 3)
        Lc = self.conf.tbptt_fwd_length
        if not any(lab.ndim == 3 for lab in mds.labels):
            raise ValueError(
                "TBPTT requires at least one per-timestep label [batch, T, "
                f"nOut]; got shapes {[tuple(lab.shape) for lab in mds.labels]}")
        saved = {name: self.states[name] for name in rec}
        self.states.update(self._zero_carries(rec, mds.features[0].shape[0]))

        def tslice(arrs, sl):
            if arrs is None:
                return None
            return [None if a is None else (a[:, sl] if a.ndim >= 2 else a)
                    for a in arrs]

        try:
            for t0 in range(0, T, Lc):
                sl = slice(t0, t0 + Lc)
                self._fit_batch(MultiDataSet(
                    [f[:, sl] if f.ndim == 3 else f for f in mds.features],
                    [y[:, sl] if y.ndim == 3 else y for y in mds.labels],
                    tslice(mds.features_masks, sl), tslice(mds.labels_masks, sl)))
        finally:
            self.states.update(saved)

    # ------------------------------------------------------ scanned fit

    def stage_scan(self, data: Union[DataSet, MultiDataSet], batch_size: int
                   ) -> Tuple[Tensors, Tensors]:
        """The dataset on the net's device, once, as scan-ready minibatch
        stacks [steps, batch, ...]: ({input: features}, {loss output:
        labels}), for ``fit_scan(staged=...)``. Masked data raises; a
        tail that fills no minibatch is dropped with a warning."""
        mds = self._to_mds(data)
        if any(m is not None for m in (mds.features_masks or [])) or \
                any(m is not None for m in (mds.labels_masks or [])):
            raise ValueError("fit_scan does not support masked data; use fit()")
        by_output = dict(zip(self.output_names, mds.labels))
        arrays = {("x", n): f for n, f in zip(self.input_names, mds.features)}
        arrays.update({("y", n): by_output[n] for n in self.loss_outputs})
        n = (int(mds.features[0].shape[0]) // batch_size) * batch_size
        with span("data_load", path="stage_scan", examples=n):
            staged = stage_arrays(arrays, batch_size, self._dtype, self.device)
        return ({n: t for (k, n), t in staged.items() if k == "x"},
                {n: t for (k, n), t in staged.items() if k == "y"})

    def fit_scan(self, data: Optional[Union[DataSet, MultiDataSet]],
                 batch_size: int, epochs: int = 1, staged=None) -> np.ndarray:
        """``epochs`` passes over the staged minibatches (``staged``, or
        ``stage_scan(data, batch_size)``), ``conf.iterations`` steps each;
        listeners are not called. Each minibatch's last score lands in
        one preallocated device tensor, fetched once at the end. Returns
        the scores [epochs * steps]; ``score()`` is the last."""
        if self.params is None:
            self.init()
        xb, yb = staged if staged is not None else self.stage_scan(data, batch_size)
        steps = next(iter(xb.values())).shape[0]
        iters = max(1, self.gc.iterations)
        scores = torch.empty(epochs * steps, device=self.device,
                             dtype=torch.promote_types(self._dtype, torch.float32))
        with span("compile" if scan_dispatch(self, epochs) else "device_step",
                  path="graph_fit_scan", epochs=epochs):
            for e in range(epochs):
                for s in range(steps):
                    xs = {n: t[s] for n, t in xb.items()}
                    ys = {n: t[s] for n, t in yb.items()}
                    for _ in range(iters):
                        score = self._train_step(xs, ys, {}, {})
                    scores[e * steps + s] = score
            out = scores.cpu().numpy()
        self._score = float(out[-1])
        return out

    # ------------------------------------------------------- streaming rnn

    # one timestep through a layer chain (the recurrent generator's path)
    _rnn_step = MultiLayerNetwork._rnn_step

    def _init_rnn_state(self, b: int) -> Dict[str, Any]:
        return self._zero_carries(self._recurrent_names(), b)

    @torch.no_grad()
    def _rnn_one_step(self, params: Params, rstate: Dict[str, Any],
                      inputs: Tensors):
        """One timestep through the DAG: recurrent vertices advance their
        carries, the other layers run their inference forward. Returns
        (the outputs in ``set_outputs`` order, the new carries)."""
        acts: Tensors = {}
        new_rstate = dict(rstate)
        for name in self.order:
            v = self.defs[name]
            if v.kind == "input":
                acts[name] = inputs[name]
            elif v.kind == "layer":
                impl, x = self.impls[name], acts[v.inputs[0]]
                if hasattr(impl, "rnn_time_step"):
                    x, new_rstate[name] = impl.rnn_time_step(params[name], x,
                                                             rstate[name])
                else:
                    x, _ = impl.forward(params[name], x, self.states[name],
                                        False, None)
                acts[name] = x
            else:
                ins = [acts[i] for i in v.inputs]
                acts[name] = v.vertex.forward(ins, [None] * len(ins))
        return [acts[n] for n in self.output_names], new_rstate

    def rnn_time_step(self, *features) -> List[np.ndarray]:
        """Stateful streaming inference: one timestep [b, f] per input,
        or [b, t, f] bursts run step by step (2-D inputs then fed whole
        at every step); the LSTM carries persist across calls until
        :meth:`rnn_clear_previous_state`. Runs on the f32 parameters."""
        xs = [np.asarray(f) for f in features]
        bursts = [x.ndim == 3 for x in xs]
        lengths = {x.shape[1] for x, b3 in zip(xs, bursts) if b3}
        if len(lengths) > 1:
            raise ValueError(
                f"rnn_time_step burst inputs disagree on length: {sorted(lengths)}")
        if not self._rnn_state:
            self._rnn_state = self._init_rnn_state(xs[0].shape[0])
        ts = {n: self._tensor(x) for n, x in zip(self.input_names, xs)}
        if not any(bursts):
            outs, self._rnn_state = self._rnn_one_step(self.params,
                                                       self._rnn_state, ts)
            return [_numpy(o) for o in outs]
        steps = []
        for s in range(lengths.pop()):
            step_in = {n: (t[:, s] if b3 else t)
                       for (n, t), b3 in zip(ts.items(), bursts)}
            outs, self._rnn_state = self._rnn_one_step(self.params,
                                                       self._rnn_state, step_in)
            steps.append(outs)
        return [_numpy(torch.stack([o[i] for o in steps], dim=1))
                for i in range(len(self.output_names))]

    def rnn_clear_previous_state(self) -> None:
        self._rnn_state = {}

    def generate(self, prompt_ids, max_new_tokens: int, **kwargs) -> np.ndarray:
        """Autoregressive generation over a single-input linear layer
        chain (``nn/generate.py``, the MultiLayerNetwork's contract).
        Knobs: ``temperature`` / ``top_k`` / ``top_p`` / ``eos_token`` /
        ``seed``."""
        from deeplearning4j_tpu_torch.nn.generate import generate
        return generate(self, prompt_ids, max_new_tokens, **kwargs)

    # ------------------------------------------------------------- inference

    @torch.no_grad()
    def outputs(self, *features, features_masks: Optional[Dict[str, Any]] = None
                ) -> List[np.ndarray]:
        """The activations of every graph output, in ``set_outputs``
        order, in eval mode."""
        inputs = {n: self._tensor(f) for n, f in zip(self.input_names, features)}
        fmasks = {k: self._tensor(v) for k, v in (features_masks or {}).items()}
        acts, _, _ = self._forward_all(self.params, self.states, inputs, False,
                                       None, fmasks)
        return [_numpy(acts[n]) for n in self.output_names]

    def output(self, *features) -> np.ndarray:
        return self.outputs(*features)[0]

    def infer_output_fn(self):
        """The serving engine's batched output program for a
        single-input, single-output graph (``MultiLayerNetwork.
        infer_output_fn``'s contract): a pure ``(params, states, x,
        fmask) -> predictions``."""
        if len(self.input_names) != 1 or len(self.output_names) != 1:
            raise ValueError(
                "ParallelInference serves single-input/single-output "
                f"graphs; this one has inputs {self.input_names} and "
                f"outputs {self.output_names}: serve per output with "
                "outputs() directly")
        return self._infer_output

    @torch.no_grad()
    def _infer_output(self, params: Params, states: Dict[str, Any],
                      x: torch.Tensor, fmask: Optional[torch.Tensor]
                      ) -> torch.Tensor:
        inp = self.input_names[0]
        fmasks = {} if fmask is None else {inp: fmask}
        acts, _, _ = self._forward_all(params, states, {inp: x}, False,
                                       None, fmasks)
        return acts[self.output_names[0]]

    def score(self, data=None) -> float:
        """Loss on ``data`` in eval mode, or the last training step's."""
        if data is None:
            return float(self._score)
        inputs, labels, fmasks, lmasks = self._tensors(self._to_mds(data))
        with span("eval", path="graph_score"), torch.no_grad():
            return float(self._score_fn(self.params, self.states, inputs, labels,
                                        False, None, fmasks, lmasks)[0])

    def gradient_and_score(self, data) -> Tuple[Params, float]:
        """Gradients and score in eval mode (no dropout)."""
        inputs, labels, fmasks, lmasks = self._tensors(self._to_mds(data))
        score, grads, _ = MultiLayerNetwork._grads(
            self.params, lambda p: self._score_fn(
                p, self.states, inputs, labels, False, None, fmasks, lmasks))
        return grads, float(score)

    # ----------------------------------------------------- flat param views

    _flat_order = MultiLayerNetwork._flat_order
    params_flat = MultiLayerNetwork.params_flat
    set_params_flat = MultiLayerNetwork.set_params_flat
    num_params = MultiLayerNetwork.num_params
