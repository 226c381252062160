"""MultiLayerNetwork, the sequential-stack model container.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: construction,
``init`` (parameters and the updater state), the all-layer forward,
``output``, ``generate``, and training: ``fit`` runs, per minibatch,
``conf.iterations`` steps of forward, loss (``_score_fn``: the head's
loss plus the L1/L2 penalties), ``torch.autograd`` backward, per-layer
gradient normalization and the updater, ``params -= update``; ``score``
and ``gradient_and_score`` evaluate without dropout. Truncated BPTT
cuts long sequences into ``tbptt_fwd_length`` chunks with the LSTM
carries crossing them as state; ``rnn_time_step`` streams one timestep
(or a burst, step by step) with the carries kept between calls. The
forward and the score return the layers' new states, cast back to the
stored dtypes. Parameters are a
dict per layer of float32 tensors on the net's device, in the
reference's layout (``params["layer1"]["Wqkv"]``), and so is the updater
state (``opt_state["updater"]["layer1"]["Wqkv"]["m"]``), so both carry
across in both directions. Under a bf16 ``compute_dtype`` the layers
compute on a bf16 copy of the parameters, the head's logits and the loss
stay f32, and the gradients, the updater state and the parameters are
f32. Unlike the reference, which compiles the whole step into one
program, each step runs eagerly.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

import deeplearning4j_tpu_torch.nn.layers  # noqa: F401  (registers impls)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    BackpropType,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers.base import build_layer
from deeplearning4j_tpu_torch.nn.updater import (
    GradientNormalization,
    apply_updater,
    init_updater_state,
    normalize_gradient,
)
from deeplearning4j_tpu_torch.util.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.util.dtypes import (
    cast_floats,
    cast_like,
    resolve_compute_dtype,
)
from deeplearning4j_tpu_torch.util.rng import fold_in

Params = Dict[str, Dict[str, torch.Tensor]]


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration, device: DeviceLike = None):
        """``device`` defaults to ``cuda``; without a card that raises
        unless ``device="cpu"`` is given."""
        if conf.input_preprocessors:
            raise NotImplementedError(
                "input preprocessors are not ported yet")
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
        self._score: Union[float, torch.Tensor] = float("nan")
        # mixed precision: params stay f32, layer compute in
        # gc.compute_dtype, logits in f32 (util/dtypes.py policy)
        self._cd = resolve_compute_dtype(self.gc.compute_dtype)
        self._ucfgs = [self.gc.updater_config_for(impl.conf) for impl in self.impls]
        self._gn_specs = [
            (GradientNormalization(self.gc.resolve(impl.conf, "gradient_normalization")),
             self.gc.resolve(impl.conf, "gradient_normalization_threshold"))
            for impl in self.impls]
        # the fit path's dropout streams: step key = fold_in(this, step)
        self._train_key = int(self.gc.seed) + 7919
        #: rnn_time_step's carries, {layer: {"h", "c"}}; None = no history
        self._rnn_state: Optional[Dict[str, Any]] = None

    def init(self) -> "MultiLayerNetwork":
        """Draw every layer's parameters from one generator seeded with
        the config's seed, and zero the updater state."""
        gen = torch.Generator(device=self.device).manual_seed(int(self.gc.seed))
        self.params = {}
        self.states = {}
        upd = {}
        for impl, ucfg in zip(self.impls, self._ucfgs):
            p = impl.init_params(gen, self.device)
            self.params[impl.name] = p
            self.states[impl.name] = impl.init_state()
            upd[impl.name] = {n: init_updater_state(ucfg, v) for n, v in p.items()}
        self.opt_state = {"step": 0, "updater": upd}
        return self

    def cast_params(self, params: Params) -> Params:
        """The compute-dtype copy of ``params`` (a no-op under f32). The
        output head is cast too: its product accumulates in f32."""
        return cast_floats(params, self._cd) if self._cd is not None else params

    @torch.no_grad()
    def _forward(self, params: Params, states: Dict[str, Any], x: torch.Tensor,
                 fmask: Optional[torch.Tensor] = None
                 ) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
        """All-layer inference forward; returns (every layer's output,
        the layers' new states)."""
        acts, new_states = [], {}
        if self._cd is not None and self.impls[0].cast_input:
            x = x.to(self._cd)
        params = self.cast_params(params)
        for impl in self.impls:
            x, ns = impl.forward(params[impl.name], x, states[impl.name],
                                 False, mask=fmask)
            new_states[impl.name] = cast_like(ns, states[impl.name])
            acts.append(x)
        return acts, new_states

    def output(self, x, train: bool = False,
               features_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Network output for ``x`` (token ids for a GPT stack, [b, t, f]
        features for a recurrent one, with an optional [b, t] features
        mask): the head's activations, f32, as a numpy array."""
        if train:
            raise ValueError("use fit() for training-mode passes")
        xt = torch.as_tensor(np.asarray(x), dtype=torch.float32,
                             device=self.device)
        fm = None if features_mask is None else torch.as_tensor(
            np.asarray(features_mask), dtype=torch.float32, device=self.device)
        acts, _ = self._forward(self.params, self.states, xt, fm)
        return acts[-1].float().cpu().numpy()

    # ------------------------------------------------------------ training

    def _tensor(self, a) -> Optional[torch.Tensor]:
        """A batch array as f32 on the net's device: features and labels
        are float, as in the reference (ids become exact floats and the
        layers take them back to ints)."""
        if a is None:
            return None
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _batch(self, ds: DataSet):
        return (self._tensor(ds.features), self._tensor(ds.labels),
                self._tensor(ds.features_mask), self._tensor(ds.labels_mask))

    def _score_fn(self, params: Params, states: Dict[str, Any],
                  x: torch.Tensor, y: torch.Tensor, train: bool,
                  rng: Optional[int], fmask: Optional[torch.Tensor],
                  lmask: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """(data loss (the output layer's) plus the L1/L2 penalties, the
        layers' new states): the quantity a step minimizes. Layers
        compute on the compute-dtype copy of ``params``; the penalties
        read the f32 parameters."""
        new_states: Dict[str, Any] = {}
        if self._cd is not None and self.impls[0].cast_input:
            x = x.to(self._cd)
        for i, impl in enumerate(self.impls[:-1]):
            p = params[impl.name]
            if self._cd is not None:
                p = cast_floats(p, self._cd)
            lrng = fold_in(rng, i) if rng is not None else None
            x, ns = impl.forward(p, x, states[impl.name], train, lrng,
                                 mask=fmask)
            new_states[impl.name] = cast_like(ns, states[impl.name])
        i_out = len(self.impls) - 1
        p_out = params[self.out.name]
        if self._cd is not None:
            if "W" in p_out:  # bf16 head operands, f32 logits (preout)
                p_out = cast_floats(p_out, self._cd)
            else:
                x = x.float()  # the loss is always f32
        lrng = fold_in(rng, i_out) if rng is not None else None
        score = self.out.score(p_out, x, y, states[self.out.name], train,
                               lrng, mask=lmask)
        new_states[self.out.name] = states[self.out.name]
        for impl in self.impls:
            score = score + impl.regularization_penalty(
                params[impl.name]).to(score.dtype)
        return score, new_states

    def _grads(self, params: Params, loss_fn
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
        new_params: Params = {}
        new_upd: Dict[str, Any] = {}
        for impl, (nt, thr), ucfg in zip(self.impls, self._gn_specs, self._ucfgs):
            name = impl.name
            g = normalize_gradient(nt, grads[name], thr)
            new_params[name], new_upd[name] = {}, {}
            for pname, gval in g.items():
                upd, ust = apply_updater(ucfg, gval,
                                         self.opt_state["updater"][name][pname], it)
                p = self.params[name][pname]
                new_params[name][pname] = p - upd.to(p.dtype)
                new_upd[name][pname] = ust
        self.params = new_params
        self.states = new_states
        self.opt_state = {"step": it + 1, "updater": new_upd}
        return score

    def fit(self, data: Union[DataSet, Iterable[DataSet], np.ndarray],
            labels: Optional[np.ndarray] = None,
            batch_size: Optional[int] = None) -> None:
        """Train on a DataSet (one minibatch, or minibatches of
        ``batch_size``), an iterable of DataSets (``ListDataSetIterator``)
        or features + ``labels`` arrays; ``conf.iterations`` steps per
        minibatch. A short last minibatch is fed as it is."""
        if self.params is None:
            self.init()
        if isinstance(data, np.ndarray):
            data = DataSet(data, labels)
        if self.conf.pretrain:
            self.pretrain(data)
        if isinstance(data, DataSet):
            if batch_size is None:
                self._fit_batch(data)
                return
            data = ListDataSetIterator(data, batch_size)
        for ds in data:
            self._fit_batch(ds)

    def pretrain(self, data, epochs: int = 1,
                 batch_size: Optional[int] = None) -> Dict[str, float]:
        raise NotImplementedError(
            "layer-wise pretraining (RBM, AutoEncoder) is not ported yet: "
            "ROADMAP Queue A2")

    def _fit_batch(self, ds: DataSet) -> None:
        if (self.conf.backprop_type == BackpropType.TRUNCATED_BPTT
                and np.ndim(ds.features) == 3
                and ds.features.shape[1] > self.conf.tbptt_fwd_length):
            self._fit_tbptt(ds)
            return
        x, y, fm, lm = self._batch(ds)
        for _ in range(max(1, self.gc.iterations)):
            self._score = self._train_step(x, y, fm, lm)

    def score(self, ds: Optional[DataSet] = None) -> float:
        """Loss on ``ds`` in eval mode (no dropout), or the last training
        step's score."""
        if ds is None:
            return float(self._score)
        x, y, fm, lm = self._batch(ds)
        with torch.no_grad():
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
        labels = np.asarray(ds.labels)
        # sparse ids must be integers, so that a dense [b, nOut] label
        # matrix with nOut == T is never read as per-timestep ids
        sparse_ids = (labels.ndim == 2 and labels.shape == (b, T)
                      and np.issubdtype(labels.dtype, np.integer))
        if not (labels.ndim == 3 or sparse_ids):
            hint = ""
            if labels.ndim == 2 and labels.shape == (b, T):
                hint = (f" Labels have the [batch, T] shape but float dtype "
                        f"{labels.dtype}; cast to an integer dtype to use "
                        f"the sparse-id path.")
            raise ValueError(
                f"TBPTT requires per-timestep labels [batch, T, nOut] (or "
                f"sparse INT ids [batch, T]); got shape {labels.shape}. "
                f"For sequence-level labels use backprop_type='standard'."
                + hint)
        rec = self._recurrent_impls()
        if not rec:
            raise ValueError("TBPTT configured but no recurrent layers present")
        saved = {}
        for impl in rec:
            saved[impl.name] = self.states[impl.name]
            zeros = torch.zeros(b, impl.conf.n_out, device=self.device)
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
                zeros = torch.zeros(b, impl.conf.n_out, device=self.device)
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
        xt = torch.as_tensor(x, dtype=torch.float32, device=self.device)
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
        return out.float().cpu().numpy()

    def rnn_clear_previous_state(self) -> None:
        self._rnn_state = None

    # ----------------------------------------------------- flat param views

    def _flat_order(self) -> List[Tuple[str, str]]:
        """(layer, param) in the reference's ``ravel_pytree`` order:
        sorted keys at each level, so "layer10" sorts before "layer2"."""
        return [(l, n) for l in sorted(self.params) for n in sorted(self.params[l])]

    def params_flat(self) -> np.ndarray:
        """One flat f32 vector of every parameter."""
        return torch.cat([self.params[l][n].reshape(-1)
                          for l, n in self._flat_order()]).cpu().numpy()

    def set_params_flat(self, vec) -> None:
        flat = torch.as_tensor(np.asarray(vec), dtype=torch.float32,
                               device=self.device)
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

    def generate(self, prompt_ids, max_new_tokens: int, **kwargs) -> np.ndarray:
        """Autoregressive generation (``nn/generate.py``): for a GPT
        stack a bucketed prefill through the flash kernel, then a
        KV-cache decode loop; for a recurrent stack the prompt streamed
        step by step through the LSTM scan, then one step per token.
        Knobs: ``temperature`` / ``top_k`` / ``top_p`` / ``eos_token`` /
        ``seed``. Returns [b, t0 + max_new_tokens] int64 token ids."""
        from deeplearning4j_tpu_torch.nn.generate import generate
        return generate(self, prompt_ids, max_new_tokens, **kwargs)


def _detach(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach() if isinstance(tree, torch.Tensor) else tree
