"""MultiLayerNetwork, the sequential-stack model container.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: construction,
``init``, the all-layer forward, ``output`` and ``generate``. Parameters
are a dict per layer of float32 tensors on the net's device, in the
reference's layout (``params["layer1"]["Wqkv"]``), so weights carry
across in both directions. ``fit``, ``score`` and the updaters wait for
later slices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

import deeplearning4j_tpu_torch.nn.layers  # noqa: F401  (registers impls)
from deeplearning4j_tpu_torch.nn.conf.configuration import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import build_layer
from deeplearning4j_tpu_torch.util.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.util.dtypes import cast_floats, resolve_compute_dtype

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
        # mixed precision: params stay f32, layer compute in
        # gc.compute_dtype, logits in f32 (util/dtypes.py policy)
        self._cd = resolve_compute_dtype(self.gc.compute_dtype)

    def init(self) -> "MultiLayerNetwork":
        """Draw every layer's parameters from one generator seeded with
        the config's seed."""
        gen = torch.Generator(device=self.device).manual_seed(int(self.gc.seed))
        self.params = {}
        self.states = {}
        for impl in self.impls:
            self.params[impl.name] = impl.init_params(gen, self.device)
            self.states[impl.name] = impl.init_state()
        return self

    def cast_params(self, params: Params) -> Params:
        """The compute-dtype copy of ``params`` (a no-op under f32). The
        output head is cast too: its product accumulates in f32."""
        return cast_floats(params, self._cd) if self._cd is not None else params

    @torch.no_grad()
    def _forward(self, params: Params, x: torch.Tensor,
                 fmask: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """All-layer inference forward; returns every layer's output."""
        acts = []
        if self._cd is not None and self.impls[0].cast_input:
            x = x.to(self._cd)
        params = self.cast_params(params)
        for impl in self.impls:
            x, _ = impl.forward(params[impl.name], x, self.states[impl.name],
                                False, mask=fmask)
            acts.append(x)
        return acts

    def output(self, x, train: bool = False,
               features_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Network output for ``x`` (token ids for a GPT stack): the
        head's activations, f32, as a numpy array."""
        if train:
            raise ValueError("use fit() for training-mode passes")
        xt = torch.as_tensor(np.asarray(x), dtype=torch.float32,
                             device=self.device)
        fm = None if features_mask is None else torch.as_tensor(
            np.asarray(features_mask), dtype=torch.float32, device=self.device)
        return self._forward(self.params, xt, fm)[-1].float().cpu().numpy()

    def generate(self, prompt_ids, max_new_tokens: int, **kwargs) -> np.ndarray:
        """Autoregressive generation (``nn/generate.py``): bucketed
        prefill through the flash kernel, then a KV-cache decode loop.
        Knobs: ``temperature`` / ``top_k`` / ``top_p`` / ``eos_token`` /
        ``seed``. Returns [b, t0 + max_new_tokens] int64 token ids."""
        from deeplearning4j_tpu_torch.nn.generate import generate
        return generate(self, prompt_ids, max_new_tokens, **kwargs)
