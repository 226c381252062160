"""Recurrent layers: Graves LSTM (+ bidirectional).

Counterpart of ``deeplearning4j_tpu/nn/layers/recurrent.py``: the
Graves (2013) LSTM with peephole connections, parameters in the
reference's layout (``Wx [nIn, 4n]``, ``Wr [n, 4n]``, ``b [4n]``, the
peepholes ``wci``/``wcf``/``wco [n]``; gate order input, forget, output,
block). The input projection of every timestep is one ``torch.matmul``
(the reference leaves it to XLA); the recurrence goes to the fused scan
(``ops/lstm_kernel.py``: the CUDA kernels on the card, their plain
versions on the CPU) where its gates allow, else to a plain masked scan
in torch ops, the counterpart of the reference's XLA scan. At masked
timesteps that scan holds the carry and zeroes the output.

``rnn_time_step`` streaming state is the (h, c) carry the caller keeps;
in truncated BPTT the carry rides the layer's state between chunks.
"""

from __future__ import annotations

from typing import Dict

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.base import LayerImpl, register_impl
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import activate
from deeplearning4j_tpu_torch.ops.lstm_kernel import (
    fused_lstm_applicable,
    fused_lstm_scan,
    fused_lstm_train_applicable,
)


def _lstm_params(gen, device, n_in, n_out, weight_init, dist_mean, dist_std,
                 forget_bias, dist=None) -> Dict[str, torch.Tensor]:
    Wx = init_weights(gen, (n_in, 4 * n_out), weight_init, n_in, n_out,
                      dist_mean, dist_std, dist=dist, device=device)
    Wr = init_weights(gen, (n_out, 4 * n_out), weight_init, n_out, n_out,
                      dist_mean, dist_std, dist=dist, device=device)
    b = torch.zeros(4 * n_out, device=device)
    b[n_out:2 * n_out] = forget_bias  # the forget gate's bias init
    zeros = lambda: torch.zeros(n_out, device=device)  # noqa: E731
    return {"Wx": Wx, "Wr": Wr, "b": b,
            "wci": zeros(), "wcf": zeros(), "wco": zeros()}


def _lstm_scan(p, x, h0, c0, gate_act: str, block_act: str, mask=None,
               reverse: bool = False, train: bool = True):
    """Run the LSTM over time. x [b, t, f] -> (outputs [b, t, n], (h, c)).

    The fused scan takes the default configuration (``train`` picks the
    training gate); the reverse direction runs it on the time-reversed
    gates. Everything else (masks, other activations, shapes the kernels
    do not take) runs the plain scan below."""
    n = h0.shape[-1]
    # the input projection of every step, laid out time-major [t, b, 4n]
    # as the scan reads it (x is small: no copy of the gates is needed)
    xg_t = torch.matmul(x.transpose(0, 1), p["Wx"]) + p["b"]
    applicable = (fused_lstm_train_applicable if train
                  else fused_lstm_applicable)
    if applicable(x.shape[0], n, gate_act, block_act, mask,
                  itemsize=xg_t.element_size(), device=x.device):
        xg_k = xg_t.flip(0) if reverse else xg_t
        h_seq, (h, c) = fused_lstm_scan(xg_k, p["Wr"], p["wci"], p["wcf"],
                                        p["wco"], h0, c0)
        if reverse:
            h_seq = h_seq.flip(0)
        return h_seq.transpose(0, 1), (h.to(x.dtype), c.to(x.dtype))

    mask_t = None if mask is None else mask.transpose(0, 1)  # [t, b]
    h, c = h0, c0
    outs = [None] * xg_t.shape[0]
    steps = range(xg_t.shape[0])
    for s in (reversed(steps) if reverse else steps):
        g = xg_t[s] + h @ p["Wr"]
        i = activate(gate_act, g[:, :n] + c * p["wci"])
        f = activate(gate_act, g[:, n:2 * n] + c * p["wcf"])
        blk = activate(block_act, g[:, 3 * n:])
        c_new = f * c + i * blk
        o = activate(gate_act, g[:, 2 * n:3 * n] + c_new * p["wco"])
        h_new = o * activate(block_act, c_new)
        if mask_t is not None:
            mm = mask_t[s][:, None].to(h_new.dtype)
            c_new = mm * c_new + (1 - mm) * c
            outs[s] = mm * h_new
            h_new = mm * h_new + (1 - mm) * h
        else:
            outs[s] = h_new
        h, c = h_new, c_new
    return torch.stack(outs, dim=1), (h, c)


@register_impl(L.GravesLSTM)
class GravesLSTMImpl(LayerImpl):
    def init_params(self, gen, device) -> Dict[str, torch.Tensor]:
        c = self.conf
        return _lstm_params(gen, device, c.n_in, c.n_out, self.weight_init,
                            c.dist_mean, c.dist_std, c.forget_gate_bias_init,
                            dist=c.dist)

    def init_state(self):
        return {}

    def forward(self, params, x, state, train, rng=None, mask=None):
        """With an ("h", "c") pair in ``state`` (truncated BPTT) the scan
        starts from it and the final carry is the new state; otherwise
        from zeros, with the state passed through."""
        x = self.maybe_dropout_input(x, train, rng)
        b, n = x.shape[0], self.conf.n_out
        tbptt = isinstance(state, dict) and "h" in state
        if tbptt:
            h0, c0 = state["h"].to(x.dtype), state["c"].to(x.dtype)
        else:
            h0 = c0 = torch.zeros(b, n, dtype=x.dtype, device=x.device)
        out, (h, c) = _lstm_scan(params, x, h0, c0, self.conf.gate_activation,
                                 self.activation, mask, train=train)
        return out, ({"h": h, "c": c} if tbptt else state)

    def rnn_time_step(self, params, x, state):
        """One timestep x [b, f] from the carry in ``state`` (zeros when
        it has none) -> (output [b, n], the new carry)."""
        b, n = x.shape[0], self.conf.n_out
        zeros = torch.zeros(b, n, dtype=x.dtype, device=x.device)
        h, c = state.get("h", zeros), state.get("c", zeros)
        out, (h2, c2) = _lstm_scan(params, x[:, None, :], h, c,
                                   self.conf.gate_activation, self.activation,
                                   train=False)
        return out[:, 0, :], {"h": h2, "c": c2}


@register_impl(L.GravesBidirectionalLSTM)
class GravesBidirectionalLSTMImpl(LayerImpl):
    """Forward and backward LSTMs over the same input, outputs summed;
    parameters ``f_*`` and ``b_*``."""

    def init_params(self, gen, device):
        c = self.conf
        pf, pb = (_lstm_params(gen, device, c.n_in, c.n_out, self.weight_init,
                               c.dist_mean, c.dist_std,
                               c.forget_gate_bias_init, dist=c.dist)
                  for _ in range(2))
        return {**{f"f_{k}": v for k, v in pf.items()},
                **{f"b_{k}": v for k, v in pb.items()}}

    def forward(self, params, x, state, train, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        b, n = x.shape[0], self.conf.n_out
        pf = {k[2:]: v for k, v in params.items() if k.startswith("f_")}
        pb = {k[2:]: v for k, v in params.items() if k.startswith("b_")}
        h0 = c0 = torch.zeros(b, n, dtype=x.dtype, device=x.device)
        out_f, _ = _lstm_scan(pf, x, h0, c0, self.conf.gate_activation,
                              self.activation, mask, train=train)
        out_b, _ = _lstm_scan(pb, x, h0, c0, self.conf.gate_activation,
                              self.activation, mask, reverse=True,
                              train=train)
        return out_f + out_b, state
