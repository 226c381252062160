"""Feed-forward layer family: Dense, Output/RnnOutput/Loss, Embedding,
AutoEncoder, RBM, Activation, Dropout, GlobalPooling.

Counterpart of ``deeplearning4j_tpu/nn/layers/feedforward.py``. Scoring
takes the fused from-logits loss where the activation and loss allow it
(softmax + mcxent/nll, sigmoid + xent). Dense products and the embedding
gather go through ``qmatmul`` / ``qtake``, so int8/fp8 weights
(``nn/quantize.py``) serve. The AutoEncoder and the RBM carry a visible
bias ``vb`` and the layer-wise pretraining objectives the containers'
``pretrain`` runs: the AutoEncoder's reconstruction loss (autograd) and
the RBM's CD-k gradient (supplied directly). Their Bernoulli draws
(corruption, Gibbs samples) are ``uniform < p`` on uniforms from
``uniform_draw``, the form ``jax.random.bernoulli`` takes.
"""

from __future__ import annotations

from typing import Dict

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.base import (
    LayerImpl,
    apply_dropout,
    register_impl,
)
from deeplearning4j_tpu_torch.nn.quantize import is_quantized, qmatmul, qtake
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import Activation, activate
from deeplearning4j_tpu_torch.ops.losses import LossFunction, compute_loss
from deeplearning4j_tpu_torch.util.rng import fold_in, generator


def _fused_logits_pair(activation: str, loss_function: str) -> bool:
    """True when activation + loss compute through the numerically
    stable fused from-logits path (the same function)."""
    act = Activation(activation)
    lf = LossFunction(loss_function)
    return (act is Activation.SOFTMAX and lf in (
        LossFunction.MCXENT, LossFunction.NEGATIVELOGLIKELIHOOD)) or \
        (act is Activation.SIGMOID and lf is LossFunction.XENT)


def _score(activation: str, loss_function: str, z, labels, mask):
    """Mean-over-examples loss of pre-activations ``z``."""
    if _fused_logits_pair(activation, loss_function):
        return compute_loss(loss_function, labels, z, mask=mask,
                            from_logits=True)
    return compute_loss(loss_function, labels, activate(activation, z),
                        mask=mask)


class BaseDenseImpl(LayerImpl):
    """z = x.W + b, a = act(z)."""

    supports_no_bias = True
    applies_drop_connect = True

    def init_params(self, gen, device) -> Dict[str, torch.Tensor]:
        c = self.conf
        W = init_weights(gen, (c.n_in, c.n_out), self.weight_init, c.n_in,
                         c.n_out, c.dist_mean, c.dist_std, dist=c.dist,
                         device=device)
        if not c.has_bias:
            return {"W": W}
        return {"W": W, "b": torch.full((c.n_out,), float(self.bias_init),
                                        device=device)}

    def preout(self, params, x: torch.Tensor) -> torch.Tensor:
        """In the promoted dtype of x and W, as the reference's matmul;
        a quantized W in x's dtype, the bias added in that dtype."""
        if is_quantized(params, "W"):
            z = qmatmul(x, params, "W")
            return z + params["b"].to(z.dtype) if "b" in params else z
        W = params["W"]
        dt = torch.promote_types(x.dtype, W.dtype)
        z = x.to(dt) @ W.to(dt)
        return z + params["b"] if "b" in params else z

    def forward(self, params, x, state, train, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        params = self.maybe_drop_connect(params, train, rng)
        return activate(self.activation, self.preout(params, x)), state


@register_impl(L.DenseLayer)
class DenseImpl(BaseDenseImpl):
    pass


@register_impl(L.OutputLayer)
class OutputImpl(BaseDenseImpl):
    """Dense + loss head."""

    def has_loss(self) -> bool:
        return True

    def preout(self, params, x: torch.Tensor) -> torch.Tensor:
        """Logits. On half-precision operands the product accumulates in
        f32 and the logits stay f32 (never rounded to bf16 in between):
        both operands are upcast after their half-precision cast, which
        gives the exact products the reference's
        ``preferred_element_type=f32`` matmul sums. Mixed operands (f32
        activations on a bf16 head) compute in the promoted dtype, as the
        reference's matmul does. A quantized head computes in x's dtype
        (``qmatmul``), as the reference's; its callers take the logits to
        f32."""
        W = params["W"]
        if is_quantized(params, "W"):
            z = qmatmul(x, params, "W")
        elif torch.promote_types(x.dtype, W.dtype) in (torch.bfloat16,
                                                       torch.float16):
            z = x.float() @ W.float()
        else:
            dt = torch.promote_types(x.dtype, W.dtype)
            z = x.to(dt) @ W.to(dt)
        return z + params["b"].to(z.dtype) if "b" in params else z

    @property
    def loss_function(self) -> str:
        return self.conf.loss_function

    def score(self, params, x, labels, state, train, rng=None, mask=None):
        """Mean-over-examples data loss of this head (f32 logits)."""
        x = self.maybe_dropout_input(x, train, rng)
        params = self.maybe_drop_connect(params, train, rng)
        return _score(self.activation, self.loss_function,
                      self.preout(params, x), labels, mask)


@register_impl(L.RnnOutputLayer)
class RnnOutputImpl(OutputImpl):
    """Per-timestep head over [b, t, f]; the product broadcasts over t."""


@register_impl(L.LossLayer)
class LossImpl(LayerImpl):
    """A parameterless activation + loss head."""

    def has_loss(self) -> bool:
        return True

    @property
    def loss_function(self) -> str:
        return self.conf.loss_function

    def forward(self, params, x, state, train, rng=None, mask=None):
        return activate(self.activation, x), state

    def score(self, params, x, labels, state, train, rng=None, mask=None):
        return _score(self.activation, self.loss_function, x, labels, mask)


@register_impl(L.EmbeddingLayer)
class EmbeddingImpl(LayerImpl):
    """Index lookup: int ids [b] or [b, 1] -> [b, n_out], plus the bias."""

    cast_input = False  # ids must stay exact (see LayerImpl.cast_input)

    def init_params(self, gen, device):
        c = self.conf
        W = init_weights(gen, (c.n_in, c.n_out), self.weight_init, c.n_in,
                         c.n_out, c.dist_mean, c.dist_std, dist=c.dist,
                         device=device)
        return {"W": W, "b": torch.full((c.n_out,), float(self.bias_init),
                                        device=device)}

    def forward(self, params, x, state, train, rng=None, mask=None):
        idx = x.long()
        if idx.ndim == 2:
            idx = idx[:, 0]
        return activate(self.activation, qtake(params, "W", idx) + params["b"]), state


@register_impl(L.ActivationLayer)
class ActivationImpl(LayerImpl):
    def forward(self, params, x, state, train, rng=None, mask=None):
        return activate(self.activation, x), state


@register_impl(L.DropoutLayer)
class DropoutImpl(LayerImpl):
    def forward(self, params, x, state, train, rng=None, mask=None):
        rate = self.dropout_rate
        if train and rate > 0.0 and rng is not None:
            x = apply_dropout(x, rate, generator(rng, x.device))
        return x, state


@register_impl(L.GlobalPoolingLayer)
class GlobalPoolingImpl(LayerImpl):
    """Pool over time ([b, t, f] -> [b, f], honoring the features mask)
    or space ([b, h, w, c] -> [b, c])."""

    def forward(self, params, x, state, train, rng=None, mask=None):
        pt = self.conf.pooling_type
        if pt == L.PoolingType.PNORM:
            # the reference reads conf.pnorm, which GlobalPoolingLayer
            # does not have (ROADMAP Queue C)
            raise ValueError("GlobalPoolingLayer has no pnorm field: PNORM "
                             "global pooling is unavailable")
        if x.ndim == 3:
            if mask is not None:
                m = mask[:, :, None].to(x.dtype)
                if pt == L.PoolingType.MAX:
                    big_neg = torch.tensor(-1e30, dtype=x.dtype, device=x.device)
                    return torch.amax(torch.where(m > 0, x, big_neg), dim=1), state
                s = torch.sum(x * m, dim=1)
                if pt == L.PoolingType.SUM:
                    return s, state
                return s / torch.clamp(torch.sum(m, dim=1), min=1.0), state
            dims = (1,)
        else:
            dims = (1, 2)
        if pt == L.PoolingType.MAX:
            return torch.amax(x, dim=dims), state
        if pt == L.PoolingType.SUM:
            return torch.sum(x, dim=dims), state
        return torch.mean(x, dim=dims), state


def uniform_draw(key: int, shape, device) -> torch.Tensor:
    """f32 uniforms in [0, 1) of ``shape`` from the stream ``key``: the
    Bernoulli draws of the AutoEncoder's corruption and the RBM's Gibbs
    samples are ``uniform_draw(...) < p``."""
    return torch.rand(tuple(shape), generator=generator(key, device),
                      device=device)


@register_impl(L.AutoEncoder)
class AutoEncoderImpl(BaseDenseImpl):
    """Denoising autoencoder: encode a = act(x W + b), decode
    x' = act(a W^T + vb); the pretraining loss is the reconstruction of
    the uncorrupted input (plus the sparsity term)."""

    def init_params(self, gen, device) -> Dict[str, torch.Tensor]:
        p = super().init_params(gen, device)
        p["vb"] = torch.zeros(self.conf.n_in, device=device)  # visible bias
        return p

    def encode(self, params, x):
        return activate(self.activation, x @ params["W"] + params["b"])

    def decode(self, params, a):
        return activate(self.activation, a @ params["W"].T + params["vb"])

    def forward(self, params, x, state, train, rng=None, mask=None):
        return self.encode(params, x), state

    def pretrain_loss(self, params, x, rng):
        """Reconstruction loss of ``x`` from its corrupted copy: each
        input kept with probability 1 - corruption_level (drawn from the
        stream ``rng``), the rest zeroed."""
        c = self.conf
        corrupted = x
        if c.corruption_level > 0.0 and rng is not None:
            keep = uniform_draw(rng, x.shape, x.device) < 1.0 - c.corruption_level
            corrupted = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
        recon = self.decode(params, self.encode(params, corrupted))
        loss = compute_loss(c.loss_function, x, recon)
        if c.sparsity > 0.0:
            a_mean = self.encode(params, x).mean(dim=0)
            loss = loss + torch.sum((a_mean - c.sparsity) ** 2)
        return loss


@register_impl(L.RBM)
class RBMImpl(BaseDenseImpl):
    """Restricted Boltzmann machine with CD-k pretraining: a Gibbs chain
    of static length k, whose gradient estimate is supplied directly
    (contrastive divergence is not the gradient of a tractable
    objective)."""

    def init_params(self, gen, device) -> Dict[str, torch.Tensor]:
        p = super().init_params(gen, device)
        p["vb"] = torch.zeros(self.conf.n_in, device=device)
        return p

    def _prop_up(self, params, v):
        z = v @ params["W"] + params["b"]
        if self.conf.hidden_unit == L.RBMHiddenUnit.BINARY:
            return torch.sigmoid(z)
        return torch.relu(z)

    def _prop_down(self, params, h):
        z = h @ params["W"].T + params["vb"]
        vu = self.conf.visible_unit
        if vu == L.RBMVisibleUnit.BINARY:
            return torch.sigmoid(z)
        if vu == L.RBMVisibleUnit.SOFTMAX:
            return torch.softmax(z, dim=-1)
        return z  # gaussian / linear: the mean-field identity

    def forward(self, params, x, state, train, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        return activate(self.activation, x @ params["W"] + params["b"]), state

    def cd_gradients(self, params, v0, rng):
        """(the CD-k gradient {"W", "b", "vb"}, the reconstruction error
        of the chain's last visible sample, clipped to [1e-7, 1 - 1e-7]).
        Gibbs step j of binary hidden units samples h from the stream
        ``fold_in(rng, j)``."""
        c = self.conf
        h0 = self._prop_up(params, v0)
        h, v = h0, v0
        for j in range(c.k):
            hs = h
            if c.hidden_unit == L.RBMHiddenUnit.BINARY:
                hs = (uniform_draw(fold_in(rng, j), h.shape, h.device)
                      < h).to(v0.dtype)
            v = self._prop_down(params, hs)
            h = self._prop_up(params, v)
        n = v0.shape[0]
        grads = {"W": -(v0.T @ h0 - v.T @ h) / n,
                 "b": -torch.mean(h0 - h, dim=0),
                 "vb": -torch.mean(v0 - v, dim=0)}
        recon_err = compute_loss(c.loss_function, v0,
                                 torch.clamp(v, 1e-7, 1 - 1e-7))
        return grads, recon_err

    def pretrain_loss(self, params, x, rng):
        # score reporting only: the gradients come from cd_gradients
        return self.cd_gradients(params, x, rng)[1]
