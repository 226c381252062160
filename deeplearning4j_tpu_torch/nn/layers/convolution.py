"""Convolution and subsampling (pooling) layers.

Counterpart of ``deeplearning4j_tpu/nn/layers/convolution.py``.
Activations are NHWC and ``W`` is HWIO in ``params``, the reference's
layouts, so the zip and the weight carry need no conversion; each call
permutes them to the NCHW view PyTorch's convolution and pooling take
(an NHWC tensor seen as NCHW is channels-last, which cuDNN reads
without a copy) and hands its output back as NHWC.

- ``convolution_mode="same"`` pads as XLA's ``SAME``: ``ceil(in / s)``
  outputs, the odd extra row and column of padding at the end, at any
  stride (``F.conv2d(padding="same")`` takes stride 1 only).
- A float32 convolution computes in full float32: cuDNN's TF32 (on by
  default in PyTorch) is turned off around the forward and backward
  calls only.
- MAX pooling pads with -inf, and its gradient goes to the first
  maximal cell of each window, as XLA's; AVG divides each window by its
  count of real (unpadded) cells; PNORM is ``(sum |x|^p)^(1/p)``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.base import LayerImpl, register_impl
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import activate
from deeplearning4j_tpu_torch.ops.pooling import max_pool_nhwc


@contextlib.contextmanager
def _ieee_f32():
    """cuDNN convolutions in full float32 inside, as before outside."""
    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = prev


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` on NCHW views, forward and backward run with cuDNN's
    float32 convolutions in full float32."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.geom = (stride, padding)
        with _ieee_f32():
            return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding = ctx.geom
        with _ieee_f32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, list(stride), list(padding), [1, 1], False,
                [0, 0], 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                            False])
        return dx, dw, None, None


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA ``SAME`` padding of one spatial dim: (before, after)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d_nhwc(x: torch.Tensor, W: torch.Tensor, stride: Tuple[int, int],
                padding: Tuple[int, int], mode: str) -> torch.Tensor:
    """NHWC x (*) HWIO W -> NHWC, with the reference's padding rules."""
    if mode == "same":
        (t, b), (l, r) = (_same_pads(x.shape[1], W.shape[0], stride[0]),
                          _same_pads(x.shape[2], W.shape[1], stride[1]))
    else:
        (t, b), (l, r) = (padding[0],) * 2, (padding[1],) * 2
    xc = _nchw(x)
    if (t, l) != (b, r):
        xc, t, l = F.pad(xc, (l, r, t, b)), 0, 0
    w = W.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return _nhwc(_Conv2d.apply(xc, w, tuple(stride), (t, l)))


@register_impl(L.ConvolutionLayer)
class ConvolutionImpl(LayerImpl):
    supports_no_bias = True
    applies_drop_connect = True

    def init_params(self, gen, device) -> Dict[str, torch.Tensor]:
        c = self.conf
        kh, kw = c.kernel_size
        # receptive-field fans, as the reference
        W = init_weights(gen, (kh, kw, c.n_in, c.n_out), self.weight_init,
                         c.n_in * kh * kw, c.n_out * kh * kw, c.dist_mean,
                         c.dist_std, dist=c.dist, device=device)
        if not c.has_bias:
            return {"W": W}
        return {"W": W, "b": torch.full((c.n_out,), float(self.bias_init),
                                        device=device)}

    def forward(self, params, x, state, train, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        params = self.maybe_drop_connect(params, train, rng)
        c = self.conf
        z = conv2d_nhwc(x, params["W"].to(x.dtype), c.stride, c.padding,
                        c.convolution_mode)
        if "b" in params:
            z = z + params["b"].to(x.dtype)
        return activate(self.activation, z), state


def _window_sum(x: torch.Tensor, k, s, p) -> torch.Tensor:
    """NHWC sums over windows, the padding at 0."""
    xc = _nchw(x)
    if p[0] or p[1]:
        xc = F.pad(xc, (p[1], p[1], p[0], p[0]))
    return _nhwc(F.avg_pool2d(xc, k, s, divisor_override=1))


@register_impl(L.SubsamplingLayer)
class SubsamplingImpl(LayerImpl):
    """Max / avg / sum / p-norm pooling over NHWC windows."""

    def forward(self, params, x, state, train, rng=None, mask=None):
        c = self.conf
        k, s, p = tuple(c.kernel_size), tuple(c.stride), tuple(c.padding)
        pt = c.pooling_type
        if pt == L.PoolingType.MAX:
            out = max_pool_nhwc(x, k, s, p)
        elif pt == L.PoolingType.SUM:
            out = _window_sum(x, k, s, p)
        elif pt == L.PoolingType.AVG:
            out = _window_sum(x, k, s, p)
            if p[0] or p[1]:
                ones = torch.ones((1,) + tuple(x.shape[1:3]) + (1,),
                                  dtype=x.dtype, device=x.device)
                out = out / _window_sum(ones, k, s, p)
            else:
                out = out / (k[0] * k[1])
        elif pt == L.PoolingType.PNORM:
            q = float(c.pnorm)
            out = _window_sum(torch.abs(x) ** q, k, s, p) ** (1.0 / q)
        else:
            raise ValueError(f"unknown pooling type {pt}")
        return out, state
