"""Max pooling with an equality-mask backward.

Counterpart of ``deeplearning4j_tpu/ops/pooling.py`` ``maxpool2d``: NHWC
max pooling whose gradient goes, for each window, to every input cell
equal to the window's maximum, split evenly by the window's tie count
(so each window passes on exactly its output's gradient). The default
pooling path (``SubsamplingImpl``) does not use it: there, as in the
reference's default, a window's gradient goes to its first maximal cell.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def max_pool_nhwc(x: torch.Tensor, window, strides, pads) -> torch.Tensor:
    """NHWC max over windows, the padding (ph, pw) at -inf; autograd's
    gradient goes to the first maximal cell of each window, as XLA's."""
    (kh, kw), (sh, sw), (ph, pw) = window, strides, pads
    xc = x.permute(0, 3, 1, 2)
    if ph or pw:
        xc = F.pad(xc, (pw, pw, ph, ph), value=float("-inf"))
    return F.max_pool2d(xc, (kh, kw), (sh, sw)).permute(0, 2, 3, 1)


class _MaxPool2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window, strides, pads):
        y = max_pool_nhwc(x, window, strides, pads)
        ctx.save_for_backward(x, y)
        ctx.geom = (window, strides, pads)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        (kh, kw), (sh, sw), (ph, pw) = ctx.geom
        xp = F.pad(x, (0, 0, pw, pw, ph, ph), value=float("-inf"))
        b, H, W, c = xp.shape
        oy, ox = y.shape[1], y.shape[2]
        # every window lies inside the -inf-padded input: oy = (H-kh)//sh + 1
        rows = lambda k: slice(k, k + (oy - 1) * sh + 1, sh)  # noqa: E731
        cols = lambda k: slice(k, k + (ox - 1) * sw + 1, sw)  # noqa: E731
        masks = {}
        cnt = torch.zeros(y.shape, dtype=torch.float32, device=x.device)
        for ki in range(kh):
            for kj in range(kw):
                eq = (xp[:, rows(ki), cols(kj), :] == y).float()
                masks[ki, kj] = eq
                cnt = cnt + eq
        g32 = g.float() / cnt
        dxp = torch.zeros((b, H, W, c), dtype=torch.float32, device=x.device)
        for (ki, kj), eq in masks.items():
            dxp[:, rows(ki), cols(kj), :] += eq * g32
        dx = dxp[:, ph:ph + x.shape[1], pw:pw + x.shape[2], :]
        return dx.to(x.dtype), None, None, None


def maxpool2d(x: torch.Tensor, window: Tuple[int, int],
              strides: Tuple[int, int], pads: Tuple[int, int]) -> torch.Tensor:
    """NHWC max pooling with symmetric spatial padding ``pads`` = (ph,
    pw) and the equality-mask backward."""
    return _MaxPool2d.apply(x, tuple(window), tuple(strides), tuple(pads))
