"""Finite-difference gradient checker: the framework's correctness oracle.

Counterpart of ``deeplearning4j_tpu/nn/gradientcheck.py``
(``check_gradients_fn``, ``check_gradients``, ``check_gradients_graph``):
perturb each parameter,
central-difference the score in float64, compare with autograd's
gradient. The same defaults: ``epsilon`` 1e-4, a relative-error limit of
1e-2 and an absolute floor of 1e-5. The check runs on the net's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class GradCheckResult:
    ok: bool
    max_rel_error: float
    n_checked: int
    n_failed: int
    failures: List[str]


def check_gradients_fn(
    loss_fn: Callable[[torch.Tensor], torch.Tensor],
    flat_params: torch.Tensor,
    epsilon: float = 1e-4,
    max_rel_error: float = 1e-2,
    min_abs_error: float = 1e-5,
    subset: Optional[int] = None,
    seed: int = 0,
) -> GradCheckResult:
    """Check d loss / d params of a scalar loss over a flat vector, in
    float64 on the vector's device. ``subset``: only N indices, chosen by
    numpy ``default_rng(seed)`` (for big nets)."""
    base = flat_params.detach().to(torch.float64)
    leaf = base.clone().requires_grad_()
    with torch.enable_grad():
        analytic = torch.autograd.grad(loss_fn(leaf), leaf)[0].cpu().numpy()
    n = base.shape[0]
    idxs = np.arange(n)
    if subset is not None and subset < n:
        idxs = np.random.default_rng(seed).choice(n, subset, replace=False)

    failures: List[str] = []
    max_rel = 0.0
    with torch.no_grad():
        for i in idxs:
            p_plus = base.clone()
            p_plus[i] += epsilon
            p_minus = base.clone()
            p_minus[i] -= epsilon
            numeric = (float(loss_fn(p_plus)) - float(loss_fn(p_minus))) / (2 * epsilon)
            a = float(analytic[i])
            abs_err = abs(a - numeric)
            denom = max(abs(a), abs(numeric))
            rel = abs_err / denom if denom > 0 else 0.0
            if abs_err > min_abs_error and rel > max_rel:
                max_rel = rel
            if rel > max_rel_error and abs_err > min_abs_error:
                failures.append(f"param[{i}]: analytic={a:.3e} "
                                f"numeric={numeric:.3e} rel={rel:.3e}")
    return GradCheckResult(
        ok=not failures,
        max_rel_error=max_rel,
        n_checked=len(idxs),
        n_failed=len(failures),
        failures=failures[:25],
    )


def check_gradients(model, ds, epsilon: float = 1e-4, max_rel_error: float = 1e-2,
                    min_abs_error: float = 1e-5, subset: Optional[int] = None,
                    train: bool = False) -> GradCheckResult:
    """Gradient-check a MultiLayerNetwork on a DataSet in float64, over
    its parameters in ``params_flat`` order. ``train=True`` checks the
    training graph (BN on the batch's moments) with a fixed dropout key,
    which is valid only without dropout."""
    flat, unflat = _flat64(model)
    dev = flat.device

    def t64(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a), dtype=torch.float64, device=dev)

    x, y = t64(ds.features), t64(ds.labels)
    fmask, lmask = t64(ds.features_mask), t64(ds.labels_mask)
    rng = 0 if train else None

    def loss(v):
        return model._score_fn(unflat(v), model.states, x, y, train, rng,
                               fmask, lmask)[0]

    return check_gradients_fn(loss, flat, epsilon, max_rel_error,
                              min_abs_error, subset)


def check_gradients_graph(graph, mds, epsilon: float = 1e-4,
                          max_rel_error: float = 1e-2, min_abs_error: float = 1e-5,
                          subset: Optional[int] = None,
                          train: bool = False) -> GradCheckResult:
    """Gradient-check a ComputationGraph on a MultiDataSet in float64,
    over its parameters in ``params_flat`` order; ``train`` as in
    :func:`check_gradients`."""
    flat, unflat = _flat64(graph)
    to64 = lambda d: {k: v.to(torch.float64) for k, v in d.items()}  # noqa: E731
    inputs, labels, fmasks, lmasks = (to64(d) for d in graph._tensors(mds))
    rng = 0 if train else None

    def loss(v):
        return graph._score_fn(unflat(v), graph.states, inputs, labels, train,
                               rng, fmasks, lmasks)[0]

    return check_gradients_fn(loss, flat, epsilon, max_rel_error,
                              min_abs_error, subset)


def _flat64(model):
    """(the parameters as one f64 vector in ``params_flat`` order, the
    map from such a vector back to the parameter tree)."""
    order = model._flat_order()
    shapes = [model.params[l][n].shape for l, n in order]
    flat = torch.cat([model.params[l][n].detach().reshape(-1).to(torch.float64)
                      for l, n in order])

    def unflat(v):
        params, at = {l: {} for l in model.params}, 0
        for (l, n), shape in zip(order, shapes):
            size = int(np.prod(shape))
            params[l][n] = v[at:at + size].reshape(shape)
            at += size
        return params

    return flat, unflat
