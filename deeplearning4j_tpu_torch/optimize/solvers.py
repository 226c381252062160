"""The classic full-batch optimizers: line gradient descent, conjugate
gradient and L-BFGS with a backtracking line search.

Counterpart of ``deeplearning4j_tpu/optimize/solvers.py``. SGD is the
containers' own ``fit``; these methods drive a loss-and-gradient oracle
over the flat parameter vector from a host loop, since a line search's
control flow depends on the values it reads. The oracle
(``_FlatOracle``) is ``torch.autograd`` over the flat vector, in the
reference's ``ravel_pytree`` order (``_flat_order``), in float64 on the
CPU and float32 on the card, as the reference runs float64 where JAX
has it and float32 on the TPU. The host loop keeps the vector as a
numpy array of that dtype. On the card a recurrent net's oracle runs
the LSTM kernels: the gradient calls the training scan (``lstm_fwd``,
``lstm_bwd``, ``lstm_dw``), the loss-only calls the forward-only one.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


class BackTrackLineSearch:
    """Armijo backtracking along a search direction, on a scalar loss."""

    def __init__(self, max_iterations: int = 5, c1: float = 1e-4,
                 shrink: float = 0.5, initial_step: float = 1.0):
        self.max_iterations = max_iterations
        self.c1 = c1
        self.shrink = shrink
        self.initial_step = initial_step

    def optimize(self, loss_fn, x: np.ndarray, direction: np.ndarray,
                 f0: float, g0: np.ndarray) -> Tuple[float, float, np.ndarray]:
        """Returns (step, f_new, direction_used): callers step along the
        returned direction, which is -g0 where the given one was not a
        descent direction."""
        slope = float(np.dot(g0, direction))
        if slope >= 0:  # not a descent direction: take -grad
            direction = -g0
            slope = float(np.dot(g0, direction))
        step = self.initial_step
        for i in range(self.max_iterations):
            f_new = float(loss_fn(x + step * direction))
            if np.isfinite(f_new) and f_new <= f0 + self.c1 * step * slope:
                return step, f_new, direction
            if i < self.max_iterations - 1:
                step *= self.shrink
        # Armijo never held: (step, f_new) are the last pair evaluated; if
        # even that loss was not finite, no movement at the starting loss
        if not np.isfinite(f_new):
            return 0.0, f0, direction
        return step, f_new, direction


class _FlatOracle:
    """Loss, and loss with its gradient, of a model on one batch as
    functions of the flat parameter vector (numpy in, host values out)."""

    def __init__(self, model, ds):
        self.model = model
        dev = model.device
        self.dtype = torch.float64 if dev.type == "cpu" else torch.float32
        self.layout = [(l, n, tuple(model.params[l][n].shape))
                       for l, n in model._flat_order()]
        self.flat0 = torch.cat([model.params[l][n].reshape(-1).to(self.dtype)
                                for l, n, _ in self.layout]).cpu().numpy()
        cast = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
            np.asarray(a), dtype=self.dtype, device=dev)
        self._batch = (cast(ds.features), cast(ds.labels),
                       cast(ds.features_mask), cast(ds.labels_mask))

    def unravel(self, v: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        at = 0
        for l, n, shape in self.layout:
            size = int(np.prod(shape))
            out.setdefault(l, {})[n] = v[at:at + size].reshape(shape)
            at += size
        return out

    def _vector(self, flat: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(flat), dtype=self.dtype,
                               device=self.model.device)

    def _loss(self, v: torch.Tensor) -> torch.Tensor:
        x, y, fm, lm = self._batch
        m = self.model
        return m._score_fn(self.unravel(v), m.states, x, y, False, None,
                           fm, lm)[0]

    def loss(self, flat: np.ndarray) -> float:
        with torch.no_grad():
            return float(self._loss(self._vector(flat)))

    def value_and_grad(self, flat: np.ndarray) -> Tuple[float, np.ndarray]:
        v = self._vector(flat).requires_grad_()
        with torch.enable_grad():
            f = self._loss(v)
            (g,) = torch.autograd.grad(f, v)
        return float(f.detach()), g.cpu().numpy()

    def set_back(self, model, flat: np.ndarray) -> None:
        new = self.unravel(self._vector(flat))
        model.params = {l: {n: new[l][n].to(t.dtype).clone() for n, t in p.items()}
                        for l, p in model.params.items()}


class TerminationConditions:
    """Convergence tests between solver iterations: the relative change
    of the loss (``EpsTermination``), a floor on the gradient's norm
    (``Norm2Termination``) and a zero direction."""

    def __init__(self, eps: float = 1e-4, tolerance: float = 1e-5,
                 grad_norm_min: float = 1e-8):
        self.eps = eps
        self.tolerance = tolerance
        self.grad_norm_min = grad_norm_min

    def eps_terminate(self, cost: float, old: float) -> bool:
        if cost == 0.0 and old == 0.0:
            return False
        return 2.0 * abs(old - cost) <= self.tolerance * (
            abs(old) + abs(cost) + self.eps)

    def terminate(self, cost: float, old: float,
                  direction: np.ndarray) -> bool:
        if self.eps_terminate(cost, old):
            return True
        n2 = float(np.linalg.norm(direction))
        return n2 < self.grad_norm_min or n2 == 0.0


def line_gradient_descent(oracle: _FlatOracle, iterations: int,
                          terminations: Optional[TerminationConditions] = None
                          ) -> Tuple[np.ndarray, float]:
    """Steepest descent with the line search."""
    term = terminations or TerminationConditions()
    x = oracle.flat0
    ls = BackTrackLineSearch()
    f = oracle.loss(x)
    for _ in range(iterations):
        old = f
        f, g = oracle.value_and_grad(x)
        step, f, d = ls.optimize(oracle.loss, x, -g, f, g)
        x = x + step * d
        if term.terminate(f, old, d):
            break
    return x, f


def conjugate_gradient(oracle: _FlatOracle, iterations: int,
                       terminations: Optional[TerminationConditions] = None
                       ) -> Tuple[np.ndarray, float]:
    """Polak-Ribière conjugate gradient with automatic restart."""
    term = terminations or TerminationConditions()
    x = oracle.flat0
    ls = BackTrackLineSearch()
    f, g = oracle.value_and_grad(x)
    d = -g
    for _ in range(iterations):
        old = f
        step, f, d = ls.optimize(oracle.loss, x, d, f, g)
        x = x + step * d
        f, g_new = oracle.value_and_grad(x)
        beta = max(0.0, float(np.dot(g_new, g_new - g) / max(np.dot(g, g), 1e-30)))
        d = -g_new + beta * d
        g = g_new
        if term.terminate(f, old, -g):  # the gradient's norm, not the
            break                       # momentum-blended direction's
    return x, f


def lbfgs(oracle: _FlatOracle, iterations: int, memory: int = 10,
          terminations: Optional[TerminationConditions] = None
          ) -> Tuple[np.ndarray, float]:
    """Limited-memory BFGS (the two-loop recursion)."""
    term = terminations or TerminationConditions()
    x = oracle.flat0
    ls = BackTrackLineSearch()
    f, g = oracle.value_and_grad(x)
    s_hist, y_hist = [], []
    for _ in range(iterations):
        old = f
        q = g.copy()
        alphas = []
        for s, y in reversed(list(zip(s_hist, y_hist))):
            rho = 1.0 / max(float(np.dot(y, s)), 1e-30)
            a = rho * float(np.dot(s, q))
            alphas.append((a, rho, s, y))
            q -= a * y
        if y_hist:
            s, y = s_hist[-1], y_hist[-1]
            q *= float(np.dot(s, y)) / max(float(np.dot(y, y)), 1e-30)
        for a, rho, s, y in reversed(alphas):
            b = rho * float(np.dot(y, q))
            q += (a - b) * s
        d = -q
        step, f, d = ls.optimize(oracle.loss, x, d, f, g)
        x_new = x + step * d
        f_new, g_new = oracle.value_and_grad(x_new)
        s_vec, y_vec = x_new - x, g_new - g
        if float(np.dot(s_vec, y_vec)) > 1e-10:
            s_hist.append(s_vec)
            y_hist.append(y_vec)
            if len(s_hist) > memory:
                s_hist.pop(0)
                y_hist.pop(0)
        x, f, g = x_new, f_new, g_new
        if term.terminate(f, old, -g):
            break
    return x, f


class Solver:
    """Dispatches on ``gc.optimization_algo``: SGD is the container's
    ``fit``; the classic methods run here and set the parameters and the
    score."""

    def __init__(self, model):
        self.model = model

    def optimize(self, ds, iterations: Optional[int] = None,
                 terminations: Optional[TerminationConditions] = None
                 ) -> float:
        from deeplearning4j_tpu_torch.nn.conf.configuration import (
            OptimizationAlgorithm as OA,
        )

        algo = self.model.gc.optimization_algo
        iters = iterations or max(1, self.model.gc.iterations)
        if algo == OA.STOCHASTIC_GRADIENT_DESCENT:
            self.model.fit(ds)
            return self.model.score()
        oracle = _FlatOracle(self.model, ds)
        if algo == OA.LINE_GRADIENT_DESCENT:
            x, f = line_gradient_descent(oracle, iters, terminations)
        elif algo == OA.CONJUGATE_GRADIENT:
            x, f = conjugate_gradient(oracle, iters, terminations)
        elif algo == OA.LBFGS:
            x, f = lbfgs(oracle, iters, terminations=terminations)
        else:
            raise ValueError(f"unknown optimization algorithm {algo}")
        oracle.set_back(self.model, x)
        self.model._score = f
        return f
