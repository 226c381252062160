"""The timing the zoo's training benchmarks share."""

from __future__ import annotations

import time

import numpy as np


def best_of_fit_scan(net, batch: int, epochs: int, staged):
    """One warm-up ``fit_scan`` of ``epochs`` over the staged minibatches,
    then the best of two timed ones (each ends on its scores' fetch, so
    it times the device's work): (the three calls' scores in order, the
    best timed call's seconds)."""
    scores = [net.fit_scan(None, batch, epochs=epochs, staged=staged)]
    dt = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        scores.append(net.fit_scan(None, batch, epochs=epochs, staged=staged))
        dt = min(dt, time.perf_counter() - t0)
    return np.concatenate(scores), dt
