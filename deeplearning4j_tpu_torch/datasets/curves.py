"""Curves: rasterized quadratic Bezier curves.

Counterpart of ``deeplearning4j_tpu/datasets/curves.py``: 28 x 28 images
of smooth curves, the deep autoencoder and DBN benchmark, generated
from seeded random control points (the reference's arrays from the same
seed) and rasterized by dense sampling with a soft one-pixel halo.
Labels are the six control-point coordinates (a regression target).
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet

SIDE = 28


def _raster_bezier(p0, p1, p2, side: int = SIDE) -> np.ndarray:
    """The Bezier through control points in [0, 1]^2 as a [side, side]
    image in [0, 1]."""
    t = np.linspace(0.0, 1.0, 4 * side)[:, None]
    pts = ((1 - t) ** 2) * p0 + 2 * (1 - t) * t * p1 + (t ** 2) * p2
    img = np.zeros((side, side), np.float32)
    xy = np.clip((pts * (side - 1)).round().astype(int), 0, side - 1)
    img[xy[:, 1], xy[:, 0]] = 1.0
    halo = np.zeros_like(img)
    halo[1:, :] += img[:-1, :] * 0.4
    halo[:-1, :] += img[1:, :] * 0.4
    halo[:, 1:] += img[:, :-1] * 0.4
    halo[:, :-1] += img[:, 1:] * 0.4
    return np.clip(img + halo, 0.0, 1.0)


def load_curves(num_examples: int = 10000, seed: int = 123,
                flat: bool = True) -> DataSet:
    """[n, 784] (or [n, 28, 28, 1]) curve images; labels the six
    control-point coordinates in [0, 1]."""
    rng = np.random.default_rng(seed)
    ctrl = rng.random((num_examples, 3, 2)).astype(np.float32)
    imgs = np.stack([_raster_bezier(c[0], c[1], c[2]) for c in ctrl])
    features = imgs.reshape(num_examples, -1) if flat else imgs[..., None]
    return DataSet(features.astype(np.float32),
                   ctrl.reshape(num_examples, 6).astype(np.float32))
