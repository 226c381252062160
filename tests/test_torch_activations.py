"""Every activation of the port against the JAX package's on the same
seeded inputs (f32, 1e-6: the same formulas, elementwise; softmax over
the last axis)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu_torch.ops import activations as tact


@pytest.mark.parametrize("name", [a.value for a in tact.Activation])
def test_activation_matches_jax(name):
    x = (np.random.default_rng(0).standard_normal((4, 64)) * 3).astype(np.float32)
    x[0, :6] = [0.0, -0.0, 1e-8, -1e-8, 40.0, -40.0]  # zeros, tiny, saturated
    want = np.asarray(jact.activate(name, jnp.asarray(x)))
    got = tact.activate(name, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=name)


def test_names_are_the_references():
    assert [a.value for a in tact.Activation] == [a.value for a in jact.Activation]
