"""Layer impls; importing this package registers them."""

from deeplearning4j_tpu_torch.nn.layers import (  # noqa: F401
    attention,
    convolution,
    feedforward,
    moe,
    normalization,
    recurrent,
    transformer,
)
