"""Layer impls; importing this package registers them."""

from deeplearning4j_tpu_torch.nn.layers import (  # noqa: F401
    feedforward,
    recurrent,
    transformer,
)
