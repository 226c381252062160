"""Layer impls; importing this package registers them."""

from deeplearning4j_tpu_torch.nn.layers import feedforward, transformer  # noqa: F401
