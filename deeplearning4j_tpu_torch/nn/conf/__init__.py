from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: F401
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
