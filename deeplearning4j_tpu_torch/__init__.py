"""deeplearning4j_tpu_torch: the PyTorch + CUDA port of deeplearning4j_tpu.

The port mirrors the JAX package's layout module for module, and is held
against it on the same inputs in ``tests/test_torch_*.py``. It imports
``torch`` and numpy, never ``jax``, and nothing of ``deeplearning4j_tpu``:
what it needs from there it keeps as its own copy.

Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; without a card and without ``device="cpu"`` they
raise. Every TPU (Pallas) kernel on a ported path is a hand-written
CUDA kernel under ``kernels/``, built at first use; on the CPU each
kernel's wrapper runs its plain PyTorch version instead.

Ported so far: the GPT serving path (``models.zoo.transformer.gpt`` ->
``MultiLayerNetwork.generate``), GPT training (``fit``, ``score``, the
losses and updaters), the GravesLSTM char-RNN, the feed-forward and CNN
path (dense, convolution, pooling, batch and local response
normalization, the input types and preprocessors, ``evaluate``, the
listeners, the f64 gradient check, the MNIST and Iris data), the config
JSON and YAML and the model zip with its updater and layer state, the
flash-attention and LSTM kernels, and (``monitor/``) the metrics
registry, phase spans and request traces every path publishes into.
"""
