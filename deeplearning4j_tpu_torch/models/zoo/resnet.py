"""ResNet-50 as a ComputationGraph.

Counterpart of ``deeplearning4j_tpu/models/zoo/resnet.py``: the
bottleneck ResNet-v1.5 (the stride 2 on the 3x3 of each downsampling
block), stages [3, 4, 6, 3], widths 64/128/256/512, expansion 4, NHWC,
bias-free convolutions each followed by a BatchNormalization (the last
of each block's at gamma 0, so residual branches start as identity),
trained with nesterovs. The convolutions, the batch norms and the
pooling run on cuDNN; no port kernel sits on this path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
from deeplearning4j_tpu_torch.models.zoo.benchmark import best_of_fit_scan
from deeplearning4j_tpu_torch.nn.conf.configuration import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer,
    BatchNormalization,
    ConvolutionLayer,
    GlobalPoolingLayer,
    OutputLayer,
    PoolingType,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.util.device import DeviceLike

STAGES = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)
EXPANSION = 4


def _conv(n_in, n_out, k, s):
    return ConvolutionLayer(n_in=n_in, n_out=n_out, kernel_size=(k, k),
                            stride=(s, s), convolution_mode="same",
                            activation="identity", weight_init="relu",
                            has_bias=False)


def _bn(n, gamma: float = 1.0):
    return BatchNormalization(n_in=n, n_out=n, gamma=gamma)


def resnet(stages=STAGES, widths=WIDTHS, num_classes: int = 1000,
           compute_dtype: str = "bfloat16", learning_rate: float = 0.1,
           seed: int = 12345, device: DeviceLike = None) -> ComputationGraph:
    """A bottleneck ResNet for [b, H, W, 3] NHWC inputs, with the
    reference's config (its JSON is the reference's); ``device``
    defaults to cuda."""
    base = (NeuralNetConfiguration.builder()
            .seed(seed).learning_rate(learning_rate).updater("nesterovs")
            .momentum(0.9).weight_init("relu").activation("identity")
            .compute_dtype(compute_dtype)
            .build())
    g = (ComputationGraphConfiguration.builder(base)
         .add_inputs("in")
         .add_layer("stem_conv", _conv(3, 64, 7, 2), "in")
         .add_layer("stem_bn", _bn(64), "stem_conv")
         .add_layer("stem_relu", ActivationLayer(activation="relu"), "stem_bn")
         .add_layer("stem_pool",
                    SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                     padding=(1, 1),
                                     pooling_type=PoolingType.MAX),
                    "stem_relu"))

    prev, prev_c = "stem_pool", 64
    for si, (blocks, width) in enumerate(zip(stages, widths)):
        out_c = width * EXPANSION
        for bi in range(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            p = f"s{si}b{bi}"
            g = (g
                 .add_layer(f"{p}_c1", _conv(prev_c, width, 1, 1), prev)
                 .add_layer(f"{p}_bn1", _bn(width), f"{p}_c1")
                 .add_layer(f"{p}_r1", ActivationLayer(activation="relu"), f"{p}_bn1")
                 .add_layer(f"{p}_c2", _conv(width, width, 3, stride), f"{p}_r1")
                 .add_layer(f"{p}_bn2", _bn(width), f"{p}_c2")
                 .add_layer(f"{p}_r2", ActivationLayer(activation="relu"), f"{p}_bn2")
                 .add_layer(f"{p}_c3", _conv(width, out_c, 1, 1), f"{p}_r2")
                 .add_layer(f"{p}_bn3", _bn(out_c, gamma=0.0), f"{p}_c3"))
            if bi == 0:  # projection shortcut where the shape changes
                g = (g.add_layer(f"{p}_sc", _conv(prev_c, out_c, 1, stride), prev)
                      .add_layer(f"{p}_scbn", _bn(out_c), f"{p}_sc"))
                shortcut = f"{p}_scbn"
            else:
                shortcut = prev
            g = (g.add_vertex(f"{p}_add", ElementWiseVertex(op="add"),
                              f"{p}_bn3", shortcut)
                  .add_layer(f"{p}_out", ActivationLayer(activation="relu"),
                             f"{p}_add"))
            prev, prev_c = f"{p}_out", out_c

    g = (g.add_layer("pool", GlobalPoolingLayer(pooling_type=PoolingType.AVG), prev)
          .add_layer("fc", OutputLayer(n_in=prev_c, n_out=num_classes,
                                       activation="softmax",
                                       loss_function="mcxent",
                                       weight_init="xavier"), "pool")
          .set_outputs("fc"))
    return ComputationGraph(g.build(), device=device)


def resnet50(num_classes: int = 1000, compute_dtype: str = "bfloat16",
             learning_rate: float = 0.1, seed: int = 12345,
             device: DeviceLike = None) -> ComputationGraph:
    """ResNet-50 (stages 3/4/6/3) for [b, 224, 224, 3] NHWC inputs."""
    return resnet(STAGES, WIDTHS, num_classes, compute_dtype, learning_rate,
                  seed, device)


def resnet50_train_flops_per_example(image_size: int = 224) -> float:
    """The reference's count: the multiply-adds of every convolution and
    the head summed over the v1.5 graph; a training step is 3 forwards,
    a forward 2 FLOPs per multiply-add."""
    macs = 0
    hw = image_size // 2  # the stem convolution's output
    macs += hw * hw * 64 * 3 * 49
    hw //= 2  # after the max pool
    prev_c = 64
    for si, (blocks, width) in enumerate(zip(STAGES, WIDTHS)):
        out_c = width * EXPANSION
        for bi in range(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            out_hw = hw // stride
            macs += hw * hw * width * prev_c              # 1x1 (input size)
            macs += out_hw * out_hw * width * width * 9   # 3x3 (strided)
            macs += out_hw * out_hw * out_c * width       # 1x1 expansion
            if bi == 0:
                macs += out_hw * out_hw * out_c * prev_c  # projection
            hw = out_hw
            prev_c = out_c
    macs += prev_c * 1000
    return 3.0 * 2.0 * macs


def resnet50_benchmark(peak_flops: float, batch: int = 128,
                       image_size: int = 224, steps: int = 8,
                       num_classes: int = 1000, device: DeviceLike = None,
                       record: Optional[dict] = None) -> dict:
    """Training throughput on synthetic ImageNet-shaped data from numpy
    ``default_rng(0)``: the data staged once (``stage_scan``), one
    warm-up ``fit_scan`` of 12 epochs over ``steps`` minibatches, then
    the best of two timed ones. Returns the reference's keys; with
    ``record`` given, also stores there the net, the staged data, every
    call's scores in order and the best call's seconds."""
    net = resnet50(num_classes=num_classes, device=device)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch * steps, image_size, image_size, 3)).astype(np.float32)
    y = np.eye(num_classes, dtype=np.float32)[rng.integers(0, num_classes, batch * steps)]
    staged = net.stage_scan(MultiDataSet([x], [y]), batch)
    del x, y
    epochs = 12
    scores, dt = best_of_fit_scan(net, batch, epochs, staged)
    eps = epochs * steps * batch / dt
    mfu = eps * resnet50_train_flops_per_example(image_size) / peak_flops
    assert np.isfinite(scores).all()
    if record is not None:
        record.update(net=net, staged=staged, scores=scores, seconds=dt,
                      epochs=epochs)
    return {"metric": "resnet50_train_examples_per_sec_per_chip",
            "value": round(eps, 1), "unit": "examples/sec/chip",
            "mfu": round(mfu, 4), "vs_baseline": round(mfu / 0.30, 4)}

