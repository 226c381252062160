"""GPT-style causal language model for the zoo.

Counterpart of ``deeplearning4j_tpu/models/zoo/transformer.py`` (``gpt``,
``generate``, ``gpt_stack_blocks``, ``gpt_train_flops_per_token`` and
``gpt_benchmark``): token+position embedding -> N pre-LN transformer
blocks (the flash-attention kernels on the card; dense MLPs, or
Mixtral-style top-1 routed experts with ``num_experts > 0``) -> softmax
LM head, trained with Adam by ``net.fit`` or ``net.fit_scan``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.zoo.benchmark import best_of_fit_scan
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import (
    RnnOutputLayer,
    SequenceEmbeddingLayer,
    TransformerBlock,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.device import DeviceLike


def gpt(vocab_size: int = 50257, d_model: int = 512, n_layers: int = 8,
        num_heads: int = 8, max_len: int = 1024, ffn_mult: int = 4,
        dropout: float = 0.0, learning_rate: float = 3e-4,
        compute_dtype: str = "bfloat16", num_experts: int = 0,
        capacity_factor: float = 1.25, aux_loss_weight: float = 0.01,
        seed: int = 0, device: DeviceLike = None) -> MultiLayerNetwork:
    """Decoder-only LM over int token ids [b, t], with the reference's
    config (its JSON is the reference's). ``device`` defaults to cuda.
    ``num_experts > 0`` swaps the dense MLPs for top-1 routed experts
    (``capacity_factor`` and ``aux_loss_weight`` tune the routing)."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed).learning_rate(learning_rate).updater("adam")
         .activation("identity").weight_init("xavier")
         .compute_dtype(compute_dtype)
         .list()
         .layer(SequenceEmbeddingLayer(n_in=vocab_size, n_out=d_model,
                                       max_len=max_len)))
    for _ in range(n_layers):
        b = b.layer(TransformerBlock(n_in=d_model, n_out=d_model,
                                     num_heads=num_heads, ffn_mult=ffn_mult,
                                     causal=True, dropout=dropout,
                                     num_experts=num_experts,
                                     capacity_factor=capacity_factor,
                                     aux_loss_weight=aux_loss_weight))
    conf = (b.layer(RnnOutputLayer(n_in=d_model, n_out=vocab_size,
                                   activation="softmax",
                                   loss_function="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device=device)


def gpt_stack_blocks(net: MultiLayerNetwork) -> Dict[str, torch.Tensor]:
    """The (identical) TransformerBlock parameters of a ``gpt`` net,
    stacked: every entry gains a leading [n_layers] dimension, the
    layout a pipeline shards over its stages."""
    trees = [net.params[b.name] for b in net.impls[1:-1]]
    return {name: torch.stack([t[name] for t in trees]) for name in trees[0]}


def gpt_train_flops_per_token(vocab_size: int, d_model: int, n_layers: int,
                              seq_len: int, ffn_mult: int = 4) -> float:
    """Train FLOPs per token, the reference's count: 6 x the MACs of
    the qkv, output and MLP projections, the causal attention products,
    the head and the embedding gather."""
    per_layer = 3 * d_model * d_model + d_model * d_model \
        + 2 * ffn_mult * d_model * d_model          # qkv + proj + mlp
    attn = 2 * seq_len * d_model / 2                # causal qk^T + pv
    head = d_model * vocab_size
    macs = n_layers * (per_layer + attn) + head + d_model  # + embed gather
    return 6.0 * macs


def gpt_benchmark(peak_flops: float, vocab_size: int = 8192,
                  d_model: int = 512, n_layers: int = 8, seq_len: int = 1024,
                  batch: int = 16, steps: int = 4, device: DeviceLike = None,
                  record: Optional[dict] = None) -> dict:
    """Training throughput on synthetic token streams from numpy
    ``default_rng(0)`` (labels the ids rolled by one): the data staged
    once (``stage_scan``), one warm-up ``fit_scan`` of 12 epochs over
    ``steps`` minibatches, then the best of two timed ones. Returns the
    reference's keys; with ``record`` given, also stores there the net,
    the staged data, every call's scores in order and the best call's
    seconds."""
    net = gpt(vocab_size=vocab_size, d_model=d_model, n_layers=n_layers,
              max_len=seq_len, device=device).init()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab_size, (batch * steps, seq_len))
    staged = net.stage_scan(DataSet(ids.astype(np.float32),
                                    np.roll(ids, -1, axis=1).astype(np.float32)),
                            batch)
    epochs = 12
    scores, dt = best_of_fit_scan(net, batch, epochs, staged)
    tps = epochs * steps * batch * seq_len / dt
    mfu = tps * gpt_train_flops_per_token(
        vocab_size, d_model, n_layers, seq_len) / peak_flops
    assert np.isfinite(scores).all()
    if record is not None:
        record.update(net=net, staged=staged, scores=scores, seconds=dt,
                      epochs=epochs)
    return {"metric": "gpt_train_tokens_per_sec_per_chip",
            "value": round(tps, 1), "unit": "tokens/sec/chip",
            "mfu": round(mfu, 4), "vs_baseline": round(mfu / 0.30, 4)}


def generate(net: MultiLayerNetwork, prompt_ids: np.ndarray,
             max_new_tokens: int, temperature: float = 0.0, *,
             top_k: int = 0, top_p: float = 0.0,
             eos_token: int = None, seed: int = 0) -> np.ndarray:
    """``prompt_ids`` [b, t0] -> [b, t0 + max_new_tokens]; see
    ``nn/generate.py``."""
    return net.generate(prompt_ids, max_new_tokens,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        eos_token=eos_token, seed=seed)
