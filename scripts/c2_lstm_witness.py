#!/usr/bin/env python3
"""C2 on the CPU: does the JAX package's own bf16 LSTM kernel part from
its ``lax.scan`` path at ill-conditioned training steps, as the port's
kernels part from the port's plain scan in phase 6 of ``chip_smoke.py``
(the printed ``witness_seed31`` / ``witness_seed33``)?

Phase 6's witness at a reduced width: the char-RNN stack (vocab 64, two
GravesLSTM of ``--hidden`` units, a softmax RnnOutputLayer, bf16
compute, Adam 0.01) from ``chip_smoke._random_params`` at the weight
seeds 31 and 33, on ``chip_smoke._markov_ids`` at the id seeds 32 and 34
([``--batch``, ``--seq``]). Along ``--steps`` Adam steps of the JAX
package's ``lax.scan`` path (its ``fit``), before each step, the loss
and gradients (eval mode, as the witness) on the same weights through
the JAX package's Pallas kernels, interpreted (``_on_tpu`` patched to
True, as ``tests/test_lstm_kernel.py`` does), against the ``lax.scan``
path's: per step the worst relative L2 over the gradients, where it is,
and the loss difference. One JSON line per seed.

    JAX_PLATFORMS=cpu python3 scripts/c2_lstm_witness.py [--batch 64]
        [--seq 128] [--hidden 128] [--steps 20]

The defaults cut phase 6's batch 1024 and 512 units to 64 and 128 (the
reference kernel's tile) so that the interpreter runs in minutes; the
sequence length, vocabulary, seeds, optimizer and step count are phase
6's. Imports JAX: it measures the reference, not the port.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    import deeplearning4j_tpu.ops.lstm_kernel as jlk
    from deeplearning4j_tpu.datasets.dataset import DataSet
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf import layers as L
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork

    v, n = cs.CHAR_VOCAB, args.hidden
    conf = (NeuralNetConfiguration.builder().seed(1).learning_rate(0.01)
            .updater("adam").activation("tanh").compute_dtype("bfloat16").list()
            .layer(L.GravesLSTM(n_in=v, n_out=n))
            .layer(L.GravesLSTM(n_in=n, n_out=n))
            .layer(L.RnnOutputLayer(n_in=n, n_out=v, activation="softmax",
                                    loss_function="mcxent"))
            .build())

    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as Port

    # the port's net on the CPU gives _random_params its layout and order
    shapes = Port(MultiLayerConfiguration.from_json(conf.to_json()),
                  device="cpu").init()
    eye = np.eye(v, dtype=np.float32)
    for wseed, iseed in ((31, 32), (33, 34)):
        net = MultiLayerNetwork(conf).init()
        tree = cs._random_params(shapes, seed=wseed)
        net.params = jax.tree.map(jnp.asarray, tree)
        ids = cs._markov_ids(np, np.random.default_rng(iseed), args.batch, args.seq)
        x, y = eye[ids], eye[np.roll(ids, -1, axis=1)]
        xj, yj = jnp.asarray(x), jnp.asarray(y)

        def loss(p):
            return net._score_fn(p, net.states, xj, yj, False, None, None, None)[0]

        plain = jax.jit(jax.value_and_grad(loss))
        kernel = jax.jit(jax.value_and_grad(loss))
        rows, t0 = [], time.perf_counter()
        for _ in range(args.steps):
            lp, gp = plain(net.params)
            saved = jlk._on_tpu
            jlk._on_tpu = lambda: True
            try:
                lk, gk = kernel(net.params)
            finally:
                jlk._on_tpu = saved
            worst, at = 0.0, ""
            for layer, g in gp.items():
                for name, a in g.items():
                    b = np.asarray(gk[layer][name], np.float64)
                    a = np.asarray(a, np.float64)
                    rel = float(np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30))
                    if not np.isfinite(b).all():
                        rel = float("inf")
                    if rel >= worst:
                        worst, at = rel, f"{layer}/{name}"
            rows.append(dict(loss=float(lp), loss_vs_scan=abs(float(lk) - float(lp)),
                             grad_rel_l2_vs_scan=worst, at=at))
            net.fit(DataSet(x, y))
        print("c2_witness " + json.dumps(dict(
            weight_seed=wseed, id_seed=iseed, batch=args.batch, seq=args.seq,
            hidden=n, seconds=time.perf_counter() - t0, steps=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
