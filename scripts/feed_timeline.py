#!/usr/bin/env python3
"""Where a pipelined ``fit``'s time goes, on the card: the host spans of
the feed's stages and of each step, batch by batch.

    python3 scripts/feed_timeline.py

Runs phase 6's char-RNN (``chip_smoke.py``: bf16, two GravesLSTM(512),
b 1024, seq 128, seed-31 weights) over 8 full minibatches of one-hot
f32 data through ``fit`` (pipeline on, and off), after a warm-up fit
each. For each batch it prints, in ms from the start of the fit, the
span of the host-side slice (``ListDataSetIterator``'s gather, on the
prefetch thread), of the staging (``DeviceStager``, on the feed thread)
and of the step (``_fit_batch`` on the training thread, not
synchronized), then the fit's wall ms per step. First the same host
operations on an idle process: the slice, ``Tensor.pin_memory`` and a
``copy_`` into a pinned buffer, and the pageable copy to the card.
Needs one CUDA card; prints the card's name and power limit.
"""

from __future__ import annotations

import collections
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BATCHES = 8


def _ms(t, t0):
    return round((t - t0) * 1e3, 2)


def _ring_stage(torch, staging):
    """A variant of ``DeviceStager._stage`` for the card: each array is
    copied (``copy_``, on the intra-op threads) into a pinned buffer of a
    ring kept per shape and dtype, reused once the event of its last copy
    has fired, then sent to the card as the stager does."""
    ring = collections.defaultdict(list)  # (shape, dtype) -> [[buf, event]]

    def pinned(t):
        slots = ring[(tuple(t.shape), t.dtype)]
        for slot in slots:
            if slot[1] is not None and slot[1].query():
                break
        else:
            slot = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True), None]
            slots.append(slot)
        slot[0].copy_(t)
        return slot

    def stage(self, arrays, batch_of):
        with torch.cuda.device(self.device):
            if self.stream is None:
                self.stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self.stream):
                out, used = [], []
                for a in arrays:
                    if a is None:
                        out.append(None)
                        continue
                    slot = pinned(staging._host_tensor(a))
                    used.append(slot)
                    out.append(slot[0].to(self.device, non_blocking=True)
                               .to(self.dtype))
                event = torch.cuda.Event()
                event.record(self.stream)
                for slot in used:
                    slot[1] = event
        batch = batch_of(out)
        batch._staged = staging._Staged(event, [t for t in out if t is not None])
        return batch

    return stage


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.datasets import iterators, staging
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    if not torch.cuda.is_available():
        print("feed_timeline: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, "
          f"{torch.get_num_threads()} intra-op threads", flush=True)
    ids = cs._markov_ids(np, np.random.default_rng(35), BATCHES * cs.CHAR_BATCH,
                         cs.CHAR_SEQ)
    eye = np.eye(cs.CHAR_VOCAB, dtype=np.float32)
    ds = DataSet(eye[ids], eye[np.roll(ids, -1, axis=1)])

    # the host operations alone, each the best of 5
    def best(fn):
        out = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return round(min(out), 3)

    it = iterators.ListDataSetIterator(ds, cs.CHAR_BATCH)
    b = it.next()
    buf = torch.empty(b.features.shape, dtype=torch.float32, pin_memory=True)
    src = torch.from_numpy(b.features)
    print("idle: " + str(dict(
        slice_ms=best(lambda: (it.reset(), it.next())),
        pin_memory_ms=best(lambda: src.pin_memory()),
        copy_into_pinned_ms=best(lambda: buf.copy_(src)),
        pinned_to_card_ms=best(lambda: buf.to("cuda", non_blocking=True)),
        pageable_to_card_ms=best(lambda: src.to("cuda")))), flush=True)

    spans = collections.defaultdict(list)
    lock = threading.Lock()

    def timed(name, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            with lock:
                spans[name].append((t0, time.perf_counter()))
            return out
        return wrapper

    iterators.ListDataSetIterator._next_impl = timed(
        "slice", iterators.ListDataSetIterator._next_impl)
    built = staging.DeviceStager._stage
    staging.DeviceStager._stage = timed("stage", built)
    for pipeline in (True, False, "ring"):
        if pipeline == "ring":
            staging.DeviceStager._stage = timed("stage", _ring_stage(torch, staging))
        net = cs._service_net()
        net._fit_batch = timed("step", net._fit_batch)
        for run in ("warm", "timed"):
            spans.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.fit(iterators.ListDataSetIterator(ds, cs.CHAR_BATCH),
                    feed_pipeline=bool(pipeline))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = {name: [(_ms(a, t0), _ms(z, t0)) for a, z in v]
                for name, v in spans.items()}
        print(f"pipeline {pipeline}: fit {wall * 1e3 / BATCHES:.2f} ms a step; "
              f"spans (start, end) ms: {rows}", flush=True)
        del net
    return 0


if __name__ == "__main__":
    sys.exit(main())
