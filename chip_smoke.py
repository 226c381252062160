#!/usr/bin/env python3
"""Smoke test of the PyTorch port (deeplearning4j_tpu_torch) on one
NVIDIA GPU; the quickest proof that the port still starts on the card.

    python3 chip_smoke.py                 # every phase, as the check runs it
    python3 chip_smoke.py --only 2b,5     # phases 0 and 1, then just these

Phases (any failure ends the run with a non-zero exit and no result):

0. device: the card's name and power limit (nvidia-smi); fails without
   CUDA.
1. build: every kernel source in this checkout, one ``nvcc`` each, all
   started together, from an empty build directory, timed; fails if a
   bf16 ``flash_fwd_kernel``, ``flash_fwd_kernel_wide``,
   ``flash_dq_kernel``, ``flash_dkv_kernel``, ``flash_dq_kernel_wide``,
   ``flash_dkv_kernel_wide``, ``lstm_fwd_kernel``,
   ``lstm_bwd_kernel`` or ``lstm_dw_kernel``, or an
   f32 ``flash_fwd_kernel_tf32x3``, ``flash_dq_kernel_tf32x3``,
   ``flash_dkv_kernel_tf32x3``,
   ``flash_dq_kernel_wide_tf32x3``, ``flash_dkv_kernel_wide_tf32x3``,
   ``lstm_fwd_kernel``, ``lstm_bwd_kernel`` or ``lstm_dw_kernel``,
   spills registers (``BF16_KERNELS``, ``F32_KERNELS``).
2. kernels: each kernel's wrapper on card tensors against its plain
   PyTorch version on the same inputs, at the main paths' shapes, at
   larger ones and at ragged ones (t = 200, tq 72 / tk 200, one head of
   2048; the wide heads of 256, 512 and 1024, ``WIDE_HEAD_CASES``,
   ``WIDE_512_CASES``, ``WIDE_F32_512_CASES``, ``WIDE_F32_1024_CASES``
   and ``WIDE_1024_CASES``), with stated tolerances; a
   forward call must be
   one launch of the kernel its dtype and head take
   (``fwd_kernel_name``: the bf16 heads of 256, 512 and 1024 run
   ``flash_fwd_kernel_wide``, the f32 heads of every width
   ``flash_fwd_kernel_tf32x3``), a backward
   call one launch of each of
   the two its dtype and head take (``bwd_kernel_names``: the bf16
   heads of 256, 512 and 1024 run ``flash_dq_kernel_wide`` and
   ``flash_dkv_kernel_wide``; the f32 heads up
   to 128 ``flash_dq_kernel_tf32x3`` and ``flash_dkv_kernel_tf32x3``,
   256, 512 and 1024 ``flash_dq_kernel_wide_tf32x3`` and
   ``flash_dkv_kernel_wide_tf32x3``), and the bf16
   forward at heads of 64 and 128 is also run and timed at both of its
   tilings (64 and 128 query rows per block), and the bf16 and f32
   forward and the bf16 ``flash_dq`` at 1024 at both of theirs (16 and
   32); median times beside the
   plain version, the one PyTorch call that computes the same
   function (a yardstick only, never used by the port) and the least
   time the card could take (the bound). ``ms`` columns are device time
   (torch.profiler: the card's work per call); ``call_ms`` columns are
   CUDA-event time per single call, which includes the host's launch
   work. The forward (``flash_fwd``) first, then the backward
   (``flash_dq``, ``flash_dkv``) at the same shapes, ragged ones
   included; a backward call must launch
   each of the two once. The f32 backward rows also print the bound of
   each kernel on the tensor cores in 3xTF32 (``dq_bound_tf32x3_ms``,
   ``dkv_bound_tf32x3_ms``: three TF32 products per f32 one at 495
   TFLOP/s) beside the f32 CUDA-core bound, and each kernel's share of
   both (the tensor-core kernels may beat the CUDA-core bound: a share
   of it above 1 is no error); the f32 forward rows print the same two
   bounds of the forward (``bound_ms``, ``bound_tf32x3_ms``) and its
   shares of them. Last, C3 and C4 (``flash_bwd_scale4`` lines): at each
   f32 head from 64 to 1024, on inputs drawn at scale 4 from numpy seeds
   (``scale4_arrays``: scores of ±60 and more), the f32 forward's errors
   from an f64 forward (``fwd_f64``) and the f32 backward's after it
   from an f64 backward (``bwd_f64``), beside the plain backward's; the
   run fails where the forward's or the backward's passes twice the JAX
   package's own f32 error there (``REF_SCALE4_FWD_REL``,
   ``REF_SCALE4_REL``).
2b. LSTM kernels: first one call of ``lstm_fwd``'s timed bf16
   instantiation at the training shape, printed as ``lstm_fwd_phases``:
   the mean µs per step (over blocks and steps) of the barrier wait, the
   h chunks up to the landing of the last one (their copies and waits
   and the products of all but the last), the last chunk's product, and
   the cell with its stores, from the card's globaltimer; then one call
   of ``lstm_bwd``'s timed bf16 sweep on that forward's residuals,
   printed as ``lstm_bwd_phases`` (the same four phases of its step:
   barrier wait, dg chunks but the last, the last chunk's product, the
   gate chain with its stores and the next step's prefetch), whose
   outputs must equal the untimed kernels' bit for bit; then
   ``lstm_bwd_phases`` of the f32 sweep (``F32_BWD_TIMER_CASES``: b 32,
   t 128, n 512 and the char-RNN example's b 64, t 64, n 256; barrier
   wait, the sums of the dh partials, the gate chain with its stores,
   the product with its stores), bit for bit too; then
   ``lstm_fwd_phases`` of the f32 forward (``F32_TIMER_CASES``): 50
   timed calls of ``lstm_fwd_only`` at the serving shape (b 32, t 1,
   n 512: no barrier, and the first phase runs from the kernel's entry,
   so it holds the loads of W, h and xg), reading Wr and then its copy
   packed per block (``pack_wr``, as generate does), and 3 of
   ``lstm_fwd`` at b 32, t 128, n 512, each call's outputs equal to the
   untimed kernel's; every f32 row also times ``lstm_fwd_only`` on the
   packed copy (its outputs equal bit for bit). Then
   ``lstm_fwd_only``, ``lstm_fwd`` and the backward pair ``lstm_bwd`` +
   ``lstm_dw`` against their plain versions, f32 and bf16, nonzero h0
   and c0, at the char-RNN's two main shapes (b 1024, t 128,
   n 512 bf16 for training; b 32, t 1, n 512 f32 for serving) and at
   n 128 / 1024, b 8 / 32 / 1024, t 1 / 9 / 128; the yardstick is
   PyTorch's ``nn.LSTM`` (cuDNN where it takes the dtype), which has no
   peepholes: the same products, not the same function.
3. serving at full width: ``gpt`` (vocab 8192, d_model 512, 8 layers,
   8 heads, max_len 512, bf16) with random weights from a numpy seed,
   greedy ``generate`` of 128 tokens for 8 prompts of 64. Launch counts
   are zeroed right before this run and read right after it; every
   kernel of the path must have launched. ``generate`` must equal
   ``generate_eager``, the prefill logits must agree with the same net
   run with the plain attention, and everything must be finite.
4. training at full width: the JAX package's GPT training benchmark
   width (vocab 8192, d_model 512, 8 layers, 8 heads, seq 1024, batch
   16, bf16, Adam at 3e-4) with random weights from a numpy seed and
   ids from a numpy seed, labels the ids rolled by one. Counts zeroed
   before one ``fit`` step and read after it: ``flash_fwd``,
   ``flash_dq`` and ``flash_dkv`` each launch once per block. Loss and
   gradients with the kernels agree with the same step run with the
   plain versions on the card; 20 steps on the batch give finite losses
   that fall; step time, tokens/s, MFU, the device busy share (beside
   the share of the port's kernel events the profile kept) and the
   attention kernels' device time per step are printed. Then the
   ``fit_scan`` row (``fit_scan_row``): the port's ``gpt_benchmark`` at
   its defaults (this width, 4 staged minibatches, 12 epochs a call, a
   warm-up call and the best of two timed ones): finite scores that
   fall, each flash kernel launched once per block on every step, and
   the step on the host's clock, tokens/s, MFU and busy share printed
   (``train_fit_scan``). Then one
   ``gradient_and_score`` step at a wide head (``WIDE_TRAIN``: d_model
   1024 over 4 heads of 256, 2 layers, seq 1024, batch 8, bf16), with
   the kernels against the plain versions on the card at the same
   tolerances: each flash kernel launches once per block, and its
   device step time and the wide kernels' share of it are printed
   (``train_wide``). Then one ``gradient_and_score`` step of the
   training width in f32 (``F32_TRAIN``: every attention call [128,
   1024, 64] f32 causal): each flash kernel launches once per block,
   the backward runs only the 3xTF32 kernels, the loss and every
   gradient agree with the plain attention's within
   ``F32_TRAIN_LOSS_REL`` and ``F32_TRAIN_GRAD_REL``, and its device
   step time and the flash kernels' ms and share of it are printed
   (``train_f32``). Then the same for the wide-head step in f32
   (``WIDE_F32_TRAIN``: ``WIDE_TRAIN`` in f32, every attention call [32,
   1024, 256] f32 causal, the backward through the wide 3xTF32 kernels;
   ``train_wide_f32``). Both f32 steps' forward runs
   ``flash_fwd_kernel_tf32x3`` and nothing else.
5. char-RNN serving at full width: the JAX package's LSTM decode
   benchmark (vocab 64, two GravesLSTM of 512, RnnOutputLayer softmax,
   f32), random weights from a numpy seed, greedy ``generate`` of 128
   tokens for 32 prompts of 32. ``lstm_fwd_only`` launches once per layer
   per prompt step and per decode step, 2 x (32 + 127) times, and no
   other LSTM kernel; ``generate`` equals ``generate_eager``; ``output``
   on the prompt agrees with the plain versions; ``rnn_time_step`` fed
   the prompt step by step ends on ``output``'s last step.
6. char-RNN training at full width: the JAX package's LSTM training
   benchmark (the same stack, bf16, Adam at 0.01, batch 1024, seq 128,
   one-hot ids of a seeded Markov chain, labels the ids rolled by one). One
   ``gradient_and_score`` with the kernels against the plain versions;
   one ``fit`` step launches ``lstm_fwd``, ``lstm_bwd`` and ``lstm_dw``
   once per layer and ``lstm_fwd_only`` never; 20 steps give finite
   losses that fall; step time, tokens/s, MFU, busy share (and kept
   share), the LSTM
   kernels' device ms per step and peak memory are printed. Then a
   witness (printed, not gated): 20 steps through the plain scan on the
   card, from these weights and from a second seed of weights and ids;
   before each, the loss and gradients on the same weights through the
   kernels, and through the forward kernel with the plain backward,
   against the plain scan's. Then ``examples/train_char_rnn.py``'s f32
   training at full width (one ``GravesLSTM(256)`` and its output layer
   over the corpus's 28 characters, Adam 0.01, batch 64, seq 64, ids of
   a seeded Markov chain, per-step ``fit``): loss and gradients with the
   kernels against the plain scan within ``EXAMPLE_*_REL``; one step
   launches ``lstm_fwd``, ``lstm_bwd`` and ``lstm_dw`` once and
   ``lstm_fwd_only`` never; 20 steps give a loss that falls; step time,
   tokens/s, MFU at the f32 peak, busy share and the three kernels' ms
   per step are printed (``char_train_f32``). Before it, the bf16
   stack's ``fit_scan`` row at ``bench_lstm``'s shapes (2 staged
   minibatches of 1024, seq 128, Markov ids, ``CHAR_SCAN_EPOCHS`` a
   call): ``lstm_fwd``, ``lstm_bwd`` and ``lstm_dw`` twice on every step
   (``char_train_fit_scan``).
7. LeNet-MNIST training at full width: the JAX package's flagship
   (``__graft_entry__._flagship``: conv 20@5x5, max 2x2/2, conv 50@5x5,
   max 2x2/2, dense 500, softmax 10; relu, Adam at 0.01, seed 12345,
   bf16), rebuilt by the port's builder with ``set_input_type``, on 8
   batches of 2048 of the port's synthetic MNIST. No port kernel runs
   on this path (cuDNN and cuBLAS do its work): the counts, zeroed
   before the first step and read after it, must stay empty. 20 steps
   give finite losses that fall; the median step of steps 3-20,
   examples/s, MFU (``bench.py``'s 13.758 MFLOP per example over 989
   TFLOP/s) and the busy share are printed; ``evaluate`` on 10,000
   synthetic test examples prints an accuracy marked as synthetic. f32
   copies of the net before and after training on the card, with
   cuDNN's TF32 switched on, match the port on the CPU for 64 examples:
   outputs within 1e-4 (relative), and the untrained copy's gradients
   within 1e-3 over the examples away from a kink (``kink_free``: a
   ReLU input or a max-pool tie within reach of f32 rounding makes the
   gradient jump; at least 56 of the 64 must qualify). Printed, not
   gated: the gradients over all 64 and the trained copy's (its softmax
   saturates), and the untrained copy's output error with the port's
   f32 scope taken away (TF32). The trained copy's zip, saved on the
   card, restores on the CPU with the CPU net's outputs. A ``fit_scan``
   row on the 8 staged minibatches (``LENET_SCAN_EPOCHS`` a call, no
   port kernel: ``lenet_train_fit_scan``).
8. MLP-Iris training at full width: the JAX package's benchmark net
   (4-64-64-3, relu, Adam at 0.1, seed 3, bf16) on the 150 Iris rows
   tiled 256 times, 20 steps of 4096 (no port kernel either): losses
   that fall, step ms, examples/s and busy share; ``evaluate`` on the
   150 rows; ``check_gradients`` in f64 on the card over every
   parameter of the trained net must pass; a ``fit_scan`` row on
   ``bench_mlp_iris``'s staging (9 minibatches of 4096, the tail dropped;
   ``mlp_iris_train_fit_scan``).
9. the ComputationGraph: (a) ResNet-50 through the port's
   ``resnet50_benchmark`` at batch 128, 224 x 224, 1000 classes, bf16,
   nesterovs 0.1 (8 staged minibatches of ``default_rng(0)`` images, 12
   epochs a call): finite scores that fall, no port kernel, examples/s,
   MFU (``resnet50_train_flops_per_example`` over 989 TFLOP/s), busy
   share and peak memory (``resnet50_fit_scan``); (b) a tiny ResNet
   (stages (1, 1), widths (8, 16), 4 classes, f32, 32 x 32) on the card
   against the CPU: outputs, score and one step within 1e-4 relative;
   (c) the char-RNN as a graph on phase 5's weights: a ``rnn_time_step``
   burst equal to the MultiLayerNetwork's (``lstm_fwd_only`` once per
   layer per step), a single step within ``SERVE_OUT_TOL``, and greedy
   ``generate`` equal to the MultiLayerNetwork's, through
   ``lstm_fwd_only`` only; (d) a ``gpt`` chain as a graph on phase 3's
   weights: greedy ``generate`` equal to the MultiLayerNetwork's, with
   the same launches, ``flash_fwd`` among them.

10. the rest of the layer library (``phase_layers``): (a) the MoE GPT
   at phase 4's width with the zoo's routed experts (8 experts, top-1,
   capacity factor 1.25, aux weight 0.01): each block's expert choices
   with the kernels against the plain versions (the share routed
   differently printed), then one step's loss and every gradient
   against the plain versions replaying the kernel step's routing
   (``TRAIN_*``), and routing by itself (the loss, and the layers
   before the first block that routes differently, ``MOE_FLIP_REL``);
   one ``fit`` step launches each flash kernel once per block; 20 steps
   give finite losses that fall; step ms, tokens/s, MFU, busy share,
   peak memory and the flash kernels' ms per step; (b) the MoE GPT at
   phase 3's width: greedy ``generate`` equal to ``generate_eager``
   through ``flash_fwd``, the prefill logits against the plain
   attention's (``LOGIT_TOL``, the plain run replaying the kernel run's
   routing; and by itself where no token routes differently); (c) phase
   3's dense GPT quantized to int8 and to fp8 (``nn/quantize.py``): the
   same checks of ``generate`` and the prefill, the parameter bytes, and
   ``accuracy_gate`` against the float net (printed); (d) two causal
   residual ``AttentionLayer(512 -> 512, 8 heads)`` under an
   ``RnnOutputLayer``, b 16, seq 1024, bf16: one ``gradient_and_score``
   against the plain attention (``TRAIN_*``), each flash kernel once
   per layer; (e) a DBN at MNIST's width (RBM 784 -> 500, AutoEncoder
   500 -> 250, output 10; f32, SGD 0.1) on 8 synthetic minibatches of
   2048: ``pretrain`` gives finite per-layer losses, the AE's falls over
   a second epoch, no port kernel launches, and one pretrain step per
   layer agrees with the CPU given the same uniforms (``PRETRAIN_REL``).
11. paged serving (``phase_paged``): phase 3's GPT and weights behind
   ``ContinuousDecodeScheduler`` (8 slots, bursts of 8, blocks of 16;
   ``PAGED``), 16 one-row requests of prompts 16-64 (seed 8) and +128
   greedy tokens, 8 submitted, one ``step()``, then 8 more. (a) the
   admissions' prefills launch ``flash_fwd``; each request's tokens
   equal its solo ``generate_eager``, or the first position that
   differs is a near-tie of the eager run (top-two logits within
   ``LOGIT_TOL``); then the same in f32 with a near-tie bound of
   ``PAGED_TIE_F32``; tokens/s, time to first token, bursts and the busy
   share, the last from a profile of a shorter steady window: the first
   8 requests (the slots full), +32 each (``PAGED_WINDOW_NEW``), against
   the wall time of the same serve unprofiled (``paged_serve`` line). (b) the same requests on a pool of 49
   blocks: it preempts, the tokens equal (a)'s under the same rule, the
   pool drains fully free and a double free raises. (c) an int8 KV
   pool twice: the runs agree token for token and every first token is
   (a)'s; agreement with (a) and bytes per block printed. (d) a prompt
   whose prefix comes from a shared table (``share_blocks``, its
   partial block copied on write by ``block_copy_program``): the tail's
   ``tail_prefill_program`` logits within ``LOGIT_TOL`` of a full
   prefill, the shared block untouched.
12. the training services (``phase_services``) on phase 6's char-RNN
   (bf16, b 1024, seq 128, seed-31 weights), over 8 minibatches of
   Markov ids exported to a temporary directory (``export_dataset``).
   First two identical runs of the step over them: every gate below is
   bit for bit where these agree bit for bit, else within
   ``CHAR_GRAD_REL``. (a) ``ResumableTrainer`` at a checkpoint every 2
   steps over a shuffled ``ExportedDataSetIterator``, uninterrupted, and
   preempted after 3 steps then resumed in a fresh trainer and iterator:
   equal parameters and updater state; each step's ms, each save's ms,
   the restore's ms and the unit's bytes printed. (b) a
   ``TrainingSupervisor`` run equals the unsupervised one; a batch of
   NaN features rolls back once (its index in ``batches_skipped``), to
   the snapshot, and the next step equals one at 0.5x the learning rate
   from it. (c) ``EarlyStoppingTrainer`` for 3 epochs with
   ``ScoreImprovementEpochTerminationCondition`` and a held-out
   ``DataSetLossCalculator``: the best model's held-out score is the one
   recorded. (d) 20 steps in one ``fit`` with a listener of frequency 5
   equal a run with frequency 1 at its iterations, with 4 score fetches
   (plus the end of fit's empty call) against 20; the host ms per step
   of both. Counts zeroed before (a)-(d) and read after: ``lstm_fwd``,
   ``lstm_bwd``, ``lstm_dw`` (training) and ``lstm_fwd_only`` (the
   held-out scores) must have launched. (e) ``Solver`` with ``lbfgs``, 10
   iterations, on phase 6's f32 example net: the oracle's first gradient
   through the kernels (one launch each of the f32 ``lstm_fwd``,
   ``lstm_bwd``, ``lstm_dw``) against the plain versions within
   ``EXAMPLE_GRAD_REL``, the f32 kernels launched by the solve, and a
   loss that falls (``services`` line).
13. the feed pipeline (``phase_feed``): both containers' ``fit`` on an
   iterator wrap it in the shape bucketing, the host prefetch and the
   device staging (pinned host memory, a side stream, an event the step
   waits on). (a) phase 6's char-RNN (bf16, b 1024, seq 128, seed-31
   weights) over 8 full minibatches and a ragged tail of 300 rows, one
   ``fit`` with the pipeline off and one with it on from the same
   weights: the 8 full steps' scores and the parameters after them
   equal bit for bit; the tail step with the pipeline is the tail padded
   to 1024 rows with a [1024, 128] labels mask and launches
   ``lstm_fwd``, ``lstm_bwd`` and ``lstm_dw`` twice each; its score
   within ``CHAR_LOSS_TOL`` and its update within ``CHAR_GRAD_REL``
   (relative L2) of the unpadded tail's; the host ms per step both
   ways, the busy share of a steady window of pipelined steps and the
   stream and time of the staging copy. (b) phase 4's GPT (seed-11
   weights) over 4 full minibatches of 16, pipeline off and on: scores
   and parameters bit for bit, 8 launches of each flash kernel per
   step. (c) the native IO library built from the checkout's source
   (fails on the NumPy fallback): ``csv_read_floats``, ``gather_rows``
   (plain and fused with the standardization) and ``one_hot`` equal
   their NumPy forms bit for bit on 8192 x 3072 (the CSV holds exact
   binary fractions), timed both ways; then the Iris CSV through
   ``CSVRecordReader``, ``RecordReaderDataSetIterator`` and a fitted
   ``NormalizerStandardize`` trains phase 8's MLP-Iris for 20 steps
   through the pipeline, and its loss falls (``feed`` line).

Phase 2's rows carry their wall time (``row_s``) and each phase line
the time since the start (``[t ... s]``); the kernels line gives each
kernel its launches per step on the fit_scan paths, on phase 9's
graph generate paths, on phase 10's paths, on phase 11's serve and in
phase 12 (``services_launches``, ``solver_launches``) and in phase 13's
pipelined runs (``feed_launches``).

The last lines are the card's name and power limit, one JSON object
with every kernel's numbers, and ``{"ok": true, "device": {...}}``
(only when every phase ran). Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# bf16 products on the tensor cores; f32 products in full f32 (no TF32)
# so that f32 comparisons hold to 2e-5
TOL = {  # kernel vs its plain version: max |o - o_plain|, max |lse - lse_plain|
    "float32": (2e-5, 2e-5),
    # one bf16 ulp at |o| < 4 is 0.0156; the plain version rounds P and o
    # at the same places but sums in another order
    "bfloat16": (2e-2, 1e-4),
}
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM dense
# calls per profile (and per CUDA-event timing) of the forward rows'
# kernel, tilings and SDPA
FWD_REPS = 10
# calls timed of phase 2's plain versions: a plain call at t 2048
# launches ~10k small kernels; torch.profiler's processing of their events
# took minutes, so they are timed by CUDA events (_event_ms)
PLAIN_REPS = 1
PEAK_BYTES = 3.35e12
# the f32 flash backward at heads <= 128 runs on the tensor cores in
# 3xTF32: three TF32 products for each f32 one, at the dense TF32 rate
PEAK_TF32, TF32X3_PRODUCTS = 495e12, 3
GPT = dict(vocab_size=8192, d_model=512, n_layers=8, num_heads=8, max_len=512,
           compute_dtype="bfloat16")
BATCH, PROMPT, NEW = 8, 64, 128
# prefill logits with the flash kernel vs with the plain attention, same
# card and matmuls: the attention outputs differ by about a bf16 ulp and
# that difference passes through 8 bf16 layers
LOGIT_TOL = 5e-2
# backward kernels vs their plain version, max |dq/dk/dv - plain|:
# f32: CUDA-core FMAs without TF32, only the order of the sums differs;
# bf16: ds and p are rounded to bf16 before their products, and a score
# that differs in the last f32 bit can round ds to the neighbouring bf16
# value, summed in another order; so the bound scales with max |ref|
BWD_TOL_F32 = 2e-5
BWD_REL_BF16 = 2e-2
TRAIN = dict(vocab_size=8192, d_model=512, n_layers=8, num_heads=8,
             max_len=1024, compute_dtype="bfloat16")
TRAIN_BATCH, TRAIN_STEPS = 16, 20
# phase 4's f32 step: the training width in f32 (the dtype of
# examples/train_gpt.py --smoke), so that every attention call is [128,
# 1024, 64] f32 causal and the backward runs the 3xTF32 kernels
F32_TRAIN = dict(TRAIN, compute_dtype="float32")
# one f32 step, kernels vs plain versions on the card: the loss relative
# to itself and each gradient's worst relative L2. On the H100 the step
# read 1.0e-7 and 1.4e-6 through the 3xTF32 backward, and 1.0e-7 and
# 1.0e-6 through the SIMT kernels it replaced (the f32 noise floor: the
# same step, the same forward kernel); the bounds are ten times those
F32_TRAIN_LOSS_REL, F32_TRAIN_GRAD_REL = 1e-6, 1e-5
# the flash kernels' wide heads (phase 2, forward and backward): the
# shape their times are recorded at, [32, 1024, 256] causal, a ragged head
# of 512 and one of 1024 (t 200: no multiple of their row and key tiles)
WIDE_HEAD = (256, 32, 1024)
WIDE_HEAD_CASES = {dtype: [(dtype, WIDE_HEAD[0], WIDE_HEAD[1], WIDE_HEAD[2],
                            WIDE_HEAD[2], True), (dtype, 512, 8, 200, 200, True),
                           (dtype, 1024, 4, 200, 200, True)]
                   for dtype in ("bfloat16", "float32")}
# the bf16 wide kernels at d 512, forward and backward, at the same bound
# as WIDE_HEAD's
WIDE_512_CASES = [("bfloat16", 512, 16, 1024, 1024, True)]
# the f32 wide kernels at d 512 (flash_dq_kernel_wide_tf32x3,
# flash_dkv_kernel_wide_tf32x3; the forward flash_fwd_kernel_tf32x3), at
# the same bound as WIDE_HEAD's
WIDE_F32_512_CASES = [("float32", 512, 16, 1024, 1024, True)]
# the f32 wide kernels at d 1024 (flash_dq_kernel_wide_tf32x3<1024>,
# flash_dkv_kernel_wide_tf32x3<1024>; the forward flash_fwd_kernel_tf32x3),
# at the same bound by operations as the f32 rows of WIDE_HEAD and
# WIDE_F32_512_CASES (bh x d = 8192)
WIDE_F32_1024_CASES = [("float32", 1024, 8, 1024, 1024, True)]
# the bf16 wide kernels at d 1024 (flash_fwd_kernel_wide<1024, 32>,
# flash_dq_kernel_wide<1024, 32>, flash_dkv_kernel_wide<1024>; each of
# the 16-row tilings timed beside), forward and backward, at the same
# bound by bytes as WIDE_HEAD's (bh x d = 8192)
WIDE_1024_CASES = [("bfloat16", 1024, 8, 1024, 1024, True)]
# one step's loss and gradients with the kernels vs with the plain
# versions on the card: bf16 attention outputs and gradients that differ
# by bf16 roundings pass through 8 bf16 layers
TRAIN_LOSS_TOL, TRAIN_GRAD_REL = 1e-2, 2e-2
# phase 4's wide-head step: heads of 256 (Gemma-7B's head_dim), so that
# training runs the wide bf16 flash kernels; two blocks, held to the
# tolerances above
WIDE_TRAIN = dict(vocab_size=8192, d_model=1024, n_layers=2, num_heads=4,
                  max_len=1024, compute_dtype="bfloat16")
WIDE_TRAIN_BATCH = 8
# phase 4's wide step in f32 (the dtype of examples/train_gpt.py
# --smoke): every attention call [32, 1024, 256] f32 causal, the
# backward through the wide 3xTF32 kernels; held to F32_TRAIN's bounds
WIDE_F32_TRAIN = dict(WIDE_TRAIN, compute_dtype="float32")
# C3 (ROADMAP Queue C): the f32 forward and backward at scores of ±60
# and more (scale4_arrays), from an f64 forward and backward, at each head
# the kernels are built for (at 1024 the wide 3xTF32 backward after the
# 3xTF32 forward: its p must be rebuilt from the forward's own score
# bits); the CPU tests measure the JAX package's own f32 error on the same
# arrays
SCALE4_HEADS, SCALE4_BH, SCALE4_T = (64, 128, 256, 512, 1024), 2, 128
# C3: the JAX package's own f32 backward error (``_flash_fwd_impl`` and
# ``_flash_bwd_impl`` in interpret mode, one 128 x 128 block, causal) on
# ``scale4_arrays(d)``, from ``bwd_f64``, relative to max |ref|, for dq,
# dk and dv, measured on the CPU (tests/test_torch_flash_backward.py
# re-measures it). The reference's two passes compute the scores alike,
# so s - lse cancels their rounding; the port's f32 kernels take every
# score in the forward's order for that, and phase 2 fails where one of
# their errors passes twice these (ROADMAP C4)
REF_SCALE4_REL = {64: (3.4386e-06, 3.4765e-06, 1.3591e-06),
                  128: (4.8767e-06, 3.2174e-06, 1.7877e-06),
                  256: (1.0905e-05, 1.2654e-05, 2.6006e-06),
                  512: (8.4214e-06, 7.7507e-06, 4.6950e-06),
                  1024: (4.3930e-06, 4.1917e-06, 2.9249e-06)}
# the JAX package's own f32 forward error on the same arrays
# (``_flash_fwd_impl`` in interpret mode, one 128 x 128 block, causal),
# from ``fwd_f64``, relative to max |ref|, for o and lse, measured on the
# CPU (tests/test_torch_flash_backward.py re-measures it); phase 2 fails
# where the port's f32 forward passes twice these
REF_SCALE4_FWD_REL = {64: (2.7395e-06, 2.6566e-07),
                      128: (3.8382e-06, 3.5370e-07),
                      256: (9.1207e-06, 6.5213e-07),
                      512: (1.0374e-05, 6.3552e-07),
                      1024: (6.8522e-06, 5.2006e-07)}

# LSTM kernels vs their plain versions (phase 2b). f32: CUDA-core FMAs
# (no TF32) against cuBLAS f32, so only the order of the sums differs,
# carried through up to 128 steps of the recurrence (forward outputs are
# at most ~1 in size: an absolute bound; gradients relative to max
# |ref|). bf16: both sides round h, the streams and dg at the same
# points, but a product that differs in its last f32 bit can round to
# the neighbouring bf16 value, and the recurrence carries that on; so
# the bound is relative to max(1, max |ref|), as the flash backward's.
LSTM_TOL_F32, LSTM_BWD_REL_F32 = 5e-5, 1e-4
LSTM_REL_BF16 = 3e-2
LSTM_CASES = [  # (dtype, b, t, n); the training and serving shapes first
    ("bfloat16", 1024, 128, 512), ("float32", 32, 1, 512),
    ("bfloat16", 32, 1, 512), ("float32", 32, 128, 512),
    ("bfloat16", 8, 9, 128), ("float32", 8, 9, 128),
    ("bfloat16", 1024, 9, 128), ("float32", 1024, 9, 128),
    ("bfloat16", 32, 9, 1024), ("float32", 32, 9, 1024),
    ("bfloat16", 128, 128, 1024), ("float32", 8, 128, 1024),
    ("float32", 64, 64, 256),  # examples/train_char_rnn.py's f32 training
]
CHAR_VOCAB, CHAR_HIDDEN = 64, 512
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 32, 32, 128
# output with the kernels vs the plain versions (f32): the sums of the
# recurrent product in another order, through two layers and 32 steps
SERVE_OUT_TOL = 1e-5
CHAR_BATCH, CHAR_SEQ, CHAR_STEPS = 1024, 128, 20
# one bf16 step, kernels vs plain versions on the card: loss, and the
# relative L2 of each parameter's gradient (bf16 roundings of h and dg
# that differ, carried through 128 steps and two layers)
CHAR_LOSS_TOL, CHAR_GRAD_REL = 1e-2, 3e-2
# examples/train_char_rnn.py at full width (phase 6's f32 run): one
# GravesLSTM(256) and its output layer over the example corpus's 28
# characters, f32, batch 64, seq 64, Adam 0.01
EXAMPLE_VOCAB, EXAMPLE_HIDDEN, EXAMPLE_BATCH, EXAMPLE_SEQ = 28, 256, 64, 64
# one f32 step, kernels vs plain versions on the card: both sum the
# products in f32 (CUDA-core FMAs against cuBLAS without TF32), in other
# orders, through 64 steps: the loss relative to itself, each gradient's
# relative L2
EXAMPLE_LOSS_REL, EXAMPLE_GRAD_REL = 1e-4, 1e-4
# LeNet-MNIST (phase 7): the JAX package's benchmark batch and epoch
LENET_BATCH, LENET_BATCHES, LENET_STEPS, LENET_TEST = 2048, 8, 20, 10000
# an f32 copy of the net on the card vs on the CPU (64 examples): cuDNN
# and the CPU sum the convolutions and products in other orders, in f32
LENET_CHECK = 64
LENET_OUT_REL, LENET_GRAD_REL = 1e-4, 1e-3
# a gradient jumps where a ReLU input crosses 0 (or a max-pool window's
# two largest cells swap); with ~19,000 of them per LeNet example one can
# lie within reach of f32 rounding, the card and the CPU then round to
# either side, and their gradients part by the jump (one example of 64
# moved the whole gradient by 3e-2, PR 9). A smooth gradient moves in
# proportion to a change of the parameters, a jump does not shrink with
# it. So the gradient gate leaves out the examples whose f64 gradient
# moves by more than KINK_TOL (relative) when the parameters move by
# KINK_REL (relative: KINK_DRAWS random directions, each both ways), and
# needs LENET_MIN_KEPT of them
KINK_REL, KINK_TOL, KINK_DRAWS, LENET_MIN_KEPT = 1e-6, 1e-4, 2, 56
# MLP-Iris (phase 8): the JAX package's benchmark, its 150 rows tiled
IRIS_TILES, IRIS_BATCH, IRIS_STEPS = 256, 4096, 20
# the fit_scan rows of phases 6-8 (each a warm-up fit_scan and the best
# of two timed ones, ``best_of_fit_scan``): epochs per call, over the
# staged minibatches (2 of the char-RNN's, 8 of LeNet's, 9 of MLP-Iris's)
CHAR_SCAN_EPOCHS, LENET_SCAN_EPOCHS, IRIS_SCAN_EPOCHS = 10, 5, 5
# phase 9 (a): ResNet-50 through resnet50_benchmark at the JAX package's
# benchmark size (batch 128, 224 x 224, 1000 classes, bf16, nesterovs
# 0.1), 8 staged minibatches, 12 epochs per call
RESNET_BATCH, RESNET_IMAGE, RESNET_STEPS = 128, 224, 8
# phase 9 (b): a tiny ResNet in f32 on the card against the CPU
# (tests/test_zoo.py's size): outputs, score and one step
TINY_RESNET = dict(stages=(1, 1), widths=(8, 16), num_classes=4,
                   compute_dtype="float32", learning_rate=0.01)
TINY_RESNET_BATCH, TINY_RESNET_IMAGE, TINY_RESNET_REL = 8, 32, 1e-4
# phase 9 (d): new tokens of the gpt chain's greedy generate
GRAPH_NEW = 32


T0 = time.perf_counter()


def _say(msg: str, flush: bool = True) -> None:
    """A phase line, with the seconds since the smoke started."""
    print(f"{msg} [t {time.perf_counter() - T0:.1f} s]", flush=flush)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def _time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` timings by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# the one name of _device_times's result when torch.profiler kept no
# whole profile
EVENT_TIMED = "whole call, by CUDA events (torch.profiler kept no whole profile)"


def _event_ms(torch, fn, reps: int, warm: bool = False) -> float:
    """ms per call of ``fn`` by CUDA events around ``reps`` calls issued
    back to back (after one warm-up call if ``warm``): the card's time
    from the first launch to the last kernel's end, the host's gaps
    between launches included. Phases 2 and 2b time the plain versions
    so: torch.profiler's processing of their many small launches took
    most of phase 2's time."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# seconds of idle host time around the calls inside each profile, per
# attempt: the profiler keeps only device events whose timestamps, mapped
# to the host's clock, fall inside the profile; where that mapping is off
# by more than the margin, a profile can come back empty or keep only
# some of its device events
PROFILE_PADS = (0.02, 0.1, 0.5, 1.0, 2.0)


# the port's kernels as torch.profiler names them (bf16 and f32 alike) ->
# the names under which their wrappers count launches in kernels.LAUNCHES
PORT_KERNELS = {"flash_fwd_kernel": ("flash_fwd",),
                "flash_dq_kernel": ("flash_dq",),
                "flash_dkv_kernel": ("flash_dkv",),
                "lstm_fwd_kernel": ("lstm_fwd", "lstm_fwd_only"),
                "lstm_bwd_kernel": ("lstm_bwd",),
                "lstm_dw_kernel": ("lstm_dw",)}


def _port_kernel(name: str):
    """The ``PORT_KERNELS`` key of a profiler name, or None."""
    m = re.search(r"::(\w+?_kernel)(?:_f32|_wide_tf32x3|_wide|_tf32x3)?<", name)
    return m.group(1) if m and m.group(1) in PORT_KERNELS else None


class _Profile(dict):
    """Device ms per call by name; ``kept_share``: the share of the
    port's kernel launches whose events the profile kept (None where the
    calls launched none of them)."""
    kept_share = None


def _device_times(torch, fn, reps: int, warm: bool = True) -> dict:
    """Device ms per call of ``fn`` for each kernel, copy and fill name
    that torch.profiler saw in ``reps`` calls (after one warm-up call,
    unless ``warm`` is false: the caller has just run ``fn`` itself).
    Unlike the event time it leaves out the host's share. A profile may
    keep only some of its device events (on the chip's machine it often
    drops a few, and in a long process up to most of them), so a name's
    time per call is the mean of the events it kept times its launches
    per call. For the port's kernels those are known: each wrapper
    counts its launches in ``kernels.LAUNCHES``, so their times are
    exact however many events were dropped (several instantiations of
    one kernel share its count in proportion to their events). For any
    other name (library kernels, copies, fills) they are estimated as
    ``ceil(count / reps)``: exact for a name launched once per call; for
    one launched k times per call, it reads low by a launch for every
    ``reps`` of its events dropped. The result's ``kept_share`` is the
    share of the port's launches whose events were kept, the measure of
    how far a sum over other names may read low. A profile that recorded
    no device time at all, or no event of a port kernel that the calls
    launched, is taken again with a wider idle margin around the calls
    (``PROFILE_PADS``); if none was whole in that sense, the result is
    the CUDA-event time of ``reps`` calls issued back to back, per call,
    under the one name ``EVENT_TIMED`` (so a query for a kernel's own
    name then fails)."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch import kernels

    if warm:
        fn()
    torch.cuda.synchronize()
    for attempt, pad in enumerate(PROFILE_PADS):
        before = collections.Counter(kernels.LAUNCHES)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        ran = kernels.LAUNCHES - before
        seen = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        groups = collections.defaultdict(list)
        for e in seen:
            groups[_port_kernel(e.key)].append(e)
        unseen = sorted(key for key, names in PORT_KERNELS.items()
                        if key not in groups and any(ran[w] for w in names))
        if seen and not unseen:
            if attempt:
                print(f"chip_smoke: torch.profiler recorded no device time "
                      f"(or none of a port kernel that ran) with margins "
                      f"{PROFILE_PADS[:attempt]} s, and did with {pad} s",
                      flush=True)
            out, launched, kept = _Profile(), 0, 0
            for key, events in groups.items():
                if key is None:
                    for e in events:
                        out[e.key] = (e.self_device_time_total / 1e3 / e.count
                                      * -(-e.count // reps))
                    continue
                n = sum(ran[w] for w in PORT_KERNELS[key])
                c = sum(e.count for e in events)
                _check(n > 0, f"torch.profiler saw {key} in calls that "
                       f"launched none: {dict(ran)}")
                launched, kept = launched + n, kept + c
                for e in events:
                    out[e.key] = e.self_device_time_total / 1e3 / c * n / reps
            if launched:
                out.kept_share = kept / launched
            short = sum(e.count % reps > 0 for e in groups.get(None, ()))
            if short or kept < launched:
                print(f"chip_smoke: partial profile: kept {kept} events of "
                      f"{launched} port kernel launches; {short} other names "
                      f"kept a count of events that is not a multiple of "
                      f"{reps} calls", flush=True)
            return out
        if seen:
            print(f"chip_smoke: profile at margin {pad} s kept no event of "
                  f"{unseen}, launched {dict(ran)}", flush=True)
        else:
            print(f"chip_smoke: empty profile at margin {pad} s: "
                  f"{len(prof.events())} events, none on the device",
                  flush=True)
    ms = _event_ms(torch, fn, reps)
    print(f"chip_smoke: torch.profiler kept no whole profile in "
          f"{len(PROFILE_PADS)} attempts; {EVENT_TIMED}: {ms} ms", flush=True)
    return {EVENT_TIMED: ms}


def _sum_ms(per_name: dict, match: str = "") -> float:
    """The device ms of the names in ``per_name`` that contain ``match``
    (all of them by default); fails where there are none."""
    ms = sum(t for name, t in per_name.items() if match in name)
    _check(ms > 0, f"torch.profiler recorded no device time for {match!r}")
    return ms


def _device_ms(torch, fn, reps: int, match: str = "", warm: bool = True) -> float:
    """Device ms per call of ``fn``, of the names containing ``match``."""
    return _sum_ms(_device_times(torch, fn, reps, warm), match)


def _clocks() -> str:
    """The card's SM and memory clocks, power draw and temperature now."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,"
                        "power.draw,temperature.gpu", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _ptxas(report):
    """[(kernel, registers, spill bytes stored and loaded)] from
    ``-Xptxas -v``."""
    out, fn, spill = [], None, 0
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            fn, spill = ln.split("'")[1], 0
        elif "bytes spill stores" in ln:
            spill = int(ln.split("bytes spill stores")[0].split(",")[-1]) \
                + int(ln.split("bytes spill loads")[0].split(",")[-1])
        elif "Used " in ln and fn is not None:
            out.append((fn, int(ln.split("Used ")[1].split()[0]), spill))
            fn = None
    return out


def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def fwd_kernel_name(dtype: str, d: int) -> str:
    """The profiled name (up to its template arguments) of the forward
    kernel that a padded head of ``d`` runs in ``dtype``: the bf16 heads
    of 64 and 128 the mma.sync kernel, of 256, 512 and 1024 the wide
    mma.sync kernel; the f32 heads of every width the 3xTF32 kernel
    (scores on the CUDA cores, P V on the tensor cores)."""
    if dtype == "float32":
        return "flash_fwd_kernel_tf32x3<"
    return "flash_fwd_kernel<" if d <= 128 else "flash_fwd_kernel_wide<"


def bwd_kernel_names(dtype: str, d: int) -> tuple:
    """The profiled names (up to their template arguments) of the two
    backward kernels that a padded head of ``d`` runs in ``dtype``, as
    ``fwd_kernel_name`` has the forward's: in bf16 the mma.sync kernels
    up to 128 and the wide ones at 256, 512 and 1024 (heads 129-1024); in
    f32 the 3xTF32 kernels up to 128 and the wide 3xTF32 ones at 256, 512
    and 1024 (heads 129-1024)."""
    if dtype == "bfloat16":
        suffix = "" if d <= 128 else "_wide"
    else:
        suffix = "_tf32x3" if d <= 128 else "_wide_tf32x3"
    return (f"flash_dq_kernel{suffix}<", f"flash_dkv_kernel{suffix}<")


def _live_pairs(tq, tk, causal):
    """The (q, k) pairs the causal mask leaves (all of them otherwise)."""
    offset = tk - tq
    return sum(min(tk, r + offset + 1) for r in range(tq)) if causal \
        else tq * tk


def _flash_bound(bh, tq, tk, d, causal, dtype, peak=None, products=1):
    """(bound_ms, bound_by): the work this input needs (the (q, k) pairs
    the causal mask leaves, at 4 d flops each, ``products`` times over)
    over the peak rate of its type (or ``peak``), or its bytes (q, k, v
    read once, o and lse written once) over the memory rate, whichever
    is larger."""
    flops = products * 4.0 * bh * d * _live_pairs(tq, tk, causal)
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * bh * d * (2 * tq + 2 * tk) + 4 * bh * tq
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _flash_bwd_bound(bh, tq, tk, d, causal, dtype, flops_per_pair, n_out,
                     peak=None):
    """(bound_ms, bound_by) of one backward kernel: ``flops_per_pair``
    per live (q, k) pair (6 d for dq: the s, dP and ds.k products; 8 d
    for dk/dv: s, dP, p^T.dO and ds^T.q) over the peak rate of its type
    (or ``peak``), or its bytes (q, k, v, dO read once, lse and delta
    once, ``n_out`` [.., d] outputs written once; dq, which computes
    delta, also reads O) over the memory rate."""
    flops = float(flops_per_pair) * bh * _live_pairs(tq, tk, causal)
    size = 2 if dtype == "bfloat16" else 4
    nbytes = size * bh * d * (2 * tq + 2 * tk) + 8 * bh * tq \
        + size * bh * d * (2 * tq if n_out == 1 else 2 * tk)
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _flash_bound_tf32x3(bh, tq, tk, d, causal):
    """(bound_ms, bound_by) of the f32 forward on the tensor cores in
    3xTF32: ``TF32X3_PRODUCTS`` TF32 flops for each of its 4 d f32 flops
    per live pair at the dense TF32 rate, or the bytes of
    ``_flash_bound``. The f32 forward takes its scores (2 d of the 4 d)
    on the CUDA cores, so it may not reach this bound; it may beat the
    f32 CUDA-core one (a share of it above 1 is not an error)."""
    return _flash_bound(bh, tq, tk, d, causal, "float32", PEAK_TF32, TF32X3_PRODUCTS)


def _flash_bwd_bound_tf32x3(bh, tq, tk, d, causal, flops_per_pair, n_out):
    """(bound_ms, bound_by) of one f32 backward kernel on the tensor
    cores in 3xTF32: ``TF32X3_PRODUCTS`` TF32 flops for each f32 flop at
    the dense TF32 rate, or the bytes of ``_flash_bwd_bound``. The f32
    kernels at heads <= 128 run so, and may beat the CUDA-core bound
    (a share of it above 1 is not an error)."""
    return _flash_bwd_bound(bh, tq, tk, d, causal, "float32",
                            TF32X3_PRODUCTS * flops_per_pair, n_out, PEAK_TF32)


def bwd_cases():
    """Phase 2's backward cases: (dtype, d, bh, tq, tk, causal)."""
    cases = []
    for dtype in ("bfloat16", "float32"):
        for d in (64, 128):
            for t, bh in ((64, 64), (1024, 128), (2048, 8)):
                for causal in (False, True):
                    cases.append((dtype, d, bh, t, t, causal))
            cases.append((dtype, d, 16, 512, 2048, True))  # tq < tk: offset
            # ragged last q- and k-tiles; an offset with a ragged diagonal;
            # few blocks with a long loop (the forward's ragged cases)
            cases += [(dtype, d, 8, 200, 200, False), (dtype, d, 8, 200, 200, True),
                      (dtype, d, 8, 72, 200, True), (dtype, d, 1, 2048, 2048, False),
                      (dtype, d, 1, 2048, 2048, True)]
        cases += WIDE_HEAD_CASES[dtype]
    return (cases + WIDE_512_CASES + WIDE_F32_512_CASES + WIDE_F32_1024_CASES
            + WIDE_1024_CASES)


def bwd_row(torch, F, kernels, flash, g, case, names):
    """One backward case: flash_dq and flash_dkv against the plain
    backward on the same (q, k, v, o, lse, dO) (made by ``g``), then the
    device times of the call, each kernel, the plain version and SDPA's
    backward beside the bounds. ``names``: the profiled names the call
    must run (``bwd_kernel_names``) and nothing else, or None to take
    whatever it runs (another checkout's, for a comparison); the row's
    ``kernels`` lists the names it ran."""
    dtype, d, bh, tq, tk, causal = case
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(bh, t, d, generator=g, device="cuda").to(dt)
                   for t in (tq, tk, tk, tq))
    o, lse = flash.flash_attention_fwd(q, k, v, causal)
    blocks = (flash._bwd_block(tq, 1024 if causal else 512),
              flash._bwd_block(tk, 1024))
    kernels.reset_launches()
    got = flash.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    tag = f"{dtype} d{d} bh{bh} tq{tq} tk{tk} causal={causal}"
    launched = dict(kernels.LAUNCHES)
    _check(launched == {flash.DQ_KERNEL: 1, flash.DKV_KERNEL: 1},
           f"flash bwd {tag}: one call launched {launched}")
    want = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                           *blocks)
    errs = {}

    def check(out, what):
        for name, a, b in zip(("dq", "dk", "dv"), out, want):
            _check(bool(torch.isfinite(a.float()).all()), f"finite {name} {what}")
            err = (a.float() - b.float()).abs().max().item()
            ref = b.float().abs().max().item()
            tol = BWD_TOL_F32 if dtype == "float32" else BWD_REL_BF16 * ref
            _check(err <= tol, f"flash bwd {name} {what} {tag}: err {err} > tol {tol}")
            errs[name] = max(err, errs.get(name, 0.0))

    check(got, "")
    kernel = lambda: flash.flash_attention_bwd(  # noqa: E731
        q, k, v, o, lse, do, causal)
    plain = lambda: flash.flash_attention_bwd_plain(  # noqa: E731
        q, k, v, o, lse, do, causal, *blocks)
    # SDPA's backward as a yardstick: its fwd+bwd device time less
    # its fwd time, on [1, bh, t, d] (is_causal where tq == tk, which
    # lets it pick its flash backend; an explicit mask otherwise)
    qs_, ks_, vs_ = (z[None].detach().requires_grad_() for z in (q, k, v))
    mask = None
    if causal and tq != tk:
        mask = torch.ones(tq, tk, dtype=torch.bool, device="cuda").tril(tk - tq)
    lib_kw = dict(attn_mask=mask, is_causal=causal and mask is None)
    lib_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs_, ks_, vs_, **lib_kw)
    lib_fb = lambda: torch.autograd.grad(  # noqa: E731
        lib_fwd(), (qs_, ks_, vs_), do[None])
    t_row = time.perf_counter()
    times = _device_times(torch, kernel, 10)
    # the whole call is one launch of each of the two kernels that
    # this dtype and head take
    _check(names is None
           or (all(any(n in name for n in names) for name in times)
               and all(any(n in name for name in times) for n in names)),
           f"flash_bwd call {tag} ran {sorted(times)}, not {names}")
    # flash_dq's two tilings at bf16 1024 (16 and 32 query rows a block)
    by_block_q = {}
    if dtype == "bfloat16" and d == 1024 and names is not None:
        for bq in (16, 32):
            tiled = lambda: flash._flash_bwd_cuda(  # noqa: E731
                q, k, v, o, lse, do, causal, bq)
            check(tiled(), f"block_q {bq}")
            by_block_q[bq] = _device_ms(torch, tiled, 10, "flash_dq_kernel")
    dq_bound = _flash_bwd_bound(bh, tq, tk, d, causal, dtype, 6 * d, 1)
    dkv_bound = _flash_bwd_bound(bh, tq, tk, d, causal, dtype, 8 * d, 2)
    row = dict(dtype=dtype, bh=bh, tq=tq, tk=tk, d=d, causal=causal,
               err_dq=errs["dq"], err_dk=errs["dk"], err_dv=errs["dv"],
               ms=_sum_ms(times),
               dq_kernel_only_ms=_sum_ms(times, "flash_dq_kernel"),
               dkv_kernel_only_ms=_sum_ms(times, "flash_dkv_kernel"),
               dq_kernel_only_ms_by_block_q=by_block_q,
               # the check above ran the plain version on these inputs
               plain_ms=_event_ms(torch, plain, PLAIN_REPS),
               library_ms=(_device_ms(torch, lib_fb, 10)
                           - _device_ms(torch, lib_fwd, 10)),
               dq_bound_ms=dq_bound[0], dq_bound_by=dq_bound[1],
               dkv_bound_ms=dkv_bound[0], dkv_bound_by=dkv_bound[1],
               call_ms=_time_ms(torch, kernel, 10),
               kernels=sorted(times))
    if dtype == "float32":
        # the bound on the tensor cores in 3xTF32 beside the f32 CUDA-core
        # one, and each kernel's share of both: the 3xTF32 kernels may beat
        # the CUDA-core bound (a share of it above 1 is no error)
        for key, flops, n_out in (("dq", 6 * d, 1), ("dkv", 8 * d, 2)):
            ms, by = _flash_bwd_bound_tf32x3(bh, tq, tk, d, causal, flops, n_out)
            row[f"{key}_bound_tf32x3_ms"], row[f"{key}_bound_tf32x3_by"] = ms, by
            row[f"{key}_bound_tf32x3_share"] = ms / row[f"{key}_kernel_only_ms"]
            row[f"{key}_bound_share"] = (row[f"{key}_bound_ms"]
                                         / row[f"{key}_kernel_only_ms"])
    row["row_s"] = time.perf_counter() - t_row
    return row


def phase_bwd_kernels(torch, F, kernels, flash):
    """Phase 2, backward: flash_dq and flash_dkv against the plain
    backward on the same (q, k, v, o, lse, dO), each call running the
    two kernels of ``bwd_kernel_names``."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(4321)
    for case in bwd_cases():
        row = bwd_row(torch, F, kernels, flash, g, case,
                      bwd_kernel_names(case[0], case[1]))
        print("flash_bwd " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def scale4_arrays(np, d):
    """C3's inputs at a head of ``d``: q, k, v and dO [SCALE4_BH,
    SCALE4_T, d] f32, 4 x standard normal from the numpy seed 4000 + d
    (scores of ±60 and more). The CPU tests draw the same arrays for the
    JAX package's own f32 error."""
    rng = np.random.default_rng(4000 + d)
    return [(4.0 * rng.standard_normal((SCALE4_BH, SCALE4_T, d))).astype(np.float32)
            for _ in range(4)]


def bwd_f64(torch, q, k, v, do, causal):
    """(dq, dk, dv) in f64 of o = softmax(qs k^T) v on [bh, t, d] inputs
    (qs = q times 1/sqrt(d) rounded to f32, the port's pre-scale factor),
    dense: C3's reference, on any device."""
    q, k, v, do = (x.double() for x in (q, k, v, do))
    tq, tk, d = q.shape[1], k.shape[1], q.shape[2]
    c = torch.tensor(1.0 / d ** 0.5, dtype=torch.float32).item()
    qs = q * c
    s = qs @ k.transpose(1, 2)
    if causal:
        rows = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        s = s.masked_fill(rows < torch.arange(tk, device=q.device)[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    ds = p * (do @ v.transpose(1, 2) - (do * (p @ v)).sum(-1, keepdim=True))
    return c * (ds @ k), ds.transpose(1, 2) @ qs, p.transpose(1, 2) @ do


def fwd_f64(torch, q, k, v, causal):
    """(o, lse [bh, tq, 1]) in f64 of softmax(qs k^T) v on [bh, t, d]
    inputs (qs as ``bwd_f64``'s), dense: the forward's reference at
    scale 4, on any device."""
    q, k, v = (x.double() for x in (q, k, v))
    tq, tk, d = q.shape[1], k.shape[1], q.shape[2]
    s = (q * torch.tensor(1.0 / d ** 0.5, dtype=torch.float32).item()) @ k.transpose(1, 2)
    if causal:
        rows = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        s = s.masked_fill(rows < torch.arange(tk, device=q.device)[None], float("-inf"))
    return torch.softmax(s, dim=-1) @ v, torch.logsumexp(s, dim=-1, keepdim=True)


def rel_errors(got, ref):
    """max |got - ref| / max |ref| of each output, as floats."""
    return [((a.double() - r).abs().max() / r.abs().max()).item()
            for a, r in zip(got, ref)]


def scale4_row(torch, np, flash, d):
    """C3 and C4 at a head of ``d``, on ``scale4_arrays`` (causal): the
    errors from ``fwd_f64`` of the port's f32 forward (o, lse), and from
    ``bwd_f64`` of its f32 backward after it (dq, dk, dv) and of the
    plain f32 backward on the same o and lse, relative to max |ref|,
    each beside its ratio to the JAX package's own error
    (``REF_SCALE4_FWD_REL``, ``REF_SCALE4_REL``)."""
    q, k, v, do = (torch.tensor(a, device="cuda") for a in scale4_arrays(np, d))
    o, lse = flash.flash_attention_fwd(q, k, v, True)
    fwd = rel_errors((o, lse), fwd_f64(torch, q, k, v, True))
    ref = bwd_f64(torch, q, k, v, do, True)
    bwd = rel_errors(flash.flash_attention_bwd(q, k, v, o, lse, do, True), ref)
    return dict(d=d, bh=SCALE4_BH, t=SCALE4_T, causal=True, forward=fwd,
                forward_ratio=[e / r for e, r in zip(fwd, REF_SCALE4_FWD_REL[d])],
                kernels=bwd, ratio=[e / r for e, r in zip(bwd, REF_SCALE4_REL[d])],
                plain=rel_errors(flash.flash_attention_bwd_plain(
                    q, k, v, o, lse, do, True), ref))


def scale4_gate(row):
    """Fails where the port's f32 forward or backward on the scale-4
    arrays passes twice the JAX package's own error (a ratio above 2)."""
    _check(max(row["forward_ratio"] + row["ratio"]) <= 2,
           f"flash_bwd_scale4 d {row['d']}: forward {row['forward']} (ratios "
           f"{row['forward_ratio']}), backward {row['kernels']} (ratios "
           f"{row['ratio']}) pass twice the reference's f32 error")


def phase_scale4(torch, np, flash):
    """Phase 2, C3 and C4: ``scale4_row`` at each head the f32 kernels
    are built for (``SCALE4_HEADS``), printed as ``flash_bwd_scale4``
    lines and gated by ``scale4_gate`` (``scripts/flash_bwd_rows.py``
    prints the rows of another checkout's port, ungated)."""
    rows = []
    for d in SCALE4_HEADS:
        row = scale4_row(torch, np, flash, d)
        print("flash_bwd_scale4 " + json.dumps(row), flush=True)
        rows.append(row)
    for row in rows:
        scale4_gate(row)
    return rows


def fwd_cases():
    """Phase 2's forward cases: (dtype, d, bh, tq, tk, causal)."""
    cases = []
    for dtype in ("bfloat16", "float32"):
        for d in (64, 128):
            # (64, 64) is the prefill shape, (1024, 128) the training one
            for t, bh in ((64, 64), (512, 16), (1024, 128), (2048, 8)):
                for causal in (False, True):
                    cases.append((dtype, d, bh, t, t, causal))
            cases.append((dtype, d, 16, 512, 2048, True))  # tq < tk: offset
            # ragged last q- and k-tiles; an offset with a ragged diagonal;
            # few blocks with a long key loop
            cases += [(dtype, d, 8, 200, 200, False), (dtype, d, 8, 200, 200, True),
                      (dtype, d, 8, 72, 200, True), (dtype, d, 1, 2048, 2048, False),
                      (dtype, d, 1, 2048, 2048, True)]
        cases += WIDE_HEAD_CASES[dtype]
    return (cases + WIDE_512_CASES + WIDE_F32_512_CASES + WIDE_F32_1024_CASES
            + WIDE_1024_CASES)


def fwd_row(torch, F, flash, g, case, kernel):
    """One forward case: the wrapper's output against the plain version
    on the same inputs (made by ``g``), then the device times of the
    wrapper, the plain version and SDPA beside the bound, and of each
    tiling the kernel offers at this head. ``kernel``: the profiled name
    the call must run and nothing else, or None to take whatever it
    runs (another checkout's, for a comparison, whose tilings are not
    known, so none is timed); the row's ``kernels`` lists the names it
    ran."""
    dtype, d, bh, tq, tk, causal = case
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(bh, t, d, generator=g, device="cuda").to(dt)
               for t in (tq, tk, tk))
    op, lp = flash.flash_attention_fwd_plain(q, k, v, causal)
    tol_o, tol_l = TOL[dtype]
    tag = f"{dtype} d{d} bh{bh} tq{tq} tk{tk} causal={causal}"

    def errors(o, lse, what):
        torch.cuda.synchronize()
        _check(bool(torch.isfinite(o.float()).all()), f"finite o {what} {tag}")
        err_o = (o.float() - op.float()).abs().max().item()
        err_l = (lse - lp).abs().max().item()
        _check(err_o <= tol_o and err_l <= tol_l,
               f"flash {what} {tag}: o err {err_o} (tol {tol_o}), "
               f"lse err {err_l} (tol {tol_l})")
        return err_o, err_l

    err_o, err_l = errors(*flash.flash_attention_fwd(q, k, v, causal), "")
    # SDPA as a yardstick, on [1, bh, t, d]: is_causal where tq == tk
    # (which lets it pick its flash backend), an explicit mask otherwise
    mask = None
    if causal and tq != tk:
        mask = torch.ones(tq, tk, dtype=torch.bool, device="cuda").tril(tk - tq)
    run = lambda: flash.flash_attention_fwd(q, k, v, causal)  # noqa: E731
    plain = lambda: flash.flash_attention_fwd_plain(q, k, v, causal)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[None], k[None], v[None], attn_mask=mask,
        is_causal=causal and mask is None)
    bound_ms, bound_by = _flash_bound(bh, tq, tk, d, causal, dtype)
    t_row = time.perf_counter()
    times = _device_times(torch, run, FWD_REPS)
    # the whole call is one launch of the kernel (q is scaled inside),
    # the one this dtype and head take
    _check(kernel is None or all(kernel in name for name in times),
           f"flash_fwd call {tag} ran more than its kernel {kernel}: "
           f"{sorted(times)}")
    by_block_q = {}
    # the two tilings of the bf16 mma kernel (d <= 128) and of the wide
    # one and the f32 one at 1024
    tilings = {64: (64, 128), 128: (64, 128), 1024: (16, 32)}.get(d, ())
    if dtype == "float32" and d != 1024:
        tilings = ()
    if tq > 64 and kernel is not None:
        for bq in tilings:
            tiled = lambda: flash._flash_fwd_cuda(q, k, v, causal, bq)  # noqa: E731
            errors(*tiled(), f"block_q {bq}")
            by_block_q[bq] = _device_ms(torch, tiled, FWD_REPS, "flash_fwd_kernel")
    row = dict(dtype=dtype, bh=bh, tq=tq, tk=tk, d=d, causal=causal,
               err_o=err_o, err_lse=err_l,
               ms=_sum_ms(times),
               kernel_only_ms=_sum_ms(times, "flash_fwd_kernel"),
               kernel_only_ms_by_block_q=by_block_q,
               # the check above ran the plain version on these inputs
               plain_ms=_event_ms(torch, plain, PLAIN_REPS),
               library_ms=_device_ms(torch, library, FWD_REPS),
               bound_ms=bound_ms, bound_by=bound_by,
               call_ms=_time_ms(torch, run, FWD_REPS),
               kernels=sorted(times))
    row["row_s"] = time.perf_counter() - t_row
    if dtype == "float32":
        # the bound on the tensor cores in 3xTF32 beside the f32 CUDA-core
        # one (``bound_ms``), and the kernel's share of both, as the f32
        # backward rows have them
        ms, by = _flash_bound_tf32x3(bh, tq, tk, d, causal)
        row |= dict(bound_tf32x3_ms=ms, bound_tf32x3_by=by,
                    bound_tf32x3_share=ms / row["kernel_only_ms"],
                    bound_share=bound_ms / row["kernel_only_ms"])
    return row


def phase_kernels(torch, F, flash):
    """Phase 2: the flash kernel against its plain version."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(1234)
    for case in fwd_cases():
        row = fwd_row(torch, F, flash, g, case, fwd_kernel_name(case[0], case[1]))
        print("flash_fwd " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


@contextlib.contextmanager
def _plain_attention(torch, flash, module):
    """Swap the attention of ``module``'s layers (``nn/layers/transformer``'s
    blocks, or ``nn/layers/attention``'s ``AttentionLayer``) for the flash
    kernels' plain versions on the same card tensors, forward and
    backward, with the blocks the wrapper would use (the comparisons of
    phases 3, 4 and 10 only)."""
    saved = module.dispatch_attention

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal):
            tq, tk = q.shape[1], k.shape[1]
            bq = flash._pick_block(tq, 1024 if causal else 512)
            bk = flash._pick_block(tk, 1024)
            o, lse = flash.flash_attention_fwd_plain(q, k, v, causal, bq, bk)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.causal = causal
            ctx.blocks = (flash._bwd_block(tq, bq), flash._bwd_block(tk, bk))
            return o

        @staticmethod
        def backward(ctx, grad):
            q, k, v, o, lse = ctx.saved_tensors
            return (*flash.flash_attention_bwd_plain(
                q, k, v, o, lse, grad, ctx.causal, *ctx.blocks), None)

    def plain(q, k, v, causal, mask=None):
        b, t, h, d = q.shape
        fold = lambda z: z.transpose(1, 2).reshape(b * h, t, d)  # noqa: E731
        o = PlainFlash.apply(fold(q), fold(k), fold(v), causal)
        return o.reshape(b, h, t, d).transpose(1, 2)

    module.dispatch_attention = plain
    try:
        yield
    finally:
        module.dispatch_attention = saved


def _random_params(net, seed: int):
    """Weights for ``net`` from a numpy seed, in the port's layout."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tree = {}
    for layer, params in net.params.items():
        tree[layer] = {}
        for name, t in params.items():
            shape = tuple(t.shape)
            if name.endswith("_g"):
                a = np.ones(shape)
            elif len(shape) == 1:
                a = 0.02 * rng.standard_normal(shape)
            else:
                a = rng.standard_normal(shape) * (2.0 / sum(shape)) ** 0.5
            tree[layer][name] = a.astype(np.float32)
    return tree


def phase_gpt(torch, np, kernels, flash):
    """Phase 3: the slice at full width; returns (launches, metrics)."""
    from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
    from deeplearning4j_tpu_torch.nn import generate as gen_mod
    from deeplearning4j_tpu_torch.nn.layers import transformer
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    net = gpt(**GPT).init()
    params_from_numpy(net, _random_params(net, seed=7))
    prompts = np.random.default_rng(8).integers(0, GPT["vocab_size"],
                                                (BATCH, PROMPT))

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = net.generate(prompts, NEW)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    _check(launches.get(flash.KERNEL, 0) > 0,
           f"the flash kernel never launched on the generate path: {launches}")

    _check(out.shape == (BATCH, PROMPT + NEW), f"output shape {out.shape}")
    _check(bool((out[:, :PROMPT] == prompts).all()), "prompt echoed")
    _check(bool(((out >= 0) & (out < GPT["vocab_size"])).all()), "token range")
    eager = gen_mod.generate_eager(net, prompts, NEW)
    _check(bool((out == eager).all()), "generate == generate_eager")

    g = gen_mod.build_generator(net)
    ids = torch.as_tensor(prompts, device="cuda")
    lengths = torch.full((BATCH,), PROMPT, device="cuda")

    def prefill():
        return g.prefill(net.cast_params(net.params), ids, lengths,
                         PROMPT + NEW)

    caches, logits = prefill()
    with _plain_attention(torch, flash, transformer):
        caches_p, logits_p = prefill()
    _check(bool(torch.isfinite(logits).all()), "finite prefill logits")
    _check(all(bool(torch.isfinite(c[n].float()).all())
               for c in caches for n in ("k", "v")), "finite caches")
    logit_err = (logits - logits_p).abs().max().item()
    _check(logit_err <= LOGIT_TOL,
           f"prefill logits kernel vs plain attention: {logit_err} > {LOGIT_TOL}")
    _check(bool((logits.argmax(-1).cpu().numpy() == out[:, PROMPT]).all()),
           "first token is the prefill argmax")

    prefill_ms = _time_ms(torch, prefill, 10)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.generate(prompts, NEW)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    gen_s = statistics.median(times)
    per_gen = _device_times(torch, lambda: net.generate(prompts, NEW), 1)
    gen_device_ms = _sum_ms(per_gen)
    metrics = dict(generate_device_ms=gen_device_ms,
                   device_busy_share=gen_device_ms / (gen_s * 1e3),
                   profile_kept_share=per_gen.kept_share,
                   first_generate_s=first_s, generate_s=gen_s,
                   tokens_per_s=BATCH * NEW / gen_s, prefill_ms=prefill_ms,
                   decode_ms_per_token=(gen_s * 1e3 - prefill_ms) / (NEW - 1),
                   prefill_logit_max_abs_diff_vs_plain=logit_err,
                   max_abs_logit=logits.abs().max().item())
    print("gpt " + json.dumps(metrics), flush=True)
    return launches, metrics


def phase_train(torch, np, kernels, flash):
    """Phase 4: training at full width; returns (launches, metrics)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.zoo.transformer import (
        gpt,
        gpt_train_flops_per_token,
    )
    from deeplearning4j_tpu_torch.nn.layers import transformer
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    t = TRAIN["max_len"]
    net = gpt(**TRAIN).init()
    params_from_numpy(net, _random_params(net, seed=11))
    ids = np.random.default_rng(12).integers(0, TRAIN["vocab_size"],
                                             (TRAIN_BATCH, t))
    ds = DataSet(ids.astype(np.float32),
                 np.roll(ids, -1, axis=1).astype(np.float32))

    # one step's loss and gradients, kernels vs plain versions (eval
    # mode: dropout is 0 in this configuration anyway)
    grads, loss = net.gradient_and_score(ds)
    with _plain_attention(torch, flash, transformer):
        grads_p, loss_p = net.gradient_and_score(ds)
    _check(abs(loss - loss_p) <= TRAIN_LOSS_TOL,
           f"train loss kernels {loss} vs plain {loss_p}")
    worst = 0.0
    for layer, gl in grads.items():
        for name, g in gl.items():
            gp = grads_p[layer][name]
            _check(bool(torch.isfinite(g).all()), f"finite grad {layer}/{name}")
            rel = ((g - gp).norm() / gp.norm().clamp_min(1e-30)).item()
            _check(rel <= TRAIN_GRAD_REL,
                   f"grad {layer}/{name} kernels vs plain: rel L2 {rel}")
            worst = max(worst, rel)
    del grads, grads_p

    torch.cuda.synchronize()
    kernels.reset_launches()
    net.fit(ds)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for name in (flash.KERNEL, flash.DQ_KERNEL, flash.DKV_KERNEL):
        _check(launches.get(name, 0) == TRAIN["n_layers"],
               f"{name} launched {launches.get(name, 0)} times in one train "
               f"step, expected {TRAIN['n_layers']}: {launches}")

    losses, times = [net.score()], []
    for _ in range(TRAIN_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(net.score())
    _check(all(np.isfinite(losses)), f"finite losses {losses}")
    _check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    step_s = statistics.median(times[1:])  # steps 3..20
    per_step = _device_times(torch, lambda: net.fit(ds), 3)
    dev = {m: _sum_ms(per_step, m) for m in
           ("", "flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")}
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:12]
    tokens = TRAIN_BATCH * t
    flops = gpt_train_flops_per_token(TRAIN["vocab_size"], TRAIN["d_model"],
                                      TRAIN["n_layers"], t)
    torch.cuda.reset_peak_memory_stats()
    net.fit(ds)
    torch.cuda.synchronize()
    metrics = dict(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
                   mfu=tokens / step_s * flops / PEAK_FLOPS["bfloat16"],
                   step_device_ms=dev[""],
                   device_busy_share=dev[""] / (step_s * 1e3),
                   profile_kept_share=per_step.kept_share,
                   flash_fwd_ms_per_step=dev["flash_fwd_kernel"],
                   flash_dq_ms_per_step=dev["flash_dq_kernel"],
                   flash_dkv_ms_per_step=dev["flash_dkv_kernel"],
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   loss_first=losses[0], loss_last=losses[-1],
                   loss_vs_plain=abs(loss - loss_p),
                   grad_rel_l2_vs_plain_max=worst, losses=losses,
                   top_kernels_ms_per_step=[[k[:90], ms] for k, ms in top])
    print("train " + json.dumps(metrics), flush=True)
    del net
    metrics["fit_scan"] = _gpt_fit_scan(torch, np, kernels, flash)
    metrics["wide_head"] = phase_train_wide(torch, np, kernels, flash)
    metrics["f32"] = phase_train_f32(torch, np, kernels, flash)
    metrics["wide_f32"] = phase_train_f32(torch, np, kernels, flash, "train_wide_f32")
    return launches, metrics


def _gpt_fit_scan(torch, np, kernels, flash):
    """Phase 4's fit_scan row: the port's ``gpt_benchmark`` at its
    defaults (the training width: vocab 8192, d_model 512, 8 layers, seq
    1024, batch 16, bf16, Adam 3e-4, 4 staged minibatches of
    ``default_rng(0)`` ids, 12 epochs a call); each flash kernel
    launches once per block on every step."""
    from deeplearning4j_tpu_torch.models.zoo.transformer import (
        gpt_benchmark,
        gpt_train_flops_per_token,
    )

    def run():
        rec = {}
        rec["result"] = gpt_benchmark(PEAK_FLOPS["bfloat16"], record=rec)
        return rec

    t = TRAIN["max_len"]
    return fit_scan_row(
        torch, np, kernels, "train", run, TRAIN_BATCH * t,
        gpt_train_flops_per_token(TRAIN["vocab_size"], TRAIN["d_model"],
                                  TRAIN["n_layers"], t),
        PEAK_FLOPS["bfloat16"],
        {k: TRAIN["n_layers"] for k in (flash.KERNEL, flash.DQ_KERNEL,
                                        flash.DKV_KERNEL)})


def phase_train_wide(torch, np, kernels, flash):
    """Phase 4's wide-head step (``WIDE_TRAIN``, heads of 256): one
    ``gradient_and_score`` with the kernels against the same step with
    the plain versions on the card (``TRAIN_LOSS_TOL``,
    ``TRAIN_GRAD_REL``); each flash kernel launches once per block; the
    step's device time and the wide kernels' share of it."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
    from deeplearning4j_tpu_torch.nn.layers import transformer
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    t, layers = WIDE_TRAIN["max_len"], WIDE_TRAIN["n_layers"]
    net = gpt(**WIDE_TRAIN).init()
    params_from_numpy(net, _random_params(net, seed=13))
    ids = np.random.default_rng(14).integers(0, WIDE_TRAIN["vocab_size"],
                                             (WIDE_TRAIN_BATCH, t))
    ds = DataSet(ids.astype(np.float32),
                 np.roll(ids, -1, axis=1).astype(np.float32))
    torch.cuda.synchronize()
    kernels.reset_launches()
    grads, loss = net.gradient_and_score(ds)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for name in (flash.KERNEL, flash.DQ_KERNEL, flash.DKV_KERNEL):
        _check(launches.get(name, 0) == layers,
               f"{name} launched {launches.get(name, 0)} times in one wide-head "
               f"step, expected {layers}: {launches}")
    with _plain_attention(torch, flash, transformer):
        grads_p, loss_p = net.gradient_and_score(ds)
    _check(abs(loss - loss_p) <= TRAIN_LOSS_TOL,
           f"wide-head loss kernels {loss} vs plain {loss_p}")
    worst, at = _grad_rel(torch, grads, grads_p)
    _check(worst <= TRAIN_GRAD_REL,
           f"wide-head grad {at} kernels vs plain: rel L2 {worst}")
    del grads, grads_p
    per_step = _device_times(torch, lambda: net.gradient_and_score(ds), 3)
    wide = {m: _sum_ms(per_step, m) for m in (
        "flash_fwd_kernel_wide", "flash_dq_kernel_wide", "flash_dkv_kernel_wide")}
    step_ms = _sum_ms(per_step)
    metrics = dict(launches=launches, loss=loss, loss_vs_plain=abs(loss - loss_p),
                   grad_rel_l2_vs_plain_max=worst, grad_worst_at=at,
                   step_device_ms=step_ms, profile_kept_share=per_step.kept_share,
                   wide_kernels_ms_per_step=wide,
                   wide_kernels_share=sum(wide.values()) / step_ms,
                   shape=[WIDE_TRAIN_BATCH * WIDE_TRAIN["num_heads"], t,
                          WIDE_TRAIN["d_model"] // WIDE_TRAIN["num_heads"]])
    print("train_wide " + json.dumps(metrics), flush=True)
    return metrics


# phase 4's f32 steps: (configuration, batch, weight seed, id seed)
F32_STEPS = {"train_f32": (F32_TRAIN, TRAIN_BATCH, 15, 16),
             "train_wide_f32": (WIDE_F32_TRAIN, WIDE_TRAIN_BATCH, 13, 14)}


def f32_step(torch, np, kernels, flash, step="train_f32"):
    """One ``gradient_and_score`` of an f32 step of ``F32_STEPS``
    (``train_f32``: ``F32_TRAIN``; ``train_wide_f32``: ``WIDE_F32_TRAIN``,
    with the wide bf16 step's seeds; random weights and ids from numpy
    seeds, labels the ids rolled by one) through ``flash``'s kernels,
    then the same step with its plain versions on the card. Returns
    (net, ds, the kernels' step's launches, loss, plain loss, worst
    gradient rel L2, where); ``scripts/f32_train_step.py`` runs it on
    another checkout's port."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
    from deeplearning4j_tpu_torch.nn.layers import transformer
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    conf, batch, weight_seed, id_seed = F32_STEPS[step]
    t = conf["max_len"]
    net = gpt(**conf).init()
    params_from_numpy(net, _random_params(net, seed=weight_seed))
    ids = np.random.default_rng(id_seed).integers(0, conf["vocab_size"], (batch, t))
    ds = DataSet(ids.astype(np.float32),
                 np.roll(ids, -1, axis=1).astype(np.float32))
    torch.cuda.synchronize()
    kernels.reset_launches()
    grads, loss = net.gradient_and_score(ds)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    with _plain_attention(torch, flash, transformer):
        grads_p, loss_p = net.gradient_and_score(ds)
    worst, at = _grad_rel(torch, grads, grads_p)
    return net, ds, launches, loss, loss_p, worst, at


def phase_train_f32(torch, np, kernels, flash, step="train_f32"):
    """Phase 4's f32 steps (``f32_step``): ``train_f32``, the training
    width in f32 (every attention call [128, 1024, 64] f32 causal, the
    backward through the 3xTF32 kernels), and ``train_wide_f32``, the
    wide-head step in f32 (every attention call [32, 1024, 256] f32
    causal, the backward through the wide 3xTF32 kernels). Each flash
    kernel launches once per block, the step's forward runs only the
    kernel of ``fwd_kernel_name`` (``flash_fwd_kernel_tf32x3``) and its
    backward only those of ``bwd_kernel_names``; the loss and every
    gradient against the same step with the plain attention
    (``F32_TRAIN_LOSS_REL``, ``F32_TRAIN_GRAD_REL``); the step's device
    time, the flash kernels' ms per step and share of it are printed as
    a line named ``step``."""
    conf, batch = F32_STEPS[step][:2]
    t, layers, heads = conf["max_len"], conf["n_layers"], conf["num_heads"]
    d_head = conf["d_model"] // heads
    net, ds, launches, loss, loss_p, worst, at = f32_step(torch, np, kernels, flash, step)
    for name in (flash.KERNEL, flash.DQ_KERNEL, flash.DKV_KERNEL):
        _check(launches.get(name, 0) == layers,
               f"{name} launched {launches.get(name, 0)} times in one {step} "
               f"step, expected {layers}: {launches}")
    loss_rel = abs(loss - loss_p) / abs(loss_p)
    _check(loss_rel <= F32_TRAIN_LOSS_REL,
           f"{step} loss kernels {loss} vs plain {loss_p}: rel {loss_rel}")
    _check(worst <= F32_TRAIN_GRAD_REL,
           f"{step} grad {at} kernels vs plain: rel L2 {worst}")
    per_step = _device_times(torch, lambda: net.gradient_and_score(ds), 3)
    names = bwd_kernel_names("float32", d_head)
    ran = [n for n in per_step if "flash_dq_kernel" in n or "flash_dkv_kernel" in n]
    _check(all(any(k in n for k in names) for n in ran)
           and all(any(k in n for n in ran) for k in names),
           f"the {step} step's backward ran {ran}, not {names}")
    fwd_name = fwd_kernel_name("float32", d_head)
    ran_fwd = [n for n in per_step if "flash_fwd_kernel" in n]
    _check(ran_fwd and all(fwd_name in n for n in ran_fwd),
           f"the {step} step's forward ran {ran_fwd}, not {fwd_name}")
    step_ms = _sum_ms(per_step)
    flash_ms = {m: _sum_ms(per_step, m) for m in (
        "flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")}
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:12]
    metrics = dict(launches=launches, loss=loss, loss_rel_vs_plain=loss_rel,
                   grad_rel_l2_vs_plain_max=worst, grad_worst_at=at,
                   step_device_ms=step_ms, profile_kept_share=per_step.kept_share,
                   flash_ms_per_step=flash_ms,
                   flash_share={m: ms / step_ms for m, ms in flash_ms.items()},
                   backward_pair_share=(flash_ms["flash_dq_kernel"]
                                        + flash_ms["flash_dkv_kernel"]) / step_ms,
                   backward_kernels=sorted(ran), forward_kernels=sorted(ran_fwd),
                   shape=[batch * heads, t, d_head],
                   top_kernels_ms_per_step=[[k[:90], ms] for k, ms in top])
    print(f"{step} " + json.dumps(metrics), flush=True)
    return metrics


def _lstm_bounds(dtype, b, t, n):
    """{kernel: (bound_ms, bound_by)}: the recurrent product's flops
    (2 t b n 4n, the dh recurrence and dWr alike) over the peak rate of
    the type, or each kernel's own bytes (every input read once, every
    output written once) over the memory rate, whichever is larger."""
    s = 2 if dtype == "bfloat16" else 4
    seq = t * b * n * s            # one [t, b, n] stream
    w, carry, peep = 4 * n * n * s, b * n * (s + 4), 3 * n * 4
    nbytes = {
        "lstm_fwd_only": 4 * seq + w + carry + peep + seq + carry,
        "lstm_fwd": 4 * seq + w + carry + peep + 6 * seq,
        # five residuals, gout, h0, c0, dc_T in; dg, h_prev, dh0, dc0 out
        "lstm_bwd": 6 * seq + w + peep + carry + 4 * b * n + 5 * seq + 8 * b * n,
        "lstm_dw": 5 * seq + 16 * n * n + peep,
    }
    flops = 2.0 * t * b * n * 4 * n
    out = {}
    for name, nb in nbytes.items():
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nb / PEAK_BYTES * 1e3
        out[name] = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return out


def _lstm_check(what, dtype, got, want, forward):
    """max |got - want| within the stated tolerance; returns it."""
    _check(bool(got.float().isfinite().all()), f"finite {what}")
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    if dtype == "float32":
        tol = LSTM_TOL_F32 if forward else LSTM_BWD_REL_F32 * max(1.0, ref)
    else:
        tol = LSTM_REL_BF16 * max(1.0, ref)
    _check(err <= tol, f"{what}: err {err} > tol {tol}")
    return err


# the phases between the four stamps of a timed LSTM sweep per block and
# step, named for what they hold. lstm_fwd stamps after the barrier,
# after the last h chunk landed, after the product, after the cell and
# its stores: the copies and waits of every h chunk interleave with the
# products of the chunks before it, so "chunks_but_last" is the copies,
# waits and products of all chunks but the last, ending when the last
# one has landed, and "last_chunk" the last chunk's product (with the
# wait for the step's xg rows); the barrier wait runs from the previous
# step's last stamp to this step's first. lstm_bwd stamps at the same
# points of its step (dg chunks, then the gate chain and its stores;
# its barrier wait also holds what a block does between its arrival and
# its wait)
PHASE_NAMES = ("barrier_wait", "chunks_but_last", "last_chunk", "cell_stores")
BWD_PHASE_NAMES = ("barrier_wait", "chunks_but_last", "last_chunk", "chain_stores")
# the f32 sweep's step: the barrier wait (from its arrival), the sums of
# the batch group's partials of dh for its rows and units, the gate chain
# with its stores, and the product of its dg by its Wr columns with the
# stores of that partial for every unit's owner
F32_BWD_PHASE_NAMES = ("barrier_wait", "partial_sums", "chain_stores", "product_stores")


def _phase_breakdown(stamps, names):
    """Mean µs per step of each of the four phases ``names`` (the first
    the barrier wait, from the previous step's last stamp) and of the
    whole step (the sum of the four), over blocks and steps 1 .. t-1
    (each has a barrier before it), from stamps [blocks, t, 4] in ns
    (numpy), or [calls, blocks, t, 4] for several calls of one kernel
    (their means pooled; ``kernel_us`` the mean over calls). At t = 1
    there is no barrier: the phases are step 0's, the first of them from
    the kernel's entry (so it holds the loads the product waits for),
    and ``barrier_wait_us`` is None."""
    import numpy as np

    st = stamps.astype("float64") / 1e3
    st = st[None] if st.ndim == 3 else st
    _check(st.ndim == 4 and st.shape[3] == 4 and len(names) == 4,
           f"the timer needs 4 stamps per step and 4 names: {st.shape}, "
           f"{names}")
    if st.shape[2] > 1:
        spans = {names[0]: st[:, :, 1:, 0] - st[:, :, :-1, 3]}
        steps = st[:, :, 1:]
        spans["step"] = steps[..., 3] - st[:, :, :-1, 3]
    else:
        spans, steps = {}, st
        spans["step"] = st[..., 3] - st[..., 0]
    for k, name in enumerate(names[1:]):
        spans[name] = steps[..., k + 1] - steps[..., k]
    _check(all(v.min() >= 0 for v in spans.values()),
           "the stamps of a step are not in order")
    out = {f"{k}_us": float(v.mean()) for k, v in spans.items()}
    out.setdefault(f"{names[0]}_us", None)
    ticks = np.diff(np.unique(stamps))
    out.update(calls=int(st.shape[0]), blocks=int(st.shape[1]),
               steps=int(st.shape[2]),
               kernel_us=float((st[..., 3].max(axis=(1, 2))
                                - st[..., 0].min(axis=(1, 2))).mean()),
               # the least step of the card's globaltimer seen in the stamps
               timer_tick_ns=int(ticks.min()) if ticks.size else None)
    return out


# the f32 forward's timer (phase 2b): (dtype, b, t, n, with residuals, calls,
# Wr packed) at the serving shape (lstm_fwd_only, t 1: one step per call, so
# many calls), reading Wr and its packed copy (generate's), and at t 128
# (lstm_fwd)
F32_TIMER_CASES = (("float32", 32, 1, 512, False, 50, False),
                   ("float32", 32, 1, 512, False, 50, True),
                   ("float32", 32, 128, 512, True, 3, False))
# the f32 sweep's timer (phase 2b): (b, t, n) at phase 2b's f32 scan shape
# and at examples/train_char_rnn.py's training shape
F32_BWD_TIMER_CASES = ((32, 128, 512), (EXAMPLE_BATCH, EXAMPLE_SEQ, EXAMPLE_HIDDEN))


def phase_lstm_timer(torch, lk):
    """The per-step breakdowns of lstm_fwd's and lstm_bwd's bf16 sweeps at
    the training shape, from their timed instantiations (one call each
    after a warm-up), then the f32 forward's (``F32_TIMER_CASES``); each
    timed call's outputs against the untimed kernel's."""
    dtype, b, t, n = LSTM_CASES[0]
    _check(dtype == "bfloat16", "LSTM_CASES[0] is the bf16 training shape")
    g = torch.Generator(device="cuda").manual_seed(2025)
    dt = torch.bfloat16
    xg = torch.randn(t, b, 4 * n, generator=g, device="cuda").to(dt)
    wr = (torch.randn(n, 4 * n, generator=g, device="cuda") * n ** -0.5).to(dt)
    pe = tuple(torch.randn(n, generator=g, device="cuda") * 0.1 for _ in range(3))
    h0 = (torch.randn(b, n, generator=g, device="cuda") * 0.5).to(dt)
    c0 = torch.randn(b, n, generator=g, device="cuda") * 0.5
    lk.lstm_fwd_timed(xg, wr, *pe, h0, c0)
    hs, _, stamps = lk.lstm_fwd_timed(xg, wr, *pe, h0, c0)
    torch.cuda.synchronize()
    want, res = lk.lstm_fwd(xg, wr, *pe, h0, c0)
    _lstm_check(f"timed lstm_fwd h {dtype} b{b} t{t} n{n}", dtype, hs, want, True)
    out = dict(kernel=lk.FWD_KERNEL, dtype=dtype, b=b, t=t, n=n,
               **_phase_breakdown(stamps.cpu().numpy(), PHASE_NAMES))
    print("lstm_fwd_phases " + json.dumps(out), flush=True)

    gout = torch.randn(t, b, n, generator=g, device="cuda").to(dt)
    gcl = torch.randn(b, n, generator=g, device="cuda")
    lk.lstm_bwd_timed(res, wr, *pe, h0, c0, gout, gcl)
    *got, stamps = lk.lstm_bwd_timed(res, wr, *pe, h0, c0, gout, gcl)
    want = lk.lstm_bwd(res, wr, *pe, h0, c0, gout, gcl)
    torch.cuda.synchronize()
    out = dict(dtype=dtype, b=b, t=t, n=n,
               **_phase_breakdown(stamps.cpu().numpy(), BWD_PHASE_NAMES))
    print("lstm_bwd_phases " + json.dumps(out), flush=True)
    _check_bwd_equal(torch, got, want, dtype)
    for case in F32_BWD_TIMER_CASES:
        _f32_bwd_timer(torch, lk, g, *case)
    for case in F32_TIMER_CASES:
        _f32_fwd_timer(torch, lk, g, *case)


def _check_bwd_equal(torch, got, want, what):
    """The timed sweep's outputs equal the untimed kernels' bit for bit."""
    for name, a, w in zip(("dg", "dWr", "dwci", "dwcf", "dwco", "dh0", "dc0"),
                          got, want):
        _check(torch.equal(a, w), f"timed lstm_bwd {what} {name} differs from "
               f"lstm_bwd's: {(a.float() - w.float()).abs().max().item()}")


def _f32_bwd_timer(torch, lk, g, b, t, n):
    """The f32 sweep's step phases (``lstm_bwd_phases``) on the f32
    forward kernel's residuals: one timed call after a warm-up one, whose
    outputs must equal the untimed kernels' bit for bit."""
    xg = torch.randn(t, b, 4 * n, generator=g, device="cuda")
    wr = torch.randn(n, 4 * n, generator=g, device="cuda") * n ** -0.5
    pe = tuple(torch.randn(n, generator=g, device="cuda") * 0.1 for _ in range(3))
    h0 = torch.randn(b, n, generator=g, device="cuda") * 0.5
    c0 = torch.randn(b, n, generator=g, device="cuda") * 0.5
    _, res = lk.lstm_fwd(xg, wr, *pe, h0, c0)
    gout = torch.randn(t, b, n, generator=g, device="cuda")
    gcl = torch.randn(b, n, generator=g, device="cuda")
    args = (res, wr, *pe, h0, c0, gout, gcl)
    lk.lstm_bwd_timed(*args)
    *got, stamps = lk.lstm_bwd_timed(*args)
    want = lk.lstm_bwd(*args)
    torch.cuda.synchronize()
    tag = f"float32 b{b} t{t} n{n}"
    _check_bwd_equal(torch, got, want, tag)
    out = dict(dtype="float32", b=b, t=t, n=n,
               **_phase_breakdown(stamps.cpu().numpy(), F32_BWD_PHASE_NAMES))
    print("lstm_bwd_phases " + json.dumps(out), flush=True)


def _f32_fwd_timer(torch, lk, g, dtype, b, t, n, with_residuals, calls,
                   packed):
    """The f32 forward's step phases (``lstm_fwd_phases``): ``calls``
    timed calls after a warm-up one, pooled, reading Wr or (``packed``)
    ``pack_wr``'s copy; each call's outputs must equal the untimed
    kernel's on Wr bit for bit."""
    xg = torch.randn(t, b, 4 * n, generator=g, device="cuda")
    wr = torch.randn(n, 4 * n, generator=g, device="cuda") * n ** -0.5
    pe = tuple(torch.randn(n, generator=g, device="cuda") * 0.1 for _ in range(3))
    h0 = torch.randn(b, n, generator=g, device="cuda") * 0.5
    c0 = torch.randn(b, n, generator=g, device="cuda") * 0.5
    args = (xg, wr, *pe, h0, c0)
    want = lk.lstm_fwd(*args, with_residuals=with_residuals)
    kw = dict(with_residuals=with_residuals,
              wr_packed=lk.pack_wr(wr, b) if packed else None)
    lk.lstm_fwd_timed(*args, **kw)
    stamps = []
    for _ in range(calls):
        hs, rest, st = lk.lstm_fwd_timed(*args, **kw)
        stamps.append(st)
    torch.cuda.synchronize()
    name = lk.FWD_KERNEL if with_residuals else lk.FWD_ONLY_KERNEL
    for a, w in zip((hs, *rest), (want[0], *want[1])):
        _check(torch.equal(a, w), f"timed {name} {dtype} b{b} t{t} n{n} differs "
               f"from the untimed kernel: {(a - w).abs().max().item()}")
    out = dict(kernel=name, dtype=dtype, b=b, t=t, n=n, wr_packed=packed,
               **_phase_breakdown(torch.stack(stamps).cpu().numpy(), PHASE_NAMES))
    print("lstm_fwd_phases " + json.dumps(out), flush=True)


def phase_lstm_kernels(torch, lk):
    """Phase 2b: the LSTM kernels against their plain versions."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(2024)
    for dtype, b, t, n in LSTM_CASES:
        dt = getattr(torch, dtype)

        def r(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale
        xg, wr = r(t, b, 4 * n).to(dt), r(n, 4 * n, scale=n ** -0.5).to(dt)
        pe = tuple(r(n, scale=0.1) for _ in range(3))
        h0, c0 = r(b, n, scale=0.5).to(dt), r(b, n, scale=0.5)
        gout, gcl = r(t, b, n).to(dt), r(b, n)
        tag = f"{dtype} b{b} t{t} n{n}"

        fo = lk.lstm_fwd(xg, wr, *pe, h0, c0, with_residuals=False)
        hs, res = lk.lstm_fwd(xg, wr, *pe, h0, c0)
        bwd = lk.lstm_bwd(res, wr, *pe, h0, c0, gout, gcl)
        torch.cuda.synchronize()
        fo_p = lk.lstm_fwd_plain(xg, wr, *pe, h0, c0, with_residuals=False)
        hs_p, res_p = lk.lstm_fwd_plain(xg, wr, *pe, h0, c0)
        bwd_p = lk.lstm_bwd_plain(res, wr, *pe, h0, c0, gout, gcl)
        err_fo = max(_lstm_check(f"lstm_fwd_only {nm} {tag}", dtype, a, p, True)
                     for nm, a, p in zip(("h", "h_T", "c_T"),
                                         (fo[0], *fo[1]), (fo_p[0], *fo_p[1])))
        err_fwd = max(_lstm_check(f"lstm_fwd {nm} {tag}", dtype, a, p, True)
                      for nm, a, p in zip(("h", "i", "f", "o", "blk", "c"),
                                          (hs, *res), (hs_p, *res_p)))
        errs_bwd = {nm: _lstm_check(f"lstm_bwd {nm} {tag}", dtype, a, p, False)
                    for nm, a, p in zip(("dg", "dWr", "dwci", "dwcf", "dwco",
                                         "dh0", "dc0"), bwd, bwd_p)}

        run_fo = lambda: lk.lstm_fwd(xg, wr, *pe, h0, c0,  # noqa: E731
                                     with_residuals=False)
        run_fwd = lambda: lk.lstm_fwd(xg, wr, *pe, h0, c0)  # noqa: E731
        run_bwd = lambda: lk.lstm_bwd(res, wr, *pe, h0, c0, gout, gcl)  # noqa: E731
        plain_fo = lambda: lk.lstm_fwd_plain(  # noqa: E731
            xg, wr, *pe, h0, c0, with_residuals=False)
        plain_fwd = lambda: lk.lstm_fwd_plain(xg, wr, *pe, h0, c0)  # noqa: E731
        plain_bwd = lambda: lk.lstm_bwd_plain(  # noqa: E731
            res, wr, *pe, h0, c0, gout, gcl)
        # yardstick: nn.LSTM at the same b, n, t and dtype, input size 16
        # (its input product is left small), no peepholes
        ref_lstm = torch.nn.LSTM(16, n).to("cuda", dt)
        xs = r(t, b, 16).to(dt)
        hc = (h0[None].contiguous(), c0.to(dt)[None].contiguous())
        go = r(t, b, n).to(dt)

        def lib_fwd():
            with torch.no_grad():
                return ref_lstm(xs, hc)

        def lib_fb():
            out, _ = ref_lstm(xs, hc)
            return torch.autograd.grad(out, list(ref_lstm.parameters()), go)

        reps = 5 if t * b * n >= 1 << 24 else 20
        # the f32 forward-only kernel reading generate's packed Wr
        packed = lk.pack_wr(wr, b)
        if packed is not None:
            fo_pk = lk.lstm_fwd(xg, wr, *pe, h0, c0, with_residuals=False,
                                wr_packed=packed)
            _check(all(torch.equal(a, p) for a, p in zip(
                (fo_pk[0], *fo_pk[1]), (fo[0], *fo[1]))),
                f"lstm_fwd_only {tag}: packed Wr differs from Wr")
            t_fo_pk = _device_times(torch, lambda: lk.lstm_fwd(  # noqa: E731
                xg, wr, *pe, h0, c0, with_residuals=False, wr_packed=packed),
                reps)
        t_fo = _device_times(torch, run_fo, reps)
        t_fwd = _device_times(torch, run_fwd, reps)
        t_bwd = _device_times(torch, run_bwd, reps)
        lib_f = _device_ms(torch, lib_fwd, reps)
        bounds = _lstm_bounds(dtype, b, t, n)
        row = dict(
            dtype=dtype, b=b, t=t, n=n, err_fwd_only=err_fo, err_fwd=err_fwd,
            err_bwd=errs_bwd,
            fwd_only_ms=_sum_ms(t_fo, "lstm_fwd_kernel"),
            fwd_only_packed_ms=(_sum_ms(t_fo_pk, "lstm_fwd_kernel")
                                if packed is not None else None),
            fwd_only_call_device_ms=_sum_ms(t_fo),
            fwd_ms=_sum_ms(t_fwd, "lstm_fwd_kernel"),
            fwd_call_device_ms=_sum_ms(t_fwd),
            bwd_ms=_sum_ms(t_bwd, "lstm_bwd_kernel"),
            dw_ms=_sum_ms(t_bwd, "lstm_dw_kernel"),
            backward_ms=_sum_ms(t_bwd),
            plain_fwd_only_ms=_event_ms(torch, plain_fo, 2, warm=True),
            plain_fwd_ms=_event_ms(torch, plain_fwd, 2, warm=True),
            plain_bwd_ms=_event_ms(torch, plain_bwd, 2, warm=True),
            library_fwd_ms=lib_f,
            library_bwd_ms=_device_ms(torch, lib_fb, reps) - lib_f,
            bounds={k: list(v) for k, v in bounds.items()},
            fwd_only_call_ms=_time_ms(torch, run_fo, reps),
            fwd_call_ms=_time_ms(torch, run_fwd, reps),
            bwd_call_ms=_time_ms(torch, run_bwd, reps),
            plain_fwd_only_call_ms=_time_ms(torch, plain_fo, 2, warmup=1))
        print("lstm " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


@contextlib.contextmanager
def _plain_lstm(lk, fwd=True):
    """Run the fused LSTM scan through the kernels' plain versions on the
    same card tensors, forward (unless ``fwd`` is false) and backward
    (comparisons only)."""
    saved = lk.lstm_fwd, lk.lstm_bwd
    if fwd:
        lk.lstm_fwd = lambda *a, with_residuals=True, wr_packed=None: (  # noqa: E731
            lk.lstm_fwd_plain(*a, with_residuals=with_residuals))
    lk.lstm_bwd = lk.lstm_bwd_plain
    try:
        yield
    finally:
        lk.lstm_fwd, lk.lstm_bwd = saved


def _char_rnn(compute_dtype, lr=0.01):
    """The JAX package's char-RNN benchmark stack (``bench.py``
    ``bench_lstm``/``bench_lstm_decode``), built by the port's builder
    (Adam at ``lr``, 0.01 as the benchmark's)."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    builder = (NeuralNetConfiguration.builder().seed(1).learning_rate(lr)
               .updater("adam").activation("tanh"))
    if compute_dtype:
        builder = builder.compute_dtype(compute_dtype)
    conf = (builder.list()
            .layer(L.GravesLSTM(n_in=CHAR_VOCAB, n_out=CHAR_HIDDEN))
            .layer(L.GravesLSTM(n_in=CHAR_HIDDEN, n_out=CHAR_HIDDEN))
            .layer(L.RnnOutputLayer(n_in=CHAR_HIDDEN, n_out=CHAR_VOCAB,
                                    activation="softmax",
                                    loss_function="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init()


def char_rnn_flops_per_token(vocab, hidden, layers=2):
    """``bench.py`` ``bench_lstm``'s count: 3 x 2 x the multiply-adds per
    token of the layers' input and recurrent products and the head."""
    macs = (vocab * 4 * hidden + (layers - 1) * hidden * 4 * hidden
            + layers * hidden * 4 * hidden + hidden * vocab)
    return 6.0 * macs


def _lstm_launches(kernels, lk):
    return {k: kernels.LAUNCHES.get(k, 0) for k in (
        lk.FWD_ONLY_KERNEL, lk.FWD_KERNEL, lk.BWD_KERNEL, lk.DW_KERNEL)}


def phase_char_serve(torch, np, kernels, lk):
    """Phase 5: char-RNN generation at full width; returns (launches,
    metrics)."""
    from deeplearning4j_tpu_torch.nn import generate as gen_mod
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    net = _char_rnn(None)
    params_from_numpy(net, _random_params(net, seed=21))
    prompts = np.random.default_rng(22).integers(0, CHAR_VOCAB,
                                                 (SERVE_BATCH, SERVE_PROMPT))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = net.generate(prompts, SERVE_NEW)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _lstm_launches(kernels, lk)
    bucket = gen_mod._pow2_bucket(SERVE_PROMPT)
    want = {lk.FWD_ONLY_KERNEL: 2 * (bucket + SERVE_NEW - 1), lk.FWD_KERNEL: 0,
            lk.BWD_KERNEL: 0, lk.DW_KERNEL: 0}
    _check(launches == want, f"char-RNN generate launches {launches}, "
           f"expected {want}")

    _check(out.shape == (SERVE_BATCH, SERVE_PROMPT + SERVE_NEW),
           f"output shape {out.shape}")
    _check(bool((out[:, :SERVE_PROMPT] == prompts).all()), "prompt echoed")
    _check(bool(((out >= 0) & (out < CHAR_VOCAB)).all()), "token range")
    eager = gen_mod.generate_eager(net, prompts, SERVE_NEW)
    _check(bool((out == eager).all()), "char-RNN generate == generate_eager")

    x = np.eye(CHAR_VOCAB, dtype=np.float32)[prompts]
    probs = net.output(x)
    with _plain_lstm(lk):
        probs_p = net.output(x)
    _check(bool(np.isfinite(probs).all()), "finite output")
    out_err = float(np.abs(probs - probs_p).max())
    _check(out_err <= SERVE_OUT_TOL,
           f"output kernels vs plain: {out_err} > {SERVE_OUT_TOL}")
    net.rnn_clear_previous_state()
    for s in range(SERVE_PROMPT):
        last = net.rnn_time_step(x[:, s])
    net.rnn_clear_previous_state()
    step_err = float(np.abs(last - probs[:, -1]).max())
    _check(step_err <= SERVE_OUT_TOL,
           f"rnn_time_step vs output's last step: {step_err}")

    g = gen_mod.build_generator(net)
    ids = torch.as_tensor(prompts, device="cuda")
    lengths = torch.full((SERVE_BATCH,), SERVE_PROMPT, device="cuda")
    prefill_ms = _time_ms(torch, lambda: g.prefill(
        g.serving_params(net.params, SERVE_BATCH), ids, lengths), 5)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.generate(prompts, SERVE_NEW)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    gen_s = statistics.median(times)
    per_gen = _device_times(torch, lambda: net.generate(prompts, SERVE_NEW), 1)
    dev_ms = _sum_ms(per_gen)
    metrics = dict(first_generate_s=first_s, generate_s=gen_s,
                   tokens_per_s=SERVE_BATCH * SERVE_NEW / gen_s,
                   prefill_ms=prefill_ms,
                   decode_ms_per_token=(gen_s * 1e3 - prefill_ms) / (SERVE_NEW - 1),
                   generate_device_ms=dev_ms,
                   device_busy_share=dev_ms / (gen_s * 1e3),
                   profile_kept_share=per_gen.kept_share,
                   lstm_fwd_only_ms_per_generate=_sum_ms(per_gen, "lstm_fwd_kernel"),
                   output_max_abs_diff_vs_plain=out_err,
                   rnn_time_step_max_abs_diff=step_err)
    print("char_serve " + json.dumps(metrics), flush=True)
    return launches, metrics


def _markov_ids(np, rng, b, t, vocab=CHAR_VOCAB):
    """[b, t] ids of a seeded first-order Markov chain over ``vocab`` ids:
    each id is followed by one fixed successor with probability 0.9,
    else by a uniform draw. Unlike uniform ids (whose loss starts at its
    floor, log vocab, under small random weights) it leaves the net
    something to learn in 20 steps."""
    succ = rng.permutation(vocab)
    ids = np.empty((b, t), np.int64)
    ids[:, 0] = rng.integers(0, vocab, b)
    noise = rng.random((b, t)) < 0.1
    draws = rng.integers(0, vocab, (b, t))
    for s in range(1, t):
        ids[:, s] = np.where(noise[:, s], draws[:, s], succ[ids[:, s - 1]])
    return ids


def _char_train_witness(torch, np, lk, seed, ds):
    """CHAR_STEPS ``fit`` steps through the plain scan on the card from
    the weights of ``seed``; before each, the loss and gradients on the
    same weights through the kernels, and through the forward kernel
    with the plain backward, against the plain scan's. A difference of
    the kernels that builds up over steps shows at the step where it
    does (two free-running trajectories at Adam 0.01 cannot tell it from
    the growth of rounding differences), and the second comparison tells
    the forward's share from the backward's. Read, not gated: the first
    step is gated in phase 6. Returns the plain trajectory's losses and,
    per step, the loss difference and the two worst gradient rel L2."""
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    net = _char_rnn("bfloat16")
    params_from_numpy(net, _random_params(net, seed=seed))
    out = collections.defaultdict(list)
    for s in range(CHAR_STEPS):
        grads, loss = net.gradient_and_score(ds)
        with _plain_lstm(lk, fwd=False):
            grads_f, _ = net.gradient_and_score(ds)
        with _plain_lstm(lk):
            grads_p, loss_p = net.gradient_and_score(ds)
            net.fit(ds)
        out["losses"].append(net.score())
        out["loss_vs_plain"].append(abs(loss - loss_p))
        out["grad_rel_l2_vs_plain"].append(_grad_rel(torch, grads, grads_p))
        out["grad_rel_l2_fwd_kernel_vs_plain"].append(_grad_rel(torch, grads_f, grads_p))
    _check(all(np.isfinite(out["losses"])), f"char-RNN seed {seed}: {dict(out)}")
    return dict(out)


def _grad_rel(torch, grads, grads_p):
    """The worst rel L2, over the layers' gradients, of ``grads`` against
    ``grads_p``, and where it is; inf for a non-finite gradient."""
    worst, at = 0.0, ""
    for layer, gl in grads.items():
        for name, gk in gl.items():
            gp = grads_p[layer][name]
            rel = ((gk - gp).norm() / gp.norm().clamp_min(1e-30)).item()
            if not bool(torch.isfinite(gk).all()):
                rel = float("inf")
            if rel >= worst:
                worst, at = rel, f"{layer}/{name}"
    return worst, at


def _grads_vs_plain(torch, what, grads, grads_p):
    """The worst rel L2 over the layers' gradients of ``grads`` (kernels)
    against ``grads_p`` (plain); fails past CHAR_GRAD_REL or on a
    non-finite gradient."""
    worst, at = _grad_rel(torch, grads, grads_p)
    _check(worst != float("inf"), f"{what}: finite grad {at}")
    _check(worst <= CHAR_GRAD_REL, f"{what}: grad {at} kernels vs plain: rel L2 {worst}")
    return worst


def phase_char_train(torch, np, kernels, lk):
    """Phase 6: char-RNN training at full width; returns (launches,
    metrics)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    net = _char_rnn("bfloat16")
    params_from_numpy(net, _random_params(net, seed=31))
    ids = _markov_ids(np, np.random.default_rng(32), CHAR_BATCH, CHAR_SEQ)
    eye = np.eye(CHAR_VOCAB, dtype=np.float32)
    ds = DataSet(eye[ids], eye[np.roll(ids, -1, axis=1)])

    grads, loss = net.gradient_and_score(ds)
    with _plain_lstm(lk):
        grads_p, loss_p = net.gradient_and_score(ds)
    _check(abs(loss - loss_p) <= CHAR_LOSS_TOL,
           f"char-RNN loss kernels {loss} vs plain {loss_p}")
    worst = _grads_vs_plain(torch, "char-RNN", grads, grads_p)
    del grads, grads_p

    torch.cuda.synchronize()
    kernels.reset_launches()
    net.fit(ds)
    torch.cuda.synchronize()
    launches = _lstm_launches(kernels, lk)
    want = {lk.FWD_ONLY_KERNEL: 0, lk.FWD_KERNEL: 2, lk.BWD_KERNEL: 2,
            lk.DW_KERNEL: 2}
    _check(launches == want, f"char-RNN train step launches {launches}, "
           f"expected {want}")

    losses, times = [net.score()], []
    for _ in range(CHAR_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(net.score())
    _check(all(np.isfinite(losses)), f"finite losses {losses}")
    _check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    step_s = statistics.median(times[1:])
    per_step = _device_times(torch, lambda: net.fit(ds), 3)
    dev = {m: _sum_ms(per_step, m) for m in
           ("", "lstm_fwd_kernel", "lstm_bwd_kernel", "lstm_dw_kernel")}
    # lstm_fwd alone on the step's own layer-0 gates (phase 2b times it on
    # N(0, 1) gates): the kernel's time in and out of the step's context
    p0 = net.cast_params(net.params)["layer0"]
    x0 = torch.as_tensor(ds.features, device="cuda").to(torch.bfloat16)
    xg0 = torch.matmul(x0.transpose(0, 1), p0["Wx"]) + p0["b"]
    zeros = torch.zeros(CHAR_BATCH, CHAR_HIDDEN, dtype=torch.bfloat16,
                        device="cuda")
    fwd_alone = _device_ms(torch, lambda: lk.lstm_fwd(
        xg0, p0["Wr"], p0["wci"], p0["wcf"], p0["wco"], zeros, zeros), 5,
        "lstm_fwd_kernel")
    del x0, xg0
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:12]
    tokens = CHAR_BATCH * CHAR_SEQ
    flops = char_rnn_flops_per_token(CHAR_VOCAB, CHAR_HIDDEN)
    torch.cuda.reset_peak_memory_stats()
    net.fit(ds)
    torch.cuda.synchronize()
    metrics = dict(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
                   mfu=tokens / step_s * flops / PEAK_FLOPS["bfloat16"],
                   flops_per_token=flops,
                   step_device_ms=dev[""],
                   device_busy_share=dev[""] / (step_s * 1e3),
                   profile_kept_share=per_step.kept_share,
                   lstm_fwd_ms_per_step=dev["lstm_fwd_kernel"],
                   lstm_bwd_ms_per_step=dev["lstm_bwd_kernel"],
                   lstm_dw_ms_per_step=dev["lstm_dw_kernel"],
                   lstm_fwd_ms_alone_on_step_gates=fwd_alone,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   loss_first=losses[0], loss_last=losses[-1],
                   loss_vs_plain=abs(loss - loss_p),
                   grad_rel_l2_vs_plain_max=worst, losses=losses,
                   top_kernels_ms_per_step=[[k[:90], ms] for k, ms in top])
    # the kernels held against the plain scan along the plain scan's own
    # trajectory: these weights and ids, and a second seed of both
    ids2 = _markov_ids(np, np.random.default_rng(34), CHAR_BATCH, CHAR_SEQ)
    ds2 = DataSet(eye[ids2], eye[np.roll(ids2, -1, axis=1)])
    metrics.update(witness_seed31=_char_train_witness(torch, np, lk, 31, ds),
                   witness_seed33=_char_train_witness(torch, np, lk, 33, ds2))
    print("char_train " + json.dumps(metrics), flush=True)
    del net
    # fit_scan at bench_lstm's shapes: 2 staged minibatches of 1024, seq
    # 128 (Markov ids, so that the loss can fall), from these weights
    scan_net = _char_rnn("bfloat16")
    params_from_numpy(scan_net, _random_params(scan_net, seed=31))
    ids = _markov_ids(np, np.random.default_rng(32), 2 * CHAR_BATCH, CHAR_SEQ)
    metrics["fit_scan"] = fit_scan_row(
        torch, np, kernels, "char_train",
        _scan_run(scan_net, DataSet(eye[ids], eye[np.roll(ids, -1, axis=1)]),
                  CHAR_BATCH, CHAR_SCAN_EPOCHS),
        CHAR_BATCH * CHAR_SEQ, flops, PEAK_FLOPS["bfloat16"],
        {lk.FWD_KERNEL: 2, lk.BWD_KERNEL: 2, lk.DW_KERNEL: 2})
    del scan_net
    metrics["f32"] = _char_train_f32(torch, np, kernels, lk)
    return launches, metrics


def _char_rnn_example(algo="stochastic_gradient_descent"):
    """``examples/train_char_rnn.py``'s net at full width, built by the
    port's builder: one GravesLSTM(256) and a softmax output layer over
    the corpus's characters, Adam 0.01, the default f32; ``algo`` is its
    optimization algorithm (phase 12 runs ``lbfgs``)."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(12).learning_rate(0.01)
            .updater("adam").activation("tanh").optimization_algo(algo).list()
            .layer(L.GravesLSTM(n_in=EXAMPLE_VOCAB, n_out=EXAMPLE_HIDDEN))
            .layer(L.RnnOutputLayer(n_in=EXAMPLE_HIDDEN, n_out=EXAMPLE_VOCAB,
                                    activation="softmax",
                                    loss_function="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init()


def _char_train_f32(torch, np, kernels, lk):
    """Phase 6's f32 run: the char-RNN example's training at full width
    (per-step ``fit``), on ids of a seeded Markov chain over its 28
    characters. Gates: the loss and every gradient with the kernels
    against the plain scan on the card (``EXAMPLE_*_REL``), one step
    launching ``lstm_fwd``, ``lstm_bwd`` and ``lstm_dw`` once each and
    ``lstm_fwd_only`` never, and a loss that falls over CHAR_STEPS steps.
    Returns (and prints as ``char_train_f32``) its metrics, the launches
    among them."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    net = _char_rnn_example()
    _check(net.gc.compute_dtype == "float32",
           f"the example trains in f32, not {net.gc.compute_dtype}")
    params_from_numpy(net, _random_params(net, seed=41))
    ids = _markov_ids(np, np.random.default_rng(42), EXAMPLE_BATCH,
                      EXAMPLE_SEQ, EXAMPLE_VOCAB)
    eye = np.eye(EXAMPLE_VOCAB, dtype=np.float32)
    ds = DataSet(eye[ids], eye[np.roll(ids, -1, axis=1)])

    grads, loss = net.gradient_and_score(ds)
    with _plain_lstm(lk):
        grads_p, loss_p = net.gradient_and_score(ds)
    loss_rel = abs(loss - loss_p) / abs(loss_p)
    _check(loss_rel <= EXAMPLE_LOSS_REL,
           f"f32 char-RNN loss kernels {loss} vs plain {loss_p}")
    worst, at = _grad_rel(torch, grads, grads_p)
    _check(worst <= EXAMPLE_GRAD_REL,
           f"f32 char-RNN grad {at} kernels vs plain: rel L2 {worst}")
    del grads, grads_p

    torch.cuda.synchronize()
    kernels.reset_launches()
    net.fit(ds)
    torch.cuda.synchronize()
    launches = _lstm_launches(kernels, lk)
    want = {lk.FWD_ONLY_KERNEL: 0, lk.FWD_KERNEL: 1, lk.BWD_KERNEL: 1,
            lk.DW_KERNEL: 1}
    _check(launches == want, f"f32 char-RNN train step launches {launches}, "
           f"expected {want}")
    losses, times = [net.score()], []
    for _ in range(CHAR_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(net.score())
    _check(all(np.isfinite(losses)), f"f32 finite losses {losses}")
    _check(losses[-1] < losses[0], f"f32 loss did not fall: {losses}")
    step_s = statistics.median(times[1:])
    per_step = _device_times(torch, lambda: net.fit(ds), 3)
    dev = {m: _sum_ms(per_step, m) for m in
           ("", "lstm_fwd_kernel", "lstm_bwd_kernel", "lstm_dw_kernel")}
    tokens = EXAMPLE_BATCH * EXAMPLE_SEQ
    flops = char_rnn_flops_per_token(EXAMPLE_VOCAB, EXAMPLE_HIDDEN, layers=1)
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:8]
    metrics = dict(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
                   mfu=tokens / step_s * flops / PEAK_FLOPS["float32"],
                   flops_per_token=flops, step_device_ms=dev[""],
                   device_busy_share=dev[""] / (step_s * 1e3),
                   profile_kept_share=per_step.kept_share,
                   lstm_fwd_ms_per_step=dev["lstm_fwd_kernel"],
                   lstm_bwd_ms_per_step=dev["lstm_bwd_kernel"],
                   lstm_dw_ms_per_step=dev["lstm_dw_kernel"],
                   loss_first=losses[0], loss_last=losses[-1],
                   loss_rel_vs_plain=loss_rel, grad_rel_l2_vs_plain_max=worst,
                   grad_worst_at=at, launches=launches, losses=losses,
                   top_kernels_ms_per_step=[[k[:90], ms] for k, ms in top])
    print("char_train_f32 " + json.dumps(metrics), flush=True)
    return metrics


def lenet_train_flops_per_example() -> float:
    """``bench.py``'s count for the LeNet flagship: 3 x 2 x the
    multiply-adds of conv1 5x5x1x20 at 24x24, conv2 5x5x20x50 at 8x8,
    dense 800->500 and the head 500->10 (13.758 MFLOP)."""
    macs = (24 * 24 * 20 * 25 + 8 * 8 * 50 * 25 * 20 + 800 * 500 + 500 * 10)
    return 3.0 * 2.0 * macs


def _lenet_conf(compute_dtype):
    """The JAX package's flagship (``__graft_entry__._flagship``):
    LeNet on 28x28x1, n_in and the flatten wired by ``set_input_type``,
    built by the port's builder."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

    return (NeuralNetConfiguration.builder()
            .seed(12345).learning_rate(0.01).updater("adam")
            .activation("relu").weight_init("relu")
            .compute_dtype(compute_dtype)
            .list()
            .layer(L.ConvolutionLayer(n_out=20, kernel_size=(5, 5)))
            .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(L.ConvolutionLayer(n_out=50, kernel_size=(5, 5)))
            .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(L.DenseLayer(n_out=500))
            .layer(L.OutputLayer(n_out=10, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(InputType.convolutional(28, 28, 1))
            .build())


def _mlp_iris_conf(compute_dtype):
    """The JAX package's MLP-Iris benchmark net (``bench.py``
    ``bench_mlp_iris``): 4-64-64-3, relu, Adam at 0.1, seed 3."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    return (NeuralNetConfiguration.builder()
            .seed(3).learning_rate(0.1).updater("adam").activation("relu")
            .compute_dtype(compute_dtype)
            .list()
            .layer(L.DenseLayer(n_in=4, n_out=64))
            .layer(L.DenseLayer(n_in=64, n_out=64))
            .layer(L.OutputLayer(n_in=64, n_out=3, activation="softmax",
                                 loss_function="mcxent"))
            .build())


def accuracy_line(what, ev, n, synthetic):
    """The printed evaluation summary; accuracy on synthetic data says
    so, since it claims nothing about the real data set."""
    import numpy as np

    data = "SYNTHETIC data (no accuracy claim)" if synthetic else "real data"
    return (f"{what}: accuracy {ev.accuracy():.4f} over {n} examples of "
            f"{data}; confusion diagonal {np.diag(ev.confusion.counts).tolist()}")


def _rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _grads_rel(a, b, ds) -> float:
    """The largest, over parameters, of max |ga - gb| / max |gb|, the
    gradients of nets ``a`` and ``b`` on ``ds``."""
    ga, _ = a.gradient_and_score(ds)
    gb, _ = b.gradient_and_score(ds)
    return max(_rel_err(ga[l][n].cpu().numpy(), gb[l][n].cpu().numpy())
               for l in gb for n in gb[l])


def kink_free(net64, x, y):
    """A mask of the examples whose gradient is continuous at f32's
    rounding: each example's f64 gradient on its own (``net64``, f64
    parameters), against the same with the parameters scaled by 1 +-
    ``KINK_REL`` x N(0, 1) noise (``KINK_DRAWS`` seeded draws, each
    both ways, so a ReLU input at 0 crosses it), moves by at most
    ``KINK_TOL`` of its largest entry."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    def per_example(params):
        net64.params, rows = params, []
        for i in range(len(x)):
            g, _ = net64.gradient_and_score(DataSet(x[i:i + 1], y[i:i + 1]))
            rows.append(np.concatenate([g[l][n].cpu().numpy().ravel()
                                        for l, n in net64._flat_order()]))
        return np.stack(rows)

    params = net64.params
    try:
        base = per_example(params)
        moved = np.zeros(len(x))
        for d in range(KINK_DRAWS):
            dev = next(t for p in params.values() for t in p.values()).device
            gen = torch.Generator(device=dev).manual_seed(d)
            noise = {l: {n: KINK_REL * torch.randn(
                v.shape, generator=gen, dtype=v.dtype, device=v.device)
                for n, v in p.items()} for l, p in params.items()}
            for sign in (1, -1):
                noisy = {l: {n: v * (1 + sign * noise[l][n]) for n, v in p.items()}
                         for l, p in params.items()}
                moved = np.maximum(moved, np.abs(per_example(noisy) - base).max(1))
    finally:
        net64.params = params
    return moved <= KINK_TOL * np.maximum(np.abs(base).max(1), 1e-300)


def _host_tree(net) -> dict:
    """The net's parameters as numpy, {layer: {name: array}}."""
    return {l: {n: v.cpu().numpy() for n, v in p.items()}
            for l, p in net.params.items()}


def _port_launches(kernels) -> dict:
    """The port's kernel launches counted since the last reset."""
    return {k: v for k, v in kernels.LAUNCHES.items() if v}


def _train_metrics(torch, net, batches, steps, flops_per_example):
    """``steps`` fit steps cycling over ``batches`` (the first one with
    the launch counts zeroed before it and read after it): the losses,
    the median step of steps 3.., examples/s, MFU, and the device time
    and busy share of one step by torch.profiler."""
    import numpy as np

    from deeplearning4j_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    net.fit(batches[0])
    torch.cuda.synchronize()
    launches = _port_launches(kernels)
    losses, times = [net.score()], []
    for s in range(1, steps):
        t0 = time.perf_counter()
        net.fit(batches[s % len(batches)])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(net.score())
    _check(all(np.isfinite(losses)), f"finite losses {losses}")
    _check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    step_s = statistics.median(times[1:])
    per_step = _device_times(torch, lambda: net.fit(batches[0]), 3)
    dev = _sum_ms(per_step)
    b = batches[0].num_examples()
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:8]
    return dict(step_ms=step_s * 1e3, examples_per_s=b / step_s,
                mfu=(b / step_s * flops_per_example / PEAK_FLOPS["bfloat16"]
                     if flops_per_example else None),
                step_device_ms=dev, device_busy_share=dev / (step_s * 1e3),
                loss_first=losses[0], loss_last=losses[-1], losses=losses,
                port_kernel_launches=launches,
                top_kernels_ms_per_step=[[k[:90], ms] for k, ms in top])


def fit_scan_row(torch, np, kernels, what, run, units_per_step,
                 flops_per_unit, peak, want):
    """A ``fit_scan`` row: ``run()`` trains (a warm-up ``fit_scan`` and
    the best of two timed ones, ``best_of_fit_scan``) and returns a dict
    with the ``net``, its ``staged`` data, every call's ``scores`` in
    order and the best call's ``seconds``; the port's kernel launches
    are counted over it. Gates: finite scores, a loss that falls from the
    first score to the last, and exactly ``want`` (kernel -> launches per
    step) launched on every step. Then one epoch of ``fit_scan``
    profiled for the device time per step. Prints and returns the step
    on the host's clock, units/s, MFU at ``peak`` (None without
    ``flops_per_unit``), the busy share and the launches."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    rec = run()
    torch.cuda.synchronize()
    launches = _port_launches(kernels)
    net, staged, scores = rec["net"], rec["staged"], np.asarray(rec["scores"])
    x0 = next(iter(staged[0].values())) if isinstance(staged[0], dict) else staged[0]
    steps, batch = x0.shape[0], x0.shape[1]
    total = len(scores)  # steps over the three calls
    _check(bool(np.isfinite(scores).all()), f"{what} fit_scan: finite scores")
    _check(scores[-1] < scores[0], f"{what} fit_scan: loss did not fall: "
           f"{scores[0]} -> {scores[-1]}")
    _check(launches == {k: v * total for k, v in want.items() if v},
           f"{what} fit_scan launched {launches} in {total} steps, expected "
           f"{want} per step")
    step_s = rec["seconds"] / (total // 3)
    per = _device_times(torch, lambda: net.fit_scan(None, batch, epochs=1,
                                                    staged=staged), 1)
    dev_ms = _sum_ms(per) / steps
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    m = dict(step_ms=step_s * 1e3, units_per_s=units_per_step / step_s,
             mfu=(units_per_step / step_s * flops_per_unit / peak
                  if flops_per_unit else None),
             step_device_ms=dev_ms, device_busy_share=dev_ms / (step_s * 1e3),
             profile_kept_share=getattr(per, "kept_share", None), steps=total,
             steps_per_call=total // 3, loss_first=float(scores[0]),
             loss_last=float(scores[-1]), launches=launches,
             launches_per_step={k: v // total for k, v in launches.items()},
             top_kernels_ms_per_step=[[k[:90], ms / steps] for k, ms in top])
    if "result" in rec:
        m["benchmark"] = rec["result"]
    print(f"{what}_fit_scan " + json.dumps(m), flush=True)
    return m


def _scan_run(net, ds, batch, epochs):
    """``fit_scan_row``'s ``run`` for a net and a dataset: staged once,
    then ``best_of_fit_scan`` at ``epochs`` per call."""
    from deeplearning4j_tpu_torch.models.zoo.benchmark import best_of_fit_scan

    def run():
        staged = net.stage_scan(ds, batch)
        scores, seconds = best_of_fit_scan(net, batch, epochs, staged)
        return dict(net=net, staged=staged, scores=scores, seconds=seconds)
    return run


def phase_lenet(torch, np, kernels):
    """Phase 7: LeNet-MNIST at full width; returns its metrics."""
    import tempfile
    from unittest import mock

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.mnist import load_mnist
    from deeplearning4j_tpu_torch.nn.layers import convolution
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util import model_serializer as ser

    t0 = time.perf_counter()
    net = MultiLayerNetwork(_lenet_conf("bfloat16")).init()
    init_tree = _host_tree(net)
    train = load_mnist(train=True, num_examples=LENET_BATCH * LENET_BATCHES)
    x = train.features.reshape(-1, 28, 28, 1)
    batches = [DataSet(x[i:i + LENET_BATCH], train.labels[i:i + LENET_BATCH])
               for i in range(0, len(x), LENET_BATCH)]
    setup_s = time.perf_counter() - t0
    m = _train_metrics(torch, net, batches, LENET_STEPS,
                       lenet_train_flops_per_example())
    _check(not m["port_kernel_launches"], "the LeNet step launched port "
           f"kernels: {m['port_kernel_launches']}")

    test = load_mnist(train=False, num_examples=LENET_TEST)
    ev = net.evaluate(DataSet(test.features.reshape(-1, 28, 28, 1), test.labels),
                      batch_size=LENET_BATCH)
    _check(ev.confusion.counts.sum() == LENET_TEST, "evaluate counted "
           f"{ev.confusion.counts.sum()} examples")
    print(accuracy_line("lenet evaluate", ev, LENET_TEST, synthetic=True),
          flush=True)
    scan = fit_scan_row(
        torch, np, kernels, "lenet_train",
        _scan_run(MultiLayerNetwork(_lenet_conf("bfloat16")).init(),
                  DataSet(x, train.labels), LENET_BATCH, LENET_SCAN_EPOCHS),
        LENET_BATCH, lenet_train_flops_per_example(), PEAK_FLOPS["bfloat16"], {})

    # f32 copies of the net, before and after training, on the card and on
    # the CPU, with cuDNN's TF32 on (PyTorch's default): the port's
    # convolutions must still compute in f32. The outputs of both copies
    # are held to LENET_OUT_REL. The gradients are held to LENET_GRAD_REL
    # on the untrained copy, over the examples away from a kink; the
    # trained copy's softmax saturates, its f32 gradients are rounding
    # noise on p - y, and they are printed only
    xc = test.features[:LENET_CHECK].reshape(-1, 28, 28, 1)
    yc = test.labels[:LENET_CHECK]
    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision
    conv.fp32_precision = "tf32"
    try:
        out_rel, grads = {}, {}
        for when, tree in (("init", init_tree), ("trained", _host_tree(net))):
            card, cpu = (ser.params_from_numpy(
                MultiLayerNetwork(_lenet_conf("float32"), device=d).init(), tree)
                for d in ("cuda", "cpu"))
            out_cpu = cpu.output(xc)
            out_rel[when] = _rel_err(card.output(xc), out_cpu)
            grads[when + "_all"] = _grads_rel(card, cpu, DataSet(xc, yc))
            if when == "init":
                # a witness, not gated: the same output with the port's
                # f32 scope taken away, i.e. the convolutions in TF32
                with mock.patch.object(convolution, "_ieee_f32", contextlib.nullcontext):
                    tf32_witness = _rel_err(card.output(xc), out_cpu)
                cpu64 = ser.params_from_numpy(MultiLayerNetwork(
                    _lenet_conf("float32"), device="cpu").init(torch.float64), tree)
                kept = kink_free(cpu64, xc, yc)
                grads["init_kept"] = _grads_rel(card, cpu, DataSet(xc[kept], yc[kept]))
                # which side of a jump the f64 gradient takes
                grads["init_all_vs_cpu_f64"] = _grads_rel(card, cpu64, DataSet(xc, yc))
                grads["cpu_f32_vs_cpu_f64"] = _grads_rel(cpu, cpu64, DataSet(xc, yc))
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "lenet.zip")
            ser.write_model(card, path)
            back = ser.restore_multi_layer_network(path, device="cpu")
            restored_equal = bool(np.array_equal(back.output(xc), out_cpu))
    finally:
        conv.fp32_precision = prev
    for when, rel in out_rel.items():
        _check(rel <= LENET_OUT_REL, f"f32 LeNet ({when}) output card vs CPU {rel}")
    _check(int(kept.sum()) >= LENET_MIN_KEPT, f"only {int(kept.sum())} of "
           f"{LENET_CHECK} examples away from a kink")
    _check(grads["init_kept"] <= LENET_GRAD_REL, "f32 LeNet gradients card vs "
           f"CPU {grads['init_kept']} over {int(kept.sum())} examples")
    _check(restored_equal, "the zip saved on the card restores on the CPU "
           "with other outputs")
    m.update(fit_scan=scan, setup_s=setup_s,
             flops_per_example=lenet_train_flops_per_example(),
             synthetic_test_accuracy=ev.accuracy(),
             f32_out_rel_card_vs_cpu=out_rel, f32_grad_rel_card_vs_cpu=grads,
             kink_free_examples=int(kept.sum()),
             kink_examples=np.flatnonzero(~kept).tolist(),
             f32_out_rel_with_tf32_witness=tf32_witness,
             zip_card_to_cpu_equal=restored_equal,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print("lenet_train " + json.dumps(m), flush=True)
    return m


def iris_batches(np):
    """The Iris rows (min-max scaled, in file order) tiled
    ``IRIS_TILES`` times, cut into the full batches of ``IRIS_BATCH``."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iris import load_iris_dataset

    iris = load_iris_dataset()
    x = np.tile(iris.features, (IRIS_TILES, 1)).astype(np.float32)
    y = np.tile(iris.labels, (IRIS_TILES, 1)).astype(np.float32)
    return [DataSet(x[i:i + IRIS_BATCH], y[i:i + IRIS_BATCH])
            for i in range(0, len(x) - IRIS_BATCH + 1, IRIS_BATCH)]


def phase_mlp_iris(torch, np, kernels):
    """Phase 8: MLP-Iris at full width; returns its metrics."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iris import load_iris_dataset
    from deeplearning4j_tpu_torch.nn.gradientcheck import check_gradients
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    net = MultiLayerNetwork(_mlp_iris_conf("bfloat16")).init()
    m = _train_metrics(torch, net, iris_batches(np), IRIS_STEPS, None)
    _check(not m["port_kernel_launches"], "the MLP step launched port "
           f"kernels: {m['port_kernel_launches']}")
    iris = load_iris_dataset()
    # fit_scan on bench_mlp_iris's data: the rows tiled, 9 minibatches of
    # 4096 (the tail of 1536 dropped, with the warning)
    tiled = DataSet(np.tile(iris.features, (IRIS_TILES, 1)).astype(np.float32),
                    np.tile(iris.labels, (IRIS_TILES, 1)).astype(np.float32))
    m["fit_scan"] = fit_scan_row(
        torch, np, kernels, "mlp_iris_train",
        _scan_run(MultiLayerNetwork(_mlp_iris_conf("bfloat16")).init(), tiled,
                  IRIS_BATCH, IRIS_SCAN_EPOCHS),
        IRIS_BATCH, None, None, {})
    ev = net.evaluate(DataSet(iris.features.astype(np.float32),
                              iris.labels.astype(np.float32)))
    print(accuracy_line("mlp_iris evaluate", ev, 150, synthetic=False), flush=True)

    # the finite-difference oracle in f64 on the card, on the trained
    # parameters, every one of them
    net64 = MultiLayerNetwork(_mlp_iris_conf("float32")).init(torch.float64)
    params_from_numpy(net64, _host_tree(net))
    t0 = time.perf_counter()
    gc = check_gradients(net64, DataSet(iris.features, iris.labels))
    gc_s = time.perf_counter() - t0
    _check(net64.params["layer0"]["W"].device.type == "cuda"
           and net64.params["layer0"]["W"].dtype == torch.float64,
           "the gradient check ran off the card or not in f64")
    _check(gc.ok and gc.n_checked == net64.num_params(),
           f"f64 gradient check on the card: {gc.n_failed} of {gc.n_checked} "
           f"failed: {gc.failures[:5]}")
    m.update(accuracy=ev.accuracy(), gradcheck_n_checked=gc.n_checked,
             gradcheck_max_rel_error=gc.max_rel_error, gradcheck_s=gc_s)
    print("mlp_iris_train " + json.dumps(m), flush=True)
    return m


def char_rnn_graph(compute_dtype=None, device=None):
    """``_char_rnn``'s stack as a ComputationGraph (in -> GravesLSTM ->
    GravesLSTM -> RnnOutputLayer) on ``device`` (cuda by default), its
    layers named as the MultiLayerNetwork's so that one parameter tree
    loads into both."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraph,
        ComputationGraphConfiguration,
    )

    base = (NeuralNetConfiguration.builder().seed(1).learning_rate(0.01)
            .updater("adam").activation("tanh"))
    if compute_dtype:
        base = base.compute_dtype(compute_dtype)
    conf = (ComputationGraphConfiguration.builder(base.build())
            .add_inputs("in")
            .add_layer("layer0", L.GravesLSTM(n_in=CHAR_VOCAB, n_out=CHAR_HIDDEN), "in")
            .add_layer("layer1", L.GravesLSTM(n_in=CHAR_HIDDEN, n_out=CHAR_HIDDEN),
                       "layer0")
            .add_layer("layer2", L.RnnOutputLayer(n_in=CHAR_HIDDEN, n_out=CHAR_VOCAB,
                                                  activation="softmax",
                                                  loss_function="mcxent"), "layer1")
            .set_outputs("layer2")
            .build())
    return ComputationGraph(conf, device=device).init()


def gpt_graph(conf, device=None):
    """``gpt(**conf)`` as a single-input ComputationGraph chain (embedding
    -> blocks -> head) on ``device`` (cuda by default), its layers named
    as the MultiLayerNetwork's."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraph,
        ComputationGraphConfiguration,
    )

    base = (NeuralNetConfiguration.builder().seed(0).learning_rate(3e-4)
            .updater("adam").activation("identity").weight_init("xavier")
            .compute_dtype(conf["compute_dtype"]).build())
    d, n = conf["d_model"], conf["n_layers"]
    g = (ComputationGraphConfiguration.builder(base).add_inputs("ids")
         .add_layer("layer0", L.SequenceEmbeddingLayer(
             n_in=conf["vocab_size"], n_out=d, max_len=conf["max_len"]), "ids"))
    for i in range(1, n + 1):
        g = g.add_layer(f"layer{i}", L.TransformerBlock(
            n_in=d, n_out=d, num_heads=conf["num_heads"], causal=True),
            f"layer{i - 1}")
    g = (g.add_layer(f"layer{n + 1}", L.RnnOutputLayer(
        n_in=d, n_out=conf["vocab_size"], activation="softmax",
        loss_function="mcxent"), f"layer{n}").set_outputs(f"layer{n + 1}"))
    return ComputationGraph(g.build(), device=device).init()


def phase_graph(torch, np, kernels, flash, lk):
    """Phase 9: the ComputationGraph. (a) ResNet-50 through the port's
    ``resnet50_benchmark`` at the JAX package's benchmark size; (b) a tiny
    ResNet in f32 on the card against the CPU; (c) the char-RNN as a
    graph on phase 5's weights; (d) a ``gpt`` chain as a graph on phase
    3's weights. Returns its metrics."""
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.models.zoo import resnet as zoo
    from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    out = {}
    # (a) ResNet-50: no port kernel runs on this path
    torch.cuda.reset_peak_memory_stats()

    def run():
        rec = {}
        rec["result"] = zoo.resnet50_benchmark(
            PEAK_FLOPS["bfloat16"], batch=RESNET_BATCH, image_size=RESNET_IMAGE,
            steps=RESNET_STEPS, record=rec)
        return rec

    a = fit_scan_row(torch, np, kernels, "resnet50", run, RESNET_BATCH,
                     zoo.resnet50_train_flops_per_example(RESNET_IMAGE),
                     PEAK_FLOPS["bfloat16"], {})
    a["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["resnet50"] = a
    torch.cuda.empty_cache()

    # (b) the tiny ResNet, f32, card against CPU (TF32 off, as set above)
    rng = np.random.default_rng(41)
    x = rng.standard_normal((TINY_RESNET_BATCH, TINY_RESNET_IMAGE,
                             TINY_RESNET_IMAGE, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, TINY_RESNET_BATCH)]
    cpu = zoo.resnet(device="cpu", **TINY_RESNET).init()
    card = params_from_numpy(zoo.resnet(**TINY_RESNET).init(), _host_tree(cpu))
    mds = MultiDataSet([x], [y])
    b = dict(output_rel=_rel_err(card.output(x), cpu.output(x)),
             score_rel=_rel_err(card.score(mds), cpu.score(mds)))
    cpu.fit(mds)
    card.fit(mds)
    b["step_score_rel"] = _rel_err(card.score(), cpu.score())
    b["step_params_rel"] = max(
        _rel_err(card.params[l][n].cpu().numpy(), cpu.params[l][n].numpy())
        for l in cpu.params for n in cpu.params[l])
    for k, v in b.items():
        _check(v <= TINY_RESNET_REL, f"tiny ResNet f32 card vs CPU: {k} {v}")
    out["tiny_resnet"] = b

    # (c) the char-RNN as a graph, phase 5's weights
    net = _char_rnn(None)
    tree = _random_params(net, seed=21)
    params_from_numpy(net, tree)
    graph = params_from_numpy(char_rnn_graph(), tree)
    prompts = np.random.default_rng(22).integers(0, CHAR_VOCAB,
                                                 (SERVE_BATCH, SERVE_PROMPT))
    xs = np.eye(CHAR_VOCAB, dtype=np.float32)[prompts]
    kernels.reset_launches()
    burst = graph.rnn_time_step(xs)[0]
    steps_launched = _lstm_launches(kernels, lk)[lk.FWD_ONLY_KERNEL]
    _check(steps_launched == 2 * SERVE_PROMPT, f"the char-RNN graph's "
           f"rnn_time_step launched lstm_fwd_only {steps_launched} times")
    graph.rnn_clear_previous_state()
    one = graph.rnn_time_step(xs[:, 0])[0]
    want_burst = net.rnn_time_step(xs)
    net.rnn_clear_previous_state()
    # the burst runs the MultiLayerNetwork's operations on the same
    # tensors; a single step reads a contiguous copy of the first step
    _check(np.array_equal(burst, want_burst), "the char-RNN graph's "
           "rnn_time_step burst differs from the MultiLayerNetwork's")
    one_err = float(np.abs(one - want_burst[:, 0]).max())
    _check(one_err <= SERVE_OUT_TOL, "the char-RNN graph's single "
           f"rnn_time_step is {one_err} from the MultiLayerNetwork's")
    kernels.reset_launches()
    toks = graph.generate(prompts, SERVE_NEW)
    gen_launches = _lstm_launches(kernels, lk)
    _check(gen_launches[lk.FWD_ONLY_KERNEL] > 0 and not any(
        v for k, v in gen_launches.items() if k != lk.FWD_ONLY_KERNEL),
        f"the char-RNN graph's generate launched {gen_launches}")
    _check(bool((toks == net.generate(prompts, SERVE_NEW)).all()),
           "the char-RNN graph's generate differs from the MultiLayerNetwork's")
    out["char_rnn_graph"] = dict(rnn_time_step_launches=steps_launched,
                                 generate_launches=gen_launches)
    del net, graph

    # (d) a gpt chain as a graph, phase 3's weights
    net = gpt(**GPT).init()
    tree = _random_params(net, seed=7)
    params_from_numpy(net, tree)
    graph = params_from_numpy(gpt_graph(GPT), tree)
    prompts = np.random.default_rng(8).integers(0, GPT["vocab_size"],
                                                (BATCH, PROMPT))
    kernels.reset_launches()
    toks = graph.generate(prompts, GRAPH_NEW)
    torch.cuda.synchronize()
    graph_launches = _port_launches(kernels)
    kernels.reset_launches()
    want = net.generate(prompts, GRAPH_NEW)
    torch.cuda.synchronize()
    _check(graph_launches.get(flash.KERNEL, 0) > 0
           and graph_launches == _port_launches(kernels),
           f"the gpt graph's generate launched {graph_launches}, the "
           f"MultiLayerNetwork's {_port_launches(kernels)}")
    _check(bool((toks == want).all()), "the gpt graph's greedy generate "
           "differs from the MultiLayerNetwork's")
    out["gpt_graph"] = dict(generate_launches=graph_launches,
                            new_tokens=GRAPH_NEW)
    print("graph " + json.dumps(out), flush=True)
    return out


# phase 10 (a): the MoE GPT at phase 4's width, with the zoo's routed
# experts: 8 experts (Mixtral 8x7B's count; routed top-1, as the
# reference), capacity factor 1.25 and aux loss weight 0.01 (the zoo's
# defaults)
MOE_TRAIN = dict(TRAIN, num_experts=8, capacity_factor=1.25,
                 aux_loss_weight=0.01)
# the MoE step, kernels vs plain versions: a bf16 attention output that
# differs by an ulp can flip a near-tie router argmax, and a flip moves
# every later token's queue slot in two experts (and so which tokens
# overflow). So each block's expert choices are compared first and the
# share routed differently printed; then (1) the plain step replays the
# kernel step's expert choices: with the same routing the loss and every
# gradient are held to TRAIN_LOSS_TOL and TRAIN_GRAD_REL, as phase 4's
# dense step; (2) the plain step routes by itself: its loss is held to
# TRAIN_LOSS_TOL (a flip moves a few of 16,384 tokens' losses), and the
# gradients of the layers before the first block whose routing differs
# to TRAIN_GRAD_REL + MOE_FLIP_REL * sqrt(k / n), k of n tokens routed
# differently in some block: a flip changes about three tokens'
# contributions to every gradient sum below it (its own, and the tokens
# its move keeps and drops at the capacity edge), and contributions that
# add in quadrature move a relative L2 by about sqrt(3 k / n)
MOE_FLIP_REL = 4.0
# phase 10 (b): the MoE GPT at phase 3's serving width
MOE_GPT = dict(GPT, num_experts=8)
# phase 10 (d): two causal residual AttentionLayer(512 -> 512, 8 heads)
# and an RnnOutputLayer over ATTN_CLASSES classes, batch 16, seq 1024,
# bf16
ATTN_WIDTH, ATTN_HEADS, ATTN_BATCH, ATTN_SEQ, ATTN_CLASSES = 512, 8, 16, 1024, 16
# phase 10 (e): a DBN at MNIST's width (tests/test_pretrain.py's stack),
# 8 minibatches of 2048 of the synthetic MNIST; one pretrain step per
# layer on the card against the CPU with the same uniforms: f32 (no
# TF32) on both, the products summed in other orders
DBN_BATCH, DBN_BATCHES, PRETRAIN_REL = 2048, 8, 1e-4


@contextlib.contextmanager
def _routing(torch, record, replay=None):
    """Record each MoE routing call's (expert choice, slot) in
    ``record``; with ``replay`` (an earlier record), route each call by
    the recorded expert choices (the gate and the aux loss from the
    call's own router logits)."""
    from deeplearning4j_tpu_torch.ops import moe

    saved = moe.top1_route

    def route(gate_logits, capacity, valid=None):
        if replay is None:
            expert = torch.softmax(gate_logits.float(), dim=-1).argmax(dim=-1)
        else:
            expert = replay[len(record)][0]
        out = saved(gate_logits, capacity, valid, expert=expert)
        record.append((expert, out[0]))
        return out

    moe.top1_route = route
    try:
        yield record
    finally:
        moe.top1_route = saved


def _routing_shares(a, b):
    """Per block, the share of tokens whose expert (and whose slot)
    differs between two records."""
    _check(len(a) == len(b), f"{len(a)} vs {len(b)} routing calls")
    return [{"expert": (ea != eb).float().mean().item(),
             "slot": (sa != sb).float().mean().item()}
            for (ea, sa), (eb, sb) in zip(a, b)]


def _moe_train(torch, np, kernels, flash):
    """Phase 10 (a): one MoE GPT step at full width, kernels against
    the plain versions (routing first), the launches of one ``fit``
    step, 20 steps, the step's time and where it goes."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.zoo.transformer import (
        gpt,
        gpt_train_flops_per_token,
    )
    from deeplearning4j_tpu_torch.nn.layers import transformer
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    t, n_layers = MOE_TRAIN["max_len"], MOE_TRAIN["n_layers"]
    net = gpt(**MOE_TRAIN).init()
    params_from_numpy(net, _random_params(net, seed=41))
    ids = np.random.default_rng(42).integers(0, MOE_TRAIN["vocab_size"],
                                             (TRAIN_BATCH, t))
    ds = DataSet(ids.astype(np.float32),
                 np.roll(ids, -1, axis=1).astype(np.float32))
    with _routing(torch, []) as routes:
        grads, loss = net.gradient_and_score(ds)
    with _plain_attention(torch, flash, transformer):
        with _routing(torch, []) as routes_p:
            grads_p, loss_p = net.gradient_and_score(ds)
        with _routing(torch, [], replay=routes):
            grads_r, loss_r = net.gradient_and_score(ds)
    shares = _routing_shares(routes, routes_p)
    _check(len(routes) == n_layers, f"{len(routes)} routing calls")
    n = TRAIN_BATCH * t
    moved = torch.zeros(n, dtype=torch.bool, device=net.device)
    for (ea, _), (eb, _) in zip(routes, routes_p):
        moved |= ea != eb
    k = int(moved.sum())
    print("moe_train_routing " + json.dumps(
        {"blocks": shares, "tokens_routed_differently": k, "tokens": n}), flush=True)
    # (1) the same routing: the loss and every gradient
    _check(abs(loss - loss_r) <= TRAIN_LOSS_TOL,
           f"MoE train loss kernels {loss} vs plain (same routing) {loss_r}")
    worst_r, at_r = _grad_rel(torch, grads, grads_r)
    _check(worst_r <= TRAIN_GRAD_REL, f"MoE grad {at_r} kernels vs plain (same "
           f"routing): rel L2 {worst_r}")
    # (2) each its own routing: the loss, and the layers before the
    # first block whose routing differs
    _check(abs(loss - loss_p) <= TRAIN_LOSS_TOL,
           f"MoE train loss kernels {loss} vs plain {loss_p}")
    first = next((i for i, sh in enumerate(shares) if sh["expert"] > 0), n_layers)
    gated = {f"layer{i}" for i in range(first + 1)} | (
        {f"layer{n_layers + 1}"} if first == n_layers else set())
    bound = TRAIN_GRAD_REL + MOE_FLIP_REL * (k / n) ** 0.5
    worst_g, at_g = _grad_rel(torch, {l: g for l, g in grads.items() if l in gated},
                              grads_p)
    _check(worst_g <= bound, f"MoE grad {at_g} kernels vs plain (before block "
           f"{first}): rel L2 {worst_g} > {bound}")
    worst_p, at_p = _grad_rel(torch, grads, grads_p)
    del grads, grads_p, grads_r
    _say("phase 10 (a): MoE step within tolerance of the plain attention")

    torch.cuda.synchronize()
    kernels.reset_launches()
    net.fit(ds)
    torch.cuda.synchronize()
    launches = _port_launches(kernels)
    for name in (flash.KERNEL, flash.DQ_KERNEL, flash.DKV_KERNEL):
        _check(launches.get(name, 0) == n_layers,
               f"{name} launched {launches.get(name, 0)} times in one MoE "
               f"train step, expected {n_layers}: {launches}")
    losses, times = [net.score()], []
    for _ in range(TRAIN_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(net.score())
    _check(all(np.isfinite(losses)), f"finite MoE losses {losses}")
    _check(losses[-1] < losses[0], f"MoE loss did not fall: {losses}")
    step_s = statistics.median(times[1:])
    per_step = _device_times(torch, lambda: net.fit(ds), 2)
    dev = {m: _sum_ms(per_step, m) for m in
           ("", "flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")}
    top = sorted(per_step.items(), key=lambda kv: -kv[1])[:12]
    # per token, a top-1 MoE block does the dense block's products (one
    # expert's FFN) plus the router's d x E
    flops = gpt_train_flops_per_token(MOE_TRAIN["vocab_size"], MOE_TRAIN["d_model"],
                                      n_layers, t) \
        + 6.0 * n_layers * MOE_TRAIN["d_model"] * MOE_TRAIN["num_experts"]
    torch.cuda.reset_peak_memory_stats()
    net.fit(ds)
    torch.cuda.synchronize()
    m = dict(step_ms=step_s * 1e3, tokens_per_s=n / step_s,
             mfu=n / step_s * flops / PEAK_FLOPS["bfloat16"],
             step_device_ms=dev[""], device_busy_share=dev[""] / (step_s * 1e3),
             profile_kept_share=per_step.kept_share,
             flash_fwd_ms_per_step=dev["flash_fwd_kernel"],
             flash_dq_ms_per_step=dev["flash_dq_kernel"],
             flash_dkv_ms_per_step=dev["flash_dkv_kernel"],
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             loss_first=losses[0], loss_last=losses[-1], losses=losses,
             loss_vs_plain_same_routing=abs(loss - loss_r),
             loss_vs_plain=abs(loss - loss_p),
             grad_rel_l2_vs_plain_same_routing_max=worst_r,
             grad_worst_at_same_routing=at_r,
             grad_rel_l2_vs_plain_gated_max=worst_g,
             grad_rel_l2_vs_plain_max=worst_p, grad_worst_at=at_p,
             first_block_routed_differently=first, flip_grad_bound=bound,
             launches=launches,
             top_kernels_ms_per_step=[[name[:90], ms] for name, ms in top])
    print("moe_train " + json.dumps(m), flush=True)
    return m


def _serve_check(torch, np, kernels, flash, net, what):
    """Greedy ``generate`` of NEW tokens for BATCH prompts of PROMPT on
    ``net`` (counts zeroed right before): ``flash_fwd`` launched,
    ``generate == generate_eager``, tokens in range. Returns (the
    launches, the generator, the prompts on the card, the seconds of
    that generate)."""
    from deeplearning4j_tpu_torch.nn import generate as gen_mod

    prompts = np.random.default_rng(8).integers(0, GPT["vocab_size"],
                                                (BATCH, PROMPT))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = net.generate(prompts, NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = _port_launches(kernels)
    _check(launches.get(flash.KERNEL, 0) > 0,
           f"{what}: the flash kernel never launched in generate: {launches}")
    _check(out.shape == (BATCH, PROMPT + NEW), f"{what}: output shape {out.shape}")
    _check(bool(((out >= 0) & (out < GPT["vocab_size"])).all()), f"{what}: tokens")
    _check(bool((out == gen_mod.generate_eager(net, prompts, NEW)).all()),
           f"{what}: generate == generate_eager")
    return (launches, gen_mod.build_generator(net),
            torch.as_tensor(prompts, device=net.device), gen_s)


def _moe_serve(torch, np, kernels, flash):
    """Phase 10 (b): the MoE GPT's greedy generate at phase 3's width;
    its prefill logits against the plain attention's (the plain run
    replaying the kernel run's routing, and routing by itself)."""
    from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
    from deeplearning4j_tpu_torch.nn.layers import transformer
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    net = gpt(**MOE_GPT).init()
    params_from_numpy(net, _random_params(net, seed=43))
    launches, g, ids, gen_s = _serve_check(torch, np, kernels, flash, net, "MoE")
    lengths = torch.full((BATCH,), PROMPT, device=ids.device)

    def prefill():
        return g.prefill(net.cast_params(net.params), ids, lengths, PROMPT + NEW)

    with _routing(torch, []) as routes:
        _, logits = prefill()
    with _plain_attention(torch, flash, transformer):
        with _routing(torch, []) as routes_p:
            _, logits_p = prefill()
        with _routing(torch, [], replay=routes):
            _, logits_r = prefill()
    shares = _routing_shares(routes, routes_p)
    _check(bool(logits.isfinite().all()), "finite MoE prefill logits")
    err_r = (logits - logits_r).abs().max().item()
    _check(err_r <= LOGIT_TOL, f"MoE prefill logits kernel vs plain (same "
           f"routing): {err_r} > {LOGIT_TOL}")
    err_p = (logits - logits_p).abs().max().item()
    if not any(sh["expert"] for sh in shares):  # no flip: the same routing
        _check(err_p <= LOGIT_TOL, f"MoE prefill logits kernel vs plain: "
               f"{err_p} > {LOGIT_TOL}")
    m = dict(generate_s=gen_s, tokens_per_s=BATCH * NEW / gen_s,
             prefill_ms=_time_ms(torch, prefill, 5), launches=launches,
             prefill_logit_max_abs_diff_vs_plain_same_routing=err_r,
             prefill_logit_max_abs_diff_vs_plain=err_p,
             prefill_routing_vs_plain=shares)
    print("moe_generate " + json.dumps(m), flush=True)
    return m


def _quantized_serve(torch, np, kernels, flash):
    """Phase 10 (c): phase 3's dense GPT quantized to int8 and to fp8:
    greedy generate, prefill logits against the same quantized net with
    the plain attention, the parameter bytes, and the accuracy gate
    against the unquantized net (printed: random weights give flat
    logits)."""
    from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
    from deeplearning4j_tpu_torch.nn import quantize as q
    from deeplearning4j_tpu_torch.nn.layers import transformer
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    net = gpt(**GPT).init()
    params_from_numpy(net, _random_params(net, seed=7))
    out = {"param_bytes": {"float32": q.quantized_param_bytes(net.params)}}
    for mode in q.quant_modes():
        qn = q.quantize(net, mode)
        launches, g, ids, gen_s = _serve_check(torch, np, kernels, flash, qn, mode)
        lengths = torch.full((BATCH,), PROMPT, device=ids.device)

        def prefill():
            return g.prefill(qn.cast_params(qn.params), ids, lengths, PROMPT + NEW)

        _, logits = prefill()
        with _plain_attention(torch, flash, transformer):
            _, logits_p = prefill()
        _check(bool(logits.isfinite().all()), f"{mode}: finite prefill logits")
        err = (logits - logits_p).abs().max().item()
        _check(err <= LOGIT_TOL, f"{mode} prefill logits kernel vs plain: "
               f"{err} > {LOGIT_TOL}")
        out["param_bytes"][mode] = q.quantized_param_bytes(qn.params)
        out[mode] = dict(generate_s=gen_s, tokens_per_s=BATCH * NEW / gen_s,
                         prefill_ms=_time_ms(torch, prefill, 5),
                         launches=launches,
                         prefill_logit_max_abs_diff_vs_plain=err,
                         accuracy_gate=q.accuracy_gate(net, qn))
        del qn, g
    print("quantized_generate " + json.dumps(out), flush=True)
    return out


def attention_layer_conf(layers=2):
    """Phase 10 (d)'s stack: causal residual AttentionLayers of
    ATTN_WIDTH over ATTN_HEADS heads and an RnnOutputLayer, bf16."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        AttentionLayer,
        RnnOutputLayer,
    )

    b = (NeuralNetConfiguration.builder().seed(0).learning_rate(3e-4)
         .updater("adam").activation("identity").weight_init("xavier")
         .compute_dtype("bfloat16").list())
    for _ in range(layers):
        b = b.layer(AttentionLayer(n_in=ATTN_WIDTH, n_out=ATTN_WIDTH,
                                   num_heads=ATTN_HEADS, causal=True,
                                   residual=True))
    return b.layer(RnnOutputLayer(n_in=ATTN_WIDTH, n_out=ATTN_CLASSES,
                                  activation="softmax",
                                  loss_function="mcxent")).build()


def _attention_layer(torch, np, kernels, flash):
    """Phase 10 (d): one ``gradient_and_score`` of the AttentionLayer
    stack, kernels against the plain versions; each flash kernel
    launches once per AttentionLayer."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.layers import attention
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    net = MultiLayerNetwork(attention_layer_conf()).init()
    params_from_numpy(net, _random_params(net, seed=44))
    rng = np.random.default_rng(45)
    ds = DataSet(rng.standard_normal((ATTN_BATCH, ATTN_SEQ, ATTN_WIDTH)).astype(np.float32),
                 rng.integers(0, ATTN_CLASSES, (ATTN_BATCH, ATTN_SEQ)).astype(np.float32))
    torch.cuda.synchronize()
    kernels.reset_launches()
    grads, loss = net.gradient_and_score(ds)
    torch.cuda.synchronize()
    launches = _port_launches(kernels)
    for name in (flash.KERNEL, flash.DQ_KERNEL, flash.DKV_KERNEL):
        _check(launches.get(name, 0) == 2, f"{name} launched "
               f"{launches.get(name, 0)} times in one AttentionLayer step, "
               f"expected 2: {launches}")
    with _plain_attention(torch, flash, attention):
        grads_p, loss_p = net.gradient_and_score(ds)
    _check(abs(loss - loss_p) <= TRAIN_LOSS_TOL,
           f"AttentionLayer loss kernels {loss} vs plain {loss_p}")
    worst, at = _grad_rel(torch, grads, grads_p)
    _check(worst <= TRAIN_GRAD_REL, f"AttentionLayer grad {at} kernels vs "
           f"plain: rel L2 {worst}")
    del grads, grads_p
    per_step = _device_times(torch, lambda: net.gradient_and_score(ds), 3)
    dev = {k: _sum_ms(per_step, k) for k in
           ("", "flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")}
    m = dict(loss=loss, loss_vs_plain=abs(loss - loss_p),
             grad_rel_l2_vs_plain_max=worst, grad_worst_at=at, launches=launches,
             step_device_ms=dev[""], flash_ms=dev["flash_fwd_kernel"]
             + dev["flash_dq_kernel"] + dev["flash_dkv_kernel"],
             profile_kept_share=per_step.kept_share)
    print("attention_layer " + json.dumps(m), flush=True)
    return m


def dbn_conf():
    """Phase 10 (e)'s DBN: RBM(784 -> 500, xent), AutoEncoder(500 ->
    250, mse, corruption 0.3), OutputLayer(250 -> 10), sigmoid, SGD
    0.1, f32, pretraining on."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        RBM,
        AutoEncoder,
        OutputLayer,
    )

    return (NeuralNetConfiguration.builder().seed(1).learning_rate(0.1)
            .updater("sgd").activation("sigmoid").list()
            .layer(RBM(n_in=784, n_out=500, loss_function="xent"))
            .layer(AutoEncoder(n_in=500, n_out=250, loss_function="mse",
                               corruption_level=0.3))
            .layer(OutputLayer(n_in=250, n_out=10, activation="softmax",
                               loss_function="mcxent"))
            .pretrain(True).build())


def _pretrain(torch, np, kernels):
    """Phase 10 (e): the DBN's ``pretrain`` at MNIST's width (no port
    kernel), the AE's reconstruction loss (without corruption, on the
    RBM's frozen activations) before and after a second epoch of its
    own, and one pretrain step per layer on the card against the CPU
    with the same uniforms."""
    from deeplearning4j_tpu_torch.datasets.mnist import load_mnist
    from deeplearning4j_tpu_torch.nn.layers import feedforward
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updater import init_updater_state
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy
    from deeplearning4j_tpu_torch.util.rng import fold_in

    data = load_mnist(train=True, num_examples=DBN_BATCH * DBN_BATCHES)
    net = MultiLayerNetwork(dbn_conf()).init()
    tree = _random_params(net, seed=46)
    params_from_numpy(net, tree)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    losses = net.pretrain(data, epochs=1, batch_size=DBN_BATCH)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    _check(not _port_launches(kernels),
           f"pretrain launched port kernels: {_port_launches(kernels)}")
    _check(set(losses) == {"layer0", "layer1"} and all(
        np.isfinite(v) for v in losses.values()), f"pretrain losses {losses}")
    # the AE's second epoch, on the RBM's frozen activations: its
    # reconstruction loss without corruption over the 8 minibatches
    batches = [net._tensor(data.features[i:i + DBN_BATCH])
               for i in range(0, DBN_BATCH * DBN_BATCHES, DBN_BATCH)]
    rbm, ae = net.impls[0], net.impls[1]

    @torch.no_grad()
    def ae_loss():
        return statistics.mean(float(ae.pretrain_loss(
            net.params["layer1"], rbm.forward(net.params["layer0"], x, {},
                                              False)[0], None))
            for x in batches)

    ae_before = ae_loss()
    ucfg = net._specs["layer1"][2]
    ust = {n: init_updater_state(ucfg, v) for n, v in net.params["layer1"].items()}
    key = int(net.gc.seed) + 104729 * 2
    for j, x in enumerate(batches):
        it = DBN_BATCHES + j
        new_p, ust, _ = net._pretrain_step(1, ust, it, x, fold_in(key, it))
        net.params = {**net.params, "layer1": new_p}
    ae_after = ae_loss()
    _check(np.isfinite(ae_after) and ae_after < ae_before,
           f"the AE's loss did not fall over a second epoch: {ae_before} -> "
           f"{ae_after}")

    # one step per layer, card against CPU, the same uniforms
    x = data.features[:DBN_BATCH]
    cpu = MultiLayerNetwork(dbn_conf(), device="cpu").init()
    card = MultiLayerNetwork(dbn_conf()).init()
    params_from_numpy(cpu, tree)
    params_from_numpy(card, tree)
    saved = feedforward.uniform_draw
    rel = {}
    try:
        for i in (0, 1):
            u = np.random.default_rng(47 + i).random((DBN_BATCH, 500)).astype(np.float32)
            out = []
            for net in (cpu, card):
                feedforward.uniform_draw = (
                    lambda key, shape, device, u=u: torch.as_tensor(
                        u[:, :shape[1]], device=device))
                ucfg = net._specs[f"layer{i}"][2]
                ust = {n: init_updater_state(ucfg, v)
                       for n, v in net.params[f"layer{i}"].items()}
                new_p, _, loss = net._pretrain_step(i, ust, 0, net._tensor(x), 5)
                out.append((new_p, float(loss)))
            (pc, lc), (pg, lg) = out
            rel[f"layer{i}"] = {"loss": abs(lg - lc) / abs(lc)} | {
                n: ((pg[n].cpu() - pc[n]).norm() / pc[n].norm()).item() for n in pc}
    finally:
        feedforward.uniform_draw = saved
    worst = max(v for r in rel.values() for v in r.values())
    _check(worst <= PRETRAIN_REL, f"pretrain step card vs CPU: {rel}")
    m = dict(losses=losses, ae_loss_after_epoch1=ae_before,
             ae_loss_after_epoch2=ae_after,
             pretrain_epoch_s=epoch_s, step_rel_card_vs_cpu=rel,
             step_rel_card_vs_cpu_max=worst)
    print("pretrain " + json.dumps(m), flush=True)
    return m


def phase_layers(torch, np, kernels, flash):
    """Phase 10: the rest of the layer library on the card."""
    out = {"moe_train": _moe_train(torch, np, kernels, flash)}
    _say(f"phase 10 (a): MoE gpt train step {out['moe_train']['step_ms']:.2f} ms")
    out["moe_generate"] = _moe_serve(torch, np, kernels, flash)
    _say("phase 10 (b): MoE gpt generate "
         f"{out['moe_generate']['tokens_per_s']:.1f} tokens/s")
    out["quantized"] = _quantized_serve(torch, np, kernels, flash)
    _say("phase 10 (c): int8 and fp8 gpt generate")
    out["attention_layer"] = _attention_layer(torch, np, kernels, flash)
    _say("phase 10 (d): AttentionLayer step within tolerance of the plain "
         "attention")
    out["pretrain"] = _pretrain(torch, np, kernels)
    _say("phase 10 (e): DBN pretrain, one step per layer card vs CPU within "
         f"{PRETRAIN_REL}")
    return out


def _layer_launches(entries, done):
    """Each kernel's launches on phase 10's paths, added to its entry of
    the kernels line: per MoE train step, per MoE generate, per int8 and
    fp8 generate, and per AttentionLayer step."""
    m = done["10"]
    for e in entries:
        name = e["name"]
        e["moe_train_launches_per_step"] = m["moe_train"]["launches"].get(name, 0)
        e["moe_generate_launches"] = m["moe_generate"]["launches"].get(name, 0)
        e["quantized_generate_launches"] = {
            mode: m["quantized"][mode]["launches"].get(name, 0)
            for mode in ("int8", "fp8")}
        e["attention_layer_launches_per_step"] = \
            m["attention_layer"]["launches"].get(name, 0)
    return entries


# phase 11: the scheduler's knobs, the requests and the f32 near-tie bound
PAGED = dict(slots=8, burst_tokens=8, block_size=16)
PAGED_REQUESTS, PAGED_PROMPTS = 16, (16, 64)
PAGED_TIE_F32 = 1e-4
# the serve whose profile gives the busy share: the first PAGED["slots"]
# requests, +32 tokens each (a steady window of full slots)
PAGED_WINDOW_NEW = 32


def _paged_requests(np):
    rng = np.random.default_rng(8)
    lengths = rng.integers(PAGED_PROMPTS[0], PAGED_PROMPTS[1] + 1,
                           PAGED_REQUESTS)
    return [rng.integers(0, GPT["vocab_size"], (1, int(t))) for t in lengths]


def _paged_serve(net, prompts, new=None, **kw):
    """Phase 11's traffic: the first half submitted, one ``step()``,
    then the rest, drained, each request for ``new`` tokens (NEW by
    default). Returns (the scheduler, each request's ids, the wall
    seconds)."""
    from deeplearning4j_tpu_torch.serving.continuous import \
        ContinuousDecodeScheduler

    import torch

    s = ContinuousDecodeScheduler(net=net, start=False, **dict(PAGED, **kw))
    half = len(prompts) // 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new = NEW if new is None else new
    futs = [s.submit(p, new) for p in prompts[:half]]
    s.step()
    futs += [s.submit(p, new) for p in prompts[half:]]
    _check(s.drain(600), "the scheduler did not drain")
    torch.cuda.synchronize()
    return s, [f.result(0) for f in futs], time.perf_counter() - t0


@contextlib.contextmanager
def _recording_gaps(torch, net):
    """Record, while ``generate_eager`` runs on ``net``, the top-two
    logit gap of every logits row its loop takes a token from (the
    prefill's, then each step's; kept on the card, fetched at the end):
    yields a list that holds one [steps, rows] array per run."""
    g = _gen_mod().build_generator(net)
    begin, step = g._begin, g._next
    runs, rows = [], []

    def gap(logits):
        top = logits.float().topk(2, dim=-1).values
        rows.append(top[:, 0] - top[:, 1])

    def rec_begin(*args):
        if rows:
            runs.append(torch.stack(rows).cpu().numpy())
            rows.clear()
        out = begin(*args)
        gap(out[2])
        return out

    def rec_next(*args):
        out = step(*args)
        gap(out[1])
        return out

    g._begin, g._next = rec_begin, rec_next
    try:
        yield runs
    finally:
        del g._begin, g._next
        if rows:
            runs.append(torch.stack(rows).cpu().numpy())


def _gen_mod():
    from deeplearning4j_tpu_torch.nn import generate as gen_mod

    return gen_mod


def _eager(torch, net, prompts):
    """Each prompt's solo ``generate_eager`` of NEW tokens, and the
    top-two logit gap at each of its generated positions."""
    with _recording_gaps(torch, net) as runs:
        out = [_gen_mod().generate_eager(net, p, NEW) for p in prompts]
    return out, [r[:, 0] for r in runs]


def _eager_gap(torch, net, prompt, tokens):
    """The top-two logit gap of a solo eager run (the generator's own
    prefill and decode steps, as ``generate_eager`` runs them) fed
    ``prompt`` and then ``tokens``, at the position after them."""
    import numpy as np

    _, t = prompt.shape
    g = _gen_mod().build_generator(net)
    ids = np.zeros((1, g.prompt_bucket(t, NEW)), np.int64)
    ids[:, :t] = prompt
    _, state, logits = g._begin(net.params, ids, np.array([t]), NEW)
    for tok in tokens:
        state, logits = g._next(state, torch.tensor([int(tok)],
                                                    device=net.device))
    top = logits[0].float().topk(2).values
    return (top[0] - top[1]).item()


def _parity(torch, net, prompts, got, want, bound, what, eager, gaps):
    """Each request's tokens equal ``want``'s, or the first position
    where they part is a near-tie (top-two logit gap within ``bound``)
    of a solo eager run along their common prefix: the gap ``eager``'s
    run recorded (``gaps``) where that prefix is ``eager``'s, else one
    ``_eager_gap`` replays. Returns (whole matches, the near-ties)."""
    import numpy as np

    whole, ties = 0, []
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        a, b = a[0, p.shape[1]:], b[0, p.shape[1]:]
        diff = np.flatnonzero(a != b)
        if not len(diff):
            whole += 1
            continue
        j = int(diff[0])
        if (b[:j] == eager[i][0, p.shape[1]:p.shape[1] + j]).all():
            gap = float(gaps[i][j])
        else:
            gap = _eager_gap(torch, net, p, b[:j])
        ties.append(dict(request=i, position=j, gap=gap))
        _check(gap <= bound, f"{what}: request {i} parts at generated token "
               f"{j} where the eager run's top-two gap is {gap} > {bound}")
    print(f"paged_parity {what}: {whole} of {len(got)} requests whole, "
          f"near-ties {json.dumps(ties)}", flush=True)
    return whole, ties


def _paged_tail(torch, np, kernels, net, prompt):
    """Phase 11 (d): ``prompt``'s first 72 tokens prefilled into 5 pool
    blocks (4 full, 1 partial) held by a cache owner; a sequence shares
    the 4 full blocks and copies the partial one on write, then
    prefills its 5-token tail through the pool. Its logits against a
    full prefill of all 77 tokens."""
    from deeplearning4j_tpu_torch.nn import generate as gen_mod
    from deeplearning4j_tpu_torch.nn.kvpool import PagedKVCachePool

    g = gen_mod.build_generator(net)
    pc = net.cast_params(net.params)
    bs = PAGED["block_size"]
    layers, heads, hd, dtype = g.kv_layout()
    pool = PagedKVCachePool(64, bs, layers, heads, hd, dtype, name="tail")
    m, t = 72, prompt.shape[1]
    cached = pool.alloc(pool.blocks_for(m), owner="cache")
    t_pad = g.prompt_bucket(m, 1)
    t_blk = -(-t_pad // bs) * bs
    ids = np.zeros((1, t_pad), np.int64)
    ids[0, :m] = prompt[0, :m]
    caches, _ = g.prefill_program(t_blk)(pc, ids, np.array([m]))
    table = np.zeros((1, t_blk // bs), np.int64)
    table[0, :len(cached)] = cached
    pool.set_layers(g.scatter_program(1, t_blk, bs)(pool.layers, caches,
                                                    table))
    shared = pool.share_blocks(cached[:-1], owner="seq")
    (cow,) = pool.alloc(1, owner="seq")
    partial = cached[-1]
    before = [layer["k"][partial].clone() for layer in pool.layers]
    pool.set_layers(g.block_copy_program(1, pool.num_blocks, bs)(
        pool.layers, [partial], [cow]))
    tier = 8
    tables = np.zeros((1, tier), np.int64)
    tables[0, :len(shared) + 1] = shared + [cow]
    tail = np.zeros((1, 8), np.int64)
    tail[0, :t - m] = prompt[0, m:]
    pools, tail_logits = g.tail_prefill_program(1, 8, tier, pool.num_blocks,
                                                bs)(
        pc, pool.layers, tail, np.array([m]), np.array([t - m]), tables)
    pool.set_layers(pools)
    kernels.reset_launches()
    full = np.zeros((1, g.prompt_bucket(t, 1)), np.int64)
    full[0, :t] = prompt[0]
    _, full_logits = g.prefill_program(full.shape[1])(pc, full, np.array([t]))
    _check(kernels.LAUNCHES.get("flash_fwd", 0) > 0,
           "the full prefill did not run the flash kernel")
    err = (tail_logits - full_logits).abs().max().item()
    _check(bool(torch.isfinite(tail_logits).all()), "finite tail logits")
    _check(err <= LOGIT_TOL, f"tail prefill through a shared table vs a full "
           f"prefill: {err} > {LOGIT_TOL}")
    _check(all(torch.equal(b, layer["k"][partial])
               for b, layer in zip(before, pool.layers)),
           "the tail's writes reached the shared partial block")
    pool.free_blocks(shared + [cow], owner="seq")
    pool.free_blocks(cached, owner="cache")
    _check(pool.free_count == pool.total_blocks, "the tail pool drained")
    return dict(tail_logit_max_abs_diff_vs_full_prefill=err,
                shared_blocks=len(shared), cached_tokens=m, tail_tokens=t - m)


def phase_paged(torch, np, kernels, flash):
    """Phase 11: paged serving at phase 3's width; returns its metrics."""
    from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
    from deeplearning4j_tpu_torch.nn import generate as gen_mod
    from deeplearning4j_tpu_torch.nn.kvpool import PagedKVCachePool
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    prompts = _paged_requests(np)
    nets = {}
    for dtype in ("bfloat16", "float32"):
        net = nets[dtype] = gpt(**dict(GPT, compute_dtype=dtype)).init()
        params_from_numpy(net, _random_params(net, seed=7))
    net = nets["bfloat16"]
    _say("phase 11: phase 3's gpt in bf16 and in f32")

    # (a) serve: the main path, counts read just after
    torch.cuda.synchronize()
    kernels.reset_launches()
    s, got, first_s = _paged_serve(net, prompts)
    launches = _port_launches(kernels)
    _check(launches.get(flash.KERNEL, 0) > 0,
           f"the admissions' prefills never launched flash_fwd: {launches}")
    st = s.stats()
    _check(st["pool"]["blocks_free"] == st["pool"]["blocks_total"],
           f"the pool did not drain: {st['pool']}")
    for p, out in zip(prompts, got):
        _check(out.shape == (1, p.shape[1] + NEW), f"shape {out.shape}")
        _check(bool(((out >= 0) & (out < GPT["vocab_size"])).all()), "tokens")
    t0 = time.perf_counter()
    eager, gaps = _eager(torch, net, prompts)
    eager_s = time.perf_counter() - t0
    whole, ties = _parity(torch, net, prompts, got, eager, LOGIT_TOL,
                          "bf16 vs generate_eager", eager, gaps)
    s2, got2, serve_s = _paged_serve(net, prompts)
    _check(all((a == b).all() for a, b in zip(got, got2)),
           "a second serve gave other tokens")
    ttft = sorted((c["t_first"] - c["t_submit"]) * 1e3 for c in s2.completed)
    # the busy share of a shorter steady window: one wave of requests
    # filling the slots, +PAGED_WINDOW_NEW each (torch.profiler's
    # processing of a whole serve's ~86,000 launches took ~29 s); the
    # profile's warm-up call is the window's timed serve
    window, timed = prompts[:PAGED["slots"]], []
    t0 = time.perf_counter()
    per = _device_times(torch, lambda: timed.append(
        _paged_serve(net, window, PAGED_WINDOW_NEW)), 1)
    profile_s = time.perf_counter() - t0
    window_s = timed[0][2]
    device_ms = _sum_ms(per)
    _say(f"phase 11 (a): serves {first_s:.2f} and {serve_s:.2f} s, "
         f"{len(prompts)} solo generate_eager {eager_s:.2f} s, the window's "
         f"timed and profiled serves {profile_s:.2f} s")
    s32, got32, _ = _paged_serve(nets["float32"], prompts)
    eager32, gaps32 = _eager(torch, nets["float32"], prompts)
    whole32, ties32 = _parity(torch, nets["float32"], prompts, got32, eager32,
                              PAGED_TIE_F32, "f32 vs generate_eager", eager32,
                              gaps32)
    tokens = PAGED_REQUESTS * NEW
    m = dict(requests=PAGED_REQUESTS, new_tokens=NEW,
             prompt_lengths=[int(p.shape[1]) for p in prompts],
             tokens_per_s=tokens / serve_s, serve_s=serve_s,
             first_serve_s=first_s, eager_s=eager_s,
             ttft_ms_median=statistics.median(ttft),
             ttft_ms_p90=ttft[int(0.9 * (len(ttft) - 1) + 0.5)],
             bursts=s2.stats()["bursts"],
             busy_window=dict(requests=len(window), new_tokens=PAGED_WINDOW_NEW,
                              wall_ms=window_s * 1e3, device_ms=device_ms),
             device_busy_share=device_ms / (window_s * 1e3),
             profile_kept_share=per.kept_share,
             pool_blocks=st["pool"]["blocks_total"] + 1,
             pool_bytes=(st["pool"]["blocks_total"] + 1)
             * st["pools"][0]["block_bytes"],
             whole_vs_eager=whole, near_ties_vs_eager=ties,
             whole_vs_eager_f32=whole32, near_ties_vs_eager_f32=ties32,
             launches=launches)
    _say(f"phase 11 (a): {tokens} tokens in {serve_s:.3f} s, {whole} of "
         f"{PAGED_REQUESTS} requests equal to generate_eager whole, "
         f"{whole32} in f32")
    m["telemetry"] = _paged_traced(net, prompts, got)
    _say(f"phase 11 (a): traced serve, counters as stats(), "
         f"{m['telemetry']['traces']} traces; tokens/s "
         f"{m['telemetry']['tokens_per_s_traced']:.1f} (request tracer on) vs "
         f"{m['tokens_per_s']:.1f} (off)")

    # (b) preemption on a pool of 4 full sequences
    blocks = 4 * -(-(PAGED_PROMPTS[1] + NEW) // PAGED["block_size"]) + 1
    sb, gotb, _ = _paged_serve(net, prompts, num_blocks=blocks)
    stb = sb.stats()
    _check(stb["preemptions"] > 0, "the 49-block pool never preempted")
    _check(stb["pool"]["blocks_free"] == stb["pool"]["blocks_total"],
           f"the preempting pool did not drain: {stb['pool']}")
    pool = sb._lane_for(None, None).pool
    try:
        pool.free_blocks([1])
        _check(False, "a double free did not raise")
    except RuntimeError as e:
        _check("double free" in str(e), f"double free raised {e}")
    whole_b, ties_b = _parity(torch, net, prompts, gotb, got, LOGIT_TOL,
                              "preempted vs (a)", eager, gaps)
    m.update(preemptions=stb["preemptions"], preempt_pool_blocks=blocks,
             whole_preempted_vs_a=whole_b, near_ties_preempted_vs_a=ties_b)
    _say(f"phase 11 (b): {stb['preemptions']} preemptions on {blocks} blocks, "
         f"{whole_b} of {PAGED_REQUESTS} requests equal to (a) whole")

    # (c) an int8 KV pool, twice
    runs = [_paged_serve(net, prompts, kv_quant="int8") for _ in range(2)]
    _check(all((a == b).all() for a, b in zip(runs[0][1], runs[1][1])),
           "two int8-pool serves gave other tokens")
    gen = [(a[0, p.shape[1]:], b[0, p.shape[1]:])
           for p, a, b in zip(prompts, runs[0][1], got)]
    _check(all(a[0] == b[0] for a, b in gen),
           "an int8-pool first token differs from (a)'s")
    layers, heads, hd, dtype = gen_mod.build_generator(net).kv_layout()
    m.update(int8_tokens_equal_to_a=float(np.mean(
        np.concatenate([a == b for a, b in gen]))),
        int8_requests_whole_as_a=sum(bool((a == b).all()) for a, b in gen),
        block_bytes={q or "bfloat16": PagedKVCachePool.bytes_per_block(
            layers, PAGED["block_size"], heads, hd, dtype, q)
            for q in (None, "int8")})
    _say(f"phase 11 (c): int8 pool, {m['int8_tokens_equal_to_a']:.4f} of the "
         f"tokens as (a)'s, block bytes {m['block_bytes']}")

    # (d) a tail prefill through a shared, copied-on-write table
    rng = np.random.default_rng(9)
    m["tail"] = _paged_tail(torch, np, kernels, net,
                            rng.integers(0, GPT["vocab_size"], (1, 77)))
    _say(f"phase 11 (d): tail prefill within "
         f"{m['tail']['tail_logit_max_abs_diff_vs_full_prefill']:.4f} of a "
         f"full prefill")
    print("paged_serve " + json.dumps(dict(
        {k: v for k, v in m.items() if k != "launches"}, card=_card())),
        flush=True)
    return m


def _paged_traced(net, prompts, untraced):
    """Phase 11's serve again with a fresh registry and a request
    tracer: the same tokens; the ``dl4j_sched_*`` counters equal the
    scheduler's ``stats()``, the pool's free gauge its total once
    drained, and the tokens delivered the admissions' first tokens plus
    ``dl4j_attr_decode_tokens_total`` (the scheduler's decode count; the
    reference's scheduler, too, ticks ``dl4j_decode_tokens_total`` only
    through ``generate``, which is checked after on one prompt); one
    ``decode_request`` trace per request with its ``queue_wait``,
    ``prefill`` and ``decode_burst`` spans; the flight recorder's dump
    and the Prometheus text pass the schema check."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.monitor import reqtrace
    from deeplearning4j_tpu_torch.nn.generate import generate

    reg = monitor.MetricsRegistry()
    old = monitor.set_registry(reg)
    reqtrace.configure_flight_recorder()
    tracer = reqtrace.enable_request_tracing()
    try:
        s, got, serve_s = _paged_serve(net, prompts)
        ids = generate(net, prompts[0], NEW)
    finally:
        reqtrace.disable_request_tracing()
        monitor.set_registry(old)
    _check(all((a == b).all() for a, b in zip(got, untraced)),
           "the traced serve gave other tokens")
    _check(ids.shape == (1, prompts[0].shape[1] + NEW), f"generate {ids.shape}")
    st = s.stats()
    value = lambda name, **kw: (reg.get(name, **kw).value  # noqa: E731
                                if reg.get(name, **kw) is not None else 0)
    counts = {k: value(f"dl4j_sched_{k}_total") for k in
              ("admitted_rows", "retired_rows", "bursts", "preemptions")}
    _check(counts == {k: st[k] for k in counts}, f"counters {counts} vs {st}")
    free = value(monitor.KVPOOL_BLOCKS_FREE_GAUGE, pool="decode")
    _check(free == st["pool"]["blocks_total"] == st["pool"]["blocks_free"],
           f"pool gauge {free} vs {st['pool']}")
    delivered = sum(c["tokens"] for c in s.completed)
    decoded = value(monitor.ATTR_DECODE_TOKENS_COUNTER, model="default")
    _check(delivered == PAGED_REQUESTS * NEW == decoded + st["admitted_rows"],
           f"{delivered} tokens delivered, {decoded} decoded + "
           f"{st['admitted_rows']} admissions")
    _check(value(monitor.DECODE_TOKENS_COUNTER) == NEW
           and value(monitor.DECODE_REQUESTS_COUNTER) == 1,
           "generate's decode counters")
    traces = tracer.completed_traces()
    _check(len(traces) == PAGED_REQUESTS, f"{len(traces)} traces")
    for tr in traces:
        names = {sp["name"] for sp in tr["spans"]}
        roots = [sp for sp in tr["spans"] if sp["parent"] is None]
        _check(tr["name"] == "decode_request" and len(roots) == 1
               and {"queue_wait", "prefill", "decode_burst"} <= names,
               f"trace {tr['trace']}: {sorted(names)}, {len(roots)} roots")
    with tempfile.TemporaryDirectory() as tmp:
        dump = reqtrace.flight_recorder().dump(os.path.join(tmp, "flight.jsonl"))
        _schema_check([dump], reg.prometheus_text(), tmp)
    return dict(counts, pool_blocks_free=free, tokens_delivered=delivered,
                attr_decode_tokens=decoded, traces=len(traces),
                spans=int(reg.get(monitor.TRACE_SPANS_COUNTER).value),
                serve_s_traced=serve_s,
                tokens_per_s_traced=PAGED_REQUESTS * NEW / serve_s)


def _paged_launches(entries, done):
    """Each kernel's launches in phase 11's serve of 16 requests, added
    to its entry of the kernels line."""
    for e in entries:
        e["paged_serve_launches"] = done["11"]["launches"].get(e["name"], 0)
    return entries


# phase 12: the training services on phase 6's char-RNN (bf16, b 1024,
# seq 128, Adam 0.01): minibatches exported to disk, a checkpoint every
# 2 steps, a preemption after 3, the deferred scores' listener frequency
# and step count, the early-stopping epochs, and the solver's iterations
# on the f32 example
SERVICE_BATCHES, SERVICE_CKPT_EVERY, SERVICE_PREEMPT = 8, 2, 3
SERVICE_FREQUENCY, SERVICE_STEPS, SERVICE_EPOCHS = 5, 20, 3
SOLVER_ITERATIONS = 10


def _service_net(lr=0.01):
    """Phase 6's bf16 char-RNN on its seed-31 weights."""
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    net = _char_rnn("bfloat16", lr)
    params_from_numpy(net, _random_params(net, seed=31))
    return net


def _service_batches(np, n, seed):
    """``n`` minibatches of phase 6's shape from one Markov chain over
    its 64 characters: one-hot features and labels (the ids rolled by
    one) as uint8, as they are exported (``fit`` takes them to the net's
    dtype exactly)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    ids = _markov_ids(np, np.random.default_rng(seed), n * CHAR_BATCH, CHAR_SEQ,
                      CHAR_VOCAB)
    eye = np.eye(CHAR_VOCAB, dtype=np.uint8)
    return [DataSet(eye[part], eye[np.roll(part, -1, axis=1)])
            for part in np.split(ids, n)]


def _tree_diff(torch, got, want):
    """(bit for bit, the worst relative L2 over the leaves) of two
    nested dicts of tensors."""
    same, worst = True, 0.0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            s, r = _tree_diff(torch, g, w)
            same, worst = same and s, max(worst, r)
            continue
        same = same and torch.equal(g, w)
        rel = ((g.float() - w.float()).norm()
               / w.float().norm().clamp_min(1e-30)).item()
        worst = max(worst, rel if torch.isfinite(g).all() else float("inf"))
    return same, worst


def _same_run(torch, got, want, exact, what):
    """Gate two runs' trees: bit for bit where the step is deterministic
    on this card (``exact``), else within CHAR_GRAD_REL (relative L2)."""
    same, worst = _tree_diff(torch, got, want)
    _check(same if exact else worst <= CHAR_GRAD_REL,
           f"{what}: bit for bit {same}, worst rel L2 {worst}")
    return worst


def _timed(torch, fn, into):
    """``fn`` wrapped to append each call's wall ms (synchronized) to
    ``into``."""
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        into.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapper


def _services_resume(torch, np, data_dir, root, exact):
    """(a) The 8 exported minibatches through ``ResumableTrainer`` at a
    checkpoint every 2 steps, uninterrupted, and again preempted after 3
    and resumed in a fresh trainer and a fresh shuffled iterator: the
    parameters and the updater state of the two runs equal."""
    from deeplearning4j_tpu_torch.datasets.export import ExportedDataSetIterator
    from deeplearning4j_tpu_torch.optimize.resumable import ResumableTrainer

    steps, saves = [], []

    def trainer(directory):
        t = ResumableTrainer(_service_net(), directory,
                             checkpoint_every=SERVICE_CKPT_EVERY)
        t.model.fit = _timed(torch, t.model.fit, steps)
        t._save = _timed(torch, t._save, saves)
        return t

    def cursor():
        return ExportedDataSetIterator(data_dir, shuffle=True, seed=9)

    ref = trainer(os.path.join(root, "uninterrupted"))
    ref.fit(cursor())
    first = trainer(os.path.join(root, "preempted"))
    _check(first.fit(cursor(), max_steps=SERVICE_PREEMPT) == SERVICE_PREEMPT,
           "the preempted run took other than 3 steps")
    again = trainer(os.path.join(root, "preempted"))
    it = cursor()
    t0 = time.perf_counter()
    again.resume_or_start(it)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    _check(again.steps_done == SERVICE_PREEMPT and it.state()["position"]
           == SERVICE_PREEMPT and again.model.device.type == "cuda",
           f"resume: {again.steps_done} steps, cursor {it.state()}")
    again.model.fit = _timed(torch, again.model.fit, steps)
    again.fit(it)
    worst = _same_run(torch, again.model.params, ref.model.params, exact,
                      "resumed vs uninterrupted parameters")
    worst_u = _same_run(torch, again.model.opt_state["updater"],
                        ref.model.opt_state["updater"], exact,
                        "resumed vs uninterrupted updater state")
    unit = os.path.join(root, "uninterrupted", "checkpoint")
    return dict(steps=len(steps), step_ms=steps, saves=len(saves),
                save_ms=saves, restore_ms=restore_ms,
                unit_bytes=sum(os.path.getsize(os.path.join(unit, f))
                               for f in os.listdir(unit)),
                params_rel_l2=worst, updater_rel_l2=worst_u)


def _services_supervisor(torch, np, batches, plain, exact):
    """(b) A supervised run over the batches against ``plain`` (the
    unsupervised run over them); then a batch of NaN features: one
    rollback, to the snapshot, and the next step at half the rate."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.optimize.supervisor import TrainingSupervisor
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    net = _service_net()
    sup = TrainingSupervisor(net)
    for ds in batches:
        _check(sup.step(ds), "a healthy batch was rolled back")
    worst = _same_run(torch, net.params, plain.params, exact,
                      "supervised vs unsupervised parameters")
    poisoned = DataSet(batches[0].features.astype(np.float32), batches[0].labels)
    poisoned.features[0, 0, 0] = np.nan
    before = {l: dict(p) for l, p in net.params.items()}
    _check(not sup.step(poisoned), "the NaN batch was not rolled back")
    rep = sup.report()
    _check(rep["rollbacks"] == 1 and rep["batches_skipped"] == [len(batches)],
           f"rollbacks: {rep}")
    same, _ = _tree_diff(torch, net.params, before)
    _check(same, "the parameters after the rollback are not the snapshot")
    half = _service_net(lr=0.01 * sup.lr_backoff)
    params_from_numpy(half, _host_tree(net))
    half.opt_state = net.opt_state
    sup.step(batches[1])
    half.fit(batches[1])
    worst_half = _same_run(torch, net.params, half.params, exact,
                           "the step after the rollback vs a step at 0.5 lr")
    return dict(rollbacks=rep["rollbacks"], batches_skipped=rep["batches_skipped"],
                lr_scale=rep["lr_scale"], supervised_rel_l2=worst,
                after_rollback_rel_l2=worst_half)


def _services_early_stopping(torch, np, data_dir, held_out, exact):
    """(c) ``EarlyStoppingTrainer`` for 3 epochs over the exported
    batches, scored on held-out minibatches of the same chain: the best
    model's held-out
    score equals the best score the trainer recorded (bit for bit where
    the step is deterministic, else within 1e-6 relative)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.export import ExportedDataSetIterator
    from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator,
        EarlyStoppingConfiguration,
        EarlyStoppingTrainer,
        InMemoryModelSaver,
        MaxEpochsTerminationCondition,
        ScoreImprovementEpochTerminationCondition,
    )

    held = DataSet(np.concatenate([d.features for d in held_out]),
                   np.concatenate([d.labels for d in held_out]))
    calc = lambda: DataSetLossCalculator(  # noqa: E731
        ListDataSetIterator(held, CHAR_BATCH))
    net = _service_net()
    cfg = EarlyStoppingConfiguration(
        epoch_termination_conditions=[
            MaxEpochsTerminationCondition(SERVICE_EPOCHS),
            ScoreImprovementEpochTerminationCondition(2)],
        score_calculator=calc(), model_saver=InMemoryModelSaver())
    t0 = time.perf_counter()
    res = EarlyStoppingTrainer(cfg, net, ExportedDataSetIterator(data_dir)).fit()
    es_s = time.perf_counter() - t0
    best = calc().calculate_score(res.best_model)
    rel = abs(best - res.best_model_score) / abs(res.best_model_score)
    _check(res.best_model is not net and (rel == 0.0 if exact else rel <= 1e-6),
           f"the best model scores {best} on the held-out set, the trainer "
           f"recorded {res.best_model_score}")
    return dict(total_epochs=res.total_epochs, best_epoch=res.best_model_epoch,
                best_score=res.best_model_score, best_model_rescored=best,
                termination=f"{res.termination_reason}/{res.termination_details}",
                seconds=es_s)


def _services_deferred(torch, np, batches, exact):
    """(d) 20 steps in one ``fit`` with a listener of frequency 5 and
    with one of frequency 1: the same scores at the listener's
    iterations, and 4 fetches (plus the end of fit's call) against 20."""
    from deeplearning4j_tpu_torch.optimize import CollectScoresIterationListener
    from deeplearning4j_tpu_torch.optimize.deferred import score_sink

    stream = [batches[i % len(batches)] for i in range(SERVICE_STEPS)]
    runs = {}
    for freq in (1, SERVICE_FREQUENCY):
        net = _service_net()
        listener = CollectScoresIterationListener(freq)
        net.set_listeners(listener)
        sink = score_sink(net)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(stream)
        torch.cuda.synchronize()
        runs[freq] = dict(scores=listener.scores, flushes=sink.flushes,
                          flush_calls=sink.flush_calls,
                          host_ms_per_step=(time.perf_counter() - t0) * 1e3
                          / SERVICE_STEPS)
    every, sparse = runs[1], runs[SERVICE_FREQUENCY]
    want = [(i, s) for i, s in every["scores"] if i % SERVICE_FREQUENCY == 0]
    _check(len(every["scores"]) == SERVICE_STEPS and len(sparse["scores"])
           == len(want) == SERVICE_STEPS // SERVICE_FREQUENCY,
           f"listener iterations {sparse['scores']} vs {want}")
    worst = max(abs(a[1] - b[1]) for a, b in zip(sparse["scores"], want))
    _check([i for i, _ in sparse["scores"]] == [i for i, _ in want]
           and (worst == 0.0 if exact else worst <= CHAR_LOSS_TOL),
           f"frequency {SERVICE_FREQUENCY} scores {sparse['scores']} vs {want}")
    _check((sparse["flushes"], sparse["flush_calls"]) ==
           (SERVICE_STEPS // SERVICE_FREQUENCY, SERVICE_STEPS // SERVICE_FREQUENCY + 1)
           and every["flushes"] == SERVICE_STEPS,
           f"fetches: frequency {SERVICE_FREQUENCY} {sparse['flushes']} "
           f"({sparse['flush_calls']} calls), frequency 1 {every['flushes']}")
    return dict(host_ms_per_step_frequency_1=every["host_ms_per_step"],
                host_ms_per_step_frequency_5=sparse["host_ms_per_step"],
                fetches_frequency_1=every["flushes"],
                fetches_frequency_5=sparse["flushes"],
                flush_calls_frequency_5=sparse["flush_calls"],
                score_max_abs_diff=worst)


def _services_solver(torch, np, kernels, lk):
    """(e) ``Solver`` with ``lbfgs`` on the f32 char-RNN example: the
    oracle's first gradient through the kernels against the plain
    versions' (EXAMPLE_GRAD_REL), the f32 LSTM kernels launched, and a
    loss that falls over SOLVER_ITERATIONS iterations."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.optimize.solvers import Solver, _FlatOracle
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    net = _char_rnn_example("lbfgs")
    params_from_numpy(net, _random_params(net, seed=41))
    ids = _markov_ids(np, np.random.default_rng(42), EXAMPLE_BATCH,
                      EXAMPLE_SEQ, EXAMPLE_VOCAB)
    eye = np.eye(EXAMPLE_VOCAB, dtype=np.float32)
    ds = DataSet(eye[ids], eye[np.roll(ids, -1, axis=1)])
    oracle = _FlatOracle(net, ds)
    _check(oracle.dtype == torch.float32, f"the oracle runs in {oracle.dtype}")
    kernels.reset_launches()
    f0, g = oracle.value_and_grad(oracle.flat0)
    grad_launches = _lstm_launches(kernels, lk)
    want = {lk.FWD_ONLY_KERNEL: 0, lk.FWD_KERNEL: 1, lk.BWD_KERNEL: 1,
            lk.DW_KERNEL: 1}
    _check(grad_launches == want, f"the oracle's gradient launched "
           f"{grad_launches}, expected {want}")
    with _plain_lstm(lk):
        f0_p, g_p = oracle.value_and_grad(oracle.flat0)
    as_tree = lambda v: oracle.unravel(torch.as_tensor(v))  # noqa: E731
    worst, at = _grad_rel(torch, as_tree(g), as_tree(g_p))
    _check(worst <= EXAMPLE_GRAD_REL and abs(f0 - f0_p) <= EXAMPLE_LOSS_REL * abs(f0_p),
           f"the oracle's gradient {at} kernels vs plain: rel L2 {worst}, "
           f"loss {f0} vs {f0_p}")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    f = Solver(net).optimize(ds, iterations=SOLVER_ITERATIONS)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = _lstm_launches(kernels, lk)
    _check(np.isfinite(f) and f < f0, f"lbfgs: loss {f0} -> {f}")
    _check(all(launches[k] > 0 for k in (lk.FWD_KERNEL, lk.BWD_KERNEL,
                                         lk.DW_KERNEL)),
           f"lbfgs launched {launches}")
    return dict(loss_first=f0, loss_last=f, iterations=SOLVER_ITERATIONS,
                solve_ms=solve_s * 1e3,
                ms_per_iteration=solve_s * 1e3 / SOLVER_ITERATIONS,
                first_grad_rel_l2_vs_plain=worst, first_grad_worst_at=at,
                oracle_grad_launches=grad_launches, launches=launches)


def phase_services(torch, np, kernels, lk):
    """Phase 12: the training services on phase 6's char-RNN at full
    width, and the classic solver on the f32 example. Returns its
    metrics; ``launches`` are the LSTM kernels' over (a)-(d)."""
    import tempfile

    from deeplearning4j_tpu_torch.datasets.export import export_dataset

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    # one Markov chain: 8 minibatches to train on, 2 held out
    stored = _service_batches(np, SERVICE_BATCHES + 2, 32)
    stored, held_out = stored[:SERVICE_BATCHES], stored[SERVICE_BATCHES:]
    # the runs from memory take f32 batches, as phase 6's fit does
    batches = [DataSet(d.features.astype(np.float32),
                       d.labels.astype(np.float32)) for d in stored]
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_services_") as root:
        data_dir = os.path.join(root, "data")
        t0 = time.perf_counter()
        export_dataset(stored, data_dir)
        out["export_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        kernels.reset_launches()
        # two identical runs of phase 6's step over the batches: the gates
        # below are bit for bit where these agree bit for bit
        plain, twin = _service_net(), _service_net()
        for ds in batches:
            plain.fit(ds)
            twin.fit(ds)
        exact, worst = _tree_diff(torch, twin.params, plain.params)
        out["deterministic"] = dict(bit_for_bit=exact, rel_l2=worst)
        del twin
        _say(f"phase 12: two runs of the step bit for bit: {exact} "
             f"(rel L2 {worst})")
        out["resume"] = _services_resume(torch, np, data_dir, root, exact)
        r = out["resume"]
        _say(f"phase 12 (a): preempted at {SERVICE_PREEMPT} and resumed equals "
             f"the uninterrupted run; {r['saves']} saves, median "
             f"{statistics.median(r['save_ms']):.1f} ms, restore "
             f"{r['restore_ms']:.1f} ms, unit {r['unit_bytes']} bytes")
        out["supervisor"] = _services_supervisor(torch, np, batches, plain, exact)
        del plain
        _say("phase 12 (b): supervised run as the plain one; one rollback to "
             "the snapshot, the next step at 0.5 lr")
        out["early_stopping"] = _services_early_stopping(torch, np, data_dir,
                                                         held_out, exact)
        _say(f"phase 12 (c): early stopping, best epoch "
             f"{out['early_stopping']['best_epoch']} of "
             f"{out['early_stopping']['total_epochs']}")
    out["deferred"] = _services_deferred(torch, np, batches, exact)
    torch.cuda.synchronize()
    out["launches"] = launches = _lstm_launches(kernels, lk)
    _check(all(launches[k] > 0 for k in (lk.FWD_KERNEL, lk.BWD_KERNEL,
                                         lk.DW_KERNEL, lk.FWD_ONLY_KERNEL)),
           f"the services' runs launched {launches}")
    d = out["deferred"]
    _say(f"phase 12 (d): host ms per step {d['host_ms_per_step_frequency_1']:.2f} "
         f"(frequency 1) and {d['host_ms_per_step_frequency_5']:.2f} "
         f"(frequency 5), {d['fetches_frequency_5']} fetches against "
         f"{d['fetches_frequency_1']}")
    out["solver"] = _services_solver(torch, np, kernels, lk)
    s = out["solver"]
    _say(f"phase 12 (e): lbfgs loss {s['loss_first']:.4f} -> "
         f"{s['loss_last']:.4f} in {s['solve_ms']:.0f} ms")
    print("services " + json.dumps(dict(out, card=_card())), flush=True)
    return out


def _service_launches(entries, done):
    """Each kernel's launches in phase 12: over the services' runs (a)-(d)
    on the bf16 char-RNN, and over the f32 example's ``lbfgs`` solve."""
    m = done["12"]
    for e in entries:
        e["services_launches"] = m["launches"].get(e["name"], 0)
        e["solver_launches"] = m["solver"]["launches"].get(e["name"], 0)
    return entries


# phase 13: the feed pipeline. (a) phase 6's char-RNN over FEED_FULL
# minibatches of CHAR_BATCH and a ragged tail of FEED_TAIL rows; (b)
# phase 4's GPT over FEED_GPT minibatches of TRAIN_BATCH; (c) the native
# IO arrays (FEED_ROWS x FEED_COLS f32, and ids over FEED_COLS classes),
# and MLP-Iris through the Iris CSV for FEED_IRIS_STEPS steps of
# FEED_IRIS_BATCH (4 full and a padded tail of 22 an epoch); the
# pipelined steps left out of the busy share's window
FEED_FULL, FEED_TAIL, FEED_GPT = 8, 300, 4
FEED_ROWS, FEED_COLS = 8192, 3072
FEED_IRIS_BATCH, FEED_IRIS_STEPS = 32, 20
FEED_SKIP = 2


def _feed_run(torch, net, it, pipeline, snapshot_at=None):
    """``net.fit(it, feed_pipeline=pipeline)``, each step timed on the
    host up to the end of its work on the compute stream; returns each
    step's (score, host ms, rows, labels-mask shape, launches) and the
    parameters before step ``snapshot_at`` + 1 (cloned)."""
    from deeplearning4j_tpu_torch import kernels

    steps, snap = [], {}
    inner = net._fit_batch

    def step(ds):
        if net.opt_state["step"] == snapshot_at:
            snap["params"] = {k: {n: t.clone() for n, t in v.items()}
                              for k, v in net.params.items()}
        before = collections.Counter(kernels.LAUNCHES)
        stream = torch.cuda.current_stream()
        stream.synchronize()
        t0 = time.perf_counter()
        inner(ds)
        stream.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        lm = ds.labels_mask
        steps.append(dict(score=float(net._score), host_ms=ms,
                          rows=int(ds.features.shape[0]),
                          labels_mask=None if lm is None else list(lm.shape),
                          launches=dict(kernels.LAUNCHES - before)))

    net._fit_batch = step
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(it, feed_pipeline=pipeline)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del net._fit_batch
    return steps, snap.get("params"), wall_ms


def _feed_profile(torch, fn, first):
    """One torch.profiler trace of ``fn`` (a pipelined ``fit``): the
    compute stream's (the LSTM kernels') busy share over a steady window,
    from the start of its ``first``-th ``lstm_fwd_kernel`` event (0-based)
    to the end of its last event, the window's ms, the LSTM forward
    events kept, and each host-to-device copy name's streams, count and
    median ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    fwd = sorted((e for e in dev if "lstm_fwd_kernel" in e.name),
                 key=lambda e: e.time_range.start)
    _check(len(fwd) > first, f"the profile kept {len(fwd)} lstm_fwd_kernel events")
    stream, t0 = fwd[0].device_resource_id, fwd[first].time_range.start
    on = [e for e in dev if e.device_resource_id == stream and e.time_range.end > t0]
    t1 = max(e.time_range.end for e in on)
    busy = sum(e.time_range.end - max(e.time_range.start, t0) for e in on)
    copies = collections.defaultdict(list)
    for e in dev:
        if "Memcpy HtoD" in e.name:
            copies[e.name].append((e.device_resource_id,
                                   (e.time_range.end - e.time_range.start) / 1e3))
    return dict(busy_share=busy / (t1 - t0), window_ms=(t1 - t0) / 1e3,
                lstm_fwd_events=len(fwd), compute_stream=stream,
                copies={name: dict(streams=sorted({st for st, _ in v}),
                                   count=len(v),
                                   ms_each_median=statistics.median(
                                       ms for _, ms in v))
                        for name, v in copies.items()})


def _feed_char(torch, np, kernels, lk):
    """Phase 13 (a): the char-RNN through the pipeline, off and on."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.datasets.staging import stager_of

    n = FEED_FULL * CHAR_BATCH + FEED_TAIL
    ids = _markov_ids(np, np.random.default_rng(35), n, CHAR_SEQ)
    eye = np.eye(CHAR_VOCAB, dtype=np.float32)
    ds = DataSet(eye[ids], eye[np.roll(ids, -1, axis=1)])
    runs = {}
    for pipeline in (False, True):
        net = _service_net()
        torch.cuda.synchronize()
        kernels.reset_launches()
        steps, snap, wall = _feed_run(torch, net, ListDataSetIterator(ds, CHAR_BATCH),
                                      pipeline, snapshot_at=FEED_FULL)
        runs[pipeline] = dict(steps=steps, snap=snap, wall=wall, net=net,
                              launches=_lstm_launches(kernels, lk))
    off, on = runs[False], runs[True]
    telemetry = _feed_traced(torch, ds, on)
    _check(len(off["steps"]) == len(on["steps"]) == FEED_FULL + 1,
           f"steps {len(off['steps'])}, {len(on['steps'])}")
    _check([s["score"] for s in on["steps"][:FEED_FULL]]
           == [s["score"] for s in off["steps"][:FEED_FULL]],
           "pipelined scores over the full steps are not the plain fit's: "
           f"{[s['score'] for s in on['steps']]} vs "
           f"{[s['score'] for s in off['steps']]}")
    same, worst = _tree_diff(torch, on["snap"], off["snap"])
    _check(same, f"parameters after {FEED_FULL} steps differ (rel L2 {worst})")
    t_on, t_off = on["steps"][-1], off["steps"][-1]
    _check(t_on["rows"] == CHAR_BATCH and t_on["labels_mask"] == [CHAR_BATCH, CHAR_SEQ]
           and t_off["rows"] == FEED_TAIL and t_off["labels_mask"] is None,
           f"tail steps: pipelined {t_on}, plain {t_off}")
    want = {lk.FWD_KERNEL: 2, lk.BWD_KERNEL: 2, lk.DW_KERNEL: 2}
    _check(all(t_on["launches"].get(k, 0) == v for k, v in want.items()),
           f"the padded tail step launched {t_on['launches']}, expected {want}")
    tail_score_diff = abs(t_on["score"] - t_off["score"])
    _check(tail_score_diff <= CHAR_LOSS_TOL,
           f"tail score padded {t_on['score']} vs unpadded {t_off['score']}")
    upd_on = {k: {n: on["net"].params[k][n] - t for n, t in v.items()}
              for k, v in on["snap"].items()}
    upd_off = {k: {n: off["net"].params[k][n] - t for n, t in v.items()}
               for k, v in off["snap"].items()}
    upd_bits, upd_rel = _tree_diff(torch, upd_on, upd_off)
    _check(upd_rel <= CHAR_GRAD_REL,
           f"tail update padded vs unpadded: rel L2 {upd_rel}")
    del upd_on, upd_off, off["net"], off["snap"], on["snap"]

    # the full batches again in one pipelined fit, unsynchronized: its
    # wall time, and from a profile the compute stream's busy share from
    # step FEED_SKIP + 1 on and where the staging copies ran
    net = on["net"]
    full = DataSet(ds.features[:FEED_FULL * CHAR_BATCH],
                   ds.labels[:FEED_FULL * CHAR_BATCH])

    def pipelined():
        net.fit(ListDataSetIterator(full, CHAR_BATCH))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipelined()
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    trace = _feed_profile(torch, pipelined, 2 * FEED_SKIP)
    stager = stager_of(net)
    _check(stager.stream is not None and stager.copies > 0
           and stager.stream != torch.cuda.current_stream(),
           "the staging copies did not run on the feed's own stream")
    host = lambda run: [round(s["host_ms"], 3) for s in run["steps"]]  # noqa: E731
    return dict(
        steps=FEED_FULL + 1, rows=n, scores_bit_for_bit=True,
        params_bit_for_bit=True, tail_rows=[t_on["rows"], t_off["rows"]],
        tail_labels_mask=t_on["labels_mask"], tail_launches=t_on["launches"],
        tail_score=[t_on["score"], t_off["score"]],
        tail_score_diff=tail_score_diff, tail_update_rel_l2=upd_rel,
        tail_update_bit_for_bit=upd_bits,
        host_ms_per_step_off=host(off), host_ms_per_step_on=host(on),
        host_ms_median_full_off=statistics.median(
            s["host_ms"] for s in off["steps"][1:FEED_FULL]),
        host_ms_median_full_on=statistics.median(
            s["host_ms"] for s in on["steps"][1:FEED_FULL]),
        fit_wall_ms=[off["wall"], on["wall"]],
        full_fit_ms_per_step=fit_ms / FEED_FULL,
        device_busy_share=trace["busy_share"],
        window_ms_per_step=trace["window_ms"] / (FEED_FULL - FEED_SKIP),
        trace=trace, feed_stream_id=stager.stream.stream_id,
        compute_stream_id=torch.cuda.current_stream().stream_id,
        staged_bytes=stager.nbytes, staged_copies=stager.copies,
        telemetry=telemetry, launches=on["launches"])


def _schema():
    """``scripts/check_telemetry_schema.py`` of this checkout, loaded by
    path (it imports nothing of the packages)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "check_telemetry_schema.py")
    spec = importlib.util.spec_from_file_location("check_telemetry_schema", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _schema_check(files, metrics_text, tmp):
    """``check_telemetry_schema.main`` over ``files`` and the Prometheus
    text; fails unless it returns 0."""
    metrics = os.path.join(tmp, "metrics.txt")
    with open(metrics, "w") as f:
        f.write(metrics_text)
    rc = _schema().main(list(files) + ["--metrics", metrics, "--check-names"])
    _check(rc == 0, f"check_telemetry_schema rejected {files} + metrics")


def _feed_traced(torch, ds, untraced):
    """Phase 13 (a)'s pipelined fit again from the same weights with a
    fresh registry and a tracer: bit for bit the untraced run's scores
    and parameters; the feed's counters equal the port's own counts (the
    stager's bytes, one padded tail, the deferred ring's fetches, one
    dispatch miss per signature); a ``compile`` span at each signature's
    first step and ``device_step`` spans at the others; the JSONL, the
    Chrome trace and the Prometheus text pass the schema check."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.datasets.staging import stager_of
    from deeplearning4j_tpu_torch.optimize.deferred import score_sink

    net = _service_net()
    reg = monitor.MetricsRegistry()
    old = monitor.set_registry(reg)
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, "events.jsonl")
        tracer = monitor.enable_tracing(jsonl)
        try:
            steps, _, wall = _feed_run(torch, net, ListDataSetIterator(ds, CHAR_BATCH),
                                       True)
        finally:
            monitor.disable_tracing()
            monitor.set_registry(old)
        chrome = tracer.export_chrome_trace(os.path.join(tmp, "trace.json"))
        _schema_check([jsonl, chrome], reg.prometheus_text(), tmp)
    _check([s["score"] for s in steps] == [s["score"] for s in untraced["steps"]],
           "traced scores are not the untraced run's: "
           f"{[s['score'] for s in steps]} vs "
           f"{[s['score'] for s in untraced['steps']]}")
    same, worst = _tree_diff(torch, net.params, untraced["net"].params)
    _check(same, f"traced parameters differ from the untraced run's (rel L2 {worst})")
    value = lambda name: reg.get(name).value  # noqa: E731
    stager, sigs = stager_of(net), net.__dict__["_dispatch_sigs"]
    counts = dict(h2d_bytes=value(monitor.H2D_BYTES_COUNTER),
                  stager_nbytes=stager.nbytes,
                  padded_batches=value(monitor.FEED_PADDED_BATCHES_COUNTER),
                  score_syncs=value(monitor.SCORE_SYNC_COUNTER),
                  ring_fetches=score_sink(net).flushes,
                  dispatch_misses=value(monitor.JIT_CACHE_MISS_COUNTER),
                  signatures=len(sigs))
    _check(counts["h2d_bytes"] == stager.nbytes > 0
           and counts["padded_batches"] == 1
           and counts["score_syncs"] == counts["ring_fetches"]
           and counts["dispatch_misses"] == len(sigs) == 2, f"counters {counts}")
    kinds = [e["name"] for e in tracer.events()
             if e["name"] in ("compile", "device_step")]
    # the padded tail carries a labels mask: the second signature
    want = ["compile"] + ["device_step"] * (FEED_FULL - 1) + ["compile"]
    _check(kinds == want, f"step spans {kinds}, expected {want}")
    # one more untraced run after the traced one, so that the traced
    # run's step time sits between two untraced ones
    after, _, _ = _feed_run(torch, _service_net(),
                            ListDataSetIterator(ds, CHAR_BATCH), True)
    median = lambda run: statistics.median(  # noqa: E731
        s["host_ms"] for s in run[1:FEED_FULL])
    return dict(counts, step_spans=kinds, scores_bit_for_bit=True,
                params_bit_for_bit=True, events=len(tracer.events()),
                dropped=tracer.dropped, fit_wall_ms_traced=wall,
                host_ms_median_full_traced=median(steps),
                host_ms_median_full_untraced=median(untraced["steps"]),
                host_ms_median_full_untraced_after=median(after))


def _feed_gpt(torch, np, kernels, flash):
    """Phase 13 (b): phase 4's GPT through the pipeline, off and on."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    ids = np.random.default_rng(12).integers(
        0, TRAIN["vocab_size"], (FEED_GPT * TRAIN_BATCH, TRAIN["max_len"]))
    ds = DataSet(ids.astype(np.float32),
                 np.roll(ids, -1, axis=1).astype(np.float32))
    runs = {}
    for pipeline in (False, True):
        net = gpt(**TRAIN).init()
        params_from_numpy(net, _random_params(net, seed=11))
        torch.cuda.synchronize()
        kernels.reset_launches()
        steps, _, wall = _feed_run(torch, net, ListDataSetIterator(ds, TRAIN_BATCH),
                                   pipeline)
        runs[pipeline] = dict(steps=steps, wall=wall, params=net.params,
                              launches={k: kernels.LAUNCHES.get(k, 0) for k in (
                                  flash.KERNEL, flash.DQ_KERNEL, flash.DKV_KERNEL)})
        del net
    off, on = runs[False], runs[True]
    _check([s["score"] for s in on["steps"]] == [s["score"] for s in off["steps"]]
           and len(on["steps"]) == FEED_GPT,
           f"gpt scores: pipelined {[s['score'] for s in on['steps']]}, plain "
           f"{[s['score'] for s in off['steps']]}")
    same, worst = _tree_diff(torch, on["params"], off["params"])
    _check(same, f"gpt parameters pipelined vs plain: rel L2 {worst}")
    for s in on["steps"]:
        per = {k: s["launches"].get(k, 0) for k in on["launches"]}
        _check(all(v == TRAIN["n_layers"] for v in per.values()),
               f"a pipelined gpt step launched {per}")
    return dict(steps=FEED_GPT, scores=[s["score"] for s in on["steps"]],
                scores_bit_for_bit=True, params_bit_for_bit=True,
                host_ms_per_step_off=[s["host_ms"] for s in off["steps"]],
                host_ms_per_step_on=[s["host_ms"] for s in on["steps"]],
                fit_wall_ms=[off["wall"], on["wall"]], launches=on["launches"])


def _best_ms(fn, reps=3):
    """The least wall ms of ``reps`` calls of ``fn``, and its result."""
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, out


def _write_fractions_csv(np, path, ints):
    """A CSV of ``ints / 512`` (ints in [-4096, 4096)), each cell the
    exact decimal in 12 characters: written as bytes from a table of the
    8192 cells, which formats 25 M cells in about a second."""
    table = np.frombuffer(b"".join(f"{k / 512:12.9f},".encode()
                                   for k in range(-4096, 4096)),
                          np.uint8).reshape(8192, 13)
    cells = table[ints + 4096]
    cells[:, -1, -1] = ord("\n")
    cells.tofile(path)


def _feed_native(torch, np):
    """Phase 13 (c): the native IO library built here against NumPy, and
    MLP-Iris trained from the Iris CSV through DataVec and the
    pipeline."""
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.datasets import native_batcher as nb
    from deeplearning4j_tpu_torch.datasets.iris import IRIS_CSV
    from deeplearning4j_tpu_torch.datasets.iterators import MultipleEpochsIterator
    from deeplearning4j_tpu_torch.datasets.normalizers import NormalizerStandardize
    from deeplearning4j_tpu_torch.datavec import (
        CSVRecordReader,
        RecordReaderDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    shutil.rmtree(native.BUILD_DIR, ignore_errors=True)
    native._lib, native._tried = None, False
    t0 = time.perf_counter()
    lib = native.get_lib()
    build_s = time.perf_counter() - t0
    _check(lib is not None and os.path.exists(native.LIB),
           "the native IO library did not build from the checkout's source")
    rng = np.random.default_rng(36)
    # exact binary fractions: every parser reads the same floats
    ints = rng.integers(-4096, 4096, (FEED_ROWS, FEED_COLS))
    src = (ints / 512).astype(np.float32)
    idx = rng.integers(0, FEED_ROWS, FEED_ROWS)
    ids = rng.integers(0, FEED_COLS, FEED_ROWS)
    mean, std = src.mean(axis=0), src.std(axis=0)
    sd = np.where(std != 0.0, std, np.float32(1.0))
    out = {"build_s": build_s}
    for what, fn, plain in (
            ("gather", lambda: nb.gather_rows(src, idx), lambda: src[idx]),
            ("gather_normalize", lambda: nb.gather_rows(src, idx, mean, std),
             lambda: (src[idx] - mean) / sd),
            ("one_hot", lambda: nb.one_hot(ids, FEED_COLS),
             lambda: np.eye(FEED_COLS, dtype=np.float32)[ids])):
        ms, got = _best_ms(fn)
        plain_ms, want = _best_ms(plain)
        _check(got.dtype == want.dtype and np.array_equal(got, want),
               f"native {what} is not its NumPy form")
        out[what] = dict(native_ms=ms, numpy_ms=plain_ms)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_feed_") as d:
        path = os.path.join(d, "data.csv")
        t0 = time.perf_counter()
        _write_fractions_csv(np, path, ints)
        write_ms = (time.perf_counter() - t0) * 1e3
        ms, got = _best_ms(lambda: native.csv_read_floats(path, strict=True), 2)
        plain_ms, want = _best_ms(
            lambda: np.loadtxt(path, delimiter=",", dtype=np.float32), 1)
        _check(np.array_equal(got, want) and np.array_equal(got, src),
               "native csv_read_floats is not np.loadtxt's array")
        out["csv_parse"] = dict(native_ms=ms, numpy_loadtxt_ms=plain_ms,
                                write_ms=write_ms, bytes=os.path.getsize(path))

    it = RecordReaderDataSetIterator(CSVRecordReader(IRIS_CSV, skip_lines=1),
                                     FEED_IRIS_BATCH, label_index=-1, num_classes=3)
    norm = NormalizerStandardize().fit(it)
    it.set_pre_processor(norm)
    it.reset()
    whole = norm.transform(RecordReaderDataSetIterator(
        CSVRecordReader(IRIS_CSV, skip_lines=1), 150, label_index=-1,
        num_classes=3).next())
    net = MultiLayerNetwork(_mlp_iris_conf("bfloat16")).init()
    before = net.score(whole)
    epochs = FEED_IRIS_STEPS // 5
    steps, _, wall = _feed_run(torch, net, MultipleEpochsIterator(epochs, it), True)
    after = net.score(whole)
    _check(len(steps) == FEED_IRIS_STEPS
           and [s["rows"] for s in steps[:5]] == [FEED_IRIS_BATCH] * 5
           and steps[4]["labels_mask"] == [FEED_IRIS_BATCH],
           f"iris steps {[(s['rows'], s['labels_mask']) for s in steps]}")
    _check(np.isfinite(after) and after < before,
           f"MLP-Iris loss through the CSV did not fall: {before} -> {after}")
    out["iris"] = dict(steps=len(steps), loss_before=before, loss_after=after,
                       host_ms_per_step=[s["host_ms"] for s in steps],
                       fit_wall_ms=wall)
    return out


def phase_feed(torch, np, kernels, flash, lk):
    """Phase 13: the feed pipeline on the card. Returns its metrics;
    ``launches`` are the port's kernels' in the pipelined runs of (a) and
    (b)."""
    out = {"char": _feed_char(torch, np, kernels, lk)}
    c = out["char"]
    _say(f"phase 13 (a): char-RNN through the pipeline bit for bit over "
         f"{FEED_FULL} steps; host ms per full step {c['host_ms_median_full_off']:.2f}"
         f" (off) vs {c['host_ms_median_full_on']:.2f} (on); padded tail score "
         f"within {c['tail_score_diff']:.2e}, update rel L2 "
         f"{c['tail_update_rel_l2']:.2e}; busy {c['device_busy_share']:.3f}")
    tel = c["telemetry"]
    _say(f"phase 13 (a): traced fit bit for bit, counters {dict((k, tel[k]) for k in ('h2d_bytes', 'padded_batches', 'score_syncs', 'dispatch_misses'))}"
         f"; host ms per full step {tel['host_ms_median_full_traced']:.3f} "
         f"(tracing on) vs {tel['host_ms_median_full_untraced']:.3f} and "
         f"{tel['host_ms_median_full_untraced_after']:.3f} (off, before and after)")
    out["gpt"] = _feed_gpt(torch, np, kernels, flash)
    _say("phase 13 (b): gpt through the pipeline bit for bit, 8 launches of "
         "each flash kernel per step")
    out["native"] = _feed_native(torch, np)
    n = out["native"]
    _say(f"phase 13 (c): native gather {n['gather']['native_ms']:.1f} ms vs "
         f"{n['gather']['numpy_ms']:.1f} (NumPy), csv parse "
         f"{n['csv_parse']['native_ms']:.0f} ms vs "
         f"{n['csv_parse']['numpy_loadtxt_ms']:.0f}; iris loss "
         f"{n['iris']['loss_before']:.4f} -> {n['iris']['loss_after']:.4f}")
    out["launches"] = dict(c["launches"])
    out["launches"].update(out["gpt"]["launches"])
    print("feed " + json.dumps(dict(out, card=_card())), flush=True)
    return out


def _feed_launches(entries, done):
    """Each kernel's launches in phase 13's pipelined runs (the char-RNN's
    9 steps, the gpt's 4), added to its entry of the kernels line."""
    for e in entries:
        e["feed_launches"] = done["13"]["launches"].get(e["name"], 0)
    return entries


PHASES = ("2", "2b", "3", "4", "5", "6", "7", "8", "9", "10", "11", "12", "13")
# source -> its bf16 kernels, each of whose instantiations must not spill:
# the mma.sync designs keep their tiles, sums and (LSTM) cell state in
# registers
BF16_KERNELS = {"flash_fwd": ("flash_fwd_kernel", "flash_fwd_kernel_wide"),
                "flash_bwd": ("flash_dq_kernel", "flash_dkv_kernel",
                              "flash_dq_kernel_wide", "flash_dkv_kernel_wide"),
                "lstm_fwd": ("lstm_fwd_kernel",),
                "lstm_bwd": ("lstm_bwd_kernel", "lstm_dw_kernel")}
# source -> its f32 kernels held to the same gate: the f32 LSTM forward
# and backward keep their register tiles, streams and carries in
# registers too, and the 3xTF32 flash kernels their accumulators, score
# chains and split fragments
F32_KERNELS = {"flash_fwd": ("flash_fwd_kernel_tf32x3",),
               "flash_bwd": ("flash_dq_kernel_tf32x3", "flash_dkv_kernel_tf32x3",
                             "flash_dq_kernel_wide_tf32x3",
                             "flash_dkv_kernel_wide_tf32x3"),
               "lstm_fwd": ("lstm_fwd_kernel",),
               "lstm_bwd": ("lstm_bwd_kernel", "lstm_dw_kernel")}


def _spill_gate(name, report):
    """Phase 1's reading of one source's ``-Xptxas -v`` report: prints
    its registers and spills, and for each of its ``BF16_KERNELS`` and
    ``F32_KERNELS`` the registers and spill bytes of every instantiation
    of that element type; fails if one spills or there is none."""
    fns = _ptxas(report)
    regs = [r for _, r, _ in fns]
    spills = [(f[f.find("kernel"):][:60], sp) for f, _, sp in fns if sp]
    _say(f"phase 1: {name}.cu ptxas: {len(fns)} kernels, "
          f"{min(regs)}-{max(regs)} registers, spills {spills}", flush=True)
    gated = [("bf16", k, lambda f, k=k: k + "I" in f and "bfloat16" in f)
             for k in BF16_KERNELS.get(name, ())]
    # an f32 instantiation: of a kernel templated on its element type
    # (``<float, ..>``) or of one that is f32 only (no bf16 in its name)
    gated += [("f32", k, lambda f, k=k: k + "I" in f and "bfloat16" not in f)
              for k in F32_KERNELS.get(name, ())]
    for dtype, kernel, match in gated:
        typed = [(f, r, sp) for f, r, sp in fns if match(f)]
        _say(f"phase 1: {dtype} {kernel} registers, spill bytes: "
              f"{[(r, sp) for _, r, sp in typed]}", flush=True)
        _check(typed and not any(sp for _, _, sp in typed),
               f"{dtype} {kernel} spills: {typed}")


def _phases(argv):
    """The phases after 0 and 1 to run: all of them, or ``--only a,b``."""
    if not argv:
        return PHASES
    if len(argv) != 2 or argv[0] != "--only" or \
            not set(argv[1].split(",")) <= set(PHASES):
        raise SystemExit(f"usage: chip_smoke.py [--only {','.join(PHASES)}]")
    return tuple(p for p in PHASES if p in argv[1].split(","))


def main(argv) -> int:
    import numpy as np
    import torch

    phases = _phases(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.ops import flash_attention as flash
    from deeplearning4j_tpu_torch.ops import lstm_kernel as lk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 0: device
    card = _card()
    kind = torch.cuda.get_device_name(0)
    _say(f"phase 0: {kind} ({card}), torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    # phase 1: build every source, in parallel, from an empty build directory
    shutil.rmtree(kernels.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    reports = kernels.build()
    for name, report in reports.items():
        _spill_gate(name, report)
    _say(f"phase 1: built {sorted(reports)} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    done = {}
    if "2" in phases:  # kernels against their plain versions
        done["2"] = phase_kernels(torch, F, flash)
        _say(f"phase 2: {len(done['2'])} flash_fwd cases within tolerance",
              flush=True)
        done["2bwd"] = phase_bwd_kernels(torch, F, kernels, flash)
        _say(f"phase 2: {len(done['2bwd'])} flash_dq/flash_dkv cases within "
              "tolerance", flush=True)
        done["2scale4"] = phase_scale4(torch, np, flash)
    if "2b" in phases:
        print(f"clocks: {_clocks()}", flush=True)
        phase_lstm_timer(torch, lk)
        done["2b"] = phase_lstm_kernels(torch, lk)
        _say(f"phase 2b: {len(done['2b'])} LSTM cases (lstm_fwd_only, lstm_fwd, "
              "lstm_bwd + lstm_dw) within tolerance", flush=True)
    if "3" in phases:  # serving at full width
        done["3"] = phase_gpt(torch, np, kernels, flash)
        m = done["3"][1]
        _say(f"phase 3: gpt generate {m['tokens_per_s']:.1f} tokens/s, "
              f"prefill {m['prefill_ms']:.3f} ms on {card}", flush=True)
    if "4" in phases:  # training at full width
        print(f"clocks: {_clocks()}", flush=True)
        done["4"] = phase_train(torch, np, kernels, flash)
        m = done["4"][1]
        _say(f"phase 4: gpt train step {m['step_ms']:.2f} ms, "
              f"{m['tokens_per_s']:.0f} tokens/s, MFU {m['mfu']:.4f}, "
              f"loss {m['loss_first']:.4f} -> {m['loss_last']:.4f} on {card}",
              flush=True)
        f = m["fit_scan"]
        _say(f"phase 4: gpt fit_scan step {f['step_ms']:.2f} ms, "
              f"{f['units_per_s']:.0f} tokens/s, MFU {f['mfu']:.4f}, busy "
              f"{f['device_busy_share']:.3f}, loss {f['loss_first']:.4f} -> "
              f"{f['loss_last']:.4f} on {card}", flush=True)
        w = m["wide_head"]
        _say(f"phase 4: wide-head (256) step {w['step_device_ms']:.3f} device ms, "
              f"wide flash kernels {w['wide_kernels_share']:.3f} of it, "
              f"within tolerance of the plain attention on {card}", flush=True)
        for key, what in (("f32", "f32 step"), ("wide_f32", "wide-head (256) f32 step")):
            w = m[key]
            _say(f"phase 4: {what} {w['step_device_ms']:.3f} device ms, flash "
                  f"backward pair {w['backward_pair_share']:.3f} of it, within "
                  f"tolerance of the plain attention on {card}", flush=True)
    if "5" in phases:  # char-RNN serving at full width
        print(f"clocks: {_clocks()}", flush=True)
        done["5"] = phase_char_serve(torch, np, kernels, lk)
        m = done["5"][1]
        _say(f"phase 5: char-RNN generate {m['tokens_per_s']:.1f} tokens/s, "
              f"prefill {m['prefill_ms']:.3f} ms on {card}", flush=True)
    if "6" in phases:  # char-RNN training at full width
        print(f"clocks: {_clocks()}", flush=True)
        done["6"] = phase_char_train(torch, np, kernels, lk)
        m = done["6"][1]
        _say(f"phase 6: char-RNN train step {m['step_ms']:.2f} ms, "
              f"{m['tokens_per_s']:.0f} tokens/s, MFU {m['mfu']:.4f}, "
              f"loss {m['loss_first']:.4f} -> {m['loss_last']:.4f} on {card}",
              flush=True)
        f = m["fit_scan"]
        _say(f"phase 6: char-RNN fit_scan step {f['step_ms']:.2f} ms, "
              f"{f['units_per_s']:.0f} tokens/s, MFU {f['mfu']:.4f}, busy "
              f"{f['device_busy_share']:.3f}, loss {f['loss_first']:.4f} -> "
              f"{f['loss_last']:.4f} on {card}", flush=True)
        m = m["f32"]
        _say(f"phase 6: f32 char-RNN example train step {m['step_ms']:.3f} ms, "
              f"{m['tokens_per_s']:.0f} tokens/s, MFU {m['mfu']:.4f}, busy "
              f"{m['device_busy_share']:.3f}, loss {m['loss_first']:.4f} -> "
              f"{m['loss_last']:.4f} on {card}", flush=True)
    if "7" in phases:  # LeNet-MNIST training at full width
        print(f"clocks: {_clocks()}", flush=True)
        m = done["7"] = phase_lenet(torch, np, kernels)
        _say(f"phase 7: LeNet-MNIST train step {m['step_ms']:.3f} ms, "
              f"{m['examples_per_s']:.0f} examples/s, MFU {m['mfu']:.4f}, "
              f"busy {m['device_busy_share']:.3f}, loss {m['loss_first']:.4f} -> "
              f"{m['loss_last']:.4f} on {card}", flush=True)
        f = m["fit_scan"]
        _say(f"phase 7: LeNet-MNIST fit_scan step {f['step_ms']:.3f} ms, "
              f"{f['units_per_s']:.0f} examples/s, MFU {f['mfu']:.4f}, busy "
              f"{f['device_busy_share']:.3f} on {card}", flush=True)
    if "8" in phases:  # MLP-Iris training at full width
        print(f"clocks: {_clocks()}", flush=True)
        m = done["8"] = phase_mlp_iris(torch, np, kernels)
        _say(f"phase 8: MLP-Iris train step {m['step_ms']:.3f} ms, "
              f"{m['examples_per_s']:.0f} examples/s, busy "
              f"{m['device_busy_share']:.3f}, loss {m['loss_first']:.4f} -> "
              f"{m['loss_last']:.4f}, f64 gradient check passed "
              f"({m['gradcheck_n_checked']} parameters) on {card}", flush=True)
        f = m["fit_scan"]
        _say(f"phase 8: MLP-Iris fit_scan step {f['step_ms']:.3f} ms, "
              f"{f['units_per_s']:.0f} examples/s, busy "
              f"{f['device_busy_share']:.3f} on {card}", flush=True)
    if "9" in phases:  # ComputationGraph: ResNet-50, the tiny ResNet, chains
        print(f"clocks: {_clocks()}", flush=True)
        m = done["9"] = phase_graph(torch, np, kernels, flash, lk)
        a = m["resnet50"]
        _say(f"phase 9: ResNet-50 fit_scan {a['units_per_s']:.0f} examples/s, "
              f"step {a['step_ms']:.2f} ms, MFU {a['mfu']:.4f}, busy "
              f"{a['device_busy_share']:.3f}, peak memory {a['peak_mem_gb']:.2f} GB; "
              f"tiny ResNet f32 card vs CPU within {TINY_RESNET_REL}; the "
              f"char-RNN and gpt graphs generate as the MultiLayerNetwork "
              f"on {card}", flush=True)
    if "10" in phases:  # the rest of the layer library
        print(f"clocks: {_clocks()}", flush=True)
        m = done["10"] = phase_layers(torch, np, kernels, flash)
        a, q = m["moe_train"], m["quantized"]
        _say(f"phase 10: MoE gpt train step {a['step_ms']:.2f} ms, "
             f"{a['tokens_per_s']:.0f} tokens/s, busy "
             f"{a['device_busy_share']:.3f}, loss {a['loss_first']:.4f} -> "
             f"{a['loss_last']:.4f}; MoE generate "
             f"{m['moe_generate']['tokens_per_s']:.1f} tokens/s; int8 "
             f"{q['int8']['tokens_per_s']:.1f}, fp8 {q['fp8']['tokens_per_s']:.1f} "
             f"tokens/s; AttentionLayer and DBN pretrain within tolerance "
             f"on {card}", flush=True)
    if "11" in phases:  # paged serving at full width
        print(f"clocks: {_clocks()}", flush=True)
        m = done["11"] = phase_paged(torch, np, kernels, flash)
        _say(f"phase 11: paged serve {m['tokens_per_s']:.1f} tokens/s, time to "
             f"first token median {m['ttft_ms_median']:.1f} ms, p90 "
             f"{m['ttft_ms_p90']:.1f} ms, busy {m['device_busy_share']:.3f}, "
             f"{m['preemptions']} preemptions on the small pool on {card}",
             flush=True)
    if "12" in phases:  # the training services on the char-RNN
        print(f"clocks: {_clocks()}", flush=True)
        m = done["12"] = phase_services(torch, np, kernels, lk)
        r, d = m["resume"], m["deferred"]
        _say(f"phase 12: resume, supervisor, early stopping, deferred scores "
             f"({d['fetches_frequency_5']} fetches for {SERVICE_STEPS} steps) "
             f"and lbfgs on the card; checkpoint save median "
             f"{statistics.median(r['save_ms']):.1f} ms on {card}", flush=True)
    if "13" in phases:  # the feed pipeline
        print(f"clocks: {_clocks()}", flush=True)
        m = done["13"] = phase_feed(torch, np, kernels, flash, lk)
        c = m["char"]
        _say(f"phase 13: feed pipeline; char-RNN step {c['window_ms_per_step']:.2f} ms "
             f"pipelined (busy {c['device_busy_share']:.3f}), staging on stream "
             f"{c['feed_stream_id']} beside compute stream "
             f"{c['compute_stream_id']}; native IO built on {card}", flush=True)
    if phases != PHASES:
        print(f"chip_smoke: ran phases 0, 1, {', '.join(phases)} only; "
              "no result", flush=True)
        return 0

    summary = {"kernels": _feed_launches(_service_launches(_paged_launches(
        _layer_launches(_path_launches(_flash_summary(done)
                                       + _lstm_summary(done, lk), done),
                        done), done), done), done)}
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


SRC = "deeplearning4j_tpu_torch/kernels/"


def _flash_summary(done):
    """The flash kernels' entries of the kernels line (phases 2-4)."""
    from deeplearning4j_tpu_torch.ops import flash_attention as flash

    rows, bwd_rows = done["2"], done["2bwd"]
    launches, train_launches = done["3"][0], done["4"][0]
    main_row = next(r for r in rows if r["dtype"] == "bfloat16" and r["d"] == 64
                    and r["tq"] == PROMPT and r["tk"] == PROMPT and r["causal"]
                    and r["bh"] == BATCH * GPT["num_heads"])
    train_bh = TRAIN_BATCH * TRAIN["num_heads"]
    d_head = TRAIN["d_model"] // TRAIN["num_heads"]

    def train_row(rs):
        return next(r for r in rs if r["dtype"] == "bfloat16"
                    and r["d"] == d_head and r["tq"] == TRAIN["max_len"]
                    and r["tk"] == TRAIN["max_len"] and r["causal"]
                    and r["bh"] == train_bh)

    fwd_train, bwd_row = train_row(rows), train_row(bwd_rows)

    def wide_row(rs, d, bh, t):
        return next(r for r in rs if r["dtype"] == "bfloat16" and r["d"] == d
                    and r["bh"] == bh and r["tq"] == t and r["causal"])

    def wide(r, kernel, key, err):
        """a wide head's numbers (bf16 causal, the wide mma.sync kernels):
        this kernel's time beside the plain version and the library call
        (SDPA; its whole backward for the two backward kernels)"""
        ms = r[f"{key}kernel_only_ms"]
        return {"kernel": kernel, "ms": ms, "plain_ms": r["plain_ms"],
                "library_ms": r["library_ms"], "max_abs_err": err,
                "bound_ms": r[f"{key}bound_ms"], "bound_by": r[f"{key}bound_by"],
                "bound_share": r[f"{key}bound_ms"] / ms,
                "shape": [r["bh"], r["tq"], r["d"]]}

    _, d512, bh512, t512, _, _ = WIDE_512_CASES[0]
    _, d1024, bh1024, t1024, _, _ = WIDE_1024_CASES[0]
    f32_1024 = WIDE_F32_1024_CASES[0]
    f32_bwd = next(r for r in bwd_rows if r["dtype"] == "float32"
                   and r["d"] == d_head and r["tq"] == TRAIN["max_len"]
                   and r["tk"] == TRAIN["max_len"] and r["causal"]
                   and r["bh"] == train_bh)
    f32_wide_bwd = next(r for r in bwd_rows if r["dtype"] == "float32"
                        and r["d"] == WIDE_HEAD[0] and r["bh"] == WIDE_HEAD[1]
                        and r["tq"] == r["tk"] == WIDE_HEAD[2] and r["causal"])
    f32_wide_bwd_1024 = next(r for r in bwd_rows if (
        r["dtype"], r["d"], r["bh"], r["tq"], r["tk"], r["causal"]) == f32_1024)
    f32_train, f32_wide_train = done["4"][1]["f32"], done["4"][1]["wide_f32"]

    def f32_fwd(r, train):
        """the f32 forward (``flash_fwd_kernel_tf32x3``) at one of phase
        4's f32 steps' shapes, or at d 512 or 1024 (``train`` None): its time
        beside the plain version and SDPA, its bounds on the CUDA cores
        (f32) and on the tensor cores in 3xTF32 with their shares, and
        the step's launches (left out at d 512, where no step runs)"""
        entry = {"kernel": "flash_fwd_kernel_tf32x3", "ms": r["kernel_only_ms"],
                  "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                  "max_abs_err": r["err_o"], "max_abs_err_lse": r["err_lse"],
                  "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                  "bound_share": r["bound_share"],
                  "bound_tf32x3_ms": r["bound_tf32x3_ms"],
                  "bound_tf32x3_by": r["bound_tf32x3_by"],
                  "bound_tf32x3_share": r["bound_tf32x3_share"],
                  "shape": [r["bh"], r["tq"], r["d"]]}
        if train:
            entry["launches"] = train["launches"].get(flash.KERNEL, 0)
        return entry

    def f32_fwd_row(d, bh, t):
        return next(r for r in rows if r["dtype"] == "float32" and r["d"] == d
                    and r["bh"] == bh and r["tq"] == r["tk"] == t and r["causal"])

    def f32(name, key, grads, r=f32_bwd, train=f32_train, suffix="_tf32x3"):
        """the f32 backward as one of phase 4's f32 steps runs it (by
        default at the training shape, [128, 1024, 64] causal, the 3xTF32
        kernels), or at d 1024 (``train`` None): this kernel's time beside
        the whole call, the plain version and the library call (both the
        whole backward), its bound on the CUDA cores (f32) and on the
        tensor cores in 3xTF32 with their shares, and the step's launches
        (left out at d 1024, where no step runs)"""
        ms = r[f"{key}_kernel_only_ms"]
        entry = {"kernel": f"{name}_kernel{suffix}", "ms": ms, "backward_ms": r["ms"],
                 "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                 "max_abs_err": max(r[f"err_{g}"] for g in grads),
                 "bound_ms": r[f"{key}_bound_ms"], "bound_by": r[f"{key}_bound_by"],
                 "bound_share": r[f"{key}_bound_ms"] / ms,
                 "bound_tf32x3_ms": r[f"{key}_bound_tf32x3_ms"],
                 "bound_tf32x3_by": r[f"{key}_bound_tf32x3_by"],
                 "bound_tf32x3_share": r[f"{key}_bound_tf32x3_ms"] / ms,
                 "shape": [r["bh"], r["tq"], r["d"]]}
        if train:
            entry["launches"] = train["launches"].get(name, 0)
        return entry

    fwd_wide, bwd_wide = (wide_row(rs, *WIDE_HEAD) for rs in (rows, bwd_rows))
    fwd_512, bwd_512 = (wide_row(rs, d512, bh512, t512) for rs in (rows, bwd_rows))
    fwd_1024, bwd_1024 = (wide_row(rs, d1024, bh1024, t1024) for rs in (rows, bwd_rows))
    fwd_f32_1024 = f32_fwd_row(*f32_1024[1:4])
    wide_train = done["4"][1]["wide_head"]
    return [{
        "name": flash.KERNEL, "route": "cuda",
        "source": SRC + "flash_fwd.cu",
        "replaces": "deeplearning4j_tpu/ops/flash_attention.py:150",
        "launches": launches.get(flash.KERNEL, 0),
        "max_abs_err": main_row["err_o"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "kernel_only_ms": main_row["kernel_only_ms"],
        "bound_share": main_row["bound_ms"] / main_row["kernel_only_ms"],
        "shape": [main_row["bh"], main_row["tq"], main_row["d"]],
        "max_abs_err_all_cases": max(r["err_o"] for r in rows),
        "train_launches": train_launches.get(flash.KERNEL, 0),
        # the same numbers at the training path's shape
        "train": {k: fwd_train[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "kernel_only_ms", "kernel_only_ms_by_block_q")}
        | {"max_abs_err": fwd_train["err_o"],
           "bound_share": fwd_train["bound_ms"] / fwd_train["kernel_only_ms"],
           "shape": [train_bh, TRAIN["max_len"], d_head]},
        "wide_head": wide(fwd_wide, "flash_fwd_kernel_wide", "", fwd_wide["err_o"]),
        "wide_head_512": wide(fwd_512, "flash_fwd_kernel_wide", "", fwd_512["err_o"]),
        "wide_head_1024": wide(fwd_1024, "flash_fwd_kernel_wide", "", fwd_1024["err_o"])
        | {"ms_by_block_q": fwd_1024["kernel_only_ms_by_block_q"]},
        "wide_train_launches": wide_train["launches"].get(flash.KERNEL, 0),
        "f32_train_launches": f32_train["launches"].get(flash.KERNEL, 0),
        "wide_f32_train_launches": f32_wide_train["launches"].get(flash.KERNEL, 0),
        # the f32 forward at the f32 steps' shapes and at d 512
        "f32": f32_fwd(f32_fwd_row(d_head, train_bh, TRAIN["max_len"]), f32_train),
        "wide_head_f32": f32_fwd(f32_fwd_row(*WIDE_HEAD), f32_wide_train),
        "wide_head_f32_512": f32_fwd(f32_fwd_row(*WIDE_F32_512_CASES[0][1:4]), None),
        "wide_head_f32_1024": f32_fwd(fwd_f32_1024, None)
        | {"ms_by_block_q": fwd_f32_1024["kernel_only_ms_by_block_q"]},
    }] + [{
        "name": name, "route": "cuda", "source": SRC + "flash_bwd.cu",
        "replaces": f"deeplearning4j_tpu/ops/flash_attention.py:{line}",
        "launches": train_launches.get(name, 0),
        "max_abs_err": max(bwd_row[f"err_{g}"] for g in grads),
        "ms": bwd_row[f"{key}_kernel_only_ms"],
        "kernel_only_ms": bwd_row[f"{key}_kernel_only_ms"],
        "bound_share": bwd_row[f"{key}_bound_ms"]
        / bwd_row[f"{key}_kernel_only_ms"],
        # the plain backward and SDPA's backward compute dq, dk and dv
        # together: plain_ms and library_ms are the whole backward's time,
        # to be read beside backward_ms (this port's whole backward call)
        "plain_ms": bwd_row["plain_ms"],
        "backward_ms": bwd_row["ms"],
        "bound_ms": bwd_row[f"{key}_bound_ms"],
        "bound_by": bwd_row[f"{key}_bound_by"],
        "library_ms": bwd_row["library_ms"],
        "shape": [train_bh, TRAIN["max_len"], d_head],
        "max_abs_err_all_cases": max(r[f"err_{g}"] for r in bwd_rows
                                     for g in grads),
        "wide_head": wide(bwd_wide, f"{name}_kernel_wide", f"{key}_",
                          max(bwd_wide[f"err_{g}"] for g in grads))
        | {"backward_ms": bwd_wide["ms"]},
        "wide_head_512": wide(bwd_512, f"{name}_kernel_wide", f"{key}_",
                              max(bwd_512[f"err_{g}"] for g in grads))
        | {"backward_ms": bwd_512["ms"]},
        # [8, 1024, 1024] causal, the wide kernels at 1024 (no step runs
        # them; flash_dq also at each of its tilings)
        "wide_head_1024": wide(bwd_1024, f"{name}_kernel_wide", f"{key}_",
                               max(bwd_1024[f"err_{g}"] for g in grads))
        | {"backward_ms": bwd_1024["ms"]}
        | ({"ms_by_block_q": bwd_1024["dq_kernel_only_ms_by_block_q"]} if key == "dq" else {}),
        "wide_train_launches": wide_train["launches"].get(name, 0),
        "f32": f32(name, key, grads),
        # the wide f32 step's shape, [32, 1024, 256] causal: the wide 3xTF32
        # kernels
        "wide_head_f32": f32(name, key, grads, f32_wide_bwd, f32_wide_train,
                             "_wide_tf32x3"),
        # [8, 1024, 1024] causal, the wide 3xTF32 kernels at 1024 (no step
        # runs them)
        "wide_head_f32_1024": f32(name, key, grads, f32_wide_bwd_1024, None,
                                  "_wide_tf32x3"),
    } for name, line, key, grads in (
        (flash.DQ_KERNEL, 220, "dq", ("dq",)),
        (flash.DKV_KERNEL, 252, "dkv", ("dk", "dv")))]


def _path_launches(entries, done):
    """Each kernel's launches per step on the fit_scan paths (phase 4's
    ``gpt_benchmark``, phase 6's char-RNN) and its launches on phase 9's
    graph paths, added to its entry of the kernels line."""
    scans = (done["4"][1]["fit_scan"], done["6"][1]["fit_scan"])
    graph = done["9"]
    on_graph = collections.Counter(graph["gpt_graph"]["generate_launches"])
    on_graph.update(graph["char_rnn_graph"]["generate_launches"])
    for e in entries:
        e["fit_scan_launches_per_step"] = sum(
            m["launches_per_step"].get(e["name"], 0) for m in scans)
        e["graph_generate_launches"] = on_graph[e["name"]]
    return entries


def _lstm_summary(done, lk):
    """The LSTM kernels' entries of the kernels line (phases 2b, 5, 6):
    ``lstm_fwd_only`` at the serving shape (reading Wr packed, as
    generate does), the training kernels at the training shape, and
    under the key ``f32`` the f32 ``lstm_fwd`` at b 32, t 128, n 512 and
    the f32 ``lstm_bwd`` and ``lstm_dw`` at the char-RNN example's
    training shape (b 64, t 64, n 256; launches from phase 6's f32 run).
    The plain backward and the yardstick's backward
    compute every gradient together: read their plain_ms and library_ms
    beside backward_ms (the whole lstm_bwd call: sweep and weights)."""
    rows = done["2b"]
    serve_launches, train_launches = done["5"][0], done["6"][0]
    f32_train_launches = done["6"][1]["f32"]["launches"]

    def row(dtype, b, t, n):
        return next(r for r in rows if (r["dtype"], r["b"], r["t"], r["n"])
                    == (dtype, b, t, n))

    serve = row("float32", SERVE_BATCH, 1, CHAR_HIDDEN)
    train = row("bfloat16", CHAR_BATCH, CHAR_SEQ, CHAR_HIDDEN)
    f32_fwd = row("float32", SERVE_BATCH, CHAR_SEQ, CHAR_HIDDEN)
    f32_train = row("float32", EXAMPLE_BATCH, EXAMPLE_SEQ, EXAMPLE_HIDDEN)
    replaces = "deeplearning4j_tpu/ops/lstm_kernel.py:"
    entries = []
    for name, r, line, key, err, plain, lib, src in (
            (lk.FWD_ONLY_KERNEL, serve, 101, "fwd_only", "err_fwd_only",
             "plain_fwd_only_ms", "library_fwd_ms", "lstm_fwd.cu"),
            (lk.FWD_KERNEL, train, 86, "fwd", "err_fwd", "plain_fwd_ms",
             "library_fwd_ms", "lstm_fwd.cu"),
            (lk.BWD_KERNEL, train, 181, "bwd", None, "plain_bwd_ms",
             "library_bwd_ms", "lstm_bwd.cu"),
            (lk.DW_KERNEL, train, 181, "dw", None, "plain_bwd_ms",
             "library_bwd_ms", "lstm_bwd.cu")):
        bound_ms, bound_by = r["bounds"][name]
        errs = (lambda x: x[err]) if err else (lambda x: max(x["err_bwd"].values()))
        entry = {
            "name": name, "route": "cuda", "source": SRC + src,
            "replaces": replaces + str(line),
            "launches": serve_launches[name] if name == lk.FWD_ONLY_KERNEL
            else train_launches[name],
            "max_abs_err": errs(r), "ms": r[f"{key}_ms"], "plain_ms": r[plain],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": r[lib],
            "shape": [r["b"], r["t"], r["n"], r["dtype"]],
            "max_abs_err_all_cases": max(errs(x) for x in rows),
            "serve_launches": serve_launches[name],
            "train_launches": train_launches[name],
        }
        if key in ("bwd", "dw"):
            entry["backward_ms"] = r["backward_ms"]
        if name == lk.FWD_ONLY_KERNEL:
            # generate reads Wr packed per block (pack_wr): its time is the
            # main path's; the same kernel reading Wr itself beside it
            entry["ms"] = r["fwd_only_packed_ms"]
            entry["ms_reading_wr"] = r["fwd_only_ms"]
        if name == lk.FWD_KERNEL:
            # the f32 lstm_fwd (the serving layout at t 128); on no main
            # path: the f32 path is serving's (training's is bf16)
            bound_ms, bound_by = f32_fwd["bounds"][name]
            entry["f32"] = {
                "ms": f32_fwd["fwd_ms"], "plain_ms": f32_fwd["plain_fwd_ms"],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": f32_fwd["library_fwd_ms"],
                "max_abs_err": f32_fwd["err_fwd"],
                "launches": serve_launches[name],
                "shape": [f32_fwd["b"], f32_fwd["t"], f32_fwd["n"], "float32"]}
        if key in ("bwd", "dw"):
            # the f32 pair on the char-RNN example's training path
            bound_ms, bound_by = f32_train["bounds"][name]
            entry["f32"] = {
                "ms": f32_train[f"{key}_ms"], "plain_ms": f32_train[plain],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": f32_train[lib],
                "max_abs_err": errs(f32_train),
                "backward_ms": f32_train["backward_ms"],
                "launches": f32_train_launches[name],
                "shape": [f32_train["b"], f32_train["t"], f32_train["n"],
                          "float32"]}
        entries.append(entry)
    return entries


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
