#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vqa_tpu_torch) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py             # the smoke run
    python3 chip_smoke.py --profile   # and torch.profiler tables of one
                                      # B=16384 forward, one
                                      # B=4096 beam decode, one B=4096
                                      # MTL training step and one B=8192
                                      # ReGAT forward

Phases, each of which raises (exit code 1) on failure:

1. device: a CUDA card must be present; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the port's CUDA kernels from ``vqa_tpu_torch/csrc`` and
   its host library (the feed's threaded gathers, answer densify and
   spatial graphs) from ``vqa_tpu_torch/csrc/host`` with g++; a host library
   that does not build or load fails the run;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (ragged ones included), within a stated tolerance;
   gru_v2 at B=512, 1000, 4096, 8192, 16384 and 32768 (the bench's fast32
   batch), at a B that reaches each
   cluster size its plan can choose (16 where the card schedules 16-block
   clusters) and at H=2048, whose state lives in device memory; the three
   decode-attention kernels at B=512, 1003 and 4096 in four input
   regimes (f32 over an f32 or an int8 payload, bf16 over a bf16 payload,
   bf16 over an int8 payload with factored weights), with and without
   dropout, and the keep mask the forward kernel emits equal to
   ``keep_mask`` bit for bit; decode_att_dvp also at T=1 and T=0, at 64
   boxes and at H=1040 (65 lane groups), in bf16 and f32; the int8 GEMM
   bit for bit at the ReGAT
   path's shapes (3-D entry at B=8192 and B=1003, N=1024 and 2048; 2-D
   entry at the GCN projections' rows and at a ragged M=3001 with bias and
   ReLU) and at the ragged edges of its tiling (N=1000, K=96, and M=100
   with N=40); gcn_chain_fused at B=512, 1003 and 8192 in bf16 and f32,
   and in bf16 at D=1000 (not a whole number of its 64-column tiles);
   dequant_matmul at the path's shape, at B=32768's M = 1,179,648 rows
   (x_q past 2**31 bytes) and the ragged edges of its tiling (N=1000,
   M=100, K=64 and 80); its gated epilogue (dequant_matmul_gated_logits,
   the serving attention's logits) at B=1024, 1003 and 32768 and at 10
   boxes with N=1000 and K=80, two calls bit-equal; pool_int8 at B=1024,
   1003 and 32768; attended_int8 bit for bit at B=8192, 3 and 8191;
   vocab_topk_lse at R=12288 with k = 1, 3
   and 8, and at R=3001, R=8 and V=1000 with an exact tie planted across
   tiles and vocabulary splits, which must go to the lower index; and at
   every one of these shapes (and phase 12's) the kernel module's
   ``supports`` must hold, so that no shape gate moves a main path off its
   kernel;
4. serve: the full-width Up-Down model (bf16, ``use_pallas=True``, weights
   from a seeded generator) answers a few batches of the int8 feed made by
   the port's data layer (``vqa_tpu_torch.data``), through
   ``VQAModel.forward_vqa``; every kernel's launch count must rise, the
   question GRU must form its input gates per token (``ops/rnn.py``
   ``ROUTES["gates"]`` once a request: 5,120 tokens, fewer than the
   vocabulary table's rows), and the
   logits must agree with the same model whose kernels are swapped for
   their plain versions;
5. decode: the full-width Up-Down caption model (BUTD decoder, bf16,
   ``use_pallas=True``, seeded weights) beam-decodes the same requests
   through ``make_beam_search(fused_vocab=True)``; the launch counts of
   vocab_topk_lse, gru_v2 and dequant_matmul_gated_logits (the encoder's
   attention) must rise, the beams must be
   well formed, and the best beams must agree with the same model whose
   vocab kernel, and then every kernel, is swapped for its plain version;
6. timing (for information): gru_v2, dequant_matmul, its gated epilogue
   and pool_int8 at the
   bench's B=32768 with their shares of the bound; gru_v2 at B=512, 4096,
   8192 and 16384 with
   its plan's cluster size, its share of the bound and its ratio to
   gru_last_state v1 on the same xi; each kernel and its plain version (and
   dequant_matmul and vocab_topk_lse beside cuBLAS's bf16 product of the
   same shape, with their shares of the bound, and vocab_topk_lse at k = 1,
   3 and 8), the VQA forward at B=16384, and the beam decode at B=4096
   (k=3, c_len=20) with the kernels and on the plain path
   (``use_pallas=False``), beside their times recorded before the wgmma
   designs of those two kernels, by CUDA events; the B=16384 forward and
   one forward at B=32768 must take the question GRU's vocabulary-table
   route (``ROUTES["table"]``, one gru_v2 launch a forward) and run one
   ``WNDense`` at a padded width (``linear.ROUTES["aligned"]``, the
   classifier's last layer), whose GEMM alone at B=32768 must not be
   cuBLAS's sm75 fallback (its kernel names logged);
7. train: the full-width Up-Down MTL model (VQA head and BUTD caption
   decoder, uncertainty-weighted loss, dropout 0.5 / 0.2, f32 masters with
   bf16 compute, ``use_pallas=True``, Adamax lr 2e-3, clip 0.25) trains a few
   steps on length-bucketed Loader batches of B=512 from a synthetic VQA-E
   root; each step must launch decode_att_fwd and decode_att_bwd once per
   decoder step and decode_att_dvp once, the losses must be finite, and one
   batch trained again and again must lower its loss;
8. train, kernels against plain versions: the gradients of one step with the
   kernels and with every kernel swapped for its plain version (the same
   Philox masks), in f32 and then in bf16, within stated tolerances;
8b. widths the kernels refuse run on the plain versions: the Up-Down
   serving model at hidden 1000 answers one request with gru_v2 launched
   no time (dequant_matmul_gated_logits and pool_int8 still launch) and its
   logits held
   against plain versions, and one MTL step with a decoder of width 500
   trains with no decode-attention launch;
9. train timing (for information): decode_att_fwd and decode_att_dvp at
   the path's B=512, each decode-attention kernel and its plain version at
   B=4096, each with its share of the bound (bytes, products or the issue
   of its Philox draws, whichever is largest), and the
   training step at B=4096 (19 decoder
   steps) with the kernels and on the plain path (``use_pallas=False``), by
   CUDA events, with its peak device memory;
10. ReGAT: the full-width ReGAT model (spatial corr-GCN, one layer, bf16,
   ``use_pallas=True``, ``use_int8=True``, seeded weights) answers the
   serve phase's requests with their spatial graphs (the port's data layer
   writes them) through ``VQAModel.forward_vqa``: gru_v2, the int8 GEMM
   (the 3-D entry once, the 2-D entry three times a forward),
   attended_int8 and gcn_chain_fused must launch,
   dequant_matmul(_gated_logits) and pool_int8 must not, and
   the logits must agree with the same model on plain versions; then once
   more with ``use_int8=False``, where gcn_chain_fused and attended_int8
   run beside dequant_matmul_gated_logits;
11. ReGAT timing (for information): the int8 GEMM at both entries' path
   shapes against its plain version and ``torch._int_mm`` (with its share
   of the bound and its ratio to that call), gcn_chain_fused at B=512 and
   8192 with its share of the bound, attended_int8 at B=8192 against its
   plain version and the eager three-pass form, with its share of the
   bound, the B=8192 forward's attended features by the kernel
   (``encoder.ROUTES`` kernel 1, plain 0; one attended_int8 launch),
   and the ReGAT forward at B=8192 with the kernels, on plain versions, on
   the bf16 path without ``use_int8`` / ``use_pallas`` and on the bf16 path
   with ``use_pallas`` but without ``use_int8``, with peak memory;
12. library kernels (no model path calls them, in the JAX package or the
   port): fused_multiply_attention_pool, gru_last_state and
   gru_last_state_v3 against their plain versions in bf16 at the JAX test
   shapes, at a ragged B=1003 and at full width (B=16384), the attention
   also at 100 boxes, at 256 (one image an M tile) and at H=1040 (9
   column tiles), each time with a second call bit-equal to the first; the
   full-width ones on the serving model's weights: the attention folded
   from its ``MultiplyAttention`` (``weight_g / ||weight_v||``), also held
   against that module's softmax on the dense bf16 feed and the pooling
   over it; the GRUs on its question GRU and embedded questions, v1 also
   against gru_v2 on the same input gates, and both at H=2048; then each
   timed against its plain version (and the attention against the unfused
   bf16 module, with its share of the bound and its plan; v1 against
   gru_v2 and v3 against cuDNN's ``nn.GRU``, with each GRU's share of its
   bound and its ratio to that other route), and v1 at one full wave of
   64-row tiles against half as many tiles, which the plan gives two
   blocks each;
13. the entry point: ``vqa_tpu_torch.main.main`` in this process, on a
   synthetic VQA-E root at full width, trains CONFIGS.md config 3 as
   written (the ``base-cap`` head, the BUTD decoder, ``use_mtl``; int8
   feed, ``use_pallas``, bf16 over f32 masters, length buckets) with a
   frozen GloVe table from a 300-d file the phase writes from a seed (the
   table must be on the card and absent from ``epoch_0.ckpt``) for one
   epoch of a few B=512 steps and validates (decode_att_fwd/_bwd/_dvp must
   launch),
   resumes from ``epoch_0.ckpt`` for a second epoch (the restored step and
   Adamax moments must equal the saved ones), validates in ``--mode val``
   (one score per val question) and beam-decodes in bf16 (vocab_topk_lse,
   gru_v2 and dequant_matmul_gated_logits must launch; one caption per val
   question),
   with each mode's wall time and the train samples/s;
14. ReGAT training and GCN-LSTM: config 5's model (spatial corr-GCN, one
   layer, bf16 over f32 masters, ``use_pallas``) trains a few Loader steps
   of B=512 with spatial graphs (finite losses; one batch trained again
   and again lowers its loss); GCN-LSTM (the relation encoder with the BUTD
   decoder, ``use_mtl``, dropout 0.5 / 0.2) trains a few such steps
   (decode_att_fwd/_bwd once per decoder step, _dvp once per step), one
   step's gradients with the kernels held against plain versions as in
   phase 8 (the GCN's projections included), and beam-decodes a ReGAT
   request in bf16 (gcn_chain_fused, gru_v2 and vocab_topk_lse must
   launch; best beams compared with plain versions); both steps timed at
   B=4096 with their peak memory; then ``vqa_tpu_torch.main.main`` on
   config 5's flags trains one epoch and validates in ``--mode val``
   (gcn_chain_fused must launch), with each mode's wall time;
15. Q-Relevant: the full-width q-cap model (bf16, ``use_pallas``) serves
   4 requests of B=512 from a synthetic ``select`` root on the int8 feed
   (exactly one gru_v2, one dequant_matmul_gated_logits and one
   attended_int8 a request, no dequant_matmul, no pool_int8; its
   outputs and its logits before the sigmoid within 3% of the same model on
   plain versions), timed at B=4096 with its peak memory; the max-relevance
   step (q-cap, BUTD, ``use_mtl``, dropout 0.5 / 0.2, bf16 over f32
   masters, ``use_pallas``) trains 4 steps of B=512 from
   ``Loader(batch_method="get_batch_all")`` and one batch 10 more times
   (finite losses, the repeated loss falls, no kernel launch: training
   runs no inference kernel and its caption loss is the teacher-forced
   forward), one step's loss and gradients against plain versions in f32
   and bf16 as in phase 8, timed at B=2048 (B=1024 where the B=2048
   step's peak passes 40 GiB) with its peak memory; then CONFIGS.md config
   4 as written (``base-cap``, the base decoder, ``--train_strategy
   select``, the GloVe file) and its q-cap variant through
   ``vqa_tpu_torch.main.main``: one epoch of 2 steps of B=512, then
   ``--mode val``, with each mode's wall time;
16. parallel: the MTL step of phase 7 over 2 processes (``chip_smoke.py
   --parallel-rank``, the ``('data', 'model')`` mesh of
   ``vqa_tpu_torch.parallel``, data parallel: over gloo when they share
   the card, NCCL when each has its own; started once this process has
   written their batch and the reference), B=512 a rank from one batch
   whose halves hold different caption-token counts: each rank's averaged
   f32 and bf16 gradients and loss against the same halves run in this
   process with each rank's folded seeds and the global token count
   (phase 8's tolerances), 19 decode_att_fwd / _bwd and 1 _dvp a rank a
   step, the step's time; where the machine has 2 cards, a 1x2
   tensor-parallel step (NCCL) on one half against its one-process step,
   else a line saying why it was not run. A failed rank fails the phase;
17. host feed: the port's ``pack_feature_dir`` packs a seeded npz directory
   (36 x 2048 boxes with bbox and spatial graphs) into an int8 store, which
   must hold what ``quantize_features`` gives; phase 4's model serves 4
   requests of B=512 from it through the port's ``Loader`` on the host
   library's routes (a native feature gather, graph gather and densify a
   batch, no fallback), each batch byte-equal to the same batch assembled
   by the numpy routes (fancy indexing, the Python densify) and its logits
   bit-equal; gru_v2, dequant_matmul_gated_logits and pool_int8 launch once
   a request;
   then, for information, host figures labelled with the host's CPU count
   beside the card's name and power limit (the int8 gather at B=4096 native
   against numpy and on 1 thread, beside the first touch of a fresh array
   of its size and numpy's gather into a touched buffer; the densify native
   against Python; the Loader's batches/s) and the card's copy of a B=4096
   batch (pageable and pinned) and its forward; the port's ``cap_eval``
   scores phase 13's ``decode.txt`` against a seeded reference file whose
   first reference of each question holds its caption (finite scores,
   BLEU-1, METEOR and ROUGE-L above 0); visualize's model half runs one ReGAT
   sample on the card (its attention sums to 1, one graph alpha [1, 36,
   36] a conv layer);
18. measurement: ``python -m vqa_tpu_torch.bench`` at its defaults must exit
   with 0 and print exactly one line in the root bench's schema; each rung
   must launch each of its kernels (WARMUP + ITERS) x REPS times and no
   other (``safe`` none, ``medium`` gru_v2, ``fast`` and ``fast32`` gru_v2,
   dequant_matmul_gated_logits and pool_int8); each rung's q/s and peak
   memory are
   logged beside the card's name and power limit, and ``fast``'s rate
   must lie within 1.5x of phase 6's B=16384 forward rate either way (else
   the two time different things); ``vqa_tpu_torch.entry.entry()``'s
   forward on the card gives finite logits [32, 3129]; and the path
   benchmarks each run once as a subprocess and print their rows:
   ``scripts.bench_beam fused``, ``scripts.bench_regat``, ``scripts.bench_train
   vqa`` and ``scripts.bench_feed`` on a 64-image corpus (B=512 and 4096,
   2 s a cell); each row of the first three must have launched, in its own
   run, a kernel that its name claims and no other (``fused-vocab``
   vocab_topk_lse, ``+int8`` the int8 GEMMs), and a row that claims none
   no kernel;
19. convergence: the port's convergence study
   (``vqa_tpu_torch.scripts.bf16_convergence.run``, ``--decoder butd``:
   the MTL model at embed 16, hidden 64, 6 boxes of 32-d features, B=32,
   dropout 0.5 / 0.2, on the synthetic mini-split) trains 300 steps in
   each of its variants (f32 with TF32 off, bf16 over f32 masters, the int8
   feed in bf16) with ``use_pallas``, and the int8-feed variant again with
   the decode-attention kernels swapped for their plain versions, the four
   runs as processes of their own started together (a step of this model
   is bound by the host, so 300 steps and not the study's 600, and four
   runs at once and not one after another): every loss finite; decode_att_fwd and _bwd launch 19 times a step and _dvp
   once, exactly, in each kernel run and never in the plain one; the scan
   is constructed; each final loss lies under the ceiling the slow CPU
   test pins at step 299 (``FINAL_LOSS_CEILING[300]``); the bf16
   variants' mean relative loss gap to f32 over the last 20 steps, and the
   kernel run's to the plain run, are at most 2e-3; the final train-split scores lie within
   0.01 of the plain run's; each variant's losses at steps 0, 120 and 299,
   its step time and final score are logged;
20. gate: ``python -m vqa_tpu_torch.scripts.run_gate ROOT --device cuda``
   runs in a temporary directory on a synthetic data root in RUNBOOK.md
   §0's layout (raw VQA v2 / COCO JSON, 36 x 2048 box features of both
   splits, the vocabulary, the answer list and a 300-d GloVe file): the
   port's preprocessing, config 1 trained in f32 and validated, the gate at
   55.8, which must print ``All: ... vs gate 55.80 -> FAIL`` and exit with
   1 (a synthetic split is far below the bar); then the port's gate check
   at ``--threshold 0`` must exit with 0.
   Each phase's wall time is logged, and the total.

The last three lines are the card's name and power limit as nvidia-smi
gives them, ``{"kernels": [...]}`` (one entry per kernel, with the launch
counts of each path, its time against its plain version and its bound,
with the term that sets it (the paths of phases 8b and 14 included, the
bench's rungs together as ``bench`` and phase 19's three kernel runs
together as ``convergence``);
gru_v2's, decode_att_fwd's, decode_att_dvp's
and gcn_chain_fused's also at B=512, as ``ms_b512`` and ``bound_ms_b512``,
gru_v2's, dequant_matmul's and pool_int8's also at the bench's B=32768, as
``ms_b32768`` and ``bound_ms_b32768``, and the unfused bf16 attention
module's time beside the fused attention's, as ``unfused_module_ms``)
and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch

# the flagship Up-Down dims (__graft_entry__.py entry(), bench.py)
NTOKEN, EMBED, HIDDEN, V_DIM, OBJS, ANS, Q_LEN = 20000, 300, 1024, 2048, 36, 3129, 10
SERVE_BATCH, SERVE_REQUESTS = 512, 4
# phase 17: the host feed's timing store and batch (the size the JAX
# package's feed was measured at), and the tolerance of the bf16 attention's
# sum over 36 boxes in visualize (a softmax rounded to bf16: each of its
# weights within 2**-9 of its value)
FEED_STORE_ROWS, FEED_BATCH = 8192, 4096
VIS_ATT_SUM_TOL = 1e-2
SERVE_DIMS = dict(encoder_type="base", predictor_type="base", decoder_type="none",
                  ntoken=NTOKEN, v_dim=V_DIM, embed_dim=EMBED, hidden_dim=HIDDEN,
                  ans_dim=ANS, dropout=0.2, att_type="new")
TIME_BATCH = 16384
# the decode serving shape of scripts/bench_beam.py
BEAM_K, C_LEN, DECODE_TIME_BATCH = 3, 20, 4096
# the B=16384 forward and the B=4096 decode as PERF.md recorded them before
# dequant_matmul and vocab_topk_lse ran on wgmma (chip_smoke.py runs of the
# first designs, NVIDIA H100 80GB HBM3, 700 W), logged beside this run's
RECORDED_FORWARD_MS, RECORDED_DECODE_MS = 24.102, 150.21
# fused_multiply_attention_pool at B=16384 as PERF.md recorded it before its
# clustered wgmma design (the first design, mma.sync on 144-row tiles;
# chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W)
RECORDED_ATTENTION_MS = 15.469

# Tolerances. gru_v2: the f32 state |h| < 1; kernel and plain version sum in
# different orders, and where that flips the bf16 rounding of an h operand,
# the product moves by one bf16 ulp of one term, so errors stay far below
# 2e-3. dequant_matmul and pool_int8: bf16 outputs of f32 sums; a different
# sum order may round to the neighbouring bf16 value, one ulp, at most 2**-7
# of the value. Logits: the model with kernels against the same model with
# plain versions; the GRU's f32 differences can flip bf16 roundings of the
# question vector, which move the logits by a few bf16 ulps of the largest.
GRU_ATOL = 2e-3
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-3
LOGIT_REL_TOL = 3e-2
# vocab_topk_lse: f32 sums of the same 1024 exact bf16 products in another
# order (the kernel's mma tiles against cuBLAS f32), |logit| of a few units:
# each differs by a few f32 ulps of the sum of |terms|, far below 1e-4
# (measured 3.5e-6), and so do the logsumexps. Two logits closer than
# twice that may swap ranks, so indices must be equal only on rows whose
# plain top-(k+1) values are further apart; on the others each index must
# point at a logit within tolerance of the value reported for it.
VOCAB_ATOL, VOCAB_RTOL = 1e-4, 1e-5
# Beams: the vocab kernel against its plain version on the same encoder
# output differs only by those f32 ulps, so a best beam changes only where
# two candidates of some step lie within ~1e-5 of each other.
BEAM_AGREE_VOCAB = 0.98
# Against every kernel on its plain version: the GRU kernel's f32 state
# differs from the plain version's by sum order (up to 3e-4), which flips
# bf16 roundings of the question vector, so the attention over the boxes,
# the features the decoder reads and every step's logits move by a few
# bf16 ulps; a best beam of 19 steps turns wherever such a shift crosses
# the gap between two candidates of a random-weight head. Measured on an
# H100: 0.986 of 2048 best beams identical, 0.994 of their tokens.
BEAM_AGREE_ALL = 0.95
# decode-attention kernels against their plain versions. f32 outputs: the
# same f32 products summed in another order (warp trees against einsum), so
# they differ by f32 rounding of sums of up to 2048 terms, far below 1e-5
# of the largest value (measured 2e-7). bf16 outputs: both round the same
# f32 value to bf16, so where the two f32 sums straddle a rounding point
# they are one bf16 ulp apart (2**-7 of the value at most); values near
# zero keep the f32 sum-order error, far below 2**-12 of the largest.
ATT_F32_RTOL, ATT_F32_ATOL_REL = 1e-5, 1e-5
ATT_BF16_RTOL, ATT_BF16_ATOL_REL = 2.0 ** -7, 2.0 ** -12
ATT_THRESH, ATT_SCALE = 205, 256.0 / 205     # quantized_keep(1 - 0.2)
ATT_SEED, ATT_STEP = 0x5EED1234, 7
# the MTL training step: the JAX package's shipping MTL batch (B=4096,
# scripts/trace_mtl.py) is timed; Loader batches of 512 are trained
TRAIN_BATCH, TRAIN_STEPS, REPEAT_STEPS, TRAIN_TIME_BATCH = 512, 4, 10, 4096
TRAIN_LR, TRAIN_CLIP, RUN_SEED = 2e-3, 0.25, 1234
# gradients of one training step with the kernels against the same step on
# the plain versions, as max |diff| / max |plain| of each compared tensor.
# f32: the kernels' f32 sums differ from the plain versions' by ~1e-7 of
# their values; 16 recurrent steps and the softmax carry such differences
# to every gradient, but far below 1e-3. bf16: an attention output one bf16
# ulp (2**-8) away from the plain version's moves the next recurrent
# states' bf16 roundings, and the gradients summed over 512 rows and 16
# steps inherit a few of those ulps: 5e-2.
GRAD_F32_TOL, GRAD_BF16_TOL = 1e-3, 5e-2
# the parameters whose gradients are compared: the decoder's attention (the
# attention linear's bias only shifts the logits under the softmax, so its
# gradient is rounding noise around 0 and is left out), its two cells, and
# the MTL weights
GRAD_PREFIXES = ("generator.attention.W_v.", "generator.attention.W_q.",
                 "generator.attention.linear.weight_", "generator.word_rnn.",
                 "generator.language_rnn.", "log_vars")
# ReGAT serving: scripts/bench_regat.py's model (spatial corr-GCN, one
# layer) with the int8 GEMMs and the kernels, timed at its B=8192
REGAT_DIMS = dict(encoder_type="relation", predictor_type="base",
                  decoder_type="none", ntoken=NTOKEN, v_dim=V_DIM,
                  embed_dim=EMBED, hidden_dim=HIDDEN, ans_dim=ANS,
                  att_type="new", conv_type="corr", conv_layer=1,
                  use_spa=True, use_imp=False)
REGAT_TIME_BATCH = 8192
# gcn_chain_fused against its plain version. bf16: both sum exact bf16
# products in f32 in other orders and round twice (o, then out); where two
# sums straddle a rounding point they are one bf16 ulp apart (2**-7 of the
# value at most), and an ulp of o or of the softmaxed weights moves an
# output by at most 2**-8 of the largest value. f32: sum order only.
GCN_BF16_RTOL, GCN_BF16_ATOL_REL = 2.0 ** -7, 2.0 ** -8
GCN_F32_RTOL, GCN_F32_ATOL_REL = 1e-5, 1e-5
# The library kernels against their plain versions, which compute in f32
# from the same bf16 inputs: the kernels sum the same exact bf16 products
# in f32 in another order, so att and pooled differ by f32 rounding of sums
# of up to 2048 terms, far below 1e-4 of the largest value (measured 5e-6).
# Against the serving model's MultiplyAttention, which runs its
# projections, logits and softmax in bf16: att within 5e-3, pooled within
# 1% of the largest value. The GRUs: as gru_v2 (GRU_ATOL), and v1 against
# gru_v2 on the same input gates within the same bound (one bf16 rounding of
# the state flipped by a sum order moves the later steps).
LIB_F32_ATOL_REL = 1e-4
MODULE_ATT_ATOL, MODULE_POOL_ATOL_REL = 5e-3, 1e-2
LIB_TIME_BATCH = 16384
# the entry point's synthetic VQA-E root and run: train questions over
# images, val questions, steps a training epoch (depth cut from 2048 /
# 1024 questions and 4 steps, so that the whole run, phase 14 included,
# stays within a quarter of the wall time it took without phase 14)
CLI_IMAGES, CLI_TRAIN_Q, CLI_VAL_Q, CLI_STEPS = 96, 1024, 512, 2
# CONFIGS.md config 5 (ReGAT) and GCN-LSTM (the relation encoder with the
# BUTD decoder, use_mtl) trained at full width: Loader batches of B=512
# with spatial graphs, timed at B=4096; the parameters whose gradients are
# held against plain versions (phase 8's, and the GCN's projections and
# label bias, which the caption scan's gradient of v reaches); the entry
# point's config-5 root (train questions over images, val questions)
LSTM_DIMS = dict(REGAT_DIMS, decoder_type="butd", decoder_hidden_dim=HIDDEN, c_len=C_LEN,
                 use_mtl=True)   # dropout 0.5 / 0.2, the defaults
LSTM_GRAD_PREFIXES = GRAD_PREFIXES + ("encoder.spatial_encoder.conv0.w",
                                      "encoder.spatial_encoder.conv0.label_bias")
REGAT_CLI_IMAGES, REGAT_CLI_TRAIN_Q, REGAT_CLI_VAL_Q = 64, 1024, 512
# Q-Relevant (CONFIGS.md config 4 and its q-cap head) at full width: q-cap
# serving of B=512 requests on the int8 feed (bf16, use_pallas; the
# question GRU and the v-projection launch once a request, pool_int8 never:
# q-cap reads the dense attended features), timed at B=4096; the
# max-relevance step of q-cap with the BUTD decoder and use_mtl on the
# all-captions feed's Loader batches of B=512 (N_CAP candidate captions a
# question, dense features as the entry point feeds them; no kernel
# launches: training runs none of the inference kernels and the caption
# loss is the teacher-forced forward), timed at B=2048 unless its peak
# memory passes SELECT_PEAK_LIMIT, then at B=1024; config 4 and its q-cap
# variant through the entry point on CLI_TRAIN_Q / CLI_VAL_Q questions
QCAP_DIMS = dict(encoder_type="base", predictor_type="q-cap", decoder_type="none",
                 ntoken=NTOKEN, v_dim=V_DIM, embed_dim=EMBED, hidden_dim=HIDDEN,
                 ans_dim=ANS, c_len=C_LEN, att_type="new")
SELECT_DIMS = dict(QCAP_DIMS, decoder_type="butd", decoder_hidden_dim=HIDDEN,
                   use_mtl=True)   # dropout 0.5 / 0.2, the defaults
N_CAP, QCAP_TIME_BATCH, SELECT_TIME_BATCH = 5, 4096, 2048
SELECT_PEAK_LIMIT = 40 * 2 ** 30
# phase 16: the MTL step of phase 7 over two processes, each with its own
# B=512 rows of one B=1024 batch (data parallel over gloo; the ranks share
# the card, so its times witness correctness, not NCCL's speed); the
# gradients are held to phase 8's tolerances against the same two halves
# run in this process with each rank's folded seeds and the global token
# count, left out: the attention linears' biases (see GRAD_PREFIXES). The
# ranks have PAR_TIMEOUT s.
PAR_RANKS, PAR_TIMED_STEPS, PAR_TIMEOUT, PAR_MODEL_SEED = 2, 2, 120, 16
# the MTL model of phases 7-9 and 16 (dropout 0.5 / 0.2, the defaults)
MTL_DIMS = dict(encoder_type="base", predictor_type="base", decoder_type="butd",
                ntoken=NTOKEN, v_dim=V_DIM, embed_dim=EMBED, hidden_dim=HIDDEN,
                decoder_hidden_dim=HIDDEN, ans_dim=ANS, c_len=C_LEN,
                att_type="new", use_mtl=True)
PAR_NOISE = ("attention.linear.bias",)

# phase 18: the bench's fast32 batch (held in phase 3 too); how far the
# bench's fast rate may lie from phase 6's B=16384 forward rate before the
# two are taken to time different things; bench_feed's arguments (a
# smaller corpus than its defaults, the same cells); a script's time limit;
BENCH_BATCH32 = 32768
BENCH_FORWARD_RATIO = 1.5
FEED_ARGS = ["--images", "64", "--questions", "4096", "--batches", "512", "4096",
             "--secs", "2"]
SCRIPT_TIMEOUT = 300
# phase 19: the convergence study (vqa_tpu_torch/scripts/bf16_convergence.py)
# at its batch and its decode-attention shape (boxes, decoder hidden, v_dim),
# which phase 3 holds too; its steps; the mean relative loss gap over the
# last 20 steps that the bf16 variants may keep to f32 and the kernel run to
# the plain one (the JAX study's gaps were 5.1e-4 and 5.0e-4), and how far
# the final train-split scores may lie from the plain run's
CONV_BATCH, CONV_ATT_SHAPE, CONV_STEPS = 32, (6, 64, 32), 300
CONV_GAP, CONV_SCORE_TOL = 2e-3, 0.01
# the four runs' time limit (they took 146 s together on an H100)
CONV_TIMEOUT = 400
# phase 20: the gate runner's data root (RUNBOOK.md §0 at a synthetic size)
# and the line its gate must print
GATE_ROOT_ARGS = dict(num_images=8, num_questions=32, num_objs=OBJS, v_dim=V_DIM)
GATE_FAIL_LINE = re.compile(r"^All: \d+\.\d\d vs gate 55\.80 -> FAIL$", re.M)
# the kernels that a path benchmark's row claims by a tag in its name
ROW_CLAIMS = {"fused-vocab": ("vocab_topk_lse",),
              "+int8": ("int8_matmul_dequant", "int8_matmul_dequant_3d")}

# the card's peaks for the bound of each kernel: HBM3 bytes per ms, dense
# bf16 and int8 tensor-core and f32 (non-tensor) operations per ms
# (NVIDIA's H100 SXM data sheet, at its full power limit of 700 W)
HBM_BYTES_PER_MS = 3.35e9
PEAK_OPS_PER_MS = {"bf16": 989e9, "int8": 1979e9, "f32": 67e9}
# the decode-attention kernels' third bound, the issue of their Philox
# draws: a Philox4x32-10 call is at least 40 instructions (10 rounds of two
# 32 x 32 -> 64-bit multiplies and two three-input XORs, csrc/decode_att.cu
# philox4x32_10), and the card issues at most one instruction a lane a
# clock on every lane, half the f32 rate above (which counts an FMA as two
# operations): 33.5e9 instructions a ms
PHILOX_INSTRUCTIONS = 40
ISSUE_PER_MS = PEAK_OPS_PER_MS["f32"] / 2

# kernel-name markers of the kinds a profile sums device time by, first
# match wins
PROFILE_KINDS = (
    ("the port's kernels", ("decode_att_", "vocab_topk_", "gru_seq_",
                            "dequant_matmul_", "pool_int8_", "attended_int8_",
                            "int8_matmul_",
                            "gcn_chain_")),
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cutlass", "Gemm")),
    ("int64 elementwise (the torch Philox of the hidden masks)", ("<long",)),
    ("copies and casts", ("copy",)),
    ("reductions", ("reduce_kernel",)),
)

KERNELS = {
    "gru_v2": {"source": "vqa_tpu_torch/csrc/gru.cu",
               "replaces": "vqa_tpu/ops/pallas/gru_v2.py:74"},
    "dequant_matmul": {"source": "vqa_tpu_torch/csrc/feed_gemm.cu",
                       "replaces": "vqa_tpu/ops/pallas/feed_gemm.py:55"},
    # the same kernel's gated epilogue: the serving attention's projection,
    # bias, ReLU and folded logits
    "dequant_matmul_gated_logits": {
        "source": "vqa_tpu_torch/csrc/feed_gemm.cu",
        "replaces": "vqa_tpu/ops/pallas/feed_gemm.py:55 and vqa_tpu/ops/attention.py:141"},
    "pool_int8": {"source": "vqa_tpu_torch/csrc/lazyv_pool.cu",
                  "replaces": "vqa_tpu/ops/pallas/lazyv_pool.py:46"},
    # the port's own: XLA fuses the JAX package's cast and two multiplies
    "attended_int8": {"source": "vqa_tpu_torch/csrc/lazyv_pool.cu",
                      "replaces": "none: XLA's fusion of vqa_tpu/models/encoder.py's "
                                  "v_att * dequantize(img_q, img_scale)"},
    "vocab_topk_lse": {"source": "vqa_tpu_torch/csrc/vocab_topk.cu",
                       "replaces": "vqa_tpu/ops/pallas/vocab_topk.py:114"},
    "decode_att_fwd": {"source": "vqa_tpu_torch/csrc/decode_att.cu",
                       "replaces": "vqa_tpu/ops/pallas/decode_att.py:175"},
    "decode_att_bwd": {"source": "vqa_tpu_torch/csrc/decode_att.cu",
                       "replaces": "vqa_tpu/ops/pallas/decode_att.py:300"},
    "decode_att_dvp": {"source": "vqa_tpu_torch/csrc/decode_att.cu",
                       "replaces": "vqa_tpu/ops/pallas/decode_att.py:403"},
    "int8_matmul_dequant": {"source": "vqa_tpu_torch/csrc/int8_matmul.cu",
                            "replaces": "vqa_tpu/ops/pallas/int8_matmul.py:73"},
    "int8_matmul_dequant_3d": {"source": "vqa_tpu_torch/csrc/int8_matmul.cu",
                               "replaces": "vqa_tpu/ops/pallas/int8_matmul.py:170"},
    "gcn_chain_fused": {"source": "vqa_tpu_torch/csrc/gcn_chain.cu",
                        "replaces": "vqa_tpu/ops/pallas/gcn_chain.py:102"},
    "fused_multiply_attention_pool": {
        "source": "vqa_tpu_torch/csrc/fused_attention.cu",
        "replaces": "vqa_tpu/ops/pallas/fused_attention.py:66"},
    "gru_last_state": {"source": "vqa_tpu_torch/csrc/gru.cu",
                       "replaces": "vqa_tpu/ops/pallas/gru.py:82"},
    "gru_last_state_v3": {"source": "vqa_tpu_torch/csrc/gru.cu",
                          "replaces": "vqa_tpu/ops/pallas/gru_v3.py:77"},
}
# the kernels each path must launch
VQA_KERNELS = ("gru_v2", "dequant_matmul_gated_logits", "pool_int8")
DECODE_KERNELS = ("vocab_topk_lse", "gru_v2", "dequant_matmul_gated_logits")
TRAIN_KERNELS = ("decode_att_fwd", "decode_att_bwd", "decode_att_dvp")
# a ReGAT forward: the question GRU, the v-projection (3-D entry), the
# attended features, the GCN's three projections (2-D entry), the chain;
# the launches of each
REGAT_KERNELS = {"gru_v2": 1, "int8_matmul_dequant_3d": 1, "attended_int8": 1,
                 "int8_matmul_dequant": 3, "gcn_chain_fused": 1}
# the library kernels, which no model path calls
LIBRARY_KERNELS = ("fused_multiply_attention_pool", "gru_last_state",
                   "gru_last_state_v3")
# the path whose run gives each kernel's "launches" (the library kernels':
# the entry point's four modes together, where they launch no time)
# (the plain dequant_matmul epilogue is a library entry, as
# gru_last_state is: no model path calls it; the attention runs the gated
# one, or the plain PyTorch form where that refuses the shapes)
MAIN_PATH = {**{k: "vqa" for k in VQA_KERNELS}, "dequant_matmul": "vqa",
             "vocab_topk_lse": "decode",
             **{k: "train" for k in TRAIN_KERNELS},
             **{k: "regat" for k in REGAT_KERNELS if k != "gru_v2"},
             **{k: "cli" for k in LIBRARY_KERNELS}}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


_PHASES = []


def phase(name: str) -> None:
    """Start phase ``name``: log the wall time of the one before it (host
    clock, after a synchronise), and keep it for the summary."""
    torch.cuda.synchronize()
    now = time.monotonic()
    if _PHASES:
        log(f"phase {_PHASES[-1][0]}: {now - _PHASES[-1][1]:.1f} s")
    _PHASES.append((name, now))


def time_ms(fn, iters: int) -> float:
    """Mean device time of one call of ``fn`` over ``iters`` calls, by CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_pair(kernel_fn, plain_fn, iters: int):
    """(kernel ms, plain ms), each the mean of two runs in the order plain,
    kernel, kernel, plain."""
    p0 = time_ms(plain_fn, iters)
    k0 = time_ms(kernel_fn, iters)
    k1 = time_ms(kernel_fn, iters)
    p1 = time_ms(plain_fn, iters)
    return (k0 + k1) / 2, (p0 + p1) / 2


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(nbytes_: int, ops: float, kind: str, draws: int = 0):
    """(bound ms, what bounds it, which term): the largest of the bytes over
    the HBM rate, the operations over the card's peak for their type, and
    the instructions of ``draws`` Philox calls over the issue rate. What
    bounds it is "bytes" or "operations" (products and draws alike); the
    term is "bytes", "products" or "philox issue"."""
    terms = {"bytes": nbytes_ / HBM_BYTES_PER_MS, "products": ops / PEAK_OPS_PER_MS[kind],
             "philox issue": draws * PHILOX_INSTRUCTIONS / ISSUE_PER_MS}
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


def gru_ops(batch: int, t_len: int, hidden: int, e_dim: int = 0) -> float:
    """Operations a GRU over t_len steps needs: the input product [B, E] x
    [E, 3H] every step (when done inside, e_dim > 0) and the recurrent
    product [B, H] x [H, 3H] on all but the first, whose state is zero."""
    return 2.0 * batch * 3 * hidden * (t_len * e_dim + (t_len - 1) * hidden)


def plain_kernels(stack: ExitStack, gru_v2, feed_gemm, lazyv_pool,
                  vocab_topk, decode_att, int8_matmul, gcn_chain) -> None:
    """Swap each kernel wrapper for its plain version while ``stack`` is open."""
    stack.enter_context(mock.patch.object(
        gru_v2, "gru_last_state_v2", gru_v2.gru_last_state_v2_reference))
    for name in ("dequant_matmul", "dequant_matmul_gated_logits"):
        stack.enter_context(mock.patch.object(
            feed_gemm, name, getattr(feed_gemm, name + "_reference")))
    stack.enter_context(mock.patch.object(
        lazyv_pool, "pool_int8", lazyv_pool.pool_int8_reference))
    stack.enter_context(mock.patch.object(
        lazyv_pool, "attended_int8", lazyv_pool.attended_int8_reference))
    stack.enter_context(mock.patch.object(
        vocab_topk, "vocab_topk_lse", vocab_topk.vocab_topk_lse_reference))
    for name in TRAIN_KERNELS:
        stack.enter_context(mock.patch.object(
            decode_att, name, getattr(decode_att, name + "_reference")))
    for name in ("int8_matmul_dequant", "int8_matmul_dequant_3d"):
        stack.enter_context(mock.patch.object(
            int8_matmul, name, getattr(int8_matmul, name + "_reference")))
    stack.enter_context(mock.patch.object(
        gcn_chain, "gcn_chain_fused", gcn_chain.gcn_chain_reference))


def compare_beams(name: str, got, want, start_id: int) -> float:
    """Share of requests' images whose best beam is the same in ``got``
    and ``want`` (lists of (tokens, scores)); logs it with the largest score
    difference on those beams."""
    tok = torch.cat([t[:, 0] for t, _ in got])
    w_tok = torch.cat([t[:, 0] for t, _ in want])
    score = torch.cat([s[:, 0] for _, s in got])
    w_score = torch.cat([s[:, 0] for _, s in want])
    same = (tok == w_tok).all(dim=1)
    agree = same.float().mean().item()
    diff = (score - w_score).abs()[same]
    log(f"decode: best beams vs {name}: {agree:.4f} identical over "
        f"{same.numel()} images; on those, max |score diff| "
        f"{diff.max().item() if diff.numel() else float('nan'):.3g}, "
        f"tokens agreeing overall {(tok == w_tok).float().mean().item():.4f}")
    require(bool((tok[:, 0] == start_id).all()), "beams must start with <start>")
    return agree


def device_kernels(run) -> list:
    """(kernel name, device ms) of one call of ``run`` after a warm call,
    under torch.profiler, the longest first."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sorted(((e.key, e.device_time_total / 1e3) for e in prof.key_averages()
                   if e.device_time_total > 0 and e.device_type.name == "CUDA"),
                  key=lambda kv: -kv[1])


def profile_run(name: str, run, steps: int) -> None:
    """torch.profiler over one call of ``run``: device time by kernel, per
    step of ``steps``."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in events) / 1e3
    log(f"profile: one {name}, wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"(idle share {1 - busy / wall:.3f}); device ms per step of {steps}:")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:25]:
        log(f"profile:   {e.device_time_total / 1e3 / steps:9.4f}  x{e.count:<5d} {e.key[:90]}")
    by_kind = {}
    for e in events:
        kind = next((k for k, keys in PROFILE_KINDS if any(x in e.key for x in keys)),
                    "other elementwise")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.device_time_total / 1e3
    log(f"profile: one {name}, device ms by kind: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])))


def full_precision_products() -> None:
    """f32 products in f32 and bf16 products reduced in f32, in every
    process of the run, so that a rank computes what this process does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def parallel_phase(card: str, int8_feed, gen) -> dict:
    """Phase 16: the MTL training step of phase 7 (bf16 over f32 masters,
    dropout 0.5 / 0.2, use_pallas, the int8 feed) over PAR_RANKS processes
    (the ``('data', 'model')`` mesh of ``vqa_tpu_torch.parallel``, data
    parallel: over gloo where they share the card, over NCCL where each has
    its own), each on its B=512 rows of one batch whose halves hold
    different caption-token counts. This process first runs the reference:
    those halves, one after the other, with each rank's folded seeds and
    the global token count, their gradients averaged; then it starts the
    ranks, which build the model from the same seed. Where the machine has
    two cards, a 1x2 tensor-parallel step (NCCL, a card a rank) on one
    B=512 half follows, held to that half's one-process step. Returns rank
    0's kernel launches of one full data-parallel step."""
    from vqa_tpu_torch.models.wrapper import set_model
    from vqa_tpu_torch.training.state import backward_step, joint_loss

    tp = torch.cuda.device_count() >= 2
    dev, bf16 = torch.device("cuda", 0), torch.bfloat16
    spec = {"dims": MTL_DIMS, "seed": PAR_MODEL_SEED}
    model = set_model(**spec["dims"], use_pallas=True,
                      generator=torch.Generator().manual_seed(spec["seed"]))
    rows = PAR_RANKS * TRAIN_BATCH
    x_q, scale = int8_feed(rows * OBJS, V_DIM)
    batch = {"q": torch.randint(0, NTOKEN, (rows, Q_LEN), device=dev, generator=gen),
             "a": (torch.randint(0, 4, (rows, ANS), device=dev, generator=gen)
                   * (torch.rand(rows, ANS, device=dev, generator=gen) < 2e-3)) / 3.0,
             "c": torch.randint(0, NTOKEN - 4, (rows, C_LEN), device=dev, generator=gen),
             "cap_len": torch.randint(2, C_LEN + 1, (rows,), device=dev, generator=gen),
             "img_q": x_q.view(rows, OBJS, V_DIM),
             "img_scale": scale.view(rows, OBJS).float()}
    halves = [{k: v[r * TRAIN_BATCH:(r + 1) * TRAIN_BATCH] for k, v in batch.items()}
              for r in range(PAR_RANKS)]
    counts = [int((h["cap_len"] - 1).clamp(min=0).sum()) for h in halves]
    require(len(set(counts)) == PAR_RANKS,
            f"phase 16: the ranks' caption-token counts {counts} do not differ")
    mean = sum(counts) / PAR_RANKS

    def reference(parts, token_count):
        """Loss and gradients, averaged over ``parts`` (part r run with data
        rank r's seeds), in f32 and bf16."""
        ref = {}
        for label, dtype in (("f32", None), ("bf16", bf16)):
            loss, grads = 0.0, {}
            for r, part in enumerate(parts):
                m = backward_step(model, part, RUN_SEED, 0, dtype, joint_loss, r,
                                  token_count)
                loss += m["loss"].item() / len(parts)
                for n, p in model.named_parameters():
                    grads[n] = p.grad.detach().clone() if r == 0 else grads[n] + p.grad
            ref[label] = {"loss": loss,
                          "grads": {n: (g / len(parts)).cpu() for n, g in grads.items()}}
        return ref

    with tempfile.TemporaryDirectory() as work:
        torch.save({"batch": {k: v.cpu() for k, v in batch.items()},
                    "ref": reference(halves, lambda c: torch.full_like(c, mean))},
                   os.path.join(work, "dp.pt"))
        if tp:
            torch.save({"batch": {k: v.cpu() for k, v in halves[0].items()},
                        "ref": reference(halves[:1], None)},
                       os.path.join(work, "tp.pt"))
        del model, batch, halves, x_q, scale
        torch.cuda.empty_cache()
        results = finish_ranks(work, "dp", start_ranks(work, "dp", dict(spec, n_model=1)))
        tp_results = (finish_ranks(work, "tp", start_ranks(work, "tp", dict(spec, n_model=2)))
                      if tp else None)
    for rank, res in enumerate(results):
        step = res["step_launches"]
        log(f"parallel: rank {rank} launches in one step: "
            f"{ {k: step[k] for k in TRAIN_KERNELS} }")
        require(step["decode_att_fwd"] == step["decode_att_bwd"] == C_LEN - 1
                and step["decode_att_dvp"] == 1,
                f"phase 16: rank {rank} did not launch decode_att_fwd / _bwd once per "
                "decoder step and decode_att_dvp once per step")
    shared = results[0]["backend"] == "gloo"
    log(f"time parallel step: {PAR_RANKS} ranks x B={TRAIN_BATCH} over "
        f"{results[0]['backend']}"
        + (" on one card (a correctness witness: the ranks share the card and gloo "
           "stages the all-reduce through the host, so this is no figure for NCCL)"
           if shared else ", a card a rank")
        + f", bf16 MTL step {results[0]['step_ms']:.2f} ms (rank 0), "
        f"{results[1]['step_ms']:.2f} ms (rank 1), token counts {counts} [{card}]")
    if tp:
        log(f"time parallel 1x2 tensor-parallel step (NCCL, a card a rank), bf16 MTL step "
            f"B={TRAIN_BATCH}: {tp_results[0]['step_ms']:.2f} ms [{card}]")
    else:
        log(f"parallel: the 1x2 tensor-parallel step was not run on this machine: it has "
            f"{torch.cuda.device_count()} card, gloo cannot all-gather CUDA tensors, and "
            "NCCL refuses two ranks on one card")
    return results[0]["step_launches"]


def start_ranks(work: str, tag: str, spec: dict) -> list:
    """Start PAR_RANKS ``--parallel-rank work/{tag}`` processes after writing
    ``work/{tag}.json`` (the model's dims and seed, the mesh's model axis)."""
    from vqa_tpu_torch.parallel.dryrun import free_port

    path = os.path.join(work, tag)
    with open(path + ".json", "w") as f:
        json.dump(spec, f)
    port = free_port()
    procs = []
    for rank in range(PAR_RANKS):
        env = dict(os.environ, VQA_TPU_MULTIHOST="1", VQA_TPU_COORD=f"localhost:{port}",
                   VQA_TPU_NPROCS=str(PAR_RANKS), VQA_TPU_PROC_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                       "--parallel-rank", path], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return procs


def finish_ranks(work: str, tag: str, procs: list) -> list:
    """Wait for the ranks, log their output and their gradient checks, fail
    unless every one ends well; returns their results."""
    from vqa_tpu_torch.parallel.dryrun import wait_ranks

    outs = wait_ranks(procs, PAR_TIMEOUT)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            log(f"  {tag} rank {rank}: {line}")
        require(p.returncode == 0, f"phase 16 ({tag}): rank {rank} exited with {p.returncode}")
    results = []
    for rank in range(PAR_RANKS):
        with open(os.path.join(work, f"{tag}.rank{rank}.json")) as f:
            results.append(json.load(f))
    for rank, res in enumerate(results):
        for label, tol in (("f32", GRAD_F32_TOL), ("bf16", GRAD_BF16_TOL)):
            cmp = res[label]
            log(f"parallel ({tag}): rank {rank} {label} step against one process: loss "
                f"{cmp['loss']:.6f} vs {cmp['ref_loss']:.6f} (rel {cmp['loss_rel']:.3g}), "
                f"worst max |grad diff| / max |grad| {cmp['worst']} {cmp['worst_rel']:.3g} "
                f"(tolerance {tol:g})")
            require(cmp["loss_rel"] <= tol and cmp["worst_rel"] <= tol,
                    f"phase 16 ({tag}): rank {rank} {label} step disagrees with one process")
    return results


def parallel_rank(path: str) -> int:
    """One rank of phase 16 (``--parallel-rank PATH``): joins the process
    group, builds the model of ``PATH.json`` from its seed, reads
    ``PATH.pt`` (the batch and the reference), holds its gradients of an f32
    and a bf16 step (averaged over the data group, gathered over the model
    group) against the reference, counts the kernels of one full step and
    times PAR_TIMED_STEPS more."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vqa_tpu_torch.models.wrapper import set_model
    from vqa_tpu_torch.ops.kernels import _build
    from vqa_tpu_torch.parallel import mesh as mesh_lib
    from vqa_tpu_torch.training.optim import make_optimizer
    from vqa_tpu_torch.training.state import (
        TrainState, backward_step, joint_loss, make_train_step, reduce_over_data)

    t_rank = time.monotonic()
    full_precision_products()
    world = mesh_lib.init_distributed("cuda")
    try:
        with open(path + ".json") as f:
            spec = json.load(f)
        mesh = mesh_lib.make_mesh(n_model=spec["n_model"])
        model = set_model(**spec["dims"], use_pallas=True, device=world.device,
                          generator=torch.Generator().manual_seed(spec["seed"]))
        mesh_lib.shard_params(model, mesh)
        opt = make_optimizer(model, lr=TRAIN_LR, max_norm=TRAIN_CLIP)
        state = TrainState(model, opt, seed=RUN_SEED)
        mesh_lib.replicate_global(mesh, state)
        print(f"joined, built and replicated the model in "
              f"{time.monotonic() - t_rank:.1f} s", flush=True)
        inputs = torch.load(path + ".pt", weights_only=True)
        local = {k: v.to(world.device)
                 for k, v in mesh_lib.shard_batch(mesh, inputs["batch"]).items()}
        out = {"backend": world.backend}
        for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            m = backward_step(model, local, RUN_SEED, 0, dtype, joint_loss,
                              mesh_lib.axis_rank(mesh, "data"),
                              mesh_lib.data_token_count(mesh))
            reduce_over_data(model, m, mesh)
            grads = mesh_lib.gather_shards(
                {n: p.grad for n, p in model.named_parameters()},
                getattr(model, "tp_layout", {}), getattr(model, "tp_shard", None))
            ref = inputs["ref"][label]
            rel = {}
            for n, g in grads.items():
                if n.endswith(PAR_NOISE):
                    continue
                want = ref["grads"][n].to(world.device)
                rel[n] = ((g - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
            worst = max(rel, key=rel.get)
            loss = m["loss"].item()
            out[label] = {"loss": loss, "ref_loss": ref["loss"],
                          "loss_rel": abs(loss - ref["loss"]) / abs(ref["loss"]),
                          "worst": worst, "worst_rel": rel[worst]}
        step = make_train_step(model, opt, compute_dtype=torch.bfloat16, mesh=mesh)
        _build.reset_launches()
        step(state, local)
        torch.cuda.synchronize()
        out["step_launches"] = dict(_build.LAUNCHES)
        mesh_lib.barrier()
        t0 = time.monotonic()
        for _ in range(PAR_TIMED_STEPS):
            step(state, local)
        torch.cuda.synchronize()
        out["step_ms"] = (time.monotonic() - t0) / PAR_TIMED_STEPS * 1e3
        with open(f"{path}.rank{world.rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def host_feed_phase(card: str, dev, host_build_s: float, decoded) -> dict:
    """Phase 17: the host side of the feed. The port's packer writes a
    seeded npz directory into an int8 store (it must hold what
    ``quantize_features`` gives); phase 4's model serves SERVE_REQUESTS
    requests of SERVE_BATCH from it through the port's Loader on the host
    library's routes, each batch byte-equal to the same batch assembled by
    the numpy routes and its logits bit-equal; then the feed's host figures
    beside the card's copy and forward, the port's cap_eval on phase 13's
    ``decode.txt``, and visualize's model half on a ReGAT sample. Returns
    the kernel launches of the served requests."""
    from vqa_tpu_torch import cap_eval
    from vqa_tpu_torch.data import native
    from vqa_tpu_torch.data.dataset import set_dataset
    from vqa_tpu_torch.data.loader import Loader
    from vqa_tpu_torch.data.shards import pack_feature_dir, quantize_features
    from vqa_tpu_torch.data.synthetic import make_synthetic_root
    from vqa_tpu_torch.data.tokenizer import soft_answer_scores
    from vqa_tpu_torch.models.wrapper import set_model
    from vqa_tpu_torch.ops.kernels import _build
    from vqa_tpu_torch.tools import visualize

    bf16 = torch.bfloat16
    host = (f"host: {os.cpu_count()} CPUs, {native.threads()} feed threads "
            f"(VQA_NATIVE_THREADS {os.environ.get('VQA_NATIVE_THREADS', 'unset')})")
    require(native.available(), "the host library is not available")
    log(f"host feed: the host library built in {host_build_s:.2f} s from "
        f"{native.SOURCE.relative_to(native.SOURCE.parents[3])}; {host}")

    def on_card(b):
        return {"q": torch.from_numpy(b["q"]).to(dev, torch.long),
                "img_q": torch.from_numpy(b["img_q"]).to(dev),
                "img_scale": torch.from_numpy(b["img_scale"]).to(dev, bf16),
                "a": torch.from_numpy(b["a"]).to(dev)}

    def wall_ms(fn, reps: int) -> float:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    here = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        # -- pack: the port's packer over a seeded npz directory
        make_synthetic_root(root, split="val2014", num_images=64,
                            num_questions=SERVE_BATCH * SERVE_REQUESTS,
                            num_objs=OBJS, v_dim=V_DIM, vocab_size=NTOKEN,
                            num_answers=ANS, q_len=Q_LEN, seed=17)
        feat_dir = os.path.join(root, "features", "val2014")
        graph_dir = os.path.join(root, "graphs", "val2014")
        packed = os.path.join(root, "packed")
        os.makedirs(packed)
        t0 = time.perf_counter()
        store = pack_feature_dir(feat_dir, os.path.join(packed, "val2014"),
                                 feature_dtype=np.int8, graph_dir=graph_dir)
        pack_s = time.perf_counter() - t0
        for name, row in store.index.items():
            with np.load(os.path.join(feat_dir, name)) as z, \
                    np.load(os.path.join(graph_dir, name)) as g:
                q, scale = quantize_features(z["x"])
                require(np.array_equal(store.features[row], q)
                        and np.array_equal(store.scales[row], scale)
                        and np.array_equal(store.bbox[row], z["bbox"])
                        and np.array_equal(store.graphs[row], g["graph"]),
                        f"the packed store's row {row} is not {name} quantized")
        log(f"host feed: pack_feature_dir packed {len(store.index)} images of "
            f"{OBJS}x{V_DIM} into an int8 store with scales, boxes and graphs in "
            f"{pack_s:.2f} s; every row equal to quantize_features of its npz")

        # -- serve: the Loader on the native routes against the numpy routes
        dataset = set_dataset(os.path.join(root, "annot"), packed, ANS,
                              graph_path=os.path.join(root, "graphs"),
                              is_val=True, dataset_type="vqa", feature_mode="int8")
        native.reset_routes()
        batches = list(Loader(dataset, SERVE_BATCH, drop_last=True))
        routes = dict(native.ROUTES)
        with mock.patch.object(native, "_load", lambda: None):
            native.reset_routes()
            plain = list(Loader(dataset, SERVE_BATCH, drop_last=True))
            plain_routes = dict(native.ROUTES)
        log(f"host feed: routes of the Loader's {len(batches)} batches {routes}; "
            f"with the library off {plain_routes}")
        require(len(batches) == len(plain) == SERVE_REQUESTS,
                f"the Loader gave {len(batches)} batches")
        require(routes["fallback"] == 0 and routes["native"] == 3 * SERVE_REQUESTS,
                "the feed did not take the host library's routes (a feature "
                "gather, a graph gather and a densify a batch)")
        require(plain_routes["native"] == 0, "the plain feed reached the library")
        for b, p in zip(batches, plain):
            require(set(b) == set(p), f"batch keys {sorted(b)} against {sorted(p)}")
            for key in p:
                same = (np.asarray(b[key]).dtype == np.asarray(p[key]).dtype
                        and np.asarray(b[key]).tobytes() == np.asarray(p[key]).tobytes())
                require(same, f"batch key {key}: the native route's bytes differ "
                        "from the numpy route's")
        log(f"host feed: every batch byte-equal to the numpy routes' (keys "
            f"{sorted(batches[0])})")

        model = set_model(**SERVE_DIMS, use_pallas=True,
                          generator=torch.Generator().manual_seed(0))
        model = model.to(device=dev, dtype=bf16).eval()
        requests = [on_card(b) for b in batches]
        with torch.inference_mode():
            _build.reset_launches()
            served = [model.forward_vqa(r) for r in requests]
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            log(f"host feed: {SERVE_REQUESTS} requests of B={SERVE_BATCH} from the "
                f"packed store through VQAModel.forward_vqa; kernel launches {launches}")
            for name in VQA_KERNELS:
                require(launches[name] == SERVE_REQUESTS,
                        f"{name} launched {launches[name]} times, not {SERVE_REQUESTS}")
            for score, label, _ in served:
                require(score.shape == (SERVE_BATCH, ANS) and label.shape == (SERVE_BATCH,)
                        and bool(torch.isfinite(score).all()), "bad forward_vqa output")
            same = all(torch.equal(model(r)[0], model(on_card(p))[0])
                       for r, p in zip(requests, plain))
            log(f"host feed: logits of the native batches equal those of the numpy "
                f"routes' batches bit for bit: {same}")
            require(same, "the logits of the two feeds differ")

        # -- timing (host figures: this machine's CPUs, not the card's)
        rng = np.random.default_rng(17)
        big = np.lib.format.open_memmap(os.path.join(root, "timing_features.npy"),
                                        mode="w+", dtype=np.int8,
                                        shape=(FEED_STORE_ROWS, OBJS, V_DIM))
        for start in range(0, FEED_STORE_ROWS, 1024):
            big[start:start + 1024] = np.frombuffer(
                rng.bytes(1024 * OBJS * V_DIM), np.int8).reshape(1024, OBJS, V_DIM)
        big.flush()
        del big
        big = np.load(os.path.join(root, "timing_features.npy"), mmap_mode="r")
        rows = rng.integers(0, FEED_STORE_ROWS, FEED_BATCH)
        gathered = native.gather_rows(big, rows, widen_f16=False)
        require(gathered.tobytes() == np.asarray(big[rows]).tobytes(),
                "the native gather's bytes differ from numpy's")
        g_np0 = wall_ms(lambda: np.asarray(big[rows]), 2)
        g_nat = wall_ms(lambda: native.gather_rows(big, rows, widen_f16=False), 4)
        g_np1 = wall_ms(lambda: np.asarray(big[rows]), 2)
        g_np = (g_np0 + g_np1) / 2
        with mock.patch.dict(os.environ, {"VQA_NATIVE_THREADS": "1"}):
            g_nat1 = wall_ms(lambda: native.gather_rows(big, rows, widen_f16=False), 2)
        # what a gather's fresh output costs before a byte is copied (the
        # first touch of its pages), and numpy's gather into a buffer whose
        # pages are already there
        touch = wall_ms(lambda: np.ones(gathered.shape, np.int8), 3)
        reused = np.ones_like(gathered)
        g_take = wall_ms(lambda: np.take(big, rows, axis=0, out=reused), 3)
        del reused
        mib = gathered.nbytes / 2 ** 20
        log(f"time host gather B={FEED_BATCH} int8 rows of {OBJS}x{V_DIM} from a "
            f"memory-mapped store of {FEED_STORE_ROWS} rows ({mib:.1f} MiB): native "
            f"{g_nat:.2f} ms ({mib / g_nat * 1e3 / 1024:.2f} GiB/s), numpy "
            f"{g_np:.2f} ms ({g_np0:.2f}, {g_np1:.2f}); x{g_np / g_nat:.2f}; native on "
            f"1 thread {g_nat1:.2f} ms; a fresh "
            f"{mib:.1f} MiB array's first touch {touch:.2f} ms; numpy's gather into a "
            f"buffer already touched {g_take:.2f} ms [{host}; {card}]")
        dicts = [dataset.answers[i % len(dataset)] for i in range(FEED_BATCH)]
        dense = native.densify_answers_native(dicts, ANS)
        python = np.asarray([soft_answer_scores(d, ANS) for d in dicts], np.float32)
        require(dense.tobytes() == python.tobytes(),
                "the native densify differs from the Python loop")
        d_py = wall_ms(lambda: np.asarray([soft_answer_scores(d, ANS) for d in dicts],
                                          np.float32), 1)
        d_nat = wall_ms(lambda: native.densify_answers_native(dicts, ANS), 4)
        log(f"time host densify of {FEED_BATCH} answer dicts into [{FEED_BATCH}, {ANS}] "
            f"f32: native {d_nat:.2f} ms, Python {d_py:.2f} ms; x{d_py / d_nat:.1f} "
            f"[{host}; {card}]")
        loader = Loader(dataset, SERVE_BATCH, shuffle=True, drop_last=True)
        t0 = time.perf_counter()
        n_batches = sum(1 for _ in range(3) for _ in loader)
        loader_s = time.perf_counter() - t0
        log(f"time host Loader (int8 store with graphs, shuffled, B={SERVE_BATCH}): "
            f"{n_batches} batches in {loader_s * 1e3:.1f} ms, "
            f"{n_batches / loader_s:.1f} batches/s, {n_batches * SERVE_BATCH / loader_s:.0f} "
            f"questions/s [{host}; {card}]")
        host_batch = {"q": rng.integers(0, NTOKEN, (FEED_BATCH, Q_LEN)).astype(np.int32),
                      "img_q": gathered,
                      "img_scale": (rng.random((FEED_BATCH, OBJS), np.float32) * 2 + 2.5)
                      / 127,
                      "a": np.zeros((FEED_BATCH, ANS), np.float32)}
        h2d_bytes = sum(v.nbytes for v in host_batch.values())

        def copy_pageable():
            out = on_card(host_batch)
            torch.cuda.synchronize()
            return out
        pinned = {k: torch.from_numpy(v).pin_memory() for k, v in host_batch.items()}

        def copy_pinned():
            out = {k: v.to(dev, non_blocking=True) for k, v in pinned.items()}
            torch.cuda.synchronize()
            return out
        copy_pageable()
        copy_pinned()
        h2d_page = wall_ms(copy_pageable, 3)
        h2d_pin = wall_ms(copy_pinned, 3)
        request = on_card(host_batch)
        with torch.inference_mode():
            fwd = time_ms(lambda: model.forward_vqa(request), 5)
        log(f"time host-to-card copy of one B={FEED_BATCH} int8 batch "
            f"({h2d_bytes / 2 ** 20:.1f} MiB): pageable {h2d_page:.2f} ms "
            f"({h2d_bytes / h2d_page / 1e6:.2f} GB/s), pinned {h2d_pin:.2f} ms "
            f"({h2d_bytes / h2d_pin / 1e6:.2f} GB/s); the forward on the card "
            f"{fwd:.3f} ms; the native gather + densify {g_nat + d_nat:.2f} ms "
            f"[{host}; {card}]")
        del request, pinned, big

        # -- scoring: the port's cap_eval on phase 13's decode.txt
        exp = os.path.join(root, "checkpoint", "cli_decode")
        os.makedirs(exp)
        with open(os.path.join(exp, "decode.txt"), "w") as f:
            f.write("\n".join(decoded) + "\n")
        # five references a question: the decoded caption with three seeded
        # words after it, and four seeded sentences
        words = [f"w{i}" for i in range(NTOKEN - 4)]

        def sentence(n):
            return " ".join(rng.choice(words, n))
        refs = [{"c_word": [cap.replace("<start> ", "") + " " + sentence(3)]
                 + [sentence(rng.integers(6, 14)) for _ in range(4)]}
                for cap in decoded]
        ref_path = os.path.join(root, "val2014_captions.json")
        with open(ref_path, "w") as f:
            json.dump({"data": refs}, f)
        os.chdir(root)
        try:
            t0 = time.perf_counter()
            scores = cap_eval.main(["--load_ref", ref_path, "--load_path", "cli_decode"])
            score_s = time.perf_counter() - t0
        finally:
            os.chdir(here)
        require(len(scores) == 7 and all(math.isfinite(v) for v in scores.values())
                and min(scores["Bleu_1"], scores["METEOR"], scores["ROUGE_L"]) > 0,
                f"cap_eval scores {scores}: not finite, or no overlap with the "
                "references that hold each caption")
        log(f"host feed: cap_eval scored {len(decoded)} decoded captions of phase 13 "
            f"against a seeded reference file in {score_s:.2f} s: "
            + ", ".join(f"{k} {v:.6f}" for k, v in scores.items()))

        # -- visualize's model half on one ReGAT sample, on the card
        regat = set_model(**REGAT_DIMS, use_pallas=True, use_int8=True,
                          generator=torch.Generator().manual_seed(3))
        regat = regat.to(device=dev, dtype=bf16).eval()
        sample = visualize.sample_one_batch(dataset, 5)
        meta = sample.pop("_meta")
        predict, att, g_att = visualize.graph_attention(regat, sample)
        with torch.inference_mode():
            alphas = regat.encoder(visualize.on_model_device(sample, regat), graph_alpha=True)
        require(predict.shape == (1, ANS) and att.shape == (1, OBJS)
                and np.isfinite(predict).all() and np.isfinite(att).all(),
                f"visualize: predict {predict.shape}, att {att.shape}")
        require(abs(float(att.sum()) - 1.0) < VIS_ATT_SUM_TOL,
                f"visualize: the attention sums to {att.sum()}")
        require(len(alphas) == REGAT_DIMS["conv_layer"]
                and all(tuple(a.shape) == (1, OBJS, OBJS) for a in alphas)
                and g_att.shape == (OBJS,) and np.isfinite(g_att).all(),
                f"visualize: graph alphas {[tuple(a.shape) for a in alphas]}, "
                f"row {g_att.shape}")
        log(f"host feed: visualize on {meta['feature']} (ReGAT, bf16, the card): "
            f"attention sums to {att.sum():.6f}, top box {int(att[0].argmax())}; "
            f"graph alphas {[tuple(a.shape) for a in alphas]}, its row "
            f"{[round(float(x), 4) for x in g_att[:6]]}...")
    return launches


def script_run(name: str, argv: list) -> subprocess.CompletedProcess:
    """``python -m vqa_tpu_torch.<name> <argv>`` from the repository root,
    with its wall time logged; it must exit with 0."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", f"vqa_tpu_torch.{name}", *argv],
                          capture_output=True, text=True, cwd=root, timeout=SCRIPT_TIMEOUT)
    log(f"measurement: python -m vqa_tpu_torch.{name} {' '.join(argv)}: rc "
        f"{proc.returncode} in {time.monotonic() - t0:.1f} s")
    require(proc.returncode == 0, f"vqa_tpu_torch.{name} {' '.join(argv)} exited with "
            f"{proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc


def script_rows(proc: subprocess.CompletedProcess, unit: str, want: int) -> list:
    """A path benchmark's rows (the JAX script's format: name, ms, rate),
    ``want`` of them, each with the kernels it launched in its own run (its
    stderr ``launches`` line): at least one of those its name claims
    (ROW_CLAIMS) and no other, or none where its name claims none."""
    rows = [ln for ln in proc.stdout.splitlines()
            if ln.rstrip().endswith(f" {unit})") and " ms" in ln]
    require(len(rows) == want, f"{want} rows in {unit} expected, got:\n{proc.stdout}")
    reports = [json.loads(ln.split(" ", 1)[1]) for ln in proc.stderr.splitlines()
               if ln.startswith("launches {")]
    require(len(reports) == len(rows) and all(
        row.startswith(r["row"] + " ") for row, r in zip(rows, reports)),
            f"launch lines {[r['row'] for r in reports]} for rows {rows}")
    for row, report in zip(rows, reports):
        claimed = {k for tag, kernels in ROW_CLAIMS.items() if tag in report["row"]
                   for k in kernels}
        ran = {k for k, n in report["launches"].items() if n}
        require(ran <= claimed and (bool(ran) or not claimed),
                f"row {report['row']!r} launched {sorted(ran) or 'no kernel'}; its name "
                f"claims {sorted(claimed) or 'none'}")
        log(f"measurement:   {row}  [launches: "
            f"{ {k: report['launches'][k] for k in sorted(ran)} or 'none'}]")
    return rows


def measurement_phase(card: str, forward_ms: float) -> dict:
    """Phase 18: the measurement entry points on the card. ``python -m
    vqa_tpu_torch.bench`` at its defaults prints one line in the root
    bench's schema; each of its rungs launches its kernels (WARMUP + ITERS)
    x REPS times and no other; its ``fast`` rate lies within
    BENCH_FORWARD_RATIO of the phase-6 forward's (``forward_ms`` at
    TIME_BATCH). Then ``entry()``'s forward, and each path benchmark once.
    Returns the bench's kernel launches, all rungs together."""
    from vqa_tpu_torch import bench
    from vqa_tpu_torch.entry import entry

    proc = script_run("bench", [])
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    require(len(lines) == 1, f"the bench printed {len(lines)} lines:\n{proc.stdout}")
    result = json.loads(lines[0])
    require(set(result) == {"metric", "value", "unit", "vs_baseline"}
            and result["metric"] == "vqa_updown_batch_inference_questions_per_sec_per_chip"
            and result["unit"] == "questions/s" and result["value"] > 0
            and result["vs_baseline"] == round(
                result["value"] / (bench.TARGET_MULTIPLIER * bench.REF_GPU_QPS), 3),
            f"the bench's line is not in the root bench's schema: {lines[0]}")
    rungs = {}
    for line in proc.stderr.splitlines():
        if "] rung {" in line:
            r = json.loads(line.split("] rung ", 1)[1])
            rungs[r["rung"]] = r
    require(list(rungs) == list(bench.RUNGS), f"the bench's rungs {list(rungs)}")
    each = (bench.WARMUP + bench.ITERS) * bench.REPS
    want = {"safe": (), "medium": ("gru_v2",), "fast": VQA_KERNELS, "fast32": VQA_KERNELS}
    total = dict.fromkeys(KERNELS, 0)
    for name, r in rungs.items():
        expect = {k: each if k in want[name] else 0 for k in KERNELS}
        require(r["launches"] == expect, f"bench rung {name}: launches "
                f"{ {k: v for k, v in r['launches'].items() if v} }, expected "
                f"{ {k: v for k, v in expect.items() if v} }")
        for k, v in r["launches"].items():
            total[k] += v
        log(f"measurement: bench rung {name} B={r['batch']} (staging "
            f"{r['staging_s']:.2f} s): {r['qps']:.1f} q/s, {r['ms_per_forward']:.3f} ms a "
            f"forward (host clock {r['wall_qps']:.1f} q/s), peak "
            f"{r['peak_bytes'] / 2 ** 30:.2f} GiB, "
            + (f"{each} launches each of {', '.join(want[name])}" if want[name]
               else "no kernel launch") + f" [{card}]")
    forward_qps = TIME_BATCH / forward_ms * 1e3
    ratio = rungs["fast"]["qps"] / forward_qps
    log(f"measurement: the bench's line {lines[0]}; fast {rungs['fast']['qps']:.1f} q/s "
        f"against phase 6's B={TIME_BATCH} forward {forward_qps:.1f} q/s: ratio "
        f"{ratio:.4f} (limit {BENCH_FORWARD_RATIO:g}x either way) [{card}]")
    require(1 / BENCH_FORWARD_RATIO <= ratio <= BENCH_FORWARD_RATIO,
            "the bench's fast rung does not time what phase 6 times")

    forward, (params, batch) = entry()
    with torch.inference_mode():
        logits = forward(params, batch)
    require(tuple(logits.shape) == (32, ANS) and bool(torch.isfinite(logits).all()),
            f"entry(): logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    log(f"measurement: entry() on {logits.device}: logits {tuple(logits.shape)}, finite, "
        f"max |logit| {logits.abs().max().item():.4f}")
    del forward, params, batch, logits
    torch.cuda.empty_cache()

    script_rows(script_run("scripts.bench_beam", ["fused"]), "captions/s", 2)
    script_rows(script_run("scripts.bench_regat", []), "q/s", 2)
    script_rows(script_run("scripts.bench_train", ["vqa"]), "q/s", 2)
    proc = script_run("scripts.bench_feed", FEED_ARGS)
    cells = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith('{"feed"')]
    require(len(cells) == 3 * 2 * 2 and all(
        set(c) == {"feed", "batch", "prefetch", "batches", "questions_per_s",
                   "questions_per_s_p90", "feed_GBps"} for c in cells),
            f"bench_feed cells:\n{proc.stdout}")
    best = json.JSONDecoder().raw_decode(
        proc.stdout, proc.stdout.index('{\n  "best_per_feed"'))[0]
    require(set(best["best_per_feed"]) == {"int8", "f16", "f32"}, "bench_feed best")
    for feed, c in best["best_per_feed"].items():
        log(f"measurement:   bench_feed best {feed}: B={c['batch']} prefetch "
            f"{c['prefetch']}: {c['questions_per_s']} q/s (p90 {c['questions_per_s_p90']}), "
            f"{c['feed_GBps']} GB/s [host: {os.cpu_count()} CPUs]")
    return total


def convergence_run(path: str) -> int:
    """One run of phase 19 (``--convergence-run PATH``): the study's
    ``run()`` on the card as ``PATH`` (JSON) says (variant, steps, the
    synthetic root's paths; ``plain``: the decode-attention kernels swapped
    for their plain versions), with the launch counts set to 0 just before
    and read just after; writes the result and the counts to ``PATH``'s
    ``out``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vqa_tpu_torch.ops.kernels import _build, decode_att
    from vqa_tpu_torch.scripts import bf16_convergence as study

    with open(path) as f:
        spec = json.load(f)
    # four of these share the host's cores; none computes on the CPU
    torch.set_num_threads(1)
    with ExitStack() as stack:
        if spec["plain"]:
            for name in TRAIN_KERNELS:
                stack.enter_context(mock.patch.object(
                    decode_att, name, getattr(decode_att, name + "_reference")))
        _build.reset_launches()
        result = study.run(spec["variant"], spec["paths"], spec["steps"], "butd", "cuda",
                           use_pallas=True)
        torch.cuda.synchronize()
        result["launches"] = dict(_build.LAUNCHES)
    with open(spec["out"], "w") as f:
        json.dump(result, f)
    return 0


def convergence_phase(card: str) -> dict:
    """Phase 19: the convergence study through its ``run()`` on the card,
    ``--decoder butd``, CONV_STEPS steps a run: f32, bf16 and int8feed-bf16
    with ``use_pallas`` (decode_att_fwd and _bwd once a decoder step, _dvp
    once a step, exactly), and int8feed-bf16 again with the three kernels
    swapped for their plain versions (no launch). The four runs are
    processes of their own (``--convergence-run``), all started together:
    each is bound by the host, and one process alone leaves the card idle
    most of the time. Every loss finite; the scan constructed; each final
    loss under the slow CPU test's ceiling at CONV_STEPS; the bf16 variants
    within CONV_GAP of f32 and the kernel run within CONV_GAP of the plain
    run (mean relative gap over the last 20 steps); every final score within
    CONV_SCORE_TOL of the plain run's. Returns the launches of the three
    kernel runs together."""
    from vqa_tpu_torch.data.synthetic import make_synthetic_root
    from vqa_tpu_torch.parallel.dryrun import wait_ranks
    from vqa_tpu_torch.scripts import bf16_convergence as study

    require(study.BATCH == CONV_BATCH and CONV_ATT_SHAPE == (
        study.ROOT_ARGS["num_objs"], 64, study.ROOT_ARGS["v_dim"]),
            "phase 3 does not hold the decode-attention kernels at the study's shape")
    names = [*study.VARIANTS, "int8feed-bf16 plain"]
    with tempfile.TemporaryDirectory() as work:
        paths = make_synthetic_root(os.path.join(work, "root"), **study.ROOT_ARGS)
        procs = []
        for i, name in enumerate(names):
            spec = {"variant": name.split()[0], "plain": name.endswith("plain"),
                    "steps": CONV_STEPS, "paths": paths,
                    "out": os.path.join(work, f"run{i}.out.json")}
            with open(os.path.join(work, f"run{i}.json"), "w") as f:
                json.dump(spec, f)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--convergence-run",
                 os.path.join(work, f"run{i}.json")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = wait_ranks(procs, CONV_TIMEOUT)
        runs = {}
        for i, (name, p, out) in enumerate(zip(names, procs, outs)):
            require(p.returncode == 0, f"convergence {name}: exited with {p.returncode}:\n"
                    f"{(out or '')[-4000:]}")
            with open(os.path.join(work, f"run{i}.out.json")) as f:
                runs[name] = json.load(f)
    plain = runs.pop("int8feed-bf16 plain")
    want = {"decode_att_fwd": (C_LEN - 1) * CONV_STEPS,
            "decode_att_bwd": (C_LEN - 1) * CONV_STEPS, "decode_att_dvp": CONV_STEPS}
    ceiling = study.FINAL_LOSS_CEILING[CONV_STEPS]
    for name, r in [*runs.items(), ("int8feed-bf16 plain", plain)]:
        mid = min(120, CONV_STEPS - 1)
        log(f"convergence {name}: loss {r['losses'][0]:.5f} (step 0), "
            f"{r['losses'][mid]:.5f} (step {mid}), "
            f"{r['losses'][-1]:.5f} (step {CONV_STEPS - 1}); caption loss "
            f"{r['cap_losses'][0]:.5f} -> {r['cap_losses'][-1]:.5f}; final score "
            f"{r['final_score']:.7f}; {r['seconds'] / CONV_STEPS * 1e3:.2f} ms a step "
            f"({r['seconds']:.1f} s for {CONV_STEPS}, 4 runs at once); scan "
            f"constructions {r['fused_scan_traces']}; launches "
            f"{ {k: v for k, v in r['launches'].items() if v} or 'none'} [{card}]")
        require(all(map(math.isfinite, r["losses"] + r["cap_losses"] + r["vqa_losses"])),
                f"convergence {name}: a non-finite loss")
        require(r["fused_scan_traces"] > 0, f"convergence {name}: the scan never ran")
        require(r["losses"][-1] < ceiling[r["variant"]],
                f"convergence {name}: final loss {r['losses'][-1]:.5f} not under the "
                f"ceiling {ceiling[r['variant']]}")
        require(abs(r["final_score"] - plain["final_score"]) <= CONV_SCORE_TOL,
                f"convergence {name}: final score {r['final_score']:.7f} against the "
                f"plain run's {plain['final_score']:.7f}")
        expect = dict.fromkeys(KERNELS, 0)
        if r is not plain:
            expect.update(want)
        require(r["launches"] == expect, f"convergence {name}: launches "
                f"{ {k: v for k, v in r['launches'].items() if v} }, expected "
                f"{ {k: v for k, v in expect.items() if v} }")
    gaps = {"bf16_vs_f32": study.gap(runs["f32"]["losses"], runs["bf16"]["losses"]),
            "int8feed_vs_f32": study.gap(runs["f32"]["losses"],
                                         runs["int8feed-bf16"]["losses"]),
            "int8feed_kernels_vs_plain": study.gap(plain["losses"],
                                                   runs["int8feed-bf16"]["losses"])}
    log(f"convergence: mean relative loss gaps over the last 20 steps {gaps} "
        f"(limit {CONV_GAP:g}); the study's JSON: "
        + json.dumps(study.report(list(runs.values()), CONV_STEPS, "butd")))
    for name, g in gaps.items():
        require(g <= CONV_GAP, f"convergence: gap {name} {g:.3g} over {CONV_GAP:g}")
    return {k: sum(r["launches"][k] for r in runs.values()) for k in KERNELS}


def gate_phase(card: str) -> None:
    """Phase 20: ``python -m vqa_tpu_torch.scripts.run_gate ROOT --device
    cuda`` in a temporary directory on a synthetic RUNBOOK.md §0 root (the
    port's preprocessing of both splits, config 1 trained in f32 and
    validated, the gate at 55.8): it must end in FAIL with exit code 1 and
    leave ``checkpoint/updown_vqa_gate/scalars.jsonl`` there; then the
    port's gate check at ``--threshold 0`` must pass (exit code 0)."""
    from vqa_tpu_torch.data.synthetic import make_gate_root

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory() as work:
        root = os.path.join(work, "root")
        make_gate_root(root, **GATE_ROOT_ARGS)
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "vqa_tpu_torch.scripts.run_gate", root, "--device",
             "cuda"], capture_output=True, text=True, cwd=work, env=env,
            timeout=SCRIPT_TIMEOUT)
        wall = time.monotonic() - t0
        tail = proc.stdout.strip().splitlines()[-4:]
        log(f"gate: run_gate --device cuda: rc {proc.returncode} in {wall:.1f} s; "
            f"{' | '.join(tail)} [{card}]")
        require(proc.returncode == 1 and GATE_FAIL_LINE.search(proc.stdout),
                f"run_gate: rc {proc.returncode}, no FAIL line:\n{proc.stdout[-2000:]}\n"
                f"{proc.stderr[-4000:]}")
        exp = os.path.join("checkpoint", "updown_vqa_gate")
        require(os.path.exists(os.path.join(work, exp, "scalars.jsonl")),
                "run_gate left no scalars.jsonl in its directory")
        proc = subprocess.run(
            [sys.executable, "-m", "vqa_tpu_torch.scripts.gate_check", exp,
             "--threshold", "0"], capture_output=True, text=True, cwd=work, env=env,
            timeout=SCRIPT_TIMEOUT)
        log(f"gate: gate_check --threshold 0: rc {proc.returncode}; "
            f"{proc.stdout.strip().splitlines()[-1:]}")
        require(proc.returncode == 0, f"gate_check --threshold 0 exited with "
                f"{proc.returncode}:\n{proc.stdout}\n{proc.stderr[-2000:]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print torch.profiler tables of one "
                             f"B={TIME_BATCH} forward, one "
                             f"B={DECODE_TIME_BATCH} beam decode and one "
                             f"B={TRAIN_TIME_BATCH} training step")
    parser.add_argument("--parallel-rank", metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--convergence-run", metavar="PATH", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.parallel_rank:
        return parallel_rank(args.parallel_rank)
    if args.convergence_run:
        return convergence_run(args.convergence_run)
    return run(args)


def run(args) -> int:
    """The smoke run's phases (the module docstring)."""
    # -- 1. device ---------------------------------------------------------
    t_start = time.monotonic()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vqa_tpu_torch import main as cli
    from vqa_tpu_torch.ops.kernels import (
        _build, decode_att, feed_gemm, fused_attention, gcn_chain, gru, gru_v2,
        gru_v3, int8_matmul, lazyv_pool, vocab_topk)
    from vqa_tpu_torch.models import encoder as encoder_ops
    from vqa_tpu_torch.ops import linear as linear_ops
    from vqa_tpu_torch.ops import quant as quant_ops
    from vqa_tpu_torch.ops import rnn as rnn_ops
    from vqa_tpu_torch.ops.quant import quantize_weight_per_col
    from vqa_tpu_torch.models.wrapper import set_model
    from vqa_tpu_torch.tools.beam import make_beam_search, tokens_to_captions
    from vqa_tpu_torch.training import train as train_loop
    from vqa_tpu_torch.training.optim import make_optimizer
    from vqa_tpu_torch.training.select import get_select_loss, make_train_select_step
    from vqa_tpu_torch.training.state import (
        TrainState, backward_step, make_train_step)
    from vqa_tpu_torch.data import native
    from vqa_tpu_torch.data.dataset import set_dataset
    from vqa_tpu_torch.data.loader import Loader
    from vqa_tpu_torch.data.synthetic import make_synthetic_root, write_glove
    from vqa_tpu_torch.data.tokenizer import Vocab

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    full_precision_products()

    # -- 2. build ----------------------------------------------------------
    phase("2 build")
    t0 = time.monotonic()
    lib_path = _build.build()
    _build.library()
    log(f"build: {lib_path.name} in {time.monotonic() - t0:.1f} s")
    # the host library of the feed, before any feed runs: a failed build
    # raises here instead of leaving the feed on its numpy routes
    t0 = time.monotonic()
    host_lib = native.build()
    host_build_s = time.monotonic() - t0
    require(native.available(), f"the host library {host_lib} does not load")
    log(f"build: {host_lib.name} (g++, {' '.join(native.CXX_FLAGS)}) in "
        f"{host_build_s:.2f} s")

    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    max_err = {}
    gates = {}

    def gate(name: str, holds: bool, shape: str) -> None:
        """A main-path shape that the kernel's ``supports`` must take: a gate
        that refused it would quietly move the path off its kernel."""
        require(holds, f"{name}: supports() refuses the main-path shape {shape}")
        gates[name] = gates.get(name, 0) + 1
    kernel_modules = (gru_v2, feed_gemm, lazyv_pool, vocab_topk, decode_att,
                      int8_matmul, gcn_chain)

    def int8_feed(rows: int, k: int):
        x_q = torch.randint(-127, 128, (rows, k), device=dev, generator=gen,
                            dtype=torch.int8)
        # per-box absmax/127 of unit-normal features lands in [2.5, 4.5]/127
        scale = ((torch.rand(rows, device=dev, generator=gen) * 2 + 2.5) / 127).to(bf16)
        return x_q, scale

    def gru_inputs(batch: int, hidden: int = HIDDEN):
        xi = torch.randn(batch, Q_LEN, 3 * hidden, device=dev, generator=gen).to(bf16)
        bound = hidden ** -0.5
        wh = ((torch.rand(hidden, 3 * hidden, device=dev, generator=gen) * 2 - 1) * bound).to(bf16)
        bh = ((torch.rand(3 * hidden, device=dev, generator=gen) * 2 - 1) * bound).to(bf16)
        return xi, wh, bh

    def gemm_inputs(rows: int, k: int = V_DIM, n: int = HIDDEN):
        x_q, scale = int8_feed(rows, k)
        w = ((torch.rand(k, n, device=dev, generator=gen) * 2 - 1) * k ** -0.5).to(bf16)
        return x_q, scale, w

    def gated_inputs(batch: int, objs: int, k: int, n: int):
        # the serving attention's bias and folded gate qp * w_l
        x_q, scale, w = gemm_inputs(batch * objs, k, n)
        bias = ((torch.rand(n, device=dev, generator=gen) * 2 - 1) * k ** -0.5).to(bf16)
        gate_ = (torch.randn(batch, n, device=dev, generator=gen) * n ** -0.5).to(bf16)
        return x_q, scale, w, bias, gate_

    def gated_magnitude(x_q, scale, w, bias, gate_, objs: int):
        # a logit's scale: the sum over its row of |relu(vp + bias) * gate|
        vp = torch.relu(feed_gemm.dequant_matmul_reference(x_q, scale, w) + bias)
        mag = torch.einsum("bnd,bd->bn", vp.view(-1, objs, vp.shape[-1]).float(),
                           gate_.float().abs())
        return mag.reshape(-1).clamp_min(1e-30)

    def pool_inputs(batch: int):
        x_q, scale = int8_feed(batch * OBJS, V_DIM)
        att = torch.softmax(torch.randn(batch, OBJS, device=dev, generator=gen), dim=1)
        return (att * scale.view(batch, OBJS).float()).to(bf16), x_q.view(batch, OBJS, V_DIM)

    def attended_inputs(batch: int):
        """The box weights (a bf16 softmax), the feed's bf16 scales and its
        payload [batch, OBJS, V_DIM]."""
        x_q, scale = int8_feed(batch * OBJS, V_DIM)
        att = torch.softmax(torch.randn(batch, OBJS, device=dev, generator=gen), dim=1)
        return att.to(bf16), scale.view(batch, OBJS).to(bf16), x_q.view(batch, OBJS, V_DIM)

    def vocab_inputs(rows: int, ties: bool, vocab: int = NTOKEN):
        # decoder states lie in (-1, 1); the head keeps torch's Linear init
        h = (torch.rand(rows, HIDDEN, device=dev, generator=gen) * 2 - 1).to(bf16)
        bound = HIDDEN ** -0.5
        w = ((torch.rand(vocab, HIDDEN, device=dev, generator=gen) * 2 - 1) * bound).to(bf16)
        b = ((torch.rand(vocab, device=dev, generator=gen) * 2 - 1) * bound).to(bf16)
        if ties:
            # two equal columns far above the rest, in different 128-column
            # tiles and (at V=20000) different vocabulary splits of the
            # kernel: the exact tie must go to the lower index, on every row
            w[vocab - 7] = w[11]
            b[vocab - 7] = b[11] = 8.0
        return h, w, b

    def compare_vocab(rows: int, ties: bool, k: int, vocab: int = NTOKEN) -> None:
        h, w, b = vocab_inputs(rows, ties, vocab)
        vals, idx, lse = vocab_topk.vocab_topk_lse(h, w, b, k)
        p_vals, p_idx, p_lse = vocab_topk.vocab_topk_lse_reference(h, w, b, k)
        logits = torch.matmul(h.float(), w.float().t()) + b.float()
        shape = f"R={rows} H={HIDDEN} V={vocab} k={k}{' ties' if ties else ''}"
        gate("vocab_topk_lse", vocab_topk.supports(rows, HIDDEN, vocab, k, h.dtype), shape)
        compare("vocab_topk_lse", vals, p_vals, VOCAB_ATOL, VOCAB_RTOL, shape + " vals")
        compare("vocab_topk_lse", lse, p_lse, VOCAB_ATOL, VOCAB_RTOL, shape + " lse")
        tol = VOCAB_ATOL + VOCAB_RTOL * logits.abs().amax(dim=1)
        top = vocab_topk.topk_first(logits, k + 1)[0]
        tie_free = ((top[:, :-1] - top[:, 1:]).amin(dim=1) > 2 * tol)
        mismatch = (idx != p_idx).any(dim=1)
        at_idx = logits.gather(1, idx.long())
        off = ((at_idx - vals).abs() > tol[:, None]).any(dim=1)
        log(f"kernel vocab_topk_lse {shape} idx: {mismatch.sum().item()} rows "
            f"differ from the plain version, {(mismatch & tie_free).sum().item()} "
            f"of them tie-free (of {tie_free.sum().item()}), {off.sum().item()} "
            f"indices off their values")
        require(not (mismatch & tie_free).any().item(),
                f"vocab_topk_lse {shape}: indices differ on tie-free rows")
        require(not off.any().item(), f"vocab_topk_lse {shape}: an index is "
                "not where its value is")
        if ties:
            want_idx = torch.tensor([11, vocab - 7][:k], device=dev, dtype=idx.dtype)
            require(bool((idx[:, :min(k, 2)] == want_idx).all()),
                    f"vocab_topk_lse {shape}: an exact tie did not go to the "
                    "lower index")

    def compare(name: str, got: torch.Tensor, want: torch.Tensor,
                atol: float, rtol: float, shape: str) -> None:
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        bad = (diff > atol + rtol * want.float().abs()).sum().item()
        log(f"kernel {name} {shape}: max abs err {err:.3g} (max |plain| "
            f"{want.float().abs().max().item():.3g}), tolerance {atol:g} + "
            f"{rtol:g}*|plain|, {bad} elements outside")
        require(torch.isfinite(got).all().item(), f"{name} {shape}: non-finite output")
        require(bad == 0, f"{name} {shape}: kernel disagrees with its plain version")
        max_err[name] = max(max_err.get(name, 0.0), err)

    def att_inputs(batch: int, regime: str, objs: int = OBJS, hidden: int = HIDDEN,
                   v_dim: int = V_DIM):
        """Decode-attention operands (vp2, pool2, w, qp, k) of one regime:
        "f32" (f32 payload, factored weights), "f32-int8", "bf16" (bf16
        payload, no weights) or "bf16-int8" (the main path: the int8
        payload with the weights att * img_scale). vp and qp are ReLU
        outputs; k is a weight-normed row of hidden weights. The shape is the
        main path's unless given."""
        dt = torch.float32 if regime.startswith("f32") else bf16
        vp = torch.rand(batch, objs * hidden, device=dev, generator=gen).to(dt)
        qp = torch.rand(batch, hidden, device=dev, generator=gen).to(dt)
        k = ((torch.rand(hidden, device=dev, generator=gen) * 2 - 1) * hidden ** -0.5).to(dt)
        if regime.endswith("int8"):
            pool = torch.randint(-127, 128, (batch, objs * v_dim), device=dev,
                                 generator=gen, dtype=torch.int8)
            att = torch.softmax(torch.randn(batch, objs, device=dev, generator=gen), dim=1)
            scale = (torch.rand(batch, objs, device=dev, generator=gen) * 2 + 2.5) / 127
            return vp, pool, (att * scale).to(dt), qp, k
        pool = torch.randn(batch, objs * v_dim, device=dev, generator=gen).to(dt)
        w = torch.rand(batch, objs, device=dev, generator=gen).to(dt) if regime == "f32" else None
        return vp, pool, w, qp, k

    def compare_att(batch: int, regime: str, thresh, objs: int = OBJS,
                    hidden: int = HIDDEN, v_dim: int = V_DIM) -> None:
        """The three decode-attention kernels against their plain versions on
        the same inputs, and the forward's emitted mask against keep_mask."""
        vp, pool, w, qp, k = att_inputs(batch, regime, objs, hidden, v_dim)
        rtol, atol_rel = ((ATT_F32_RTOL, ATT_F32_ATOL_REL) if regime.startswith("f32")
                          else (ATT_BF16_RTOL, ATT_BF16_ATOL_REL))
        scale = ATT_SCALE if thresh else 1.0
        shape = (f"B={batch} {regime} "
                 + ("" if (objs, hidden, v_dim) == (OBJS, HIDDEN, V_DIM)
                    else f"objs={objs} H={hidden} D={v_dim} ")
                 + (f"thresh={thresh}" if thresh else "no dropout"))
        gate("decode_att", decode_att.supports(objs, hidden, v_dim, qp.dtype, pool.dtype),
             shape)

        def check(name, got, want, what):
            compare(name, got, want, atol_rel * want.float().abs().max().item(), rtol,
                    f"{shape} {what}")

        out = decode_att.decode_att_fwd(vp, pool, w, qp, k, ATT_SEED, ATT_STEP, objs=objs,
                                        att_scale=scale, thresh=thresh,
                                        emit_mask=thresh is not None)
        want = decode_att.decode_att_fwd_reference(vp, pool, w, qp, k, ATT_SEED, ATT_STEP,
                                                   objs=objs, att_scale=scale, thresh=thresh)
        check("decode_att_fwd", out[0], want[0], "att")
        check("decode_att_fwd", out[1], want[1], "att_v")
        if thresh:
            mask = decode_att.keep_mask(ATT_SEED, ATT_STEP, batch, objs, hidden, thresh,
                                        device=dev)
            same = torch.equal(out[2], mask)
            log(f"kernel decode_att_fwd {shape}: emitted mask equal to keep_mask bit "
                f"for bit: {same}; keep rate {out[2].float().mean().item():.5f} "
                f"(thresh/256 = {thresh / 256:.5f})")
            require(same, f"decode_att_fwd {shape}: the emitted mask is not keep_mask's")
        g_attv = torch.randn(batch, v_dim, device=dev, generator=gen).to(qp.dtype)
        args = (vp, pool, w, want[0], g_attv, ATT_SEED, ATT_STEP)
        got = decode_att.decode_att_bwd(*args, objs=objs, thresh=thresh)
        ref = decode_att.decode_att_bwd_reference(*args, objs=objs, thresh=thresh)
        for what, a, b in zip(("d_qp_pre", "m", "dl"), got, ref):
            check("decode_att_bwd", a, b, what)
        compare_dvp(batch, C_LEN - 1, objs, hidden, qp.dtype, thresh, k,
                    f"B={batch} {regime}", v_dim)

    def compare_dvp(batch: int, steps: int, objs: int, hidden: int, dtype, thresh,
                    k=None, label: str = "", v_dim: int = V_DIM) -> None:
        """decode_att_dvp against its plain version on the same inputs: the
        softmax cotangents of ``steps`` decode steps, their qp rows, k."""
        rtol, atol_rel = ((ATT_F32_RTOL, ATT_F32_ATOL_REL) if dtype == torch.float32
                          else (ATT_BF16_RTOL, ATT_BF16_ATOL_REL))
        if k is None:
            k = ((torch.rand(hidden, device=dev, generator=gen) * 2 - 1)
                 * hidden ** -0.5).to(dtype)
        dls = (torch.randn(steps, batch, objs, device=dev, generator=gen) * 0.01).to(dtype)
        qps = torch.rand(steps, batch, hidden, device=dev, generator=gen).to(dtype)
        kw = dict(objs=objs, att_scale=ATT_SCALE if thresh else 1.0, thresh=thresh,
                  out_dtype=dtype)
        gate("decode_att", decode_att.supports(objs, hidden, v_dim, dtype, dtype),
             f"objs={objs} H={hidden} {dtype}")
        want = decode_att.decode_att_dvp_reference(dls, qps, k, ATT_SEED, **kw)
        compare("decode_att_dvp", decode_att.decode_att_dvp(dls, qps, k, ATT_SEED, **kw), want,
                atol_rel * want.float().abs().max().item(), rtol,
                f"{label or f'B={batch} {dtype}'} objs={objs} H={hidden} "
                + (f"thresh={thresh}" if thresh else "no dropout") + f" T={steps} d_vp")

    def int8_inputs(rows: int, n: int, xs_dtype, with_bias: bool, k: int = V_DIM):
        """The int8 GEMM's operands at a path shape: int8 rows with per-row
        scales (the feed's bf16 ones, or quantize_rows' f32 ones), a
        weight-normed-scale kernel quantized per column, a bf16 bias."""
        x_q, scale = int8_feed(rows, k)
        kernel = (torch.rand(k, n, device=dev, generator=gen) * 2 - 1) * k ** -0.5
        w_q, w_scale = quantize_weight_per_col(kernel)
        b = ((torch.rand(n, device=dev, generator=gen) * 2 - 1) * 0.1).to(bf16) \
            if with_bias else None
        return x_q, scale.to(xs_dtype), w_q, w_scale, b

    def compare_int8(batch, rows: int, n: int, xs_dtype, with_bias: bool,
                     relu: bool, out_dtype=bf16, k: int = V_DIM) -> None:
        """The int8 GEMM against its plain version, bit for bit: the 3-D
        entry on [batch, 36, K] when ``batch``, else the 2-D one on rows."""
        x_q, xs, w_q, w_scale, b = int8_inputs(rows, n, xs_dtype, with_bias, k)
        b = b.to(out_dtype) if b is not None else None
        kw = dict(bias=b, relu=relu, out_dtype=out_dtype)
        gate("int8_matmul", int8_matmul.supports_3d(batch, OBJS, k, n, xs_dtype, out_dtype)
             if batch else int8_matmul.supports(rows, k, n, xs_dtype, out_dtype),
             f"B={batch} M={rows} K={k} N={n}")
        if batch:
            name = "int8_matmul_dequant_3d"
            args = (x_q.view(batch, OBJS, k), xs.view(batch, OBJS), w_q, w_scale)
            got = int8_matmul.int8_matmul_dequant_3d(*args, **kw)
            want = int8_matmul.int8_matmul_dequant_3d_reference(*args, **kw)
            shape = f"B={batch}x{OBJS}"
        else:
            name = "int8_matmul_dequant"
            got = int8_matmul.int8_matmul_dequant(x_q, xs, w_q, w_scale, **kw)
            want = int8_matmul.int8_matmul_dequant_reference(x_q, xs, w_q, w_scale, **kw)
            shape = f"M={rows}"
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        same = torch.equal(got, want)
        log(f"kernel {name} {shape} K={k} N={n} scales {xs_dtype} out {out_dtype}"
            f"{' bias' if with_bias else ''}{' relu' if relu else ''}: equal to the "
            f"plain version bit for bit: {same} (max abs err {err:.3g})")
        require(same, f"{name} {shape} N={n}: kernel differs from its plain version")
        max_err[name] = max(max_err.get(name, 0.0), err)

    def gcn_inputs(batch: int, dtype, d: int = V_DIM):
        """gcn_chain_fused's operands: projections of unit scale, a ReLU'd
        correlation, spatial labels 0..11, a label-bias table."""
        out_self = torch.randn(batch, OBJS, d, device=dev, generator=gen).to(dtype)
        proj = torch.randn(batch, OBJS, d, device=dev, generator=gen).to(dtype)
        alpha = torch.relu(torch.randn(batch, OBJS, OBJS, device=dev, generator=gen)).to(dtype)
        graph = torch.randint(0, 12, (batch, OBJS, OBJS), device=dev, generator=gen,
                              dtype=torch.int32)
        bias = ((torch.rand(12, d, device=dev, generator=gen) * 2 - 1)
                * d ** -0.5).to(dtype)
        return out_self, proj, alpha, graph, bias

    # -- 3. kernels against their plain versions ---------------------------
    phase("3 kernels")
    with torch.inference_mode():
        # the MTL training batch of 4096 and a ragged batch, in every regime
        # the decode scan feeds the kernels
        for batch in (TRAIN_BATCH, 1003, TRAIN_TIME_BATCH):
            for regime in ("f32", "f32-int8", "bf16", "bf16-int8"):
                for thresh in (ATT_THRESH, None):
                    compare_att(batch, regime, thresh)
        # and at the convergence study's narrow shape (phase 19)
        for regime in ("f32", "f32-int8", "bf16", "bf16-int8"):
            for thresh in (ATT_THRESH, None):
                compare_att(CONV_BATCH, regime, thresh, *CONV_ATT_SHAPE)
        # the deferred reduction's edges: one step (and none), the most boxes
        # (a thread's last box set full), and an H whose 65 groups do not
        # fill the threads of a block item
        for steps, objs, hidden in ((1, OBJS, HIDDEN), (0, OBJS, HIDDEN),
                                    (C_LEN - 1, 64, HIDDEN), (C_LEN - 1, OBJS, 1040)):
            for dtype in (bf16, f32):
                for thresh in (ATT_THRESH, None):
                    compare_dvp(TRAIN_BATCH, steps, objs, hidden, dtype, thresh)
        # gru_v2 at the paths' B=512, a ragged B, the timed batches, a B
        # that reaches each cluster size the plan can choose, and H=2048,
        # whose state lives in device memory
        caps = gru_v2._device_caps(dev, HIDDEN, False)
        log(f"kernel gru_v2 H={HIDDEN}: state resident {caps[0]}, {caps[1]} SMs, "
            f"clusters the card holds at once by size {caps[2]}")
        # the most 64-row tiles whose clusters of c all fit at once: the plan
        # takes c there (0: c does not schedule)
        reach = {c: 64 * min(caps[2][c], caps[1] // c) for c in (16, 8, 4, 2)}
        reach[1] = REGAT_TIME_BATCH
        clusters_run = set()
        for batch, hidden in sorted({(SERVE_BATCH, HIDDEN), (1000, HIDDEN),
                                     (TRAIN_TIME_BATCH, HIDDEN),
                                     (REGAT_TIME_BATCH, HIDDEN), (TIME_BATCH, HIDDEN),
                                     (BENCH_BATCH32, HIDDEN), (SERVE_BATCH, 2048),
                                     *((b, HIDDEN) for b in reach.values() if b)}):
            xi, wh, bh = gru_inputs(batch, hidden)
            gate("gru_v2", gru_v2.supports(Q_LEN, hidden, xi.dtype), f"B={batch} H={hidden}")
            cluster, h16 = gru_v2.launch_plan(dev, batch, hidden, False)
            clusters_run.add((cluster, hidden))
            compare("gru_v2", gru_v2.gru_last_state_v2(xi, wh, bh),
                    gru_v2.gru_last_state_v2_reference(xi, wh, bh),
                    GRU_ATOL, 0.0, f"B={batch} T={Q_LEN} H={hidden} cluster={cluster} "
                    f"state {'in shared memory' if h16 is None else 'in device memory'}")
            del xi, wh, bh, h16
        want_clusters = {c for c, b in reach.items() if b}
        require(want_clusters <= {c for c, h in clusters_run if h == HIDDEN},
                f"gru_v2 ran clusters {sorted(clusters_run)}, not every size of "
                f"{sorted(want_clusters)}")
        # the path's shape and a ragged M, then the ragged edges of the
        # kernel's tiling (128 x 256 tiles, 64-deep K stages): an N not a
        # multiple of 256, an M below one tile, K of one stage and of a stage
        # and a quarter
        for rows, k, n in ((1024 * OBJS, V_DIM, HIDDEN), (BENCH_BATCH32 * OBJS, V_DIM, HIDDEN),
                           (1000 * OBJS + 5, V_DIM, HIDDEN),
                           (3001, V_DIM, 1000), (100, V_DIM, HIDDEN), (3001, 64, HIDDEN),
                           (3001, 80, 1000)):
            x_q, scale, w = gemm_inputs(rows, k, n)
            gate("dequant_matmul", feed_gemm.supports(rows, k, n, w.dtype), f"M={rows} K={k} N={n}")
            compare("dequant_matmul", feed_gemm.dequant_matmul(x_q, scale, w),
                    feed_gemm.dequant_matmul_reference(x_q, scale, w),
                    BF16_ATOL, BF16_RTOL, f"M={rows} K={k} N={n}")
            del x_q, scale, w
        # the gated epilogue at the serving path's shapes (B=1024, the
        # bench's B=32768, a B of whole images off the 128-row tiles) and
        # at 10 boxes, N=1000 and K=80: f32 logits against the plain
        # version's bf16 ones, each over its row's sum of |terms| (bf16
        # rounding of vp and of the logit), and a second call bit-equal
        for batch, objs, k, n in ((1024, OBJS, V_DIM, HIDDEN), (BENCH_BATCH32, OBJS, V_DIM, HIDDEN),
                                  (1003, OBJS, V_DIM, HIDDEN), (301, 10, 80, 1000)):
            ops = gated_inputs(batch, objs, k, n)
            gate("dequant_matmul_gated_logits",
                 feed_gemm.supports_gated_logits(batch * objs, k, n, objs, bf16, bf16),
                 f"B={batch} objs={objs} K={k} N={n}")
            got = feed_gemm.dequant_matmul_gated_logits(*ops, objs)
            require(torch.equal(got, feed_gemm.dequant_matmul_gated_logits(*ops, objs)),
                    f"dequant_matmul_gated_logits B={batch}: two calls differ")
            mag = gated_magnitude(*ops, objs)
            compare("dequant_matmul_gated_logits", got / mag,
                    feed_gemm.dequant_matmul_gated_logits_reference(*ops, objs).float() / mag,
                    2.0 ** -6, 0.0, f"B={batch} objs={objs} K={k} N={n} (over the row's "
                    f"sum of |terms|)")
            del ops, got, mag
        for batch in (1024, 1003, BENCH_BATCH32):
            w, x_q = pool_inputs(batch)
            gate("pool_int8", lazyv_pool.supports(*x_q.shape, w.dtype), f"B={batch}")
            compare("pool_int8", lazyv_pool.pool_int8(w, x_q),
                    lazyv_pool.pool_int8_reference(w, x_q),
                    BF16_ATOL, BF16_RTOL, f"B={batch} N={OBJS} D={V_DIM}")
            del w, x_q
        # the attended features at ReGAT's B=8192, a small and a ragged B:
        # bit for bit (both products exact in f32, each rounded once)
        for batch in (REGAT_TIME_BATCH, 3, REGAT_TIME_BATCH - 1):
            att, scale, x_q = attended_inputs(batch)
            gate("attended_int8", lazyv_pool.supports_attended(
                *x_q.shape, att.dtype, scale.dtype), f"B={batch}")
            compare("attended_int8", lazyv_pool.attended_int8(att, scale, x_q),
                    lazyv_pool.attended_int8_reference(att, scale, x_q),
                    0.0, 0.0, f"B={batch} N={OBJS} D={V_DIM}")
            del att, scale, x_q
        # the beam step's rows R = B x k at B=4096 (at k = 1, 3 and 8, the
        # ends of the kernel's k), a ragged R, then the ragged edges of its
        # tiling (128-row bands, 128-column tiles, vocabulary splits): an R
        # below one band, a V not a multiple of 128 (ties across its tiles)
        decode_rows = DECODE_TIME_BATCH * BEAM_K
        for rows, ties, k, vocab in ((decode_rows, False, BEAM_K, NTOKEN),
                                     (decode_rows, False, 1, NTOKEN),
                                     (decode_rows, False, 8, NTOKEN),
                                     (1000 * BEAM_K + 1, True, BEAM_K, NTOKEN),
                                     (8, True, BEAM_K, NTOKEN),
                                     (decode_rows, True, BEAM_K, 1000),
                                     (1000 * BEAM_K + 1, True, 8, 1000)):
            compare_vocab(rows, ties, k, vocab)
        # the ReGAT path: the v-projection (bf16 feed scales, bias, ReLU)
        # and a GCN projection (quantize_rows' f32 scales) on the 3-D entry,
        # the GCN projections' rows and a ragged M on the 2-D one
        f32 = torch.float32
        for batch in (REGAT_TIME_BATCH, 1003):
            compare_int8(batch, batch * OBJS, HIDDEN, bf16, True, True)
            compare_int8(batch, batch * OBJS, V_DIM, f32, False, False)
        compare_int8(None, REGAT_TIME_BATCH * OBJS, V_DIM, f32, False, False)
        compare_int8(None, 3001, HIDDEN, f32, True, True, out_dtype=f32)
        # the ragged edges of the kernel's tiling (two 128 x 256 tiles a
        # cluster, 128-byte K stages): an N not a multiple of 256, a K below
        # one stage and not a multiple of it, an M below one tile with an N
        # below 128
        compare_int8(None, 3001, 1000, bf16, True, True)
        compare_int8(None, 3001, HIDDEN, f32, False, False, k=96)
        compare_int8(None, 100, 40, bf16, True, True, out_dtype=f32, k=96)
        # the chain at the requests' B=512, a ragged B and the timed B in
        # both types, and in bf16 at a D that is not a whole number of the
        # kernel's 64-column tiles
        for batch, d, dtypes in ((SERVE_BATCH, V_DIM, (bf16, f32)), (1003, V_DIM, (bf16, f32)),
                                 (REGAT_TIME_BATCH, V_DIM, (bf16, f32)), (1003, 1000, (bf16,))):
            for dtype in dtypes:
                rtol, atol_rel = ((GCN_BF16_RTOL, GCN_BF16_ATOL_REL) if dtype == bf16
                                  else (GCN_F32_RTOL, GCN_F32_ATOL_REL))
                chain = gcn_inputs(batch, dtype, d)
                gate("gcn_chain_fused", gcn_chain.supports(batch, OBJS, d, 12, dtype),
                     f"B={batch} D={d} {dtype}")
                want = gcn_chain.gcn_chain_reference(*chain)
                compare("gcn_chain_fused", gcn_chain.gcn_chain_fused(*chain), want,
                        atol_rel * want.float().abs().max().item(), rtol,
                        f"B={batch} N={OBJS} D={d} {dtype}")
                del chain, want
    log(f"gates: each kernel's supports() takes every main-path shape phase 3 "
        f"checked (shapes by kernel: {gates})")

    # -- 4. serve a few requests through the port's main path --------------
    phase("4 serve")
    dims = SERVE_DIMS
    model = set_model(**dims, use_pallas=True,
                      generator=torch.Generator().manual_seed(0))
    model = model.to(device=dev, dtype=bf16).eval()
    with tempfile.TemporaryDirectory() as root:
        make_synthetic_root(root, split="val2014", num_images=64,
                            num_questions=SERVE_BATCH * SERVE_REQUESTS,
                            num_objs=OBJS, v_dim=V_DIM, vocab_size=NTOKEN,
                            num_answers=ANS, q_len=Q_LEN, seed=0)
        dataset = set_dataset(os.path.join(root, "annot"),
                              os.path.join(root, "features"), ANS,
                              is_val=True, dataset_type="vqa",
                              feature_mode="int8")
        host_batches = list(Loader(dataset, SERVE_BATCH, drop_last=True))
        # the same requests with their spatial graphs, for the ReGAT phase
        graph_set = set_dataset(os.path.join(root, "annot"),
                                os.path.join(root, "features"), ANS,
                                graph_path=os.path.join(root, "graphs"),
                                is_val=True, dataset_type="vqa",
                                feature_mode="int8")
        host_graphs = [b["graph"] for b in Loader(graph_set, SERVE_BATCH, drop_last=True)]
        vocab = Vocab.load(os.path.join(root, "vocab_list.txt"))
    require(len(host_batches) == SERVE_REQUESTS,
            f"loader gave {len(host_batches)} batches")
    requests = [{"q": torch.from_numpy(b["q"]).to(dev, torch.long),
                 "img_q": torch.from_numpy(b["img_q"]).to(dev),
                 "img_scale": torch.from_numpy(b["img_scale"]).to(dev, bf16),
                 "a": torch.from_numpy(b["a"]).to(dev)} for b in host_batches]

    with torch.inference_mode():
        _build.reset_launches()
        rnn_ops.reset_routes()
        served = [model.forward_vqa(r) for r in requests]
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        log(f"serve: {SERVE_REQUESTS} requests of B={SERVE_BATCH} through "
            f"VQAModel.forward_vqa; kernel launches {launches}; question "
            f"GRU routes {rnn_ops.ROUTES}")
        for name in VQA_KERNELS:
            require(launches[name] > 0, f"the VQA path never launched {name}")
        # B x T = 5120 tokens against 20,001 table rows: the per-token gates
        require(rnn_ops.ROUTES == {"table": 0, "gates": SERVE_REQUESTS},
                f"question GRU routes {rnn_ops.ROUTES} at B={SERVE_BATCH}")
        for score, label, target in served:
            require(score.shape == (SERVE_BATCH, ANS) and label.shape == (SERVE_BATCH,),
                    f"forward_vqa shapes {tuple(score.shape)}, {tuple(label.shape)}")
            require(torch.isfinite(score).all().item(), "non-finite scores")

        got = [model(r)[0] for r in requests]
        with ExitStack() as stack:
            plain_kernels(stack, *kernel_modules)
            want = [model(r)[0] for r in requests]
        got, want = torch.cat(got).float(), torch.cat(want).float()
        require(got.shape == (SERVE_BATCH * SERVE_REQUESTS, ANS), f"logits {tuple(got.shape)}")
        require(torch.isfinite(got).all().item(), "non-finite logits")
        rel = ((got - want).abs().max() / want.abs().max()).item()
        agree = (got.argmax(1) == want.argmax(1)).float().mean().item()
        log(f"serve: logits vs the same model on plain versions: max abs err / "
            f"max |logit| = {rel:.3g} (tolerance {LOGIT_REL_TOL:g}), max |logit| "
            f"{want.abs().max().item():.3g}, argmax agreement {agree:.4f}, "
            f"nonzero logits {(want > 0).float().mean().item():.3f}")
        require(rel <= LOGIT_REL_TOL, "logits disagree with the plain versions")

    # -- 5. decode the same requests into captions -------------------------
    phase("5 decode")
    dec_dims = dict(encoder_type="base", predictor_type="none",
                    decoder_type="butd", ntoken=NTOKEN, v_dim=V_DIM,
                    embed_dim=EMBED, hidden_dim=HIDDEN,
                    decoder_hidden_dim=HIDDEN, c_len=C_LEN, dropout=0.2,
                    att_type="new")
    dec_model = set_model(**dec_dims, use_pallas=True,
                          generator=torch.Generator().manual_seed(1))
    dec_model = dec_model.to(device=dev, dtype=bf16).eval()
    beam = make_beam_search(dec_model, BEAM_K, C_LEN, vocab.start, vocab.end,
                            fused_vocab=True)
    with torch.inference_mode():
        _build.reset_launches()
        decoded = [beam(r) for r in requests]
        torch.cuda.synchronize()
        dec_launches = dict(_build.LAUNCHES)
        log(f"decode: {SERVE_REQUESTS} requests of B={SERVE_BATCH} through "
            f"make_beam_search(k={BEAM_K}, c_len={C_LEN}, fused_vocab=True); "
            f"kernel launches {dec_launches}")
        for name in DECODE_KERNELS:
            require(dec_launches[name] > 0, f"the decode path never launched {name}")
        for tokens, scores in decoded:
            require(tokens.shape == (SERVE_BATCH, BEAM_K, C_LEN)
                    and scores.shape == (SERVE_BATCH, BEAM_K),
                    f"beam shapes {tuple(tokens.shape)}, {tuple(scores.shape)}")
            require(bool(((tokens >= 0) & (tokens < NTOKEN)).all()), "token out of range")
            require(bool(torch.isfinite(scores).all()), "non-finite beam scores")
            require(bool((scores[:, :-1] >= scores[:, 1:]).all()),
                    "beams are not ranked best first")
        captions = tokens_to_captions(decoded[0][0][:, 0].cpu().numpy(), vocab, vocab.end)
        require(len(captions) == SERVE_BATCH, "one caption per image")
        log(f"decode: first captions {captions[:2]!r}")
        with mock.patch.object(vocab_topk, "vocab_topk_lse",
                               vocab_topk.vocab_topk_lse_reference):
            plain_vocab = [beam(r) for r in requests]
        agree_vocab = compare_beams("the plain vocab head (same encoder output)",
                                    decoded, plain_vocab, vocab.start)
        require(agree_vocab >= BEAM_AGREE_VOCAB,
                f"best beams agree {agree_vocab:.4f} < {BEAM_AGREE_VOCAB}")
        with ExitStack() as stack:
            plain_kernels(stack, *kernel_modules)
            plain_all = [beam(r) for r in requests]
        agree_all = compare_beams("every kernel on its plain version", decoded,
                                  plain_all, vocab.start)
        require(agree_all >= BEAM_AGREE_ALL,
                f"best beams agree {agree_all:.4f} < {BEAM_AGREE_ALL}")

    # -- 6. timing ----------------------------------------------------------
    phase("6 timing")
    # times, bounds, and the one PyTorch call timed beside a kernel
    # times, bounds, and the one PyTorch call timed beside a kernel; extra
    # keys of a kernel's entry (its time at the batch the paths launch it at)
    times, bounds, library, extra = {}, {}, {}, {}
    with torch.inference_mode():
        # gru_v2 at the requests' B=512, the decode's, the ReGAT forward's and
        # the timed B=16384, each with its plan's cluster size, beside v1 on
        # the same xi
        by_batch = {}
        for batch in (SERVE_BATCH, DECODE_TIME_BATCH, REGAT_TIME_BATCH, TIME_BATCH):
            xi, wh, bh = gru_inputs(batch)
            cluster = gru_v2.launch_plan(dev, batch, HIDDEN, False)[0]
            pair = time_pair(lambda: gru_v2.gru_last_state_v2(xi, wh, bh),
                             lambda: gru_v2.gru_last_state_v2_reference(xi, wh, bh), 10)
            v1_ms = time_ms(lambda: gru.gru_last_state(xi, wh, bh), 10)
            b = bound(nbytes(xi, wh, bh, gru_v2.gru_last_state_v2(xi, wh, bh)),
                      gru_ops(batch, Q_LEN, HIDDEN), "bf16")
            by_batch[batch] = (pair, b, cluster)
            log(f"time gru_v2 B={batch} T={Q_LEN} H={HIDDEN} cluster={cluster}: kernel "
                f"{pair[0]:.4f} ms, plain {pair[1]:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), "
                f"share of the bound {b[0] / pair[0]:.1%}, kernel / gru_last_state v1 on "
                f"the same xi {pair[0] / v1_ms:.3f} (v1 {v1_ms:.4f} ms) [{card}]")
            del xi, wh, bh
        times["gru_v2"], bounds["gru_v2"] = by_batch[TIME_BATCH][:2]
        extra["gru_v2"] = {
            "ms_b512": by_batch[SERVE_BATCH][0][0],
            "bound_ms_b512": by_batch[SERVE_BATCH][1][0],
            "cluster_by_batch": {b: v[2] for b, v in by_batch.items()},
            "ms_by_batch": {b: v[0][0] for b, v in by_batch.items()}}
        x_q, scale, w = gemm_inputs(TIME_BATCH * OBJS)
        times["dequant_matmul"] = time_pair(
            lambda: feed_gemm.dequant_matmul(x_q, scale, w),
            lambda: feed_gemm.dequant_matmul_reference(x_q, scale, w), 5)
        bounds["dequant_matmul"] = bound(
            nbytes(x_q, scale, w, feed_gemm.dequant_matmul(x_q, scale, w)),
            2.0 * TIME_BATCH * OBJS * V_DIM * HIDDEN, "bf16")
        # the yardstick: cuBLAS's bf16 product of the same shape on the
        # activation already dequantized (the product alone)
        x_deq = x_q.to(bf16) * scale[:, None]
        library["dequant_matmul"] = time_ms(lambda: torch.matmul(x_deq, w), 5)
        del x_q, scale, w, x_deq
        # the gated epilogue: the same products, its plain version the
        # unfused projection, bias, ReLU and logits
        ops = gated_inputs(TIME_BATCH, OBJS, V_DIM, HIDDEN)
        times["dequant_matmul_gated_logits"] = time_pair(
            lambda: feed_gemm.dequant_matmul_gated_logits(*ops, OBJS),
            lambda: feed_gemm.dequant_matmul_gated_logits_reference(*ops, OBJS), 5)
        bounds["dequant_matmul_gated_logits"] = bound(
            nbytes(*ops, feed_gemm.dequant_matmul_gated_logits(*ops, OBJS)),
            2.0 * TIME_BATCH * OBJS * V_DIM * HIDDEN, "bf16")
        library["dequant_matmul_gated_logits"] = library["dequant_matmul"]
        del ops
        w, x_q = pool_inputs(TIME_BATCH)
        times["pool_int8"] = time_pair(lambda: lazyv_pool.pool_int8(w, x_q),
                                       lambda: lazyv_pool.pool_int8_reference(w, x_q), 10)
        bounds["pool_int8"] = bound(nbytes(w, x_q, lazyv_pool.pool_int8(w, x_q)),
                                    2.0 * TIME_BATCH * OBJS * V_DIM, "f32")
        del w, x_q
        # the bench's fast32 batch: the three kernels of its forward, alone
        xi, wh, bh = gru_inputs(BENCH_BATCH32)
        at32 = {"gru_v2": (time_ms(lambda: gru_v2.gru_last_state_v2(xi, wh, bh), 5), bound(
            nbytes(xi, wh, bh, gru_v2.gru_last_state_v2(xi, wh, bh)),
            gru_ops(BENCH_BATCH32, Q_LEN, HIDDEN), "bf16"))}
        del xi, wh, bh
        x_q, scale, w = gemm_inputs(BENCH_BATCH32 * OBJS)
        at32["dequant_matmul"] = (time_ms(lambda: feed_gemm.dequant_matmul(x_q, scale, w), 5),
                                  bound(nbytes(x_q, scale, w, feed_gemm.dequant_matmul(x_q, scale, w)),
                                        2.0 * BENCH_BATCH32 * OBJS * V_DIM * HIDDEN, "bf16"))
        del x_q, scale, w
        ops = gated_inputs(BENCH_BATCH32, OBJS, V_DIM, HIDDEN)
        at32["dequant_matmul_gated_logits"] = (
            time_ms(lambda: feed_gemm.dequant_matmul_gated_logits(*ops, OBJS), 5),
            bound(nbytes(*ops, feed_gemm.dequant_matmul_gated_logits(*ops, OBJS)),
                  2.0 * BENCH_BATCH32 * OBJS * V_DIM * HIDDEN, "bf16"))
        del ops
        w, x_q = pool_inputs(BENCH_BATCH32)
        at32["pool_int8"] = (time_ms(lambda: lazyv_pool.pool_int8(w, x_q), 10),
                             bound(nbytes(w, x_q, lazyv_pool.pool_int8(w, x_q)),
                                   2.0 * BENCH_BATCH32 * OBJS * V_DIM, "f32"))
        del w, x_q
        for name, (k_ms, b) in at32.items():
            extra.setdefault(name, {}).update(ms_b32768=k_ms, bound_ms_b32768=b[0])
            log(f"time {name} B={BENCH_BATCH32}: kernel {k_ms:.4f} ms, bound {b[0]:.4f} ms "
                f"({b[1]}), share of the bound {b[0] / k_ms:.1%} [{card}]")
        for name, (k_ms, p_ms) in times.items():
            log(f"time {name} B={TIME_BATCH}: kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms [{card}]")
        rows = DECODE_TIME_BATCH * BEAM_K
        h, w, b = vocab_inputs(rows, ties=False)
        times["vocab_topk_lse"] = time_pair(
            lambda: vocab_topk.vocab_topk_lse(h, w, b, BEAM_K),
            lambda: vocab_topk.vocab_topk_lse_reference(h, w, b, BEAM_K), 10)
        bounds["vocab_topk_lse"] = bound(
            nbytes(h, w, b, *vocab_topk.vocab_topk_lse(h, w, b, BEAM_K)),
            2.0 * rows * HIDDEN * NTOKEN, "bf16")
        # the yardstick: cuBLAS's bf16 h @ w.T of the same shape (the
        # product alone, its [R, V] logits written out)
        library["vocab_topk_lse"] = time_ms(lambda: torch.matmul(h, w.t()), 10)

        def unfused_head():
            logits = torch.matmul(h, w.t()) + b
            return vocab_topk.topk_first(logits, BEAM_K), torch.logsumexp(logits, -1)

        unfused_ms = time_ms(unfused_head, 10)
        # the same call at k = 1 and 8: the spread is what the top-k part of
        # the epilogue costs (the product and the logsumexp do not change)
        by_k = {k: time_ms(lambda: vocab_topk.vocab_topk_lse(h, w, b, k), 10)
                for k in (1, BEAM_K, 8)}
        del h, w, b
        log(f"time vocab_topk_lse R={rows} H={HIDDEN} V={NTOKEN} k={BEAM_K}: "
            f"kernel {times['vocab_topk_lse'][0]:.4f} ms, plain (f32) "
            f"{times['vocab_topk_lse'][1]:.4f} ms, the unfused bf16 head of "
            f"use_pallas=False (cuBLAS, topk_first, logsumexp) "
            f"{unfused_ms:.4f} ms; the kernel at k = "
            + ", ".join(f"{k}: {ms:.4f}" for k, ms in by_k.items()) + f" ms [{card}]")
        for name in ("dequant_matmul", "vocab_topk_lse"):
            k_ms = times[name][0]
            log(f"time {name}: kernel {k_ms:.4f} ms, {bounds[name][0] / k_ms:.3f} of "
                f"its bound ({bounds[name][0]:.4f} ms, {bounds[name][1]}), "
                f"{k_ms / library[name]:.3f} of cuBLAS's bf16 product of the same "
                f"shape alone ({library[name]:.4f} ms) [{card}]")

        plain_model = set_model(**dims, use_pallas=False).to(device=dev, dtype=bf16).eval()
        plain_model.load_state_dict(model.state_dict())
        x_q, scale = int8_feed(TIME_BATCH * OBJS, V_DIM)
        batch = {"q": torch.randint(0, NTOKEN, (TIME_BATCH, Q_LEN), device=dev, generator=gen),
                 "img_q": x_q.view(TIME_BATCH, OBJS, V_DIM),
                 "img_scale": scale.view(TIME_BATCH, OBJS)}
        rnn_ops.reset_routes()
        fwd_k, fwd_p = time_pair(lambda: model(batch), lambda: plain_model(batch), 3)
        forward_ms = fwd_k   # phase 18 holds the bench's fast rung against it
        log(f"time forward B={TIME_BATCH} int8 feed bf16: kernels {fwd_k:.3f} ms "
            f"({TIME_BATCH / fwd_k * 1e3:.1f} q/s), plain {fwd_p:.3f} ms "
            f"({TIME_BATCH / fwd_p * 1e3:.1f} q/s); recorded before dequant_matmul's "
            f"wgmma design: {RECORDED_FORWARD_MS} ms (PERF.md) [{card}]")
        # the staged batches take the vocabulary table (20,001 rows <= B x T);
        # the plain model runs the plain scan, which counts no route
        require(rnn_ops.ROUTES["table"] > 0 and rnn_ops.ROUTES["gates"] == 0,
                f"question GRU routes {rnn_ops.ROUTES} at B={TIME_BATCH}")
        if args.profile:
            profile_run("forward", lambda: model(batch), 1)
        del plain_model, batch, x_q, scale
        # one forward at the bench's fast32 batch: the table route, one gru_v2
        x_q, scale = int8_feed(BENCH_BATCH32 * OBJS, V_DIM)
        batch = {"q": torch.randint(0, NTOKEN, (BENCH_BATCH32, Q_LEN), device=dev,
                                    generator=gen),
                 "img_q": x_q.view(BENCH_BATCH32, OBJS, V_DIM),
                 "img_scale": scale.view(BENCH_BATCH32, OBJS)}
        rnn_ops.reset_routes()
        linear_ops.reset_routes()
        gru_before = _build.LAUNCHES["gru_v2"]
        logits32 = model(batch)[0]
        torch.cuda.synchronize()
        log(f"forward B={BENCH_BATCH32}: question GRU routes {rnn_ops.ROUTES}, gru_v2 "
            f"launches {_build.LAUNCHES['gru_v2'] - gru_before}, WNDense routes "
            f"{linear_ops.ROUTES}")
        # WNDense.forward: q_net, the attention's W_q, v_net and the
        # classifier's first layer plain; its 3129-wide last layer aligned
        require(rnn_ops.ROUTES == {"table": 1, "gates": 0}
                and linear_ops.ROUTES == {"aligned": 1, "plain": 4}
                and _build.LAUNCHES["gru_v2"] == gru_before + 1
                and bool(torch.isfinite(logits32).all()),
                f"the B={BENCH_BATCH32} forward: routes {rnn_ops.ROUTES}, "
                f"{linear_ops.ROUTES}")
        del batch, x_q, scale, logits32
        # the classifier's last layer alone: its GEMM at the padded width
        last = model.predictor.classifier.main[-2]
        h = torch.relu(torch.randn(BENCH_BATCH32, last.weight_v.shape[1], device=dev,
                                   dtype=bf16, generator=gen))
        kernels = device_kernels(lambda: last(h))
        gemms = [(name, ms) for name, ms in kernels
                 if any(x in name for x in ("gemm", "nvjet", "cutlass", "Gemm"))]
        log(f"classifier GEMM B={BENCH_BATCH32} [{BENCH_BATCH32}, "
            f"{last.weight_v.shape[1]}] x [{last.weight_v.shape[1]}, "
            f"{last.weight_v.shape[0]}]: " + ", ".join(
                f"{name[:80]} {ms:.4f} ms" for name, ms in gemms) + f" [{card}]")
        require(len(gemms) == 1 and "cutlass_75" not in gemms[0][0],
                f"the classifier's GEMM at B={BENCH_BATCH32}: {gemms}")
        del h

        dec_plain = set_model(**dec_dims, use_pallas=False).to(device=dev, dtype=bf16).eval()
        dec_plain.load_state_dict(dec_model.state_dict())
        beam_plain = make_beam_search(dec_plain, BEAM_K, C_LEN, vocab.start, vocab.end)
        beam_unfused = make_beam_search(dec_model, BEAM_K, C_LEN, vocab.start, vocab.end)
        x_q, scale = int8_feed(DECODE_TIME_BATCH * OBJS, V_DIM)
        batch = {"q": torch.randint(0, NTOKEN, (DECODE_TIME_BATCH, Q_LEN), device=dev,
                                    generator=gen),
                 "img_q": x_q.view(DECODE_TIME_BATCH, OBJS, V_DIM),
                 "img_scale": scale.view(DECODE_TIME_BATCH, OBJS)}
        dec_k, dec_p = time_pair(lambda: beam(batch), lambda: beam_plain(batch), 2)
        dec_u = time_ms(lambda: beam_unfused(batch), 2)
        log(f"time decode B={DECODE_TIME_BATCH} k={BEAM_K} c_len={C_LEN} int8 feed bf16: "
            f"kernels with fused_vocab {dec_k:.2f} ms "
            f"({DECODE_TIME_BATCH / dec_k * 1e3:.1f} captions/s), plain "
            f"(use_pallas=False) {dec_p:.2f} ms "
            f"({DECODE_TIME_BATCH / dec_p * 1e3:.1f} captions/s); kernels with "
            f"the unfused head {dec_u:.2f} ms "
            f"({DECODE_TIME_BATCH / dec_u * 1e3:.1f} captions/s); recorded before "
            f"vocab_topk_lse's wgmma design: {RECORDED_DECODE_MS} ms (PERF.md) [{card}]")
        if args.profile:
            profile_run("decode", lambda: beam(batch), C_LEN - 1)

    # -- 12. the library kernels against their plain versions ---------------
    phase("12 library kernels")
    # (run here, while the serving model whose weights they take is alive)

    def lib_attention_inputs(batch, n, dv, h, hq):
        """Attention operands: unit-normal boxes, a question in (-1, 1), Linear
        init weights; f32 and bf16 vectors mixed (the kernel upcasts both)."""
        def u(*shape, scale):
            return (torch.rand(*shape, device=dev, generator=gen) * 2 - 1) * scale
        return (torch.randn(batch, n, dv, device=dev, generator=gen).to(bf16),
                u(batch, hq, scale=1.0).to(bf16), u(dv, h, scale=dv ** -0.5).to(bf16),
                u(h, scale=0.1), u(hq, h, scale=hq ** -0.5).to(bf16),
                u(h, scale=0.1).to(bf16), u(h, 1, scale=h ** -0.5), u(1, scale=0.1).to(bf16))

    def compare_attention(args, shape):
        """The kernel against its plain version, and a second call bit-equal
        to the first: the logits' cluster sum runs in a fixed order."""
        v, q, wv, _, wq = args[:5]
        gate("fused_multiply_attention_pool", fused_attention.supports(
            *v.shape, wv.shape[1], wq.shape[0], v.dtype), shape)
        pooled, att = fused_attention.fused_multiply_attention_pool(*args)
        p_pooled, p_att = fused_attention.multiply_attention_pool_reference(*args)
        for what, got, want in (("att", att, p_att), ("pooled", pooled, p_pooled)):
            compare("fused_multiply_attention_pool", got, want,
                    LIB_F32_ATOL_REL * want.abs().max().item(), 0.0, f"{shape} {what}")
        again = fused_attention.fused_multiply_attention_pool(*args)
        same = torch.equal(again[0], pooled) and torch.equal(again[1], att)
        log(f"kernel fused_multiply_attention_pool {shape}: a second call bit-equal: {same}")
        require(same, f"fused_multiply_attention_pool {shape}: two calls differ")
        return pooled, att

    def within(name: str, what: str, got, want, atol: float) -> None:
        """A check against another route than the plain version (it does not
        enter max_abs_err)."""
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        log(f"kernel {name} {what}: max abs err {err:.3g} (max |other| "
            f"{want.float().abs().max().item():.3g}), tolerance {atol:.3g}")
        require(torch.isfinite(got).all().item() and err <= atol,
                f"{name} {what}: disagrees")

    def lib_gru_inputs(batch, t_len, e_dim, hidden):
        def u(*shape, scale):
            return ((torch.rand(*shape, device=dev, generator=gen) * 2 - 1) * scale).to(bf16)
        emb = torch.randn(batch, t_len, e_dim, device=dev, generator=gen).to(bf16)
        return (emb, u(e_dim, 3 * hidden, scale=e_dim ** -0.5), u(3 * hidden, scale=hidden ** -0.5),
                u(hidden, 3 * hidden, scale=hidden ** -0.5), u(3 * hidden, scale=hidden ** -0.5))

    def compare_grus(emb, wi, bi, wh, bh, shape):
        """v1 on the v2 route's bf16 input gates, against its plain version
        and against gru_v2; v3 on the embeddings against its plain version."""
        xi = (torch.matmul(emb, wi) + bi).to(bf16)
        for name, module in (("gru_last_state", gru), ("gru_last_state_v3", gru_v3)):
            gate(name, module.supports(emb.shape[1], wh.shape[0], bf16), shape)
        v1 = gru.gru_last_state(xi, wh, bh)
        compare("gru_last_state", v1, gru.gru_last_state_reference(xi, wh, bh), GRU_ATOL,
                0.0, shape)
        within("gru_last_state", f"{shape} vs gru_v2 on the same xi", v1,
               gru_v2.gru_last_state_v2(xi, wh, bh), GRU_ATOL)
        compare("gru_last_state_v3", gru_v3.gru_last_state_v3(emb, wi, bi, wh, bh),
                gru_v3.gru_last_state_v3_reference(emb, wi, bi, wh, bh), GRU_ATOL, 0.0,
                f"{shape} E={emb.shape[2]}")
        return xi

    # one PyTorch call computes gru_last_state_v3's function: cuDNN's GRU
    # (every step and the last state) on the serving model's question-GRU
    # weights, built outside inference mode so that its weights are flattened
    cudnn_gru = torch.nn.GRU(EMBED, HIDDEN, batch_first=True).to(dev, bf16)
    with torch.no_grad():
        w_ih, b_ih, w_hh, b_hh = model.encoder.q_rnn.rnn.layer(0, 0)
        for dst, src in zip(cudnn_gru.parameters(), (w_ih, w_hh, b_ih, b_hh)):
            dst.copy_(src)
    cudnn_gru.flatten_parameters()
    with torch.inference_mode():
        # the JAX test shapes (tests/test_pallas.py), a ragged batch, 100
        # boxes (adaptive bottom-up features), the most boxes (one image an
        # M tile) and an H of 9 column tiles (no cluster divides them)
        for shape in ((32, 12, 64, 48, 40), (16, 9, 32, 24, 24),
                      (1003, OBJS, V_DIM, HIDDEN, HIDDEN), (64, 100, V_DIM, HIDDEN, HIDDEN),
                      (5, 256, 256, HIDDEN, 64), (200, OBJS, V_DIM, 1040, HIDDEN)):
            compare_attention(lib_attention_inputs(*shape),
                              "B={} N={} Dv={} H={} Hq={}".format(*shape))
        # H=2048: the 64-row state does not fit in shared memory beside the
        # ring, so the kernel keeps it in device memory, and v1 and v3 run
        # there too
        for shape in ((64, 2, 12, 2048), (1003, 3, EMBED, 2048)):
            compare_grus(*lib_gru_inputs(*shape), "B={} T={} H={}".format(
                shape[0], shape[1], shape[3]))
        for batch, t_len, e_dim, hidden in ((16, 10, 12, 32), (16, 6, 12, 32),
                                            (1003, Q_LEN, EMBED, HIDDEN)):
            compare_grus(*lib_gru_inputs(batch, t_len, e_dim, hidden),
                         f"B={batch} T={t_len} H={hidden}")
        # full width on the serving model's MultiplyAttention, weight norm
        # folded as the module folds it (g / ||v|| in its bf16 parameters)
        att_mod = model.encoder.attention
        fc_v, fc_q, lin = att_mod.W_v.main[0], att_mod.W_q.main[0], att_mod.linear
        v = torch.randn(LIB_TIME_BATCH, OBJS, V_DIM, device=dev, generator=gen).to(bf16)
        q = (torch.rand(LIB_TIME_BATCH, HIDDEN, device=dev, generator=gen) * 2 - 1).to(bf16)
        lib_args = (v, q, fc_v.weight(bf16).t(), fc_v.bias, fc_q.weight(bf16).t(),
                    fc_q.bias, lin.weight(bf16).t(), lin.bias)
        shape = (f"B={LIB_TIME_BATCH} N={OBJS} Dv={V_DIM} H={HIDDEN} Hq={HIDDEN} "
                 "(serving model)")
        pooled, att = compare_attention(lib_args, shape)
        mod_att = att_mod(v, q)[..., 0]
        within("fused_multiply_attention_pool", f"{shape} att vs MultiplyAttention (bf16)",
               att, mod_att, MODULE_ATT_ATOL)
        mod_pooled = torch.einsum("bn,bnd->bd", mod_att.float(), v.float())
        within("fused_multiply_attention_pool", f"{shape} pooled vs sum_n att v", pooled,
               mod_pooled, MODULE_POOL_ATOL_REL * mod_pooled.abs().max().item())
        del mod_pooled
        name = "fused_multiply_attention_pool"
        times[name] = time_pair(lambda: fused_attention.fused_multiply_attention_pool(*lib_args),
                                lambda: fused_attention.multiply_attention_pool_reference(
                                    *lib_args), 3)
        # the products v @ wv and q @ wq, the gate and the pooling, from the
        # operands' shapes
        q_dim, hid = lib_args[4].shape
        bounds[name] = bound(nbytes(*lib_args, pooled, att), 2.0 * LIB_TIME_BATCH * (
            OBJS * V_DIM * hid + q_dim * hid + OBJS * hid + OBJS * V_DIM), "bf16")
        unfused_att_ms = time_ms(
            lambda: torch.einsum("bn,bnd->bd", att_mod(v, q)[..., 0], v), 3)
        log(f"time {name} {shape}: kernel {times[name][0]:.4f} ms, plain (f32) "
            f"{times[name][1]:.4f} ms, the unfused bf16 module (MultiplyAttention "
            f"+ the pooling einsum, cuBLAS) {unfused_att_ms:.4f} ms, bound "
            f"{bounds[name][0]:.4f} ms ({bounds[name][1]}); share of the bound "
            f"{bounds[name][0] / times[name][0]:.1%}, kernel / unfused module "
            f"{times[name][0] / unfused_att_ms:.3f}; recorded before this design "
            f"{RECORDED_ATTENTION_MS} ms (PERF.md) [{card}]")
        extra[name] = {"unfused_module_ms": unfused_att_ms}
        # what the kernel reports of itself and the card, and its plan here
        # (the CPU tests pin the plan on these numbers)
        card_caps = fused_attention._card(dev)
        log(f"kernel {name}: {card_caps}; plan at {shape} (images, cluster, passes, "
            f"stages, grid): {fused_attention._plan(LIB_TIME_BATCH, OBJS, hid, card_caps)} "
            f"[{card}]")
        del v, q, lib_args, pooled, att, mod_att
        # full width on the serving model's question GRU and embeddings
        emb = model.encoder.embed(torch.randint(0, NTOKEN, (LIB_TIME_BATCH, Q_LEN),
                                                device=dev, generator=gen))
        gru_args = (emb, w_ih.t(), b_ih, w_hh.t(), b_hh)
        shape = f"B={LIB_TIME_BATCH} T={Q_LEN} H={HIDDEN} (serving model)"
        xi = compare_grus(*gru_args, shape)
        wh, bh = w_hh.t(), b_hh
        times["gru_last_state"] = time_pair(lambda: gru.gru_last_state(xi, wh, bh),
                                            lambda: gru.gru_last_state_reference(xi, wh, bh), 5)
        out = gru.gru_last_state(xi, wh, bh)
        bounds["gru_last_state"] = bound(nbytes(xi, wh, bh, out),
                                         gru_ops(LIB_TIME_BATCH, Q_LEN, HIDDEN), "bf16")
        times["gru_last_state_v3"] = time_pair(
            lambda: gru_v3.gru_last_state_v3(*gru_args),
            lambda: gru_v3.gru_last_state_v3_reference(*gru_args), 5)
        bounds["gru_last_state_v3"] = bound(
            nbytes(*gru_args, out), gru_ops(LIB_TIME_BATCH, Q_LEN, HIDDEN, EMBED), "bf16")
        library["gru_last_state_v3"] = time_ms(lambda: cudnn_gru(emb), 5)
        v2_ms = time_ms(lambda: gru_v2.gru_last_state_v2(xi, wh, bh), 5)
        for name, other, other_ms in (("gru_last_state", "gru_v2 on the same xi", v2_ms),
                                      ("gru_last_state_v3", "torch.nn.GRU (cuDNN, bf16)",
                                       library["gru_last_state_v3"])):
            log(f"time {name} {shape}: kernel {times[name][0]:.4f} ms, plain "
                f"{times[name][1]:.4f} ms, bound {bounds[name][0]:.4f} ms "
                f"({bounds[name][1]}); share of the bound "
                f"{bounds[name][0] / times[name][0]:.1%}, kernel / {other} "
                f"{times[name][0] / other_ms:.3f} ({other} {other_ms:.4f} ms) [{card}]")
        # what bounds the GRU kernel: one full wave of 64-row blocks (one an
        # SM) against half a wave, which asks half the L2 bandwidth for the
        # recurrent weight; if L2 bandwidth bounded it, the half wave would
        # take about half as long
        # and the cluster plan's answer to it: half the row tiles, each
        # shared by two blocks, fill the wave again
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        wave = {}
        for tiles in (sms, sms // 2):
            rows = tiles * 64
            wave_args = (xi[:rows], wh, bh)
            wave[tiles] = (time_ms(lambda: gru.gru_last_state(*wave_args), 5),
                           gru_v2.launch_plan(dev, rows, HIDDEN, False)[0])
        log(f"time gru_last_state T={Q_LEN} H={HIDDEN}: one wave of {sms} row tiles "
            f"(B={sms * 64}, cluster {wave[sms][1]}) {wave[sms][0]:.4f} ms, half as many "
            f"tiles ({sms // 2}, cluster {wave[sms // 2][1]}) {wave[sms // 2][0]:.4f} ms "
            f"(ratio {wave[sms // 2][0] / wave[sms][0]:.3f}); B={LIB_TIME_BATCH} is "
            f"{-(-LIB_TIME_BATCH // 64)} tiles, {-(-LIB_TIME_BATCH // 64) / sms:.2f} waves "
            f"[{card}]")
        del emb, gru_args, xi, out, cudnn_gru
    torch.cuda.empty_cache()

    # -- 7. train the full-width MTL model on Loader batches ----------------
    phase("7 train")
    mtl_dims = MTL_DIMS
    mtl = set_model(**mtl_dims, use_pallas=True,
                    generator=torch.Generator().manual_seed(2))
    state = TrainState(mtl, make_optimizer(mtl, lr=TRAIN_LR, max_norm=TRAIN_CLIP),
                       seed=RUN_SEED)
    train_step = make_train_step(mtl, state.optimizer, compute_dtype=bf16)
    with tempfile.TemporaryDirectory() as root:
        make_synthetic_root(root, split="train2014", num_images=64,
                            num_questions=TRAIN_BATCH * 8, num_objs=OBJS,
                            v_dim=V_DIM, vocab_size=NTOKEN, num_answers=ANS,
                            q_len=Q_LEN, c_len=C_LEN, seed=1)
        dataset = set_dataset(os.path.join(root, "annot"),
                              os.path.join(root, "features"), ANS,
                              is_train=True, dataset_type="vqa-e",
                              feature_mode="int8")
        loader = Loader(dataset, TRAIN_BATCH, shuffle=True, drop_last=True,
                        length_bucket=True)
        host_train = list(itertools.islice(loader, TRAIN_STEPS))
    require(len(host_train) == TRAIN_STEPS, f"loader gave {len(host_train)} batches")
    train_batches = [{"q": torch.from_numpy(b["q"]).to(dev, torch.long),
                      "a": torch.from_numpy(b["a"]).to(dev),
                      "c": torch.from_numpy(b["c"]).to(dev, torch.long),
                      "cap_len": torch.from_numpy(b["cap_len"]).to(dev, torch.long),
                      "img_q": torch.from_numpy(b["img_q"]).to(dev),
                      "img_scale": torch.from_numpy(b["img_scale"]).to(dev)}
                     for b in host_train]
    decoder_steps = [b["c"].shape[1] - 1 for b in train_batches]
    _build.reset_launches()
    metrics = [train_step(state, b) for b in train_batches]
    torch.cuda.synchronize()
    train_launches = dict(_build.LAUNCHES)
    losses = [m["loss"].item() for m in metrics]
    log(f"train: {TRAIN_STEPS} steps of B={TRAIN_BATCH} (decoder steps "
        f"{decoder_steps}) through make_train_step (bf16 over f32 masters); "
        f"losses {[round(x, 4) for x in losses]}, VQA "
        f"{[round(m['train/loss'].item(), 4) for m in metrics]}, caption "
        f"{[round(m['train/cap/loss'].item(), 4) for m in metrics]}; kernel "
        f"launches {train_launches}")
    require(all(map(math.isfinite, losses)), "non-finite training loss")
    require(train_launches["decode_att_fwd"] == sum(decoder_steps)
            and train_launches["decode_att_bwd"] == sum(decoder_steps),
            "decode_att_fwd / _bwd did not run once per decoder step")
    require(train_launches["decode_att_dvp"] == TRAIN_STEPS,
            "decode_att_dvp did not run once per training step")
    repeated = [train_step(state, train_batches[0])["loss"] for _ in range(REPEAT_STEPS)]
    repeated = [x.item() for x in repeated]
    log(f"train: one batch {REPEAT_STEPS} more times: losses "
        f"{[round(x, 4) for x in repeated]}")
    require(all(map(math.isfinite, repeated)) and repeated[-1] < repeated[0],
            "the repeated batch's loss did not fall")

    # -- 8. one step's gradients: kernels against plain versions ------------
    phase("8 train gradients")

    def grads_against_plain(model, batch, prefixes, what: str) -> None:
        """One training step's loss and gradients (of the parameters under
        ``prefixes``) with the kernels and with every kernel swapped for its
        plain version, the same Philox masks, in f32 and then in bf16."""
        def step_grads(dtype):
            loss = backward_step(model, batch, RUN_SEED, 0, dtype)["loss"].item()
            return loss, {n: p.grad.detach().clone() for n, p in model.named_parameters()
                          if n.startswith(prefixes)}

        for dtype, tol in ((None, GRAD_F32_TOL), (bf16, GRAD_BF16_TOL)):
            label = "bf16" if dtype is bf16 else "f32"
            _build.reset_launches()
            k_loss, k_grads = step_grads(dtype)
            require(all(_build.LAUNCHES[n] > 0 for n in TRAIN_KERNELS),
                    f"the {what} {label} step did not launch every decode-attention kernel")
            with ExitStack() as stack:
                plain_kernels(stack, *kernel_modules)
                _build.reset_launches()
                p_loss, p_grads = step_grads(dtype)
                require(not any(_build.LAUNCHES.values()), "the plain step launched a kernel")
            rel = {n: ((k_grads[n] - p_grads[n]).abs().max()
                       / p_grads[n].abs().max().clamp_min(1e-30)).item() for n in p_grads}
            loss_rel = abs(k_loss - p_loss) / abs(p_loss)
            worst = max(rel, key=rel.get)
            by_group = {g: max(v for n, v in rel.items() if n.startswith(g))
                        for g in prefixes}
            log(f"{what}: {label} step on B={batch['q'].shape[0]}, kernels against plain "
                f"versions: loss {k_loss:.6f} vs {p_loss:.6f} (rel {loss_rel:.3g}); max "
                f"|grad diff| / max |plain grad| by group "
                f"{{{', '.join(f'{g}: {v:.3g}' for g, v in by_group.items())}}}, "
                f"worst {worst} {rel[worst]:.3g} (tolerance {tol:g})")
            require(loss_rel <= tol and rel[worst] <= tol,
                    f"{what} {label} training step: kernels disagree with the plain versions")

    grads_against_plain(mtl, train_batches[1], GRAD_PREFIXES, "train")

    # -- 8b. widths the kernels refuse: their gates send them to the plain
    # versions -------------------------------------------------------------
    phase("8b refused widths")
    # the serving model at hidden 1000: the GRU kernel takes H a multiple of
    # 32, so the question GRU runs its plain scan, while the v-projection
    # (N=1000) and the pooling keep their kernels
    wide = set_model(**dict(dims, hidden_dim=1000), use_pallas=True,
                     generator=torch.Generator().manual_seed(5))
    wide = wide.to(device=dev, dtype=bf16).eval()
    with torch.inference_mode():
        _build.reset_launches()
        score, label, _ = wide.forward_vqa(requests[0])
        torch.cuda.synchronize()
        h1000_launches = dict(_build.LAUNCHES)
        got = wide(requests[0])[0].float()
        with ExitStack() as stack:
            plain_kernels(stack, *kernel_modules)
            want = wide(requests[0])[0].float()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"refused widths: the Up-Down model at hidden 1000 (use_pallas) answers one "
        f"request of B={SERVE_BATCH}; kernel launches {h1000_launches}; logits vs the "
        f"same model on plain versions: max abs err / max |logit| = {rel:.3g} "
        f"(tolerance {LOGIT_REL_TOL:g})")
    require(h1000_launches["gru_v2"] == 0, "the question GRU at H=1000 launched gru_v2")
    require(h1000_launches["dequant_matmul_gated_logits"] == 1
            and h1000_launches["pool_int8"] == 1,
            "the H=1000 model left the gated dequant GEMM or the pooling kernel")
    require(score.shape == (SERVE_BATCH, ANS) and torch.isfinite(got).all().item()
            and rel <= LOGIT_REL_TOL, "the H=1000 model's logits disagree with plain versions")
    del wide, got, want
    # one MTL step with a decoder of width 500 (not whole 16-lane groups):
    # the scan's attention takes its plain tail
    narrow = set_model(**dict(mtl_dims, decoder_hidden_dim=500), use_pallas=True,
                       generator=torch.Generator().manual_seed(6))
    narrow_state = TrainState(narrow, make_optimizer(narrow, lr=TRAIN_LR, max_norm=TRAIN_CLIP),
                              seed=RUN_SEED)
    _build.reset_launches()
    narrow_loss = make_train_step(narrow, narrow_state.optimizer, compute_dtype=bf16)(
        narrow_state, train_batches[0])["loss"].item()
    torch.cuda.synchronize()
    h500_launches = dict(_build.LAUNCHES)
    log(f"refused widths: one MTL step of B={TRAIN_BATCH} at decoder_hidden_dim 500 "
        f"(use_pallas, bf16): loss {narrow_loss:.4f}; kernel launches {h500_launches}")
    require(math.isfinite(narrow_loss), "the H=500 MTL step's loss is not finite")
    require(not any(h500_launches[n] for n in TRAIN_KERNELS),
            "the H=500 MTL step launched a decode-attention kernel")
    del narrow, narrow_state

    # -- 9. train timing at the JAX package's MTL batch ---------------------
    phase("9 train timing")
    with torch.inference_mode():
        fkw = dict(objs=OBJS, att_scale=ATT_SCALE, thresh=ATT_THRESH)
        # decode_att_fwd at the B=512 the training path launches it at
        small = att_inputs(TRAIN_BATCH, "bf16-int8")
        fwd_small = small + (ATT_SEED, ATT_STEP)
        small_ms = time_pair(lambda: decode_att.decode_att_fwd(*fwd_small, **fkw),
                             lambda: decode_att.decode_att_fwd_reference(*fwd_small, **fkw),
                             20)
        small_bound = bound(nbytes(*small, *decode_att.decode_att_fwd(*fwd_small, **fkw)),
                            2.0 * TRAIN_BATCH * OBJS * (HIDDEN + V_DIM), "f32",
                            decode_att.philox_draws(TRAIN_BATCH, OBJS, HIDDEN))
        extra["decode_att_fwd"] = {"ms_b512": small_ms[0], "bound_ms_b512": small_bound[0]}
        log(f"time decode_att_fwd B={TRAIN_BATCH} bf16 over the int8 payload, dropout "
            f"0.2: kernel {small_ms[0]:.4f} ms, plain {small_ms[1]:.4f} ms, bound "
            f"{small_bound[0]:.4f} ms ({small_bound[2]}), share of the bound "
            f"{small_bound[0] / small_ms[0]:.1%} [{card}]")
        del small, fwd_small
        vp, pool, w, qp, k = att_inputs(TRAIN_TIME_BATCH, "bf16-int8")
        fwd_args = (vp, pool, w, qp, k, ATT_SEED, ATT_STEP)
        times["decode_att_fwd"] = time_pair(
            lambda: decode_att.decode_att_fwd(*fwd_args, **fkw),
            lambda: decode_att.decode_att_fwd_reference(*fwd_args, **fkw), 10)
        att, att_v = decode_att.decode_att_fwd(*fwd_args, **fkw)
        att_ops = 2.0 * TRAIN_TIME_BATCH * OBJS * (HIDDEN + V_DIM)
        step_draws = decode_att.philox_draws(TRAIN_TIME_BATCH, OBJS, HIDDEN)
        bounds["decode_att_fwd"] = bound(nbytes(vp, pool, w, qp, k, att, att_v), att_ops, "f32",
                                         step_draws)
        g_attv = torch.randn(TRAIN_TIME_BATCH, V_DIM, device=dev, generator=gen).to(bf16)
        bwd_args = (vp, pool, w, att, g_attv, ATT_SEED, ATT_STEP)
        bkw = dict(objs=OBJS, thresh=ATT_THRESH)
        times["decode_att_bwd"] = time_pair(
            lambda: decode_att.decode_att_bwd(*bwd_args, **bkw),
            lambda: decode_att.decode_att_bwd_reference(*bwd_args, **bkw), 10)
        bounds["decode_att_bwd"] = bound(
            nbytes(vp, pool, w, att, g_attv, *decode_att.decode_att_bwd(*bwd_args, **bkw)),
            att_ops, "f32", step_draws)
        # the deferred reduction over T = 19 steps at the path's B=512 and at
        # B=4096
        steps = C_LEN - 1
        dkw = dict(objs=OBJS, att_scale=ATT_SCALE, thresh=ATT_THRESH, out_dtype=bf16)
        for batch in (TRAIN_BATCH, TRAIN_TIME_BATCH):
            dls = (torch.randn(steps, batch, OBJS, device=dev, generator=gen) * 0.01).to(bf16)
            qps = torch.rand(steps, batch, HIDDEN, device=dev, generator=gen).to(bf16)
            pair = time_pair(lambda: decode_att.decode_att_dvp(dls, qps, k, ATT_SEED, **dkw),
                             lambda: decode_att.decode_att_dvp_reference(dls, qps, k, ATT_SEED,
                                                                         **dkw),
                             20 if batch == TRAIN_BATCH else 3)
            b = bound(nbytes(dls, qps, k, decode_att.decode_att_dvp(dls, qps, k, ATT_SEED, **dkw)),
                      2.0 * steps * batch * OBJS * HIDDEN, "f32",
                      decode_att.philox_draws(batch, OBJS, HIDDEN, steps))
            if batch == TRAIN_BATCH:
                extra["decode_att_dvp"] = {"ms_b512": pair[0], "bound_ms_b512": b[0]}
                log(f"time decode_att_dvp B={batch} T={steps} bf16, dropout 0.2: kernel "
                    f"{pair[0]:.4f} ms, plain {pair[1]:.4f} ms, bound {b[0]:.4f} ms ({b[2]}), "
                    f"share of the bound {b[0] / pair[0]:.1%} [{card}]")
            else:
                times["decode_att_dvp"], bounds["decode_att_dvp"] = pair, b
            del dls, qps
        del vp, pool, w, qp, k, att, att_v, g_attv
    for name in TRAIN_KERNELS:
        log(f"time {name} B={TRAIN_TIME_BATCH} bf16 over the int8 payload, dropout "
            f"0.2: kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms, "
            f"bound {bounds[name][0]:.4f} ms ({bounds[name][2]}), share of the bound "
            f"{bounds[name][0] / times[name][0]:.1%} [{card}]")

    x_q, scale = int8_feed(TRAIN_TIME_BATCH * OBJS, V_DIM)
    big = {"q": torch.randint(0, NTOKEN, (TRAIN_TIME_BATCH, Q_LEN), device=dev, generator=gen),
           "a": (torch.randint(0, 4, (TRAIN_TIME_BATCH, ANS), device=dev, generator=gen)
                 * (torch.rand(TRAIN_TIME_BATCH, ANS, device=dev, generator=gen) < 2e-3)) / 3.0,
           "c": torch.randint(0, NTOKEN - 4, (TRAIN_TIME_BATCH, C_LEN), device=dev, generator=gen),
           "cap_len": torch.full((TRAIN_TIME_BATCH,), C_LEN, device=dev),
           "img_q": x_q.view(TRAIN_TIME_BATCH, OBJS, V_DIM),
           "img_scale": scale.view(TRAIN_TIME_BATCH, OBJS).float()}
    plain_mtl = set_model(**mtl_dims, use_pallas=False)
    plain_mtl.load_state_dict(mtl.state_dict())
    plain_state = TrainState(plain_mtl, make_optimizer(plain_mtl, lr=TRAIN_LR,
                                                      max_norm=TRAIN_CLIP), seed=RUN_SEED)
    plain_step = make_train_step(plain_mtl, plain_state.optimizer, compute_dtype=bf16)
    peaks = {}
    for label, run in (("kernels", lambda: train_step(state, big)),
                       ("plain", lambda: plain_step(plain_state, big))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peaks[label] = (torch.cuda.max_memory_allocated(), base)
    step_k, step_p = time_pair(lambda: train_step(state, big),
                               lambda: plain_step(plain_state, big), 2)
    gb = lambda x: x / 2 ** 30
    log(f"time train step B={TRAIN_TIME_BATCH} c_len={C_LEN} ({C_LEN - 1} decoder "
        f"steps), int8 feed, bf16 over f32 masters, dropout 0.5/0.2: kernels "
        f"{step_k:.2f} ms ({TRAIN_TIME_BATCH / step_k * 1e3:.1f} samples/s), plain "
        f"(use_pallas=False) {step_p:.2f} ms ({TRAIN_TIME_BATCH / step_p * 1e3:.1f} "
        f"samples/s); peak memory allocated: kernels {gb(peaks['kernels'][0]):.2f} GiB "
        f"({gb(peaks['kernels'][0] - peaks['kernels'][1]):.2f} above the "
        f"{gb(peaks['kernels'][1]):.2f} held before the step), plain "
        f"{gb(peaks['plain'][0]):.2f} GiB ({gb(peaks['plain'][0] - peaks['plain'][1]):.2f} "
        f"above {gb(peaks['plain'][1]):.2f}) [{card}]")
    if args.profile:
        profile_run("training step", lambda: train_step(state, big), C_LEN - 1)

    del mtl, state, train_step, plain_mtl, plain_state, plain_step, big, x_q, scale
    torch.cuda.empty_cache()

    # -- 10. serve ReGAT requests through the port's main path -------------
    phase("10 ReGAT")
    regat = set_model(**REGAT_DIMS, use_pallas=True, use_int8=True,
                      generator=torch.Generator().manual_seed(3))
    regat = regat.to(device=dev, dtype=bf16).eval()
    regat_requests = [dict(r, graph=torch.from_numpy(g).to(dev))
                      for r, g in zip(requests, host_graphs)]

    def serve_regat(model, label: str, want_kernels, no_kernels):
        """Serve the requests through forward_vqa; check the launches, the
        outputs, and the logits against the model on plain versions."""
        _build.reset_launches()
        served = [model.forward_vqa(r) for r in regat_requests]
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        log(f"regat: {SERVE_REQUESTS} requests of B={SERVE_BATCH} with spatial graphs "
            f"through VQAModel.forward_vqa ({label}); kernel launches {counts}")
        for name, per_forward in want_kernels.items():
            require(counts[name] == per_forward * SERVE_REQUESTS,
                    f"the ReGAT path ({label}) launched {name} {counts[name]} times, "
                    f"not {per_forward} a forward")
        for name in no_kernels:
            require(counts[name] == 0, f"the ReGAT path ({label}) launched {name}")
        for score, lab, _ in served:
            require(score.shape == (SERVE_BATCH, ANS) and lab.shape == (SERVE_BATCH,),
                    f"forward_vqa shapes {tuple(score.shape)}, {tuple(lab.shape)}")
            require(torch.isfinite(score).all().item(), "non-finite scores")
        got = torch.cat([model(r)[0] for r in regat_requests]).float()
        with ExitStack() as stack:
            plain_kernels(stack, *kernel_modules)
            _build.reset_launches()
            want = torch.cat([model(r)[0] for r in regat_requests]).float()
            require(not any(_build.LAUNCHES.values()), "the plain forward launched a kernel")
        require(torch.isfinite(got).all().item(), "non-finite logits")
        rel = ((got - want).abs().max() / want.abs().max()).item()
        agree = (got.argmax(1) == want.argmax(1)).float().mean().item()
        log(f"regat: logits ({label}) vs the same model on plain versions: max abs err "
            f"/ max |logit| = {rel:.3g} (tolerance {LOGIT_REL_TOL:g}), max |logit| "
            f"{want.abs().max().item():.3g}, argmax agreement {agree:.4f}")
        require(rel <= LOGIT_REL_TOL, f"ReGAT logits ({label}) disagree with the plain versions")
        return counts

    with torch.inference_mode():
        regat_launches = serve_regat(regat, "use_int8", REGAT_KERNELS,
                                     ("dequant_matmul", "dequant_matmul_gated_logits",
                                      "pool_int8"))
        regat_bf16 = set_model(**REGAT_DIMS, use_pallas=True, use_int8=False)
        regat_bf16 = regat_bf16.to(device=dev, dtype=bf16).eval()
        regat_bf16.load_state_dict(regat.state_dict())
        bf16_launches = serve_regat(
            regat_bf16, "use_int8=False",
            {"gru_v2": 1, "dequant_matmul_gated_logits": 1, "attended_int8": 1,
             "gcn_chain_fused": 1},
            ("int8_matmul_dequant", "int8_matmul_dequant_3d", "pool_int8",
             "dequant_matmul"))

    # -- 11. ReGAT timing ---------------------------------------------------
    phase("11 ReGAT timing")
    with torch.inference_mode():
        for name, batch, n, xs_dtype, with_bias in (
                ("int8_matmul_dequant_3d", REGAT_TIME_BATCH, HIDDEN, bf16, True),
                ("int8_matmul_dequant", None, V_DIM, f32, False)):
            rows = REGAT_TIME_BATCH * OBJS
            x_q, xs, w_q, w_scale, b = int8_inputs(rows, n, xs_dtype, with_bias)
            if batch:
                ops = (x_q.view(batch, OBJS, V_DIM), xs.view(batch, OBJS), w_q, w_scale)
            else:
                ops = (x_q, xs, w_q, w_scale)
            kw = dict(bias=b, relu=with_bias, out_dtype=bf16)
            kern, plain = getattr(int8_matmul, name), getattr(int8_matmul, name + "_reference")
            times[name] = time_pair(lambda: kern(*ops, **kw), lambda: plain(*ops, **kw), 3)
            bounds[name] = bound(nbytes(x_q, xs, w_q, w_scale, b, kern(*ops, **kw)),
                                 2.0 * rows * V_DIM * n, "int8")
            library[name] = time_ms(lambda: torch._int_mm(x_q, w_q), 10)
            log(f"time {name} M={rows} K={V_DIM} N={n}: kernel {times[name][0]:.4f} ms, "
                f"plain (f64 product) {times[name][1]:.4f} ms, torch._int_mm (the int32 "
                f"product alone) {library[name]:.4f} ms, bound {bounds[name][0]:.4f} ms "
                f"({bounds[name][1]}); share of the bound "
                f"{bounds[name][0] / times[name][0]:.1%}, kernel / torch._int_mm "
                f"{times[name][0] / library[name]:.3f} [{card}]")
            del x_q, xs, w_q, w_scale, b, ops
        # the attended features at B=8192; the yardstick is the eager
        # three-pass form (cast, dequantize's multiply, the weights')
        att, scale, x_q = attended_inputs(REGAT_TIME_BATCH)
        times["attended_int8"] = time_pair(
            lambda: lazyv_pool.attended_int8(att, scale, x_q),
            lambda: lazyv_pool.attended_int8_reference(att, scale, x_q), 10)
        bounds["attended_int8"] = bound(
            nbytes(att, scale, x_q, lazyv_pool.attended_int8(att, scale, x_q)),
            2.0 * x_q.numel(), "f32")
        library["attended_int8"] = time_ms(
            lambda: att[..., None] * quant_ops.dequantize(x_q, scale), 10)
        log(f"time attended_int8 B={REGAT_TIME_BATCH} N={OBJS} D={V_DIM}: kernel "
            f"{times['attended_int8'][0]:.4f} ms, plain {times['attended_int8'][1]:.4f} ms, "
            f"the eager three-pass form {library['attended_int8']:.4f} ms, bound "
            f"{bounds['attended_int8'][0]:.4f} ms ({bounds['attended_int8'][2]}), share of "
            f"the bound {bounds['attended_int8'][0] / times['attended_int8'][0]:.1%} [{card}]")
        del att, scale, x_q
        # the chain at the ReGAT requests' B=512 and at B=8192
        for batch in (SERVE_BATCH, REGAT_TIME_BATCH):
            chain = gcn_inputs(batch, bf16)
            pair = time_pair(lambda: gcn_chain.gcn_chain_fused(*chain),
                             lambda: gcn_chain.gcn_chain_reference(*chain),
                             20 if batch == SERVE_BATCH else 5)
            chain_ops = 2.0 * batch * OBJS * (OBJS * (2 * V_DIM + OBJS) + 12 * V_DIM)
            b = bound(nbytes(*chain, gcn_chain.gcn_chain_fused(*chain)), chain_ops, "bf16")
            log(f"time gcn_chain_fused B={batch} N={OBJS} D={V_DIM} bf16: kernel "
                f"{pair[0]:.4f} ms, plain {pair[1]:.4f} ms, bound {b[0]:.4f} ms ({b[2]}), "
                f"share of the bound {b[0] / pair[0]:.1%} [{card}]")
            if batch == SERVE_BATCH:
                extra["gcn_chain_fused"] = {"ms_b512": pair[0], "bound_ms_b512": b[0]}
            else:
                times["gcn_chain_fused"], bounds["gcn_chain_fused"] = pair, b
            del chain

        x_q, scale = int8_feed(REGAT_TIME_BATCH * OBJS, V_DIM)
        big = {"q": torch.randint(0, NTOKEN, (REGAT_TIME_BATCH, Q_LEN), device=dev,
                                  generator=gen),
               "img_q": x_q.view(REGAT_TIME_BATCH, OBJS, V_DIM),
               "img_scale": scale.view(REGAT_TIME_BATCH, OBJS),
               "graph": torch.randint(0, 12, (REGAT_TIME_BATCH, OBJS, OBJS), device=dev,
                                      generator=gen, dtype=torch.int32)}
        regat_dense = set_model(**REGAT_DIMS).to(device=dev, dtype=bf16).eval()
        regat_dense.load_state_dict(regat.state_dict())

        def regat_plain():
            with ExitStack() as stack:
                plain_kernels(stack, *kernel_modules)
                return regat(big)

        runs = {"kernels": lambda: regat(big), "plain versions": regat_plain,
                "bf16, no use_int8 / use_pallas": lambda: regat_dense(big),
                "bf16 with use_pallas (the chain), no use_int8": lambda: regat_bf16(big)}
        # the attended features of the B=8192 forward: one kernel pass
        encoder_ops.reset_routes()
        _build.reset_launches()
        runs["kernels"]()
        torch.cuda.synchronize()
        require(encoder_ops.ROUTES == {"kernel": 1, "plain": 0}
                and _build.LAUNCHES["attended_int8"] == 1,
                f"the B={REGAT_TIME_BATCH} ReGAT forward formed its attended features "
                f"by {encoder_ops.ROUTES}, attended_int8 launched "
                f"{_build.LAUNCHES['attended_int8']} times")
        log(f"regat: B={REGAT_TIME_BATCH} forward: encoder.ROUTES {encoder_ops.ROUTES}, "
            f"attended_int8 launched once")
        peaks = {}
        for label, run in runs.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run()
            torch.cuda.synchronize()
            peaks[label] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        fwd_k, fwd_p = time_pair(runs["kernels"], runs["plain versions"], 2)
        fwd_d = time_ms(runs["bf16, no use_int8 / use_pallas"], 3)
        fwd_c = time_ms(runs["bf16 with use_pallas (the chain), no use_int8"], 3)
        log(f"time ReGAT forward B={REGAT_TIME_BATCH} int8 feed bf16: kernels {fwd_k:.3f} ms "
            f"({REGAT_TIME_BATCH / fwd_k * 1e3:.1f} q/s), plain versions {fwd_p:.3f} ms "
            f"({REGAT_TIME_BATCH / fwd_p * 1e3:.1f} q/s), bf16 without use_int8 and "
            f"use_pallas {fwd_d:.3f} ms ({REGAT_TIME_BATCH / fwd_d * 1e3:.1f} q/s), bf16 "
            f"with use_pallas (gru_v2, dequant_matmul_gated_logits, gcn_chain_fused) and without "
            f"use_int8 {fwd_c:.3f} ms ({REGAT_TIME_BATCH / fwd_c * 1e3:.1f} q/s); peak "
            f"memory above the weights and batch: " + ", ".join(
                f"{k} {v:.2f} GiB" for k, v in peaks.items()) + f" [{card}]")
        if args.profile:
            profile_run("ReGAT forward", runs["kernels"], 1)

    # -- 13. the entry point, in this process ------------------------------
    phase("13 entry point")
    del regat, regat_bf16, regat_dense, big, x_q, scale, runs, model, dec_model, dec_plain
    torch.cuda.empty_cache()
    cli_launches, cli_wall, cli_train_s, cli_steps, restored = {}, {}, {}, {}, {}
    real_train, real_load, real_build = cli.train, cli.load_checkpoint, cli.build_model
    built = []

    def capturing_build(*a, **k):
        """build_model, keeping the last model it built."""
        built[:] = [real_build(*a, **k)]
        return built[0]
    real_make_step = train_loop.make_train_step

    def timed_train(**kw):
        """train() alone, timed to its last device operation; each training
        step between two CUDA events, recorded as the host issues it."""
        events = cli_steps.setdefault(kw["start_epoch"], [])

        def make_timed_step(*a, **k):
            step = real_make_step(*a, **k)

            def timed_step(state, batch):
                ends = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                ends[0].record()
                out = step(state, batch)
                ends[1].record()
                events.append(ends)
                return out
            return timed_step

        t0 = time.perf_counter()
        with mock.patch.object(train_loop, "make_train_step", make_timed_step):
            state = real_train(**kw)
        torch.cuda.synchronize()
        cli_train_s[kw["start_epoch"]] = time.perf_counter() - t0
        return state

    def capturing_load(path, state=None):
        """load_checkpoint, keeping what the resume restored."""
        out = real_load(path, state)
        if state is not None:
            restored["step"] = out["state"].step
            restored["moments"] = {
                i: {k: v.detach().cpu().clone() for k, v in st.items()}
                for i, st in out["state"].optimizer.adamax.state_dict()["state"].items()}
        return out

    def run_mode(label: str, argv) -> None:
        _build.reset_launches()
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        cli_wall[label] = time.perf_counter() - t0
        cli_launches[label] = dict(_build.LAUNCHES)
        log(f"cli: {label}: {cli_wall[label]:.2f} s wall; kernel launches "
            f"{cli_launches[label]}")

    here = os.getcwd()
    with tempfile.TemporaryDirectory() as work, ExitStack() as stack:
        stack.enter_context(mock.patch.object(cli, "train", timed_train))
        stack.enter_context(mock.patch.object(cli, "load_checkpoint", capturing_load))
        stack.enter_context(mock.patch.object(cli, "build_model", capturing_build))
        roots = [make_synthetic_root(work, split=split, num_images=n_img,
                                     num_questions=n_q, num_objs=OBJS, v_dim=V_DIM,
                                     vocab_size=NTOKEN, num_answers=ANS, q_len=Q_LEN,
                                     c_len=C_LEN, seed=seed)
                 for split, n_img, n_q, seed in (("train2014", CLI_IMAGES, CLI_TRAIN_Q, 4),
                                                 ("val2014", CLI_IMAGES // 2, CLI_VAL_Q, 5))]
        root = roots[0]
        # the frozen GloVe table CONFIGS.md's commands load: a 300-d line for
        # each word of the synthetic vocabulary in id order (its four
        # specials are the table's zero rows)
        glove = os.path.join(work, "glove.6B.300d.txt")
        t0 = time.perf_counter()
        write_glove(glove, [w for w in Vocab.load(root["vocab_path"]).words
                            if w not in Vocab.SPECIALS], EMBED, seed=6)
        log(f"cli: wrote {glove} ({os.path.getsize(glove) / 2 ** 20:.1f} MiB) in "
            f"{time.perf_counter() - t0:.2f} s")
        argv = ["--vocab_path", root["vocab_path"], "--ans_path", root["ans_path"],
                "--load_path", root["annot"], "--feature_path", root["feature_root"],
                "--pretrained_embed_path", glove, "--comment", "mtl",
                "--encoder_type", "base", "--predictor_type", "base-cap",
                "--decoder_type", "butd", "--select_path", "vqa-e", "--use_mtl", "1",
                "--use_pallas", "1", "--feature_dtype", "int8",
                "--train_dtype", "bfloat16", "--length_bucket", "1",
                "--embed_dim", str(EMBED), "--hidden_dim", str(HIDDEN),
                "--decoder_hidden_dim", str(HIDDEN), "--v_dim", str(V_DIM),
                "--c_len", str(C_LEN), "--batch_size", str(TRAIN_BATCH),
                "--batches", str(CLI_STEPS), "--seed", str(RUN_SEED)]
        out = os.path.join(work, "checkpoint", "mtl")
        os.chdir(work)
        stack.callback(os.chdir, here)
        run_mode("train", argv + ["--mode", "train", "--epoches", "1"])
        for name in TRAIN_KERNELS:
            require(cli_launches["train"][name] > 0, f"--mode train never launched {name}")
        saved = torch.load(os.path.join(out, "epoch_0.ckpt"), weights_only=True)
        table = built[0].encoder.embedding.table
        in_ckpt = [k for k in saved["model"] if "embedding" in k]
        log(f"cli: the frozen GloVe table {tuple(table.shape)} {table.dtype} on "
            f"{table.device}; embedding keys in epoch_0.ckpt: {in_ckpt}")
        require(table.device.type == "cuda" and table.shape == (NTOKEN, EMBED),
                "the GloVe table is not on the card")
        require(not in_ckpt, "the frozen GloVe table went into the checkpoint")
        del table
        run_mode("resume", argv + ["--mode", "train", "--start_epoch", "1",
                                   "--epoches", "2"])
        for name in TRAIN_KERNELS:
            require(cli_launches["resume"][name] > 0, f"the resume never launched {name}")
        same = restored["step"] == saved["step"] == CLI_STEPS and all(
            torch.equal(restored["moments"][i][k], saved["optimizer"]["state"][i][k])
            for i in saved["optimizer"]["state"] for k in ("exp_avg", "exp_inf", "step"))
        log(f"cli: resume restored step {restored['step']} (saved {saved['step']}) and "
            f"{len(restored['moments'])} parameters' Adamax moments, equal to the "
            f"saved ones: {same}")
        require(same, "the resume did not restore the saved step and moments")
        resumed = torch.load(os.path.join(out, "epoch_1.ckpt"), weights_only=True)
        require(resumed["step"] == 2 * CLI_STEPS, f"epoch_1.ckpt at step {resumed['step']}")
        run_mode("val", argv + ["--mode", "val"])
        scores = np.load(os.path.join(out, "valid", "scores.npy"))
        require(scores.shape == (CLI_VAL_Q,) and np.isfinite(scores).all(),
                f"--mode val scored {scores.shape} questions")
        run_mode("decode", argv + ["--mode", "decode", "--decode_dtype", "bfloat16"])
        for name in DECODE_KERNELS:
            require(cli_launches["decode"][name] > 0, f"--mode decode never launched {name}")
        with open(os.path.join(out, "decode.txt")) as f:
            cli_captions = [line for line in f.read().split("\n") if line]
        require(len(cli_captions) == CLI_VAL_Q,
                f"decode.txt holds {len(cli_captions)} captions")
        log(f"cli: decode.txt first captions {cli_captions[:2]!r}")
    for start_epoch, label in ((0, "train"), (1, "resume")):
        events = cli_steps[start_epoch]
        require(len(events) == CLI_STEPS, f"--mode {label} ran {len(events)} steps")
        loop_s = events[0][0].elapsed_time(events[-1][1]) / 1e3
        steps_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
        samples = CLI_STEPS * TRAIN_BATCH
        log(f"time cli --mode {label}: {cli_wall[label]:.2f} s wall (model build, data, "
            f"{CLI_STEPS} steps of B={TRAIN_BATCH}, validation of {CLI_VAL_Q} questions, "
            f"checkpoints); train() {cli_train_s[start_epoch]:.2f} s, the wall rate of "
            f"the epoch with its validation and saves {samples / cli_train_s[start_epoch]:.1f}"
            f" samples/s; the step loop (first step's start to last step's end on the "
            f"card, the feed between steps included) {loop_s:.3f} s, "
            f"{samples / loop_s:.1f} samples/s; the steps alone (each from its start "
            f"to its end on the card) {steps_s:.3f} s, {samples / steps_s:.1f} samples/s, "
            f"per step {[round(a.elapsed_time(b), 2) for a, b in events]} ms [{card}]")
    log(f"time cli --mode val: {cli_wall['val']:.2f} s wall; --mode decode (bf16, "
        f"k=3, c_len={C_LEN}): {cli_wall['decode']:.2f} s wall, "
        f"{CLI_VAL_Q / cli_wall['decode']:.1f} captions/s [{card}]")
    cli_total = {k: sum(c[k] for c in cli_launches.values()) for k in _build.LAUNCHES}
    built.clear()

    # -- 14. ReGAT training (config 5) and GCN-LSTM -------------------------
    phase("14 ReGAT training, GCN-LSTM")
    torch.cuda.empty_cache()

    def device_batch(b):
        """A Loader batch's model inputs on the card, token ids as int64."""
        keys = ("q", "c", "cap_len", "c_all", "cap_len_all", "a", "img", "img_q",
                "img_scale", "graph")
        tokens = ("q", "c", "cap_len", "c_all", "cap_len_all")
        return {k: torch.from_numpy(b[k]).to(dev).to(
            torch.long if k in tokens else None) for k in keys if k in b}

    with tempfile.TemporaryDirectory() as root:
        make_synthetic_root(root, split="train2014", num_images=64,
                            num_questions=TRAIN_BATCH * 16, num_objs=OBJS, v_dim=V_DIM,
                            vocab_size=NTOKEN, num_answers=ANS, q_len=Q_LEN, c_len=C_LEN,
                            seed=7)
        host = {}
        for kind, bucket in (("vqa", False), ("vqa-e", True)):
            ds = set_dataset(os.path.join(root, "annot"), os.path.join(root, "features"),
                             ANS, graph_path=os.path.join(root, "graphs"), is_train=True,
                             dataset_type=kind, feature_mode="int8")
            host[kind] = list(itertools.islice(
                Loader(ds, TRAIN_BATCH, shuffle=True, drop_last=True, length_bucket=bucket),
                TRAIN_STEPS))
    regat_batches = [device_batch(b) for b in host["vqa"]]
    lstm_batches = [device_batch(b) for b in host["vqa-e"]]
    require(len(regat_batches) == len(lstm_batches) == TRAIN_STEPS
            and all("graph" in b for b in regat_batches + lstm_batches),
            "the loader gave too few batches or no graphs")

    def trainer(dims_, seed):
        model_ = set_model(**dims_, use_pallas=True, generator=torch.Generator().manual_seed(seed))
        state_ = TrainState(model_, make_optimizer(model_, lr=TRAIN_LR, max_norm=TRAIN_CLIP),
                            seed=RUN_SEED)
        return model_, state_, make_train_step(model_, state_.optimizer, compute_dtype=bf16)

    # config 5: spatial corr-GCN, one layer, bf16 over f32 masters. Its only
    # loss is the VQA BCE behind the head's trailing ReLU (the reference's
    # FCNet): on random labels at lr 2e-3 every logit reaches 0 within a
    # few steps, where the loss stays at ln 2 per answer and the gradient is
    # 0 (phase 7's VQA loss does the same), so the repeated batch trains
    # from the fresh weights, before the Loader steps
    regat_m, regat_state, regat_step = trainer(REGAT_DIMS, 8)
    _build.reset_launches()
    repeated = [regat_step(regat_state, regat_batches[0])["loss"] for _ in range(REPEAT_STEPS)]
    metrics = [regat_step(regat_state, b) for b in regat_batches]
    torch.cuda.synchronize()
    regat_train_launches = dict(_build.LAUNCHES)
    repeated = [x.item() for x in repeated]
    losses = [m["loss"].item() for m in metrics]
    log(f"regat train: one batch of B={TRAIN_BATCH} {REPEAT_STEPS} times, then "
        f"{TRAIN_STEPS} Loader steps, with spatial graphs through make_train_step "
        f"(config 5, bf16 over f32 masters, use_pallas): losses "
        f"{[round(x, 4) for x in repeated]}, then {[round(x, 4) for x in losses]} "
        f"(ln 2 x {ANS} answers = {math.log(2) * ANS:.4f}); kernel launches "
        f"{regat_train_launches}")
    require(all(map(math.isfinite, repeated + losses)), "non-finite ReGAT training loss")
    require(repeated[-1] < repeated[0], "the repeated ReGAT batch's loss did not fall")

    # GCN-LSTM: the relation encoder with the BUTD decoder, use_mtl
    lstm, lstm_state, lstm_step = trainer(LSTM_DIMS, 9)
    decoder_steps = [b["c"].shape[1] - 1 for b in lstm_batches]
    _build.reset_launches()
    metrics = [lstm_step(lstm_state, b) for b in lstm_batches]
    torch.cuda.synchronize()
    lstm_train_launches = dict(_build.LAUNCHES)
    losses = [m["loss"].item() for m in metrics]
    log(f"gcn-lstm train: {TRAIN_STEPS} Loader steps of B={TRAIN_BATCH} (decoder steps "
        f"{decoder_steps}; use_mtl, dropout 0.5 / 0.2, use_pallas, bf16 over f32 masters); "
        f"losses {[round(x, 4) for x in losses]}, VQA "
        f"{[round(m['train/loss'].item(), 4) for m in metrics]}, caption "
        f"{[round(m['train/cap/loss'].item(), 4) for m in metrics]}; kernel launches "
        f"{lstm_train_launches}")
    require(all(map(math.isfinite, losses)), "non-finite GCN-LSTM training loss")
    require(lstm_train_launches["decode_att_fwd"] == sum(decoder_steps)
            and lstm_train_launches["decode_att_bwd"] == sum(decoder_steps),
            "GCN-LSTM: decode_att_fwd / _bwd did not run once per decoder step")
    require(lstm_train_launches["decode_att_dvp"] == TRAIN_STEPS,
            "GCN-LSTM: decode_att_dvp did not run once per training step")
    grads_against_plain(lstm, lstm_batches[1], LSTM_GRAD_PREFIXES, "gcn-lstm")

    # a bf16 GCN-LSTM beam decode of the ReGAT requests (int8 feed, graphs)
    lstm_serve = set_model(**LSTM_DIMS, use_pallas=True).to(device=dev, dtype=bf16).eval()
    lstm_serve.load_state_dict(lstm.state_dict())
    lstm_beam = make_beam_search(lstm_serve, BEAM_K, C_LEN, vocab.start, vocab.end,
                                 fused_vocab=True)
    with torch.inference_mode():
        _build.reset_launches()
        lstm_decoded = [lstm_beam(regat_requests[0])]
        torch.cuda.synchronize()
        lstm_dec_launches = dict(_build.LAUNCHES)
        tokens, scores = lstm_decoded[0]
        require(tokens.shape == (SERVE_BATCH, BEAM_K, C_LEN)
                and bool(torch.isfinite(scores).all())
                and bool(((tokens >= 0) & (tokens < NTOKEN)).all())
                and bool((scores[:, :-1] >= scores[:, 1:]).all()),
                "GCN-LSTM beams are not well formed")
        with ExitStack() as stack:
            plain_kernels(stack, *kernel_modules)
            lstm_plain = [lstm_beam(regat_requests[0])]
        log(f"gcn-lstm decode: one request of B={SERVE_BATCH} with spatial graphs through "
            f"make_beam_search(k={BEAM_K}, fused_vocab=True), bf16; kernel launches "
            f"{lstm_dec_launches}")
        compare_beams("every kernel on its plain version (GCN-LSTM)", lstm_decoded,
                      lstm_plain, vocab.start)
    for name in ("gcn_chain_fused", "gru_v2", "vocab_topk_lse"):
        require(lstm_dec_launches[name] > 0, f"the GCN-LSTM decode never launched {name}")
    del lstm_serve, lstm_beam, lstm_decoded, lstm_plain

    # the step at B=4096, for information, with its peak memory
    x_q, scale = int8_feed(TRAIN_TIME_BATCH * OBJS, V_DIM)
    big = {"q": torch.randint(0, NTOKEN, (TRAIN_TIME_BATCH, Q_LEN), device=dev, generator=gen),
           "a": (torch.randint(0, 4, (TRAIN_TIME_BATCH, ANS), device=dev, generator=gen)
                 * (torch.rand(TRAIN_TIME_BATCH, ANS, device=dev, generator=gen) < 2e-3)) / 3.0,
           "img_q": x_q.view(TRAIN_TIME_BATCH, OBJS, V_DIM),
           "img_scale": scale.view(TRAIN_TIME_BATCH, OBJS).float(),
           "graph": torch.randint(0, 12, (TRAIN_TIME_BATCH, OBJS, OBJS), device=dev,
                                  generator=gen, dtype=torch.int32)}
    captioned = dict(big, c=torch.randint(0, NTOKEN - 4, (TRAIN_TIME_BATCH, C_LEN), device=dev,
                                          generator=gen),
                     cap_len=torch.full((TRAIN_TIME_BATCH,), C_LEN, device=dev))
    for label, step_fn, st, b in (("config 5 (ReGAT)", regat_step, regat_state, big),
                                  ("GCN-LSTM", lstm_step, lstm_state, captioned)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step_fn(st, b)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ms = time_ms(lambda: step_fn(st, b), 2)
        log(f"time {label} train step B={TRAIN_TIME_BATCH} int8 feed, spatial graphs, bf16 "
            f"over f32 masters, use_pallas: {ms:.2f} ms ({TRAIN_TIME_BATCH / ms * 1e3:.1f} "
            f"samples/s); peak memory allocated {peak / 2 ** 30:.2f} GiB "
            f"({(peak - base) / 2 ** 30:.2f} above the {base / 2 ** 30:.2f} held before the "
            f"step) [{card}]")
    del regat_m, regat_state, regat_step, lstm, lstm_state, lstm_step, big, captioned
    del x_q, scale, regat_batches, lstm_batches
    torch.cuda.empty_cache()

    # the entry point on config 5's flags: train one epoch, then --mode val
    with tempfile.TemporaryDirectory() as work, ExitStack() as stack:
        roots = [make_synthetic_root(work, split=split, num_images=n_img,
                                     num_questions=n_q, num_objs=OBJS, v_dim=V_DIM,
                                     vocab_size=NTOKEN, num_answers=ANS, q_len=Q_LEN,
                                     c_len=C_LEN, seed=seed)
                 for split, n_img, n_q, seed in (
                     ("train2014", REGAT_CLI_IMAGES, REGAT_CLI_TRAIN_Q, 10),
                     ("val2014", REGAT_CLI_IMAGES // 2, REGAT_CLI_VAL_Q, 11))]
        root = roots[0]
        argv = ["--vocab_path", root["vocab_path"], "--ans_path", root["ans_path"],
                "--load_path", root["annot"], "--feature_path", root["feature_root"],
                "--graph_path", root["graph_root"], "--pretrained_embed_path", "",
                "--comment", "regat", "--encoder_type", "relation", "--conv_type", "corr",
                "--conv_layer", "1", "--predictor_type", "base", "--decoder_type", "none",
                "--select_path", "vqa", "--use_pallas", "1", "--feature_dtype", "int8",
                "--train_dtype", "bfloat16", "--embed_dim", str(EMBED),
                "--hidden_dim", str(HIDDEN), "--v_dim", str(V_DIM),
                "--batch_size", str(TRAIN_BATCH), "--seed", str(RUN_SEED)]
        out = os.path.join(work, "checkpoint", "regat")
        os.chdir(work)
        stack.callback(os.chdir, here)
        run_mode("regat_train", argv + ["--mode", "train", "--epoches", "1"])
        saved = torch.load(os.path.join(out, "epoch_0.ckpt"), weights_only=True)
        steps = REGAT_CLI_TRAIN_Q // TRAIN_BATCH
        require(saved["step"] == steps, f"config 5's epoch_0.ckpt at step {saved['step']}")
        require(any(k.startswith("encoder.spatial_encoder.conv0.") for k in saved["model"]),
                "config 5's checkpoint holds no GCN")
        os.remove(os.path.join(out, "valid", "scores.npy"))
        run_mode("regat_val", argv + ["--mode", "val"])
        scores = np.load(os.path.join(out, "valid", "scores.npy"))
        require(scores.shape == (REGAT_CLI_VAL_Q,) and np.isfinite(scores).all(),
                f"config 5's --mode val scored {scores.shape} questions")
        require(cli_launches["regat_val"]["gcn_chain_fused"] > 0,
                "config 5's --mode val never launched gcn_chain_fused")
    log(f"time cli config 5: --mode train {cli_wall['regat_train']:.2f} s wall (model "
        f"build, data, {steps} steps of B={TRAIN_BATCH}, validation of {REGAT_CLI_VAL_Q} "
        f"questions, checkpoints), --mode val {cli_wall['regat_val']:.2f} s wall [{card}]")

    # -- 15. Q-Relevant: q-cap serving, the select step, config 4 ----------
    phase("15 Q-Relevant")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        made = make_synthetic_root(root, split="train2014", num_images=64,
                                   num_questions=TRAIN_BATCH * 8, num_objs=OBJS, v_dim=V_DIM,
                                   vocab_size=NTOKEN, num_answers=ANS, q_len=Q_LEN,
                                   c_len=C_LEN, seed=12)
        where = (made["annot"], made["feature_root"], ANS)
        # the serving feed: one selected caption a question, int8 features
        serve_set = set_dataset(*where, caption_id_path=made["select_path"], is_train=True,
                                dataset_type="select", feature_mode="int8")
        host_serve = list(itertools.islice(Loader(serve_set, SERVE_BATCH, drop_last=True),
                                           SERVE_REQUESTS))
        # the max-relevance feed: every caption of a question, dense features
        all_set = set_dataset(*where, caption_id_path=made["select_path"], is_train=True,
                              dataset_type="all")
        host_select = list(itertools.islice(
            Loader(all_set, TRAIN_BATCH, shuffle=True, drop_last=True,
                   batch_method="get_batch_all", length=len(all_set.questions)),
            TRAIN_STEPS))
    require(len(host_serve) == SERVE_REQUESTS and len(host_select) == TRAIN_STEPS,
            "the Q-Relevant loaders gave too few batches")
    qcap_requests = [device_batch(b) for b in host_serve]
    for r in qcap_requests:
        r["img_scale"] = r["img_scale"].to(bf16)
    select_batches = [device_batch(b) for b in host_select]
    require(all(b["c_all"].shape == (TRAIN_BATCH, N_CAP, C_LEN) for b in select_batches),
            "the all-captions feed's candidates are not [B, 5, c_len]")

    # (a) q-cap serving on the int8 feed
    qcap = set_model(**QCAP_DIMS, use_pallas=True, generator=torch.Generator().manual_seed(13))
    qcap = qcap.to(device=dev, dtype=bf16).eval()
    with torch.inference_mode():
        _build.reset_launches()
        served = [qcap.forward_vqa(r) for r in qcap_requests]
        torch.cuda.synchronize()
        qcap_launches = dict(_build.LAUNCHES)
        log(f"q-cap serve: {SERVE_REQUESTS} requests of B={SERVE_BATCH} (int8 feed, one "
            f"selected caption each) through VQAModel.forward_vqa; kernel launches "
            f"{qcap_launches}")
        for name, per_request in (("gru_v2", 1), ("dequant_matmul_gated_logits", 1),
                                  ("attended_int8", 1), ("dequant_matmul", 0),
                                  ("pool_int8", 0)):
            require(qcap_launches[name] == per_request * SERVE_REQUESTS,
                    f"q-cap serving launched {name} {qcap_launches[name]} times, not "
                    f"{per_request} a request")
        for score, label, target in served:
            require(score.shape == (SERVE_BATCH, ANS) and label.shape == (SERVE_BATCH,)
                    and bool(torch.isfinite(score).all()), "q-cap forward_vqa outputs")
        # the head's output is sigmoid(cls_net(...)); at these random weights
        # cls_net's logits are ~1e-3, so every bf16 probability rounds to
        # 0.5 and holds nothing to compare: the logits before the sigmoid
        # are held too
        logits = []
        hook = qcap.predictor.cls_net.register_forward_hook(
            lambda mod, inp, out: logits.append(out.float()))

        def outputs():
            logits.clear()
            probs = torch.cat([qcap(r)[0] for r in qcap_requests]).float()
            return probs, torch.cat(logits)

        got, got_logits = outputs()
        with ExitStack() as stack:
            plain_kernels(stack, *kernel_modules)
            want, want_logits = outputs()
        hook.remove()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        rel_logits = ((got_logits - want_logits).abs().max()
                      / want_logits.abs().max()).item()
        log(f"q-cap serve: against the same model on plain versions, max abs err / max "
            f"|value| of the outputs (sigmoid probabilities, range "
            f"[{want.min().item():.4f}, {want.max().item():.4f}]) {rel:.3g} and of the "
            f"logits before the sigmoid (max |logit| {want_logits.abs().max().item():.3g}) "
            f"{rel_logits:.3g} (tolerance {LOGIT_REL_TOL:g}); argmax agreement "
            f"{(got_logits.argmax(1) == want_logits.argmax(1)).float().mean().item():.4f}")
        require(bool(torch.isfinite(got).all() and torch.isfinite(got_logits).all())
                and rel <= LOGIT_REL_TOL and rel_logits <= LOGIT_REL_TOL,
                "q-cap outputs disagree with the plain versions")
        x_q, scale = int8_feed(QCAP_TIME_BATCH * OBJS, V_DIM)
        big = {"q": torch.randint(0, NTOKEN, (QCAP_TIME_BATCH, Q_LEN), device=dev,
                                  generator=gen),
               "img_q": x_q.view(QCAP_TIME_BATCH, OBJS, V_DIM),
               "img_scale": scale.view(QCAP_TIME_BATCH, OBJS),
               "c": torch.randint(0, NTOKEN - 4, (QCAP_TIME_BATCH, C_LEN), device=dev,
                                  generator=gen),
               "cap_len": torch.randint(2, C_LEN + 1, (QCAP_TIME_BATCH,), device=dev,
                                        generator=gen)}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = (time_ms(lambda: qcap(big), 3) + time_ms(lambda: qcap(big), 3)) / 2
        peak = torch.cuda.max_memory_allocated()
        log(f"time q-cap forward B={QCAP_TIME_BATCH} int8 feed, bf16, use_pallas: {ms:.3f} ms "
            f"({QCAP_TIME_BATCH / ms * 1e3:.1f} questions/s); peak memory allocated "
            f"{peak / 2 ** 30:.2f} GiB ({(peak - base) / 2 ** 30:.2f} above the "
            f"{base / 2 ** 30:.2f} held before) [{card}]")
    del qcap, served, got, want, got_logits, want_logits, big, x_q, scale

    # (b) the max-relevance step: q-cap, BUTD, use_mtl, bf16 over f32 masters
    sel_model = set_model(**SELECT_DIMS, use_pallas=True,
                          generator=torch.Generator().manual_seed(14))
    sel_state = TrainState(sel_model, make_optimizer(sel_model, lr=TRAIN_LR,
                                                     max_norm=TRAIN_CLIP), seed=RUN_SEED)
    sel_step = make_train_select_step(sel_model, sel_state.optimizer, compute_dtype=bf16)
    _build.reset_launches()
    metrics = [sel_step(sel_state, b) for b in select_batches]
    repeated = [sel_step(sel_state, select_batches[0])["loss"] for _ in range(REPEAT_STEPS)]
    torch.cuda.synchronize()
    select_launches = dict(_build.LAUNCHES)
    losses = [m["loss"].item() for m in metrics]
    repeated = [x.item() for x in repeated]
    log(f"select train: {TRAIN_STEPS} Loader steps of B={TRAIN_BATCH} questions x {N_CAP} "
        f"candidate captions through make_train_select_step (q-cap, BUTD, use_mtl, dropout "
        f"0.5 / 0.2, use_pallas, bf16 over f32 masters): losses "
        f"{[round(x, 4) for x in losses]}, VQA {[round(m['train/loss'].item(), 4) for m in metrics]}"
        f", caption {[round(m['train/cap/loss'].item(), 4) for m in metrics]}; one batch "
        f"{REPEAT_STEPS} more times: {[round(x, 4) for x in repeated]}; kernel launches "
        f"{select_launches}")
    require(all(map(math.isfinite, losses + repeated)), "non-finite select training loss")
    require(repeated[-1] < repeated[0], "the repeated select batch's loss did not fall")
    require(not any(select_launches.values()),
            f"the select step launched kernels: {select_launches}")

    def select_grads(dtype):
        out = backward_step(sel_model, select_batches[1], RUN_SEED, 0, dtype,
                            loss_fn=get_select_loss)
        # the attention linears' biases only shift logits under a softmax
        return out["loss"].item(), {n: p.grad.detach().clone()
                                    for n, p in sel_model.named_parameters()
                                    if not n.endswith("attention.linear.bias")}

    for dtype, tol in ((None, GRAD_F32_TOL), (bf16, GRAD_BF16_TOL)):
        label = "bf16" if dtype is bf16 else "f32"
        _build.reset_launches()
        k_loss, k_grads = select_grads(dtype)
        with ExitStack() as stack:
            plain_kernels(stack, *kernel_modules)
            p_loss, p_grads = select_grads(dtype)
        require(not any(_build.LAUNCHES.values()), "a select step launched a kernel")
        rel = {n: ((k_grads[n] - p_grads[n]).abs().max()
                   / p_grads[n].abs().max().clamp_min(1e-30)).item() for n in p_grads}
        worst = max(rel, key=rel.get)
        loss_rel = abs(k_loss - p_loss) / abs(p_loss)
        log(f"select train: {label} step on B={TRAIN_BATCH}, use_pallas against plain "
            f"versions: loss {k_loss:.6f} vs {p_loss:.6f} (rel {loss_rel:.3g}); worst max "
            f"|grad diff| / max |plain grad| over {len(rel)} parameters {worst} "
            f"{rel[worst]:.3g} (tolerance {tol:g})")
        require(loss_rel <= tol and rel[worst] <= tol,
                f"the {label} select step disagrees with the plain versions")
    del k_grads, p_grads

    # the step at B=2048 (10240 candidate rows), with its optimizer update
    def select_batch(batch):
        return {"img": torch.randn(batch, OBJS, V_DIM, device=dev, generator=gen),
                "q": torch.randint(0, NTOKEN, (batch, Q_LEN), device=dev, generator=gen),
                "a": (torch.randint(0, 4, (batch, ANS), device=dev, generator=gen)
                      * (torch.rand(batch, ANS, device=dev, generator=gen) < 2e-3)) / 3.0,
                "c_all": torch.randint(0, NTOKEN - 4, (batch, N_CAP, C_LEN), device=dev,
                                       generator=gen),
                "cap_len_all": torch.randint(2, C_LEN + 1, (batch, N_CAP), device=dev,
                                             generator=gen)}

    sel_batch_size = SELECT_TIME_BATCH
    big = select_batch(sel_batch_size)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sel_step(sel_state, big)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if peak > SELECT_PEAK_LIMIT:
        log(f"select train: the B={sel_batch_size} step's peak {peak / 2 ** 30:.2f} GiB "
            f"passes {SELECT_PEAK_LIMIT / 2 ** 30:.0f} GiB: timing B={sel_batch_size // 2}")
        sel_batch_size //= 2
        del big
        big = select_batch(sel_batch_size)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sel_step(sel_state, big)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    ms = (time_ms(lambda: sel_step(sel_state, big), 2)
          + time_ms(lambda: sel_step(sel_state, big), 2)) / 2
    log(f"time select train step B={sel_batch_size} ({sel_batch_size * N_CAP} candidate "
        f"rows; q-cap, BUTD, use_mtl, dense f32 feed, bf16 over f32 masters, with the "
        f"Adamax update): {ms:.2f} ms ({sel_batch_size / ms * 1e3:.1f} samples/s); peak "
        f"memory allocated {peak / 2 ** 30:.2f} GiB ({(peak - base) / 2 ** 30:.2f} above "
        f"the {base / 2 ** 30:.2f} held before the step) [{card}]")
    del sel_model, sel_state, sel_step, big, select_batches, metrics
    torch.cuda.empty_cache()

    # (c) config 4 as CONFIGS.md writes it, and its q-cap variant, through
    # the entry point: one epoch of a few B=512 steps, then --mode val
    with tempfile.TemporaryDirectory() as work, ExitStack() as stack:
        roots = [make_synthetic_root(work, split=split, num_images=n_img,
                                     num_questions=n_q, num_objs=OBJS, v_dim=V_DIM,
                                     vocab_size=NTOKEN, num_answers=ANS, q_len=Q_LEN,
                                     c_len=C_LEN, seed=seed)
                 for split, n_img, n_q, seed in (("train2014", CLI_IMAGES, CLI_TRAIN_Q, 15),
                                                 ("val2014", CLI_IMAGES // 2, CLI_VAL_Q, 16))]
        root = roots[0]
        glove = os.path.join(work, "glove.6B.300d.txt")
        write_glove(glove, [w for w in Vocab.load(root["vocab_path"]).words
                            if w not in Vocab.SPECIALS], EMBED, seed=6)
        argv = ["--vocab_path", root["vocab_path"], "--ans_path", root["ans_path"],
                "--load_path", root["annot"], "--feature_path", root["feature_root"],
                "--pretrained_embed_path", glove, "--encoder_type", "base",
                "--decoder_type", "base", "--train_strategy", "select",
                "--select_path", root["select_path"], "--use_pallas", "1",
                "--train_dtype", "bfloat16", "--embed_dim", str(EMBED),
                "--hidden_dim", str(HIDDEN), "--decoder_hidden_dim", str(HIDDEN),
                "--v_dim", str(V_DIM), "--c_len", str(C_LEN), "--batch_size", str(TRAIN_BATCH),
                "--batches", str(CLI_STEPS), "--seed", str(RUN_SEED)]
        os.chdir(work)
        stack.callback(os.chdir, here)
        for head in ("base-cap", "q-cap"):
            flags = argv + ["--predictor_type", head, "--comment", f"qrel_{head}"]
            out = os.path.join(work, "checkpoint", f"qrel_{head}")
            run_mode(f"config4_{head}_train", flags + ["--mode", "train", "--epoches", "1"])
            saved = torch.load(os.path.join(out, "epoch_0.ckpt"), weights_only=True)
            require(saved["step"] == CLI_STEPS,
                    f"config 4 ({head}): epoch_0.ckpt at step {saved['step']}")
            require(any(k.startswith("predictor.caption_embedding.") for k in saved["model"])
                    == (head == "q-cap"), f"config 4 ({head}): the checkpoint's head")
            require(not any("embedding.weight" in k and k.startswith("encoder.")
                            for k in saved["model"]),
                    f"config 4 ({head}): the frozen GloVe table went into the checkpoint")
            os.remove(os.path.join(out, "valid", "scores.npy"))
            run_mode(f"config4_{head}_val", flags + ["--mode", "val"])
            scores = np.load(os.path.join(out, "valid", "scores.npy"))
            require(scores.shape == (CLI_VAL_Q,) and np.isfinite(scores).all(),
                    f"config 4 ({head}): --mode val scored {scores.shape} questions")
            log(f"time cli config 4 ({head}, --train_strategy select): --mode train "
                f"{cli_wall[f'config4_{head}_train']:.2f} s wall (model build, data, "
                f"{CLI_STEPS} steps of B={TRAIN_BATCH} x {N_CAP} captions, validation of "
                f"{CLI_VAL_Q} questions, checkpoints), --mode val "
                f"{cli_wall[f'config4_{head}_val']:.2f} s wall, val score "
                f"{float(scores.mean()):.4f} [{card}]")
    # -- 16. data-parallel MTL training over two processes on the card ------
    phase("16 parallel")
    par_launches = parallel_phase(card, int8_feed, gen)
    torch.cuda.empty_cache()

    # -- 17. the host feed: the native library, a packed store, serving -----
    phase("17 host feed")
    feed_launches = host_feed_phase(card, dev, host_build_s, cli_captions)
    torch.cuda.empty_cache()

    # -- 18. the measurement entry points: the bench, entry(), the scripts --
    phase("18 measurement")
    bench_launches = measurement_phase(card, forward_ms)
    torch.cuda.empty_cache()

    # -- 19. the convergence study: the backward kernels train 300 steps ----
    phase("19 convergence")
    conv_launches = convergence_phase(card)
    torch.cuda.empty_cache()

    # -- 20. the accuracy-gate runner on a synthetic data root -------------
    phase("20 gate")
    gate_phase(card)

    phase("end")
    log(f"total wall time {time.monotonic() - t_start:.1f} s")

    paths = {"vqa": launches, "decode": dec_launches, "train": train_launches,
             "regat": regat_launches, "regat_no_int8": bf16_launches,
             "serve_h1000": h1000_launches, "train_h500": h500_launches,
             "regat_train": regat_train_launches, "gcn_lstm_train": lstm_train_launches,
             "gcn_lstm_decode": lstm_dec_launches, "qcap_serve": qcap_launches,
             "select_train": select_launches, "parallel_rank0": par_launches,
             "host_feed": feed_launches, "bench": bench_launches,
             "convergence": conv_launches,
             **{f"cli_{k}": v for k, v in cli_launches.items()}, "cli": cli_total}
    entries = [{"name": name, "route": "cuda", **KERNELS[name],
                "launches": paths[MAIN_PATH[name]][name],
                "launches_by_path": {p: n[name] for p, n in paths.items()},
                "max_abs_err": max_err[name],
                "ms": times[name][0], "plain_ms": times[name][1],
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "bound_term": bounds[name][2],
                # torch._int_mm gives the int32 product of the int8 GEMM
                # alone, cuBLAS's bf16 matmul the product of dequant_matmul
                # and vocab_topk_lse alone, cuDNN's GRU the function of
                # gru_last_state_v3; no single PyTorch call computes any
                # other of these
                "library_ms": library.get(name), **extra.get(name, {})}
               for name in KERNELS]
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
