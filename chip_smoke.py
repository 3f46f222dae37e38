#!/usr/bin/env python3
"""On-card smoke test of hivemind_tpu_torch: builds the port's Hopper kernels,
holds each against its plain PyTorch version at the shapes of the paths that run
it, then drives eighteen paths and checks each against the CPU, the local path or
the exact result:
- serving: two Llama-2-7B-width blocks (fp and int8 weight-only) through
  load_llama_blocks → ModuleBackend → TaskPool/Runtime, and two experts below the wgmma
  flash kernels' padded width through ModuleBackend, forward and backward: one of head_dim 32
  and one at TinyBERT's attention widths (head_dim 26, TMA's packed-heads view);
- decode: greedy generation and continuous batching of single-token steps through
  DecodeSessionManager's KV-cache sessions on the same blocks;
- remote: the same blocks served over the wire, in this process over loopback TCP
  (P2P → ConnectionHandler → TaskPool/Runtime and DecodeSessionManager, a
  RemoteExpert per block as the client): forward, decode and autograd backward,
  against the local path;
- swarm: the same blocks in three server processes found through the DHT (each a
  DHT peer with a Server; block 1 on two replicas) and a client of DHT,
  RemoteSequential and the client head in this process: forward, greedy decode,
  failover when a replica process is killed, and autograd backward, against the
  local path (in a thread of its own beside [collab]);
- relay: the relay tier: run_relay (the entry point) builds the port's relay daemon from
  source and advertises it in the DHT; a NATed server process with the same fp blocks
  registers there through its AutoRelay, and a client that knows it only through the DHT
  forwards and generates through the relay; then a server P2P and a client P2P each with
  a private daemon (the native transport) carry a lossless forward through its C++ AEAD;
- dmoe: the decentralized mixture of experts (BASELINE config 4: 64 ffn experts of
  width 1024, top-4, a [2048, 1024] batch) on server processes found through the DHT,
  fp32 and int8, with RemoteMixtureOfExperts as the client: beam search, forward and
  backward against a twin mixture, hot-expert replication to a late volunteer, a
  checkpoint restored in a fresh process, a killed server, the swarm monitor;
- averaging: DecentralizedAverager (BASELINE config 2: 8 peer processes, 100M float32
  parameters each made on the card, groups of 4, fp16 wire): three rounds held on the
  card to the exact group mean, GB/s per peer, a peer killed mid-round, and a late
  peer's verified state download (no kernel: the reduction is host numpy; it runs in a
  thread of its own beside [slice]);
- expert training: ModuleBackend.backward (one SGD step) on a Llama-2-7B-width block;
- ALBERT-base MLM training: make_train_step with AdamW at batch 32 × seq 512, in bf16 and in
  fp32 (all three fp32 flash passes on the tensor cores in 3xTF32);
- causal: the causal LM (CausalLMConfig.base(), GPT-2-small widths, vocab 32000) trained
  with AdamW at batch 8 × seq 1024 through the causal flash kernels in both directions;
- collab: collaborative ALBERT-base training (BASELINE config 3, examples/albert): four
  peer processes train one model through the DHT with the collaborative Optimizer and
  LAMB over two epochs, held to large-batch training; a fifth joins by downloading the
  state and trains a third with them.
- ring: ring attention over a mesh's sequence axis, four rank processes sharing the
  card over gloo, the flash kernel at every ring step, at Llama-2-7B widths (T 8192,
  causal) and ALBERT-base's, against plain fp32 attention and the whole-sequence
  kernel, forward and gradients; and a one-rank nccl mesh;
- slice: a mesh of four ranks (dp 2 x sp 2) as one swarm peer through SliceOptimizer,
  with a collaborative Optimizer peer, ALBERT-base with [collab]'s recipe, held to a
  single-rank step and to large-batch training;
- mesh_serving: the same blocks tensor-parallel over a serving mesh of 4 shards
  (MeshModuleBackend: one shard a card on a host of 4 cards, else all on one card), fp32
  and int8: prefill and merged greedy decode of 8 sessions against the single-device
  blocks, each card's memory against its shards, the window dequantize kernel, and a
  backward with an SGD step of every shard against the single-device backend; then every
  registered block and any mesh size: a Llama-2-70B-width block (8 KV heads) over 16
  shards, each KV head copied to two, fp32 and int8, prefill and merged decode;
  causal_transformer over 3 shards (uneven heads and ffn) and transformer and ffn over 4,
  forward and backward; det_dropout and nop forward, each against the single device;
- cli: the entry points as a user runs them, run_dht and run_server --mesh_devices
  <every card> as child processes, a RemoteSequential client generating through them, and
  run_top --serving --device rendering the served experts from the server's snapshots;
- chaos: the chaos soak (two trainers and an ffn expert server on the card under the
  default fault schedule) and run_blackbox rebuilding a peer's final round from its spool;
- sim: the swarm simulator's smoke scenario, twice at once on the card's host, with
  equal digests (host only: no kernel, no JAX).
Telemetry rides the serving and decode runs, as a server would arm it (the event-loop
watchdog, the device memory sampler, a ``/metrics`` exporter; over the wire the
connection handler opens a ``serving.request`` span around each request): ``[telemetry]``
holds its counters to exact counts and prints where the host time of a request and of a
decode step goes.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

The whole run must end within 1200 s on the card's host, whose speed varies by a third
from run to run: each kernel library builds as several ``nvcc`` processes at once, the
checkpoint is written meanwhile, the kernel checks draw their inputs a few cases ahead,
every child process forks from a server that imported torch and the package once, and
[swarm] and [averaging] run beside [collab] and [slice]. No kernel is timed while
another phase runs.

``--only mesh_serving,cli,chaos,sim`` runs those phases alone (after [build] and [checkpoint]),
e.g. on a host of four cards, where the mesh puts one shard on each. Such a partial
run checks and logs as a whole run does, but prints neither the kernels line nor
the ok line: it never reads as a whole run.

It exits non-zero, printing no result, when CUDA is unavailable, when the package
is not beside it, or when any phase fails (every phase runs; the failures are
listed at the end). The last line of its output is
``{"ok": true, "device": {...}}``; the line before it is the card's name and power
limit, and before that a JSON line with every kernel's launches, error and times.
Weights and requests are synthesized from fixed seeds; nothing is downloaded.
Needs no JAX and imports nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

SEED = 0
# Llama-2-7B widths (meta-llama/Llama-2-7b-hf config.json); depth cut from 32 to 2 layers
LLAMA2_7B = dict(hidden_size=4096, num_attention_heads=32, num_key_value_heads=32, intermediate_size=11008,
                 num_hidden_layers=2, rope_theta=10000.0, rms_norm_eps=1e-5, vocab_size=32000)
ALBERT_ATTENTION = (32, 512, 12, 64)  # ALBERT-base's [B, T, H, D] at batch 32, seq 512
# the causal LM's (CausalLMConfig.base(): GPT-2-small widths) [B, T, H, D] at batch 8 x seq 1024, causal
CAUSAL_BATCH, CAUSAL_SEQ = 8, 1024
CAUSAL_ATTENTION = (CAUSAL_BATCH, CAUSAL_SEQ, 12, 64)
EXPERT_TOKENS = 256  # [1, 256, 4096] through ModuleBackend.backward
EXPERT_ATTENTION = (1, EXPERT_TOKENS, 32, 128)  # that block's [B, T, H, D]
# the serving path's [B, T, H, D] (2000: a ragged tail tile; batch 4: the merged 512-long
# requests), head_dim 64 (the kernel's other width), ALBERT's and the expert backward's
FLASH_SHAPES = ([(1, t, 32, 128) for t in (512, 2048, 2000)] + [(4, 512, 32, 128), (2, 1000, 16, 64)]
                + [ALBERT_ATTENTION, EXPERT_ATTENTION, CAUSAL_ATTENTION])
# Flash vs its plain version. Each element's error within atol + rtol*scale, where an
# output's scale is sum_j p_j*|v_j| (the plain version run on |v|; it bounds the output,
# and the rounding of the terms). The bf16 kernel rounds each p_j to bf16 and both
# versions round the output, so with u = 2^-8 (bf16's unit roundoff) an exact
# computation errs by at most 3u*scale. The largest error stays within max_abs, and the
# error's norm over the reference's norm within rel_l2 (about u for bf16): what catches
# a kernel that is a few percent off on the many small outputs, each within its own limit.
# fp16 is held the same way with fp16's unit roundoff, u = 2^-11: the wgmma kernel rounds
# each p_j to fp16 and both versions round the output, so the same derivation gives
# 3u*scale and a norm ratio of u; the SIMT kernel (fp32 math, the output rounded once)
# errs less. Its cap is one fp16 ulp of an output in [4, 8).
BF16_UNIT_ROUNDOFF = 2.0**-8
FP16_UNIT_ROUNDOFF = 2.0**-11
FLASH_TOL = {
    "bfloat16": dict(atol=1e-5, rtol=3 * BF16_UNIT_ROUNDOFF, max_abs=2e-2, rel_l2=BF16_UNIT_ROUNDOFF),
    "float16": dict(atol=1e-5, rtol=3 * FP16_UNIT_ROUNDOFF, max_abs=2.0**-8, rel_l2=FP16_UNIT_ROUNDOFF),
    "float32": dict(atol=1e-4, rtol=0.0, max_abs=1e-4, rel_l2=1e-4),
}
LSE_TOL = dict(atol=1e-4, rtol=0.0, max_abs=1e-4, rel_l2=1e-5)  # lse is fp32 on both paths
MANTISSA_BITS = {"bfloat16": 7, "float16": 10, "float32": 23}
# Beyond FLASH_SHAPES, each held and timed like them: (shape, dtype, causal). The
# head_dim-32 expert's attention ([head_dim32] below), head dims 16, 32, 80, 96 and
# 256, fp16 at a Llama request's shape, and B*H = 65536, on the wgmma design's 4-D view
# (bf16 and fp16 at a head_dim that is a multiple of 8); Phi-2's and Gemma-7B's
# attention widths at a 2048-token request (microsoft/phi-2 config.json: hidden 2560, 32
# heads, head_dim 80; google/gemma-7b config.json: 16 heads of head_dim 256). Then the
# packed-heads view (16-bit head dims that are not a multiple of 8, H*D a multiple of 8):
# head dim 20 in bf16 and fp16, the TinyBERT-width expert's attention ([head_dim32]'s
# second expert: huawei-noah/TinyBERT_General_4L_312D config.json, hidden 312, 12 heads
# of 26), an odd head dim (rows 2-byte aligned), 196 (padded to 256, its last region
# partly past it) and a ragged T of 333; and bf16 at head dim 20 with H*D = 100, which no
# TMA view takes, on the SIMT design (as fp32, whose cases are FLASH_SHAPES').
FLASH_EXTRA_CASES = [
    ((2, 64, 8, 32), "bfloat16", False), ((2, 1000, 16, 32), "bfloat16", True), ((2, 1000, 16, 16), "bfloat16", True),
    ((2, 1000, 16, 80), "bfloat16", False), ((1, 512, 8, 96), "bfloat16", True), ((1, 512, 4, 256), "float16", True),
    ((2, 1000, 16, 64), "float16", True), ((1, 2048, 32, 128), "float16", True),
    ((65536, 16, 1, 64), "bfloat16", True), ((32768, 16, 2, 32), "float16", False),
    ((2, 1000, 16, 20), "bfloat16", True), ((1, 2048, 32, 80), "bfloat16", True), ((1, 2048, 16, 256), "float16", True),
    ((2, 1000, 16, 20), "float16", True), ((4, 128, 12, 26), "bfloat16", False), ((2, 1000, 16, 25), "bfloat16", True),
    ((1, 512, 4, 196), "float16", True), ((3, 333, 12, 26), "bfloat16", True), ((2, 1000, 5, 20), "bfloat16", True),
    # with those, every instantiation of the packed forward (bf16 and fp16 at padded widths 64, 128 and 256)
    ((1, 512, 8, 100), "bfloat16", True), ((1, 512, 8, 100), "float16", False), ((1, 512, 4, 196), "bfloat16", False),
    # fp32 on the 3xTF32 forward beside FLASH_SHAPES' (ALBERT's, the served shapes, T 2000 at D = 128): head dim 20
    # (a multiple of 4, not of 8) and 100 (padded to 128, its columns past 100 zeros), with a ragged T; fp32 at
    # head dims the 3xTF32 kernels do not take (18, 256) stays on SIMT
    ((2, 1000, 16, 20), "float32", True), ((3, 333, 12, 100), "float32", True), ((2, 1000, 4, 18), "float32", True),
    ((1, 512, 4, 256), "float32", False),
]
# where the forward's planted fault is checked beside FLASH_SHAPES' ALBERT shape, and the
# backward's beside FAULTY_BWD_SHAPES': head dim 20 in bf16 on the packed-heads view. There
# too, every other head holds NaN, inf and -inf in every input (q, k, v, and dout in the
# backward), and the other heads' outputs of all three passes must stay within the limits:
# a neighbour's column left in a tile a product sums over (a resident tile's missed
# zeroing, a streamed tile's stray byte) turns a head's output NaN through 0 * inf.
FAULTY_PACKED = ((2, 1000, 16, 20), "bfloat16")
# views whose base is one element off 16-byte alignment, which TMA and the 3xTF32 kernels' 16-byte
# loads cannot read: the wrappers copy them first (bf16, head_dims 64, 32 and 20 with H*D = 160;
# fp32 at 64), or the SIMT kernel reads them through their strides (bf16 head dim 20 with H*D = 100)
UNALIGNED_CASES = [((2, 1000, 16, 64), True, "bfloat16"), ((2, 64, 8, 32), False, "bfloat16"),
                   ((2, 64, 8, 20), True, "bfloat16"), ((2, 64, 5, 20), True, "bfloat16"),
                   ((2, 1000, 16, 64), True, "float32")]
SERVING_TOL = 2e-2  # max relative error, card vs CPU (hivemind_tpu/ops/device_check.py's tolerance)
# The flash backward passes vs their plain versions: (shape, dtype, causal). The
# training path's shape, the expert backward's as chip_smoke drives it, a Llama
# request at full length, a ragged tail, head_dim 64 both ways, and the fp32 path.
FLASH_BWD_CASES = [
    (ALBERT_ATTENTION, "bfloat16", False), (EXPERT_ATTENTION, "bfloat16", True), ((1, 2048, 32, 128), "bfloat16", True),
    (CAUSAL_ATTENTION, "bfloat16", True),
    ((1, 2000, 32, 128), "bfloat16", True), ((2, 1000, 16, 64), "bfloat16", False),
    ((2, 1000, 16, 64), "bfloat16", True), ((2, 1000, 16, 64), "float32", False),
    ((2, 1000, 16, 64), "float32", True), ((1, 512, 32, 128), "float32", True),
    # other head dims and fp16, and B*H = 65536, on the wgmma passes
    ((2, 64, 8, 32), "bfloat16", False), ((2, 1000, 16, 32), "bfloat16", True), ((1, 512, 8, 80), "bfloat16", False),
    ((2, 1000, 16, 64), "float16", True), ((1, 512, 4, 256), "float16", False),
    ((65536, 16, 1, 64), "bfloat16", True), ((32768, 16, 2, 32), "float16", False),
    # the forward's shapes of the rows PERF.md keeps for them, so each pass is timed at one shape
    ((1, 512, 8, 96), "bfloat16", True), ((1, 512, 4, 256), "float16", True),
    # bf16 at head_dim 20: both passes on the packed-heads view; fp16
    # at a Llama request's shape beside bf16's; Phi-2's and Gemma-7B's widths (as FLASH_EXTRA_CASES)
    ((2, 1000, 16, 20), "bfloat16", True), ((1, 2048, 32, 128), "float16", True),
    ((1, 2048, 32, 80), "bfloat16", True), ((1, 2048, 16, 256), "float16", True),
    # with the cases above, every instantiation of the wgmma passes (bf16 and fp16, padded
    # widths 64, 128 and 256, full width or not): head dim 16; 96 in fp16; 256 in bf16;
    # 136, whose last 64-column region lies wholly past it (zeroed, never loaded); 200,
    # whose last region TMA reads partly past it
    ((2, 1000, 16, 16), "bfloat16", True), ((1, 512, 8, 96), "float16", False), ((1, 512, 4, 256), "bfloat16", False),
    ((2, 1000, 16, 136), "float16", True), ((1, 512, 4, 200), "bfloat16", True),
    # the packed-heads view's cases of FLASH_EXTRA_CASES (every instantiation of both packed
    # passes: bf16 and fp16 at padded widths 64 and 256; 128 by head dim 100), and H*D = 100
    # on both SIMT passes, which keeps their 16-bit path held
    ((2, 1000, 16, 20), "float16", True), ((4, 128, 12, 26), "bfloat16", False), ((2, 1000, 16, 25), "bfloat16", True),
    ((1, 512, 4, 196), "float16", True), ((3, 333, 12, 26), "bfloat16", True), ((2, 1000, 5, 20), "bfloat16", True),
    ((1, 512, 8, 100), "bfloat16", True), ((1, 512, 8, 100), "float16", False), ((1, 512, 4, 196), "bfloat16", False),
    # fp32 beside the cases above (the 3xTF32 dQ and dK/dV passes): ALBERT's shape, the training path's; head dim
    # 20 (a multiple of 4, not of 8); 128 and 100 (padded to 128) at a ragged T; a Llama request at full length; and
    # 18, which stays on SIMT
    (ALBERT_ATTENTION, "float32", False), ((2, 1000, 16, 20), "float32", True), ((3, 333, 12, 128), "float32", True),
    ((3, 333, 12, 100), "float32", True), ((1, 2048, 32, 128), "float32", True), ((2, 1000, 4, 18), "float32", True),
]
# Each backward output element within atol + rtol*scale, where scale is the plain
# backward run on absolute values: sum_k |dS||K| for dq, sum_q |dS||Q| for dk,
# sum_q P|dO| for dv. The bf16 kernels round each P and dS term to bf16 (relative
# error <= u = 2^-8) and both versions round the output (<= u each), so an exact
# sum errs by at most 3u*scale. The error's norm over the reference's norm is held
# to 2u: rounding reads about 0.67u (a CPU emulation of the kernel's rounding at
# [2, 512, 4, 64] and [1, 1024, 2, 128]: 2.5e-3 to 2.7e-3), while dS 5% off on half
# the tiles reads about 9u (2.5e-2 to 3.6e-2). The cap is two bf16 ulps of an
# output in [4, 8). fp32: only the order of fp32 sums differs, bounded by
# T*2^-24*scale (1.2e-4 at T = 2048). fp16 is held like bf16 with fp16's unit
# roundoff, u = 2^-11: both wgmma passes round each P and dS term to fp16 as bf16's
# do to bf16, so the same derivation gives 3u*scale and a norm ratio of 2u; its cap is
# two fp16 ulps of an output in [4, 8). fp16's dS overflows past 65504 (no timed
# input comes near it).
FLASH_BWD_TOL = {
    "bfloat16": dict(atol=1e-5, rtol=3 * BF16_UNIT_ROUNDOFF, max_abs=6.25e-2, rel_l2=2 * BF16_UNIT_ROUNDOFF),
    "float16": dict(atol=1e-5, rtol=3 * FP16_UNIT_ROUNDOFF, max_abs=2.0**-7, rel_l2=2 * FP16_UNIT_ROUNDOFF),
    "float32": dict(atol=1e-5, rtol=1.2e-4, max_abs=1e-3, rel_l2=1e-5),
}
FAULTY_TILE = 64  # planted faults the checks must reject: P (forward) or dS (backward) 5% too large on every other 64-wide tile
# where the backward's planted fault is checked, (shape, dtype): the training path's
# shape, and a Llama request at full length, causal (the dQ kernel masks only its
# diagonal tiles), in bf16 and in fp16; and Gemma-7B's fp16 at a padded width of 256
FAULTY_BWD_SHAPES = ((ALBERT_ATTENTION, "bfloat16"), ((1, 2048, 32, 128), "bfloat16"),
                     ((1, 2048, 32, 128), "float16"), ((1, 2048, 16, 256), "float16"), FAULTY_PACKED)
# where the fp32 checks must reject the inputs rounded to plain TF32 (10 mantissa bits, what one
# TF32 product would read; the plain version run on tf32_split's hi parts), in both phases: the
# training path's shape and a Llama request at full length, causal
FAULTY_TF32_SHAPES = ((ALBERT_ATTENTION, False), ((1, 2048, 32, 128), True))
# where the kernels line's entry of the SIMT dQ kernel is timed: an fp32 head dim the 3xTF32 kernels do
# not take (18, not a multiple of 4), one of FLASH_BWD_CASES
SIMT_DQ_SHAPE = ((2, 1000, 4, 18), "float32")
# q, k, v sliced from one fused [B, T, 3, H, D] tensor (T stride 3*H*D): the TMA views of a
# projection that is not split into three tensors, for each head_dim, held like FLASH_SHAPES; and in
# fp32 the strided views the 3xTF32 kernels' 16-byte loads read (head dims 64 and 20)
STRIDED_CASES = [((2, 1000, 16, 64), True, "bfloat16"), ((1, 512, 32, 128), False, "bfloat16"),
                 ((2, 1000, 16, 64), True, "float32"), ((2, 333, 8, 20), False, "float32")]
# the kernels that issue wgmma: the build fails if any instantiation spills (the TMA-fed ones for
# bf16 and fp16 at padded widths 64, 128 and 256, each full-width and narrower; the 3xTF32 ones at
# padded widths 64 and 128)
WGMMA_KERNELS = ("flash_forward_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma", "flash_forward_tf32x3",
                 "flash_bwd_dq_tf32x3", "flash_bwd_dkv_tf32x3")
# the inputs [flash] and [flash_bwd] draw from their generators (seeds SEED and SEED + 5), in the order
# the checks take them
FLASH_DRAWS = ([shape for shape in FLASH_SHAPES for _ in range(3)]
               + [shape for shape, _, _ in FLASH_EXTRA_CASES for _ in range(3)]
               + [(b, t, 3, h, d) for (b, t, h, d), _, _ in STRIDED_CASES]
               + [shape for shape, _, _ in UNALIGNED_CASES for _ in range(3)])
FLASH_BWD_DRAWS = ([shape for shape, _, _ in FLASH_BWD_CASES for _ in range(4)]
                   + [(b, t, 4, h, d) for (b, t, h, d), _, _ in STRIDED_CASES]
                   + [shape for shape, _, _ in UNALIGNED_CASES for _ in range(4)])
# ALBERT-base MLM training, bench.py's workload: its first batch candidate
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 32, 512, 2, 10
TRAIN_MASKED_FRACTION = 0.25
TRAIN_CHECK_BATCH = 2  # the sub-batch held against the CPU plain path
# card vs CPU on the same weights and sub-batch (bf16 compute on both; the CPU's
# attention is plain_attention in bf16, the card's the flash kernels with fp32
# softmax): the loss's relative gap and each gradient's error norm over its norm.
# Measured on these seeds: loss 2.8e-5, gradients <= 1.6e-2 (about 4u, u = 2^-8:
# bf16 rounding carried through 12 applications of the shared layer). The limits
# are about 10x and 2x those: 3e-4 for the loss (a mean over ~150 masked positions)
# and 8u for the gradients. Remat recomputes a deterministic forward, so it is held
# to the card's own loss exactly and to 1e-6 on the gradients (measured: identical).
TRAIN_LOSS_RTOL = 3e-4
TRAIN_GRAD_REL_L2 = 8 * BF16_UNIT_ROUNDOFF
REMAT_GRAD_REL_L2 = 1e-6
ZERO_GRADIENT = "key.bias"  # softmax ignores it: its gradient is rounding noise on both sides
# [train_fp32]: [train]'s ALBERT-base, batch, AdamW and masked fraction in fp32 (AlbertConfig.base(dtype=
# float32); GEMMs in full fp32, allow_tf32 off), its attention's three passes on the 3xTF32 kernels; a few
# timed steps, then from the initial weights, on a sub-batch, the loss and every
# gradient against the same step on the card with plain fp32 attention, and against a planted fault: that
# attention on q, k, v rounded to plain TF32, which the limits must reject. Derived in PERF.md section 2: the
# kernels' products err near 2^-21 of a term, TF32's near 2^-11; on an H100 the gradients' error norms over
# their norms read at most 3.7e-6 with the kernels and at least 1.45e-4 with the fault, and the limit sits near
# their geometric middle; the loss moved by less than an ulp with the kernels and by 2.6e-7 with the fault
TRAIN_FP32_WARMUP, TRAIN_FP32_STEPS = 1, 3
TRAIN_FP32_LOSS_RTOL = 1e-6
TRAIN_FP32_GRAD_REL_L2 = 2e-5
TRAIN_FP32_ROUTES = "forward=tf32x3 dq=tf32x3 dkv=tf32x3"
TRAIN_FP32_LIMIT_S = 30.0
# [causal]: the causal LM at CausalLMConfig.base() widths and depth, [train]'s AdamW, one
# synthetic batch; held to the CPU plain path on a sub-batch (the limits below)
CAUSAL_WARMUP, CAUSAL_STEPS = 2, 10
CAUSAL_CHECK_BATCH = 2
# The loss and the gradients are held with [train]'s limits against the CPU plain path and
# against the card with fp32 attention (the plain version on fp32 q, k, v), except the query
# and key projections' gradients, held to 16u. Each row of the exact dS sums to 0 (softmax
# ignores a shift of a query's scores), so dQ_i = sum_j dS_ij k_j and dK_j = sum_i dS_ij q_i
# lose the keys' and queries' common component to cancellation. The kernels take delta =
# rowsum(dO * O) from the bf16 output O (as the JAX package's _flash_backward does), which
# errs by up to u * sum|dO||O|, so their rows of dS sum to that error instead of 0 and leave
# it times the common component in dQ and dK: u-sized against a remainder that may be far
# smaller, in the query and key projections' gradients. Measured on an H100 (700 W): those of
# layers 7, 9 and 11 at 2.9-3.6e-2 (worst 3.578e-2 against the CPU, 3.553e-2 against fp32
# attention, layer 9's key weight); every other gradient at most 1.309e-2; the CPU's own
# bf16 path at most 1.702e-2 against fp32 attention.
QK_PROJECTION = re.compile(r"\.(query|key)\.")
CAUSAL_QK_GRAD_REL_L2 = 16 * BF16_UNIT_ROUNDOFF
CAUSAL_PHASE_LIMIT_S = 60.0
EXPERT_LR = 1e-3  # SGD; the steps are compared, not the (barely moved) weights
EXPERT_TOL = SERVING_TOL
REQUEST_LENGTHS = (512, 512, 512, 512, 2048)
REFERENCE_LENGTH = 256  # a request of its own; the first 512-long request is checked too
# [head_dim32]'s served transformer experts, each a forward and a backward with its SGD step
# on the card through the wgmma flash kernels below their padded width of 64: one of
# head_dim 32 (all three passes on wgmma), and one at TinyBERT_General_4L_312D's attention
# widths (huawei-noah/TinyBERT_General_4L_312D config.json: hidden 312, 12 heads, so
# head_dim 26: all three passes on the packed-heads view); each must launch the forward
# twice (its forward, the backward's recompute) and each backward pass once
SMALL_HEADS_EXPERTS = (
    dict(tag="head_dim 32", hidden=256, heads=8, shape=(2, 64, 256), seed=SEED + 10,
         routes="forward=wgmma dq=wgmma dkv=wgmma", packed=False),
    dict(tag="TinyBERT width", hidden=312, heads=12, shape=(4, 128, 312), seed=SEED + 12,
         routes="forward=wgmma dq=wgmma dkv=wgmma", packed=True),
)
SMALL_HEADS_LAUNCHES = {"flash_attention_forward": 2, "flash_attention_backward_dq": 1,
                        "flash_attention_backward_dkv": 1}
# decode sessions on the served blocks: greedy generation from a 512-token prompt, then
# 8 sessions with prompts of 128, 136, ..., 184 tokens stepping in lock-step through
# decode_async (each merged step writes, masks and rotates every row at its own position)
DECODE_MAX_LEN, DECODE_PROMPT, DECODE_NEW = 1024, 512, 32
DECODE_CHECKED_STEPS = (1, 16, DECODE_NEW - 1)  # single-token steps held to the no-cache forward
DECODE_SESSIONS, DECODE_ROUNDS = 8, 16
DECODE_SESSION_PROMPTS = tuple(128 + 8 * i for i in range(DECODE_SESSIONS))
# the generated token's logit within this share of the best one's (at least 1) in the
# teacher-forced replay (tests/test_llama_loader.py's rule: bf16 noise may flip a near tie)
GREEDY_LOGIT_RTOL = 2e-2
# [telemetry]: the watchdog's heartbeat every 10 ms (its HIVEMIND_WATCHDOG_INTERVAL_S, 0.25 s
# by default), so a run of a second gives the loop-lag histogram tens of samples
WATCHDOG_INTERVAL_S = "0.01"
# a serving record rounds its duration and each phase to 1 us: the phases' sum may exceed
# the duration by that rounding alone
PHASE_ROUNDING_S = 2e-6
# the hooks' cost: solo decode steps with every hook on ("all"), span tracing off
# ("metrics"), and tracing off with the registry's updates as no-ops ("none"), rotated
# step by step (ABC, then CBA) for HOOK_COST_ROUNDS rounds
HOOK_COST_STATES, HOOK_COST_ROUNDS = ("all", "metrics", "none"), 100
# [remote]: forward parity over the wire at [1, T, 4096]: T = 128 is the largest unary
# request (2 MiB of fp32, the client's cap), 512 and 2048 stream; with the lossless
# "none" wire the remote chain runs the same kernels on the same batch as the local one
REMOTE_PARITY_LENGTHS = (128, 512, 2048)
REMOTE_LOSSLESS_TOL = 1e-6
REMOTE_STREAM_BYTES = 16 << 20  # the transport's throughput: one stream of this many bytes
REMOTE_PHASE_LIMIT_S = 60.0
# [swarm]: three server processes found through the DHT: S1 serves block 0, S2 and S3 each
# serve block 1 (replicas), every block as fp (SGD) and int8 under two uid prefixes. The
# client forwards [1, 512, 4096], generates DECODE_NEW tokens from [decode]'s prompt (fp
# and int8), fails over when the replica its session pinned for block 1 is killed after
# SWARM_KILL_AFTER tokens, and backpropagates [1, EXPERT_TOKENS, 4096] last (it steps the
# servers). Children that hang past the limit are killed, which fails the phase.
SWARM_PREFIXES = {"fp": "swarm_fp.", "int8": "swarm_int8."}
SWARM_LAYOUT = (0, 1, 1)  # the block each server process serves
SWARM_FORWARD_LENGTH = 512
SWARM_KILL_AFTER = 12
SWARM_STARTUP_LIMIT_S = 120.0
SWARM_PHASE_LIMIT_S = 180.0
# [relay]: the relay tier: run_relay's daemon advertised in the DHT, a NATed
# server process with the two fp blocks reached only through it, and the native transport's
# private daemons in this process. Budget: the phase, children included, must end within
# RELAY_PHASE_LIMIT_S (a timer kills the children past it, which fails the phase).
RELAY_PREFIX = "relay_fp."
RELAY_FORWARD_LENGTH = 512
RELAY_TIMED_RUNS = 3
RELAY_STARTUP_LIMIT_S = 45.0
RELAY_PHASE_LIMIT_S = 60.0
# [dmoe]: BASELINE config 4, the reference's MoE throughput setup (upstream hivemind
# docs/user/benchmarks.md: ffn experts at hid_dim 1024, client batches of 2048): 64 `ffn`
# experts (hid -> 4 hid -> hid with LayerNorm, 8.4 M parameters each) on the grid
# ffn.[0:8].[0:8], top-4 gating, a fp32 [2048, 1024] batch, the fp16 wire (the Server's
# default). Server processes, each a DHT peer bootstrapped from this one (the client):
# A serves row 0 (8 experts, fp32, Adam, a checkpoint directory, hot-expert adverts),
# B the next 28 (int8 weight-only), C the last 28 (fp32, Adam); D, a replica-only
# volunteer with 2 slots watching the grid, starts after the first calls; E restores A's
# checkpoint in a fresh process. Every expert gets its own weights from a seed.
DMOE_HIDDEN = 1024
DMOE_GRID = (8, 8)
DMOE_PREFIX = "ffn."
DMOE_BATCH = 2048
DMOE_K = 4
DMOE_UIDS = tuple(f"{DMOE_PREFIX}{i}.{j}" for i in range(DMOE_GRID[0]) for j in range(DMOE_GRID[1]))
DMOE_LAYOUT = {"A": DMOE_UIDS[:8], "B": DMOE_UIDS[8:36], "C": DMOE_UIDS[36:]}
# every expert of A gets ~one request per forward call (2048 x 4 picks over 64 experts):
# a forward every ~0.5 s crosses 0.5 requests/s in each 1 s tick
DMOE_POLICY = dict(qps_threshold=0.5, occupancy_threshold=0.5, max_replicas=2, period=1.0)
DMOE_REPLICA_SLOTS = 2
# each server declares its experts every 5 s (the Server's default is 30): the client's
# beam search reads its DHT node's stored and cached records first, so a replica shows
# in it once a declaration of the replica reaches that node
DMOE_UPDATE_PERIOD = 5.0
DMOE_TOL = SERVING_TOL  # the served path's fp16-wire limit
DMOE_STARTUP_LIMIT_S = 90.0
DMOE_PHASE_LIMIT_S = 120.0
# [averaging]: BASELINE config 2, benchmarks/benchmark_averaging.py's defaults at the
# published size: 8 peers, groups of 4, 100M float32 parameters a peer in one tensor,
# Float16Compression on the wire, 2 MiB parts, min_matchmaking_time 1 s. Each peer is a
# child process and DHT peer on one host and one card; peers 0-3 hold group bits "0"
# and 4-7 "1", reset before every round, and min_group_size is 4, so each round's two
# groups are the same 4 and 4: a peer whose join misses the 1 s window makes its whole
# group retry instead of leaving it to average as 3 + 1.
AVG_PEERS = 8
AVG_GROUP_SIZE = 4
AVG_PARAMS = 100_000_000
AVG_ROUNDS = 3
AVG_PREFIX = "bench"
AVG_MATCHMAKING_S = 1.0
AVG_STEP_TIMEOUT_S = 60.0
AVG_STARTUP_LIMIT_S = 120.0
AVG_PHASE_LIMIT_S = 240.0
AVG_KILL_LIMIT_S = 300.0  # a timer kills every peer process past this
AVG_VICTIM = 1  # SIGKILLed in the fourth round, AVG_KILL_DELAY_S after its all-reduce began
AVG_KILL_DELAY_S = 0.5
AVG_FAULT_SEED = 100  # the fourth round's values: seed SEED + AVG_FAULT_SEED + peer
AVG_U16, AVG_U32 = 2.0**-11, 2.0**-24  # unit roundoffs of fp16 and fp32
# [collab]: BASELINE config 3, examples/albert at ALBERT-base widths (albert-base-v2's
# config.json, not cut): 4 peer processes train one model through the collaborative
# Optimizer, each local step batch 32 x seq 512 (bench.py's and [train]'s workload,
# masked_loss_fraction 0.25), the JAX example's optimizer lamb_with_warmup(1e-3, 100,
# 10_000) clipped at norm 1 and keyed by epoch, target_batch_size 4096 and
# matchmaking_time 3 s (run_trainer.py:27,33), gradients averaged over the Optimizer's
# default fp16 wire and the state every epoch over fp32 (upstream hivemind's default
# state wire: the fp16 state wire turns small second moments negative, and LAMB's
# square root of them NaN; PERF.md §6), min_group_size 4 and groups unbounded (so every
# round holds every peer). After epoch 2 a fifth peer joins by load_state_from_peers()
# and trains an epoch with the swarm. One card: what is measured is the protocol
# between processes on one host, not a collective across cards.
COLLAB_PEERS = 4
COLLAB_RUN_ID = "albert_collab"
COLLAB_TARGET = 4096
COLLAB_MATCHMAKING_S = 3.0
COLLAB_LAMB = (1e-3, 100, 10_000)  # peak lr, warmup epochs, total epochs
COLLAB_EPOCHS = 2  # epochs 0-1 by the first four peers (two, for the run's time limit); the joiner's is the third
COLLAB_CHECKED = (0, 1)  # the transitions held to large-batch training
COLLAB_FAULT_PEER = COLLAB_PEERS - 1  # the planted fault leaves its batches out of the reference
COLLAB_STARTUP_LIMIT_S = 120.0
COLLAB_EPOCH_LIMIT_S = 120.0
COLLAB_PHASE_LIMIT_S = 240.0
COLLAB_KILL_LIMIT_S = 420.0  # a timer kills every peer process past this
COLLAB_INIT_SEED = SEED + 9  # every peer's initial weights
# each fp16 rounding of a value below fp16's normal range (6.1e-5) errs by up to half
# its subnormal spacing, 2^-25, whatever the value's size
COLLAB_F16_ABS = 2.0**-25
# the lossless state round: each peer's result is own + (mean - own), the mean a
# weighted fp32 sum of at most 5 peers' values over their total weight: within
# (n + 4) u32 of the largest magnitude S among them, so 16 u32 S
COLLAB_STATE_FACTOR = 16 * AVG_U32


# The phases' child processes come from multiprocessing's fork server, started by main() with
# these modules imported: each child starts without the seconds of importing torch and the
# package anew, as a spawned one would. Forking is safe there, unlike from this process: the
# server runs no thread (importing these starts none) and never touches CUDA.
CHILD_PRELOAD = ("__main__", "torch", "hivemind_tpu_torch.averaging", "hivemind_tpu_torch.compression",
                 "hivemind_tpu_torch.dht", "hivemind_tpu_torch.models", "hivemind_tpu_torch.moe.server",
                 "hivemind_tpu_torch.ops.blockwise_int8", "hivemind_tpu_torch.ops.flash_attention",
                 "hivemind_tpu_torch.optim", "hivemind_tpu_torch.parallel", "hivemind_tpu_torch.parallel.ring_attention",
                 "hivemind_tpu_torch.telemetry", "hivemind_tpu_torch.telemetry.monitor")


def collab_batch_seed(peer: int, k: int) -> int:
    """The seed of peer ``peer``'s ``k``-th batch (torch.Generator on the card)."""
    return SEED + 1_000 + 100_000 * peer + k


def log(message: str) -> None:
    sys.stdout.write(message + "\n")  # one write a line: [swarm] and [averaging] log from a thread of their own
    sys.stdout.flush()


def max_rel_err(got, expected) -> float:
    """The largest absolute difference over the reference's largest magnitude
    (hivemind_tpu/ops/device_check.py's measure)."""
    return float(np.abs(got - expected).max() / (np.abs(expected).max() + 1e-9))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def card_peaks(name: str) -> dict:
    """Published dense peaks (NVIDIA data sheets) for the card's variant, at its full power limit."""
    if "H200" in name:
        return {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "bytes": 4.8e12}
    if "H100" in name and "PCIe" in name:
        return {"bf16": 756e12, "tf32": 378e12, "fp32": 51e12, "bytes": 2.0e12}
    return {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "bytes": 3.35e12}  # H100 SXM


def bound_ms(operations: float, op_rate: float, nbytes: float, byte_rate: float):
    op_ms, byte_ms = operations / op_rate * 1e3, nbytes / byte_rate * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def flash_bound(torch, peaks, dtype, operations: float, nbytes: float) -> dict:
    """The least time a flash pass of ``operations`` on ``nbytes`` takes the card: ``bound``
    (ms, what bounds it) at the rate of the inputs' type, bf16's for 16-bit inputs and, for
    fp32, three TF32 products for each at the TF32 rate (3xTF32: an fp32-accurate product on
    the tensor cores, the least an fp32 input takes); for fp32 also ``fma``, at the CUDA cores'
    fp32 rate (the SIMT kernels' arithmetic)."""
    if dtype != torch.float32:
        return dict(bound=bound_ms(operations, peaks["bf16"], nbytes, peaks["bytes"]))
    return dict(bound=bound_ms(3.0 * operations, peaks["tf32"], nbytes, peaks["bytes"]),
                fma=bound_ms(operations, peaks["fp32"], nbytes, peaks["bytes"]))


def format_bound(bounds: dict) -> str:
    text = f"bound_ms={bounds['bound'][0]:.4f} ({bounds['bound'][1]})"
    return text + (f" fma_bound_ms={bounds['fma'][0]:.4f} ({bounds['fma'][1]})" if "fma" in bounds else "")


def metric_value(name: str, **labels) -> float:
    """One series of the port's process-wide registry: a value, or a histogram's count."""
    from hivemind_tpu_torch.telemetry import REGISTRY

    metric = REGISTRY.get(name)
    if metric is None:
        return 0.0
    child = metric.labels(**labels)
    return float(child.count) if metric.metric_type == "histogram" else child.value


def metric_total(name: str) -> float:
    """Every series of a family summed: values, or a histogram's counts."""
    from hivemind_tpu_torch.telemetry import REGISTRY

    metric = REGISTRY.get(name)
    if metric is None:
        return 0.0
    return sum(float(child.count) if metric.metric_type == "histogram" else child.value for _key, child in metric.series())


def lag_buckets(loop: str):
    """(bucket bounds, cumulative counts) of the watchdog's loop-lag histogram for ``loop``."""
    from hivemind_tpu_torch.telemetry import REGISTRY

    metric = REGISTRY.get("hivemind_event_loop_lag_seconds")
    buckets, _total, count = metric.labels(loop).snapshot()
    return metric.buckets, buckets + [count]


def bucket_quantile(bounds, cumulative, q: float) -> str:
    """The upper bound of the histogram bucket that holds quantile ``q``."""
    count = cumulative[-1]
    if not count:
        return "n/a"
    for bound, below in zip(bounds, cumulative):
        if below >= q * count:
            return f"<= {bound * 1e3:g} ms"
    return f"> {bounds[-1] * 1e3:g} ms"


def median_p90(values) -> str:
    return f"{np.median(values) * 1e3:.3f} / {np.percentile(values, 90) * 1e3:.3f} ms"


class Telemetry:
    """What ``[telemetry]`` reads: each phase leaves its readings here, and a watchdog
    tick sampler keeps the largest backlog of the port's executor since ``backlog`` was
    last reset (it runs right after the watchdog sets the backlog gauge)."""

    def __init__(self):
        self.readings, self.backlog = {}, 0

    def sample_backlog(self) -> None:
        self.backlog = max(self.backlog, int(metric_value("hivemind_executor_queue_depth", executor="blocking")))


SPIN_CYCLES_PER_MS = 2.0e6  # at least an H100's clock (1.98 GHz boost): n ms of cycles spin >= n ms


def time_ms(torch, fn, budget_ms: float = 300.0) -> float:
    """Mean device time of one call, by CUDA events over a run of calls after
    warm-up. The run is queued behind a spin kernel that outlasts the host's time
    to queue it, so the calls run back to back on the card and the reading is
    device time even where a call's host overhead exceeds it (``host_us`` reads
    that overhead)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    started = time.perf_counter()
    start.record()
    fn()
    end.record()
    host_ms = (time.perf_counter() - started) * 1e3
    torch.cuda.synchronize()
    iters = int(max(3, min(100, budget_ms / max(start.elapsed_time(end), 1e-3))))
    torch.cuda._sleep(int(SPIN_CYCLES_PER_MS * (2.0 * iters * host_ms + 1.0)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phases


MANGLED_TYPES = {"f": "float", "d": "double", "i": "int", "b": "bool"}


def kernel_name(mangled: str) -> str:
    """``name<args>`` from an Itanium-mangled kernel symbol (the last of its nested
    names; template arguments that are literals, builtin types or named types)."""
    names, i = [], mangled.find("N") + 1
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        names.append(mangled[j : j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    args = []
    if mangled[i : i + 1] == "I":
        i += 1
        while i < len(mangled) and mangled[i] != "E":
            literal, named = re.match(r"L[a-z](\d+)E", mangled[i:]), re.match(r"(\d+)", mangled[i:])
            if literal:
                args.append(literal.group(1))
                i += literal.end()
            elif named:
                start = i + named.end()
                args.append(mangled[start : start + int(named.group(1))])
                i = start + int(named.group(1))
            else:
                args.append(MANGLED_TYPES.get(mangled[i], mangled[i]))
                i += 1
    return (names[-1] if names else mangled) + (f"<{', '.join(args)}>" if args else "")


def ptxas_report(log: str):
    """Per kernel, from nvcc's ``-Xptxas -v`` log: registers at launch (setmaxnreg
    moves them between warpgroups later) and spill stores/loads in bytes; and
    every warning line and numbered note (C7508: a setmaxnreg that ptxas ignored;
    C7520: wgmmas that ptxas serialized)."""
    kernels, warnings, current = {}, [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)", line)
        if entry:
            current = kernel_name(entry.group(1))
            kernels[current] = {}
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and current:
            kernels[current]["spill"] = (int(spill.group(1)), int(spill.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if used and current:
            kernels[current]["registers"] = int(used.group(1))
        if "warning" in line.lower() or re.search(r"\(C\d{4}\)", line):
            warnings.append(line.strip())
    return kernels, warnings


def phase_build(torch, telemetry: Telemetry):
    from hivemind_tpu_torch.ops import _build
    from hivemind_tpu_torch.telemetry.device import COMPILE_TRACKER

    compiled = [name for name in _build.SOURCES if not _build.library_path(name).exists()]
    before = COMPILE_TRACKER.counts()
    started = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} kernel libraries built in {time.perf_counter() - started:.2f} s")
    recorded = {site: count - before.get(site, 0) for site, count in COMPILE_TRACKER.counts().items()}
    telemetry.readings["build"] = dict(compiled=compiled, recorded=recorded)
    log(f"[build] compiled {compiled} (the rest from the build cache); compiles recorded: "
        f"{ {site: round(seconds['seconds'], 2) for site, seconds in COMPILE_TRACKER.summary()['sites'].items()} } s")
    faults = []
    for name in _build.SOURCES:
        kernels, warnings = ptxas_report(_build.build_log(name))
        for kernel, info in kernels.items():
            stores, loads = info.get("spill", (0, 0))
            log(f"[build] {name}: {kernel}: {info.get('registers')} registers, spill stores {stores} B, loads {loads} B")
            if kernel.split("<")[0] in WGMMA_KERNELS and stores + loads:
                faults.append(f"{kernel} spills {stores} + {loads} bytes")
        for warning in warnings:
            log(f"[build] {name}: {warning}")
            if any(mark in warning for mark in ("C7508", "setmaxnreg", "C7520")):
                faults.append(f"{name}: {warning}")
    if faults:
        raise AssertionError("; ".join(faults))


class Draws:
    """``rng.standard_normal(shape, dtype=np.float32)`` for each of ``shapes`` in turn, drawn a
    few ahead by a thread while the caller checks the last ones on the card (numpy fills
    without holding the GIL): the same arrays as drawing each when it is needed."""

    def __init__(self, rng, shapes, ahead: int = 4):
        import queue
        import threading

        self._queue, self._stopped = queue.Queue(maxsize=ahead), threading.Event()
        self._thread = threading.Thread(target=self._fill, args=(rng, [tuple(shape) for shape in shapes]), daemon=True)
        self._thread.start()

    def _fill(self, rng, shapes) -> None:
        import queue

        for shape in shapes:
            array = rng.standard_normal(shape, dtype=np.float32)
            while not self._stopped.is_set():
                try:
                    self._queue.put(array, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __call__(self, shape) -> np.ndarray:
        array = self._queue.get()
        if array.shape != tuple(shape):
            raise AssertionError(f"drew {array.shape} where the check takes {tuple(shape)}: the draws are out of order")
        return array

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self._stopped.set()
        self._thread.join()


def host_us(torch, fn, calls: int = 50) -> float:
    """Mean host time of one call of ``fn``, which only enqueues work: the
    wrapper's overhead (checks, TMA geometry, map encoding, launch)."""
    torch.cuda.synchronize()
    started = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - started
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def error_reading(got, ref, scale, tol: dict, mantissa_bits: int) -> dict:
    """How ``got`` differs from ``ref``: the largest absolute error, the error's norm
    over the reference's, and the worst element against atol + rtol*scale (its share
    of that limit, its error, its reference value, and its error in ulps of the
    reference in a type with ``mantissa_bits`` explicit bits). ``ok`` holds all three
    to ``tol``."""
    got, ref, scale = (t.float().reshape(-1) for t in (got, ref, scale))
    err = (got - ref).abs()
    share = err / (tol["atol"] + tol["rtol"] * scale)
    worst = int(share.argmax())
    worst_err, worst_ref = err[worst].item(), ref[worst].item()
    ulp = 2.0 ** (math.floor(math.log2(abs(worst_ref))) - mantissa_bits) if worst_ref else 2.0 ** -149
    reading = dict(max_abs=err.max().item(), rel_l2=(err.norm() / ref.norm().clamp_min(1e-30)).item(),
                   share=share[worst].item(), err=worst_err, ref=worst_ref, ulps=worst_err / ulp)
    reading["ok"] = (math.isfinite(reading["max_abs"]) and reading["max_abs"] <= tol["max_abs"]
                     and reading["share"] <= 1.0 and reading["rel_l2"] <= tol["rel_l2"])
    return reading


def format_reading(reading: dict) -> str:
    return (f"max_err={reading['max_abs']:.3e} rel_l2={reading['rel_l2']:.3e} worst={reading['share']:.3f} of its "
            f"limit (err {reading['err']:.3e} at ref {reading['ref']:.4g}, {reading['ulps']:.2f} ulp)")


def faulty_forward(torch, q, k, v, causal):
    """The forward with P 5% too large on every other 64-wide KV tile, in fp32 with
    the output rounded to q's dtype: what the check must reject."""
    from hivemind_tpu_torch.ops.flash_attention import _scores

    scores = _scores(q, k, causal)
    probs = torch.exp(scores - torch.logsumexp(scores, dim=-1, keepdim=True))
    off = 1.0 + 0.05 * ((torch.arange(q.shape[1], device=q.device) // FAULTY_TILE) % 2)
    return torch.einsum("bhqk,bkhd->bqhd", probs * off, v.float()).to(q.dtype)


def plain_forward(torch, q, k, v, causal):
    """The plain version's (out, lse) and each output's scale, sum_j p_j*|v_j|."""
    from hivemind_tpu_torch.ops.flash_attention import flash_attention_plain

    ref_out, ref_lse = flash_attention_plain(q, k, v, causal)
    out_scale = flash_attention_plain(q, k, v.abs(), causal)[0]
    torch.cuda.synchronize()
    return ref_out, ref_lse, out_scale


def read_forward(out, lse, reference, dtype_name):
    """The kernel's (out, lse) against ``plain_forward``'s: (out reading, lse reading)."""
    ref_out, ref_lse, out_scale = reference
    return (error_reading(out, ref_out, out_scale, FLASH_TOL[dtype_name], MANTISSA_BITS[dtype_name]),
            error_reading(lse, ref_lse, ref_lse.abs(), LSE_TOL, MANTISSA_BITS["float32"]))


def simt_forward(torch, q, k, v):
    """A closure ``run(causal)`` that launches the SIMT forward kernel on q, k, v through its C
    entry point (whatever route the wrapper takes), into fresh outputs: the design a redesigned
    route replaced, timed beside it on the same tensors. Not counted as a launch."""
    from hivemind_tpu_torch.ops import flash_attention as flash

    library = flash._library()
    batch, seq, heads, head_dim = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((batch, heads, seq), dtype=torch.float32, device=q.device)

    def run(causal: bool):
        stream = torch.cuda.current_stream().cuda_stream
        status = library.hm_flash_forward_simt(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), flash.SIMT_DTYPES[q.dtype],
            batch, seq, heads, head_dim, *flash._strides(q, k, v, out), int(causal), head_dim ** -0.5, stream)
        flash._build.check_launch(library, status, "hm_flash_forward_simt")
        return out, lse

    return run


def simt_backward(torch, which: str, q, k, v, dout, lse, delta):
    """As ``simt_forward``, for the SIMT kernel of the backward pass ``which`` ("dq" or
    "dkv"): ``run(causal)`` returns its outputs."""
    from hivemind_tpu_torch.ops import flash_attention as flash

    library = flash._bwd_library()
    outputs = (torch.empty_like(q),) if which == "dq" else (torch.empty_like(k), torch.empty_like(v))
    entry = f"hm_flash_backward_{which}_simt"

    def run(causal: bool):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(library, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(t.data_ptr() for t in outputs), flash.SIMT_DTYPES[q.dtype], *q.shape,
            *flash._strides(q, k, v, dout, outputs[0]), int(causal), q.shape[-1] ** -0.5, stream)
        flash._build.check_launch(library, status, entry)
        return outputs

    return run


def tf32_rounded(*tensors):
    """The tensors rounded to plain TF32 (tf32_split's hi parts): the inputs one TF32 product
    reads, where the fp32 checks must fail. Gradients pass through the rounding unchanged."""
    from hivemind_tpu_torch.ops.flash_attention import tf32_split

    return tuple(t + (tf32_split(t)[0] - t).detach() for t in tensors)


def phase_flash(torch, peaks) -> dict:
    """The forward against its plain version; returns the kernels line's entries: the
    longest served request's, the packed-heads view's at FAULTY_PACKED and the 3xTF32 kernel's
    at ALBERT's fp32 shape."""
    with Draws(np.random.default_rng(SEED), FLASH_DRAWS) as draw:
        return check_flash(torch, peaks, draw)


def check_flash(torch, peaks, draw) -> dict:
    from hivemind_tpu_torch.ops.flash_attention import flash_attention_lse, flash_attention_plain, flash_routes, needs_copy

    entries = {}
    for shape in FLASH_SHAPES:
        batch, seq, heads, dim = shape
        base = [torch.from_numpy(draw(shape)).cuda() for _ in range(3)]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype) for t in base)
            dtype_name = str(dtype).removeprefix("torch.")
            for causal in (False, True):
                out, lse = flash_attention_lse(q, k, v, causal)
                reference = plain_forward(torch, q, k, v, causal)
                out_reading, lse_reading = read_forward(out, lse, reference, dtype_name)
                readings = f"out {format_reading(out_reading)}; lse {format_reading(lse_reading)}"
                label = f"B={batch} T={seq} H={heads} D={dim} {dtype_name} causal={causal} ({flash_routes(q)})"
                if not (out_reading["ok"] and lse_reading["ok"]):
                    raise AssertionError(f"flash {label} exceeds out {FLASH_TOL[dtype_name]}, lse {LSE_TOL}: {readings}")
                if shape == ALBERT_ATTENTION and dtype == torch.bfloat16 and not causal:  # a planted fault, rejected
                    faulty = read_forward(faulty_forward(torch, q, k, v, causal), lse, reference, dtype_name)[0]
                    log(f"[flash] {label}, P x 1.05 on every other KV tile (planted in the plain version): "
                        f"out {format_reading(faulty)} ok={faulty['ok']}")
                    if faulty["ok"]:
                        raise AssertionError("flash check passed a P that is 5% off on half the KV tiles")
                if dtype == torch.float32 and (shape, causal) in FAULTY_TF32_SHAPES:  # a planted fault, rejected
                    faulty = read_forward(*flash_attention_plain(*tf32_rounded(q, k, v), causal), reference, dtype_name)
                    log(f"[flash] {label}, q, k, v rounded to plain TF32 (planted in the plain version): "
                        f"out {format_reading(faulty[0])}; lse {format_reading(faulty[1])}")
                    if faulty[0]["ok"] and faulty[1]["ok"]:
                        raise AssertionError("flash check passed fp32 attention on inputs rounded to TF32")
                del reference
                err, lse_err = out_reading["max_abs"], lse_reading["max_abs"]
                timing = forward_timing(torch, peaks, q, k, v, causal)
                host = host_us(torch, lambda: flash_attention_lse(q, k, v, causal))
                log(f"[flash] {label}: max_err={err:.3e} lse_err={lse_err:.3e} {timing['text']} host_us={host:.1f}")
                log(f"[flash]   {readings}")
                entry = dict(max_abs_err=err, **{key: timing[key] for key in KERNEL_TIMES})
                if shape == (1, 2048, 32, 128) and causal and dtype == torch.bfloat16:  # the longest served request
                    entries["flash_attention_forward"] = entry
                if shape == ALBERT_ATTENTION and not causal and dtype == torch.float32:  # the fp32 training path's
                    entries["flash_attention_forward_tf32x3"] = entry
    for shape, dtype_name, causal in FLASH_EXTRA_CASES:
        batch, seq, heads, dim = shape
        q, k, v = (torch.from_numpy(draw(shape)).cuda().to(getattr(torch, dtype_name)) for _ in range(3))
        label = f"B={batch} T={seq} H={heads} D={dim} {dtype_name} causal={causal} ({flash_routes(q)})"
        readings = check_forward(torch, q, k, v, causal, dtype_name, label)
        if (shape, dtype_name) == FAULTY_PACKED:  # a planted fault, rejected
            reference = plain_forward(torch, q, k, v, causal)
            packed_err = read_forward(*flash_attention_lse(q, k, v, causal), reference, dtype_name)[0]["max_abs"]
            faulty = read_forward(faulty_forward(torch, q, k, v, causal), reference[1], reference, dtype_name)[0]
            log(f"[flash] {label}, P x 1.05 on every other KV tile (planted in the plain version): "
                f"out {format_reading(faulty)} ok={faulty['ok']}")
            if faulty["ok"]:
                raise AssertionError("flash check passed a P that is 5% off on half the KV tiles")
            del reference
            log(f"[flash] {label}, NaN, inf and -inf in every other head's q, k and v: the other heads' "
                f"{isolated_heads(torch, q, k, v, causal)}")
        timing = forward_timing(torch, peaks, q, k, v, causal)
        log(f"[flash] {label}: {timing['text']}")
        log(f"[flash]   {readings}")
        if (shape, dtype_name) == FAULTY_PACKED:
            entries["flash_attention_forward_packed"] = dict(max_abs_err=packed_err,
                                                             **{key: timing[key] for key in KERNEL_TIMES})
    for (batch, seq, heads, dim), causal, dtype_name in STRIDED_CASES:
        fused = torch.from_numpy(draw((batch, seq, 3, heads, dim))).cuda()
        q, k, v = fused.to(getattr(torch, dtype_name)).unbind(2)
        readings = check_forward(torch, q, k, v, causal, dtype_name, "on a fused qkv tensor")
        log(f"[flash] q, k, v of one fused [{batch}, {seq}, 3, {heads}, {dim}] {dtype_name} tensor, causal={causal} "
            f"({flash_routes(q)}, copied first: {needs_copy(q)}): {readings}")
    for shape, causal, dtype_name in UNALIGNED_CASES:
        q, k, v = (unaligned(torch, torch.from_numpy(draw(shape)).cuda().to(getattr(torch, dtype_name))) for _ in range(3))
        readings = check_forward(torch, q, k, v, causal, dtype_name, "on unaligned views")
        log(f"[flash] q, k, v {dtype_name} {list(shape)} one element off 16-byte alignment ({flash_routes(q)}, "
            f"copied first: {needs_copy(q)}), causal={causal}: {readings}")
    return entries


KERNEL_TIMES = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")  # a kernels line entry's times


def forward_timing(torch, peaks, q, k, v, causal) -> dict:
    """The forward wrapper's device time on q, k, v, its plain version's, the library's
    (``F.scaled_dot_product_attention``) and the bound (``flash_bound``); on the 3xTF32 route
    also the SIMT kernel's on the same tensors (``simt_ms``), the design it replaced. ``text``
    is the log's reading."""
    import torch.nn.functional as F

    from hivemind_tpu_torch.ops.flash_attention import flash_attention_lse, flash_attention_plain, flash_route

    batch, seq, heads, dim = q.shape
    timing = dict(ms=time_ms(torch, lambda: flash_attention_lse(q, k, v, causal)),
                  plain_ms=time_ms(torch, lambda: flash_attention_plain(q, k, v, causal)))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    timing["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
    pairs = seq * (seq + 1) / 2 if causal else seq * seq  # query-key pairs this data needs
    operations = 4.0 * batch * heads * dim * pairs
    bounds = flash_bound(torch, peaks, q.dtype, operations, 4 * q.numel() * q.element_size() + batch * heads * seq * 4)
    timing["bound_ms"], timing["bound_by"] = bounds["bound"]
    simt = ""
    if flash_route(q, "forward") == "tf32x3":
        run_simt = simt_forward(torch, q, k, v)
        timing["simt_ms"] = time_ms(torch, lambda: run_simt(causal))
        simt = f" simt_ms={timing['simt_ms']:.4f} ({timing['simt_ms'] / timing['ms']:.2f}x the kernel's)"
    timing["text"] = (f"ms={timing['ms']:.4f} ({operations / timing['ms'] / 1e9:.1f} TFLOP/s){simt} "
                      f"plain_ms={timing['plain_ms']:.4f} library_ms={timing['library_ms']:.4f} {format_bound(bounds)}")
    return timing


def poisoned(torch, t):
    """A copy of ``t`` ([B, T, H, D]) whose every other head (1, 3, ...) holds NaN, inf
    and -inf in turn along its columns."""
    t = t.clone()
    values = torch.tensor([float("nan"), float("inf"), -float("inf")], dtype=t.dtype, device=t.device)
    t[:, :, 1::2] = values.repeat(-(-t.shape[-1] // 3))[: t.shape[-1]]
    return t


def isolated_heads(torch, q, k, v, causal) -> str:
    """The forward with NaN, inf and -inf in every other head of q, k and v, held to the
    plain version on the other heads (each head's attention reads only its own columns);
    raises past the limits."""
    from hivemind_tpu_torch.ops.flash_attention import flash_attention_lse

    q, k, v = (poisoned(torch, t) for t in (q, k, v))
    out, lse = flash_attention_lse(q, k, v, causal)
    heads = torch.arange(0, q.shape[2], 2, device=q.device)
    kept = lambda t: t.index_select(2 if t.dim() == 4 else 1, heads)  # noqa: E731  (lse is [B, H, T])
    reference = tuple(kept(t) for t in plain_forward(torch, q, k, v, causal))
    dtype_name = str(q.dtype).removeprefix("torch.")
    out_reading, lse_reading = read_forward(kept(out), kept(lse), reference, dtype_name)
    readings = f"out {format_reading(out_reading)}; lse {format_reading(lse_reading)}"
    if not (out_reading["ok"] and lse_reading["ok"]):
        raise AssertionError(f"flash forward: a non-finite value in a neighbouring head reaches a head: {readings}")
    return readings


def isolated_heads_backward(torch, q, k, v, dout, causal) -> str:
    """Both backward passes with NaN, inf and -inf in every other head of q, k, v and dout
    (lse and delta from the plain forward of those inputs), held to the plain versions on
    the other heads; raises past the limits."""
    from hivemind_tpu_torch.ops.flash_attention import (
        _delta,
        flash_attention_backward_dkv,
        flash_attention_backward_dkv_plain,
        flash_attention_backward_dq,
        flash_attention_backward_dq_plain,
        flash_attention_plain,
    )

    q, k, v, dout = (poisoned(torch, t) for t in (q, k, v, dout))
    out, lse = flash_attention_plain(q, k, v, causal)
    args = (q, k, v, dout, lse, _delta(out, dout), causal)
    heads = torch.arange(0, q.shape[2], 2, device=q.device)
    got = (flash_attention_backward_dq(*args), *flash_attention_backward_dkv(*args))
    ref = (flash_attention_backward_dq_plain(*args), *flash_attention_backward_dkv_plain(*args))
    clean = [t.index_select(2, heads) for t in args[:4]]
    rows = [t.index_select(1, heads) for t in args[4:6]]
    scales = backward_scales(torch, *clean, *rows, causal)
    dtype_name = str(q.dtype).removeprefix("torch.")
    readings = {name: error_reading(g.index_select(2, heads), r.index_select(2, heads), sc,
                                    FLASH_BWD_TOL[dtype_name], MANTISSA_BITS[dtype_name])
                for name, g, r, sc in zip(("dq", "dk", "dv"), got, ref, scales)}
    text = "; ".join(f"{name} {format_reading(r)}" for name, r in readings.items())
    if not all(r["ok"] for r in readings.values()):
        raise AssertionError(f"flash backward: a non-finite value in a neighbouring head reaches a head: {text}")
    return text


def unaligned(torch, t):
    """A copy of ``t`` whose base lies one element past a 16-byte boundary."""
    storage = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = storage[1:].view(t.shape)
    view.copy_(t)
    return view


def check_forward(torch, q, k, v, causal, dtype_name, label) -> str:
    """The forward kernel's (out, lse) held to the plain version's; raises past the
    limits, else returns the readings."""
    from hivemind_tpu_torch.ops.flash_attention import flash_attention_lse

    out, lse = flash_attention_lse(q, k, v, causal)
    out_reading, lse_reading = read_forward(out, lse, plain_forward(torch, q, k, v, causal), dtype_name)
    readings = f"out {format_reading(out_reading)}; lse {format_reading(lse_reading)}"
    if not (out_reading["ok"] and lse_reading["ok"]):
        raise AssertionError(f"flash {label} exceeds out {FLASH_TOL[dtype_name]}, lse {LSE_TOL}: {readings}")
    return readings


def phase_quantization(torch, peaks):
    from hivemind_tpu_torch.ops.blockwise_int8 import (
        blockwise_dequantize_plain,
        blockwise_int8_dequantize,
        blockwise_int8_quantize,
        blockwise_quantize_plain,
    )

    rng = np.random.default_rng(SEED + 1)
    weight = rng.standard_normal((4096, 11008), dtype=np.float32) * np.float32(4096 ** -0.5)
    ties = np.resize(np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 3.0], np.float32), 4096)
    ties[-1] = 127.0  # absmax 127: scale exactly 1, every x.5 an exact tie
    flat = torch.from_numpy(np.concatenate([weight.reshape(-1), ties, np.zeros(4096, np.float32)])).cuda()
    n = flat.numel()

    codes, absmax = blockwise_int8_quantize(flat)
    ref_codes, ref_absmax = blockwise_quantize_plain(flat)
    torch.cuda.synchronize()
    if not (torch.equal(codes, ref_codes) and torch.equal(absmax, ref_absmax)):
        raise AssertionError("blockwise quantize: codes or absmax differ from the plain version")
    if codes[-2, :8].tolist() != [0, 2, 2, 0, -2, -2, 126, 3] or codes[-1].abs().max().item() != 0:
        raise AssertionError(f"blockwise quantize: ties or zero block wrong: {codes[-2, :8].tolist()}")
    quant_err = (codes.int() - ref_codes.int()).abs().max().item()
    ms = time_ms(torch, lambda: blockwise_int8_quantize(flat))
    plain_ms = time_ms(torch, lambda: blockwise_quantize_plain(flat))
    q_bound, q_by = bound_ms(4.0 * n, peaks["fp32"], n * 4 + n + absmax.numel() * 4, peaks["bytes"])
    log(f"[quantize] {n} elements: max_err={quant_err} (bit-identical) ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={q_bound:.4f} ({q_by})")
    quantize_entry = dict(max_abs_err=float(quant_err), ms=ms, plain_ms=plain_ms, bound_ms=q_bound,
                          bound_by=q_by, library_ms=None)

    out = blockwise_int8_dequantize(codes, absmax)
    ref_out = blockwise_dequantize_plain(codes, absmax)
    torch.cuda.synchronize()
    if not torch.equal(out, ref_out):
        raise AssertionError("blockwise dequantize differs from the plain version")
    deq_err = (out - ref_out).abs().max().item()
    ms = time_ms(torch, lambda: blockwise_int8_dequantize(codes, absmax))
    plain_ms = time_ms(torch, lambda: blockwise_dequantize_plain(codes, absmax))
    d_bound, d_by = bound_ms(2.0 * n, peaks["fp32"], n + absmax.numel() * 4 + n * 4, peaks["bytes"])
    log(f"[dequantize] {n} elements: max_err={deq_err} (bit-identical) ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={d_bound:.4f} ({d_by})")
    dequantize_entry = dict(max_abs_err=deq_err, ms=ms, plain_ms=plain_ms, bound_ms=d_bound,
                            bound_by=d_by, library_ms=None)
    return quantize_entry, dequantize_entry


def faulty_backward(torch, q, k, v, dout, lse, delta, causal):
    """dq and dk with dS 5% too large on every other tile (of keys for dq, of
    queries for dk), in fp32 with outputs rounded to q's dtype: what the check must
    reject."""
    from hivemind_tpu_torch.ops.flash_attention import flash_backward_terms

    _, ds = flash_backward_terms(q, k, v, dout, lse, delta, causal)
    off = 1.0 + 0.05 * ((torch.arange(q.shape[1], device=q.device) // FAULTY_TILE) % 2)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds * off, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds * off[:, None], q.float())
    return dq.to(q.dtype), dk.to(k.dtype)


def backward_scales(torch, q, k, v, dout, lse, delta, causal):
    """The plain backward on absolute values: sum |dS||K|, sum |dS||Q|, sum P|dO|."""
    from hivemind_tpu_torch.ops.flash_attention import flash_backward_terms

    p, ds = flash_backward_terms(q, k, v, dout, lse, delta, causal)
    ds = ds.abs()
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", ds, q.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", p, dout.float().abs()))


def read_backward(dtype_name, got, ref, scales) -> dict:
    tol = FLASH_BWD_TOL[dtype_name]
    return {name: error_reading(g, r, sc, tol, MANTISSA_BITS[dtype_name])
            for name, g, r, sc in zip(("dq", "dk", "dv"), got, ref, scales)}


def library_backward_ms(torch, q, k, v, dout, causal) -> float:
    """Device time of the library's whole attention backward, alone, on one
    retained ``scaled_dot_product_attention`` forward. Where its fused backends
    refuse a shape (cuDNN's graph, and the others' grid, at B*H = 65536), its
    math backend is timed."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def timed():
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        return time_ms(torch, lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dout.transpose(1, 2),
                                                          retain_graph=True))

    try:
        return timed()
    except RuntimeError as e:
        log(f"[flash_bwd]   the library's first backend refused {list(q.shape)}: {str(e)[:80]}; timing its math backend")
        with sdpa_kernel([SDPBackend.MATH]):
            return timed()


def phase_flash_bwd(torch, peaks) -> dict:
    """Both backward passes against their plain versions; returns the kernels line's entries."""
    with Draws(np.random.default_rng(SEED + 5), FLASH_BWD_DRAWS) as draw:
        return check_flash_bwd(torch, peaks, draw)


def check_flash_bwd(torch, peaks, draw) -> dict:
    from hivemind_tpu_torch.ops.flash_attention import (
        _delta,
        flash_attention_backward,
        flash_attention_backward_dkv,
        flash_attention_backward_dkv_plain,
        flash_attention_backward_dq,
        flash_attention_backward_dq_plain,
        flash_attention_plain,
        flash_route,
        flash_routes,
        needs_copy,
    )

    entries = {}
    for shape, dtype_name, causal in FLASH_BWD_CASES:
        batch, seq, heads, dim = shape
        dtype = getattr(torch, dtype_name)
        q, k, v, dout = (torch.from_numpy(draw(shape)).cuda().to(dtype) for _ in range(4))
        out, lse = flash_attention_plain(q, k, v, causal)
        delta = _delta(out, dout)
        args = (q, k, v, dout, lse, delta, causal)
        got = (flash_attention_backward_dq(*args), *flash_attention_backward_dkv(*args))
        ref = (flash_attention_backward_dq_plain(*args), *flash_attention_backward_dkv_plain(*args))
        scales = backward_scales(torch, *args)
        readings = read_backward(dtype_name, got, ref, scales)
        text = "; ".join(f"{name} {format_reading(r)}" for name, r in readings.items())
        label = f"B={batch} T={seq} H={heads} D={dim} {dtype_name} causal={causal} ({flash_routes(q)})"
        if not all(r["ok"] for r in readings.values()):
            raise AssertionError(f"flash backward {label} exceeds {FLASH_BWD_TOL[dtype_name]}: {text}")
        if (shape, dtype_name) in FAULTY_BWD_SHAPES:  # the check must reject a planted fault
            faulty = read_backward(dtype_name, (*faulty_backward(torch, *args), ref[2]), ref, scales)
            log(f"[flash_bwd] {label}, dS x 1.05 on every other tile (planted in the plain version): " +
                "; ".join(f"{name} {format_reading(faulty[name])} ok={faulty[name]['ok']}" for name in ("dq", "dk")))
            if faulty["dq"]["ok"] or faulty["dk"]["ok"]:
                raise AssertionError("flash backward check passed a dS that is 5% off on half the tiles")
        if dtype == torch.float32 and (shape, causal) in FAULTY_TF32_SHAPES:  # the same, on inputs rounded to TF32
            rounded = (*tf32_rounded(q, k, v, dout), lse, delta, causal)
            faulty = read_backward(dtype_name, (flash_attention_backward_dq_plain(*rounded),
                                                *flash_attention_backward_dkv_plain(*rounded)), ref, scales)
            log(f"[flash_bwd] {label}, q, k, v, dout rounded to plain TF32 (planted in the plain version): " +
                "; ".join(f"{name} {format_reading(faulty[name])} ok={faulty[name]['ok']}" for name in faulty))
            if faulty["dq"]["ok"]:
                raise AssertionError("flash backward check passed fp32 dQ on inputs rounded to TF32")
            if faulty["dk"]["ok"] and faulty["dv"]["ok"]:
                raise AssertionError("flash backward check passed fp32 dK and dV on inputs rounded to TF32")
        if (shape, dtype_name) == FAULTY_PACKED:
            log(f"[flash_bwd] {label}, NaN, inf and -inf in every other head's q, k, v and dout: the other heads' "
                f"{isolated_heads_backward(torch, q, k, v, dout, causal)}")
        del got, ref, scales

        ms = {"dq": time_ms(torch, lambda: flash_attention_backward_dq(*args)),
              "dkv": time_ms(torch, lambda: flash_attention_backward_dkv(*args))}
        plain_ms = {"dq": time_ms(torch, lambda: flash_attention_backward_dq_plain(*args), budget_ms=100.0),
                    "dkv": time_ms(torch, lambda: flash_attention_backward_dkv_plain(*args), budget_ms=100.0)}
        library_ms = library_backward_ms(torch, q, k, v, dout, causal)
        simt = {}  # the SIMT kernel on the same tensors, where the pass runs 3xTF32: the design it replaced
        for kernel in ("dq", "dkv"):
            if flash_route(q, kernel) == "tf32x3":
                run_simt = simt_backward(torch, kernel, *args[:6])
                simt[kernel] = f" simt_ms={time_ms(torch, lambda: run_simt(causal)):.4f}"
        host = ""
        if dtype == torch.bfloat16:  # the wrappers' host time per call: each pass, and the whole backward
            host = "; host_us " + " ".join(f"{name}={host_us(torch, fn):.1f}" for name, fn in (
                ("dq", lambda: flash_attention_backward_dq(*args)), ("dkv", lambda: flash_attention_backward_dkv(*args)),
                ("backward", lambda: flash_attention_backward(q, k, v, out, lse, dout, causal))))
        pairs = seq * (seq + 1) / 2 if causal else seq * seq  # query-key pairs this data needs
        element, rows = q.numel() * q.element_size(), batch * heads * seq * 4
        operations = {"dq": 6.0 * batch * heads * dim * pairs, "dkv": 8.0 * batch * heads * dim * pairs}
        bounds = {"dq": flash_bound(torch, peaks, dtype, operations["dq"], 5 * element + 2 * rows),
                  "dkv": flash_bound(torch, peaks, dtype, operations["dkv"], 6 * element + 2 * rows)}
        log(f"[flash_bwd] {label}: " + "; ".join(
            f"{kernel} ms={ms[kernel]:.4f} ({operations[kernel] / ms[kernel] / 1e9:.1f} TFLOP/s){simt.get(kernel, '')} "
            f"plain_ms={plain_ms[kernel]:.4f} {format_bound(bounds[kernel])}"
            for kernel in ("dq", "dkv")) + f"; library (whole backward) ms={library_ms:.4f}{host}")
        log(f"[flash_bwd]   {text}")
        # the training path's shape (bf16 and fp32: the fp32 path's 3xTF32 dQ and dK/dV), the packed-heads
        # view's, and an fp32 head dim the SIMT dQ pass still takes
        names = {(ALBERT_ATTENTION, "bfloat16"): {"dq": "", "dkv": ""}, FAULTY_PACKED: {"dq": "_packed", "dkv": "_packed"},
                 (ALBERT_ATTENTION, "float32"): {"dq": "_tf32x3", "dkv": "_tf32x3"},
                 SIMT_DQ_SHAPE: {"dq": "_simt"}}.get((shape, dtype_name), {})
        for kernel, suffix in names.items():
            outputs = ("dq",) if kernel == "dq" else ("dk", "dv")
            entries[f"flash_attention_backward_{kernel}{suffix}"] = dict(
                max_abs_err=max(readings[n]["max_abs"] for n in outputs), ms=ms[kernel], plain_ms=plain_ms[kernel],
                bound_ms=bounds[kernel]["bound"][0], bound_by=bounds[kernel]["bound"][1], library_ms=library_ms)
    views = [(f"q, k, v, dout of one fused [{b}, {t}, 4, {h}, {d}] {dtype_name} tensor, causal={causal}",
              torch.from_numpy(draw((b, t, 4, h, d))).cuda().to(getattr(torch, dtype_name)).unbind(2), causal, dtype_name)
             for (b, t, h, d), causal, dtype_name in STRIDED_CASES]
    views += [(f"q, k, v, dout {dtype_name} {list(shape)} one element off 16-byte alignment, causal={causal}",
               [unaligned(torch, torch.from_numpy(draw(shape)).cuda().to(getattr(torch, dtype_name))) for _ in range(4)],
               causal, dtype_name)
              for shape, causal, dtype_name in UNALIGNED_CASES]
    for what, (q, k, v, dout), causal, dtype_name in views:
        what = f"{what} ({flash_routes(q)}, copied first: {needs_copy(q)})"
        out, lse = flash_attention_plain(q, k, v, causal)
        args = (q, k, v, dout, lse, _delta(out, dout), causal)
        got = (flash_attention_backward_dq(*args), *flash_attention_backward_dkv(*args))
        ref = (flash_attention_backward_dq_plain(*args), *flash_attention_backward_dkv_plain(*args))
        readings = read_backward(dtype_name, got, ref, backward_scales(torch, *args))
        text = "; ".join(f"{name} {format_reading(r)}" for name, r in readings.items())
        log(f"[flash_bwd] {what}: {text}")
        if not all(r["ok"] for r in readings.values()):
            raise AssertionError(f"flash backward with {what} exceeds its limits: {text}")
    return entries


def flops_per_token(config, seq_len: int, head_fraction: float = 1.0) -> float:
    """fwd+bwd FLOPs per token ~= 6 * (matmul params-equivalent per token) (a copy of
    bench.py's); ``head_fraction``: the MLM head runs on that fraction of positions."""
    h, i, L = config.hidden_size, config.intermediate_size, config.num_layers
    per_layer = 4 * h * h + 2 * h * i  # qkv+out projections + ffn (MACs per token)
    attention_quadratic = 2 * seq_len * h  # QK^T + PV MACs per token (x6 below -> FLOPs)
    head = h * config.embedding_size + config.embedding_size * config.vocab_size
    total_params_equiv = L * (per_layer + attention_quadratic) + head_fraction * head
    return 6.0 * total_params_equiv


def loss_and_grads(model, loss_fn, batch):
    model.zero_grad(set_to_none=True)
    loss = loss_fn(batch)
    loss.backward()
    return loss.item(), {name: p.grad.detach().float().cpu() for name, p in model.named_parameters()}


def gradient_gaps(got: dict, ref: dict) -> list:
    """Each gradient's error norm over its reference's norm, largest first (a NaN
    first of all), as (gap, parameter), the key bias (exact gradient 0) left out."""
    gaps = [(((got[name] - g).norm() / g.norm().clamp_min(1e-30)).item(), name)
            for name, g in ref.items() if not name.endswith(ZERO_GRADIENT)]
    return sorted(gaps, key=lambda gap: -gap[0] if math.isfinite(gap[0]) else -math.inf)


def gradient_gap(got: dict, ref: dict) -> tuple:
    """The largest gradient error norm over reference norm (a NaN if any), and its
    parameter, the key bias left out."""
    gaps = gradient_gaps(got, ref)
    return gaps[0] if gaps else (0.0, "")


def compare_grads(torch, got: dict, ref: dict, limit: float, what: str, phase: str = "train") -> float:
    """The largest gradient error norm over reference norm; raises past ``limit``.
    The key bias (exact gradient 0) is held to 1% of the largest gradient instead."""
    largest = max(g.abs().max().item() for g in ref.values())
    for name, g in ref.items():
        if name.endswith(ZERO_GRADIENT) and max(got[name].abs().max().item(), g.abs().max().item()) > 1e-2 * largest:
            raise AssertionError(f"{what}: {name} (exact gradient 0) is above 1% of the largest gradient")
    worst, worst_name = gradient_gap(got, ref)
    log(f"[{phase}] {what}: largest gradient error norm / norm {worst:.3e} ({worst_name})")
    if not worst <= limit:
        raise AssertionError(f"{what}: gradient {worst_name} differs by {worst:.3e} > {limit}")
    return worst


GEMM_KERNEL_MARKS = ("gemm", "gemv", "xmma", "cutlass", "wgmma", "nvjet")  # cuBLAS/cuBLASLt kernel names
THE_REST = "the rest (elementwise, norms, reductions, copies)"


def profile_step(torch, train_step, batch):
    """Device time of one train step by kernel family (torch.profiler), and the
    largest kernels of the family left over."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        started = time.perf_counter()
        train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - started) * 1e3
    families, rest = {}, {}
    for event in prof.events():
        if event.device_type != DeviceType.CUDA:
            continue
        name = event.name.lower()
        if "flash_bwd" in name:
            family = "flash backward (this repo's kernels)"
        elif "flash_forward" in name:
            family = "flash forward (this repo's kernel)"
        elif any(mark in name for mark in GEMM_KERNEL_MARKS):
            family = "GEMMs (cuBLAS)"
        elif "adam" in name or "multi_tensor" in name or "foreach" in name:
            family = "optimizer"
        else:
            family = THE_REST
            rest[event.name] = rest.get(event.name, 0.0) + event.time_range.elapsed_us() / 1e3
        families[family] = families.get(family, 0.0) + event.time_range.elapsed_us() / 1e3
    by_time = lambda item: -item[1]
    return wall_ms, sorted(families.items(), key=by_time), sorted(rest.items(), key=by_time)[:6]


def timed_steps(torch, train_step, batch, wrappers: dict, warmup: int, steps: int) -> tuple:
    """The main path of a training phase: ``warmup`` steps, then ``steps`` timed ones, the
    kernels' launches counted from 0. Returns (losses, ms a timed step, launches)."""
    for wrapper in wrappers.values():
        wrapper.launches = 0
    losses = [train_step(batch) for _ in range(warmup)]
    torch.cuda.synchronize()
    started = time.perf_counter()
    losses += [train_step(batch) for _ in range(steps)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - started) * 1e3 / steps
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    return [loss.item() for loss in losses], step_ms, launches


def log_step_profile(torch, train_step, batch, what: str) -> None:
    wall_ms, families, rest = profile_step(torch, train_step, batch)
    busy = sum(ms for _, ms in families)
    log(f"[profile] one {what} step: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms ({busy / wall_ms:.1%})")
    for family, ms in families:
        log(f"[profile]   {ms:8.3f} ms  {family}")
    for kernel, ms in rest:
        log(f"[profile]     {ms:8.3f} ms  of the rest: {kernel[:100]}")


def phase_train(torch, peaks, wrappers: dict, telemetry: Telemetry) -> dict:
    from hivemind_tpu_torch.models import (
        AlbertConfig,
        AlbertForMaskedLM,
        make_mlm_loss_fn,
        make_synthetic_mlm_batch,
        make_train_step,
    )

    config = AlbertConfig.base(max_position=TRAIN_SEQ)
    adamw = lambda params: torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4)  # optax.adamw(1e-4)
    batch = make_synthetic_mlm_batch(torch.Generator(device="cuda").manual_seed(SEED + 6), config, TRAIN_BATCH, TRAIN_SEQ)
    model, train_step = make_train_step(config, adamw, masked_loss_fraction=TRAIN_MASKED_FRACTION, device="cuda",
                                        rng_seed=SEED + 7)
    initial = {key: value.detach().clone() for key, value in model.state_dict().items()}

    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, launches = timed_steps(torch, train_step, batch, wrappers, TRAIN_WARMUP, TRAIN_STEPS)
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    telemetry.readings["train"] = dict(tokens_per_s=tokens_per_s)  # [collab] prints its rate beside it
    mfu = tokens_per_s * flops_per_token(config, TRAIN_SEQ, TRAIN_MASKED_FRACTION) / peaks["bf16"]
    steps = TRAIN_WARMUP + TRAIN_STEPS
    log(f"[train] ALBERT-base batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, AdamW, masked_loss_fraction "
        f"{TRAIN_MASKED_FRACTION}: step {step_ms:.3f} ms, {tokens_per_s:.0f} tokens/s, MFU {mfu:.2%} of the "
        f"published bf16 peak; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[train] losses: {[round(loss, 5) for loss in losses]}")
    log(f"[train] launches per step: " + json.dumps({name: count / steps for name, count in launches.items()}))
    if not all(math.isfinite(loss) for loss in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    per_step = config.num_layers
    for name in ("flash_attention_forward", "flash_attention_backward_dq", "flash_attention_backward_dkv"):
        if launches[name] != per_step * steps:
            raise AssertionError(f"{name}: {launches[name]} launches in {steps} steps, expected {per_step} per step")

    log_step_profile(torch, train_step, batch, "train")

    # the same initial weights and a sub-batch: card vs the CPU plain path, and remat
    sub = {key: value[:TRAIN_CHECK_BATCH] for key, value in batch.items()}
    graded = {}
    for where, remat in (("cuda", False), ("cuda", True), ("cpu", False)):
        check = AlbertForMaskedLM(dataclasses.replace(config, remat=remat), device=where)
        check.load_state_dict(initial)
        loss_fn = make_mlm_loss_fn(check, TRAIN_MASKED_FRACTION)
        forward_before = wrappers["flash_attention_forward"].launches
        graded[(where, remat)] = loss_and_grads(check, loss_fn, {key: value.to(where) for key, value in sub.items()})
        if where == "cuda":
            torch.cuda.synchronize()
            forwards = wrappers["flash_attention_forward"].launches - forward_before
            if forwards != per_step * (2 if remat else 1):
                raise AssertionError(f"remat={remat}: {forwards} flash forward launches in one step")
        del check
    card_loss, card_grads = graded[("cuda", False)]
    cpu_loss, cpu_grads = graded[("cpu", False)]
    remat_loss, remat_grads = graded[("cuda", True)]
    loss_gap = abs(card_loss - cpu_loss) / abs(cpu_loss)
    log(f"[train] [{TRAIN_CHECK_BATCH}, {TRAIN_SEQ}] sub-batch, initial weights: card loss {card_loss:.6f}, "
        f"CPU plain path {cpu_loss:.6f} (relative gap {loss_gap:.3e}), card with remat {remat_loss:.6f}")
    if not loss_gap <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"card loss differs from the CPU's by {loss_gap:.3e} > {TRAIN_LOSS_RTOL}")
    if remat_loss != card_loss:
        raise AssertionError(f"remat changed the loss: {remat_loss} != {card_loss}")
    compare_grads(torch, card_grads, cpu_grads, TRAIN_GRAD_REL_L2, "card vs CPU")
    compare_grads(torch, remat_grads, card_grads, REMAT_GRAD_REL_L2, "remat vs not, on the card")
    return launches


@contextlib.contextmanager
def albert_attention(variant: Optional[str]):
    """ALBERT's attention as [train_fp32] varies it: ``"plain"``, the plain version on the
    layer's fp32 q, k, v (the reference); ``"tf32"``, the same on q, k, v rounded to plain TF32
    (the planted fault); None, as the model runs it (the flash kernels)."""
    from hivemind_tpu_torch.models import albert
    from hivemind_tpu_torch.parallel.ring_attention import plain_attention

    core = albert.mesh_attention_core
    if variant is not None:
        prepare = tf32_rounded if variant == "tf32" else lambda *tensors: tensors
        albert.mesh_attention_core = lambda mesh, q, k, v, mask=None: plain_attention(*prepare(q, k, v), mask=mask)
    try:
        yield
    finally:
        albert.mesh_attention_core = core


def phase_train_fp32(torch, peaks, wrappers: dict, telemetry: Telemetry) -> dict:
    from hivemind_tpu_torch.models import (
        AlbertConfig,
        AlbertForMaskedLM,
        make_mlm_loss_fn,
        make_synthetic_mlm_batch,
        make_train_step,
    )
    from hivemind_tpu_torch.ops.flash_attention import flash_routes

    phase_started = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # the GEMMs in full fp32, as the JAX package's
    torch.backends.cudnn.allow_tf32 = False
    config = AlbertConfig.base(max_position=TRAIN_SEQ, dtype=torch.float32)
    shape = (TRAIN_BATCH, TRAIN_SEQ, config.num_heads, config.hidden_size // config.num_heads)
    routes = flash_routes(torch.empty(shape, dtype=config.dtype, device="meta"))
    log(f"[train_fp32] torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}; attention {list(shape)} fp32: {routes}")
    if routes != TRAIN_FP32_ROUTES:
        raise AssertionError(f"fp32 attention at {list(shape)} routes {routes}, expected {TRAIN_FP32_ROUTES}")
    adamw = lambda params: torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4)  # [train]'s
    batch = make_synthetic_mlm_batch(torch.Generator(device="cuda").manual_seed(SEED + 6), config, TRAIN_BATCH, TRAIN_SEQ)
    model, train_step = make_train_step(config, adamw, masked_loss_fraction=TRAIN_MASKED_FRACTION, device="cuda",
                                        rng_seed=SEED + 7)
    initial = {key: value.detach().clone() for key, value in model.state_dict().items()}

    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, launches = timed_steps(torch, train_step, batch, wrappers, TRAIN_FP32_WARMUP, TRAIN_FP32_STEPS)
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    flops = flops_per_token(config, TRAIN_SEQ, TRAIN_MASKED_FRACTION)
    bf16 = telemetry.readings.get("train", {}).get("tokens_per_s")
    beside = f"; [train]'s bf16 step {bf16:.0f} tokens/s ({bf16 / tokens_per_s:.2f}x)" if bf16 else ""
    log(f"[train_fp32] ALBERT-base fp32 batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, AdamW, masked_loss_fraction "
        f"{TRAIN_MASKED_FRACTION}: step {step_ms:.3f} ms, {tokens_per_s:.0f} tokens/s, "
        f"{tokens_per_s * flops / 1e12:.1f} TFLOP/s ({tokens_per_s * flops / peaks['fp32']:.1%} of the published fp32 "
        f"peak){beside}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    steps = TRAIN_FP32_WARMUP + TRAIN_FP32_STEPS
    log(f"[train_fp32] losses: {[round(loss, 5) for loss in losses]}")
    log(f"[train_fp32] launches per step: " + json.dumps({name: count / steps for name, count in launches.items()}))
    if not all(math.isfinite(loss) for loss in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    for name in ("flash_attention_forward", "flash_attention_backward_dq", "flash_attention_backward_dkv",
                 "flash_attention_forward_tf32x3", "flash_attention_backward_dq_tf32x3",
                 "flash_attention_backward_dkv_tf32x3"):
        if launches[name] != config.num_layers * steps:
            raise AssertionError(f"{name}: {launches[name]} launches in {steps} steps, expected {config.num_layers} "
                                 f"per step")
    log_step_profile(torch, train_step, batch, "fp32 train")
    del model, train_step, batch

    # from the initial weights, a sub-batch: the kernels against plain fp32 attention, and the planted fault
    sub = make_synthetic_mlm_batch(torch.Generator(device="cuda").manual_seed(SEED + 6), config, TRAIN_CHECK_BATCH,
                                   TRAIN_SEQ)
    graded = {}
    for variant in (None, "plain", "tf32"):
        check = AlbertForMaskedLM(config, device="cuda")
        check.load_state_dict(initial)
        forward_before = wrappers["flash_attention_forward_tf32x3"].launches
        with albert_attention(variant):
            graded[variant] = loss_and_grads(check, make_mlm_loss_fn(check, TRAIN_MASKED_FRACTION), sub)
        torch.cuda.synchronize()
        forwards = wrappers["flash_attention_forward_tf32x3"].launches - forward_before
        if forwards != (config.num_layers if variant is None else 0):
            raise AssertionError(f"attention {variant or 'kernels'}: {forwards} 3xTF32 forward launches in one step")
        del check
    ref_loss, ref_grads = graded["plain"]
    readings = {}
    for variant, what in ((None, "the kernels"), ("tf32", "planted fault, plain attention on q, k, v rounded to TF32")):
        loss, grads = graded[variant]
        gaps = gradient_gaps(grads, ref_grads)
        readings[variant] = (abs(loss - ref_loss) / abs(ref_loss), gaps[0][0])
        log(f"[train_fp32] [{TRAIN_CHECK_BATCH}, {TRAIN_SEQ}] sub-batch, initial weights, {what}: loss {loss:.8f} "
            f"against plain fp32 attention's {ref_loss:.8f} (relative gap {readings[variant][0]:.3e}); largest "
            f"gradient error norms / norm " + ", ".join(f"{gap:.3e} ({name})" for gap, name in gaps[:3]))
    fault_loss, fault_grad = readings["tf32"]
    if fault_loss <= TRAIN_FP32_LOSS_RTOL and fault_grad <= TRAIN_FP32_GRAD_REL_L2:
        raise AssertionError("the fp32 check passed attention on inputs rounded to TF32")
    if not readings[None][0] <= TRAIN_FP32_LOSS_RTOL:
        raise AssertionError(f"the kernels' loss differs from plain fp32 attention's by {readings[None][0]:.3e} > "
                             f"{TRAIN_FP32_LOSS_RTOL}")
    compare_grads(torch, graded[None][1], ref_grads, TRAIN_FP32_GRAD_REL_L2, "the kernels vs plain fp32 attention",
                  phase="train_fp32")
    wall = time.perf_counter() - phase_started
    log(f"[train_fp32] phase wall {wall:.1f} s (limit {TRAIN_FP32_LIMIT_S:.0f})")
    if wall > TRAIN_FP32_LIMIT_S:
        raise AssertionError(f"the phase took {wall:.1f} s, over its {TRAIN_FP32_LIMIT_S:.0f} s")
    return launches


def causal_flops_per_token(config, seq_len: int) -> float:
    """fwd+bwd FLOPs per token of the causal LM, 6 x its matmul MACs per token: the
    projections and the FFN, attention over the (T + 1) / 2 keys a causal query sees on
    average (QK^T and PV), and the tied head (hidden x vocab)."""
    h, i, L = config.hidden_size, config.intermediate_size, config.num_layers
    per_layer = 4 * h * h + 2 * h * i
    attention = 2 * h * (seq_len + 1) / 2
    return 6.0 * (L * (per_layer + attention) + h * config.vocab_size)


@contextlib.contextmanager
def attention_variant(variant: Optional[str]):
    """The causal LM's attention as [causal] varies it: ``"non_causal"``, its planted fault
    (every layer's attention with causal=False); ``"fp32"``, the plain version on fp32
    copies of q, k, v, its output rounded once to their dtype (the reference the kernels'
    rounding is read against); None, as the model runs it."""
    from hivemind_tpu_torch.models import causal_lm
    from hivemind_tpu_torch.parallel.ring_attention import plain_attention

    core = causal_lm.mesh_attention_core
    if variant == "non_causal":
        causal_lm.mesh_attention_core = lambda mesh, q, k, v, causal=False: core(mesh, q, k, v, causal=False)
    elif variant == "fp32":
        causal_lm.mesh_attention_core = lambda mesh, q, k, v, causal=False: plain_attention(
            q.float(), k.float(), v.float(), causal=causal).to(q.dtype)
    try:
        yield
    finally:
        causal_lm.mesh_attention_core = core


def qk_part(grads: dict, projections: bool) -> dict:
    """The gradients of the query and key projections, or of every other parameter."""
    return {name: g for name, g in grads.items() if bool(QK_PROJECTION.search(name)) == projections}


def phase_causal(torch, peaks, wrappers: dict) -> dict:
    from hivemind_tpu_torch.models import CausalLM, CausalLMConfig, make_causal_train_step, make_synthetic_lm_batch
    from hivemind_tpu_torch.models.causal_lm import make_lm_loss_fn

    phase_started = time.perf_counter()
    config = CausalLMConfig.base(max_position=CAUSAL_SEQ)
    adamw = lambda params: torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4)  # [train]'s, optax.adamw(1e-4)
    generator = torch.Generator(device="cuda").manual_seed(SEED + 25)
    batch = make_synthetic_lm_batch(generator, config, CAUSAL_BATCH, CAUSAL_SEQ)
    model, train_step = make_causal_train_step(config, adamw, device="cuda", rng_seed=SEED + 26)
    initial = {key: value.detach().clone() for key, value in model.state_dict().items()}

    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, launches = timed_steps(torch, train_step, batch, wrappers, CAUSAL_WARMUP, CAUSAL_STEPS)
    tokens_per_s = CAUSAL_BATCH * CAUSAL_SEQ / (step_ms / 1e3)
    flops = causal_flops_per_token(config, CAUSAL_SEQ)
    mfu = tokens_per_s * flops / peaks["bf16"]
    steps = CAUSAL_WARMUP + CAUSAL_STEPS
    log(f"[causal] CausalLM base ({config.num_layers} layers, hidden {config.hidden_size}, {config.num_heads} heads, "
        f"vocab {config.vocab_size}) batch {CAUSAL_BATCH} x seq {CAUSAL_SEQ}, AdamW: step {step_ms:.3f} ms, "
        f"{tokens_per_s:.0f} tokens/s, {flops / 1e9:.3f} GFLOP a token, MFU {mfu:.2%} of the published bf16 peak; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[causal] losses: {[round(loss, 5) for loss in losses]}")
    log(f"[causal] launches per step: " + json.dumps({name: count / steps for name, count in launches.items()}))
    if not all(math.isfinite(loss) for loss in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall over {steps} steps: {losses[0]} -> {losses[-1]}")
    for name in ("flash_attention_forward", "flash_attention_backward_dq", "flash_attention_backward_dkv"):
        if launches[name] != config.num_layers * steps:
            raise AssertionError(f"{name}: {launches[name]} launches in {steps} steps, expected {config.num_layers} "
                                 f"per step")

    log_step_profile(torch, train_step, batch, "causal train")
    del model, train_step

    # the same initial weights and a sub-batch: card vs the CPU plain path, remat, the
    # card with fp32 attention (the kernels' reference), and a planted fault (the card's
    # attention not causal) that the same limits must reject
    sub = {"input_ids": batch["input_ids"][:CAUSAL_CHECK_BATCH]}
    graded = {}
    for where, remat, variant in (("cuda", False, None), ("cuda", True, None), ("cuda", False, "fp32"),
                                  ("cuda", False, "non_causal"), ("cpu", False, None)):
        check = CausalLM(dataclasses.replace(config, remat=remat), device=where)
        check.load_state_dict(initial)
        forward_before = wrappers["flash_attention_forward"].launches
        with attention_variant(variant):
            graded[(where, remat, variant)] = loss_and_grads(check, make_lm_loss_fn(check),
                                                             {key: value.to(where) for key, value in sub.items()})
        if where == "cuda" and variant is None:
            torch.cuda.synchronize()
            forwards = wrappers["flash_attention_forward"].launches - forward_before
            if forwards != config.num_layers * (2 if remat else 1):
                raise AssertionError(f"remat={remat}: {forwards} flash forward launches in one step")
        del check
    card_loss, card_grads = graded[("cuda", False, None)]
    cpu_loss, cpu_grads = graded[("cpu", False, None)]
    remat_loss, remat_grads = graded[("cuda", True, None)]
    ref_loss, ref_grads = graded[("cuda", False, "fp32")]
    fault_loss, fault_grads = graded[("cuda", False, "non_causal")]
    loss_gap = abs(card_loss - cpu_loss) / abs(cpu_loss)
    fault_gap = abs(fault_loss - cpu_loss) / abs(cpu_loss)
    fault_grad, fault_name = gradient_gap(fault_grads, cpu_grads)
    log(f"[causal] [{CAUSAL_CHECK_BATCH}, {CAUSAL_SEQ}] sub-batch, initial weights: card loss {card_loss:.6f}, "
        f"CPU plain path {cpu_loss:.6f} (relative gap {loss_gap:.3e}), card with remat {remat_loss:.6f}, card with "
        f"fp32 attention {ref_loss:.6f}")
    for what, got, ref in (("the card", card_grads, ref_grads), ("the CPU plain path", cpu_grads, ref_grads),
                           ("the card against the CPU", card_grads, cpu_grads)):
        gaps = gradient_gaps(got, ref)
        rest = [gap for gap in gaps if not QK_PROJECTION.search(gap[1])]
        log(f"[causal] {what}{'' if ref is cpu_grads else ' against the card with fp32 attention'}, the largest "
            f"gradient error norms / norm: " + ", ".join(f"{gap:.3e} ({name})" for gap, name in gaps[:5])
            + "; outside the query and key projections " + ", ".join(f"{gap:.3e} ({name})" for gap, name in rest[:3]))
    log(f"[causal] planted fault, the card's attention with causal=False: loss {fault_loss:.6f} (relative gap "
        f"{fault_gap:.3e}), largest gradient error norm / norm {fault_grad:.3e} ({fault_name})")
    if fault_gap <= TRAIN_LOSS_RTOL and fault_grad <= CAUSAL_QK_GRAD_REL_L2:
        raise AssertionError("the card-vs-CPU check passed a model whose attention is not causal")
    if not loss_gap <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"card loss differs from the CPU's by {loss_gap:.3e} > {TRAIN_LOSS_RTOL}")
    if remat_loss != card_loss:
        raise AssertionError(f"remat changed the loss: {remat_loss} != {card_loss}")
    for what, ref in (("card vs the card with fp32 attention", ref_grads), ("card vs CPU", cpu_grads)):
        for projections, limit in ((False, TRAIN_GRAD_REL_L2), (True, CAUSAL_QK_GRAD_REL_L2)):
            compare_grads(torch, qk_part(card_grads, projections), qk_part(ref, projections), limit,
                          what + (", query and key projections" if projections else ", the rest"), phase="causal")
    compare_grads(torch, remat_grads, card_grads, REMAT_GRAD_REL_L2, "remat vs not, on the card", phase="causal")
    wall = time.perf_counter() - phase_started
    log(f"[causal] phase wall {wall:.1f} s (limit {CAUSAL_PHASE_LIMIT_S:.0f})")
    if wall > CAUSAL_PHASE_LIMIT_S:
        raise AssertionError(f"the phase took {wall:.1f} s, over its {CAUSAL_PHASE_LIMIT_S:.0f} s")
    return launches


def phase_expert_backward(torch, checkpoint_dir: str, wrappers: dict) -> dict:
    from hivemind_tpu_torch.moe.server.llama_loader import load_llama_blocks

    rng = np.random.default_rng(SEED + 8)
    hid = LLAMA2_7B["hidden_size"]
    x, grad_out = (rng.standard_normal((1, EXPERT_TOKENS, hid), dtype=np.float32) for _ in range(2))
    sgd = lambda params: torch.optim.SGD(params, lr=EXPERT_LR)

    backend = load_llama_blocks(checkpoint_dir, layers=[0], device="cuda", optimizer=sgd)[0]["llama.0"]
    initial = {key: tensor.to("cpu", copy=True) for key, tensor in backend.snapshot_params().items()}
    for wrapper in wrappers.values():
        wrapper.launches = 0  # the main path starts here: one backward with its SGD step
    started = time.perf_counter()
    (grad_x,) = backend.backward(x, grad_out)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - started) * 1e3
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    log(f"[expert_backward] llama.0 backward [1, {EXPERT_TOKENS}, {hid}] with SGD(lr={EXPERT_LR}): "
        f"{wall_ms:.1f} ms wall; launches {json.dumps(launches)}")
    if backend.update_count != 1 or backend.get_info()["updates"] != 1:
        raise AssertionError(f"update_count {backend.update_count}, get_info updates {backend.get_info()['updates']}")
    for name in ("flash_attention_backward_dq", "flash_attention_backward_dkv"):
        if launches[name] != 1:
            raise AssertionError(f"{name} launched {launches[name]} times in one block backward")
    steps = {key: tensor.to("cpu") - initial[key] for key, tensor in backend.snapshot_params().items()}
    del backend

    cpu_backend = load_llama_blocks(checkpoint_dir, layers=[0], device="cpu", optimizer=sgd)[0]["llama.0"]
    cpu_initial = {key: tensor.clone() for key, tensor in cpu_backend.snapshot_params().items()}
    (cpu_grad_x,) = cpu_backend.backward(x, grad_out)
    readings = {"input gradient": float(np.abs(grad_x - cpu_grad_x).max() / np.abs(cpu_grad_x).max())}
    for key, tensor in cpu_backend.snapshot_params().items():
        expected = tensor - cpu_initial[key]
        readings[key] = ((steps[key] - expected).abs().max() / expected.abs().max().clamp_min(1e-30)).item()
    log("[expert_backward] card vs CPU, max relative error: " + ", ".join(f"{k} {v:.3e}" for k, v in readings.items()))
    worst = max(readings, key=readings.get)
    if not readings[worst] < EXPERT_TOL:
        raise AssertionError(f"expert backward: {worst} differs from the CPU by {readings[worst]:.3e} >= {EXPERT_TOL}")
    return launches


def layer_shapes(config: dict) -> dict:
    """The HF names and shapes of one decoder layer's projection weights."""
    hid, inner = config["hidden_size"], config["intermediate_size"]
    kv = config["num_key_value_heads"] * hid // config["num_attention_heads"]
    return {"self_attn.q_proj.weight": (hid, hid), "self_attn.k_proj.weight": (kv, hid),
            "self_attn.v_proj.weight": (kv, hid), "self_attn.o_proj.weight": (hid, hid),
            "mlp.gate_proj.weight": (inner, hid), "mlp.up_proj.weight": (inner, hid),
            "mlp.down_proj.weight": (hid, inner)}


def write_checkpoint(path: Path, config: dict, seed: int) -> None:
    """A synthetic HF-layout Llama checkpoint in fp16 safetensors, one shard per layer
    and one for the embedding, final norm and LM head."""
    rng = np.random.default_rng(seed)
    hid = config["hidden_size"]
    (path / "config.json").write_text(json.dumps(config))
    weight_map = {}
    for layer in range(config["num_hidden_layers"]):
        prefix = f"model.layers.{layer}."
        tensors = {prefix + name: (rng.standard_normal(shape, dtype=np.float32) * np.float32(shape[1] ** -0.5))
                   for name, shape in layer_shapes(config).items()}
        for norm in ("input_layernorm.weight", "post_attention_layernorm.weight"):
            tensors[prefix + norm] = 1.0 + 0.1 * rng.standard_normal(hid, dtype=np.float32)
        shard = f"model-{layer:05d}-of-{config['num_hidden_layers']:05d}.safetensors"
        write_safetensors(path / shard, {name: t.astype(np.float16) for name, t in tensors.items()})
        weight_map.update({name: shard for name in tensors})
    # the client's ends, untied as Llama-2-7B publishes them
    vocab = config["vocab_size"]
    head = {"model.embed_tokens.weight": rng.standard_normal((vocab, hid), dtype=np.float32),
            "model.norm.weight": 1.0 + 0.1 * rng.standard_normal(hid, dtype=np.float32),
            "lm_head.weight": rng.standard_normal((vocab, hid), dtype=np.float32) * np.float32(hid ** -0.5)}
    write_safetensors(path / "model-head.safetensors", {name: t.astype(np.float16) for name, t in head.items()})
    weight_map.update({name: "model-head.safetensors" for name in head})
    (path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))


def write_safetensors(path: Path, tensors: dict) -> None:
    """The safetensors layout: u64 little-endian header length, JSON header, raw bytes."""
    header, offset = {}, 0
    for name, array in tensors.items():
        header[name] = {"dtype": "F16", "shape": list(array.shape), "data_offsets": [offset, offset + array.nbytes]}
        offset += array.nbytes
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for array in tensors.values():
            f.write(np.ascontiguousarray(array).tobytes())


def plain_blocks(checkpoint_dir: str, quantization, loaded: dict) -> dict:
    """The checkpoint's blocks on the CPU, the plain path [serving] and then [decode] hold the
    card to, loaded once into ``loaded`` for both (each only runs them forward)."""
    from hivemind_tpu_torch.moe.server.llama_loader import load_llama_blocks

    if quantization not in loaded:
        loaded[quantization] = load_llama_blocks(checkpoint_dir, device="cpu", weight_quantization=quantization)[0]
    return loaded[quantization]


class RecordedForward:
    """A backend's forward as a TaskPool's process function. It notes each batch's
    [batch, seq] and whether the batch that held the watched request's input also
    held another request; it hands that request's output on to the next block's
    recorder, which watches for it in turn."""

    def __init__(self, forward, downstream=None):
        self.forward, self.downstream, self.watched = forward, downstream, None
        self.batches, self.watched_merged = [], False
        self.bytes_in = self.bytes_out = 0  # what the batches carry to the card and back

    def __call__(self, x: np.ndarray):
        self.batches.append(tuple(x.shape[:2]))
        outputs = self.forward(x)
        self.bytes_in += x.nbytes
        self.bytes_out += sum(out.nbytes for out in outputs)
        if self.watched is not None and x.shape[1:] == self.watched.shape[1:]:
            for row in range(x.shape[0]):
                if np.array_equal(x[row], self.watched[0]):
                    self.watched_merged |= x.shape[0] > 1
                    if self.downstream is not None:
                        self.downstream.watched = outputs[0][row : row + 1]
        return outputs


async def serve(backends_by_mode: dict, requests: list, watched: np.ndarray) -> dict:
    """Run every request through block 0 → block 1 of every mode concurrently,
    handed to the pools as the connection handler hands them over ([remote] drives
    the handler itself); returns {mode: [(output, latency_s), ...]}, the runtime's batch count,
    each pool's RecordedForward and the run's wall seconds. Returns once the
    runtime has counted every batch (it counts a batch after its callers' results)."""
    from hivemind_tpu_torch.moe.server.runtime import Runtime
    from hivemind_tpu_torch.moe.server.task_pool import TaskPool
    from hivemind_tpu_torch.telemetry import ensure_watchdog

    ensure_watchdog(asyncio.get_running_loop(), name="serving")

    recorded = {}
    for mode, backends in backends_by_mode.items():
        downstream, recorded[mode] = None, {}
        for uid, backend in reversed(list(backends.items())):  # the last block first: each hands on to the next
            downstream = recorded[mode][uid] = RecordedForward(backend.forward, downstream)
        downstream.watched = watched
        recorded[mode] = dict(reversed(list(recorded[mode].items())))
    pools = {mode: [TaskPool(recorded[mode][uid], f"{mode}:{uid}", max_batch_size=8) for uid in backends]
             for mode, backends in backends_by_mode.items()}
    runtime = Runtime([pool for chain in pools.values() for pool in chain])
    runtime.start()

    async def chain(mode, x):
        started = time.perf_counter()
        for pool in pools[mode]:
            (x,) = await pool.submit_task(x)
        return x, time.perf_counter() - started

    started = time.perf_counter()
    try:
        jobs = {mode: [chain(mode, x) for x in requests] for mode in pools}
        flat = await asyncio.wait_for(asyncio.gather(*(job for mode in jobs for job in jobs[mode])), timeout=600)
        formed = sum(len(forward.batches) for chain in recorded.values() for forward in chain.values())
        deadline = time.perf_counter() + 60
        while runtime.batches_processed < formed and time.perf_counter() < deadline:
            await asyncio.sleep(0.001)
    finally:
        await runtime.shutdown()
    wall_s = time.perf_counter() - started
    results, i = {}, 0
    for mode in jobs:
        results[mode] = flat[i : i + len(requests)]
        i += len(requests)
    return results, runtime.batches_processed, recorded, wall_s


def profile_call(torch, fn):
    """Where one call's time goes: device time by kernel and copy (torch.profiler),
    against the call's wall time on the host. ``fn`` runs once, warm."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        started = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - started) * 1e6
    device_us = {}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            device_us[event.name] = device_us.get(event.name, 0.0) + event.time_range.elapsed_us()
    return wall_us, sorted(device_us.items(), key=lambda item: -item[1])


def serving_counters(pools) -> dict:
    """The served path's counters, per pool, and the transfer totals."""
    from hivemind_tpu_torch.telemetry import REGISTRY

    counters = {f"{name}:{pool}": metric_value(name, pool=pool) for pool in pools for name in (
        "hivemind_moe_batches_total", "hivemind_moe_samples_total", "hivemind_moe_queue_wait_seconds")}
    latency = REGISTRY.get("hivemind_moe_batch_latency_seconds")
    counters["latency_sum"] = sum(latency.labels(pool).sum for pool in pools) if latency is not None else 0.0
    for direction in ("host_to_device", "device_to_host"):
        counters[direction] = metric_value("hivemind_device_transfer_bytes_total", direction=direction)
    return counters


def phase_serving(torch, checkpoint_dir: str, wrappers: dict, telemetry: Telemetry, cpu_blocks_loaded: dict) -> dict:
    from hivemind_tpu_torch.moe.server.llama_loader import load_llama_blocks
    from hivemind_tpu_torch.telemetry.device import MEMORY_MONITOR

    rng = np.random.default_rng(SEED + 2)
    hid = LLAMA2_7B["hidden_size"]
    requests = [rng.standard_normal((1, t, hid), dtype=np.float32) for t in (*REQUEST_LENGTHS, REFERENCE_LENGTH)]
    for wrapper in wrappers.values():
        wrapper.launches = 0  # the main path starts here: loading (int8 quantizes on the card) and serving
    started = time.perf_counter()
    backends = {
        "fp": load_llama_blocks(checkpoint_dir, device="cuda")[0],
        "int8": load_llama_blocks(checkpoint_dir, device="cuda", weight_quantization="int8")[0],
    }
    torch.cuda.synchronize()
    log(f"[serving] loaded 2 x 2 blocks on the card in {time.perf_counter() - started:.1f} s")
    merged_index = 0  # the first 512-long request: checked below, and it must share a batch
    pools = [f"{mode}:{uid}" for mode, backend_map in backends.items() for uid in backend_map]
    counters, lag, telemetry.backlog = serving_counters(pools), lag_buckets("serving"), 0
    stalls = metric_value("hivemind_event_loop_stalls_total", loop="serving")
    results, batches, recorded, wall_s = asyncio.run(serve(backends, requests, requests[merged_index]))
    torch.cuda.synchronize()
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    after = serving_counters(pools)
    memory = MEMORY_MONITOR.sample()  # synchronous, with the served blocks resident
    gauge_bytes = metric_value("hivemind_device_memory_bytes", device="cuda:0")
    allocated = torch.cuda.memory_allocated(0)
    bounds, lag_after = lag_buckets("serving")
    telemetry.readings["serving"] = dict(
        pools=pools, requests=len(requests), tokens=sum(x.shape[1] for x in requests), batches=batches,
        formed=sum(len(forward.batches) for chain in recorded.values() for forward in chain.values()),
        deltas={key: after[key] - counters[key] for key in after},
        bytes_in=sum(forward.bytes_in for chain in recorded.values() for forward in chain.values()),
        bytes_out=sum(forward.bytes_out for chain in recorded.values() for forward in chain.values()),
        latencies={mode: [latency for _y, latency in results[mode]] for mode in results},
        wall_s=wall_s, backlog=telemetry.backlog,
        lag=(bounds, [b - a for a, b in zip(lag[1], lag_after)]), memory=memory, allocated=allocated,
        gauge_bytes=gauge_bytes, stalls=metric_value("hivemind_event_loop_stalls_total", loop="serving") - stalls,
        param_bytes=sum(backend.param_bytes() for backend_map in backends.values() for backend in backend_map.values()))
    log(f"[serving] {len(requests) * 2} chained requests ran as {batches} batches "
        f"(of {len(requests) * 2 * 2} block calls: same-length requests share a batch)")
    for mode, backend_map in backends.items():
        for uid, backend in backend_map.items():
            log(f"[serving] {mode} {uid}: {backend.param_bytes()} resident parameter bytes; "
                f"batches [batch, seq]: {recorded[mode][uid].batches}")
            if not recorded[mode][uid].watched_merged:
                raise AssertionError(f"{mode} {uid}: request {merged_index} never shared a batch with another request")
        for x, (y, latency) in zip(requests, results[mode]):
            if y.shape != x.shape or not np.isfinite(y).all():
                raise AssertionError(f"{mode}: output of shape {y.shape} (finite={np.isfinite(y).all()})")
            log(f"[serving] {mode} request [1, {x.shape[1]}, {hid}]: latency {latency * 1e3:.1f} ms")
        x = requests[len(REQUEST_LENGTHS) - 1]
        backend_map["llama.0"].forward(x)  # warm
        wall_us, device_us = profile_call(torch, lambda: backend_map["llama.0"].forward(x))
        busy_us = sum(us for _, us in device_us)
        log(f"[profile] {mode} llama.0 forward [1, {x.shape[1]}, {hid}]: wall {wall_us / 1e3:.3f} ms, "
            f"device busy {busy_us / 1e3:.3f} ms ({busy_us / wall_us:.1%})")
        for name, us in device_us[:10]:
            log(f"[profile]   {us / 1e3:8.3f} ms  {name[:100]}")

    for mode, quantization in (("fp", None), ("int8", "int8")):
        cpu_blocks = plain_blocks(checkpoint_dir, quantization, cpu_blocks_loaded)
        for index, what in ((len(requests) - 1, "a batch of its own"), (merged_index, "a merged batch")):
            expected = requests[index]
            for backend in cpu_blocks.values():
                expected = backend.forward(expected)[0]
            rel_err = max_rel_err(results[mode][index][0], expected)
            log(f"[serving] {mode} card vs CPU plain path, [1, {requests[index].shape[1]}, {hid}] "
                f"({what}): max_rel_err={rel_err:.3e}")
            if not rel_err < SERVING_TOL:
                raise AssertionError(f"{mode}: card output differs from the CPU reference by {rel_err} >= {SERVING_TOL}")
    return launches


def phase_small_heads(torch, wrappers: dict) -> dict:
    """Each of SMALL_HEADS_EXPERTS, a served ``transformer`` expert with bf16 attention
    on the card through the flash kernels at a padded width of 64: one forward, then
    one ``ModuleBackend.backward`` with its SGD step (the dQ and dK/dV passes), each
    held to the same expert on the CPU (``plain_attention``): the output, the input
    gradient and each parameter's step. The launch counts are set to 0 just before
    each expert and read just after; the phase returns their sums. A few seconds."""
    totals = {}
    for expert in SMALL_HEADS_EXPERTS:
        launches = serve_small_heads_expert(torch, wrappers, **expert)
        for name, count in launches.items():
            totals[name] = totals.get(name, 0) + count
    return totals


def serve_small_heads_expert(torch, wrappers: dict, tag: str, hidden: int, heads: int, shape: tuple, seed: int,
                             routes: str, packed: bool) -> dict:
    """One expert of SMALL_HEADS_EXPERTS on the card against the CPU: its launches."""
    from hivemind_tpu_torch.moe.server.layers import name_to_block
    from hivemind_tpu_torch.moe.server.module_backend import ModuleBackend
    from hivemind_tpu_torch.ops.flash_attention import flash_routes

    rng = np.random.default_rng(seed)
    x, grad_out = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
    sgd = lambda params: torch.optim.SGD(params, lr=EXPERT_LR)  # noqa: E731
    card = ModuleBackend("transformer.0", name_to_block["transformer"](hidden, num_heads=heads, device="meta"),
                         sample_input=x, device="cuda", rng_seed=SEED, optimizer=sgd)
    initial = {key: tensor.to("cpu", copy=True) for key, tensor in card.snapshot_params().items()}
    cpu = ModuleBackend("transformer.0", name_to_block["transformer"](hidden, num_heads=heads, device="meta"),
                        sample_input=x, device="cpu", params={k: t.clone() for k, t in initial.items()}, optimizer=sgd)
    torch.cuda.synchronize()
    for wrapper in wrappers.values():
        wrapper.launches = 0  # the main path starts here: one forward of the expert, one backward with its step
    got = card.forward(x)[0]
    (grad_x,) = card.backward(x, grad_out)
    torch.cuda.synchronize()
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    steps = {key: tensor.to("cpu") - initial[key] for key, tensor in card.snapshot_params().items()}
    rel_err = max_rel_err(got, cpu.forward(x)[0])
    (cpu_grad_x,) = cpu.backward(x, grad_out)
    readings = {"input gradient": max_rel_err(grad_x, cpu_grad_x)}
    readings.update(step_errors(torch, steps, {key: t - initial[key] for key, t in cpu.snapshot_params().items()}))
    label = flash_routes(torch.empty(shape[0], shape[1], heads, hidden // heads, dtype=torch.bfloat16, device="meta"))
    log(f"[head_dim32] {tag}: transformer expert hidden {hidden}, {heads} heads, input {list(shape)} ({label}): "
        f"flash launches forward {launches['flash_attention_forward']}, dq {launches['flash_attention_backward_dq']}, "
        f"dkv {launches['flash_attention_backward_dkv']} (on the packed-heads view "
        f"{launches['flash_attention_forward_packed']} / {launches['flash_attention_backward_dq_packed']} / "
        f"{launches['flash_attention_backward_dkv_packed']}); card vs CPU (plain_attention) max_rel_err={rel_err:.3e}")
    log(f"[head_dim32] {tag}: backward with SGD(lr={EXPERT_LR}), card vs CPU, max relative error: "
        + ", ".join(f"{k} {v:.3e}" for k, v in readings.items()))
    if label != routes:
        raise AssertionError(f"{tag} expert: its attention routes {label}, expected {routes}")
    counted = {name: launches[name] for name in SMALL_HEADS_LAUNCHES}
    if counted != SMALL_HEADS_LAUNCHES:
        raise AssertionError(f"{tag} expert: flash launches {counted}, expected {SMALL_HEADS_LAUNCHES}")
    on_packed = {name: launches[f"{name}_packed"] for name in SMALL_HEADS_LAUNCHES}  # every launch, or none
    if on_packed != {name: count * packed for name, count in SMALL_HEADS_LAUNCHES.items()}:
        raise AssertionError(f"{tag} expert: flash launches on the packed-heads view {on_packed}, packed={packed}")
    if not (got.shape == x.shape and np.isfinite(got).all() and rel_err < SERVING_TOL):
        raise AssertionError(f"{tag} expert: output {got.shape}, card vs CPU {rel_err} >= {SERVING_TOL}")
    if card.update_count != 1:
        raise AssertionError(f"{tag} expert: {card.update_count} updates after one backward")
    worst = max(readings, key=readings.get)
    if not readings[worst] < EXPERT_TOL:
        raise AssertionError(f"{tag} expert backward: {worst} differs from the CPU by {readings[worst]:.3e} "
                             f">= {EXPERT_TOL}")
    return launches


class LocalPipe:
    """``decode_step`` chained over a server's block uids through its
    DecodeSessionManager, in this process (RemotePipe is the same over the wire);
    notes each call's wall time and output, and the activation bytes its block
    calls carry to the card and back."""

    def __init__(self, manager, uids):
        self.manager, self.uids, self.calls = manager, list(uids), []
        self.block_calls = self.bytes_in = self.bytes_out = 0

    def decode_step(self, hidden, session_id, reset=False):
        x = hidden.cpu().numpy() if hasattr(hidden, "cpu") else np.asarray(hidden, np.float32)
        started = time.perf_counter()
        for uid in self.uids:
            self.bytes_in += np.asarray(x, np.float32).nbytes
            x = self.manager.decode(uid, session_id, x, reset)
            self.block_calls += 1
            self.bytes_out += x.nbytes
        self.calls.append((time.perf_counter() - started, x))
        return x


def forward_chain(backends: dict, x: np.ndarray) -> np.ndarray:
    """The no-cache forward through every block (``ModuleBackend.forward``)."""
    for backend in backends.values():
        x = backend.forward(x)[0]
    return x


def greedy_gaps(head, blocks: dict, ids: np.ndarray, prompt_len: int) -> np.ndarray:
    """The teacher-forced replay of generated ids through the local blocks: for each
    generated token, how far its logit lies below the best one (relative, at least 1)."""
    replay = forward_chain(blocks, head.embed(ids[:, :-1]).cpu().numpy())
    logits = head.logits(replay[:, prompt_len - 1:]).cpu().numpy()[0]
    chosen = logits[np.arange(ids.shape[1] - prompt_len), ids[0, prompt_len:]]
    return (logits.max(axis=-1) - chosen) / np.maximum(np.abs(logits.max(axis=-1)), 1.0)


def log_profile(label: str, wall_us: float, device_us: list, top: int = 6) -> None:
    busy_us = sum(us for _, us in device_us)
    log(f"[profile] {label}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms ({busy_us / wall_us:.1%})")
    for name, us in device_us[:top]:
        log(f"[profile]   {us / 1e3:8.3f} ms  {name[:100]}")


async def lockstep_rounds(manager, uids, sessions, inputs, rounds: int = DECODE_ROUNDS):
    """``rounds`` rounds in which every session advances one token through every
    block by ``decode_async``, under the loop's watchdog; returns
    (outputs[session][round], latencies in s, wall time of all rounds in s, the
    live-session gauge right after each round, [activation bytes to the card, back])."""
    from hivemind_tpu_torch.telemetry import ensure_watchdog

    ensure_watchdog(asyncio.get_running_loop(), name="decode")
    outputs, latencies, live, moved = {sid: [] for sid in sessions}, [], [], [0, 0]

    async def step(sid, x):
        started = time.perf_counter()
        for uid in uids:
            moved[0] += np.asarray(x, np.float32).nbytes
            x = await manager.decode_async(uid, sid, x, False)
            moved[1] += x.nbytes
        latencies.append(time.perf_counter() - started)
        outputs[sid].append(x)

    started = time.perf_counter()
    for round_index in range(rounds):
        await asyncio.gather(*(step(sid, inputs[sid][round_index]) for sid in sessions))
        live.append(metric_value("hivemind_moe_decode_sessions"))
    return outputs, latencies, time.perf_counter() - started, live, moved


DECODE_COUNTERS = (
    ("resets", "hivemind_moe_decode_session_resets_total", {}),
    ("ttl_evictions", "hivemind_moe_decode_session_evictions_total", {"reason": "ttl"}),
    ("cap_evictions", "hivemind_moe_decode_session_evictions_total", {"reason": "cap"}),
    ("direct", "hivemind_moe_decode_steps_total", {"path": "direct"}),
    ("batched", "hivemind_moe_decode_steps_total", {"path": "batched"}),
    ("host_to_device", "hivemind_device_transfer_bytes_total", {"direction": "host_to_device"}),
    ("device_to_host", "hivemind_device_transfer_bytes_total", {"direction": "device_to_host"}),
)


def decode_counters() -> dict:
    return {key: metric_value(name, **labels) for key, name, labels in DECODE_COUNTERS}


@contextlib.contextmanager
def registry_updates_off(counted: list):
    """Every counter, gauge and histogram update of the port's registry skipped (the
    values hold still) and counted in ``counted[0]``; the call sites still run up to
    the update, label lookups included."""
    from hivemind_tpu_torch.telemetry import registry

    def skipped(self, *args):
        counted[0] += 1

    saved = registry._Child.inc, registry._Child.dec, registry._Child.set, registry._HistogramChild.observe
    registry._Child.inc = registry._Child.dec = registry._Child.set = registry._HistogramChild.observe = skipped
    try:
        yield
    finally:
        registry._Child.inc, registry._Child.dec, registry._Child.set, registry._HistogramChild.observe = saved


def labeled_update_us(calls: int = 100_000) -> float:
    """Host microseconds of one labeled counter update, whole (label lookup, lock, add)."""
    from hivemind_tpu_torch.telemetry import MetricsRegistry

    counter = MetricsRegistry().counter("hooks_cost_probe", "a labeled counter", ("path",))
    started = time.perf_counter()
    for _ in range(calls):
        counter.inc(path="direct")
    return (time.perf_counter() - started) / calls * 1e6


def hooks_cost(pipe, head, prompt, token) -> dict:
    """Per-token latency (median, in s) of solo decode steps in each of
    HOOK_COST_STATES, rotated step by step within one session; the registry updates
    a step makes (counted while they are off); one labeled update's host cost."""
    from hivemind_tpu_torch.telemetry import tracing

    pipe.decode_step(head.embed(prompt), "hooks", reset=True)
    per_step, counted = {state: [] for state in HOOK_COST_STATES}, [0]
    try:
        for round_index in range(HOOK_COST_ROUNDS):
            for state in HOOK_COST_STATES[:: 1 if round_index % 2 == 0 else -1]:
                tracing.enabled = state == "all"
                with registry_updates_off(counted) if state == "none" else contextlib.nullcontext():
                    started = time.perf_counter()
                    pipe.decode_step(token, "hooks")
                    per_step[state].append(time.perf_counter() - started)
    finally:
        tracing.enabled = True
    cost = {state: float(np.median(steps)) for state, steps in per_step.items()}
    return dict(cost, updates_per_step=counted[0] / HOOK_COST_ROUNDS, update_us=labeled_update_us())


def phase_decode(torch, checkpoint_dir: str, wrappers: dict, peaks: dict, telemetry: Telemetry,
                 cpu_blocks_loaded: dict) -> dict:
    from hivemind_tpu_torch.moe.server.decode_session import DecodeSessionManager
    from hivemind_tpu_torch.moe.server.llama_loader import (
        LlamaCheckpointConfig,
        LlamaClientHead,
        decode_cache_bytes,
        generate_greedy,
        load_llama_blocks,
        plan_block_capacity,
        predict_block_param_bytes,
    )

    config = LlamaCheckpointConfig.load(checkpoint_dir)
    hid, vocab = config.hidden_size, LLAMA2_7B["vocab_size"]
    kv_bytes_per_position = 2 * 2 * config.num_key_value_heads * (hid // config.num_attention_heads)  # K + V, bf16
    rng = np.random.default_rng(SEED + 9)
    prompt = rng.integers(0, vocab, size=(1, DECODE_PROMPT))
    session_prompts = [rng.integers(0, vocab, size=(1, length)) for length in DECODE_SESSION_PROMPTS]
    session_tokens = rng.integers(0, vocab, size=(DECODE_SESSIONS, DECODE_ROUNDS, 1, 1))
    head = LlamaClientHead.load(checkpoint_dir, device="cuda")
    modes = {"fp": None, "int8": "int8"}
    backends = {mode: load_llama_blocks(checkpoint_dir, device="cuda", weight_quantization=q)[0] for mode, q in modes.items()}
    managers = {mode: DecodeSessionManager(blocks, max_len=DECODE_MAX_LEN) for mode, blocks in backends.items()}
    merged = {mode: recorded_sizes(manager) for mode, manager in managers.items()}
    sessions = [f"lockstep-{i}" for i in range(DECODE_SESSIONS)]
    inputs = {sid: [head.embed(tokens).cpu().numpy() for tokens in session_tokens[i]] for i, sid in enumerate(sessions)}

    torch.cuda.synchronize()
    for wrapper in wrappers.values():
        wrapper.launches = 0  # the main path starts here: decode steps only
    pipes, generated, lockstep, decode_readings = {}, {}, {}, {}
    for mode, manager in managers.items():
        before, telemetry.backlog = decode_counters(), 0
        bounds, lag = lag_buckets("decode")
        stalls = metric_value("hivemind_event_loop_stalls_total", loop="decode")
        pipes[mode] = LocalPipe(manager, backends[mode])
        generated[mode] = generate_greedy(head, pipes[mode], prompt, DECODE_NEW, session_id="solo")
        for i, sid in enumerate(sessions):
            pipes[mode].decode_step(head.embed(session_prompts[i]), sid, reset=True)
        lockstep[mode] = asyncio.run(lockstep_rounds(manager, list(backends[mode]), sessions, inputs))
        after = decode_counters()
        decode_readings[mode] = dict(
            deltas={key: after[key] - before[key] for key in after}, live=lockstep[mode][3], blocks=len(backends[mode]),
            lag=(bounds, [b - a for a, b in zip(lag, lag_buckets("decode")[1])]), backlog=telemetry.backlog,
            stalls=metric_value("hivemind_event_loop_stalls_total", loop="decode") - stalls,
            block_calls=pipes[mode].block_calls,
            lockstep_steps=DECODE_SESSIONS * DECODE_ROUNDS * len(backends[mode]), merged=list(merged[mode]),
            sessions=1 + DECODE_SESSIONS, tokens=DECODE_NEW + DECODE_SESSIONS * DECODE_ROUNDS,
            bytes_in=pipes[mode].bytes_in + lockstep[mode][4][0], bytes_out=pipes[mode].bytes_out + lockstep[mode][4][1])
    torch.cuda.synchronize()
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    telemetry.readings["decode"] = decode_readings

    for mode in managers:
        pipe, ids = pipes[mode], generated[mode]
        param_bytes = sum(backend.param_bytes() for backend in backends[mode].values())
        blocks = len(backends[mode])
        prefill_s, prefill_out = pipe.calls[0]
        steps = pipe.calls[1:DECODE_NEW]
        step_s = np.array([seconds for seconds, _ in steps])
        # the bytes a step must read: the resident weights and the cache up to its index
        solo_bytes = param_bytes + blocks * kv_bytes_per_position * (DECODE_PROMPT + DECODE_NEW / 2)
        round_bytes = param_bytes + blocks * kv_bytes_per_position * sum(n + DECODE_ROUNDS / 2 for n in DECODE_SESSION_PROMPTS)
        outputs, latencies, wall_s, _live, _moved = lockstep[mode]
        log(f"[decode] {mode}: prefill [1, {DECODE_PROMPT}, {hid}] through {blocks} blocks {prefill_s * 1e3:.3f} ms; "
            f"solo per-token latency median {np.median(step_s) * 1e3:.3f} ms, p90 {np.percentile(step_s, 90) * 1e3:.3f} ms "
            f"over {len(step_s)} steps; per-token bound {solo_bytes / peaks['bytes'] * 1e3:.4f} ms "
            f"({solo_bytes / 1e9:.3f} GB of resident weights and caches over the card's HBM peak)")
        log(f"[decode] {mode}: {DECODE_SESSIONS} sessions x {DECODE_ROUNDS} lock-step rounds: per-token latency median "
            f"{np.median(latencies) * 1e3:.3f} ms, p90 {np.percentile(latencies, 90) * 1e3:.3f} ms; "
            f"{DECODE_SESSIONS * DECODE_ROUNDS / wall_s:.1f} tokens/s aggregate; per-round bound "
            f"{round_bytes / peaks['bytes'] * 1e3:.4f} ms ({DECODE_SESSIONS * peaks['bytes'] / round_bytes:.1f} tokens/s); "
            f"merged step sizes {sorted(set(merged[mode]))} in {len(merged[mode])} calls")
        cache_bytes = decode_cache_bytes(config, 1, DECODE_MAX_LEN)
        block_bytes = predict_block_param_bytes(config, modes[mode])
        capacity = plan_block_capacity(block_bytes, device="cuda", decode_sessions=DECODE_SESSIONS,
                                       cache_bytes_per_session_block=cache_bytes)
        log(f"[decode] {mode}: decode_cache_bytes(batch 1, max_len {DECODE_MAX_LEN}) = {cache_bytes}; "
            f"plan_block_capacity({block_bytes} B per block, {DECODE_SESSIONS} sessions) = {capacity} blocks on this card")
        if not merged[mode] or max(merged[mode]) < 2:
            raise AssertionError(f"{mode}: no device call merged 2 or more sessions: {merged[mode]}")

        # cached steps against the no-cache forward of the whole prefix (the flash kernel)
        if prefill_out.shape != (1, DECODE_PROMPT, hid) or not np.isfinite(prefill_out).all():
            raise AssertionError(f"{mode}: prefill output {prefill_out.shape}")
        for step in DECODE_CHECKED_STEPS:
            prefix = head.embed(ids[:, : DECODE_PROMPT + step]).cpu().numpy()
            expected = forward_chain(backends[mode], prefix)[:, -1:]
            rel_err = max_rel_err(pipe.calls[step][1], expected)
            log(f"[decode] {mode}: step {step} (position {DECODE_PROMPT + step - 1}) vs the no-cache forward of its "
                f"prefix: max_rel_err={rel_err:.3e}")
            if not rel_err < SERVING_TOL:
                raise AssertionError(f"{mode}: cached step {step} differs from the no-cache forward by {rel_err}")
        # the generated ids, by a teacher-forced replay without cache
        gaps = greedy_gaps(head, backends[mode], ids, DECODE_PROMPT)
        flips = int((gaps > 0).sum())
        log(f"[decode] {mode}: generated {DECODE_NEW} tokens {ids[0, DECODE_PROMPT:DECODE_PROMPT + 8].tolist()}...; "
            f"teacher-forced replay: {flips} near-tie flips, largest logit gap {gaps.max():.3e} (limit {GREEDY_LOGIT_RTOL})")
        if not gaps.max() <= GREEDY_LOGIT_RTOL:
            raise AssertionError(f"{mode}: a generated token's logit lies {gaps.max()} below the best")
        # every lock-step session against the same session decoded alone
        worst = 0.0
        for i, sid in enumerate(sessions):
            alone = f"alone-{i}"
            pipe.decode_step(head.embed(session_prompts[i]), alone, reset=True)
            for round_index, x in enumerate(inputs[sid]):
                worst = max(worst, max_rel_err(outputs[sid][round_index], pipe.decode_step(x, alone)))
        log(f"[decode] {mode}: lock-step sessions vs each decoded alone: max_rel_err={worst:.3e}")
        if not worst < SERVING_TOL:
            raise AssertionError(f"{mode}: merged steps differ from the sessions decoded alone by {worst}")
        # where a step's time goes: one more solo step, and one more lock-step round
        pipe.decode_step(head.embed(prompt), "profiled", reset=True)
        token = head.embed(ids[:, DECODE_PROMPT : DECODE_PROMPT + 1])
        log_profile(f"{mode} solo decode step through {blocks} blocks",
                    *profile_call(torch, lambda: pipe.decode_step(token, "profiled")))
        extra = {sid: inputs[sid][:1] for sid in sessions}
        log_profile(f"{mode} lock-step round of {DECODE_SESSIONS} sessions through {blocks} blocks",
                    *profile_call(torch, lambda: asyncio.run(lockstep_rounds(managers[mode], list(backends[mode]),
                                                                              sessions, extra, rounds=1))))

    # the prefill and the first step against the CPU plain path
    for mode, quantization in modes.items():
        cpu_blocks = plain_blocks(checkpoint_dir, quantization, cpu_blocks_loaded)
        cpu_pipe = LocalPipe(DecodeSessionManager(cpu_blocks, max_len=DECODE_MAX_LEN), cpu_blocks)
        ids = generated[mode]
        cpu_pipe.decode_step(head.embed(prompt).cpu(), "cpu", reset=True)
        cpu_pipe.decode_step(head.embed(ids[:, DECODE_PROMPT : DECODE_PROMPT + 1]).cpu(), "cpu")
        for index, what in ((0, "prefill"), (1, "first step")):
            rel_err = max_rel_err(pipes[mode].calls[index][1], cpu_pipe.calls[index][1])
            log(f"[decode] {mode}: {what} card vs CPU plain path: max_rel_err={rel_err:.3e}")
            if not rel_err < SERVING_TOL:
                raise AssertionError(f"{mode}: decode {what} differs from the CPU by {rel_err}")
        del cpu_blocks, cpu_pipe
    cpu_blocks_loaded.clear()  # [decode] is their last reader
    return launches


# ------------------------------------------------------------------ [remote]: the served blocks over the wire


class RemotePipe:
    """``decode_step`` chained over block uids by ``RemoteExpert.decode_np``, one
    RPC per block (the remote counterpart of LocalPipe); notes each call's wall
    time and output."""

    def __init__(self, experts):
        self.experts, self.calls, self.traced_block_calls = list(experts), [], 0

    def decode_step(self, hidden, session_id, reset=False):
        from hivemind_tpu_torch.telemetry import tracing

        x = hidden.cpu().numpy() if hasattr(hidden, "cpu") else np.asarray(hidden, np.float32)
        started = time.perf_counter()
        for expert in self.experts:
            x = expert.decode_np(x, session_id, reset=reset)
            self.traced_block_calls += tracing.enabled  # a block request leaves a serving record when traced
        self.calls.append((time.perf_counter() - started, x))
        return x


def remote_chain(experts, x: np.ndarray) -> np.ndarray:
    """One request through every block over the wire, a forward RPC per block."""
    for expert in experts:
        (x,) = expert.forward_np(x)
    return x


def wire_counters(handlers) -> dict:
    """The serving wire's byte counters on both sides, and the transport's per RPC handler."""
    counters = {f"moe:{kind}:{side}": metric_value(f"hivemind_moe_bytes_{kind}_total", direction=side)
                for kind in ("sent", "received") for side in ("client", "server")}
    for handler in handlers:
        for direction in ("in", "out"):
            counters[f"rpc:{handler}:{direction}"] = metric_value("hivemind_p2p_rpc_bytes_total", handler=handler,
                                                                  direction=direction)
    return counters


async def transport_readings(client, server_id, nbytes: int) -> dict:
    """One stream of ``nbytes`` in 1 MiB messages to a sink on the server (MB/s), and
    the same bytes echoed back by another handler (the round trip of the transport
    alone: AEAD, framing, sockets, parsing)."""
    from hivemind_tpu_torch.proto import runtime_pb2

    chunk = runtime_pb2.ExpertInfoResponse(serialized_info=np.random.default_rng(SEED + 12).bytes(1 << 20))

    async def messages():
        for _ in range(nbytes >> 20):
            yield chunk

    started = time.perf_counter()
    async for _reply in client.iterate_protobuf_handler(server_id, "chip_smoke.sink", messages(),
                                                       runtime_pb2.ExpertUID):
        pass
    stream_s = time.perf_counter() - started
    started = time.perf_counter()
    echoed = 0
    async for reply in client.iterate_protobuf_handler(server_id, "chip_smoke.echo", messages(),
                                                      runtime_pb2.ExpertInfoResponse):
        echoed += len(reply.serialized_info)
    echo_s = time.perf_counter() - started
    if echoed != (nbytes >> 20) << 20:
        raise AssertionError(f"echo returned {echoed} of {nbytes} bytes")
    return dict(stream_s=stream_s, echo_s=echo_s)


async def add_transport_probes(server) -> None:
    """A sink and an echo on the server, for ``transport_readings``."""
    from hivemind_tpu_torch.proto import runtime_pb2

    async def sink(requests, context):
        total = 0
        async for request in requests:
            total += len(request.serialized_info)
        yield runtime_pb2.ExpertUID(uid=str(total))

    async def echo(requests, context):
        async for request in requests:
            yield request

    await server.add_protobuf_handler("chip_smoke.sink", sink, runtime_pb2.ExpertInfoResponse,
                                      stream_input=True, stream_output=True)
    await server.add_protobuf_handler("chip_smoke.echo", echo, runtime_pb2.ExpertInfoResponse,
                                      stream_input=True, stream_output=True)


def aead_seconds_per_byte(nbytes: int = 16 << 20) -> float:
    """Seal and open of one frame of ``nbytes`` on this host, one thread, per byte."""
    from hivemind_tpu_torch.utils._libcrypto import ChaCha20Poly1305

    cipher, nonce = ChaCha20Poly1305(bytes(32)), bytes(12)
    payload = np.random.default_rng(SEED + 13).bytes(nbytes)
    cipher.decrypt(nonce, cipher.encrypt(nonce, payload))  # warm
    started = time.perf_counter()
    for _ in range(3):
        cipher.decrypt(nonce, cipher.encrypt(nonce, payload))
    return (time.perf_counter() - started) / (3 * nbytes)


def codec_seconds(tokens: int, hid: int, repeats: int = 5) -> dict:
    """Encode and parse times of the port's proto3 codec (``proto/wire.py``) for an
    expert request holding one fp16 [1, tokens, hid] activation and one holding a
    decode step's [1, 1, hid], and of its msgpack codec for a decode step's
    metadata: the least of ``repeats`` each, on this host."""
    from hivemind_tpu_torch.compression import resolve_activation_codec, serialize_tensor
    from hivemind_tpu_torch.proto import runtime_pb2
    from hivemind_tpu_torch.utils.serializer import MSGPackSerializer

    def best(fn) -> float:
        times = []
        for _ in range(repeats):
            started = time.perf_counter()
            fn()
            times.append(time.perf_counter() - started)
        return min(times)

    fp16 = resolve_activation_codec("float16")
    rng = np.random.default_rng(SEED + 14)
    readings = {}
    for size, length in (("large", tokens), ("small", 1)):
        tensor = serialize_tensor(rng.standard_normal((1, length, hid), dtype=np.float32), fp16)
        request = runtime_pb2.ExpertRequest(uid="llama_fp.0", tensors=[tensor])
        blob = request.SerializeToString()
        readings[f"{size}_bytes"] = len(blob)
        readings[f"{size}_encode"] = best(request.SerializeToString)
        readings[f"{size}_parse"] = best(lambda: runtime_pb2.ExpertRequest.FromString(blob))
    metadata = {"session_id": "remote", "reset": False}
    packed = MSGPackSerializer.dumps(metadata)
    readings["meta_encode"] = best(lambda: MSGPackSerializer.dumps(metadata))
    readings["meta_parse"] = best(lambda: MSGPackSerializer.loads(packed))
    return readings


def phase_remote(torch, checkpoint_dir: str, wrappers: dict, telemetry: Telemetry) -> dict:
    """The served blocks answer over the wire: a server P2P with two
    ConnectionHandlers (fp16 wire, the default, and "none") over the fp and int8
    blocks on one Runtime, and a client P2P with a RemoteExpert per block, in this
    process over loopback TCP. Forward parity against the local chain, [serving]'s
    six requests at once, greedy decode through a remote pipe, autograd backward
    against a twin backend, the transport's throughput and the hooks' cost."""
    from concurrent.futures import ThreadPoolExecutor

    from hivemind_tpu_torch.moe.client import RemoteExpert
    from hivemind_tpu_torch.moe.expert_uid import ExpertInfo
    from hivemind_tpu_torch.moe.server import ConnectionHandler, DecodeSessionManager, Runtime
    from hivemind_tpu_torch.moe.server.llama_loader import LlamaClientHead, generate_greedy, load_llama_blocks
    from hivemind_tpu_torch.p2p import P2P
    from hivemind_tpu_torch.telemetry.serving import SERVING_LEDGER
    from hivemind_tpu_torch.utils.loop import get_loop_runner

    phase_started = time.perf_counter()
    hid, vocab = LLAMA2_7B["hidden_size"], LLAMA2_7B["vocab_size"]
    rng = np.random.default_rng(SEED + 11)
    sgd = lambda params: torch.optim.SGD(params, lr=EXPERT_LR)
    backends = {
        "fp": load_llama_blocks(checkpoint_dir, uid_prefix="llama_fp.", device="cuda", optimizer=sgd)[0],
        "int8": load_llama_blocks(checkpoint_dir, uid_prefix="llama_int8.", device="cuda", weight_quantization="int8")[0],
    }
    head = LlamaClientHead.load(checkpoint_dir, device="cuda")
    parity_inputs = [rng.standard_normal((1, t, hid), dtype=np.float32) for t in REMOTE_PARITY_LENGTHS]
    serving_inputs = [np.random.default_rng(SEED + 2).standard_normal((1, t, hid), dtype=np.float32)
                      for t in (*REQUEST_LENGTHS, REFERENCE_LENGTH)]  # [serving]'s requests, from its seed
    prompt = np.random.default_rng(SEED + 9).integers(0, vocab, size=(1, DECODE_PROMPT))  # [decode]'s prompt
    x_bwd = torch.tensor(rng.standard_normal((1, EXPERT_TOKENS, hid), dtype=np.float32), device="cuda")
    w_bwd = torch.tensor(rng.standard_normal((1, EXPERT_TOKENS, hid), dtype=np.float32), device="cuda")

    # local references, before the remote path's launches are counted
    expected = {mode: [forward_chain(blocks, x) for x in parity_inputs] for mode, blocks in backends.items()}
    expected_burst = {mode: [forward_chain(blocks, x) for x in serving_inputs] for mode, blocks in backends.items()}
    local_pipes, local_ids = {}, {}
    for mode, blocks in backends.items():
        local_pipes[mode] = LocalPipe(DecodeSessionManager(blocks, max_len=DECODE_MAX_LEN), blocks)
        local_ids[mode] = generate_greedy(head, local_pipes[mode], prompt, DECODE_NEW, session_id="local")
    torch.cuda.synchronize()
    log(f"[remote] loaded the blocks and ran the local references in {time.perf_counter() - phase_started:.1f} s")

    runner = get_loop_runner()
    served = {uid: backend for blocks in backends.values() for uid, backend in blocks.items()}
    wire_names = ("float16", "none")

    async def start():
        handlers = {name: ConnectionHandler(dict(served), decode_max_len=DECODE_MAX_LEN, activation_compression=name)
                    for name in wire_names}
        servers = {name: await P2P.create(listen_host="127.0.0.1") for name in wire_names}
        for name in wire_names:
            await handlers[name].add_p2p_handlers(servers[name])
        await add_transport_probes(servers["float16"])
        runtime = Runtime([pool for handler in handlers.values() for pool in handler.all_pools()])
        runtime.start()
        client = await P2P.create(listen_host="127.0.0.1")
        for server in servers.values():
            client.add_peer_addr(server.peer_id, server.get_visible_maddrs()[0])
        return handlers, servers, runtime, client

    handlers, servers, runtime, client = runner.run_coroutine(start(), return_future=True).result(60)
    experts = {name: {mode: [RemoteExpert(ExpertInfo(uid, servers[name].peer_id), client) for uid in blocks]
                      for mode, blocks in backends.items()} for name in wire_names}
    rpc_names = [f"ConnectionHandler.rpc_{kind}{suffix}" for kind in ("forward", "backward", "decode")
                 for suffix in ("", "_stream")]
    records, block_requests = [], [0]
    SERVING_LEDGER.clear()
    listener = lambda kind, record: records.append(record)  # noqa: E731
    SERVING_LEDGER.add_record_listener(listener)
    counters = wire_counters(rpc_names)
    readings = {}
    try:
        for wrapper in wrappers.values():
            wrapper.launches = 0  # the main path starts here: every request below goes over the wire
        # 1. forward parity, unary ([1, 128, 4096] is 2 MiB of fp32) and streamed
        parity = {}
        for name in wire_names:
            for mode in backends:
                for x, reference in zip(parity_inputs, expected[mode]):
                    got = remote_chain(experts[name][mode], x)
                    block_requests[0] += len(backends[mode])
                    parity[(name, mode, x.shape[1])] = max_rel_err(got, reference)
        # 2. [serving]'s requests, every one submitted at once, both modes
        SERVING_LEDGER.clear()
        burst_records = len(records)

        def timed_chain(mode, x):
            started = time.perf_counter()
            y = remote_chain(experts["float16"][mode], x)
            return y, time.perf_counter() - started

        jobs = [(mode, x) for mode in backends for x in serving_inputs]
        started = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(jobs), thread_name_prefix="chip-smoke-client") as pool:
            burst = list(pool.map(lambda job: timed_chain(*job), jobs))
        burst_wall = time.perf_counter() - started
        block_requests[0] += len(jobs) * 2
        burst_records = records[burst_records:]
        # 3. greedy decode through a remote pipe, and the hooks' cost on it
        remote_pipes, remote_ids, hooks, token_bytes = {}, {}, {}, {}
        for mode in backends:
            remote_pipes[mode] = RemotePipe(experts["float16"][mode])
            decode_before = wire_counters([])
            remote_ids[mode] = generate_greedy(head, remote_pipes[mode], prompt, DECODE_NEW, session_id="remote")
            decode_after = wire_counters([])
            token_bytes[mode] = sum(decode_after[f"moe:{kind}:client"] - decode_before[f"moe:{kind}:client"]
                                    for kind in ("sent", "received")) / DECODE_NEW
            token = head.embed(remote_ids[mode][:, DECODE_PROMPT : DECODE_PROMPT + 1])
            hooks[mode] = hooks_cost(remote_pipes[mode], head, prompt, token)
            block_requests[0] += remote_pipes[mode].traced_block_calls
        # 4. autograd through the RemoteExpert on the fp block 0 (the server steps its SGD)
        server_block = backends["fp"]["llama_fp.0"]
        before = {key: tensor.clone() for key, tensor in server_block.snapshot_params().items()}
        x_remote = x_bwd.clone().requires_grad_(True)
        y_remote = experts["float16"]["fp"][0](x_remote)
        (y_remote * w_bwd).sum().backward()
        torch.cuda.synchronize()
        block_requests[0] += 2
        launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
        # 5. the transport alone: a 16 MiB stream, and the same bytes echoed
        transport = runner.run_coroutine(transport_readings(client, servers["float16"].peer_id, REMOTE_STREAM_BYTES),
                                         return_future=True).result(60)
        timed_request = parity_inputs[-1]
        started = time.perf_counter()
        experts["float16"]["fp"][0].forward_np(timed_request)
        request_wall = time.perf_counter() - started
        block_requests[0] += 1
        deadline = time.perf_counter() + 30  # the Runtime counts a batch after its callers' results
        while len(records) < block_requests[0] and time.perf_counter() < deadline:
            time.sleep(0.001)
    finally:
        SERVING_LEDGER.remove_record_listener(listener)

        async def stop():
            await runtime.shutdown()
            await client.shutdown()
            for server in servers.values():
                await server.shutdown()

        runner.run_coroutine(stop(), return_future=True).result(60)
    after = wire_counters(rpc_names)
    delta = {key: after[key] - counters[key] for key in after}
    faults = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            faults.append(what)

    for (name, mode, length), err in sorted(parity.items()):
        limit = REMOTE_LOSSLESS_TOL if name == "none" else SERVING_TOL
        log(f"[remote] forward parity, {name} wire, {mode}, [1, {length}, {hid}] "
            f"({'unary' if length * hid * 4 <= 2 << 20 else 'stream'}) through 2 blocks vs the local chain: "
            f"max_rel_err={err:.3e} (limit {'<=' if name == 'none' else '<'} {limit:g})")
        check(err <= limit if name == "none" else err < limit, f"{name} {mode} [1, {length}]: rel err {err}")
    # 4. backward: the twin backend takes the same SGD step locally
    twin = load_llama_blocks(checkpoint_dir, layers=[0], uid_prefix="llama_fp.", device="cuda", optimizer=sgd)[0]["llama_fp.0"]
    twin_before = {key: tensor.clone() for key, tensor in twin.snapshot_params().items()}
    (twin_grad,) = twin.backward(x_bwd.cpu().numpy(), w_bwd.cpu().numpy())
    grad_err = max_rel_err(x_remote.grad.cpu().numpy(), twin_grad)
    step_err = max(max_rel_err((server_block.params[key] - before[key]).cpu().numpy(),
                               (twin.params[key] - twin_before[key]).cpu().numpy()) for key in before)
    log(f"[remote] autograd through RemoteExpert llama_fp.0 at [1, {EXPERT_TOKENS}, {hid}] (fp16 wire): input gradient "
        f"vs the twin's ModuleBackend.backward max_rel_err={grad_err:.3e}; the server's SGD step vs the twin's: "
        f"max_rel_err={step_err:.3e} (limit {SERVING_TOL}); server updates {server_block.update_count}")
    check(grad_err < SERVING_TOL and step_err < SERVING_TOL and server_block.update_count == 1,
          f"backward: gradient {grad_err}, step {step_err}, updates {server_block.update_count}")
    with torch.no_grad():  # the weights the decode run used, for its replay below
        for key, tensor in before.items():
            server_block.params[key].copy_(tensor)
    del twin, twin_before
    local_serving = telemetry.readings.get("serving", {}).get("latencies", {})
    for mode in backends:
        walls = [seconds for (job_mode, _x), (_y, seconds) in zip(jobs, burst) if job_mode == mode]
        outputs = [y for (job_mode, _x), (y, _s) in zip(jobs, burst) if job_mode == mode]
        check(all(y.shape == x.shape and np.isfinite(y).all() for y, x in zip(outputs, serving_inputs)),
              f"{mode}: a burst output is not finite or has the wrong shape")
        # requests of many clients share the pools' batches: each must get its own rows back
        burst_err = max(max_rel_err(y, reference) for y, reference in zip(outputs, expected_burst[mode]))
        check(burst_err < SERVING_TOL, f"{mode}: a burst output differs from its local chain by {burst_err}")
        local = local_serving.get(mode)
        log(f"[remote] {mode}: [serving]'s {len(serving_inputs)} requests at once through the wire (fp16): each "
            f"output vs the local chain on its input max_rel_err={burst_err:.3e} (limit {SERVING_TOL}); request "
            f"wall median / p90 {median_p90(walls)}" + (f"; in [serving], locally: {median_p90(local)}" if local else ""))
    log(f"[remote] the burst of {len(jobs)} chained requests took {burst_wall * 1e3:.1f} ms")
    for mode in backends:
        mine = [r for r in burst_records if r["expert"].startswith(f"llama_{mode}.")]
        phases = {field: [r.get(field, 0.0) for r in mine]
                  for field in ("queue_wait_s", "assembly_s", "compute_s", "serialize_s", "total_s")}
        log(f"[remote] serving records, {mode} burst: {len(mine)} block requests, median / p90: queue wait "
            f"{median_p90(phases['queue_wait_s'])}, assembly {median_p90(phases['assembly_s'])}, compute "
            f"{median_p90(phases['compute_s'])}, serialize {median_p90(phases['serialize_s'])} (streamed responses "
            f"serialize lazily and carry none), request wall {median_p90(phases['total_s'])}")
    for mode in backends:
        remote_step = np.array([s for s, _ in remote_pipes[mode].calls[1:DECODE_NEW]])
        local_step = np.array([s for s, _ in local_pipes[mode].calls[1:DECODE_NEW]])
        equal = bool(np.array_equal(remote_ids[mode], local_ids[mode]))
        gaps = greedy_gaps(head, backends[mode], remote_ids[mode], DECODE_PROMPT)
        decode_records = [r for r in records if r["kind"] == "decode" and r["expert"].startswith(f"llama_{mode}.")]
        span_s = [r["total_s"] for r in decode_records]
        compute = [r.get("compute_s", 0.0) for r in decode_records]
        serialize = [r.get("serialize_s", 0.0) for r in decode_records]
        log(f"[remote] decode {mode}: {DECODE_NEW} tokens from a {DECODE_PROMPT}-token prompt through a remote pipe; "
            f"ids equal to the local pipe's: {equal}; teacher-forced replay largest logit gap {gaps.max():.3e} "
            f"(limit {GREEDY_LOGIT_RTOL}); per-token latency median / p90 remote {median_p90(remote_step)}, local "
            f"{median_p90(local_step)} (ratio {np.median(remote_step) / np.median(local_step):.2f}); prefill remote "
            f"{remote_pipes[mode].calls[0][0] * 1e3:.3f} ms, local {local_pipes[mode].calls[0][0] * 1e3:.3f} ms; "
            f"the server's decode records ({len(decode_records)}, prefills included) median / p90: span "
            f"{median_p90(span_s)}, compute {median_p90(compute)}, serialize {median_p90(serialize)}; "
            f"{token_bytes[mode]:.0f} B on the wire per generated token (the prefill included)")
        check(gaps.max() <= GREEDY_LOGIT_RTOL, f"{mode}: a remotely generated token's logit lies {gaps.max()} below the best")
        readings[mode] = dict(remote_step=remote_step, local_step=local_step, equal=equal, hooks=hooks[mode])
    # counters, exact: both sides of the serving wire and of the transport
    check(delta["moe:sent:client"] == delta["moe:received:server"] > 0,
          f"client sent {delta['moe:sent:client']} B, server received {delta['moe:received:server']} B")
    check(delta["moe:sent:server"] == delta["moe:received:client"] > 0,
          f"server sent {delta['moe:sent:server']} B, client received {delta['moe:received:client']} B")
    rpc_out = sum(delta[f"rpc:{name}:out"] for name in rpc_names)
    rpc_in = sum(delta[f"rpc:{name}:in"] for name in rpc_names)
    check(rpc_out == rpc_in == delta["moe:sent:client"] + delta["moe:sent:server"],
          f"transport bytes out {rpc_out}, in {rpc_in}, serving wire {delta['moe:sent:client'] + delta['moe:sent:server']}")
    check(len(records) == block_requests[0], f"{len(records)} serving records, {block_requests[0]} block requests")
    unsound = [r for r in records if not (r.get("compute_s", 0.0) > 0 and sum(r.get(field, 0.0) for field in (
        "queue_wait_s", "assembly_s", "compute_s", "serialize_s")) <= r["total_s"] + PHASE_ROUNDING_S)]
    check(not unsound, f"records whose phases exceed the span or carry no compute: {unsound[:2]}")
    log(f"[remote] counters: client sent {delta['moe:sent:client']:.0f} B = server received; server sent "
        f"{delta['moe:sent:server']:.0f} B = client received; transport out {rpc_out:.0f} B = in; "
        f"{len(records)} serving records for {block_requests[0]} block requests")
    aead_s = aead_seconds_per_byte()
    request_bytes = 2 * timed_request.size * 2  # fp16 both ways
    stream_mb_s = REMOTE_STREAM_BYTES / transport["stream_s"] / 1e6
    log(f"[remote] transport on this host: one {REMOTE_STREAM_BYTES >> 20} MiB stream at {stream_mb_s:.1f} MB/s; the "
        f"same bytes echoed back in {transport['echo_s'] * 1e3:.1f} ms; AEAD seal + open {1 / aead_s / 1e6:.1f} MB/s "
        f"on one thread; a remote [1, {timed_request.shape[1]}, {hid}] block request (fp16 wire, {request_bytes} B "
        f"both ways) took {request_wall * 1e3:.1f} ms, of which AEAD {aead_s * request_bytes / request_wall:.1%} "
        f"and the transport's round trip of its bytes {transport['echo_s'] * request_bytes / (2 * REMOTE_STREAM_BYTES) / request_wall:.1%}")
    codec = codec_seconds(timed_request.shape[1], hid)
    log(f"[remote] the port's own codecs on this host (best of 5): a [1, {timed_request.shape[1]}, {hid}] fp16 "
        f"request message ({codec['large_bytes']} B) encodes in {codec['large_encode'] * 1e3:.3f} ms and parses in "
        f"{codec['large_parse'] * 1e3:.3f} ms, {2 * (codec['large_encode'] + codec['large_parse']) / request_wall:.1%} "
        f"of the remote request above (request and response); a decode step's [1, 1, {hid}] request "
        f"({codec['small_bytes']} B) {codec['small_encode'] * 1e6:.1f} / {codec['small_parse'] * 1e6:.1f} us, its "
        f"msgpack metadata {codec['meta_encode'] * 1e6:.1f} / {codec['meta_parse'] * 1e6:.1f} us")
    elapsed = time.perf_counter() - phase_started
    log(f"[remote] phase wall {elapsed:.1f} s (limit {REMOTE_PHASE_LIMIT_S} s)")
    check(elapsed <= REMOTE_PHASE_LIMIT_S, f"[remote] took {elapsed:.1f} s > {REMOTE_PHASE_LIMIT_S} s")
    telemetry.readings["remote"] = dict(records=burst_records, decode=readings)
    if faults:
        raise AssertionError("; ".join(faults))
    return launches


def swarm_server_main(conn, checkpoint_dir: str, layer: int, initial_peers: list) -> None:
    """One server process of ``[swarm]``: its own DHT peer, bootstrapped from the
    parent's, and a Server over ``load_llama_blocks`` on ``cuda`` for one block, fp
    (SGD) and int8. Answers the parent's commands over ``conn``: ``reset`` (kernel
    launch counts and serving records to 0), ``clear`` (serving records), ``report``
    (launch counts, the medians of its ``serving.request`` spans by prefix and kind,
    and its blocks' update counts) and ``stop``."""
    import traceback

    try:
        import torch

        from hivemind_tpu_torch.dht import DHT
        from hivemind_tpu_torch.moe.server import Server, load_llama_blocks
        from hivemind_tpu_torch.ops import blockwise_int8, flash_attention
        from hivemind_tpu_torch.telemetry.serving import SERVING_LEDGER

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        wrappers = {
            "flash_attention_forward": flash_attention.flash_attention_lse,
            "flash_attention_backward_dq": flash_attention.flash_attention_backward_dq,
            "flash_attention_backward_dkv": flash_attention.flash_attention_backward_dkv,
            "blockwise_int8_quantize": blockwise_int8.blockwise_int8_quantize,
            "blockwise_int8_dequantize": blockwise_int8.blockwise_int8_dequantize,
        }
        sgd = lambda params: torch.optim.SGD(params, lr=EXPERT_LR)  # noqa: E731
        backends = {}
        for mode, prefix in SWARM_PREFIXES.items():
            options = {"weight_quantization": "int8"} if mode == "int8" else {"optimizer": sgd}
            backends.update(load_llama_blocks(checkpoint_dir, layers=[layer], uid_prefix=prefix, device="cuda",
                                              **options)[0])
        devices = sorted({backend.device.type for backend in backends.values()})
        if devices != ["cuda"]:
            raise RuntimeError(f"a swarm server's blocks are on {devices}, not the card")
        records = []
        SERVING_LEDGER.add_record_listener(lambda kind, record: records.append(record))
        dht = DHT(initial_peers=initial_peers, start=True)
        server = Server(dht, backends, decode_max_len=DECODE_MAX_LEN)
        server.run_in_background(await_ready=True, timeout=60)
        conn.send(("ready", dht.peer_id.to_base58(), torch.cuda.get_device_name(torch.cuda.current_device())))
        while True:
            command = conn.recv()
            if command == "reset":
                for wrapper in wrappers.values():
                    wrapper.launches = 0
                records.clear()
            elif command == "clear":
                records.clear()
            elif command == "report":
                spans = {}
                for mode, prefix in SWARM_PREFIXES.items():
                    for kind in ("forward", "backward", "decode"):
                        mine = [r["total_s"] for r in records if r["kind"] == kind and r["expert"].startswith(prefix)]
                        if mine:
                            spans[f"{mode}:{kind}"] = (float(np.median(mine)), float(np.percentile(mine, 90)), len(mine))
                updates = {uid: backend.update_count for uid, backend in backends.items()}
                conn.send(("report", {name: wrapper.launches for name, wrapper in wrappers.items()}, spans, updates))
                continue
            elif command == "stop":
                server.shutdown()
                dht.shutdown()
                conn.send(("stopped",))
                return
            conn.send(("ok",))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise


class SwarmChild:
    """The parent's handle on one server process of ``[swarm]``."""

    def __init__(self, context, checkpoint_dir: str, layer: int, initial_peers: list):
        self.layer, self.name = layer, f"the server process of block {layer}"
        self.conn, child_conn = context.Pipe()
        self.process = context.Process(target=swarm_server_main, args=(child_conn, checkpoint_dir, layer, initial_peers),
                                       daemon=True)
        self.process.start()
        child_conn.close()
        self.peer_id = self.device = self.last_report = None

    def receive(self, timeout: float):
        if not self.conn.poll(max(timeout, 0.0)):
            raise TimeoutError(f"{self.name} (pid {self.process.pid}) did not answer in {timeout:.0f} s")
        try:
            reply = self.conn.recv()
        except EOFError:
            raise RuntimeError(f"{self.name} exited with code {self.process.exitcode}") from None
        if reply[0] == "error":
            raise RuntimeError(f"{self.name} failed:\n{reply[1]}")
        return reply

    def ask(self, command, timeout: float = 30.0):
        self.conn.send(command)
        return self.receive(timeout)

    def report(self) -> dict:
        _, counts, spans, updates = self.ask("report")
        self.last_report = dict(counts=counts, spans=spans, updates=updates)
        return self.last_report

    def kill(self) -> None:
        if self.process.is_alive():
            os.kill(self.process.pid, signal.SIGKILL)
        self.process.join(10)


class SwarmPipe:
    """``decode_step`` through a RemoteSequential, noting each call's wall time and
    output; ``after_prefill()`` runs once the prefill has returned, and
    ``before_step(n)`` before the n-th call."""

    def __init__(self, sequential, after_prefill=None, before_step=None):
        self.sequential, self.after_prefill, self.before_step = sequential, after_prefill, before_step
        self.calls = []

    def decode_step(self, hidden, session_id, reset=False):
        if self.before_step is not None:
            self.before_step(len(self.calls))
        started = time.perf_counter()
        out = self.sequential.decode_step(hidden, session_id, reset=reset)
        self.calls.append((time.perf_counter() - started, out))
        if reset and self.after_prefill is not None:
            self.after_prefill()
        return out


def phase_swarm(torch, checkpoint_dir: str, wrappers: dict, telemetry: Telemetry) -> dict:
    """Peers find the blocks through the DHT and generate over them, across processes:
    this process is a bootstrap DHT peer and the client (``DHT(initial_peers=...)``,
    ``RemoteSequential``, ``LlamaClientHead``); three server processes (children) are each
    a DHT peer with a ``Server`` over ``load_llama_blocks`` on the card (SWARM_LAYOUT).
    Forward, greedy decode (fp and int8), failover when the replica pinned for block 1
    is killed, and autograd backward last, each against the local chain. Returns the
    launch counts summed over the server processes."""
    import multiprocessing
    import threading

    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.moe import RemoteSequential, get_experts
    from hivemind_tpu_torch.moe.server import DecodeSessionManager
    from hivemind_tpu_torch.moe.server.llama_loader import LlamaClientHead, generate_greedy, load_llama_blocks

    phase_started = time.perf_counter()
    hid, vocab = LLAMA2_7B["hidden_size"], LLAMA2_7B["vocab_size"]
    rng = np.random.default_rng(SEED + 13)
    backends = {  # the local twins: SGD at learning rate 0, so their backward leaves the replay's weights alone
        "fp": load_llama_blocks(checkpoint_dir, uid_prefix=SWARM_PREFIXES["fp"], device="cuda")[0],
        "int8": load_llama_blocks(checkpoint_dir, uid_prefix=SWARM_PREFIXES["int8"], device="cuda",
                                  weight_quantization="int8")[0],
    }
    head = LlamaClientHead.load(checkpoint_dir, device="cuda")
    x_forward = rng.standard_normal((1, SWARM_FORWARD_LENGTH, hid), dtype=np.float32)
    prompt = np.random.default_rng(SEED + 9).integers(0, vocab, size=(1, DECODE_PROMPT))  # [decode]'s prompt
    x_bwd = rng.standard_normal((1, EXPERT_TOKENS, hid), dtype=np.float32)
    w_bwd = rng.standard_normal((1, EXPERT_TOKENS, hid), dtype=np.float32)

    # local references, in this process (the servers count their own launches)
    expected = {mode: forward_chain(blocks, x_forward) for mode, blocks in backends.items()}
    local_pipes, local_ids = {}, {}
    for mode, blocks in backends.items():
        local_pipes[mode] = LocalPipe(DecodeSessionManager(blocks, max_len=DECODE_MAX_LEN), blocks)
        local_ids[mode] = generate_greedy(head, local_pipes[mode], prompt, DECODE_NEW, session_id="local")
    fp0, fp1 = backends["fp"].values()
    hidden_1 = fp0.forward(x_bwd)[0]
    (grad_1,) = fp1.backward(hidden_1, w_bwd)
    (twin_grad,) = fp0.backward(x_bwd, grad_1)
    torch.cuda.synchronize()
    log(f"[swarm] loaded the blocks and ran the local references in {time.perf_counter() - phase_started:.1f} s")

    context = multiprocessing.get_context("forkserver")  # CHILD_PRELOAD
    children, dhts, faults, readings = [], [], [], {}
    timer = None

    def check(ok: bool, what: str) -> None:
        if not ok:
            faults.append(what)

    def kill_all() -> None:
        for child in children:
            child.kill()

    try:
        started = time.perf_counter()
        bootstrap = DHT(start=True)
        dhts.append(bootstrap)
        initial_peers = [str(maddr) for maddr in bootstrap.get_visible_maddrs()]
        children.extend(SwarmChild(context, checkpoint_dir, layer, initial_peers) for layer in SWARM_LAYOUT)
        # a child or a call that hangs past the limit: the servers are killed, which fails every call in flight
        timer = threading.Timer(SWARM_PHASE_LIMIT_S, kill_all)
        timer.daemon = True
        timer.start()
        for child in children:
            _, child.peer_id, child.device = child.receive(SWARM_STARTUP_LIMIT_S - (time.perf_counter() - started))
        servers_up = time.perf_counter() - started
        by_peer = {child.peer_id: child for child in children}
        started = time.perf_counter()
        client_dht = DHT(initial_peers=initial_peers, start=True)
        dhts.append(client_dht)
        bootstrap_s = time.perf_counter() - started
        # every block of both prefixes resolves through the DHT alone, block 1 with both replicas
        uids = [f"{prefix}{index}" for prefix in SWARM_PREFIXES.values() for index in range(2)]
        started = time.perf_counter()
        while True:
            infos = get_experts(client_dht, uids)
            replicas = [len(info.replica_set) if info is not None else 0 for info in infos]
            if replicas == [1, 2, 1, 2] or time.perf_counter() - started > 30:
                break
            time.sleep(0.05)
        resolve_s = time.perf_counter() - started
        if replicas != [1, 2, 1, 2]:
            raise AssertionError(f"the DHT resolved {dict(zip(uids, replicas))} replicas")
        owners = {uid: sorted(by_peer[r.peer_id.to_base58()].layer for r in info.replica_set)
                  for uid, info in zip(uids, infos)}
        log(f"[swarm] 3 server processes up in {servers_up:.1f} s (devices {sorted({c.device for c in children})}); "
            f"the client's DHT bootstrapped in {bootstrap_s * 1e3:.1f} ms; {len(uids)} block uids resolved through "
            f"the DHT in {resolve_s * 1e3:.1f} ms, served by the processes of blocks {owners}")
        pipes = {mode: RemoteSequential(client_dht, prefix, 2) for mode, prefix in SWARM_PREFIXES.items()}
        for child in children:
            child.ask("reset")
        for wrapper in wrappers.values():
            wrapper.launches = 0  # the main path starts here; the servers count their own launches
        # 1. forward through the pipe
        with torch.no_grad():
            for mode, pipe in pipes.items():
                got = pipe(torch.tensor(x_forward, device="cuda")).cpu().numpy()
                err = max_rel_err(got, expected[mode])
                log(f"[swarm] forward {mode} [1, {SWARM_FORWARD_LENGTH}, {hid}] through the pipe (2 server "
                    f"processes, fp16 wire) vs the local chain: max_rel_err={err:.3e} (limit {SERVING_TOL})")
                check(err < SERVING_TOL, f"forward {mode}: rel err {err}")
        # 2. solo greedy generation, fp and int8; the servers' records then hold the steps alone
        swarm_pipes, swarm_ids, token_bytes, spans = {}, {}, {}, {}
        for mode, pipe in pipes.items():
            swarm_pipes[mode] = SwarmPipe(pipe, after_prefill=lambda: [child.ask("clear") for child in children])
            before = wire_counters([])
            swarm_ids[mode] = generate_greedy(head, swarm_pipes[mode], prompt, DECODE_NEW, session_id=f"swarm-{mode}")
            after = wire_counters([])
            token_bytes[mode] = sum(after[f"moe:{kind}:client"] - before[f"moe:{kind}:client"]
                                    for kind in ("sent", "received")) / DECODE_NEW
            route = [by_peer[block.peer_id.to_base58()] for block, _span in pipe._decode_routes[f"swarm-{mode}"]["route"]]
            spans[mode] = [(child, child.report()["spans"].get(f"{mode}:decode")) for child in route]
        # 3. failover: kill the process of the replica this session pinned for block 1
        killed = {}
        failover_pipe = RemoteSequential(client_dht, SWARM_PREFIXES["fp"], 2, max_retries=4)

        def kill_pinned(calls: int) -> None:
            if calls != SWARM_KILL_AFTER or killed:  # before that call, SWARM_KILL_AFTER tokens are out
                return
            victim = by_peer[failover_pipe._decode_routes["swarm-failover"]["route"][-1][0].peer_id.to_base58()]
            victim.report()  # its launch counts, before it dies
            victim.kill()
            killed.update(child=victim, exitcode=victim.process.exitcode)

        failover = SwarmPipe(failover_pipe, before_step=kill_pinned)
        failover_ids = generate_greedy(head, failover, prompt, DECODE_NEW, session_id="swarm-failover")
        final_route = [by_peer[block.peer_id.to_base58()]
                       for block, _span in failover_pipe._decode_routes["swarm-failover"]["route"]]
        # 4. autograd backward through the pipe (the servers step their SGD)
        x_remote = torch.tensor(x_bwd, device="cuda", requires_grad=True)
        y_remote = pipes["fp"](x_remote)
        (y_remote * torch.tensor(w_bwd, device="cuda")).sum().backward()
        torch.cuda.synchronize()
        grad_err = max_rel_err(x_remote.grad.cpu().numpy(), twin_grad)
        for child in children:
            if child.process.is_alive():
                child.report()
    finally:
        if timer is not None:
            timer.cancel()
        for child in children:
            if child.process.is_alive():
                with contextlib.suppress(Exception):
                    child.ask("stop", timeout=20)
            child.kill()
        for dht in reversed(dhts):
            dht.shutdown()

    launches = {name: sum(child.last_report["counts"].get(name, 0) for child in children if child.last_report)
                for name in wrappers}
    log(f"[swarm] launches summed over the server processes (the killed one's read just before its kill): "
        f"{json.dumps(launches)}")
    for mode in pipes:
        steps = np.array([seconds for seconds, _ in swarm_pipes[mode].calls[1:]])
        equal = bool(np.array_equal(swarm_ids[mode], local_ids[mode]))
        gaps = greedy_gaps(head, backends[mode], swarm_ids[mode], DECODE_PROMPT)
        local_step = np.array([seconds for seconds, _ in local_pipes[mode].calls[1:]])
        in_process = telemetry.readings.get("remote", {}).get("decode", {}).get(mode, {}).get("remote_step")
        served = [(child.layer, span) for child, span in spans[mode] if span is not None]
        outside = float(np.median(steps)) - sum(span[0] for _, span in served)
        log(f"[swarm] decode {mode}: {DECODE_NEW} tokens from a {DECODE_PROMPT}-token prompt across processes; ids "
            f"equal to the local pipe's: {equal}; teacher-forced replay largest logit gap {gaps.max():.3e} (limit "
            f"{GREEDY_LOGIT_RTOL}); per-token latency median / p90 {median_p90(steps)}; locally ([decode]'s pipe) "
            f"{median_p90(local_step)}"
            + (f"; in one process over loopback ([remote]) {median_p90(in_process)}" if in_process is not None else "")
            + f"; prefill (the server processes' first decode call) {swarm_pipes[mode].calls[0][0] * 1e3:.3f} ms; each server's span of a decode step, median "
            f"(p90, steps): " + ", ".join(f"block {layer} {span[0] * 1e3:.3f} ms ({span[1] * 1e3:.3f} ms, {span[2]})"
                                          for layer, span in served)
            + f"; the client's time outside the servers' spans {outside * 1e3:.3f} ms a step; "
            f"{token_bytes[mode]:.0f} B on the wire per generated token (the prefill included)")
        check(gaps.max() <= GREEDY_LOGIT_RTOL, f"{mode}: a token generated across processes lies {gaps.max()} "
                                               f"below the best")
        check(len(served) == 2, f"{mode}: {len(served)} servers reported decode spans")
        readings[mode] = dict(steps=steps, outside=outside, served=served, token_bytes=token_bytes[mode])
    check(bool(killed), "no replica was killed during the failover run")
    if killed:
        failover_equal = bool(np.array_equal(failover_ids, swarm_ids["fp"]))
        gaps = greedy_gaps(head, backends["fp"], failover_ids, DECODE_PROMPT)
        steps = [seconds for seconds, _ in failover.calls[1:]]
        failed_over = failover.calls[SWARM_KILL_AFTER][0]
        others = np.array(steps[:SWARM_KILL_AFTER - 1] + steps[SWARM_KILL_AFTER:])
        log(f"[swarm] failover: the process of the block-1 replica pinned by the session was SIGKILLed (exit code "
            f"{killed['exitcode']}) after {SWARM_KILL_AFTER} tokens; the session went on through the processes of "
            f"blocks {[child.layer for child in final_route]}; ids equal to the uninterrupted run: {failover_equal}; "
            f"teacher-forced replay largest logit gap {gaps.max():.3e} (limit {GREEDY_LOGIT_RTOL}); the failed-over "
            f"token took {failed_over * 1e3:.1f} ms (re-resolution and re-prefill of the retained "
            f"{DECODE_PROMPT + SWARM_KILL_AFTER} positions), the other tokens median / p90 {median_p90(others)}")
        check(killed["exitcode"] == -signal.SIGKILL, f"the killed replica exited with {killed['exitcode']}")
        check(killed["child"].layer == 1 and final_route[-1].layer == 1 and final_route[-1] is not killed["child"],
              f"the session did not move to the other replica: blocks {[child.layer for child in final_route]}")
        check(failover_equal or gaps.max() <= GREEDY_LOGIT_RTOL, f"failover: a token lies {gaps.max()} below the best")
        readings["failover"] = dict(token_s=failed_over, others=others, equal=failover_equal)
    updates = sorted((uid, child.layer, child is killed.get("child"), count) for child in children if child.last_report
                     for uid, count in child.last_report["updates"].items() if uid.startswith(SWARM_PREFIXES["fp"]))
    log(f"[swarm] autograd through the pipe at [1, {EXPERT_TOKENS}, {hid}] (fp16 wire): input gradient vs the local "
        f"chain's ModuleBackend.backward max_rel_err={grad_err:.3e} (limit {SERVING_TOL}); updates of the fp blocks "
        f"(uid, process's block, killed, updates): {updates}")
    check(grad_err < SERVING_TOL, f"backward: gradient rel err {grad_err}")
    check([count for *_, killed_one, count in updates if not killed_one] == [1, 1],
          f"backward: each live fp block steps once, the updates are {updates}")
    elapsed = time.perf_counter() - phase_started
    log(f"[swarm] phase wall {elapsed:.1f} s (limit {SWARM_PHASE_LIMIT_S} s)")
    check(elapsed <= SWARM_PHASE_LIMIT_S, f"[swarm] took {elapsed:.1f} s > {SWARM_PHASE_LIMIT_S} s")
    telemetry.readings["swarm"] = readings
    if faults:
        raise AssertionError("; ".join(faults))
    return launches


def relay_server_main(conn, checkpoint_dir: str, initial_peers: list) -> None:
    """The server process of ``[relay]``: a NATed peer. Its DHT announces a port that
    nothing listens on (an unforwarded NAT mapping), so a direct dial to it is refused;
    a Server over ``load_llama_blocks`` serves the two fp blocks on ``cuda``. Answers
    the parent over ``conn``: ``("autorelay", bootstrap)`` runs ``AutoRelay.create``
    with the AutoNAT dial-back through the bootstrap peer and replies with its diagnosis,
    the relays it registered at and its seconds; ``reset`` and ``report`` (the flash
    forward's launches) and ``stop``."""
    import socket
    import traceback

    try:
        import torch

        from hivemind_tpu_torch.dht import DHT
        from hivemind_tpu_torch.moe.server import Server, load_llama_blocks
        from hivemind_tpu_torch.ops import flash_attention
        from hivemind_tpu_torch.p2p import AutoRelay, PeerID
        from hivemind_tpu_torch.utils.loop import get_loop_runner

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        forward = flash_attention.flash_attention_lse
        backends = load_llama_blocks(checkpoint_dir, uid_prefix=RELAY_PREFIX, device="cuda")[0]
        devices = sorted({backend.device.type for backend in backends.values()})
        if devices != ["cuda"]:
            raise RuntimeError(f"the relay server's blocks are on {devices}, not the card")
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            dead_port = probe.getsockname()[1]
        dht = DHT(initial_peers=initial_peers, start=True, announce_port=dead_port)
        server = Server(dht, backends, decode_max_len=DECODE_MAX_LEN)
        server.run_in_background(await_ready=True, timeout=60)
        runner, auto = get_loop_runner(), None
        conn.send(("ready", dht.peer_id.to_base58(), torch.cuda.get_device_name(torch.cuda.current_device())))
        while True:
            command = conn.recv()
            if command[0] == "autorelay":
                started = time.perf_counter()
                p2p = runner.run_coroutine(dht.replicate_p2p())
                auto = runner.run_coroutine(AutoRelay.create(p2p, dht, probe_via=PeerID.from_base58(command[1])))
                conn.send(("autorelay", auto.natted, sorted(f"{host}:{port}" for host, port in auto.relay_clients),
                           time.perf_counter() - started, [str(maddr) for maddr in p2p.get_visible_maddrs()]))
                continue
            if command[0] == "reset":
                forward.launches = 0
            elif command[0] == "report":
                conn.send(("report", {"flash_attention_forward": forward.launches}))
                continue
            elif command[0] == "stop":
                if auto is not None:
                    runner.run_coroutine(auto.close())
                server.shutdown()
                dht.shutdown()
                conn.send(("stopped",))
                return
            conn.send(("ok",))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise


class RelayChild(SwarmChild):
    """The parent's handle on the server process of ``[relay]``."""

    def __init__(self, context, checkpoint_dir: str, initial_peers: list):
        self.layer, self.name = "relay", "the NATed server process of [relay]"
        self.conn, child_conn = context.Pipe()
        self.process = context.Process(target=relay_server_main, args=(child_conn, checkpoint_dir, initial_peers),
                                       daemon=True)
        self.process.start()
        child_conn.close()
        self.peer_id = self.device = self.last_report = None

    def ask(self, *command, timeout: float = 30.0):
        self.conn.send(command)
        return self.receive(timeout)

    def report(self) -> dict:
        _, counts = self.ask("report")
        self.last_report = dict(counts=counts)
        return self.last_report


def timed_median(fn, runs: int) -> tuple:
    """(the median wall of ``runs`` calls of ``fn``, the last call's result)."""
    walls = []
    for _ in range(runs):
        started = time.perf_counter()
        result = fn()
        walls.append(time.perf_counter() - started)
    return float(np.median(walls)), result


def phase_relay(torch, checkpoint_dir: str, wrappers: dict, telemetry: Telemetry) -> dict:
    """The relay tier on the card's host. This process is a bootstrap DHT peer (with an
    AutoRelay, so it serves the AutoNAT dial-back) and runs ``python -m
    hivemind_tpu_torch.hivemind_cli.run_relay`` as a child, which builds the port's relay
    daemon from source, starts it and advertises it in the DHT; its banner must show an
    Ed25519 identity (authenticated registration). One server process (forked as
    [swarm]'s are) serves the two fp Llama-2-7B-width blocks on the card behind a DHT that
    announces a dead port: its AutoRelay must find it NATed, register at the relay and
    publish its circuits. The client here (a client-mode DHT peer with an AutoRelay and a
    RemoteSequential) knows the server only through the DHT and reaches it only through
    the relay: the forward [1, 512, 4096] (fp16 wire, < 2e-2 of the local chain) and 32
    greedy tokens (the teacher-forced rule) ride the relayed connection. Then the native
    transport in this process: a server P2P and a client P2P each with a private daemon
    (``native_transport=True``), the server hosting a ConnectionHandler over the same
    blocks; a "none"-wire forward at T 512 must equal the local call within 1e-6 (the
    same bytes through the daemons' C++ AEAD), and both daemons are reaped at shutdown.
    Returns the flash forward's launches on the path, summed over the server process."""
    import multiprocessing
    import threading

    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.moe import RemoteSequential, get_experts
    from hivemind_tpu_torch.moe.client import RemoteExpert
    from hivemind_tpu_torch.moe.expert_uid import ExpertInfo
    from hivemind_tpu_torch.moe.server import ConnectionHandler, Runtime
    from hivemind_tpu_torch.moe.server.llama_loader import LlamaClientHead, generate_greedy, load_llama_blocks
    from hivemind_tpu_torch.p2p import P2P, AutoRelay, PeerID
    from hivemind_tpu_torch.utils.loop import get_loop_runner

    phase_started = time.perf_counter()
    hid, vocab = LLAMA2_7B["hidden_size"], LLAMA2_7B["vocab_size"]
    scratch = tempfile.TemporaryDirectory(prefix="chip_smoke_relay_")
    relay_log = Path(scratch.name) / "run_relay.log"
    context = multiprocessing.get_context("forkserver")  # CHILD_PRELOAD
    faults, dhts, autos, nodes, readings = [], [], [], [], {}
    relay_process = child = timer = runtime = runner = None

    def check(ok: bool, what: str) -> None:
        if not ok:
            faults.append(what)

    def kill_all() -> None:
        if child is not None:
            child.kill()
        if relay_process is not None and relay_process.poll() is None:
            relay_process.kill()

    try:
        bootstrap = DHT(start=True)
        dhts.append(bootstrap)
        # the shared loop, started by the DHT: a runner taken before it starts is replaced by the next caller's
        runner = get_loop_runner()
        bootstrap_p2p = runner.run_coroutine(bootstrap.replicate_p2p())
        # a public peer: nobody to probe through yet, so it diagnoses itself reachable and serves nat.check
        autos.append(runner.run_coroutine(AutoRelay.create(bootstrap_p2p, bootstrap)))
        initial_peers = [str(maddr) for maddr in bootstrap.get_visible_maddrs()]
        with open(relay_log, "w") as out:
            relay_process = subprocess.Popen(
                [sys.executable, "-m", "hivemind_tpu_torch.hivemind_cli.run_relay", "--initial_peers", *initial_peers,
                 "--announce_host", "127.0.0.1", "--identity_path", str(Path(scratch.name) / "relay.key")],
                stdout=out, stderr=subprocess.STDOUT, cwd=Path(__file__).resolve().parent)
        child = RelayChild(context, checkpoint_dir, initial_peers)
        # a child or a call that hangs past the limit: both are killed, which fails every call in flight
        timer = threading.Timer(RELAY_PHASE_LIMIT_S, kill_all)
        timer.daemon = True
        timer.start()

        # this process's blocks (loaded once: the local references, then the native transport's server)
        backends = load_llama_blocks(checkpoint_dir, uid_prefix=RELAY_PREFIX, device="cuda")[0]
        head = LlamaClientHead.load(checkpoint_dir, device="cuda")
        x = np.random.default_rng(SEED + 31).standard_normal((1, RELAY_FORWARD_LENGTH, hid), dtype=np.float32)
        prompt = np.random.default_rng(SEED + 9).integers(0, vocab, size=(1, DECODE_PROMPT))  # [decode]'s prompt
        expected = forward_chain(backends, x)
        torch.cuda.synchronize()
        loaded_s = time.perf_counter() - phase_started

        up = read_line(relay_process, relay_log, r"relay daemon up on port (\d+) \(identity ([0-9a-f]{64}), pid (\d+)\)",
                       RELAY_STARTUP_LIMIT_S - (time.perf_counter() - phase_started))
        relay_port, relay_identity, daemon_pid = int(up.group(1)), up.group(2), int(up.group(3))
        read_line(relay_process, relay_log, rf"advertised 127\.0\.0\.1:{relay_port} in the DHT \(stored=True\)",
                  RELAY_STARTUP_LIMIT_S - (time.perf_counter() - phase_started))
        relay_up_s = time.perf_counter() - phase_started
        banner_log = relay_log.read_text(errors="replace")
        check("UNAUTHENTICATED" not in banner_log, "the relay daemon runs without libcrypto: registrations are "
                                                   "UNAUTHENTICATED")
        _, child.peer_id, child.device = child.receive(RELAY_STARTUP_LIMIT_S - (time.perf_counter() - phase_started))
        server_up_s = time.perf_counter() - phase_started
        server_id = PeerID.from_base58(child.peer_id)

        # 1. the server diagnoses itself NATed, registers at the relay found in the DHT, publishes its circuits
        _, natted, registered, autorelay_s, announced = child.ask("autorelay", bootstrap_p2p.peer_id.to_base58())
        log(f"[relay] this process's blocks and local references in {loaded_s:.1f} s; by then, or after: run_relay's "
            f"daemon up on port {relay_port} (identity {relay_identity[:16]}..., pid {daemon_pid}) and advertised at "
            f"{relay_up_s:.1f} s, the server process up at {server_up_s:.1f} s (device {child.device}), announcing "
            f"{announced}")
        log(f"[relay] the server's AutoRelay.create (AutoNAT dial-back through the bootstrap, relay lookup in the "
            f"DHT, registration, circuits published): NATed={natted}, registered at {registered}, "
            f"{autorelay_s * 1e3:.1f} ms")
        check(natted and registered == [f"127.0.0.1:{relay_port}"],
              f"the server diagnosed NATed={natted} and registered at {registered}, not at 127.0.0.1:{relay_port}")

        # 2. the client: a client-mode DHT peer (no peer's routing table holds it, so the server's
        # DHT never dials it), with an AutoRelay whose resolver is its only route to the server
        client_dht = DHT(initial_peers=initial_peers, start=True, client_mode=True)
        dhts.append(client_dht)
        client_p2p = runner.run_coroutine(client_dht.replicate_p2p())
        client_auto = runner.run_coroutine(AutoRelay.create(client_p2p, client_dht, probe_via=bootstrap_p2p.peer_id))
        autos.append(client_auto)
        check(not client_auto.natted, "the client diagnosed itself NATed")
        uids = [f"{RELAY_PREFIX}{index}" for index in range(LLAMA2_7B["num_hidden_layers"])]
        child.ask("reset")
        for wrapper in wrappers.values():
            wrapper.launches = 0  # the main path starts here; the server process counts its own launches
        # resolve to first byte: the blocks' uids through the DHT, then rpc_info of block 0 (the dead
        # port refused, the circuit looked up in the DHT, the relay's control handshake and DIAL, the
        # end-to-end handshake through the splice, the reply). The client's DHT lookups may reach the
        # server's DHT node through the resolver first, and so make the relayed connection
        started = time.perf_counter()
        while not all(get_experts(client_dht, uids)) and time.perf_counter() - started < 20:
            time.sleep(0.05)
        resolve_s = time.perf_counter() - started
        check(all(get_experts(client_dht, uids)), f"the DHT did not resolve {uids}")
        before_call = client_p2p._connections.get(server_id)
        check(before_call is None or getattr(before_call, "is_relayed", False),
              "the client held a direct connection to the NATed server before its first call")
        RemoteExpert(ExpertInfo(uids[0], server_id), client_p2p).info
        first_byte_s = time.perf_counter() - started
        pipe = RemoteSequential(client_dht, RELAY_PREFIX, len(uids))
        relayed = client_p2p._connections.get(server_id)
        check(relayed is not None and getattr(relayed, "is_relayed", False),
              "the client's first call to the NATed server did not ride a relayed connection")
        streams_before = relayed._next_stream_id if relayed is not None else 0
        # 3. the first forward, through the relay
        with torch.no_grad():
            got = pipe(torch.tensor(x, device="cuda")).cpu().numpy()
        rode = relayed is not None and client_p2p._connections.get(server_id) is relayed and not relayed.is_closed \
            and relayed._next_stream_id > streams_before
        check(rode, "the first forward did not ride the relayed connection")
        err = max_rel_err(got, expected)
        check(err < SERVING_TOL, f"relayed forward: rel err {err}")
        with torch.no_grad():
            forward_s, _ = timed_median(lambda: pipe(torch.tensor(x, device="cuda")).cpu().numpy(), RELAY_TIMED_RUNS)
        # 4. greedy generation through the relay
        relay_pipe = SwarmPipe(pipe)
        ids = generate_greedy(head, relay_pipe, prompt, DECODE_NEW, session_id="relay")
        steps = np.array([seconds for seconds, _ in relay_pipe.calls[1:]])
        now = client_p2p._connections.get(server_id)
        upgraded = now is not None and not getattr(now, "is_relayed", False)
        child.report()

        # 5. the native transport in this process: private daemons, the same blocks
        native_launches_before = wrappers["flash_attention_forward"].launches

        async def start_native():
            handlers = {name: ConnectionHandler(dict(backends), decode_max_len=DECODE_MAX_LEN,
                                                activation_compression="none") for name in ("native", "asyncio")}
            servers = {"native": await P2P.create(listen_host="127.0.0.1", native_transport=True),
                       "asyncio": await P2P.create(listen_host="127.0.0.1", native_transport=False)}
            clients = {"native": await P2P.create(listen_host="127.0.0.1", native_transport=True),
                       "asyncio": await P2P.create(listen_host="127.0.0.1", native_transport=False)}
            nodes.extend([*clients.values(), *servers.values()])
            for name, server in servers.items():
                await handlers[name].add_p2p_handlers(server)
                clients[name].add_peer_addr(server.peer_id, server.get_visible_maddrs()[0])
            started_runtime = Runtime([pool for handler in handlers.values() for pool in handler.all_pools()])
            started_runtime.start()
            return servers, clients, started_runtime

        servers, clients, runtime = runner.run_coroutine(start_native(), return_future=True).result(30)
        daemons = [node._native_daemon for node in (servers["native"], clients["native"])]
        check(all(daemon is not None and daemon.alive for daemon in daemons),
              "a native transport fell back to asyncio: its private daemon is not alive")
        check(servers["native"]._inbound_proxy_active, "the native server's inbound proxy is not active")
        socket_modes = [oct(os.stat(daemon.unix_path).st_mode & 0o777) for daemon in daemons if daemon is not None]
        check(socket_modes == ["0o600", "0o600"], f"the daemons' unix sockets are {socket_modes}, not 0600")
        native_experts = {name: [RemoteExpert(ExpertInfo(uid, servers[name].peer_id), clients[name]) for uid in uids]
                          for name in servers}
        native_got = remote_chain(native_experts["native"], x)
        native_err = max_rel_err(native_got, expected)
        check(native_err <= REMOTE_LOSSLESS_TOL, f"native transport: rel err {native_err} > {REMOTE_LOSSLESS_TOL}")
        check(clients["native"]._proxied_dials >= 1, "the native client's dial did not ride its daemon")
        native_s = {name: timed_median(lambda name=name: remote_chain(native_experts[name], x), RELAY_TIMED_RUNS)[0]
                    for name in servers}
        native_launches = wrappers["flash_attention_forward"].launches - native_launches_before
        launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
        proxied_dials = clients["native"]._proxied_dials

        async def stop_native():
            await runtime.shutdown()
            for node in nodes:
                await node.shutdown()

        runner.run_coroutine(stop_native(), return_future=True).result(30)
        runtime = None
        nodes.clear()
        check(all(daemon is None or daemon.process.poll() is not None for daemon in daemons),
              "a native transport's daemon outlived its P2P's shutdown")
    finally:
        if timer is not None:
            timer.cancel()
        if runner is not None and (runtime is not None or nodes):
            async def stop_rest():
                if runtime is not None:
                    await runtime.shutdown()
                for node in nodes:
                    await node.shutdown()

            with contextlib.suppress(Exception):
                runner.run_coroutine(stop_rest(), return_future=True).result(30)
        for auto in autos:  # taken after the runner, so it is set
            with contextlib.suppress(Exception):
                runner.run_coroutine(auto.close(), return_future=True).result(10)
        if child is not None:
            if child.process.is_alive():
                with contextlib.suppress(Exception):
                    child.ask("stop", timeout=20)
            child.kill()
        if relay_process is not None:
            if relay_process.poll() is None:
                relay_process.send_signal(signal.SIGINT)
            try:
                relay_process.wait(15)
            except subprocess.TimeoutExpired:
                relay_process.kill()
                relay_process.wait()
        for dht in reversed(dhts):
            dht.shutdown()
        relay_tail = relay_log.read_text(errors="replace")[-3000:] if relay_log.exists() else ""
        scratch.cleanup()

    check(not Path(f"/proc/{daemon_pid}").exists(), f"run_relay's daemon (pid {daemon_pid}) outlived it")
    check("Traceback" not in relay_tail, f"run_relay logged a traceback:\n{relay_tail}")
    launches["flash_attention_forward"] += child.last_report["counts"]["flash_attention_forward"]
    gaps = greedy_gaps(head, backends, ids, DECODE_PROMPT)
    check(gaps.max() <= GREEDY_LOGIT_RTOL, f"a token generated through the relay lies {gaps.max()} below the best")
    swarm = telemetry.readings.get("swarm", {}).get("fp", {})
    remote = telemetry.readings.get("remote", {}).get("decode", {}).get("fp", {})
    log(f"[relay] resolve to first byte {first_byte_s * 1e3:.1f} ms: {len(uids)} block uids through the client's DHT "
        f"in {resolve_s * 1e3:.1f} ms (a relayed connection made by then: {before_call is not None}), then rpc_info "
        f"of block 0 (with no connection: the dead port refused, the circuit from the DHT, the relay's handshake and "
        f"DIAL, the end-to-end handshake, the reply); the connection is relayed: {getattr(relayed, 'is_relayed', False)}; "
        f"the first forward rode it: {rode}")
    log(f"[relay] forward fp [1, {RELAY_FORWARD_LENGTH}, {hid}] through the relay (fp16 wire) vs the local chain: "
        f"max_rel_err={err:.3e} (limit {SERVING_TOL}); median of {RELAY_TIMED_RUNS} {forward_s * 1e3:.1f} ms")
    log(f"[relay] decode fp: {DECODE_NEW} tokens from a {DECODE_PROMPT}-token prompt through the relay; teacher-forced "
        f"replay largest logit gap {gaps.max():.3e} (limit {GREEDY_LOGIT_RTOL}); per-token latency median / p90 "
        f"{median_p90(steps)}" + (f"; [swarm]'s direct connection {median_p90(swarm['steps'])}" if "steps" in swarm
                                  else "") + (f"; [remote] in one process {median_p90(remote['remote_step'])}"
                                              if "remote_step" in remote else "")
        + f"; prefill {relay_pipe.calls[0][0] * 1e3:.1f} ms; hole punch upgraded the connection to a direct one: "
        f"{upgraded}")
    log(f"[relay] native transport (a private daemon on each side, 0600 unix sockets {socket_modes}, the server's "
        f"inbound proxy active, {proxied_dials} proxied dial(s)): \"none\"-wire forward [1, {RELAY_FORWARD_LENGTH}, "
        f"{hid}] through 2 blocks vs the local call max_rel_err={native_err:.3e} (limit <= {REMOTE_LOSSLESS_TOL}); "
        f"median of {RELAY_TIMED_RUNS}: native {native_s['native'] * 1e3:.1f} ms, the asyncio transport "
        f"{native_s['asyncio'] * 1e3:.1f} ms on the same blocks; {native_launches} flash forward launches here; both "
        f"daemons reaped at shutdown")
    elapsed = time.perf_counter() - phase_started
    log(f"[relay] phase wall {elapsed:.1f} s (limit {RELAY_PHASE_LIMIT_S} s)")
    check(elapsed <= RELAY_PHASE_LIMIT_S, f"[relay] took {elapsed:.1f} s > {RELAY_PHASE_LIMIT_S} s")
    readings.update(first_byte_s=first_byte_s, forward_s=forward_s, steps=steps, native_s=native_s, upgraded=upgraded)
    telemetry.readings["relay"] = readings
    if faults:
        raise AssertionError("; ".join(faults))
    return launches


def dmoe_expert_weights(torch, uid: str) -> dict:
    """One [dmoe] expert's weights, from a seed of its own, on the card (a CUDA
    generator draws the same numbers in every process)."""
    from hivemind_tpu_torch.moe.server.layers import init_parameters, name_to_block

    module = name_to_block["ffn"](DMOE_HIDDEN, device="meta").to_empty(device="cuda")
    init_parameters(module, torch.Generator(device="cuda").manual_seed(SEED + 100 + DMOE_UIDS.index(uid)))
    return {key: tensor.detach() for key, tensor in module.state_dict().items()}


def dmoe_server_main(conn, role: str, uids: list, initial_peers: list, checkpoint_dir: str) -> None:
    """One server process of ``[dmoe]`` (``role`` A-D: a DHT peer, then on ``serve`` a
    Server on the card, its experts loaded with their own weights; E: idle until it
    restores A's checkpoint). Its kernel launch counts start at 0 before its
    Server.create. Commands: ``serve``, ``report`` (launches, update counts, replication records),
    ``publish`` (one telemetry snapshot to the DHT), ``store`` (A's checkpoint),
    ``restore`` (E: ``Server.create(checkpoint_dir=...)``, then each blob's length
    and digest), ``forward`` (each expert's local forward of a batch) and ``stop``."""
    import hashlib
    import traceback

    try:
        import torch

        from hivemind_tpu_torch.dht import DHT
        from hivemind_tpu_torch.moe.server import ReplicationPolicy, Server, store_experts
        from hivemind_tpu_torch.ops import blockwise_int8, flash_attention
        from hivemind_tpu_torch.telemetry.monitor import TelemetryPublisher

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        wrappers = {
            "flash_attention_forward": flash_attention.flash_attention_lse,
            "flash_attention_backward_dq": flash_attention.flash_attention_backward_dq,
            "flash_attention_backward_dkv": flash_attention.flash_attention_backward_dkv,
            "blockwise_int8_quantize": blockwise_int8.blockwise_int8_quantize,
            "blockwise_int8_dequantize": blockwise_int8.blockwise_int8_dequantize,
        }
        for wrapper in wrappers.values():
            wrapper.launches = 0
        policy = ReplicationPolicy(**DMOE_POLICY)
        options = {
            "A": dict(checkpoint_dir=checkpoint_dir, replicate_hot_experts=True, replication_policy=policy),
            "B": dict(weight_quantization="int8"),
            "C": {},
            "D": dict(replica_slots=DMOE_REPLICA_SLOTS, replication_watch_grids=[DMOE_PREFIX.rstrip(".")],
                      replication_policy=policy),
        }
        torch.zeros(1, device="cuda")  # the CUDA context, as a serving process holds it before any request
        server = dht = publisher = None
        if role != "E":
            dht = DHT(initial_peers=initial_peers, start=True)
        conn.send(("dht", dht.peer_id.to_base58() if dht else None, torch.cuda.get_device_name(0)))
        while True:
            command, *args = conn.recv()
            if command == "serve":  # once every peer is up: the declarations then reach them all
                if dht is not None:
                    server = Server.create(expert_uids=uids, expert_cls="ffn", hidden_dim=DMOE_HIDDEN, dht=dht,
                                           device="cuda", **options[role])
                    for uid, backend in server.backends.items():
                        backend.load_params(dmoe_expert_weights(torch, uid))
                    server.update_period = DMOE_UPDATE_PERIOD
                    server.run_in_background(await_ready=True, timeout=60)
                    publisher = TelemetryPublisher(dht, interval=60.0, start=False)
                conn.send(("serving",))
            elif command == "report":
                replication = server.replication if server is not None else None
                conn.send(("report", {name: wrapper.launches for name, wrapper in wrappers.items()},
                           {uid: backend.update_count for uid, backend in server.backends.items()} if server else {},
                           dict(advertised=dict(replication.advertised), acquisitions=list(replication.acquisitions))
                           if replication is not None else {}))
            elif command == "publish":
                conn.send(("published", publisher.publish_once()))
            elif command == "store":
                started = time.perf_counter()
                store_experts(server.backends, checkpoint_dir)
                conn.send(("stored", time.perf_counter() - started))
            elif command == "restore":
                started = time.perf_counter()
                server = Server.create(expert_uids=uids, expert_cls="ffn", hidden_dim=DMOE_HIDDEN, dht=DHT(start=False),
                                       device="cuda", checkpoint_dir=checkpoint_dir)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - started
                blobs = {uid: backend.state_dict() for uid, backend in server.backends.items()}
                conn.send(("restored", seconds, {uid: (len(blob), hashlib.blake2b(blob).hexdigest())
                                                 for uid, blob in blobs.items()}))
            elif command == "forward":
                conn.send(("forward", {uid: backend.forward(args[0])[0] for uid, backend in server.backends.items()}))
            elif command == "stop":
                if dht is not None:
                    server.shutdown()
                    dht.shutdown()
                conn.send(("stopped",))
                return
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise


class DmoeChild(SwarmChild):
    """The parent's handle on one server process of ``[dmoe]``."""

    def __init__(self, context, role: str, uids, initial_peers: list, checkpoint_dir: str):
        self.layer, self.name, self.role, self.uids = role, f"[dmoe] server process {role}", role, tuple(uids)
        self.conn, child_conn = context.Pipe()
        self.process = context.Process(target=dmoe_server_main,
                                       args=(child_conn, role, list(uids), initial_peers, checkpoint_dir), daemon=True)
        self.process.start()
        child_conn.close()
        self.peer_id = self.device = self.last_report = None

    def ask(self, *command, timeout: float = 30.0):
        self.conn.send(command)
        return self.receive(timeout)

    def report(self) -> dict:
        _, counts, updates, replication = self.ask("report")
        self.last_report = dict(counts=counts, updates=updates, replication=replication)
        return self.last_report


def dmoe_twin_mixture(torch, x, proj, experts, twins: dict, alive=None, detached=()):
    """The mixture the served path must give, computed in this process: the gate
    ``x @ proj``, each sample's chosen ``experts`` (uid lists) and alive mask, and each
    expert's module on its twin's weights on the card, differentiable by autograd. The
    outputs of the ``detached`` uids pass no input gradient (their servers refuse the
    backward), as over the wire."""
    from hivemind_tpu_torch.ops.quantized_params import dequantize_tree

    batch, k = len(experts), max(len(row) for row in experts)
    coords = np.zeros((batch, k, 2), np.int64)
    valid = np.zeros((batch, k), bool)
    jobs = {}
    for sample, row in enumerate(experts):
        for slot, uid in enumerate(row):
            coords[sample, slot] = [int(c) for c in uid[len(DMOE_PREFIX):].split(".")]
            valid[sample, slot] = True
            jobs.setdefault(uid, []).append((sample, slot))
    outputs = x.new_zeros(batch, k, DMOE_HIDDEN)
    for uid, positions in jobs.items():
        rows, slots = (torch.tensor(index, device=x.device) for index in zip(*positions))
        out = torch.func.functional_call(twins[uid].module, dequantize_tree(twins[uid].params), (x[rows],))
        outputs = outputs.index_put((rows, slots), out.detach() if uid in detached else out)
    scores = torch.split(x @ proj, DMOE_GRID, dim=1)
    coords = torch.from_numpy(coords).to(x.device)
    logits = scores[0].gather(1, coords[:, :, 0]) + scores[1].gather(1, coords[:, :, 1])
    mask = torch.from_numpy(valid).to(x.device)
    if alive is not None:
        mask &= torch.as_tensor(alive, device=x.device)
    weights = torch.where(mask, torch.softmax(torch.where(mask, logits, torch.full_like(logits, -1e9)), dim=-1),
                          torch.zeros_like(logits))
    return torch.einsum("bk,bkd->bd", weights, outputs)


def dmoe_slots_on(experts, k: int, uids) -> np.ndarray:
    """``[batch, k]``: which slots of a call's chosen ``experts`` hold one of ``uids``."""
    return np.array([[uid in uids for uid in row] + [False] * (k - len(row)) for row in experts])


def phase_dmoe(torch, wrappers: dict, telemetry: Telemetry) -> dict:
    """The decentralized mixture of experts across processes (BASELINE config 4): this
    process is the bootstrap DHT peer and the client (``RemoteMixtureOfExperts``); the
    child processes A, B, C serve the 64 experts on the card, D acquires hot experts
    of A, E restores A's checkpoint. Checks, in order: beam search vs the exhaustive
    top-4, forward vs a twin mixture, replication, backward vs the twins, checkpoint,
    a killed server, the swarm monitor; returns the launch counts summed over the
    server processes."""
    import hashlib
    import multiprocessing
    import shutil
    import threading

    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.moe import ExpertInfo, ModuleBackend, RemoteExpert, RemoteMixtureOfExperts, get_experts
    from hivemind_tpu_torch.moe.client.call_many import EXPERT_BREAKERS
    from hivemind_tpu_torch.moe.server.layers import name_to_block, name_to_input
    from hivemind_tpu_torch.moe.server.replication import fetch_replica_state
    from hivemind_tpu_torch.p2p import PeerID
    from hivemind_tpu_torch.resilience import reset_all_boards
    from hivemind_tpu_torch.telemetry.monitor import SwarmMonitor
    from hivemind_tpu_torch.utils.loop import get_loop_runner

    phase_started = time.perf_counter()
    rng = np.random.default_rng(SEED + 21)
    x = rng.standard_normal((DMOE_BATCH, DMOE_HIDDEN), dtype=np.float32)
    w = rng.standard_normal((DMOE_BATCH, DMOE_HIDDEN), dtype=np.float32)
    checkpoint_dir = tempfile.mkdtemp(prefix="dmoe_checkpoints_")
    context = multiprocessing.get_context("forkserver")  # CHILD_PRELOAD
    children, dhts, faults, readings = {}, [], [], {}
    timer = None
    line = card_line()

    def check(ok: bool, what: str) -> None:
        if not ok:
            faults.append(what)

    def kill_all() -> None:
        for child in children.values():
            child.kill()

    def forward(moe, x_t):
        """One mixture forward: (output, wall seconds, beam search seconds)."""
        search = moe._search
        timed = {}

        def timed_search(grid_scores):
            started = time.perf_counter()
            try:
                return search(grid_scores)
            finally:
                timed["search"] = time.perf_counter() - started

        moe._search = timed_search
        try:
            started = time.perf_counter()
            out = moe(x_t)
            torch.cuda.synchronize()
            return out, time.perf_counter() - started, timed["search"]
        finally:
            del moe._search

    try:
        started = time.perf_counter()
        bootstrap = DHT(start=True)
        dhts.append(bootstrap)
        initial_peers = [str(maddr) for maddr in bootstrap.get_visible_maddrs()]
        # D, the volunteer, starts its process and DHT peer with the others and serves only
        # after the first calls; E restores A's checkpoint
        for role in ("A", "B", "C", "D", "E"):
            uids = DMOE_LAYOUT.get(role, () if role == "D" else DMOE_LAYOUT["A"])
            children[role] = DmoeChild(context, role, uids, initial_peers, checkpoint_dir)
        timer = threading.Timer(DMOE_PHASE_LIMIT_S + 30.0, kill_all)  # a hang fails every call in flight
        timer.daemon = True
        timer.start()
        # the local twins, built while the servers start: the same weights, B's as int8
        twins = {}
        for uid in DMOE_UIDS:
            twins[uid] = ModuleBackend(uid, name_to_block["ffn"](DMOE_HIDDEN, device="meta"),
                                       sample_input=name_to_input["ffn"](4, DMOE_HIDDEN),
                                       params=dmoe_expert_weights(torch, uid), device="cuda",
                                       weight_quantization="int8" if uid in DMOE_LAYOUT["B"] else None)
        for child in children.values():
            _, child.peer_id, child.device = child.receive(DMOE_STARTUP_LIMIT_S - (time.perf_counter() - started))
        peers_up = time.perf_counter() - started
        client_dht = DHT(initial_peers=initial_peers, start=True)
        dhts.append(client_dht)
        for role in ("A", "B", "C", "E"):  # the servers build their experts side by side
            children[role].conn.send(("serve",))
        for role in ("A", "B", "C", "E"):
            children[role].receive(DMOE_STARTUP_LIMIT_S - (time.perf_counter() - started))
        servers_up = time.perf_counter() - started
        started = time.perf_counter()
        rows = {DMOE_PREFIX.rstrip("."): set(range(DMOE_GRID[0])),
                **{f"{DMOE_PREFIX}{i}": set(range(DMOE_GRID[1])) for i in range(DMOE_GRID[0])}}
        while True:  # every uid and every prefix record complete, as the beam search reads them
            resolved = all(info is not None for info in get_experts(client_dht, list(DMOE_UIDS)))
            complete = resolved and all(
                (entry := client_dht.get(prefix)) is not None and {c for c in entry.value if isinstance(c, int)} == coords
                for prefix, coords in rows.items())
            if complete or time.perf_counter() - started > 30:
                break
            time.sleep(0.1)
        if not complete:
            raise AssertionError("the client never resolved the 64 experts and their prefix records")
        owner = {uid: role for role in "ABC" for uid in DMOE_LAYOUT[role]}
        log(f"[dmoe] {line}: servers A (8 fp32 experts, Adam, checkpoints, hot-expert adverts), B (28 int8), C (28 "
            f"fp32) and E up, and D's process waiting to serve, in {servers_up:.1f} s (processes and DHT peers up in "
            f"{peers_up:.1f} s, then the four servers built side by side; devices {sorted({c.device for c in children.values()})}); 64 uids "
            f"and their prefix records resolved in {time.perf_counter() - started:.2f} s")

        moe = RemoteMixtureOfExperts(dht=client_dht, in_features=DMOE_HIDDEN, grid_size=DMOE_GRID,
                                     uid_prefix=DMOE_PREFIX, k_best=DMOE_K, seed=SEED, device="cuda")
        x_t = torch.tensor(x, device="cuda")
        w_t = torch.tensor(w, device="cuda")
        # 1. beam search vs the exhaustive top-4 of all 64 sums
        with torch.no_grad():
            scores = moe._split_scores(x_t @ moe.proj)
        search_ms = []
        for _ in range(3):
            started = time.perf_counter()
            chosen = moe._search(scores)
            search_ms.append((time.perf_counter() - started) * 1e3)
        host = [s.cpu().numpy().astype(np.float64) for s in scores]
        sums = (host[0][:, :, None] + host[1][:, None, :]).reshape(DMOE_BATCH, -1)
        best = np.argsort(-sums, axis=1, kind="stable")[:, :DMOE_K]
        mismatched = 0
        for sample, infos in enumerate(chosen):
            got = [DMOE_UIDS.index(info.uid) for info in infos[:DMOE_K]]
            if sorted(got) != sorted(best[sample].tolist()):
                # an exact tie at the boundary may pick either expert
                tied = np.isclose(sums[sample, got], sums[sample, best[sample]], rtol=0, atol=0).all()
                mismatched += not tied
        log(f"[dmoe] {line}: beam search (beam {moe.beam_size}) of a {DMOE_BATCH}-sample batch: "
            f"{median_p90(np.array(search_ms) / 1e3)} (median / p90 of 3); top-{DMOE_K} vs the exhaustive top-{DMOE_K} "
            f"of 64 sums: {mismatched} samples differ (limit 0, exact ties excepted)")
        check(mismatched == 0, f"beam search: {mismatched} samples differ from the exhaustive top-{DMOE_K}")

        # 2. forward vs the twin mixture
        with torch.no_grad():
            out, wall, search_s = forward(moe, x_t)
            twin = dmoe_twin_mixture(torch, x_t, moe.proj, moe.last_experts, twins)
        err = max_rel_err(out.cpu().numpy(), twin.cpu().numpy())
        forward_walls = [(wall, search_s)]
        log(f"[dmoe] {line}: forward [{DMOE_BATCH}, {DMOE_HIDDEN}] top-{DMOE_K} over 64 experts on 3 servers (fp16 "
            f"wire) vs the twin mixture: max_rel_err={err:.3e} (limit {DMOE_TOL}); all slots alive: "
            f"{bool(moe.last_alive.all())}; first call {wall * 1e3:.1f} ms (beam search {search_s * 1e3:.1f} ms)")
        check(err < DMOE_TOL, f"forward: rel err {err}")
        check(bool(moe.last_alive.all()), "forward: a slot was masked with every server alive")

        # 3. replication: D starts serving, A's hot experts are advertised, D acquires two
        started = time.perf_counter()
        children["D"].ask("serve", timeout=60)
        d_serving = time.time()
        acquired = []
        while time.perf_counter() - started < 60 and len(acquired) < DMOE_REPLICA_SLOTS:
            with torch.no_grad():
                _out, wall, search_s = forward(moe, x_t)
            forward_walls.append((wall, search_s))
            acquired = children["D"].report()["replication"]["acquisitions"]
        check(len(acquired) == DMOE_REPLICA_SLOTS, f"replication: D acquired {len(acquired)} replicas")
        replica_sets = {}
        waited = time.perf_counter()
        while acquired and time.perf_counter() - waited < 4 * DMOE_UPDATE_PERIOD:
            with torch.no_grad():
                found = moe._search(scores)
            replica_sets = {info.uid: len(info.replica_set) for row in found for info in row
                            if info.uid in {a["uid"] for a in acquired}}
            if len(replica_sets) == len(acquired) and set(replica_sets.values()) == {2}:
                break
            time.sleep(0.2)
        check(len(replica_sets) == len(acquired) and set(replica_sets.values()) == {2},
              f"replication: the client's beam search resolves {replica_sets} replicas")
        advertised = children["A"].report()["replication"]["advertised"]
        equal = []
        for record in acquired:
            uid = record["uid"]
            outs = [RemoteExpert(ExpertInfo(uid, PeerID.from_base58(children[role].peer_id), "float16"),
                                 client_dht.node.p2p).forward_np(x[:256])[0] for role in ("A", "D")]
            equal.append(bool(np.array_equal(outs[0], outs[1])))
            log(f"[dmoe] {line}: D acquired a replica of {uid} from A: advert to declared replica "
                f"{record['declared_at'] - advertised.get(uid, float('nan')):.2f} s (D started serving "
                f"{d_serving - advertised.get(uid, float('nan')):.2f} s after the advert, and declared the replica "
                f"{record['declared_at'] - d_serving:.2f} s later); transfer of {record['bytes']} B "
                f"in {record['fetch_s']:.3f} s ({record['bytes'] / record['fetch_s'] / 1e6:.1f} MB/s), built in "
                f"{record['build_s']:.3f} s; the client resolves {replica_sets.get(uid)} replicas; the same [256, "
                f"{DMOE_HIDDEN}] input through D and through A answers with equal bytes: {equal[-1]}")
        check(all(equal) and len(equal) == len(acquired), f"replication: D and A answer differently: {equal}")
        readings["replication"] = dict(acquired=acquired, advertised=advertised)

        # 4. backward vs the twins' autograd (B's int8 experts refuse the backward, as the
        # reference's do: their slots pass no input gradient and backward_k_min is 0)
        moe.backward_k_min = 0
        moe.proj.grad = None
        x_b = x_t.clone().requires_grad_(True)
        out, wall, search_s = forward(moe, x_b)
        started = time.perf_counter()
        (out * w_t).sum().backward()
        torch.cuda.synchronize()
        backward_wall = time.perf_counter() - started
        experts = moe.last_experts
        refused = set(DMOE_LAYOUT["B"])
        x_twin = x_t.clone().requires_grad_(True)
        proj_twin = moe.proj.detach().clone().requires_grad_(True)
        (dmoe_twin_mixture(torch, x_twin, proj_twin, experts, twins, detached=refused) * w_t).sum().backward()
        grad_err = max_rel_err(x_b.grad.cpu().numpy(), x_twin.grad.cpu().numpy())
        proj_err = max_rel_err(moe.proj.grad.cpu().numpy(), proj_twin.grad.cpu().numpy())
        refused_slots = sum(uid in refused for row in experts for uid in row)
        updates = {role: children[role].report()["updates"] for role in ("A", "C", "D")}
        stepped = {role: sum(count > 0 for count in counts.values()) for role, counts in updates.items()}
        log(f"[dmoe] {line}: backward at [{DMOE_BATCH}, {DMOE_HIDDEN}]: d loss / d x max_rel_err={grad_err:.3e}, d loss "
            f"/ d proj max_rel_err={proj_err:.3e} (limit {DMOE_TOL}); {refused_slots} of "
            f"{sum(len(row) for row in experts)} slots on B's int8 experts (backward refused); experts stepped by "
            f"Adam per server {stepped}; forward {wall * 1e3:.1f} ms + backward fan-out {backward_wall * 1e3:.1f} ms")
        check(grad_err < DMOE_TOL and proj_err < DMOE_TOL, f"backward: rel errs {grad_err}, {proj_err}")
        check(stepped["A"] > 0 and stepped["C"] > 0, f"backward: no fp32 expert stepped: {stepped}")
        walls = np.array([wall for wall, _ in forward_walls[1:]])
        searches = np.array([search for _, search in forward_walls[1:]])
        readings["walls"] = dict(forward=walls, search=searches, backward=backward_wall, forward_with_grad=wall)
        log(f"[dmoe] {line}: forward call wall over {len(walls)} calls (gate + beam search + fan-out + mix) "
            f"{median_p90(walls)}, of which beam search {median_p90(searches)}; {DMOE_BATCH / np.median(walls):.0f} "
            f"samples/s forward, {DMOE_BATCH / (wall + backward_wall):.0f} samples/s forward + backward")

        # 5. checkpoint: A stores, E restores in a fresh process while this process fetches
        # A's blobs over rpc_replica_state; blobs and a forward equal A's
        _, store_s = children["A"].ask("store", timeout=120)
        children["E"].conn.send(("restore",))
        fetched, blobs, fetch_s = {}, {}, 0.0
        for uid in DMOE_LAYOUT["A"]:
            started = time.perf_counter()
            _spec, blob = get_loop_runner().run_coroutine(
                fetch_replica_state(client_dht.node.p2p, PeerID.from_base58(children["A"].peer_id), uid))
            fetch_s += time.perf_counter() - started
            fetched[uid] = (len(blob), hashlib.blake2b(blob).hexdigest())
            blobs[uid] = blob
        _, restore_s, digests = children["E"].receive(120)
        x_small = x[:256]
        _, ours = children["A"].ask("forward", x_small, timeout=60)
        _, restored = children["E"].ask("forward", x_small, timeout=60)
        same_forward = all(np.array_equal(ours[uid], restored[uid]) for uid in DMOE_LAYOUT["A"])
        total = sum(length for length, _ in fetched.values())
        log(f"[dmoe] {line}: checkpoint of A's 8 experts stored in {store_s:.2f} s, restored by a fresh process "
            f"(Server.create(checkpoint_dir=...)) in {restore_s:.2f} s, beside the fetch below; its 8 blobs equal A's over rpc_replica_state "
            f"(length and blake2b-512): {digests == fetched} ({total} B fetched in {fetch_s:.2f} s, "
            f"{total / fetch_s / 1e6:.1f} MB/s); a [256, {DMOE_HIDDEN}] forward through each restored expert equals "
            f"A's: {same_forward}")
        check(digests == fetched, "checkpoint: a restored blob differs from A's")
        check(same_forward, "checkpoint: a restored expert's forward differs from A's")
        readings["checkpoint"] = dict(store_s=store_s, restore_s=restore_s, fetch_mb_s=total / fetch_s / 1e6)

        # 6. fault: C is killed; k_min=1 masks its slots, k_min=4 raises, then its breakers skip it.
        # A sample whose four experts all sit on C has no live response, and k_min=1 raises for
        # it (the reference's semantics): the masked call takes the samples that keep one
        children["C"].report()  # its launch counts, before it dies
        children["C"].kill()
        killed_code = children["C"].process.exitcode
        all_on_c = np.array([all(info.uid in DMOE_LAYOUT["C"] for info in row[:DMOE_K]) for row in chosen])
        kept = torch.from_numpy(np.flatnonzero(~all_on_c)).to(x_t.device)
        moe.k_min = 1
        with torch.no_grad():
            out, masked_wall, _ = forward(moe, x_t[kept])
        experts, alive = moe.last_experts, moe.last_alive
        on_c = dmoe_slots_on(experts, alive.shape[1], DMOE_LAYOUT["C"])
        # the backward stepped the fp32 experts (Adam): the twins take the weights of the
        # replica that answered this call (A's blobs as fetched above, D's over rpc_replica_state)
        a_peer = PeerID.from_base58(children["A"].peer_id)
        for uid in sorted({uid for row in experts for uid in row} & set(DMOE_LAYOUT["A"])):
            peer = moe._experts[uid].peer_id
            if peer != a_peer:
                _spec, blobs[uid] = get_loop_runner().run_coroutine(fetch_replica_state(client_dht.node.p2p, peer, uid))
            twins[uid].load_state_dict(blobs[uid])
        with torch.no_grad():
            twin = dmoe_twin_mixture(torch, x_t[kept], moe.proj, experts, twins, alive=alive)
        masked_err = max_rel_err(out.cpu().numpy(), twin.cpu().numpy())
        exact_mask = bool(np.array_equal(~alive, on_c))
        moe.k_min = DMOE_K
        started = time.perf_counter()
        try:
            with torch.no_grad():
                moe(x_t)
            raised = None
        except RuntimeError as e:
            raised = str(e)
        strict_wall = time.perf_counter() - started
        moe.k_min = 1
        with torch.no_grad():
            _out, next_wall, _ = forward(moe, x_t[kept])
        next_on_c = dmoe_slots_on(moe.last_experts, moe.last_alive.shape[1], DMOE_LAYOUT["C"])
        open_breakers = sum(uid in EXPERT_BREAKERS for uid in DMOE_LAYOUT["C"])
        log(f"[dmoe] {line}: C SIGKILLed (exit code {killed_code}); {int(all_on_c.sum())} of {DMOE_BATCH} samples have "
            f"all {DMOE_K} experts on C; the k_min=1 call over the other {len(kept)} masked {int(on_c.sum())} slots, "
            f"the alive mask false exactly there: {exact_mask}; output vs the twin mixture over the live slots "
            f"max_rel_err={masked_err:.3e} (limit {DMOE_TOL}); wall {masked_wall * 1e3:.1f} ms. The k_min={DMOE_K} "
            f"call raised: {raised!r:.100} ({strict_wall * 1e3:.1f} ms). Then {open_breakers} of C's 28 breakers are "
            f"open: the next call demotes C's experts below the live candidates, and skips the {int(next_on_c.sum())} "
            f"slots still on C (samples with fewer than {DMOE_K} live candidates) without an RPC, masked: "
            f"{bool(np.array_equal(~moe.last_alive, next_on_c))}; wall {next_wall * 1e3:.1f} ms")
        check(killed_code == -signal.SIGKILL, f"C exited with {killed_code}")
        check(exact_mask and on_c.any(), "fault: the alive mask is not false exactly at C's slots")
        check(masked_err < DMOE_TOL, f"fault: masked output rel err {masked_err}")
        check(raised is not None and f"fewer than k_min={DMOE_K}" in raised, f"fault: k_min={DMOE_K} gave {raised!r}")
        check(open_breakers == len(DMOE_LAYOUT["C"]) and np.array_equal(~moe.last_alive, next_on_c)
              and next_on_c.sum() < on_c.sum(), f"fault: {open_breakers} breakers open, the next call masked "
              f"{int((~moe.last_alive).sum())} slots, {int(next_on_c.sum())} on C")
        readings["fault"] = dict(masked_wall=masked_wall, next_wall=next_wall, all_on_c=int(all_on_c.sum()))

        # 7. the swarm monitor sees a snapshot from every live server
        live = [role for role in ("A", "B", "D")]
        for role in live:
            children[role].ask("publish")
        expected_peers = {str(PeerID.from_base58(children[role].peer_id)) for role in live}
        monitor = SwarmMonitor(client_dht)
        started = time.perf_counter()
        while True:
            view = monitor.poll()
            if expected_peers <= set(view["peers"]) or time.perf_counter() - started > 10:
                break
            time.sleep(0.2)
        board = monitor.render_serving_board(view)
        log(f"[dmoe] {line}: SwarmMonitor sees {view['num_peers']} peers, every live server among them: "
            f"{expected_peers <= set(view['peers'])}; serving board:\n{board}")
        check(expected_peers <= set(view["peers"]) and "serving board" in board, "monitor: a live server is missing")
        for role in ("A", "B", "D", "E"):
            children[role].report()
    finally:
        if timer is not None:
            timer.cancel()
        live = [child for child in children.values() if child.process.is_alive()]
        for child in live:  # the servers shut down side by side
            with contextlib.suppress(Exception):
                child.conn.send(("stop",))
        for child in live:
            with contextlib.suppress(Exception):
                child.receive(20)
        for child in children.values():
            child.kill()
        for dht in reversed(dhts):
            dht.shutdown()
        reset_all_boards()  # C's open breakers belong to this phase
        shutil.rmtree(checkpoint_dir, ignore_errors=True)

    launches = {name: sum(child.last_report["counts"].get(name, 0) for child in children.values() if child.last_report)
                for name in wrappers}
    log(f"[dmoe] launches summed over the server processes (C's read just before its kill): {json.dumps(launches)}")
    elapsed = time.perf_counter() - phase_started
    log(f"[dmoe] phase wall {elapsed:.1f} s (limit {DMOE_PHASE_LIMIT_S} s)")
    check(elapsed <= DMOE_PHASE_LIMIT_S, f"[dmoe] took {elapsed:.1f} s > {DMOE_PHASE_LIMIT_S} s")
    telemetry.readings["dmoe"] = readings
    if faults:
        raise AssertionError("; ".join(faults))
    return launches


# ------------------------------------------------------------------ [averaging]


def averaging_bits(index: int) -> str:
    """A peer's group bits: the first AVG_GROUP_SIZE peers in bucket 0, the rest in 1."""
    return format(index // AVG_GROUP_SIZE, "b")


def averaging_group(index: int) -> list:
    first = index // AVG_GROUP_SIZE * AVG_GROUP_SIZE
    return list(range(first, first + AVG_GROUP_SIZE))


def averaging_limit(rounds: int) -> float:
    """The elementwise limit on |result - exact group mean|, as a multiple of the
    group's largest input magnitude S at that element, after ``rounds`` rounds of the
    fp16 wire. A round rounds each remote input part to fp16 (<= u16 S, so the reduced
    mean errs by <= u16 S) and the returned delta, at most 2 S, to fp16 (<= 2 u16 S),
    and the own input's rounding shows in the result once more (<= u16 S): 4 u16 S in
    the first round. A later round averages values already within that of the mean,
    so it adds the rounding of its inputs and of its near-zero delta: 2 u16 S. The
    fp32 sums and divides add a few u32 S."""
    return (2 + 2 * rounds) * AVG_U16 + 16 * AVG_U32


def averaging_seeded(torch, seed: int):
    generator = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(AVG_PARAMS, generator=generator, device="cuda")


def hold_to_group_mean(torch, result, seeds: list, rounds: int) -> dict:
    """``result`` (fp32 on the card) against the exact float64 mean of the tensors the
    seeds make, element by element within ``averaging_limit(rounds)`` of the group's
    largest magnitude: ``ratio`` is the worst error over its limit (<= 1 passes). The
    planted fault, a mean that leaves the last member out, must fail the same check:
    ``fault_ratio`` > 1."""
    inputs = [averaging_seeded(torch, seed) for seed in seeds]
    factor = averaging_limit(rounds)
    ratio = fault_ratio = 0.0
    chunk = 10_000_000
    for start in range(0, AVG_PARAMS, chunk):
        stacked = torch.stack([x[start:start + chunk] for x in inputs]).double()
        total = stacked.sum(0)
        limit = factor * stacked.abs().amax(0)
        got = result[start:start + chunk].double()
        ratio = max(ratio, ((got - total / len(inputs)).abs() / limit).max().item())
        faulty = (total - stacked[-1]) / (len(inputs) - 1)
        fault_ratio = max(fault_ratio, ((got - faulty).abs() / limit).max().item())
    finite = bool(torch.isfinite(result).all().item()) and tuple(result.shape) == (AVG_PARAMS,)
    return dict(ratio=ratio, fault_ratio=fault_ratio, finite=finite)


def averaging_peer_main(conn, index: int, initial_peers: list) -> None:
    """One peer of ``[averaging]`` (index AVG_PEERS: the late joiner that downloads the
    state): its own DHT peer, bootstrapped from the parent's, and a
    ``DecentralizedAverager`` over one seeded tensor of AVG_PARAMS on the card, fp16 on
    the wire, uncompressed state for downloads. Answers the parent's commands over
    ``conn``: ``step`` (one round; after it the averages are copied back to the card and
    held there against the exact group mean, or saved for the parent), ``reseed``
    (fresh seeded values), ``digest`` (blake2b-16 of its tensor's bytes), ``load``
    (``load_state_from_peers``, verified) and ``stop``."""
    import hashlib
    import resource
    import traceback

    def cpu_seconds() -> float:
        usage = resource.getrusage(resource.RUSAGE_SELF)
        return usage.ru_utime + usage.ru_stime

    try:
        import torch

        from hivemind_tpu_torch.averaging import DecentralizedAverager
        from hivemind_tpu_torch.compression import Float16Compression, NoCompression
        from hivemind_tpu_torch.dht import DHT
        from hivemind_tpu_torch.telemetry import LEDGER

        loader = index == AVG_PEERS
        seed_base = SEED
        params = torch.zeros(AVG_PARAMS, device="cuda") if loader else averaging_seeded(torch, seed_base + index)
        dht = DHT(initial_peers=initial_peers, start=True)
        averager = DecentralizedAverager(
            [params], dht, prefix=AVG_PREFIX, start=True, target_group_size=AVG_GROUP_SIZE,
            min_group_size=AVG_GROUP_SIZE, initial_group_bits=averaging_bits(index),
            min_matchmaking_time=AVG_MATCHMAKING_S,
            compression=Float16Compression(), state_compression=NoCompression(), allow_state_sharing=not loader)
        del params
        applied = [0.0]
        apply_delta = averager._apply_delta

        async def timed_apply(tensor_index, delta):
            started = time.perf_counter()
            await apply_delta(tensor_index, delta)
            applied[0] += time.perf_counter() - started

        averager._apply_delta = timed_apply
        conn.send(("ready", dht.peer_id.to_base58(), torch.cuda.get_device_name(0)))
        rounds = 0  # since the tensor was last seeded
        while True:
            command, *args = conn.recv()
            if command == "step":
                announce, save_path, check = args
                averager.set_group_bits(averaging_bits(index))  # undo the last round's rebucketing
                applied[0], cpu_before, started = 0.0, cpu_seconds(), time.perf_counter()
                control = averager.step(gather=index, wait=False, timeout=AVG_STEP_TIMEOUT_S)
                if announce:
                    while not control.began_allreduce and not control.done():
                        time.sleep(0.001)
                    conn.send(("began",))
                gathered = control.result(timeout=AVG_STEP_TIMEOUT_S + 30)
                seconds, cpu = time.perf_counter() - started, cpu_seconds() - cpu_before
                rounds += 1
                record = [r for r in LEDGER.records() if r["peer"] == str(dht.peer_id)][-1]
                with averager.get_tensors() as tensors:
                    result = tensors[0].to("cuda")  # the caller's copy back to the card
                torch.cuda.synchronize()
                members = sorted(gathered.values())
                reading = dict(members=members, seconds=seconds, cpu=cpu, apply=applied[0],
                               matchmaking=record.get("matchmaking_wait_s"), allreduce=record["total_s"])
                if check:
                    reading.update(hold_to_group_mean(torch, result, [seed_base + j for j in members], rounds))
                if save_path is not None:
                    np.save(save_path, result.cpu().numpy())
                del result
                torch.cuda.empty_cache()
                conn.send(("stepped", reading))
            elif command == "reseed":
                (seed_base,) = args
                with averager.get_tensors() as tensors:
                    tensors[0].copy_(averaging_seeded(torch, seed_base + index).cpu())
                rounds = 0
                conn.send(("ok",))
            elif command == "digest":
                with averager.get_tensors() as tensors:
                    conn.send(("digest", hashlib.blake2b(tensors[0].numpy().tobytes(), digest_size=16).hexdigest()))
            elif command == "load":
                started = time.perf_counter()
                result = averager._runner.run_coroutine(averager._load_state_from_peers_async(timeout=AVG_STEP_TIMEOUT_S))
                seconds = time.perf_counter() - started
                (state,) = result.tensors
                on_card = state.to("cuda")
                conn.send(("loaded", dict(
                    seconds=seconds, bytes=result.bytes_received, verified=result.verified, donors=result.donors,
                    digest=hashlib.blake2b(state.numpy().tobytes(), digest_size=16).hexdigest(),
                    finite=bool(torch.isfinite(on_card).all().item()), shape=tuple(on_card.shape),
                    dtype=str(on_card.dtype))))
            elif command == "stop":
                averager.shutdown()
                dht.shutdown()
                conn.send(("stopped",))
                return
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise


class AveragingChild(SwarmChild):
    """The parent's handle on one peer process of ``[averaging]``."""

    def __init__(self, context, index: int, initial_peers: list):
        self.index = index
        self.name = f"averaging peer {index}" if index < AVG_PEERS else "the state-loading peer"
        self.conn, child_conn = context.Pipe()
        self.process = context.Process(target=averaging_peer_main, args=(child_conn, index, initial_peers), daemon=True)
        self.process.start()
        child_conn.close()
        self.peer_id = self.device = self.last_report = None


def on_own_stream(torch, fn, *args):
    """``fn(*args)`` with this thread's card work on a CUDA stream of its own, so that it
    never queues between the calls that another thread times on the default stream."""
    with torch.cuda.stream(torch.cuda.Stream()):
        return fn(*args)


def host_line() -> str:
    """The host's cores, CPU model and memory: host-bound phases read against them."""
    model, memory = "?", float("nan")
    with open("/proc/cpuinfo") as cpuinfo:
        model = next((line.split(":", 1)[1].strip() for line in cpuinfo if line.startswith("model name")), model)
    with open("/proc/meminfo") as meminfo:
        memory = next((int(line.split()[1]) / 2**20 for line in meminfo if line.startswith("MemTotal:")), memory)
    return f"{os.cpu_count()} cores ({model}), {memory:.1f} GiB"


def phase_averaging(torch) -> None:
    """Decentralized averaging across processes (BASELINE config 2,
    benchmarks/benchmark_averaging.py at its published size): this process is the
    bootstrap DHT peer; AVG_PEERS child peers each average AVG_PARAMS float32
    parameters made on the card, in two groups of AVG_GROUP_SIZE over the fp16 wire.
    Checks, in order: three rounds held on the card to the exact group mean (a planted
    fault must fail the same check); GB/s per peer, as benchmark_averaging.py computes
    it; a fourth round in which one peer is SIGKILLed once its all-reduce has begun;
    a late peer's verified state download. Launches no kernel."""
    import importlib.metadata
    import multiprocessing
    import threading

    from hivemind_tpu_torch.averaging.partition import DEFAULT_PART_SIZE_BYTES
    from hivemind_tpu_torch.dht import DHT

    phase_started = time.perf_counter()
    context = multiprocessing.get_context("forkserver")  # CHILD_PRELOAD
    children, dhts, faults = [], [], []
    scratch = tempfile.TemporaryDirectory(prefix="averaging_")
    timer = None

    def check(ok: bool, what: str) -> None:
        if not ok:
            faults.append(what)

    def kill_all() -> None:
        for child in children:
            child.kill()

    log(f"[averaging] host {host_line()}; scipy {importlib.metadata.version("scipy")} (HiGHS cuts the parts); {AVG_PEERS} peers x "
        f"{AVG_PARAMS:,} float32 parameters ({AVG_PARAMS * 4 / 1e6:.0f} MB each on the card), groups of {AVG_GROUP_SIZE} (bits "
        f"{sorted({averaging_bits(i) for i in range(AVG_PEERS)})}), fp16 wire, parts of "
        f"{DEFAULT_PART_SIZE_BYTES >> 20} MiB, min_matchmaking_time {AVG_MATCHMAKING_S} s")
    try:
        started = time.perf_counter()
        bootstrap = DHT(start=True)
        dhts.append(bootstrap)
        initial_peers = [str(maddr) for maddr in bootstrap.get_visible_maddrs()]
        children.extend(AveragingChild(context, index, initial_peers) for index in range(AVG_PEERS))
        timer = threading.Timer(AVG_KILL_LIMIT_S, kill_all)  # a hung peer or call: every child dies
        timer.daemon = True
        timer.start()
        for child in children:
            _, child.peer_id, child.device = child.receive(AVG_STARTUP_LIMIT_S - (time.perf_counter() - started))
        by_peer = {child.peer_id: child for child in children}
        log(f"[averaging] {AVG_PEERS} peer processes up in {time.perf_counter() - started:.1f} s "
            f"(devices {sorted({child.device for child in children})})")

        # 1-2. three rounds, each held on the card; throughput over the three
        walls, cpu = [], {child.index: 0.0 for child in children}
        for round_index in range(1, AVG_ROUNDS + 1):
            for child in children:  # announce nothing, save nothing, hold to the mean
                child.conn.send(("step", False, None, True))
            stepped = {child: child.receive(AVG_STEP_TIMEOUT_S + 60)[1] for child in children}
            walls.append(max(reading["seconds"] for reading in stepped.values()))
            for child, reading in stepped.items():
                cpu[child.index] += reading["cpu"]
                check(reading["members"] == averaging_group(child.index),
                      f"round {round_index}: peer {child.index} averaged with {reading['members']}")
                check(reading["finite"] and reading["ratio"] <= 1.0,
                      f"round {round_index}: peer {child.index} is {reading['ratio']:.3f} x its limit off the mean")
                check(reading["fault_ratio"] > 1.0,
                      f"round {round_index}: peer {child.index}'s check passed a mean without peer "
                      f"{reading['members'][-1]}")
            values = list(stepped.values())
            log(f"[averaging] round {round_index}: {walls[-1]:.3f} s (the slowest peer's step; median "
                f"{np.median([r['seconds'] for r in values]):.3f} s); ledger split, median over peers: matchmaking "
                f"{np.median([r['matchmaking'] or 0.0 for r in values]):.3f} s, all-reduce "
                f"{np.median([r['allreduce'] for r in values]):.3f} s, of which apply "
                f"{np.median([r['apply'] for r in values]):.3f} s; groups "
                f"{sorted({tuple(r['members']) for r in values})}; worst error / limit "
                f"{max(r['ratio'] for r in values):.4f} (limit {averaging_limit(round_index) / AVG_U16:.0f} u16 x the "
                f"group's largest |x|, every element, on the card); the planted fault (a mean without the last "
                f"member) at {min(r['fault_ratio'] for r in values):.1f} x the limit: rejected")
        gbps = AVG_PARAMS * 4 * 2 * AVG_ROUNDS / sum(walls) / 1e9  # benchmark_averaging.py:106-107
        log(f"[averaging] averaging_gbps_per_peer={gbps:.4f} ({AVG_ROUNDS} rounds, {sum(walls) / AVG_ROUNDS:.3f} s a "
            f"round); CPU seconds of each peer over the {AVG_ROUNDS} rounds: "
            + ", ".join(f"{index}: {seconds:.1f}" for index, seconds in sorted(cpu.items())))

        # 3. a fourth round on fresh values, with a peer killed once its all-reduce has begun
        for child in children:
            child.ask(("reseed", SEED + AVG_FAULT_SEED))
        victim = children[AVG_VICTIM]
        saved = {index: os.path.join(scratch.name, f"peer{index}.npy") for index in averaging_group(AVG_VICTIM)
                 if index != AVG_VICTIM}
        commands = {child: (child is victim, saved.get(child.index), child.index not in saved and child is not victim)
                    for child in children}
        for child, command in commands.items():
            child.conn.send(("step", *command))
        victim.receive(AVG_STEP_TIMEOUT_S)  # its all-reduce has begun
        time.sleep(AVG_KILL_DELAY_S)
        victim.kill()
        check(victim.process.exitcode == -signal.SIGKILL, f"the victim exited with {victim.process.exitcode}")
        try:  # a dead child's pipe reads as EOF; a reply means its round had ended before the kill
            finished = victim.conn.poll(0) and victim.conn.recv()[0] == "stepped"
        except (EOFError, OSError):
            finished = False
        check(not finished, f"the kill came after peer {AVG_VICTIM}'s round had ended")
        stepped = {child: child.receive(AVG_STEP_TIMEOUT_S + 60)[1] for child in children if child is not victim}
        for child, reading in stepped.items():
            check(reading["seconds"] <= AVG_STEP_TIMEOUT_S,
                  f"round 4: peer {child.index} took {reading['seconds']:.1f} s > its step timeout")
            if child.index in saved:
                continue
            check(reading["members"] == averaging_group(child.index) and reading["finite"] and reading["ratio"] <= 1.0,
                  f"round 4: peer {child.index} of the other group: {reading['members']}, {reading['ratio']:.3f} x "
                  f"its limit off the mean")
        survivors = [torch.from_numpy(np.load(path)).to("cuda") for path in saved.values()]
        inputs = [averaging_seeded(torch, SEED + AVG_FAULT_SEED + index) for index in averaging_group(AVG_VICTIM)]
        tolerance = 2 * averaging_limit(1) * torch.stack(inputs).abs().amax(0)
        agree = torch.ones(AVG_PARAMS, dtype=torch.bool, device="cuda")
        for other in survivors[1:]:
            agree &= (other - survivors[0]).abs() <= tolerance
        agreement = agree.float().mean().item()
        del survivors, inputs, tolerance, agree
        torch.cuda.empty_cache()
        survivor_seconds = [stepped[children[index]]["seconds"] for index in saved]
        log(f"[averaging] round 4 (fresh seeded values): peer {AVG_VICTIM} SIGKILLed {AVG_KILL_DELAY_S} s after its "
            f"all-reduce began; its group's survivors {list(saved)} ended in "
            f"{', '.join(f'{s:.3f}' for s in survivor_seconds)} s (step timeout {AVG_STEP_TIMEOUT_S:.0f} s) and agree "
            f"on {agreement:.1%} of the vector (at least 50%, within 2 x the fp16 limit); the other group "
            f"{sorted({tuple(r['members']) for c, r in stepped.items() if c.index not in saved})} held to its mean, "
            f"worst {max(r['ratio'] for c, r in stepped.items() if c.index not in saved):.4f} x the limit")
        check(agreement >= 0.5, f"round 4: the survivors agree on {agreement:.1%} of the vector")

        # 4. a late peer downloads the state from the swarm
        loader = AveragingChild(context, AVG_PEERS, initial_peers)
        children.append(loader)
        loader.receive(AVG_STARTUP_LIMIT_S)
        _, loaded = loader.ask(("load",), timeout=AVG_STEP_TIMEOUT_S + 30)
        donor = by_peer.get(loaded["donors"][-1]) if loaded["donors"] else None
        donor_digest = donor.ask(("digest",))[1] if donor is not None else None
        rate = loaded["bytes"] / loaded["seconds"] / 1e6
        log(f"[averaging] state download: a new peer loaded {loaded['bytes']:,} B ({loaded['shape']}, "
            f"{loaded['dtype']}) from peer {donor.index if donor else '?'} in {loaded['seconds']:.3f} s = "
            f"{rate:.1f} MB/s (one stream; [dmoe]'s replica transfers: 67-92 MB/s); every digest verified: "
            f"{loaded['verified']}; bytes equal to the donor's: {loaded['digest'] == donor_digest}; finite on the card: "
            f"{loaded['finite']}")
        check(loaded["verified"] and loaded["digest"] == donor_digest and loaded["finite"]
              and loaded["shape"] == (AVG_PARAMS,), f"state download: {loaded}, donor digest {donor_digest}")
    finally:
        if timer is not None:
            timer.cancel()
        for child in children:
            if child.process.is_alive():
                with contextlib.suppress(Exception):
                    child.ask(("stop",), timeout=20)
            child.kill()
        for dht in reversed(dhts):
            dht.shutdown()
        scratch.cleanup()
    elapsed = time.perf_counter() - phase_started
    log(f"[averaging] phase wall {elapsed:.1f} s (limit {AVG_PHASE_LIMIT_S:.0f} s)")
    check(elapsed <= AVG_PHASE_LIMIT_S, f"[averaging] took {elapsed:.1f} s > {AVG_PHASE_LIMIT_S:.0f} s")
    if faults:
        raise AssertionError("; ".join(faults))


def collab_layout(model) -> list:
    """``(name, transposed, flax shape)`` of each parameter in the averaged view's order:
    the flax tree's flatten order, Dense kernels ``[in, out]``, the embedding as it is
    (hivemind_tpu_torch/convert.py)."""
    from hivemind_tpu_torch.convert import flax_path

    entries = []
    for name, param in model.named_parameters():
        path, transposed = flax_path(name, param.ndim)
        entries.append((path, name, transposed, tuple(param.T.shape if transposed else param.shape)))
    return [entry[1:] for entry in sorted(entries)]


def collab_split(torch, flat: np.ndarray, layout: list) -> tuple:
    """A peer's saved averaged view (parameters, mu, nu in the JAX package's layout, one
    float32 array) as three dicts of tensors on the card in torch layout."""
    tensor = torch.from_numpy(flat).to("cuda")
    parts, offset = [], 0
    for _ in range(3):
        part = {}
        for name, transposed, shape in layout:
            view = tensor[offset:offset + math.prod(shape)].view(shape)
            part[name] = (view.T if transposed else view).contiguous()
            offset += math.prod(shape)
        parts.append(part)
    if offset != tensor.numel():
        raise AssertionError(f"a saved view holds {tensor.numel()} values, the layout {offset}")
    return tuple(parts)


def collab_peer_main(conn, index: int, initial_peers: list, scratch: str, recipe: dict) -> None:
    """One peer of ``[collab]`` (index COLLAB_PEERS: the late joiner) or of ``[slice]``
    (``recipe``: its run id, group size, target batch and initial weights' seed): its own DHT peer,
    bootstrapped from the parent's, and ALBERT-base on the card trained through the
    collaborative Optimizer. Answers the parent's commands over ``conn``: ``train``
    (batches until the given epoch; the reading carries every accumulated batch's
    ``(k, batch size, epoch)`` and the epoch's time split), ``save`` (its averaged
    view to a file), ``load`` (``load_state_from_peers()``), ``digest`` (blake2b-16 of
    its view) and ``stop``."""
    import hashlib
    import traceback

    try:
        import torch

        from hivemind_tpu_torch.compression import NoCompression
        from hivemind_tpu_torch.dht import DHT
        from hivemind_tpu_torch.models import AlbertConfig, AlbertForMaskedLM, make_mlm_loss_fn, make_synthetic_mlm_batch
        from hivemind_tpu_torch.moe.server.layers import lamb_with_warmup
        from hivemind_tpu_torch.ops import flash_attention
        from hivemind_tpu_torch.optim import Optimizer
        from hivemind_tpu_torch.telemetry import LEDGER
        from hivemind_tpu_torch.telemetry.tracing import add_span_listener

        torch.backends.cuda.matmul.allow_tf32 = False
        kernels = {"flash_attention_forward": flash_attention.flash_attention_lse,
                   "flash_attention_backward_dq": flash_attention.flash_attention_backward_dq,
                   "flash_attention_backward_dkv": flash_attention.flash_attention_backward_dkv}
        config = AlbertConfig.base(max_position=TRAIN_SEQ)
        model = AlbertForMaskedLM(config, device="cuda")
        model.reset_parameters(torch.Generator(device="cuda").manual_seed(recipe["init_seed"]))
        loss_fn = make_mlm_loss_fn(model, TRAIN_MASKED_FRACTION)
        dht = DHT(initial_peers=initial_peers, start=True)
        opt = Optimizer(dht=dht, run_id=recipe["run_id"], target_batch_size=recipe["target"],
                        params=model.named_parameters(), optimizer=lamb_with_warmup(*COLLAB_LAMB),
                        batch_size_per_step=TRAIN_BATCH, matchmaking_time=COLLAB_MATCHMAKING_S, average_state_every=1,
                        min_group_size=recipe["min_group_size"], state_averaging_compression=NoCompression())
        me = str(dht.peer_id)
        spans = {}  # this epoch's host seconds in the Optimizer's own spans, and the state rounds' outcomes

        def on_span(span) -> None:
            if span.name in ("optimizer.update", "state_averager.round"):
                spans[span.name] = spans.get(span.name, 0.0) + span.duration
            if span.name == "state_averager.round":
                spans.setdefault("averaged", []).append(span.attributes.get("averaged"))

        add_span_listener(on_span)

        def view() -> np.ndarray:
            return np.concatenate([t.reshape(-1) for t in opt.state_averager._host_state_tensors()])

        conn.send(("ready", dht.peer_id.to_base58(), torch.cuda.get_device_name(0)))
        k = steps = 0
        while True:
            command, *args = conn.recv()
            if command == "train":
                (until,) = args
                if steps == 0:  # the path starts here: every count at 0
                    for wrapper in kernels.values():
                        wrapper.launches = 0
                    torch.cuda.reset_peak_memory_stats()
                spans.clear()
                rounds_before = len(LEDGER.records())
                batches, losses, compute, accumulate, transition = [], [], 0.0, 0.0, 0.0
                started = time.perf_counter()
                while opt.local_epoch < until:
                    k += 1
                    generator = torch.Generator(device="cuda").manual_seed(collab_batch_seed(index, k))
                    batch = make_synthetic_mlm_batch(generator, config, TRAIN_BATCH, TRAIN_SEQ)
                    epoch = opt.local_epoch
                    begun = time.perf_counter()
                    loss = loss_fn(batch)
                    loss.backward()
                    losses.append(loss.item())  # synchronizes: the step's card time ends here
                    computed = time.perf_counter()
                    opt.step(batch_size=TRAIN_BATCH)
                    opt.zero_grad()
                    stepped = time.perf_counter()
                    compute += computed - begun
                    if opt.local_epoch != epoch:
                        transition += stepped - computed
                    else:
                        accumulate += stepped - computed
                    batches.append((k, TRAIN_BATCH, epoch))
                    steps += 1
                rounds = [r for r in LEDGER.records()[rounds_before:] if r["peer"] == me]
                update, state_round = spans.get("optimizer.update", 0.0), spans.get("state_averager.round", 0.0)
                grad_allreduce = rounds[0]["total_s"] if rounds else float("nan")
                conn.send(("trained", dict(
                    epoch=opt.local_epoch, batches=batches, wall=time.perf_counter() - started, compute=compute,
                    accumulate=accumulate, transition=transition, update=update, state_round=state_round,
                    # the epoch's last step, less what the spans and the round record account for
                    waiting=transition - update - state_round - grad_allreduce, grad_allreduce=grad_allreduce,
                    state_allreduce=rounds[-1]["total_s"] if len(rounds) > 1 else float("nan"),
                    group_sizes=[r.get("group_size") for r in rounds], failed=opt.consecutive_failed_averaging_rounds,
                    state_ok=spans.get("averaged") == [True],
                    counts=opt.state_averager._get_opt_counts(), losses=losses, steps=steps,
                    launches={name: wrapper.launches for name, wrapper in kernels.items()},
                    peak=torch.cuda.max_memory_allocated())))
            elif command == "save":
                (epoch,) = args
                np.save(os.path.join(scratch, f"peer{index}_e{epoch}.npy"), view())
                conn.send(("saved",))
            elif command == "load":
                started = time.perf_counter()
                ok = opt.load_state_from_peers()
                seconds = time.perf_counter() - started
                result = opt.state_averager.last_download
                mine = view()
                conn.send(("loaded", dict(
                    ok=ok, seconds=seconds, epoch=opt.local_epoch, counts=opt.state_averager._get_opt_counts(),
                    donors=list(result.donors) if result else [], verified=bool(result and result.verified),
                    bytes=result.bytes_received if result else 0, finite=bool(np.isfinite(mine).all()),
                    digest=hashlib.blake2b(mine.tobytes(), digest_size=16).hexdigest())))
            elif command == "digest":
                mine = view()
                conn.send(("digest", dict(
                    epoch=opt.local_epoch, counts=opt.state_averager._get_opt_counts(),
                    digest=hashlib.blake2b(mine.tobytes(), digest_size=16).hexdigest())))
            elif command == "stop":
                opt.shutdown()
                dht.shutdown()
                conn.send(("stopped",))
                return
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise


class CollabChild(SwarmChild):
    """The parent's handle on one peer process of ``[collab]``."""

    def __init__(self, context, index: int, initial_peers: list, scratch: str, recipe: Optional[dict] = None):
        self.index = index
        self.name = f"collab peer {index}" if index < COLLAB_PEERS else "the joining collab peer"
        recipe = recipe or dict(run_id=COLLAB_RUN_ID, min_group_size=COLLAB_PEERS, init_seed=COLLAB_INIT_SEED,
                                target=COLLAB_TARGET)
        self.conn, child_conn = context.Pipe()
        self.process = context.Process(target=collab_peer_main,
                                       args=(child_conn, index, initial_peers, scratch, recipe), daemon=True)
        self.process.start()
        child_conn.close()
        self.peer_id = self.device = self.last_report = None


def collab_rate(torch, transition: int) -> float:
    """``lamb_with_warmup``'s rate at ``transition``: its schedule reads the count before
    the increment, so transition 0 has a rate of 0."""
    from hivemind_tpu_torch.moe.server.layers import linear_warmup_schedule

    return float(linear_warmup_schedule(*COLLAB_LAMB)(torch.tensor(transition, dtype=torch.int32)))


def collab_step_bound(torch, transition: int, leaf_norm: float) -> float:
    """The most one LAMB step of ``transition`` moves an element of a leaf of norm
    ``leaf_norm``: lr x max(|p|, U). LAMB's step is lr x trust ratio x update, of size
    lr |p| at most per element, or lr |update| when |p| = 0 (a ratio of 1), and Adam's
    |m̂|/√v̂ is at most U = sqrt(Σ_k ((1−b1) b1^k)² / ((1−b2) b2^k)) x sqrt(1 − b2^t) /
    (1 − b1^t) after t updates (Cauchy-Schwarz). 0 at transition 0, whose rate is 0."""
    rate = collab_rate(torch, transition)
    b1, b2, t = 0.9, 0.999, transition + 1  # optax.lamb's betas
    adam_bound = math.sqrt(sum(((1 - b1) * b1**k) ** 2 / ((1 - b2) * b2**k) for k in range(t))) * math.sqrt(
        1 - b2**t) / (1 - b1**t)
    return rate * max(adam_bound, leaf_norm)


def collab_step_error(torch, transition: int, param, mu, nu, dm, dv) -> float:
    """The most ‖a peer's LAMB step − the reference's‖ / lr can be on one leaf at
    ``transition``, when both start from ``param`` and the peer's new mu and nu lie
    within ``dm`` and ``dv`` of the reference's ``mu`` and ``nu`` (elementwise):

    - Adam's u = m̂/(√v̂ + eps) rises with m and falls in |u| with v, so over that box
      each element of the peer's u lies within D of the reference's, D read at the box's
      corners, plus 12 u32 |u| for the fp32 arithmetic of both;
    - the step is lr ‖p‖ u/‖u‖ (the trust ratio), and ‖x/‖x‖ − y/‖y‖‖ ≤
      min(2, 2 ‖x − y‖/‖y‖); a leaf with ‖p‖ = 0 steps by lr u (a ratio of 1);
    - plus 4 u32 of the step for its own fp32 products."""
    b1, b2, eps = 0.9, 0.999, 1e-6  # optax.lamb's
    count = torch.tensor(transition + 1, dtype=torch.float32)
    c1 = float(1 - torch.pow(torch.tensor(b1, dtype=torch.float32), count))  # as optax's bias correction
    c2 = float(1 - torch.pow(torch.tensor(b2, dtype=torch.float32), count))
    mu, nu = mu.double(), nu.double()
    dm = dm.double() + 4 * AVG_U32 * mu.abs()
    dv = dv.double() + 4 * AVG_U32 * nu.abs()
    root = lambda v: (v.clamp_min(0) / c2).sqrt() + eps
    u = (mu / c1) / root(nu)
    near, far = root(nu - dv), root(nu + dv)
    m_low, m_high = (mu - dm) / c1, (mu + dm) / c1
    spread = torch.maximum(torch.maximum(m_high / near, m_high / far) - u,
                           u - torch.minimum(m_low / near, m_low / far))
    d_norm = float((spread + 12 * AVG_U32 * u.abs()).norm())
    u_norm, p_norm = float(u.norm()), float(param.double().norm())
    if p_norm == 0:
        return d_norm + 4 * AVG_U32 * u_norm
    return p_norm * (min(2.0, 2 * d_norm / u_norm) if u_norm > 0 else 2.0) + 4 * AVG_U32 * p_norm


def collab_limits(torch, reference: list, pre: list, transition: int, layout: list, local_max: dict,
                  grad: dict) -> tuple:
    """The limits on a peer's state after ``transition`` against the reference (the
    mean of ``reference``: one step of each peer's own state ``pre``), derived from the
    wires:

    - the state round averages each peer's post-update state losslessly: within
      COLLAB_STATE_FACTOR (16 u32) of the largest magnitude S among the peers' values;
    - each peer applied the gradient the fp16 all-reduce gave it, within
      δ = averaging_limit(1) (4 u16 + 16 u32, PR 11's derivation) x the largest |local
      mean gradient| + 4 x 2^-25 (each fp16 rounding of a value below fp16's normal range
      errs by half the subnormal spacing) of the exact sample-weighted mean G; after clipping by c = min(1, 1/|G|), within
      e = c δ + c r/(1−r) (|G| + δ), r = |δ|/|G| (the clip factor's own error);
    - so mu moves by at most dm = (1 − b1) e more and nu by dv = (1 − b2)(2 c|G| e + e²),
      elementwise;
    - and a leaf of parameters by at most lr x ``collab_step_error`` more, in norm, plus
      the state round's 16 u32 ‖S‖ and 3 u32 ‖S‖ for the fp32 sums p + step (the peer's
      and the reference's).

    Returns (the parameters' limit on the norm of the error, per leaf; mu's and nu's
    elementwise limits)."""
    rate = collab_rate(torch, transition)
    factor = averaging_limit(1)
    floor = 4 * COLLAB_F16_ABS
    delta = {name: factor * local_max[name] + floor for name in grad}
    g_norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grad.values()))
    d_norm = math.sqrt(sum(float((d.double() ** 2).sum()) for d in delta.values()))
    clip, ratio = min(1.0, 1.0 / g_norm), d_norm / g_norm
    error = {name: clip * delta[name] + clip * ratio / (1 - ratio) * (grad[name].abs() + delta[name]) for name in grad}
    params, mu, nu = {}, {}, {}
    for name, _, _ in layout:
        scale = [torch.stack([peer[kind][name].abs() for peer in reference]).amax(0) for kind in range(3)]
        dm = 0.1 * error[name]
        dv = 1e-3 * (2 * clip * grad[name].abs() * error[name] + error[name] ** 2)
        mu[name] = COLLAB_STATE_FACTOR * scale[1] + dm
        nu[name] = COLLAB_STATE_FACTOR * scale[2] + dv
        step = max(collab_step_error(torch, transition, own[0][name], ref[1][name], ref[2][name], dm, dv)
                   for own, ref in zip(pre, reference)) if rate else 0.0
        params[name] = (COLLAB_STATE_FACTOR + 3 * AVG_U32) * float(scale[0].double().norm()) + rate * step
    return params, mu, nu


def collab_reference_step(torch, pre: tuple, grad: dict, transition: int) -> tuple:
    """One ``lamb_with_warmup`` step of the port's transforms from a peer's state before
    ``transition`` (parameters, mu, nu; count = transition) with the gradient ``grad``."""
    from hivemind_tpu_torch.moe.server.layers import lamb_with_warmup
    from hivemind_tpu_torch.optim import transforms as T

    params, mu, nu = pre
    count = torch.tensor(transition, dtype=torch.int32, device="cuda")
    state = (T.EmptyState(), (T.ScaleByAdamState(count=count, mu=mu, nu=nu), T.EmptyState(), T.EmptyState(),
                              T.ScaleByScheduleState(count=count)))
    updates, (_, (adam, *_)) = lamb_with_warmup(*COLLAB_LAMB).update(grad, state, params)
    return T.apply_updates(params, updates), adam.mu, adam.nu


# the planted faults in a peer's parameter step: post = pre + f x (its step)
COLLAB_STEP_FAULTS = {"the update not applied": 0.0, "the update's sign flipped": -1.0,
                      "the rate doubled (the schedule read one count late)": 2.0}


def collab_hold(torch, transition: int, readings: dict, scratch: str, layout: list,
                init_seed: int = COLLAB_INIT_SEED, precomputed: Optional[dict] = None,
                fault_peer: int = COLLAB_FAULT_PEER) -> dict:
    """Large-batch equivalence at ``transition``: recompute on the card the gradient of
    every batch each peer accumulated in that epoch, from that peer's parameters of the
    epoch, take their sample-weighted mean in fp32, apply one ``lamb_with_warmup`` step
    to each peer's state of the epoch, and hold each peer's state after the transition
    to the mean of those steps within ``collab_limits``: mu and nu element by element,
    the parameters leaf by leaf in norm (their step is lr ‖p‖ in norm, far below any
    element's limit). Planted faults must fail it: the reference with peer
    COLLAB_FAULT_PEER's batches left out, and, where the rate is not 0, each peer's
    parameter step altered as COLLAB_STEP_FAULTS says. Returns the worst ratio error /
    limit of each kind and each fault's, the update's card time and how many limits a
    whole step spans. ``precomputed`` gives a peer's gradient sums and samples instead (a
    slice's, summed through its mesh); ``fault_peer`` is the peer whose batches the
    planted fault leaves out; ``init_seed`` draws the weights before transition 0."""
    from hivemind_tpu_torch.models import AlbertConfig, AlbertForMaskedLM, make_mlm_loss_fn, make_synthetic_mlm_batch

    precomputed = precomputed or {}
    config = AlbertConfig.base(max_position=TRAIN_SEQ)
    model = AlbertForMaskedLM(config, device="cuda")
    loss_fn = make_mlm_loss_fn(model, TRAIN_MASKED_FRACTION)
    peers = sorted(readings[transition])
    names = [name for name, _, _ in layout]
    if transition == 0:
        model.reset_parameters(torch.Generator(device="cuda").manual_seed(init_seed))
        initial = {name: p.detach().clone() for name, p in model.named_parameters()}
        zeros = {name: torch.zeros_like(p) for name, p in initial.items()}
        pre = {i: (initial, zeros, zeros) for i in peers}
    else:
        pre = {i: collab_split(torch, np.load(os.path.join(scratch, f"peer{i}_e{transition}.npy")), layout) for i in peers}
    post = {i: collab_split(torch, np.load(os.path.join(scratch, f"peer{i}_e{transition + 1}.npy")), layout)
            for i in peers}
    sums, samples = {}, {}
    for i in peers:
        if i in precomputed:
            sums[i], samples[i] = precomputed[i]
            continue
        with torch.no_grad():
            for name, param in model.named_parameters():
                param.copy_(pre[i][0][name])
        sums[i] = {name: torch.zeros_like(p) for name, p in model.named_parameters()}
        samples[i] = 0
        for k, size, epoch in readings[transition][i]["batches"]:
            if epoch != transition:
                raise AssertionError(f"peer {i} accumulated batch {k} in epoch {epoch} during epoch {transition}")
            generator = torch.Generator(device="cuda").manual_seed(collab_batch_seed(i, k))
            model.zero_grad(set_to_none=True)
            loss_fn(make_synthetic_mlm_batch(generator, config, size, TRAIN_SEQ)).backward()
            for name, param in model.named_parameters():
                sums[i][name] += param.grad * size
            samples[i] += size
    del model
    local_max = {name: torch.stack([sums[i][name] / samples[i] for i in peers]).abs().amax(0) for name in names}

    def mean_gradient(members):
        total = sum(samples[i] for i in members)
        return {name: sum(sums[i][name] for i in members) / total for name in names}

    def reference(gradient, timings=None):
        stepped = []
        for i in peers:
            started, ended = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            started.record()
            stepped.append(collab_reference_step(torch, pre[i], gradient, transition))
            ended.record()
            ended.synchronize()
            if timings is not None:
                timings.append(started.elapsed_time(ended))
        mean = [{name: torch.stack([s[kind][name].double() for s in stepped]).mean(0) for name in names}
                for kind in range(3)]
        return stepped, mean

    def over(error: float, limit: float) -> float:  # a leaf of zeros at rate 0 has a limit of 0
        return error / limit if limit > 0 else (0.0 if error == 0 else float("inf"))

    def worst(observed: dict, expected: list, limits: tuple, kinds=range(3)) -> list:
        ratios = []
        for kind in kinds:
            ratio = 0.0
            for name in names:
                for i in peers:
                    got = observed[i][kind][name].double()
                    if not bool(torch.isfinite(got).all()):
                        ratio = float("inf")
                        continue
                    if kind == 0:
                        ratio = max(ratio, over(float((got - expected[0][name]).norm()), limits[0][name]))
                    else:
                        ratio = max(ratio, float(((got - expected[kind][name]).abs() / limits[kind][name]).max()))
            ratios.append(ratio)
        return ratios

    grad = mean_gradient(peers)
    update_ms = []
    stepped, expected = reference(grad, update_ms)
    limits = collab_limits(torch, stepped, [pre[i] for i in peers], transition, layout, local_max, grad)
    held = dict(zip(("params", "mu", "nu"), worst(post, expected, limits)))
    held["update_ms"] = float(np.median(update_ms[1:] or update_ms))  # the first call warms the schedule up
    _, without = reference(mean_gradient([i for i in peers if i != fault_peer]))
    held["faults"] = {f"peer {fault_peer}'s batches left out": max(worst(post, without, limits))}
    pre_mean = {name: torch.stack([pre[i][0][name].double() for i in peers]).mean(0) for name in names}
    steps = [over(float((expected[0][name] - pre_mean[name]).norm()), limits[0][name]) for name in names]
    held["step_over_limit"] = (float(np.median(steps)), sum(step > 1 for step in steps), len(steps))
    if collab_rate(torch, transition) > 0:  # at a rate of 0 there is no step to alter
        for label, f in COLLAB_STEP_FAULTS.items():
            faulty = {i: ({name: pre_mean[name] + f * (post[i][0][name].double() - pre_mean[name]) for name in names},)
                      for i in peers}
            held["faults"][label] = worst(faulty, expected, limits, kinds=(0,))[0]
    torch.cuda.empty_cache()
    held.update(samples=sum(samples.values()), batches={i: len(readings[transition][i]["batches"]) for i in peers})
    return held


def collab_agreement(torch, epoch: int, peers: list, scratch: str, layout: list) -> float:
    """The peers' parameters after the transition into ``epoch`` against each other:
    the worst |a − b| over 2 x COLLAB_STATE_FACTOR x S (each is within one lossless
    state round of the mean), S the largest magnitude among the round's inputs: the
    largest |value| now plus the most one peer's step can differ from the others',
    ``collab_step_bound``; infinite when a value is not finite."""
    params = [collab_split(torch, np.load(os.path.join(scratch, f"peer{i}_e{epoch}.npy")), layout)[0] for i in peers]
    worst = 0.0
    for name, _, _ in layout:
        stacked = torch.stack([p[name] for p in params])
        if not bool(torch.isfinite(stacked).all()):
            return float("inf")
        step = collab_step_bound(torch, epoch - 1, float(stacked.flatten(1).norm(dim=1).max()))
        limit = 2 * COLLAB_STATE_FACTOR * (stacked.abs().amax(0) + 2 * step)
        worst = max(worst, float(((stacked.amax(0) - stacked.amin(0)) / limit).max()))
    return worst


def phase_collab(torch, wrappers: dict, telemetry: Telemetry) -> dict:
    """Collaborative ALBERT-base training (BASELINE config 3, examples/albert): this
    process is the bootstrap DHT peer; COLLAB_PEERS child peers train one model
    through the collaborative Optimizer on the card, epoch by epoch; a fifth joins by
    downloading the state and trains an epoch with them. Checks, in order: large-batch
    equivalence of transitions COLLAB_CHECKED (a planted fault must fail), agreement
    after every epoch, the joiner's state against its donor's bytes, and throughput:
    ALBERT-base tokens/s/chip over epoch 1 beside [train]'s solo step. The flash
    launches are the children's, reported over their pipes."""
    import multiprocessing
    import threading

    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.models import AlbertConfig, AlbertForMaskedLM

    phase_started = time.perf_counter()
    torch.cuda.empty_cache()  # the peers need the card's memory, not this process's cache
    context = multiprocessing.get_context("forkserver")  # CHILD_PRELOAD
    children, dhts, faults = [], [], []
    scratch = tempfile.TemporaryDirectory(prefix="collab_")
    timer = None

    def check(ok: bool, what: str) -> None:
        if not ok:
            faults.append(what)

    def kill_all() -> None:
        for child in children:
            child.kill()

    log(f"[collab] host {host_line()}; {COLLAB_PEERS} peers + 1 joiner, ALBERT-base (albert-base-v2 widths, 12 "
        f"applications of the shared layer), batch {TRAIN_BATCH} x seq {TRAIN_SEQ} a step, masked_loss_fraction "
        f"{TRAIN_MASKED_FRACTION}, lamb_with_warmup{COLLAB_LAMB} clipped at 1, target_batch_size {COLLAB_TARGET}, "
        f"matchmaking_time {COLLAB_MATCHMAKING_S} s, fp16 wire for gradients, fp32 for the state, averaged every epoch, "
        f"min_group_size {COLLAB_PEERS}, groups unbounded")
    readings, walls = {}, {}
    try:
        started = time.perf_counter()
        bootstrap = DHT(start=True)
        dhts.append(bootstrap)
        initial_peers = [str(maddr) for maddr in bootstrap.get_visible_maddrs()]
        children.extend(CollabChild(context, index, initial_peers, scratch.name) for index in range(COLLAB_PEERS))
        timer = threading.Timer(COLLAB_KILL_LIMIT_S, kill_all)  # a hung peer or call: every child dies
        timer.daemon = True
        timer.start()
        for child in children:
            _, child.peer_id, child.device = child.receive(COLLAB_STARTUP_LIMIT_S - (time.perf_counter() - started))
        by_peer = {child.peer_id: child for child in children}
        log(f"[collab] {COLLAB_PEERS} peer processes up in {time.perf_counter() - started:.1f} s")

        def train(epoch: int, members: list) -> None:
            begun = time.perf_counter()
            for child in members:
                child.conn.send(("train", epoch + 1))
            readings[epoch] = {child.index: child.receive(COLLAB_EPOCH_LIMIT_S)[1] for child in members}
            walls[epoch] = time.perf_counter() - begun
            for child in members:
                child.ask(("save", epoch + 1), timeout=60)
            values = list(readings[epoch].values())
            median = lambda key: float(np.median([r[key] for r in values]))
            samples = sum(size for r in values for _, size, _ in r["batches"])
            log(f"[collab] epoch {epoch} -> {epoch + 1}: wall {walls[epoch]:.3f} s, {samples} samples from "
                f"{len(values)} peers ({[len(r['batches']) for r in values]} batches); median over peers: compute "
                f"{median('compute'):.3f} s, accumulate on the host {median('accumulate'):.3f} s, waiting for the "
                f"swarm {median('waiting'):.3f} s, gradient all-reduce {median('grad_allreduce'):.3f} s, update "
                f"(host, span optimizer.update) {median('update'):.3f} s, state round (span state_averager.round, "
                f"the update's card work included) {median('state_round'):.3f} s (its all-reduce "
                f"{median('state_allreduce'):.3f} s); group sizes "
                f"{sorted({tuple(r['group_sizes']) for r in values})}; losses (first, last) of peer 0 "
                f"{values[0]['losses'][0]:.4f}, {values[0]['losses'][-1]:.4f}")
            for child in members:
                reading = readings[epoch][child.index]
                check(reading["epoch"] == epoch + 1, f"epoch {epoch}: {child.name} ended at epoch {reading['epoch']}")
                check(reading["failed"] == 0, f"epoch {epoch}: {child.name} fell back to local gradients")
                check(reading["state_ok"], f"epoch {epoch}: {child.name}'s state round failed")
                check(reading["counts"] == [epoch + 1] * 2, f"epoch {epoch}: {child.name}'s counts {reading['counts']}")
                check(all(math.isfinite(loss) for loss in reading["losses"]), f"epoch {epoch}: {child.name} loss")
                check(reading["group_sizes"][:1] == [len(members)],
                      f"epoch {epoch}: {child.name}'s gradient round had {reading['group_sizes']} peers")

        for epoch in range(COLLAB_EPOCHS):
            train(epoch, children)

        # the late joiner downloads the state, then trains an epoch with the swarm
        joiner = CollabChild(context, COLLAB_PEERS, initial_peers, scratch.name)
        children.append(joiner)
        joiner.receive(COLLAB_STARTUP_LIMIT_S)
        _, loaded = joiner.ask(("load",), timeout=120)
        donor = by_peer.get(loaded["donors"][-1]) if loaded["donors"] else None
        donor_state = donor.ask(("digest",))[1] if donor is not None else {}
        log(f"[collab] the joiner loaded {loaded['bytes']:,} B from peer {donor.index if donor else '?'} in "
            f"{loaded['seconds']:.3f} s at epoch {loaded['epoch']} (donor at {donor_state.get('epoch')}); every digest "
            f"verified: {loaded['verified']}; its parameters, mu and nu equal the donor's, byte for byte: "
            f"{loaded['digest'] == donor_state.get('digest')}; counts {loaded['counts']} (donor "
            f"{donor_state.get('counts')})")
        check(loaded["ok"] and loaded["verified"] and loaded["finite"] and loaded["epoch"] == COLLAB_EPOCHS
              and loaded["epoch"] == donor_state.get("epoch") and loaded["digest"] == donor_state.get("digest")
              and loaded["counts"] == donor_state.get("counts"), f"the joiner's download: {loaded}, donor {donor_state}")
        train(COLLAB_EPOCHS, children)
        for child in children:
            child.ask(("stop",), timeout=60)

        reading_of = {child.index: readings[COLLAB_EPOCHS][child.index] for child in children}
        for child in children:
            reading = reading_of[child.index]
            per_step = {name: count / reading["steps"] for name, count in reading["launches"].items()}
            log(f"[collab] {child.name}: {reading['steps']} steps, flash launches per step {json.dumps(per_step)}, "
                f"peak memory {reading['peak'] / 2**30:.2f} GiB")
            check(all(count == 12 * reading["steps"] for count in reading["launches"].values()),
                  f"{child.name}: launches {reading['launches']} in {reading['steps']} steps, expected 12 each a step")
        launches = {name: sum(r["launches"].get(name, 0) for r in reading_of.values()) for name in wrappers}

        timed = range(1, COLLAB_EPOCHS)  # the four peers' epochs after the first
        tokens = sum(size * TRAIN_SEQ for epoch in timed for r in readings[epoch].values() for _, size, _ in r["batches"])
        rate = tokens / sum(walls[epoch] for epoch in timed)
        telemetry.readings["collab"] = {"tokens_per_s": rate}
        log(f"[collab] ALBERT-base tokens/s/chip over epochs {list(timed)}: {rate:.0f} ({tokens:,} tokens of "
            f"{COLLAB_PEERS} peers in {sum(walls[epoch] for epoch in timed):.3f} s; one card); [train]'s solo step in this run: "
            f"{telemetry.readings.get('train', {}).get('tokens_per_s', float('nan')):.0f} tokens/s")

        # the checks that need the card's memory run after the peers are gone
        layout = collab_layout(AlbertForMaskedLM(AlbertConfig.base(max_position=TRAIN_SEQ), device="meta"))
        for transition in COLLAB_CHECKED:
            held = collab_hold(torch, transition, readings, scratch.name, layout)
            median_step, above, leaves = held["step_over_limit"]
            log(f"[collab] transition {transition}: {held['samples']} samples in {held['batches']} batches a peer, "
                f"recomputed on the card; worst error / limit: parameters {held['params']:.4f} (each leaf's error in "
                f"norm), mu {held['mu']:.4f}, nu {held['nu']:.4f} (every element) of every peer; a whole parameter "
                f"step spans {median_step:.2f} limits (median leaf; {above} of {leaves} leaves above 1); the update "
                f"alone on the card (the reference's step, CUDA events) {held['update_ms']:.3f} ms; planted faults, "
                f"each x the limit: " + "; ".join(f"{label} {ratio:.1f} ({'rejected' if ratio > 1 else 'NOT rejected'})"
                                                   for label, ratio in held["faults"].items()))
            check(max(held["params"], held["mu"], held["nu"]) <= 1.0,
                  f"transition {transition} is off large-batch training: {held}")
            check(all(ratio > 1.0 for ratio in held["faults"].values()),
                  f"transition {transition}: the check passed a planted fault: {held['faults']}")
            check(transition == 0 or len(held["faults"]) == 1 + len(COLLAB_STEP_FAULTS),
                  f"transition {transition}: the parameter step faults were not planted (no step)")
        for epoch in range(1, COLLAB_EPOCHS + 2):
            peers = sorted(readings[epoch - 1])
            worst = collab_agreement(torch, epoch, peers, scratch.name, layout)
            log(f"[collab] after epoch {epoch - 1}: {len(peers)} peers at epoch {epoch}, parameters agree within "
                f"{worst:.4f} of twice the state round's limit")
            check(worst <= 1.0, f"epoch {epoch}: the peers' parameters differ by {worst:.3f} x the limit")
    finally:
        if timer is not None:
            timer.cancel()
        for child in children:
            if child.process.is_alive():
                with contextlib.suppress(Exception):
                    child.ask(("stop",), timeout=20)
            child.kill()
        for dht in reversed(dhts):
            dht.shutdown()
        scratch.cleanup()
    elapsed = time.perf_counter() - phase_started
    log(f"[collab] phase wall {elapsed:.1f} s (limit {COLLAB_PHASE_LIMIT_S:.0f} s)")
    check(elapsed <= COLLAB_PHASE_LIMIT_S, f"[collab] took {elapsed:.1f} s > {COLLAB_PHASE_LIMIT_S:.0f} s")
    if faults:
        raise AssertionError("; ".join(faults))
    return launches


# ---------------------------------------------------------------- [ring]: ring attention on a mesh
# Four ranks with sp = 4 share the one card and talk over gloo (NCCL refuses two ranks on
# one device): the flash kernel runs on the card at every ring step, the rotated K/V
# blocks pass through pinned host buffers. What is measured is the arithmetic and the
# protocol of the ring, not a collective across cards. Shapes: Llama-2-7B attention at
# T 8192 (2,048 positions a shard, [serving]'s prefill shape), causal, and ALBERT-base's
# [32, 512, 12, 64] (128 a shard, one forward tile), not causal; bf16.
RING_SP = 4
RING_CASES = (((1, 8192, 32, 128), True), (ALBERT_ATTENTION, False))
RING_TIMED_RUNS = 3
RING_STARTUP_LIMIT_S = 90.0
RING_KILL_LIMIT_S = 420.0  # a timer kills every rank process past this
RING_HEAD_CHUNK = 4  # heads a time in the fp32 references (scores of [1, 4, 8192, 8192] are 1 GiB)
# The ring's output against plain fp32 attention, each element within atol + rtol·scale
# (scale = sum_j p_j·|v_j|, as [flash]): the flash kernel's 3u of each shard's own output,
# plus one bf16 rounding of each shard's output before the fp32 merge, weighted by
# w_i = exp(lse_i − lse) (summing to 1) and each within u·sum_{j in shard i} p_j|v_j|/w_i:
# u·scale more, so 4u; the norm ratio within 2u. Against the whole-sequence kernel on the
# card, both errors: 7u per element, 3u in norm, twice the cap.
RING_TOL = dict(atol=1e-5, rtol=4 * BF16_UNIT_ROUNDOFF, max_abs=2e-2, rel_l2=2 * BF16_UNIT_ROUNDOFF)
RING_FLASH_TOL = dict(atol=2e-5, rtol=7 * BF16_UNIT_ROUNDOFF, max_abs=4e-2, rel_l2=3 * BF16_UNIT_ROUNDOFF)
# the einsum ring's gradients (bf16 throughout, as the JAX package's) against plain fp32
# attention's, each gradient's error norm over its norm: [train]'s gradient limit
RING_GRAD_REL_L2 = 8 * BF16_UNIT_ROUNDOFF
RING_FAULTS = ("a ring step skipped", "the future-shard mask dropped")


def ring_inputs(torch, shape, case: int):
    """q, k, v (bf16) and the cotangent w (fp32) of a ``[ring]`` case, made on the card."""
    generator = torch.Generator(device="cuda").manual_seed(SEED + 700 + case)
    q, k, v = (torch.randn(shape, generator=generator, device="cuda").to(torch.bfloat16) for _ in range(3))
    return q, k, v, torch.randn(shape, generator=generator, device="cuda")


def faulty_ring_forward(torch, mesh, q, k, v, causal: bool, fault: str):
    """The kernel ring's forward with a planted fault the check must reject: the block of
    ring step 1 left out of the merge, or a future shard's lse left unmasked."""
    from hivemind_tpu_torch.ops.flash_attention import flash_attention_lse
    from hivemind_tpu_torch.parallel.ring_attention import _NEG_INF, _merge

    size, here = mesh.shape["sp"], mesh.coordinate["sp"]
    out, lse = flash_attention_lse(q, k, v, causal=causal)
    out = out.float()
    k_cur, v_cur = k, v
    for step in range(1, size):
        k_cur, v_cur = mesh.ring_shift((k_cur, v_cur), "sp", 1)
        out_i, lse_i = flash_attention_lse(q, k_cur, v_cur)
        if fault == RING_FAULTS[0] and step == 1:
            continue
        if causal and fault != RING_FAULTS[1] and (here - step) % size > here:
            lse_i = torch.full_like(lse_i, _NEG_INF)
        out, lse = _merge(out, lse, out_i, lse_i)
    return out.to(q.dtype)


def ring_rank_main(conn, rank: int, port: int, scratch: str, backend: str) -> None:
    """One rank of ``[ring]``: a (1, 1, RING_SP) mesh over ``backend`` (gloo: the ranks
    share the card; nccl: a card each, where the machine has RING_SP). For each case it
    runs ``ring_flash_attention`` forward and backward (the path: its launches are
    counted), the forward RING_TIMED_RUNS more times for its wall, and the planted
    faults; its shards go to ``scratch`` for the parent."""
    import traceback

    try:
        import torch

        from hivemind_tpu_torch.ops import flash_attention
        from hivemind_tpu_torch.parallel import make_mesh
        from hivemind_tpu_torch.parallel.mesh import NamedSharding, P
        from hivemind_tpu_torch.parallel.ring_attention import ring_flash_attention, ring_flash_forward

        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = make_mesh(1, 1, RING_SP, backend=backend, device="cuda", init_method=f"tcp://localhost:{port}",
                         rank=rank, world_size=RING_SP)
        shard = NamedSharding(mesh, P(None, "sp")).shard
        conn.send(("ready", str(mesh.device), mesh.stages_through_host))
        readings = []
        for case, (shape, causal) in enumerate(RING_CASES):
            q, k, v, w = (shard(t).contiguous() for t in ring_inputs(torch, shape, case))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            flash_attention.flash_attention_lse.launches = 0  # the path starts here
            inputs = [t.clone().requires_grad_() for t in (q, k, v)]
            out = ring_flash_attention(*inputs, mesh, "sp", causal)
            (out.float() * w).sum().backward()
            torch.cuda.synchronize()
            launches = flash_attention.flash_attention_lse.launches
            walls = []
            with torch.no_grad():
                for _ in range(RING_TIMED_RUNS):
                    torch.cuda.synchronize()
                    started = time.perf_counter()
                    ring_flash_forward(q, k, v, mesh, "sp", causal)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - started)
                faults = {fault: faulty_ring_forward(torch, mesh, q, k, v, causal, fault).cpu()
                          for fault in RING_FAULTS if causal or fault == RING_FAULTS[0]}
            torch.save(dict(out=out.detach().cpu(), grads=[t.grad.cpu() for t in inputs], faults=faults),
                       os.path.join(scratch, f"ring{backend}{case}_{rank}.pt"))
            readings.append(dict(launches=launches, walls=walls, peak=torch.cuda.max_memory_allocated()))
            del q, k, v, w, inputs, out, faults
            torch.cuda.empty_cache()
        conn.send(("done", readings))
        conn.recv()  # "stop": leave the process group together
        torch.distributed.destroy_process_group()
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise


def ring_nccl_main(conn, port: int) -> None:
    """The nccl branch of make_mesh on the card: a one-rank mesh, a sum and a broadcast
    of card tensors over it, and ring_flash_attention at sp = 1 (the local flash call)."""
    import traceback

    try:
        import torch

        from hivemind_tpu_torch.ops import flash_attention
        from hivemind_tpu_torch.parallel import make_mesh
        from hivemind_tpu_torch.parallel.ring_attention import ring_flash_attention

        mesh = make_mesh(1, 1, 1, backend="nccl", device="cuda", init_method=f"tcp://localhost:{port}",
                         rank=0, world_size=1)
        x = torch.arange(8, dtype=torch.float32, device=mesh.device)
        q, k, v, _ = ring_inputs(torch, ALBERT_ATTENTION, 1)
        torch.distributed.all_reduce(x)  # a collective of the nccl group on the card
        before = flash_attention.flash_attention_lse.launches
        out = ring_flash_attention(q, k, v, mesh, "sp", False)
        launches = flash_attention.flash_attention_lse.launches - before
        expected, _ = flash_attention.flash_attention_lse(q, k, v)
        torch.cuda.synchronize()
        conn.send(("done", dict(backend=torch.distributed.get_backend(), device=str(mesh.device),
                                sum_ok=bool(torch.equal(x, torch.arange(8, dtype=torch.float32, device=mesh.device))),
                                equal=bool(torch.equal(out, expected)),
                                launches=launches)))
        torch.distributed.destroy_process_group()
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise


class MeshChild(SwarmChild):
    """The parent's handle on one rank process of a mesh phase."""

    def __init__(self, context, name: str, target, *args):
        self.name, self.index = name, None
        self.conn, child_conn = context.Pipe()
        self.process = context.Process(target=target, args=(child_conn, *args), daemon=True)
        self.process.start()
        child_conn.close()
        self.peer_id = self.device = self.last_report = None


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def ring_references(torch, q, k, v, w, causal: bool):
    """Plain whole-sequence attention in fp32, a few heads at a time: (out, scale, dq, dk,
    dv) for sum(out·w), scale = sum_j p_j·|v_j|."""
    from hivemind_tpu_torch.ops.flash_attention import flash_attention_plain
    from hivemind_tpu_torch.parallel.ring_attention import plain_attention

    outs, scales, grads = [], [], [[], [], []]
    for h in range(0, q.shape[2], RING_HEAD_CHUNK):
        part = [t[:, :, h:h + RING_HEAD_CHUNK].float() for t in (q, k, v)]
        with torch.no_grad():
            scales.append(flash_attention_plain(*part[:2], part[2].abs(), causal)[0])
        leaves = [t.clone().requires_grad_() for t in part]
        out = plain_attention(*leaves, causal=causal)
        (out * w[:, :, h:h + RING_HEAD_CHUNK]).sum().backward()
        outs.append(out.detach())
        for index, leaf in enumerate(leaves):
            grads[index].append(leaf.grad)
        del out, leaves
    return (torch.cat(outs, 2), torch.cat(scales, 2), *(torch.cat(g, 2) for g in grads))


def ring_check(torch, context, backend: str, scratch: str, check) -> int:
    """RING_SP child ranks run the ring over ``backend``; each case's assembled output is
    held to plain fp32 attention and to the whole-sequence flash kernel, its gradients (the
    einsum ring in bf16) to plain fp32 attention's, and the planted faults must fail.
    Returns the launches of the ranks' counted calls."""
    import threading

    from hivemind_tpu_torch.ops.flash_attention import flash_attention_lse

    children, timer, launches = [], None, 0
    try:
        port = free_port()
        children.extend(MeshChild(context, f"ring rank {rank} ({backend})", ring_rank_main, rank, port, scratch, backend)
                        for rank in range(RING_SP))
        timer = threading.Timer(RING_KILL_LIMIT_S, lambda: [child.kill() for child in children])
        timer.daemon = True
        timer.start()
        started = time.perf_counter()
        ready = [child.receive(RING_STARTUP_LIMIT_S) for child in children]
        staged = all(r[2] for r in ready)
        log(f"[ring] {backend}: {RING_SP} ranks up in {time.perf_counter() - started:.1f} s on "
            f"{sorted({r[1] for r in ready})}, blocks staged through pinned host buffers: {staged}")
        check(staged == (backend == "gloo"), f"[ring] {backend}: host staging {staged}")
        readings = [child.receive(RING_KILL_LIMIT_S)[1] for child in children]
        for child in children:
            child.conn.send(("stop",))
        for case, (shape, causal) in enumerate(RING_CASES):
            per_rank = [reading[case] for reading in readings]
            shards = [torch.load(os.path.join(scratch, f"ring{backend}{case}_{rank}.pt")) for rank in range(RING_SP)]
            out = torch.cat([s["out"] for s in shards], 1).to("cuda")
            q, k, v, w = ring_inputs(torch, shape, case)
            ref, scale, *ref_grads = ring_references(torch, q, k, v, w, causal)
            whole, _ = flash_attention_lse(q, k, v, causal)
            kernel_ms = time_ms(torch, lambda: flash_attention_lse(q, k, v, causal))
            vs_plain = error_reading(out, ref, scale, RING_TOL, MANTISSA_BITS["bfloat16"])
            vs_kernel = error_reading(out, whole, scale, RING_FLASH_TOL, MANTISSA_BITS["bfloat16"])
            grad_errors = []
            for index, ref_grad in enumerate(ref_grads):
                got = torch.cat([s["grads"][index] for s in shards], 1).to("cuda").float()
                grad_errors.append(float((got - ref_grad).norm() / ref_grad.norm()))
            fault_readings = {}
            for fault in shards[0]["faults"]:
                faulty = torch.cat([s["faults"][fault] for s in shards], 1).to("cuda")
                fault_readings[fault] = error_reading(faulty, ref, scale, RING_TOL, MANTISSA_BITS["bfloat16"])
            wall = float(np.median([max(r["walls"][i] for r in per_rank) for i in range(RING_TIMED_RUNS)]))
            case_launches = [r["launches"] for r in per_rank]
            launches += sum(case_launches)
            label = f"[ring] {backend}: {list(shape)} bf16 {'causal' if causal else 'full'}, sp={RING_SP}"
            route = "blocks cross gloo through the host" if backend == "gloo" else "nccl between the cards"
            log(f"{label}: vs plain fp32 {format_reading(vs_plain)}; vs the whole-sequence kernel "
                f"{format_reading(vs_kernel)}; gradients (einsum ring) error norm / norm dq {grad_errors[0]:.3e} dk "
                f"{grad_errors[1]:.3e} dv {grad_errors[2]:.3e} (limit {RING_GRAD_REL_L2:.3e}); flash_attention_lse "
                f"launches per rank {case_launches}; ring forward wall {wall * 1e3:.3f} ms (host clock, the slowest rank, "
                f"median of {RING_TIMED_RUNS}; {route}) vs the whole-sequence kernel alone {kernel_ms:.4f} ms (CUDA "
                f"events); peak memory a rank {max(r['peak'] for r in per_rank) / 2**30:.2f} GiB")
            for fault, reading in fault_readings.items():
                log(f"{label}: planted fault '{fault}': {format_reading(reading)} -> "
                    f"{'rejected' if not reading['ok'] else 'NOT rejected'}")
                check(not reading["ok"], f"{label}: the check passed '{fault}'")
            check(vs_plain["ok"] and vs_kernel["ok"], f"{label}: the ring's output is off")
            check(max(grad_errors) <= RING_GRAD_REL_L2, f"{label}: gradients off by {grad_errors}")
            check(all(n == RING_SP for n in case_launches), f"{label}: launches {case_launches}, expected {RING_SP}")
            check(len(fault_readings) == (2 if causal else 1), f"{label}: faults planted {list(fault_readings)}")
            del out, q, k, v, w, ref, scale, ref_grads, whole
            torch.cuda.empty_cache()
        for child in children:
            child.process.join(30)
    finally:
        if timer is not None:
            timer.cancel()
        for child in children:
            child.kill()
    return launches


def phase_ring(torch) -> dict:
    """Ring attention over a mesh's sequence axis (``ring_flash_attention``): RING_SP ranks
    sharing the card over gloo, and, on a machine with RING_SP cards, RING_SP ranks with a
    card each over nccl (``ring_check``); then a one-rank nccl mesh. Returns the path's
    launches (summed over the ranks)."""
    import multiprocessing

    torch.cuda.empty_cache()
    context = multiprocessing.get_context("forkserver")  # CHILD_PRELOAD
    scratch = tempfile.TemporaryDirectory(prefix="ring_")
    faults, launches = [], 0

    def check(ok: bool, what: str) -> None:
        if not ok:
            faults.append(what)

    try:
        backends = ("gloo", "nccl") if torch.cuda.device_count() >= RING_SP else ("gloo",)
        if len(backends) == 1:
            log(f"[ring] {torch.cuda.device_count()} card: the ranks share it over gloo (nccl needs a card per rank)")
        for backend in backends:
            launches += ring_check(torch, context, backend, scratch.name, check)
        nccl = MeshChild(context, "the nccl rank", ring_nccl_main, free_port())
        try:
            _, reading = nccl.receive(RING_STARTUP_LIMIT_S)
            nccl.process.join(30)
        finally:
            nccl.kill()
        log(f"[ring] a one-rank nccl mesh on {reading['device']} ({reading['backend']}): an all_reduce of a card "
            f"tensor {'ok' if reading['sum_ok'] else 'WRONG'}; ring_flash_attention at sp=1 equals the flash "
            f"kernel: {reading['equal']}, {reading['launches']} launch")
        check(reading["backend"] == "nccl" and reading["sum_ok"] and reading["equal"] and reading["launches"] == 1,
              f"[ring] the nccl mesh: {reading}")
    finally:
        scratch.cleanup()
    if faults:
        raise AssertionError("; ".join(faults))
    return {"flash_attention_forward": launches, "flash_attention_backward_dq": 0, "flash_attention_backward_dkv": 0,
            "blockwise_int8_quantize": 0, "blockwise_int8_dequantize": 0}


# ---------------------------------------------------------------- [slice]: a mesh as one swarm peer
# One SliceOptimizer slice of SLICE_SHAPE ranks (dp 2 x sp 2) on the one card over gloo, and
# one port Optimizer peer, train ALBERT-base with [collab]'s recipe (LAMB with warmup,
# target SLICE_TARGET samples an epoch, the fp16 gradient wire and the fp32 state wire) in one
# swarm. The slice's step is a global microbatch of TRAIN_BATCH x TRAIN_SEQ, each rank
# taking its [dp, sp] block (batch 16 x seq 256), ring attention over sp.
SLICE_SHAPE = (2, 1, 2)
SLICE_RANKS = SLICE_SHAPE[0] * SLICE_SHAPE[1] * SLICE_SHAPE[2]
SLICE_RUN_ID = "albert_slice"
SLICE_EPOCHS = 2  # transitions 0 and 1, both held to large-batch training
SLICE_TARGET = COLLAB_TARGET // 2  # halved for the run's time limit: each epoch and its recomputed sums half as long
SLICE_PEER = 1  # the port Optimizer peer's index (the slice is peer 0 of the reference)
SLICE_INIT_SEED = SEED + 11
SLICE_STARTUP_LIMIT_S = 150.0
SLICE_EPOCH_LIMIT_S = 150.0
SLICE_KILL_LIMIT_S = 600.0  # a timer kills every process past this


def slice_rank_main(conn, rank: int, port: int, initial_peers: list, scratch: str) -> None:
    """One rank of ``[slice]``: a SLICE_SHAPE gloo mesh on the card, ALBERT-base on it and
    a SliceOptimizer (rank 0 builds the DHT peer). Commands: ``check`` (the mesh's loss
    and summed gradients of batch 0 from the initial weights, saved by rank 0), ``train``
    (global batches until the given epoch), ``save`` (rank 0 writes the state view;
    every rank returns its view's digest), ``regrad`` (the sum of the mesh gradients of
    the given batches from the view saved at an epoch, outside the optimizer, saved by
    rank 0) and ``stop``."""
    import hashlib
    import traceback

    try:
        import torch

        from hivemind_tpu_torch.compression import NoCompression
        from hivemind_tpu_torch.dht import DHT
        from hivemind_tpu_torch.models import AlbertConfig, AlbertForMaskedLM, make_mlm_loss_fn, make_synthetic_mlm_batch
        from hivemind_tpu_torch.models.albert import reduce_gradients
        from hivemind_tpu_torch.moe.server.layers import lamb_with_warmup
        from hivemind_tpu_torch.ops import flash_attention
        from hivemind_tpu_torch.optim import SliceOptimizer
        from hivemind_tpu_torch.parallel import MeshTensorBridge, make_mesh, params_shardings, shard_batch
        from hivemind_tpu_torch.parallel import shard_state_dict

        torch.backends.cuda.matmul.allow_tf32 = False
        kernels = {"flash_attention_forward": flash_attention.flash_attention_lse,
                   "flash_attention_backward_dq": flash_attention.flash_attention_backward_dq,
                   "flash_attention_backward_dkv": flash_attention.flash_attention_backward_dkv}
        mesh = make_mesh(*SLICE_SHAPE, backend="gloo", device="cuda", init_method=f"tcp://localhost:{port}",
                         rank=rank, world_size=SLICE_RANKS)
        config = AlbertConfig.base(max_position=TRAIN_SEQ, mesh=mesh)
        model = AlbertForMaskedLM(config, device="cuda")
        model.reset_parameters(torch.Generator(device="cuda").manual_seed(SLICE_INIT_SEED))
        loss_fn = make_mlm_loss_fn(model, TRAIN_MASKED_FRACTION)
        bridge = MeshTensorBridge(mesh)
        layout = collab_layout(AlbertForMaskedLM(AlbertConfig.base(max_position=TRAIN_SEQ), device="meta"))
        opt = SliceOptimizer(mesh=mesh, params=model.named_parameters(), optimizer=lamb_with_warmup(*COLLAB_LAMB),
                             dht_factory=lambda: DHT(initial_peers=initial_peers, start=True), run_id=SLICE_RUN_ID,
                             target_batch_size=SLICE_TARGET, batch_size_per_step=TRAIN_BATCH,
                             matchmaking_time=COLLAB_MATCHMAKING_S, average_state_every=1, min_group_size=2,
                             state_averaging_compression=NoCompression())

        def batch_of(k: int):
            generator = torch.Generator(device="cuda").manual_seed(collab_batch_seed(0, k))
            return shard_batch(make_synthetic_mlm_batch(generator, config, TRAIN_BATCH, TRAIN_SEQ), mesh)

        def summed_gradients(names_batches):
            """Sum over ``(k, size)`` of size x the mesh gradient of batch k, over dp and sp."""
            sums = {name: torch.zeros_like(p) for name, p in model.named_parameters()}
            for k, size in names_batches:
                model.zero_grad(set_to_none=True)
                loss = loss_fn(batch_of(k))
                loss.backward()
                for name, p in model.named_parameters():
                    sums[name] += p.grad * size
            model.zero_grad(set_to_none=True)
            flat = torch.cat([s.reshape(-1) for s in sums.values()])
            mesh.all_reduce(flat, ("dp", "sp"))
            return flat, loss

        conn.send(("ready", str(mesh.device), opt.dht.peer_id.to_base58() if opt.dht is not None else None))
        k = steps = 0
        while True:
            command, *args = conn.recv()
            if command == "check":
                model.zero_grad(set_to_none=True)
                loss = loss_fn(batch_of(0))
                loss.backward()
                reduce_gradients(model, mesh)
                named = dict(model.named_parameters())
                grads = bridge.gather_to_host([p.grad for p in named.values()], list(params_shardings(named, mesh).values()))
                if grads is not None:
                    transposed = dict(zip(named, (s.transposed for s in params_shardings(named, mesh).values())))
                    torch.save({name: torch.from_numpy(g.T.copy() if transposed[name] else g)
                                for name, g in zip(named, grads)}, os.path.join(scratch, "slice_check.pt"))
                model.zero_grad(set_to_none=True)
                conn.send(("checked", loss.item()))
            elif command == "train":
                (until,) = args
                if steps == 0:  # the path starts here: every count at 0
                    for wrapper in kernels.values():
                        wrapper.launches = 0
                    torch.cuda.reset_peak_memory_stats()
                batches, compute, accumulate, transition, peers, samples = [], 0.0, 0.0, 0.0, [], []
                started = time.perf_counter()
                while opt.local_epoch < until:
                    k += 1
                    epoch = opt.local_epoch
                    begun = time.perf_counter()
                    loss = loss_fn(batch_of(k))
                    loss.backward()
                    torch.cuda.synchronize()
                    computed = time.perf_counter()
                    pending = opt._samples + TRAIN_BATCH
                    opt.step(batch_size=TRAIN_BATCH)
                    opt.zero_grad()
                    stepped = time.perf_counter()
                    compute += computed - begun
                    if opt.local_epoch != epoch:
                        transition += stepped - computed
                        samples.append(pending)
                        if opt.tracker is not None:
                            peers.append(opt.tracker.global_progress.num_peers)
                    else:
                        accumulate += stepped - computed
                    batches.append((k, TRAIN_BATCH, epoch))
                    steps += 1
                conn.send(("trained", dict(
                    epoch=opt.local_epoch, batches=batches, wall=time.perf_counter() - started, compute=compute,
                    accumulate=accumulate, transition=transition, peers=peers, samples=samples,
                    failed=opt.consecutive_failed_averaging_rounds, steps=steps,
                    launches={name: wrapper.launches for name, wrapper in kernels.items()},
                    peak=torch.cuda.max_memory_allocated())))
            elif command == "save":
                (epoch,) = args
                view = np.concatenate([t.reshape(-1) for t in opt.state_dict()["tensors"]])
                if rank == 0:
                    np.save(os.path.join(scratch, f"peer0_e{epoch}.npy"), view)
                conn.send(("saved", hashlib.blake2b(view.tobytes(), digest_size=16).hexdigest()))
            elif command == "regrad":
                transition, epoch_batches = args
                if transition == 0:
                    model.reset_parameters(torch.Generator(device="cuda").manual_seed(SLICE_INIT_SEED))
                else:
                    params = collab_split(torch, np.load(os.path.join(scratch, f"peer0_e{transition}.npy")), layout)[0]
                    model.load_state_dict(shard_state_dict(params, mesh))
                flat, _ = summed_gradients([(kk, size) for kk, size, _ in epoch_batches])
                if rank == 0:
                    sums, offset = {}, 0
                    for name, p in model.named_parameters():
                        sums[name] = flat[offset:offset + p.numel()].view_as(p).cpu()
                        offset += p.numel()
                    torch.save(sums, os.path.join(scratch, f"slice_sums_{transition}.pt"))
                conn.send(("regraded",))
            elif command == "stop":
                opt.shutdown()
                conn.send(("stopped",))
                conn.recv()  # leave the process group together
                torch.distributed.destroy_process_group()
                return
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise


def phase_slice(torch, wrappers: dict, telemetry: Telemetry) -> dict:
    """A mesh as one swarm peer (the slice tier): this process is the bootstrap DHT peer;
    a SliceOptimizer slice of SLICE_RANKS child ranks and one child port Optimizer
    peer train ALBERT-base through one swarm with [collab]'s recipe. Checks, in order:
    the mesh's loss and gradients of one batch against a single-rank step of the same
    weights and batch ([train]'s limits); after SLICE_EPOCHS transitions, [collab]'s
    large-batch equivalence of both peers (the slice's gradient sums recomputed through
    the mesh outside the optimizer, a planted fault must fail), the peers' agreement,
    the ranks identical bit for bit, and the slice counted as one peer with its global
    microbatch as its samples. Returns the path's launches (the ranks' and the peer's)."""
    import multiprocessing
    import threading

    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.models import AlbertConfig, AlbertForMaskedLM, make_mlm_loss_fn, make_synthetic_mlm_batch

    phase_started = time.perf_counter()
    torch.cuda.empty_cache()
    context = multiprocessing.get_context("forkserver")  # CHILD_PRELOAD
    scratch = tempfile.TemporaryDirectory(prefix="slice_")
    ranks, peer, dhts, faults, timer = [], None, [], [], None

    def check(ok: bool, what: str) -> None:
        if not ok:
            faults.append(what)

    def everyone():
        return ranks + ([peer] if peer is not None else [])

    log(f"[slice] host {host_line()}; a SliceOptimizer slice of {SLICE_RANKS} ranks (dp {SLICE_SHAPE[0]} x sp "
        f"{SLICE_SHAPE[2]}, gloo, all on the one card: collectives through the host) + 1 port Optimizer peer; "
        f"[collab]'s recipe: ALBERT-base, global microbatch {TRAIN_BATCH} x {TRAIN_SEQ}, lamb_with_warmup{COLLAB_LAMB}, "
        f"target {SLICE_TARGET} (halved for the run's time limit), fp16 gradient wire, fp32 state wire")
    readings, extras = {}, {}  # by epoch: each peer's reading; the ranks' readings, wall and tokens
    try:
        bootstrap = DHT(start=True)
        dhts.append(bootstrap)
        initial_peers = [str(maddr) for maddr in bootstrap.get_visible_maddrs()]
        port = free_port()
        started = time.perf_counter()
        ranks.extend(MeshChild(context, f"slice rank {rank}", slice_rank_main, rank, port, initial_peers, scratch.name)
                     for rank in range(SLICE_RANKS))
        peer = CollabChild(context, SLICE_PEER, initial_peers, scratch.name,
                           dict(run_id=SLICE_RUN_ID, min_group_size=2, init_seed=SLICE_INIT_SEED, target=SLICE_TARGET))
        timer = threading.Timer(SLICE_KILL_LIMIT_S, lambda: [child.kill() for child in everyone()])
        timer.daemon = True
        timer.start()
        for child in everyone():
            child.receive(SLICE_STARTUP_LIMIT_S - (time.perf_counter() - started))
        log(f"[slice] {SLICE_RANKS} ranks and the peer up in {time.perf_counter() - started:.1f} s")

        # the mesh step against a single-rank step of the same weights and batch
        for child in ranks:
            child.conn.send(("check",))
        mesh_losses = [child.receive(120)[1] for child in ranks]
        config = AlbertConfig.base(max_position=TRAIN_SEQ)
        model = AlbertForMaskedLM(config, device="cuda")
        model.reset_parameters(torch.Generator(device="cuda").manual_seed(SLICE_INIT_SEED))
        generator = torch.Generator(device="cuda").manual_seed(collab_batch_seed(0, 0))
        loss, grads = loss_and_grads(model, make_mlm_loss_fn(model, TRAIN_MASKED_FRACTION),
                                     make_synthetic_mlm_batch(generator, config, TRAIN_BATCH, TRAIN_SEQ))
        mesh_grads = torch.load(os.path.join(scratch.name, "slice_check.pt"))
        del model
        gap = max(abs(m - loss) for m in mesh_losses) / abs(loss)
        log(f"[slice] one mesh step vs a single-rank step of the same weights and batch: loss {mesh_losses[0]:.6f} vs "
            f"{loss:.6f} (gap {gap:.3e}, limit {TRAIN_LOSS_RTOL}; the 4 ranks' losses {len(set(mesh_losses))} distinct)")
        check(gap <= TRAIN_LOSS_RTOL, f"[slice] the mesh loss is off by {gap:.3e}")
        try:
            compare_grads(torch, mesh_grads, grads, TRAIN_GRAD_REL_L2, "mesh vs single rank", phase="slice")
        except AssertionError as e:
            check(False, f"[slice] {e}")

        def train(epoch: int) -> None:
            begun = time.perf_counter()
            for child in everyone():
                child.conn.send(("train", epoch + 1))
            readings[epoch] = {0: ranks[0].receive(SLICE_EPOCH_LIMIT_S)[1]}
            others = [child.receive(SLICE_EPOCH_LIMIT_S)[1] for child in ranks[1:]]
            readings[epoch][SLICE_PEER] = peer.receive(SLICE_EPOCH_LIMIT_S)[1]
            wall = time.perf_counter() - begun
            digests = [child.ask(("save", epoch + 1), timeout=60)[1] for child in ranks]
            peer.ask(("save", epoch + 1), timeout=60)
            slice_reading, peer_reading = readings[epoch][0], readings[epoch][SLICE_PEER]
            tokens = sum(size * TRAIN_SEQ for r in readings[epoch].values() for _, size, _ in r["batches"])
            extras[epoch] = dict(ranks=[slice_reading, *others], wall=wall, tokens=tokens)
            log(f"[slice] epoch {epoch} -> {epoch + 1}: wall {wall:.3f} s, {tokens // TRAIN_SEQ} samples (the slice "
                f"{len(slice_reading['batches'])} global microbatches, the peer {len(peer_reading['batches'])} batches); "
                f"the slice: compute {slice_reading['compute']:.3f} s, accumulate {slice_reading['accumulate']:.3f} s, "
                f"transition {slice_reading['transition']:.3f} s, samples at the transition {slice_reading['samples']}, "
                f"peers seen {slice_reading['peers']}; the peer: compute {peer_reading['compute']:.3f} s, waiting "
                f"{peer_reading['waiting']:.3f} s, gradient all-reduce {peer_reading['grad_allreduce']:.3f} s, state "
                f"round {peer_reading['state_round']:.3f} s, group sizes {peer_reading['group_sizes']}; "
                f"{tokens / wall:.0f} tokens/s/chip")
            check(len(set(digests)) == 1, f"epoch {epoch}: the slice's ranks differ: {digests}")
            check(all(r["epoch"] == epoch + 1 for r in [slice_reading, *others, peer_reading]),
                  f"epoch {epoch}: epochs {[r['epoch'] for r in [slice_reading, *others, peer_reading]]}")
            check(all(r["batches"] == slice_reading["batches"] for r in others), f"epoch {epoch}: ranks stepped apart")
            check(slice_reading["peers"] == [2], f"epoch {epoch}: the slice saw {slice_reading['peers']} peers")
            check(peer_reading["group_sizes"][:1] == [2], f"epoch {epoch}: the gradient round had "
                                                          f"{peer_reading['group_sizes']} peers")
            check(slice_reading["samples"] == [TRAIN_BATCH * len(slice_reading["batches"])],
                  f"epoch {epoch}: the slice counted {slice_reading['samples']} samples for "
                  f"{len(slice_reading['batches'])} global microbatches")
            check(slice_reading["failed"] == 0 and peer_reading["failed"] == 0,
                  f"epoch {epoch}: a peer fell back to local gradients")
            log(f"[slice] epoch {epoch}: the {SLICE_RANKS} ranks' state views identical (blake2b {digests[0]}); peak "
                f"memory a rank {[round(r['peak'] / 2**30, 2) for r in [slice_reading, *others]]} GiB, the peer "
                f"{peer_reading['peak'] / 2**30:.2f} GiB")

        for epoch in range(SLICE_EPOCHS):
            train(epoch)
        last = readings[SLICE_EPOCHS - 1]
        rank_launches = [r["launches"] for r in extras[SLICE_EPOCHS - 1]["ranks"]]
        peer_launches = last[SLICE_PEER]["launches"]
        log(f"[slice] flash launches of each rank {json.dumps(rank_launches)} in {last[0]['steps']} steps (ring "
            f"attention: {SLICE_SHAPE[2]} forward launches an application, the backward through the einsum ring); the "
            f"peer {json.dumps(peer_launches)} in {last[SLICE_PEER]['steps']} steps")
        check(all(r["flash_attention_forward"] == 12 * SLICE_SHAPE[2] * last[0]["steps"] for r in rank_launches),
              f"[slice] the ranks launched {rank_launches} in {last[0]['steps']} steps")
        tokens = sum(extras[e]["tokens"] for e in range(1, SLICE_EPOCHS))
        walls = sum(extras[e]["wall"] for e in range(1, SLICE_EPOCHS))
        log(f"[slice] ALBERT-base tokens/s/chip over epoch 1 (the slice and the peer): {tokens / walls:.0f}; "
            f"[collab] in this run: {telemetry.readings.get('collab', {}).get('tokens_per_s', float('nan')):.0f}; "
            f"[train]'s solo step: {telemetry.readings.get('train', {}).get('tokens_per_s', float('nan')):.0f}")

        # large-batch equivalence: the slice's gradient sums recomputed through the mesh
        layout = collab_layout(AlbertForMaskedLM(AlbertConfig.base(max_position=TRAIN_SEQ), device="meta"))
        for transition in range(SLICE_EPOCHS):
            batches = readings[transition][0]["batches"]
            for child in ranks:
                child.conn.send(("regrad", transition, batches))
            for child in ranks:
                child.receive(300)
            sums = {name: t.to("cuda") for name, t in torch.load(os.path.join(scratch.name, f"slice_sums_{transition}.pt")).items()}
            held = collab_hold(torch, transition, readings, scratch.name, layout, init_seed=SLICE_INIT_SEED,
                               precomputed={0: (sums, sum(size for _, size, _ in batches))}, fault_peer=0)
            median_step, above, leaves = held["step_over_limit"]
            log(f"[slice] transition {transition}: {held['samples']} samples, worst error / limit: parameters "
                f"{held['params']:.4f}, mu {held['mu']:.4f}, nu {held['nu']:.4f} (both peers); a whole step spans "
                f"{median_step:.2f} limits (median leaf); planted faults, each x the limit: "
                + "; ".join(f"{label} {ratio:.1f} ({'rejected' if ratio > 1 else 'NOT rejected'})"
                            for label, ratio in held["faults"].items()))
            check(max(held["params"], held["mu"], held["nu"]) <= 1.0, f"[slice] transition {transition}: {held}")
            check(all(ratio > 1.0 for ratio in held["faults"].values()),
                  f"[slice] transition {transition}: the check passed a planted fault: {held['faults']}")
            check(transition == 0 or len(held["faults"]) == 1 + len(COLLAB_STEP_FAULTS),
                  f"[slice] transition {transition}: the step faults were not planted")
        for epoch in range(1, SLICE_EPOCHS + 1):
            worst = collab_agreement(torch, epoch, [0, SLICE_PEER], scratch.name, layout)
            log(f"[slice] after epoch {epoch - 1}: the slice and the peer agree within {worst:.4f} of twice the state "
                f"round's limit")
            check(worst <= 1.0, f"[slice] epoch {epoch}: the slice and the peer differ by {worst:.3f} x the limit")
        launches = {name: sum(r.get(name, 0) for r in rank_launches) + peer_launches.get(name, 0) for name in wrappers}
    finally:
        if timer is not None:
            timer.cancel()
        for child in everyone():
            if child.process.is_alive():
                with contextlib.suppress(Exception):
                    child.conn.send(("stop",))
        for child in everyone():
            with contextlib.suppress(Exception):
                child.receive(30)
        for child in ranks:
            with contextlib.suppress(Exception):
                child.conn.send(("exit",))
        for child in everyone():
            child.process.join(10)
            child.kill()
        for dht in reversed(dhts):
            dht.shutdown()
        scratch.cleanup()
    log(f"[slice] phase wall {time.perf_counter() - phase_started:.1f} s")
    if faults:
        raise AssertionError("; ".join(faults))
    return launches


# ------------------------------------------------------------------ [mesh_serving] and [cli]: the serving mesh

# [mesh_serving]: each Llama-2-7B-width block tensor-parallel over MESH_TP shards (8 heads and
# an ffn width of 2752 a shard): one shard a card where the host has MESH_TP cards, else all
# of them on card 0, one after another; fp32 and int8, against the single-device blocks
MESH_TP = 4
MESH_PREFILL = 2048
MESH_PREFILL_RUNS = 3
MESH_MAX_LEN = 256
MESH_NEW = 32  # tokens each session generates greedily, the sessions stepping merged
MESH_WINDOW = (4096, 11008, 1)  # the window kernel's shape: shard 1 of MESH_TP of an ffn_gate / ffn_up code grid
# the row shards (shard 1 of MESH_TP, flax [in, out]) of ffn_down and attention_out: whole
# rows of whole blocks, which the blockwise kernel takes as well as the window entry
MESH_ROW_SHARDS = {"ffn_down": (11008, 4096), "attention_out": (4096, 4096)}
MESH_PHASE_LIMIT_S = 210.0
# the mesh's backward: block 0 at [1, MESH_BACKWARD_TOKENS, 4096] with SGD(EXPERT_LR), held to
# the single-device backend of the same weights on the card as [expert_backward] holds its
MESH_BACKWARD_TOKENS = 512
MESH_BACKWARD_LIMIT_S = 30.0
# the serving mesh for every registered block and any N: a Llama-2-70B-width block
# (meta-llama/Llama-2-70b-hf config.json: hidden 8192, 64 heads, 8 KV heads, intermediate
# 28672, rms eps 1e-5; depth cut to 1 layer) over 16 shards, 4 query heads and 1 KV head a
# shard (each KV head copied to two shards), fp32 and int8; run_server's default
# causal_transformer (hidden 1024, 8 heads) over 3 shards (2/3/3 heads, ffn 1365/1365/1366);
# transformer and ffn at hidden 1024 over 4 shards; det_dropout and nop forward only
LLAMA2_70B = dict(hidden_size=8192, num_attention_heads=64, num_key_value_heads=8, intermediate_size=28672,
                  num_hidden_layers=1, rope_theta=10000.0, rms_norm_eps=1e-5, vocab_size=32000)
MESH_70B_SHARDS = 16
MESH_70B_PREFILL = 512
MESH_70B_SESSIONS, MESH_70B_PROMPT, MESH_70B_NEW = 4, 64, 8
MESH_BLOCK_HIDDEN = 1024
MESH_BLOCK_CASES = (  # (block, kwargs, shards, input shape, with a backward)
    ("causal_transformer", {"num_heads": 8}, 3, (4, 512, MESH_BLOCK_HIDDEN), True),
    ("transformer", {"num_heads": 8}, 4, (4, 512, MESH_BLOCK_HIDDEN), True),
    ("ffn", {}, 4, (2048, MESH_BLOCK_HIDDEN), True),
    ("det_dropout", {}, 4, (2048, MESH_BLOCK_HIDDEN), False),
    ("nop", {}, 4, (2048, MESH_BLOCK_HIDDEN), False),
)
MESH_BLOCK_SESSIONS, MESH_BLOCK_PROMPT = 4, 64  # causal_transformer's merged decode round
MESH_BLOCKS_LIMIT_S = 60.0  # the 70B-width and every-block parts together
# [cli]: run_dht and run_server --mesh_devices <the host's cards> as child processes, a
# RemoteSequential client forwarding [1, CLI_FORWARD, 4096] (the flash kernel on every
# shard) and generating CLI_NEW tokens through them
CLI_FORWARD, CLI_PROMPT, CLI_NEW = 512, 64, 16
CLI_STARTUP_LIMIT_S = 90.0
CLI_PHASE_LIMIT_S = 150.0
# run_top --serving --device as a child against the [cli] swarm, reading run_server's snapshots
CLI_TELEMETRY_KEY, CLI_TELEMETRY_INTERVAL_S = "chip_smoke_cli_telemetry", 2.0
# run_top's child: 8.3 s and 10.0 s on the card's host (PR runs 2-3), 2.5 s against a local DHT
# on a CPU sandbox, where importing takes 2 s of it; the limit leaves room for the host
CLI_TOP_LIMIT_S = 20.0


def window_entry(torch, peaks) -> dict:
    """The window dequantize (one column shard of a quantized [4096, 11008] weight) held
    bit for bit to its plain version and to the whole tensor's dequantize, and timed."""
    from hivemind_tpu_torch.ops.blockwise_int8 import (
        blockwise_dequantize_window_plain,
        blockwise_int8_dequantize,
        blockwise_int8_dequantize_window,
        blockwise_int8_quantize,
    )

    rows, out, shard = MESH_WINDOW
    cols = out // MESH_TP
    rng = np.random.default_rng(SEED + 21)
    weight = torch.from_numpy(rng.standard_normal((rows, out), dtype=np.float32) * np.float32(rows ** -0.5)).cuda()
    codes, absmax = blockwise_int8_quantize(weight.reshape(-1))
    window = codes.reshape(rows, out)[:, shard * cols : (shard + 1) * cols].contiguous()
    base = shard * cols
    got = blockwise_int8_dequantize_window(window, absmax, out, base)
    plain = blockwise_dequantize_window_plain(window, absmax, out, base)
    whole = blockwise_int8_dequantize(codes, absmax).reshape(rows, out)[:, base : base + cols]
    torch.cuda.synchronize()
    if not (torch.equal(got, plain) and torch.equal(got, whole)):
        raise AssertionError("window dequantize differs from its plain version or from the whole tensor's")
    err = (got - plain).abs().max().item()
    ms = time_ms(torch, lambda: blockwise_int8_dequantize_window(window, absmax, out, base))
    plain_ms = time_ms(torch, lambda: blockwise_dequantize_window_plain(window, absmax, out, base))
    n = rows * cols
    touched = (base + (rows - 1) * out + cols - 1) // 4096 - base // 4096 + 1  # the absmax blocks it reads
    bound, by = bound_ms(2.0 * n, peaks["fp32"], n + touched * 4 + n * 4, peaks["bytes"])
    log(f"[mesh_serving] window dequantize [{rows}, {cols}] of [{rows}, {out}] at column {base}: max_err={err} "
        f"(bit-identical to the plain version and the whole tensor's) ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound:.4f} ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None)


def row_shard_routes(torch, peaks) -> None:
    """The window entry and the blockwise kernel on the same row shards (whole rows of
    whole blocks, which ``QuantizedWindow`` sends to the blockwise kernel), held bit for
    bit to each other, and timed."""
    from hivemind_tpu_torch.ops.blockwise_int8 import (
        blockwise_int8_dequantize,
        blockwise_int8_dequantize_window,
        blockwise_int8_quantize,
    )

    shard = MESH_WINDOW[2]
    rng = np.random.default_rng(SEED + 24)
    for leaf, (whole_rows, width) in MESH_ROW_SHARDS.items():
        height = whole_rows // MESH_TP
        weight = torch.from_numpy(rng.standard_normal((whole_rows, width), dtype=np.float32)).cuda()
        codes, absmax = blockwise_int8_quantize(weight.reshape(-1))
        window = codes.reshape(whole_rows, width)[shard * height : (shard + 1) * height].contiguous()
        base, blocks = shard * height * width, height * width // 4096
        own_absmax = absmax[base // 4096 : base // 4096 + blocks]
        routes = {"window entry": lambda: blockwise_int8_dequantize_window(window, absmax, width, base),
                  "blockwise kernel": lambda: blockwise_int8_dequantize(window.reshape(blocks, 4096), own_absmax)}
        got = [fn().reshape(height, width) for fn in routes.values()]
        torch.cuda.synchronize()
        if not torch.equal(*got):
            raise AssertionError(f"{leaf}: the window entry and the blockwise kernel differ on a row shard")
        times = {route: time_ms(torch, fn) for route, fn in routes.items()}
        n = height * width
        bound, by = bound_ms(2.0 * n, peaks["fp32"], n * 5 + blocks * 4, peaks["bytes"])
        log(f"[mesh_serving] row shard {leaf} [{height}, {width}] of [{whole_rows}, {width}] at row {shard * height}: "
            + ", ".join(f"{route} ms={t:.4f}" for route, t in times.items())
            + f" (bit-identical); bound_ms={bound:.4f} ({by})")


def recorded_sizes(manager) -> list:
    """Hook the manager's merged step: the list it returns grows by each call's session count."""
    sizes, step = [], manager._batched_step
    manager._batched_step = lambda uid, x, *args: sizes.append(x.shape[0]) or step(uid, x, *args)
    return sizes


def merged_greedy(manager, uids, head, prompts: dict, new_tokens: int):
    """Each session prefills its prompt, then all generate ``new_tokens`` greedily, the
    single-token steps of every session in flight together (``decode_async``, which
    merges them). Returns (ids per session, prefill seconds, seconds per round)."""
    hidden, prefill_s, round_s = {}, [], []
    for sid, prompt in prompts.items():
        started, x = time.perf_counter(), head.embed(prompt).cpu().numpy()
        for uid in uids:
            x = manager.decode(uid, sid, x, True)
        prefill_s.append(time.perf_counter() - started)
        hidden[sid] = x
    ids = {sid: [int(t) for t in prompt[0]] for sid, prompt in prompts.items()}

    async def step(sid):
        x = head.embed(np.asarray([[ids[sid][-1]]])).cpu().numpy()
        for uid in uids:
            x = await manager.decode_async(uid, sid, x, False)
        hidden[sid] = x

    async def rounds():
        for index in range(new_tokens):
            for sid in prompts:
                ids[sid].append(int(head.logits(hidden[sid][:, -1:]).reshape(-1).argmax().item()))
            if index + 1 == new_tokens:
                return  # the last token needs no step
            started = time.perf_counter()
            await asyncio.gather(*(step(sid) for sid in prompts))
            round_s.append(time.perf_counter() - started)

    asyncio.run(rounds())
    return {sid: np.asarray([tokens]) for sid, tokens in ids.items()}, prefill_s, round_s


def profile_by_device(torch, fn, devices) -> tuple:
    """One warm call under torch.profiler: its host wall (us) and, for each device, its
    busy time and its three largest kernels or copies (us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for device in devices:
        torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        started = time.perf_counter()
        fn()
        for device in devices:
            torch.cuda.synchronize(device)
        wall_us = (time.perf_counter() - started) * 1e6
    by_device = {}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            names = by_device.setdefault(event.device_index, {})
            names[event.name] = names.get(event.name, 0.0) + event.time_range.elapsed_us()
    return wall_us, {index: (sum(names.values()), sorted(names.items(), key=lambda item: -item[1])[:3])
                     for index, names in sorted(by_device.items())}


def shard_bytes(shard: dict) -> int:
    return sum(value.numel() * value.element_size() if hasattr(value, "numel") else value.nbytes
               for value in shard.values())


def phase_mesh_serving(torch, checkpoint_dir: str, wrappers: dict, peaks: dict):
    from hivemind_tpu_torch.moe.server.decode_session import DecodeSessionManager
    from hivemind_tpu_torch.moe.server.llama_loader import LlamaClientHead, load_llama_blocks
    from hivemind_tpu_torch.moe.server.mesh_backend import ServingMesh

    phase_started = time.perf_counter()
    entry = window_entry(torch, peaks)
    row_shard_routes(torch, peaks)
    cards = torch.cuda.device_count()
    mesh = ServingMesh([f"cuda:{i}" for i in range(MESH_TP)] if cards >= MESH_TP else ["cuda:0"] * MESH_TP)
    distinct = sorted(set(mesh.devices), key=str)
    log(f"[mesh_serving] mesh {mesh}, {cards} card(s) on the host")
    modes = {"fp": None, "int8": "int8"}
    vocab, hid = LLAMA2_7B["vocab_size"], LLAMA2_7B["hidden_size"]
    rng = np.random.default_rng(SEED + 22)
    prefill_ids = rng.integers(0, vocab, size=(1, MESH_PREFILL))
    prompts = {f"mesh-{i}": rng.integers(0, vocab, size=(1, length)) for i, length in enumerate(DECODE_SESSION_PROMPTS)}
    head = LlamaClientHead.load(checkpoint_dir, device="cuda")
    single = {mode: load_llama_blocks(checkpoint_dir, device="cuda", weight_quantization=q, uid_prefix="single.")[0]
              for mode, q in modes.items()}
    peers = {f"{a}->{b}": torch.cuda.can_device_access_peer(a, b) for a in distinct for b in distinct if a != b}
    log(f"[mesh_serving] peer access between the mesh's cards: {peers or 'one card'}")
    for device in distinct:  # the GEMM library's workspace on each card, made once, before the reading
        torch.nn.functional.linear(torch.ones(8, 8, dtype=torch.bfloat16, device=device),
                                   torch.ones(8, 8, dtype=torch.bfloat16, device=device))
        torch.cuda.synchronize(device)
    before = {device: torch.cuda.memory_allocated(device) for device in distinct}

    for wrapper in wrappers.values():
        wrapper.launches = 0  # the main path starts here: loading over the mesh, prefill, merged decode
    meshed, sizes = {}, {}
    for mode, q in modes.items():
        meshed[mode] = load_llama_blocks(checkpoint_dir, mesh=mesh, weight_quantization=q, uid_prefix="mesh.")[0]
        torch.cuda.synchronize()
        if mode == "fp":
            after = {device: torch.cuda.memory_allocated(device) for device in distinct}
    prefill, generated, timing = {}, {}, {}
    x = head.embed(prefill_ids).cpu().numpy()
    for mode in modes:
        prefill[mode] = forward_chain(meshed[mode], x)
        manager = DecodeSessionManager(meshed[mode], max_len=MESH_MAX_LEN)
        sizes[mode] = recorded_sizes(manager)
        generated[mode], prefill_s, round_s = merged_greedy(manager, list(meshed[mode]), head, prompts, MESH_NEW)
        timing[mode] = dict(prefill_s=prefill_s, round_s=round_s)
    # the mesh's backward: block 0 with SGD, one step of every shard
    backward_started = time.perf_counter()
    sgd = lambda params: torch.optim.SGD(params, lr=EXPERT_LR)
    trained = load_llama_blocks(checkpoint_dir, layers=[0], mesh=mesh, optimizer=sgd, uid_prefix="train.")[0]["train.0"]
    initial = trained.gather_params()
    grad_rng = np.random.default_rng(SEED + 27)
    bx, bgrad = (grad_rng.standard_normal((1, MESH_BACKWARD_TOKENS, hid), dtype=np.float32) for _ in range(2))
    synchronize_all = lambda: [torch.cuda.synchronize(device) for device in distinct]
    synchronize_all()
    before_backward = {name: wrapper.launches for name, wrapper in wrappers.items()}
    started = time.perf_counter()
    (mesh_grad_x,) = trained.backward(bx, bgrad)
    synchronize_all()
    backward_walls = {"mesh": [time.perf_counter() - started]}
    backward_launches = {name: wrapper.launches - before_backward[name] for name, wrapper in wrappers.items()}
    torch.cuda.synchronize()
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}

    faults = []
    for device in distinct:  # each card holds its shards of the fp blocks, and nothing whole
        expected = sum(shard_bytes(shard) for backend in meshed["fp"].values() for shard, at in
                       zip(backend.params, mesh.devices) if at == device)
        grown = after[device] - before[device]
        log(f"[mesh_serving] fp {device}: allocated +{grown} B over the load for {expected} B of shards "
            f"(param_bytes_per_device {meshed['fp']['mesh.0'].param_bytes_per_device()} B a block, "
            f"{mesh.devices.count(device)} shard(s) a block here)")
        if not expected <= grown <= expected * 1.02 + (16 << 20):
            faults.append(f"{device} grew by {grown} B over the fp load, for {expected} B of shards")
    for mode in modes:
        backend = meshed[mode]["mesh.0"]
        log(f"[mesh_serving] {mode}: param_bytes {backend.param_bytes()} B a block, param_bytes_per_device "
            f"{backend.param_bytes_per_device()} B (single device: {single[mode]['single.0'].param_bytes()} B); "
            f"get_info mesh_devices={backend.get_info()['mesh_devices']}")
        # the mesh's prefill against the single-device blocks, and both timed
        expected = forward_chain(single[mode], x)
        rel_err = max_rel_err(prefill[mode], expected)
        walls = {}
        for what, blocks in (("mesh", meshed[mode]), ("single", single[mode])):
            runs = []
            for _ in range(MESH_PREFILL_RUNS):
                started = time.perf_counter()
                forward_chain(blocks, x)
                runs.append(time.perf_counter() - started)
            walls[what] = float(np.median(runs))
        log(f"[mesh_serving] {mode}: prefill [1, {MESH_PREFILL}, {hid}] through 2 blocks, mesh vs single device: "
            f"max_rel_err={rel_err:.3e} (limit {SERVING_TOL}); wall {walls['mesh'] * 1e3:.3f} ms vs "
            f"{walls['single'] * 1e3:.3f} ms (median of {MESH_PREFILL_RUNS})")
        for what, backend in (("mesh", meshed[mode]["mesh.0"]), ("single", single[mode]["single.0"])):
            wall_us, by_device = profile_by_device(torch, lambda: backend.forward(x), distinct)
            log(f"[profile] {mode} {what} block forward [1, {MESH_PREFILL}, {hid}]: wall {wall_us / 1e3:.3f} ms; "
                + "; ".join(f"cuda:{index} busy {busy / 1e3:.3f} ms (" + ", ".join(
                    f"{name[:48]} {us / 1e3:.3f}" for name, us in top) + ")" for index, (busy, top) in by_device.items()))
        if not (prefill[mode].shape == x.shape and np.isfinite(prefill[mode]).all() and rel_err < SERVING_TOL):
            faults.append(f"{mode}: the mesh's prefill differs from the single device's by {rel_err}")
        # the same merged greedy decode on the single-device blocks, for its times
        manager = DecodeSessionManager(single[mode], max_len=MESH_MAX_LEN)
        _ids, single_prefill_s, single_round_s = merged_greedy(manager, list(single[mode]), head, prompts, MESH_NEW)
        log(f"[mesh_serving] {mode}: {len(prompts)} sessions x {MESH_NEW} tokens, merged: per-token latency "
            f"(a round of every session) median / p90 mesh {median_p90(timing[mode]['round_s'])} vs single "
            f"{median_p90(single_round_s)}; session prefill [1, {DECODE_SESSION_PROMPTS[0]}-"
            f"{DECODE_SESSION_PROMPTS[-1]}] median mesh {np.median(timing[mode]['prefill_s']) * 1e3:.3f} ms vs "
            f"single {np.median(single_prefill_s) * 1e3:.3f} ms; {len(prompts) / np.median(timing[mode]['round_s']):.1f} "
            f"tokens/s mesh; merged step sizes {sorted(set(sizes[mode]))} in {len(sizes[mode])} calls")
        if not sizes[mode] or max(sizes[mode]) < 2:
            faults.append(f"{mode}: no merged step held 2 or more sessions: {sizes[mode]}")
        # every session's ids by a teacher-forced replay through the single-device blocks
        flips, worst = 0, 0.0
        for sid, prompt in prompts.items():
            gaps = greedy_gaps(head, single[mode], generated[mode][sid], prompt.shape[1])
            flips, worst = flips + int((gaps > 0).sum()), max(worst, float(gaps.max()))
        log(f"[mesh_serving] {mode}: teacher-forced replay of {len(prompts)} x {MESH_NEW} mesh tokens on the single "
            f"device: {flips} near-tie flips, largest logit gap {worst:.3e} (limit {GREEDY_LOGIT_RTOL})")
        if not worst <= GREEDY_LOGIT_RTOL:
            faults.append(f"{mode}: a token the mesh generated lies {worst} below the best logit")
    faults += mesh_backward_faults(torch, checkpoint_dir, trained, initial, (bx, bgrad), mesh_grad_x, backward_launches,
                                   backward_walls, synchronize_all, backward_started)
    del meshed, single, trained
    torch.cuda.empty_cache()
    # every registered block and any N: the counts of their own mesh calls join the path's
    blocks_started = time.perf_counter()
    faults += mesh_70b_part(torch, wrappers, launches)
    faults += mesh_blocks_part(torch, wrappers, launches)
    blocks_wall = time.perf_counter() - blocks_started
    log(f"[mesh_serving] the 70B-width and every-block parts' wall {blocks_wall:.1f} s (limit {MESH_BLOCKS_LIMIT_S:.0f})")
    if blocks_wall > MESH_BLOCKS_LIMIT_S:
        faults.append(f"the 70B-width and every-block parts took {blocks_wall:.1f} s, over {MESH_BLOCKS_LIMIT_S:.0f} s")
    wall = time.perf_counter() - phase_started
    log(f"[mesh_serving] phase wall {wall:.1f} s (limit {MESH_PHASE_LIMIT_S:.0f})")
    if wall > MESH_PHASE_LIMIT_S:
        faults.append(f"the phase took {wall:.1f} s, over its {MESH_PHASE_LIMIT_S:.0f} s")
    if faults:
        raise AssertionError("; ".join(faults))
    return launches, entry


def mesh_backward_faults(torch, checkpoint_dir: str, trained, initial: dict, inputs: tuple, mesh_grad_x,
                         launches: dict, walls: dict, synchronize_all, started: float) -> list:
    """The mesh's backward held as [expert_backward] holds one: its input gradient and
    each leaf's step, assembled from the shards, against the single-device backend of the
    same weights on the card; the norm copies identical on every shard; one dQ and one
    dK/dV launch a shard. Then both backwards timed (each call takes a step)."""
    from hivemind_tpu_torch.moe.server.llama_loader import load_llama_blocks

    faults, hid = [], LLAMA2_7B["hidden_size"]
    steps = {key: tensor - initial[key] for key, tensor in trained.gather_params().items()}
    for key in ("attention_norm.weight", "ffn_norm.weight"):
        copies = [shard[key].to("cpu") for shard in trained.params]
        if not all(torch.equal(copy, copies[0]) for copy in copies[1:]):
            faults.append(f"the mesh's copies of {key} differ after a step")
    sgd = lambda params: torch.optim.SGD(params, lr=EXPERT_LR)
    reference = load_llama_blocks(checkpoint_dir, layers=[0], device="cuda", optimizer=sgd)[0]["llama.0"]
    ref_initial = {key: tensor.to("cpu", copy=True) for key, tensor in reference.snapshot_params().items()}
    synchronize_all()
    begun = time.perf_counter()
    (ref_grad_x,) = reference.backward(*inputs)
    torch.cuda.synchronize()
    walls["single"] = [time.perf_counter() - begun]
    readings = {"input gradient": max_rel_err(mesh_grad_x, ref_grad_x)}
    for key, tensor in reference.snapshot_params().items():
        expected = tensor.to("cpu") - ref_initial[key]
        readings[key] = ((steps[key] - expected).abs().max() / expected.abs().max().clamp_min(1e-30)).item()
    for _ in range(2):  # warm walls: both take two more steps
        for what, backend, sync in (("mesh", trained, synchronize_all), ("single", reference, torch.cuda.synchronize)):
            begun = time.perf_counter()
            backend.backward(*inputs)
            sync()
            walls[what].append(time.perf_counter() - begun)
    log(f"[mesh_serving] backward [1, {MESH_BACKWARD_TOKENS}, {hid}] of block 0 over {len(trained.devices)} shards with "
        f"SGD(lr={EXPERT_LR}) vs the single device, max relative error: "
        + ", ".join(f"{key} {value:.3e}" for key, value in readings.items()) + f" (limit {EXPERT_TOL})")
    log(f"[mesh_serving] backward walls (first, then warm) mesh {[round(w * 1e3, 3) for w in walls['mesh']]} ms vs "
        f"single {[round(w * 1e3, 3) for w in walls['single']]} ms; launches in the mesh's first backward "
        f"{json.dumps(launches)}")
    worst = max(readings, key=readings.get)
    if not readings[worst] < EXPERT_TOL:
        faults.append(f"the mesh's backward: {worst} differs from the single device's by {readings[worst]:.3e}")
    for name in ("flash_attention_backward_dq", "flash_attention_backward_dkv"):
        if launches[name] != len(trained.devices):
            faults.append(f"{name} launched {launches[name]} times in the mesh's backward, not once a shard")
    wall = time.perf_counter() - started
    log(f"[mesh_serving] backward part's wall {wall:.1f} s (limit {MESH_BACKWARD_LIMIT_S:.0f})")
    if wall > MESH_BACKWARD_LIMIT_S:
        faults.append(f"the backward part took {wall:.1f} s, over its {MESH_BACKWARD_LIMIT_S:.0f} s")
    return faults


def write_block_checkpoint(torch, path: Path, config: dict, seed: int) -> None:
    """A synthetic HF-layout Llama checkpoint of ``config``'s decoder layers alone (no
    client ends), in fp16 safetensors as ``write_checkpoint`` writes it; the weights are
    drawn on the card from a seeded generator (a 70B-width layer is 0.86 G parameters,
    too many to draw on the host within the phase's budget)."""
    generator = torch.Generator(device="cuda").manual_seed(seed)
    hid = config["hidden_size"]
    (path / "config.json").write_text(json.dumps(config))
    weight_map = {}
    for layer in range(config["num_hidden_layers"]):
        prefix = f"model.layers.{layer}."
        tensors = {prefix + name: (torch.randn(shape, generator=generator, device="cuda") * shape[1] ** -0.5)
                   for name, shape in layer_shapes(config).items()}
        for norm in ("input_layernorm.weight", "post_attention_layernorm.weight"):
            tensors[prefix + norm] = 1.0 + 0.1 * torch.randn(hid, generator=generator, device="cuda")
        shard = f"model-{layer:05d}-of-{config['num_hidden_layers']:05d}.safetensors"
        write_safetensors(path / shard, {name: t.half().cpu().numpy() for name, t in tensors.items()})
        weight_map.update({name: shard for name in tensors})
    (path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))


def counted(wrappers: dict, totals: dict, fn):
    """``fn()``, its kernel launches added to ``totals`` (the path's counts)."""
    before = {name: wrapper.launches for name, wrapper in wrappers.items()}
    result = fn()
    for name, wrapper in wrappers.items():
        totals[name] = totals.get(name, 0) + wrapper.launches - before[name]
    return result


def spread(torch, shards: int) -> list:
    """``shards`` devices: all on the one card, or in contiguous groups over the host's cards."""
    cards = torch.cuda.device_count()
    return [f"cuda:{r * min(cards, shards) // shards}" for r in range(shards)]


def median_wall(torch, fn, devices, runs: int = 3) -> float:
    walls = []
    for _ in range(runs):
        started = time.perf_counter()
        fn()
        for device in sorted(set(devices)):
            torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - started)
    return float(np.median(walls))


def merged_round(manager, tokens: dict) -> tuple:
    """One decode step of every session in ``tokens`` (``{sid: [1, 1, hid]}``), in flight
    together so the manager merges them; returns ({sid: output}, wall seconds)."""

    async def rounds():
        return await asyncio.gather(*(manager.decode_async("b", sid, x, False) for sid, x in tokens.items()))

    started = time.perf_counter()
    outputs = asyncio.run(rounds())
    return dict(zip(tokens, outputs)), time.perf_counter() - started


def mesh_70b_part(torch, wrappers: dict, launches: dict) -> list:
    """A Llama-2-70B-width block over 16 shards (4 query heads and 1 KV head each, every KV
    head copied to two shards), fp32 and int8, against the single-device backend of the
    same checkpoint on the card: prefill [1, 512] (16 flash launches), the per-shard cache
    shapes, the copied int8 windows bit for bit, 4 sessions x 8 merged tokens."""
    from hivemind_tpu_torch.moe.server.decode_session import DecodeSessionManager
    from hivemind_tpu_torch.moe.server.llama_loader import load_llama_blocks
    from hivemind_tpu_torch.moe.server.mesh_backend import ServingMesh
    from hivemind_tpu_torch.ops.quantized_params import dequantize_tree

    faults, config, part = [], LLAMA2_70B, {}
    hid, heads, kv_heads = config["hidden_size"], config["num_attention_heads"], config["num_key_value_heads"]
    head_dim = hid // heads
    mesh = ServingMesh(spread(torch, MESH_70B_SHARDS))
    scratch = tempfile.TemporaryDirectory(prefix="llama2_70b_width_")
    started = time.perf_counter()
    write_block_checkpoint(torch, Path(scratch.name), config, SEED + 31)
    log(f"[mesh_serving] 70B width: a 1-layer checkpoint written in {time.perf_counter() - started:.1f} s; mesh {mesh}")
    rng = np.random.default_rng(SEED + 32)
    x = rng.standard_normal((1, MESH_70B_PREFILL, hid), dtype=np.float32)
    prompts = {f"s{i}": rng.standard_normal((1, MESH_70B_PROMPT, hid), dtype=np.float32)
               for i in range(MESH_70B_SESSIONS)}
    tokens = [{sid: rng.standard_normal((1, 1, hid), dtype=np.float32) for sid in prompts} for _ in range(MESH_70B_NEW)]
    try:
        for mode, quantization in (("fp", None), ("int8", "int8")):
            meshed = counted(wrappers, part, lambda: load_llama_blocks(
                scratch.name, mesh=mesh, weight_quantization=quantization, uid_prefix="m70.")[0]["m70.0"])
            single = load_llama_blocks(scratch.name, device="cuda", weight_quantization=quantization,
                                       uid_prefix="s70.")[0]["s70.0"]
            cache_k, cache_v = meshed.init_decode_cache(1, 16)
            shapes = sorted({tuple(cache.shape) for cache in cache_k + cache_v})
            if shapes != [(1, 16, 1, head_dim)] or len(cache_k) != MESH_70B_SHARDS:
                faults.append(f"70B {mode}: per-shard cache shapes {shapes} over {len(cache_k)} shards")
            flash_before = wrappers["flash_attention_forward"].launches
            got = counted(wrappers, part, lambda: meshed.forward(x)[0])
            flash = wrappers["flash_attention_forward"].launches - flash_before
            rel_err = max_rel_err(got, single.forward(x)[0])
            walls = {what: median_wall(torch, lambda: backend.forward(x), mesh.devices, runs=2)
                     for what, backend in (("mesh", meshed), ("single", single))}
            log(f"[mesh_serving] 70B {mode}: prefill [1, {MESH_70B_PREFILL}, {hid}] over {MESH_70B_SHARDS} shards vs "
                f"the single device: max_rel_err={rel_err:.3e} (limit {SERVING_TOL}); {flash} flash launches; wall "
                f"{walls['mesh'] * 1e3:.3f} ms vs {walls['single'] * 1e3:.3f} ms; param_bytes {meshed.param_bytes()} B, "
                f"per device {meshed.param_bytes_per_device()} B, cache shards {shapes}")
            if not (np.isfinite(got).all() and rel_err < SERVING_TOL):
                faults.append(f"70B {mode}: the mesh's prefill differs from the single device's by {rel_err}")
            if flash != MESH_70B_SHARDS:
                faults.append(f"70B {mode}: {flash} flash launches in a prefill, not {MESH_70B_SHARDS}")
            if quantization:  # every window, copied KV heads included, bit for bit the whole tensor's dequantize
                whole = {key: tensor.to("cpu") for key, tensor in dequantize_tree(single.params).items()}
                gathered = meshed.gather_params()
                differ = [key for key in whole if not torch.equal(gathered[key], whole[key])]
                for key in ("key.weight", "value.weight"):
                    for (k0, k1), shard in zip(meshed._ranges["kv"], meshed.params):
                        if not torch.equal(shard[key].dequantize().to("cpu"), whole[key][k0 * head_dim : k1 * head_dim]):
                            differ.append(f"{key} rows of KV heads [{k0}, {k1})")
                log(f"[mesh_serving] 70B int8: windows decoded against the whole tensors' dequantize: "
                    f"{'bit-identical' if not differ else differ}")
                if differ:
                    faults.append(f"70B int8: windows differ from the whole dequantize: {differ}")
            managers = {what: DecodeSessionManager({"b": backend}, max_len=MESH_70B_PROMPT + MESH_70B_NEW)
                        for what, backend in (("mesh", meshed), ("single", single))}
            sizes = recorded_sizes(managers["mesh"])
            worst, round_s = 0.0, {"mesh": [], "single": []}
            for sid, prompt in prompts.items():
                ours = counted(wrappers, part, lambda: managers["mesh"].decode("b", sid, prompt, True))
                worst = max(worst, max_rel_err(ours, managers["single"].decode("b", sid, prompt, True)))
            for step in tokens:
                ours, wall = counted(wrappers, part, lambda: merged_round(managers["mesh"], step))
                round_s["mesh"].append(wall)
                theirs, wall = merged_round(managers["single"], step)
                round_s["single"].append(wall)
                worst = max(worst, max(max_rel_err(ours[sid], theirs[sid]) for sid in step))
            log(f"[mesh_serving] 70B {mode}: {MESH_70B_SESSIONS} sessions prefilled [1, {MESH_70B_PROMPT}] and "
                f"{MESH_70B_NEW} merged tokens vs the single device: max_rel_err={worst:.3e}; merged step sizes "
                f"{sorted(set(sizes))} in {len(sizes)} calls; a round median mesh "
                f"{np.median(round_s['mesh']) * 1e3:.3f} ms vs single {np.median(round_s['single']) * 1e3:.3f} ms")
            if not worst < SERVING_TOL:
                faults.append(f"70B {mode}: a decode step differs from the single device's by {worst}")
            if not sizes or max(sizes) < 2:
                faults.append(f"70B {mode}: no merged step held 2 or more sessions: {sizes}")
            del meshed, single, managers
            torch.cuda.empty_cache()
    finally:
        scratch.cleanup()
    log(f"[mesh_serving] 70B width: launches {json.dumps({k: v for k, v in part.items() if v})}")
    for name, count in part.items():
        launches[name] = launches.get(name, 0) + count
    return faults


def step_errors(torch, steps: dict, expected: dict) -> dict:
    """Each leaf's step against the reference's, relative to the reference's largest;
    ``key.bias`` (whose exact gradient is 0, softmax ignoring it) against the largest
    step of any leaf."""
    largest = max(step.abs().max().item() for step in expected.values())
    return {key: ((steps[key] - expected[key]).abs().max()
                  / (largest if key == ZERO_GRADIENT else expected[key].abs().max().clamp_min(1e-30))).item()
            for key in expected}


def mesh_blocks_part(torch, wrappers: dict, launches: dict) -> list:
    """Every registered block but the Llama block over a mesh, against the single-device
    backend of the same weights on the card: causal_transformer at run_server's default
    width over 3 shards (prefill, a merged decode round, a backward with SGD),
    transformer and ffn over 4 (forward and backward), det_dropout and nop (forward)."""
    from hivemind_tpu_torch.moe.server.decode_session import DecodeSessionManager
    from hivemind_tpu_torch.moe.server.layers import name_to_block
    from hivemind_tpu_torch.moe.server.mesh_backend import MeshModuleBackend, ServingMesh
    from hivemind_tpu_torch.moe.server.module_backend import ModuleBackend

    faults, hid = [], MESH_BLOCK_HIDDEN
    sgd = lambda params: torch.optim.SGD(params, lr=EXPERT_LR)
    for case, (block, kwargs, shards, shape, backward) in enumerate(MESH_BLOCK_CASES):
        mesh = ServingMesh(spread(torch, shards))
        rng = np.random.default_rng(SEED + 40 + case)
        inputs = [rng.standard_normal(shape, dtype=np.float32)]
        if block == "det_dropout":
            inputs.append((rng.random(shape) > 0.2).astype(np.float32))
        sample = dict(sample_inputs=[a[:1] for a in inputs]) if len(inputs) > 1 else dict(sample_input=inputs[0][:1])
        part = {}
        meshed = counted(wrappers, part, lambda: MeshModuleBackend(
            f"mesh.{block}", name_to_block[block](hid, **kwargs), mesh=mesh, optimizer=sgd, rng_seed=SEED + 41, **sample))
        single = ModuleBackend(f"single.{block}", name_to_block[block](hid, **kwargs), optimizer=sgd,
                               params=meshed.gather_params(), device="cuda", **sample)
        got = counted(wrappers, part, lambda: meshed.forward(*inputs)[0])
        readings = {"forward": max_rel_err(got, single.forward(*inputs)[0])}
        walls = {what: median_wall(torch, lambda: backend.forward(*inputs), mesh.devices)
                 for what, backend in (("mesh", meshed), ("single", single))}
        cut = {unit: [stop - start for start, stop in ranges] for unit, ranges in meshed._ranges.items()}
        if block == "causal_transformer":  # sessions prefilled, then one merged round
            managers = [DecodeSessionManager({"b": backend}, max_len=MESH_BLOCK_PROMPT + 1) for backend in (meshed, single)]
            sizes = recorded_sizes(managers[0])
            worst = 0.0
            for i in range(MESH_BLOCK_SESSIONS):
                prompt = rng.standard_normal((1, MESH_BLOCK_PROMPT, hid), dtype=np.float32)
                ours = counted(wrappers, part, lambda: managers[0].decode("b", f"s{i}", prompt, True))
                worst = max(worst, max_rel_err(ours, managers[1].decode("b", f"s{i}", prompt, True)))
            step = {f"s{i}": rng.standard_normal((1, 1, hid), dtype=np.float32) for i in range(MESH_BLOCK_SESSIONS)}
            (ours, round_s) = counted(wrappers, part, lambda: merged_round(managers[0], step))
            theirs, single_round_s = merged_round(managers[1], step)
            readings["decode"] = max(worst, max(max_rel_err(ours[sid], theirs[sid]) for sid in step))
            log(f"[mesh_serving] {block}: per-shard caches {[tuple(c.shape) for c in managers[0]._sessions[('b', 's0')].cache_k]}; "
                f"a merged round of sizes {sizes} in {round_s * 1e3:.3f} ms vs {single_round_s * 1e3:.3f} ms")
            if not sizes or max(sizes) < 2:
                faults.append(f"{block}: no merged step held 2 or more sessions: {sizes}")
        if backward:
            grad_out = rng.standard_normal(got.shape, dtype=np.float32)
            initial, single_initial = meshed.gather_params(), {k: v.to("cpu", copy=True) for k, v in single.params.items()}
            bwd = {}
            grads = counted(wrappers, bwd, lambda: meshed.backward(*inputs, grad_out))
            single_grads = single.backward(*inputs, grad_out)
            readings["input gradient"] = max(max_rel_err(a, b) for a, b in zip(grads, single_grads))
            steps = {key: tensor - initial[key] for key, tensor in meshed.gather_params().items()}
            expected = {key: tensor.to("cpu") - single_initial[key] for key, tensor in single.params.items()}
            errors = step_errors(torch, steps, expected)
            worst_leaf = max(errors, key=errors.get)
            readings[f"step ({worst_leaf})"] = errors[worst_leaf]
            copies = [key for key, leaf in meshed.plan.leaves.items() if leaf.kind == "copy"]
            differ = [key for key in copies if not all(torch.equal(shard[key].to("cpu"), meshed.params[0][key].to("cpu"))
                                                       for shard in meshed.params[1:])]
            heads = sum(1 for count in cut.get("heads", []) if count)
            log(f"[mesh_serving] {block} backward: launches {json.dumps({k: v for k, v in bwd.items() if v})}; "
                f"copies {copies or 'none'} {'identical' if not differ else 'DIFFER: ' + str(differ)}")
            if differ:
                faults.append(f"{block}: the copies of {differ} differ after a step")
            if heads and not bwd["flash_attention_backward_dq"] == bwd["flash_attention_backward_dkv"] == heads:
                faults.append(f"{block}: {bwd['flash_attention_backward_dq']} dQ and "
                              f"{bwd['flash_attention_backward_dkv']} dK/dV launches, not one a shard with heads ({heads})")
            for name, count in bwd.items():
                part[name] = part.get(name, 0) + count
        for name, count in part.items():
            launches[name] = launches.get(name, 0) + count
        log(f"[mesh_serving] {block} over {shards} shards {cut} vs the single device, max relative error: "
            + ", ".join(f"{what} {value:.3e}" for what, value in readings.items()) + f" (limit {SERVING_TOL}); forward "
            f"[{', '.join(map(str, shape))}] wall {walls['mesh'] * 1e3:.3f} ms vs {walls['single'] * 1e3:.3f} ms; "
            f"launches {json.dumps({k: v for k, v in part.items() if v})}")
        worst = max(readings, key=readings.get)
        if not (np.isfinite(got).all() and readings[worst] < SERVING_TOL):
            faults.append(f"{block}: {worst} differs from the single device's by {readings[worst]:.3e}")
        del meshed, single
    torch.cuda.empty_cache()
    return faults


# [chaos]: the port's chaos soak on the card (the JAX package's tier-1 smoke configuration),
# then run_blackbox rebuilding one peer's final round from its spool
CHAOS_SOAK = dict(n_peers=2, duration=18.0, seed=0, chaos_fraction=0.55, include_moe=True)
# the soak's teardown joins each trainer, which may be inside an averaging round (its
# averaging_timeout is 20 s): the phase read 31.7 s and 57.5 s on the card's hosts
CHAOS_PHASE_LIMIT_S = 75.0
# the verdict's checks the phase reads but does not hold: at 2 peers x 18 s a >= 0.1 s chaos
# delay lands inside one of the ~8 chaos rounds by chance, so about half the runs of either
# package name a straggler (the JAX package's tier-1 smoke of this configuration does not
# hold it either); every other check of the verdict is held
CHAOS_CHANCE_CHECKS = ("straggler_attributed",)
# [sim]: the swarm simulator's smoke scenario, twice, in two child processes at once. A run
# took 46-62 s alone on the card's hosts and 94 s on a slower one (49-55 s on a CPU sandbox,
# where the JAX package's takes 33 s; the port's own proto3 and msgpack codecs, pure Python,
# cost about a third of it), too long for the script's end: the children start with the
# script at the lowest CPU priority, on the host's spare cores beside [build] and the kernel
# phases (whose times are the card's, behind spin kernels), and [sim] collects them
SIM_SCENARIO, SIM_SEED = "smoke", 0
SIM_LIMIT_S = 300.0  # the children's time from their start
SIM_PHASE_LIMIT_S = 20.0  # the phase's own wait for them
SIM_CHILD = """
import json, sys, time
from hivemind_tpu_torch.sim import run_scenario
started = time.perf_counter()
result = run_scenario(sys.argv[1], seed=int(sys.argv[2]))
wall_s = time.perf_counter() - started
jax = sorted({name.split(".")[0] for name in sys.modules} & {"jax", "flax", "optax", "hivemind_tpu"})
print(json.dumps({"digest": result.digest(), "wall_s": wall_s, "sim_seconds": result.diagnostics.get("sim_seconds"),
                  "summary": result.summary, "jax_modules": jax}, default=str))
"""


def phase_chaos(torch, wrappers: dict) -> dict:
    """The chaos soak with the trainers' parameters and the ffn experts on the card: its
    verdict must hold, and run_blackbox (a child, as a user runs it) rebuilds a peer's
    final round from the spool it left. No kernel runs on this path."""
    from hivemind_tpu_torch.hivemind_cli.run_chaos_soak import run_soak

    started = time.perf_counter()
    spools = tempfile.TemporaryDirectory(prefix="chip_smoke_blackbox_")
    try:
        for wrapper in wrappers.values():
            wrapper.launches = 0
        report = run_soak(**CHAOS_SOAK, blackbox_root=spools.name, device="cuda")
        launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
        soak_s = time.perf_counter() - started
        rebuilt = subprocess.run([sys.executable, "-m", "hivemind_tpu_torch.hivemind_cli.run_blackbox",
                                  f"{spools.name}/peer1", "--victim", "peer1", "--format", "json"],
                                 capture_output=True, text=True, timeout=30, cwd=Path(__file__).resolve().parent)
    finally:
        spools.cleanup()
    failed = sorted(check for check, ok in report["checks"].items() if not ok and check not in CHAOS_CHANCE_CHECKS)
    chance = {check: report["checks"][check] for check in CHAOS_CHANCE_CHECKS}
    log(f"[chaos] soak of {CHAOS_SOAK['n_peers']} peers for {CHAOS_SOAK['duration']} s in {soak_s:.1f} s on "
        f"{report['runs_on']}: placement {report.get('placement')}; steps {report['steps']}, epochs {report['epochs']}, "
        f"{report['total_injections']} faults injected, moe {report['moe']}, ledger rounds under chaos "
        f"{report['ledger_rounds_under_chaos']} ({report['straggler_attributions_under_chaos']} straggler attributions); "
        f"held checks failed: {failed or 'none'}; read, not held: {chance}; errors {report['errors']}")
    if failed:
        raise AssertionError(f"the soak's verdict failed: {failed}, errors {report['errors']}")
    placement = report.get("placement") or {}
    if not placement.get("trainers") or any(not device.startswith("cuda") for device in
                                            placement.get("trainers", []) + placement.get("experts", [])):
        raise AssertionError(f"the soak ran off the card: {placement}")
    if rebuilt.returncode != 0:
        raise AssertionError(f"run_blackbox exited with {rebuilt.returncode}: {rebuilt.stderr[-2000:]}")
    post = json.loads(rebuilt.stdout)["postmortem"]["peer1"]
    final_round = post.get("final_round") or {}
    log(f"[chaos] run_blackbox --format json over peer1's spool: final round {final_round.get('round')} "
        f"(slowest {final_round.get('slowest_peer')}), last span {(post.get('last_span') or {}).get('name')}, "
        f"reconstructed {post.get('reconstructed')}")
    if final_round.get("round") is None:
        raise AssertionError(f"run_blackbox rebuilt no final round from peer1's spool: {post}")
    wall = time.perf_counter() - started
    log(f"[chaos] phase wall {wall:.1f} s (limit {CHAOS_PHASE_LIMIT_S:.0f})")
    if wall > CHAOS_PHASE_LIMIT_S:
        raise AssertionError(f"the phase took {wall:.1f} s, over its {CHAOS_PHASE_LIMIT_S:.0f} s")
    return launches


def start_sim() -> tuple:
    """The two simulator children, started now at the lowest CPU priority, their output
    in files (a full pipe would stall a child until [sim] reads it); returns
    (start, [(child, stdout file, stderr file)])."""
    children = []
    for _ in range(2):
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        children.append((subprocess.Popen([sys.executable, "-c", SIM_CHILD, SIM_SCENARIO, str(SIM_SEED)], stdout=out,
                                          stderr=err, text=True, cwd=Path(__file__).resolve().parent,
                                          preexec_fn=lambda: os.nice(19)), out, err))
    return time.perf_counter(), children


def stop_sim(sim) -> None:
    for child, _out, _err in sim[1] if sim else ():
        if child.poll() is None:
            child.kill()
            child.wait()


def phase_sim(sim: tuple) -> None:
    """The swarm simulator on the card's host: the smoke scenario twice, in the two child
    processes ``start_sim`` began (no JAX may load in them); the digests must be equal."""
    begun, children = sim
    started = time.perf_counter()
    try:
        for child, _out, _err in children:
            child.wait(timeout=max(1.0, begun + SIM_LIMIT_S - time.perf_counter()))
    finally:
        stop_sim(sim)
    runs = []
    for child, out, err in children:
        out.seek(0)
        err.seek(0)
        if child.returncode != 0:
            raise AssertionError(f"run_scenario exited with {child.returncode}: {err.read()[-2000:]}")
        runs.append(json.loads(out.read().strip().splitlines()[-1]))
    summary = runs[0]["summary"]
    log(f"[sim] run_scenario({SIM_SCENARIO!r}, seed={SIM_SEED}) twice at once, beside the phases since the script's "
        f"start at the lowest CPU priority: digests {runs[0]['digest'][:16]} / {runs[1]['digest'][:16]}, walls "
        f"{runs[0]['wall_s']:.3f} / {runs[1]['wall_s']:.3f} s; dht get success "
        f"{summary['dht']['get_success_rate']}, beam recall {summary['beam']['recall_at_beam']}, matchmaking "
        f"convergence {summary['matchmaking']['convergence_during']}, chaos hits {summary['chaos_link_rule_hits']}; "
        f"JAX modules loaded: {runs[0]['jax_modules'] or 'none'}")
    if runs[0]["digest"] != runs[1]["digest"]:
        raise AssertionError("two runs of the same seed gave different digests")
    if runs[0]["jax_modules"] or runs[1]["jax_modules"]:
        raise AssertionError(f"the simulator loaded {runs[0]['jax_modules']}")
    wall = time.perf_counter() - started
    log(f"[sim] phase wall {wall:.1f} s (limit {SIM_PHASE_LIMIT_S:.0f}); the children's {started - begun:.1f} s "
        f"before it ran beside the other phases")
    if wall > SIM_PHASE_LIMIT_S:
        raise AssertionError(f"the phase took {wall:.1f} s, over its {SIM_PHASE_LIMIT_S:.0f} s")


def read_line(process, log_path: Path, pattern: str, limit_s: float) -> re.Match:
    """Wait for ``pattern`` in a child's log file; raises at the limit or when the child exits."""
    deadline = time.monotonic() + limit_s
    while time.monotonic() < deadline:
        found = re.search(pattern, log_path.read_text(errors="replace"))
        if found:
            return found
        if process.poll() is not None:
            raise RuntimeError(f"{process.args[2]} exited with code {process.returncode}:\n"
                               f"{log_path.read_text(errors='replace')[-3000:]}")
        time.sleep(0.2)
    raise TimeoutError(f"{process.args[2]} logged no {pattern!r} in {limit_s:.0f} s")


def phase_cli(torch, checkpoint_dir: str, wrappers: dict) -> dict:
    """The entry points a user runs: run_dht, then run_server over every local card as a
    mesh, as child processes; a client generates through them. The server logs its
    kernel launches once loaded and again as it stops: the served path's launches are
    the difference (loading runs each block's sample forward)."""
    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.moe.client.remote_sequential import RemoteSequential
    from hivemind_tpu_torch.moe.server.llama_loader import LlamaClientHead, generate_greedy, load_llama_blocks

    phase_started = time.perf_counter()
    cards = torch.cuda.device_count()
    scratch = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    logs = {name: Path(scratch.name) / f"{name}.log" for name in ("run_dht", "run_server")}
    children, client = [], None

    def start(name, *args):
        with open(logs[name], "w") as out:
            children.append(subprocess.Popen([sys.executable, "-m", f"hivemind_tpu_torch.hivemind_cli.{name}", *args],
                                             stdout=out, stderr=subprocess.STDOUT, cwd=Path(__file__).resolve().parent))
        return children[-1]

    try:
        dht_process = start("run_dht", "--listen_host", "127.0.0.1")
        maddr = read_line(dht_process, logs["run_dht"], r"--initial_peers (\S+)", CLI_STARTUP_LIMIT_S).group(1)
        started = time.perf_counter()
        server = start("run_server", "--llama_checkpoint", checkpoint_dir, "--mesh_devices", str(cards),
                       "--decode_max_len", str(CLI_PROMPT + CLI_NEW), "--initial_peers", maddr,
                       "--telemetry_key", CLI_TELEMETRY_KEY, "--telemetry_interval", str(CLI_TELEMETRY_INTERVAL_S))
        plan = read_line(server, logs["run_server"], r"memory plan: .*", CLI_STARTUP_LIMIT_S).group(0)
        read_line(server, logs["run_server"], r"serving \d+ experts", CLI_STARTUP_LIMIT_S)
        loaded = json.loads(read_line(server, logs["run_server"], r"kernel launches while loading: (\{.*\})", 1).group(1))
        log(f"[cli] run_dht at {maddr}; run_server --mesh_devices {cards} up in {time.perf_counter() - started:.1f} s: "
            f"{plan}")
        client = DHT(initial_peers=[maddr], start=True)
        head = LlamaClientHead.load(checkpoint_dir, device="cuda")
        pipe = RemoteSequential(client, "llama.", LLAMA2_7B["num_hidden_layers"])
        rng = np.random.default_rng(SEED + 23)
        x = rng.standard_normal((1, CLI_FORWARD, LLAMA2_7B["hidden_size"]), dtype=np.float32)
        started = time.perf_counter()
        forwarded = pipe(torch.from_numpy(x)).numpy()
        forward_s = time.perf_counter() - started
        prompt = rng.integers(0, LLAMA2_7B["vocab_size"], size=(1, CLI_PROMPT))
        started = time.perf_counter()
        ids = generate_greedy(head, pipe, prompt, CLI_NEW)
        generate_s = time.perf_counter() - started
        time.sleep(CLI_TELEMETRY_INTERVAL_S + 0.5)  # the publisher's next snapshot holds the served requests
        started = time.perf_counter()
        top = subprocess.run([sys.executable, "-X", "importtime", "-m", "hivemind_tpu_torch.hivemind_cli.run_top",
                              "--initial_peers", maddr,
                              "--key", CLI_TELEMETRY_KEY, "--frames", "1", "--no-ansi", "--serving", "--device"],
                             capture_output=True, text=True, timeout=60, cwd=Path(__file__).resolve().parent)
        top_s = time.perf_counter() - started
        server.send_signal(signal.SIGINT)
        counts = json.loads(read_line(server, logs["run_server"], r"kernel launches: (\{.*\})", 60).group(1))
        server.wait(60)
    finally:
        if client is not None:
            client.shutdown()
        for child in children:
            if child.poll() is None:
                child.send_signal(signal.SIGINT)
        for child in children:
            try:
                child.wait(15)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
        server_log = logs["run_server"].read_text(errors="replace")
        scratch.cleanup()
    # the server logs each kernel wrapper's launches by its name (run_server.kernel_launches), not the
    # packed-heads view's or a route's counts (no functions), which its Llama-width blocks never launch
    launches = {name: counts[wrapper.__name__] - loaded[wrapper.__name__] for name, wrapper in wrappers.items()
                if callable(wrapper)}
    layers = LLAMA2_7B["num_hidden_layers"]
    local = load_llama_blocks(checkpoint_dir, device="cuda")[0]
    rel_err = max_rel_err(forwarded, forward_chain(local, x))
    log(f"[cli] forward [1, {CLI_FORWARD}, {LLAMA2_7B['hidden_size']}] through the served mesh in "
        f"{forward_s * 1e3:.1f} ms (fp16 wire): max_rel_err={rel_err:.3e} against one card's blocks (limit {SERVING_TOL})")
    if not rel_err < SERVING_TOL:
        raise AssertionError(f"the served mesh's forward differs from one card's by {rel_err}")
    gaps = greedy_gaps(head, local, ids, CLI_PROMPT)
    log(f"[cli] generated {CLI_NEW} tokens through the served mesh in {generate_s:.2f} s: "
        f"{ids[0, CLI_PROMPT:].tolist()}; teacher-forced replay on one card: {int((gaps > 0).sum())} near-tie "
        f"flips, largest logit gap {gaps.max():.3e} (limit {GREEDY_LOGIT_RTOL}); server's kernel launches while "
        f"serving {json.dumps(launches)} (while loading {json.dumps(loaded)})")
    if launches["flash_attention_forward"] < layers * cards:  # the forward: every block on every shard
        raise AssertionError(f"the served forward launched the flash kernel {launches['flash_attention_forward']} "
                             f"times, fewer than {layers} blocks x {cards} shards")
    if "Traceback" in server_log:
        raise AssertionError(f"run_server logged a traceback:\n{server_log[-3000:]}")
    board = top.stdout[top.stdout.find("serving board"):] if "serving board" in top.stdout else ""
    import_us = max((int(line.split("|")[1]) for line in top.stderr.splitlines()
                     if line.startswith("import time:") and line.split("|")[1].strip().isdigit()), default=0)
    log(f"[cli] run_top --frames 1 --no-ansi --serving --device in {top_s:.1f} s (limit {CLI_TOP_LIMIT_S:.0f}; its "
        f"largest import {import_us / 1e6:.1f} s), exit {top.returncode}:\n" + "\n".join(top.stdout.strip().splitlines()[:40]))
    if top.returncode != 0 or "llama.0" not in board:
        raise AssertionError(f"run_top printed no served experts' board (exit {top.returncode}): "
                             f"{top.stdout[-1500:]} {top.stderr[-1500:] if top.returncode else ''}")
    if top_s > CLI_TOP_LIMIT_S:
        raise AssertionError(f"run_top took {top_s:.1f} s, over its {CLI_TOP_LIMIT_S:.0f} s")
    if not gaps.max() <= GREEDY_LOGIT_RTOL:
        raise AssertionError(f"a token generated through run_server lies {gaps.max()} below the best logit")
    wall = time.perf_counter() - phase_started
    log(f"[cli] phase wall {wall:.1f} s (limit {CLI_PHASE_LIMIT_S:.0f})")
    if wall > CLI_PHASE_LIMIT_S:
        raise AssertionError(f"the phase took {wall:.1f} s, over its {CLI_PHASE_LIMIT_S:.0f} s")
    return launches


PROMETHEUS_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
PROMETHEUS_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> dict:
    """{(sample name, labels): value} of a text exposition; raises on a line that does not parse."""
    samples = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        match = PROMETHEUS_SAMPLE.match(line)
        if match is None:
            raise AssertionError(f"/metrics line does not parse: {line!r}")
        name, labels, value = match.groups()
        samples[(name, tuple(PROMETHEUS_LABEL.findall(labels or "")))] = float(value)
    return samples


def registry_samples() -> dict:
    """The same keys as ``parse_prometheus``, read from the registry's series directly
    (histograms: their count and sum)."""
    from hivemind_tpu_torch.telemetry import REGISTRY

    samples = {}
    for metric in REGISTRY.collect():
        for key, child in metric.series():
            labels = tuple(zip(metric.labelnames, key))
            if metric.metric_type == "histogram":
                _buckets, total, count = child.snapshot()
                samples[(metric.name + "_count", labels)], samples[(metric.name + "_sum", labels)] = float(count), total
            else:
                name = metric.name if metric.metric_type != "counter" or metric.name.endswith("_total") else metric.name + "_total"
                samples[(name, labels)] = child.value
    return samples


def phase_telemetry(torch, telemetry: Telemetry, exporter_port: int) -> None:
    """The served path's telemetry after [serving], [decode] and [remote], held to
    exact counts; then where the host time of a request and of a decode step goes."""
    import urllib.request

    faults = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            faults.append(what)

    build = telemetry.readings["build"]
    expected = {f"build.{name}": 1 for name in build["compiled"]}
    check({site: n for site, n in build["recorded"].items() if n} == expected,
          f"[build] recorded compiles {build['recorded']}, expected one per library it compiled {expected}")
    check(metric_total("hivemind_device_compiles_total") == len(build["compiled"]),
          f"hivemind_device_compiles_total {metric_total('hivemind_device_compiles_total')} != "
          f"{len(build['compiled'])} libraries compiled")

    serving = telemetry.readings["serving"]
    deltas, pools, requests = serving["deltas"], serving["pools"], serving["requests"]
    batches = sum(deltas[f"hivemind_moe_batches_total:{pool}"] for pool in pools)
    check(batches == serving["batches"] == serving["formed"],
          f"batches: counted {batches}, runtime {serving['batches']}, formed {serving['formed']}")
    samples = {pool: deltas[f"hivemind_moe_samples_total:{pool}"] for pool in pools}
    check(all(n == requests for n in samples.values()), f"samples per pool {samples}, submitted {requests} each")
    waits = sum(deltas[f"hivemind_moe_queue_wait_seconds:{pool}"] for pool in pools)
    check(waits == requests * len(pools), f"queue waits observed {waits}, tasks {requests * len(pools)}")
    moved = (deltas["host_to_device"], deltas["device_to_host"])
    check(moved == (serving["bytes_in"], serving["bytes_out"]),
          f"serving transfers {moved}, the batches carried {(serving['bytes_in'], serving['bytes_out'])}")
    memory = serving["memory"] or {}
    check(serving["gauge_bytes"] == serving["allocated"] == memory.get("devices", {}).get("cuda:0", {}).get("bytes")
          and serving["allocated"] >= serving["param_bytes"],
          f"memory gauge {serving['gauge_bytes']}, allocated {serving['allocated']}, sample {memory}, "
          f"resident parameters {serving['param_bytes']}")

    for mode, reading in telemetry.readings["decode"].items():
        deltas, blocks = reading["deltas"], reading["blocks"]
        check(reading["live"] and set(reading["live"]) == {reading["sessions"] * blocks},
              f"{mode}: live-session gauge during the lock-step {reading['live']}, expected the server's "
              f"{reading['sessions']} sessions (solo and {DECODE_SESSIONS} lock-step) x {blocks} blocks")
        merged = sum(reading["merged"])
        direct = reading["block_calls"] + reading["lockstep_steps"] - merged
        check((deltas["batched"], deltas["direct"]) == (merged, direct),
              f"{mode}: steps batched/direct {deltas['batched']}/{deltas['direct']}, made {merged}/{direct}")
        check(deltas["ttl_evictions"] == deltas["cap_evictions"] == 0, f"{mode}: evictions {deltas}")
        check(deltas["resets"] == reading["sessions"] * blocks,
              f"{mode}: resets {deltas['resets']}, sessions opened {reading['sessions']} x {blocks} blocks")
        moved = (deltas["host_to_device"], deltas["device_to_host"])
        check(moved == (reading["bytes_in"], reading["bytes_out"]),
              f"{mode}: decode transfers {moved}, the steps carried {(reading['bytes_in'], reading['bytes_out'])}")

    time.sleep(0.1)  # the watchdogs of the closed loops have stopped: the registry holds still
    scraped = parse_prometheus(urllib.request.urlopen(f"http://127.0.0.1:{exporter_port}/metrics", timeout=30).read().decode())
    direct_read = registry_samples()
    check(all(key in scraped for key in direct_read) and all(scraped[key] == value for key, value in direct_read.items()),
          f"/metrics differs from the registry at {[key for key in direct_read if scraped.get(key) != direct_read[key]][:4]}")
    log(f"[telemetry] /metrics over HTTP: {len(scraped)} samples parsed, {len(direct_read)} read back from the registry")

    remote = telemetry.readings.get("remote", {})
    for mode in ("fp", "int8"):  # the serving records of [remote]'s burst: the handler opens the spans
        mine = [r for r in remote.get("records", ()) if r["expert"].startswith(f"llama_{mode}.")]
        if not mine:
            continue
        fields = ("queue_wait_s", "assembly_s", "compute_s", "serialize_s")
        phases = {field: [r.get(field, 0.0) for r in mine] for field in (*fields, "total_s")}
        log(f"[telemetry] serving {mode} over the wire: {len(mine)} block requests, median / p90: queue wait "
            f"{median_p90(phases['queue_wait_s'])}, batch assembly {median_p90(phases['assembly_s'])}, device compute "
            f"{median_p90(phases['compute_s'])}, request wall {median_p90(phases['total_s'])}; phases "
            f"{sum(map(sum, (phases[f] for f in fields))) / sum(phases['total_s']):.1%} of the requests' wall")
    bounds, lag = serving["lag"]
    moved = serving["deltas"]["host_to_device"] + serving["deltas"]["device_to_host"]
    log(f"[telemetry] serving: runtime busy {serving['deltas']['latency_sum'] / serving['wall_s']:.1%} of the run's "
        f"{serving['wall_s']:.3f} s (batch latency sum over wall; all requests submitted at once); loop lag "
        f"p50 {bucket_quantile(bounds, lag, 0.5)}, p99 {bucket_quantile(bounds, lag, 0.99)} over {lag[-1]} heartbeats, "
        f"{serving['stalls']:.0f} stalls; largest executor backlog {serving['backlog']}; host<->device "
        f"{moved:.0f} B: {moved / (requests * len(pools)):.0f} B per block request, "
        f"{moved / (serving['tokens'] * len(pools)):.0f} B per token and block; memory {serving['allocated']} B allocated, "
        f"{serving['param_bytes']} B resident parameters")
    for mode, reading in telemetry.readings["decode"].items():
        deltas, (bounds, lag) = reading["deltas"], reading["lag"]
        hooks = remote.get("decode", {}).get(mode, {}).get("hooks", {})
        moved = deltas["host_to_device"] + deltas["device_to_host"]
        cost = ""
        if hooks:
            cost = (f"; hooks, on [remote]'s pipe: solo per-token median with every hook {hooks['all'] * 1e3:.4f} ms, spans off "
                    f"{hooks['metrics'] * 1e3:.4f} ms, spans and registry updates off {hooks['none'] * 1e3:.4f} ms "
                    f"(spans {(hooks['all'] - hooks['metrics']) * 1e3:+.4f} ms, registry updates "
                    f"{(hooks['metrics'] - hooks['none']) * 1e3:+.4f} ms; {HOOK_COST_ROUNDS} steps each, rotated); "
                    f"{hooks['updates_per_step']:g} registry updates a step x {hooks['update_us']:.3f} us per labeled "
                    f"update timed alone = {hooks['updates_per_step'] * hooks['update_us']:.1f} us a step")
        log(f"[telemetry] decode {mode}: steps direct {deltas['direct']:.0f} / batched {deltas['batched']:.0f} "
            f"(block calls), live sessions in the lock-step {sorted(set(reading['live']))} ({reading['sessions']} x "
            f"{reading['blocks']} blocks), resets {deltas['resets']:.0f}, evictions 0; lock-step loop lag p50 "
            f"{bucket_quantile(bounds, lag, 0.5)}, p99 {bucket_quantile(bounds, lag, 0.99)} over {lag[-1]} heartbeats, "
            f"{reading['stalls']:.0f} stalls; largest executor backlog {reading['backlog']}; host<->device {moved:.0f} B, "
            f"{moved / reading['tokens']:.0f} B per generated token (prefills included){cost}")
    if faults:
        raise AssertionError("; ".join(faults))


def main(argv=None) -> int:
    import argparse
    import multiprocessing
    import multiprocessing.forkserver

    parser = argparse.ArgumentParser(description="On-card smoke test of hivemind_tpu_torch (every phase by default)")
    parser.add_argument("--only", default=None,
                        help="comma-separated phases to run after [build] and [checkpoint], e.g. mesh_serving,cli; "
                             "a partial run prints neither the kernels line nor the ok line")
    args = parser.parse_args(argv)
    only = None if args.only is None else set(args.only.split(","))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this smoke test runs only on the card", file=sys.stderr)
        return 2
    # read when the telemetry package is imported, so set before the first import
    os.environ.setdefault("HIVEMIND_WATCHDOG_INTERVAL_S", WATCHDOG_INTERVAL_S)
    try:
        from hivemind_tpu_torch.ops import blockwise_int8, flash_attention
        from hivemind_tpu_torch.telemetry import MetricsExporter, arm_device_telemetry
        from hivemind_tpu_torch.telemetry.watchdog import add_tick_sampler
    except ImportError as e:
        print(f"chip_smoke: cannot import the hivemind_tpu_torch package beside this script: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False

    wrappers = {
        "flash_attention_forward": flash_attention.flash_attention_lse,
        "flash_attention_backward_dq": flash_attention.flash_attention_backward_dq,
        "flash_attention_backward_dkv": flash_attention.flash_attention_backward_dkv,
        "blockwise_int8_quantize": blockwise_int8.blockwise_int8_quantize,
        "blockwise_int8_dequantize": blockwise_int8.blockwise_int8_dequantize,
        "blockwise_int8_dequantize_window": blockwise_int8.blockwise_int8_dequantize_window,
        # the flash kernels' launches on the packed-heads view (16-bit head dims that are not a multiple of 8)
        "flash_attention_forward_packed": flash_attention.flash_attention_lse.packed,
        "flash_attention_backward_dq_packed": flash_attention.flash_attention_backward_dq.packed,
        "flash_attention_backward_dkv_packed": flash_attention.flash_attention_backward_dkv.packed,
        # fp32's kernels: every pass on 3xTF32; the SIMT dQ kernel at the head dims 3xTF32 does not take
        "flash_attention_forward_tf32x3": flash_attention.flash_attention_lse.tf32x3,
        "flash_attention_backward_dq_tf32x3": flash_attention.flash_attention_backward_dq.tf32x3,
        "flash_attention_backward_dkv_tf32x3": flash_attention.flash_attention_backward_dkv.tf32x3,
        "flash_attention_backward_dq_simt": flash_attention.flash_attention_backward_dq.simt,
    }
    # each path, and the kernels that must launch in its run
    path_kernels = {
        "serving": ("flash_attention_forward", "blockwise_int8_quantize", "blockwise_int8_dequantize"),
        "expert_backward": ("flash_attention_forward", "flash_attention_backward_dq", "flash_attention_backward_dkv"),
        "train": ("flash_attention_forward", "flash_attention_backward_dq", "flash_attention_backward_dkv"),
        "train_fp32": ("flash_attention_forward", "flash_attention_backward_dq", "flash_attention_backward_dkv",
                       "flash_attention_forward_tf32x3", "flash_attention_backward_dq_tf32x3",
                       "flash_attention_backward_dkv_tf32x3"),
        "head_dim32": ("flash_attention_forward", "flash_attention_backward_dq", "flash_attention_backward_dkv",
                       "flash_attention_forward_packed", "flash_attention_backward_dq_packed",
                       "flash_attention_backward_dkv_packed"),
        "decode": ("blockwise_int8_dequantize",),
        "remote": ("flash_attention_forward", "flash_attention_backward_dq", "flash_attention_backward_dkv",
                   "blockwise_int8_dequantize"),
        "swarm": ("flash_attention_forward", "flash_attention_backward_dq", "flash_attention_backward_dkv",
                  "blockwise_int8_dequantize"),
        "relay": ("flash_attention_forward",),
        "dmoe": ("blockwise_int8_quantize", "blockwise_int8_dequantize"),
        "collab": ("flash_attention_forward", "flash_attention_backward_dq", "flash_attention_backward_dkv"),
        "ring": ("flash_attention_forward",),
        "slice": ("flash_attention_forward", "flash_attention_backward_dq", "flash_attention_backward_dkv"),
        "causal": ("flash_attention_forward", "flash_attention_backward_dq", "flash_attention_backward_dkv"),
        "mesh_serving": ("flash_attention_forward", "flash_attention_backward_dq", "flash_attention_backward_dkv",
                         "blockwise_int8_quantize", "blockwise_int8_dequantize", "blockwise_int8_dequantize_window"),
        "cli": ("flash_attention_forward",),
        "chaos": (),  # the soak's toy loss and ffn experts launch none of the port's kernels
    }

    line = card_line()
    log(f"[card] {line}; host {host_line()}")
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    entries, path_launches, failures = {}, {}, []
    checkpoint = tempfile.TemporaryDirectory(prefix="llama2_7b_width_")
    # telemetry as a serving process arms it: the memory sampler on the watchdog tick,
    # a /metrics exporter; and the largest executor backlog on each tick
    telemetry = Telemetry()
    arm_device_telemetry()
    add_tick_sampler(telemetry.sample_backlog)
    exporter = MetricsExporter(port=0, host="127.0.0.1")
    # the fork server of the phases' children imports CHILD_PRELOAD beside the build
    multiprocessing.set_forkserver_preload(list(CHILD_PRELOAD))
    multiprocessing.forkserver.ensure_running()
    # the simulator's children start first and run on the host's spare cores ([sim] collects them)
    sim = start_sim() if only is None or "sim" in only else None

    def run(phase: str, fn, *args):
        if only is not None and phase not in only | {"build", "checkpoint"}:
            return None
        started = time.perf_counter()
        try:
            return fn(*args)
        except Exception as e:  # every phase runs; the failures are listed at the end
            failures.append(f"[{phase}] {type(e).__name__}: {e}")
            log(f"[{phase}] FAILED: {type(e).__name__}: {e}")
        finally:
            log(f"[time] {phase}: {time.perf_counter() - started:.1f} s")

    # the checkpoint is written while nvcc builds the kernels; [checkpoint] waits for it
    writer, lane = concurrent.futures.ThreadPoolExecutor(max_workers=1), concurrent.futures.ThreadPoolExecutor(max_workers=1)
    written = writer.submit(write_checkpoint, Path(checkpoint.name), LLAMA2_7B, SEED + 3)
    try:
        run("build", phase_build, torch, telemetry)
        entries.update(run("flash", phase_flash, torch, peaks) or {})
        entries["blockwise_int8_quantize"], entries["blockwise_int8_dequantize"] = (
            run("quantize", phase_quantization, torch, peaks) or (None, None))
        entries.update(run("flash_bwd", phase_flash_bwd, torch, peaks) or {})
        run("checkpoint", written.result)
        cpu_blocks_loaded = {}  # by quantization: [serving] loads, [decode] reads and frees
        path_launches["serving"] = run("serving", phase_serving, torch, checkpoint.name, wrappers, telemetry,
                                       cpu_blocks_loaded)
        path_launches["head_dim32"] = run("head_dim32", phase_small_heads, torch, wrappers)
        path_launches["decode"] = run("decode", phase_decode, torch, checkpoint.name, wrappers, peaks, telemetry,
                                      cpu_blocks_loaded)
        path_launches["remote"] = run("remote", phase_remote, torch, checkpoint.name, wrappers, telemetry)
        run("telemetry", phase_telemetry, torch, telemetry, exporter.port)
        path_launches["dmoe"] = run("dmoe", phase_dmoe, torch, wrappers, telemetry)
        path_launches["expert_backward"] = run("expert_backward", phase_expert_backward, torch, checkpoint.name, wrappers)
        path_launches["train"] = run("train", phase_train, torch, peaks, wrappers, telemetry)
        path_launches["train_fp32"] = run("train_fp32", phase_train_fp32, torch, peaks, wrappers, telemetry)
        path_launches["causal"] = run("causal", phase_causal, torch, peaks, wrappers)
        # Two host-bound swarm phases run in a lane of their own (a thread; this process's card work there on a
        # stream of its own), each beside a phase that times no kernel and keeps its limits with room to spare:
        # [swarm] beside [collab] (after [telemetry]: the swarm's DHT and servers arm a watchdog on the port's
        # shared loop, which stays open, so the registry would not hold still for its scrape), and [averaging]
        # (host numpy, no kernel; its peers' card work is a few ms a round) beside [slice]. Their readings are
        # taken beside those phases. [collab] runs after [train], whose solo step it reads beside its own.
        swarmed = lane.submit(run, "swarm", on_own_stream, torch, phase_swarm, torch, checkpoint.name, wrappers, telemetry)
        path_launches["collab"] = run("collab", phase_collab, torch, wrappers, telemetry)
        path_launches["swarm"] = swarmed.result()
        # the relay tier, alone: its readings sit beside [swarm]'s and [remote]'s
        path_launches["relay"] = run("relay", phase_relay, torch, checkpoint.name, wrappers, telemetry)
        # the mesh tier: ranks that share the card over gloo
        path_launches["ring"] = run("ring", phase_ring, torch)
        averaged = lane.submit(run, "averaging", on_own_stream, torch, phase_averaging, torch)
        path_launches["slice"] = run("slice", phase_slice, torch, wrappers, telemetry)
        averaged.result()
        # the serving mesh: tensor-parallel blocks in this process, then the entry points as children
        path_launches["mesh_serving"], entries["blockwise_int8_dequantize_window"] = (
            run("mesh_serving", phase_mesh_serving, torch, checkpoint.name, wrappers, peaks) or (None, None))
        path_launches["cli"] = run("cli", phase_cli, torch, checkpoint.name, wrappers)
        # the swarm tooling: the chaos soak on the card, then the simulator (host only)
        path_launches["chaos"] = run("chaos", phase_chaos, torch, wrappers)
        run("sim", phase_sim, sim)
    finally:
        stop_sim(sim)
        writer.shutdown()
        lane.shutdown()
        checkpoint.cleanup()
        exporter.shutdown()

    for path, kernels in path_kernels.items():
        counts = path_launches.get(path)
        if counts is None:
            continue
        log(f"[launches] {path} path: {json.dumps(counts)}")
        missing = [kernel for kernel in kernels if counts.get(kernel, 0) <= 0]
        if missing:
            failures.append(f"[launches] kernels never launched on the {path} path: {missing}")
    if failures:
        print("chip_smoke: failed phases:\n" + "\n".join(failures), file=sys.stderr)
        return 1
    if only is not None:
        print(f"chip_smoke: partial run of {sorted(only)} passed; no kernels or ok line", file=sys.stderr)
        return 0

    meta = {
        "flash_attention_forward": ("hivemind_tpu_torch/csrc/flash_attention.cu", "hivemind_tpu/ops/pallas_attention.py:108"),
        "flash_attention_backward_dq": ("hivemind_tpu_torch/csrc/flash_attention_bwd.cu", "hivemind_tpu/ops/pallas_attention.py:279"),
        "flash_attention_backward_dkv": ("hivemind_tpu_torch/csrc/flash_attention_bwd.cu", "hivemind_tpu/ops/pallas_attention.py:292"),
        "blockwise_int8_quantize": ("hivemind_tpu_torch/csrc/blockwise_int8.cu", "hivemind_tpu/ops/pallas_quantization.py:46"),
        "blockwise_int8_dequantize": ("hivemind_tpu_torch/csrc/blockwise_int8.cu", "hivemind_tpu/ops/pallas_quantization.py:73"),
        # row 5 on a shard of the serving mesh, whose cut the JAX package leaves to GSPMD
        "blockwise_int8_dequantize_window": ("hivemind_tpu_torch/csrc/blockwise_int8.cu",
                                             "hivemind_tpu/ops/pallas_quantization.py:73"),
        # rows 1-3 on the packed-heads view (kPacked instantiations)
        "flash_attention_forward_packed": ("hivemind_tpu_torch/csrc/flash_attention.cu",
                                           "hivemind_tpu/ops/pallas_attention.py:108"),
        "flash_attention_backward_dq_packed": ("hivemind_tpu_torch/csrc/flash_attention_bwd.cu",
                                               "hivemind_tpu/ops/pallas_attention.py:279"),
        "flash_attention_backward_dkv_packed": ("hivemind_tpu_torch/csrc/flash_attention_bwd.cu",
                                                "hivemind_tpu/ops/pallas_attention.py:292"),
        # rows 1-3 on fp32 (flash_forward_tf32x3, flash_bwd_dq_tf32x3, flash_bwd_dkv_tf32x3), and row 2 on
        # the SIMT kernel (flash_bwd_dq_simt) at an fp32 head dim 3xTF32 does not take
        "flash_attention_forward_tf32x3": ("hivemind_tpu_torch/csrc/flash_attention.cu",
                                           "hivemind_tpu/ops/pallas_attention.py:108"),
        "flash_attention_backward_dq_tf32x3": ("hivemind_tpu_torch/csrc/flash_attention_bwd.cu",
                                               "hivemind_tpu/ops/pallas_attention.py:279"),
        "flash_attention_backward_dkv_tf32x3": ("hivemind_tpu_torch/csrc/flash_attention_bwd.cu",
                                                "hivemind_tpu/ops/pallas_attention.py:292"),
        "flash_attention_backward_dq_simt": ("hivemind_tpu_torch/csrc/flash_attention_bwd.cu",
                                             "hivemind_tpu/ops/pallas_attention.py:279"),
    }
    kernels = [
        {"name": kernel, "route": "cuda", "source": meta[kernel][0], "replaces": meta[kernel][1],
         "launches": sum(counts.get(kernel, 0) for counts in path_launches.values() if counts), **entries[kernel]}
        for kernel in wrappers
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
