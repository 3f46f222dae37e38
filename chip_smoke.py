#!/usr/bin/env python3
"""On-card smoke test of hivemind_tpu_torch: builds the port's Hopper kernels,
holds each against its plain PyTorch version at the shapes of the paths that run
it, then drives four paths and checks each against the CPU:
- serving: two Llama-2-7B-width blocks (fp and int8 weight-only) through
  load_llama_blocks → ModuleBackend → TaskPool/Runtime, and an expert of
  head_dim 32, which the flash kernel does not take, through ModuleBackend;
- decode: greedy generation and continuous batching of single-token steps through
  DecodeSessionManager's KV-cache sessions on the same blocks;
- expert training: ModuleBackend.backward (one SGD step) on a Llama-2-7B-width block;
- ALBERT-base MLM training: make_train_step with AdamW at batch 32 × seq 512.
Telemetry rides the serving and decode runs, as a server would arm it (the event-loop
watchdog, the device memory sampler, a ``/metrics`` exporter, a ``serving.request`` span
around each request): ``[telemetry]`` holds its counters to exact counts and prints where
the host time of a request and of a decode step goes.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

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
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 0
# Llama-2-7B widths (meta-llama/Llama-2-7b-hf config.json); depth cut from 32 to 2 layers
LLAMA2_7B = dict(hidden_size=4096, num_attention_heads=32, num_key_value_heads=32, intermediate_size=11008,
                 num_hidden_layers=2, rope_theta=10000.0, rms_norm_eps=1e-5, vocab_size=32000)
ALBERT_ATTENTION = (32, 512, 12, 64)  # ALBERT-base's [B, T, H, D] at batch 32, seq 512
EXPERT_TOKENS = 256  # [1, 256, 4096] through ModuleBackend.backward
EXPERT_ATTENTION = (1, EXPERT_TOKENS, 32, 128)  # that block's [B, T, H, D]
# the serving path's [B, T, H, D] (2000: a ragged tail tile; batch 4: the merged 512-long
# requests), head_dim 64 (the kernel's other width), ALBERT's and the expert backward's
FLASH_SHAPES = ([(1, t, 32, 128) for t in (512, 2048, 2000)] + [(4, 512, 32, 128), (2, 1000, 16, 64)]
                + [ALBERT_ATTENTION, EXPERT_ATTENTION])
# Flash vs its plain version. Each element's error within atol + rtol*scale, where an
# output's scale is sum_j p_j*|v_j| (the plain version run on |v|; it bounds the output,
# and the rounding of the terms). The bf16 kernel rounds each p_j to bf16 and both
# versions round the output, so with u = 2^-8 (bf16's unit roundoff) an exact
# computation errs by at most 3u*scale. The largest error stays within max_abs, and the
# error's norm over the reference's norm within rel_l2 (about u for bf16): what catches
# a kernel that is a few percent off on the many small outputs, each within its own limit.
# fp16 (the SIMT kernel: fp32 math, the output rounded once) is held the same way with
# fp16's unit roundoff; its cap is one fp16 ulp of an output in [4, 8).
BF16_UNIT_ROUNDOFF = 2.0**-8
FP16_UNIT_ROUNDOFF = 2.0**-11
FLASH_TOL = {
    "bfloat16": dict(atol=1e-5, rtol=3 * BF16_UNIT_ROUNDOFF, max_abs=2e-2, rel_l2=BF16_UNIT_ROUNDOFF),
    "float16": dict(atol=1e-5, rtol=3 * FP16_UNIT_ROUNDOFF, max_abs=2.0**-8, rel_l2=FP16_UNIT_ROUNDOFF),
    "float32": dict(atol=1e-4, rtol=0.0, max_abs=1e-4, rel_l2=1e-4),
}
LSE_TOL = dict(atol=1e-4, rtol=0.0, max_abs=1e-4, rel_l2=1e-5)  # lse is fp32 on both paths
MANTISSA_BITS = {"bfloat16": 7, "float16": 10, "float32": 23}
# The SIMT kernels (fp32, fp16, and bf16 at a head_dim other than 64 or 128) beyond the
# fp32 cases of FLASH_SHAPES, each held and timed like them: (shape, dtype, causal).
# The head_dim-32 expert's attention ([head_dim32] below), head dims 16, 32, 80, 96
# and 256, fp16 at a Llama request's shape, and B*H = 65536 on both designs.
FLASH_EXTRA_CASES = [
    ((2, 64, 8, 32), "bfloat16", False), ((2, 1000, 16, 32), "bfloat16", True), ((2, 1000, 16, 16), "bfloat16", True),
    ((2, 1000, 16, 80), "bfloat16", False), ((1, 512, 8, 96), "bfloat16", True), ((1, 512, 4, 256), "float16", True),
    ((2, 1000, 16, 64), "float16", True), ((1, 2048, 32, 128), "float16", True),
    ((65536, 16, 1, 64), "bfloat16", True), ((32768, 16, 2, 32), "float16", False),
]
# views whose base is one element off 16-byte alignment, which TMA cannot read: the
# wrappers copy them first (bf16, head_dim 64), or the SIMT kernel reads them (head_dim 32)
UNALIGNED_CASES = [((2, 1000, 16, 64), True), ((2, 64, 8, 32), False)]
SERVING_TOL = 2e-2  # max relative error, card vs CPU (hivemind_tpu/ops/device_check.py's tolerance)
# The flash backward passes vs their plain versions: (shape, dtype, causal). The
# training path's shape, the expert backward's as chip_smoke drives it, a Llama
# request at full length, a ragged tail, head_dim 64 both ways, and the fp32 path.
FLASH_BWD_CASES = [
    (ALBERT_ATTENTION, "bfloat16", False), (EXPERT_ATTENTION, "bfloat16", True), ((1, 2048, 32, 128), "bfloat16", True),
    ((1, 2000, 32, 128), "bfloat16", True), ((2, 1000, 16, 64), "bfloat16", False),
    ((2, 1000, 16, 64), "bfloat16", True), ((2, 1000, 16, 64), "float32", False),
    ((2, 1000, 16, 64), "float32", True), ((1, 512, 32, 128), "float32", True),
    # the SIMT kernels at other head dims and in fp16, and B*H = 65536 on both designs
    ((2, 64, 8, 32), "bfloat16", False), ((2, 1000, 16, 32), "bfloat16", True), ((1, 512, 8, 80), "bfloat16", False),
    ((2, 1000, 16, 64), "float16", True), ((1, 512, 4, 256), "float16", False),
    ((65536, 16, 1, 64), "bfloat16", True), ((32768, 16, 2, 32), "float16", False),
    # the forward's SIMT shapes of [flash], so each kernel's SIMT row is timed at one shape
    ((1, 512, 8, 96), "bfloat16", True), ((1, 512, 4, 256), "float16", True),
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
# T*2^-24*scale (1.2e-4 at T = 2048). fp16 (the SIMT kernels: P and dS in fp32, the
# output rounded once) is held like bf16 with fp16's unit roundoff.
FLASH_BWD_TOL = {
    "bfloat16": dict(atol=1e-5, rtol=3 * BF16_UNIT_ROUNDOFF, max_abs=6.25e-2, rel_l2=2 * BF16_UNIT_ROUNDOFF),
    "float16": dict(atol=1e-5, rtol=3 * FP16_UNIT_ROUNDOFF, max_abs=2.0**-7, rel_l2=2 * FP16_UNIT_ROUNDOFF),
    "float32": dict(atol=1e-5, rtol=1.2e-4, max_abs=1e-3, rel_l2=1e-5),
}
FAULTY_TILE = 64  # planted faults the checks must reject: P (forward) or dS (backward) 5% too large on every other 64-wide tile
# where the backward's planted fault is checked: the training path's shape, and a Llama
# request at full length, causal (the dQ kernel masks only its diagonal tiles)
FAULTY_BWD_SHAPES = (ALBERT_ATTENTION, (1, 2048, 32, 128))
# q, k, v sliced from one fused [B, T, 3, H, D] tensor (T stride 3*H*D): the TMA views of a
# projection that is not split into three tensors, for each head_dim, held like FLASH_SHAPES
STRIDED_CASES = [((2, 1000, 16, 64), True), ((1, 512, 32, 128), False)]
# the kernels that issue wgmma fed by TMA, with setmaxnreg: the build fails if one spills
WGMMA_KERNELS = ("flash_forward_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")
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
EXPERT_LR = 1e-3  # SGD; the steps are compared, not the (barely moved) weights
EXPERT_TOL = SERVING_TOL
REQUEST_LENGTHS = (512, 512, 512, 512, 2048)
REFERENCE_LENGTH = 256  # a request of its own; the first 512-long request is checked too
# an expert of head_dim 32, which the SIMT flash kernel serves on the card
SMALL_HEADS_EXPERT = dict(hidden=256, heads=8, shape=(2, 64, 256))
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


def log(message: str) -> None:
    print(message, flush=True)


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
        return {"bf16": 989e12, "fp32": 67e12, "bytes": 4.8e12}
    if "H100" in name and "PCIe" in name:
        return {"bf16": 756e12, "fp32": 51e12, "bytes": 2.0e12}
    return {"bf16": 989e12, "fp32": 67e12, "bytes": 3.35e12}  # H100 SXM


def bound_ms(operations: float, op_rate: float, nbytes: float, byte_rate: float):
    op_ms, byte_ms = operations / op_rate * 1e3, nbytes / byte_rate * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


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


def phase_flash(torch, peaks) -> dict:
    import torch.nn.functional as F

    from hivemind_tpu_torch.ops.flash_attention import flash_attention_lse, flash_attention_plain, flash_route, needs_copy

    rng = np.random.default_rng(SEED)
    main_entry = None
    for shape in FLASH_SHAPES:
        batch, seq, heads, dim = shape
        base = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda() for _ in range(3)]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype) for t in base)
            dtype_name = str(dtype).removeprefix("torch.")
            for causal in (False, True):
                out, lse = flash_attention_lse(q, k, v, causal)
                reference = plain_forward(torch, q, k, v, causal)
                out_reading, lse_reading = read_forward(out, lse, reference, dtype_name)
                readings = f"out {format_reading(out_reading)}; lse {format_reading(lse_reading)}"
                label = f"B={batch} T={seq} H={heads} D={dim} {dtype_name} causal={causal}"
                if not (out_reading["ok"] and lse_reading["ok"]):
                    raise AssertionError(f"flash {label} exceeds out {FLASH_TOL[dtype_name]}, lse {LSE_TOL}: {readings}")
                if shape == ALBERT_ATTENTION and dtype == torch.bfloat16 and not causal:  # a planted fault, rejected
                    faulty = read_forward(faulty_forward(torch, q, k, v, causal), lse, reference, dtype_name)[0]
                    log(f"[flash] {label}, P x 1.05 on every other KV tile (planted in the plain version): "
                        f"out {format_reading(faulty)} ok={faulty['ok']}")
                    if faulty["ok"]:
                        raise AssertionError("flash check passed a P that is 5% off on half the KV tiles")
                del reference
                err, lse_err = out_reading["max_abs"], lse_reading["max_abs"]
                ms = time_ms(torch, lambda: flash_attention_lse(q, k, v, causal))
                host = host_us(torch, lambda: flash_attention_lse(q, k, v, causal))
                plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v, causal))
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
                pairs = seq * (seq + 1) / 2 if causal else seq * seq  # query-key pairs this data needs
                operations = 4.0 * batch * heads * dim * pairs
                nbytes = 4 * q.numel() * q.element_size() + lse.numel() * 4
                rate = peaks["bf16"] if dtype == torch.bfloat16 else peaks["fp32"]
                bound, bound_by = bound_ms(operations, rate, nbytes, peaks["bytes"])
                log(f"[flash] {label}: max_err={err:.3e} lse_err={lse_err:.3e} ms={ms:.4f} "
                    f"({operations / ms / 1e9:.1f} TFLOP/s) host_us={host:.1f} plain_ms={plain_ms:.4f} "
                    f"library_ms={library_ms:.4f} bound_ms={bound:.4f} ({bound_by})")
                log(f"[flash]   {readings}")
                if shape == (1, 2048, 32, 128) and causal and dtype == torch.bfloat16:  # the longest served request
                    main_entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                      bound_by=bound_by, library_ms=library_ms)
    for shape, dtype_name, causal in FLASH_EXTRA_CASES:
        batch, seq, heads, dim = shape
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda().to(getattr(torch, dtype_name))
                   for _ in range(3))
        label = f"B={batch} T={seq} H={heads} D={dim} {dtype_name} causal={causal} ({flash_route(q)})"
        readings = check_forward(torch, q, k, v, causal, dtype_name, label)
        ms = time_ms(torch, lambda: flash_attention_lse(q, k, v, causal))
        plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v, causal))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
        pairs = seq * (seq + 1) / 2 if causal else seq * seq
        operations = 4.0 * batch * heads * dim * pairs
        nbytes = 4 * q.numel() * q.element_size() + batch * heads * seq * 4
        bound, bound_by = bound_ms(operations, peaks["bf16"], nbytes, peaks["bytes"])
        log(f"[flash] {label}: ms={ms:.4f} ({operations / ms / 1e9:.1f} TFLOP/s) plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} bound_ms={bound:.4f} ({bound_by})")
        log(f"[flash]   {readings}")
    for (batch, seq, heads, dim), causal in STRIDED_CASES:
        fused = torch.from_numpy(rng.standard_normal((batch, seq, 3, heads, dim), dtype=np.float32)).cuda().bfloat16()
        q, k, v = fused.unbind(2)
        readings = check_forward(torch, q, k, v, causal, "bfloat16", "on a fused qkv tensor")
        log(f"[flash] q, k, v of one fused [{batch}, {seq}, 3, {heads}, {dim}] bf16 tensor, causal={causal}: {readings}")
    for shape, causal in UNALIGNED_CASES:
        q, k, v = (unaligned(torch, torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda().bfloat16())
                   for _ in range(3))
        readings = check_forward(torch, q, k, v, causal, "bfloat16", "on unaligned views")
        log(f"[flash] q, k, v bf16 {list(shape)} one element off 16-byte alignment ({flash_route(q)}, "
            f"copied first: {needs_copy(q)}), causal={causal}: {readings}")
    return main_entry


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
    from hivemind_tpu_torch.ops.flash_attention import (
        _delta,
        flash_attention_backward,
        flash_attention_backward_dkv,
        flash_attention_backward_dkv_plain,
        flash_attention_backward_dq,
        flash_attention_backward_dq_plain,
        flash_attention_plain,
        flash_route,
    )

    rng = np.random.default_rng(SEED + 5)
    entries = {}
    for shape, dtype_name, causal in FLASH_BWD_CASES:
        batch, seq, heads, dim = shape
        dtype = getattr(torch, dtype_name)
        q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda().to(dtype)
                         for _ in range(4))
        out, lse = flash_attention_plain(q, k, v, causal)
        delta = _delta(out, dout)
        args = (q, k, v, dout, lse, delta, causal)
        got = (flash_attention_backward_dq(*args), *flash_attention_backward_dkv(*args))
        ref = (flash_attention_backward_dq_plain(*args), *flash_attention_backward_dkv_plain(*args))
        scales = backward_scales(torch, *args)
        readings = read_backward(dtype_name, got, ref, scales)
        text = "; ".join(f"{name} {format_reading(r)}" for name, r in readings.items())
        label = f"B={batch} T={seq} H={heads} D={dim} {dtype_name} causal={causal} ({flash_route(q)})"
        if not all(r["ok"] for r in readings.values()):
            raise AssertionError(f"flash backward {label} exceeds {FLASH_BWD_TOL[dtype_name]}: {text}")
        if shape in FAULTY_BWD_SHAPES and dtype == torch.bfloat16:  # the check must reject a planted fault
            faulty = read_backward(dtype_name, (*faulty_backward(torch, *args), ref[2]), ref, scales)
            log(f"[flash_bwd] {label}, dS x 1.05 on every other tile (planted in the plain version): " +
                "; ".join(f"{name} {format_reading(faulty[name])} ok={faulty[name]['ok']}" for name in ("dq", "dk")))
            if faulty["dq"]["ok"] or faulty["dk"]["ok"]:
                raise AssertionError("flash backward check passed a dS that is 5% off on half the tiles")
        del got, ref, scales

        ms = {"dq": time_ms(torch, lambda: flash_attention_backward_dq(*args)),
              "dkv": time_ms(torch, lambda: flash_attention_backward_dkv(*args))}
        plain_ms = {"dq": time_ms(torch, lambda: flash_attention_backward_dq_plain(*args), budget_ms=100.0),
                    "dkv": time_ms(torch, lambda: flash_attention_backward_dkv_plain(*args), budget_ms=100.0)}
        library_ms = library_backward_ms(torch, q, k, v, dout, causal)
        host = ""
        if dtype == torch.bfloat16:  # the wrappers' host time per call: each pass, and the whole backward
            host = "; host_us " + " ".join(f"{name}={host_us(torch, fn):.1f}" for name, fn in (
                ("dq", lambda: flash_attention_backward_dq(*args)), ("dkv", lambda: flash_attention_backward_dkv(*args)),
                ("backward", lambda: flash_attention_backward(q, k, v, out, lse, dout, causal))))
        pairs = seq * (seq + 1) / 2 if causal else seq * seq  # query-key pairs this data needs
        element, rows = q.numel() * q.element_size(), batch * heads * seq * 4
        rate = peaks["fp32"] if dtype == torch.float32 else peaks["bf16"]
        operations = {"dq": 6.0 * batch * heads * dim * pairs, "dkv": 8.0 * batch * heads * dim * pairs}
        bounds = {"dq": bound_ms(operations["dq"], rate, 5 * element + 2 * rows, peaks["bytes"]),
                  "dkv": bound_ms(operations["dkv"], rate, 6 * element + 2 * rows, peaks["bytes"])}
        log(f"[flash_bwd] {label}: " + "; ".join(
            f"{kernel} ms={ms[kernel]:.4f} ({operations[kernel] / ms[kernel] / 1e9:.1f} TFLOP/s) "
            f"plain_ms={plain_ms[kernel]:.4f} bound_ms={bounds[kernel][0]:.4f} ({bounds[kernel][1]})"
            for kernel in ("dq", "dkv")) + f"; library (whole backward) ms={library_ms:.4f}{host}")
        log(f"[flash_bwd]   {text}")
        if shape == ALBERT_ATTENTION:  # the training path's shape
            for kernel, names in (("dq", ("dq",)), ("dkv", ("dk", "dv"))):
                entries[f"flash_attention_backward_{kernel}"] = dict(
                    max_abs_err=max(readings[n]["max_abs"] for n in names), ms=ms[kernel], plain_ms=plain_ms[kernel],
                    bound_ms=bounds[kernel][0], bound_by=bounds[kernel][1], library_ms=library_ms)
    views = [(f"q, k, v, dout of one fused [{b}, {t}, 4, {h}, {d}] bf16 tensor, causal={causal}",
              torch.from_numpy(rng.standard_normal((b, t, 4, h, d), dtype=np.float32)).cuda().bfloat16().unbind(2), causal)
             for (b, t, h, d), causal in STRIDED_CASES]
    views += [(f"q, k, v, dout bf16 {list(shape)} one element off 16-byte alignment, causal={causal}",
               [unaligned(torch, torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda().bfloat16())
                for _ in range(4)], causal) for shape, causal in UNALIGNED_CASES]
    for what, (q, k, v, dout), causal in views:
        out, lse = flash_attention_plain(q, k, v, causal)
        args = (q, k, v, dout, lse, _delta(out, dout), causal)
        got = (flash_attention_backward_dq(*args), *flash_attention_backward_dkv(*args))
        ref = (flash_attention_backward_dq_plain(*args), *flash_attention_backward_dkv_plain(*args))
        readings = read_backward("bfloat16", got, ref, backward_scales(torch, *args))
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


def compare_grads(torch, got: dict, ref: dict, limit: float, what: str) -> float:
    """The largest gradient error norm over reference norm; raises past ``limit``.
    The key bias (exact gradient 0) is held to 1% of the largest gradient instead."""
    largest = max(g.abs().max().item() for g in ref.values())
    worst, worst_name = 0.0, ""
    for name, g in ref.items():
        if name.endswith(ZERO_GRADIENT):
            if max(got[name].abs().max().item(), g.abs().max().item()) > 1e-2 * largest:
                raise AssertionError(f"{what}: {name} (exact gradient 0) is above 1% of the largest gradient")
            continue
        rel = ((got[name] - g).norm() / g.norm().clamp_min(1e-30)).item()
        if not rel <= worst:
            worst, worst_name = rel, name
    log(f"[train] {what}: largest gradient error norm / norm {worst:.3e} ({worst_name})")
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


def phase_train(torch, peaks, wrappers: dict) -> dict:
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
    for wrapper in wrappers.values():
        wrapper.launches = 0  # the main path starts here: the train steps
    losses = [train_step(batch) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    started = time.perf_counter()
    losses += [train_step(batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - started) * 1e3 / TRAIN_STEPS
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    losses = [loss.item() for loss in losses]
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
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

    wall_ms, families, rest = profile_step(torch, train_step, batch)
    busy = sum(ms for _, ms in families)
    log(f"[profile] one train step: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms ({busy / wall_ms:.1%})")
    for family, ms in families:
        log(f"[profile]   {ms:8.3f} ms  {family}")
    for kernel, ms in rest:
        log(f"[profile]     {ms:8.3f} ms  of the rest: {kernel[:100]}")

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


def write_checkpoint(path: Path, config: dict, seed: int) -> None:
    """A synthetic HF-layout Llama checkpoint in fp16 safetensors, one shard per layer
    and one for the embedding, final norm and LM head."""
    rng = np.random.default_rng(seed)
    hid, inner = config["hidden_size"], config["intermediate_size"]
    kv = config["num_key_value_heads"] * hid // config["num_attention_heads"]
    (path / "config.json").write_text(json.dumps(config))
    weight_map = {}
    for layer in range(config["num_hidden_layers"]):
        prefix = f"model.layers.{layer}."
        shapes = {
            "self_attn.q_proj.weight": (hid, hid), "self_attn.k_proj.weight": (kv, hid),
            "self_attn.v_proj.weight": (kv, hid), "self_attn.o_proj.weight": (hid, hid),
            "mlp.gate_proj.weight": (inner, hid), "mlp.up_proj.weight": (inner, hid),
            "mlp.down_proj.weight": (hid, inner),
        }
        tensors = {prefix + name: (rng.standard_normal(shape, dtype=np.float32) * np.float32(shape[1] ** -0.5))
                   for name, shape in shapes.items()}
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
    """Run every request through block 0 → block 1 of every mode concurrently, each
    block call inside a ``serving.request`` span as the connection handler opens
    one; returns {mode: [(output, latency_s), ...]}, the runtime's batch count,
    each pool's RecordedForward and the run's wall seconds. Returns once the
    runtime has counted every batch (it counts a batch after its callers' results)."""
    from hivemind_tpu_torch.moe.server.runtime import Runtime
    from hivemind_tpu_torch.moe.server.task_pool import TaskPool
    from hivemind_tpu_torch.telemetry import ensure_watchdog, trace
    from hivemind_tpu_torch.telemetry.serving import SERVING_SPAN

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

    async def chain(mode, index, x):
        started = time.perf_counter()
        for uid, pool in zip(backends_by_mode[mode], pools[mode]):
            with trace(SERVING_SPAN, kind="forward", expert=pool.name, peer="chip_smoke", client=f"request-{index}",
                       batch=int(x.shape[0])):
                (x,) = await pool.submit_task(x)
        return x, time.perf_counter() - started

    started = time.perf_counter()
    try:
        jobs = {mode: [chain(mode, i, x) for i, x in enumerate(requests)] for mode in pools}
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


def phase_serving(torch, checkpoint_dir: str, wrappers: dict, telemetry: Telemetry) -> dict:
    from hivemind_tpu_torch.moe.server.llama_loader import load_llama_blocks
    from hivemind_tpu_torch.telemetry.device import MEMORY_MONITOR
    from hivemind_tpu_torch.telemetry.serving import SERVING_LEDGER

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
    SERVING_LEDGER.clear()
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
        records=SERVING_LEDGER.records(), wall_s=wall_s, backlog=telemetry.backlog,
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
        cpu_blocks = load_llama_blocks(checkpoint_dir, device="cpu", weight_quantization=quantization)[0]
        for index, what in ((len(requests) - 1, "a batch of its own"), (merged_index, "a merged batch")):
            expected = requests[index]
            for backend in cpu_blocks.values():
                expected = backend.forward(expected)[0]
            rel_err = max_rel_err(results[mode][index][0], expected)
            log(f"[serving] {mode} card vs CPU plain path, [1, {requests[index].shape[1]}, {hid}] "
                f"({what}): max_rel_err={rel_err:.3e}")
            if not rel_err < SERVING_TOL:
                raise AssertionError(f"{mode}: card output differs from the CPU reference by {rel_err} >= {SERVING_TOL}")
        del cpu_blocks
    return launches


def phase_small_heads(torch, wrappers: dict) -> dict:
    """A served ``transformer`` expert of head_dim 32 on the card, through the SIMT
    flash kernel, against the same expert on the CPU (``plain_attention``)."""
    from hivemind_tpu_torch.moe.server.layers import name_to_block
    from hivemind_tpu_torch.moe.server.module_backend import ModuleBackend

    hid, heads, shape = SMALL_HEADS_EXPERT["hidden"], SMALL_HEADS_EXPERT["heads"], SMALL_HEADS_EXPERT["shape"]
    x = np.random.default_rng(SEED + 10).standard_normal(shape, dtype=np.float32)
    card = ModuleBackend("transformer.0", name_to_block["transformer"](hid, num_heads=heads, device="meta"),
                         sample_input=x, device="cuda", rng_seed=SEED)
    cpu = ModuleBackend("transformer.0", name_to_block["transformer"](hid, num_heads=heads, device="meta"),
                        sample_input=x, device="cpu", params={k: t.cpu() for k, t in card.snapshot_params().items()})
    torch.cuda.synchronize()
    for wrapper in wrappers.values():
        wrapper.launches = 0  # the main path starts here: one forward of the expert
    got = card.forward(x)[0]
    torch.cuda.synchronize()
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    rel_err = max_rel_err(got, cpu.forward(x)[0])
    log(f"[head_dim32] transformer expert hidden {hid}, {heads} heads, input {list(shape)}: "
        f"{launches['flash_attention_forward']} flash forward launch(es) on the card; card vs CPU (plain_attention) "
        f"max_rel_err={rel_err:.3e}")
    if not (got.shape == x.shape and np.isfinite(got).all() and rel_err < SERVING_TOL):
        raise AssertionError(f"head_dim-32 expert: output {got.shape}, card vs CPU {rel_err} >= {SERVING_TOL}")
    return launches


class LocalPipe:
    """``decode_step`` chained over a server's block uids through its
    DecodeSessionManager (the stand-in for the transport slice's remote pipe), each
    block call inside a ``serving.request`` span as the connection handler opens
    one; notes each call's wall time and output, and the activation bytes its block
    calls carry to the card and back."""

    def __init__(self, manager, uids):
        self.manager, self.uids, self.calls = manager, list(uids), []
        self.block_calls = self.bytes_in = self.bytes_out = 0

    def decode_step(self, hidden, session_id, reset=False):
        from hivemind_tpu_torch.telemetry import trace
        from hivemind_tpu_torch.telemetry.serving import SERVING_SPAN

        x = hidden.cpu().numpy() if hasattr(hidden, "cpu") else np.asarray(hidden, np.float32)
        started = time.perf_counter()
        for uid in self.uids:
            self.bytes_in += np.asarray(x, np.float32).nbytes
            with trace(SERVING_SPAN, kind="decode", expert=uid, peer="chip_smoke", client=session_id):
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


def phase_decode(torch, checkpoint_dir: str, wrappers: dict, peaks: dict, telemetry: Telemetry) -> dict:
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
    merged = {mode: [] for mode in modes}
    for mode, manager in managers.items():  # a recorder on the merged step: how many sessions each call held
        batched_step = manager._batched_step
        manager._batched_step = (lambda step, sizes: lambda uid, x, *args: sizes.append(x.shape[0]) or step(uid, x, *args))(
            batched_step, merged[mode])
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
        replay = forward_chain(backends[mode], head.embed(ids[:, :-1]).cpu().numpy())
        logits = head.logits(replay[:, DECODE_PROMPT - 1 :]).cpu().numpy()[0]
        chosen = logits[np.arange(DECODE_NEW), ids[0, DECODE_PROMPT:]]
        gaps = (logits.max(axis=-1) - chosen) / np.maximum(np.abs(logits.max(axis=-1)), 1.0)
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
        # the hooks' cost: spans and registry updates, on and off
        decode_readings[mode]["hooks"] = hooks_cost(pipe, head, prompt, token)

    # the prefill and the first step against the CPU plain path
    for mode, quantization in modes.items():
        cpu_blocks = load_llama_blocks(checkpoint_dir, device="cpu", weight_quantization=quantization)[0]
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
    """The served path's telemetry after [serving] and [decode], held to exact
    counts; then where the host time of a request and of a decode step goes."""
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
    records = serving["records"]
    check(len(records) == requests * len(pools), f"{len(records)} serving records, {requests * len(pools)} requests")
    unsound = [r for r in records if not (r.get("compute_s", 0.0) > 0 and r.get("queue_wait_s", 0.0) + r.get("assembly_s", 0.0)
                                         + r.get("compute_s", 0.0) <= r["total_s"] + PHASE_ROUNDING_S)]
    check(not unsound, f"records whose phases exceed the span or carry no compute: {unsound[:2]}")
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

    for mode in ("fp", "int8"):
        mine = [r for r in records if r["expert"].startswith(f"{mode}:")]
        phases = {field: [r.get(field, 0.0) for r in mine] for field in ("queue_wait_s", "assembly_s", "compute_s", "total_s")}
        log(f"[telemetry] serving {mode}: {len(mine)} block requests, median / p90: queue wait "
            f"{median_p90(phases['queue_wait_s'])}, batch assembly {median_p90(phases['assembly_s'])}, device compute "
            f"{median_p90(phases['compute_s'])}, request wall {median_p90(phases['total_s'])}; phases "
            f"{sum(map(sum, (phases[f] for f in ('queue_wait_s', 'assembly_s', 'compute_s')))) / sum(phases['total_s']):.1%}"
            f" of the requests' wall")
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
        deltas, (bounds, lag), hooks = reading["deltas"], reading["lag"], reading.get("hooks", {})
        moved = deltas["host_to_device"] + deltas["device_to_host"]
        cost = ""
        if hooks:
            cost = (f"; hooks: solo per-token median with every hook {hooks['all'] * 1e3:.4f} ms, spans off "
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


def main() -> int:
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
    }
    # each path, and the kernels that must launch in its run
    path_kernels = {
        "serving": ("flash_attention_forward", "blockwise_int8_quantize", "blockwise_int8_dequantize"),
        "expert_backward": ("flash_attention_forward", "flash_attention_backward_dq", "flash_attention_backward_dkv"),
        "train": ("flash_attention_forward", "flash_attention_backward_dq", "flash_attention_backward_dkv"),
        "head_dim32": ("flash_attention_forward",),
        "decode": ("blockwise_int8_dequantize",),
    }

    line = card_line()
    log(f"[card] {line}")
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

    def run(phase: str, fn, *args):
        started = time.perf_counter()
        try:
            return fn(*args)
        except Exception as e:  # every phase runs; the failures are listed at the end
            failures.append(f"[{phase}] {type(e).__name__}: {e}")
            log(f"[{phase}] FAILED: {type(e).__name__}: {e}")
        finally:
            log(f"[time] {phase}: {time.perf_counter() - started:.1f} s")

    try:
        run("build", phase_build, torch, telemetry)
        entries["flash_attention_forward"] = run("flash", phase_flash, torch, peaks)
        entries["blockwise_int8_quantize"], entries["blockwise_int8_dequantize"] = (
            run("quantize", phase_quantization, torch, peaks) or (None, None))
        entries.update(run("flash_bwd", phase_flash_bwd, torch, peaks) or {})
        run("checkpoint", write_checkpoint, Path(checkpoint.name), LLAMA2_7B, SEED + 3)
        path_launches["serving"] = run("serving", phase_serving, torch, checkpoint.name, wrappers, telemetry)
        path_launches["head_dim32"] = run("head_dim32", phase_small_heads, torch, wrappers)
        path_launches["decode"] = run("decode", phase_decode, torch, checkpoint.name, wrappers, peaks, telemetry)
        run("telemetry", phase_telemetry, torch, telemetry, exporter.port)
        path_launches["expert_backward"] = run("expert_backward", phase_expert_backward, torch, checkpoint.name, wrappers)
        path_launches["train"] = run("train", phase_train, torch, peaks, wrappers)
    finally:
        checkpoint.cleanup()
        exporter.shutdown()

    for path, kernels in path_kernels.items():
        counts = path_launches.get(path)
        if counts is None:
            continue
        log(f"[launches] {path} path: {json.dumps(counts)}")
        missing = [kernel for kernel in kernels if counts[kernel] <= 0]
        if missing:
            failures.append(f"[launches] kernels never launched on the {path} path: {missing}")
    if failures:
        print("chip_smoke: failed phases:\n" + "\n".join(failures), file=sys.stderr)
        return 1

    meta = {
        "flash_attention_forward": ("hivemind_tpu_torch/csrc/flash_attention.cu", "hivemind_tpu/ops/pallas_attention.py:108"),
        "flash_attention_backward_dq": ("hivemind_tpu_torch/csrc/flash_attention_bwd.cu", "hivemind_tpu/ops/pallas_attention.py:279"),
        "flash_attention_backward_dkv": ("hivemind_tpu_torch/csrc/flash_attention_bwd.cu", "hivemind_tpu/ops/pallas_attention.py:292"),
        "blockwise_int8_quantize": ("hivemind_tpu_torch/csrc/blockwise_int8.cu", "hivemind_tpu/ops/pallas_quantization.py:46"),
        "blockwise_int8_dequantize": ("hivemind_tpu_torch/csrc/blockwise_int8.cu", "hivemind_tpu/ops/pallas_quantization.py:73"),
    }
    kernels = [
        {"name": kernel, "route": "cuda", "source": meta[kernel][0], "replaces": meta[kernel][1],
         "launches": sum(counts[kernel] for counts in path_launches.values()), **entries[kernel]}
        for kernel in wrappers
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
