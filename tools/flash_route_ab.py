#!/usr/bin/env python3
"""The flash kernels' designs timed against the SIMT design on one card, in one process.

For each input, each pass the wrappers route to a redesign of SIMT (wgmma: all three
passes, on the 4-D view at a 16-bit head dim that is a multiple of 8 and on the
packed-heads view at any other whose H·D is one, and the forward and dK/dV pass on the
copied-rows view at every other 16-bit head dim; tf32x3: all three fp32 passes at a head
dim from 16 to 128 that is a multiple of 4; a pass that is SIMT for the input is noted and
not timed) runs through its wrapper
(``flash_attention_lse``, ``flash_attention_backward_dq``, ``flash_attention_backward_dkv``)
and through the SIMT kernel's C entry point on the same tensors, in turns (SIMT, route,
route, SIMT), each held to the plain PyTorch version first. Each line gives both
designs' device times (CUDA events behind a spin kernel, as ``chip_smoke.py``'s), the
least time the card could take (``bound_ms``, ``chip_smoke.flash_bound``) and the
library's (``F.scaled_dot_product_attention``; for a backward pass its whole backward).
The last line is a JSON object with every reading, beside the card's name and power
limit.

``--rows`` times instead the three passes through their wrappers alone at the shapes
of PERF.md's rows 1-3, 1c-3c, 1h-3h, 1p-3p, 1t-3t and 1x, 3x, and ``--root DIR`` imports the package and
``chip_smoke.py`` from another checkout: run on the parent's and this checkout's in
turns in one call, it compares two versions of the kernels on one card.

Run from the repository root on a machine with one NVIDIA card:

    python3 tools/flash_route_ab.py
    python3 tools/flash_route_ab.py --cases 2,1000,16,32,bfloat16,1 1,2048,16,256,float16,1
    python3 tools/flash_route_ab.py --cases 32,512,12,64,float32,0 1,2048,32,128,float32,1
    for root in parent . . parent; do python3 tools/flash_route_ab.py --rows --root $root; done
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

# (shape, dtype, causal): the three shapes PERF.md timed the SIMT kernels at (rows 1s, 3s),
# head_dim 16 (padded 4x by the wgmma design), Phi-2's and Gemma-7B's widths and fp16 at a
# Llama-2-7B request of 2048 tokens; then the packed-heads view: head dim 20 at row 1s's
# shape, the TinyBERT-width expert's attention (12 heads of 26), an odd head dim, and fp16 at
# 196 (padded to 256); then fp32 on the three 3xTF32 passes: ALBERT's training shape, a Llama-2-7B
# request of 2048 tokens and PERF.md rows 2t's and 3t's [1, 512, 32, 128] causal; then the
# copied-rows view (forward and dK/dV): head dim 20 with H·D = 100 and fp16 21 with H·D = 63
DEFAULT_CASES = [
    ((2, 1000, 16, 32), "bfloat16", True), ((1, 512, 8, 96), "bfloat16", True), ((1, 512, 4, 256), "float16", True),
    ((2, 1000, 16, 16), "bfloat16", True), ((1, 2048, 32, 80), "bfloat16", True),
    ((1, 2048, 16, 256), "float16", True), ((1, 2048, 32, 128), "float16", True),
    ((2, 1000, 16, 20), "bfloat16", True), ((4, 128, 12, 26), "bfloat16", False), ((2, 1000, 16, 25), "bfloat16", True),
    ((1, 512, 4, 196), "float16", True),
    ((32, 512, 12, 64), "float32", False), ((1, 2048, 32, 128), "float32", True), ((1, 512, 32, 128), "float32", True),
    ((2, 1000, 5, 20), "bfloat16", True), ((2, 1000, 3, 21), "float16", True),
]


# PERF.md's rows, (row, pass, shape, causal, dtype): 1 (forward), 2 and 3 (dQ, dK/dV) at the
# served and ALBERT's shapes, 1c-3c at the causal LM's; 1h-3h at their six shapes (three small
# ones, Phi-2's, Gemma-7B's and Llama-2-7B's fp16); 1p-3p on the packed-heads view; 1t-3t in fp32;
# 1x and 3x on the copied-rows view (SIMT before it)
_H_SHAPES = [((2, 1000, 16, 32), "bfloat16"), ((1, 512, 8, 96), "bfloat16"), ((1, 512, 4, 256), "float16"),
             ((1, 2048, 32, 80), "bfloat16"), ((1, 2048, 16, 256), "float16"), ((1, 2048, 32, 128), "float16")]
ROWS = ([("1", "forward", (1, 2048, 32, 128), True, "bfloat16"), ("1", "forward", (32, 512, 12, 64), False, "bfloat16"),
         ("1c", "forward", (8, 1024, 12, 64), True, "bfloat16"),
         ("2", "dq", (32, 512, 12, 64), False, "bfloat16"), ("2c", "dq", (8, 1024, 12, 64), True, "bfloat16"),
         ("3", "dkv", (32, 512, 12, 64), False, "bfloat16"), ("3c", "dkv", (8, 1024, 12, 64), True, "bfloat16")]
        + [(f"{n}h", which, shape, True, dtype) for n, which in (("1", "forward"), ("2", "dq"), ("3", "dkv"))
           for shape, dtype in _H_SHAPES]
        + [(f"{n}p", which, shape, causal, "bfloat16") for n, which in (("1", "forward"), ("2", "dq"), ("3", "dkv"))
           for shape, causal in (((2, 1000, 16, 20), True), ((4, 128, 12, 26), False))]
        + [("1t", "forward", (32, 512, 12, 64), False, "float32"),
           ("1t", "forward", (1, 2048, 32, 128), True, "float32")]
        + [(f"{n}t", which, shape, causal, "float32") for n, which in (("2", "dq"), ("3", "dkv"))
           for shape, causal in (((32, 512, 12, 64), False), ((1, 512, 32, 128), True))]
        + [("1x", "forward", (2, 1000, 5, 20), True, "bfloat16"), ("3x", "dkv", (2, 1000, 5, 20), True, "bfloat16")])


def time_rows(torch, smoke, flash) -> list:
    """Each of ROWS through its wrapper alone, on tensors drawn from one seed."""
    rng = np.random.default_rng(smoke.SEED + 21)
    readings = []
    for row, which, shape, causal, dtype_name in ROWS:
        dtype = getattr(torch, dtype_name)
        q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda().to(dtype) for _ in range(4))
        if which == "forward":
            fn = lambda: flash.flash_attention_lse(q, k, v, causal)  # noqa: E731
        else:
            out, lse = flash.flash_attention_plain(q, k, v, causal)
            args = (q, k, v, dout, lse, flash._delta(out, dout), causal)
            wrapper = flash.flash_attention_backward_dq if which == "dq" else flash.flash_attention_backward_dkv
            fn = lambda: wrapper(*args)  # noqa: E731
        ms = smoke.time_ms(torch, fn)
        print(f"[rows] {row} {which} {list(shape)} {dtype_name} causal={causal} ({flash.flash_route(q, which)}): "
              f"ms={ms:.4f}", flush=True)
        readings.append(dict(row=row, which=which, shape=list(shape), dtype=dtype_name, causal=causal, ms=ms))
    return readings


def parse_case(text: str):
    batch, seq, heads, dim, dtype, causal = text.split(",")
    return (int(batch), int(seq), int(heads), int(dim)), dtype, bool(int(causal))


def turns(torch, time_ms, simt, route) -> dict:
    """SIMT, the route, the route, SIMT: each design's mean of its two readings, and all four."""
    readings = [time_ms(torch, fn) for fn in (simt, route, route, simt)]
    return dict(simt_ms=(readings[0] + readings[3]) / 2, route_ms=(readings[1] + readings[2]) / 2, turns=readings)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cases", nargs="*", type=parse_case, default=DEFAULT_CASES,
                        help="B,T,H,D,dtype,causal each (dtype bfloat16, float16 or float32; causal 0 or 1)")
    parser.add_argument("--rows", action="store_true", help="time PERF.md's rows (ROWS) through the wrappers instead")
    parser.add_argument("--root", default=str(ROOT), help="the checkout whose package and chip_smoke.py to import")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_route_ab: no CUDA device is available; it times kernels on the card", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from hivemind_tpu_torch.ops import flash_attention as flash

    if args.rows:
        print(json.dumps({"card": smoke.card_line(), "root": args.root, "rows": time_rows(torch, smoke, flash)}))
        return 0
    name = torch.cuda.get_device_name(0)
    peaks = smoke.card_peaks(name)
    rng = np.random.default_rng(smoke.SEED + 20)
    results = []
    for shape, dtype_name, causal in args.cases:
        batch, seq, heads, dim = shape
        dtype = getattr(torch, dtype_name)
        q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda().to(dtype)
                         for _ in range(4))
        label = f"B={batch} T={seq} H={heads} D={dim} {dtype_name} causal={causal} ({flash.flash_routes(q)})"
        pairs = seq * (seq + 1) / 2 if causal else seq * seq
        element, rows = q.numel() * q.element_size(), batch * heads * seq * 4

        # forward: both designs held to the plain version, then timed in turns
        passes = {}
        route = flash.flash_route(q, "forward")
        if route == "simt":
            print(f"[ab] {label} forward: SIMT alone (the wrapper's route); not timed", flush=True)
        else:
            reference = smoke.plain_forward(torch, q, k, v, causal)
            run_simt = smoke.simt_forward(torch, q, k, v)
            for design, (out, lse) in ((route, flash.flash_attention_lse(q, k, v, causal)), ("simt", run_simt(causal))):
                out_reading, lse_reading = smoke.read_forward(out, lse, reference, dtype_name)
                if not (out_reading["ok"] and lse_reading["ok"]):
                    raise AssertionError(f"{design} forward {label}: {smoke.format_reading(out_reading)}; "
                                         f"lse {smoke.format_reading(lse_reading)}")
            del reference
            forward = turns(torch, smoke.time_ms, lambda: run_simt(causal),
                            lambda: flash.flash_attention_lse(q, k, v, causal))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            forward["library_ms"] = smoke.time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                                                is_causal=causal))
            forward["bound_ms"], forward["bound_by"] = smoke.flash_bound(
                torch, peaks, dtype, 4.0 * batch * heads * dim * pairs, 4 * element + rows)["bound"]
            passes["forward"] = dict(route=route, **forward)

        # the dQ and dK/dV passes the wrappers route to a redesign, likewise, from the plain
        # forward's (out, lse); the library's time is its whole backward's, beside each pass
        out, lse = flash.flash_attention_plain(q, k, v, causal)
        delta = flash._delta(out, dout)
        args_ = (q, k, v, dout, lse, delta, causal)
        scales = smoke.backward_scales(torch, *args_)
        library_ms = smoke.library_backward_ms(torch, q, k, v, dout, causal)
        for which, wrapper, plain, operations, nbytes, outputs in (
                ("dq", flash.flash_attention_backward_dq, flash.flash_attention_backward_dq_plain, 6.0,
                 5 * element + 2 * rows, slice(0, 1)),
                ("dkv", flash.flash_attention_backward_dkv, flash.flash_attention_backward_dkv_plain, 8.0,
                 6 * element + 2 * rows, slice(1, 3))):
            route = flash.flash_route(q, which)
            if route == "simt":
                print(f"[ab] {label} {which}: SIMT alone (the wrapper's route); not timed", flush=True)
                continue
            as_tuple = (lambda result: (result,)) if which == "dq" else tuple
            ref = as_tuple(plain(*args_))
            run_simt = smoke.simt_backward(torch, which, q, k, v, dout, lse, delta)
            for design, got in ((route, as_tuple(wrapper(*args_))), ("simt", run_simt(causal))):
                tol = smoke.FLASH_BWD_TOL[dtype_name]
                readings = [smoke.error_reading(g, r, sc, tol, smoke.MANTISSA_BITS[dtype_name])
                            for g, r, sc in zip(got, ref, scales[outputs])]
                if not all(r["ok"] for r in readings):
                    raise AssertionError(f"{design} {which} {label}: " + "; ".join(map(smoke.format_reading, readings)))
            del ref
            passes[which] = dict(route=route, **turns(torch, smoke.time_ms, lambda: run_simt(causal),
                                                        lambda: wrapper(*args_)))
            passes[which]["library_ms"] = library_ms
            passes[which]["bound_ms"], passes[which]["bound_by"] = smoke.flash_bound(
                torch, peaks, dtype, operations * batch * heads * dim * pairs, nbytes)["bound"]
        del scales
        for what, reading in passes.items():
            print(f"[ab] {label} {what}: simt_ms={reading['simt_ms']:.4f} {reading['route']}_ms={reading['route_ms']:.4f} "
                  f"({reading['simt_ms'] / reading['route_ms']:.2f}x) library_ms={reading['library_ms']:.4f} "
                  f"bound_ms={reading['bound_ms']:.4f} ({reading['bound_by']}); turns "
                  + " ".join(f"{t:.4f}" for t in reading["turns"]), flush=True)
        results.append(dict(shape=list(shape), dtype=dtype_name, causal=causal, **passes))
    print(json.dumps({"card": smoke.card_line(), "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
