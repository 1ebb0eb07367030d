#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``rafiki_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It imports nothing of JAX or of ``rafiki_tpu``. In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every kernel of the port from ``rafiki_torch/ops/csrc`` (one
   ``nvcc`` per source, in parallel) and prints the build time and each
   kernel's registers and spills;
3. kernel phase, forward: runs K1 (``flash_fwd.cu``) against its plain
   PyTorch version ``flash_attention_reference`` on the card at the
   flagship shape and at ragged, cross, ``kv_mask``, f32 and small-head
   shapes, comparing ``o`` and ``lse`` with the tolerances stated below:
   every bf16 case on both bf16 variants, ``wgmma`` (which
   ``flash_attention`` must pick there) and ``mma_sync`` (forced), f32 on
   ``f32``. It times the two bf16 variants in turns (mma.sync, wgmma,
   wgmma, mma.sync), the plain version and, as a yardstick only,
   ``torch.nn.functional.scaled_dot_product_attention``, and the host's
   cost of one K1 launch of each variant;
4. kernel phase, backward: runs K2 (``flash_bwd_dq.cu``) and K3
   (``flash_bwd_dkv.cu``) against their plain versions at the flagship
   train shape (8, 16, 2048, 2048, 128) and at ragged, cross causal,
   ``kv_mask`` (one example fully padded), head_dim 80 and f32 shapes:
   every bf16 case on both bf16 variants, ``wgmma`` (which the backward
   must pick there) and ``mma_sync`` (forced), f32 on ``f32``; checks
   that two launches of the wgmma variants give bitwise-equal dq, dk and
   dv at the train shape; holds K1's wgmma variant against its plain
   version at the train shape too; and times K2's and K3's two bf16
   variants in turns (mma.sync, wgmma, wgmma, mma.sync) as CUDA graphs,
   their plain versions and, as the yardstick, ``torch.autograd.grad`` of
   ``scaled_dot_product_attention`` (dq, dk and dv together, so its time
   covers K2 and K3 at once), and K1's two bf16 variants in turns beside
   ``scaled_dot_product_attention``;
5. train phase: trains ``TorchTransformerLM`` at flagship width
   (d_model 2048, 16 heads of 128, 8 layers, seq_len 2048, vocab 32768,
   batch 8, ``remat`` "dots", initialised on the card from the ``seed``
   knob) for 16 steps, two chunks of 8, on a synthetic Markov token
   stream; checks that every logged loss is finite, that the second
   chunk's mean loss is below the first's, and the launches per step
   (K2 and K3 once per layer, K1 twice: the forward and its rerun under
   "dots", every launch of the three on its wgmma variant); prints the
   step time, tokens
   per second, ``chip_util`` and
   peak memory; profiles one step; and holds one step's loss and
   gradients against the same step on ``flash_attention_plain``;
6. serve phase: serves the trained parameters (``dump_parameters()``)
   through ``InferenceWorker`` and the predictor's ``POST /predict`` on
   a local port, checks every score, times a window of some hundreds of
   scored queries sent by several clients at once, checks that the K1
   launch count grew by ``n_layers`` per scored query, all on the wgmma
   variant, and that K2 and K3 never ran, and holds the served scores
   against the same model with
   attention switched to the plain version;
7. generate phase, on the trained parameters: builds the paged-KV
   engine (``make_generator``, the decode step captured as a CUDA graph)
   and checks (1) greedy decoding against the full forward (K1) over the
   same prefix at every step, (2) one prefill per bucket from 32 to 4096
   rows against the same prefill on the plain attention, its last
   logits and every layer's K and V rows (and on K1 reading K/V one row
   late, a planted fault the rows' limit must see), with
   K1's launches (``n_layers`` a prefill, all wgmma; none for a prefix
   hit or a decode step), K1's own output at each bucket's shape against
   its plain version and K1's time there, (5) a sampled request
   giving the same tokens alone and packed with seven others, and (6)
   the decode step's time as a graph replay and eagerly beside its byte
   bound, the graph's result bit for bit the eager step's, and a profile
   of the step; then sends (3) a window of 64 ``POST /generate``
   requests from 8 clients and (4) four requests to a small engine that
   must preempt, checking every NDJSON stream, and prints tokens per
   second, time to first token, inter-token latency, decode steps, live
   lanes a step and prefills skipped;
8. prints a ``{"kernels": [...]}`` line, in which ``library_covers``
   names the kernels whose work one library call does, and, last, the
   ``{"ok": true, "device": ...}`` line.

Any failed check exits non-zero without the last line.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
import traceback
import urllib.error
import urllib.request

SEED = 0
FLAGSHIP = {"d_model": 2048, "n_layers": 8, "seq_len": 2048,
            "vocab_size": 32768, "batch_size": 8, "learning_rate": 3e-4,
            "train_steps": 100, "quick_train": False}
# Two chunks of steps_per_dispatch = 8 (below the knob's floor of 20, so
# set after validation).
TRAIN_STEPS = 16
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# |kernel - plain| <= atol + rtol * |plain|. bf16: both outputs are f32
# sums taken in another order and rounded to bf16, so they may differ by
# up to two bf16 ulps (2 * 2^-7 relative). f32: summation order only.
# lse is f32 in both dtypes.
TOL_O = {"bfloat16": (1e-3, 1.6e-2), "float32": (1e-5, 1e-5)}
TOL_LSE = (1e-4, 1e-6)
# K2 and K3 against their plain versions: |kernel - plain| <= a·max|plain|
# + rtol·|plain|. Each gradient sums up to T products with p or ds rounded
# to bf16; where the kernel's exp and the plain version's round an
# intermediate to neighbouring bf16 values, a term moves by one bf16 ulp,
# and the output is rounded to bf16 once. f32: summation order only.
TOL_GRAD = {"bfloat16": (1e-2, 1.6e-2), "float32": (1e-5, 1e-4)}
# One train step on the kernels against the same step on the plain
# versions, same weights and windows: the loss, and each parameter's
# gradient as relative Frobenius error. The attention outputs and
# gradients differ by bf16 ulps per layer, carried through eight layers
# of a bf16 residual stream.
TOL_STEP_LOSS = 1e-2
TOL_STEP_GRAD = 3e-2
# Served scores against the plain-attention run of the same model: the
# attention outputs differ by bf16 ulps per layer, carried through eight
# layers of a bf16 residual stream, then averaged over the query's tokens.
TOL_SCORE = 2e-2
# The throughput window: single-query requests of 2 to seq_len + 1 ids,
# sent by this many client threads at once.
WINDOW_REQUESTS = 384
WINDOW_CLIENTS = 8
# The generate phase's engine: 8 lanes of 144 page slots (2304 tokens:
# seq_len plus the generation cap) take 1152 pages; a page holds 8
# layers x 16 tokens x 2048 x 2 bytes x (K, V) = 1 MiB.
GEN_ENGINE = {"page_size": 16, "n_pages": 1280, "decode_batch": 8,
              "max_new_cap": 256, "prefix_cache_entries": 16}
# The decode step's logits against the full forward over the same
# prefix, atol and rtol: the reference's own decode tolerance
# (tests/test_lm_generate.py). The greedy token may part from the full
# forward's argmax only where the latter's top-2 gap is below twice the
# atol.
TOL_LOGITS = (0.08, 0.05)
NEAR_TIE = 0.16
# A prefill on K1 against the same prefill on the plain attention. Its
# last logits, absolute: two bf16 ulps at the logits' magnitude (4 to 8
# in the trained flagship); the unembedding rounds each logit to bf16, and
# the attention outputs' ulp differences move a logit by one ulp (0.03125
# at every bucket on the H100). The logits of the trained flagship hardly
# depend on its attention: K1 reading K/V one row late moves them by that
# same ulp. So every layer's K and V rows, which decoding reads, are held
# too: max |diff| over the layer's max |x| within two bf16 ulps (2^-6).
# On the H100 the kernels stay within one ulp (at most 7.7e-3) and the
# planted late read moves the rows by 0.13 to 0.19; both are printed.
TOL_PREFILL = 0.0625
TOL_KV = 2 ** -6
# One prompt for each prefill bucket (32 to 4096 rows).
PREFILL_LENGTHS = (17, 33, 65, 129, 257, 513, 1025, 2100)
# The window of streamed requests.
GEN_REQUESTS = 64
GEN_CLIENTS = 8


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """Registers and spills of each kernel in an ``nvcc -Xptxas -v``
    log, as ``kernel<head dim>: N registers, S spill bytes``."""
    out, name, spill = [], "?", 0
    for line in log.splitlines():
        # The mangled name: <length><kernel name>ILi<head dim>E.
        entry = re.search(r"Compiling entry function '\S*?(?<=\d)"
                          r"(flash_\w+?_kernel)ILi(\d+)E", line)
        if entry:
            name = f"{entry.group(1)}<{entry.group(2)}>"
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if spills:
            spill = int(spills.group(1)) + int(spills.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out.append(f"{name}: {regs.group(1)} registers, {spill} spill "
                       f"bytes")
    return "; ".join(out)


def build_warnings(log: str) -> list:
    """The warning lines of an ``nvcc -Xptxas -v`` log, and the C75xx
    lines (printed as info) with which ptxas says it serialised the
    ``wgmma``s."""
    return [line.strip() for line in log.splitlines()
            if "arning" in line or "C75" in line]


def time_ms(torch, fn, n: int) -> float:
    """Mean device time of ``fn`` over ``n`` runs, after a warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(torch, fn, n: int) -> float:
    """Mean device time of ``fn`` over ``n`` runs captured in one CUDA
    graph: the host's cost of a launch (tens of microseconds through the
    Python wrapper, near K1's own time at the serve shape) stays out."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    del graph
    torch.cuda.empty_cache()
    return ms


def host_us(torch, fn, n: int = 200) -> float:
    """The host's cost of one call of ``fn``: wall time of ``n`` calls
    without a synchronise, divided by ``n``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def k1_variants(torch, attn, q, k, v, n: int):
    """K1's two bf16 variants on q, k, v (causal), timed in turns
    (mma.sync, wgmma, wgmma, mma.sync) as CUDA graphs; returns the mean
    ms of each."""
    fns = {x: (lambda x=x: attn._flash_forward(q, k, v, True, None,
                                               variant=x))
           for x in ("wgmma", "mma_sync")}
    runs = {"wgmma": [], "mma_sync": []}
    for x in ("mma_sync", "wgmma", "wgmma", "mma_sync"):
        runs[x].append(graph_ms(torch, fns[x], n))
    return {x: sum(r) / len(r) for x, r in runs.items()}, fns


def causal_pairs(tq, tkv, causal):
    """The (query, key) pairs the mask lets through (end-aligned)."""
    if not causal:
        return tq * tkv
    shift = tkv - tq
    return sum(min(tkv, max(0, r + shift + 1)) for r in range(tq))


def bound(flops, nbytes, esize):
    """(ms, 'bytes' | 'operations'): the least time for this work on the
    card: the larger of the operations over the peak rate of their type
    and the bytes over the memory rate."""
    peak = PEAK_BF16_FLOPS if esize == 2 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attention_bound(b, h, tq, tkv, d, causal, esize):
    """K1: two products (2 FLOP a multiply-add) over the unmasked pairs;
    q, k, v read once, o and lse written once."""
    flops = 4.0 * b * h * causal_pairs(tq, tkv, causal) * d
    nbytes = esize * b * h * (2 * tq + 2 * tkv) * d + 4 * b * h * tq
    return bound(flops, nbytes, esize)


def backward_bounds(b, h, tq, tkv, d, causal, esize):
    """K2 (three products; writes dq) and K3 (four products; writes dk
    and dv): each reads q, k, v, do, lse and delta once."""
    pairs = causal_pairs(tq, tkv, causal)
    read = esize * b * h * (2 * tq + 2 * tkv) * d + 8 * b * h * tq
    k2 = bound(6.0 * b * h * pairs * d, read + esize * b * h * tq * d, esize)
    k3 = bound(8.0 * b * h * pairs * d, read + 2 * esize * b * h * tkv * d,
               esize)
    return k2, k3


def kernel_phase(torch, attn):
    """K1 against its plain version; returns the flagship numbers."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    # name, B, H, Tq, Tkv, D, dtype, causal, kv_mask lengths (None = none)
    cases = [
        ("flagship", 1, 16, 2048, 2048, 128, bf16, True, None),
        ("ragged", 2, 4, 1000, 1000, 128, bf16, True, None),
        ("cross causal", 2, 4, 300, 1000, 128, bf16, True, None),
        ("cross", 2, 4, 1000, 300, 64, bf16, False, None),
        ("kv_mask causal", 3, 4, 700, 700, 128, bf16, True, [700, 333, 0]),
        ("kv_mask", 3, 4, 257, 700, 128, bf16, False, [700, 333, 0]),
        ("head_dim 80", 2, 2, 130, 130, 80, bf16, True, None),
        ("f32 causal", 2, 4, 500, 500, 128, f32, True, None),
        ("f32 kv_mask", 3, 2, 257, 300, 48, f32, False, [300, 100, 0]),
    ]
    flagship = None
    for name, b, h, tq, tkv, d, dt, causal, lengths in cases:
        q = torch.randn(b, h, tq, d, device="cuda", generator=gen).to(dt)
        k = torch.randn(b, h, tkv, d, device="cuda", generator=gen).to(dt)
        v = torch.randn(b, h, tkv, d, device="cuda", generator=gen).to(dt)
        mask = None
        if lengths is not None:
            mask = (torch.arange(tkv, device="cuda")[None, :]
                    < torch.tensor(lengths, device="cuda")[:, None])
        ro, rl = attn.flash_attention_reference(q, k, v, causal=causal,
                                                kv_mask=mask,
                                                return_lse=True)
        auto = "wgmma" if dt == bf16 else "f32"
        check(attn.flash_forward_variant(q, k, v) == auto,
              f"K1 would take {attn.flash_forward_variant(q, k, v)} for "
              f"{name}, not {auto}")
        for variant in ((auto, "mma_sync") if dt == bf16 else (auto,)):
            total = attn.flash_attention.launches
            count = attn.flash_attention.variant_launches[variant]
            if variant == auto:
                o, lse = attn.flash_attention(q, k, v, causal=causal,
                                              kv_mask=mask, return_lse=True)
            else:
                o, lse = attn._flash_forward(q, k, v, causal, mask,
                                             variant=variant)
            torch.cuda.synchronize()
            check(attn.flash_attention.launches == total + 1
                  and attn.flash_attention.variant_launches[variant]
                  == count + 1, f"K1 {variant} did not launch ({name})")
            err_o = (o.float() - ro.float()).abs()
            err_l = (lse - rl).abs()
            atol, rtol = TOL_O[str(dt).split(".")[1]]
            ok_o = bool((err_o <= atol + rtol * ro.float().abs()).all())
            ok_l = bool((err_l <= TOL_LSE[0] + TOL_LSE[1] * rl.abs()).all())
            print(f"kernel K1 {variant:8s} {name:15s} ({b},{h},{tq},{tkv},"
                  f"{d}) {str(dt)[6:]:8s} causal={causal!s:5s} "
                  f"mask={lengths is not None!s:5s} "
                  f"max|do|={err_o.max().item():.3e} "
                  f"max|dlse|={err_l.max().item():.3e} "
                  f"{'ok' if ok_o and ok_l else 'MISMATCH'}", flush=True)
            check(ok_o and ok_l,
                  f"K1 {variant} disagrees with its plain version ({name})")
            check(bool(torch.isfinite(o.float()).all()),
                  f"K1 {variant} non-finite ({name})")
            if name == "flagship" and variant == "wgmma":
                flagship = (q, k, v, float(err_o.max()))

    q, k, v, err = flagship
    b, h, t, d = q.shape
    ms, fns = k1_variants(torch, attn, q, k, v, 50)
    plain_ms = time_ms(torch, lambda: attn.flash_attention_reference(
        q, k, v, causal=True), 5)
    lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 50)
    host = {x: host_us(torch, fn) for x, fn in fns.items()}
    bound_ms, bound_by = attention_bound(b, h, t, t, d, True, 2)
    tf = {x: 4.0 * b * h * (t * (t + 1) / 2) * d / (m * 1e-3) / 1e12
          for x, m in ms.items()}
    print(f"kernel K1 flagship (1,16,2048,2048,128) bf16 causal, CUDA-graph "
          f"device time: wgmma {ms['wgmma']:.4f} ms ({tf['wgmma']:.1f} "
          f"TFLOP/s), mma.sync {ms['mma_sync']:.4f} ms "
          f"({tf['mma_sync']:.1f} TFLOP/s) (in turns: mma.sync, wgmma, "
          f"wgmma, mma.sync), plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; 989 TFLOP/s bf16, 3.35 TB/s); "
          f"host cost of one launch through the wrapper: wgmma "
          f"{host['wgmma']:.1f} us, mma.sync {host['mma_sync']:.1f} us",
          flush=True)
    check(ms["wgmma"] < ms["mma_sync"],
          "K1's wgmma variant is not faster than mma.sync (serve shape)")
    return {"max_abs_err": err, "ms": ms["wgmma"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "library_covers": ["flash_fwd (K1)"],
            "variant": "wgmma", "mma_sync_ms": ms["mma_sync"],
            "host_us": host["wgmma"], "mma_sync_host_us": host["mma_sync"]}


# K2 and K3: the public wrapper (the variant the shape picks) and the
# private one that forces a variant.
BWD = {"K2": ("flash_attention_dq", "_flash_dq"),
       "K3": ("flash_attention_dkv", "_flash_dkv")}


def bwd(torch, attn, kernel, variant, args, causal, mask):
    """K2 or K3 on ``variant``: through the public wrapper where the shape
    picks that variant, forced otherwise; checks that the launch went to
    it."""
    public, forced = (getattr(attn, x) for x in BWD[kernel])
    total, count = public.launches, public.variant_launches[variant]
    if attn.flash_backward_variant(*args[:4]) == variant:
        out = public(*args, causal=causal, kv_mask=mask)
    else:
        out = forced(*args, causal, mask, variant=variant)
    torch.cuda.synchronize()
    check(public.launches == total + 1
          and public.variant_launches[variant] == count + 1,
          f"{kernel} {variant} did not launch")
    return out


def bwd_variants(torch, attn, args, n: int):
    """K2's and K3's two bf16 variants on ``args`` (causal), timed in
    turns (mma.sync, wgmma, wgmma, mma.sync) as CUDA graphs; returns the
    mean ms of each (kernel, variant)."""
    fns = {(kern, x): (lambda f=getattr(attn, BWD[kern][1]), x=x:
                       f(*args, True, None, variant=x))
           for kern in BWD for x in ("wgmma", "mma_sync")}
    runs = {key: [] for key in fns}
    for x in ("mma_sync", "wgmma", "wgmma", "mma_sync"):
        for kern in BWD:
            runs[kern, x].append(graph_ms(torch, fns[kern, x], n))
    return {key: sum(r) / len(r) for key, r in runs.items()}


def backward_phase(torch, attn):
    """K2 and K3 against their plain versions; returns the numbers of
    both at the flagship train shape."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    bf16, f32 = torch.bfloat16, torch.float32
    # name, B, H, Tq, Tkv, D, dtype, causal, kv_mask lengths (None = none)
    cases = [
        ("flagship train", 8, 16, 2048, 2048, 128, bf16, True, None),
        ("ragged", 2, 4, 1000, 1000, 128, bf16, True, None),
        ("cross causal", 2, 4, 300, 1000, 128, bf16, True, None),
        ("kv_mask causal", 3, 4, 700, 700, 128, bf16, True, [700, 333, 0]),
        ("head_dim 80", 2, 2, 130, 130, 80, bf16, True, None),
        ("f32 causal", 2, 4, 500, 500, 128, f32, True, None),
        ("f32 kv_mask", 3, 2, 257, 300, 48, f32, False, [300, 100, 0]),
    ]
    flagship = None
    for name, b, h, tq, tkv, d, dt, causal, lengths in cases:
        q, do = (torch.randn(b, h, tq, d, device="cuda", generator=gen).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(b, h, tkv, d, device="cuda", generator=gen).to(dt)
                for _ in range(2))
        mask = None
        if lengths is not None:
            mask = (torch.arange(tkv, device="cuda")[None, :]
                    < torch.tensor(lengths, device="cuda")[:, None])
        o, lse = attn.flash_attention_reference(q, k, v, causal=causal,
                                                kv_mask=mask, return_lse=True)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta)
        kw = dict(causal=causal, kv_mask=mask)
        rq = attn.flash_attention_dq_reference(*args, **kw)
        rk, rv = attn.flash_attention_dkv_reference(*args, **kw)
        auto = "wgmma" if dt == bf16 else "f32"
        check(attn.flash_backward_variant(q, k, v, do) == auto,
              f"K2/K3 would take {attn.flash_backward_variant(q, k, v, do)} "
              f"for {name}, not {auto}")
        a, rtol = TOL_GRAD[str(dt).split(".")[1]]
        errs = {}
        for variant in ((auto, "mma_sync") if dt == bf16 else (auto,)):
            dq = bwd(torch, attn, "K2", variant, args, causal, mask)
            dk, dv = bwd(torch, attn, "K3", variant, args, causal, mask)
            errs[variant] = {}
            for what, got, ref in (("dq", dq, rq), ("dk", dk, rk),
                                   ("dv", dv, rv)):
                err = (got.float() - ref.float()).abs()
                ok = bool((err <= a * ref.float().abs().max()
                           + rtol * ref.float().abs()).all())
                errs[variant][what] = float(err.max())
                check(bool(torch.isfinite(got.float()).all()),
                      f"{variant} {what} non-finite ({name})")
                check(ok, f"{'K2' if what == 'dq' else 'K3'} {variant} {what} "
                      f"disagrees with its plain version ({name})")
            e = errs[variant]
            print(f"kernel K2/K3 {variant:8s} {name:15s} ({b},{h},{tq},{tkv},"
                  f"{d}) {str(dt)[6:]:8s} causal={causal!s:5s} "
                  f"mask={lengths is not None!s:5s} max|ddq|={e['dq']:.3e} "
                  f"max|ddk|={e['dk']:.3e} max|ddv|={e['dv']:.3e} "
                  f"(max|dq|={rq.float().abs().max().item():.3e}) ok",
                  flush=True)
            if name == "flagship train" and variant == "wgmma":
                # Each block writes its rows once, without atomics: a
                # second launch gives the same bits.
                dq2 = bwd(torch, attn, "K2", variant, args, causal, mask)
                dk2, dv2 = bwd(torch, attn, "K3", variant, args, causal, mask)
                same = all(bool(torch.equal(x, y)) for x, y in
                           ((dq, dq2), (dk, dk2), (dv, dv2)))
                print(f"kernel K2/K3 wgmma flagship train: a second launch "
                      f"gives bitwise-equal dq, dk, dv: {same}", flush=True)
                check(same, "K2/K3 wgmma differ from run to run")
                del dq2, dk2, dv2
        if name == "flagship train":
            # K1 at the shape every train step gives it, against the
            # plain o and lse computed above.
            wg = attn.flash_attention.variant_launches["wgmma"]
            ko, kl = attn.flash_attention(q, k, v, causal=True,
                                          return_lse=True)
            torch.cuda.synchronize()
            check(attn.flash_attention.variant_launches["wgmma"] == wg + 1,
                  "K1 did not take the wgmma variant at the train shape")
            err_o = (ko.float() - o.float()).abs()
            err_l = (kl - lse).abs()
            atol, rtol = TOL_O["bfloat16"]
            check(bool((err_o <= atol + rtol * o.float().abs()).all())
                  and bool((err_l <= TOL_LSE[0]
                            + TOL_LSE[1] * lse.abs()).all()),
                  "K1 disagrees with its plain version (flagship train)")
            k1_errs = (float(err_o.max()), float(err_l.max()))
            del ko, kl, err_o, err_l
            flagship = (args, errs)
        del dq, dk, dv, rq, rk, rv

    (q, k, v, do, lse, delta), errs = flagship
    b, h, t, d = q.shape
    ms = bwd_variants(torch, attn, (q, k, v, do, lse, delta), 20)
    plain_q = time_ms(torch, lambda: attn.flash_attention_dq_reference(
        q, k, v, do, lse, delta, causal=True), 3)
    plain_kv = time_ms(torch, lambda: attn.flash_attention_dkv_reference(
        q, k, v, do, lse, delta, causal=True), 3)
    k1_ms, _ = k1_variants(torch, attn, q, k, v, 20)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), 20)
    lib_fwd_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 20)
    (b2_ms, b2_by), (b3_ms, b3_by) = backward_bounds(b, h, t, t, d, True, 2)
    b1_ms, _ = attention_bound(b, h, t, t, d, True, 2)
    pairs = causal_pairs(t, t, True)
    tf = lambda prods, ms: 2.0 * prods * b * h * pairs * d / (ms * 1e-3) / 1e12
    pair = {x: ms["K2", x] + ms["K3", x] for x in ("wgmma", "mma_sync")}
    print(f"kernel train shape ({b},{h},{t},{t},{d}) bf16 causal, CUDA-graph "
          f"device time (in turns: mma.sync, wgmma, wgmma, mma.sync): "
          f"K2 wgmma {ms['K2', 'wgmma']:.4f} ms "
          f"({tf(3, ms['K2', 'wgmma']):.1f} TFLOP/s), mma.sync "
          f"{ms['K2', 'mma_sync']:.4f} ms ({tf(3, ms['K2', 'mma_sync']):.1f} "
          f"TFLOP/s), bound {b2_ms:.4f} ms, plain {plain_q:.4f} ms; "
          f"K3 wgmma {ms['K3', 'wgmma']:.4f} ms "
          f"({tf(4, ms['K3', 'wgmma']):.1f} TFLOP/s), mma.sync "
          f"{ms['K3', 'mma_sync']:.4f} ms ({tf(4, ms['K3', 'mma_sync']):.1f} "
          f"TFLOP/s), bound {b3_ms:.4f} ms, plain {plain_kv:.4f} ms; "
          f"K2 + K3 wgmma {pair['wgmma']:.4f} ms, mma.sync "
          f"{pair['mma_sync']:.4f} ms, against autograd.grad of "
          f"scaled_dot_product_attention (dq, dk, dv) {lib_ms:.4f} ms "
          f"(wgmma pair / library {pair['wgmma'] / lib_ms:.2f}x); K1 wgmma "
          f"{k1_ms['wgmma']:.4f} ms ({tf(2, k1_ms['wgmma']):.1f} TFLOP/s), "
          f"mma.sync {k1_ms['mma_sync']:.4f} ms "
          f"({tf(2, k1_ms['mma_sync']):.1f} TFLOP/s) (CUDA graphs, in "
          f"turns), bound {b1_ms:.4f} ms, scaled_dot_product_attention "
          f"{lib_fwd_ms:.4f} ms, wgmma max|do|={k1_errs[0]:.3e} "
          f"max|dlse|={k1_errs[1]:.3e} against its plain version, ok) "
          f"(989 TFLOP/s bf16, 3.35 TB/s)", flush=True)
    check(k1_ms["wgmma"] < k1_ms["mma_sync"],
          "K1's wgmma variant is not faster than mma.sync (train shape)")
    check(pair["wgmma"] < pair["mma_sync"],
          "K2 + K3 on wgmma are not faster than on mma.sync (train shape)")
    # The library call computes dq, dk and dv at once: its time covers
    # K2 and K3 together.
    both = ["flash_bwd_dq (K2)", "flash_bwd_dkv (K3)"]
    k1_train = {"train_ms": k1_ms["wgmma"], "train_bound_ms": b1_ms,
                "train_library_ms": lib_fwd_ms,
                "train_mma_sync_ms": k1_ms["mma_sync"],
                "train_max_abs_err": k1_errs[0]}
    shared = {"library_ms": lib_ms, "library_covers": both,
              "variant": "wgmma", "pair_ms": pair["wgmma"],
              "pair_mma_sync_ms": pair["mma_sync"],
              "pair_over_library": pair["wgmma"] / lib_ms}
    return (k1_train,
            {"max_abs_err": errs["wgmma"]["dq"], "ms": ms["K2", "wgmma"],
             "plain_ms": plain_q, "bound_ms": b2_ms, "bound_by": b2_by,
             "mma_sync_ms": ms["K2", "mma_sync"],
             "mma_sync_max_abs_err": errs["mma_sync"]["dq"], **shared},
            {"max_abs_err": max(errs["wgmma"]["dk"], errs["wgmma"]["dv"]),
             "ms": ms["K3", "wgmma"], "plain_ms": plain_kv,
             "bound_ms": b3_ms, "bound_by": b3_by,
             "mma_sync_ms": ms["K3", "mma_sync"],
             "mma_sync_max_abs_err": max(errs["mma_sync"]["dk"],
                                         errs["mma_sync"]["dv"]), **shared})


KERNEL_FNS = ("flash_attention", "flash_attention_dq", "flash_attention_dkv")


def launch_counts(attn):
    """(K1, K2, K3, then each of the three on its wgmma variant)."""
    fns = [getattr(attn, x) for x in KERNEL_FNS]
    return (tuple(f.launches for f in fns)
            + tuple(f.variant_launches["wgmma"] for f in fns))


def reset_launch_counts(attn):
    for fn in (getattr(attn, x) for x in KERNEL_FNS):
        fn.launches = 0
        for variant in fn.variant_launches:
            fn.variant_launches[variant] = 0


def step_grads(model, win):
    """One step's loss and f32 gradients, by parameter name."""
    model._net.zero_grad(set_to_none=True)
    loss, _ = model._loss(win)
    loss.backward()
    grads = {n: p.grad.detach().clone()
             for n, p in model._net.named_parameters()}
    model._net.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def train_phase(torch, np, attn, card):
    """Trains the flagship LM on the kernels; returns its dumped
    parameters and the K1, K2 and K3 launches of the training run."""
    import tempfile

    from rafiki_torch.datasets import make_synthetic_token_dataset
    from rafiki_torch.model.dataset import load_token_dataset
    from rafiki_torch.model.logger import logger
    from rafiki_torch.model.loop_ckpt import epoch_rng
    from rafiki_torch.model.optim import adamw
    from rafiki_torch.models import TorchTransformerLM

    knobs = dict(TorchTransformerLM.validate_knobs(FLAGSHIP),
                 train_steps=TRAIN_STEPS)
    L, b, t = knobs["n_layers"], knobs["batch_size"], knobs["seq_len"]
    k_disp = knobs["steps_per_dispatch"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train_path, _ = make_synthetic_token_dataset(
            tmp, n_train=1 << 20, n_val=1 << 12,
            vocab_size=knobs["vocab_size"], seed=SEED)
        ds = load_token_dataset(train_path)
        print(f"train: synthetic Markov stream of {ds.size} ids, vocab "
              f"{ds.vocab_size}, made in {time.perf_counter() - t0:.1f} s",
              flush=True)
        model = TorchTransformerLM(device="cuda", **knobs)
        records = []

        def sink(rec):
            if rec.get("type") == "values":
                records.append((time.perf_counter(), rec["values"]))

        prev = logger.current_sink()
        logger.set_sink(sink)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts(attn)
        t0 = time.perf_counter()
        try:
            model.train(train_path)
        finally:
            logger.set_sink(prev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = launch_counts(attn)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = [r["loss"] for _, r in records]
    steps = [r["step"] for _, r in records]
    print(f"train: {TRAIN_STEPS} steps in {secs:.2f} s (first use "
          f"included); chunk records " + "; ".join(
              f"step {r['step']} loss {r['loss']:.4f} token_acc "
              f"{r['token_acc']:.5f}" + (f" chip_util {r['chip_util']}"
                                         if "chip_util" in r else "")
              for _, r in records), flush=True)
    check(steps == list(range(k_disp, TRAIN_STEPS + 1, k_disp)),
          f"logged steps {steps}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[1] < losses[0], f"the chunk loss did not fall: {losses}")
    per_step = [n / TRAIN_STEPS for n in launches]
    print(f"train: launches per step K1 {per_step[0]:g} (wgmma "
          f"{per_step[3]:g}), K2 {per_step[1]:g} (wgmma {per_step[4]:g}), K3 "
          f"{per_step[2]:g} (wgmma {per_step[5]:g}) ({L} layers, remat "
          f"{knobs['remat']!r})", flush=True)
    check(per_step == [2 * L, L, L, 2 * L, L, L],
          f"launches per step {per_step}: expected K1 {2 * L} (the forward "
          f"and its rerun under 'dots'), K2 {L}, K3 {L}, all on wgmma")
    chunk_secs = records[1][0] - records[0][0]
    step_ms = chunk_secs / k_disp * 1e3
    util = records[1][1].get("chip_util")
    check(util is not None and 0 < util < 1, f"chip_util {util}")
    print(f"train: steady chunk of {k_disp} steps in {chunk_secs:.3f} s = "
          f"{step_ms:.1f} ms a step, {b * t / (step_ms * 1e-3):.1f} tokens/s, "
          f"chip_util {util} (analytic {model._flops_per_step(b) / 1e12:.2f} "
          f"TFLOP a step over 989 TFLOP/s bf16); peak memory "
          f"{peak_gb:.2f} GB (max_memory_allocated) on {card}", flush=True)

    params = model.dump_parameters()
    # Checks after the run: the same windows for every step below.
    rng = epoch_rng(SEED, 1)
    starts = rng.integers(0, ds.size - (t + 1), size=b)
    win = torch.from_numpy(np.stack([ds.ids[i:i + t + 1] for i in starts])
                           .astype(np.int64)).to("cuda")
    opt = adamw(model._net.parameters(), 0.0)  # lr 0: weights stay put

    def one_step():
        model._net.zero_grad(set_to_none=True)
        loss, _ = model._loss(win)
        loss.backward()
        opt.step()

    profile(torch, one_step, f"one train step (batch {b} x {t})", card, 18)
    loss_k, grads_k = step_grads(model, win)
    model.attention = attn.flash_attention_plain
    loss_p, grads_p = step_grads(model, win)
    model.attention = attn.flash_attention
    errs = {n: float((grads_k[n] - grads_p[n]).norm() / grads_p[n].norm())
            for n in grads_p}
    worst = max(errs, key=errs.get)
    print(f"train: one step on the kernels vs flash_attention_plain, same "
          f"weights and windows: loss {loss_k:.6f} vs {loss_p:.6f} (|diff| "
          f"{abs(loss_k - loss_p):.3e}, tolerance {TOL_STEP_LOSS}); gradient "
          f"relative error max {errs[worst]:.3e} ({worst}), median "
          f"{sorted(errs.values())[len(errs) // 2]:.3e} over {len(errs)} "
          f"parameters (tolerance {TOL_STEP_GRAD})", flush=True)
    check(abs(loss_k - loss_p) <= TOL_STEP_LOSS,
          "the step's loss disagrees with the plain-attention step")
    check(errs[worst] <= TOL_STEP_GRAD,
          "a gradient disagrees with the plain-attention step")
    model.destroy()
    del opt, grads_k, grads_p
    torch.cuda.empty_cache()
    return params, launches


def post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            status, body = resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        status, body = e.code, json.loads(e.read())
    return status, body, time.perf_counter() - t0


def profile(torch, fn, what, card, top=10):
    """Where the time of one ``fn()`` goes on the card: device time by
    kernel, and the device's busy share of the wall time. Returns the
    rows, (device us, count, kernel name), and the busy us; None when
    the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side kernel rows only: the host operators' rows repeat the
    # device time of the kernels they launch, and a user annotation's row
    # (the optimizer's step range) spans kernels already counted.
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type == DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            rows.append((us, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        print("profile: the profiler recorded no device time: not measured",
              flush=True)
        return None
    print(f"profile: {what}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%) on {card}",
          flush=True)
    for us, n, key in sorted(rows, reverse=True)[:top]:
        print(f"profile: {100 * us / busy:5.1f}% {us / 1e3:8.3f} ms "
              f"x{n:<4d} {key[:90]}", flush=True)
    return rows, busy


def throughput_window(np, url, ids, seq_len, card, n_requests=WINDOW_REQUESTS,
                      clients=WINDOW_CLIENTS) -> int:
    """The scoring service's rate: ``n_requests`` single-query requests
    of random lengths, sent by ``clients`` threads at once. Checks each
    answer and prints latency percentiles and tokens scored per second;
    returns the number of queries scored."""
    from concurrent.futures import ThreadPoolExecutor

    lengths = np.random.default_rng(SEED + 2).integers(
        2, seq_len + 2, size=n_requests).tolist()
    queries = [ids(n) for n in lengths]

    def one(q):
        status, body, dt = post(url + "/predict", {"query": q})
        check(status == 200, f"/predict answered {status}")
        p = body["prediction"]
        check(isinstance(p, float) and math.isfinite(p),
              f"non-finite score {p}")
        return dt

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        lat = sorted(pool.map(one, queries))
    secs = time.perf_counter() - t0
    n_tok = sum(min(n, seq_len + 1) - 1 for n in lengths)
    pct = {p: lat[min(len(lat) - 1, int(p / 100 * len(lat)))] * 1e3
           for p in (50, 90, 99)}
    print(f"slice: window of {n_requests} single-query requests from "
          f"{clients} clients: {n_tok} tokens scored in {secs:.4f} s = "
          f"{n_tok / secs:.1f} tokens/s, {n_requests / secs:.2f} queries/s; "
          f"latency p50 {pct[50]:.2f} ms, p90 {pct[90]:.2f} ms, p99 "
          f"{pct[99]:.2f} ms (one padded {seq_len}-position forward per "
          f"query) on {card}", flush=True)
    return n_requests


def slice_phase(torch, np, attn, card, params):
    from rafiki_torch.models import TorchTransformerLM
    from rafiki_torch.predictor import PredictorService
    from rafiki_torch.torchenv import sync
    from rafiki_torch.worker import InferenceWorker

    knobs = FLAGSHIP
    t0 = time.perf_counter()
    n_params = sum(a.size for a in params.values())
    worker = InferenceWorker(TorchTransformerLM, knobs, params,
                             device="cuda")
    sync(worker.device)
    print(f"slice: TorchTransformerLM {n_params / 1e6:.1f} M trained params "
          f"loaded on {card} in {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(SEED + 1)
    v, t, L = knobs["vocab_size"], knobs["seq_len"], knobs["n_layers"]

    def ids(n):
        return rng.integers(0, v, size=n).tolist()

    requests = [
        {"query": ids(512)},
        {"query": ids(1)},
        {"queries": [ids(3000), ids(100), ids(2), ids(1500)]},
        {"query": ids(2048)},
        {"queries": [ids(1), ids(700)]},
    ]
    app = PredictorService([worker.start()], device="cuda").start()
    served, latencies, tokens = [], [], []
    try:
        reset_launch_counts(attn)
        for req in requests:
            status, body, dt = post(app.url + "/predict", req)
            check(status == 200, f"/predict answered {status}")
            single = "query" in req
            preds = [body["prediction"]] if single else body["predictions"]
            queries = [req["query"]] if single else req["queries"]
            check(len(preds) == len(queries), "wrong number of predictions")
            served.extend(zip(queries, preds))
            latencies.append(dt)
            tokens.append(sum(min(len(q), t + 1) - 1 for q in queries
                              if len(q) >= 2))
        window = throughput_window(np, app.url, ids, t, card)
        launches = launch_counts(attn)
        status, body, _ = post(app.url + "/predict", {})
        check(status == 400, "an empty body must get 400")
    finally:
        app.stop()
        worker.stop()

    scored = [(q, p) for q, p in served if len(q) >= 2]
    for q, p in served:
        check(isinstance(p, float) and math.isfinite(p),
              f"non-finite score {p}")
        if len(q) < 2:
            check(p == 0.0, "a query of fewer than 2 ids must score 0.0")
    n_scored = len(scored) + window
    check(launches[0] == L * n_scored,
          f"K1 launched {launches[0]} times for {n_scored} scored queries "
          f"of {L} layers: some layer did not go through the kernel")
    check(launches[3] == launches[0],
          f"only {launches[3]} of {launches[0]} K1 launches took wgmma")
    check(launches[1:3] == (0, 0), f"serving launched K2/K3 {launches[1:3]}")
    print(f"slice: {len(requests)} POST /predict requests, {len(served)} "
          f"queries ({len(scored)} scored), then {window} scored queries "
          f"in the window; K1 launches {launches[0]} = {L} x {n_scored}, "
          f"all on wgmma, K2 and K3 none", flush=True)
    print("slice: per-request latency ms " + ", ".join(
        f"{x * 1e3:.1f}" for x in latencies) + f" (smoke requests, one at "
        f"a time; the first pays the card's first-use costs) on {card}",
        flush=True)

    model = worker.model
    model.attention = attn.flash_attention_reference
    plain = model.predict([q for q, _ in scored])
    model.attention = attn.flash_attention
    diffs = [abs(a - p) for (_, a), p in zip(scored, plain)]
    print(f"slice: served scores {[round(p, 5) for _, p in scored]} vs "
          f"plain-attention {[round(p, 5) for p in plain]}, max |diff| "
          f"{max(diffs):.3e} (tolerance {TOL_SCORE})", flush=True)
    check(max(diffs) <= TOL_SCORE,
          "served scores disagree with the plain-attention model")
    query = scored[0][0]
    profile(torch, lambda: model.predict([query]),
            f"one predict of a {len(query)}-id query", card)
    model.destroy()
    return launches[0]


def stream_generate(url, body):
    """One ``POST /generate``: (frames, send time, arrival time of each
    NDJSON line), read line by line as the chunks arrive."""
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    frames, times = [], []
    with urllib.request.urlopen(req, timeout=600) as resp:
        check(resp.status == 200, f"/generate answered {resp.status}")
        check(resp.headers["Content-Type"] == "application/x-ndjson",
              f"/generate content type {resp.headers['Content-Type']}")
        for line in resp:
            frames.append(json.loads(line))
            times.append(time.perf_counter())
    return frames, t0, times


def check_stream(frames, max_new) -> int:
    """Every frame numbered without gaps, only the last ``done``, which
    says ``length`` with ``max_new`` tokens or ``eos``; returns the
    number of tokens."""
    check([f.get("seq") for f in frames] == list(range(len(frames))),
          f"frames not numbered without gaps: {[f.get('seq') for f in frames]}")
    check(all(not f["done"] for f in frames[:-1]) and frames[-1]["done"],
          "a stream did not end with its one done frame")
    last, n = frames[-1], sum(len(f["tok"]) for f in frames)
    check(last["n_tokens"] == n, f"n_tokens {last['n_tokens']} != {n} sent")
    check(last["finish"] == "eos" or (last["finish"] == "length"
                                      and n == max_new),
          f"stream finished {last['finish']!r} after {n} of {max_new} tokens")
    return n


def percentile(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p / 100 * len(xs)))]


def decode_bound(s, B, T):
    """The decode step's least time: it reads every bf16 weight once
    (the projections and the tied embedding, which the unembedding
    reads whole) and gathers the fixed ``T``-slot K and V of every lane
    in every layer, whatever the lengths; its products are 2 FLOP per
    weight per lane."""
    n_w = 12 * s["layers"] * s["d"] ** 2 + s["v"] * s["d"]
    nbytes = 2 * n_w + s["layers"] * 2 * B * T * s["d"] * 2
    flops = 2.0 * n_w * B + s["layers"] * 4.0 * B * T * s["d"]
    return bound(flops, nbytes, 2), n_w * 2, nbytes


def engine_checks(torch, np, attn, card, model):
    """Checks (1), (2), (5) and (6) of the generate phase on an engine
    held directly: greedy parity with the full forward, K1 at every
    prefill bucket, sampling alone and packed, the decode step's time.
    Returns K1's numbers at the buckets."""
    import torch.nn.functional as F

    from rafiki_torch.models.lm_generate import PREFILL_BUCKETS

    s = model._dims()
    L, V = s["layers"], s["v"]
    t0 = time.perf_counter()
    eng = model.make_generator(**GEN_ENGINE)
    torch.cuda.synchronize()
    pool_gib = 2 * eng._k_pool.numel() * 2 / 2 ** 30
    print(f"generate: engine {GEN_ENGINE}: {eng.pages_per_seq} page slots "
          f"a lane ({eng.max_tokens} tokens), K and V pools {pool_gib:.3f} "
          f"GiB, decode step captured as a CUDA graph, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    check(eng._graph is not None, "the decode step was not captured")
    rng = np.random.default_rng(SEED + 5)

    # (1) Greedy parity with the full forward (K1) over the same prefix.
    prompt = rng.integers(0, V, 300).tolist()
    sid, tok = eng.admit(prompt, max_new=32, temperature=0.0)
    toks, errs, gaps, ties, step_k1 = list(prompt), [], [], 0, 0
    atol, rtol = TOL_LOGITS
    while True:
        ref = model._forward(torch.tensor([toks], device="cuda"))[0, -1]
        ref = ref.cpu().numpy()
        got = eng.last_logits[sid]
        err = np.abs(got - ref)
        errs.append(float(err.max()))
        check(bool((err <= atol + rtol * np.abs(ref)).all()),
              f"decode logits at position {len(toks)} disagree with the "
              f"full forward: max |diff| {err.max():.4f}")
        top2 = np.sort(ref)[-2:]
        gaps.append(float(top2[1] - top2[0]))
        if tok != int(np.argmax(ref)):
            check(gaps[-1] < NEAR_TIE, f"greedy token {tok} at position "
                  f"{len(toks)} is not the full forward's argmax "
                  f"{int(np.argmax(ref))} (top-2 gap {gaps[-1]:.4f})")
            ties += 1
        toks.append(tok)
        if sid not in eng._seqs:
            break
        k0 = attn.flash_attention.launches
        (r,), evicted = eng.step()
        step_k1 += attn.flash_attention.launches - k0
        check(not evicted and r[0] == sid, "unexpected step result")
        tok = r[1]
    check(len(toks) == len(prompt) + 32, f"{len(toks) - len(prompt)} tokens")
    check(step_k1 == 0, f"decode steps launched K1 {step_k1} times")
    print(f"generate (1): greedy 300-id prompt, 32 tokens: decode logits vs "
          f"the full forward (K1) over the same prefix at every step: max "
          f"|diff| {max(errs):.4e} (tolerance atol {atol}, rtol {rtol}); "
          f"greedy tokens equal to the full forward's argmax at "
          f"{32 - ties} of 32 steps ({ties} near-ties, top-2 gap < "
          f"{NEAR_TIE}, where they may part); smallest top-2 gap "
          f"{min(gaps):.4f}; decode steps launched K1 0 times", flush=True)

    # (2) K1 at every prefill bucket, against the plain attention.
    def late_kv(q, k, v, **kw):
        """K1 reading each key and value one row late: the planted fault
        that shows what the logits' limit can see."""
        k, v = (torch.cat([x[:, :, :1], x[:, :, :-1]], 2) for x in (k, v))
        return attn.flash_attention(q, k, v, **kw)

    def prefill_rows(ids, n, attention):
        """A prefill of ``n`` ids on ``attention`` into pages of its own:
        its last logits, and each layer's K and V rows, (2, L, n, d)
        f32."""
        ps = eng.page_size
        pages = [eng.pool.alloc() for _ in range(-(-n // ps))]
        rows = (torch.tensor(pages, device="cuda")[:, None] * ps
                + torch.arange(ps, device="cuda")).reshape(-1)[:n]
        pos = torch.zeros(ids.shape[1], dtype=torch.int64, device="cuda")
        pos[:n] = rows
        model.attention = attention
        try:
            logits = eng._run_prefill(ids, pos, n - 1).cpu().numpy()
        finally:
            model.attention = attn.flash_attention
        kv = torch.stack([eng._k_pool[:, rows], eng._v_pool[:, rows]])
        for p in pages:
            eng.pool.free(p)
        return logits, kv.float()

    def kv_rel(kv, ref):
        """The largest |kv - ref| of each K or V layer over that layer's
        largest |ref|, the largest over layers."""
        dims = (2, 3)
        return float(((kv - ref).abs().amax(dims)
                      / ref.abs().amax(dims)).max())

    buckets = []
    for n in PREFILL_LENGTHS:
        bucket = next(b for b in PREFILL_BUCKETS if b >= n)
        prompt = rng.integers(0, V, n).tolist()
        c0 = launch_counts(attn)
        sid, _ = eng.admit(prompt, max_new=1)
        c1 = launch_counts(attn)
        got = eng.last_logits[sid]
        eng.finish(sid)
        check(c1[0] - c0[0] == L and c1[3] - c0[3] == L
              and c1[1:3] == c0[1:3],
              f"a {n}-id prefill launched K1 {c1[0] - c0[0]} times "
              f"({c1[3] - c0[3]} wgmma), not {L}, and K2/K3 "
              f"{c1[1] - c0[1]}/{c1[2] - c0[2]} times, not 0")
        ids = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
        ids[0, :n] = torch.tensor(prompt, device="cuda")
        _, kv = prefill_rows(ids, n, attn.flash_attention)
        plain, kv_plain = prefill_rows(ids, n, attn.flash_attention_plain)
        planted, kv_planted = prefill_rows(ids, n, late_kv)
        err = np.abs(got - plain)
        planted_err = float(np.abs(planted - plain).max())
        kv_err, planted_kv_err = kv_rel(kv, kv_plain), kv_rel(kv_planted,
                                                              kv_plain)
        check(bool((err <= TOL_PREFILL).all()),
              f"a {n}-id prefill's logits disagree with the plain "
              f"attention: max |diff| {err.max():.4f}")
        check(kv_err <= TOL_KV, f"a {n}-id prefill's K/V rows disagree "
              f"with the plain attention's: {kv_err:.4e} of the layer's "
              f"max |x|")
        skipped = eng.prefill_skipped_total
        c0 = launch_counts(attn)
        sid, _ = eng.admit(prompt, max_new=1)
        c1 = launch_counts(attn)
        eng.finish(sid)
        check(eng.prefill_skipped_total == skipped + 1 and c1 == c0,
              f"a prefix hit ({n} ids) launched {c1[0] - c0[0]} K1")
        gen = torch.Generator(device="cuda").manual_seed(bucket)
        q, k, v = (torch.randn(1, s["h"], bucket, s["d"] // s["h"],
                               device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        check(attn.flash_forward_variant(q, k, v) == "wgmma",
              f"K1 would not take wgmma at {bucket} rows")
        ro, rl = attn.flash_attention_reference(q, k, v, causal=True,
                                                return_lse=True)
        c0 = launch_counts(attn)
        o, lse = attn.flash_attention(q, k, v, causal=True, return_lse=True)
        c1 = launch_counts(attn)
        check(c1[0] - c0[0] == 1 and c1[3] - c0[3] == 1,
              f"K1 did not launch on wgmma at {bucket} rows")
        err_o = (o.float() - ro.float()).abs()
        err_l = (lse - rl).abs()
        a_o, r_o = TOL_O["bfloat16"]
        check(bool((err_o <= a_o + r_o * ro.float().abs()).all())
              and bool((err_l <= TOL_LSE[0] + TOL_LSE[1] * rl.abs()).all())
              and bool(torch.isfinite(o.float()).all()),
              f"K1 disagrees with its plain version at {bucket} rows: max "
              f"|do| {err_o.max().item():.3e}, |dlse| "
              f"{err_l.max().item():.3e}")
        ms = graph_ms(torch, lambda: attn._flash_forward(q, k, v, True,
                                                         None), 20)
        plain_ms = time_ms(torch, lambda: attn.flash_attention_reference(
            q, k, v, causal=True), 3)
        lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 20)
        b_ms, b_by = attention_bound(1, s["h"], bucket, bucket,
                                     s["d"] // s["h"], True, 2)
        buckets.append({"rows": bucket, "prompt": n, "ms": ms,
                        "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "max_abs_err": float(err_o.max()),
                        "lse_max_abs_err": float(err_l.max()),
                        "logits_max_abs_err": float(err.max()),
                        "planted_logits_max_abs_err": planted_err,
                        "kv_rel_err": kv_err,
                        "planted_kv_rel_err": planted_kv_err})
        print(f"generate (2): {n}-id prompt, bucket {bucket}: K1 launches "
              f"{L}, all wgmma; last logits (max |logit| "
              f"{np.abs(plain).max():.3f}) vs the plain attention max "
              f"|diff| {err.max():.4e} (tolerance {TOL_PREFILL}); every "
              f"layer's K and V rows vs the plain attention's: max |diff| "
              f"over the layer's max |x| {kv_err:.4e} (tolerance {TOL_KV}); "
              f"with K1 reading K/V one row late (a "
              f"planted fault): logits {planted_err:.4e}, K/V rows "
              f"{planted_kv_err:.4e}; a prefix hit launched none; K1 at "
              f"(1,{s['h']},{bucket},{bucket},{s['d'] // s['h']}) causal "
              f"on random q, k, v against its plain version: max|do| "
              f"{err_o.max().item():.3e}, max|dlse| {err_l.max().item():.3e}"
              f" (tolerance as the kernel phase's); "
              f"{ms:.4f} ms (CUDA graph), plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}) on {card}", flush=True)
        del q, k, v, o, lse, ro, rl

    # (5) Sampling: the same (seed, prompt) alone and packed with seven
    # other requests.
    prompt = rng.integers(0, V, 200).tolist()
    sid, tok = eng.admit(prompt, max_new=48, temperature=0.8, seed=1234)
    alone = [tok]
    while sid in eng._seqs:
        alone += [t for q, t, _ in eng.step()[0] if q == sid]
    others = [eng.admit(rng.integers(0, V, int(n)).tolist(), max_new=64,
                        temperature=float(t), seed=int(n))[0]
              for n, t in zip(rng.integers(50, 500, 7), [0.8, 0.0] * 4)]
    sid, tok = eng.admit(prompt, max_new=48, temperature=0.8, seed=1234)
    lane = eng._seqs[sid].lane
    packed = [tok]
    while sid in eng._seqs:
        res, evicted = eng.step()
        check(not evicted, "the sampling check was preempted")
        packed += [t for q, t, _ in res if q == sid]
    for o in others:
        eng.finish(o)
    print(f"generate (5): 200-id prompt, seed 1234, temperature 0.8, 48 "
          f"tokens: alone (lane 0) and packed with 7 others (lane {lane}) "
          f"identical: {packed == alone}", flush=True)
    check(packed == alone, "sampled tokens differ alone and packed")

    # (6) The decode step at 8 full lanes: graph replay, eager, bound.
    B, T = eng.decode_batch, eng.max_tokens
    for _ in range(B):
        eng.admit(rng.integers(0, V, 2040).tolist(), max_new=256,
                  temperature=0.8, seed=7)
    check(eng.resident() == B, f"{eng.resident()} lanes resident")
    eng._stage_inputs()
    eager = eng._decode(*eng._decode_args())
    graph = eng._run_decode()
    torch.cuda.synchronize()
    same = (bool(torch.equal(eager[0], graph[0]))
            and bool(torch.equal(eager[1], graph[1])))
    check(same, "the decode graph's tokens or logits differ from the "
          "eager step's on the same inputs")
    graph_step = time_ms(torch, eng._graph.replay, 50)
    eager_step = time_ms(torch, lambda: eng._decode(*eng._decode_args()), 20)
    t0 = time.perf_counter()
    for _ in range(20):
        eng.step()
    wall_step = (time.perf_counter() - t0) / 20 * 1e3
    (b_ms, b_by), w_bytes, nbytes = decode_bound(s, B, T)
    prof = profile(torch, lambda: eng._decode(*eng._decode_args()),
                   f"one eager decode step at {B} full lanes", card, 12)
    gather_share = eager_device = None
    if prof is not None:
        rows, busy = prof
        eager_device = busy / 1e3
        # The gather is PyTorch's gather kernel for rows, its index
        # kernel for the head-major layout; index_copy_ writes the new rows.
        gather_us = sum(us for us, _, key in rows if "gather" in key or (
            "index" in key and "index_copy" not in key))
        gather_share = gather_us / busy
        print(f"generate (6): the K/V gather (PyTorch's gather and index "
              f"kernels, not index_copy_) takes {100 * gather_share:.1f}% "
              f"of the eager step's device time ({gather_us / 1e3:.3f} of "
              f"{busy / 1e3:.3f} ms)", flush=True)
    eager_dev = "not measured" if eager_device is None else \
        f"{eager_device:.4f} ms"
    print(f"generate (6): decode step at {B} full lanes ({T} K/V slots a "
          f"lane): CUDA graph replay {graph_step:.4f} ms (device time, "
          f"CUDA events); eager {eager_step:.4f} ms between CUDA events "
          f"(host-bound: the card waits on the host's launches), of which "
          f"the device is busy {eager_dev} (profiler); one step() on the "
          f"host clock {wall_step:.4f} ms (staging, replay, tokens and "
          f"logits back); bound {b_ms:.4f} ms ({b_by}: {w_bytes / 1e9:.3f} "
          f"GB of bf16 weights + {(nbytes - w_bytes) / 1e9:.3f} GB of K/V "
          f"gather at 3.35 TB/s); graph and eager steps equal bit for "
          f"bit on the same inputs: {same} on {card}", flush=True)
    eng.close()
    check(eng.pool.used_pages == 0, "close() left pages allocated")
    return {"buckets": buckets, "decode_graph_ms": graph_step,
            "decode_eager_ms": eager_step,
            "decode_eager_device_ms": eager_device,
            "decode_step_wall_ms": wall_step,
            "decode_bound_ms": b_ms, "decode_gather_share": gather_share}


def generate_window(torch, np, attn, card, params, engine_cfg, bodies,
                    what):
    """``bodies`` as ``POST /generate`` requests from ``GEN_CLIENTS``
    threads at once to a worker built with ``engine_cfg``; checks every
    stream and K1's launches (``n_layers`` a prefill, all wgmma; K2 and
    K3 none). Returns the scheduler's stats, the engine's evictions, the
    K1 launches and the client-side numbers."""
    from concurrent.futures import ThreadPoolExecutor

    from rafiki_torch.models import TorchTransformerLM
    from rafiki_torch.predictor import PredictorService
    from rafiki_torch.worker import InferenceWorker

    L = FLAGSHIP["n_layers"]
    worker = InferenceWorker(TorchTransformerLM, FLAGSHIP, params,
                             device="cuda", generate=engine_cfg)
    eng = worker.scheduler.engine
    app = PredictorService([worker.start()], device="cuda").start()
    try:
        reset_launch_counts(attn)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(GEN_CLIENTS) as pool:
            results = list(pool.map(
                lambda b: stream_generate(app.url, b), bodies))
        secs = time.perf_counter() - t0
        launches = launch_counts(attn)
        stats = worker.scheduler.stats()
    finally:
        app.stop()
        worker.stop()
    check(eng.pool.used_pages == 0, "stop() left pages allocated")
    n_tok = sum(check_stream(fr, b["max_new"])
                for (fr, _, _), b in zip(results, bodies))
    check(stats["errors"] == 0, f"{stats['errors']} decode loop errors")
    prefills = stats["prefills_run"]
    check(launches[0] == L * prefills and launches[3] == launches[0],
          f"K1 launched {launches[0]} times ({launches[3]} wgmma) for "
          f"{prefills} prefills of {L} layers")
    check(launches[1:3] == (0, 0), f"generation launched K2/K3 "
          f"{launches[1:3]}")
    ttft = [(ts[0] - t) * 1e3 for _, t, ts in results]
    itl = [(b - a) * 1e3 for _, _, ts in results for a, b in zip(ts, ts[1:])]
    step_tokens = stats["tokens"] - prefills - stats["prefills_cached"]
    lanes = step_tokens / max(1, stats["decode_dispatches"])
    print(f"generate {what}: {len(bodies)} POST /generate streams from "
          f"{GEN_CLIENTS} clients, every stream complete with contiguous "
          f"frames: {n_tok} tokens in {secs:.4f} s = {n_tok / secs:.1f} "
          f"tokens/s; TTFT p50 {percentile(ttft, 50):.2f} ms, p99 "
          f"{percentile(ttft, 99):.2f} ms; inter-token p50 "
          f"{percentile(itl, 50):.2f} ms, p99 {percentile(itl, 99):.2f} ms "
          f"(client side); {stats['decode_dispatches']} decode steps, "
          f"{lanes:.3f} live lanes a step; prefills run {prefills}, "
          f"skipped {stats['prefills_cached']}; preemptions "
          f"{stats['preemptions']} (engine evictions "
          f"{eng.evictions_total}); K1 launches {launches[0]} = {L} x "
          f"{prefills}, all wgmma, K2 and K3 none on {card}", flush=True)
    return {"stats": stats, "evictions": eng.evictions_total,
            "k1_launches": launches[0], "tokens": n_tok, "secs": secs,
            "tokens_per_s": n_tok / secs,
            "ttft_ms": (percentile(ttft, 50), percentile(ttft, 99)),
            "itl_ms": (percentile(itl, 50), percentile(itl, 99)),
            "lanes": lanes}


def generate_phase(torch, np, attn, card, params):
    """Generative serving of the trained flagship: checks (1), (2), (5)
    and (6) on an engine held directly, then (3) the window of streamed
    requests and (4) preemption through ``POST /generate``. Returns K1's
    launches on the generate path and the phase's numbers."""
    from rafiki_torch.models import TorchTransformerLM

    model = TorchTransformerLM(device="cuda",
                               **TorchTransformerLM.validate_knobs(FLAGSHIP))
    model.load_parameters(params)
    out = engine_checks(torch, np, attn, card, model)
    model.destroy()
    torch.cuda.empty_cache()

    # (3) The window: a quarter of the prompts are one shared 512-id
    # prompt, the rest 16 to 2000 random ids; greedy and sampled.
    V = FLAGSHIP["vocab_size"]
    rng = np.random.default_rng(SEED + 6)
    shared = rng.integers(0, V, 512).tolist()
    bodies = [{"tokens": (shared if i % 4 == 0 else rng.integers(
                   0, V, int(rng.integers(16, 2001))).tolist()),
               "max_new": int(rng.integers(64, 257)),
               "temperature": 0.8 if rng.random() < 0.5 else 0.0,
               "seed": i}
              for i in range(GEN_REQUESTS)]
    window = generate_window(torch, np, attn, card, params, GEN_ENGINE,
                             bodies, "(3)")
    check(window["stats"]["prefills_cached"] >= 1,
          "the shared prompt never hit the prefix cache")

    # (4) Preemption: 4 lanes of 100-id prompts growing to 300 tokens
    # need 76 pages; the pool has 39.
    small = dict(GEN_ENGINE, decode_batch=4, n_pages=40,
                 prefix_cache_entries=0)
    bodies = [{"tokens": rng.integers(0, V, 100).tolist(), "max_new": 200,
               "temperature": 0.0, "seed": i} for i in range(4)]
    pre = generate_window(torch, np, attn, card, params, small, bodies,
                          "(4) preemption, engine " + json.dumps(small))
    check(pre["evictions"] >= 1 and pre["stats"]["preemptions"] >= 1,
          "pool pressure never preempted a sequence")
    out.update(window=window, preemption=pre)
    return window["k1_launches"] + pre["k1_launches"], out


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from rafiki_torch.ops import _build
        from rafiki_torch.ops import attention as attn
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1
    try:
        card = card_line()
        print(card, flush=True)
        secs = _build.build_all()
        print(f"build: kernels built in {secs:.1f} s", flush=True)
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            log = _build.build_log(name)
            print(f"build: {name}.cu: {ptxas_summary(log)}", flush=True)
            for line in build_warnings(log):
                print(f"build: {name}.cu: {line}", flush=True)
        k1 = kernel_phase(torch, attn)
        k1_train, k2, k3 = backward_phase(torch, attn)
        params, train_launches = train_phase(torch, np, attn, card)
        serve_launches = slice_phase(torch, np, attn, card, params)
        gen_launches, gen = generate_phase(torch, np, attn, card, params)
    except Exception:
        traceback.print_exc()
        return 1
    src = "rafiki_torch/ops/csrc/"
    print(json.dumps({"kernels": [
        dict(name="flash_fwd (K1)", route="cuda", source=src + "flash_fwd.cu",
             replaces="rafiki_tpu/ops/attention.py:162",
             launches=train_launches[0] + serve_launches + gen_launches,
             generate_launches=gen_launches,
             generate_buckets=gen["buckets"], **k1, **k1_train),
        dict(name="flash_bwd_dq (K2)", route="cuda",
             source=src + "flash_bwd_dq.cu",
             replaces="rafiki_tpu/ops/attention.py:338",
             launches=train_launches[1], **k2),
        dict(name="flash_bwd_dkv (K3)", route="cuda",
             source=src + "flash_bwd_dkv.cu",
             replaces="rafiki_tpu/ops/attention.py:401",
             launches=train_launches[2], **k3)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
