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
   ``kv_mask`` (one example fully padded), head_dim 80 and f32 shapes,
   holds K1's wgmma variant against its plain version at the train shape
   too, and times both kernels, their plain versions and, as the
   yardstick, ``torch.autograd.grad`` of ``scaled_dot_product_attention``
   (dq, dk and dv together, so its time covers K2 and K3 at once), and
   K1's two bf16 variants in turns beside ``scaled_dot_product_attention``;
5. train phase: trains ``TorchTransformerLM`` at flagship width
   (d_model 2048, 16 heads of 128, 8 layers, seq_len 2048, vocab 32768,
   batch 8, ``remat`` "dots", initialised on the card from the ``seed``
   knob) for 16 steps, two chunks of 8, on a synthetic Markov token
   stream; checks that every logged loss is finite, that the second
   chunk's mean loss is below the first's, and the launches per step
   (K2 and K3 once per layer, K1 twice: the forward and its rerun under
   "dots", every one on the wgmma variant); prints the step time, tokens
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
7. prints a ``{"kernels": [...]}`` line, in which ``library_covers``
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
        dq = attn.flash_attention_dq(*args, **kw)
        dk, dv = attn.flash_attention_dkv(*args, **kw)
        torch.cuda.synchronize()
        rq = attn.flash_attention_dq_reference(*args, **kw)
        rk, rv = attn.flash_attention_dkv_reference(*args, **kw)
        a, rtol = TOL_GRAD[str(dt).split(".")[1]]
        errs = {}
        for what, got, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
            err = (got.float() - ref.float()).abs()
            ok = bool((err <= a * ref.float().abs().max()
                       + rtol * ref.float().abs()).all())
            errs[what] = float(err.max())
            check(bool(torch.isfinite(got.float()).all()),
                  f"{what} non-finite ({name})")
            check(ok, f"{'K2' if what == 'dq' else 'K3'} {what} disagrees "
                  f"with its plain version ({name})")
        print(f"kernel K2/K3 {name:15s} ({b},{h},{tq},{tkv},{d}) "
              f"{str(dt)[6:]:8s} causal={causal!s:5s} "
              f"mask={lengths is not None!s:5s} max|ddq|={errs['dq']:.3e} "
              f"max|ddk|={errs['dk']:.3e} max|ddv|={errs['dv']:.3e} "
              f"(max|dq|={rq.float().abs().max().item():.3e}) ok",
              flush=True)
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

    (q, k, v, do, lse, delta), errs = flagship
    b, h, t, d = q.shape
    ms_q = time_ms(torch, lambda: attn.flash_attention_dq(
        q, k, v, do, lse, delta, causal=True), 20)
    ms_kv = time_ms(torch, lambda: attn.flash_attention_dkv(
        q, k, v, do, lse, delta, causal=True), 20)
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
    print(f"kernel train shape ({b},{h},{t},{t},{d}) bf16 causal: "
          f"K2 {ms_q:.4f} ms ({tf(3, ms_q):.1f} TFLOP/s, bound {b2_ms:.4f} "
          f"ms, plain {plain_q:.4f} ms); K3 {ms_kv:.4f} ms "
          f"({tf(4, ms_kv):.1f} TFLOP/s, bound {b3_ms:.4f} ms, plain "
          f"{plain_kv:.4f} ms); K2 + K3 {ms_q + ms_kv:.4f} ms against "
          f"autograd.grad of scaled_dot_product_attention (dq, dk, dv) "
          f"{lib_ms:.4f} ms ({lib_ms / (ms_q + ms_kv):.2f}x); K1 wgmma "
          f"{k1_ms['wgmma']:.4f} ms ({tf(2, k1_ms['wgmma']):.1f} TFLOP/s), "
          f"mma.sync {k1_ms['mma_sync']:.4f} ms "
          f"({tf(2, k1_ms['mma_sync']):.1f} TFLOP/s) (CUDA graphs, in "
          f"turns), bound {b1_ms:.4f} ms, scaled_dot_product_attention "
          f"{lib_fwd_ms:.4f} ms, wgmma max|do|={k1_errs[0]:.3e} "
          f"max|dlse|={k1_errs[1]:.3e} against its plain version, ok) "
          f"(989 TFLOP/s bf16, 3.35 TB/s)", flush=True)
    check(k1_ms["wgmma"] < k1_ms["mma_sync"],
          "K1's wgmma variant is not faster than mma.sync (train shape)")
    # The library call computes dq, dk and dv at once: its time covers
    # K2 and K3 together.
    both = ["flash_bwd_dq (K2)", "flash_bwd_dkv (K3)"]
    k1_train = {"train_ms": k1_ms["wgmma"], "train_bound_ms": b1_ms,
                "train_library_ms": lib_fwd_ms,
                "train_mma_sync_ms": k1_ms["mma_sync"],
                "train_max_abs_err": k1_errs[0]}
    return (k1_train,
            {"max_abs_err": errs["dq"], "ms": ms_q, "plain_ms": plain_q,
             "bound_ms": b2_ms, "bound_by": b2_by, "library_ms": lib_ms,
             "library_covers": both},
            {"max_abs_err": max(errs["dk"], errs["dv"]), "ms": ms_kv,
             "plain_ms": plain_kv, "bound_ms": b3_ms, "bound_by": b3_by,
             "library_ms": lib_ms, "library_covers": both})


def launch_counts(attn):
    """(K1, K2, K3, K1 on its wgmma variant)."""
    return (attn.flash_attention.launches, attn.flash_attention_dq.launches,
            attn.flash_attention_dkv.launches,
            attn.flash_attention.variant_launches["wgmma"])


def reset_launch_counts(attn):
    attn.flash_attention.launches = 0
    for variant in attn.flash_attention.variant_launches:
        attn.flash_attention.variant_launches[variant] = 0
    attn.flash_attention_dq.launches = 0
    attn.flash_attention_dkv.launches = 0


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
          f"{per_step[3]:g}), K2 {per_step[1]:g}, K3 {per_step[2]:g} ({L} "
          f"layers, remat {knobs['remat']!r})", flush=True)
    check(per_step == [2 * L, L, L, 2 * L],
          f"launches per step {per_step}: expected K1 {2 * L} (the forward "
          f"and its rerun under 'dots'), all on wgmma, K2 {L}, K3 {L}")
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

    profile(torch, one_step, f"one train step (batch {b} x {t})", card, 14)
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


def profile(torch, fn, what, card, top=10) -> None:
    """Where the time of one ``fn()`` goes on the card: device time by
    kernel, and the device's busy share of the wall time."""
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
        return
    print(f"profile: {what}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%) on {card}",
          flush=True)
    for us, n, key in sorted(rows, reverse=True)[:top]:
        print(f"profile: {100 * us / busy:5.1f}% {us / 1e3:8.3f} ms "
              f"x{n:<4d} {key[:90]}", flush=True)


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
            print(f"build: {name}.cu: {ptxas_summary(_build.build_log(name))}",
                  flush=True)
        k1 = kernel_phase(torch, attn)
        k1_train, k2, k3 = backward_phase(torch, attn)
        params, train_launches = train_phase(torch, np, attn, card)
        serve_launches = slice_phase(torch, np, attn, card, params)
    except Exception:
        traceback.print_exc()
        return 1
    src = "rafiki_torch/ops/csrc/"
    print(json.dumps({"kernels": [
        dict(name="flash_fwd (K1)", route="cuda", source=src + "flash_fwd.cu",
             replaces="rafiki_tpu/ops/attention.py:162",
             launches=train_launches[0] + serve_launches, **k1, **k1_train),
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
