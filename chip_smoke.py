#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (the
kernels are built for sm_90a with nvcc and Triton at first use, into
``build/paddle_tpu_torch/``). Phases, each of which raises on failure:

1. card check: CUDA must be available; prints the card's name and
   power limit (nvidia-smi);
2. build: compiles the CUDA kernels (ragged paged attention, paged
   decode attention, flash attention, the weight-gradient accumulation;
   one nvcc per source, started together) and the Triton RMSNorm and LayerNorm kernels from the
   sources in the checkout, printing nvcc's register/spill report;
3. each kernel against its plain PyTorch version on the card, at the
   shapes of the Llama-2-7B serving step below (the RMSNorm forward at
   the training step's (8, 2048, 4096) too), in bf16 and fp32, with
   the kernel's time, the plain version's time, the least time the card
   could take (bound) and a one-call library yardstick where one exists;
   the ragged kernels on a mixed, a prefill-only, a decode-only and a
   lone-prompt-token batch (nkv 32 and 8) with the unified step's
   ``decoding`` flags, each on the routes the call takes (wgmma tiles and
   the key split with its merge), with each decoding token walked by one block
   (one chunk) and with every token forced through the key split, and
   their registers, spills, shared memory and wgmma/atomic instructions
   (fails if a 16-bit instantiation spills, the wgmma kernel issues no
   HGMMA, or any uses atomics);
4. the paged decode kernels (the key split and its merge) against their
   plain version at the 7B legacy decode step's shapes (8 rows, 32
   heads, d 128, page 16, 64-page tables; lengths 0 to 1000), KV heads
   32 and 8, bf16 and fp32, and a d 64 case, two runs bitwise equal and
   each kernel's launches counted, with the chunk ``decode_split``
   picks, its times (and at other chunk sizes, the whole span being the
   grid before the split), bound, the ragged kernels' time on the same
   batch, and the kernels' registers, spills and shared memory (fails as
   phase 3);
5. tiny end-to-end parity: the serving engine on the card (kernels,
   its steps CUDA graphs) against the same engine on the CPU (plain
   versions), fp32, TF32 off — greedy tokens must be identical;
6. the same for the legacy pipeline (``unified=False``) with the prefix
   cache off and on (a shared-prefix request and an exact repeat, which
   copies a page on write) and for the generate engines
   (``PagedGenerationEngine`` and ``llama_engine``, each one CUDA graph
   a key), the page books audited after every step;
7. the slice at full width: Llama-2-7B (32 layers, bf16, seeded random
   weights) served by ``ContinuousBatchingEngine`` — 12 requests of
   32-512 prompt tokens through 8 slots, 32 new tokens each — with
   the kernels' launch counters checked against the micro-rounds run
   (graph replays counted), its compiled programs (one unified-step
   CUDA graph) and a profiled breakdown of a prefill and a decode step;
   served once through the graphs and once through the engine's eager
   card path, with identical greedy tokens, each run's step wall,
   kernel device time, idle share, tokens/s, peak memory, program
   builds and capture seconds;
8. the same weights and load through the legacy pipeline (prefill waves
   over the flash forward, decode steps over the paged decode kernel;
   one graph per prefill key and one for the decode chunk), its launch
   counts checked against the waves and decode steps run and a profiled
   breakdown of its steps; then a wave of 8 requests sharing a 256-token
   prefix through the unified engine with the prefix cache, warm (after
   one primer request) and cold, with the prefill tokens the cache
   skipped and no page leaked; each through the graphs and eagerly, as
   phase 7;
9. the RMSNorm backward kernel against its plain version at the train
   step's (rows, h) = (16384, 4096), bf16 and fp32, with its time, bound
   and the backward of ``F.rms_norm`` as the yardstick;
10. the flash-attention forward, dQ and dK/dV kernels against their
    plain versions: causal at BH 32, S 2048, d 128 in bf16 and fp32, a
    GQA case (8 KV heads), a padded-key case (``kv_valid`` 2000) and an
    unpadded S 2000; then at the train step's shape (BH 256, S 2048,
    bf16) with times, bounds and ``F.scaled_dot_product_attention``
    forward and backward as the yardsticks. Each of out, dq, dk and dv
    is held to a tolerance scaled by its own rms
    (``paddle_tpu_torch.testing``'s ``FLASH_TOL``, which
    tests/test_torch_gpu.py applies too). It lists each d-128
    instantiation's registers, spill bytes (from nvcc's ``-Xptxas -v``),
    shared memory and wgmma (HGMMA) and atomic instructions (from
    ``cuobjdump -sass``), and fails if a bf16 one spills or issues no
    wgmma, or any uses atomics;
11. tiny training parity: ``build_train_step`` with full remat for 5
    AdamW steps on the card (kernels) and on the CPU (plain versions),
    fp32, TF32 off, from the same weights — losses and weights agree;
12. the training slice at full width: Llama-2-7B widths with 8 layers
    (the one cut: 32 layers of bf16 weights, gradients and fp32 AdamW
    moments do not fit one 80 GB card), vocab 32000, one (1, 8, 2048)
    batch, 2 warm-up and 5 timed steps, every step's launch counts
    checked, the loss falling, and a profiler breakdown of one step;
13. the LayerNorm forward and backward kernels against their plain
    versions at the BERT-large step's (rows, h) = (8192, 1024), eps
    1e-12, bf16 and fp32, with ``F.layer_norm`` forward and backward as
    the yardsticks; the backward at ``ln_bwd_config``'s launch, at the
    launch it replaced and at variants, dw and db bitwise repeatable;
14. the flash forward, dQ and dK/dV kernels with segment ids against
    their plain versions at the BERT-large step's shape (BH 16·16, S
    512, d 64, non-causal) and the packed batch's segment ids, bf16 and
    fp32, with SDPA under the boolean segment mask as the yardstick, the
    share of 64 x 64 tile pairs the bf16 kernels skip for their segment
    ids, and the d-64 instantiations' registers, spills and shared
    memory;
15. tiny ERNIE training parity: ``build_mlm_train_step`` for 5 packed
    MLM steps on the card (kernels) and on the CPU (plain versions),
    fp32, TF32 off, d 64 heads — losses and weights agree;
16. packed BERT-large MLM pretraining at full width (24 layers, h 1024,
    16 heads, vocab 30522; nothing cut): ``bench_bert_packed``'s
    (16, 512) batch packed from seed 0, bf16 weights with fp32 master
    weights and AdamW moments, 2 warm-up and 5 timed steps, every step's
    launch counts checked, the loss falling, real tokens/s, MFU by
    ``bench_bert_packed``'s accounting and a profiler breakdown;
17. the weight-gradient accumulation kernel (``acc += xᵀ·dout`` into an
    fp32 ``main_grad``) against its plain version at the Llama-2-7B
    projections' shapes for a (2, 2048) micro-batch — (din, dout) =
    (4096, 4096), (4096, 11008), (11008, 4096), 4096 rows — in bf16 and
    fp32, into a bf16 accumulator, in fp16, at an unaligned shape and at
    a shape whose rows the wgmma route splits, with the route each case
    takes, its time over rotating inputs, the WMMA kernel's time on the
    same inputs where the wgmma route takes them (two runs bitwise
    equal), bound, plain time and a library yardstick; and the kernels'
    registers, spills, shared memory and wgmma/atomic instructions (fails
    as phase 3);
18. tiny main-grad training parity: the imperative ``LlamaForCausalLM``
    under ``MixPrecisionLayer`` and ``GradientMergeOptimizer(
    MixPrecisionOptimizer(AdamW), k_steps=2)`` for 3 updates on the card
    and on the CPU, fp32, TF32 off — losses, main grads and weights
    agree — and ``linear_with_main_grad``'s gradients;
19. main-grad training at full width: the imperative Llama at Llama-2-7B
    widths with 8 layers (phase 12's cut), bf16 weights, fp32 main
    grads, master weights and moments, 4 micro-batches of (2, 2048) a
    step; 2 warm-up and 3 timed steps, every step's launch counts
    checked, the loss falling, a profiler breakdown; then one more step
    whose projections' own operands go through the accumulation kernel
    (7·L·k = 224 launches, all on the wgmma route), each accumulator
    matching its ``main_grad``;
20. tiny decoding-options parity (run after phase 8): a mixed greedy /
    sampled / grammar-constrained serve, unified and speculative, the
    engine-wide ``do_sample`` on the unified and legacy pipelines and
    ``PagedGenerationEngine`` — tokens through the CUDA graphs equal the
    eager card run's and the CPU's (fp32, TF32 off), constrained streams
    legal, one program build each with the sampling epilogue on;
21. decoding options at full width, on phase 7's weights and geometry
    (run after phase 20): phase 7's load served as a mix of greedy,
    sampled (temperature 0.8, top-k 50, top-p 0.95) and JSON-constrained
    requests, then greedy with ``speculative=True, spec_k=4`` three
    times: with the default n-gram drafter, with drafts taken from phase
    7's greedy streams, and with drafts taken from the second serve's
    streams; each through the graphs and eagerly with identical tokens,
    every serve's tokens equal to phase 7's greedy streams and every
    stream draft accepted (fails otherwise), launch counts checked; the
    sampled decode step's wall, device time and idle share beside phase
    7's greedy step, and a speculative decode round's wall, idle share
    and tile sizes (the n-gram drafter's, and full spans of k+1 tokens,
    each span token a one-token tile on the key split);
22. the generate engines on phase 7's weights (run after phase 21):
    ``llama_engine`` at the reference's ``decode`` workload shape (8
    prompts of 512 tokens, 128 new tokens; all 32 layers) through one
    CUDA graph a key, with the prefill's and the whole generate's wall,
    decode tokens/s, the decode step's device time by kind (matmul,
    cached attention, RMSNorm, other), idle share and its HBM bound,
    RMSNorm launches (2L+1 a step), builds, capture seconds, graph-pool,
    peak and reserved memory, and tokens equal to the eager card run's;
    then ``PagedGenerationEngine`` over phase 7's 12 prompts, 32 new
    tokens, two calls of one key (one build), graphs against eager,
    launch counts checked;
23. the serving scheduler on phase 7's warm engine (run right after
    phase 7): phase 7's 12 prompts through ``ServingScheduler`` with
    priority i % 3, a deadline on even requests and a queue cap of 10
    (two shed at submit), one request cancelling itself from its
    ``on_token`` after 4 tokens and one read by a consumer thread;
    fails unless the shed and cancelled requests are the reference
    policy's, the finished streams equal the engine-only oracle (the
    same engine's serve in admission order), the page books hold after
    the cancel and at the end, no program is built, a second scheduler
    with ``step_timeout_s`` (its steps on the watchdog thread) gives the
    same tokens, and the armed memory ledger's weight and pool bytes
    equal the tensors' with ``plan_capacity`` predicting the pool's
    pages; reports scheduled against engine-only tokens/s, TTFT / ITL /
    e2e / queue-wait p50 and p99, the host gap between engine steps, a
    profiled prefill and decode step's idle share, the step wall with
    every tap armed against disarmed (A B B A by step), and the share
    of tokens equal to phase 7's greedy streams.

The line before the card line lists every kernel with its numbers; the
last line is ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import subprocess
import sys
import threading
import time

import numpy as np

N_PHASES = 23
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS_PER_S = {                 # H100 SXM dense peaks
    "bf16": 989e12,                # tensor cores, bf16
    "fp32": 67e12,                 # fp32 outside the tensor cores
}
SEED = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def eager_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Per-call time of ``fn`` called eagerly back to back (CUDA events
    around ``iters`` calls): the device time, or the host's launch time
    where that is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed, timed with CUDA events — free of the host's
    per-launch cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return ms


def bound_ms(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(torch, name, got, want, rtol, atol):
    """``got`` finite and within (rtol, atol) of ``want``; returns max
    |got - want| (``paddle_tpu_torch.testing.close``)."""
    from paddle_tpu_torch import testing
    return testing.close(got, want, rtol, atol, name)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def rms_norm_phase(torch, rn):
    """rms_norm at the shapes of both main paths: the 7B serving step's
    (T, h) = (256, 4096), and the training step's (B, S, h) = (8, 2048,
    4096) as ``decoder_layer`` passes it (16384 rows)."""
    h, eps = 4096, 1e-5
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    report = {}
    # tolerances: fp32 differs only in the order of the row sum; a bf16
    # output may differ by one rounding step (8 mantissa bits)
    for path, shape, plain_iters in (("serve", (256, h), 20),
                                     ("train", (8, 2048, h), 3)):
        for dt, kind, rtol, atol in ((torch.bfloat16, "bf16", 1.6e-2, 1e-5),
                                     (torch.float32, "fp32", 1e-5, 1e-6)):
            x = torch.randn(shape, generator=gen, device="cuda").to(dt)
            w = (1 + 0.1 * torch.randn(h, generator=gen,
                                       device="cuda")).to(dt)
            got = rn.rms_norm_kernel(x, w, eps)
            torch.cuda.synchronize()
            err = check_close(torch, f"rms_norm {path} {kind}", got,
                              rn.rms_norm_plain(x, w, eps), rtol, atol)
            rows = x.numel() // h
            isz = x.element_size()
            nbytes = 2 * rows * h * isz + h * isz
            bms, by = bound_ms(nbytes, 4 * rows * h, "fp32")
            lib = None
            if hasattr(torch.nn.functional, "rms_norm"):
                lib = device_ms(torch, lambda: torch.nn.functional.rms_norm(
                    x, (h,), w, eps))
            key = kind if path == "serve" else f"{path}_{kind}"
            report[key] = dict(
                shape=list(shape), max_abs_err=err, rtol=rtol, atol=atol,
                ms=device_ms(torch, lambda: rn.rms_norm_kernel(x, w, eps)),
                eager_ms=eager_ms(torch, lambda: rn.rms_norm_kernel(
                    x, w, eps)),
                plain_ms=device_ms(torch, lambda: rn.rms_norm_plain(
                    x, w, eps), iters=plain_iters),
                bound_ms=bms, bound_by=by, library_ms=lib)
            del x, w, got
            torch.cuda.empty_cache()
    return report


#: the ragged batches of phase 3, as (first position, tokens, decoding)
#: per row, flagged as the unified step flags them (a decode row's carry
#: decodes, a prompt chunk's tokens do not): the mixed step (five decode
#: rows at different lengths, a cold and a warm prefill chunk, an idle row
#: and pads), a prefill-only micro-round (a cold and a warm 128-token
#: chunk), a decode-only one (the 7B decode step's 8 rows, one token each,
#: and 248 pads) and lone prompt tokens (one-token prompts and a chunk's
#: last token cut off alone, each a one-token wgmma tile) beside decode
#: tokens and a short chunk
RAGGED_BATCHES = {
    "mixed": [(999, 1, True), (732, 1, True), (516, 1, True),
              (300, 1, True), (94, 1, True), (0, 180, False),
              (400, 60, False)],
    "prefill": [(0, 128, False), (384, 128, False)],
    "decode": [(0, 1, True), (15, 1, True), (16, 1, True), (999, 1, True),
               (516, 1, True), (300, 1, True), (94, 1, True),
               (732, 1, True)],
    "lone_prompt": [(0, 1, False), (127, 1, False), (999, 1, True),
                    (300, 1, True), (64, 1, False), (500, 40, False)],
}


def ragged_batch(torch, nkv, dtype, rows=RAGGED_BATCHES["mixed"], nh=32,
                 d=128, page=16, width=64, n_tokens=256):
    """A ragged batch at the 7B step's shapes: the rows' tokens packed in
    order, one idle row, pads up to ``n_tokens``. Returns the kernel's
    arguments, the ``decoding`` flags, the real tokens, and the bytes and
    operations the batch needs."""
    rng = np.random.RandomState(SEED)
    n_rows = len(rows) + 1                        # + one idle row
    n_pages = n_rows * width + 1
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((n_rows, width), np.int32)
    kv_lens = np.zeros((n_rows,), np.int32)
    token_row = np.full((n_tokens,), -1, np.int32)
    positions = np.zeros((n_tokens,), np.int32)
    decoding = np.zeros((n_tokens,), bool)
    cursor, used = 0, 0
    for r, (p0, n, dec) in enumerate(rows):
        kv_lens[r] = p0 + n
        npg = -(-int(kv_lens[r]) // page)
        bt[r, :npg] = perm[used:used + npg]
        used += npg
        token_row[cursor:cursor + n] = r
        positions[cursor:cursor + n] = p0 + np.arange(n)
        decoding[cursor:cursor + n] = dec
        cursor += n
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    pool = (n_pages, page, nkv, d)
    k = torch.randn(pool, generator=gen, device="cuda").to(dtype)
    v = torch.randn(pool, generator=gen, device="cuda").to(dtype)
    q = torch.randn((n_tokens, nh, d), generator=gen,
                    device="cuda").to(dtype)
    meta = [torch.from_numpy(a).cuda()
            for a in (bt, token_row, positions, kv_lens)]
    # work this batch needs: each row's keys 0..max position, read once
    real = token_row >= 0
    keys = sum(p0 + n for p0, n, _ in rows)
    isz = k.element_size()
    nbytes = (2 * q.numel() * isz + 2 * keys * nkv * d * isz
              + sum(a.numel() * 4 for a in meta))
    ops = 4 * int((positions[real] + 1).sum()) * nh * d
    return ((q, k, v, *meta), torch.from_numpy(decoding).cuda(), real,
            nbytes, ops)


def attention_phase(torch, pa):
    """The ragged kernels against their plain version on the four
    batches of ``RAGGED_BATCHES`` with the unified step's ``decoding``
    flags (nkv 32 and 8; bf16, and fp32 for the mixed batch), pads
    exactly 0, with the routes the call takes, the key
    split's chunk (decode_split) and the time of each: ``ms`` the call's
    own kernels (wgmma tiles + key split + merge, or the key split and
    merge alone) and each kernel's profiled device ms, ``one_chunk_ms``
    the same with each single token walked by one block (the key split
    before the chunks), ``key_split_ms`` every token through the key
    split. No library yardstick (no PyTorch call gathers pages). Then the
    kernels' registers, spills, shared memory and wgmma/atomic
    instructions."""
    report = {}
    # tolerances: fp32 differs in summation order and the online (kernel)
    # vs two-pass (plain) softmax; in bf16 the plain version rounds the
    # probabilities to bf16 before P·V (as the JAX array path and the
    # wgmma route do) while the key split keeps them in fp32 (as the
    # Pallas kernel does)
    cases = [(b, nkv, dt) for b in RAGGED_BATCHES for nkv in (32, 8)
             for dt in ("bf16", "fp32") if b == "mixed" or dt == "bf16"]
    for batch, nkv, kind in cases:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        rtol, atol = (2e-2, 2e-2) if kind == "bf16" else (1e-4, 1e-5)
        args, dec, real, nbytes, ops = ragged_batch(torch, nkv, dt,
                                                    RAGGED_BATCHES[batch])
        args = (*args, dec)
        want = pa.ragged_paged_attention_plain(*args[:-1])
        errs = {}
        for route in (None, "key_split"):
            got = pa.ragged_paged_attention_kernel(*args, route=route)
            torch.cuda.synchronize()
            errs[route] = check_close(
                torch, f"attention {batch} nkv={nkv} {kind} "
                f"{route or 'auto'}", got, want, rtol, atol)
            pads = torch.from_numpy(~real).cuda()
            if not bool((got[pads] == 0).all()):
                raise AssertionError("pad slots must come out exactly 0")
            del got
        bms, by = bound_ms(nbytes, ops, kind)
        key = f"nkv{nkv}_{kind}" if batch == "mixed" else \
            f"{batch}_nkv{nkv}_{kind}"
        chunk, n_chunks = pa.ragged_split(256, args[3].shape[0], 64 * 16, 32,
                                          nkv, 128, dt, "cuda")
        report[key] = dict(
            batch=batch, nh=32, nkv=nkv, d=128, page=16,
            tokens=int(real.sum()),
            routes=list(pa.ragged_route(dt, 16, 32, nkv)),
            chunk=chunk, n_chunks=n_chunks,
            max_abs_err=max(errs.values()), rtol=rtol, atol=atol,
            ms=device_ms(torch, lambda: pa.ragged_paged_attention_kernel(
                *args)),
            profiled_ms=kernel_breakdown_ms(
                torch, lambda: pa.ragged_paged_attention_kernel(*args),
                (("tiles", ("ragged_tiles_kernel",)),
                 ("key_split", ("ragged_key_split_kernel",)),
                 ("merge", ("decode_merge_kernel",)))),
            one_chunk_ms=device_ms(
                torch, lambda: pa.ragged_paged_attention_kernel(
                    *args, chunk=1024)),
            key_split_ms=device_ms(
                torch, lambda: pa.ragged_paged_attention_kernel(
                    *args, route="key_split")),
            eager_ms=eager_ms(torch, lambda: pa.
                              ragged_paged_attention_kernel(*args)),
            plain_ms=device_ms(torch, lambda: pa.
                               ragged_paged_attention_plain(*args[:-1]),
                               iters=2, replays=2),
            bound_ms=bms, bound_by=by, library_ms=None)
        del args, dec, want
        torch.cuda.empty_cache()
    report["resources"] = _cuda_resources(
        "ragged_paged_attention", wgmma=("ragged_tiles_kernel",),
        others=("ragged_key_split_kernel", "decode_merge_kernel"),
        smem=lambda fn: pa.
        ragged_smem_bytes(128 if "Li128E" in fn else 64)
        if "ragged_tiles_kernel" in fn else None, report=report)
    return report


def _cuda_resources(source, wgmma, others, smem=lambda fn: None,
                    report=None):
    """Registers and spill bytes (ptxas), dynamic shared memory and the
    SASS's wgmma (HGMMA) and atomic instructions of each instantiation of
    the kernels of ``csrc/<source>.cu`` whose names hold a fragment of
    ``wgmma`` (each must issue wgmma) or ``others``; fails if a 16-bit
    instantiation spills, a wgmma one issues no HGMMA, or any uses
    atomics."""
    from paddle_tpu_torch.ops import _common
    ptxas = _common.ptxas_report(source)
    sass = _common.sass_counts(source)
    out, bad = {}, []
    for fn, r in ptxas.items():
        tc = any(f in fn for f in wgmma)
        if not tc and not any(f in fn for f in others):
            continue
        r = dict(r, **sass.get(fn, {}), smem_bytes=smem(fn))
        sixteen = "__nv_bfloat16" in fn or "6__half" in fn
        if (r.get("atomics") or (sixteen and (r.get("spill_stores")
                                              or r.get("spill_loads")))
                or (tc and not r.get("hgmma"))):
            bad.append(fn)
        out[fn] = r
    if bad or not out:
        raise AssertionError((f"{source}: kernels spill, lack wgmma or use "
                              f"atomics: {bad}" if bad else
                              f"{source}: no ptxas report")
                             + f"; the phase measured {json.dumps(report)}")
    return out


# ---------------------------------------------------------------------------
# phase 4: the paged decode kernel against its plain version
# ---------------------------------------------------------------------------

def decode_batch(torch, nkv, dtype, nh=32, d=128, page=16, width=64):
    """A decode batch at the 7B legacy decode step's shapes: 8 rows of
    lengths 1, a page edge (16, 17), ~1000 and a spread, and one empty
    row (seq_len 0, which must come out exactly 0). Returns the kernel's
    arguments, the same batch in the ragged kernel's form (one token per
    row at position seq_len - 1, flagged decoding; the empty row a pad
    slot), the bytes the
    batch needs and the operations it does."""
    seq_lens = np.array([1, 16, 17, 1000, 0, 517, 301, 95], np.int32)
    b = len(seq_lens)
    rng = np.random.RandomState(SEED)
    n_pages = b * width + 1
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((b, width), np.int32)
    used = 0
    for r, n in enumerate(seq_lens):
        npg = -(-int(n) // page)
        bt[r, :npg] = perm[used:used + npg]
        used += npg
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    pool = (n_pages, page, nkv, d)
    k = torch.randn(pool, generator=gen, device="cuda").to(dtype)
    v = torch.randn(pool, generator=gen, device="cuda").to(dtype)
    q = torch.randn((b, nh, d), generator=gen, device="cuda").to(dtype)
    bt_d, sl_d = (torch.from_numpy(a).cuda() for a in (bt, seq_lens))
    real = seq_lens > 0
    ragged_meta = [torch.from_numpy(a).cuda() for a in (
        np.where(real, np.arange(b), -1).astype(np.int32),
        np.maximum(seq_lens - 1, 0).astype(np.int32), seq_lens, real)]
    isz = k.element_size()
    keys = int(seq_lens.sum())
    nbytes = (2 * q.numel() * isz + 2 * keys * nkv * d * isz
              + bt.nbytes + seq_lens.nbytes)
    ops = 4 * keys * nh * d
    return (q, k, v, bt_d, sl_d), ragged_meta, nbytes, ops


#: chunk sizes phase 4 times beside decode_split's own; the table's span
#: (1024 keys) is one chunk, one block per row and head group (PR 4's grid)
DECODE_CHUNKS = (64, 128, 256, 512, 1024)


def paged_decode_phase(torch, pa):
    """The paged decode kernels against their plain version at the legacy
    decode step's shapes (B 8, nh 32, d 128, page 16, W 64), nkv 32 and
    8, bf16 and fp32, and a d 64 case; the empty row must be exactly 0
    and two runs bitwise equal, one call counted with one key-split and
    one merge launch. Times: device ms (CUDA-graph replays over rotating
    copies of the pools, so the ~45 MB of K/V a call reads come from
    device memory and not the 50 MB L2) at decode_split's chunk and, for
    16-bit pools, at each of ``DECODE_CHUNKS`` (the span: the grid the
    kernel had before the split), each kernel's profiled device ms, eager
    ms, the plain version's, the bound, and the ragged kernels on the
    same batch (one token per row) at their own chunk and at one
    chunk. No single PyTorch call gathers
    pages (library: none). Then the kernels' registers, spills and shared
    memory."""
    report = {}
    # tolerances: those of the ragged phase, for the same reasons (fp32:
    # summation order, online vs two-pass softmax; bf16: the plain version
    # rounds P to bf16 before P·V as the JAX array path does, the kernel
    # keeps it in fp32 as the Pallas kernel does)
    for nkv, d, dt, kind, rtol, atol in (
            (32, 128, torch.bfloat16, "bf16", 2e-2, 2e-2),
            (32, 128, torch.float32, "fp32", 1e-4, 1e-5),
            (8, 128, torch.bfloat16, "bf16", 2e-2, 2e-2),
            (8, 128, torch.float32, "fp32", 1e-4, 1e-5),
            (8, 64, torch.bfloat16, "bf16", 2e-2, 2e-2)):
        args, rmeta, nbytes, ops = decode_batch(torch, nkv, dt, d=d)
        name = f"nkv{nkv}_d{d}_{kind}"
        chunk, n_chunks = pa.paged_split(8, 64 * 16, 32, nkv, d, dt, "cuda")
        _reset({"decode": pa.paged_attention})
        got = pa.paged_attention_kernel(*args)
        again = pa.paged_attention_kernel(*args)
        torch.cuda.synchronize()
        counts = dict(calls=pa.paged_attention.launches,
                      **pa.paged_attention.route_launches)
        if counts != dict(calls=2, key_split=2, merge=2 * (n_chunks > 1)):
            raise AssertionError(f"paged decode {name}: counts {counts}")
        if not torch.equal(got, again):
            raise AssertionError(f"paged decode {name}: two runs differ")
        want = pa.paged_attention_plain(*args)
        err = check_close(torch, f"paged decode {name}", got, want, rtol,
                          atol)
        if not bool((got[4] == 0).all()):
            raise AssertionError("paged decode: the empty row must be 0")
        q, k, v, bt, sl = args
        copies = _l2_cold((k, v))
        nxt = itertools.cycle(copies).__next__
        bms, by = bound_ms(nbytes, ops, kind)
        chunk_ms = {}
        for c in (DECODE_CHUNKS if kind == "bf16" else (1024,)):
            check_close(torch, f"paged decode {name} chunk {c}",
                        pa.paged_attention_kernel(*args, chunk=c), want,
                        rtol, atol)
            chunk_ms[c] = device_ms(torch, lambda: pa.paged_attention_kernel(
                q, *nxt(), bt, sl, chunk=c))
        report[name] = dict(
            b=8, nh=32, nkv=nkv, d=d, page=16, width=64,
            keys=int(sl.sum()), chunk=chunk, n_chunks=n_chunks,
            profiled_ms=kernel_breakdown_ms(
                torch, lambda: pa.paged_attention_kernel(q, *nxt(), bt, sl),
                (("key_split", ("paged_decode_attention_kernel",)),
                 ("merge", ("decode_merge_kernel",)))),
            max_abs_err=err, rtol=rtol, atol=atol,
            ms=device_ms(torch, lambda: pa.paged_attention_kernel(
                q, *nxt(), bt, sl)),
            one_chunk_ms=chunk_ms[1024], chunk_ms=chunk_ms,
            eager_ms=eager_ms(torch, lambda: pa.paged_attention_kernel(
                q, *nxt(), bt, sl)),
            plain_ms=device_ms(torch, lambda: pa.paged_attention_plain(
                *args), iters=2, replays=2),
            bound_ms=bms, bound_by=by, library_ms=None,
            ragged_kernel_ms=device_ms(
                torch, lambda: pa.ragged_paged_attention_kernel(
                    q, *nxt(), bt, *rmeta)),
            ragged_one_chunk_ms=device_ms(
                torch, lambda: pa.ragged_paged_attention_kernel(
                    q, *nxt(), bt, *rmeta, chunk=1024)))
        del args, rmeta, got, again, want, copies, nxt, q, k, v
        torch.cuda.empty_cache()
    report["resources"] = _cuda_resources(
        "paged_decode_attention", wgmma=(),
        others=("paged_decode_attention_kernel", "decode_merge_kernel"),
        report=report)
    return report


# ---------------------------------------------------------------------------
# phase 5: tiny end-to-end parity, card vs CPU
# ---------------------------------------------------------------------------

def parity_phase(torch, L, D):
    cfg = L.llama_tiny(hidden_size=256, num_attention_heads=2,
                       num_key_value_heads=2, intermediate_size=512,
                       num_hidden_layers=2, dtype=torch.float32)
    params_cpu = L.init_params(cfg, seed=SEED, device="cpu")
    params_gpu = {k: v.cuda() for k, v in params_cpu.items()}
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 40, 17, 3, 29)]
    outs = []
    for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        eng = D.ContinuousBatchingEngine(
            cfg, D.GenerationConfig(max_new_tokens=8), num_slots=2,
            page_size=16, max_seq_len=128, chunk=4, device=dev)
        outs.append(eng.serve(params, prompts))
        eng.mgr.check_conservation()
    if outs[0] != outs[1]:
        raise AssertionError(f"card tokens {outs[0]} != cpu tokens "
                             f"{outs[1]}")
    return {"requests": len(prompts), "tokens": outs[0]}


def _serve_checked(eng, params, prompts, max_steps=200):
    """Serve ``prompts`` step by step, auditing the page books after
    every step. Returns the tokens in submission order and each step's
    wall time (ms; a step ends in its one device->host copy)."""
    rids = [eng.submit(p) for p in prompts]
    results, step_ms = {}, []
    while len(results) < len(rids):
        t0 = time.perf_counter()
        eng.step(params)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        eng.mgr.check_conservation()
        results.update(eng.collect())
        if len(step_ms) > max_steps:
            raise AssertionError(f"serve did not finish in {max_steps} steps")
    return [results[r] for r in rids], step_ms


# ---------------------------------------------------------------------------
# phase 6: tiny legacy-pipeline parity, card vs CPU
# ---------------------------------------------------------------------------

def legacy_parity_phase(torch, L, D):
    """Phase 5's config and weights through the legacy pipeline
    (``unified=False``), with the prefix cache off and on (a request
    sharing two pages of an earlier prompt, and an exact repeat of a
    whole-page prompt, which copies its last page), and through
    ``PagedGenerationEngine`` and ``llama_engine`` (each one CUDA graph a
    key): greedy tokens on the card (kernels) equal the CPU's (plain
    versions), fp32, TF32 off; the page books are audited after every
    step."""
    cfg = L.llama_tiny(hidden_size=256, num_attention_heads=2,
                       num_key_value_heads=2, intermediate_size=512,
                       num_hidden_layers=2, dtype=torch.float32)
    params_cpu = L.init_params(cfg, seed=SEED, device="cpu")
    params_gpu = {k: v.cuda() for k, v in params_cpu.items()}
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 40, 17, 3, 32)]
    prompts += [np.concatenate([prompts[1][:32], prompts[0]]),
                prompts[4].copy()]
    report = {}
    for cache in (False, True):
        outs, snaps = [], []
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            eng = D.ContinuousBatchingEngine(
                cfg, D.GenerationConfig(max_new_tokens=8), num_slots=2,
                page_size=16, max_seq_len=128, chunk=4, device=dev,
                unified=False, prefix_cache=cache)
            outs.append(_serve_checked(eng, params, prompts)[0])
            snaps.append(eng.cache.snapshot() if cache else None)
        if outs[0] != outs[1]:
            raise AssertionError(f"legacy (cache {cache}): card tokens "
                                 f"{outs[0]} != cpu tokens {outs[1]}")
        if cache and not (snaps[0]["hits"] >= 2
                          and snaps[0]["cow_copies"] >= 1
                          and snaps[0] == snaps[1]):
            raise AssertionError(f"cache stats card {snaps[0]} cpu "
                                 f"{snaps[1]}")
        report["legacy_cache" if cache else "legacy"] = dict(
            tokens=outs[0], cache=snaps[0])
    gen = [D.PagedGenerationEngine(cfg, D.GenerationConfig(
        max_new_tokens=8), page_size=16, device=dev).generate(
            params, prompts[:5])
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu))]
    if not np.array_equal(gen[0], gen[1]):
        raise AssertionError(f"PagedGenerationEngine: card {gen[0]} != "
                             f"cpu {gen[1]}")
    report["paged_generation"] = gen[0].tolist()
    ids = np.stack([prompts[i][:5] for i in (0, 1, 2, 4)])
    gen = [D.llama_engine(cfg, D.GenerationConfig(max_new_tokens=8),
                          device=dev).generate(params, ids)
           for dev, params in (("cuda", params_gpu), ("cpu", params_cpu))]
    if not np.array_equal(gen[0], gen[1]):
        raise AssertionError(f"GenerationEngine: card {gen[0]} != "
                             f"cpu {gen[1]}")
    report["generation"] = gen[0].tolist()
    return report


# ---------------------------------------------------------------------------
# phase 7: Llama-2-7B at full width through the serving engine
# ---------------------------------------------------------------------------

NEW_TOKENS = 32


def init_7b(torch, L):
    """Llama-2-7B (32 layers, bf16) with seeded random weights, made once
    for phases 7 and 8. Returns (config, params, seconds)."""
    cfg = L.llama2_7b(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = L.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


def serve_load(cfg):
    """The smoke's serve load: 12 prompts of 32-512 tokens (seed 0)."""
    rng = np.random.RandomState(SEED)
    lens = rng.randint(32, 513, size=12)
    return [rng.randint(1, cfg.vocab_size, (int(n),)).astype(np.int32)
            for n in lens]


def _serve_engine(D, cfg, **kw):
    """The smoke's engine geometry: 8 slots, page 16, max_seq_len 1024,
    chunk 8, 32 new tokens."""
    return D.ContinuousBatchingEngine(
        cfg, D.GenerationConfig(max_new_tokens=NEW_TOKENS), num_slots=8,
        page_size=16, max_seq_len=1024, chunk=8, device="cuda", **kw)


def _check_outputs(cfg, outs, eng):
    for i, toks in enumerate(outs):
        if len(toks) != NEW_TOKENS or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {i}: bad output {toks}")
    cached = eng.cache.evictable_pages if eng.cache is not None else 0
    if (eng.mgr.num_free_pages + cached != eng.mgr.usable_pages
            or getattr(eng.mgr, "num_live_pages", 0)):
        raise AssertionError("pages leaked after the serve")


def _free_card(torch):
    """Drop what a finished engine left (its graphs and pools)."""
    gc.collect()
    torch.cuda.empty_cache()


def _programs(eng, single):
    """The engine's compiled programs: exactly one ``single`` program
    (``cbe.unified_step`` or ``cbe.decode_chunk``), any others prefill
    programs, none built twice (no miss repeats a key)."""
    names = [n for n, _ in eng.compile_misses]
    allowed = {single} | ({"cbe.prefill"} if single == "cbe.decode_chunk"
                          else set())
    if (names.count(single) != 1 or not set(names) <= allowed
            or len(set(eng.compile_misses)) != len(eng.compile_misses)):
        raise AssertionError(f"program builds {eng.compile_misses}")
    return dict(misses=len(names),
                prefill_keys=[list(k) for n, k in eng.compile_misses
                              if n == "cbe.prefill"],
                first_call_s=dict(eng.compile_seconds),
                capture_s=dict(eng.capture_seconds))


def _serve_run(torch, eng, params, prompts, reset):
    """Serve ``prompts`` on ``eng`` with the counters ``reset`` (a
    callable) zeroed just before; returns the tokens and the run's
    numbers (serve wall, step walls, tokens/s with and without the
    graphs' capture seconds, peak memory)."""
    reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs, step_ms = _serve_checked(eng, params, prompts)
    serve_s = time.perf_counter() - t0
    generated = NEW_TOKENS * len(prompts)
    capture_s = sum(eng.capture_seconds.values())
    return outs, dict(
        requests=len(prompts), generated_tokens=generated,
        steps=len(step_ms), serve_s=serve_s,
        generated_tokens_per_s=generated / serve_s,
        generated_tokens_per_s_without_capture=generated / (serve_s
                                                            - capture_s),
        mean_step_ms=float(np.mean(step_ms)), first_step_ms=step_ms[0],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def _graphs_and_eager(torch, run):
    """``run(graphs)`` once through the CUDA graphs and once through the
    engine's eager card path (``_graphs = False``); the greedy tokens must
    be identical. Returns the graph run's report with the eager run's
    under ``"eager"``."""
    out = {}
    for graphs in (True, False):
        toks, out[graphs] = run(graphs)
        out[graphs]["tokens"] = toks
        _free_card(torch)
    if out[True].pop("tokens") != out[False].pop("tokens"):
        raise AssertionError("greedy tokens through the CUDA graphs differ "
                             "from the eager card run's")
    return dict(out[True], eager=out[False])


def serve_7b_phase(torch, L, D, rn, pa, cfg, params):
    prompts = serve_load(cfg)
    n_layers = cfg.num_hidden_layers

    def run(graphs):
        eng = _serve_engine(D, cfg, step_tokens=256)
        eng._graphs = graphs
        if graphs:
            engines[graphs] = eng

        def reset():
            rn.rms_norm.launches = 0
            _reset_ragged(pa)
        outs, report = _serve_run(torch, eng, params, prompts, reset)
        launches = {"rms_norm_fwd": rn.rms_norm.launches,
                    **_ragged_launches(pa)}
        rounds = eng.micro_rounds
        # one ragged call a layer and micro-round; bf16 pools at page 16
        # take both kernels each call (wgmma tiles, then the key split)
        want = {"rms_norm_fwd": (2 * n_layers + 1) * rounds,
                **_ragged_want(torch, pa, n_layers * rounds)}
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
        _check_outputs(cfg, outs, eng)
        programs = _programs(eng, "cbe.unified_step")
        report.update(micro_rounds=rounds, launches=launches,
                      programs=programs,
                      breakdown=step_breakdown(torch, eng, params,
                                               cfg.vocab_size))
        return outs, report

    toks, engines = {}, {}

    def run_kept(graphs):
        toks[graphs], report = run(graphs)
        return toks[graphs], report

    report = _graphs_and_eager(torch, run_kept)
    prompt_tokens = sum(map(len, prompts))
    # the greedy tokens for phase 21 and the warm graph engine for phase
    # 23 (both popped before printing)
    return dict(report, _tokens=toks[True], _engine=engines[True],
                layers=n_layers,
                params=L.param_count(cfg),
                prompt_tokens=prompt_tokens,
                processed_tokens_per_s=(report["generated_tokens"]
                                        + prompt_tokens) / report["serve_s"])


# ---------------------------------------------------------------------------
# phase 8: Llama-2-7B through the legacy pipeline, and a prefix-cache wave
# ---------------------------------------------------------------------------

def _reset(counters):
    for c in counters.values():
        c.launches = 0
        for r in getattr(c, "route_launches", {}):
            c.route_launches[r] = 0


def _reset_ragged(pa):
    _reset({"ragged": pa.ragged_paged_attention})


def _ragged_launches(pa):
    """The ragged op's calls and its kernels' launches by route."""
    op = pa.ragged_paged_attention
    return {"ragged_paged_attention": op.launches,
            **{f"ragged_{r}": n for r, n in op.route_launches.items()}}


def _ragged_want(torch, pa, calls):
    """Each call of the 7B engines (bf16, page 16, 1024-key tables, 256
    tokens over 8 rows, MHA) launches the wgmma tiles, the key split and,
    where ``ragged_split`` takes more than one chunk, the merge."""
    _, n_chunks = pa.ragged_split(256, 8, 1024, 32, 32, 128, torch.bfloat16,
                                  "cuda")
    return {"ragged_paged_attention": calls, "ragged_wgmma": calls,
            "ragged_key_split": calls,
            "ragged_merge": calls * (n_chunks > 1)}


def _decode_launches(pa):
    """The paged decode op's calls and its kernels' launches."""
    op = pa.paged_attention
    return {"paged_decode_attention": op.launches,
            **{f"paged_decode_{r}": n for r, n in op.route_launches.items()}}


def _decode_want(torch, pa, calls):
    """Each legacy decode call (8 rows, 1024-key tables, MHA) launches the
    key split and, where ``paged_split`` takes more than one chunk, the
    merge."""
    _, n_chunks = pa.paged_split(8, 1024, 32, 32, 128, torch.bfloat16,
                                 "cuda")
    return {"paged_decode_attention": calls, "paged_decode_key_split": calls,
            "paged_decode_merge": calls * (n_chunks > 1)}


def legacy_7b_phase(torch, L, D, rn, pa, fa, cfg, params, unified):
    """Phase 7's load through ``ContinuousBatchingEngine(unified=False)``
    (same weights, geometry and prompts), with its launch counts held to
    the code's (paged decode L per decode step, flash forward L per
    prefill wave, RMSNorm 2L+1 per wave or decode step) and a profiled
    breakdown of its steps; then, on the unified engine with
    ``prefix_cache=True``, a wave of 8 requests sharing a 256-token
    prefix (distinct 32-128-token suffixes) after one primer request
    with that prefix, and the same wave again from a cold cache. Each
    through the CUDA graphs and through the eager card path, with
    identical tokens."""
    n_layers = cfg.num_hidden_layers
    counters = {"rms_norm_fwd": rn.rms_norm,
                "paged_decode_attention": pa.paged_attention,
                "flash_attention_fwd": fa.flash_fwd_kernel,
                "ragged_paged_attention": pa.ragged_paged_attention}
    prompts = serve_load(cfg)

    def counts():
        got = {k: c.launches for k, c in counters.items()
               if "paged" not in k}
        got.update(_ragged_launches(pa), **_decode_launches(pa))
        return got

    def run_legacy(graphs):
        eng = _serve_engine(D, cfg, unified=False)
        eng._graphs = graphs
        outs, report = _serve_run(torch, eng, params, prompts,
                                  lambda: _reset(counters))
        launches = counts()
        steps, waves = eng.decode_steps, eng.prefill_calls
        want = {"rms_norm_fwd": (2 * n_layers + 1) * (waves + steps),
                "flash_attention_fwd": n_layers * waves,
                **_ragged_want(torch, pa, 0),
                **_decode_want(torch, pa, n_layers * steps)}
        if launches != want:
            raise AssertionError(f"legacy launch counts {launches} != "
                                 f"{want}")
        _check_outputs(cfg, outs, eng)
        programs = _programs(eng, "cbe.decode_chunk")
        report.update(prefill_waves=waves, decode_steps=steps,
                      launches=launches, programs=programs,
                      breakdown=step_breakdown(torch, eng, params,
                                               cfg.vocab_size, LEGACY_KINDS))
        return outs, report

    legacy = dict(_graphs_and_eager(torch, run_legacy),
                  unified_generated_tokens_per_s=unified[
                      "generated_tokens_per_s"],
                  unified_mean_step_ms=unified["mean_step_ms"])

    rng = np.random.RandomState(SEED + 2)
    prefix = rng.randint(1, cfg.vocab_size, (256,))
    primer = np.concatenate([prefix, rng.randint(1, cfg.vocab_size, (40,))])
    wave = [np.concatenate([prefix, rng.randint(1, cfg.vocab_size, (int(n),))]
                           ).astype(np.int32)
            for n in rng.randint(32, 129, size=8)]

    def run_cache(graphs):
        ceng = _serve_engine(D, cfg, step_tokens=256, prefix_cache=True)
        ceng._graphs = graphs
        _serve_checked(ceng, params, [primer.astype(np.int32)])
        runs, toks = {}, {}
        for name in ("warm", "cold"):
            if name == "cold":
                ceng.cache.evict(ceng.mgr.num_pages)   # back to a cold cache
            _reset(counters)
            ceng.micro_rounds = 0
            ran0, hits0 = ceng._prefill_tokens, ceng.cache.stats["hits"]
            t0 = time.perf_counter()
            toks[name], wave_ms = _serve_checked(ceng, params, wave)
            wall = time.perf_counter() - t0
            rounds = ceng.micro_rounds
            got = counts()
            want = {"rms_norm_fwd": (2 * n_layers + 1) * rounds,
                    "flash_attention_fwd": 0, **_decode_want(torch, pa, 0),
                    **_ragged_want(torch, pa, n_layers * rounds)}
            if got != want:
                raise AssertionError(f"cache wave ({name}) launch counts "
                                     f"{got} != {want}")
            _check_outputs(cfg, toks[name], ceng)
            ran = ceng._prefill_tokens - ran0
            runs[name] = dict(
                prompt_tokens=sum(map(len, wave)), prefill_tokens_run=ran,
                prefill_tokens_skipped=sum(map(len, wave)) - ran,
                hits=ceng.cache.stats["hits"] - hits0, steps=len(wave_ms),
                first_step_ms=wave_ms[0], wall_s=wall, micro_rounds=rounds,
                launches=got)
        if runs["warm"]["prefill_tokens_skipped"] != 8 * 256:
            raise AssertionError(f"warm wave skipped "
                                 f"{runs['warm']['prefill_tokens_skipped']}"
                                 " prefill tokens, not 8 x 256")
        return toks, dict(runs, snapshot=ceng.cache.snapshot(),
                          leaked_pages=ceng.mgr.num_live_pages,
                          programs=_programs(ceng, "cbe.unified_step"))

    return dict(legacy=legacy,
                prefix_cache=_graphs_and_eager(torch, run_cache))


MATMUL_NAMES = ("gemm", "gemv", "xmma", "cutlass", "nvjet")
SERVE_KINDS = (("ragged_paged_attention", ("ragged_tiles_kernel",
                                           "ragged_key_split_kernel",
                                           "decode_merge_kernel")),
               ("rms_norm_fwd", ("rms_norm",)), ("matmul", MATMUL_NAMES))
LEGACY_KINDS = (("paged_decode_attention", ("paged_decode_attention",
                                            "decode_merge_kernel")),
                ("flash_fwd", ("flash_attention_fwd",)),
                ("rms_norm_fwd", ("rms_norm",)), ("matmul", MATMUL_NAMES))


def _kernel_ms_by_kind(prof, kinds=SERVE_KINDS, n_top=6):
    """Device time (ms) of one profiled window by kind of kernel (the
    first kind whose name fragment the kernel's name holds, else
    "other"), and the window's largest kernels."""
    from torch.autograd import DeviceType
    out = {kind: 0.0 for kind, _ in kinds}
    out["other"] = 0.0
    top = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        kind = next((k for k, frags in kinds
                     if any(f in name for f in frags)), "other")
        out[kind] += us / 1e3
        top.append((us / 1e3, e.key[:60], e.count))
    top.sort(reverse=True)
    return out, [dict(ms=t, kernel=k, calls=c) for t, k, c in top[:n_top]]


def kernel_breakdown_ms(torch, fn, kinds, iters: int = 10) -> dict:
    """Device ms per call of ``fn`` by kind of kernel (``kinds`` as in
    ``_kernel_ms_by_kind``), from torch.profiler over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_kind, _ = _kernel_ms_by_kind(prof, kinds)
    return {k: v / iters for k, v in by_kind.items()}


def profiled_ms(torch, fn, iters: int = 5) -> float:
    """Device time per call of ``fn`` summed over every kernel it runs,
    from torch.profiler — for library calls that go through autograd
    and cannot be captured in a CUDA graph."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kinds, _ = _kernel_ms_by_kind(prof, ())
    return sum(kinds.values()) / iters


def step_breakdown(torch, eng, params, vocab, kinds=SERVE_KINDS,
                   submit_kw=None):
    """Where a prefill step and a decode step of the engine spend their
    time. Eight requests of 256 prompt tokens fill the first step with
    prefill (unified: 8 micro-rounds of 256 tokens; legacy: one prefill
    wave of 8 rows, then a decode chunk); the second step decodes the 8
    rows (``chunk`` micro-rounds or decode steps). A first pass builds
    any program the two steps need; wall times come from an unprofiled
    pass, kernel device times (by ``kinds``) from a torch.profiler pass
    over the same two steps. Fails if the profiler sees no device time
    (the kernels of a graph replay must be attributed). ``submit_kw``
    gives each request's submit arguments (a sampler)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(1, vocab, (256,)).astype(np.int32)
               for _ in range(eng.num_slots)]
    out = {}
    for profiled in (None, False, True):
        rids = [eng.submit(p, **(submit_kw or {})) for p in prompts]
        for phase in ("prefill_step", "decode_step"):
            torch.cuda.synchronize()
            if profiled is None:
                eng.step(params)
                torch.cuda.synchronize()
            elif profiled:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    eng.step(params)
                    torch.cuda.synchronize()
                by_kind, top = _kernel_ms_by_kind(prof, kinds)
                busy = sum(by_kind.values())
                if busy <= 0:
                    raise AssertionError(f"{phase}: the profiler saw no "
                                         "device time")
                wall = out[phase]["wall_ms"]
                out[phase].update(
                    kernel_ms=by_kind, top_kernels=top,
                    device_busy_ms=busy, idle_share=1 - busy / wall)
            else:
                t0 = time.perf_counter()
                eng.step(params)      # ends in its device->host copy
                out[phase] = dict(wall_ms=(time.perf_counter() - t0) * 1e3)
        for rid in rids:
            eng.cancel(rid)
        eng.mgr.check_conservation()
    return out


# ---------------------------------------------------------------------------
# phase 20: tiny decoding-options parity, card vs CPU
# ---------------------------------------------------------------------------

def _abc_grammar(C, vocab_size):
    vocab = (["<eos>"] + list("abcde")
             + [f"tok{i}" for i in range(6, vocab_size)])
    return C.compile_regex("(ab|cd)*e", vocab, eos_token_id=0)


def _check_legal(gram, toks):
    st = gram.start
    for t in toks:
        if not gram.legal(st, t):
            raise AssertionError(f"grammar-illegal token {t} in {toks}")
        st = gram.advance(st, t)


def _serve_subs(eng, params, prompts, subs, max_steps=500):
    """Serve ``prompts`` with per-request submit arguments ``subs``,
    auditing the page books after every step. Returns the tokens in
    submission order and each step's wall time (ms)."""
    rids = [eng.submit(p, **s) for p, s in zip(prompts, subs)]
    results, step_ms = {}, []
    while len(results) < len(rids):
        t0 = time.perf_counter()
        eng.step(params)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        eng.mgr.check_conservation()
        results.update(eng.collect())
        if len(step_ms) > max_steps:
            raise AssertionError(f"serve did not finish in {max_steps} steps")
    return [results[r] for r in rids], step_ms


def sampling_parity_phase(torch, L, D):
    """Phase 5's config and weights: a greedy / sampled / constrained /
    near-greedy mix through the unified and the speculative engine, and
    the engine-wide ``do_sample`` through the unified and legacy
    pipelines and ``PagedGenerationEngine``, each on the card through the
    CUDA graphs, on the card eagerly and on the CPU: identical tokens."""
    from paddle_tpu_torch.inference import constrain as C
    from paddle_tpu_torch.inference.sampling import SamplerConfig
    cfg = L.llama_tiny(hidden_size=256, num_attention_heads=2,
                       num_key_value_heads=2, intermediate_size=512,
                       num_hidden_layers=2, dtype=torch.float32)
    params_cpu = L.init_params(cfg, seed=SEED, device="cpu")
    params_gpu = {k: v.cuda() for k, v in params_cpu.items()}
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 40, 17, 3, 29, 11, 23)]
    gram = _abc_grammar(C, cfg.vocab_size)
    kinds = [dict(), dict(sampler=SamplerConfig(0.9, 20, 0.9, seed=3)),
             dict(grammar=gram, sampler=SamplerConfig(1.0, seed=4)),
             dict(sampler=SamplerConfig(0.05, seed=5))]
    subs = [kinds[i % len(kinds)] for i in range(len(prompts))]
    runs = (("cuda", params_gpu, True), ("cuda", params_gpu, False),
            ("cpu", params_cpu, False))
    report = {}
    for spec in (False, True):
        outs = []
        for dev, params, graphs in runs:
            eng = D.ContinuousBatchingEngine(
                cfg, D.GenerationConfig(max_new_tokens=8), num_slots=3,
                page_size=16, max_seq_len=128, chunk=4, device=dev,
                grammar_states=gram.n_states, speculative=spec, spec_k=3)
            eng._graphs = graphs
            outs.append(_serve_subs(eng, params, prompts, subs)[0])
            name = "cbe.spec_step" if spec else "cbe.unified_step"
            if [(n, k[-1]) for n, k in eng.compile_misses] != [(name, True)]:
                raise AssertionError(f"program builds {eng.compile_misses}")
        if not outs[0] == outs[1] == outs[2]:
            raise AssertionError(f"mixed serve (speculative {spec}): "
                                 f"graphs {outs[0]}, eager {outs[1]}, cpu "
                                 f"{outs[2]}")
        for toks, sub in zip(outs[0], subs):
            if "grammar" in sub:
                _check_legal(gram, toks)
        report["speculative" if spec else "unified"] = dict(
            tokens=outs[0], spec=eng.spec.snapshot() if spec else None)
    gen = D.GenerationConfig(max_new_tokens=7, do_sample=True,
                             temperature=0.8, top_k=30, top_p=0.9, seed=6)
    for unified in (True, False):
        outs = []
        for dev, params, graphs in runs:
            eng = D.ContinuousBatchingEngine(
                cfg, gen, num_slots=2, page_size=16, max_seq_len=128,
                chunk=4, device=dev, unified=unified)
            eng._graphs = graphs
            outs.append(_serve_subs(eng, params, prompts[:5],
                                    [{}] * 5)[0])
        if not outs[0] == outs[1] == outs[2]:
            raise AssertionError(f"do_sample (unified {unified}): graphs "
                                 f"{outs[0]}, eager {outs[1]}, cpu "
                                 f"{outs[2]}")
        report["do_sample_" + ("unified" if unified else "legacy")] = outs[0]
    gen_out = [D.PagedGenerationEngine(cfg, gen, page_size=16,
                                       device=dev).generate(params,
                                                            prompts[:5])
               for dev, params, _ in runs[1:]]
    if not np.array_equal(gen_out[0], gen_out[1]):
        raise AssertionError(f"PagedGenerationEngine do_sample: card "
                             f"{gen_out[0]} != cpu {gen_out[1]}")
    report["paged_generation_do_sample"] = gen_out[0].tolist()
    return report


# ---------------------------------------------------------------------------
# phase 21: the decoding options at full width
# ---------------------------------------------------------------------------

SAMPLED_KINDS = SERVE_KINDS + (("sort", ("sort",)), ("scan", ("scan",)))


def _json_vocab(vocab_size):
    """A synthetic tokenizer vocabulary for the JSON grammar: EOS, JSON
    punctuation and characters, the rest tokens no JSON text starts."""
    toks = ["<eos>"] + list('{}[]:, ') + ['"', '\\']
    toks += list("abcdefghijklmnopqrstuvwxyz0123456789+-.eE")
    return toks + [f"<junk{i}>" for i in range(len(toks), vocab_size)]


class _StreamDrafter:
    """Drafts the next tokens of known greedy streams, found by the prompt
    the history starts with: all accepted while the engine's own greedy
    tokens follow those streams."""

    def __init__(self, prompts, streams):
        self.refs = [(len(p), [int(t) for t in p], list(map(int, o)))
                     for p, o in zip(prompts, streams)]

    def draft(self, history, k):
        for n, prompt, out in self.refs:
            if list(history[:n]) == prompt:
                done = len(history) - n
                return out[done:done + k]
        return []


class _FullSpanDrafter:
    """Drafts k copies of the row's last token: every decoding row's span
    is k+1 tokens (a round's full verification cost, whatever is
    accepted)."""

    def draft(self, history, k):
        return [int(history[-1])] * k


def spec_round_breakdown(torch, pa, eng, params, vocab, drafter=None):
    """A speculative decode round of 8 rows: phase 7's eight 256-token
    breakdown prompts are prefilled (rounds of 256 tokens), then three
    decode rounds are timed (wall to the round's one device->host copy)
    and one more profiled (device time by kind, idle share), with the
    engine's drafter or ``drafter``. Reports the tokens those rounds
    committed, the drafts and acceptance, and the tile sizes the ragged
    kernels found on the profiled round's packed axis (``ragged_tiles``
    with the round's ``decoding`` flags: every span token is a one-token
    tile on the key split, as the unified step decodes it)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(1, vocab, (256,)).astype(np.int32)
               for _ in range(eng.num_slots)]
    own, eng.drafter = eng.drafter, drafter or eng.drafter
    rids = [eng.submit(p) for p in prompts]
    n = eng.num_slots
    for _ in range(4 * n):
        if all(eng._pend[s] is None and eng._slot_rid[s] is not None
               for s in range(n)):
            break
        eng.step(params)
    else:
        raise AssertionError("rows still prefilling")
    stats0 = dict(eng.spec.stats)
    toks0 = sum(len(eng._live[r].tokens) for r in rids if r in eng._live)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step(params)
        walls.append((time.perf_counter() - t0) * 1e3)
    toks1 = sum(len(eng._live[r].tokens) for r in rids if r in eng._live)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step(params)
        torch.cuda.synchronize()
    by_kind, top = _kernel_ms_by_kind(prof, SAMPLED_KINDS)
    busy = sum(by_kind.values())
    if busy <= 0:
        raise AssertionError("spec round: the profiler saw no device time")
    ts = pa.ragged_tile_size(torch.bfloat16, eng.page_size,
                             eng.model_config.num_attention_heads,
                             eng.model_config.num_key_value_heads)
    static = eng._spec_step.static
    tiles = pa.ragged_tiles(static["token_row"], n, ts,
                            static["decoding"]).cpu().numpy()
    _, sizes = np.unique(tiles[tiles >= 0], return_counts=True)
    drafted = eng.spec.stats["drafted"] - stats0["drafted"]
    accepted = eng.spec.stats["accepted"] - stats0["accepted"]
    for rid in rids:
        eng.cancel(rid)
    eng.mgr.check_conservation()
    eng.drafter = own
    mean = float(np.mean(walls))
    return dict(round_wall_ms=mean, round_walls_ms=walls,
                committed_tokens_per_round=(toks1 - toks0) / 3 / n,
                drafted=drafted, accepted=accepted,
                kernel_ms=by_kind, top_kernels=top, device_busy_ms=busy,
                idle_share=1 - busy / mean,
                tile_sizes=sorted(int(x) for x in sizes))


def sampling_7b_phase(torch, L, D, C, rn, pa, cfg, params, greedy,
                      greedy_tokens):
    """Phase 7's weights, geometry and load: a mixed serve (request i
    greedy, sampled or JSON-constrained by i % 3) and speculative greedy
    serves (the n-gram drafter, drafts from ``greedy_tokens``, drafts
    from the second serve's tokens), each through the graphs and eagerly
    (tokens equal,
    launch counts held to the rounds run), with the sampled and the
    speculative step breakdowns beside phase 7's greedy step
    (``greedy``). Every speculative serve's tokens must equal phase 7's
    greedy streams (the reference's promise: the spans' tokens take the
    attention kernels' route of a token decoded alone), and the drafts
    taken from those streams must all be accepted."""
    from paddle_tpu_torch.inference.sampling import SamplerConfig
    n_layers = cfg.num_hidden_layers
    prompts = serve_load(cfg)
    t0 = time.perf_counter()
    gram = C.json_grammar(_json_vocab(cfg.vocab_size), 0, max_depth=1)
    grammar_s = time.perf_counter() - t0
    sampler = SamplerConfig(temperature=0.8, top_k=50, top_p=0.95)
    kinds = [dict(), dict(sampler=sampler), dict(grammar=gram)]
    subs = [kinds[i % 3] for i in range(len(prompts))]

    def reset():
        rn.rms_norm.launches = 0
        _reset_ragged(pa)

    def counts(rounds):
        got = {"rms_norm_fwd": rn.rms_norm.launches, **_ragged_launches(pa)}
        want = {"rms_norm_fwd": (2 * n_layers + 1) * rounds,
                **_ragged_want(torch, pa, n_layers * rounds)}
        if got != want:
            raise AssertionError(f"launch counts {got} != {want}")
        return got

    def run_mixed(graphs):
        eng = _serve_engine(D, cfg, step_tokens=256,
                            grammar_states=gram.n_states)
        eng._graphs = graphs
        reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs, step_ms = _serve_subs(eng, params, prompts, subs)
        serve_s = time.perf_counter() - t0
        launches = counts(eng.micro_rounds)
        _check_outputs(cfg, outs, eng)
        for toks, sub in zip(outs, subs):
            if "grammar" in sub:
                _check_legal(gram, toks)
        if [(n, k[-1]) for n, k in eng.compile_misses] != [
                ("cbe.unified_step", True)]:
            raise AssertionError(f"program builds {eng.compile_misses}")
        generated = NEW_TOKENS * len(prompts)
        report = dict(
            steps=len(step_ms), serve_s=serve_s,
            generated_tokens_per_s=generated / serve_s,
            mean_step_ms=float(np.mean(step_ms)),
            micro_rounds=eng.micro_rounds, launches=launches,
            sampling_counts=eng.sampling_counts,
            capture_s=dict(eng.capture_seconds),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            breakdown=step_breakdown(
                torch, eng, params, cfg.vocab_size, SAMPLED_KINDS,
                submit_kw=dict(sampler=SamplerConfig(0.8, 50, 0.95,
                                                     seed=SEED))))
        return outs, report

    def run_spec(graphs, drafter):
        eng = _serve_engine(D, cfg, step_tokens=256, speculative=True,
                            spec_k=4, drafter=drafter)
        eng._graphs = graphs
        reset()
        t0 = time.perf_counter()
        outs, step_ms = _serve_subs(eng, params, prompts,
                                    [{}] * len(prompts))
        serve_s = time.perf_counter() - t0
        launches = counts(eng.spec_rounds)
        _check_outputs(cfg, outs, eng)
        if [n for n, _ in eng.compile_misses] != ["cbe.spec_step"]:
            raise AssertionError(f"program builds {eng.compile_misses}")
        generated = NEW_TOKENS * len(prompts)
        report = dict(
            rounds=eng.spec_rounds, serve_s=serve_s,
            generated_tokens_per_s=generated / serve_s,
            mean_step_ms=float(np.mean(step_ms)), launches=launches,
            spec=eng.spec.snapshot(), capture_s=dict(eng.capture_seconds),
            round=spec_round_breakdown(
                torch, pa, eng, params, cfg.vocab_size,
                None if drafter is None else _FullSpanDrafter()))
        if drafter is not None and report["round"]["tile_sizes"] != [1] * (
                (eng.spec_k + 1) * eng.num_slots):
            raise AssertionError(f"full spans did not make one-token tiles: "
                                 f"{report['round']['tile_sizes']}")
        return outs, report

    mixed = _graphs_and_eager(torch, run_mixed)
    spec, spec_toks = {}, {}
    # drafts: the n-gram drafter; phase 7's greedy streams; and the
    # streams the second serve produced. Each serve must give phase 7's
    # greedy tokens, and the stream drafts must all be accepted
    runs = (("ngram", lambda: None),
            ("phase7_stream", lambda: _StreamDrafter(prompts, greedy_tokens)),
            ("own_stream", lambda: _StreamDrafter(
                prompts, spec_toks["phase7_stream"])))
    for name, make in runs:
        def run_spec_kept(graphs, make=make, name=name):
            toks, report = run_spec(graphs, make())
            spec_toks[name] = toks
            return toks, report
        spec[name] = _graphs_and_eager(torch, run_spec_kept)
        same = float(np.mean([a == b for x, y in zip(spec_toks[name],
                                                      greedy_tokens)
                              for a, b in zip(x, y)]))
        stats = spec[name]["spec"]
        drafted, accepted = stats["drafted"], stats["accepted"]
        spec[name].update(tokens_equal_to_drafted_streams=same,
                          acceptance=accepted / drafted if drafted else None)
        if same != 1.0:
            raise AssertionError(
                f"speculative serve ({name}): {same:.4f} of its tokens "
                "equal phase 7's greedy streams, not all")
        if name != "ngram" and accepted != drafted:
            raise AssertionError(f"speculative serve ({name}): accepted "
                                 f"{accepted} of {drafted} drafts")
    g_dec = greedy["breakdown"]["decode_step"]
    s_dec = mixed["breakdown"]["decode_step"]
    return dict(
        grammar_states=gram.n_states, grammar_compile_s=grammar_s,
        mixed=mixed, speculative=spec,
        sampled_vs_greedy=dict(
            decode_wall_ms=[s_dec["wall_ms"], g_dec["wall_ms"]],
            decode_wall_ratio=s_dec["wall_ms"] / g_dec["wall_ms"],
            decode_idle=[s_dec["idle_share"], g_dec["idle_share"]],
            decode_device_ms=[s_dec["device_busy_ms"],
                              g_dec["device_busy_ms"]]),
        spec_round_vs_micro_round={
            name: r["round"]["round_wall_ms"] / (g_dec["wall_ms"] / 8)
            for name, r in spec.items()})


# ---------------------------------------------------------------------------
# phase 22: the generate engines at full width
# ---------------------------------------------------------------------------

#: the reference's ``decode`` workload shape (benchmarks/bench_workloads.py,
#: bench_decode): 8 prompts of 512 tokens, 128 new tokens
GEN_B, GEN_T, GEN_NEW = 8, 512, 128
GEN_KINDS = (("rms_norm_fwd", ("rms_norm",)), ("matmul", MATMUL_NAMES))


def _profiled(torch, fn):
    """``fn()``'s device time by kind (GEN_KINDS) from torch.profiler;
    fails if the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kind, top = _kernel_ms_by_kind(prof, GEN_KINDS)
    if sum(by_kind.values()) <= 0:
        raise AssertionError("the profiler saw no device time")
    return by_kind, top


def _generate_run(torch, D, rn, cfg, params, ids, max_new, graphs,
                  profiled=False):
    """A fresh ``llama_engine`` generates ``ids`` twice (the first call
    builds its program: one counted miss, and on the card captures it),
    the second timed to its device->host copy, with RMSNorm launches
    counted over it; optionally a third under torch.profiler."""
    eng = D.llama_engine(cfg, D.GenerationConfig(max_new_tokens=max_new),
                         device="cuda")
    eng._graphs = graphs
    torch.cuda.reset_peak_memory_stats()
    first = eng.generate(params, ids)
    rn.rms_norm.launches = 0
    t0 = time.perf_counter()
    toks = eng.generate(params, ids)
    wall = time.perf_counter() - t0
    rms = rn.rms_norm.launches
    if not np.array_equal(first, toks):
        raise AssertionError("a replay's tokens differ from the first run's")
    key = (D._bucket(ids.shape[1]), max_new, ids.shape[0])
    if eng.compile_misses != [("generation_engine.run", key)]:
        raise AssertionError(f"program builds {eng.compile_misses}")
    want = (2 * cfg.num_hidden_layers + 1) * max_new
    if rms != want:
        raise AssertionError(f"RMSNorm launches {rms} != {want}")
    report = dict(wall_ms=wall * 1e3, rms_norm_launches=rms,
                  builds=len(eng.compile_misses),
                  first_call_s=eng.compile_seconds["generation_engine.run"],
                  capture_s=eng.capture_seconds.get(
                      "generation_engine.run", 0.0),
                  graph_pool_gb=eng.graph_pool_bytes.get(
                      "generation_engine.run", 0) / 1e9,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                  reserved_gb=torch.cuda.memory_reserved() / 1e9)
    if profiled:
        report["kernel_ms"], report["top_kernels"] = _profiled(
            torch, lambda: eng.generate(params, ids))
    return toks, report


def generate_7b_phase(torch, L, D, rn, pa, fa, cfg, params):
    """The generate engines over phase 7's Llama-2-7B weights (bf16, 32
    layers, MHA). ``llama_engine`` at the reference's ``decode`` workload
    shape (B 8, T 512, 128 new tokens; ``bench_decode``'s timing: a
    1-token run is the prefill, and decode tokens/s is B·127 / (t_128 -
    t_1)), one CUDA graph a key, tokens equal to the eager card run's;
    per-step device time by kind (the cached attention from a profile of
    one layer's ``_cached_attention`` at the step's shapes, times L),
    idle share, and the step against its HBM bound (the weights plus the
    K/V slab the attention reads, over 3.35 TB/s). Then
    ``PagedGenerationEngine`` over phase 7's 12 ragged prompts, 32 new
    tokens: two calls of one key (one build, the same tokens), graphs
    against eager, launch counts held to the code's."""
    n_layers, nkv, d = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                        cfg.head_dim)
    rng = np.random.RandomState(SEED)
    ids = rng.randint(0, cfg.vocab_size, (GEN_B, GEN_T)).astype(np.int32)
    toks, full = _generate_run(torch, D, rn, cfg, params, ids, GEN_NEW,
                               True, profiled=True)
    _free_card(torch)
    _, prefill = _generate_run(torch, D, rn, cfg, params, ids, 1, True,
                               profiled=True)
    _free_card(torch)
    eager_toks, eager = _generate_run(torch, D, rn, cfg, params, ids,
                                      GEN_NEW, False)
    _free_card(torch)
    if not np.array_equal(toks, eager_toks):
        raise AssertionError("generate: tokens through the CUDA graph "
                             "differ from the eager card run's")
    if toks.shape != (GEN_B, GEN_NEW) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"generate: bad output {toks.shape}")
    steps = GEN_NEW - 1
    decode_ms = (full["wall_ms"] - prefill["wall_ms"]) / steps
    step_kinds = {k: (full["kernel_ms"][k] - prefill["kernel_ms"][k]) / steps
                  for k in full["kernel_ms"]}
    # one layer's cached attention at the decode step's shapes
    s_max = GEN_T + GEN_NEW
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((GEN_B, 1, cfg.num_attention_heads, d), generator=gen,
                    device="cuda").to(cfg.dtype)
    kc, vc = (torch.randn((GEN_B, s_max, nkv, d), generator=gen,
                          device="cuda").to(cfg.dtype) for _ in range(2))
    kv_len = torch.full((), GEN_T + 64, dtype=torch.long, device="cuda")
    attn = kernel_breakdown_ms(
        torch, lambda: L._cached_attention(q, kc, vc, kv_len, cfg),
        GEN_KINDS)
    del q, kc, vc
    attn_ms = n_layers * sum(attn.values())
    busy = sum(step_kinds.values())
    by_kind = dict(
        matmul=step_kinds["matmul"] - n_layers * attn["matmul"],
        cached_attention=attn_ms, rms_norm_fwd=step_kinds["rms_norm_fwd"],
        other=step_kinds["other"] - n_layers * attn["other"])
    nbytes = L.param_count(cfg) * 2 + 2 * n_layers * GEN_B * s_max * nkv \
        * d * 2
    bound, by = bound_ms(nbytes, 2 * L.param_count(cfg) * GEN_B, "bf16")
    generate = dict(
        batch=GEN_B, prompt=GEN_T, new_tokens=GEN_NEW, layers=n_layers,
        prefill_ms=prefill["wall_ms"], full_ms=full["wall_ms"],
        decode_step_ms=decode_ms,
        decode_tokens_per_s=GEN_B * steps / (full["wall_ms"]
                                            - prefill["wall_ms"]) * 1e3,
        eager_full_ms=eager["wall_ms"],
        step_kernel_ms=by_kind, step_device_busy_ms=busy,
        step_idle_share=1 - busy / decode_ms,
        cached_attention_share=attn_ms / busy,
        step_bound_ms=bound, step_bound_by=by, step_bytes=nbytes,
        step_vs_bound=decode_ms / bound,
        rms_norm_launches_per_step=full["rms_norm_launches"] // GEN_NEW,
        launches={"rms_norm_fwd": full["rms_norm_launches"]},
        graph=full, prefill_run=prefill, eager=eager,
        tokens_equal_eager=True)

    prompts = serve_load(cfg)
    counters = {"rms_norm_fwd": rn.rms_norm,
                "paged_decode_attention": pa.paged_attention,
                "flash_attention_fwd": fa.flash_fwd_kernel}

    def run_paged(graphs):
        eng = D.PagedGenerationEngine(cfg, D.GenerationConfig(
            max_new_tokens=NEW_TOKENS), page_size=16, device="cuda")
        eng._graphs = graphs
        _reset(counters)
        outs, walls = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            outs.append(eng.generate(params, prompts))
            walls.append((time.perf_counter() - t0) * 1e3)
        got = {k: c.launches for k, c in counters.items()}
        want = {"rms_norm_fwd": 2 * (2 * n_layers + 1) * NEW_TOKENS,
                "paged_decode_attention": 2 * n_layers * (NEW_TOKENS - 1),
                "flash_attention_fwd": 2 * n_layers}
        if got != want:
            raise AssertionError(f"paged generate launches {got} != {want}")
        if not np.array_equal(outs[0], outs[1]):
            raise AssertionError("paged generate: a replay's tokens differ")
        if [n for n, _ in eng.compile_misses] != ["paged_engine.run"]:
            raise AssertionError(f"program builds {eng.compile_misses}")
        if outs[0].shape != (len(prompts), NEW_TOKENS):
            raise AssertionError(f"paged generate: bad output "
                                 f"{outs[0].shape}")
        report = dict(key=list(eng.compile_misses[0][1]),
                      first_call_ms=walls[0], second_call_ms=walls[1],
                      builds=len(eng.compile_misses),
                      capture_s=eng.capture_seconds.get("paged_engine.run",
                                                        0.0),
                      graph_pool_gb=eng.graph_pool_bytes.get(
                          "paged_engine.run", 0) / 1e9,
                      launches=got)
        return outs[0].tolist(), report

    paged = _graphs_and_eager(torch, run_paged)
    return dict(generate=generate, paged=paged)


# ---------------------------------------------------------------------------
# phase 23: the serving scheduler over phase 7's engine
# ---------------------------------------------------------------------------

SCHED_QUEUE_CAP = 10        # 12 submissions: two shed at submit
SCHED_CANCEL = 3            # this request's on_token cancels it ...
SCHED_CANCEL_AFTER = 4      # ... after its 4th token
SCHED_DEADLINE_MS = 120000  # even requests carry a deadline (never lapses)


def _policy_victims(priorities, deadlines, cap):
    """The reference scheduler's queue-cap shedding, written out plainly:
    requests arrive in order; while more than ``cap`` are queued, the one
    with the largest (priority, deadline (none = +inf), arrival) goes."""
    queued, shed = [], []
    for i, (pr, dl) in enumerate(zip(priorities, deadlines)):
        queued.append((pr, math.inf if dl is None else dl, i))
        while len(queued) > cap:
            worst = max(queued)
            queued.remove(worst)
            shed.append(worst[2])
    return sorted(shed)


def _percentiles(h):
    return {"p50": h.percentile(0.5), "p99": h.percentile(0.99),
            "count": h.count}


def _scheduled_serve(S, eng, params, prompts, cfg_kw, on_cancel=None,
                     step_log=None):
    """Phase 7's load through a ``ServingScheduler``: priority i % 3, a
    deadline on even requests, request ``SCHED_CANCEL`` cancelled by its
    own ``on_token`` after ``SCHED_CANCEL_AFTER`` tokens (``on_cancel``
    runs right after), request 0 read by a consumer thread through the
    stream's blocking iterator. Returns the scheduler, the handles, the
    consumer's tokens, each ``sched.step`` wall (ms) and the serve wall."""
    sched = S.ServingScheduler(eng, S.SchedulerConfig(**cfg_kw))
    box = {}

    def stop(tok):
        h = box["h"]
        if len(h.stream.tokens) == SCHED_CANCEL_AFTER:
            sched.cancel(h.rid)
            if on_cancel is not None:
                on_cancel()

    hs = [sched.submit(p, priority=i % 3,
                       deadline_ms=SCHED_DEADLINE_MS if i % 2 == 0 else None,
                       on_token=stop if i == SCHED_CANCEL else None)
          for i, p in enumerate(prompts)]
    box["h"] = hs[SCHED_CANCEL]
    consumed = []
    reader = threading.Thread(target=lambda: consumed.extend(hs[0].stream))
    reader.start()
    step_ms = []
    t0 = time.perf_counter()
    while sched.pending:
        s0 = time.perf_counter()
        sched.step(params)
        step_ms.append((time.perf_counter() - s0) * 1e3)
        if step_log is not None:
            step_log(sched)
        if len(step_ms) > 300:
            raise AssertionError("the scheduled serve did not finish")
    wall = time.perf_counter() - t0
    reader.join(timeout=60)
    if reader.is_alive():
        raise AssertionError("the stream's consumer thread is still blocked")
    return sched, hs, consumed, step_ms, wall


def _sched_step_breakdown(torch, S, eng, params, vocab):
    """Where two scheduled steps spend their time (as ``step_breakdown``
    does for the engine's): eight 256-token requests through a scheduler,
    its first step (all prefill) and its second (decode); wall from an
    unprofiled pass, device time from a torch.profiler pass."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(1, vocab, (256,)).astype(np.int32)
               for _ in range(eng.num_slots)]
    out = {}
    for profiled in (False, True):
        sched = S.ServingScheduler(eng)
        hs = [sched.submit(p) for p in prompts]
        for phase in ("prefill_step", "decode_step"):
            torch.cuda.synchronize()
            if profiled:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    sched.step(params)
                    torch.cuda.synchronize()
                by_kind, top = _kernel_ms_by_kind(prof)
                busy = sum(by_kind.values())
                if busy <= 0:
                    raise AssertionError(f"{phase}: the profiler saw no "
                                         "device time")
                wall = out[phase]["wall_ms"]
                out[phase].update(kernel_ms=by_kind, top_kernels=top,
                                  device_busy_ms=busy,
                                  idle_share=1 - busy / wall)
            else:
                t0 = time.perf_counter()
                sched.step(params)
                out[phase] = dict(wall_ms=(time.perf_counter() - t0) * 1e3)
        for h in hs:
            sched.cancel(h.rid)
        eng.mgr.check_conservation()
    return out


def _taps(O, on, sched, monitor):
    """Arm (or disarm) every ported tap: the flight recorder, the span
    collector, the journal, the memory ledger and the SLO monitor."""
    for tap in (O.flight_recorder, O.span_collector, O.journal,
                O.memory_ledger):
        tap.arm() if on else tap.disarm()
    sched.slo_monitor = monitor if on else None


def scheduled_7b_phase(torch, L, D, rn, pa, cfg, params, eng, serve,
                       greedy):
    """Phase 7's load through ``ServingScheduler`` over phase 7's warm
    engine (CUDA graphs): tokens against the engine-only oracle, the
    reference policy's shed and cancel victims, page books, no new
    program build, the watchdog thread's replays, the memory ledger's
    bytes, latency percentiles, the host gap, the idle share and the
    armed taps' cost."""
    import paddle_tpu_torch.observability as O
    import paddle_tpu_torch.serving as S
    prompts = serve_load(cfg)
    n_layers = cfg.num_hidden_layers
    misses0 = list(eng.compile_misses)
    recompiles0 = O.recompiles.count()
    priorities = [i % 3 for i in range(len(prompts))]
    deadlines = [SCHED_DEADLINE_MS if i % 2 == 0 else None
                 for i in range(len(prompts))]
    want_shed = _policy_victims(priorities, deadlines, SCHED_QUEUE_CAP)

    # the scheduled serve, counters zeroed just before: the engine's steps
    # timed from inside for the host gap between two of them
    spans = []
    real_step = eng.step

    def timed_step(p):
        t0 = time.perf_counter()
        try:
            return real_step(p)
        finally:
            spans.append((t0, time.perf_counter()))

    eng.step = timed_step
    rn.rms_norm.launches = 0
    _reset_ragged(pa)
    rounds0 = eng.micro_rounds
    try:
        sched, hs, consumed, step_ms, wall = _scheduled_serve(
            S, eng, params, prompts,
            dict(max_queue_depth=SCHED_QUEUE_CAP),
            on_cancel=eng.mgr.check_conservation)
    finally:
        del eng.step
    torch.cuda.synchronize()
    launches = {"rms_norm_fwd": rn.rms_norm.launches, **_ragged_launches(pa)}
    rounds = eng.micro_rounds - rounds0
    want = {"rms_norm_fwd": (2 * n_layers + 1) * rounds,
            **_ragged_want(torch, pa, n_layers * rounds)}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    shed = [h.rid for h in hs if h.state == "shed"]
    cancelled = [h.rid for h in hs if h.state == "cancelled"]
    if shed != want_shed or cancelled != [SCHED_CANCEL]:
        raise AssertionError(f"shed {shed} (policy: {want_shed}), "
                             f"cancelled {cancelled}")
    if len(hs[SCHED_CANCEL].stream.tokens) != SCHED_CANCEL_AFTER:
        raise AssertionError("the cancelled request kept "
                             f"{len(hs[SCHED_CANCEL].stream.tokens)} tokens")
    done = [h for h in hs if h.state == "done"]
    if len(done) != len(prompts) - len(want_shed) - 1 or any(
            len(h.stream.tokens) != NEW_TOKENS for h in done):
        raise AssertionError(f"states {[h.state for h in hs]}")
    if consumed != hs[0].stream.result():
        raise AssertionError("the consumer thread's tokens differ")
    if eng.mgr.num_free_pages != eng.mgr.usable_pages:
        raise AssertionError("pages leaked after the scheduled serve")
    generated = sum(len(h.stream.tokens) for h in hs)

    # the engine-only oracle: the same engine's serve of the admitted
    # prompts in the scheduler's admission order (phase 7's step loop)
    order = sorted((h for h in hs if h.engine_rid is not None),
                   key=lambda h: h.engine_rid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    oracle, oracle_ms = _serve_checked(eng, params, [h.prompt for h in order])
    oracle_s = time.perf_counter() - t0
    by_prompt = {}
    for h, toks in zip(order, oracle):
        got = h.stream.tokens
        if (h.state == "done" and got != toks) or got != toks[:len(got)]:
            raise AssertionError(f"request {h.rid}: scheduled tokens differ "
                                 "from the engine-only oracle")
        by_prompt[h.rid] = toks
    equal = sum(int(a == b) for h in hs if h.state == "done"
                for a, b in zip(h.stream.tokens, greedy[h.rid]))
    n_done = sum(len(h.stream.tokens) for h in done)

    # the watchdog: every engine step on the scheduler's step thread
    # (replays there), step_timeout_s at 10x the slowest step's wall
    timeout_s = 10 * max(step_ms) / 1e3
    wsched, whs, _, wstep_ms, wwall = _scheduled_serve(
        S, eng, params, prompts,
        dict(max_queue_depth=SCHED_QUEUE_CAP, step_timeout_s=timeout_s))
    if [h.stream.tokens for h in whs] != [h.stream.tokens for h in hs] or \
            wsched.metrics.counters["step_failures_total"]:
        raise AssertionError("the watchdog thread's serve differs")

    # every tap armed against all disarmed, alternated A B B A by step
    # over six copies of the load, each submitted once the queue has
    # drained (enough armed steps for the memory ledger's decimated feed,
    # one in 16 steps)
    O.memory_ledger.reset()
    asched = S.ServingScheduler(eng, S.SchedulerConfig(max_queue_depth=100))
    # objectives on the histograms' last bound (a latency past it
    # counts as bad)
    monitor = asched.make_slo_monitor(ttft_p95_ms=10000.0,
                                      itl_p99_ms=10000.0)
    ahs = []
    walls = {False: [], True: []}
    n = 0
    try:
        while asched.pending or len(ahs) < 6 * len(prompts):
            if len(ahs) < 6 * len(prompts) and not asched.queue_depth:
                # the next copy of the load once the queue has drained
                ahs += [asched.submit(p) for p in prompts]
            armed = n % 4 in (1, 2)
            _taps(O, armed, asched, monitor)
            t0 = time.perf_counter()
            asched.step(params)
            walls[armed].append((time.perf_counter() - t0) * 1e3)
            n += 1
        mem = O.memory_ledger.snapshot()
    finally:
        _taps(O, False, asched, monitor)
        O.flight_recorder.clear()
        O.span_collector.clear()
        O.journal.clear()
        O.memory_ledger.reset()
    for j, h in enumerate(ahs):
        first = ahs[j % len(prompts)].stream.tokens
        want_toks = by_prompt.get(j % len(prompts), first)
        if h.state != "done" or h.stream.tokens != first \
                or first != want_toks:
            raise AssertionError(
                f"armed serve request {j} ({h.state}): {h.stream.tokens}, "
                f"first copy {first}, oracle {want_toks}")
    weight_bytes = sum(t.nbytes for t in params.values())
    pool = mem["pools"][0] if mem["pools"] else {}
    pool_bytes = eng.mgr.k_pages.nbytes + eng.mgr.v_pages.nbytes
    if mem["classes"].get("weights") != weight_bytes:
        raise AssertionError(f"ledger weights {mem['classes']} != "
                             f"{weight_bytes}")
    if pool.get("pool_bytes") != pool_bytes:
        raise AssertionError(f"ledger pool bytes {pool.get('pool_bytes')} "
                             f"!= {pool_bytes}")
    plan = O.plan_capacity(num_layers=n_layers,
                           num_kv_heads=cfg.num_key_value_heads,
                           head_dim=cfg.head_dim, page_size=eng.page_size,
                           dtype_bytes=eng.mgr.k_pages.dtype.itemsize,
                           hbm_bytes=pool_bytes)
    if plan.max_pages != eng.mgr.usable_pages or not pool["planner"][
            "exact"]:
        raise AssertionError(f"capacity plan {plan.as_dict()} against "
                             f"{eng.mgr.usable_pages} usable pages")
    card_plan = O.plan_capacity(
        num_layers=n_layers, num_kv_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim, page_size=eng.page_size,
        dtype_bytes=eng.mgr.k_pages.dtype.itemsize,
        hbm_bytes=torch.cuda.get_device_properties(0).total_memory,
        weight_bytes=weight_bytes, max_seq_len=eng.max_seq_len)

    if eng.compile_misses != misses0 or O.recompiles.count() != recompiles0:
        raise AssertionError(f"the scheduled serves built programs: "
                             f"{eng.compile_misses[len(misses0):]}")
    breakdown = _sched_step_breakdown(torch, S, eng, params, cfg.vocab_size)
    gaps = [(b[0] - a[1]) * 1e3 for a, b in zip(spans, spans[1:])]
    m = sched.metrics.histograms
    a_ms, b_ms = (float(np.mean(walls[k])) for k in (False, True))
    return dict(
        requests=len(prompts), shed=shed, cancelled=cancelled,
        launches=launches, micro_rounds=rounds, steps=len(step_ms),
        generated_tokens=generated, serve_s=wall,
        scheduled_tokens_per_s=generated / wall,
        engine_only_tokens_per_s=NEW_TOKENS * len(order) / oracle_s,
        engine_only_mean_step_ms=float(np.mean(oracle_ms)),
        engine_only_steps=len(oracle_ms),
        phase7_tokens_per_s=serve["generated_tokens_per_s_without_capture"],
        mean_step_ms=float(np.mean(step_ms)),
        latency_ms={k: _percentiles(m[k]) for k in
                    ("ttft_ms", "itl_ms", "e2e_ms", "queue_wait_ms")},
        host_gap_ms={"mean": float(np.mean(gaps)),
                     "median": float(np.median(gaps)), "max": max(gaps)},
        breakdown=breakdown,
        equal_to_phase7_greedy=equal / n_done,
        watchdog=dict(step_timeout_s=timeout_s, steps=len(wstep_ms),
                      serve_s=wwall, mean_step_ms=float(np.mean(wstep_ms))),
        armed_overhead=dict(steps_disarmed=len(walls[False]),
                            steps_armed=len(walls[True]),
                            disarmed_ms=a_ms, armed_ms=b_ms,
                            ms=b_ms - a_ms, pct=100 * (b_ms - a_ms) / a_ms),
        memory=dict(weight_bytes=weight_bytes, pool_bytes=pool_bytes,
                    page_bytes=pool["page_bytes"],
                    usable_pages=eng.mgr.usable_pages,
                    card_plan=card_plan.as_dict()),
        prometheus_lines=len(sched.metrics.to_prometheus_text()
                             .splitlines()))


# ---------------------------------------------------------------------------
# phase 9: the RMSNorm backward kernel against its plain version
# ---------------------------------------------------------------------------

def rms_norm_bwd_phase(torch, rn):
    """rms_norm_bwd at the train step's (rows, h) = (16384, 4096)."""
    rows, h, eps = 16384, 4096, 1e-5
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    report = {}
    # tolerances: dx is one rounding of an fp32 value whose row sums run
    # in another order (one bf16 step, 8 mantissa bits); dw sums 16384
    # rows in another order (blocks of 32, then the blocks) before its
    # one rounding
    for dt, kind, tol in (
            (torch.bfloat16, "bf16", dict(dx=(1.6e-2, 1e-4),
                                          dw=(1.6e-2, 1e-2))),
            (torch.float32, "fp32", dict(dx=(1e-5, 1e-5),
                                         dw=(1e-5, 1e-3)))):
        x = torch.randn(rows, h, generator=gen, device="cuda").to(dt)
        g = torch.randn(rows, h, generator=gen, device="cuda").to(dt)
        w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(dt)
        dx, dw = rn.rms_norm_bwd_kernel(x, w, g, eps)
        torch.cuda.synchronize()
        pdx, pdw = rn.rms_norm_bwd_plain(x, w, g, eps)
        err = max(check_close(torch, f"rms_norm_bwd dx {kind}", dx, pdx,
                              *tol["dx"]),
                  check_close(torch, f"rms_norm_bwd dw {kind}", dw, pdw,
                              *tol["dw"]))
        isz = x.element_size()
        nbytes = 3 * rows * h * isz + 2 * h * isz
        bms, by = bound_ms(nbytes, 10 * rows * h, "fp32")
        xl = x.detach().requires_grad_(True)
        wl = w.detach().requires_grad_(True)
        y = torch.nn.functional.rms_norm(xl, (h,), wl, eps)
        lib = profiled_ms(torch, lambda: torch.autograd.grad(
            y, (xl, wl), g, retain_graph=True))
        report[kind] = dict(
            shape=[rows, h], max_abs_err=err, tol=tol,
            ms=device_ms(torch, lambda: rn.rms_norm_bwd_kernel(x, w, g, eps)),
            plain_ms=device_ms(torch, lambda: rn.rms_norm_bwd_plain(
                x, w, g, eps), iters=5, replays=2),
            bound_ms=bms, bound_by=by, library_ms=lib)
        del x, g, w, xl, wl, y, dx, dw, pdx, pdw
        torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 10: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------

def _flash_tol(torch):
    """``paddle_tpu_torch.testing.FLASH_TOL`` keyed "bf16" / "fp32" (the
    tolerances of each flash tensor, scaled by its own rms: their
    reasons are written there)."""
    from paddle_tpu_torch.testing import FLASH_TOL
    return {"bf16": FLASH_TOL[torch.bfloat16],
            "fp32": FLASH_TOL[torch.float32]}


def _flash_inputs(torch, bh, s, d, dt, rep=1, seed=SEED):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape_kv = (bh // rep, s, d)
    q = torch.randn((bh, s, d), generator=gen, device="cuda").to(dt)
    k = torch.randn(shape_kv, generator=gen, device="cuda").to(dt)
    v = torch.randn(shape_kv, generator=gen, device="cuda").to(dt)
    do = torch.randn((bh, s, d), generator=gen, device="cuda").to(dt)
    return q, k, v, do


def _flash_check(torch, fa, name, q, k, v, do, args):
    """Each of the three kernels against the plain versions, ``args``
    being the kernels' arguments after q, k, v (scale, causal, kv_valid,
    causal_offset, kv_rep[, seg_q, seg_k]). Returns each kernel's largest
    |kernel - plain| (fwd over out and lse, dq over dq, dkv over dk and
    dv), each tensor's, and each tensor's relative L2 error ||kernel -
    plain|| / ||plain||."""
    out, lse = fa.flash_fwd_kernel(q, k, v, *args)
    delta = fa._delta(out, do)
    dq = fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta, *args)
    dk, dv = fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, *args)
    torch.cuda.synchronize()
    from paddle_tpu_torch.testing import LSE_TOL, flash_close
    pout, plse = fa.flash_fwd_plain(q, k, v, *args)
    errs, rel = {}, {}
    errs["out"], rel["out"] = flash_close(out, pout, q.dtype, f"{name} out")
    errs["lse"] = check_close(torch, f"{name} lse", lse, plse, *LSE_TOL)
    del pout, plse
    # the backward from the kernel's own out and lse, as autograd runs it
    grads = fa.flash_bwd_plain(q, k, v, out, lse, do, *args)
    for g_name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
        errs[g_name], rel[g_name] = flash_close(got, want, q.dtype,
                                                f"{name} {g_name}")
    return dict(max_abs_err=dict(fwd=max(errs["out"], errs["lse"]),
                                 dq=errs["dq"],
                                 dkv=max(errs["dk"], errs["dv"])),
                tensor_err=errs, rel_l2=rel)


def flash_phase(torch, fa):
    d = 128
    checks = {}
    for name, bh, s, dt, kind, rep, kv_valid in (
            ("causal_bf16", 32, 2048, torch.bfloat16, "bf16", 1, None),
            ("causal_fp32", 32, 2048, torch.float32, "fp32", 1, None),
            ("gqa_nkv8_bf16", 32, 2048, torch.bfloat16, "bf16", 4, None),
            ("kv_valid2000_bf16", 32, 2048, torch.bfloat16, "bf16", 1, 2000),
            ("s2000_bf16", 32, 2000, torch.bfloat16, "bf16", 1, None)):
        q, k, v, do = _flash_inputs(torch, bh, s, d, dt, rep)
        checks[name] = dict(
            bh=bh, s=s, kv_rep=rep, kv_valid=kv_valid,
            **_flash_check(torch, fa, name, q, k, v, do,
                           (1.0 / math.sqrt(d), True, kv_valid, 0, rep)),
            tol_rtol_atol_over_rms_l2=_flash_tol(torch)[kind])
        del q, k, v, do
        torch.cuda.empty_cache()

    # the train step's shape: B*nh = 8*32 = 256 rows, S 2048, causal, bf16
    bh, s = 256, 2048
    q, k, v, do = _flash_inputs(torch, bh, s, d, torch.bfloat16)
    sc = 1.0 / math.sqrt(d)
    step_check = _flash_check(torch, fa, "step_bf16", q, k, v, do,
                              (sc, True, None, 0, 1))
    torch.cuda.empty_cache()
    out, lse = fa.flash_fwd_kernel(q, k, v, sc, True)
    delta = fa._delta(out, do)
    isz = q.element_size()
    mat = bh * s * d * isz                         # one (BH, S, D) tensor
    row = bh * s * 4                               # one fp32 (BH, S) row
    pairs = bh * s * s / 2                         # causal: half the square
    fwd = dict(ms=device_ms(torch, lambda: fa.flash_fwd_kernel(
        q, k, v, sc, True), iters=10, replays=3))
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(4 * mat + row,
                                                4 * d * pairs, "bf16")
    dq = dict(ms=device_ms(torch, lambda: fa.flash_bwd_dq_kernel(
        q, k, v, do, lse, delta, sc, True), iters=10, replays=3))
    dq["bound_ms"], dq["bound_by"] = bound_ms(5 * mat + 2 * row,
                                              6 * d * pairs, "bf16")
    dkv = dict(ms=device_ms(torch, lambda: fa.flash_bwd_dkv_kernel(
        q, k, v, do, lse, delta, sc, True), iters=10, replays=3))
    dkv["bound_ms"], dkv["bound_by"] = bound_ms(6 * mat + 2 * row,
                                                8 * d * pairs, "bf16")
    fwd["plain_ms"] = eager_ms(torch, lambda: fa.flash_fwd_plain(
        q, k, v, sc, True), iters=2, warmup=1)
    torch.cuda.empty_cache()
    # the plain backward computes dq, dk and dv in one call
    dq["plain_ms"] = dkv["plain_ms"] = eager_ms(
        torch, lambda: fa.flash_bwd_plain(q, k, v, out, lse, do, sc, True),
        iters=2, warmup=1)
    torch.cuda.empty_cache()
    # yardstick: one PyTorch call, (B, H, S, D) = (1, 256, 2048, 128);
    # its backward computes dq, dk and dv together
    q4, k4, v4, do4 = (t.reshape(1, bh, s, d) for t in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd["library_ms"] = device_ms(torch, lambda: sdpa(q4, k4, v4,
                                                      is_causal=True))
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q4, k4, v4))
    o4 = sdpa(ql, kl, vl, is_causal=True)
    dq["library_ms"] = dkv["library_ms"] = profiled_ms(
        torch, lambda: torch.autograd.grad(o4, (ql, kl, vl), do4,
                                           retain_graph=True))
    # fp32 at the check shape (BH 32), for the record
    q, k, v, do = _flash_inputs(torch, 32, s, d, torch.float32)
    out32, lse32 = fa.flash_fwd_kernel(q, k, v, sc, True)
    delta32 = fa._delta(out32, do)
    fp32 = dict(bh=32, s=s, fwd_bound_ms=bound_ms(
        0, 4 * d * 32 * s * s / 2, "fp32")[0])
    for key, fn in (
            ("fwd_ms", lambda: fa.flash_fwd_kernel(q, k, v, sc, True)),
            ("dq_ms", lambda: fa.flash_bwd_dq_kernel(
                q, k, v, do, lse32, delta32, sc, True)),
            ("dkv_ms", lambda: fa.flash_bwd_dkv_kernel(
                q, k, v, do, lse32, delta32, sc, True))):
        fp32[key] = device_ms(torch, fn, iters=5, replays=2)
    del q, k, v, do, q4, k4, v4, do4, ql, kl, vl, o4, out, lse, delta
    torch.cuda.empty_cache()
    for key, r in (("fwd", fwd), ("dq", dq), ("dkv", dkv)):
        r["max_abs_err"] = step_check["max_abs_err"][key]
    return dict(checks=checks, step_shape=dict(
        bh=bh, s=s, d=d, dtype="bf16", fwd=fwd, dq=dq, dkv=dkv,
        tensor_err=step_check["tensor_err"],
        rel_l2=step_check["rel_l2"]), fp32_bh32=fp32,
        resources=_flash_resources(fa, "d128"))


def _flash_resources(fa, head):
    """ptxas's registers and spill bytes, the dynamic shared memory and
    the SASS's wgmma (HGMMA) and atomic instructions of each flash
    instantiation at this head dim; fails if a bf16 one spills, issues
    no wgmma, or any uses atomics."""
    from paddle_tpu_torch.ops import _common
    res = {k: v for k, v in fa.kernel_resources().items() if head in k}
    for name, counts in _common.sass_counts("flash_attention").items():
        for key, v in res.items():
            dt, kind, d = key.split()[:3]
            if (("sm90" in name) == (dt == "bf16")
                    and f"flash_attention_{kind}_kernelILi{d[1:]}ELb"
                    f"{int(key.endswith('seg'))}" in name):
                v.update(counts)
    bad = [k for k, v in res.items() if v.get("atomics") or (
        k.startswith("bf16") and (v.get("spill_stores") or
                                  v.get("spill_loads") or not v.get("hgmma")))]
    if bad or not res:
        raise AssertionError(f"flash kernels spill, lack wgmma or use "
                             f"atomics: {bad}" if bad else "no ptxas report")
    return res


# ---------------------------------------------------------------------------
# phase 11: tiny training parity, card vs CPU
# ---------------------------------------------------------------------------

def train_parity_phase(torch, L):
    """5 AdamW steps of build_train_step (full remat, two microbatches)
    on the card and on the CPU from the same fp32 weights. S = 100 is
    not a multiple of any tile; 2 query heads share one KV head."""
    cfg = L.llama_tiny(hidden_size=256, num_attention_heads=2,
                       num_key_value_heads=1, intermediate_size=512,
                       num_hidden_layers=2, dtype=torch.float32)
    params_cpu = L.init_params(cfg, seed=SEED, device="cpu")
    rng = np.random.RandomState(SEED)
    steps, lr = 5, 1e-3
    ids = rng.randint(0, cfg.vocab_size, (steps, 2, 1, 100)).astype(np.int64)
    labels = np.roll(ids, -1, axis=-1)
    runs = {}
    for dev in ("cuda", "cpu"):
        step, _ = L.build_train_step(cfg, learning_rate=lr, remat=True,
                                     device=dev)
        params = {k: v.clone().to(dev) for k, v in params_cpu.items()}
        opt = L.init_opt_state(params)
        losses = []
        for i in range(steps):
            loss, params, opt = step(params, opt,
                                     torch.from_numpy(ids[i]).to(dev),
                                     torch.from_numpy(labels[i]).to(dev))
            losses.append(float(loss))
        runs[dev] = (losses, {k: v.cpu() for k, v in params.items()})
    # tolerances: fp32 on both sides, sums in other orders (cuBLAS vs the
    # CPU, online vs one-pass softmax), so the losses agree to fp32
    # rounding; the weights as paddle_tpu_torch.testing.
    # trained_weights_close says
    from paddle_tpu_torch.testing import trained_weights_close
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-5,
                               atol=1e-6)
    return dict(steps=steps, losses_card=runs["cuda"][0],
                losses_cpu=runs["cpu"][0],
                **trained_weights_close(runs["cuda"][1], runs["cpu"][1], lr,
                                        steps, msg="train parity"))


# ---------------------------------------------------------------------------
# phase 12: the training slice at full width
# ---------------------------------------------------------------------------

TRAIN_KINDS = (("flash_fwd", ("flash_attention_fwd",)),
               ("flash_bwd", ("flash_attention_bwd",)),
               ("rms_norm", ("rms_norm",)), ("matmul", MATMUL_NAMES))


def train_7b_phase(torch, L, rn, fa):
    cfg = L.llama2_7b(num_hidden_layers=8, dtype=torch.bfloat16)
    n_layers = cfg.num_hidden_layers
    step, init = L.build_train_step(cfg, learning_rate=1e-4, remat=True,
                                    device="cuda")
    t0 = time.perf_counter()
    params, opt = init(seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    b, s = 8, 2048
    rng = np.random.RandomState(SEED)
    ids_np = rng.randint(0, cfg.vocab_size, (1, b, s)).astype(np.int64)
    ids = torch.from_numpy(ids_np).cuda()
    labels = torch.from_numpy(np.roll(ids_np, -1, axis=-1)).cuda()
    counters = {"rms_norm_fwd": rn.rms_norm,
                "rms_norm_bwd": rn.rms_norm_bwd,
                "flash_attention_fwd": fa.flash_fwd_kernel,
                "flash_attention_bwd_dq": fa.flash_bwd_dq_kernel,
                "flash_attention_bwd_dkv": fa.flash_bwd_dkv_kernel}
    # per step (one microbatch): RMSNorm forward 2L+1, and 2L more in the
    # remat replay; backward 2L+1; flash forward L, and L in the replay;
    # dQ and dK/dV once per layer
    want = {"rms_norm_fwd": 4 * n_layers + 1,
            "rms_norm_bwd": 2 * n_layers + 1,
            "flash_attention_fwd": 2 * n_layers,
            "flash_attention_bwd_dq": n_layers,
            "flash_attention_bwd_dkv": n_layers}
    totals = {k: 0 for k in counters}
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for i in range(7):                       # 2 warm-up + 5 timed steps
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, params, opt = step(params, opt, ids, labels)
        losses.append(float(loss))           # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        got = {k: c.launches for k, c in counters.items()}
        if got != want:
            raise AssertionError(f"step {i}: launch counts {got} != {want}")
        for k in totals:
            totals[k] += got[k]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall over 7 steps: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timed = step_ms[2:]
    mean_ms = float(np.mean(timed))
    tokens = b * s
    tok_s = tokens / (mean_ms / 1e3)
    # bench.py's accounting: 6 FLOPs per matmul parameter and token (the
    # embedding gather excluded) + causal attention 6·L·S·h
    n_params = L.param_count(cfg)
    n_matmul = n_params - cfg.vocab_size * cfg.hidden_size
    flops_per_token = 6.0 * n_matmul + 6.0 * n_layers * s * cfg.hidden_size
    mfu = flops_per_token * tok_s / PEAK_OPS_PER_S["bf16"]

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss, params, opt = step(params, opt, ids, labels)
        torch.cuda.synchronize()
    kinds, top = _kernel_ms_by_kind(prof, TRAIN_KINDS, n_top=14)
    busy = sum(kinds.values())
    del params, opt, step, init, loss
    return dict(
        layers=n_layers, reduced="num_hidden_layers 32 -> 8 (memory)",
        params=n_params, init_s=init_s, batch=[1, b, s], lr=1e-4,
        remat="full", losses=losses, step_ms=step_ms, mean_step_ms=mean_ms,
        tokens_per_s=tok_s, flops_per_token=flops_per_token,
        mfu_vs_989tflops=mfu, peak_mem_gb=peak_gb,
        launches_per_step=want, launches=totals,
        breakdown=dict(kernel_ms=kinds, top_kernels=top, device_busy_ms=busy,
                       wall_ms=mean_ms, idle_share=1 - busy / mean_ms))


# ---------------------------------------------------------------------------
# the packed BERT-large batch (phases 14 and 16)
# ---------------------------------------------------------------------------

def pack_batch(b, s, lo, hi, vocab, seed=SEED):
    """``bench_bert_packed``'s batch (benchmarks/bench_workloads.py:164-193):
    sequence lengths uniform in [lo, hi] until B·S tokens are drawn,
    packed into B rows of S longest first, each into the fitting row that
    is least full; ids uniform in [1, vocab), segment ids per row (-1 at
    pads), and 15 % of the real positions scored (labels -100
    elsewhere). Returns numpy ``(ids, seg, labels, seg_lens)``."""
    rng = np.random.RandomState(seed)
    lens = []
    while True:
        n = int(rng.randint(lo, hi + 1))
        if sum(lens) + n > b * s:
            break
        lens.append(n)
    lens.sort(reverse=True)
    fill = [0] * b
    seg_lens = [[] for _ in range(b)]
    for n in lens:
        r = min((i for i in range(b) if fill[i] + n <= s),
                key=lambda i: fill[i], default=None)
        if r is None:
            continue
        seg_lens[r].append(n)
        fill[r] += n
    ids = np.zeros((b, s), np.int32)
    seg = np.full((b, s), -1, np.int32)
    labels = np.full((b, s), -100, np.int64)
    for r in range(b):
        at = 0
        for si, n in enumerate(seg_lens[r]):
            tok = rng.randint(1, vocab, (n,))
            ids[r, at:at + n] = tok
            seg[r, at:at + n] = si
            labels[r, at:at + n] = np.where(rng.rand(n) < 0.15, tok, -100)
            at += n
    return ids, seg, labels, seg_lens


BERT_B, BERT_S = 16, 512


def _bert_large(E):
    return E.ErnieConfig(vocab_size=30522, hidden_size=1024,
                         num_hidden_layers=24, num_attention_heads=16,
                         intermediate_size=4096, max_position_embeddings=512)


# ---------------------------------------------------------------------------
# phase 13: the LayerNorm kernels against their plain versions
# ---------------------------------------------------------------------------

def _l2_cold(tensors, min_bytes=200e6):
    """Copies of ``tensors`` (a tuple), enough that one pass over all of
    them moves ``min_bytes``. A timed function that takes the next copy
    at every call reads its inputs from device memory and not from the
    50 MB L2 cache, as the training step's LayerNorms do."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(2, math.ceil(min_bytes / nbytes))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def _ln_bwd_launches(ln, rows, h, sms):
    """The backward's launches phase 13 times: ln_bwd_config's, the grid
    it replaced (a row a tile, 512 programs of 2 warps) and variants of
    the new one (rows and warps a tile, programs per SM)."""
    cfg = ln.ln_bwd_config(rows, h, sms)
    tiles = lambda per: -(-rows // per)  # noqa: E731
    return {"config": cfg,
            "parent": ln.LnBwdConfig(1, min(512, rows), 2),
            "rows2": cfg._replace(rows_per_tile=2, num_warps=2,
                                  programs=min(tiles(2), 4 * sms)),
            "rows8": cfg._replace(rows_per_tile=8, num_warps=8,
                                  programs=min(tiles(8), sms)),
            "programs4_per_sm": cfg._replace(programs=min(tiles(
                cfg.rows_per_tile), 4 * sms)),
            "programs1_per_sm": cfg._replace(programs=min(tiles(
                cfg.rows_per_tile), sms))}


def layer_norm_phase(torch, ln):
    """layer_norm and its backward at the BERT-large step's (rows, h) =
    (16·512, 1024), eps 1e-12, with F.layer_norm's forward and backward
    as the yardsticks. Every timed call reads fresh copies of x (and g),
    so the 16.8 MB (bf16) rows do not sit in L2 between calls. Each
    output is held to ``paddle_tpu_torch.testing.LN_TOL``; the backward
    at each launch of ``_ln_bwd_launches`` (the chosen one's time is
    ``ms``, the one it replaced ``parent_launch_ms``), its dw and db the
    same bits on a second run."""
    from paddle_tpu_torch.testing import LN_TOL, rms_close
    rows, h, eps = BERT_B * BERT_S, 1024, 1e-12
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    fwd, bwd = {}, {}
    for dt, kind in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        x = (2 * torch.randn(rows, h, generator=gen, device="cuda")
             + 0.5).to(dt)
        g = torch.randn(rows, h, generator=gen, device="cuda").to(dt)
        w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(dt)
        b = (0.1 * torch.randn(h, generator=gen, device="cuda")).to(dt)
        y = ln.layer_norm_kernel(x, w, b, eps)
        dx, dw, db = ln.layer_norm_bwd_kernel(x, w, g, eps)
        torch.cuda.synchronize()
        tol = LN_TOL[dt]
        y_err = rms_close(y, ln.ln_plain(x, w, b, eps), *tol["y"],
                          f"layer_norm {kind}")
        pdx, pdw, pdb = ln.ln_bwd_plain(x, w, g, eps)
        launches = _ln_bwd_launches(ln, rows, h, sms)
        bwd_err = 0.0
        for name, cfg in launches.items():
            dx, dw, db = ln.layer_norm_bwd_kernel(x, w, g, eps, config=cfg)
            _, dw2, db2 = ln.layer_norm_bwd_kernel(x, w, g, eps, config=cfg)
            torch.cuda.synchronize()
            if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
                raise AssertionError(f"layer_norm_bwd {name} {kind}: dw/db "
                                     "differ between two runs")
            bwd_err = max(
                bwd_err,
                rms_close(dx, pdx, *tol["dx"], f"layer_norm_bwd dx {name}"),
                rms_close(dw, pdw, *tol["sums"],
                          f"layer_norm_bwd dw {name}"),
                rms_close(db, pdb, *tol["sums"],
                          f"layer_norm_bwd db {name}"))
        isz = x.element_size()
        copies = _l2_cold((x, g))
        nxt = itertools.cycle(copies).__next__
        fb, fby = bound_ms(2 * rows * h * isz + 2 * h * isz, 8 * rows * h,
                           "fp32")
        fwd[kind] = dict(
            shape=[rows, h], eps=eps, max_abs_err=y_err, tol=tol["y"],
            ms=device_ms(torch, lambda: ln.layer_norm_kernel(
                nxt()[0], w, b, eps)),
            plain_ms=device_ms(torch, lambda: ln.ln_plain(x, w, b, eps),
                               iters=5, replays=2),
            bound_ms=fb, bound_by=fby,
            library_ms=device_ms(torch, lambda: torch.nn.functional.
                                 layer_norm(nxt()[0], (h,), w, b, eps)))
        bb, bby = bound_ms(3 * rows * h * isz + 3 * h * isz, 20 * rows * h,
                           "fp32")

        def kernel_bwd(cfg=None):
            xc, gx = nxt()
            return ln.layer_norm_bwd_kernel(xc, w, gx, eps, config=cfg)

        # the library's backward, one recorded forward per copy
        wl, bl = (t.detach().requires_grad_(True) for t in (w, b))
        graphs = []
        for xc, gx in copies:
            xl = xc.detach().requires_grad_(True)
            graphs.append((torch.nn.functional.layer_norm(
                xl, (h,), wl, bl, eps), (xl, wl, bl), gx))
        lib = itertools.cycle(graphs).__next__
        launch_ms = {name: device_ms(torch, lambda: kernel_bwd(cfg))
                     for name, cfg in launches.items()}
        bwd[kind] = dict(
            shape=[rows, h], eps=eps, max_abs_err=bwd_err, tol=tol,
            launch=launches["config"]._asdict(), ms=launch_ms.pop("config"),
            parent_launch_ms=launch_ms.pop("parent"), variants_ms=launch_ms,
            plain_ms=device_ms(torch, lambda: ln.ln_bwd_plain(x, w, g, eps),
                               iters=5, replays=2),
            bound_ms=bb, bound_by=bby,
            library_ms=profiled_ms(torch, lambda: torch.autograd.grad(
                *lib(), retain_graph=True), iters=len(graphs)))
        del x, g, w, b, y, dx, dw, db, dw2, db2, pdx, pdw, pdb, copies, nxt
        del graphs, lib, wl, bl
        torch.cuda.empty_cache()
    return dict(fwd=fwd, bwd=bwd)


# ---------------------------------------------------------------------------
# phase 14: the segment-masked flash kernels against their plain versions
# ---------------------------------------------------------------------------

def seg_flash_phase(torch, E, fa):
    """The three flash kernels with segment ids at the BERT-large step's
    shape: BH 16·16, S 512, d 64, non-causal, the packed batch's (16,
    512) segment ids (pads -1 on the query side, -2 on the key side).
    The yardstick is SDPA with the boolean segment mask, for its time
    only (it gives the pad rows, which attend nothing, NaN)."""
    cfg = _bert_large(E)
    nh, d = cfg.num_attention_heads, cfg.hidden_size // cfg.num_attention_heads
    b, s = BERT_B, BERT_S
    _, seg_np, _, seg_lens = pack_batch(b, s, 64, 512, cfg.vocab_size)
    seg = torch.from_numpy(seg_np).cuda()
    seg_q = torch.where(seg < 0, -1, seg).contiguous()
    seg_k = torch.where(seg < 0, -2, seg).contiguous()
    bh, sc = b * nh, 1.0 / math.sqrt(d)
    args = (sc, False, None, 0, 1, seg_q, seg_k)
    checks = {}
    for dt, kind in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        q, k, v, do = _flash_inputs(torch, bh, s, d, dt)
        checks[kind] = _flash_check(torch, fa, f"segmented {kind}", q, k,
                                    v, do, args)
        out, lse = fa.flash_fwd_kernel(q, k, v, *args)
        pads = fa._seg_rows(seg_q, bh) < 0
        if not (bool((out[pads] == 0).all())
                and bool((lse[pads] == -1e30).all())):
            raise AssertionError("segmented: pad rows must give out 0 and "
                                 "lse -1e30")
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    # times at bf16; the work is the pairs inside each segment
    q, k, v, do = _flash_inputs(torch, bh, s, d, torch.bfloat16)
    out, lse = fa.flash_fwd_kernel(q, k, v, *args)
    delta = fa._delta(out, do)
    pairs = nh * sum(n * n for row in seg_lens for n in row)
    isz = q.element_size()
    mat, row = bh * s * d * isz, bh * s * 4
    segb = 2 * b * s * 4
    rep = dict(bh=bh, s=s, d=d, dtype="bf16", pairs=pairs,
               pairs_share_of_square=pairs / (bh * s * s),
               skipped_tile_pairs_share=fa.seg_skip_share(seg_q, seg_k))
    for key, nmat, nrow, ops, fn in (
            ("fwd", 4, 1, 4, lambda: fa.flash_fwd_kernel(q, k, v, *args)),
            ("dq", 5, 2, 6, lambda: fa.flash_bwd_dq_kernel(
                q, k, v, do, lse, delta, *args)),
            ("dkv", 6, 2, 8, lambda: fa.flash_bwd_dkv_kernel(
                q, k, v, do, lse, delta, *args))):
        r = dict(ms=device_ms(torch, fn, iters=10, replays=3),
                 max_abs_err=max(checks["bf16"]["max_abs_err"][key],
                                 checks["fp32"]["max_abs_err"][key]))
        r["bound_ms"], r["bound_by"] = bound_ms(
            nmat * mat + nrow * row + segb, ops * d * pairs, "bf16")
        rep[key] = r
    rep["fwd"]["plain_ms"] = eager_ms(torch, lambda: fa.flash_fwd_plain(
        q, k, v, *args), iters=2, warmup=1)
    rep["dq"]["plain_ms"] = rep["dkv"]["plain_ms"] = eager_ms(
        torch, lambda: fa.flash_bwd_plain(q, k, v, out, lse, do, *args),
        iters=2, warmup=1)
    torch.cuda.empty_cache()
    # yardstick: SDPA with the segment mask, (B, H, S, D) = (16, 16, 512,
    # 64); its backward computes dq, dk and dv together
    mask = (seg_q[:, None, :, None] == seg_k[:, None, None, :])
    q4, k4, v4, do4 = (t.reshape(b, nh, s, d) for t in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rep["fwd"]["library_ms"] = device_ms(torch, lambda: sdpa(
        q4, k4, v4, attn_mask=mask))
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q4, k4, v4))
    o4 = sdpa(ql, kl, vl, attn_mask=mask)
    rep["dq"]["library_ms"] = rep["dkv"]["library_ms"] = profiled_ms(
        torch, lambda: torch.autograd.grad(o4, (ql, kl, vl), do4,
                                           retain_graph=True))
    # fp32 kernel times, for the record
    q, k, v, do = _flash_inputs(torch, bh, s, d, torch.float32)
    out32, lse32 = fa.flash_fwd_kernel(q, k, v, *args)
    delta32 = fa._delta(out32, do)
    rep["fp32_ms"] = dict(
        fwd=device_ms(torch, lambda: fa.flash_fwd_kernel(q, k, v, *args),
                      iters=5, replays=2),
        dq=device_ms(torch, lambda: fa.flash_bwd_dq_kernel(
            q, k, v, do, lse32, delta32, *args), iters=5, replays=2),
        dkv=device_ms(torch, lambda: fa.flash_bwd_dkv_kernel(
            q, k, v, do, lse32, delta32, *args), iters=5, replays=2),
        fwd_bound_ms=bound_ms(0, 4 * d * pairs, "fp32")[0])
    del q, k, v, do, out, lse, delta, q4, k4, v4, do4, ql, kl, vl, o4, mask
    del out32, lse32, delta32
    torch.cuda.empty_cache()
    return dict(checks=checks, step_shape=rep,
                tol_rtol_atol_over_rms_l2=_flash_tol(torch),
                resources=_flash_resources(fa, "d64"))


# ---------------------------------------------------------------------------
# phase 15: tiny ERNIE training parity, card vs CPU
# ---------------------------------------------------------------------------

def ernie_parity_phase(torch, E):
    """5 packed MLM steps of build_mlm_train_step on the card (kernels)
    and on the CPU (plain versions) from the same fp32 weights; d 64
    heads (the flash kernels take d 64 and 128), S 100."""
    cfg = E.ernie_tiny(vocab_size=256, hidden_size=128,
                       num_attention_heads=2, intermediate_size=256,
                       num_hidden_layers=2, max_position_embeddings=128)
    ids, seg, labels, _ = pack_batch(3, 100, 10, 60, cfg.vocab_size)
    batch = [torch.from_numpy(a) for a in (ids, labels, seg)]
    steps, lr = 5, 1e-3
    runs = {}
    for dev in ("cuda", "cpu"):
        step, init = E.build_mlm_train_step(cfg, learning_rate=lr,
                                            device="cpu")
        model, _ = init(seed=SEED)
        model.to(dev)
        opt = E.AdamW(model.named_parameters(), learning_rate=lr)
        losses = [float(step(model, opt, *(t.to(dev) for t in batch)))
                  for _ in range(steps)]
        runs[dev] = (losses, {n: p.detach().cpu()
                              for n, p in model.named_parameters()})
    # tolerances as phase 11's, the key bias (qkv_bias[h:2h], rounding
    # noise on both devices) held to 2·lr·steps only
    from paddle_tpu_torch.testing import trained_weights_close
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-5,
                               atol=1e-6)
    return dict(steps=steps, losses_card=runs["cuda"][0],
                losses_cpu=runs["cpu"][0],
                **trained_weights_close(runs["cuda"][1], runs["cpu"][1], lr,
                                        steps, hidden=cfg.hidden_size,
                                        msg="ernie parity"))


# ---------------------------------------------------------------------------
# phase 16: packed BERT-large MLM pretraining at full width
# ---------------------------------------------------------------------------

ERNIE_KINDS = (("flash_fwd", ("flash_attention_fwd",)),
               ("flash_bwd", ("flash_attention_bwd",)),
               ("layer_norm", ("layer_norm",)), ("matmul", MATMUL_NAMES))


def bert_large_phase(torch, E, ln, fa):
    """bench_bert_packed's configuration (bench_workloads.py:145-150,
    164-221): BERT-large (24 layers, h 1024, 16 heads, ffn 4096, vocab
    30522), bf16 weights with fp32 master weights and moments, AdamW lr
    1e-4 wd 0.01, one packed (16, 512) batch repeated; 2 warm-up and 5
    timed steps, every step's launch counts checked, the loss falling,
    and a profiler breakdown of one step. Nothing is cut."""
    cfg = _bert_large(E)
    n_layers, h = cfg.num_hidden_layers, cfg.hidden_size
    step, init = E.build_mlm_train_step(cfg, learning_rate=1e-4,
                                        weight_decay=0.01,
                                        dtype=torch.bfloat16, device="cuda")
    t0 = time.perf_counter()
    model, opt = init(seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids_np, seg_np, labels_np, seg_lens = pack_batch(
        BERT_B, BERT_S, 64, 512, cfg.vocab_size)
    ids, seg, labels = (torch.from_numpy(a).cuda()
                        for a in (ids_np, seg_np, labels_np))
    counters = {"layer_norm_fwd": ln.layer_norm,
                "layer_norm_bwd": ln.layer_norm_bwd,
                "flash_attention_fwd": fa.flash_fwd_kernel,
                "flash_attention_bwd_dq": fa.flash_bwd_dq_kernel,
                "flash_attention_bwd_dkv": fa.flash_bwd_dkv_kernel}
    # per step: the embeddings' LN, two post-LNs per layer and the MLM
    # transform's LN, forward and backward; one flash forward, dQ and
    # dK/dV per layer (no remat)
    want = {"layer_norm_fwd": 2 * n_layers + 2,
            "layer_norm_bwd": 2 * n_layers + 2,
            "flash_attention_fwd": n_layers,
            "flash_attention_bwd_dq": n_layers,
            "flash_attention_bwd_dkv": n_layers}
    totals = {k: 0 for k in counters}
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for i in range(7):                       # 2 warm-up + 5 timed steps
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(model, opt, ids, labels, seg)
        losses.append(float(loss))           # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        got = {k: c.launches for k, c in counters.items()}
        if got != want:
            raise AssertionError(f"step {i}: launch counts {got} != {want}")
        for k in totals:
            totals[k] += got[k]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall over 7 steps: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mean_ms = float(np.mean(step_ms[2:]))
    real = int((seg_np >= 0).sum())
    # bench_bert_packed's accounting: 6 FLOPs per parameter and real
    # token, plus 12·L·h·Σ s_i² for attention inside each segment
    n_params = E.param_count(model)
    flops = 6.0 * n_params * real + 12.0 * n_layers * h * float(
        sum(n * n for row in seg_lens for n in row))
    mfu = flops / (mean_ms / 1e3) / PEAK_OPS_PER_S["bf16"]

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss = step(model, opt, ids, labels, seg)
        torch.cuda.synchronize()
    kinds, top = _kernel_ms_by_kind(prof, ERNIE_KINDS, n_top=14)
    busy = sum(kinds.values())
    from torch.autograd import DeviceType
    n_kernels = sum(e.count for e in prof.key_averages()
                    if getattr(e, "device_type", None) == DeviceType.CUDA)
    # wall split of one more step: forward + backward, then AdamW, each
    # ended by a synchronize
    split = {}
    t0 = time.perf_counter()
    opt.clear_grad()
    model.compute_loss(ids, labels, segment_ids=seg).backward()
    torch.cuda.synchronize()
    split["forward_backward_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    opt.step()
    torch.cuda.synchronize()
    split["adamw_ms"] = (time.perf_counter() - t0) * 1e3
    del model, opt, step, init, loss
    return dict(
        layers=n_layers, reduced="nothing", params=n_params, init_s=init_s,
        batch=[BERT_B, BERT_S], sequences=sum(len(r) for r in seg_lens),
        real_tokens=real, fill_rate=real / (BERT_B * BERT_S), lr=1e-4,
        weight_decay=0.01, remat="none", losses=losses, step_ms=step_ms,
        mean_step_ms=mean_ms, real_tokens_per_s=real / (mean_ms / 1e3),
        flops_per_step=flops, mfu_vs_989tflops=mfu, peak_mem_gb=peak_gb,
        launches_per_step=want, launches=totals,
        breakdown=dict(kernel_ms=kinds, top_kernels=top, device_busy_ms=busy,
                       wall_ms=mean_ms, idle_share=1 - busy / mean_ms,
                       kernels_launched=n_kernels, wall_split=split))


# ---------------------------------------------------------------------------
# phase 17: the weight-gradient accumulation kernel against its plain version
# ---------------------------------------------------------------------------

# (name, rows, din, dout, input dtype, accumulator dtype): the Llama-2-7B
# projections at a (2, 2048) micro-batch (q/k/v/o, gate/up, down), bf16
# into fp32 main_grad; the same in fp32; a bf16 accumulator
# (multi_precision=False); and a shape that tiles nowhere
GRAD_ADD_CASES = (
    ("qkvo_bf16", 4096, 4096, 4096, "bfloat16", "float32"),
    ("gate_up_bf16", 4096, 4096, 11008, "bfloat16", "float32"),
    ("down_bf16", 4096, 11008, 4096, "bfloat16", "float32"),
    ("qkvo_fp32", 4096, 4096, 4096, "float32", "float32"),
    ("gate_up_fp32", 4096, 4096, 11008, "float32", "float32"),
    ("down_fp32", 4096, 11008, 4096, "float32", "float32"),
    ("qkvo_bf16_acc", 4096, 4096, 4096, "bfloat16", "bfloat16"),
    ("unaligned_bf16", 1000, 4096, 1000, "bfloat16", "float32"),
    ("qkvo_fp16", 4096, 4096, 4096, "float16", "float32"),
    # few output tiles: the wgmma route splits its rows (16 parts)
    ("split_bf16", 8192, 512, 512, "bfloat16", "float32"),
)


def _has_out_dtype(torch):
    """Whether this torch's ``torch.mm`` takes ``out_dtype`` (bf16 in,
    fp32 out in one call)."""
    a = torch.ones(16, 16, device="cuda", dtype=torch.bfloat16)
    try:
        torch.mm(a, a, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return False
    return True


def grad_add_phase(torch, fl):
    """The row-7 kernel against its plain version at the shapes of
    ``GRAD_ADD_CASES``, from a given accumulator (in place) and from
    none, under ``paddle_tpu_torch.testing.GRAD_ADD_TOL``; its device
    time over rotating copies of ≥ 200 MB of inputs (they would sit in
    L2 otherwise), its bound, the plain version's time, and the library
    yardstick: ``acc.addmm_(xᵀ, g)`` where the accumulator has the
    inputs' dtype; for bf16 into fp32 ``torch.mm(xᵀ, g,
    out_dtype=float32)`` where this torch has it (the product alone),
    else ``acc.add_((xᵀ @ g).float())``. ``autograd_dw_ms`` is the bf16
    ``xᵀ @ g`` that autograd runs for a bf16 weight's gradient."""
    from paddle_tpu_torch.testing import GRAD_ADD_TOL, grad_add_close
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out_dtype = _has_out_dtype(torch)
    report = {}
    for name, rows, din, dout, dt_name, acc_name in GRAD_ADD_CASES:
        dt, acc_dt = getattr(torch, dt_name), getattr(torch, acc_name)
        x = torch.randn(rows, din, generator=gen, device="cuda").to(dt)
        g = torch.randn(rows, dout, generator=gen, device="cuda").to(dt)
        acc = (64 * torch.randn(din, dout, generator=gen,
                                device="cuda")).to(acc_dt)
        got = fl.fused_linear_grad_add_kernel(x, g, acc.clone(), acc_dt)
        fresh = fl.fused_linear_grad_add_kernel(x, g, None, acc_dt)
        torch.cuda.synchronize()
        err = grad_add_close(got, fl.fused_linear_param_grad_add_plain(
            x, g, acc.clone(), acc_dt), f"grad_add {name}")
        err_fresh = grad_add_close(fresh, fl.fused_linear_param_grad_add_plain(
            x, g, None, acc_dt), f"grad_add {name} (no accumulator)")
        del got, fresh
        isz, asz = x.element_size(), acc.element_size()
        bound, by = bound_ms((rows * din + rows * dout) * isz
                             + 2 * din * dout * asz, 2.0 * rows * din * dout,
                             "fp32" if dt == torch.float32 else "bf16")
        copies = _l2_cold((x, g, acc))
        nxt = itertools.cycle(copies).__next__

        def kernel():
            xc, gc, ac = nxt()
            fl.fused_linear_grad_add_kernel(xc, gc, ac, acc_dt)

        if acc_dt == dt:
            call = "acc.addmm_(x.t(), g)"

            def library():
                xc, gc, ac = nxt()
                ac.addmm_(xc.t(), gc)
        elif out_dtype:
            call = "torch.mm(x.t(), g, out_dtype=torch.float32)"

            def library():
                xc, gc, _ = nxt()
                torch.mm(xc.t(), gc, out_dtype=torch.float32)
        else:
            call = "acc.add_((x.t() @ g).float())"

            def library():
                xc, gc, ac = nxt()
                ac.add_((xc.t() @ gc).float())

        ms = device_ms(torch, kernel)
        route = fl.grad_add_route(rows, din, dout, dt)
        r = dict(shape=[rows, din, dout], dtype=dt_name, acc_dtype=acc_name,
                 route=route, split=fl.grad_add_split(
                     rows, din, dout, torch.cuda.get_device_properties(0)
                     .multi_processor_count) if route == "wgmma" else None,
                 max_abs_err=err, max_abs_err_no_acc=err_fresh,
                 tol=list(GRAD_ADD_TOL[acc_dt]), ms=ms,
                 plain_ms=device_ms(torch, lambda: fl.
                                    fused_linear_param_grad_add_plain(
                                        x, g, acc, acc_dt), iters=3,
                                    replays=2),
                 bound_ms=bound, bound_by=by, tflops=2e-9 * rows * din * dout
                 / ms, library_ms=device_ms(torch, library),
                 library_call=call)
        if route == "wgmma":
            # the WMMA kernel (the route of shapes TMA cannot map) on the
            # same inputs, checked and timed
            grad_add_close(fl.fused_linear_grad_add_kernel(
                x, g, None, acc_dt, "wmma"), fl.
                fused_linear_param_grad_add_plain(x, g, None, acc_dt),
                f"grad_add {name} (wmma)")

            def wmma():
                xc, gc, ac = nxt()
                fl.fused_linear_grad_add_kernel(xc, gc, ac, acc_dt, "wmma")

            r["wmma_ms"] = device_ms(torch, wmma)
            a = fl.fused_linear_grad_add_kernel(x, g, acc.clone(), acc_dt)
            b = fl.fused_linear_grad_add_kernel(x, g, acc.clone(), acc_dt)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"grad_add {name}: two runs differ")
            del a, b
        if dt == torch.bfloat16 and acc_dt == torch.float32:
            r["autograd_dw_ms"] = device_ms(torch, lambda: (
                lambda xc, gc, _: xc.t() @ gc)(*nxt()))
        report[name] = r
        del x, g, acc, copies, nxt
        torch.cuda.empty_cache()
    report["resources"] = _cuda_resources(
        "fused_linear_grad_add", wgmma=("grad_add_wgmma",),
        others=("grad_add_fold", "grad_add_wmma", "grad_add_fma"),
        smem=lambda fn: fl.grad_add_smem_bytes()
        if "grad_add_wgmma" in fn else None, report=report)
    return report


# ---------------------------------------------------------------------------
# phase 18: tiny main-grad training parity, card vs CPU
# ---------------------------------------------------------------------------

def _main_grad_trainer(torch, L, model, k, lr):
    """``model`` under ``MixPrecisionLayer`` and
    ``GradientMergeOptimizer(MixPrecisionOptimizer(AdamW(
    multi_precision=True)), k_steps=k)``."""
    from paddle_tpu_torch.distributed.fleet import meta_optimizers as MO
    from paddle_tpu_torch.distributed.fleet.utils import (
        mix_precision_utils as MPU)
    from paddle_tpu_torch.optimizer.adamw import AdamW
    opt = MO.GradientMergeOptimizer(MPU.MixPrecisionOptimizer(AdamW(
        parameters=model.parameters(), learning_rate=lr,
        multi_precision=True)), k_steps=k)
    return MPU.MixPrecisionLayer(model), opt


def _micro(mw, opt, ids, labels, before_update=None):
    """One micro-batch: forward, backward, fold into main_grad, then the
    gradient-merge step (an update every k-th call) and clear.
    ``before_update()`` runs after the fold, before ``step``."""
    loss = mw.compute_loss(ids, labels)
    loss.backward()
    mw.accumulate_main_grads()
    if before_update is not None:
        before_update()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def main_grad_parity_phase(torch, L, fl):
    """The imperative ``llama_tiny`` (fp32, 2 query heads sharing 1 KV
    head, S 100: no tile multiple) with the same weights on the card
    (kernels) and the CPU (plain versions), 3 updates of k = 2
    micro-batches through the main-grad wrappers: losses, every
    ``main_grad`` before each update and the weights after agree; and
    ``linear_with_main_grad``'s dx, dw, db (dW through the row-7 kernel
    on the card)."""
    cfg = L.llama_tiny(hidden_size=256, num_attention_heads=2,
                       num_key_value_heads=1, intermediate_size=512,
                       num_hidden_layers=2, dtype=torch.float32)
    ref = L.init_layers(L.LlamaForCausalLM(cfg, device="cpu"), seed=SEED)
    rng = np.random.RandomState(SEED)
    steps, k, lr = 3, 2, 1e-3
    ids = rng.randint(0, cfg.vocab_size, (steps, k, 2, 100)).astype(np.int64)
    labels = np.roll(ids, -1, axis=-1)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = L.LlamaForCausalLM(cfg, device=dev)
        model.load_state_dict(ref.state_dict())
        mw, opt = _main_grad_trainer(torch, L, model, k, lr)
        losses, grads = [], []
        for s in range(steps):
            for m in range(k):
                last = m == k - 1
                losses.append(float(_micro(
                    mw, opt, torch.from_numpy(ids[s, m]).to(dev),
                    torch.from_numpy(labels[s, m]).to(dev),
                    (lambda: grads.append({
                        # a copy: on the CPU .cpu() is the tensor itself,
                        # which the update then divides by k in place
                        n: p.main_grad.to("cpu", copy=True)
                        for n, p in model.named_parameters()}))
                    if last else None)))
        runs[dev] = (losses, grads, {n: p.detach().cpu()
                                     for n, p in model.named_parameters()})
    # tolerances: fp32 on both devices, sums in other orders (phase 11's
    # for losses and weights; main_grad under MAIN_GRAD_PARITY_TOL)
    from paddle_tpu_torch.testing import (MAIN_GRAD_PARITY_TOL, l2_close,
                                          trained_weights_close)
    (lc, gc, wc), (lp, gp, wp) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(lc, lp, rtol=1e-5, atol=1e-6)
    grad_err = 0.0
    for step, (a, b) in enumerate(zip(gc, gp)):
        for n in b:
            grad_err = max(grad_err, l2_close(
                a[n], b[n], MAIN_GRAD_PARITY_TOL,
                f"step {step} main_grad {n}")[0])
    lin = {}
    rng = np.random.RandomState(SEED + 1)
    x, w, b, cot = (rng.randn(*s) for s in ((3, 100, 256), (256, 384),
                                            (384,), (3, 100, 384)))
    before = fl.fused_linear_grad_add_kernel.launches
    for dev in ("cuda", "cpu"):
        ts = [torch.tensor(a, dtype=torch.float32, device=dev)
              .requires_grad_() for a in (x, w, b)]
        y = fl.linear_with_main_grad(*ts)
        (y * torch.tensor(cot, dtype=torch.float32, device=dev)).sum() \
            .backward()
        lin[dev] = [t.grad.cpu() for t in ts]
    if fl.fused_linear_grad_add_kernel.launches != before + 1:
        raise AssertionError("linear_with_main_grad did not launch the "
                             "row-7 kernel once on the card")
    lin_err = max(check_close(torch, f"linear_with_main_grad d{n}", a, b,
                              1e-5, 1e-4)
                  for n, a, b in zip("xwb", lin["cuda"], lin["cpu"]))
    return dict(steps=steps, k_steps=k, losses_card=lc, losses_cpu=lp,
                max_abs_main_grad_err=grad_err,
                max_abs_linear_with_main_grad_err=lin_err,
                **trained_weights_close(wc, wp, lr, steps,
                                        msg="main-grad parity"))


# ---------------------------------------------------------------------------
# phase 19: main-grad training of the imperative Llama at full width
# ---------------------------------------------------------------------------

MAIN_GRAD_KINDS = (("grad_add", ("grad_add_",)),) + TRAIN_KINDS
PROJECTIONS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
               "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
               "mlp.down_proj")


def main_grad_7b_phase(torch, L, rn, fa, fl, dw_ms):
    """The imperative ``LlamaForCausalLM`` at Llama-2-7B widths with 8
    layers (the one cut, phase 12's reason: bf16 weights with fp32
    main grads, master weights and moments), trained with fp32 main
    grads: k = 4 micro-batches of (2, 2048) a step through
    ``MixPrecisionLayer`` and ``GradientMergeOptimizer(
    MixPrecisionOptimizer(AdamW), k_steps=4)``; 2 warm-up and 3 timed
    steps, each step's launch counts checked, the loss falling, and a
    profiler breakdown of one step. Then one more step in which forward
    pre-hooks and full backward hooks on every projection hand the
    model's own operands to ``fused_linear_param_grad_add`` into fp32
    accumulators (7·L·k launches): after the k micro-batches each must
    match that projection's ``main_grad``, and a sampled projection the
    plain version; that step is profiled too, for the kernel's device
    time on these operands. ``dw_ms`` is phase 17's report (the per-call times of
    the kernel and of autograd's bf16 dW product at these shapes)."""
    from paddle_tpu_torch.testing import grad_add_close, main_grad_close
    cfg = L.llama2_7b(num_hidden_layers=8, dtype=torch.bfloat16)
    n_layers, k, b, s, lr = cfg.num_hidden_layers, 4, 2, 2048, 1e-4
    t0 = time.perf_counter()
    model = L.init_layers(L.LlamaForCausalLM(cfg, device="cuda"), seed=SEED)
    mw, opt = _main_grad_trainer(torch, L, model, k, lr)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED)
    ids_np = rng.randint(0, cfg.vocab_size, (k, b, s)).astype(np.int64)
    ids = torch.from_numpy(ids_np).cuda()
    labels = torch.from_numpy(np.roll(ids_np, -1, axis=-1)).cuda()
    counters = {"rms_norm_fwd": rn.rms_norm,
                "rms_norm_bwd": rn.rms_norm_bwd,
                "flash_attention_fwd": fa.flash_fwd_kernel,
                "flash_attention_bwd_dq": fa.flash_bwd_dq_kernel,
                "flash_attention_bwd_dkv": fa.flash_bwd_dkv_kernel,
                "fused_linear_grad_add": fl.fused_linear_grad_add_kernel}
    # per step, k micro-batches each: RMSNorm forward 2L+1 and backward
    # 2L+1 (no remat), flash forward, dQ and dK/dV once a layer; the
    # model's own dW goes through autograd, never the row-7 kernel
    want = {"rms_norm_fwd": k * (2 * n_layers + 1),
            "rms_norm_bwd": k * (2 * n_layers + 1),
            "flash_attention_fwd": k * n_layers,
            "flash_attention_bwd_dq": k * n_layers,
            "flash_attention_bwd_dkv": k * n_layers,
            "fused_linear_grad_add": 0}
    totals = {n: 0 for n in counters}

    def step():
        loss = torch.zeros((), device="cuda")
        for m in range(k):
            loss += _micro(mw, opt, ids[m], labels[m])
        return loss / k

    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for i in range(5):                       # 2 warm-up + 3 timed steps
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step()))         # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        got = {n: c.launches for n, c in counters.items()}
        if got != want:
            raise AssertionError(f"step {i}: launch counts {got} != {want}")
        for n in totals:
            totals[n] += got[n]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall over 5 steps: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mean_ms = float(np.mean(step_ms[2:]))
    tokens = k * b * s

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kinds, top = _kernel_ms_by_kind(prof, MAIN_GRAD_KINDS, n_top=14)
    busy = sum(kinds.values())

    # the step with the row-7 kernel on the model's own operands
    layers = {f"llama.layers.{l}.{p}": model.llama.layers[l]
              .get_submodule(p) for l in range(n_layers) for p in PROJECTIONS}
    n_proj = len(layers)
    accs = {n: torch.zeros_like(mod.weight, dtype=torch.float32)
            for n, mod in layers.items()}
    inputs, sample, handles = {}, {}, []
    sample_name = "llama.layers.0.self_attn.o_proj"   # a strided input

    def pre_hook(name):
        def hook(module, args):
            inputs[name] = args[0].detach()
        return hook

    def bwd_hook(name):
        def hook(module, grad_input, grad_output):
            x, dout = inputs.pop(name), grad_output[0]
            with torch.no_grad():
                fl.fused_linear_param_grad_add(x, dout, accs[name],
                                               has_bias=False)
            if name == sample_name:
                sample["x"], sample["dout"] = x, dout.detach()
        return hook

    for name, mod in layers.items():
        handles.append(mod.register_forward_pre_hook(pre_hook(name)))
        handles.append(mod.register_full_backward_hook(bwd_hook(name)))
    checked = {}

    def check_accumulators():
        # after the k-th fold, before the update divides main_grad by k
        err, l2 = 0.0, 0.0
        for n, mod in layers.items():
            e, r = main_grad_close(accs[n], mod.weight.main_grad,
                                   f"accumulator {n} vs main_grad")
            err, l2 = max(err, e), max(l2, r)
        checked.update(max_abs_err=err, max_rel_l2=l2)

    _reset({"grad_add": fl.fused_linear_grad_add_kernel})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for m in range(k):
            _micro(mw, opt, ids[m], labels[m],
                   check_accumulators if m == k - 1 else None)
        torch.cuda.synchronize()
    launches = fl.fused_linear_grad_add_kernel.launches
    by_route = dict(fl.fused_linear_grad_add_kernel.route_launches)
    hooked_kinds, _ = _kernel_ms_by_kind(prof, MAIN_GRAD_KINDS)
    for h in handles:
        h.remove()
    # every projection's shape takes the wgmma route
    if (launches != n_proj * k or by_route["wgmma"] != launches
            or not checked):
        raise AssertionError(f"row-7 launches {launches} ({by_route}) != "
                             f"7·L·k = {n_proj * k} on the wgmma route, "
                             "or accumulators unchecked")
    x2 = sample["x"].reshape(-1, sample["x"].shape[-1]).contiguous()
    g2 = sample["dout"].reshape(-1, sample["dout"].shape[-1]).contiguous()
    sample_err = grad_add_close(
        fl.fused_linear_grad_add_kernel(x2, g2, None, torch.float32),
        fl.fused_linear_param_grad_add_plain(x2, g2, None, torch.float32),
        f"grad_add on {sample_name}'s operands")
    # per step at these shapes: 4 (h, h) projections, gate and up (h, ffn),
    # down (ffn, h), in each of L layers and k micro-batches
    n_params = sum(p.numel() for p in model.parameters())
    # bench.py's accounting: 6 FLOPs per matmul parameter and token (the
    # embedding gather excluded) + causal attention 6·L·S·h
    flops_per_token = 6.0 * (n_params - cfg.vocab_size * cfg.hidden_size) \
        + 6.0 * n_layers * s * cfg.hidden_size
    tok_s = tokens / (mean_ms / 1e3)
    per_step = {key: k * n_layers * (4 * dw_ms["qkvo_bf16"][key]
                                     + 2 * dw_ms["gate_up_bf16"][key]
                                     + dw_ms["down_bf16"][key])
                for key in ("ms", "autograd_dw_ms", "bound_ms")}
    del model, mw, opt, accs, inputs, sample, layers
    return dict(
        layers=n_layers, reduced="num_hidden_layers 32 -> 8 (memory)",
        params=n_params, init_s=init_s, k_steps=k, micro_batch=[b, s],
        lr=lr, remat="none", losses=losses, step_ms=step_ms,
        mean_step_ms=mean_ms, tokens_per_step=tokens, tokens_per_s=tok_s,
        flops_per_token=flops_per_token,
        mfu_vs_989tflops=flops_per_token * tok_s / PEAK_OPS_PER_S["bf16"],
        peak_mem_gb=peak_gb, launches_per_step=want, launches=totals,
        breakdown=dict(kernel_ms=kinds, top_kernels=top, device_busy_ms=busy,
                       wall_ms=mean_ms, idle_share=1 - busy / mean_ms),
        grad_add=dict(launches=launches, want=n_proj * k,
                      route_launches=by_route,
                      kernel_ms_in_step=hooked_kinds["grad_add"],
                      step_kernel_ms=hooked_kinds,
                      accumulators_vs_main_grad=checked,
                      sample=sample_name, sample_max_abs_err=sample_err,
                      kernel_ms_per_step_from_phase17=per_step["ms"],
                      autograd_dw_ms_per_step_from_phase17=per_step[
                          "autograd_dw_ms"],
                      bound_ms_per_step=per_step["bound_ms"]))


def _kernel_entry(name, route, source, replaces, launches, r):
    """One entry of the kernels line: ``launches`` from the main paths,
    the rest from the kernel's own phase."""
    return dict(name=name, route=route, source=source, replaces=replaces,
                launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 2
    # fp32 comparisons on the card are full fp32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from paddle_tpu_torch.inference import constrain as C
    from paddle_tpu_torch.inference import decoding as D
    from paddle_tpu_torch.models import ernie as E
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.ops import _common
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_linear as fl
    from paddle_tpu_torch.ops import layer_norm_fused as ln
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import rms_norm as rn

    card = card_line()
    print(f"[1/{N_PHASES}] card: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)

    # phase 2: nvcc in the background (one process per source, started
    # together) while Triton compiles its kernels
    t0 = time.perf_counter()
    errors = []
    sources = ["ragged_paged_attention", "paged_decode_attention",
               "flash_attention", "fused_linear_grad_add"]

    def build():
        try:
            _common.build_cuda_sources(sources)
        except BaseException as e:       # re-raised below, on this thread
            errors.append(e)

    th = threading.Thread(target=build)
    th.start()
    x = torch.ones(4, 4096, device="cuda", dtype=torch.bfloat16)
    rn.rms_norm_kernel(x, x[0], 1e-5)
    rn.rms_norm_bwd_kernel(x, x[0], x, 1e-5)
    ln.layer_norm_kernel(x, x[0], x[1], 1e-12)
    ln.layer_norm_bwd_kernel(x, x[0], x, 1e-12)
    torch.cuda.synchronize()
    th.join()
    if errors:
        raise errors[0]
    for name in sources:
        for line in _common.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())
    print(f"[2/{N_PHASES}] built every kernel in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def done(n, what, report):
        print(f"[{n}/{N_PHASES}] {what}:", json.dumps(report), flush=True)

    rms = rms_norm_phase(torch, rn)
    done(3, "rms_norm kernel vs plain", rms)
    attn = attention_phase(torch, pa)
    done(3, "ragged attention kernel vs plain", attn)
    decode = paged_decode_phase(torch, pa)
    done(4, "paged decode kernel vs plain", decode)

    done(5, "tiny engine, card == cpu tokens", parity_phase(torch, L, D))
    done(6, "tiny legacy engine, cache off/on, and PagedGenerationEngine, "
         "card == cpu tokens", legacy_parity_phase(torch, L, D))

    cfg7b, params7b, init_s = init_7b(torch, L)
    serve = dict(serve_7b_phase(torch, L, D, rn, pa, cfg7b, params7b),
                 init_s=init_s)
    greedy_tokens = serve.pop("_tokens")
    engine7 = serve.pop("_engine")
    done(7, f"Llama-2-7B bf16 serve on {card}", serve)
    sched = scheduled_7b_phase(torch, L, D, rn, pa, cfg7b, params7b,
                               engine7, serve, greedy_tokens)
    del engine7
    _free_card(torch)
    done(23, f"Llama-2-7B bf16 scheduled serve (ServingScheduler) on "
         f"{card}", sched)
    legacy = legacy_7b_phase(torch, L, D, rn, pa, fa, cfg7b, params7b, serve)
    done(8, f"Llama-2-7B bf16 legacy serve and prefix-cache wave on {card}",
         legacy)
    done(20, "tiny sampled / constrained / speculative / do_sample engines, "
         "card == cpu tokens", sampling_parity_phase(torch, L, D))
    options = sampling_7b_phase(torch, L, D, C, rn, pa, cfg7b, params7b,
                                serve, greedy_tokens)
    done(21, f"Llama-2-7B bf16 sampled, constrained and speculative serves "
         f"on {card}", options)
    gens = generate_7b_phase(torch, L, D, rn, pa, fa, cfg7b, params7b)
    done(22, f"Llama-2-7B bf16 generate engines on {card}", gens)
    del params7b             # the training phases need the memory
    gc.collect()
    torch.cuda.empty_cache()

    rms_bwd = rms_norm_bwd_phase(torch, rn)
    done(9, "rms_norm backward kernel vs plain", rms_bwd)
    flash = flash_phase(torch, fa)
    done(10, "flash attention kernels vs plain", flash)
    done(11, "tiny training, card == cpu", train_parity_phase(torch, L))
    train = train_7b_phase(torch, L, rn, fa)
    done(12, f"Llama-2-7B widths, 8 layers, bf16 training on {card}", train)
    gc.collect()
    torch.cuda.empty_cache()

    lnr = layer_norm_phase(torch, ln)
    done(13, "layer_norm kernels vs plain", lnr)
    seg_flash = seg_flash_phase(torch, E, fa)
    done(14, "segment-masked flash kernels vs plain", seg_flash)
    done(15, "tiny ERNIE training, card == cpu", ernie_parity_phase(torch, E))
    bert = bert_large_phase(torch, E, ln, fa)
    done(16, f"packed BERT-large MLM bf16 training on {card}", bert)
    gc.collect()
    torch.cuda.empty_cache()

    grad_add = grad_add_phase(torch, fl)
    done(17, "weight-gradient accumulation kernel vs plain", grad_add)
    done(18, "tiny main-grad training, card == cpu",
         main_grad_parity_phase(torch, L, fl))
    main_grad = main_grad_7b_phase(torch, L, rn, fa, fl, grad_add)
    done(19, f"Llama-2-7B widths, 8 layers, main-grad training on {card}",
         main_grad)
    mg = main_grad["launches"]

    rb, ab = rms["bf16"], attn["nkv32_bf16"]
    leg, warm = legacy["legacy"]["launches"], legacy["prefix_cache"]["warm"]
    cold = legacy["prefix_cache"]["cold"]
    mixed = options["mixed"]["launches"]
    glaunch = (gens["generate"]["launches"]["rms_norm_fwd"]
               + gens["generate"]["eager"]["rms_norm_launches"])
    plaunch = {k: gens["paged"]["launches"][k]
               + gens["paged"]["eager"]["launches"][k]
               for k in gens["paged"]["launches"]}
    specl = {k: sum(r["launches"][k] for r in options["speculative"].values())
             for k in ("rms_norm_fwd", "ragged_paged_attention")}
    kernels = [
        # the forward runs on every main path: the unified serve's
        # launches, the legacy serve's, the cache waves', the mixed
        # sampled serve's, the speculative serve's and the training runs'
        dict(name="rms_norm_fwd", route="triton",
             source="paddle_tpu_torch/ops/rms_norm.py",
             replaces="paddle_tpu/ops/rms_norm.py:48",
             launches=serve["launches"]["rms_norm_fwd"]
             + sched["launches"]["rms_norm_fwd"]
             + leg["rms_norm_fwd"] + warm["launches"]["rms_norm_fwd"]
             + cold["launches"]["rms_norm_fwd"] + mixed["rms_norm_fwd"]
             + specl["rms_norm_fwd"] + glaunch + plaunch["rms_norm_fwd"]
             + train["launches"]["rms_norm_fwd"] + mg["rms_norm_fwd"],
             max_abs_err=rb["max_abs_err"], ms=rb["ms"],
             plain_ms=rb["plain_ms"], bound_ms=rb["bound_ms"],
             bound_by=rb["bound_by"], library_ms=rb["library_ms"]),
        dict(name="ragged_paged_attention", route="cuda",
             source="paddle_tpu_torch/csrc/ragged_paged_attention.cu",
             replaces="paddle_tpu/ops/paged_attention.py:215",
             launches=serve["launches"]["ragged_paged_attention"]
             + sched["launches"]["ragged_paged_attention"]
             + warm["launches"]["ragged_paged_attention"]
             + cold["launches"]["ragged_paged_attention"]
             + mixed["ragged_paged_attention"]
             + specl["ragged_paged_attention"],
             max_abs_err=ab["max_abs_err"], ms=ab["ms"],
             plain_ms=ab["plain_ms"], bound_ms=ab["bound_ms"],
             bound_by=ab["bound_by"], library_ms=ab["library_ms"]),
        # numbers at the 7B MHA decode batch; the error the largest over
        # every case of phase 4
        _kernel_entry("paged_decode_attention", "cuda",
                      "paddle_tpu_torch/csrc/paged_decode_attention.cu",
                      "paddle_tpu/ops/paged_attention.py:650",
                      leg["paged_decode_attention"]
                      + plaunch["paged_decode_attention"],
                      dict(decode["nkv32_d128_bf16"], max_abs_err=max(
                          r["max_abs_err"] for k, r in decode.items()
                          if k != "resources"))),
        _kernel_entry("rms_norm_bwd", "triton",
                      "paddle_tpu_torch/ops/rms_norm.py",
                      "paddle_tpu/ops/rms_norm.py:55",
                      train["launches"]["rms_norm_bwd"] + mg["rms_norm_bwd"],
                      rms_bwd["bf16"]),
    ]
    # the flash kernels run on every training path (the Llama step's
    # launches, the BERT step's and main-grad training's) and the forward
    # on the legacy serve's prefill waves too; their numbers are the Llama step shape's, the
    # error the largest over it and the segmented checks
    step, seg_step = flash["step_shape"], seg_flash["step_shape"]
    for name, key, line in (("flash_attention_fwd", "fwd", 41),
                            ("flash_attention_bwd_dq", "dq", 172),
                            ("flash_attention_bwd_dkv", "dkv", 224)):
        r = dict(step[key], max_abs_err=max(step[key]["max_abs_err"],
                                            seg_step[key]["max_abs_err"]))
        kernels.append(_kernel_entry(
            name, "cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
            f"paddle_tpu/ops/flash_attention.py:{line}",
            train["launches"][name] + bert["launches"][name]
            + mg[name] + leg.get(name, 0) + plaunch.get(name, 0), r))
    for name, key, line in (("layer_norm_fwd", "fwd", 45),
                            ("layer_norm_bwd", "bwd", 54)):
        kernels.append(_kernel_entry(
            name, "triton", "paddle_tpu_torch/ops/layer_norm_fused.py",
            f"paddle_tpu/ops/layer_norm_fused.py:{line}",
            bert["launches"][name], lnr[key]["bf16"]))
    # row 7: launched on main-grad training's own operands (phase 19);
    # its numbers at the q/k/v/o shape, bf16 into fp32
    kernels.append(_kernel_entry(
        "fused_linear_grad_add", "cuda",
        "paddle_tpu_torch/csrc/fused_linear_grad_add.cu",
        "paddle_tpu/ops/fused_linear.py:37",
        main_grad["grad_add"]["launches"], grad_add["qkvo_bf16"]))
    for k in kernels:
        if not all(math.isfinite(k[f]) for f in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"non-finite measurement in {k}")
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never ran on its main path")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
