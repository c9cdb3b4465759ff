#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (the
kernels are built for sm_90a with nvcc and Triton at first use, into
``build/paddle_tpu_torch/``). Phases, each of which raises on failure:

1. card check: CUDA must be available; prints the card's name and
   power limit (nvidia-smi);
2. build: compiles the CUDA kernels (ragged paged attention, flash
   attention; one nvcc per source, started together) and the Triton
   RMSNorm and LayerNorm kernels from the sources in the checkout,
   printing nvcc's register/spill report;
3. each kernel against its plain PyTorch version on the card, at the
   shapes of the Llama-2-7B serving step below (the RMSNorm forward at
   the training step's (8, 2048, 4096) too), in bf16 and fp32, with
   the kernel's time, the plain version's time, the least time the card
   could take (bound) and a one-call library yardstick where one exists;
4. tiny end-to-end parity: the serving engine on the card (kernels)
   against the same engine on the CPU (plain versions), fp32, TF32 off —
   greedy tokens must be identical;
5. the slice at full width: Llama-2-7B (32 layers, bf16, seeded random
   weights) served by ``ContinuousBatchingEngine`` — 12 requests of
   32-512 prompt tokens through 8 slots, 32 new tokens each — with
   the kernels' launch counters checked against the micro-rounds run;
6. the RMSNorm backward kernel against its plain version at the train
   step's (rows, h) = (16384, 4096), bf16 and fp32, with its time, bound
   and the backward of ``F.rms_norm`` as the yardstick;
7. the flash-attention forward, dQ and dK/dV kernels against their plain
   versions: causal at BH 32, S 2048, d 128 in bf16 and fp32, a GQA case
   (8 KV heads), a padded-key case (``kv_valid`` 2000) and an unpadded
   S 2000; then at the train step's shape (BH 256, S 2048, bf16) with
   times, bounds and ``F.scaled_dot_product_attention`` forward and
   backward as the yardsticks. Each of out, dq, dk and dv is held to a
   tolerance scaled by its own rms (``paddle_tpu_torch.testing``'s
   ``FLASH_TOL``, which tests/test_torch_gpu.py applies too);
8. tiny training parity: ``build_train_step`` with full remat for 5
   AdamW steps on the card (kernels) and on the CPU (plain versions),
   fp32, TF32 off, from the same weights — losses and weights agree;
9. the training slice at full width: Llama-2-7B widths with 8 layers
   (the one cut: 32 layers of bf16 weights, gradients and fp32 AdamW
   moments do not fit one 80 GB card), vocab 32000, one (1, 8, 2048)
   batch, 2 warm-up and 5 timed steps, every step's launch counts
   checked, the loss falling, and a profiler breakdown of one step;
10. the LayerNorm forward and backward kernels against their plain
    versions at the BERT-large step's (rows, h) = (8192, 1024), eps
    1e-12, bf16 and fp32, with ``F.layer_norm`` forward and backward as
    the yardsticks;
11. the flash forward, dQ and dK/dV kernels with segment ids against
    their plain versions at the BERT-large step's shape (BH 16·16, S
    512, d 64, non-causal) and the packed batch's segment ids, bf16 and
    fp32, with SDPA under the boolean segment mask as the yardstick;
12. tiny ERNIE training parity: ``build_mlm_train_step`` for 5 packed
    MLM steps on the card (kernels) and on the CPU (plain versions),
    fp32, TF32 off, d 64 heads — losses and weights agree;
13. packed BERT-large MLM pretraining at full width (24 layers, h 1024,
    16 heads, vocab 30522; nothing cut): ``bench_bert_packed``'s
    (16, 512) batch packed from seed 0, bf16 weights with fp32 master
    weights and AdamW moments, 2 warm-up and 5 timed steps, every step's
    launch counts checked, the loss falling, real tokens/s, MFU by
    ``bench_bert_packed``'s accounting and a profiler breakdown.

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


def mixed_batch(torch, nkv, dtype, nh=32, d=128, page=16, width=64,
                n_tokens=256):
    """A ragged batch at the 7B step's shapes: five decode rows at
    different lengths, a cold prefill chunk, a warm prefill chunk
    (first position > 0), an idle row and pad slots."""
    rng = np.random.RandomState(SEED)
    decode_lens = [1000, 733, 517, 301, 95]
    rows = [(kv - 1, 1) for kv in decode_lens]    # (first position, n)
    rows += [(0, 180), (400, 60)]                 # cold, warm prefill
    n_rows = len(rows) + 1                        # + one idle row
    n_pages = n_rows * width + 1
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((n_rows, width), np.int32)
    kv_lens = np.zeros((n_rows,), np.int32)
    token_row = np.full((n_tokens,), -1, np.int32)
    positions = np.zeros((n_tokens,), np.int32)
    cursor, used = 0, 0
    for r, (p0, n) in enumerate(rows):
        kv_lens[r] = p0 + n
        npg = -(-int(kv_lens[r]) // page)
        bt[r, :npg] = perm[used:used + npg]
        used += npg
        token_row[cursor:cursor + n] = r
        positions[cursor:cursor + n] = p0 + np.arange(n)
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
    keys = sum(p0 + n for p0, n in rows)
    isz = k.element_size()
    nbytes = (2 * q.numel() * isz + 2 * keys * nkv * d * isz
              + sum(a.numel() * 4 for a in meta))
    ops = 4 * int((positions[real] + 1).sum()) * nh * d
    return (q, k, v, *meta), real, nbytes, ops


def attention_phase(torch, pa):
    report = {}
    # tolerances: fp32 differs in summation order and the online (kernel)
    # vs two-pass (plain) softmax; in bf16 the plain version rounds the
    # probabilities to bf16 before P·V (as the JAX array path does) while
    # the kernel keeps them in fp32 (as the Pallas kernel does)
    for nkv in (32, 8):
        for dt, kind, rtol, atol in ((torch.bfloat16, "bf16", 2e-2, 2e-2),
                                     (torch.float32, "fp32", 1e-4, 1e-5)):
            args, real, nbytes, ops = mixed_batch(torch, nkv, dt)
            got = pa.ragged_paged_attention_kernel(*args)
            torch.cuda.synchronize()
            want = pa.ragged_paged_attention_plain(*args)
            err = check_close(torch, f"attention nkv={nkv} {kind}", got,
                              want, rtol, atol)
            pads = torch.from_numpy(~real).cuda()
            if not bool((got[pads] == 0).all()):
                raise AssertionError("pad slots must come out exactly 0")
            bms, by = bound_ms(nbytes, ops, kind)
            report[f"nkv{nkv}_{kind}"] = dict(
                nh=32, nkv=nkv, d=128, page=16, tokens=int(real.sum()),
                max_abs_err=err, rtol=rtol, atol=atol,
                ms=device_ms(torch, lambda: pa.ragged_paged_attention_kernel(
                    *args)),
                eager_ms=eager_ms(torch, lambda: pa.
                                  ragged_paged_attention_kernel(*args)),
                plain_ms=device_ms(torch, lambda: pa.
                                   ragged_paged_attention_plain(*args),
                                   iters=2, replays=2),
                bound_ms=bms, bound_by=by, library_ms=None)
            del args, got, want
            torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 4: tiny end-to-end parity, card vs CPU
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


# ---------------------------------------------------------------------------
# phase 5: Llama-2-7B at full width through the serving engine
# ---------------------------------------------------------------------------

def serve_7b_phase(torch, L, D, rn, pa):
    cfg = L.llama2_7b(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = L.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    new_tokens = 32
    eng = D.ContinuousBatchingEngine(
        cfg, D.GenerationConfig(max_new_tokens=new_tokens), num_slots=8,
        page_size=16, max_seq_len=1024, chunk=8, step_tokens=256,
        device="cuda")
    rng = np.random.RandomState(SEED)
    lens = rng.randint(32, 513, size=12)
    prompts = [rng.randint(1, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in lens]
    rids = [eng.submit(p) for p in prompts]
    rn.rms_norm.launches = 0
    pa.ragged_paged_attention.launches = 0
    eng.micro_rounds = 0
    torch.cuda.reset_peak_memory_stats()
    results, step_ms = {}, []
    t_serve = time.perf_counter()
    while len(results) < len(rids):
        t0 = time.perf_counter()
        eng.step(params)          # ends in the step's one device->host copy
        step_ms.append((time.perf_counter() - t0) * 1e3)
        eng.mgr.check_conservation()
        results.update(eng.collect())
        if len(step_ms) > 200:
            raise AssertionError("serve did not finish in 200 steps")
    serve_s = time.perf_counter() - t_serve
    launches = {"rms_norm_fwd": rn.rms_norm.launches,
                "ragged_paged_attention":
                    pa.ragged_paged_attention.launches}
    n_layers, rounds = cfg.num_hidden_layers, eng.micro_rounds
    want = {"rms_norm_fwd": (2 * n_layers + 1) * rounds,
            "ragged_paged_attention": n_layers * rounds}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    for rid in rids:
        toks = results[rid]
        if len(toks) != new_tokens or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {rid}: bad output {toks}")
    if eng.mgr.num_free_pages != eng.mgr.usable_pages:
        raise AssertionError("pages leaked after the serve")
    breakdown = step_breakdown(torch, eng, params, cfg.vocab_size)
    del eng, params          # the training phases need the memory
    generated = new_tokens * len(rids)
    return dict(
        breakdown=breakdown,
        layers=n_layers, params=L.param_count(cfg), init_s=init_s,
        requests=len(rids), prompt_tokens=int(lens.sum()),
        generated_tokens=generated, steps=len(step_ms),
        micro_rounds=rounds, serve_s=serve_s,
        generated_tokens_per_s=generated / serve_s,
        processed_tokens_per_s=(generated + int(lens.sum())) / serve_s,
        mean_step_ms=float(np.mean(step_ms)),
        first_step_ms=step_ms[0],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches)


MATMUL_NAMES = ("gemm", "gemv", "xmma", "cutlass", "nvjet")
SERVE_KINDS = (("ragged_paged_attention", ("ragged_paged_attention",)),
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


def step_breakdown(torch, eng, params, vocab):
    """Where a prefill step and a decode step of the engine spend their
    time. Eight requests of 256 prompt tokens fill the first step with
    prefill (8 micro-rounds of 256 tokens); the second step decodes the
    8 rows. Wall times come from an unprofiled pass, kernel device
    times from a torch.profiler pass over the same two steps."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(1, vocab, (256,)).astype(np.int32)
               for _ in range(eng.num_slots)]
    out = {}
    for profiled in (False, True):
        rids = [eng.submit(p) for p in prompts]
        for phase in ("prefill_step", "decode_step"):
            torch.cuda.synchronize()
            if profiled:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    eng.step(params)
                    torch.cuda.synchronize()
                kinds, top = _kernel_ms_by_kind(prof)
                busy = sum(kinds.values())
                wall = out[phase]["wall_ms"]
                out[phase].update(
                    kernel_ms=kinds, top_kernels=top,
                    device_busy_ms=busy,
                    idle_share=(1 - busy / wall) if busy else None)
            else:
                t0 = time.perf_counter()
                eng.step(params)      # ends in its device->host copy
                out[phase] = dict(wall_ms=(time.perf_counter() - t0) * 1e3)
        for rid in rids:
            eng.cancel(rid)
        eng.mgr.check_conservation()
    return out


# ---------------------------------------------------------------------------
# phase 6: the RMSNorm backward kernel against its plain version
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
# phase 7: the flash-attention kernels against their plain versions
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
        rel_l2=step_check["rel_l2"]), fp32_bh32=fp32)


# ---------------------------------------------------------------------------
# phase 8: tiny training parity, card vs CPU
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
# phase 9: the training slice at full width
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
# the packed BERT-large batch (phases 11 and 13)
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
# phase 10: the LayerNorm kernels against their plain versions
# ---------------------------------------------------------------------------

def _l2_cold(tensors, min_bytes=200e6):
    """Copies of ``tensors`` (a tuple), enough that one pass over all of
    them moves ``min_bytes``. A timed function that takes the next copy
    at every call reads its inputs from device memory and not from the
    50 MB L2 cache, as the training step's LayerNorms do."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(2, math.ceil(min_bytes / nbytes))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def layer_norm_phase(torch, ln):
    """layer_norm and its backward at the BERT-large step's (rows, h) =
    (16·512, 1024), eps 1e-12, with F.layer_norm's forward and backward
    as the yardsticks. Every timed call reads fresh copies of x (and g),
    so the 16.8 MB (bf16) rows do not sit in L2 between calls. Each
    output is held to ``paddle_tpu_torch.testing.LN_TOL``."""
    from paddle_tpu_torch.testing import LN_TOL, rms_close
    rows, h, eps = BERT_B * BERT_S, 1024, 1e-12
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
        bwd_err = max(
            rms_close(dx, pdx, *tol["dx"], f"layer_norm_bwd dx {kind}"),
            rms_close(dw, pdw, *tol["sums"], f"layer_norm_bwd dw {kind}"),
            rms_close(db, pdb, *tol["sums"], f"layer_norm_bwd db {kind}"))
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

        def kernel_bwd():
            xc, gx = nxt()
            return ln.layer_norm_bwd_kernel(xc, w, gx, eps)

        # the library's backward, one recorded forward per copy
        wl, bl = (t.detach().requires_grad_(True) for t in (w, b))
        graphs = []
        for xc, gx in copies:
            xl = xc.detach().requires_grad_(True)
            graphs.append((torch.nn.functional.layer_norm(
                xl, (h,), wl, bl, eps), (xl, wl, bl), gx))
        lib = itertools.cycle(graphs).__next__
        bwd[kind] = dict(
            shape=[rows, h], eps=eps, max_abs_err=bwd_err, tol=tol,
            ms=device_ms(torch, kernel_bwd),
            plain_ms=device_ms(torch, lambda: ln.ln_bwd_plain(x, w, g, eps),
                               iters=5, replays=2),
            bound_ms=bb, bound_by=bby,
            library_ms=profiled_ms(torch, lambda: torch.autograd.grad(
                *lib(), retain_graph=True), iters=len(graphs)))
        del x, g, w, b, y, dx, dw, db, pdx, pdw, pdb, copies, nxt, graphs
        del lib, wl, bl
        torch.cuda.empty_cache()
    return dict(fwd=fwd, bwd=bwd)


# ---------------------------------------------------------------------------
# phase 11: the segment-masked flash kernels against their plain versions
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
               pairs_share_of_square=pairs / (bh * s * s))
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
                tol_rtol_atol_over_rms_l2=_flash_tol(torch))


# ---------------------------------------------------------------------------
# phase 12: tiny ERNIE training parity, card vs CPU
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
    # tolerances as phase 8's, the key bias (qkv_bias[h:2h], rounding
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
# phase 13: packed BERT-large MLM pretraining at full width
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

    from paddle_tpu_torch.inference import decoding as D
    from paddle_tpu_torch.models import ernie as E
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.ops import _common
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import layer_norm_fused as ln
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import rms_norm as rn

    card = card_line()
    print(f"[1/13] card: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)

    # phase 2: nvcc in the background (one process per source, started
    # together) while Triton compiles its kernels
    t0 = time.perf_counter()
    errors = []
    sources = ["ragged_paged_attention", "flash_attention"]

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
    print(f"[2/13] built every kernel in {time.perf_counter() - t0:.1f} s",
          flush=True)

    rms = rms_norm_phase(torch, rn)
    print("[3/13] rms_norm kernel vs plain:", json.dumps(rms), flush=True)
    attn = attention_phase(torch, pa)
    print("[3/13] ragged attention kernel vs plain:", json.dumps(attn),
          flush=True)

    parity = parity_phase(torch, L, D)
    print("[4/13] tiny engine, card == cpu tokens:", json.dumps(parity),
          flush=True)

    serve = serve_7b_phase(torch, L, D, rn, pa)
    print(f"[5/13] Llama-2-7B bf16 serve on {card}:", json.dumps(serve),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    rms_bwd = rms_norm_bwd_phase(torch, rn)
    print("[6/13] rms_norm backward kernel vs plain:", json.dumps(rms_bwd),
          flush=True)
    flash = flash_phase(torch, fa)
    print("[7/13] flash attention kernels vs plain:", json.dumps(flash),
          flush=True)
    tparity = train_parity_phase(torch, L)
    print("[8/13] tiny training, card == cpu:", json.dumps(tparity),
          flush=True)
    train = train_7b_phase(torch, L, rn, fa)
    print(f"[9/13] Llama-2-7B widths, 8 layers, bf16 training on {card}:",
          json.dumps(train), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    lnr = layer_norm_phase(torch, ln)
    print("[10/13] layer_norm kernels vs plain:", json.dumps(lnr), flush=True)
    seg_flash = seg_flash_phase(torch, E, fa)
    print("[11/13] segment-masked flash kernels vs plain:",
          json.dumps(seg_flash), flush=True)
    eparity = ernie_parity_phase(torch, E)
    print("[12/13] tiny ERNIE training, card == cpu:", json.dumps(eparity),
          flush=True)
    bert = bert_large_phase(torch, E, ln, fa)
    print(f"[13/13] packed BERT-large MLM bf16 training on {card}:",
          json.dumps(bert), flush=True)

    rb, ab = rms["bf16"], attn["nkv32_bf16"]
    kernels = [
        # the forward runs on both main paths: the serve's launches plus
        # the training run's
        dict(name="rms_norm_fwd", route="triton",
             source="paddle_tpu_torch/ops/rms_norm.py",
             replaces="paddle_tpu/ops/rms_norm.py:48",
             launches=serve["launches"]["rms_norm_fwd"]
             + train["launches"]["rms_norm_fwd"],
             max_abs_err=rb["max_abs_err"], ms=rb["ms"],
             plain_ms=rb["plain_ms"], bound_ms=rb["bound_ms"],
             bound_by=rb["bound_by"], library_ms=rb["library_ms"]),
        dict(name="ragged_paged_attention", route="cuda",
             source="paddle_tpu_torch/csrc/ragged_paged_attention.cu",
             replaces="paddle_tpu/ops/paged_attention.py:215",
             launches=serve["launches"]["ragged_paged_attention"],
             max_abs_err=ab["max_abs_err"], ms=ab["ms"],
             plain_ms=ab["plain_ms"], bound_ms=ab["bound_ms"],
             bound_by=ab["bound_by"], library_ms=ab["library_ms"]),
        _kernel_entry("rms_norm_bwd", "triton",
                      "paddle_tpu_torch/ops/rms_norm.py",
                      "paddle_tpu/ops/rms_norm.py:55",
                      train["launches"]["rms_norm_bwd"], rms_bwd["bf16"]),
    ]
    # the flash kernels run on both training paths: the Llama step's
    # launches plus the BERT step's; their numbers are the Llama step
    # shape's, the error the largest over it and the segmented checks
    step, seg_step = flash["step_shape"], seg_flash["step_shape"]
    for name, key, line in (("flash_attention_fwd", "fwd", 41),
                            ("flash_attention_bwd_dq", "dq", 172),
                            ("flash_attention_bwd_dkv", "dkv", 224)):
        r = dict(step[key], max_abs_err=max(step[key]["max_abs_err"],
                                            seg_step[key]["max_abs_err"]))
        kernels.append(_kernel_entry(
            name, "cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
            f"paddle_tpu/ops/flash_attention.py:{line}",
            train["launches"][name] + bert["launches"][name], r))
    for name, key, line in (("layer_norm_fwd", "fwd", 45),
                            ("layer_norm_bwd", "bwd", 54)):
        kernels.append(_kernel_entry(
            name, "triton", "paddle_tpu_torch/ops/layer_norm_fused.py",
            f"paddle_tpu/ops/layer_norm_fused.py:{line}",
            bert["launches"][name], lnr[key]["bf16"]))
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
