#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (the
kernels are built for sm_90a with nvcc and Triton at first use, into
``build/paddle_tpu_torch/``). Phases, each of which raises on failure:

1. card check: CUDA must be available; prints the card's name and
   power limit (nvidia-smi);
2. build: compiles the CUDA ragged paged-attention kernel and the
   Triton RMSNorm kernel from the sources in the checkout, printing
   nvcc's register/spill report;
3. each kernel against its plain PyTorch version on the card, at the
   shapes of the Llama-2-7B serving step below, in bf16 and fp32, with
   the kernel's time, the plain version's time, the least time the card
   could take (bound) and a one-call library yardstick where one exists;
4. tiny end-to-end parity: the serving engine on the card (kernels)
   against the same engine on the CPU (plain versions), fp32, TF32 off —
   greedy tokens must be identical;
5. the slice at full width: Llama-2-7B (32 layers, bf16, seeded random
   weights) served by ``ContinuousBatchingEngine`` — 12 requests of
   32-512 prompt tokens through 8 slots, 32 new tokens each — with
   the kernels' launch counters checked against the micro-rounds run.

The line before the card line lists every kernel with its numbers; the
last line is ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

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
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol, msg=lambda m: f"{name}: {m}")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def rms_norm_phase(torch, rn):
    """rms_norm at the 7B step's (T, h) = (256, 4096)."""
    rows, h = 256, 4096
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    report = {}
    # tolerances: fp32 differs only in the order of the row sum; a bf16
    # output may differ by one rounding step (8 mantissa bits)
    for dt, kind, rtol, atol in ((torch.bfloat16, "bf16", 1.6e-2, 1e-5),
                                 (torch.float32, "fp32", 1e-5, 1e-6)):
        x = torch.randn(rows, h, generator=gen, device="cuda").to(dt)
        w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(dt)
        eps = 1e-5
        got = rn.rms_norm_kernel(x, w, eps)
        torch.cuda.synchronize()
        err = check_close(torch, f"rms_norm {kind}", got,
                          rn.rms_norm_plain(x, w, eps), rtol, atol)
        isz = x.element_size()
        nbytes = 2 * rows * h * isz + h * isz
        bms, by = bound_ms(nbytes, 4 * rows * h, "fp32")
        lib = None
        if hasattr(torch.nn.functional, "rms_norm"):
            lib = device_ms(torch, lambda: torch.nn.functional.rms_norm(
                x, (h,), w, eps))
        report[kind] = dict(
            shape=[rows, h], max_abs_err=err, rtol=rtol, atol=atol,
            ms=device_ms(torch, lambda: rn.rms_norm_kernel(x, w, eps)),
            eager_ms=eager_ms(torch, lambda: rn.rms_norm_kernel(x, w, eps)),
            plain_ms=device_ms(torch, lambda: rn.rms_norm_plain(x, w, eps)),
            bound_ms=bms, bound_by=by, library_ms=lib)
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


def _kernel_ms_by_kind(prof):
    """Device time (ms) of one profiled window by kind of kernel, and
    the window's largest kernels."""
    from torch.autograd import DeviceType
    kinds = dict(ragged_paged_attention=0.0, rms_norm_fwd=0.0, matmul=0.0,
                 other=0.0)
    top = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        kind = ("ragged_paged_attention" if "ragged_paged_attention" in name
                else "rms_norm_fwd" if "rms_norm" in name
                else "matmul" if any(s in name for s in (
                    "gemm", "gemv", "xmma", "cutlass", "nvjet"))
                else "other")
        kinds[kind] += us / 1e3
        top.append((us / 1e3, e.key[:60], e.count))
    top.sort(reverse=True)
    return kinds, [dict(ms=t, kernel=k, calls=c) for t, k, c in top[:6]]


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
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.ops import _common
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import rms_norm as rn

    card = card_line()
    print(f"[1/5] card: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)

    # phase 2: nvcc in the background while Triton compiles its kernel
    t0 = time.perf_counter()
    errors = []

    def build():
        try:
            _common.build_cuda_sources(["ragged_paged_attention"])
        except BaseException as e:       # re-raised below, on this thread
            errors.append(e)

    th = threading.Thread(target=build)
    th.start()
    x = torch.ones(4, 4096, device="cuda", dtype=torch.bfloat16)
    rn.rms_norm_kernel(x, x[0], 1e-5)
    torch.cuda.synchronize()
    th.join()
    if errors:
        raise errors[0]
    for line in _common.build_logs.get("ragged_paged_attention",
                                       "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    print(f"[2/5] built both kernels in {time.perf_counter() - t0:.1f} s",
          flush=True)

    rms = rms_norm_phase(torch, rn)
    print("[3/5] rms_norm kernel vs plain:", json.dumps(rms), flush=True)
    attn = attention_phase(torch, pa)
    print("[3/5] ragged attention kernel vs plain:", json.dumps(attn),
          flush=True)

    parity = parity_phase(torch, L, D)
    print("[4/5] tiny engine, card == cpu tokens:", json.dumps(parity),
          flush=True)

    serve = serve_7b_phase(torch, L, D, rn, pa)
    print(f"[5/5] Llama-2-7B bf16 serve on {card}:", json.dumps(serve),
          flush=True)

    rb, ab = rms["bf16"], attn["nkv32_bf16"]
    kernels = [
        dict(name="rms_norm_fwd", route="triton",
             source="paddle_tpu_torch/ops/rms_norm.py",
             replaces="paddle_tpu/ops/rms_norm.py:48",
             launches=serve["launches"]["rms_norm_fwd"],
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
    ]
    for k in kernels:
        if not all(math.isfinite(k[f]) for f in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"non-finite measurement in {k}")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
