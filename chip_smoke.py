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
    of tokens equal to phase 7's greedy streams;
24. the serving fleet on phase 7's weights (run right after phase 23):
    two unified 7B replicas with the prefix cache, each its own pool and
    CUDA graph, built and warmed before any timed window. (a) phase 7's
    12 prompts, four of them behind a shared 256-token prefix, through
    ``FleetRouter``: requests per replica, prefix-affinity and cache
    hits, tokens/s against phase 7's engine-only serve, TTFT / ITL p50
    and p99, the router's host work between steps and a profiled step's
    idle share. (b) on two fresh replicas, a step clock and the journal
    armed (its head ``model_spec(cfg, SEED)`` and the fleet's topology):
    a ``FaultInjector`` ``replica_die`` on replica 0 at the first step
    where one of its requests is mid-decode: every request finishes,
    fails unless the tokens streamed before the kill and after it (the
    continuation flags its streamed tokens ``decoded``) equal phase 7's
    greedy streams; the ejection's automatic debug bundle and a final
    one are kept for phase 29; then ``replica_stall`` and the half-open
    probe re-admitting the replica. (c) ``DisaggRouter`` with a PREFILL
    and a DECODE replica:
    handoffs, pages and bytes, handoff ms split into export, wire
    (frame, CRC, decode) and import, bytes/s against a pinned host round
    trip of the same size, the decode side's ITL against (a)'s, stream
    equality with phase 7's before and after the handoff (asserted),
    ``check_conservation`` on both pools after every import and no page
    left live. (d) a signal bus on a replica's scheduler and the
    fleet's, a ``DiagServer`` on 127.0.0.1 answering every route with
    the reference's keys, and an ``AutoscaleController`` scaling up
    through a factory that builds a third replica on the same weights
    (its capture seconds), flipping its role and draining it back down.
    Launch counts are checked against the replicas' micro-rounds in
    every window, no program is built after the warm-up, and every
    replica is released before the later phases;
25. tiny GPT parity (run after phase 19): ``gpt_tiny`` at h 128 with 2
    heads of 64 (the flash kernels' d), 2 layers, fp32, TF32 off, on the
    card against the same weights on the CPU — logits, ``generate``
    tokens (identical), ``fused_multi_transformer_array`` with a ragged
    ``seq_lens`` decode, and 3 AdamW steps of ``compute_loss`` (losses
    and weights), the launches held to the layer count; then the
    LayerNorm kernels at h 1600 (4096 and 8 rows, bf16 and fp32) and the
    causal flash kernels at d 64 with 25 heads ((100, 1024), (200, 512)
    and a 37-token prompt) against their plain versions, with times,
    bounds, plain and library (``F.layer_norm``, SDPA) times at the
    training step's shapes;
26. GPT-2 XL at its published widths (vocab 50257, h 1600, 48 layers,
    25 heads, FFN 6400, 1024 positions; bf16, seeded random weights,
    nothing cut): ``generate`` at the ``decode`` workload's shape (8
    prompts of 512 tokens, 128 new) with its prefill ms, decode tok/s, a
    profiled decode step by kind and its idle share, the mean step
    against its HBM bound, peak memory, launches checked and the share
    of tokens equal to a full re-forward's argmax; then training on a
    (4, 1024) batch with ``AdamW(multi_precision=True)``, 2 warm-up and 3
    timed steps, every step's launches checked, the loss falling,
    tokens/s, MFU, peak memory and a profiled breakdown;
27. the eager training API, card against CPU (after phase 26): every
    optimizer family (SGD, Momentum with Nesterov, Adam, AdamW with a
    decay filter, Adamax, Lamb, centered RMSProp with momentum,
    Adagrad; fp32) over a tiny GPT's parameters under
    ``LinearWarmup(CosineAnnealingDecay)`` and ``ClipGradByGlobalNorm``
    for 3 steps, each step's gradients from the CPU model given to both
    sides: weights and every state slot within ``CARD_CPU_TOL``;
    ``GradScaler`` with AdamW, a good step and an inf step (skipped,
    weights and moments bitwise unchanged, the scale halved, the CPU
    twin's state); legacy replicas' bf16 continuations, a failover and a
    handoff, equal to a single engine's streams, with the paged decode,
    flash forward and RMSNorm launches counted;
28. GPT-2 XL training with the reference's recipe (phase 26's config
    and batches): ``amp.decorate(level="O2")``, AdamW under the warm-up
    and cosine schedule with ``ClipGradByGlobalNorm(1.0)`` and no decay
    on biases and norms, ``GradScaler``; 2 warm-up and 5 timed steps
    (launches checked), the step against phase 26's plain-AdamW step,
    tokens/s, MFU, peak memory, idle share, the unscale's and the clip's
    device ms, the card reads a step and the loss curve; an inf step
    that moves nothing and halves the scale; the optimizer's,
    scheduler's and scaler's state through host memory into fresh
    objects, the next step's weights bitwise the uninterrupted run's;
29. postmortem replay on the card (after phase 22, once phase 7's
    weights are freed): ``replay_bundle`` over phase 24 (b)'s ejection
    and final bundles, each rebuilding the 7B weights and both replicas
    from the head frame: ``ok``, no divergence, no leaked page, the
    launches checked against the micro-rounds, the wall against the
    original run's, builds and capture seconds; a copy with one flipped
    token must diverge at that outcome frame;
30. multi-host serving (right after phase 24, with phase 7's weights
    still alive in this process): two spawned engine processes
    (``chip_smoke:llama7b_host``, each building its own 7B weights from
    the seed, the unified engine with the prefix cache and its CUDA
    graph) behind a ``HostFleetRouter`` over ``PipeTransport``, the
    memory reckoned first; ``hello`` must say ``bfloat16``, nvidia-smi
    must list both processes holding at least their weights. (a) a
    storm of 16 requests (64-512 prompt tokens, 128 new), its streams
    equal to an in-process engine's on this process's weights, the
    fleet's tokens/s and the router's host ms a step; (d) the
    federation armed, one merged /metrics scraped from a DiagServer
    (validator-clean, a ``host`` label per process, the scrape ms, clock
    offsets and RTTs); (b) ``migrate_host`` mid-decode with the pages
    (4 of the storm's prompts, 2 a host): continuations equal to the
    storm's streams, pages imported and prefill tokens skipped on the
    destination, no live page left, the migration's ms (its export and
    import RPCs), bytes and bytes/s beside phase 24 (c)'s handoff; (c)
    a real SIGKILL mid-decode (8 of the storm's prompts): the breaker
    walks SUSPECT to EJECTED, the interrupted streams finish equal on
    the survivor with no live page, the card frees the dead process's
    weights; each process's
    launches (counted in the process, read from its telemetry frames)
    checked against its micro-rounds; the tear-down leaves no process
    and the card within 0.1 GB of its level before the phase.
31. the Paddle-shaped eager Tensor surface (right after phase 12): (a)
    ``scripts/eager_llama_step.py`` (``paddle.to_tensor``, Parameters,
    ``paddle.matmul``, ``F.embedding``, ``F.rms_norm``, the incubate
    rotary embedding, causal SDPA, ``F.silu``, ``F.cross_entropy``,
    ``backward``, ``ClipGradByGlobalNorm`` and AdamW) at tiny widths on
    the card against the CPU, fp32 (TF32 off) and under ``auto_cast``
    O1 bf16, loss and every gradient within ``EAGER_CARD_CPU_TOL``; the
    training ``fused_bias_dropout_residual_layer_norm`` with the same
    mask on both devices; the tensor checker and the ``checkify_wrap``
    counterpart naming the op. (b) the same script at Llama-2-7B widths
    with 8 layers (phase 12's cut), fp32 Parameters under O1, a (1,
    2048) batch: 1 warm and 3 timed steps with rows 1, 2, 5 and 6
    launched 2L+1, 2L+1, L and L times a step, the loss falling, matmul
    and flash inputs bf16 and RMSNorm fp32 at the dispatcher, step 1's
    loss against ``forward_stacked`` on the bf16 weights; the step wall,
    tokens/s, device ms by kind, idle share, ops a step, the
    dispatcher's µs per op disarmed and armed, and peak memory beside
    phase 12's step.

32. GPT-2 XL's widths cut to 4 layers (the machine's 45 GiB of disk
    writes a call, and the smoke's time limit) under phase 28's recipe
    driven by ``ResilientTrainer`` (right after phase 28): six steps in a
    plain loop, then the chaos run with fresh objects
    (``save_interval=2``, ``keep=2``, async saves of the 2.8 GB
    ``TrainState`` under ``build/``): a preemption at step
    2 through the real SIGTERM path with its flush corrupted by a
    ``truncate_shard`` fault, a resume by a new model, optimizer,
    scheduler and scaler from another seed that skips the corrupt
    checkpoint, a NaN at step 4 rolled back and replayed. The final
    weights, masters, moments and scheduler state bitwise the plain
    run's; the counters; every step's rows 5, 6 and 8 launches; each
    save's stall and write GB/s, each load's GB/s, beside the card's
    name and power limit.

33. the rest of ``nn/``, ``metric/`` and the high-level API (last):
    (a) ``scripts/transformer_mt.py`` at tiny widths (d_model 64, 4
    heads, 2 + 2 layers, d_ff 128, vocabulary 101) on the card against
    the CPU: 3 ``Model.fit`` steps over batches of 4 pairs of 5-12
    tokens with dropout 0.1 (the key stream's masks on both devices),
    the losses and weights within ``testing.MT_FIT``, greedy tokens and
    the beam ids of a tiny LSTM seq2seq (hidden 32, beam 4) identical,
    then each new ``functional`` family once card against CPU. (b)
    Transformer-base (PaddleNLP's ``transformer.base.yaml``: d_model 512,
    8 heads, 6 + 6 layers, d_ff 2048, 33 712 shared BPE tokens, post-LN,
    tied output) fp32 through ``Model.fit``: 30 steps of ≤4096-target-
    token buckets with ``ModelCheckpoint`` and ``LRScheduler``, row 8's
    30 forward and 30 backward launches a step; the step wall (median of
    steps 6-30), target and total tokens/s, MFU against the fp32 peak, a
    profiled step's device ms by kind and idle share, the dropout draws
    and the masked attentions timed alone at its shapes, the host ms
    hapi adds a batch, peak memory; ``evaluate`` with ``Accuracy``,
    ``save`` / ``load`` (bitwise) and ``predict``; greedy decoding (64
    equal-length sources, 128 tokens) with row 5's 12 launches a step.
    (c) beam search over the LSTM seq2seq at PaddleNLP's IWSLT'15 widths
    (hidden 512, target vocabulary 7709): batch 128, beam 10, 50 steps;
    ms a step, tokens/s, ``gather_tree`` alone.
34. Compiled programs (``jit``, ``static``, the Predictor, fusion), TF32
    off. (a) Tiny widths, card == CPU and every CUDA graph == the same
    program with graphs off (bitwise): ``to_static``, ``TrainStep`` (3
    steps with dropout) and ``multi_step(2)``, the dy2static ``if`` /
    ``while`` (a counted graph break) / ``for`` / early-``return``
    functions, a ``to_static`` function of Python numbers (one capture,
    each call its own values), ``jit.save`` → ``load`` → ``Predictor``
    (the saved programs launch rows 8, 1 and 5), the fused-tail
    engine's streams,
    the fused Adam (bitwise against eager on each device). (b)
    Transformer-base at full widths through ``Model.prepare(jit_compile=
    True)`` over phase 33's 30 buckets padded by ``ShapeBucketer`` (5
    signatures, one CUDA graph each); the first 3 steps bitwise against
    the graphs-off body; the eager ``Model.fit`` over the same padded
    batches; step median, idle share, MFU, peak memory, captures and
    ``recompile_count``. (c) ``jit.save`` of its forward through
    ``inference.create_predictor``: against the layer, row 8's 30
    launches a run, save / load seconds, ms a run. (d) (run after phase
    21, on phase 7's weights) the 7B unified serve with
    ``fused_tail=True``: phase 7's streams, one build, 2 plan uploads a
    step against 8, ``enable_fused_tail()`` mid-serve (one counted
    rebuild), the fused speculative step, and warm fused and unfused
    serves alternating (3 each: step ms and the host's planning ms a
    step). (e) ``install_optimizer_fusion`` on Transformer-base's Adam
    under the eager ``Model.fit``: 3 steps bitwise, the optimizer step's
    ms fused and unfused. (f) Rows 1, 8 and 5's custom-op dispatch (the
    form an exported program holds) against the direct call of their
    wrappers: µs a call, and Transformer-base's greedy decoding with
    each patched in, alternating, same tokens.
35. Distributed I, TF32 off. (a) ``init_parallel_env()`` at world size
    1 with an explicit ``PADDLE_MASTER``: a one-rank NCCL group; every
    collective, both ``new_group`` forms, the object collectives,
    ``barrier`` and ``destroy_process_group`` on CUDA tensors, bitwise
    against a one-rank gloo group on the CPU; the native ``TCPStore``
    (built by g++) round trip; ``RNGStatesTracker`` draws card == CPU.
    (b) Phase 12's configuration under the remat policies ``full``,
    ``dots``, ``attn``, ``offload`` (and ``full`` again), each from the
    same weights for 1 warm-up and 3 timed steps: losses and weights
    against ``full``, step ms, tokens/s, MFU, peak memory, the bytes
    ``offload`` moves to the host, each policy's launches of rows 1, 2,
    5 and 6 checked. (c) Phase 33's Transformer-base with every layer
    under ``fleet.recompute`` and its Adam in ``AMPOptimizer``, 3 steps
    against the plain ones from the same weights and key stream: losses
    and gradients bitwise, step ms and peak memory of both.
36. Distributed II (Fleet hybrid training), TF32 off, over a one-rank
    NCCL group. (a) ``build_hybrid_train_step`` over ``build_mesh({})``
    at phase 12's configuration (Llama-2-7B widths, 8 layers, bf16, one
    (8, 2048) microbatch, full remat) from phase 12's weights, 3 steps,
    against phase 12's ``build_train_step`` run again from the same
    weights in this call: losses within ``testing.HYBRID_LOSS_TOL``,
    step ms (median) of both, peak memory above the weights and AdamW
    state, and rows 1, 2, 5, 6's launches a step checked. (b)
    ``fleet.init`` with every ``hybrid_configs`` degree 1,
    ``distributed_model`` on the imperative ``LlamaForCausalLM`` (7B
    widths, 2 layers, fp32) and ``distributed_optimizer`` (AdamW under
    ``HybridParallelClipGrad``): 5 steps of ``compile_train_step`` (a
    CUDA graph) with losses bitwise equal to the same model under a plain
    ``jit.TrainStep`` and ``ClipGradByGlobalNorm``; the same for
    ``group_sharded_parallel(level="os_g")`` under ``jit.TrainStep``, and
    ``PipelineParallel.train_batch`` at one stage against the eager loop
    on the same ``PipelineLayer``.
37. Distributed III, TF32 off. (a) Ring attention at Llama-2-7B widths
    (B 1, S 8192, 32 heads, d 128, bf16, causal) over a 4-rank ring
    (2048-token chunks), with 32 and with 8 KV heads (kv_rep 4): every
    rank's hops run in this process through ``ops.ring_attention``'s
    ``ring_forward`` / ``ring_backward`` (each hop's KV chunk read from
    the whole-sequence tensors), forward and backward, held against rows
    5 and 6 over the whole sequence and against the plain versions
    (``testing.RING_TOL``), with rows 5 and 6's launches (10 each a
    ring), and the ring's ms beside the whole-sequence kernels'; then
    ``ring_flash_attention`` over a one-rank NCCL group (rows 5 and 6
    over the whole sequence, one launch each). (b) GPT-MoE at the
    reference bench's configuration (vocab 50304, h 1024, 8 layers, 16
    heads, ff 4096, 8 experts top-2, GShard, fp32, AdamW lr 1e-4, (8,
    1024)) through ``jit.TrainStep``: 2 warm-up and 3 timed steps, step
    ms (median), tokens/s, active MFU over the fp32 peak, peak memory,
    rows 5, 6 and 8's launches a step checked; the losses held to the
    same steps run eagerly from the same weights and key stream
    (``testing.MOE_LOSS_TOL``); then one step with every gate biased as
    ``BENCH_MOE_SKEW`` biases it: a finite loss, block 0's routed, kept
    (at most the capacity) and dropped tokens an expert, its ms. (c)
    ``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 1``
    runs a trainer that joins NCCL, all-reduces and takes one GPT-MoE
    tiny step (exit 0); a trainer exiting 3 makes the launcher exit
    non-zero with its ``failure.json``.
38. Distributed IV (run while phase 7's weights are on the card). (a) A
    tiny fp32 engine (h 512, 4 heads of 128, 2 layers), greedy and
    seeded sampled requests mixed, with the prefix cache and speculation
    on and off, over ``serving_mesh(n, [cuda:0] * n)`` for n 1, 2 and 4
    (logical chips on one card, each with its own weight and pool slabs)
    through the CUDA graphs: tokens equal to the CPU engine's at mp 1.
    (b) Row 3 on the head slabs of a serving mesh at the 7B serve's
    packed shapes (256 tokens, 8 rows, d 128, bf16): 16 and 8 heads of
    MHA (mp 2 and 4) and 8 query heads over 2 kv heads (GQA 32/8 at mp
    4): each chip's kernel on its contiguous slabs against the whole
    call's slice and its plain version (``testing.RAGGED_SLAB_TOL``),
    the launches, one chip's ms, every chip's in turn and the whole
    call's. (c) Llama-2-7B (phase 7's weights, 32 layers, bf16) over
    ``serving_mesh(4, [cuda:0] * 4)``: the first micro-round's logits
    against the one-chip step's (and the same over 2 layers in fp32),
    then phase 7's 12 prompts through the
    CUDA graphs, greedy tokens equal to phase 7's up to a near-tie
    (``testing.TP_SERVE_TOL``), step walls, device ms by kind, the
    all-reduce adds alone, idle share, capture seconds, peak memory,
    rows 1 and 3's launches per micro-round (row 3: 4 x 32). (d)
    ``test_elastic.py``'s seeded chip-loss storm at tiny widths, fp32,
    on the card: byte-identical to the fault-free storm and the CPU's;
    then one ``lose_chip`` on a 2-replica 7B fleet (2 logical chips a
    replica, mp 2 -> 1), the resize arc timed on the host clock with the
    rebuilt replica's first step. (e) ``auto_parallel`` (``shard_tensor``,
    ``reshard``, ``shard_layer``, ``Engine.fit``) over a one-rank NCCL
    group against the CPU. (f) Only with two cards: a serving mesh over
    cuda:0 and cuda:1 (the NCCL all-reduce); otherwise it says why it
    did not run.
39. Other workloads: int8 serving and vision, TF32 off. (a) and (b) run
    while phase 7's weights are on the card, (c) to (f) last. (a) Tiny
    fp32 card == CPU: phase 5's config with all eight Llama keys
    weight-only int8 (the card's int8 bytes the CPU's) served by the
    unified and legacy engines with FLAGS_serving_a8w8_prefill on and
    off, identical greedy tokens; ``_int8_mm``'s int32 product and
    output bitwise; ``FusedMultiTransformerInt8`` prefill and decode
    within ``testing.INT8_CARD_CPU_TOL``; a ResNet-18 SGD step within
    ``testing.VISION_CARD_CPU_TOL``; two ViT ``build_vit_train_step``
    steps (2 heads of 64) within ``CARD_CPU_TOL`` and
    ``trained_weights_close``. (b) Llama-2-7B weight-only int8
    (``quantize_stacked_params`` of phase 7's weights) served with phase
    7's load through the CUDA graphs, A8W8 prefill on: step walls,
    tokens/s, peak memory, weight bytes, builds and capture seconds, rows
    1 and 3's launches checked against the micro-rounds, a profiled
    prefill and decode step, the greedy streams equal to phase 7's
    (counted, not asserted); then the flag off once: one more counted
    build, the weight-only route's step walls. (c)
    ``FusedMultiTransformerInt8`` at BERT-large geometry (24 layers, h
    1024, 16 heads, bf16, (8, 512)) against the bf16 stack: device ms of
    each, relative L2, rows 5 and 8's launches. (d) ResNet-50, B 128 at
    224², AMP O2 bf16, Momentum through ``jit.TrainStep``; (e) ViT-L/16,
    B 32 at 224², bf16, ``build_vit_train_step`` with rows 5, 6 and 8's
    launches a step checked and MFU by the reference bench's FLOP count;
    (f) PP-YOLOE-s, B 16 at 320², AdamW through ``jit.TrainStep``, then
    ``predict_with_nms``: 3 warm-up and 5 timed steps each, ms/step,
    img/s, peak memory, finite losses.

40. The long tail, TF32 off, while phase 7's weights are on the card.
    (a) Phase 7's serve (its engine geometry, weights and 12 prompts,
    CUDA graphs) unprofiled, then with its first 8 steps under
    ``Profiler(targets=[CPU, GPU], scheduler=(2, 6),
    on_trace_ready=export_chrome_tracing(dir))``: the host export holds
    the window's 4 ``ProfileStep`` spans; the device trace names row 1's
    and row 3's kernels exactly as often as their launch counters counted
    over the window; the tokens equal the unprofiled run's and phase 7's;
    the window's step walls with and without the profiler, and
    ``summary()``'s top lines. (b) The slice's modules on the card
    against the port's CPU path: ``linalg`` at (4096, 4096) fp32
    (``solve``, ``cholesky``, ``qr``, ``eigh``, ``inv``, ``slogdet``,
    ``lu``; ``svd`` at 2048, ``lstsq`` at (4096, 2048)) by residual and
    orthogonality bounds and card == CPU where the host is quick;
    ``stft``/``istft``, ``MelSpectrogram`` (80 mels) and ``MFCC`` (40)
    over 32 clips of 10 s at 16 kHz (n_fft 512, hop 160, window 400);
    2^20 draws of each distribution family under the same key against
    the CPU's (flipped rejection decisions counted); ``sparse.matmul``
    and ``send_u_recv`` (sum, mean, max) on a seeded graph of
    ogbn-arxiv's size; ``viterbi_decode`` at (64, 256) with 50 tags, the
    paths equal. The bounds are ``testing``'s LINALG_CARD_TOL,
    SIGNAL_CARD_TOL, DRAW_TOL with DRAW_CARD_FLIPS and GRAPH_CARD_TOL.
    (a)'s launches join rows 1 and 3 in the kernels line.

The line before the card line lists every kernel with its numbers; the
last line is ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

N_PHASES = 40
#: phase 24 (b)'s debug bundles, replayed by phase 29 (under ``build/``)
BUNDLE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "smoke_bundles")
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


def backward_ms(torch, fwd_bwd, fwd, iters: int = 10) -> float:
    """Device time of a library call's autograd backward: ``fwd_bwd()``
    (the call, then ``torch.autograd.grad`` of its output) less
    ``fwd()`` (the call alone), each captured in a CUDA graph and
    replayed (:func:`device_ms`; inside the capture the backward runs
    on the capture stream with its forward). torch.profiler, which timed
    these backwards before, saw none or part of their device time late
    in this script's run (0 ms for ``F.layer_norm``'s, torch 2.11 on the
    H100)."""
    return (device_ms(torch, fwd_bwd, iters=iters, replays=3)
            - device_ms(torch, fwd, iters=iters, replays=3))


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
            # k[6]: the sampling epilogue (the prefill flags follow it)
            if [(n, k[6]) for n, k in eng.compile_misses] != [(name, True)]:
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
        if [(n, k[6]) for n, k in eng.compile_misses] != [
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
    key = (D._bucket(ids.shape[1]), max_new, ids.shape[0]) \
        + D._prefill_flags()
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
# phase 24: the serving fleet at Llama-2-7B width (router, chaos, roles)
# ---------------------------------------------------------------------------

FLEET_PREFIX = 256            # tokens of the shared prefix in (a)
FLEET_SHARED = (0, 3, 6, 9)   # (a): phase 7's prompts that get the prefix
#: the JAX package's DiagServer route documents (top-level keys) for a
#: server with an SLO monitor, a router, a signal bus, an autoscaler and a
#: prefix cache attached
FLEET_ROUTE_KEYS = {
    "/": ("endpoints",),
    "/healthz": ("status",),
    "/statusz": ("autoscale", "flight_recorder", "health", "journal",
                 "kvcache", "memory", "router", "signals", "slo",
                 "timelines"),
    "/tracez": ("active", "armed", "completed", "dropped_spans", "slowest",
                "traces"),
    "/varz": ("anomalies", "armed", "history", "interval_s", "signals",
              "ticks", "window_s"),
    "/scalez": ("config", "kind", "pending_ops", "records", "replicas",
                "roles", "rounds", "schema_version"),
    "/journalz": ("armed", "capacity", "dropped", "frames", "frames_total",
                  "head", "journal_version", "step"),
    "/memz": ("armed", "audits", "classes", "last_oom", "migration",
              "peaks", "pools"),
    "/debugz": ("armed", "capacity", "dump_dir", "dumps", "events",
                "metric_samples", "spans"),
}


class _JumpClock:
    """The host's monotonic clock plus a settable offset: a chaos run's
    breaker cooldowns pass without sleeping."""

    def __init__(self):
        self.offset = 0.0

    def __call__(self):
        return time.monotonic() + self.offset

    def sleep(self, dt):
        time.sleep(dt)


class _StepClock:
    """A deterministic clock for a journaled run: ``advance`` moves it a
    router step, sleeps add their time, ``offset`` jumps a cooldown (as
    :class:`_JumpClock`'s). A replay pins it to each journaled sample
    and lets sleeps add theirs, as here."""

    def __init__(self):
        self.t = 1000.0
        self.offset = 0.0

    def __call__(self):
        return self.t + self.offset

    def sleep(self, dt):
        self.t += dt

    advance = sleep


class _Launches:
    """Launch counts of the fleet's kernels over one window: the counters
    zeroed at ``start`` and checked at ``stop`` against the micro-rounds
    the window's engines ran (each engine's compiled unified step: 2L+1
    RMSNorm calls and L ragged calls a micro-round)."""

    def __init__(self, torch, rn, pa, n_layers):
        self.torch, self.rn, self.pa, self.n_layers = torch, rn, pa, n_layers
        self.total = {}

    def start(self, engines):
        self.rn.rms_norm.launches = 0
        _reset_ragged(self.pa)
        self.rounds0 = {id(e): e.micro_rounds for e in engines}

    def stop(self, engines):
        self.torch.cuda.synchronize()
        rounds = sum(e.micro_rounds - self.rounds0.get(id(e), 0)
                     for e in engines)
        got = {"rms_norm_fwd": self.rn.rms_norm.launches,
               **_ragged_launches(self.pa)}
        want = {"rms_norm_fwd": (2 * self.n_layers + 1) * rounds,
                **_ragged_want(self.torch, self.pa, self.n_layers * rounds)}
        if got != want:
            raise AssertionError(f"fleet launch counts {got} != {want}")
        for k, v in got.items():
            self.total[k] = self.total.get(k, 0) + v
        return dict(got, micro_rounds=rounds)


def _pct(xs):
    xs = [float(x) for x in xs]
    if not xs:
        return None
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99)), "count": len(xs)}


def _fleet_handles(S, engines, clock, health_kw=None):
    return [S.ReplicaHandle(i, eng, health_config=S.HealthConfig(
        **(health_kw or {})), clock=clock, sleep=clock.sleep)
        for i, eng in enumerate(engines)]


def _submit_timed(router, prompt, log, **kw):
    """``router.submit`` with every token's host time and the replica it
    came from recorded in ``log[rid]`` (the first entry: the submit)."""
    box = {}

    def on_token(tok):
        log[box["rid"]].append((time.perf_counter(),
                                box["req"].replica_id))
    t0 = time.perf_counter()
    req = router.submit(prompt, on_token=on_token, **kw)
    box.update(rid=req.rid, req=req)
    log[req.rid] = [(t0, None)]
    return req


def _latency(log, only_replica=None):
    """TTFT (submit to first token) and ITL (gaps between a request's
    consecutive tokens), ms; ``only_replica`` keeps the gaps whose both
    tokens came from that replica."""
    ttft, itl = [], []
    for stamps in log.values():
        t_sub, toks = stamps[0][0], stamps[1:]
        if toks:
            ttft.append((toks[0][0] - t_sub) * 1e3)
        for (a, ra), (b, rb) in zip(toks, toks[1:]):
            if only_replica is None or ra == rb == only_replica:
                itl.append((b - a) * 1e3)
    return {"ttft_ms": _pct(ttft), "itl_ms": _pct(itl)}


def _timed_router_steps(router, params, handles, max_steps=400,
                        before_step=None):
    """Step ``router`` until nothing is pending; returns each router
    step's wall and the host work outside the replicas' own steps (the
    router's routing, breaker, handoff and bookkeeping time), ms."""
    inside = [0.0]
    real = {}
    for h in handles:
        real[h.replica_id] = h.step

        def step(params, _f=h.step):
            t0 = time.perf_counter()
            try:
                return _f(params)
            finally:
                inside[0] += time.perf_counter() - t0
        h.step = step
    walls, host = [], []
    try:
        while router.pending:
            if before_step is not None:
                before_step()
            inside[0] = 0.0
            t0 = time.perf_counter()
            router.step(params)
            wall = time.perf_counter() - t0
            walls.append(wall * 1e3)
            host.append((wall - inside[0]) * 1e3)
            if len(walls) > max_steps:
                raise AssertionError(f"the fleet did not finish: "
                                     f"{router.statusz()['counters']}")
    finally:
        for h in handles:
            del h.step
    return walls, host


def _equal_share(pairs):
    n = sum(len(a) for a, _ in pairs)
    eq = sum(int(x == y) for a, b in pairs for x, y in zip(a, b))
    return (eq / n if n else None), eq, n


def _fleet_profiled_step(torch, router, params, vocab, n):
    """Where a router step that decodes on every replica spends its time
    (as ``step_breakdown`` does for one engine): ``n`` requests of 256
    prompt tokens, a first (prefill) router step, then the second
    (decode) one; wall from an unprofiled pass, device time from a
    torch.profiler pass over the same load; each pass drained."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(SEED + 7)
    prompts = [rng.randint(1, vocab, (256,)).astype(np.int32)
               for _ in range(n)]
    out = {}
    for profiled in (False, True):
        reqs = [router.submit(p) for p in prompts]
        router.step(params)
        torch.cuda.synchronize()
        if profiled:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                router.step(params)
                torch.cuda.synchronize()
        else:
            t0 = time.perf_counter()
            router.step(params)     # each replica ends in its host copy
            out["wall_ms"] = (time.perf_counter() - t0) * 1e3
        while router.pending:
            router.step(params)
        if any(r.state != "done" for r in reqs):
            raise AssertionError("the profiled fleet requests did not "
                                 "finish")
    by_kind, top = _kernel_ms_by_kind(prof)
    busy = sum(by_kind.values())
    if busy <= 0:
        raise AssertionError("the profiler saw no device time in the "
                             "fleet step")
    return dict(out, device_busy_ms=busy, kernel_ms=by_kind,
                top_kernels=top, idle_share=1 - busy / out["wall_ms"])


def _pinned_copy_bytes_per_s(torch, nbytes):
    """A plain device -> pinned host -> device round trip of ``nbytes``
    (the bytes a handoff moves), timed on the host around synchronised
    copies: bytes over the two copies' seconds."""
    n = max(int(nbytes) // 2, 1)
    dev = torch.empty(n, dtype=torch.bfloat16, device="cuda")
    host = torch.empty(n, dtype=torch.bfloat16, pin_memory=True)
    back = torch.empty_like(dev)
    best = math.inf
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host.copy_(dev)
        torch.cuda.synchronize()
        back.copy_(host)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return 2 * n / best, best


class _FleetScript:
    """An autoscale policy that decides a written-out sequence, one
    decision a round: the controller's actuation path on the card."""

    def __init__(self, S, decisions):
        self.config = S.AutoscaleConfig(max_replicas=3)
        self._script = list(decisions)

    def decide(self, snap, roles, t):
        return self._script.pop(0) if self._script else None


def fleet_7b_phase(torch, L, D, rn, pa, cfg, params, serve, greedy):
    """Phase 24: ``FleetRouter`` / ``DisaggRouter`` over replicas of the
    7B engine on one card, sharing phase 7's weights (each replica its
    own pool and CUDA graph): (a) a routed serve with a shared prefix,
    (b) a replica killed mid-decode and a stall re-admitted through the
    half-open probe, (c) a PREFILL and a DECODE replica with the KV page
    handoff, (d) the signal bus, the DiagServer's routes and one
    autoscaler scale-up, role flip and drain back down."""
    import urllib.request
    import paddle_tpu_torch.observability as O
    from paddle_tpu_torch.observability.journal import journal, model_spec
    import paddle_tpu_torch.resilience as RS
    import paddle_tpu_torch.serving as S
    prompts = serve_load(cfg)
    n_layers = cfg.num_hidden_layers
    launches = _Launches(torch, rn, pa, n_layers)
    reg = O.get_registry()

    def total(name):
        m = reg.get(name)
        return 0.0 if m is None else m.total

    def make_engine():
        eng = _serve_engine(D, cfg, step_tokens=256, prefix_cache=True)
        # the warm build: one short request captures the unified step
        eng.serve(params, [prompts[0][:16]])
        eng.cache.evict(eng.mgr.num_pages)
        eng.mgr.check_conservation()
        return eng

    out = {}
    t_setup = time.perf_counter()
    engines = [make_engine(), make_engine()]
    pool_bytes = engines[0].mgr.k_pages.nbytes + engines[0].mgr.v_pages.nbytes
    out["setup"] = dict(
        replicas=2, setup_s=time.perf_counter() - t_setup,
        capture_s=[sum(e.capture_seconds.values()) for e in engines],
        builds=[len(e.compile_misses) for e in engines],
        weight_bytes=sum(t.nbytes for t in params.values()),
        pool_bytes_each=pool_bytes,
        allocated_gb=torch.cuda.memory_allocated() / 1e9,
        reserved_gb=torch.cuda.memory_reserved() / 1e9)
    misses0 = [list(e.compile_misses) for e in engines]

    def no_new_builds(what):
        for e, m in zip(engines, misses0):
            if e.compile_misses != m:
                raise AssertionError(f"{what} built programs: "
                                     f"{e.compile_misses[len(m):]}")

    def cold_caches():
        for e in engines:
            e.cache.evict(e.mgr.num_pages)
            e.mgr.check_conservation()
            if e.mgr.num_live_pages:
                raise AssertionError("a replica holds live pages")

    # -- (a) the routed serve ----------------------------------------------
    rng = np.random.RandomState(SEED + 24)
    prefix = rng.randint(1, cfg.vocab_size, (FLEET_PREFIX,)).astype(np.int32)
    a_prompts = [np.concatenate([prefix, p]).astype(np.int32)
                 if i in FLEET_SHARED else p for i, p in enumerate(prompts)]
    clock = _JumpClock()
    handles = _fleet_handles(S, engines, clock)
    router = S.FleetRouter(handles, clock=clock, sleep=clock.sleep)
    log = {}
    aff0 = total("paddle_router_prefix_affinity_hits_total")
    hits0 = [e.cache.snapshot()["hits"] for e in engines]
    skipped0 = [e.cache.snapshot()["cached_tokens"] for e in engines]
    launches.start(engines)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [_submit_timed(router, a_prompts[0], log)]
    walls, host = _timed_router_steps(router, params, handles)
    reqs += [_submit_timed(router, p, log) for p in a_prompts[1:]]
    w2, h2 = _timed_router_steps(router, params, handles)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    a_launch = launches.stop(engines)
    walls += w2
    host += h2
    if any(r.state != "done" or len(r.stream.tokens) != NEW_TOKENS
           for r in reqs):
        raise AssertionError(f"(a) states {[r.state for r in reqs]}")
    no_new_builds("the routed serve")
    generated = sum(len(r.stream.tokens) for r in reqs)
    plain = [(r.stream.tokens, greedy[i]) for i, r in enumerate(reqs)
             if i not in FLEET_SHARED]
    share, eq, n = _equal_share(plain)
    if share != 1.0:
        raise AssertionError(f"routed streams: {eq} of {n} tokens equal to "
                             "phase 7's greedy streams")
    per_replica = {str(k): sum(1 for r in reqs if r.replica_id == k)
                   for k in range(2)}
    out["a_routed"] = dict(
        requests=len(reqs), requests_per_replica=per_replica,
        affinity_hits=total("paddle_router_prefix_affinity_hits_total")
        - aff0,
        shared_prefix_replicas=sorted({reqs[i].replica_id
                                       for i in FLEET_SHARED}),
        cache_hits=[e.cache.snapshot()["hits"] - h
                    for e, h in zip(engines, hits0)],
        prefill_tokens_skipped=[e.cache.snapshot()["cached_tokens"] - s
                                for e, s in zip(engines, skipped0)],
        router_steps=len(walls), serve_s=wall_a, generated_tokens=generated,
        tokens_per_s=generated / wall_a,
        phase7_engine_only_tokens_per_s=serve[
            "generated_tokens_per_s_without_capture"],
        mean_router_step_ms=float(np.mean(walls)),
        router_host_ms=dict(mean=float(np.mean(host)),
                            median=float(np.median(host)), max=max(host)),
        latency=_latency(log), launches=a_launch,
        equal_to_phase7_greedy=share, equal_tokens=[eq, n])
    hybrid_itl = out["a_routed"]["latency"]["itl_ms"]
    out["a_routed"]["profiled_step"] = _fleet_profiled_step(
        torch, router, params, cfg.vocab_size, 2 * engines[0].num_slots)
    no_new_builds("the profiled fleet step")
    del router, handles, reqs
    cold_caches()

    # -- (b) chaos: a replica dies mid-decode; a stall and the probe --------
    # fresh replicas on a step clock, journaled from their first step
    # (phase 29 replays the bundles: its replicas, rebuilt from the head
    # frame, start from zero too: request ids, programs, caches)
    engines[:] = []
    _free_card(torch)
    engines[:] = [_serve_engine(D, cfg, step_tokens=256, prefix_cache=True)
                  for _ in range(2)]
    clock = _StepClock()
    inj = RS.FaultInjector()
    handles = _fleet_handles(S, engines, clock, dict(
        eject_after=1, probe_cooldown_s=0.5))
    router = S.FleetRouter(handles, clock=clock, sleep=clock.sleep,
                           fault_injector=inj)
    fo0 = total("paddle_router_failovers_total")
    shutil.rmtree(BUNDLE_DIR, ignore_errors=True)
    os.makedirs(BUNDLE_DIR)
    O.flight_recorder.clear()
    O.flight_recorder.arm(dump_dir=BUNDLE_DIR)
    journal.arm(capacity=1 << 15)
    journal.record_head(model=model_spec(cfg, SEED),
                        fleet=router.journal_topology())
    reqs = [router.submit(p) for p in prompts]
    at_kill = {}

    def arm_kill():
        # the first step at which a request of replica 0 is mid-decode
        if at_kill:
            return
        mid = [r for r in reqs if r.replica_id == 0
               and 0 < len(r.stream.tokens) < NEW_TOKENS]
        if mid:
            at_kill.update({r.rid: list(r.stream.tokens) for r in reqs})
            inj.schedule.append(RS.Fault("replica_die", router._steps + 1,
                                         replica=0))

    def step_b():
        clock.advance(0.05)
        arm_kill()

    launches.start(engines)
    t0 = time.perf_counter()
    walls_b, _ = _timed_router_steps(router, params, handles,
                                     before_step=step_b)
    wall_b = time.perf_counter() - t0
    b_launch = launches.stop(engines)
    bundles = dict(final=O.flight_recorder.dump_debug_bundle(
        reason="smoke_chaos_final"))
    journal.disarm()
    O.flight_recorder.disarm()
    bundles["ejection"] = os.path.join(BUNDLE_DIR, next(
        f for f in sorted(os.listdir(BUNDLE_DIR))
        if "replica_ejected" in f))
    out["_bundles"] = bundles
    if not inj.fired or inj.fired[0][0] != "replica_die":
        raise AssertionError(f"the kill did not fire: {inj.fired}")
    if any(r.state != "done" or len(r.stream.tokens) != NEW_TOKENS
           for r in reqs):
        raise AssertionError(f"(b) states {[r.state for r in reqs]}")
    failed_over = [r for r in reqs if r.failovers]
    if not failed_over or any(r.replica_id != 1 for r in failed_over):
        raise AssertionError("no request failed over to replica 1")
    before = [(at_kill[r.rid], greedy[r.rid][:len(at_kill[r.rid])])
              for r in reqs]
    if any(a != b for a, b in before):
        raise AssertionError("tokens streamed before the kill differ from "
                             "phase 7's greedy streams")
    after = [(r.stream.tokens[len(at_kill[r.rid]):],
              greedy[r.rid][len(at_kill[r.rid]):]) for r in failed_over]
    kept = [(r.stream.tokens, greedy[r.rid]) for r in reqs
            if not r.failovers]
    s_after, eq_after, n_after = _equal_share(after)
    s_kept, eq_kept, n_kept = _equal_share(kept)
    if s_kept != 1.0:
        raise AssertionError(f"streams that stayed on replica 1: {eq_kept} "
                             f"of {n_kept} tokens equal to phase 7's")
    first_diff = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                       None) for a, b in after]
    if s_after != 1.0:
        # the continuation's streamed tokens are flagged ``decoding``
        # (``submit(decoded=)``): they take the route they were decoded on
        raise AssertionError(f"streams after the kill: {eq_after} of "
                             f"{n_after} tokens equal to phase 7's (first "
                             f"differing token {first_diff})")
    # (b)'s replicas built their programs in the chaos serve: later parts
    # build none
    misses0[:] = [list(e.compile_misses) for e in engines]
    chaos = dict(
        kill_step=inj.fired[0][1], router_steps=len(walls_b),
        serve_s=wall_b, failovers=total("paddle_router_failovers_total")
        - fo0, failed_over_requests=[r.rid for r in failed_over],
        streamed_before_kill={str(r.rid): len(at_kill[r.rid])
                              for r in failed_over},
        equal_before_kill=1.0,
        equal_after_kill=s_after, equal_after_kill_tokens=[eq_after,
                                                           n_after],
        first_differing_token_after_kill=first_diff,
        equal_not_failed_over=s_kept, equal_not_failed_over_tokens=[
            eq_kept, n_kept],
        replica0_state=handles[0].health.state, launches=b_launch)

    # the dead replica comes back on its engine, stalls, is ejected and
    # re-admitted through the half-open probe
    for e in engines:
        e.mgr.check_conservation()
    handles[0] = _fleet_handles(S, engines[:1], clock, dict(
        eject_after=1, probe_cooldown_s=0.5))[0]
    router.replace_replica(handles[0])
    inj.schedule.append(RS.Fault("replica_stall", router._steps + 1,
                                 replica=0))
    trail = []
    probe = None
    launches.start(engines)
    for step in range(200):
        state = handles[0].health.state
        if not trail or trail[-1] != state:
            trail.append(state)
        if state == "ejected":
            clock.offset += 1.0          # the cooldown passes
        if state == "half_open" and probe is None:
            probe = router.submit(prompts[1])
        elif step % 3 == 0 and len(trail) < 6 and not router.pending:
            router.submit(prompts[2])
        if probe is not None and probe.state == "done" \
                and state == "healthy" and not router.pending:
            break
        router.step(params)
        clock.advance(0.05)
    stall_launch = launches.stop(engines)
    if trail[-1] != "healthy" or "half_open" not in trail or probe is None \
            or probe.replica_id != 0:
        raise AssertionError(f"the stalled replica was not re-admitted "
                             f"through its probe: {trail}")
    if probe.stream.tokens != greedy[1]:
        raise AssertionError("the probe's stream differs from phase 7's")
    chaos.update(stall_trail=trail, stall_launches=stall_launch,
                 fired=[list(f) for f in inj.fired])
    out["b_chaos"] = chaos
    no_new_builds("the stall and probe")
    del router, handles, reqs, probe
    cold_caches()

    # -- (c) disaggregated serve: PREFILL -> DECODE with the page handoff --
    clock = _JumpClock()
    handles = _fleet_handles(S, engines, clock)
    router = S.DisaggRouter(handles, roles={0: S.ReplicaRole.PREFILL,
                                            1: S.ReplicaRole.DECODE},
                            clock=clock, sleep=clock.sleep)
    audits = [0]
    real_import = engines[1].cache.import_prefix

    def audited_import(tokens, ks, vs):
        got = real_import(tokens, ks, vs)
        for e in engines:
            e.mgr.check_conservation()
        audits[0] += 1
        return got
    engines[1].cache.import_prefix = audited_import
    at_handoff = {}
    real_handoff = router._handoff

    def noted_handoff(req, src, dst):
        at_handoff[req.rid] = len(req.stream.tokens)
        return real_handoff(req, src, dst)
    router._handoff = noted_handoff
    log = {}
    bytes0 = total("paddle_handoff_bytes_total")
    launches.start(engines)
    t0 = time.perf_counter()
    reqs = [_submit_timed(router, p, log) for p in prompts]
    walls_c, host_c = _timed_router_steps(router, params, handles)
    wall_c = time.perf_counter() - t0
    c_launch = launches.stop(engines)
    del engines[1].cache.import_prefix
    if any(r.state != "done" or len(r.stream.tokens) != NEW_TOKENS
           for r in reqs):
        raise AssertionError(f"(c) states {[r.state for r in reqs]}")
    if router.handoffs_failed or audits[0] != router.handoffs_ok \
            or not router.handoffs_ok:
        raise AssertionError(f"handoffs ok {router.handoffs_ok}, failed "
                             f"{router.handoffs_failed}, audited "
                             f"{audits[0]}")
    for e in engines:
        e.mgr.check_conservation()
        if e.mgr.num_live_pages:
            raise AssertionError("pages leaked after the handoffs")
    no_new_builds("the disaggregated serve")
    phases = list(router.handoff_phases)
    moved = sum(p["bytes"] for p in phases)
    secs = [p["export_s"] + p["wire_s"] + p["import_s"] for p in phases]
    biggest = max(phases, key=lambda p: p["bytes"])
    plain_bps, plain_s = _pinned_copy_bytes_per_s(torch, biggest["bytes"])
    pre = [(r.stream.tokens[:at_handoff.get(r.rid, NEW_TOKENS)],
            greedy[r.rid][:at_handoff.get(r.rid, NEW_TOKENS)]) for r in reqs]
    post = [(r.stream.tokens[at_handoff[r.rid]:],
             greedy[r.rid][at_handoff[r.rid]:]) for r in reqs
            if r.rid in at_handoff]
    s_pre, eq_pre, n_pre = _equal_share(pre)
    s_post, eq_post, n_post = _equal_share(post)
    decode_lat = _latency(log, only_replica=1)
    out["c_disagg"] = dict(
        router_steps=len(walls_c), serve_s=wall_c,
        tokens_per_s=NEW_TOKENS * len(reqs) / wall_c,
        handoffs=router.handoffs_ok, pages=router.handoff_pages_total,
        bytes=moved, bytes_counter=total("paddle_handoff_bytes_total")
        - bytes0, page_bytes=engines[0].mgr.page_nbytes,
        handoff_ms=_pct([s * 1e3 for s in secs]),
        export_ms=_pct([p["export_s"] * 1e3 for p in phases]),
        wire_ms=_pct([p["wire_s"] * 1e3 for p in phases]),
        import_ms=_pct([p["import_s"] * 1e3 for p in phases]),
        handoff_bytes_per_s=moved / sum(secs),
        largest_handoff=dict(bytes=biggest["bytes"], pages=biggest["pages"],
                             ms=1e3 * (biggest["export_s"]
                                       + biggest["wire_s"]
                                       + biggest["import_s"])),
        pinned_copy_bytes_per_s=plain_bps, pinned_copy_ms=plain_s * 1e3,
        decode_replica_itl_ms=decode_lat["itl_ms"],
        hybrid_itl_ms=hybrid_itl, latency=_latency(log),
        router_host_ms=dict(mean=float(np.mean(host_c)),
                            max=max(host_c)),
        conservation_audits=audits[0], leaked_pages=0,
        streamed_at_handoff={str(k): v for k, v in at_handoff.items()},
        equal_before_handoff=s_pre, equal_before_handoff_tokens=[eq_pre,
                                                                 n_pre],
        equal_after_handoff=s_post, equal_after_handoff_tokens=[eq_post,
                                                                n_post],
        finished_on_decode=sum(1 for r in reqs if r.replica_id == 1),
        launches=c_launch)
    if s_pre != 1.0:
        raise AssertionError("tokens streamed before the handoff differ "
                             "from phase 7's greedy streams")
    if s_post != 1.0:
        raise AssertionError(f"streams after the handoff: {eq_post} of "
                             f"{n_post} tokens equal to phase 7's")

    # -- (d) sensors, the DiagServer and the autoscaler --------------------
    fleet_engines = list(engines)
    capture = {}

    def engine_factory():
        t = time.perf_counter()
        eng = make_engine()
        capture.update(build_s=time.perf_counter() - t,
                       capture_s=sum(eng.capture_seconds.values()),
                       builds=len(eng.compile_misses))
        fleet_engines.append(eng)
        return eng

    def handle_factory(rid, eng):
        return S.ReplicaHandle(rid, eng, clock=clock, sleep=clock.sleep)

    sbus = handles[0]._scheduler.attach_signal_bus(interval_s=0.0)
    script = _FleetScript(S, [
        S.Decision("scale_up", "smoke", role=S.ReplicaRole.HYBRID),
        S.Decision("role_change", "smoke", replica_id=2,
                   role=S.ReplicaRole.PREFILL),
        S.Decision("scale_down", "smoke", replica_id=2)])
    ctl = S.AutoscaleController(router, engine_factory, handle_factory,
                                policy=script, interval_s=0.0)
    ctl.bus.arm()
    launches.start(fleet_engines)
    records = []
    try:
        for i in range(60):
            if i in (0, 4, 8):
                router.submit(prompts[4 + i // 4])
            rec = ctl.evaluate()
            if rec is not None:
                records.append(rec)
            router.step(params)
            clock.offset += 0.05
            if len(records) == 3 and records[-1].state == "done" \
                    and not router.pending:
                break
    finally:
        ctl.bus.disarm()
    d_launch = launches.stop(fleet_engines)
    acts = [(r.action, r.state) for r in ctl.records]
    if acts != [("scale_up", "done"), ("role_change", "done"),
                ("scale_down", "done")] or len(router.replicas) != 2:
        raise AssertionError(f"autoscaler records {acts}, replicas "
                             f"{sorted(router.replicas)}")
    srv = O.DiagServer(port=0, host="127.0.0.1",
                       monitor=router.make_slo_monitor())
    srv.attach_router(router)
    srv.attach_signals(ctl.bus)
    srv.attach_autoscale(ctl)
    srv.attach_kvcache(engines[1].cache)
    port = srv.start()
    routes = {}
    try:
        for route, want in FLEET_ROUTE_KEYS.items():
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                        timeout=30) as resp:
                body = json.loads(resp.read())
                status = resp.status
            if status != 200 or tuple(sorted(body)) != want:
                raise AssertionError(f"{route}: {status} "
                                     f"{sorted(body)} != {want}")
            routes[route] = status
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as resp:
            text = resp.read().decode()
            routes["/metrics"] = resp.status
    finally:
        srv.stop()
    for fam in ("paddle_router_requests_total",
                "paddle_router_replica_role", "paddle_handoff_pages_total",
                "paddle_autoscale_decisions_total", "paddle_signal_value"):
        if f"# TYPE {fam}" not in text:
            raise AssertionError(f"/metrics lacks {fam}")
    out["d_sensors"] = dict(
        routes=routes, scale_records=acts,
        third_replica=capture, signals=len(ctl.bus.values()),
        scheduler_signals=sorted(sbus.values()), launches=d_launch,
        metrics_lines=len(text.splitlines()))
    for e in fleet_engines:
        e.mgr.check_conservation()
    out["launches"] = launches.total
    # the process-wide recorder keeps the last router, bus and controller
    # for its bundles: let go of them so the replicas' pools free
    O.flight_recorder._router = O.flight_recorder._signals = None
    O.flight_recorder._autoscale = O.flight_recorder._slo_monitor = None
    return out


def fleet_released(torch, allocated0, report):
    """After a fleet phase returns (its replicas out of scope): the card
    holds what it held before the phase, within 1 GiB."""
    _free_card(torch)
    kept = torch.cuda.memory_allocated() - allocated0
    report["kept_gb_after_release"] = kept / 1e9
    if kept > 2**30:
        raise AssertionError(f"the fleet kept {kept / 1e9:.2f} GB on the "
                             "card after its release")


# ---------------------------------------------------------------------------
# phase 30: multi-host serving — two Llama-2-7B engine processes
# ---------------------------------------------------------------------------

MH_REQUESTS = 16      # (a): the storm's requests, prompts of 64-512 tokens
MH_NEW_TOKENS = 128
MH_MIGRATE = 4        # (b): the drain's requests (a migration moves
#                       ~200 MB a request at ~6 MB/s through the frames)
MH_KILL = 8           # (c): the kill's requests
#: the gauges each host process publishes after every engine step
MH_GAUGE = re.compile(r'^(smoke_host_\w+)(?:\{host="h\d+"(?:,kernel="(\w+)")?'
                      r'\}|\{kernel="(\w+)"\})? (\S+)$')


def llama7b_host(seed: int = SEED, max_new_tokens: int = MH_NEW_TOKENS):
    """Phase 30's host factory (``"chip_smoke:llama7b_host"``, run in a
    spawned process): Llama-2-7B bf16 with its own seeded weights on the
    card (the draw of phase 7's ``init_7b``), the unified engine with the
    prefix cache (phase 24's geometry: 8 slots, page 16, 1024 positions,
    256 tokens a step), its step captured as a CUDA graph by one short
    warm request. The kernels' launch counters are zeroed after the warm
    request; after every engine step the process publishes them, its
    micro-rounds and its allocated bytes as registry gauges, which reach
    the parent in the telemetry frames."""
    import torch
    from paddle_tpu_torch.inference import decoding as D
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.observability import get_registry
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import rms_norm as rn
    cfg = L.llama2_7b(dtype=torch.bfloat16)
    params = L.init_params(cfg, seed=seed, device="cuda")
    eng = D.ContinuousBatchingEngine(
        cfg, D.GenerationConfig(max_new_tokens=max_new_tokens),
        num_slots=8, page_size=16, max_seq_len=1024, chunk=8,
        step_tokens=256, prefix_cache=True, device="cuda")
    eng.serve(params, [np.arange(1, 17, dtype=np.int32)])
    eng.cache.evict(eng.mgr.num_pages)
    eng.mgr.check_conservation()
    reg = get_registry()
    g_launch = reg.gauge("smoke_host_kernel_launches",
                         "kernel launches in this host since its warm-up",
                         labels=("kernel",))
    g_rounds = reg.gauge("smoke_host_micro_rounds",
                         "engine micro-rounds since the warm-up")
    g_alloc = reg.gauge("smoke_host_allocated_bytes",
                        "device bytes this process holds")
    g_weights = reg.gauge("smoke_host_weight_bytes",
                          "device bytes of this host's weights")
    g_weights.set(float(sum(t.nbytes for t in params.values())))
    rn.rms_norm.launches = 0
    _reset_ragged(pa)
    rounds0 = eng.micro_rounds

    def publish():
        g_launch.set(float(rn.rms_norm.launches), kernel="rms_norm_fwd")
        for k, v in _ragged_launches(pa).items():
            g_launch.set(float(v), kernel=k)
        g_rounds.set(float(eng.micro_rounds - rounds0))
        g_alloc.set(float(torch.cuda.memory_allocated()))

    real_step = eng.step

    def step(p):
        n = real_step(p)
        publish()
        return n
    eng.step = step
    publish()
    return eng, params


def _host_gauges(text):
    """The ``smoke_host_*`` gauges of one host's exposition text:
    ``{kernel: launches, ..., "smoke_host_micro_rounds": n, ...}``."""
    out = {}
    for line in text.splitlines():
        m = MH_GAUGE.match(line)
        if m:
            out[m.group(2) or m.group(3) or m.group(1)] = float(m.group(4))
    return out


def _compute_apps():
    """``nvidia-smi``'s compute processes as ``[(pid, used MiB)]``."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                        "--format=csv,noheader,nounits"], check=True,
                       capture_output=True, text=True, timeout=60)
    apps = []
    for line in r.stdout.strip().splitlines():
        pid, mib = (s.strip() for s in line.split(","))
        apps.append((int(pid), float(mib)))
    return apps


def _check_host_apps(apps, pids, weight_bytes):
    """nvidia-smi must list both host processes, each holding at least
    its weights. Where a PID namespace hides the pids (every process
    reads as one pid, and each line then shows the card's total), it
    must list this process and two more; each host's own allocated
    bytes, from its telemetry, are checked in ``_host_launches``."""
    held = {}
    for pid, mib in apps:
        held[pid] = max(held.get(pid, 0.0), mib)
    if set(pids) <= set(held):
        small = [p for p in pids if held[p] * 2**20 < weight_bytes]
        if small:
            raise AssertionError(f"nvidia-smi: hosts {small} hold under "
                                 f"their weights ({apps})")
        return "by pid"
    big = [mib for _, mib in apps if mib * 2**20 >= weight_bytes]
    if len(apps) < 3 or len(big) < 3:
        raise AssertionError(f"nvidia-smi lists {apps}: not this process "
                             "and two hosts holding their weights")
    return "by count (pids hidden)"


def _host_launches(torch, pa, hub, hid, n_layers):
    """One host's launch counts from its last telemetry frame, checked
    against the micro-rounds its engine ran (2L+1 RMSNorm launches and L
    ragged calls a micro-round, as phase 24's)."""
    m = hub.mirror(hid)
    if m.frame is None:
        raise AssertionError(f"no telemetry frame from host {hid}")
    g = _host_gauges(m.frame["metrics_text"])
    rounds = int(g["smoke_host_micro_rounds"])
    got = {"rms_norm_fwd": int(g["rms_norm_fwd"]),
           **{k: int(g[k]) for k in _ragged_want(torch, pa, 0)}}
    want = {"rms_norm_fwd": (2 * n_layers + 1) * rounds,
            **_ragged_want(torch, pa, n_layers * rounds)}
    if got != want or rounds <= 0:
        raise AssertionError(f"host {hid} launches {got} != {want}")
    if g["smoke_host_allocated_bytes"] < g["smoke_host_weight_bytes"]:
        raise AssertionError(f"host {hid} holds "
                             f"{g['smoke_host_allocated_bytes']} bytes, "
                             "under its weights")
    return dict(got, micro_rounds=rounds,
                allocated_gb=g["smoke_host_allocated_bytes"] / 1e9)


def _mid_decode(router, prompts, what):
    """Submit ``prompts`` one a router step (so both hosts take some)
    and step until every stream is mid-decode (16 tokens in, 16 to go);
    returns the router requests."""
    reqs = []
    for _ in range(400):
        if len(reqs) < len(prompts):
            reqs.append(router.submit(prompts[len(reqs)]))
        elif all(16 <= len(r.stream.tokens) < MH_NEW_TOKENS - 16
                 for r in reqs):
            if len({r.replica_id for r in reqs}) != 2:
                raise AssertionError(f"{what} one host took every request")
            return reqs
        router.step(None)
    raise AssertionError(f"{what} no mid-decode moment")


def multihost_7b_phase(torch, L, D, pa, cfg, params, fleet):
    """Phase 30: two spawned engine processes, each with its own 7B
    weights, behind a ``HostFleetRouter`` over ``PipeTransport``: (a) a
    storm, (d) the federation's one merged /metrics, (b) ``migrate_host``
    with the pages, (c) a real SIGKILL mid-decode; then the tear-down."""
    import urllib.request
    import paddle_tpu_torch.serving as S
    from paddle_tpu_torch.observability import DiagServer
    from paddle_tpu_torch.observability.format import (
        validate_exposition_text)
    n_layers = cfg.num_hidden_layers
    rng = np.random.RandomState(SEED + 30)
    prompts = [rng.randint(1, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.randint(64, 513, size=MH_REQUESTS)]
    out = {}

    # the in-process reference: the children's engine on the parent's
    # weights (the same seed's draw)
    alloc0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = D.ContinuousBatchingEngine(
        cfg, D.GenerationConfig(max_new_tokens=MH_NEW_TOKENS),
        num_slots=8, page_size=16, max_seq_len=1024, chunk=8,
        step_tokens=256, prefix_cache=True, device="cuda")
    t0 = time.perf_counter()
    inproc, _ = _serve_checked(eng, params, prompts, max_steps=1000)
    inproc_s = time.perf_counter() - t0
    engine_bytes = torch.cuda.max_memory_allocated() - alloc0
    del eng
    _free_card(torch)

    # memory: the parent's weights stay (phases 8 and 20-22 need them)
    weight_bytes = sum(t.nbytes for t in params.values())
    free0, total = torch.cuda.mem_get_info()
    parent_bytes = total - free0
    context_bytes = 0.6e9            # a process's CUDA context, about
    plan = parent_bytes + 2 * (weight_bytes + engine_bytes + context_bytes)
    out["memory_plan_gb"] = dict(
        card=total / 1e9, parent_in_use=parent_bytes / 1e9,
        weights_per_host=weight_bytes / 1e9,
        engine_per_host=engine_bytes / 1e9,
        context_per_host=context_bytes / 1e9, total=plan / 1e9)
    print("  phase 30 memory plan (GB):", json.dumps(out["memory_plan_gb"]),
          flush=True)
    if plan > 0.95 * total:
        raise AssertionError(f"two 7B hosts need {plan / 1e9:.1f} GB of "
                             f"the card's {total / 1e9:.1f}")

    # -- the two host processes --------------------------------------------
    t0 = time.perf_counter()
    transports = [S.PipeTransport("chip_smoke:llama7b_host",
                                  {"seed": SEED}, host_id=i)
                  for i in range(2)]
    hosts = []
    router = None
    try:
        hosts = [S.HostHandle(i, S.HostEndpoint(tr, timeout_s=600.0),
                              health_config=S.HealthConfig(
                                  probe_cooldown_s=1e9))
                 for i, tr in enumerate(transports)]
        start_s = time.perf_counter() - t0
        pids = [tr._proc.pid for tr in transports]
        if any(h.engine.kv_dtype != "bfloat16" or not
               h.engine.has_prefix_cache for h in hosts):
            raise AssertionError("hello: " + str(
                [vars(h.engine) for h in hosts]))
        apps = _compute_apps()
        free1 = torch.cuda.mem_get_info()[0]
        out["hosts"] = dict(
            start_s=start_s, pids=pids, kv_dtype=hosts[0].engine.kv_dtype,
            page_nbytes=hosts[0].engine.page_nbytes,
            usable_pages=hosts[0].engine.mgr.usable_pages,
            compute_apps_mib=apps,
            compute_apps_check=_check_host_apps(apps, pids, weight_bytes),
            free_drop_gb=(free0 - free1) / 1e9)
        if free0 - free1 < 2 * weight_bytes:
            raise AssertionError(f"the hosts took {(free0 - free1) / 1e9:.1f}"
                                 f" GB of the card, under two 7B weights")
        router = S.HostFleetRouter(hosts, config=S.RouterConfig())
        hub = router.federation

        # -- (a) the storm: the fault-free reference streams ---------------
        # one submit a router step: each host's heartbeat reports its
        # load before the next request is routed (a host's load is what
        # its last step reply said)
        log = {}
        reqs = []
        todo = iter(prompts)

        def submit_next():
            p = next(todo, None)
            if p is not None:
                reqs.append(_submit_timed(router, p, log))
        t0 = time.perf_counter()
        submit_next()
        walls, host_ms = _timed_router_steps(router, None, hosts,
                                             max_steps=2000,
                                             before_step=submit_next)
        wall_a = time.perf_counter() - t0
        if any(r.state != "done" or len(r.stream.tokens) != MH_NEW_TOKENS
               for r in reqs):
            raise AssertionError(f"(a) states {[r.state for r in reqs]}")
        storm = [list(r.stream.tokens) for r in reqs]
        share, eq, n = _equal_share(list(zip(storm, inproc)))
        if share != 1.0:
            raise AssertionError(f"(a) {eq} of {n} tokens equal to the "
                                 "in-process engine's")
        generated = MH_NEW_TOKENS * len(reqs)
        out["a_storm"] = dict(
            requests=len(reqs),
            requests_per_host={str(k): sum(r.replica_id == k for r in reqs)
                               for k in range(2)},
            router_steps=len(walls), serve_s=wall_a,
            generated_tokens=generated, tokens_per_s=generated / wall_a,
            phase24_in_process_fleet_tokens_per_s=fleet["a_routed"][
                "tokens_per_s"],
            in_process_engine_s=inproc_s,
            in_process_engine_tokens_per_s=generated / inproc_s,
            mean_router_step_ms=float(np.mean(walls)),
            router_host_ms=dict(mean=float(np.mean(host_ms)),
                                median=float(np.median(host_ms)),
                                max=max(host_ms)),
            phase24_router_host_ms=fleet["a_routed"]["router_host_ms"],
            latency=_latency(log), equal_to_in_process=share,
            equal_tokens=[eq, n])

        # -- (d) federation: one merged /metrics ----------------------------
        hub.arm()
        router.step(None)           # a beat from each host
        launches_a = {str(h): _host_launches(torch, pa, hub, h, n_layers)
                      for h in range(2)}
        srv = DiagServer()
        srv.attach_federation(hub)
        srv.start()
        try:
            t0 = time.perf_counter()
            with urllib.request.urlopen(srv.url + "/metrics",
                                        timeout=60) as resp:
                text = resp.read().decode()
            scrape_ms = (time.perf_counter() - t0) * 1e3
            with urllib.request.urlopen(srv.url + "/statusz",
                                        timeout=60) as resp:
                fed = json.loads(resp.read())["federation"]
        finally:
            srv.stop()
        validate_exposition_text(text)
        for h in range(2):
            needle = (f'smoke_host_kernel_launches{{host="h{h}",'
                      f'kernel="rms_norm_fwd"}}')
            if needle not in text or f'{{host="h{h}"' not in text:
                raise AssertionError(f"/metrics has no series of host h{h}")
        clocks = {k: v["clock"] for k, v in fed["hosts"].items()}
        out["d_federation"] = dict(
            scrape_ms=scrape_ms, bytes=len(text),
            families=text.count("# TYPE "),
            hosts=sorted(fed["hosts"]),
            reconcile_error_ms=fed["reconcile_error_ms"],
            clock_offset_ms={k: c["offset_ms"] for k, c in clocks.items()},
            rtt_ms={k: dict(p50=c["rtt_p50_ms"], p90=c["rtt_p90_ms"],
                            samples=c["samples"])
                    for k, c in clocks.items()},
            launches_after_a=launches_a)

        # -- (b) migrate_host: drain host 0 with its pages ------------------
        sub = list(range(MH_MIGRATE))
        src = 0
        dst = 1
        reqs = _mid_decode(router, [prompts[i] for i in sub], "(b)")
        moved = [i for i, r in zip(sub, reqs) if r.replica_id == src]
        at_move = {i: len(r.stream.tokens) for i, r in zip(sub, reqs)}
        skipped0 = hosts[dst].statusz()["host"]["prefix_cache"][
            "cached_tokens"]
        # each request's two RPCs timed in the parent: the export (the
        # source's page reads and frame, the pipe, the parent's decode)
        # and the import (the parent's frame, the pipe, the
        # destination's decode and page writes)
        rpc_s = {"export_flight": [], "import_prefix": []}
        for h, name in ((hosts[src], "export_flight"),
                        (hosts[dst], "import_prefix")):
            def timed(*a, _f=getattr(h, name), _l=rpc_s[name]):
                t = time.perf_counter()
                try:
                    return _f(*a)
                finally:
                    _l.append(time.perf_counter() - t)
            setattr(h, name, timed)
        t0 = time.perf_counter()
        try:
            summary = router.migrate_host(src, dst)
        finally:
            del hosts[src].export_flight, hosts[dst].import_prefix
        mig_wall = time.perf_counter() - t0
        entries = router.multihost_snapshot()["migrations"][
            -summary["requests"] - summary["failed"]:]
        steps = 0
        while router.pending:
            router.step(None)
            steps += 1
            if steps > 2000:
                raise AssertionError("(b) did not finish")
        if (summary["failed"] or summary["requests"] != len(moved)
                or summary["pages"] <= 0
                or any(r.state != "done" for r in reqs)):
            raise AssertionError(f"(b) {summary}")
        share_b, eq_b, n_b = _equal_share(
            [(r.stream.tokens, storm[i]) for i, r in zip(sub, reqs)])
        if share_b != 1.0:
            raise AssertionError(f"(b) {eq_b} of {n_b} tokens equal to the "
                                 "storm's")
        st = [h.statusz()["host"] for h in hosts]
        skipped = st[dst]["prefix_cache"]["cached_tokens"] - skipped0
        imported = sum(e["imported_pages"] for e in entries)
        if imported <= 0 or skipped <= 0:
            raise AssertionError(f"(b) imported {imported} pages, skipped "
                                 f"{skipped} prefill tokens")
        if any(s["pages"]["live"] for s in st):
            raise AssertionError(f"(b) live pages {[s['pages'] for s in st]}")
        secs = [e["seconds"] for e in entries]
        c = fleet["c_disagg"]
        out["b_migrate"] = dict(
            src=src, dst=dst, requests=summary["requests"],
            streamed_at_move=[at_move[i] for i in moved],
            pages=summary["pages"], bytes=summary["bytes"],
            imported_pages=imported,
            skipped_pages=summary["skipped_pages"],
            prefill_tokens_skipped=skipped,
            migration_ms=_pct([s * 1e3 for s in secs]),
            migration_ms_per_request=[s * 1e3 for s in secs],
            bytes_per_request=[e["bytes"] for e in entries],
            export_rpc_ms=[t * 1e3 for t in rpc_s["export_flight"]],
            import_rpc_ms=[t * 1e3 for t in rpc_s["import_prefix"]],
            bytes_per_s=summary["bytes"] / sum(secs),
            drain_wall_s=mig_wall,
            phase24_handoff_ms=c["handoff_ms"],
            phase24_handoff_bytes_per_s=c["handoff_bytes_per_s"],
            equal_to_storm=share_b, equal_tokens=[eq_b, n_b],
            live_pages=[s["pages"]["live"] for s in st])
        router.undrain(src)

        # -- (c) host_die: a real SIGKILL mid-decode ------------------------
        victim, survivor = 1, 0
        sub = list(range(MH_KILL))
        reqs = _mid_decode(router, [prompts[i] for i in sub], "(c)")
        steps = 0
        interrupted = [i for i, r in zip(sub, reqs)
                       if r.replica_id == victim]
        victim_launches = _host_launches(torch, pa, hub, victim, n_layers)
        fo0 = sum(r.failovers for r in reqs)
        free_kill = torch.cuda.mem_get_info()[0]
        t_kill = time.perf_counter()
        hosts[victim].kill()                  # SIGKILL of the process
        walk, t_eject, t_freed, rise = [], None, None, 0
        while router.pending:
            router.step(None)
            state = hosts[victim].health.state
            if not walk or walk[-1] != state:
                walk.append(state)
            if t_eject is None and state == "ejected":
                t_eject = time.perf_counter() - t_kill
            rise = torch.cuda.mem_get_info()[0] - free_kill
            if t_freed is None and rise >= weight_bytes:
                t_freed = time.perf_counter() - t_kill
            steps += 1
            if steps > 3000:
                raise AssertionError("(c) did not finish")
        while t_freed is None and time.perf_counter() - t_kill < 10.0:
            time.sleep(0.05)
            rise = torch.cuda.mem_get_info()[0] - free_kill
            if rise >= weight_bytes:
                t_freed = time.perf_counter() - t_kill
        if walk[:1] != ["suspect"] or walk[-1] != "ejected":
            raise AssertionError(f"(c) health walk {walk}")
        if t_freed is None:
            raise AssertionError(f"(c) the card freed {rise / 1e9:.1f} GB "
                                 "after the kill")
        if any(r.state != "done" for r in reqs):
            raise AssertionError(f"(c) states {[r.state for r in reqs]}")
        share_c, eq_c, n_c = _equal_share(
            [(r.stream.tokens, storm[i]) for i, r in zip(sub, reqs)])
        if share_c != 1.0:
            raise AssertionError(f"(c) {eq_c} of {n_c} tokens equal to the "
                                 "storm's")
        st_s = hosts[survivor].statusz()["host"]
        if st_s["pages"]["live"]:
            raise AssertionError(f"(c) survivor pages {st_s['pages']}")
        router.step(None)             # a last beat from the survivor
        survivor_launches = _host_launches(torch, pa, hub, survivor,
                                           n_layers)
        out["c_host_die"] = dict(
            victim=victim, interrupted=len(interrupted),
            health_walk=walk, kill_to_ejected_s=t_eject,
            kill_to_weights_freed_s=t_freed, freed_gb=rise / 1e9,
            failovers=sum(r.failovers for r in reqs) - fo0,
            equal_to_storm=share_c, equal_tokens=[eq_c, n_c],
            survivor_live_pages=st_s["pages"]["live"])
        out["launches"] = {
            "rms_norm_fwd": victim_launches["rms_norm_fwd"]
            + survivor_launches["rms_norm_fwd"],
            "ragged_paged_attention":
                victim_launches["ragged_paged_attention"]
                + survivor_launches["ragged_paged_attention"],
            "per_host": {str(victim): victim_launches,
                         str(survivor): survivor_launches}}
        hub.disarm()
    finally:
        # -- tear-down ----------------------------------------------------
        if router is not None:
            router.close()
        for tr in transports:
            tr.close()
    alive = [tr._proc.is_alive() for tr in transports]
    free_end = torch.cuda.mem_get_info()[0]
    out["teardown"] = dict(alive=alive,
                           card_vs_before_gb=(free0 - free_end) / 1e9)
    if any(alive):
        raise AssertionError(f"host processes survived: {alive}")
    if abs(free0 - free_end) > 0.1e9:
        raise AssertionError(f"the card is {(free0 - free_end) / 1e9:.2f} "
                             "GB from its level before the hosts")
    return out


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

        def lib_fwd():
            return torch.nn.functional.rms_norm(xl, (h,), wl, eps)

        lib = backward_ms(torch, lambda: torch.autograd.grad(
            lib_fwd(), (xl, wl), g), lib_fwd)
        report[kind] = dict(
            shape=[rows, h], max_abs_err=err, tol=tol,
            ms=device_ms(torch, lambda: rn.rms_norm_bwd_kernel(x, w, g, eps)),
            plain_ms=device_ms(torch, lambda: rn.rms_norm_bwd_plain(
                x, w, g, eps), iters=5, replays=2),
            bound_ms=bms, bound_by=by, library_ms=lib)
        del x, g, w, xl, wl, dx, dw, pdx, pdw
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
    dq["library_ms"] = dkv["library_ms"] = backward_ms(
        torch, lambda: torch.autograd.grad(
            sdpa(ql, kl, vl, is_causal=True), (ql, kl, vl), do4),
        lambda: sdpa(ql, kl, vl, is_causal=True), iters=5)
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
    del q, k, v, do, q4, k4, v4, do4, ql, kl, vl, out, lse, delta
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


def _ln_library_bwd_ms(torch, copies, w, b, eps):
    """``F.layer_norm``'s backward (:func:`backward_ms`), each call on
    the next of the L2-cold ``copies`` of (x, g)."""
    h = w.shape[0]
    wl, bl = (t.detach().requires_grad_(True) for t in (w, b))
    nxt = itertools.cycle([(xc.detach().requires_grad_(True), gx)
                           for xc, gx in copies]).__next__

    def fwd(xl=None):
        return torch.nn.functional.layer_norm(
            nxt()[0] if xl is None else xl, (h,), wl, bl, eps)

    def fwd_bwd():
        xl, gx = nxt()
        return torch.autograd.grad(fwd(xl), (xl, wl, bl), gx)

    return backward_ms(torch, fwd_bwd, fwd)


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

        launch_ms = {name: device_ms(torch, lambda: kernel_bwd(cfg))
                     for name, cfg in launches.items()}
        bwd[kind] = dict(
            shape=[rows, h], eps=eps, max_abs_err=bwd_err, tol=tol,
            launch=launches["config"]._asdict(), ms=launch_ms.pop("config"),
            parent_launch_ms=launch_ms.pop("parent"), variants_ms=launch_ms,
            plain_ms=device_ms(torch, lambda: ln.ln_bwd_plain(x, w, g, eps),
                               iters=5, replays=2),
            bound_ms=bb, bound_by=bby,
            library_ms=_ln_library_bwd_ms(torch, copies, w, b, eps))
        del x, g, w, b, y, dx, dw, db, dw2, db2, pdx, pdw, pdb, copies, nxt
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
    rep["dq"]["library_ms"] = rep["dkv"]["library_ms"] = backward_ms(
        torch, lambda: torch.autograd.grad(
            sdpa(ql, kl, vl, attn_mask=mask), (ql, kl, vl), do4),
        lambda: sdpa(ql, kl, vl, attn_mask=mask), iters=5)
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
    del q, k, v, do, out, lse, delta, q4, k4, v4, do4, ql, kl, vl, mask
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
        opt = E.AdamW(learning_rate=lr, parameters=model.named_parameters())
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


# ---------------------------------------------------------------------------
# phases 25-26: GPT on the fused decoder stack
# ---------------------------------------------------------------------------

#: phase 25's tiny GPT: head dim 64 (128 / 2 heads), which the flash
#: kernels take; 2 layers, vocab 128, 64 positions
GPT_TINY = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256)
#: GPT-2 XL as published (openai-community/gpt2-xl config.json: n_embd
#: 1600, n_layer 48, n_head 25, n_inner null = 4·n_embd, n_positions
#: 1024, vocab 50257, layer_norm_epsilon 1e-5, gelu_new = tanh GELU)
GPT2_XL = dict(vocab_size=50257, hidden_size=1600, num_hidden_layers=48,
               num_attention_heads=25, intermediate_size=6400,
               max_position_embeddings=1024, layer_norm_epsilon=1e-5)
GPT_KINDS = (("flash_fwd", ("flash_attention_fwd",)),
             ("flash_bwd", ("flash_attention_bwd",)),
             ("layer_norm", ("layer_norm",)), ("matmul", MATMUL_NAMES))
GPT_GEN_KINDS = (("layer_norm_fwd", ("layer_norm",)),
                 ("matmul", MATMUL_NAMES))
GPT_TRAIN_B, GPT_TRAIN_S = 4, 1024


def _gpt_counters(ln, fa):
    return {"layer_norm_fwd": ln.layer_norm,
            "layer_norm_bwd": ln.layer_norm_bwd,
            "flash_attention_fwd": fa.flash_fwd_kernel,
            "flash_attention_bwd_dq": fa.flash_bwd_dq_kernel,
            "flash_attention_bwd_dkv": fa.flash_bwd_dkv_kernel}


def _gpt_want(n_layers, forwards=1, prefills=1, train_steps=0):
    """Launches on the GPT path: a forward runs 2L + 1 LayerNorms (two
    per layer and the final one), a prefill (or training forward) one
    flash forward a layer, a training step's backward as many LayerNorm
    backwards and one dQ and one dK/dV a layer."""
    ln_fwd = (2 * n_layers + 1) * forwards
    return {"layer_norm_fwd": ln_fwd,
            "layer_norm_bwd": (2 * n_layers + 1) * train_steps,
            "flash_attention_fwd": n_layers * prefills,
            "flash_attention_bwd_dq": n_layers * train_steps,
            "flash_attention_bwd_dkv": n_layers * train_steps}


def _check_launches(what, counters, want):
    got = {k: c.launches for k, c in counters.items()}
    if got != want:
        raise AssertionError(f"{what}: launches {got} != {want}")
    return got


def gpt_parity_phase(torch, G, ftb, ln, fa):
    """Tiny GPT (h 128, 2 heads of 64, 2 layers, fp32, TF32 off) on the
    card (kernels) against the same weights on the CPU (plain versions):
    logits of a (3, 37) batch, ``generate`` tokens (identical),
    ``fused_multi_transformer_array`` over the model's layers with a
    ragged ``seq_lens`` decode, and 3 AdamW steps of ``compute_loss``
    (losses and weights), with the launches of each run held to the
    layer count. Then the kernels at GPT-2 XL's shapes
    (:func:`gpt_kernel_checks`)."""
    from paddle_tpu_torch.optimizer.adamw import AdamW
    from paddle_tpu_torch.testing import CARD_CPU_TOL, trained_weights_close
    cfg = G.gpt_tiny(**GPT_TINY)
    n_layers, tol = cfg.num_hidden_layers, CARD_CPU_TOL
    cpu = G.init(G.GPTForCausalLM(cfg, device="cpu"), SEED)
    card = G.GPTForCausalLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    counters = _gpt_counters(ln, fa)
    rng = np.random.RandomState(SEED)
    ids = rng.randint(0, cfg.vocab_size, (3, 37)).astype(np.int64)
    out = {}
    _reset(counters)
    with torch.no_grad():
        got = card(torch.from_numpy(ids).cuda())
        torch.cuda.synchronize()
        _check_launches("gpt forward", counters, _gpt_want(n_layers))
        want = cpu(torch.from_numpy(ids))
    out["logits_max_abs_err"] = check_close(torch, "gpt logits", got.cpu(),
                                            want, *tol["out"])
    prompt, new = ids[:, :20], 12
    _reset(counters)
    toks = card.generate(prompt, max_new_tokens=new)
    _check_launches("gpt generate", counters, _gpt_want(n_layers, new))
    if not np.array_equal(toks, cpu.generate(prompt, max_new_tokens=new)):
        raise AssertionError("gpt generate: card tokens differ from the "
                             "CPU's")
    out["generate_tokens_equal"] = True

    # the decoder stack alone: a padded prefill, then a 2-token decode
    # with ragged seq_lens, over the model's own per-layer weights
    x = rng.normal(0, 1, (3, 16, cfg.hidden_size)).astype(np.float32)
    new_x = rng.normal(0, 1, (3, 2, cfg.hidden_size)).astype(np.float32)
    lens = np.asarray([5, 11, 16], np.int64)
    res = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        dec = model.gpt.decoder
        params = {k: list(getattr(dec, a)) for k, a in dec._STACK_KEYS}
        with torch.no_grad():
            _, kv = ftb.fused_multi_transformer_array(
                torch.from_numpy(x).to(dev), params,
                num_heads=cfg.num_attention_heads, max_cache_len=24)
            y, kv = ftb.fused_multi_transformer_array(
                torch.from_numpy(new_x).to(dev), params,
                num_heads=cfg.num_attention_heads, cache_kv=kv,
                time_step=16, seq_lens=torch.from_numpy(lens).to(dev))
        res[dev] = (y.cpu(), kv.cpu())
    out["stack_max_abs_err"] = max(
        check_close(torch, "gpt stack out", res["cuda"][0], res["cpu"][0],
                    *tol["out"]),
        check_close(torch, "gpt stack cache", res["cuda"][1], res["cpu"][1],
                    *tol["out"]))

    steps, lr = 3, 1e-3
    batch = rng.randint(0, cfg.vocab_size, (4, 48)).astype(np.int64)
    labels = np.roll(batch, -1, axis=1)
    labels[:, -1] = -100
    runs = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        opt = AdamW(learning_rate=lr, parameters=model.named_parameters())
        losses = []
        for i in range(steps):
            _reset(counters)
            opt.clear_grad()
            loss = model.compute_loss(torch.from_numpy(batch).to(dev),
                                      torch.from_numpy(labels).to(dev))
            loss.backward()
            opt.step()
            losses.append(float(loss))
            if dev == "cuda":
                _check_launches(f"gpt train step {i}", counters,
                                _gpt_want(n_layers, train_steps=1))
        runs[dev] = (losses, {n: p.detach().cpu()
                              for n, p in model.named_parameters()})
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0],
                               *tol["loss"])
    out.update(steps=steps, losses_card=runs["cuda"][0],
               losses_cpu=runs["cpu"][0],
               **trained_weights_close(runs["cuda"][1], runs["cpu"][1], lr,
                                       steps, hidden=cfg.hidden_size,
                                       msg="gpt parity"))
    del card, cpu
    out["kernels"] = gpt_kernel_checks(torch, ln, fa)
    return out


def gpt_kernel_checks(torch, ln, fa):
    """The LayerNorm and flash kernels against their plain versions at
    the GPT-2 XL shapes of phase 26, where no earlier phase runs them:
    LayerNorm at h 1600 (not a power of two: the forward's block is
    2048 with a masked tail) and eps 1e-5, over the training step's and
    the prefill's 4096 rows and a decode step's 8, bf16 and fp32; the
    causal flash kernels at d 64 with 25 heads, over the training step's
    (4·25, 1024), the prefill's (8·25, 512) and a 37-token prompt. Times
    (device, L2-cold for the LayerNorms), bounds, plain and library
    times (``F.layer_norm``; SDPA ``is_causal``) at the training step's
    shapes, bf16."""
    from paddle_tpu_torch.testing import LN_TOL, rms_close
    h, eps = GPT2_XL["hidden_size"], GPT2_XL["layer_norm_epsilon"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    report = {"layer_norm": {}, "flash": {}}
    for dt, kind in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        tol = LN_TOL[dt]
        for rows in (GPT_TRAIN_B * GPT_TRAIN_S, 8):
            x = (2 * torch.randn(rows, h, generator=gen, device="cuda")
                 + 0.5).to(dt)
            g = torch.randn(rows, h, generator=gen, device="cuda").to(dt)
            w = (1 + 0.1 * torch.randn(h, generator=gen,
                                       device="cuda")).to(dt)
            b = (0.1 * torch.randn(h, generator=gen, device="cuda")).to(dt)
            y = ln.layer_norm_kernel(x, w, b, eps)
            dx, dw, db = ln.layer_norm_bwd_kernel(x, w, g, eps)
            torch.cuda.synchronize()
            pdx, pdw, pdb = ln.ln_bwd_plain(x, w, g, eps)
            r = dict(shape=[rows, h], eps=eps, max_abs_err=dict(
                fwd=rms_close(y, ln.ln_plain(x, w, b, eps), *tol["y"],
                              f"layer_norm h{h} {kind}"),
                bwd=max(rms_close(dx, pdx, *tol["dx"], "ln dx"),
                        rms_close(dw, pdw, *tol["sums"], "ln dw"),
                        rms_close(db, pdb, *tol["sums"], "ln db"))))
            if rows > 8 and kind == "bf16":
                isz = x.element_size()
                copies = _l2_cold((x, g))
                nxt = itertools.cycle(copies).__next__
                fb, fby = bound_ms(2 * rows * h * isz + 2 * h * isz,
                                   8 * rows * h, "fp32")
                bb, bby = bound_ms(3 * rows * h * isz + 3 * h * isz,
                                   20 * rows * h, "fp32")
                r.update(
                    fwd=dict(ms=device_ms(torch, lambda: ln.layer_norm_kernel(
                        nxt()[0], w, b, eps)), bound_ms=fb, bound_by=fby,
                        plain_ms=device_ms(torch, lambda: ln.ln_plain(
                            x, w, b, eps), iters=5, replays=2),
                        library_ms=device_ms(torch, lambda: torch.nn.
                                             functional.layer_norm(
                                                 nxt()[0], (h,), w, b,
                                                 eps))),
                    bwd=dict(ms=device_ms(torch, lambda: ln.
                                          layer_norm_bwd_kernel(
                                              *(lambda c: (c[0], w, c[1]))(
                                                  nxt()), eps)),
                             launch=ln.ln_bwd_config(
                                 rows, h, torch.cuda.get_device_properties(
                                     0).multi_processor_count)._asdict(),
                             bound_ms=bb, bound_by=bby,
                             plain_ms=device_ms(torch, lambda: ln.
                                                ln_bwd_plain(x, w, g, eps),
                                                iters=5, replays=2),
                             library_ms=_ln_library_bwd_ms(
                                 torch, copies, w, b, eps)))
                del copies, nxt
            report["layer_norm"][f"rows{rows}_{kind}"] = r
            del x, g, w, b, y, dx, dw, db, pdx, pdw, pdb
        torch.cuda.empty_cache()
    nh, d = GPT2_XL["num_attention_heads"], 64
    sc = 1.0 / math.sqrt(d)
    for name, bh, s, dt in (
            ("train_bf16", GPT_TRAIN_B * nh, GPT_TRAIN_S, torch.bfloat16),
            ("prefill_bf16", 8 * nh, 512, torch.bfloat16),
            ("prompt37_bf16", 2 * nh, 37, torch.bfloat16),
            ("prompt37_fp32", 2 * nh, 37, torch.float32),
            ("train_fp32", 8, GPT_TRAIN_S, torch.float32)):
        q, k, v, do = _flash_inputs(torch, bh, s, d, dt)
        report["flash"][name] = dict(bh=bh, s=s, **_flash_check(
            torch, fa, f"gpt {name}", q, k, v, do, (sc, True, None, 0, 1)))
        del q, k, v, do
        torch.cuda.empty_cache()
    # times at the training step's shape: (B·nh, S, d) = (100, 1024, 64)
    bh, s = GPT_TRAIN_B * nh, GPT_TRAIN_S
    q, k, v, do = _flash_inputs(torch, bh, s, d, torch.bfloat16)
    out, lse = fa.flash_fwd_kernel(q, k, v, sc, True)
    delta = fa._delta(out, do)
    mat, row, pairs = bh * s * d * 2, bh * s * 4, bh * s * (s + 1) / 2
    times = {}
    for key, fn, nbytes, ops in (
            ("fwd", lambda: fa.flash_fwd_kernel(q, k, v, sc, True),
             4 * mat + row, 4 * d * pairs),
            ("dq", lambda: fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta,
                                                  sc, True),
             5 * mat + 2 * row, 6 * d * pairs),
            ("dkv", lambda: fa.flash_bwd_dkv_kernel(q, k, v, do, lse, delta,
                                                    sc, True),
             6 * mat + 2 * row, 8 * d * pairs)):
        times[key] = dict(ms=device_ms(torch, fn, iters=10, replays=3))
        times[key]["bound_ms"], times[key]["bound_by"] = bound_ms(
            nbytes, ops, "bf16")
    times["fwd"]["plain_ms"] = eager_ms(torch, lambda: fa.flash_fwd_plain(
        q, k, v, sc, True), iters=2, warmup=1)
    times["dq"]["plain_ms"] = times["dkv"]["plain_ms"] = eager_ms(
        torch, lambda: fa.flash_bwd_plain(q, k, v, out, lse, do, sc, True),
        iters=2, warmup=1)
    q4, k4, v4, do4 = (t.reshape(GPT_TRAIN_B, nh, s, d)
                       for t in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times["fwd"]["library_ms"] = device_ms(
        torch, lambda: sdpa(q4, k4, v4, is_causal=True))
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q4, k4, v4))
    times["dq"]["library_ms"] = times["dkv"]["library_ms"] = backward_ms(
        torch, lambda: torch.autograd.grad(
            sdpa(ql, kl, vl, is_causal=True), (ql, kl, vl), do4),
        lambda: sdpa(ql, kl, vl, is_causal=True), iters=5)
    report["flash"]["train_shape_times"] = dict(bh=bh, s=s, d=d, **times)
    del q, k, v, do, out, lse, delta, q4, k4, v4, do4, ql, kl, vl
    torch.cuda.empty_cache()
    return report


def gpt2_xl_phase(torch, G, ftb, ln, fa):
    """GPT-2 XL at its published widths (``GPT2_XL``; nothing cut), bf16,
    seeded random weights. (a) ``generate`` at the reference's ``decode``
    workload shape (8 prompts of 512 tokens, 128 new): the prefill's
    and the whole call's wall (decode tokens/s = 8·127 / (call -
    prefill)), a profiled decode step's device time by kind (matmul,
    the cached attention from a profile of one layer's
    ``_decode_attention`` at the step's shapes times L, LayerNorm,
    other) and idle share, the mean step against its HBM bound (every
    weight and the valid K/V of the mean step read once), peak memory,
    launches checked (flash forward L in the prefill, LayerNorm forward
    2L + 1 a forward), and the share of generated tokens equal to a full
    re-forward's argmax (reported). (b) Training: a (4, 1024) batch
    through ``compute_loss``, backward and ``AdamW(multi_precision=
    True)`` (fp32 master weights and moments), 2 warm-up and 3 timed
    steps, the loss falling, every step's launches checked, tokens/s,
    MFU, peak memory and a profiled step's breakdown and idle share."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.optimizer.adamw import AdamW
    cfg = G.GPTConfig(**GPT2_XL)
    n_layers, h, nh = (cfg.num_hidden_layers, cfg.hidden_size,
                       cfg.num_attention_heads)
    d = h // nh
    counters = _gpt_counters(ln, fa)
    t0 = time.perf_counter()
    model = G.init(G.GPTForCausalLM(cfg, dtype=torch.bfloat16,
                                    device="cuda"), SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    rng = np.random.RandomState(SEED)
    ids = rng.randint(0, cfg.vocab_size, (GEN_B, GEN_T)).astype(np.int64)
    ids_t = torch.from_numpy(ids).cuda()
    s_max = GEN_T + GEN_NEW
    model.generate(ids, max_new_tokens=2)         # first use of each kernel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    with torch.no_grad():
        _reset(counters)
        t0 = time.perf_counter()
        logits, kv = model(ids_t, gen_cache_len=s_max)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        _check_launches("gpt-2 xl prefill", counters, _gpt_want(n_layers))
        # a decode step's wall and device time by kind, at time_step 512
        step = logits[:, -1].float().argmax(-1)[:, None]
        del logits
        n_prof = 4

        def steps():
            for i in range(n_prof):
                model(step, caches=kv, time_step=GEN_T + i)

        steps()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        step_wall = (time.perf_counter() - t0) * 1e3 / n_prof
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            steps()
            torch.cuda.synchronize()
        kinds, top = _kernel_ms_by_kind(prof, GPT_GEN_KINDS, n_top=8)
        kinds = {k: v / n_prof for k, v in kinds.items()}
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        q = torch.randn((GEN_B, nh, 1, d), generator=gen,
                        device="cuda").to(torch.bfloat16)
        attn = kernel_breakdown_ms(
            torch, lambda: ftb._decode_attention(q, kv[0, 0], kv[0, 1],
                                                 GEN_T + 1), GPT_GEN_KINDS)
        del kv, q
    torch.cuda.empty_cache()
    busy = sum(kinds.values())
    step_kinds = dict(
        matmul=kinds["matmul"] - n_layers * attn["matmul"],
        cached_attention=n_layers * sum(attn.values()),
        layer_norm_fwd=kinds["layer_norm_fwd"] - n_layers * attn[
            "layer_norm_fwd"],
        other=kinds["other"] - n_layers * attn["other"])

    _reset(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = model.generate(ids, max_new_tokens=GEN_NEW)
    call_ms = (time.perf_counter() - t0) * 1e3
    launches = _check_launches("gpt-2 xl generate", counters,
                               _gpt_want(n_layers, GEN_NEW))
    peak_gen = torch.cuda.max_memory_allocated() / 1e9
    if toks.shape != (GEN_B, GEN_NEW) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"gpt-2 xl generate: bad output {toks.shape}")
    # a full re-forward of prompt + generated: its argmax at each
    # generated position (bf16: reported, not asserted)
    with torch.no_grad():
        seq = torch.from_numpy(np.concatenate(
            [ids, toks[:, :-1].astype(np.int64)], axis=1)).cuda()
        ref = model(seq)[:, GEN_T - 1:].float().argmax(-1).cpu().numpy()
        del seq
    torch.cuda.empty_cache()
    decode_steps = GEN_NEW - 1
    decode_ms = (call_ms - prefill_ms) / decode_steps
    mean_len = GEN_T + GEN_NEW // 2          # valid keys of the mean step
    kv_bytes = 2 * n_layers * GEN_B * mean_len * h * 2
    bound, by = bound_ms(weight_bytes + kv_bytes, 2 * n_params * GEN_B,
                         "bf16")
    generate = dict(
        batch=GEN_B, prompt=GEN_T, new_tokens=GEN_NEW, prefill_ms=prefill_ms,
        call_ms=call_ms, decode_step_ms=decode_ms,
        decode_tokens_per_s=GEN_B * decode_steps / (call_ms - prefill_ms)
        * 1e3,
        profiled_step=dict(at=GEN_T, wall_ms=step_wall, kernel_ms=step_kinds,
                           device_busy_ms=busy,
                           idle_share=1 - busy / step_wall,
                           cached_attention_one_layer_ms=attn,
                           top_kernels=top),
        step_bound_ms=bound, step_bound_by=by,
        step_bytes=dict(weights=weight_bytes, kv=kv_bytes),
        step_vs_bound=decode_ms / bound, peak_mem_gb=peak_gen,
        launches=launches,
        equal_to_reforward_argmax=float((ref == toks).mean()))

    torch.cuda.reset_peak_memory_stats()
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                weight_decay=0.01, multi_precision=True)
    batch = rng.randint(0, cfg.vocab_size,
                        (GPT_TRAIN_B, GPT_TRAIN_S)).astype(np.int64)
    labels = np.roll(batch, -1, axis=1)
    labels[:, -1] = -100
    batch, labels = (torch.from_numpy(a).cuda() for a in (batch, labels))
    want = _gpt_want(n_layers, train_steps=1)

    def train_step():
        opt.clear_grad()
        loss = model.compute_loss(batch, labels)
        loss.backward()
        opt.step()
        return loss

    losses, step_ms, totals = [], [], {k: 0 for k in counters}
    for i in range(5):                       # 2 warm-up + 3 timed steps
        _reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(train_step()))  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for k, n in _check_launches(f"gpt-2 xl train step {i}", counters,
                                    want).items():
            totals[k] += n
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"gpt-2 xl losses did not fall: {losses}")
    peak_train = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_step()
        torch.cuda.synchronize()
    t_kinds, t_top = _kernel_ms_by_kind(prof, GPT_KINDS, n_top=10)
    t_busy = sum(t_kinds.values())
    mean_ms = float(np.mean(step_ms[2:]))
    tokens = GPT_TRAIN_B * GPT_TRAIN_S
    # 6 FLOPs per parameter and token (forward and backward), plus causal
    # attention: 12·L·h·S² a sequence for the full square, halved
    flops = 6.0 * n_params * tokens + 6.0 * n_layers * h * GPT_TRAIN_B \
        * GPT_TRAIN_S ** 2
    train = dict(
        batch=[GPT_TRAIN_B, GPT_TRAIN_S], lr=1e-4, weight_decay=0.01,
        multi_precision=True, remat="none", losses=losses, step_ms=step_ms,
        mean_step_ms=mean_ms, tokens_per_s=tokens / (mean_ms / 1e3),
        flops_per_step=flops,
        flops_counted="6·N·tokens + 6·L·h·B·S² (causal attention)",
        mfu_vs_989tflops=flops / (mean_ms / 1e3) / PEAK_OPS_PER_S["bf16"],
        peak_mem_gb=peak_train, launches_per_step=want, launches=totals,
        breakdown=dict(kernel_ms=t_kinds, top_kernels=t_top,
                       device_busy_ms=t_busy, wall_ms=mean_ms,
                       idle_share=1 - t_busy / mean_ms))
    launch_sum = {k: launches.get(k, 0) + totals[k]
                  + _gpt_want(n_layers)[k] for k in counters}
    del model, opt, batch, labels
    gc.collect()
    torch.cuda.empty_cache()
    return dict(config="openai-community/gpt2-xl config.json", reduced="nothing",
                params=n_params, weight_gb=weight_bytes / 1e9, init_s=init_s,
                generate=generate, train=train, launches=launch_sum)


# ---------------------------------------------------------------------------
# phases 27-29: the training recipe's eager API, and postmortem replay
# ---------------------------------------------------------------------------

#: phase 27's optimizer families: (class, keyword arguments)
RECIPE_FAMILIES = {
    "sgd": ("SGD", dict(weight_decay=0.01)),
    "momentum": ("Momentum", dict(momentum=0.9, use_nesterov=True,
                                  weight_decay=0.01)),
    "adam": ("Adam", dict(weight_decay=0.01)),
    "adamw": ("AdamW", dict(weight_decay=0.01)),
    "adamax": ("Adamax", dict(weight_decay=0.01)),
    "lamb": ("Lamb", dict(lamb_weight_decay=0.01)),
    "rmsprop": ("RMSProp", dict(centered=True, momentum=0.5)),
    "adagrad": ("Adagrad", dict(initial_accumulator_value=0.1)),
}


def _no_decay(name):
    """The recipe's decay filter: no decay on biases and norms."""
    return not any(k in name for k in ("bias", "ln_", "norm"))


def _recipe_schedule(LR, peak, total):
    """The recipe's schedule: 2 warm-up steps from peak/10 to peak, then
    a cosine over ``total`` steps."""
    return LR.LinearWarmup(LR.CosineAnnealingDecay(peak, total), 2,
                           peak / 10, peak)


def _recipe_family(torch, O, LR, cls, kw, params, lr):
    extra = {}
    if cls == "AdamW":
        extra["apply_decay_param_fun"] = _no_decay
    elif cls == "Lamb":
        extra["exclude_from_weight_decay_fn"] = lambda p: p.dim() < 2
    return getattr(O, cls)(learning_rate=_recipe_schedule(LR, lr, 10),
                           parameters=params,
                           grad_clip=O.ClipGradByGlobalNorm(1.0),
                           **kw, **extra)


def _legacy_moved_streams(torch, L, D, mode):
    """Two legacy replicas (``unified=False``, bf16, tiny widths) on the
    card: the streams of a ``"failover"`` (replica 0 killed mid-decode)
    or a ``"handoff"`` (PREFILL -> DECODE page handoff) run, each
    request's tokens at its move, and a single engine's streams (the
    uninterrupted run)."""
    from paddle_tpu_torch.resilience import Fault, FaultInjector
    import paddle_tpu_torch.serving as S
    cfg = L.llama_tiny(hidden_size=512, num_attention_heads=8,
                       num_key_value_heads=8, intermediate_size=1024,
                       num_hidden_layers=2, dtype=torch.bfloat16)
    params = L.init_params(cfg, seed=5, device="cuda")
    rng = np.random.RandomState(12)
    prompts = [rng.randint(1, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.randint(20, 120, size=8)]

    def engine():
        return D.ContinuousBatchingEngine(
            cfg, D.GenerationConfig(max_new_tokens=24), num_slots=4,
            page_size=16, max_seq_len=160, chunk=4, prefix_cache=True,
            device="cuda", unified=False)

    oracle = engine().serve(params, prompts)
    inj = FaultInjector()
    handles = [S.ReplicaHandle(i, engine(), health_config=S.HealthConfig(
        eject_after=1)) for i in range(2)]
    if mode == "handoff":
        router = S.DisaggRouter(handles, roles={0: S.ReplicaRole.PREFILL,
                                                1: S.ReplicaRole.DECODE})
    else:
        router = S.FleetRouter(handles, fault_injector=inj)
    reqs = [router.submit(p) for p in prompts]
    moved_at = {}
    if mode == "handoff":
        real = router._handoff

        def noted(req, src, dst):
            moved_at[req.rid] = list(req.stream.tokens)
            return real(req, src, dst)
        router._handoff = noted
    while router.pending:
        if mode == "failover" and not moved_at and any(
                r.replica_id == 0 and 0 < len(r.stream.tokens) < 24
                for r in reqs):
            moved_at = {r.rid: list(r.stream.tokens) for r in reqs
                        if r.replica_id == 0}
            inj.schedule.append(Fault("replica_die", router._steps + 1,
                                      replica=0))
        router.step(params)
    if any(r.state != "done" for r in reqs):
        raise AssertionError(f"legacy {mode}: states "
                             f"{[r.state for r in reqs]}")
    for h in handles:
        h.engine.mgr.check_conservation()
        if h.engine.mgr.num_live_pages:
            raise AssertionError(f"legacy {mode}: pages leaked")
    moved = [r.rid for r in reqs if r.rid in moved_at
             and (r.failovers or mode == "handoff")]
    return [r.stream.tokens for r in reqs], moved_at, moved, oracle


def recipe_parity_phase(torch, G, L, D, rn, pa, fa):
    """Phase 27: the eager training API on the card against the CPU.
    (a) Every optimizer family (fp32) over a tiny GPT's parameters, with
    the recipe's ``LinearWarmup(CosineAnnealingDecay)`` schedule,
    ``ClipGradByGlobalNorm(1.0)`` and decay filter, 3 steps: a CPU model
    gives each step's gradients, and the same gradients go to a card
    copy and a CPU copy of the weights, so the comparison holds the
    optimizers' own arithmetic (weights and every state slot within
    ``CARD_CPU_TOL``). (b) ``GradScaler`` with AdamW: a good step, then a
    gradient holding an inf: the step is skipped, weights and moments
    bitwise unchanged on the card, the scale halved, the scaler's state
    the CPU twin's. (c) Legacy replicas' bf16 continuations (a failover
    and a handoff) equal the uninterrupted streams (ROADMAP Queue C 4),
    with their kernels' launches."""
    from paddle_tpu_torch import amp as A
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.optimizer import lr as LR
    from paddle_tpu_torch.testing import CARD_CPU_TOL, close
    cfg = G.gpt_tiny(**GPT_TINY)
    model = G.init(G.GPTForCausalLM(cfg, device="cpu"), SEED)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.RandomState(SEED + 27)
    batch = rng.randint(0, cfg.vocab_size, (4, 48)).astype(np.int64)
    labels = np.roll(batch, -1, axis=1)
    labels[:, -1] = -100
    batch, labels = torch.from_numpy(batch), torch.from_numpy(labels)
    rtol, atol = CARD_CPU_TOL["out"]
    steps, lr = 3, 1e-3

    def load_start():
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
            model.zero_grad(set_to_none=True)

    def card_copy():
        return [(n, torch.nn.Parameter(w.to("cuda", copy=True)))
                for n, w in start.items()]

    families = {}
    for fam, (cls, kw) in RECIPE_FAMILIES.items():
        load_start()
        cpu = _recipe_family(torch, O, LR, cls, kw,
                             list(model.named_parameters()), lr)
        card_params = card_copy()
        card = _recipe_family(torch, O, LR, cls, kw, card_params, lr)
        for i in range(steps):
            model.zero_grad(set_to_none=True)
            model.compute_loss(batch, labels).backward()
            for (_, p), q in zip(card_params, model.parameters()):
                p.grad = q.grad.to("cuda", copy=True)
            cpu.step()
            card.step()
            for o in (cpu, card):
                o._learning_rate.step()
        errs = {"weights": 0.0, "state": 0.0}
        for (name, p), q in zip(card_params, model.parameters()):
            errs["weights"] = max(errs["weights"], close(
                p.detach().cpu(), q.detach(), rtol, atol,
                f"{fam} {name}"))
            cs, ks = card.state[name], cpu.state[name]
            if set(cs) != set(ks):
                raise AssertionError(f"{fam} {name}: slots {sorted(cs)} "
                                     f"!= {sorted(ks)}")
            for slot in ks:
                errs["state"] = max(errs["state"], close(
                    cs[slot].cpu(), ks[slot], rtol, atol,
                    f"{fam} {name}.{slot}"))
        families[fam] = dict(max_abs_err=errs, slots=sorted(
            cpu.state[cpu._names[0]]), lr_after=card.get_lr())

    # (b) the loss scaler: a good step, then an inf
    load_start()
    card_params = card_copy()
    sides = {"cuda": (card_params, O.AdamW(learning_rate=lr,
                                           parameters=card_params)),
             "cpu": (list(model.named_parameters()),
                     O.AdamW(learning_rate=lr,
                             parameters=list(model.named_parameters())))}
    scalers = {dev: A.GradScaler(init_loss_scaling=2.0 ** 10,
                                 decr_every_n_nan_or_inf=1)
               for dev in sides}
    scaler_trace = []
    for i, bad in enumerate([False, True]):
        model.zero_grad(set_to_none=True)
        scalers["cpu"].scale(model.compute_loss(batch, labels)).backward()
        grads = [q.grad.clone() for q in model.parameters()]
        if bad:
            grads[3].view(-1)[5] = float("inf")
            before = [p.detach().clone() for _, p in card_params]
            moments = {n: {k: v.clone() for k, v in s.items()}
                       for n, s in sides["cuda"][1].state.items()}
        for dev, (params, opt) in sides.items():
            for (_, p), g in zip(params, grads):
                p.grad = g.to(dev, copy=True)
            scalers[dev].step(opt)
            scalers[dev].update()
        if scalers["cuda"].state_dict() != scalers["cpu"].state_dict():
            raise AssertionError("scaler state: card "
                                 f"{scalers['cuda'].state_dict()} != cpu "
                                 f"{scalers['cpu'].state_dict()}")
        scaler_trace.append(scalers["cuda"].state_dict())
    card_opt = sides["cuda"][1]
    if not all(torch.equal(a, p.detach())
               for a, (_, p) in zip(before, card_params)):
        raise AssertionError("the inf step changed a weight")
    if not all(torch.equal(v, card_opt.state[n][k])
               for n, s in moments.items() for k, v in s.items()):
        raise AssertionError("the inf step changed a moment")
    if card_opt.step_count != 1 or scaler_trace[-1]["scale"] != 2.0 ** 9:
        raise AssertionError(f"scaler trace {scaler_trace}")
    scaler = dict(trace=scaler_trace, skipped_step_bitwise=True,
                  weights_max_abs_err=max(
                      close(p.detach().cpu(), q.detach(), rtol, atol,
                            f"scaler {n}")
                      for (n, p), q in zip(card_params, model.parameters())),
                  host_reads=scalers["cuda"].host_reads)
    del sides, card_params, card_opt

    # (c) Queue C 4: legacy continuations at bf16
    counters = {"rms_norm_fwd": rn.rms_norm,
                "paged_decode_attention": pa.paged_attention,
                "flash_attention_fwd": fa.flash_fwd_kernel}
    _reset(counters)
    legacy = {}
    for mode in ("failover", "handoff"):
        got, moved_at, moved, oracle = _legacy_moved_streams(torch, L, D,
                                                             mode)
        after = [(got[r][len(moved_at[r]):], oracle[r][len(moved_at[r]):])
                 for r in moved]
        share, eq, n = _equal_share(after)
        if not moved or got != oracle:
            raise AssertionError(f"legacy {mode}: {eq} of {n} tokens after "
                                 f"the move equal ({len(moved)} moved)")
        legacy[mode] = dict(moved_requests=len(moved),
                            equal_after_move=share,
                            equal_after_move_tokens=[eq, n])
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    if not all(launches.values()):
        raise AssertionError(f"legacy continuations: launches {launches}")
    _free_card(torch)
    return dict(families=families, steps=steps, scaler=scaler,
                legacy_bf16=legacy, launches=launches)


def _digest(torch, tensors):
    """Bit-pattern sums of a list of tensors (int64, on the device): a
    change of any one element changes its tensor's sum."""
    out = []
    for t in tensors:
        bits = t.detach().view({2: torch.int16, 4: torch.int32}[
            t.element_size()])
        out.append(bits.sum(dtype=torch.int64))
    return torch.stack(out)


def gpt2_xl_recipe_phase(torch, G, ln, fa, plain):
    """Phase 28: GPT-2 XL (phase 26's config and (4, 1024) batches) with
    the reference's training recipe: ``amp.decorate(level="O2",
    dtype="bfloat16")`` over the fp32 model, ``AdamW(learning_rate=
    LinearWarmup(CosineAnnealingDecay), grad_clip=ClipGradByGlobalNorm(
    1.0), apply_decay_param_fun=<no decay on biases and norms>)`` and
    ``GradScaler(enable=True, decr_every_n_nan_or_inf=1)``: 2 warm-up
    and 5 timed steps (each step's launches checked), the step's wall,
    tokens/s, MFU, peak memory and a profiled step's idle share beside
    phase 26's plain-AdamW step (``plain``), the unscale's and the
    clip's device ms, the card reads a step (sync-debug warnings), the
    loss curve. Then one step whose gradient holds an inf: it changes no
    weight, master or moment (bit-pattern sums of every tensor, and
    three tensors compared whole) and halves the scale. Then the
    optimizer's, scheduler's and scaler's state go through host memory
    into fresh objects: the next step from the restored weights gives
    the uninterrupted run's weights bit for bit."""
    import warnings
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import amp as A
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.optimizer import lr as LR
    cfg = G.GPTConfig(**GPT2_XL)
    n_layers, h = cfg.num_hidden_layers, cfg.hidden_size
    counters = _gpt_counters(ln, fa)
    peak_lr = 1e-4
    t0 = time.perf_counter()
    model = G.init(G.GPTForCausalLM(cfg, device="cuda"), SEED)
    named = list(model.named_parameters())

    def recipe():
        sched = _recipe_schedule(LR, peak_lr, 100)
        opt = O.AdamW(learning_rate=sched, parameters=named,
                      grad_clip=O.ClipGradByGlobalNorm(1.0),
                      apply_decay_param_fun=_no_decay, weight_decay=0.01)
        return sched, opt, A.GradScaler(enable=True,
                                        decr_every_n_nan_or_inf=1)

    sched, opt, scaler = recipe()
    model, opt = A.decorate(models=model, optimizers=opt, level="O2",
                            dtype="bfloat16")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for _, p in named)
    if any(p.dtype != torch.bfloat16 for _, p in named) \
            or not opt._multi_precision:
        raise AssertionError("amp.decorate(O2) did not cast the model")
    rng = np.random.RandomState(SEED + 28)
    batch = rng.randint(0, cfg.vocab_size,
                        (GPT_TRAIN_B, GPT_TRAIN_S)).astype(np.int64)
    labels = np.roll(batch, -1, axis=1)
    labels[:, -1] = -100
    batch, labels = (torch.from_numpy(a).cuda() for a in (batch, labels))
    want = _gpt_want(n_layers, train_steps=1)

    def backward(scaler):
        model.zero_grad(set_to_none=True)
        loss = model.compute_loss(batch, labels)
        scaler.scale(loss).backward()
        return loss.detach()

    def finish(scaler, sched, opt):
        scaler.step(opt)
        scaler.update()
        sched.step()

    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, totals = [], [], {k: 0 for k in counters}
    for i in range(7):                        # 2 warm-up + 5 timed steps
        _reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = backward(scaler)
        finish(scaler, sched, opt)
        losses.append(float(loss))           # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for k, n in _check_launches(f"gpt-2 xl recipe step {i}", counters,
                                    want).items():
            totals[k] += n
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"gpt-2 xl recipe losses did not fall: "
                             f"{losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9

    # one step with its card reads counted (sync-debug warnings, by the
    # line that raised them; a site an empty window raises too is the
    # mode switch's own), one profiled; the unscale and the clip timed
    # apart with CUDA events
    def sync_sites(fn):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, ["/".join(w.filename.split(os.sep)[-3:])
                     + f":{w.lineno}" for w in caught
                     if "synchroniz" in str(w.message)]

    def recipe_step():
        loss = backward(scaler)
        finish(scaler, sched, opt)
        return loss

    _, empty = sync_sites(lambda: None)
    loss, reads = sync_sites(recipe_step)
    losses.append(float(loss))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = backward(scaler)
        finish(scaler, sched, opt)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    losses.append(float(loss))
    kinds, top = _kernel_ms_by_kind(prof, GPT_KINDS, n_top=10)
    busy = sum(kinds.values())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    loss = backward(scaler)
    ev[0].record()
    scaler.unscale_(opt)
    ev[1].record()
    pairs = [(p, g) for (_, p), g in zip(named, scaler._unscaled)
             if g is not None]
    ev[2].record()
    clipped = opt._grad_clip(pairs)
    ev[3].record()
    torch.cuda.synchronize()
    unscale_ms, clip_ms = ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3])
    del pairs, clipped
    finish(scaler, sched, opt)
    losses.append(float(loss))

    # the inf step: nothing moves, the scale halves
    backward(scaler)
    named[0][1].grad.view(-1)[7] = float("inf")
    state = opt.state
    keep = [named[0][0], named[len(named) // 2][0], named[-1][0]]
    whole = {n: [dict(named)[n].detach().clone()]
             + [v.clone() for v in state[n].values()] for n in keep}
    flat = [p for _, p in named] + [v for n, _ in named
                                    for v in state[n].values()]
    d0 = _digest(torch, flat)
    scale0, steps0 = scaler.get_loss_scaling(), opt.step_count
    finish(scaler, sched, opt)
    if not torch.equal(d0, _digest(torch, flat)) or not all(
            torch.equal(a, b) for n in keep for a, b in zip(
                whole[n], [dict(named)[n]] + list(state[n].values()))):
        raise AssertionError("the inf step changed a weight or a moment")
    if scaler.get_loss_scaling() != scale0 / 2 or opt.step_count != steps0:
        raise AssertionError(f"inf step: scale {scaler.get_loss_scaling()} "
                             f"(was {scale0}), step {opt.step_count}")
    del whole, flat

    # resume: state through host memory into fresh objects
    def host(t):
        return t.detach().to("cpu", copy=True)

    saved = {k: (host(v) if isinstance(v, torch.Tensor) else v)
             for k, v in opt.state_dict().items()}
    saved_sched, saved_scaler = sched.state_dict(), scaler.state_dict()
    start = {n: host(p) for n, p in named}
    t0 = time.perf_counter()
    backward(scaler)
    grads = _digest(torch, [p.grad for _, p in named])
    finish(scaler, sched, opt)
    ref_digest = _digest(torch, [p for _, p in named])
    ref_whole = {n: host(dict(named)[n]) for n in keep}
    del opt, state
    gc.collect()
    with torch.no_grad():
        for n, p in named:
            p.copy_(start[n])
    sched2, opt2, scaler2 = recipe()
    _, opt2 = A.decorate(models=model, optimizers=opt2, level="O2",
                         dtype="bfloat16")
    opt2.set_state_dict(saved)
    sched2.set_state_dict(saved_sched)
    scaler2.load_state_dict(saved_scaler)
    restore_s = time.perf_counter() - t0
    backward(scaler2)
    grads2 = _digest(torch, [p.grad for _, p in named])
    finish(scaler2, sched2, opt2)
    torch.cuda.synchronize()
    equal_grads = bool(torch.equal(grads, grads2))
    if not torch.equal(ref_digest, _digest(torch, [p for _, p in named])) \
            or not all(torch.equal(ref_whole[n], dict(named)[n].cpu())
                       for n in keep):
        raise AssertionError(f"resumed weights differ from the "
                             f"uninterrupted run's (gradients equal: "
                             f"{equal_grads})")
    mean_ms = float(np.mean(step_ms[2:]))
    tokens = GPT_TRAIN_B * GPT_TRAIN_S
    flops = 6.0 * n_params * tokens + 6.0 * n_layers * h * GPT_TRAIN_B \
        * GPT_TRAIN_S ** 2
    out = dict(
        recipe=dict(amp="decorate O2 bf16", optimizer="AdamW wd 0.01",
                    lr="LinearWarmup(2 steps, 1e-5 -> 1e-4) then "
                       "CosineAnnealingDecay(1e-4, T_max 100)",
                    grad_clip="ClipGradByGlobalNorm(1.0)",
                    decay_filter="none on biases and norms",
                    scaler="GradScaler(2^16, decr_every_n_nan_or_inf=1)"),
        init_s=init_s, losses=losses, step_ms=step_ms, mean_step_ms=mean_ms,
        tokens_per_s=tokens / (mean_ms / 1e3),
        mfu_vs_989tflops=flops / (mean_ms / 1e3) / PEAK_OPS_PER_S["bf16"],
        plain_adamw_step_ms=plain["mean_step_ms"],
        plain_adamw_tokens_per_s=plain["tokens_per_s"],
        peak_mem_gb=peak, plain_peak_mem_gb=plain["peak_mem_gb"],
        unscale_ms=unscale_ms, clip_ms=clip_ms,
        card_reads_per_step=sum(r not in empty for r in reads),
        card_reads=reads, card_reads_empty_window=empty,
        breakdown=dict(kernel_ms=kinds, top_kernels=top,
                       device_busy_ms=busy, wall_ms=prof_wall,
                       idle_share=1 - busy / prof_wall),
        inf_step=dict(weights_moments_unchanged=True,
                      scale_before=scale0,
                      scale_after=scaler.get_loss_scaling()),
        resume=dict(bitwise_equal=True, gradients_equal=equal_grads,
                    state_tensors=len(saved) - 2, restore_s=restore_s),
        launches_per_step=want, launches=totals)
    del model, opt2, named, batch, labels, saved, start
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 32: GPT-2 XL's recipe through ResilientTrainer (checkpoints, a
# preemption, a corrupt shard, a NaN rollback)
# ---------------------------------------------------------------------------

#: the durable checkpoints of phase 32 (under the gitignored ``build/``)
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "smoke_checkpoints")
RESILIENT_STEPS = 6
#: GPT-2 XL's widths cut to 4 of its 48 layers: the card's machine allows
#: a call 45 GiB of disk writes (deleted files count), and the phase's
#: five saves of the whole model's 21.8 GB TrainState would write 109 GB;
#: at 4 layers a save is 2.8 GB (the embeddings and 4 layers, 14 bytes a
#: parameter). 8 layers (4.6 GB a save) made this phase ~87 s of a smoke
#: that must stay inside its time limit.
RESILIENT_LAYERS = 4


class _IOLog:
    """Times the checkpoint path from outside: each save's stall (the
    trainer's ``save``), host snapshot, commit and its CRC passes, each
    load's target build, read and verify and its copy onto the card.
    Wraps module attributes and puts them back on ``close``."""

    def __init__(self, R, U):
        self.saves, self.loads, self.stalls = [], [], []
        self._snap_ms = None
        self._tls = threading.local()
        self._undo = []
        D = R.durable
        self._wrap(U, "file_crc32", self._crc)
        self._wrap(D, "host_snapshot", self._snapshot)
        self._wrap(D, "_commit", self._commit)
        self._wrap(D, "_target_from_metadata", self._target)
        self._wrap(D, "load_state_dict", self._load)

    def trainer(self, tr):
        """``tr`` with its ``save`` timed: the training loop's stall."""
        real = tr.save

        def save(block=False):
            t0 = time.perf_counter()
            try:
                return real(block)
            finally:
                self.stalls.append(dict(
                    step=tr.state.global_step, block=bool(block),
                    stall_ms=(time.perf_counter() - t0) * 1e3,
                    snapshot_ms=self._snap_ms))
        tr.save = save
        return tr

    def _wrap(self, mod, name, make):
        real = getattr(mod, name)
        setattr(mod, name, make(real))
        self._undo.append((mod, name, real))

    def close(self):
        for mod, name, real in reversed(self._undo):
            setattr(mod, name, real)

    def _timed(self, rec, key, fn, *a):
        t0 = time.perf_counter()
        prev = getattr(self._tls, "rec", None)
        self._tls.rec = rec
        try:
            return fn(*a)
        except Exception as e:
            rec["error"] = type(e).__name__
            raise
        finally:
            rec[key] = time.perf_counter() - t0
            self._tls.rec = prev

    def _crc(self, real):
        def f(path, *a):
            t0 = time.perf_counter()
            try:
                return real(path, *a)
            finally:
                rec = getattr(self._tls, "rec", None)
                if rec is not None:
                    rec["crc_s"] = rec.get("crc_s", 0.0) \
                        + time.perf_counter() - t0
        return f

    def _snapshot(self, real):
        def f(sd):
            t0 = time.perf_counter()
            out = real(sd)
            self._snap_ms = (time.perf_counter() - t0) * 1e3
            return out
        return f

    def _commit(self, real):
        def f(snapshot, root, step, keep, fi=None):
            rec = dict(step=int(step), thread=threading.current_thread().name)
            self.saves.append(rec)
            return self._timed(rec, "write_s", real, snapshot, root, step,
                               keep, fi)
        return f

    def _target(self, real):
        def f(meta):
            rec = dict()
            self.loads.append(rec)
            return self._timed(rec, "target_s", real, meta)
        return f

    def _load(self, real):
        def f(target, path, *a):
            rec = self.loads[-1]
            rec["path"] = os.path.basename(path)
            return self._timed(rec, "read_verify_s", real, target, path, *a)
        return f


def _resilient_digest(torch, named, opt, sched, scaler):
    """Bit-pattern sums of every weight and every optimizer state tensor
    (master, moments) in parameter order, and the scalar state."""
    flat = [p for _, p in named] + [opt.state[n][k] for n, _ in named
                                    for k in sorted(opt.state[n])]
    return dict(digest=_digest(torch, flat).cpu(), step=opt.step_count,
                sched=sched.state_dict(),
                lr=opt.state_dict().get("LR_Scheduler"),
                scale=scaler.get_loss_scaling())


def gpt2_xl_resilience_phase(torch, G, ln, fa):
    """Phase 32: GPT-2 XL's widths (phase 26's config cut to
    ``RESILIENT_LAYERS`` layers by the machine's disk-write allowance;
    (4, 1024) batches) under phase 28's recipe, driven by
    ``ResilientTrainer``. The
    step's batch is a pure function of its index, so a replay retraces
    it. (1) The free space under ``build/`` must hold three checkpoints
    (``keep=2`` and a staging directory). (2) Six steps in a plain loop,
    no trainer and no save: the digest of every weight, master and
    moment, the scheduler's state and the scale. (3) The chaos run with
    fresh objects (``save_interval=2``, ``keep=2``, async saves, one
    ``ResilienceMetrics`` for both trainers): a seed save at step 0, an
    async save at 2, a preemption at step 2 through the real SIGTERM
    path (step 2 finishes, the flush saves ``step_3``, ``Preempted``), a
    ``truncate_shard`` fault corrupting that flush; then a new model,
    optimizer, scheduler and scaler from another seed resume, skip the
    corrupt ``step_3`` and restore ``step_2``; an async save at 4, a NaN
    at 4 rolled back to ``step_4`` and replayed; the final save at 6.
    Asserts: the final state bitwise the plain run's, the counters, each
    step's row 5, 6 and 8 launches, the scale (the scaler is outside
    ``TrainState``, as in the reference; no step overflows), the card
    back within 0.1 GB and no checkpoint left. Reports the checkpoint's
    bytes, each save's stall, snapshot, write s and GB/s and CRC share,
    each load's s and GB/s (read and verify, copy onto the card), the
    step wall with an async write in flight against without, the chaos
    run's wall against the plain run's, peak memory and goodput's
    buckets."""
    import signal
    from paddle_tpu_torch import amp as A
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch import resilience as R
    from paddle_tpu_torch.distributed.checkpoint import (TrainState,
                                                         flatten_state_dict)
    from paddle_tpu_torch.distributed.checkpoint import utils as U
    from paddle_tpu_torch.optimizer import lr as LR
    cfg = G.GPTConfig(**dict(GPT2_XL, num_hidden_layers=RESILIENT_LAYERS))
    n_layers = cfg.num_hidden_layers
    counters = _gpt_counters(ln, fa)
    want = _gpt_want(n_layers, train_steps=1)
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def build(seed):
        model = G.init(G.GPTForCausalLM(cfg, device="cuda"), seed)
        named = list(model.named_parameters())
        sched = _recipe_schedule(LR, 1e-4, 100)
        opt = O.AdamW(learning_rate=sched, parameters=named,
                      grad_clip=O.ClipGradByGlobalNorm(1.0),
                      apply_decay_param_fun=_no_decay, weight_decay=0.01)
        scaler = A.GradScaler(enable=True, decr_every_n_nan_or_inf=1)
        model, opt = A.decorate(models=model, optimizers=opt, level="O2",
                                dtype="bfloat16")
        return model, named, sched, opt, scaler

    def batch(i):
        rng = np.random.RandomState(SEED + 3200 + i)
        ids = rng.randint(0, cfg.vocab_size,
                          (GPT_TRAIN_B, GPT_TRAIN_S)).astype(np.int64)
        labels = np.roll(ids, -1, axis=1)
        labels[:, -1] = -100
        return (torch.from_numpy(ids).cuda(), torch.from_numpy(labels).cuda())

    walls, launches = [], {k: 0 for k in counters}

    def step_fn(objs, fi=None, trainer=None):
        model, _, sched, opt, scaler = objs

        def step(i):
            if fi is not None and fi.fire("nan", i):
                return float("nan")
            busy = bool(trainer and trainer[0]._pending is not None
                        and not trainer[0]._pending.done())
            ids, labels = batch(i)
            _reset(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.zero_grad(set_to_none=True)
            loss = model.compute_loss(ids, labels)
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            sched.step()
            torch.cuda.synchronize()
            # checked after the run: a raise here would be retried
            walls.append(dict(step=i, ms=(time.perf_counter() - t0) * 1e3,
                              write_in_flight=busy,
                              launches={k: c.launches
                                        for k, c in counters.items()}))
            return loss.detach()
        return step

    def check_steps(what):
        for w in walls:
            if w["launches"] != want:
                raise AssertionError(f"{what} step {w['step']}: launches "
                                     f"{w['launches']} != {want}")
            for k, n in w.pop("launches").items():
                launches[k] += n

    # (1) the disk: bf16 weights, fp32 masters and two fp32 moments
    t0 = time.perf_counter()
    objs = build(SEED)
    n_params = sum(p.numel() for _, p in objs[1])
    ckpt_bytes = n_params * (2 + 4 + 4 + 4)
    if os.path.exists(CKPT_DIR):
        shutil.rmtree(CKPT_DIR)
    os.makedirs(CKPT_DIR)
    free = shutil.disk_usage(CKPT_DIR).free
    need = 3 * ckpt_bytes + (2 << 30)
    if free < need:
        raise RuntimeError(
            f"phase 32 needs {need / 1e9:.1f} GB free under {CKPT_DIR} "
            f"(three {ckpt_bytes / 1e9:.1f} GB checkpoints: keep=2 and a "
            f"staging directory); {free / 1e9:.1f} GB are free")

    # (2) the plain run
    step = step_fn(objs)
    losses = [float(step(i)) for i in range(RESILIENT_STEPS)]
    plain_s = time.perf_counter() - t0
    check_steps("plain run")
    plain = _resilient_digest(torch, objs[1], objs[3], objs[2], objs[4])
    flat, _ = flatten_state_dict(
        TrainState(objs[0], objs[3], objs[2]).state_dict())
    state_bytes = sum(v.nbytes for v in flat.values()
                      if isinstance(v, torch.Tensor))
    del flat
    plain_walls = [w["ms"] for w in walls]
    del objs, step
    gc.collect()
    torch.cuda.empty_cache()

    # (3) the chaos run
    io = _IOLog(R, U)
    metrics = R.ResilienceMetrics()
    fi = R.FaultInjector([R.Fault("preempt", 2), R.Fault("truncate_shard", 3),
                          R.Fault("nan", 4)])
    rcfg = R.ResilienceConfig(checkpoint_dir=CKPT_DIR, save_interval=2,
                              keep=2, async_save=True, fault_injector=fi,
                              tokens_per_step=GPT_TRAIN_B * GPT_TRAIN_S)
    handler = signal.getsignal(signal.SIGTERM)
    walls.clear()
    try:
        t0 = time.perf_counter()
        objs = build(SEED)
        first = [io.trainer(R.ResilientTrainer(
            TrainState(objs[0], objs[3], objs[2]), rcfg, metrics))]
        try:
            first[0].run(step_fn(objs, fi, first), RESILIENT_STEPS)
            raise AssertionError("the preemption did not stop the run")
        except R.Preempted as e:
            preempted = dict(step=e.step,
                             checkpoint=os.path.basename(e.checkpoint))
        first_goodput = first[0].goodput.finalize(time.perf_counter() - t0)
        if signal.getsignal(signal.SIGTERM) is not handler:
            raise AssertionError("the trainer left its SIGTERM handler")
        del objs, first
        gc.collect()
        torch.cuda.empty_cache()
        objs = build(SEED + 1)
        ts = TrainState(objs[0], objs[3], objs[2])
        real_set = ts.set_state_dict

        def set_state_dict(state):
            t = time.perf_counter()
            real_set(state)
            torch.cuda.synchronize()
            io.loads[-1]["to_card_s"] = time.perf_counter() - t
        ts.set_state_dict = set_state_dict
        second = [io.trainer(R.ResilientTrainer(ts, rcfg, metrics))]
        res = second[0].run(step_fn(objs, fi, second), RESILIENT_STEPS)
        chaos_s = time.perf_counter() - t0
        got = _resilient_digest(torch, objs[1], objs[3], objs[2], objs[4])
    finally:
        io.close()
    check_steps("chaos run")
    counts = metrics.counters
    want_counts = dict(preemptions=1, preempt_flushes=1,
                       corrupt_checkpoints_skipped=1, nan_rollbacks=1)
    if any(counts.get(k) != v for k, v in want_counts.items()) \
            or counts.get("restores", 0) < 2:
        raise AssertionError(f"resilience counters {counts}")
    if preempted != dict(step=3, checkpoint="step_3") \
            or res["resumed_from"] != 2 or res["end_step"] != 6 \
            or res["skipped_steps"] != []:
        raise AssertionError(f"preempted {preempted}, run {res}")
    if not torch.equal(plain["digest"], got["digest"]) \
            or plain["step"] != got["step"] \
            or plain["sched"] != got["sched"] or plain["lr"] != got["lr"]:
        raise AssertionError(
            f"the chaos run's state differs from the plain run's: steps "
            f"{got['step']} vs {plain['step']}, schedulers {got['sched']} "
            f"vs {plain['sched']}, tensors equal "
            f"{torch.eq(plain['digest'], got['digest']).sum().item()} of "
            f"{plain['digest'].numel()}")
    if res["last_loss"] != losses[-1]:
        raise AssertionError(f"last loss {res['last_loss']} != {losses[-1]}")
    if got["scale"] != plain["scale"]:
        raise AssertionError(f"scale {got['scale']} != {plain['scale']}")
    saves = [s for s in io.saves if "error" not in s]
    loads = [r for r in io.loads if "error" not in r]
    failed = [r for r in io.loads if "error" in r]
    if [s["step"] for s in saves] != [0, 2, 3, 4, 6] or len(loads) != 2 \
            or len(failed) != 1 or failed[0]["path"] != "step_3":
        raise AssertionError(f"saves {io.saves}, loads {io.loads}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    on_disk = sum(os.path.getsize(os.path.join(r, f))
                  for r, _, fs in os.walk(CKPT_DIR) for f in fs)
    del objs, ts, second, set_state_dict, real_set
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR)
    getattr(torch._C, "_host_emptyCache", lambda: None)()  # pinned snapshots
    left = (torch.cuda.memory_allocated() - mem0) / 1e9
    if abs(left) > 0.1 or os.path.exists(CKPT_DIR):
        raise AssertionError(f"phase 32 left {left:.3f} GB on the card "
                             f"or a checkpoint under build/")
    gb = state_bytes / 1e9
    stalls = [st for st in io.stalls if st["snapshot_ms"] is not None]
    if [st["step"] for st in stalls] != [s["step"] for s in saves]:
        raise AssertionError(f"stalls {io.stalls} against saves {saves}")
    for s, st in zip(saves, stalls):
        s.update(stall_ms=st["stall_ms"], snapshot_ms=st["snapshot_ms"],
                 sync=st["block"],
                 write_gb_per_s=gb / s["write_s"],
                 crc_share=s.get("crc_s", 0.0) / s["write_s"])
    for r in loads:
        r.update(read_verify_gb_per_s=gb / r["read_verify_s"],
                 to_card_gb_per_s=gb / r["to_card_s"],
                 crc_share=r.get("crc_s", 0.0) / r["read_verify_s"])
    busy = [w["ms"] for w in walls if w["write_in_flight"]]
    idle = [w["ms"] for w in walls if not w["write_in_flight"]]
    return dict(
        card=card_line(), layers=n_layers, checkpoint_bytes=state_bytes,
        checkpoint_bytes_reckoned=ckpt_bytes, bytes_on_disk_at_end=on_disk,
        scaler="outside TrainState (as in the reference); no step "
               "overflows, so only its scale is compared",
        free_disk_gb=free / 1e9, losses=losses,
        saves=saves, loads=loads, failed_verify=failed,
        step_ms_write_in_flight=busy, step_ms_no_write=idle,
        plain_step_ms=plain_walls, plain_s=plain_s, chaos_s=chaos_s,
        peak_mem_gb=peak, counters=counts, preempted=preempted,
        resumed_from=res["resumed_from"],
        goodput=dict(first=first_goodput, second=res["goodput"]),
        step_timer=res["step_timer"], bitwise_equal=True,
        scale=got["scale"], launches_per_step=want, launches=launches)


def _rewrite_member(src, dst, name, data):
    """Copy a bundle tarball with one member's bytes replaced."""
    import io
    import os
    import tarfile
    with tarfile.open(src, "r:gz") as a, tarfile.open(dst, "w:gz") as b:
        for m in a.getmembers():
            buf = a.extractfile(m).read()
            if os.path.basename(m.name) == name:
                buf = data
                m.size = len(buf)
            b.addfile(m, io.BytesIO(buf))
    return dst


def _audit_pools(engines):
    """Every replica's page books balance. (Its own frame: a loop
    variable in the phase would keep the last replica, with its pool,
    graphs and weights, alive past the replay.)"""
    for e in engines:
        e.mgr.check_conservation()


def replay_7b_phase(torch, rn, pa, bundles, original):
    """Phase 29: ``replay_bundle`` on the card over phase 24 (b)'s two
    bundles (the ejection auto-dump, a clean prefix of the incident, and
    the final bundle): each rebuilds the 7B weights from the journaled
    seed and both replicas from the head frame, re-drives the router and
    must come back ``ok`` with no divergence and zero leaked pages (the
    final one with every page back); its launches checked against the
    replicas' micro-rounds. Then a copy of the final bundle with one
    outcome token flipped: the divergence names that frame. Reported:
    each replay's wall against the original run's, its program builds
    and capture seconds."""
    from paddle_tpu_torch.observability import replay as R
    from paddle_tpu_torch.observability.flight import (flight_recorder,
                                                       validate_bundle)
    from paddle_tpu_torch.observability.journal import encode_frames
    allocated0 = torch.cuda.memory_allocated()
    built = []
    real = R.rebuild_fleet

    def keep(head, clock, injector, *, device=None):
        out = real(head, clock, injector, device=device)
        built.append(out)
        return out

    R.rebuild_fleet = keep
    out = {}
    try:
        for name in ("ejection", "final", "flipped"):
            path = bundles.get(name)
            if name == "flipped":
                doc = validate_bundle(bundles["final"])
                frames = [dict(f) for f in doc["journal"].frames]
                target = next(f for f in frames if f["t"] == "outcome")
                target["tokens"] = list(target["tokens"])
                target["tokens"][0] ^= 1
                path = _rewrite_member(
                    bundles["final"], bundles["final"] + ".flipped.tar.gz",
                    "journal.jsonl",
                    encode_frames(doc["journal"].head, frames))
            built.clear()
            rn.rms_norm.launches = 0
            _reset_ragged(pa)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = R.replay_bundle(path)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            cfg, params, router, replicas = built[0]
            engines = [h.engine for h in replicas]
            cfg_layers = cfg.num_hidden_layers
            rounds = sum(e.micro_rounds for e in engines)
            got = {"rms_norm_fwd": rn.rms_norm.launches,
                   **_ragged_launches(pa)}
            want = {"rms_norm_fwd": (2 * cfg_layers + 1) * rounds,
                    **_ragged_want(torch, pa, cfg_layers * rounds)}
            if got != want:
                raise AssertionError(f"replay {name}: launches {got} != "
                                     f"{want}")
            res = dict(rep.as_dict(), wall_s=wall,
                       builds=[len(e.compile_misses) for e in engines],
                       capture_s=[sum(e.capture_seconds.values())
                                  for e in engines],
                       micro_rounds=rounds, launches=got)
            if name == "flipped":
                d = rep.divergence
                if d is None or rep.ok or (d.step, d.replica, d.component) \
                        != (target["step"], target["replica"], "outcome"):
                    raise AssertionError(f"the flipped token was not "
                                         f"localized: {res}")
            else:
                if rep.refused is not None or rep.divergence is not None \
                        or not rep.ok or rep.leaked_pages:
                    raise AssertionError(f"replay of the {name} bundle: "
                                         f"{res}")
                if name == "final" and (rep.pending or any(
                        e.mgr.num_live_pages for e in engines)):
                    raise AssertionError(f"replay of the final bundle "
                                         f"left pages live: {res}")
                _audit_pools(engines)
            out[name] = res
            del cfg, params, router, replicas, engines
            built.clear()
            # the recorder keeps the last router for its bundles (and
            # through it the replicas' pools and graphs): let go of it
            flight_recorder._router = flight_recorder._signals = None
            flight_recorder._autoscale = flight_recorder._slo_monitor = None
            _free_card(torch)
    finally:
        R.rebuild_fleet = real
    fleet_released(torch, allocated0, out)
    out["original_serve_s"] = original
    out["launches"] = {k: sum(out[n]["launches"][k] for n in
                              ("ejection", "final", "flipped"))
                       for k in out["final"]["launches"]}
    return out


# ---------------------------------------------------------------------------
# phase 31: the Paddle-shaped eager Tensor surface, tiny parity and 7B widths
# ---------------------------------------------------------------------------

EAGER_TINY = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2)


def _eager_batch(vocab, b, s, seed=SEED):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int64)
    return ids, np.roll(ids, -1, axis=-1)


def _eager_grads(params):
    return {k: p.grad._value.float().cpu() for k, p in params.items()}


def eager_parity_phase(torch, L, ln):
    """(a) scripts/eager_llama_step.py at tiny widths (2 heads of d 64
    per KV head, S 100: no tile multiple) on the card against the CPU,
    fp32 (TF32 off) and under ``auto_cast`` O1 bf16: loss and every
    gradient within ``EAGER_CARD_CPU_TOL``; the training
    ``fused_bias_dropout_residual_layer_norm``'s mask equal on both
    devices for one seed and its output within ``LN_TOL``; the tensor
    checker stopping at an injected inf and naming the op; the
    ``checkify_wrap`` counterpart naming the ATen op inside a function."""
    from scripts import eager_llama_step as E
    from paddle_tpu_torch import random as R
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.amp import debugging as dbg

    S = E.surface("paddle_tpu_torch")
    P = S.paddle
    cfg = L.llama_tiny(**EAGER_TINY)
    d = cfg.hidden_size // cfg.num_attention_heads
    stacked = {k: v.numpy() for k, v in
               L.init_params(cfg, SEED, device="cpu").items()}
    for k in ("ln1", "ln2", "ln_f"):       # norms off one, so dw is seen
        stacked[k] = stacked[k] + 0.1 * np.random.RandomState(SEED).randn(
            *stacked[k].shape).astype(np.float32)
    ids, labels = _eager_batch(cfg.vocab_size, 2, 100)
    report = {}
    try:
        for level in (None, "O1"):
            runs = {}
            for dev in ("gpu", "cpu"):
                P.set_device(dev)
                params = E.make_parameters(S, stacked, cfg.num_hidden_layers)
                cos, sin = E.rope_tables(S, ids.shape[1], d)
                loss = E.forward_backward(S, params, P.to_tensor(ids),
                                          P.to_tensor(labels), cfg, cos, sin,
                                          level)
                runs[dev] = (float(loss), _eager_grads(params))
            tol = testing.EAGER_CARD_CPU_TOL["fp32" if level is None
                                             else "bf16"]
            name = "fp32" if level is None else "o1_bf16"
            testing.close(torch.tensor(runs["gpu"][0]),
                          torch.tensor(runs["cpu"][0]), *tol["loss"],
                          f"eager {name} loss")
            worst = (0.0, 0.0)
            for k, g in runs["cpu"][1].items():
                err = testing.l2_close(runs["gpu"][1][k], g, tol["grads"],
                                       f"eager {name} grad {k}")
                worst = (max(worst[0], err[0]), max(worst[1], err[1]))
            report[name] = dict(loss_card=runs["gpu"][0],
                                loss_cpu=runs["cpu"][0],
                                grad_max_abs_err=worst[0],
                                grad_max_rel_l2=worst[1])

        # the training dropout of the fused epilogue: one seed, one mask
        from paddle_tpu_torch.incubate.nn import functional as IF
        rng = np.random.RandomState(SEED)
        x, res = (rng.randn(64, cfg.hidden_size).astype(np.float32)
                  for _ in range(2))
        g, b = (rng.randn(cfg.hidden_size).astype(np.float32)
                for _ in range(2))
        outs, masks = {}, {}
        for dev in ("gpu", "cpu"):
            P.set_device(dev)
            P.seed(SEED)
            key = R.get_rng_state()[1]
            nxt = R.prng.fold_in(key, 1)
            masks[dev] = R.bernoulli_draw(nxt, 0.9, x.shape,
                                          "cuda" if dev == "gpu" else "cpu")
            ln.layer_norm.launches = 0
            outs[dev] = IF.fused_bias_dropout_residual_layer_norm(
                P.to_tensor(x), P.to_tensor(res), None, P.to_tensor(g),
                P.to_tensor(b), dropout_rate=0.1, training=True)
            if dev == "gpu" and ln.layer_norm.launches != 1:
                raise AssertionError("the fused epilogue did not launch the "
                                     "LayerNorm kernel on the card")
        if not torch.equal(masks["gpu"].cpu(), masks["cpu"]):
            raise AssertionError("dropout masks differ between card and CPU")
        ln_err = testing.close(outs["gpu"]._value.cpu(), outs["cpu"]._value,
                               *testing.LN_TOL[torch.float32]["y"],
                               "fused_bias_dropout_residual_layer_norm")
        report["dropout"] = dict(rate=0.1,
                                 dropped=int((~masks["cpu"]).sum()),
                                 elements=masks["cpu"].numel(),
                                 ln_max_abs_err=ln_err)

        # the nan/inf checker at the dispatcher, and inside a function
        P.set_device("gpu")
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(enable=True))
        try:
            P.divide(P.ones([4]), P.to_tensor([1.0, 0.0, 2.0, 3.0]))
            raise AssertionError("the tensor checker let an inf through")
        except FloatingPointError as e:
            if "divide" not in str(e):
                raise AssertionError(f"checker error names no op: {e}")
            checker_msg = str(e)
        finally:
            dbg.disable_tensor_checker()
        wrapped = dbg.checkify_wrap(lambda t: torch.log(t).sum())
        wrapped(torch.ones(3, device="cuda"))
        try:
            wrapped(torch.tensor([-1.0, 1.0], device="cuda"))
            raise AssertionError("checkify_wrap let a nan through")
        except FloatingPointError as e:
            if "aten.log" not in str(e):
                raise AssertionError(f"checkify error names no ATen op: {e}")
            checkify_msg = str(e)
        report.update(checker=checker_msg, checkify=checkify_msg)
    finally:
        P.set_device("gpu")
    return report


def _dispatch_us(torch, P, n_ops=2000, trials=9):
    """The dispatcher's host µs per op, disarmed and armed (the always-on
    telemetry), as the reference's benchmarks/bench_dispatch_overhead.py
    measures them: a small ``add`` on the card, bursts timed A B B A,
    the overhead the median of the per-round ratios."""
    from paddle_tpu_torch.observability import telemetry
    x = P.to_tensor(np.ones((8, 8), np.float32))
    y = P.to_tensor(np.ones((8, 8), np.float32))
    was = telemetry.enabled

    def burst(armed, n=n_ops):
        (telemetry.enable if armed else telemetry.disable)()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            x + y
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    burst(True, 500)
    ratios, base, armed = [], [], []
    for _ in range(trials):
        d1, a1, a2, d2 = (burst(False), burst(True), burst(True),
                          burst(False))
        base += [d1, d2]
        armed += [a1, a2]
        ratios.append((a1 + a2) / (d1 + d2))
    (telemetry.enable if was else telemetry.disable)()
    return dict(disarmed_us_per_op=min(base) * 1e6,
                armed_us_per_op=min(armed) * 1e6,
                armed_overhead_pct=(sorted(ratios)[len(ratios) // 2] - 1) * 100,
                n_ops=n_ops, trials=trials)


def eager_7b_phase(torch, L, rn, fa, train12):
    """(b) scripts/eager_llama_step.py at Llama-2-7B widths, 8 layers
    (phase 12's cut), one (1, 2048) batch, fp32 Parameters from
    ``init_params`` under ``auto_cast(level="O1", dtype="bfloat16")``,
    AdamW with ``ClipGradByGlobalNorm(1.0)``: one warm and 3 timed
    steps, every step's launches of rows 1, 2, 5 and 6 checked (2L+1,
    2L+1, L, L), the loss finite and falling, the dtypes each op
    receives after the cast hook (matmul and flash bf16, RMSNorm fp32),
    step 1's loss against ``forward_stacked`` on the bf16 cast of the
    same weights (``EAGER_BF16_LOSS_TOL``); then the step wall, tokens/s,
    device ms by kind and idle share of a profiled step, ops dispatched
    a step, the dispatcher's µs per op and the peak memory."""
    from scripts import eager_llama_step as E
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.core import dispatch as D
    from paddle_tpu_torch.core.tensor import Tensor
    from paddle_tpu_torch.observability import telemetry

    S = E.surface("paddle_tpu_torch")
    P = S.paddle
    P.set_device("gpu")
    cfg = L.llama2_7b(num_hidden_layers=8, dtype=torch.float32)
    n_layers, b, s = cfg.num_hidden_layers, 1, 2048
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stacked = L.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids_np, labels_np = _eager_batch(cfg.vocab_size, b, s)
    ids_t = torch.from_numpy(ids_np).cuda()
    with torch.no_grad():
        p16 = {k: v.to(torch.bfloat16) for k, v in stacked.items()}
        logits = L.forward_stacked(p16, ids_t, cfg)
        ref_loss = float(L._token_ce(
            logits, torch.from_numpy(labels_np).cuda()))
        del p16, logits
    torch.cuda.empty_cache()

    params = E.make_parameters(S, stacked, n_layers)
    del stacked
    opt = E.make_optimizer(S, params, lr=1e-4)
    cos, sin = E.rope_tables(S, s, cfg.head_dim)
    ids, labels = P.to_tensor(ids_np), P.to_tensor(labels_np)
    counters = {"rms_norm_fwd": rn.rms_norm, "rms_norm_bwd": rn.rms_norm_bwd,
                "flash_attention_fwd": fa.flash_fwd_kernel,
                "flash_attention_bwd_dq": fa.flash_bwd_dq_kernel,
                "flash_attention_bwd_dkv": fa.flash_bwd_dkv_kernel}
    want = {"rms_norm_fwd": 2 * n_layers + 1,
            "rms_norm_bwd": 2 * n_layers + 1,
            "flash_attention_fwd": n_layers,
            "flash_attention_bwd_dq": n_layers,
            "flash_attention_bwd_dkv": n_layers}
    totals = dict.fromkeys(counters, 0)

    # the dtypes each op receives after the cast hook (step 1 only)
    seen, hook = {}, D.amp_cast_hook

    def spy(op_name, args):
        args = hook(op_name, args)
        seen.setdefault(op_name, set()).update(
            str(a.dtype).rpartition(".")[2] for a in args
            if isinstance(a, Tensor))
        return args

    losses, step_ms, ops_per_step = [], [], []
    for i in range(4):                  # 1 warm + 3 timed steps
        for c in counters.values():
            c.launches = 0
        D.amp_cast_hook = spy if i == 0 else hook
        n0 = sum(telemetry.op_counts.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = E.train_step(S, params, opt, ids, labels, cfg, cos, sin,
                            amp_level="O1")
        losses.append(float(loss))       # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        ops_per_step.append(sum(telemetry.op_counts.values()) - n0)
        D.amp_cast_hook = hook
        got = {k: c.launches for k, c in counters.items()}
        if got != want:
            raise AssertionError(f"step {i}: launch counts {got} != {want}")
        for k in totals:
            totals[k] += got[k]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall over 4 steps: {losses}")
    for op, dts in (("matmul", {"bfloat16"}), ("flash_attention", {"bfloat16"}),
                    ("rms_norm", {"float32"})):
        if seen.get(op) != dts:
            raise AssertionError(f"{op} received {seen.get(op)}, want {dts}")
    rtol, atol = testing.EAGER_BF16_LOSS_TOL
    testing.close(torch.tensor(losses[0]), torch.tensor(ref_loss), rtol, atol,
                  "step 1 loss against forward_stacked on bf16 weights")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mean_ms = float(np.mean(step_ms[1:]))

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        E.train_step(S, params, opt, ids, labels, cfg, cos, sin,
                     amp_level="O1")
        torch.cuda.synchronize()
    kinds, top = _kernel_ms_by_kind(prof, TRAIN_KINDS, n_top=10)
    busy = sum(kinds.values())
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    del params, opt, loss
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        layers=n_layers, reduced="num_hidden_layers 32 -> 8 (memory)",
        batch=[b, s], amp="O1 bfloat16", lr=1e-4, init_s=init_s,
        losses=losses, ref_loss_bf16_forward_stacked=ref_loss,
        step_ms=step_ms, mean_step_ms=mean_ms,
        tokens_per_s=b * s / (mean_ms / 1e3), peak_mem_gb=peak_gb,
        ops_dispatched_per_step=ops_per_step[-1],
        op_dtypes={k: sorted(v) for k, v in sorted(seen.items())},
        launches_per_step=want, launches=totals,
        breakdown=dict(kernel_ms=kinds, top_kernels=top, device_busy_ms=busy,
                       wall_ms=mean_ms, idle_share=1 - busy / mean_ms),
        dispatch=_dispatch_us(torch, P),
        phase12_mean_step_ms=train12["mean_step_ms"],
        phase12_batch=train12["batch"])


# ---------------------------------------------------------------------------
# phase 33: the rest of nn, metric and the high-level API — Transformer-base
# through Model.fit (scripts/transformer_mt.py)
# ---------------------------------------------------------------------------

def _t2n(t):
    v = t._value if hasattr(t, "_value") else t
    return v.detach().float().cpu().numpy()


def nn_families_card_cpu(torch):
    """Each family of ``nn.functional`` that this slice ports, once on
    the card against the CPU at small shapes, fp32 (TF32 off), within
    ``CARD_CPU_TOL["out"]``: activations, the dropouts (one seed: the
    same kept elements on both devices), convolutions, pools, norms,
    padding and resizing, losses, the masked dropout attention and the
    LSTM. Returns the worst error per family."""
    import paddle_tpu_torch as P
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import testing
    rs = np.random.RandomState(SEED)

    def f(*s):
        return rs.randn(*s).astype(np.float32)

    def lstm(xs):
        P.seed(SEED)
        layer = P.nn.LSTM(16, 24, num_layers=2, direction="bidirect")
        out, (h, c) = layer(xs[0], sequence_length=xs[1])
        return [out, h, c]

    lab = rs.randint(0, 10, (8, 12)).astype(np.int32)
    cases = {
        "activations": (lambda xs: [
            F.gelu(xs[0]), F.mish(xs[0]), F.softplus(xs[0], 2.0),
            F.hardswish(xs[0]), F.log_softmax(xs[0]), F.selu(xs[0]),
            F.glu(xs[0])], [f(64, 96)]),
        "dropout": (lambda xs: [
            F.dropout(xs[0], 0.3), F.dropout(xs[0], 0.5, axis=1),
            F.dropout2d(xs[1], 0.5), F.alpha_dropout(xs[0], 0.2),
            F.rrelu(xs[0])], [f(64, 96), f(4, 8, 6, 6)]),
        "conv": (lambda xs: [
            F.conv2d(xs[0], xs[1], stride=2, padding=1, groups=2),
            F.conv2d_transpose(xs[0], xs[2], stride=2, padding=1,
                               output_padding=1),
            F.conv1d(xs[3], xs[4], padding="SAME")],
            [f(2, 8, 16, 16), f(12, 4, 3, 3), f(8, 6, 3, 3), f(2, 8, 20),
             f(6, 8, 5)]),
        "pool": (lambda xs: list(F.max_pool2d(
            xs[0], 3, 2, 1, ceil_mode=True, return_mask=True)) + [
            F.avg_pool2d(xs[0], 3, 2, 1), F.adaptive_avg_pool2d(xs[0], 4),
            F.max_pool3d(xs[1], 2)], [f(2, 4, 16, 16), f(1, 2, 6, 6, 6)]),
        "norm": (lambda xs: [
            F.batch_norm(xs[0], P.zeros([8]), P.ones([8]), training=True),
            F.group_norm(xs[0], 4), F.instance_norm(xs[0]),
            F.local_response_norm(xs[0], 5)], [f(4, 8, 6, 6)]),
        "resize": (lambda xs: [
            F.pad(xs[0], [2, 1, 1, 3], mode="reflect"),
            F.interpolate(xs[0], size=(13, 7), mode="bicubic"),
            F.interpolate(xs[0], scale_factor=2, mode="bilinear"),
            F.grid_sample(xs[0], xs[1]), F.unfold(xs[0], 3, paddings=1)],
            [f(2, 3, 9, 10), np.tanh(f(2, 5, 4, 2))]),
        "loss": (lambda xs: [
            F.cross_entropy(xs[0], xs[1], label_smoothing=0.1),
            F.cross_entropy(xs[0], F.label_smooth(F.one_hot(xs[1], 10)),
                            soft_label=True, reduction="none"),
            F.ctc_loss(F.log_softmax(xs[2]), xs[3], xs[4], xs[5]),
            F.binary_cross_entropy_with_logits(xs[6], xs[7])],
            [f(8, 12, 10), lab, f(20, 4, 6),
             rs.randint(1, 6, (4, 5)).astype(np.int32),
             np.array([20, 18, 15, 20], np.int32),
             np.array([5, 3, 4, 1], np.int32), f(6, 7),
             (rs.rand(6, 7) > 0.5).astype(np.float32)]),
        "attention": (lambda xs: [
            F.scaled_dot_product_attention(xs[0], xs[1], xs[1],
                                           attn_mask=xs[2], dropout_p=0.1),
            F.scaled_dot_product_attention(xs[0], xs[1], xs[1],
                                           attn_mask=xs[3])],
            [f(4, 9, 8, 64), f(4, 11, 8, 64),
             (rs.rand(4, 1, 1, 11) > 0.2) | np.eye(1, 11, dtype=bool),
             np.triu(np.full((9, 11), -1e9, np.float32), 3)]),
        "rnn": (lstm, [f(3, 7, 16), np.array([7, 3, 5], np.int32)]),
    }
    rtol, atol = testing.CARD_CPU_TOL["out"]
    report = {}
    try:
        for name, (fn, arrays) in cases.items():
            outs = {}
            for dev in ("gpu", "cpu"):
                P.set_device(dev)
                P.seed(SEED)
                outs[dev] = [_t2n(o) for o in fn([P.to_tensor(a)
                                                  for a in arrays])]
            worst = 0.0
            for i, (g, c) in enumerate(zip(outs["gpu"], outs["cpu"])):
                if name == "dropout" and not np.array_equal(g == 0, c == 0):
                    raise AssertionError(f"dropout output {i}: the kept "
                                         "elements differ card vs CPU")
                worst = max(worst, testing.close(
                    torch.from_numpy(g), torch.from_numpy(c), rtol, atol,
                    f"nn family {name} output {i}"))
            report[name] = worst
    finally:
        P.set_device("gpu")
    return report


def _mt_run(torch, M, S, cfg, pairs, batches, s2s, src, src2):
    """scripts/transformer_mt.py at ``cfg`` on the current place: three
    ``fit`` steps (losses, weights), greedy tokens, beam-search ids."""
    P = S.paddle
    P.seed(3)
    net = M.build_model(S, cfg)
    model = M.prepare(S, net, cfg)
    losses = []

    class Rec(S.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    ck = os.path.join("build", "mt_tiny_ck")
    M.train(S, model, M.make_loader(S, pairs, 0, cfg["max_length"], batches),
            ck, callbacks=[Rec()])
    shutil.rmtree(ck, ignore_errors=True)
    weights = {k: v.detach().float().cpu() for k, v in
               net.state_dict().items()}
    greedy = _t2n(M.greedy_decode(S, net, P.to_tensor(src), 6))
    P.seed(5)
    parts = M.build_seq2seq(S, s2s)
    beams = _t2n(M.beam_search(S, parts, P.to_tensor(src2), s2s,
                               s2s["max_step_num"]))
    return losses, weights, greedy, beams


def mt_parity_phase(torch, ln):
    """(a) scripts/transformer_mt.py at its tiny widths (d_model 64, 4
    heads, 2 + 2 layers, d_ff 128, vocabulary 101) on the card against
    the CPU: 3 ``fit`` steps over batches of 4 pairs of length 5-12 with
    dropout 0.1 (the key stream's masks on both devices), each step's
    loss and the weights after them within ``testing.MT_FIT``, the
    LayerNorm kernels launched on the card; greedy tokens identical, and
    the beam ids of the tiny LSTM seq2seq (hidden 32, beam 4); then each
    new ``functional`` family card against CPU."""
    from scripts import transformer_mt as M
    from paddle_tpu_torch import testing
    S = M.surface("paddle_tpu_torch")
    P = S.paddle
    cfg, s2s = dict(M.TINY), dict(M.SEQ2SEQ_TINY)
    pairs = M.sentence_pairs(12, cfg["vocab"], 5, 12, seed=SEED)
    batches = [list(range(i, i + 4)) for i in range(0, 12, 4)]
    rs = np.random.RandomState(SEED + 1)
    src = rs.randint(2, cfg["vocab"], (3, 9)).astype(np.int32)
    src[1, 6:] = M.BOS                                  # a padded source
    src2 = rs.randint(2, s2s["src_vocab"], (3, 9)).astype(np.int32)
    runs = {}
    try:
        for dev in ("gpu", "cpu"):
            P.set_device(dev)
            ln.layer_norm.launches = ln.layer_norm_bwd.launches = 0
            runs[dev] = _mt_run(torch, M, S, cfg, pairs, batches, s2s, src,
                                src2)
            if dev == "gpu":
                ln_launches = (ln.layer_norm.launches,
                               ln.layer_norm_bwd.launches)
    finally:
        P.set_device("gpu")
    (gl, gw, gg, gb), (cl, cw, cg, cb) = runs["gpu"], runs["cpu"]
    tol = testing.MT_FIT
    loss_err = testing.close(torch.tensor(gl), torch.tensor(cl),
                             tol["rtol"], tol["atol"], "tiny MT fit losses")
    w_err = max(testing.close(gw[k], cw[k], tol["rtol"], tol["atol"],
                              f"tiny MT weight {k}") for k in cw)
    if not np.array_equal(gg, cg):
        raise AssertionError(f"greedy tokens differ:\n{gg}\n{cg}")
    if not np.array_equal(gb, cb):
        raise AssertionError("beam-search ids differ card vs CPU")
    # 3 steps: 2 encoder + 2 decoder layers, 2 and 3 norms each
    want_ln = 3 * (2 * 2 + 3 * 2)
    if ln_launches[0] < want_ln or ln_launches[1] != want_ln:
        raise AssertionError(f"LayerNorm launches {ln_launches}, want "
                             f">= {want_ln} forward, {want_ln} backward")
    return dict(losses_card=gl, losses_cpu=cl, loss_max_abs_err=loss_err,
                weight_max_abs_err=w_err, greedy_tokens=gg.tolist(),
                beam_ids_equal=True, ln_launches=list(ln_launches),
                families=nn_families_card_cpu(torch))


def _mt_flops(b, ss, st, cfg):
    """Matmul FLOPs of one training step of TransformerMT on a (b, ss)
    source and (b, st) target batch: forward from the shapes, backward
    twice the forward."""
    d, ff, v = cfg["d_model"], cfg["d_ff"], cfg["vocab"]
    enc = cfg["n_enc"] * (8 * b * ss * d * d + 4 * b * ss * d * ff
                          + 4 * b * ss * ss * d)
    dec = cfg["n_dec"] * (8 * b * st * d * d + 4 * b * st * st * d
                          + 4 * b * st * d * d + 4 * b * ss * d * d
                          + 4 * b * st * ss * d + 4 * b * st * d * ff)
    return 3 * (enc + dec + 2 * b * st * d * v)


MT_STEPS, MT_DECODE_B, MT_DECODE_STEPS = 30, 64, 128


def mt_base_phase(torch, ln, fa):
    """(b) Transformer-base at full width, fp32, on the card: 30
    ``Model.fit`` steps of ≤4096-target-token batches (PaddleNLP's token
    buckets over seeded pairs of 16-128 tokens, in a seeded order), with
    ``ModelCheckpoint(save_freq=1)`` and ``LRScheduler(by_step=True)``;
    every step's LayerNorm launches (30 forward, 30 backward); the step
    wall, tokens/s, MFU against the fp32 peak from the shapes' FLOPs, a
    profiled step's device ms by kind and idle share, the dropout draws
    and the masked attention timed alone at the step's shapes, the host
    ms that hapi adds a batch, peak memory; ``evaluate`` with
    ``Accuracy``, ``save`` and ``load`` (bitwise), ``predict``; greedy
    decoding of 64 equal-length sources for 128 tokens with row 5's
    launches counted."""
    from scripts import transformer_mt as M
    from paddle_tpu_torch import random as R
    from paddle_tpu_torch.nn import functional as NF
    S = M.surface("paddle_tpu_torch")
    P = S.paddle
    P.set_device("gpu")
    cfg = dict(M.BASE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    P.seed(SEED)
    net = M.build_model(S, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pairs = M.sentence_pairs(3000, cfg["vocab"], 16, 128, seed=SEED)
    buckets = M.token_buckets(pairs, cfg["max_tokens"], cfg["max_length"])
    order = np.random.RandomState(SEED).permutation(len(buckets))
    batches = [buckets[i] for i in order[:MT_STEPS]]
    shapes = [(len(b), max(len(pairs[i][0]) for i in b),
               max(len(pairs[i][1]) for i in b) + 1) for b in batches]
    model = M.prepare(S, net, cfg)
    counters = {"layer_norm_fwd": ln.layer_norm,
                "layer_norm_bwd": ln.layer_norm_bwd,
                "flash_attention_fwd": fa.flash_fwd_kernel,
                "flash_attention_bwd_dq": fa.flash_bwd_dq_kernel,
                "flash_attention_bwd_dkv": fa.flash_bwd_dkv_kernel}
    n_ln = 2 * cfg["n_enc"] + 3 * cfg["n_dec"]
    step_ms, gap_ms, losses, per_step = [], [], [], []
    marks = {}

    class Timer(S.callbacks.Callback):
        def on_train_batch_begin(self, step, logs=None):
            now = time.perf_counter()
            if "end" in marks:
                gap_ms.append((now - marks["end"]) * 1e3)
            for c in counters.values():
                c.launches = 0
            marks["begin"] = now

        def on_train_batch_end(self, step, logs=None):
            now = time.perf_counter()          # float(loss) has synced
            step_ms.append((now - marks["begin"]) * 1e3)
            losses.append(logs["loss"])
            per_step.append({k: c.launches for k, c in counters.items()})
            marks["end"] = now

    ck = os.path.join("build", "mt_base_ck")
    t0 = time.perf_counter()
    M.train(S, model, M.make_loader(S, pairs, 0, 256, batches), ck,
            callbacks=[Timer()])
    fit_s = time.perf_counter() - t0
    want = {"layer_norm_fwd": n_ln, "layer_norm_bwd": n_ln,
            "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}
    for i, got in enumerate(per_step):
        if got != want:
            raise AssertionError(f"fit step {i}: launches {got} != {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    saved = sorted(os.listdir(ck))
    if saved != ["0.pdopt", "0.pdparams", "final.pdopt", "final.pdparams"]:
        raise AssertionError(f"ModelCheckpoint wrote {saved}")
    shutil.rmtree(ck, ignore_errors=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timed = slice(5, None)                       # steps 6-30
    med = float(np.median(step_ms[timed]))
    tgt_tok = [b * (st - 1) for b, _, st in shapes]
    all_tok = [b * (ss + st) for b, ss, st in shapes]
    flops = [_mt_flops(b, ss, st, cfg) for b, ss, st in shapes]
    sec = float(np.sum(step_ms[timed])) / 1e3
    tgt_tps = float(np.sum(tgt_tok[timed])) / sec
    tok_tps = float(np.sum(all_tok[timed])) / sec
    mfu = float(np.sum(flops[timed])) / sec / PEAK_OPS_PER_S["fp32"]

    # the median-sized batch: one timed step with the shapes of its
    # dropout draws and masked attentions recorded (profiled last, below:
    # the profiler's CUPTI hooks can stay behind and slow what follows)
    loader = list(M.make_loader(S, pairs, 0, 256, batches))
    mid = int(np.argsort([b * st for b, _, st in shapes])[len(shapes) // 2])
    src, trg, lab = loader[mid]
    draws, attns = [], []
    draw0, sdpa0 = R.bernoulli_draw, NF._sdpa_masked

    def draw_spy(key, p, shape, device=None):
        draws.append((float(p), tuple(shape)))
        return draw0(key, p, shape, device)

    def sdpa_spy(q, k, v, mask, scale, dropout_p, dropout_key, causal):
        attns.append((tuple(q.shape), tuple(k.shape),
                      None if mask is None else tuple(mask.shape),
                      mask is not None and mask.dtype == torch.bool))
        return sdpa0(q, k, v, mask, scale, dropout_p, dropout_key, causal)

    R.bernoulli_draw, NF._sdpa_masked = draw_spy, sdpa_spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.train_batch([src, trg], [lab])
        torch.cuda.synchronize()
        step_wall = (time.perf_counter() - t0) * 1e3
    finally:
        R.bernoulli_draw, NF._sdpa_masked = draw0, sdpa0
    n_draws = len(draws)
    key = R.next_key().to("cuda")

    def run_draws():
        for p, shape in draws:
            R.bernoulli_draw(key, p, shape, "cuda")
    draw_ms = eager_ms(torch, run_draws, iters=3, warmup=1)
    qkv = {}

    def run_attns():
        for qs, ks, ms, is_bool in attns:
            if qs not in qkv:
                qkv[qs] = torch.randn(qs, device="cuda",
                                      requires_grad=True)
            if ks not in qkv:
                qkv[ks] = torch.randn(ks, device="cuda",
                                      requires_grad=True)
            q, k = qkv[qs], qkv[ks]
            m = (torch.ones(ms, dtype=torch.bool, device="cuda")
                 if is_bool else torch.zeros(ms, device="cuda"))
            o = sdpa0(q, k, k, m, 0.125, 0.0, None, False)
            o.sum().backward()
    attn_ms = eager_ms(torch, run_attns, iters=3, warmup=1)
    del qkv

    # the host time hapi adds a batch: each of batches 6-15 again through
    # the network, the criterion, backward and the update alone (inputs
    # already on the card, no callback, no float(loss)), against its own
    # fit step
    crit = M.make_criterion(S, cfg["vocab"])
    opt = model._optimizer
    bare = range(5, min(15, len(loader)))
    bare_ms = []
    for i in bare:
        s_, t_, l_ = [P.to_tensor(a) for a in loader[i]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = crit(net(s_, t_), l_)
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        bare_ms.append((time.perf_counter() - t0) * 1e3)
    added = [step_ms[i] - b for i, b in zip(bare, bare_ms)]
    del s_, t_, l_, loss

    # evaluate with Accuracy, save / load, predict
    emodel = S.paddle.Model(net)
    emodel.prepare(None, crit, S.metric.Accuracy())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = emodel.evaluate([loader[mid]], verbose=0)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join("build", "mt_base_save", "m")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.save(path)
    save_s = time.perf_counter() - t0
    P.seed(SEED + 1)
    net2 = M.build_model(S, cfg)
    model2 = M.prepare(S, net2, cfg)
    t0 = time.perf_counter()
    model2.load(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    for (n, a), (_, b) in zip(net.state_dict().items(),
                              net2.state_dict().items()):
        if not torch.equal(a, b):
            raise AssertionError(f"loaded {n} differs from the saved one")
    del model2, net2
    pred = model.predict_batch([src, trg])[0]
    if pred.shape != (src.shape[0], trg.shape[1], cfg["vocab"]) or \
            not np.isfinite(pred).all():
        raise AssertionError(f"predict gave {pred.shape}")
    del pred
    gc.collect()
    torch.cuda.empty_cache()

    # greedy decoding: 64 sources of one length (no padding mask, so
    # every attention is the flash forward)
    dsrc = P.to_tensor(np.random.RandomState(SEED).randint(
        2, cfg["vocab"], (MT_DECODE_B, 64)).astype(np.int32))
    M.greedy_decode(S, net, dsrc, 4, memory_mask=False)      # warm
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = M.greedy_decode(S, net, dsrc, MT_DECODE_STEPS, memory_mask=False)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    dec_launches = {k: c.launches for k, c in counters.items()}
    want_fa = cfg["n_enc"] + 2 * cfg["n_dec"] * MT_DECODE_STEPS
    if dec_launches["flash_attention_fwd"] != want_fa:
        raise AssertionError(f"greedy decode: flash launches "
                             f"{dec_launches['flash_attention_fwd']} != "
                             f"{want_fa}")
    if tuple(toks.shape) != (MT_DECODE_B, MT_DECODE_STEPS):
        raise AssertionError(f"greedy tokens {toks.shape}")

    # the same median-sized step, profiled: device ms by kind
    from torch.profiler import ProfilerActivity, profile
    model.train_batch([src, trg], [lab])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.train_batch([src, trg], [lab])
        torch.cuda.synchronize()
    kinds, top = _kernel_ms_by_kind(prof, MT_KINDS, n_top=10)
    busy = sum(kinds.values())
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    del net, model, emodel, opt
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        config="Transformer-base (d_model 512, 8 heads, 6 + 6 layers, d_ff "
               "2048, vocab 33712 shared, post-LN), fp32, TF32 off",
        reduced="none of the widths; 30 steps of synthetic WMT14-shaped "
                "pairs", init_s=init_s, steps=MT_STEPS, batches=shapes,
        losses=losses, step_ms=step_ms, median_step_ms_6_30=med,
        target_tokens_per_s=tgt_tps, tokens_per_s=tok_tps,
        mfu_fp32=mfu, fit_s=fit_s, peak_mem_gb=peak_gb,
        launches_per_step=want,
        launches={k: v * MT_STEPS for k, v in want.items()},
        profiled_step=dict(batch=list(shapes[mid]), wall_ms=step_wall,
                           kernel_ms=kinds, top_kernels=top,
                           device_busy_ms=busy,
                           idle_share=1 - busy / step_wall,
                           dropout_draws=n_draws,
                           dropout_draws_ms_alone=draw_ms,
                           masked_attentions=len(attns),
                           masked_attention_fwd_bwd_ms_alone=attn_ms),
        hapi=dict(bare_step_ms=bare_ms, fit_step_ms=[step_ms[i]
                                                    for i in bare],
                  added_ms_per_batch_median=float(np.median(added)),
                  gap_between_batches_ms=float(np.median(gap_ms))),
        row8=_mt_ln_row8(torch, ln, shapes[mid][0] * shapes[mid][2],
                         cfg["d_model"]),
        row5_decode=_mt_flash_decode(torch, fa, MT_DECODE_B * cfg["nhead"],
                                     cfg["d_model"] // cfg["nhead"]),
        evaluate=dict(ms=eval_ms, logs=ev), save_s=save_s, load_s=load_s,
        greedy=dict(batch=MT_DECODE_B, new_tokens=MT_DECODE_STEPS,
                    ms_per_step=dec_s * 1e3 / MT_DECODE_STEPS,
                    tokens_per_s=MT_DECODE_B * MT_DECODE_STEPS / dec_s,
                    launches=dec_launches))


def _mt_ln_row8(torch, ln, rows, h, eps=1e-5):
    """Row 8 at the Transformer-base step's (tokens, 512) fp32 shape:
    forward and backward kernel against the plain versions and
    ``F.layer_norm`` (fresh copies of x and g a call, out of L2)."""
    from paddle_tpu_torch.testing import LN_TOL, rms_close
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = 2 * torch.randn(rows, h, generator=gen, device="cuda") + 0.5
    g = torch.randn(rows, h, generator=gen, device="cuda")
    w = 1 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    b = 0.1 * torch.randn(h, generator=gen, device="cuda")
    tol = LN_TOL[torch.float32]
    y_err = rms_close(ln.layer_norm_kernel(x, w, b, eps),
                      ln.ln_plain(x, w, b, eps), *tol["y"], "row 8 fwd")
    got, want = ln.layer_norm_bwd_kernel(x, w, g, eps), \
        ln.ln_bwd_plain(x, w, g, eps)
    b_err = max(rms_close(got[0], want[0], *tol["dx"], "row 8 dx"),
                rms_close(got[1], want[1], *tol["sums"], "row 8 dw"),
                rms_close(got[2], want[2], *tol["sums"], "row 8 db"))
    copies = _l2_cold((x, g))
    nxt = itertools.cycle(copies).__next__
    fb, fby = bound_ms(2 * rows * h * 4 + 2 * h * 4, 8 * rows * h, "fp32")
    bb, bby = bound_ms(3 * rows * h * 4 + 3 * h * 4, 20 * rows * h, "fp32")

    def kernel_bwd():
        xc, gc = nxt()
        return ln.layer_norm_bwd_kernel(xc, w, gc, eps)
    out = dict(
        shape=[rows, h], dtype="fp32",
        fwd=dict(max_abs_err=y_err,
                 ms=device_ms(torch, lambda: ln.layer_norm_kernel(
                     nxt()[0], w, b, eps)),
                 plain_ms=device_ms(torch, lambda: ln.ln_plain(x, w, b, eps),
                                    iters=5, replays=2),
                 bound_ms=fb, bound_by=fby,
                 library_ms=device_ms(torch, lambda: torch.nn.functional
                                      .layer_norm(nxt()[0], (h,), w, b,
                                                  eps))),
        bwd=dict(max_abs_err=b_err, ms=device_ms(torch, kernel_bwd),
                 plain_ms=device_ms(torch, lambda: ln.ln_bwd_plain(
                     x, w, g, eps), iters=5, replays=2),
                 bound_ms=bb, bound_by=bby,
                 library_ms=_ln_library_bwd_ms(torch, copies, w, b, eps)))
    del x, g, copies, nxt
    torch.cuda.empty_cache()
    return out


def _mt_flash_decode(torch, fa, bh, d):
    """Row 5 at greedy decoding's shapes, fp32: one query a row over 64
    keys (the cross-attention of a 64-token source) and over 128 (the
    self-attention's last step), against the plain version and SDPA."""
    from paddle_tpu_torch import testing
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for sk in (64, 128):
        q = torch.randn(bh, 1, d, generator=gen, device="cuda")
        k = torch.randn(bh, sk, d, generator=gen, device="cuda")
        v = torch.randn(bh, sk, d, generator=gen, device="cuda")
        sc = 1.0 / math.sqrt(d)
        got = fa.flash_fwd_kernel(q, k, v, sc, False)[0]
        want = fa.flash_fwd_plain(q, k, v, sc, False)[0]
        err = testing.flash_close(got, want, torch.float32,
                                  f"row 5 decode sk {sk}")[0]
        bnd, by = bound_ms((2 * bh * d + 2 * bh * sk * d) * 4 + bh * 4,
                           4 * bh * sk * d, "fp32")
        out[f"sk{sk}"] = dict(
            shape=[bh, 1, sk, d], max_abs_err=err,
            ms=device_ms(torch, lambda: fa.flash_fwd_kernel(q, k, v, sc,
                                                            False)),
            plain_ms=device_ms(torch, lambda: fa.flash_fwd_plain(
                q, k, v, sc, False)),
            bound_ms=bnd, bound_by=by,
            library_ms=device_ms(torch, lambda: torch.nn.functional
                                 .scaled_dot_product_attention(
                                     q[None], k[None], v[None])))
    return out


MT_KINDS = (("products", MATMUL_NAMES), ("layer_norm", ("layer_norm",)),
            ("flash", ("flash_attention",)), ("softmax", ("softmax",)))


def seq2seq_beam_phase(torch):
    """(c) beam search over the LSTM seq2seq at PaddleNLP's IWSLT'15
    widths (embedding and hidden 512, 2-layer LSTM encoder, two
    LSTMCells with attention, target vocabulary 7709): batch 128, beam
    10, 50 steps over 32-token sources; ms a step, tokens/s, and
    ``gather_tree`` alone."""
    from scripts import transformer_mt as M
    S = M.surface("paddle_tpu_torch")
    P = S.paddle
    P.set_device("gpu")
    cfg = dict(M.SEQ2SEQ)
    b, k, steps = 128, cfg["beam_size"], cfg["max_step_num"]
    P.seed(SEED)
    parts = M.build_seq2seq(S, cfg)
    src = P.to_tensor(np.random.RandomState(SEED).randint(
        2, cfg["src_vocab"], (b, 32)).astype(np.int32))
    M.beam_search(S, parts, src[:8], cfg, 3)                 # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = M.beam_search(S, parts, src, cfg, steps)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    if tuple(ids.shape) != (b, steps, k):
        raise AssertionError(f"beam ids {ids.shape}")
    v = ids._value
    if int(v.min()) < 0 or int(v.max()) >= cfg["tgt_vocab"]:
        raise AssertionError("beam ids outside the vocabulary")
    tid = torch.randint(0, cfg["tgt_vocab"], (steps, b, k), device="cuda",
                        dtype=torch.int32)
    par = torch.randint(0, k, (steps, b, k), device="cuda",
                        dtype=torch.int32)
    gt_ms = eager_ms(torch, lambda: S.nn.functional.gather_tree(tid, par),
                     iters=5, warmup=1)
    return dict(batch=b, beam=k, steps=steps, source_len=32,
                ms_per_step=sec * 1e3 / steps,
                tokens_per_s=b * steps / sec,
                beam_tokens_per_s=b * k * steps / sec,
                gather_tree_ms=gt_ms)


def _kernel_entry(name, route, source, replaces, launches, r):
    """One entry of the kernels line: ``launches`` from the main paths,
    the rest from the kernel's own phase."""
    return dict(name=name, route=route, source=source, replaces=replaces,
                launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"])



# ---------------------------------------------------------------------------
# phase 34: compiled programs (jit, static, the Predictor, fusion)
# ---------------------------------------------------------------------------

def _same(torch, a, b, what):
    """Bitwise equality of two tensors (or lists of them)."""
    if isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _same(torch, x, y, f"{what}[{i}]")
        return
    a = a._value if hasattr(a, "_value") else a
    b = b._value if hasattr(b, "_value") else b
    if not torch.equal(a.detach().cpu(), b.detach().cpu()):
        diff = (a.float().cpu() - b.float().cpu()).abs().max()
        raise AssertionError(f"{what}: graph != graphs-off run "
                             f"(max diff {diff})")


def _jit_mlp(P, drop):
    nn = P.nn

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(16, 64)
            self.norm = nn.LayerNorm(64)
            self.fc2 = nn.Linear(64, 8)
            self.d = nn.Dropout(drop)

        def forward(self, x):
            return self.fc2(self.d(self.norm(P.nn.functional.relu(
                self.fc1(x)))))
    return MLP()


def _jit_scaled(x, s, n):
    """A compiled function of a tensor and two Python numbers."""
    return x * s + n


def _dy2_branch(x):
    if (x.sum() > 0):
        y = x * 2.0
    else:
        y = x - 1.0
    return y + 1.0


def _dy2_while(x):
    s = x * 0.0
    while (s.sum() < 10.0):
        s = s + x
        if (s.sum() >= 6.0):
            break
    return s


def _dy2_for(x):
    s = x[0] * 0.0
    for i, row in enumerate(x):
        s = s + row * float(i)
    return s


def _dy2_early(x):
    s = x
    while s.sum() < 40.0:
        s = s * 2.0
        if s.max() > 9.0:
            return s * -1.0
    return s


class _JitTinyLlama:
    """A pre-norm attention block over RMSNorm (row 1) and causal
    attention at head dim 64 (row 5), for ``jit.save`` on the card."""

    @staticmethod
    def build(P):
        nn = P.nn

        class Block(nn.Layer):
            def __init__(self, h=128, heads=2):
                super().__init__()
                self.heads = heads
                self.norm1 = nn.RMSNorm(h)
                self.qkv = nn.Linear(h, 3 * h)
                self.out = nn.Linear(h, h)
                self.norm2 = nn.RMSNorm(h)

            def forward(self, x):
                b, s, h = x.shape
                q, k, v = P.split(self.qkv(self.norm1(x)), 3, axis=-1)
                shape = [b, s, self.heads, h // self.heads]
                a = P.nn.functional.scaled_dot_product_attention(
                    q.reshape(shape), k.reshape(shape), v.reshape(shape),
                    is_causal=True)
                return self.norm2(x + self.out(a.reshape([b, s, h])))
        return Block()


def jit_parity_phase(torch, L, D, ln, rn, fa):
    """(a) Tiny widths, card against CPU and every CUDA graph against the
    same program run with graphs off on the card (bitwise): a
    ``to_static`` MLP with LayerNorm; ``TrainStep`` (AdamW, global-norm
    clip, dropout 0.5) for 3 steps and ``multi_step(2)``; the dy2static
    ``if`` / ``while`` with ``break`` (a counted graph break) / ``for``
    over a tensor / early ``return`` functions; ``jit.save`` → ``load`` →
    ``Predictor`` of the MLP and of a tiny RMSNorm + flash attention
    block; the fused-tail engine's greedy streams; and the fused Adam
    step (bitwise against the eager one on each device)."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import jit, testing
    from paddle_tpu_torch.inference.config import Config
    from paddle_tpu_torch.inference.predictor import create_predictor
    from paddle_tpu_torch.jit import dy2static as D2
    tol = testing.MT_FIT
    rs = np.random.RandomState(SEED)
    xs = rs.randn(3, 12, 16).astype(np.float32)
    ys = rs.randint(0, 8, size=(3, 12)).astype(np.int64)
    out = {}

    def on(dev, fn):
        P.set_device(dev)
        try:
            return fn()
        finally:
            P.set_device("gpu")

    # to_static
    def static_run(graphs):
        P.seed(SEED)
        net = jit.to_static(_jit_mlp(P, 0.5))
        net.eval()
        net.forward._graphs = graphs
        return [net(P.to_tensor(x)) for x in xs] + [net(P.to_tensor(xs[0]))]
    g, e = static_run(True), static_run(False)
    _same(torch, g, e, "to_static")
    c = on("cpu", lambda: static_run(True))
    out["to_static_max_abs_err"] = max(
        testing.close(a._value.cpu(), b._value, tol["rtol"], tol["atol"],
                      "to_static card vs cpu") for a, b in zip(g, c))

    # to_static over Python numbers: each is a program input (one
    # capture, every value computed with), as jax.jit traces it
    def numbers_run(graphs):
        sf = jit.to_static(_jit_scaled)
        sf._graphs = graphs
        return [sf(P.to_tensor(xs[0]), s, 2) for s in (2.0, 3.0, 0.5)], sf
    (g, gsf), (e, _) = numbers_run(True), numbers_run(False)
    _same(torch, g, e, "to_static numbers")
    if gsf.programs.captures != 1:
        raise AssertionError(f"to_static numbers: "
                             f"{gsf.programs.captures} captures")
    c, _ = on("cpu", lambda: numbers_run(True))
    out["numbers_max_abs_err"] = max(
        testing.close(a._value.cpu(), torch.from_numpy(xs[0] * s + 2),
                      tol["rtol"], tol["atol"], f"to_static numbers {s}")
        for a, s in zip(g, (2.0, 3.0, 0.5)))
    _same(torch, g, c, "to_static numbers card vs cpu")

    # TrainStep (3 steps with dropout) and multi_step(2)
    def train_run(graphs):
        P.seed(SEED)
        net = _jit_mlp(P, 0.5)
        opt = P.optimizer.AdamW(
            learning_rate=1e-2, parameters=net.parameters(),
            grad_clip=P.optimizer.ClipGradByGlobalNorm(1.0))
        step = jit.TrainStep(net, lambda m, x, y: P.nn.functional
                             .cross_entropy(m(x), y), opt)
        step._graphs = graphs
        losses = [step(P.to_tensor(x), P.to_tensor(y))
                  for x, y in zip(xs, ys)]
        multi = step.multi_step(2)
        losses.append(multi(P.to_tensor(xs[:2]), P.to_tensor(ys[:2])))
        losses.append(multi(P.to_tensor(xs[1:]), P.to_tensor(ys[1:])))
        return losses, [p.detach().clone() for p in net.parameters()], step
    (gl, gw, gstep), (el, ew, _) = train_run(True), train_run(False)
    _same(torch, gl, el, "TrainStep losses")
    _same(torch, gw, ew, "TrainStep weights")
    if gstep.programs.captures != 1 or \
            gstep._multi[2].programs.captures != 1:
        raise AssertionError("TrainStep captured "
                             f"{gstep.programs.captures} graphs")
    cl, cw, _ = on("cpu", lambda: train_run(True))
    out["train_losses_card"] = [float(x) for x in gl]
    out["train_losses_cpu"] = [float(x) for x in cl]
    out["train_loss_max_abs_err"] = testing.close(
        torch.tensor([float(x) for x in gl]),
        torch.tensor([float(x) for x in cl]), tol["rtol"], tol["atol"],
        "TrainStep losses card vs cpu")
    out["train_weight_max_abs_err"] = max(
        testing.close(a.cpu(), b, tol["rtol"], tol["atol"],
                      "TrainStep weights card vs cpu")
        for a, b in zip(gw, cw))

    # dy2static
    xin = {"if": (np.ones(4), -np.ones(4)), "while_break": (np.ones(4),),
           "for_tensor": (np.arange(6.0).reshape(3, 2),),
           "early_return": (np.ones(2) * 0.5, np.ones(2) * 3.0)}
    fns = {"if": _dy2_branch, "while_break": _dy2_while,
           "for_tensor": _dy2_for, "early_return": _dy2_early}
    breaks0 = sum(D2.graph_breaks.values())
    dy2 = {}
    for name, fn in fns.items():
        def dy_run(graphs, fn=fn, name=name):
            sf = jit.to_static(fn)
            sf._graphs = graphs
            return [sf(P.to_tensor(x.astype(np.float32)))
                    for x in xin[name] for _ in range(2)]
        g, e = dy_run(True), dy_run(False)
        _same(torch, g, e, f"dy2static {name}")
        c = on("cpu", lambda: dy_run(True))
        dy2[name] = max(testing.close(a._value.cpu(), b._value, tol["rtol"],
                                      tol["atol"], f"dy2static {name}")
                        for a, b in zip(g, c))
    out["dy2static_max_abs_err"] = dy2
    out["graph_breaks"] = sum(D2.graph_breaks.values()) - breaks0
    if out["graph_breaks"] <= 0:
        raise AssertionError("the data-dependent while was not counted")

    # jit.save -> load -> Predictor, card and CPU
    def save_run(build, shape, dev, tag):
        P.seed(SEED + 1)
        layer = build()
        layer.eval()
        x = np.random.RandomState(SEED).randn(*shape).astype(np.float32)
        want = layer(P.to_tensor(x))
        path = os.path.join("build", "jit_smoke", f"{tag}_{dev}")
        jit.save(layer, path, input_spec=[P.static.InputSpec(list(shape),
                                                             "float32")])
        cfg = Config(path)
        if dev == "cpu":
            cfg.disable_gpu()
        pred = create_predictor(cfg)
        got = [pred.run([x])[0] for _ in range(3)]
        return want, got
    saved = {}
    for tag, build, shape in (
            ("mlp", lambda: _jit_mlp(P, 0.0), (12, 16)),
            ("llama_block", lambda: _JitTinyLlama.build(P), (2, 32, 128))):
        rn.rms_norm.launches = fa.flash_fwd_kernel.launches = 0
        ln.layer_norm.launches = 0
        gwant, ggot = save_run(build, shape, "gpu", tag)
        launches = dict(rms_norm_fwd=rn.rms_norm.launches,
                        flash_attention_fwd=fa.flash_fwd_kernel.launches,
                        layer_norm_fwd=ln.layer_norm.launches)
        cwant, cgot = on("cpu", lambda: save_run(build, shape, "cpu", tag))
        if not all(np.array_equal(ggot[0], o) for o in ggot[1:]):
            raise AssertionError(f"{tag}: predictor replays differ")
        saved[tag] = dict(
            vs_layer=testing.close(torch.from_numpy(ggot[0]),
                                   gwant._value.cpu(), tol["rtol"],
                                   tol["atol"], f"{tag} predictor vs layer"),
            card_vs_cpu=testing.close(torch.from_numpy(ggot[0]),
                                      torch.from_numpy(cgot[0]),
                                      tol["rtol"], tol["atol"],
                                      f"{tag} predictor card vs cpu"),
            launches=launches)
    # the layer's own forward and 3 predictor runs (a warm-up and two
    # replays): the MLP's one LayerNorm, the block's two RMSNorms and
    # one flash forward each time
    if saved["mlp"]["launches"]["layer_norm_fwd"] != 4:
        raise AssertionError(f"mlp program launches {saved['mlp']}")
    bl = saved["llama_block"]["launches"]
    if bl["rms_norm_fwd"] != 8 or bl["flash_attention_fwd"] != 4:
        raise AssertionError(f"block program launches {bl}")
    shutil.rmtree(os.path.join("build", "jit_smoke"), ignore_errors=True)
    out["saved_programs"] = saved

    # fused tail: tiny engine, fused on card == unfused on card == CPU
    cfg = L.llama_tiny(hidden_size=256, num_attention_heads=2,
                       num_key_value_heads=2, intermediate_size=512,
                       num_hidden_layers=2, dtype=torch.float32)
    params_cpu = L.init_params(cfg, seed=SEED, device="cpu")
    params_gpu = {k: v.cuda() for k, v in params_cpu.items()}
    prompts = [rs.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 40, 17, 3, 29)]
    streams = {}
    for dev, params, fused, graphs in (("cuda", params_gpu, True, True),
                                       ("cuda", params_gpu, True, False),
                                       ("cuda", params_gpu, False, True),
                                       ("cpu", params_cpu, True, True)):
        eng = D.ContinuousBatchingEngine(
            cfg, D.GenerationConfig(max_new_tokens=8), num_slots=2,
            page_size=16, max_seq_len=128, chunk=4, device=dev,
            fused_tail=fused)
        eng._graphs = graphs
        streams[(dev, fused, graphs)] = eng.serve(params, prompts)
    if len({str(v) for v in streams.values()}) != 1:
        raise AssertionError(f"fused-tail streams differ: {streams}")
    out["fused_tail_tokens"] = streams[("cuda", True, True)]

    # fused optimizer: bitwise against the eager step on each device
    fused_ok = {}
    for dev in ("cuda", "cpu"):
        runs = []
        for fused in (False, True):
            gen = torch.Generator().manual_seed(SEED)
            ps = [torch.randn(s, generator=gen).to(dev).requires_grad_(True)
                  for s in ((64, 32), (32,), (128, 8))]
            opt = P.optimizer.Adam(
                learning_rate=P.optimizer.lr.StepDecay(0.01, 2, 0.5),
                parameters=ps, weight_decay=0.01,
                grad_clip=P.optimizer.ClipGradByGlobalNorm(1.0))
            if fused:
                jit.install_optimizer_fusion(opt)
            for k in range(4):
                g2 = torch.Generator().manual_seed(100 + k)
                for p in ps:
                    p.grad = torch.randn(p.shape, generator=g2).to(dev)
                opt.step()
                opt._learning_rate.step()
            runs.append([p.detach().clone() for p in ps] +
                        [v.clone() for s in opt.state.values()
                         for v in s.values()])
        _same(torch, runs[1], runs[0], f"fused Adam on {dev}")
        fused_ok[dev] = True
    out["fused_adam_bitwise"] = fused_ok
    return out


def _mt_padded(M, pairs, batches):
    """Phase 33's batches collated and padded by ``ShapeBucketer`` to the
    recipe's buckets (``M.JIT_BUCKETS``)."""
    S = M.surface("paddle_tpu_torch")
    raw = [M.collate([pairs[i] for i in b]) for b in batches]
    return [M.bucket_batch(S, *r) for r in raw], raw


def _mt_profile(torch, model, batch):
    """One step of ``model`` on ``batch`` under torch.profiler: wall ms,
    device ms and the idle share (None where the profiler saw no device
    time)."""
    from torch.profiler import ProfilerActivity, profile
    src, trg, lab = batch
    model.train_batch([src, trg], [lab])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.train_batch([src, trg], [lab])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kinds, top = _kernel_ms_by_kind(prof, MT_KINDS, n_top=6)
    busy = sum(kinds.values())
    return dict(wall_ms=wall, device_busy_ms=busy, kernel_ms=kinds,
                top_kernels=top,
                idle_share=(1 - busy / wall) if busy > 0 else None)


def jit_mt_base_phase(torch, ln):
    """(b) Transformer-base at full widths (phase 33's recipe) through
    ``Model.prepare(jit_compile=True)``: phase 33's 30 token buckets
    padded by ``ShapeBucketer`` (pad id BOS, which the source bias, the
    causal mask and the criterion's weights already ignore) to at most
    6 signatures, one CUDA graph each; the first 3 compiled steps equal
    the graphs-off ``TrainStep`` body bitwise (losses and weights); the
    same padded batches through the eager ``Model.fit``; step median,
    idle share, MFU and peak memory for both, captures, capture seconds
    and ``recompile_count`` for the compiled run. (e)
    ``install_optimizer_fusion`` on its Adam under the eager
    ``Model.fit``: 3 steps bitwise against the unfused optimizer, and
    the optimizer step's ms fused against unfused."""
    from scripts import transformer_mt as M
    S = M.surface("paddle_tpu_torch")
    P = S.paddle
    P.set_device("gpu")
    cfg = dict(M.BASE)
    pairs = M.sentence_pairs(3000, cfg["vocab"], 16, 128, seed=SEED)
    buckets = M.token_buckets(pairs, cfg["max_tokens"], cfg["max_length"])
    order = np.random.RandomState(SEED).permutation(len(buckets))
    batches = [buckets[i] for i in order[:MT_STEPS]]
    padded, raw = _mt_padded(M, pairs, batches)
    shapes = [(s.shape[0], s.shape[1], t.shape[1]) for s, t, _ in padded]
    real = [(len(b), max(len(pairs[i][0]) for i in b),
             max(len(pairs[i][1]) for i in b) + 1) for b in batches]
    sigs = sorted(set(shapes))
    if len(sigs) > 6:
        raise AssertionError(f"{len(sigs)} padded signatures: {sigs}")
    n_ln = 2 * cfg["n_enc"] + 3 * cfg["n_dec"]

    def fit(jit_compile, graphs=True, n=MT_STEPS, snapshot_at=None):
        """``Model.fit`` over the first ``n`` padded batches, each step
        timed by a callback (``float(loss)`` ends a step)."""
        torch.cuda.reset_peak_memory_stats()
        P.seed(SEED)
        net = M.build_model(S, cfg)
        model = M.prepare(S, net, cfg, jit_compile=jit_compile)
        if jit_compile:
            model._train_step._graphs = graphs
        step_ms, losses, snap, marks = [], [], {}, {}

        class Timer(S.callbacks.Callback):
            def on_train_batch_begin(self, step, logs=None):
                marks["t0"] = time.perf_counter()

            def on_train_batch_end(self, step, logs=None):
                step_ms.append((time.perf_counter() - marks["t0"]) * 1e3)
                losses.append(logs["loss"])
                if snapshot_at is not None and step + 1 == snapshot_at:
                    snap.update({k: v.detach().clone()
                                 for k, v in net.state_dict().items()})

        ln.layer_norm.launches = ln.layer_norm_bwd.launches = 0
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the guard's recaptures
            model.fit(padded[:n], epochs=1, verbose=0, shuffle=False,
                      callbacks=[Timer()])
        return dict(net=net, model=model, step_ms=step_ms, losses=losses,
                    snap=snap, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                    launches=(ln.layer_norm.launches,
                              ln.layer_norm_bwd.launches))

    def summary(run):
        timed = slice(5, None)
        sec = float(np.sum(run["step_ms"][timed])) / 1e3
        flops_pad = [_mt_flops(b, ss, st, cfg) for b, ss, st in shapes]
        flops_real = [_mt_flops(b, ss, st, cfg) for b, ss, st in real]
        return dict(
            median_step_ms_6_30=float(np.median(run["step_ms"][timed])),
            step_ms=run["step_ms"], losses=run["losses"],
            mfu_fp32_padded=float(np.sum(flops_pad[timed])) / sec
            / PEAK_OPS_PER_S["fp32"],
            mfu_fp32_real_tokens=float(np.sum(flops_real[timed])) / sec
            / PEAK_OPS_PER_S["fp32"],
            peak_mem_gb=run["peak_gb"])

    # the compiled run, its first 3 steps against the graphs-off body
    comp = fit(True, snapshot_at=3)
    ts = comp["model"]._train_step
    if comp["launches"] != (n_ln * MT_STEPS, n_ln * MT_STEPS):
        raise AssertionError(f"compiled LayerNorm launches "
                             f"{comp['launches']}")
    report = dict(
        config="Transformer-base (d_model 512, 8 heads, 6 + 6 layers, "
               "d_ff 2048, vocab 33712 shared, post-LN), fp32, TF32 off",
        reduced="none of the widths; phase 33's 30 synthetic "
                "WMT14-shaped buckets padded to the recipe's buckets",
        buckets=M.JIT_BUCKETS, padded_shapes=shapes, real_shapes=real,
        signatures=[list(s) for s in sigs],
        real_token_share=float(np.sum([b * (ss + st) for b, ss, st in real])
                               / np.sum([b * (ss + st)
                                         for b, ss, st in shapes])))
    compiled = summary(comp)
    compiled.update(captures=ts.programs.captures,
                    capture_s=ts.programs.capture_seconds,
                    recompile_count=ts.guard.recompile_count,
                    layer_norm_launches=list(comp["launches"]))
    if ts.programs.captures != len(sigs) or \
            ts.guard.recompile_count != len(sigs) - 1:
        raise AssertionError(f"{ts.programs.captures} captures for "
                             f"{len(sigs)} signatures")
    compiled["profiled_step"] = _mt_profile(torch, comp["model"],
                                            padded[len(padded) // 2])
    snap = comp.pop("snap")
    del comp
    gc.collect()
    torch.cuda.empty_cache()
    off = fit(True, graphs=False, n=3)
    for a, b in zip(compiled["losses"][:3], off["losses"]):
        if a != b:
            raise AssertionError(f"compiled losses {compiled['losses'][:3]} "
                                 f"!= graphs-off {off['losses']}")
    for k, v in off["net"].state_dict().items():
        if not torch.equal(v, snap[k]):
            raise AssertionError(f"compiled weight {k} after 3 steps != "
                                 "the graphs-off body's")
    compiled["first_3_bitwise_vs_graphs_off"] = True
    del off, snap
    gc.collect()
    torch.cuda.empty_cache()
    report["compiled"] = compiled

    # the eager run over the same padded batches
    eag = fit(False)
    eager = summary(eag)
    eager["profiled_step"] = _mt_profile(torch, eag["model"],
                                         padded[len(padded) // 2])
    report["eager"] = eager
    del eag
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the fused optimizer under the eager Model.fit
    runs = []
    for fused in (False, True):
        P.seed(SEED)
        net = M.build_model(S, cfg)
        model = M.prepare(S, net, cfg)
        if fused:
            S.jit.install_optimizer_fusion(model._optimizer)
        losses = [model.train_batch([s, t], [l])[0]
                  for s, t, l in padded[:3]]
        opt = model._optimizer
        state = [v.clone() for s in opt.state.values() for v in s.values()]
        runs.append((losses, {k: v.detach().clone()
                              for k, v in net.state_dict().items()}, state))
        # the optimizer step alone, on the last step's gradients
        s_, t_, l_ = [P.to_tensor(a) for a in padded[3]]
        loss = model._loss(net(s_, t_), l_)
        loss.backward()
        for _ in range(2):
            opt.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            opt.step()
        torch.cuda.synchronize()
        runs[-1] += ((time.perf_counter() - t0) * 1e2,
                     opt._fused_step.steps_fused if fused else 0)
        del net, model, opt, loss
        gc.collect()
        torch.cuda.empty_cache()
    (ul, uw, us, ums, _), (fl_, fw, fs, fms, nf) = runs
    if ul != fl_:
        raise AssertionError(f"fused Adam losses {fl_} != unfused {ul}")
    for k in uw:
        if not torch.equal(uw[k], fw[k]):
            raise AssertionError(f"fused Adam weight {k} != unfused")
    _same(torch, fs, us, "fused Adam state")
    report["fused_adam"] = dict(bitwise_3_steps=True, losses=fl_,
                                optimizer_step_ms_unfused=ums,
                                optimizer_step_ms_fused=fms,
                                steps_fused=nf)
    return report


def jit_predictor_phase(torch, ln):
    """(c) ``jit.save`` of Transformer-base's forward (eval, sources and
    targets of 8 × 64 tokens), then ``inference.create_predictor(Config
    (prefix))`` on the card: the output against the layer's own forward
    on the card, row 8's launches counted inside the predictor (30 a
    run), save and load seconds, ms per ``run``."""
    from scripts import transformer_mt as M
    from paddle_tpu_torch import inference, testing
    S = M.surface("paddle_tpu_torch")
    P = S.paddle
    cfg = dict(M.BASE)
    P.seed(SEED)
    net = M.build_model(S, cfg)
    net.eval()
    rs = np.random.RandomState(SEED)
    src = rs.randint(2, cfg["vocab"], (8, 64)).astype(np.int32)
    trg = rs.randint(2, cfg["vocab"], (8, 64)).astype(np.int32)
    src[3, 50:] = M.BOS
    with P.no_grad():
        want = net(P.to_tensor(src), P.to_tensor(trg))._value.float().cpu()
    path = os.path.join("build", "jit_mt_base", "m")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    S.jit.save(net, path, input_spec=[P.static.InputSpec([8, 64], "int32"),
                                      P.static.InputSpec([8, 64], "int32")])
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = inference.create_predictor(inference.Config(path))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ln.layer_norm.launches = 0
    got = pred.run([src, trg])[0]                 # capture
    ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pred.run([src, trg])[0]
        ms.append((time.perf_counter() - t0) * 1e3)
    n_ln = 2 * cfg["n_enc"] + 3 * cfg["n_dec"]
    if ln.layer_norm.launches != 11 * n_ln:
        raise AssertionError(f"predictor row 8 launches "
                             f"{ln.layer_norm.launches} != {11 * n_ln}")
    if not np.array_equal(got, out):
        raise AssertionError("predictor replays differ")
    tol = testing.MT_FIT
    err = testing.close(torch.from_numpy(got), want, tol["rtol"], tol["atol"],
                        "predictor vs the layer's forward")
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    captures = pred.programs.captures
    del net, pred
    gc.collect()
    torch.cuda.empty_cache()
    return dict(shape=[8, 64, 64], max_abs_err_vs_layer=err,
                layer_norm_launches=ln.layer_norm.launches,
                layer_norm_launches_per_run=n_ln, save_s=save_s,
                load_s=load_s, run_ms_median=float(np.median(ms)),
                captures=captures)


def _dispatch_arms(torch, ln, rn, fa):
    """The two dispatches of rows 1, 8 and 5's forwards on the card:
    ``direct`` calls each kernel's wrapper, ``op`` goes through its
    ``torch.library`` custom op (the form an exported program holds).
    Each arm maps a module's dispatcher name to its function."""
    def fa_direct(q, k, v, scale, causal, kv_valid=None, causal_offset=0,
                  kv_rep=1, seg_q=None, seg_k=None):
        return fa.flash_fwd_kernel(q, k, v, scale, causal, kv_valid,
                                   causal_offset, kv_rep, seg_q, seg_k)

    def fa_op(q, k, v, scale, causal, kv_valid=None, causal_offset=0,
              kv_rep=1, seg_q=None, seg_k=None):
        return fa.flash_fwd_op(q, k, v, float(scale), bool(causal), kv_valid,
                               int(causal_offset), int(kv_rep), seg_q, seg_k)
    return {
        "direct": {(rn, "_rms_norm_fwd"): rn.rms_norm_kernel,
                   (ln, "_layer_norm_fwd"): ln.layer_norm_kernel,
                   (fa, "flash_attention_fwd"): fa_direct},
        "op": {(rn, "_rms_norm_fwd"): rn.rms_norm_op,
               (ln, "_layer_norm_fwd"): ln.layer_norm_op,
               (fa, "flash_attention_fwd"): fa_op}}


def dispatch_cost_phase(torch, ln, rn, fa):
    """(f) The host cost of the custom-op dispatch of rows 1, 8 and 5
    against the direct call of their kernel wrappers: the µs a call at
    decoding's shapes (2000 calls an arm, host-bound: a kernel takes a
    few µs), and Transformer-base's greedy decoding (phase 33's 64
    sources, 128 steps: 19 row-8 and 12 row-5 launches a step) with each
    arm patched into the modules' dispatchers; after a full-length warm
    run each, the arms alternate in ABBA order, 4 runs each, and must
    emit the same tokens."""
    from scripts import transformer_mt as M
    S = M.surface("paddle_tpu_torch")
    P = S.paddle
    arms = _dispatch_arms(torch, ln, rn, fa)
    saved = {k: getattr(*k) for k in arms["direct"]}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    xr = torch.randn(8, 4096, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    xl = torch.randn(MT_DECODE_B, 512, generator=gen, device="cuda")
    q = torch.randn(MT_DECODE_B * 8, 1, 64, generator=gen, device="cuda")
    kv = torch.randn(MT_DECODE_B * 8, 128, 64, generator=gen, device="cuda")
    calls = {"rms_norm_fwd": lambda f: f(xr, xr[0], 1e-5),
             "layer_norm_fwd": lambda f: f(xl, xl[0], xl[1], 1e-5),
             "flash_attention_fwd": lambda f: f(q, kv, kv, 0.125, False)}
    names = {"rms_norm_fwd": (rn, "_rms_norm_fwd"),
             "layer_norm_fwd": (ln, "_layer_norm_fwd"),
             "flash_attention_fwd": (fa, "flash_attention_fwd")}
    per_call = {n: {a: [] for a in arms} for n in calls}
    for n, call in calls.items():
        for a in arms:
            call(arms[a][names[n]])                         # warm
        for _ in range(3):
            for a in arms:
                f = arms[a][names[n]]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(2000):
                    call(f)
                torch.cuda.synchronize()
                per_call[n][a].append((time.perf_counter() - t0) / 2000
                                      * 1e6)
    P.seed(SEED)
    cfg = dict(M.BASE)
    net = M.build_model(S, cfg)
    net.eval()
    dsrc = P.to_tensor(np.random.RandomState(SEED).randint(
        2, cfg["vocab"], (MT_DECODE_B, 64)).astype(np.int32))
    step_ms = {a: [] for a in arms}
    tokens = {}
    try:
        for a in arms:               # warm: the caches' full length too
            for k, f in arms[a].items():
                setattr(*k, f)
            M.greedy_decode(S, net, dsrc, MT_DECODE_STEPS,
                            memory_mask=False)
        for r in range(4):           # ABBA: drift cancels in the medians
            for a in (("direct", "op") if r % 2 == 0 else ("op", "direct")):
                for k, f in arms[a].items():
                    setattr(*k, f)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks = M.greedy_decode(S, net, dsrc, MT_DECODE_STEPS,
                                       memory_mask=False)
                torch.cuda.synchronize()
                step_ms[a].append((time.perf_counter() - t0) * 1e3
                                  / MT_DECODE_STEPS)
                tokens.setdefault(a, np.asarray(toks._value.cpu()))
    finally:
        for k, f in saved.items():
            setattr(*k, f)
    if not np.array_equal(tokens["direct"], tokens["op"]):
        raise AssertionError("greedy tokens differ between the dispatches")
    del net
    gc.collect()
    torch.cuda.empty_cache()
    return dict(per_call_us=per_call, greedy_step_ms=step_ms,
                greedy_op_minus_direct_ms=float(
                    np.median(step_ms["op"]) - np.median(step_ms["direct"])))


def fused_tail_7b_phase(torch, D, rn, pa, cfg, params, serve, greedy):
    """(d) Llama-2-7B (phase 7's configuration) through the unified
    engine with ``fused_tail=True``: the streams equal phase 7's token
    for token, the same one build, 2 plan uploads a step (plus the block
    table) against the unfused program's 8, the step wall beside phase
    7's; ``enable_fused_tail()`` after 3 steps of an unfused serve adds
    one counted rebuild and the streams stay equal; and the speculative
    step fused at phase 21's configuration (spec_k 4, the n-gram
    drafter) gives phase 7's streams."""
    prompts = serve_load(cfg)
    n_layers = cfg.num_hidden_layers
    rn.rms_norm.launches = 0
    _reset_ragged(pa)
    eng = _serve_engine(D, cfg, step_tokens=256, fused_tail=True)
    t0 = time.perf_counter()
    outs, step_ms = _serve_checked(eng, params, prompts)
    serve_s = time.perf_counter() - t0
    if outs != greedy:
        raise AssertionError("fused-tail streams differ from phase 7's")
    _check_outputs(cfg, outs, eng)
    programs = _programs(eng, "cbe.unified_step")
    prog = eng._unified_step
    launches = {"rms_norm_fwd": rn.rms_norm.launches,
                **_ragged_launches(pa)}
    want = {"rms_norm_fwd": (2 * n_layers + 1) * eng.micro_rounds,
            **_ragged_want(torch, pa, n_layers * eng.micro_rounds)}
    if launches != want:
        raise AssertionError(f"fused launches {launches} != {want}")
    uploads = prog.uploads / prog.calls
    if uploads != 3:
        raise AssertionError(f"fused step uploads {uploads} a step")
    report = dict(serve_s=serve_s, steps=len(step_ms),
                  mean_step_ms=float(np.mean(step_ms)),
                  phase7_mean_step_ms=serve["mean_step_ms"],
                  uploads_per_step=dict(fused_plan=2, fused_total=uploads,
                                        unfused_plan=8, unfused_total=9),
                  programs=programs, launches=launches,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # the step wall fused against unfused: two warm engines, their
    # serves alternating, 3 each, with the host's planning ms a step
    # (the packed plan's ``_plan_step_packed`` against ``_plan_step``)
    engs = {"unfused": _serve_engine(D, cfg, step_tokens=256), "fused": eng}
    if _serve_checked(engs["unfused"], params, prompts)[0] != greedy:
        raise AssertionError("unfused streams differ from phase 7's")
    plan_s = {}
    for name, meth in (("unfused", "_plan_step"),
                       ("fused", "_plan_step_packed")):
        acc = plan_s[name] = [0.0]

        def timed(*a, _f=getattr(engs[name], meth), _acc=acc, **k):
            t0 = time.perf_counter()
            try:
                return _f(*a, **k)
            finally:
                _acc[0] += time.perf_counter() - t0
        setattr(engs[name], meth, timed)
    alt = {n: dict(mean_step_ms=[], plan_ms_per_step=[]) for n in engs}
    for _ in range(3):
        for name, e in engs.items():
            plan_s[name][0] = 0.0
            outs, step_ms = _serve_checked(e, params, prompts)
            if outs != greedy:
                raise AssertionError(f"{name} streams differ from phase 7's")
            alt[name]["mean_step_ms"].append(float(np.mean(step_ms)))
            alt[name]["plan_ms_per_step"].append(
                plan_s[name][0] * 1e3 / len(step_ms))
    report["alternating"] = alt
    del eng, prog, engs
    _free_card(torch)

    # enable_fused_tail() mid-serve
    eng = _serve_engine(D, cfg, step_tokens=256)
    rids = [eng.submit(p) for p in prompts]
    for _ in range(3):
        eng.step(params)
    eng.enable_fused_tail()
    done = dict(eng.collect())
    n = 3
    while len(done) < len(rids):
        eng.step(params)
        eng.mgr.check_conservation()
        done.update(eng.collect())
        n += 1
        if n > 200:
            raise AssertionError("mid-serve fused serve did not finish")
    if [done[r] for r in rids] != greedy:
        raise AssertionError("streams changed after enable_fused_tail()")
    keys = [k[4] for name, k in eng.compile_misses]
    if keys != [False, True]:
        raise AssertionError(f"enable_fused_tail builds {eng.compile_misses}")
    report["mid_serve"] = dict(builds=len(keys), steps=n)
    del eng
    _free_card(torch)

    # the speculative step, fused
    eng = _serve_engine(D, cfg, step_tokens=256, speculative=True,
                        spec_k=4, fused_tail=True)
    t0 = time.perf_counter()
    outs, step_ms = _serve_checked(eng, params, prompts)
    if outs != greedy:
        raise AssertionError("fused speculative streams differ from "
                             "phase 7's")
    if [n for n, _ in eng.compile_misses] != ["cbe.spec_step"]:
        raise AssertionError(f"program builds {eng.compile_misses}")
    report["speculative"] = dict(
        rounds=eng.spec_rounds, serve_s=time.perf_counter() - t0,
        mean_step_ms=float(np.mean(step_ms)),
        uploads_per_round=eng._spec_step.uploads / eng._spec_step.calls,
        spec=eng.spec.snapshot())
    report["launches"] = {k: v for k, v in launches.items()}
    del eng
    _free_card(torch)
    return report


# ---------------------------------------------------------------------------
# phase 35: Distributed I — the collective API over a one-rank NCCL group,
# the remat policies at 7B widths, recompute with dropout
# ---------------------------------------------------------------------------

def _collective_calls(torch, D, device):
    """Every collective of the API at this one rank, on ``device``'s
    tensors (fp32 and bf16): the results on the host, in call order."""
    from paddle_tpu_torch.core.tensor import Tensor
    from paddle_tpu_torch.parallel import mesh as pmesh
    base = torch.randn(4096, generator=torch.Generator().manual_seed(SEED))

    def t(x):
        return Tensor._wrap(x.to(device), True)

    out = {}
    for op in ("sum", "max", "min", "avg", "prod"):
        x = t(base)
        D.all_reduce(x, op=op)
        out[f"all_reduce_{op}"] = x
    x = t(base.to(torch.bfloat16))
    D.all_reduce(x)
    out["all_reduce_bf16"] = x
    out["all_gather"] = D.all_gather(t(base))
    parts = []
    D.all_gather(parts, t(base))
    out["all_gather_list"] = parts[0]
    out["reduce_scatter"] = D.reduce_scatter(t(base))
    x = t(torch.zeros(4096))
    D.reduce_scatter(x, [t(3 * base)])
    out["reduce_scatter_list"] = x
    out["alltoall"] = D.alltoall(t(base))
    x = t(base)
    D.broadcast(x, src=0)
    out["broadcast"] = x
    x = t(base)
    D.reduce(x, dst=0)
    out["reduce"] = x
    out["gather"] = D.gather(t(base), dst=0)[0]
    x = t(torch.zeros(4096))
    D.scatter(x, [t(2 * base)], src=0)
    out["scatter"] = x
    out["all_reduce_replicated"] = D.collective.all_reduce_replicated(t(base))
    x = t(base)
    D.all_reduce(x, group=D.new_group(ranks=[0]))
    out["new_group_ranks"] = x
    pmesh.set_global_mesh(pmesh.build_mesh({}))
    x = t(base)
    D.all_reduce(x, group=D.new_group(axis="mp"))
    out["new_group_axis"] = x
    pmesh.set_global_mesh(None)
    objs = []
    D.all_gather_object(objs, {"rank": D.get_rank(), "v": [1, 2.5]})
    bl = ["a", 7]
    D.broadcast_object_list(bl, src=0)
    so = []
    D.scatter_object_list(so, [{"to": 0}], src=0)
    D.barrier()
    D.wait(out["all_reduce_sum"])
    res = {k: v._value.detach().float().cpu() if hasattr(v, "_value")
           else v.detach().float().cpu() for k, v in out.items()}
    res["objects"] = (objs, bl, so)
    return res


def distributed_phase(torch):
    """(a) ``init_parallel_env()`` with ``PADDLE_TRAINERS_NUM=1`` and an
    explicit ``PADDLE_MASTER``: a one-rank NCCL group on the card. Every
    collective of the API, both ``new_group`` forms, the object
    collectives, ``barrier`` and ``destroy_process_group`` on CUDA
    tensors, bitwise against the same calls over a one-rank gloo group
    on the CPU; the native ``TCPStore`` round trip; ``RNGStatesTracker``
    draws card == CPU. Point-to-point calls need two ranks: one card
    holds one NCCL rank, so they are checked on gloo ranks (tier-1)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import random as R
    from paddle_tpu_torch.distributed import store as ST
    from paddle_tpu_torch.distributed.launch.context import free_port
    from paddle_tpu_torch.distributed.meta_parallel import random_state
    saved = {k: os.environ.get(k) for k in
             ("PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID", "PADDLE_MASTER")}
    runs, backends, init_ms = {}, {}, {}
    try:
        os.environ.update(PADDLE_TRAINERS_NUM="1", PADDLE_TRAINER_ID="0")
        for dev in ("cpu", "cuda"):
            os.environ["PADDLE_MASTER"] = f"127.0.0.1:{free_port()}"
            t0 = time.perf_counter()
            D.init_parallel_env(device=None if dev == "cuda" else "cpu")
            init_ms[dev] = (time.perf_counter() - t0) * 1e3
            backends[dev] = D.get_backend()
            runs[dev] = _collective_calls(torch, D, dev)
            D.destroy_process_group()
            if D.is_initialized() or D.env.distributed_is_initialized():
                raise AssertionError("destroy_process_group left a group")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if backends != {"cpu": "GLOO", "cuda": "NCCL"}:
        raise AssertionError(f"backends {backends}")
    if runs["cuda"]["objects"] != runs["cpu"]["objects"]:
        raise AssertionError(f"object collectives {runs['cuda']['objects']} "
                             f"!= {runs['cpu']['objects']}")
    calls = sorted(k for k in runs["cpu"] if k != "objects")
    for k in calls:
        if not torch.equal(runs["cuda"][k], runs["cpu"][k]):
            raise AssertionError(f"{k}: NCCL != gloo")

    # the native store
    s = ST.TCPStore(is_master=True, world_size=1, timeout=30.0)
    try:
        t0 = time.perf_counter()
        for i in range(200):
            s.set(f"k{i}", b"v" * 64)
            if s.get(f"k{i}") != b"v" * 64:
                raise AssertionError("TCPStore round trip")
        rt_us = (time.perf_counter() - t0) / 200 * 1e6
        if s.add("n", 5) != 5 or s.add("n", -2) != 3:
            raise AssertionError("TCPStore.add")
        s.wait("n", timeout=1.0)
        s.barrier("smoke")
        s.delete_key("k0")
        store = dict(backend=s.backend, daemon=s.daemon.backend,
                     set_get_us=rt_us)
    finally:
        s.close()
    if store["backend"] != "native" or store["daemon"] != "native":
        raise AssertionError(f"the native store did not build: {store}")

    # the tracker's draws on the card and on the host
    draws = {}
    for dev in ("cpu", "cuda"):
        random_state.model_parallel_random_seed(1234)
        tr = random_state.get_rng_state_tracker()
        with tr.rng_state():
            u = R.uniform_draw(R.next_key(), (1 << 20,), device=dev)
            m = R.bernoulli_draw(R.next_key(), 0.9, (1 << 20,), device=dev)
        with tr.rng_state():
            n = R.normal_draw(R.next_key(), (1 << 16,), device=dev)
        draws[dev] = [x.cpu() for x in (u, m, n)]
    tracker_equal = [torch.equal(a, b) for a, b in
                     zip(draws["cuda"][:2], draws["cpu"][:2])]
    if not all(tracker_equal):
        raise AssertionError("tracker uniform/bernoulli draws card != cpu")
    normal_max_diff = float((draws["cuda"][2] - draws["cpu"][2]).abs().max())
    if normal_max_diff > 1e-5:
        raise AssertionError(f"tracker normal draws differ by "
                             f"{normal_max_diff}")
    return dict(backends=backends, init_ms=init_ms, collectives=calls,
                bitwise=True, store=store, tracker_bitwise=tracker_equal,
                tracker_normal_max_diff=normal_max_diff)


def _weights_digest(torch, params, want=None):
    """The sum of every weight in fp64 and, against ``want`` (another
    run's weights), the tensors that differ and their largest gap."""
    total = sum(float(v.double().sum()) for v in params.values())
    if want is None:
        return dict(sum=total)
    diff = {k: float((params[k].float() - want[k].float()).abs().max())
            for k in params if not torch.equal(params[k], want[k])}
    return dict(sum=total, bitwise=not diff, differ=diff)


#: phase 35 (b)'s steps a policy: one warm-up and three timed
REMAT_STEPS = 4


class _GcPauses:
    """The milliseconds Python's cyclic garbage collector ran while
    inside (``gc.callbacks``): a host pause inside a timed step."""

    def __enter__(self):
        self.ms, self._t0 = 0.0, None
        gc.callbacks.append(self._note)
        return self

    def _note(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self._t0 = None

    def __exit__(self, *exc):
        gc.callbacks.remove(self._note)
        return False


def remat_7b_phase(torch, L, rn, fa):
    """(b) Phase 12's configuration (Llama-2-7B widths, 8 layers, bf16,
    one (8, 2048) microbatch) under each remat policy: ``full``,
    ``dots``, ``attn``, ``offload`` and ``full`` again (the repeat shows
    the card's own run-to-run bits), each from the same weights for 1
    warm-up and 3 timed steps (with the garbage collector's pauses inside
    each). Losses and weights against ``full``'s;
    step ms, tokens/s, MFU, peak memory above the weights and the AdamW
    state, the bytes ``offload`` moves to the host a step, and each
    policy's launches of rows 1, 2, 5 and 6 against its ``want``."""
    cfg = L.llama2_7b(num_hidden_layers=8, dtype=torch.bfloat16)
    n = cfg.num_hidden_layers
    b, s = 8, 2048
    _, init = L.build_train_step(cfg, learning_rate=1e-4, device="cuda")
    params0, _ = init(seed=SEED)
    rng = np.random.RandomState(SEED)
    ids_np = rng.randint(0, cfg.vocab_size, (1, b, s)).astype(np.int64)
    ids = torch.from_numpy(ids_np).cuda()
    labels = torch.from_numpy(np.roll(ids_np, -1, axis=-1)).cuda()
    counters = {"rms_norm_fwd": rn.rms_norm, "rms_norm_bwd": rn.rms_norm_bwd,
                "flash_attention_fwd": fa.flash_fwd_kernel,
                "flash_attention_bwd_dq": fa.flash_bwd_dq_kernel,
                "flash_attention_bwd_dkv": fa.flash_bwd_dkv_kernel}
    replay = {"full": 2 * n, "dots": 2 * n, "attn": n, "offload": n}
    n_matmul = L.param_count(cfg) - cfg.vocab_size * cfg.hidden_size
    flops_per_token = 6.0 * n_matmul + 6.0 * n * s * cfg.hidden_size
    out, totals, full_params = {}, {k: 0 for k in counters}, None
    for run in ("full", "dots", "attn", "offload", "full_again"):
        policy = run.split("_")[0]
        want = {"rms_norm_fwd": 4 * n + 1, "rms_norm_bwd": 2 * n + 1,
                "flash_attention_fwd": replay[policy],
                "flash_attention_bwd_dq": n, "flash_attention_bwd_dkv": n}
        step, _ = L.build_train_step(cfg, learning_rate=1e-4, remat=True,
                                     remat_policy=policy, device="cuda")
        params = {k: v.clone() for k, v in params0.items()}
        opt = L.init_opt_state(params)
        gc.collect()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, offload, gc_ms = [], [], [], []
        for i in range(REMAT_STEPS):
            for c in counters.values():
                c.launches = 0
            L.offload_bytes[0] = 0
            torch.cuda.synchronize()
            with _GcPauses() as gp:
                t0 = time.perf_counter()
                loss, params, opt = step(params, opt, ids, labels)
                losses.append(float(loss))
                step_ms.append((time.perf_counter() - t0) * 1e3)
            gc_ms.append(gp.ms)
            offload.append(L.offload_bytes[0])
            got = {k: c.launches for k, c in counters.items()}
            if got != want:
                raise AssertionError(f"{run} step {i}: launches {got} != "
                                     f"{want}")
            for k in totals:
                totals[k] += got[k]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{run}: non-finite loss {losses}")
        peak_gb = (torch.cuda.max_memory_allocated() - resident) / 1e9
        mean_ms = float(np.mean(step_ms[1:]))
        tok_s = b * s / (mean_ms / 1e3)
        r = dict(losses=losses, step_ms=step_ms, mean_step_ms=mean_ms,
                 gc_ms=gc_ms, tokens_per_s=tok_s,
                 mfu_vs_989tflops=flops_per_token * tok_s
                 / PEAK_OPS_PER_S["bf16"],
                 peak_above_state_gb=peak_gb,
                 resident_gb=resident / 1e9,
                 offload_bytes_per_step=offload[-1],
                 launches_per_step=want)
        if full_params is None:
            full_params = {k: v.clone() for k, v in params.items()}
            full_losses = losses
            r["weights"] = _weights_digest(torch, params)
        else:
            r["weights"] = _weights_digest(torch, params, full_params)
            r["losses_equal_full"] = losses == full_losses
            r["first_loss_gap"] = max(abs(a - c) for a, c in
                                      zip(losses, full_losses))
        out[run] = r
        del params, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    if out["offload"]["offload_bytes_per_step"] != n * (
            b * s * cfg.hidden_size * 2 + b * cfg.num_attention_heads * s * 4):
        raise AssertionError("offload moved other bytes than L x (out + LSE)")
    for run in ("dots", "attn", "offload", "full_again"):
        gap = out[run]["first_loss_gap"]
        if gap > 5e-3 * abs(full_losses[0]):
            raise AssertionError(f"{run}: losses {out[run]['losses']} far "
                                 f"from full's {full_losses}")
    del params0, full_params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=n, reduced="num_hidden_layers 32 -> 8 (memory)",
                batch=[1, b, s], steps=REMAT_STEPS, runs=out,
                launches=totals)


def recompute_mt_phase(torch, ln):
    """(c) Phase 33's Transformer-base (fp32, TF32 off) with every
    encoder and decoder layer under ``fleet.recompute``, its Adam
    wrapped in ``AMPOptimizer``: 3 steps against the same 3 steps
    without recompute, from the same weights and key stream (dropout
    0.1 on). Losses and every gradient bitwise (the key stream
    replays); step ms with the garbage collector's pauses inside them,
    peak memory above the resident state, and row 8's launches per step
    for both."""
    from scripts import transformer_mt as M
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import meta_optimizers as MO
    S = M.surface("paddle_tpu_torch")
    P = S.paddle
    P.set_device("gpu")
    cfg = dict(M.BASE)
    pairs = M.sentence_pairs(3000, cfg["vocab"], 16, 128, seed=SEED)
    buckets = M.token_buckets(pairs, cfg["max_tokens"], cfg["max_length"])
    order = np.random.RandomState(SEED).permutation(len(buckets))
    batches = [buckets[i] for i in order[:3]]
    loader = list(M.make_loader(S, pairs, 0, 256, batches))
    crit = M.make_criterion(S, cfg["vocab"])
    runs = {}
    for use_rc in (False, True):
        P.seed(SEED)
        net = M.build_model(S, cfg)
        if use_rc:
            tr = net.transformer
            for lyr in list(tr.encoder.layers) + list(tr.decoder.layers):
                lyr.forward = functools.partial(fleet.recompute, lyr.forward)
        opt = MO.AMPOptimizer(M.make_optimizer(S, net, cfg["d_model"]),
                              {"level": "O1", "dtype": "bfloat16"})
        P.seed(SEED + 1)                     # the dropout stream
        gc.collect()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses, grads, step_ms, ln_launches, gc_ms = [], [], [], [], []
        for batch in loader:
            src, trg, lab = (P.to_tensor(a) for a in batch)
            ln.layer_norm.launches = ln.layer_norm_bwd.launches = 0
            torch.cuda.synchronize()
            with _GcPauses() as gp:
                t0 = time.perf_counter()
                loss = crit(net(src, trg), lab)
                loss.backward()
                losses.append(float(loss))
                g = [p.grad.detach().clone() for p in net.parameters()]
                opt.step()
                opt.clear_grad()
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            grads.append(g)
            gc_ms.append(gp.ms)
            ln_launches.append((ln.layer_norm.launches,
                                ln.layer_norm_bwd.launches))
        runs[use_rc] = dict(
            losses=losses, grads=grads, step_ms=step_ms, gc_ms=gc_ms,
            peak_above_state_gb=(torch.cuda.max_memory_allocated()
                                 - resident) / 1e9,
            layer_norm_launches=ln_launches,
            weights=[p.detach().clone() for p in net.parameters()])
        del net, opt
    plain, rc = runs[False], runs[True]
    if rc["losses"] != plain["losses"]:
        raise AssertionError(f"losses {rc['losses']} != {plain['losses']}")
    for i, (ga, gb) in enumerate(zip(rc["grads"], plain["grads"])):
        bad = [j for j, (a, b) in enumerate(zip(ga, gb))
               if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"step {i}: gradients {bad} differ")
    if not all(torch.equal(a, b) for a, b in zip(rc["weights"],
                                                 plain["weights"])):
        raise AssertionError("weights differ after the steps")
    n_ln = 2 * cfg["n_enc"] + 3 * cfg["n_dec"]
    for r in (plain, rc):
        del r["grads"], r["weights"]
    if any(f != n_ln or bw != n_ln for f, bw in plain["layer_norm_launches"]):
        raise AssertionError(f"plain LayerNorm launches "
                             f"{plain['layer_norm_launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    shapes = [tuple(int(d) for d in trg.shape) for _, trg, _ in loader]
    return dict(batches=shapes, bitwise=True, plain=plain, recompute=rc,
                launches={"layer_norm_fwd": sum(
                    f for f, _ in plain["layer_norm_launches"]
                    + rc["layer_norm_launches"]),
                    "layer_norm_bwd": sum(
                    bw for _, bw in plain["layer_norm_launches"]
                    + rc["layer_norm_launches"])})


# ---------------------------------------------------------------------------
# phase 36: Distributed II (the hybrid step, the Fleet path)
# ---------------------------------------------------------------------------

#: phase 36 (a)'s steps a run
HYBRID_STEPS = 3
#: phase 36 (b)'s steps a run
FLEET_STEPS = 5


def _one_rank_nccl(D):
    """A one-rank NCCL process group (``init_parallel_env`` with
    ``PADDLE_TRAINERS_NUM=1`` and an explicit ``PADDLE_MASTER``); returns
    the environment to restore after ``destroy_process_group``."""
    from paddle_tpu_torch.distributed.launch.context import free_port
    saved = {k: os.environ.get(k) for k in
             ("PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID", "PADDLE_MASTER")}
    os.environ.update(PADDLE_TRAINERS_NUM="1", PADDLE_TRAINER_ID="0",
                      PADDLE_MASTER=f"127.0.0.1:{free_port()}")
    D.init_parallel_env()
    if D.get_backend() != "NCCL":
        raise AssertionError(f"backend {D.get_backend()}, not NCCL")
    return saved


def _restore_env(saved):
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _train_counters(rn, fa):
    return {"rms_norm_fwd": rn.rms_norm, "rms_norm_bwd": rn.rms_norm_bwd,
            "flash_attention_fwd": fa.flash_fwd_kernel,
            "flash_attention_bwd_dq": fa.flash_bwd_dq_kernel,
            "flash_attention_bwd_dkv": fa.flash_bwd_dkv_kernel}


def hybrid_7b_phase(torch, L, rn, fa):
    """(a) The hybrid step over a one-rank NCCL mesh at phase 12's
    configuration, against phase 12's step run again here from the same
    weights: every collective is its input itself (no copy), so the body
    is the one-device step's work. Returns the report and the process
    group's saved environment (phase 36 (b) runs on the same group)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.parallel import mesh as pmesh
    from paddle_tpu_torch.testing import HYBRID_LOSS_TOL
    cfg = L.llama2_7b(num_hidden_layers=8, dtype=torch.bfloat16)
    n = cfg.num_hidden_layers
    b, s = 8, 2048
    _, init = L.build_train_step(cfg, learning_rate=1e-4, device="cuda")
    params0, _ = init(seed=SEED)
    rng = np.random.RandomState(SEED)
    ids_np = rng.randint(0, cfg.vocab_size, (1, b, s)).astype(np.int64)
    ids = torch.from_numpy(ids_np).cuda()
    labels = torch.from_numpy(np.roll(ids_np, -1, axis=-1)).cuda()
    counters = _train_counters(rn, fa)
    want = {"rms_norm_fwd": 4 * n + 1, "rms_norm_bwd": 2 * n + 1,
            "flash_attention_fwd": 2 * n, "flash_attention_bwd_dq": n,
            "flash_attention_bwd_dkv": n}
    totals = {k: 0 for k in counters}

    def run(step, params, what):
        opt = L.init_opt_state(params)
        gc.collect()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for i in range(HYBRID_STEPS):
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, params, opt = step(params, opt, ids, labels)
            losses.append(float(loss))
            ms.append((time.perf_counter() - t0) * 1e3)
            got = {k: c.launches for k, c in counters.items()}
            if got != want:
                raise AssertionError(f"{what} step {i}: launches {got} != "
                                     f"{want}")
            if what == "hybrid":
                for k in totals:
                    totals[k] += got[k]
        peak = (torch.cuda.max_memory_allocated() - resident) / 1e9
        del opt
        return losses, ms, peak, params

    one, _ = L.build_train_step(cfg, learning_rate=1e-4, remat=True,
                                device="cuda")
    l12, ms12, peak12, p = run(one, {k: v.clone() for k, v in
                                     params0.items()}, "one-device")
    del p, one
    saved = _one_rank_nccl(D)
    t0 = time.perf_counter()
    mesh = pmesh.build_mesh({})
    pmesh.set_global_mesh(mesh)
    mesh_ms = (time.perf_counter() - t0) * 1e3
    hstep, _ = L.build_hybrid_train_step(cfg, mesh, learning_rate=1e-4,
                                         remat=True, device="cuda")
    params = hstep.shard(params0)          # one rank: each slab is whole
    del params0
    lh, msh, peakh, p = run(hstep, params, "hybrid")
    del p, params, hstep
    gc.collect()
    torch.cuda.empty_cache()
    rtol, atol = HYBRID_LOSS_TOL
    for a, c in zip(lh, l12):
        if not math.isfinite(a) or abs(a - c) > atol + rtol * abs(c):
            raise AssertionError(f"hybrid losses {lh} far from the "
                                 f"one-device step's {l12}")
    report = dict(layers=n, reduced="num_hidden_layers 32 -> 8 (memory)",
                  batch=[1, b, s], steps=HYBRID_STEPS, mesh=dict(mesh.shape),
                  mesh_build_ms=mesh_ms, losses=lh, one_device_losses=l12,
                  bitwise=lh == l12, tol=HYBRID_LOSS_TOL,
                  step_ms=msh, one_device_step_ms=ms12,
                  median_step_ms=float(np.median(msh)),
                  one_device_median_step_ms=float(np.median(ms12)),
                  peak_above_state_gb=peakh,
                  one_device_peak_above_state_gb=peak12,
                  launches_per_step=want, launches=totals)
    return report, saved


def _llama_pipe_layers(L, cfg):
    """Llama as a ``PipelineLayer``'s entries: the embedding, each decoder
    layer (RoPE tables made from its input), the final norm and head."""
    from paddle_tpu_torch.distributed.meta_parallel import LayerDesc
    from paddle_tpu_torch.distributed.meta_parallel import mp_layers as mpl
    from paddle_tpu_torch.nn.common_layers import RMSNorm
    from paddle_tpu_torch.nn.layer import Layer
    from paddle_tpu_torch.ops import rope as rope_ops

    class Embed(Layer):
        def __init__(self, c):
            super().__init__()
            self.embed = mpl.VocabParallelEmbedding(
                c.vocab_size, c.hidden_size, dtype=c.dtype, device="cuda")

        def forward(self, ids):
            return self.embed(ids)

    class Block(Layer):
        def __init__(self, c):
            super().__init__()
            self.c = c
            self.layer = L.LlamaDecoderLayer(c, device="cuda")

        def forward(self, x):
            cos, sin = rope_ops.build_rope_cache(
                x.shape[1], self.c.head_dim, self.c.rope_theta, device="cuda")
            return self.layer(x, cos, sin)

    class Head(Layer):
        def __init__(self, c):
            super().__init__()
            self.norm = RMSNorm(c.hidden_size, epsilon=c.rms_norm_eps,
                                dtype=c.dtype, device="cuda")
            self.lm_head = mpl.ColumnParallelLinear(
                c.hidden_size, c.vocab_size, has_bias=False, dtype=c.dtype,
                device="cuda")

        def forward(self, x):
            return self.lm_head(self.norm(x))

    return ([LayerDesc(Embed, cfg)]
            + [LayerDesc(Block, cfg) for _ in range(cfg.num_hidden_layers)]
            + [LayerDesc(Head, cfg)])


def fleet_hybrid_phase(torch, L, rn, fa):
    """(b) The Fleet path at every degree 1 over the one-rank NCCL group
    of (a): ``compile_train_step`` against a plain ``jit.TrainStep``,
    ``group_sharded_parallel("os_g")`` under ``jit.TrainStep`` against
    the same, and ``PipelineParallel`` at one stage against the eager
    loop, each 5 steps from one set of weights, losses bitwise."""
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.meta_parallel import (
        PipelineLayer, PipelineParallel)
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.nn import functional as NF
    cfg = L.llama2_7b(num_hidden_layers=2)
    V = cfg.vocab_size
    rng = np.random.RandomState(SEED)
    ids_np = rng.randint(0, V, (2, 512)).astype(np.int64)
    ids = torch.from_numpy(ids_np).cuda()
    labels = torch.from_numpy(np.roll(ids_np, -1, axis=-1)).cuda()
    counters = _train_counters(rn, fa)
    totals = {k: 0 for k in counters}
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 1,
                               "sep_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    torch.manual_seed(SEED)
    state0 = {k: v.detach().clone() for k, v in
              L.LlamaForCausalLM(cfg, device="cuda").state_dict().items()}

    def llama():
        net = L.LlamaForCausalLM(cfg, device="cuda")
        net.set_state_dict(state0)
        return net

    def adamw(params):
        return optimizer.AdamW(learning_rate=1e-4, parameters=params,
                               grad_clip=optimizer.ClipGradByGlobalNorm(1.0))

    def loss_fn(model, i, l):
        return model.compute_loss(i, l)

    def steps(fn, what):
        out, ms = [], []
        for c in counters.values():
            c.launches = 0
        for _ in range(FLEET_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append(float(fn()))
            ms.append((time.perf_counter() - t0) * 1e3)
        for k, c in counters.items():
            totals[k] += c.launches
        if not all(math.isfinite(x) for x in out):
            raise AssertionError(f"{what}: non-finite losses {out}")
        return out, ms

    runs = {}
    net = llama()
    plain = jit.TrainStep(net, loss_fn, adamw(net.parameters()))
    runs["plain"] = steps(lambda: plain(ids, labels), "plain TrainStep")
    del net, plain
    net = llama()
    dopt = fleet.distributed_optimizer(adamw(net.parameters()))
    dm = fleet.distributed_model(net)
    step = dm.compile_train_step(loss_fn, dopt)
    clip = type(dopt.inner_opt._grad_clip).__name__
    runs["fleet"] = steps(lambda: step(ids, labels), "fleet")
    captures = step.programs.captures
    del net, dm, dopt, step
    net = llama()
    model, sopt, _ = group_sharded_parallel(net, adamw(net.parameters()),
                                            "os_g")
    step = jit.TrainStep(model, loss_fn, sopt)
    runs["os_g"] = steps(lambda: step(ids, labels), "os_g")
    del net, model, sopt, step
    gc.collect()
    torch.cuda.empty_cache()

    def pipe_loss(logits, lab):
        return NF.cross_entropy(logits.reshape([-1, V]), lab.reshape([-1]))

    pipes = {}
    for kind in ("eager", "pipeline"):
        torch.manual_seed(SEED)
        pipe = PipelineLayer(_llama_pipe_layers(L, cfg), loss_fn=pipe_loss)
        opt = adamw(pipe.parameters())
        if kind == "eager":
            def one(pipe=pipe, opt=opt):
                loss = pipe._loss_fn(pipe(ids), labels) / 1
                loss.backward()
                opt.step()
                opt.clear_grad()
                return loss.detach()
        else:
            pp = PipelineParallel(pipe, hcg, strategy)

            def one(pp=pp, opt=opt):
                return pp.train_batch((ids, labels), opt)
        pipes[kind] = steps(one, kind)
        del pipe, opt
    gc.collect()
    torch.cuda.empty_cache()
    equal = {"fleet": runs["fleet"][0] == runs["plain"][0],
             "os_g": runs["os_g"][0] == runs["plain"][0],
             "pipeline": pipes["pipeline"][0] == pipes["eager"][0]}
    if not all(equal.values()):
        raise AssertionError(f"not bitwise: {equal}; {runs}; {pipes}")
    med = lambda x: float(np.median(x[1]))  # noqa: E731
    return dict(layers=2, dtype="float32", batch=[2, 512],
                reduced="num_hidden_layers 32 -> 2",
                steps=FLEET_STEPS, clip=clip, bitwise=equal,
                captures=captures,
                losses={k: v[0] for k, v in {**runs, **pipes}.items()},
                median_step_ms={k: med(v) for k, v in
                                {**runs, **pipes}.items()},
                launches=totals)


# ---------------------------------------------------------------------------
# phase 37: Distributed III — ring attention, GPT-MoE, the launch CLI
# ---------------------------------------------------------------------------

#: phase 37 (a): Llama-2-7B's attention widths over a 4-rank ring
RING = dict(b=1, s=8192, h=32, d=128, p=4)
#: phase 37 (b): GPT-MoE at the reference bench's configuration
#: (``benchmarks/bench_workloads.py:244-253``), warm-up and timed steps
MOE_CFG = dict(vocab_size=50304, hidden_size=1024, num_hidden_layers=8,
               num_attention_heads=16, intermediate_size=4096,
               max_position_embeddings=1024, num_experts=8, moe_topk=2)
MOE_BATCH = (8, 1024)
MOE_WARM, MOE_STEPS = 2, 3


def _flash_counters(fa):
    return {"flash_attention_fwd": fa.flash_fwd_kernel,
            "flash_attention_bwd_dq": fa.flash_bwd_dq_kernel,
            "flash_attention_bwd_dkv": fa.flash_bwd_dkv_kernel}


def ring_one_process(torch, ra, q3, k3, v3, g3, p, scale, causal, kv_rep):
    """Every rank's hops of one ``p``-rank ring, run in this process
    through the port's ring code (``ring_forward`` / ``ring_backward``)
    with an exchange that reads each hop's KV chunk from the
    whole-sequence tensors and adds each chunk's travelling dK/dV
    partials into its home slot. q3/g3 (BH, S, D), k3/v3 (BH/kv_rep, S,
    D). Returns the whole-sequence (out, dq, dk, dv)."""
    s = q3.shape[1] // p

    def chunks(t):
        return [t[:, i * s:(i + 1) * s].contiguous() for i in range(p)]
    qs, ks, vs, gs = (chunks(t) for t in (q3, k3, v3, g3))
    outs, lses = [], []
    for my in range(p):
        held = [my]

        def ex(kr, vr, held=held):
            held[0] = (held[0] - 1) % p
            return ks[held[0]], vs[held[0]]
        out, lse = ra.ring_forward(qs[my], ks[my], vs[my], my, p, ex, scale,
                                   causal, kv_rep)
        outs.append(out)
        lses.append(lse)
    dks = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
           for k in ks]
    dvs = [torch.zeros_like(t) for t in dks]
    dqs = []
    for my in range(p):
        held = [my]

        def ex_b(*ts, held=held):
            dks[held[0]] += ts[-2]
            dvs[held[0]] += ts[-1]
            if len(ts) == 2:                      # the last hop: home
                return ts
            held[0] = (held[0] - 1) % p
            return (ks[held[0]], vs[held[0]], torch.zeros_like(ts[2]),
                    torch.zeros_like(ts[3]))
        dq, _, _ = ra.ring_backward(qs[my], ks[my], vs[my], outs[my],
                                    lses[my], gs[my], my, p, ex_b, scale,
                                    causal, kv_rep)
        dqs.append(dq)
    return (torch.cat(outs, 1), torch.cat(dqs, 1),
            torch.cat(dks, 1).to(k3.dtype), torch.cat(dvs, 1).to(v3.dtype))


def _plain_slabs(torch, fa, q, k, v, g, sc, rep, heads=4):
    """Rows 5 and 6's plain versions over the whole sequence, ``heads``
    query heads at a time (the fp32 scores of all 32 heads at S 8192
    would take 8.6 GB a tensor)."""
    outs, dqs, dks, dvs = [], [], [], []
    kr = heads // rep
    for i in range(q.shape[0] // heads):
        qs, gs = q[i * heads:(i + 1) * heads], g[i * heads:(i + 1) * heads]
        ks, vs = k[i * kr:(i + 1) * kr], v[i * kr:(i + 1) * kr]
        out, lse = fa.flash_fwd_plain(qs, ks, vs, sc, True, kv_rep=rep)
        dq, dk, dv = fa.flash_bwd_plain(qs, ks, vs, out, lse, gs, sc, True,
                                        kv_rep=rep)
        outs.append(out)
        dqs.append(dq)
        dks.append(dk)
        dvs.append(dv)
        del lse
        torch.cuda.empty_cache()
    return tuple(torch.cat(t) for t in (outs, dqs, dks, dvs))


def ring_attention_phase(torch, fa):
    """(a) Ring attention at Llama-2-7B widths (B 1, S 8192, 32 heads, d
    128, bf16, causal) over a 4-rank ring (2048-token chunks), with 32
    and with 8 KV heads (kv_rep 4): every rank's hops through the port's
    ring code in this process, held against rows 5 and 6 over the whole
    sequence and against the plain versions (``testing.RING_TOL``). The
    ring's launches of rows 5 and 6 are counted on its first run."""
    from paddle_tpu_torch.ops import ring_attention as ra
    from paddle_tpu_torch.testing import RING_TOL, l2_close
    b, s, h, d, p = (RING[k] for k in ("b", "s", "h", "d", "p"))
    sc = 1.0 / math.sqrt(d)
    tol = RING_TOL[torch.bfloat16]
    counters = _flash_counters(fa)
    totals = {k: 0 for k in counters}
    report = {}
    for name, hk in (("mha", 32), ("gqa_nkv8", 8)):
        rep = h // hk
        q, k, v, g = _flash_inputs(torch, b * h, s, d, torch.bfloat16, rep)
        for c in counters.values():
            c.launches = 0
        ring = ring_one_process(torch, ra, q, k, v, g, p, sc, True, rep)
        torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters.items()}
        blocks = p * (p + 1) // 2              # causal: rank r sees r + 1
        if launches != {n: blocks for n in counters}:
            raise AssertionError(f"ring {name}: launches {launches}, "
                                 f"{blocks} each expected")
        for n in totals:
            totals[n] += launches[n]
        wout, wlse = fa.flash_fwd_kernel(q, k, v, sc, True, kv_rep=rep)
        whole = (wout,) + fa.flash_attention_bwd(q, k, v, wout, wlse, g, sc,
                                                 True, kv_rep=rep)
        plain = _plain_slabs(torch, fa, q, k, v, g, sc, rep)
        err = {}
        for i, key in enumerate(("out", "dq", "dk", "dv")):
            err[key] = dict(
                vs_whole=l2_close(ring[i], whole[i], tol,
                                  f"ring {name} {key} vs whole"),
                vs_plain=l2_close(ring[i], plain[i], tol,
                                  f"ring {name} {key} vs plain"))
        del ring, whole, plain, wout, wlse
        torch.cuda.empty_cache()
        def ring_step():
            ring_one_process(torch, ra, q, k, v, g, p, sc, True, rep)

        def whole_step():
            o, lse = fa.flash_fwd_kernel(q, k, v, sc, True, kv_rep=rep)
            fa.flash_attention_bwd(q, k, v, o, lse, g, sc, True, kv_rep=rep)
        # device time (CUDA-graph replays), and the ring's eager wall,
        # which adds the host's launches of every hop's ops
        ring_ms = device_ms(torch, ring_step, iters=2, replays=3)
        whole_ms = device_ms(torch, whole_step, iters=2, replays=3)
        ring_wall = eager_ms(torch, ring_step, iters=3, warmup=1)
        report[name] = dict(kv_heads=hk, kv_rep=rep, launches=launches,
                            errors=err, ring_fwd_bwd_ms=ring_ms,
                            whole_fwd_bwd_ms=whole_ms,
                            ring_over_whole=ring_ms / whole_ms,
                            ring_eager_wall_ms=ring_wall)
        del q, k, v, g
        torch.cuda.empty_cache()
    report.update(shape=dict(RING), dtype="bfloat16", causal=True,
                  tol_rtol_atol_over_rms_l2=tol, launches=totals)
    return report


def ring_flash_one_rank(torch, fa):
    """``ring_flash_attention`` over the one-rank NCCL group (sep degree
    1): rows 5 and 6 over the whole sequence, forward and backward, its
    launches counted; equal to the kernels called directly."""
    from paddle_tpu_torch.ops import ring_attention as ra
    from paddle_tpu_torch.parallel import mesh as pmesh
    b, s, h, d = (RING[k] for k in ("b", "s", "h", "d"))
    pmesh.set_global_mesh(pmesh.build_mesh({}))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, g = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    counters = _flash_counters(fa)
    for c in counters.values():
        c.launches = 0
    qg = q.clone().requires_grad_(True)
    out = ra.ring_flash_attention(qg, k, v, causal=True)
    out.backward(g)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    if launches != {n: 1 for n in counters}:
        raise AssertionError(f"ring_flash_attention over one rank: "
                             f"launches {launches}")
    want = fa.sdpa_array(q, k, v, causal=True)
    pmesh.set_global_mesh(None)
    return dict(launches=launches, equal_to_kernels=bool(torch.equal(
        out.detach(), want)), shape=[b, s, h, d])


def _moe_flops_per_token(cfg, s):
    """``bench_workloads.py:298-301``'s active FLOPs per token: attention
    blocks 6·4h², the top-k experts 6·2·h·ff a layer, the LM head and the
    causal attention 6·L·S·h."""
    h, L = cfg.hidden_size, cfg.num_hidden_layers
    return (L * (6 * 4 * h * h + cfg.moe_topk * 6 * 2 * h
                 * cfg.intermediate_size)
            + 6 * h * cfg.vocab_size + 6.0 * L * s * h)


def _routing_counts(torch, net, ids, key):
    """Block 0's routing of ``ids``: the tokens each expert's top-2 picks
    (routed) and the ones its gate admits (kept) after random routing and
    the capacity, as the compiled step's forward computes them."""
    from paddle_tpu_torch import random as R
    blk = net.blocks[0]
    with torch.no_grad(), R.traced_key_scope(key):
        x = net.embeddings(ids)
        x = x + blk.attn(blk.ln1(x))
        xf = blk.ln2(x).reshape(-1, x.shape[-1])
        probs = torch.softmax((xf @ blk.mlp.gate.gate).float(), -1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :2]
        idx = blk.mlp.gate._gate(xf)[0]
    e = blk.mlp.num_expert
    routed = torch.bincount(top.reshape(-1), minlength=e)
    kept = torch.bincount(idx[idx >= 0].long(), minlength=e)
    return routed.tolist(), kept.tolist()


def gpt_moe_phase(torch, ln, fa):
    """(b) GPT-MoE at workload #4's widths (the reference bench's
    configuration: vocab 50304, h 1024, 8 layers, 16 heads, ff 4096, 8
    experts top-2, GShard gate, fp32, AdamW lr 1e-4, (8, 1024)) through
    ``jit.TrainStep`` (a CUDA graph): 2 warm-up and 3 timed steps with
    rows 5, 6 and 8's launches a step, held to the same steps run
    eagerly from the same weights and key stream (``testing.
    MOE_LOSS_TOL``); then one step with every gate biased as
    ``BENCH_MOE_SKEW`` biases it, with block 0's routed and kept tokens
    an expert."""
    import paddle_tpu_torch as TP
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.models.gpt_moe import (GPTMoEConfig,
                                                 GPTMoEForCausalLM)
    from paddle_tpu_torch.testing import MOE_LOSS_TOL
    cfg = GPTMoEConfig(**MOE_CFG)
    B, S = MOE_BATCH
    L = cfg.num_hidden_layers
    TP.seed(SEED)
    net = GPTMoEForCausalLM(cfg, device="cuda")
    state0 = {k: v.detach().clone() for k, v in net.state_dict().items()}
    rng = np.random.RandomState(SEED)
    ids_np = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int64)
    ids = torch.from_numpy(ids_np).cuda()
    labels = torch.from_numpy(np.roll(ids_np, -1, axis=-1)).cuda()

    def loss_fn(model, i, l):
        return model.compute_loss(i, l)

    counters = dict(_flash_counters(fa), layer_norm_fwd=ln.layer_norm,
                    layer_norm_bwd=ln.layer_norm_bwd)
    want = {"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L, "layer_norm_fwd": 2 * L + 1,
            "layer_norm_bwd": 2 * L + 1}
    totals = {k: 0 for k in counters}
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=net.parameters())
    step = jit.TrainStep(net, loss_fn, opt)
    gc.collect()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    TP.seed(SEED + 1)
    losses, ms = [], []
    for i in range(MOE_WARM + MOE_STEPS):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(ids, labels)))
        ms.append((time.perf_counter() - t0) * 1e3)
        got = {k: c.launches for k, c in counters.items()}
        if got != want:
            raise AssertionError(f"GPT-MoE step {i}: launches {got} != "
                                 f"{want}")
        for k in totals:
            totals[k] += got[k]
    peak = (torch.cuda.max_memory_allocated() - resident) / 1e9
    captures = step.programs.captures
    timed = ms[MOE_WARM:]
    step_ms = float(np.median(timed))
    tok_s = B * S / (step_ms / 1e3)
    flops_tok = _moe_flops_per_token(cfg, S)
    mfu = flops_tok * tok_s / PEAK_OPS_PER_S["fp32"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"GPT-MoE losses {losses}")

    # the same steps eagerly, from the same weights and key stream
    eager_net = GPTMoEForCausalLM(cfg, device="cuda")
    eager_net.set_state_dict(state0)
    del state0
    eopt = optimizer.AdamW(learning_rate=1e-4,
                           parameters=eager_net.parameters())
    from paddle_tpu_torch import random as R
    TP.seed(SEED + 1)
    eager = []
    for _ in range(MOE_WARM + MOE_STEPS):
        key = jit._host_key().cuda()
        with R.traced_key_scope(key):
            loss = eager_net.compute_loss(ids, labels)
        loss.backward()
        eopt.step()
        eopt.clear_grad()
        eager.append(float(loss))
    del eager_net, eopt
    gc.collect()
    torch.cuda.empty_cache()
    rtol, atol = MOE_LOSS_TOL
    for a, c in zip(losses, eager):
        if abs(a - c) > atol + rtol * abs(c):
            raise AssertionError(f"compiled GPT-MoE losses {losses} far "
                                 f"from the eager ones {eager}")

    # one step with every gate biased toward experts 0 and 1
    with torch.no_grad():
        for blk in net.blocks:
            gw = blk.mlp.gate.gate
            gw[:, 0] += 4.0
            gw[:, 1] += 3.5
    cap = int(math.ceil(cfg.capacity_factor[0] * B * S / cfg.num_experts))
    routed, kept = _routing_counts(torch, net, ids,
                                   jit._host_key().cuda())
    if any(k > min(r, cap) for k, r in zip(kept, routed)):
        raise AssertionError(f"skew: kept {kept} over min(routed {routed}, "
                             f"capacity {cap})")
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    skew_loss = float(step(ids, labels))
    skew_ms = (time.perf_counter() - t0) * 1e3
    got = {k: c.launches for k, c in counters.items()}
    if got != want or not math.isfinite(skew_loss):
        raise AssertionError(f"skewed step: loss {skew_loss}, launches {got}")
    for k in totals:
        totals[k] += got[k]
    del net, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        config=dict(MOE_CFG, moe_gate=cfg.moe_gate, dtype="float32",
                    capacity_factor=list(cfg.capacity_factor)),
        batch=[B, S], reduced="nothing cut", steps=dict(
            warm=MOE_WARM, timed=MOE_STEPS), losses=losses,
        eager_losses=eager, tol=MOE_LOSS_TOL, step_ms=ms,
        median_step_ms=step_ms, tokens_per_s=tok_s,
        active_flops_per_token=flops_tok,
        fp32_peak_flops=PEAK_OPS_PER_S["fp32"], active_mfu=mfu,
        peak_above_resident_gb=peak, captures=captures,
        launches_per_step=want,
        skew=dict(loss=skew_loss, step_ms=skew_ms, capacity=cap,
                  block0_routed=routed, block0_kept=kept,
                  block0_dropped=[r - k for r, k in zip(routed, kept)]),
        launches=totals)


_LAUNCH_SCRIPT = """
import json, os, sys
sys.path.insert(0, {repo!r})
import torch
import paddle_tpu_torch as TP
import paddle_tpu_torch.distributed as D
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.models.gpt_moe import GPTMoEForCausalLM, gpt_moe_tiny

D.init_parallel_env()
x = torch.full((4,), float(D.get_rank() + 1), device="cuda")
D.all_reduce(x)
cfg = gpt_moe_tiny()
TP.seed(0)
net = GPTMoEForCausalLM(cfg, device="cuda")
opt = optimizer.AdamW(learning_rate=1e-3, parameters=net.parameters())
ids = torch.randint(0, cfg.vocab_size, (2, 16), device="cuda")
loss = net.compute_loss(ids, torch.roll(ids, -1, 1))
loss.backward()
opt.step()
with open(os.path.join({out!r}, f"rank{{D.get_rank()}}.json"), "w") as f:
    json.dump(dict(backend=D.get_backend(), world=D.get_world_size(),
                   sum=x.tolist(), loss=float(loss)), f)
D.destroy_process_group()
"""


def launch_cli_phase(torch):
    """(c) ``python -m paddle_tpu_torch.distributed.launch
    --nproc_per_node 1`` on the card: the trainer joins NCCL, runs one
    all-reduce and one GPT-MoE tiny step, and exits 0; a trainer that
    exits 3 makes the launcher exit non-zero."""
    import tempfile
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="launch_")
    ok = os.path.join(tmp, "train.py")
    with open(ok, "w") as f:
        f.write(_LAUNCH_SCRIPT.format(repo=repo, out=tmp))
    bad = os.path.join(tmp, "boom.py")
    with open(bad, "w") as f:
        f.write("import sys\nsys.exit(3)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID", "PADDLE_MASTER"):
        env.pop(k, None)

    def run(script):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", "1", "--log_dir",
             os.path.join(tmp, "log"), script], env=env, cwd=repo,
            capture_output=True, text=True, timeout=300)
        return r, time.perf_counter() - t0
    r, ok_s = run(ok)
    if r.returncode != 0:
        log = os.path.join(tmp, "log", "workerlog.0")
        tail = open(log).read()[-3000:] if os.path.exists(log) else ""
        raise AssertionError(f"launch exited {r.returncode}: "
                             f"{r.stderr[-2000:]}\n{tail}")
    with open(os.path.join(tmp, "rank0.json")) as f:
        res = json.load(f)
    if res["backend"] != "NCCL" or res["sum"] != [1.0] * 4 or \
            not math.isfinite(res["loss"]):
        raise AssertionError(f"trainer reported {res}")
    rb, bad_s = run(bad)
    if rb.returncode == 0:
        raise AssertionError("a trainer exiting 3 left the launcher at 0")
    with open(os.path.join(tmp, "log", "failure.json")) as f:
        failure = json.load(f)
    shutil.rmtree(tmp, ignore_errors=True)
    return dict(trainer=res, launch_s=ok_s, failing_exit=rb.returncode,
                failing_reason=failure["reason"],
                failing_trainer_exit=failure["container"]["exit_code"],
                failing_launch_s=bad_s)


# ---------------------------------------------------------------------------
# phase 38: Distributed IV — tensor-parallel serving over a serving mesh,
# elastic resize after a lost chip, auto_parallel
# ---------------------------------------------------------------------------

#: chips of (c)'s serving mesh (logical chips on cuda:0)
TP_CHIPS = 4
#: (b)'s head slabs: (name, whole-call nh, whole-call nkv, chips)
SLAB_CASES = (("mha_mp2", 32, 32, 2), ("mha_mp4", 32, 32, 4),
              ("gqa_mp4", 32, 8, 4))


def _logical_mesh(torch, n):
    """A serving mesh of ``n`` logical chips on cuda:0."""
    from paddle_tpu_torch.parallel.mesh import serving_mesh
    return serving_mesh(n, [torch.device("cuda", 0)] * n)


def _tp_tiny_cfg(torch, L):
    return L.llama_tiny(hidden_size=512, num_attention_heads=4,
                        num_key_value_heads=4, intermediate_size=1024,
                        num_hidden_layers=2, dtype=torch.float32)


def _serve_mixed(eng, params, prompts, S):
    """Serve ``prompts`` with every other request sampled (seeded);
    returns the tokens in submission order."""
    subs = [dict(sampler=S.SamplerConfig(temperature=0.8, top_p=0.9,
                                         seed=5 + i)) if i % 2 else {}
            for i in range(len(prompts))]
    return _serve_subs(eng, params, prompts, subs)[0]


def tp_tiny_phase(torch, L, D):
    """(a) A tiny fp32 model (h 512, 4 heads of 128, 2 layers) served with
    greedy and seeded sampled requests mixed, the prefix cache and
    speculation on and off (the cache's second, warm serve too), over
    serving meshes of 1, 2 and 4 logical chips on cuda:0 through the
    CUDA graphs: every degree's tokens equal the CPU engine's at mp 1."""
    from paddle_tpu_torch.inference import sampling as S
    cfg = _tp_tiny_cfg(torch, L)
    params_cpu = L.init_params(cfg, seed=SEED, device="cpu")
    params_gpu = {k: v.cuda() for k, v in params_cpu.items()}
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 40, 17, 3, 29, 12)]
    report = {}
    for pc in (False, True):
        for spec in (False, True):
            kw = dict(num_slots=2, page_size=16, max_seq_len=128, chunk=4,
                      prefix_cache=pc, speculative=spec,
                      step_tokens=10 if spec else None)
            runs = {}
            for mp, dev in ((1, "cpu"), (1, "cuda"), (2, "cuda"),
                            (4, "cuda")):
                mesh = _logical_mesh(torch, mp) if dev == "cuda" else None
                eng = D.ContinuousBatchingEngine(
                    cfg, D.GenerationConfig(max_new_tokens=8),
                    mesh=mesh, device=None if mesh else dev, **kw)
                params = params_gpu if dev == "cuda" else params_cpu
                out = [_serve_mixed(eng, params, prompts, S)]
                if pc:
                    out.append(_serve_mixed(eng, params, prompts, S))
                if eng.num_chips != mp:
                    raise AssertionError(f"{eng.num_chips} chips, not {mp}")
                runs[f"{dev}_mp{mp}"] = out
            want = runs.pop("cpu_mp1")
            bad = [k for k, v in runs.items() if v != want]
            if bad:
                raise AssertionError(f"prefix_cache={pc} speculative={spec}"
                                     f": {bad} differ from the CPU engine")
            report[f"cache{int(pc)}_spec{int(spec)}"] = dict(
                degrees=[1, 2, 4], serves=len(want), tokens=want[0][:2])
    return report


def _ragged_want_at(torch, pa, calls, nh, nkv, tokens=256, rows=8,
                    span=1024):
    """The launches of ``calls`` calls of the ragged op at the 7B engine's
    packed shapes with ``nh`` query and ``nkv`` kv heads."""
    routes = pa.ragged_route(torch.bfloat16, 16, nh, nkv)
    _, n_chunks = pa.ragged_split(tokens, rows, span, nh, nkv, 128,
                                  torch.bfloat16, "cuda")
    return {"ragged_paged_attention": calls,
            "ragged_wgmma": calls * ("wgmma" in routes),
            "ragged_key_split": calls,
            "ragged_merge": calls * (n_chunks > 1)}


def head_slab_phase(torch, pa):
    """(b) Row 3 on the head slabs of a serving mesh at the 7B serve's
    packed shapes (phase 3's mixed batch: 256 tokens over 8 rows, 1024-key
    tables, d 128, bf16): each chip's kernel on its contiguous slabs
    (``ragged_paged_attention_chips``) against the whole-heads kernel's
    slice (bitwise where the key split is the same) and against its plain
    version (``testing.RAGGED_SLAB_TOL``), pads exactly 0; the device ms
    of one chip's call, of every chip's in turn and of the whole call;
    the launches; one chip's bound."""
    from paddle_tpu_torch import testing
    bf16 = torch.bfloat16
    rtol, atol = testing.RAGGED_SLAB_TOL[bf16]
    report = {}
    for name, nh, nkv, chips in SLAB_CASES:
        args, dec, real, nbytes, ops = ragged_batch(torch, nkv, bf16, nh=nh)
        q, k, v, bt, tr, pos, kvl = args
        meta = (bt, tr, pos, kvl)
        devs = [torch.device("cuda", 0)] * chips
        qs = pa.split_heads(q, chips, devs)
        ks = pa.HeadShards.split(k, devs).slabs
        vs = pa.HeadShards.split(v, devs).slabs
        hq, hk = nh // chips, nkv // chips
        whole = pa.ragged_paged_attention_kernel(q, k, v, *meta, dec)
        _reset_ragged(pa)
        outs = pa.ragged_paged_attention_chips(qs, ks, vs, *meta,
                                               decoding=dec)
        torch.cuda.synchronize()
        launches = _ragged_launches(pa)
        want = _ragged_want_at(torch, pa, chips, hq, hk)
        if launches != want:
            raise AssertionError(f"{name}: launches {launches} != {want}")
        pads = torch.from_numpy(~real).cuda()
        err_whole, err_plain, bitwise = 0.0, 0.0, []
        for c, out in enumerate(outs):
            sl = whole[:, c * hq:(c + 1) * hq]
            bitwise.append(bool(torch.equal(out, sl)))
            err_whole = max(err_whole, check_close(
                torch, f"{name} chip {c} vs whole", out, sl, rtol, atol))
            plain = pa.ragged_paged_attention_plain(qs[c], ks[c], vs[c],
                                                    *meta)
            err_plain = max(err_plain, check_close(
                torch, f"{name} chip {c} vs plain", out, plain, rtol, atol))
            if not bool((out[pads] == 0).all()):
                raise AssertionError("pad slots must come out exactly 0")
        meta_bytes = sum(a.numel() * 4 for a in meta)
        bms, by = bound_ms((nbytes - meta_bytes) / chips + meta_bytes,
                           ops / chips, "bf16")
        split = pa.ragged_split(256, bt.shape[0], 1024, hq, hk, 128, bf16,
                                "cuda")
        report[name] = dict(
            nh=hq, nkv=hk, chips=chips, routes=list(pa.ragged_route(
                bf16, 16, hq, hk)), chunk=split[0], n_chunks=split[1],
            whole_split=list(pa.ragged_split(256, bt.shape[0], 1024, nh, nkv,
                                             128, bf16, "cuda")),
            bitwise_to_whole=bitwise, max_abs_err_whole=err_whole,
            max_abs_err=err_plain, rtol=rtol, atol=atol, launches=launches,
            ms=device_ms(torch, lambda: pa.ragged_paged_attention_kernel(
                qs[0], ks[0], vs[0], *meta, dec)),
            all_chips_ms=device_ms(
                torch, lambda: pa.ragged_paged_attention_chips(
                    qs, ks, vs, *meta, decoding=dec)),
            whole_ms=device_ms(torch, lambda: pa.
                               ragged_paged_attention_kernel(q, k, v, *meta,
                                                             dec)),
            plain_ms=device_ms(torch, lambda: pa.ragged_paged_attention_plain(
                qs[0], ks[0], vs[0], *meta), iters=2, replays=2),
            bound_ms=bms, bound_by=by)
        del args, qs, ks, vs, whole, outs
        torch.cuda.empty_cache()
    return report


def _first_step_logits(torch, L, pa, cfg, params, placed, mesh, prompts):
    """The logits of one packed micro-round (8 rows, each its prompt's
    first 32 tokens: 256 tokens, the engine's first micro-round shape)
    through the one-chip step and the mesh step, each on fresh pools."""
    rows, n = 8, 32
    ids = np.concatenate([p[:n] for p in prompts[:rows]]).astype(np.int32)
    tr = np.repeat(np.arange(rows), n).astype(np.int32)
    pos = np.tile(np.arange(n), rows).astype(np.int32)
    bt = (1 + np.arange(rows * 2).reshape(rows, 2)).astype(np.int32)
    cuda = [torch.from_numpy(a).cuda() for a in (
        ids, tr, pos, np.full(rows, n, np.int32),
        (np.arange(rows) * n + n - 1).astype(np.int32), bt)]
    ids_t, tr_t, pos_t, kvl, last, bt_t = cuda
    dec = torch.zeros(rows * n, dtype=torch.bool, device="cuda")
    shape = (cfg.num_hidden_layers, rows * 2 + 1, 16,
             cfg.num_key_value_heads, cfg.head_dim)
    out = []
    for p, m in ((params, None), (placed, mesh)):
        kp = torch.zeros(shape, dtype=cfg.dtype, device="cuda")
        vp = torch.zeros_like(kp)
        if m is not None:
            devs = m.devices.reshape(-1).tolist()
            kp, vp = (pa.HeadShards.split(t, devs) for t in (kp, vp))
        out.append(L.ragged_step(p, ids_t, tr_t, pos_t, kvl, last, kp, vp,
                                 bt_t, cfg, m, "mp", decoding=dec)[0])
        del kp, vp
    return out


def _logits_diff(got, want):
    """Relative L2 and largest |difference| of two logits tensors, the
    rms of ``want`` and the rows whose argmax agrees."""
    ref, diff = want.float(), got.float() - want.float()
    return dict(rel_l2=float(diff.norm() / ref.norm()),
                max_abs=float(diff.abs().max()),
                logits_rms=float(ref.pow(2).mean().sqrt()),
                same_argmax=int((got.argmax(-1) == want.argmax(-1)).sum()))


def _one_chip_top2(torch, L, cfg, params, seq):
    """The top-2 margin of the one-chip step's logits after ``seq`` (a
    prefill of the whole sequence on fresh pools)."""
    t = len(seq)
    width = -(-t // 16)
    bt = torch.arange(1, width + 1, dtype=torch.int32,
                      device="cuda")[None]
    kp = torch.zeros((cfg.num_hidden_layers, width + 1, 16,
                      cfg.num_key_value_heads, cfg.head_dim),
                     dtype=cfg.dtype, device="cuda")
    vp = torch.zeros_like(kp)
    i32 = dict(dtype=torch.int32, device="cuda")
    logits = L.ragged_step(
        params, torch.tensor(seq, **i32), torch.zeros(t, **i32),
        torch.arange(t, **i32), torch.tensor([t], **i32),
        torch.tensor([t - 1], **i32), kp, vp, bt, cfg,
        decoding=torch.zeros(t, dtype=torch.bool, device="cuda"))[0][0]
    top = torch.topk(logits.float(), 2)
    return (float(top.values[0] - top.values[1]),
            [int(i) for i in top.indices])


def _all_reduce_ms(torch, chips, tokens, hidden):
    """Device ms of one serving all-reduce of ``chips`` fp32 (tokens,
    hidden) partials on one card (the chips - 1 adds)."""
    from paddle_tpu_torch.parallel.mesh import serving_all_reduce
    parts = [torch.randn(tokens, hidden, device="cuda")
             for _ in range(chips)]
    return device_ms(torch, lambda: serving_all_reduce(parts))


def tp_7b_phase(torch, L, D, rn, pa, cfg, params, greedy):
    """(c) Llama-2-7B (phase 7's weights, 32 layers, bf16) over
    ``serving_mesh(4, [cuda:0] * 4)``: the first micro-round's logits
    against the one-chip step's, and the same step in fp32 over 2 layers
    (``testing.TP_SERVE_TOL``); phase 7's 12 prompts served through the
    CUDA graphs, greedy tokens equal to phase 7's up to a near-tie (the
    mesh's token in the one-chip top-2 there, the margin under the
    bound); step walls, device ms by kind (a prefill and a decode step,
    torch.profiler), the all-reduce adds alone, idle share, capture
    seconds, peak memory; rows 1 and 3's launches per micro-round (row
    1: once a norm, the chips share the card; row 3: a call a chip and
    layer)."""
    from paddle_tpu_torch import testing
    tol = testing.TP_SERVE_TOL
    n_layers = cfg.num_hidden_layers
    mesh = _logical_mesh(torch, TP_CHIPS)
    prompts = serve_load(cfg)
    t0 = time.perf_counter()
    placed = L.shard_params_tp(params, mesh, cfg)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    one, tp = _first_step_logits(torch, L, pa, cfg, params, placed, mesh,
                                 prompts)
    del placed
    _free_card(torch)
    first = _logits_diff(tp, one)
    rms = first["logits_rms"]
    if not (first["rel_l2"] <= tol["rel_l2"]
            and first["max_abs"] <= tol["max_abs"] * rms):
        raise AssertionError(f"first-step logits over the mesh: {first} "
                             f"(bounds {tol})")
    # the same step in fp32 over 2 layers: the sum order only
    c32 = dataclasses.replace(cfg, num_hidden_layers=2, dtype=torch.float32)
    p32 = {k: (v[:2] if k in L.LAYER_KEYS else v).float()
           for k, v in params.items()}
    one32, tp32 = _first_step_logits(torch, L, pa, c32, p32,
                                     L.shard_params_tp(p32, mesh, c32),
                                     mesh, prompts)
    fp32 = _logits_diff(tp32, one32)
    del p32, one32, tp32
    _free_card(torch)
    if not fp32["rel_l2"] <= tol["fp32_rel_l2"]:
        raise AssertionError(f"fp32 first-step logits over the mesh: "
                             f"{fp32} (bound {tol['fp32_rel_l2']})")
    eng = _serve_engine(D, cfg, step_tokens=256, mesh=mesh)

    def reset():
        rn.rms_norm.launches = 0
        _reset_ragged(pa)
    outs, report = _serve_run(torch, eng, params, prompts, reset)
    launches = {"rms_norm_fwd": rn.rms_norm.launches,
                **_ragged_launches(pa)}
    rounds = eng.micro_rounds
    hq, hk = (cfg.num_attention_heads // TP_CHIPS,
              cfg.num_key_value_heads // TP_CHIPS)
    want = {"rms_norm_fwd": (2 * n_layers + 1) * rounds,
            **_ragged_want_at(torch, pa, TP_CHIPS * n_layers * rounds, hq,
                              hk)}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    _check_outputs(cfg, outs, eng)
    programs = _programs(eng, "cbe.unified_step")
    if programs["misses"] != 1 or eng.compile_misses[0][1][5] != TP_CHIPS:
        raise AssertionError(f"program builds {eng.compile_misses}")
    # tokens: equal to phase 7's up to a near-tie of the one-chip logits
    diverged = []
    for i, (got, want_t) in enumerate(zip(outs, greedy)):
        j = next((j for j, (a, b) in enumerate(zip(got, want_t))
                  if a != b), None)
        if j is None:
            continue
        margin, top2 = _one_chip_top2(
            torch, L, cfg, params, list(prompts[i]) + list(want_t[:j]))
        diverged.append(dict(request=i, at=j, margin=margin,
                             margin_share=margin / rms, one_chip_top2=top2,
                             tokens=[got[j], want_t[j]]))
        if margin > tol["margin"] * rms or got[j] not in top2:
            raise AssertionError(f"request {i} left phase 7's tokens at "
                                 f"{j}: {diverged[-1]} (margin bound "
                                 f"{tol['margin'] * rms})")
    breakdown = step_breakdown(torch, eng, params, cfg.vocab_size)
    reduce_ms = _all_reduce_ms(torch, TP_CHIPS, 256, cfg.hidden_size)
    report.update(
        chips=TP_CHIPS, mesh=repr(mesh), place_s=place_s,
        first_step=first, first_step_fp32_2_layers=fp32, bounds=tol,
        identical_requests=sum(
            a == b for a, b in zip(outs, greedy)), diverged=diverged,
        micro_rounds=rounds, launches=launches,
        launches_per_micro_round={k: v / rounds for k, v in
                                  launches.items()},
        programs=programs, breakdown=breakdown,
        all_reduce_ms=dict(one=reduce_ms, per_micro_round=2 * n_layers
                           * reduce_ms))
    del eng
    _free_card(torch)
    return report


class _Clock:
    """A fake clock for the storm (the tests' ``FakeClock``)."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt

    def advance(self, dt):
        self.t += dt


def _elastic_fleet(torch, D, S, cfg, n, mp, device, clock, injector=None,
                   engine_kw=None, max_new=8, sleep=None):
    """``test_elastic.py``'s fleet: ``n`` replicas, each over a serving
    mesh of ``mp`` chips (logical chips on ``device``), the controller
    rebuilding from the same factories."""
    from paddle_tpu_torch.parallel.mesh import serving_mesh
    kw = engine_kw or dict(num_slots=2, page_size=4, max_seq_len=64,
                           chunk=2)

    def engine_factory(mesh):
        return D.ContinuousBatchingEngine(
            cfg, D.GenerationConfig(max_new_tokens=max_new, seed=3),
            mesh=mesh, device=None if mesh is not None else device, **kw)

    def handle_factory(rid, eng):
        return S.ReplicaHandle(
            rid, eng, config=S.SchedulerConfig(max_step_retries=1,
                                               retry_backoff_s=0.01),
            health_config=S.HealthConfig(suspect_after=1, eject_after=2,
                                         probe_cooldown_s=0.4),
            clock=clock, sleep=sleep or clock.sleep)

    handles = [handle_factory(i, engine_factory(serving_mesh(
        mp, [torch.device(device)] * mp))) for i in range(n)]
    router = S.FleetRouter(handles, config=S.RouterConfig(
        failover_backoff_s=0.05), clock=clock, sleep=sleep or clock.sleep,
        fault_injector=injector)
    ctl = S.ElasticServingController(router, engine_factory, handle_factory,
                                     fault_injector=injector, clock=clock)
    return router, ctl


def _storm_prompts(vocab, n=8, seed=31):
    rng = np.random.RandomState(seed)
    base = rng.randint(1, vocab, (4,)).astype(np.int32)
    out = []
    for i in range(n):
        if i % 3 == 0:
            tail = rng.randint(1, vocab, (3,))
            out.append(np.concatenate([base, tail]).astype(np.int32))
        else:
            out.append(rng.randint(1, vocab, (int(rng.randint(4, 9)),))
                       .astype(np.int32))
    return out


def _detach_fleet(recorder):
    """Drop the router and the controller the flight recorder holds (it
    keeps the last fleet attached, and with it the fleet's engines)."""
    recorder.attach_router(None)
    recorder.attach_elastic(None)


def _drive(router, ctl, clock, params, submissions, max_steps=400):
    handles, step = [], 0
    submissions = dict(submissions)
    while step < max_steps:
        for p in submissions.pop(step, []):
            handles.append(router.submit(p))
        if not submissions and not router.pending and not ctl.resizing:
            break
        ctl.step(params)
        clock.advance(0.05)
        step += 1
    if step >= max_steps:
        raise AssertionError(f"storm did not finish: {router.statusz()}")
    return handles


def elastic_storm_phase(torch, L, D):
    """(d) ``test_seeded_chip_storm_end_to_end_byte_identical``'s storm at
    tiny widths on the card (llama_tiny with 4 heads of 64, the kernels'
    smallest head dim: h 256, 2 layers, fp32, the reference's seed-3
    draws): 2 replicas of 2 logical chips under
    ``FaultInjector.seeded_chips(11, 10, 2, 2, n_faults=2)``; the tokens
    equal the fault-free storm's on the card and the CPU's, every arc
    rejoined."""
    from paddle_tpu_torch import serving as S
    from paddle_tpu_torch.observability.flight import flight_recorder
    from paddle_tpu_torch.resilience import FaultInjector
    cfg = L.llama_tiny(hidden_size=256, intermediate_size=512,
                       num_hidden_layers=2, dtype=torch.float32)
    prompts = _storm_prompts(cfg.vocab_size)
    subs = {0: prompts[:6], 8: prompts[6:]}
    out = {}
    for dev in ("cuda", "cpu"):
        params = L.init_stacked_params(cfg, seed=3, device=dev)
        for faults in (False, True):
            if dev == "cpu" and faults:
                continue
            clock = _Clock()
            inj = (FaultInjector.seeded_chips(11, 10, 2, 2, n_faults=2)
                   if faults else None)
            router, ctl = _elastic_fleet(torch, D, S, cfg, 2, 2, dev, clock,
                                         inj)
            try:
                hs = _drive(router, ctl, clock, params, subs)
            finally:
                _detach_fleet(flight_recorder)
            out[(dev, faults)] = [h.stream.tokens for h in hs]
            if faults:
                if inj.schedule or len(ctl.resizes) != 2 or not all(
                        r.done for r in ctl.resizes):
                    raise AssertionError("the storm's arcs did not finish")
                arcs = [dict(kind=r.kind, replica=r.replica, chip=r.chip,
                             step=r.step, chips=[r.from_chips, r.to_chips])
                        for r in ctl.resizes]
    if not out[("cuda", True)] == out[("cuda", False)] == out[("cpu",
                                                               False)]:
        raise AssertionError("the chip-loss storm's tokens differ from the "
                             "fault-free storm's or the CPU's")
    return dict(requests=len(prompts), arcs=arcs, byte_identical=True,
                tokens=out[("cuda", True)][:2])


def elastic_7b_phase(torch, D, rn, pa, cfg, params):
    """(d) One ``lose_chip`` on a 2-replica fleet at Llama-2-7B widths
    (phase 7's weights, 32 layers, bf16; each replica over 2 logical
    chips on cuda:0, 4 slots, page 16, max_seq_len 1024): phase 7's
    first 8 prompts, replica 0's chip 1 dies at fleet step 3; the
    ``ResizeRecord``'s phases on the host clock (chip lost, checkpointed,
    ejected, resharded, rejoined) and the rebuilt one-chip replica's
    first step after it (its program's build and capture included):
    the time to recover from a lost chip. Two more prompts are submitted
    once the replica has rejoined (the least loaded, it takes them).
    Every request completes with 32 valid tokens; rows 1 and 3's
    launches."""
    from paddle_tpu_torch import serving as S
    from paddle_tpu_torch.observability.flight import flight_recorder
    from paddle_tpu_torch.resilience import Fault, FaultInjector
    load = serve_load(cfg)
    prompts, late = load[:8], load[8:10]
    inj = FaultInjector(schedule=[Fault("chip_die", 3, replica=0, chip=1)])
    rn.rms_norm.launches = 0
    _reset_ragged(pa)
    router, ctl = _elastic_fleet(
        torch, D, S, cfg, 2, 2, "cuda", time.perf_counter, inj,
        engine_kw=dict(num_slots=4, page_size=16, max_seq_len=1024,
                       chunk=8, step_tokens=256),
        max_new=NEW_TOKENS, sleep=time.sleep)
    try:
        return _lose_chip_run(torch, cfg, rn, pa, router, ctl, params,
                              prompts, late)
    finally:
        _detach_fleet(flight_recorder)


def _lose_chip_run(torch, cfg, rn, pa, router, ctl, params, prompts, late):
    """:func:`elastic_7b_phase`'s run of the fleet and its report."""
    handles = [router.submit(p) for p in prompts]
    t0 = time.perf_counter()
    rebuilt_first_step = None
    steps = 0
    while router.pending or ctl.resizing:
        before = router.replicas[0].engine
        ctl.step(params)
        steps += 1
        if ctl.resizes and late:
            handles += [router.submit(p) for p in late]
            late = []
        eng0 = router.replicas[0].engine
        if (ctl.resizes and rebuilt_first_step is None and eng0 is before
                and eng0.micro_rounds > 0 and eng0.num_chips == 1):
            torch.cuda.synchronize()
            rebuilt_first_step = time.perf_counter()
        if steps > 400:
            raise AssertionError(f"fleet did not finish: {router.statusz()}")
    wall = time.perf_counter() - t0
    [rec] = ctl.resizes
    if not rec.done or (rec.from_chips, rec.to_chips) != (2, 1):
        raise AssertionError(f"resize {rec.as_dict()}")
    toks = [h.stream.tokens for h in handles]
    _check_outputs(cfg, toks, router.replicas[1].engine)
    lost = rec.phases[0][1]
    arc = {p: t - lost for p, t in rec.phases}
    report = dict(
        replicas=2, chips=[2, 2], requests=len(handles), steps=steps,
        wall_s=wall, resize=dict(
            kind=rec.kind, step=rec.step, flights=len(rec.flights),
            phases_s=arc, rejoined_s=arc["rejoined"],
            first_step_after_rejoin_s=(None if rebuilt_first_step is None
                                       else rebuilt_first_step - lost),
            capture_s=dict(router.replicas[0].engine.capture_seconds)),
        failovers=sum(h.failovers for h in handles),
        launches={"rms_norm_fwd": rn.rms_norm.launches,
                  **_ragged_launches(pa)})
    return report


def auto_parallel_phase(torch):
    """(e) ``auto_parallel`` over a one-rank NCCL group: ``shard_tensor``,
    ``reshard`` (Shard -> Replicate: an NCCL all-gather of one rank;
    Replicate -> Shard(1): a cut), ``shard_layer`` and 4 ``Engine.fit``
    steps of a small MLP (fp32, AdamW, ``jit.TrainStep``), with the same
    calls on the CPU without a process group: equal results."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import distributed as Dd
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.distributed.auto_parallel import Engine
    from paddle_tpu_torch.io import TensorDataset
    rng = np.random.RandomState(SEED)
    x = rng.randn(8, 6).astype(np.float32)
    X = rng.randn(32, 6).astype(np.float32)
    Y = (X @ rng.randn(6, 2)).astype(np.float32)
    init = {}
    results = {}
    for dev in ("gpu", "cpu"):
        P.set_device(dev)
        saved = _one_rank_nccl(Dd) if dev == "gpu" else None
        try:
            mesh = Dd.ProcessMesh([0], dim_names=["x"])
            s = Dd.shard_tensor(x, mesh, [Dd.Shard(0)])
            rep = Dd.reshard(s, mesh, [Dd.Replicate()])
            cut = Dd.reshard(rep, mesh, [Dd.Shard(1)])
            net = P.nn.Sequential(P.nn.Linear(6, 16), P.nn.Tanh(),
                                  P.nn.Linear(16, 2))
            if not init:
                init.update({k: v.detach().cpu().clone()
                             for k, v in net.state_dict().items()})
            net.set_state_dict(init)
            Dd.shard_layer(net, mesh)
            eng = Engine(net, loss=lambda p, y: ((p - y) ** 2).mean(),
                         optimizer=P.optimizer.AdamW(
                             learning_rate=1e-2,
                             parameters=net.parameters()))
            hist = eng.fit(TensorDataset([X, Y]), epochs=1, batch_size=8)
            results[dev] = dict(
                tensors=[t._value.cpu() for t in (s, rep, cut)],
                specs=[tuple(t._sharding_spec) for t in (s, rep, cut)],
                loss=hist[-1]["loss"],
                weights={k: v.detach().cpu()
                         for k, v in net.state_dict().items()})
        finally:
            if saved is not None:
                Dd.destroy_process_group()
                _restore_env(saved)
    P.set_device("gpu")
    g, c = results["gpu"], results["cpu"]
    if g["specs"] != c["specs"] or not all(
            torch.equal(a, b) for a, b in zip(g["tensors"], c["tensors"])):
        raise AssertionError("shard_tensor / reshard differ card vs cpu")
    rtol, atol = testing.CARD_CPU_TOL["loss"]
    if not math.isclose(g["loss"], c["loss"], rel_tol=rtol, abs_tol=atol):
        raise AssertionError(f"Engine.fit loss {g['loss']} != {c['loss']}")
    wdiff = max(float((g["weights"][k] - c["weights"][k]).abs().max())
                for k in g["weights"])
    return dict(loss=g["loss"], cpu_loss=c["loss"], steps=4,
                weights_max_abs_diff=wdiff, specs=g["specs"])


def tp_two_cards_phase(torch, L, D):
    """(f) A serving mesh over two cards (the NCCL branch of
    ``serving_all_reduce``): the tiny engine at mp 2 over cuda:0 and
    cuda:1 against the CPU engine. Runs only where the machine has two
    cards."""
    n = torch.cuda.device_count()
    if n < 2:
        return dict(ran=False, reason=f"{n} CUDA device visible: the NCCL "
                    "branch needs two cards")
    from paddle_tpu_torch.parallel.mesh import serving_mesh
    cfg = _tp_tiny_cfg(torch, L)
    params = L.init_params(cfg, seed=SEED, device="cpu")
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, cfg.vocab_size, (n_,)).astype(np.int32)
               for n_ in (5, 40, 17)]
    kw = dict(num_slots=2, page_size=16, max_seq_len=128, chunk=4)
    want = D.ContinuousBatchingEngine(
        cfg, D.GenerationConfig(max_new_tokens=8), device="cpu",
        **kw).serve(params, prompts)
    eng = D.ContinuousBatchingEngine(
        cfg, D.GenerationConfig(max_new_tokens=8), mesh=serving_mesh(2),
        **kw)
    got = eng.serve({k: v.cuda(0) for k, v in params.items()}, prompts)
    if got != want:
        raise AssertionError("two-card mesh tokens differ from the CPU's")
    return dict(ran=True, cards=n, tokens=got[:2])


# ---------------------------------------------------------------------------
# phase 39: other workloads — int8 serving and vision
# ---------------------------------------------------------------------------

#: the counters phase 39 reads, by the kernel line's names
P39_KERNELS = ("rms_norm_fwd", "ragged_paged_attention",
               "paged_decode_attention", "flash_attention_fwd",
               "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
               "layer_norm_fwd", "layer_norm_bwd")


def _p39_counters(rn, pa, fa, ln):
    return dict(zip(P39_KERNELS, (
        rn.rms_norm, pa.ragged_paged_attention, pa.paged_attention,
        fa.flash_fwd_kernel, fa.flash_bwd_dq_kernel, fa.flash_bwd_dkv_kernel,
        ln.layer_norm, ln.layer_norm_bwd)))


def _read(counters):
    return {k: c.launches for k, c in counters.items()}


def _add(total, part):
    for k, n in part.items():
        total[k] = total.get(k, 0) + n
    return total


def _rel(got, want):
    """(relative L2 error, largest |difference| as a share of the rms)."""
    got, want = got.double().cpu(), want.double().cpu()
    rms = want.pow(2).mean().sqrt().item()
    return dict(rel_l2=((got - want).norm() / want.norm()).item(),
                max_abs_share=(got - want).abs().max().item() / rms)


def _built_on_cpu(fn):
    """``fn()`` with the framework's place set to the CPU (its layers
    built there), the place restored after."""
    from paddle_tpu_torch.core import place
    saved = place._current_place[0]
    place.set_device("cpu")
    try:
        return fn()
    finally:
        place._current_place[0] = saved


def int8_tiny_phase(torch, L, D, rn, pa, fa, ln, ftb):
    """(a) Tiny fp32 checks of the slice, card against CPU, TF32 off.
    Phase 5's config with all eight Llama keys quantized
    (``quantize_stacked_params``: the card's int8 bytes equal the CPU's)
    served by the unified and the legacy engines with
    FLAGS_serving_a8w8_prefill on and off: identical greedy tokens, rows
    1, 3 and 4 counted on the card. ``_int8_mm`` at (40, 256) x (256,
    512): the int32 product and the output bitwise the CPU's.
    ``FusedMultiTransformerInt8`` (2 layers, h 128, 2 heads of 64)
    prefill with a cache and one decode step within
    ``testing.INT8_CARD_CPU_TOL``. ResNet-18 (4 images of 64²) one SGD
    step: loss and gradients within ``testing.VISION_CARD_CPU_TOL``; a
    ViT (h 128, 2 heads of 64: the kernels take d 64 or 128) two
    ``build_vit_train_step`` steps at lr 1e-3: the first loss within
    ``CARD_CPU_TOL``, the second (after an AdamW step that may move a
    noise-gradient element ±lr apart) within 1e-4, the weights by
    ``trained_weights_close``."""
    import paddle_tpu_torch as TP
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.incubate.nn import (FusedMultiTransformer,
                                              FusedMultiTransformerInt8)
    from paddle_tpu_torch.testing import (CARD_CPU_TOL, INT8_CARD_CPU_TOL,
                                          VISION_CARD_CPU_TOL, l2_close,
                                          trained_weights_close)
    from paddle_tpu_torch.vision.models import resnet18
    from paddle_tpu_torch.vision.models import vit as V
    counters = _p39_counters(rn, pa, fa, ln)
    launches, report = {}, {}

    cfg = L.llama_tiny(hidden_size=256, num_attention_heads=2,
                       num_key_value_heads=2, intermediate_size=512,
                       num_hidden_layers=2, dtype=torch.float32)
    params_cpu = L.init_params(cfg, seed=SEED, device="cpu")
    q_cpu = Q.quantize_stacked_params(params_cpu)
    q_gpu = Q.quantize_stacked_params({k: v.cuda()
                                       for k, v in params_cpu.items()})
    for k, v in q_cpu.items():
        if isinstance(v, dict) and not all(torch.equal(v[p], q_gpu[k][p].cpu())
                                           for p in ("q", "scale")):
            raise AssertionError(f"{k}: the card's int8 weights differ")
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 40, 17, 3, 29)]
    serves = {}
    for unified in (True, False):
        for flag in (True, False):
            TP.set_flags({"FLAGS_serving_a8w8_prefill": int(flag)})
            try:
                outs = []
                for dev, params in (("cuda", q_gpu), ("cpu", q_cpu)):
                    eng = D.ContinuousBatchingEngine(
                        cfg, D.GenerationConfig(max_new_tokens=8),
                        num_slots=2, page_size=16, max_seq_len=128, chunk=4,
                        device=dev, unified=unified)
                    _reset(counters)
                    outs.append(_serve_checked(eng, params, prompts)[0])
                    if dev == "cuda":
                        _add(launches, _read(counters))
            finally:
                TP.set_flags({"FLAGS_serving_a8w8_prefill": 1})
            if outs[0] != outs[1]:
                raise AssertionError(f"int8 (unified {unified}, a8w8 {flag})"
                                     f": card {outs[0]} != cpu {outs[1]}")
            serves[f"{'unified' if unified else 'legacy'}_"
                   f"{'a8w8' if flag else 'weight_only'}"] = outs[0]
    report["serves"] = serves

    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(40, 256, generator=gen)
    wq = torch.randint(-127, 128, (256, 512), generator=gen,
                       dtype=torch.int8)
    ws = torch.rand(512, generator=gen) * 0.01
    xq = torch.randint(-127, 128, (40, 256), generator=gen,
                       dtype=torch.int8)
    prod = (ftb.int32_product(xq.cuda(), wq.cuda()).cpu(),
            ftb.int32_product(xq, wq))
    mm = (ftb._int8_mm(x.cuda(), wq.cuda(), ws.cuda()).cpu(),
          ftb._int8_mm(x, wq, ws))
    if not (torch.equal(*prod) and torch.equal(*mm)):
        raise AssertionError("_int8_mm on the card is not the CPU's bits")
    report["int8_mm_bitwise"] = True

    TP.seed(SEED)
    fm_cpu = FusedMultiTransformer(128, 2, 256, num_layers=2, device="cpu")
    fm_gpu = FusedMultiTransformer(128, 2, 256, num_layers=2, device="cuda")
    fm_gpu.set_state_dict(fm_cpu.state_dict())
    outs = {}
    for dev, fm in (("cuda", fm_gpu), ("cpu", fm_cpu)):
        q = FusedMultiTransformerInt8.from_float(
            fm, qkv_in_scale=[4.0, 4.0])
        xs = torch.randn(2, 17, 128, generator=torch.Generator()
                         .manual_seed(SEED)).to(dev)
        _reset(counters)
        pre, cache = q(xs[:, :16], gen_cache_len=17)
        step, cache = q(xs[:, 16:], caches=cache, time_step=16)
        if dev == "cuda":
            _add(launches, _read(counters))
        outs[dev] = (pre, step, cache)
    report["fused_int8"] = {
        name: l2_close(outs["cuda"][i].cpu(), outs["cpu"][i],
                       INT8_CARD_CPU_TOL, f"FusedMultiTransformerInt8 {name}")
        for i, name in enumerate(("prefill", "decode", "cache"))}

    TP.seed(SEED)
    net_cpu = _built_on_cpu(lambda: resnet18(num_classes=10))
    net_gpu = resnet18(num_classes=10)
    net_gpu.set_state_dict(net_cpu.state_dict())
    x_np = np.random.RandomState(SEED).randn(4, 3, 64, 64).astype(np.float32)
    y_np = np.array([3, 7, 0, 9], np.int64)
    res = {}
    for dev, net in (("cuda", net_gpu), ("cpu", net_cpu)):
        opt = TP.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
        loss = TP.nn.functional.cross_entropy(
            net(torch.from_numpy(x_np).to(dev)),
            torch.from_numpy(y_np).to(dev))
        loss.backward()
        res[dev] = (float(loss), {n: p.grad.detach().cpu()
                                  for n, p in net.named_parameters()})
        opt.step()
    worst = max(_rel(res["cuda"][1][k], res["cpu"][1][k])["rel_l2"]
                for k in res["cpu"][1])
    loss_rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    if loss_rel > VISION_CARD_CPU_TOL["loss"] or \
            worst > VISION_CARD_CPU_TOL["grad_rel_l2"]:
        raise AssertionError(f"ResNet-18 step: loss rel {loss_rel}, worst "
                             f"gradient rel L2 {worst}")
    report["resnet18"] = dict(loss=res["cuda"][0], loss_rel=loss_rel,
                              worst_grad_rel_l2=worst,
                              bounds=VISION_CARD_CPU_TOL)
    del net_gpu, net_cpu

    TP.seed(SEED)
    vit = _built_on_cpu(lambda: V.vit_tiny_test(embed_dim=128, num_heads=2))
    p_cpu = V.stacked_params_from_module(vit)
    xv = np.random.RandomState(SEED).randn(4, 3, 16, 16).astype(np.float32)
    yv = np.array([1, 5, 2, 9], np.int32)
    runs = {}
    for dev in ("cuda", "cpu"):
        step, init = V.build_vit_train_step(num_heads=2, patch=4,
                                            learning_rate=1e-3,
                                            dtype=torch.float32)
        params = {k: v.clone().to(dev) for k, v in p_cpu.items()}
        opt = init(params)
        _reset(counters)
        losses = [float(step(params, opt, torch.from_numpy(xv).to(dev),
                             torch.from_numpy(yv).to(dev))[0])
                  for _ in range(2)]
        if dev == "cuda":
            _add(launches, _read(counters))
        runs[dev] = (losses, {k: v.cpu() for k, v in params.items()})
    rtol, atol = CARD_CPU_TOL["loss"]
    np.testing.assert_allclose(runs["cuda"][0][0], runs["cpu"][0][0],
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(runs["cuda"][0][1], runs["cpu"][0][1],
                               rtol=1e-4)
    report["vit"] = dict(losses=runs["cuda"][0], cpu_losses=runs["cpu"][0],
                         **trained_weights_close(
                             runs["cuda"][1], runs["cpu"][1], 1e-3, 2,
                             hidden=128, msg="ViT steps"))
    return dict(report, launches=launches)


def int8_7b_phase(torch, L, D, rn, pa, cfg, params, greedy):
    """(b) Llama-2-7B with all eight keys weight-only int8
    (``quantize_stacked_params`` of phase 7's weights) served by
    ``ContinuousBatchingEngine`` with phase 7's load (12 requests, 8
    slots, 32 new tokens) through the CUDA graphs, A8W8 prefill on:
    step walls, tokens/s, peak memory, weight bytes, program builds and
    capture seconds, rows 1 and 3's launches checked against the
    micro-rounds, a profiled prefill and decode step, and how many greedy
    streams equal phase 7's bf16 ones (reported, not asserted:
    quantization may move tokens). Then FLAGS_serving_a8w8_prefill off
    once: one more counted program build, and the weight-only route's
    step walls on two of the prompts."""
    import paddle_tpu_torch as TP
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.observability.memory import pytree_nbytes
    from paddle_tpu_torch.observability.runtime import recompiles
    n_layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    qp = Q.quantize_stacked_params(params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    prompts = serve_load(cfg)
    eng = _serve_engine(D, cfg, step_tokens=256)

    def reset():
        rn.rms_norm.launches = 0
        _reset_ragged(pa)
    outs, report = _serve_run(torch, eng, qp, prompts, reset)
    launches = {"rms_norm_fwd": rn.rms_norm.launches,
                **_ragged_launches(pa)}
    rounds = eng.micro_rounds
    want = {"rms_norm_fwd": (2 * n_layers + 1) * rounds,
            **_ragged_want(torch, pa, n_layers * rounds)}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    _check_outputs(cfg, outs, eng)
    programs = _programs(eng, "cbe.unified_step")
    if not eng.compile_misses[0][1][7]:
        raise AssertionError(f"the A8W8 flag is not in the key "
                             f"{eng.compile_misses}")
    breakdown = step_breakdown(torch, eng, qp, cfg.vocab_size)
    before = recompiles.count("cbe.unified_step")
    TP.set_flags({"FLAGS_serving_a8w8_prefill": 0})
    try:
        rn.rms_norm.launches = 0
        _reset_ragged(pa)
        t1 = time.perf_counter()
        off, off_ms = _serve_checked(eng, qp, prompts[:2])
        off_s = time.perf_counter() - t1
        off_launches = {"rms_norm_fwd": rn.rms_norm.launches,
                        "ragged_paged_attention":
                            pa.ragged_paged_attention.launches}
    finally:
        TP.set_flags({"FLAGS_serving_a8w8_prefill": 1})
    if recompiles.count("cbe.unified_step") != before + 1 or \
            [k[7] for n, k in eng.compile_misses] != [True, False]:
        raise AssertionError(f"the flag flip: {eng.compile_misses}")
    identical = sum(a == b for a, b in zip(outs, greedy))
    prefix = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                   len(a)) for a, b in zip(outs, greedy)]
    steps = report["steps"]
    report.update(
        steady_mean_step_ms=(report["mean_step_ms"] * steps
                             - report["first_step_ms"]) / (steps - 1),
        first_token_equal_to_phase7=sum(p > 0 for p in prefix),
        tokens_equal_to_phase7_before_first_difference=prefix)
    report.update(
        quantize_s=quant_s, weight_bytes=pytree_nbytes(qp),
        bf16_weight_bytes=pytree_nbytes(params), micro_rounds=rounds,
        launches=launches, launches_per_micro_round={
            k: v / rounds for k, v in launches.items()},
        programs=programs, breakdown=breakdown,
        identical_to_phase7=identical, of=len(greedy),
        weight_only=dict(requests=2, steps=len(off_ms), serve_s=off_s,
                         step_ms=off_ms,
                         steady_mean_step_ms=float(np.mean(off_ms[1:])),
                         capture_s=eng.capture_seconds.get(
                             "cbe.unified_step"),
                         misses=len(eng.compile_misses),
                         identical_to_a8w8=sum(
                             a == b for a, b in zip(off, outs[:2]))))
    report["launches"] = _add(dict(launches), off_launches)
    del eng, qp
    _free_card(torch)
    return report


def int8_fused_phase(torch, ftb, fa, ln):
    """(c) ``FusedMultiTransformerInt8`` at BERT-large geometry (24
    layers, h 1024, 16 heads, ff 4096, bf16) against the bf16
    ``FusedMultiTransformer`` it was quantized from (seeded
    Xavier weights), a (8, 512) prefill: device ms of each (one CUDA
    graph of the call), the relative L2 and largest difference of the
    int8 output, and rows 5 and 8's launches of one int8 prefill (24
    and 48)."""
    import paddle_tpu_torch as TP
    from paddle_tpu_torch.incubate.nn import (FusedMultiTransformer,
                                              FusedMultiTransformerInt8)
    n_layers, h, heads, ff, b, s = 24, 1024, 16, 4096, 8, 512
    TP.seed(SEED)
    fm = FusedMultiTransformer(h, heads, ff, num_layers=n_layers,
                               dtype=torch.bfloat16, device="cuda")
    q = FusedMultiTransformerInt8.from_float(fm)
    x = torch.randn(b, s, h, generator=torch.Generator(device="cuda")
                    .manual_seed(SEED), device="cuda").to(torch.bfloat16)
    counters = dict(flash_attention_fwd=fa.flash_fwd_kernel,
                    layer_norm_fwd=ln.layer_norm)
    _reset(counters)
    got = q(x)
    launches = _read(counters)
    want = dict(flash_attention_fwd=n_layers, layer_norm_fwd=2 * n_layers)
    if launches != want:
        raise AssertionError(f"int8 stack launches {launches} != {want}")
    ref = fm(x)
    close = _rel(got.float(), ref.float())
    if not (torch.isfinite(got).all() and close["rel_l2"] < 0.1):
        raise AssertionError(f"int8 stack far from the bf16 one: {close}")
    with torch.no_grad():
        bf16_ms = device_ms(torch, lambda: fm(x), iters=3, replays=3)
        int8_ms = device_ms(torch, lambda: q(x), iters=3, replays=3)
    report = dict(geometry=dict(layers=n_layers, hidden=h, heads=heads,
                                ffn=ff, batch=b, seq=s),
                  bf16_ms=bf16_ms, int8_ms=int8_ms,
                  speedup=bf16_ms / int8_ms, **close,
                  launches=launches)
    del fm, q
    _free_card(torch)
    return report


def _vision_steps(torch, step, args, counters, warm, timed, want=None):
    """``warm`` + ``timed`` calls of a train step, each synchronized and
    timed on the host clock, the counters zeroed before each and (with
    ``want``) checked after it. Returns the losses, the timed steps' ms
    and the launch totals."""
    losses, ms, totals = [], [], {}
    for i in range(warm + timed):
        _reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(*args)
        losses.append(float(getattr(loss, "_value", loss)))
        ms.append((time.perf_counter() - t0) * 1e3)
        got = _read(counters)
        if want is not None and got != want:
            raise AssertionError(f"step {i}: launches {got} != {want}")
        _add(totals, got)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    return losses, ms[warm:], totals


VISION_WARM, VISION_STEPS = 3, 5


def resnet50_phase(torch):
    """(d) ResNet-50 (1000 classes) as ``benchmarks/bench_resnet.py``
    trains it: B 128 at 224², ``amp.decorate(level="O2",
    dtype="bfloat16")``, Momentum (lr 0.1, 0.9) through ``jit.TrainStep``
    (a CUDA graph); 3 warm-up and 5 timed steps: ms/step (median), img/s,
    peak memory, finite losses."""
    import paddle_tpu_torch as TP
    from paddle_tpu_torch import amp, jit, optimizer
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision.models import resnet50
    b, side = 128, 224
    TP.seed(SEED)
    net = resnet50(num_classes=1000)
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=net.parameters())
    amp.decorate(models=net, optimizers=opt, level="O2", dtype="bfloat16")

    def loss_fn(model, x, y):
        return F.cross_entropy(model(x).astype("float32"), y)

    step = jit.TrainStep(net, loss_fn, opt)
    rng = np.random.RandomState(SEED)
    x = TP.to_tensor(rng.randn(b, 3, side, side).astype(np.float32)) \
        .astype("bfloat16")
    y = TP.to_tensor(rng.randint(0, 1000, (b,)).astype(np.int64))
    torch.cuda.reset_peak_memory_stats()
    losses, ms, _ = _vision_steps(torch, step, (x, y), {}, VISION_WARM,
                                  VISION_STEPS)
    step_ms = float(np.median(ms))
    report = dict(batch=b, side=side, amp="O2 bf16", optimizer="Momentum",
                  steps=dict(warm=VISION_WARM, timed=VISION_STEPS),
                  losses=losses, step_ms=ms, median_step_ms=step_ms,
                  img_per_s=b / (step_ms / 1e3),
                  captures=step.programs.captures,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del step, net, opt, x
    _free_card(torch)
    return report


def vit_l_phase(torch, fa, ln):
    """(e) ViT-L/16 (1000 classes) through ``build_vit_train_step`` as
    ``bench_workloads.py``'s stacked path sets it up: weights of two or
    more dims in bf16, biases and the rest fp32, fp32 AdamW moments, B 32
    at 224², ``remat="dots"``, one CUDA graph; 3 warm-up and 5 timed
    steps: ms/step, img/s, MFU against 989 TFLOP/s by the bench's FLOP
    count (6 · (params − the head's 1000·1024) · 197 tokens an image),
    peak memory; rows 5, 6 and 8's launches a step checked (the layer
    recomputed in the backward runs its forward again: flash forward
    2·24, dQ and dK/dV 24, LayerNorm forward 4·24 + 1, backward
    2·24 + 1)."""
    import paddle_tpu_torch as TP
    from paddle_tpu_torch.vision.models import vit as V
    b, side, n_layers = 32, 224, 24
    TP.seed(SEED)
    net = V.vit_large_patch16_224(class_num=1000)
    n_params = sum(p.numel() for p in net.parameters())
    params = {k: (v.to(torch.bfloat16) if v.dtype == torch.float32
                  and v.dim() > 1 else v)
              for k, v in V.stacked_params_from_module(net).items()}
    del net
    step, init = V.build_vit_train_step(num_heads=16, patch=16,
                                        learning_rate=1e-4,
                                        dtype=torch.bfloat16)
    opt = init(params)
    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(rng.randn(b, 3, side, side).astype(np.float32)) \
        .cuda()
    y = torch.from_numpy(rng.randint(0, 1000, (b,)).astype(np.int32)).cuda()
    counters = dict(_flash_counters(fa), layer_norm_fwd=ln.layer_norm,
                    layer_norm_bwd=ln.layer_norm_bwd)
    want = {"flash_attention_fwd": 2 * n_layers,
            "flash_attention_bwd_dq": n_layers,
            "flash_attention_bwd_dkv": n_layers,
            "layer_norm_fwd": 4 * n_layers + 1,
            "layer_norm_bwd": 2 * n_layers + 1}
    torch.cuda.reset_peak_memory_stats()
    losses, ms, totals = _vision_steps(
        torch, lambda: step(params, opt, x, y)[0], (), counters,
        VISION_WARM, VISION_STEPS, want)
    step_ms = float(np.median(ms))
    img_s = b / (step_ms / 1e3)
    tokens = (side // 16) ** 2 + 1
    flops_img = 6.0 * (n_params - 1000 * 1024) * tokens
    report = dict(batch=b, side=side, params_m=n_params / 1e6,
                  steps=dict(warm=VISION_WARM, timed=VISION_STEPS),
                  losses=losses, step_ms=ms, median_step_ms=step_ms,
                  img_per_s=img_s, flops_per_img=flops_img,
                  mfu=flops_img * img_s / PEAK_OPS_PER_S["bf16"],
                  captures=step.programs.captures,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                  launches_per_step=want, launches=totals)
    del step, params, opt
    _free_card(torch)
    return report


def ppyoloe_phase(torch):
    """(f) PP-YOLOE-s (80 classes, width 0.5, depth 0.33) as
    ``bench_workloads.py`` trains it: B 16 at 320², 8 ground truths an
    image, AdamW (lr 1e-4) through ``jit.TrainStep`` over
    ``compute_loss``; 3 warm-up and 5 timed steps (ms/step, img/s, peak
    memory, finite losses); then ``predict_with_nms`` on the batch in
    eval mode: the detections an image."""
    import paddle_tpu_torch as TP
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.vision.models.ppyoloe import PPYOLOE
    b, side, g = 16, 320, 8
    net = PPYOLOE(num_classes=80, width_mult=0.5, depth_mult=0.33)
    TP.seed(SEED)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=net.parameters())
    step = jit.TrainStep(
        net, lambda model, x, gb, gl: model.compute_loss(x, gb, gl), opt)
    rng = np.random.RandomState(SEED)
    x = TP.to_tensor(rng.randn(b, 3, side, side).astype(np.float32))
    gb = rng.rand(b, g, 4).astype(np.float32) * side
    gb[..., 2:] = np.maximum(gb[..., 2:], gb[..., :2] + 4)
    gl = rng.randint(0, 80, (b, g)).astype(np.int32)
    args = (x, TP.to_tensor(gb), TP.to_tensor(gl))
    torch.cuda.reset_peak_memory_stats()
    losses, ms, _ = _vision_steps(torch, step, args, {}, VISION_WARM,
                                  VISION_STEPS)
    step_ms = float(np.median(ms))
    peak = torch.cuda.max_memory_allocated() / 1e9
    net.eval()
    t0 = time.perf_counter()
    dets = net.predict_with_nms(x, score_threshold=0.0, top_k=100,
                                nms_threshold=0.6, keep_top_k=30)
    nms_s = time.perf_counter() - t0
    if len(dets) != b or not all(
            d[0].shape[1] == 4 and 0 < d[0].shape[0] <= 30 for d in dets):
        raise AssertionError("predict_with_nms: bad detections")
    report = dict(batch=b, side=side, ground_truths=g,
                  params_m=sum(p.numel() for p in net.parameters()) / 1e6,
                  steps=dict(warm=VISION_WARM, timed=VISION_STEPS),
                  losses=losses, step_ms=ms, median_step_ms=step_ms,
                  img_per_s=b / (step_ms / 1e3),
                  captures=step.programs.captures, peak_mem_gb=peak,
                  predict_with_nms_s=nms_s,
                  detections=[int(d[0].shape[0]) for d in dets])
    del step, net, opt
    _free_card(torch)
    return report


# ---------------------------------------------------------------------------
# phase 40: the long tail — the Profiler around the 7B serve, and the
# slice's modules on the card against the CPU
# ---------------------------------------------------------------------------

#: the profiled serve: steps driven under the Profiler, and its window
PROFILE_STEPS = 8
PROFILE_WINDOW = (2, 6)
#: the kernels of rows 1 and 3 by the names the device trace gives them,
#: with the counter each is held to
P40_TRACE_NAMES = (("_rms_norm_fwd", "rms_norm_fwd"),
                   ("ragged_tiles_kernel", "ragged_wgmma"),
                   ("ragged_key_split_kernel", "ragged_key_split"),
                   ("decode_merge_kernel", "ragged_merge"))


def _device_counts(prof, names):
    """Kernel launches in a torch.profiler trace whose names hold each of
    ``names``."""
    from torch.autograd import DeviceType
    out = dict.fromkeys(names, 0)
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        for n in names:
            if n in e.key:
                out[n] += e.count
    return out


def _p40_counts(rn, pa):
    return {"rms_norm_fwd": rn.rms_norm.launches, **_ragged_launches(pa)}


def _profiled_serve(torch, eng, params, prompts, prof, rn, pa):
    """Serve ``prompts`` step by step; with ``prof`` the first
    ``PROFILE_STEPS`` steps run under it (``prof.step()`` after each), the
    counters zeroed as its window opens and read as it closes. Returns
    the tokens, each step's wall (ms) and the window's counts."""
    rids = [eng.submit(p) for p in prompts]
    results, walls, counts = {}, [], None
    lo, hi = PROFILE_WINDOW
    i = 0
    while len(results) < len(rids) or i < PROFILE_STEPS:
        if prof is not None and i == lo:
            start = _p40_counts(rn, pa)
        t0 = time.perf_counter()
        eng.step(params)
        walls.append((time.perf_counter() - t0) * 1e3)
        results.update(eng.collect())
        if prof is not None and i < PROFILE_STEPS:
            prof.step()
            if i + 1 == hi:
                end = _p40_counts(rn, pa)
                counts = {k: end[k] - start[k] for k in end}
            if i + 1 == PROFILE_STEPS:
                prof.stop()
        i += 1
        if i > 200:
            raise AssertionError("the profiled serve did not finish")
    return [results[r] for r in rids], walls, counts


def profiler_7b_phase(torch, D, rn, pa, cfg, params, greedy):
    """(a) Phase 7's serve (same engine geometry, weights and prompts,
    CUDA graphs) once unprofiled and once with its first 8 steps under
    ``Profiler(targets=[CPU, GPU], scheduler=(2, 6),
    on_trace_ready=export_chrome_tracing(dir))``: the host export holds
    the window's 4 step spans, the device trace names rows 1 and 3's
    kernels as many times as their launch counters counted over the
    window, the tokens equal the unprofiled run's and phase 7's, and the
    window's step walls stand beside the same steps unprofiled."""
    from paddle_tpu_torch import profiler as P
    prompts = serve_load(cfg)
    phase_start = _p40_counts(rn, pa)
    trace_dir = os.path.join("build", "p40_profiler")
    shutil.rmtree(trace_dir, ignore_errors=True)
    eng = _serve_engine(D, cfg, step_tokens=256)
    # the first serve builds and captures the step program; the second is
    # the unprofiled run the profiled one is compared with
    t0 = time.perf_counter()
    warm, _, _ = _profiled_serve(torch, eng, params, prompts, None, rn, pa)
    build_s = time.perf_counter() - t0
    plain, plain_ms, _ = _profiled_serve(torch, eng, params, prompts, None,
                                         rn, pa)
    prof = P.Profiler(targets=[P.ProfilerTarget.CPU, P.ProfilerTarget.GPU],
                      scheduler=PROFILE_WINDOW, log_dir=trace_dir,
                      on_trace_ready=P.export_chrome_tracing(trace_dir))
    prof.start()
    toks, prof_ms, counts = _profiled_serve(torch, eng, params, prompts,
                                            prof, rn, pa)
    if not toks == plain == warm or (greedy is not None and toks != greedy):
        raise AssertionError("the profiled serve's tokens differ from the "
                             "unprofiled run's or phase 7's")
    with open(prof.last_export_path) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted(e["name"] for e in events if e.get("cat") == "ProfileStep")
    lo, hi = PROFILE_WINDOW
    if steps != sorted(f"ProfileStep#{k}" for k in range(lo, hi)):
        raise AssertionError(f"host export's step spans {steps}")
    seen = _device_counts(prof.device_profile,
                          [n for n, _ in P40_TRACE_NAMES])
    for name, key in P40_TRACE_NAMES:
        if seen[name] != counts[key]:
            raise AssertionError(f"device trace: {name} {seen[name]} times, "
                                 f"its counter {counts[key]}")
    if counts["ragged_paged_attention"] != counts["ragged_wgmma"] or \
            counts["rms_norm_fwd"] <= 0:
        raise AssertionError(f"window counts {counts}")
    window = slice(lo, hi)
    _check_outputs(cfg, toks, eng)
    summary = prof.summary(time_unit="ms").splitlines()
    phase_end = _p40_counts(rn, pa)
    del eng
    _free_card(torch)
    return dict(
        launches={k: phase_end[k] - phase_start[k] for k in phase_end},
        steps=len(prof_ms), build_and_first_serve_s=build_s,
        window_steps=hi - lo, step_spans=steps,
        window_launches=counts, device_trace_counts=seen,
        window_step_ms_profiled=prof_ms[window],
        window_step_ms_unprofiled=plain_ms[window],
        mean_step_ms_profiled=float(np.mean(prof_ms[window])),
        mean_step_ms_unprofiled=float(np.mean(plain_ms[window])),
        profiler_overhead_ms_a_step=float(np.mean(prof_ms[window])
                                          - np.mean(plain_ms[window])),
        host_export=os.path.basename(prof.last_export_path),
        host_events=len(events),
        device_trace=os.path.basename(prof.device_trace_path),
        device_trace_mb=os.path.getsize(prof.device_trace_path) / 1e6,
        summary_top=summary[:8])


def _cuda_ms(torch, fn):
    """One warm call, then one call timed with CUDA events: (result,
    ms)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _host_rel_l2(a, b):
    """||a - b|| / ||b|| in fp64 (complex128 for complex) on the host."""
    a, b = (t.detach().cpu() for t in (a, b))
    a, b = ((t.cdouble() if t.is_complex() else t.double()) for t in (a, b))
    return float((a - b).norm() / b.norm())


def _held(name, value, bound, report):
    """Record ``value`` in ``report``; one over its bound is listed under
    ``report["_over"]`` (:func:`_check_held` raises for the list, once
    every value is recorded)."""
    report[name] = value
    if not value <= bound:
        report.setdefault("_over", []).append(f"{name} {value} > {bound}")


def _check_held(report):
    over = report.pop("_over", None)
    if over:
        raise AssertionError(f"over their bounds: {over}; all: {report}")
    return report


def linalg_card_phase(torch, TP):
    """(b) ``linalg`` at (4096, 4096) fp32 (svd and lstsq at 2048):
    residual and orthogonality bounds on the card, the card's results
    against the port's CPU path where the CPU is quick enough, each
    call's device ms (``testing.LINALG_CARD_TOL``)."""
    from paddle_tpu_torch.testing import LINALG_CARD_TOL as T
    g = torch.Generator().manual_seed(SEED)
    n, m = 4096, 2048
    a = torch.randn(n, n, generator=g) / math.sqrt(n) + 3 * torch.eye(n)
    s = a @ a.T
    b = torch.randn(n, 8, generator=g)
    am = torch.randn(n, m, generator=g) / math.sqrt(n)
    sq = am[:m]
    bm = torch.randn(n, 4, generator=g)
    la = TP.linalg
    cuda = {k: TP.to_tensor(v.numpy()) for k, v in
            dict(a=a, s=s, b=b, am=am, sq=sq, bm=bm).items()}
    TP.set_device("cpu")
    host = {k: TP.to_tensor(v.numpy()) for k, v in
            dict(a=a, s=s, b=b, am=am, sq=sq, bm=bm).items()}
    TP.set_device("gpu")
    v = {k: t._value for k, t in cuda.items()}
    out, ms = {}, {}
    eye = torch.eye(n, device="cuda")
    x, ms["solve"] = _cuda_ms(torch, lambda: la.solve(cuda["a"], cuda["b"]))
    _held("solve_residual", _host_rel_l2(v["a"] @ x._value, v["b"]),
          T["residual"], out)
    _held("solve_card_cpu", _host_rel_l2(x._value, la.solve(host["a"],
                                                    host["b"])._value),
          T["card_cpu"], out)
    lo, ms["cholesky"] = _cuda_ms(torch, lambda: la.cholesky(cuda["s"]))
    lv = lo._value
    _held("cholesky_residual", _host_rel_l2(lv @ lv.T, v["s"]), T["residual"], out)
    _held("cholesky_card_cpu", _host_rel_l2(lv, la.cholesky(host["s"])._value),
          T["card_cpu"], out)
    (q, r), ms["qr"] = _cuda_ms(torch, lambda: la.qr(cuda["a"]))
    _held("qr_residual", _host_rel_l2(q._value @ r._value, v["a"]), T["residual"],
          out)
    _held("qr_orthogonality", float((q._value.T @ q._value - eye).abs()
                                    .max()), T["orthogonality"], out)
    (w, vec), ms["eigh"] = _cuda_ms(torch, lambda: la.eigh(cuda["s"]))
    wv, vv = w._value, vec._value
    _held("eigh_residual", _host_rel_l2(v["s"] @ vv, vv * wv), T["residual"], out)
    _held("eigh_orthogonality", float((vv.T @ vv - eye).abs().max()),
          T["orthogonality"], out)
    inv, ms["inv"] = _cuda_ms(torch, lambda: la.inv(cuda["a"]))
    _held("inv_residual", float((v["a"] @ inv._value - eye).abs().max()),
          T["orthogonality"], out)
    _held("inv_card_cpu", _host_rel_l2(inv._value, la.inv(host["a"])._value),
          T["card_cpu"], out)
    sd, ms["slogdet"] = _cuda_ms(torch, lambda: la.slogdet(cuda["a"]))
    want = la.slogdet(host["a"])._value
    if float(sd._value[0]) != float(want[0]):
        raise AssertionError("slogdet sign card != cpu")
    _held("slogdet_card_cpu", abs(float(sd._value[1]) - float(want[1]))
          / abs(float(want[1])), T["card_cpu"], out)
    (packed, piv), ms["lu"] = _cuda_ms(torch, lambda: la.lu(cuda["a"]))
    p_, l_, u_ = la.lu_unpack(packed, piv)
    _held("lu_residual", _host_rel_l2(p_._value @ l_._value @ u_._value, v["a"]),
          T["residual"], out)
    (u, sv, vh), ms["svd_2048"] = _cuda_ms(torch, lambda: la.svd(cuda["sq"]))
    _held("svd_residual", _host_rel_l2((u._value * sv._value) @ vh._value, v["sq"]),
          T["residual"], out)
    eye_m = torch.eye(m, device="cuda")
    _held("svd_orthogonality", float((u._value.T @ u._value - eye_m).abs()
                                     .max()), T["orthogonality"], out)
    _held("svd_card_cpu", _host_rel_l2(sv._value, torch.linalg.svdvals(
        host["sq"]._value)), T["card_cpu"], out)
    (xs, res, rank, _), ms["lstsq_4096x2048"] = _cuda_ms(
        torch, lambda: la.lstsq(cuda["am"], cuda["bm"]))
    # the least-squares solution's residual is orthogonal to A's columns
    normal = v["am"].T @ (v["am"] @ xs._value - v["bm"])
    _held("lstsq_normal_equations", float(
        normal.norm() / (v["am"].T @ v["bm"]).norm()), T["residual"], out)
    if int(rank._value) != m:
        raise AssertionError(f"lstsq rank {int(rank._value)}")
    return _check_held(dict(out, device_ms=ms))


def signal_card_phase(torch, TP):
    """(b) ``signal.stft``/``istft``, ``MelSpectrogram`` (80 mels) and
    ``MFCC`` (40 coefficients) over 32 clips of 10 s at 16 kHz (n_fft
    512, hop 160, window 400): the round trip's error, card against CPU,
    each call's device ms (``testing.SIGNAL_CARD_TOL``)."""
    from paddle_tpu_torch.testing import SIGNAL_CARD_TOL as T
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn(32, 160000, generator=g) * 0.1
    win = TP.audio.functional.get_window("hann", 400)._value
    kw = dict(hop_length=160, win_length=400)
    out, ms = {}, {}
    res = {}
    for dev in ("gpu", "cpu"):
        TP.set_device(dev)
        xt = TP.to_tensor(x.numpy())
        w = TP.to_tensor(win.cpu().numpy())
        mel = TP.audio.features.MelSpectrogram(
            sr=16000, n_fft=512, n_mels=80, f_min=0.0, **kw)
        mfcc = TP.audio.features.MFCC(sr=16000, n_mfcc=40, n_fft=512,
                                      n_mels=80, f_min=0.0, **kw)
        fns = dict(
            stft=lambda: TP.signal.stft(xt, 512, window=w, **kw),
            mel=lambda: mel(xt), mfcc=lambda: mfcc(xt))
        if dev == "gpu":
            got = {k: _cuda_ms(torch, f) for k, f in fns.items()}
            ms.update({k: t for k, (_, t) in got.items()})
            res["gpu"] = {k: r._value for k, (r, _) in got.items()}
            back, ms["istft"] = _cuda_ms(torch, lambda: TP.signal.istft(
                got["stft"][0], 512, window=w, length=x.shape[1], **kw))
            _held("istft_round_trip", _host_rel_l2(back._value, xt._value),
                  T["round_trip"], out)
        else:
            res["cpu"] = {k: f()._value for k, f in fns.items()}
    TP.set_device("gpu")
    for k in res["gpu"]:
        _held(f"{k}_card_cpu", _host_rel_l2(res["gpu"][k], res["cpu"][k]),
              T["card_cpu"], out)
    out["frames"] = int(res["gpu"]["stft"].shape[-1])
    return _check_held(dict(out, device_ms=ms))


#: family -> (constructor over the distribution module and a to_tensor,
#: discrete, whether each element's draw is its own: a whole-array
#: rejection loop (Hörmann's Poisson, BTRS) updates accepted elements
#: while any other is still drawing, so its CPU draw must be the whole
#: array's)
P40_FAMILIES = {
    "Normal": (lambda D, t: D.Normal(t(0.5), t(2.0)), False, True),
    "Uniform": (lambda D, t: D.Uniform(t(-1.0), t(3.0)), False, True),
    "Exponential": (lambda D, t: D.Exponential(t(1.5)), False, True),
    "Laplace": (lambda D, t: D.Laplace(t(0.0), t(1.0)), False, True),
    "Gumbel": (lambda D, t: D.Gumbel(t(1.0), t(2.0)), False, True),
    "Cauchy": (lambda D, t: D.Cauchy(t(0.0), t(1.0)), False, True),
    "LogNormal": (lambda D, t: D.LogNormal(t(0.0), t(0.5)), False, True),
    "Gamma": (lambda D, t: D.Gamma(t(0.7), t(2.0)), False, True),
    "Chi2": (lambda D, t: D.Chi2(t(4.0)), False, True),
    "Beta": (lambda D, t: D.Beta(t(2.0), t(0.5)), False, True),
    "StudentT": (lambda D, t: D.StudentT(t(5.0)), False, True),
    "Bernoulli": (lambda D, t: D.Bernoulli(t(0.3)), True, True),
    "Geometric": (lambda D, t: D.Geometric(t(0.2)), True, True),
    "Poisson_knuth": (lambda D, t: D.Poisson(t(3.5)), True, True),
    "Poisson_rejection": (lambda D, t: D.Poisson(t(40.0)), True, False),
    "Binomial_inversion": (lambda D, t: D.Binomial(t(20.0), t(0.3)), True,
                           True),
    "Binomial_btrs": (lambda D, t: D.Binomial(t(200.0), t(0.4)), True,
                      False),
    "Categorical": (lambda D, t: D.Categorical(t(np.log(np.array(
        [0.1, 0.2, 0.3, 0.4], np.float32)))), True, True),
    "MultivariateNormal": (lambda D, t: D.MultivariateNormal(
        t(np.zeros(2, np.float32)), covariance_matrix=t(np.array(
            [[2.0, 0.5], [0.5, 1.0]], np.float32))), False, True),
    "Dirichlet": (lambda D, t: D.Dirichlet(t(np.array(
        [0.5, 1.0, 2.0, 4.0], np.float32))), False, True),
    "Multinomial": (lambda D, t: D.Multinomial(10, t(np.array(
        [0.1, 0.2, 0.3, 0.4], np.float32))), True, True),
}
P40_DRAWS = 2 ** 20
#: the CPU's share of an element-wise family's draws (a prefix: element
#: i's bits and keys do not depend on the array's size)
P40_CPU_DRAWS = 2 ** 16


def distribution_card_phase(torch, TP):
    """(b) 2^20 draws of each family on the card against the CPU's under
    the same key (a 2^16 prefix where each element's draw is its own, the
    whole array where a rejection loop runs over it): discrete draws
    equal, continuous within ``testing.DRAW_TOL``, flipped decisions
    counted (``testing.DRAW_CARD_FLIPS``); draws per second; and the
    Dirichlet and Multinomial."""
    from paddle_tpu_torch.testing import DRAW_CARD_FLIPS, DRAW_TOL
    out = {}
    def to_tensor(v):
        return TP.to_tensor(np.float32(v) if np.isscalar(v) else v)

    for name, (mk, discrete, own) in P40_FAMILIES.items():
        kind = ("gamma" if name in ("Gamma", "Chi2", "Beta", "StudentT",
                                    "Dirichlet") else "normal")
        draws = {}
        for dev in ("gpu", "cpu"):
            TP.set_device(dev)
            TP.seed(SEED + 40)
            d = mk(TP.distribution, to_tensor)
            n = P40_DRAWS if dev == "gpu" or not own else P40_CPU_DRAWS
            if dev == "gpu":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                draws[dev] = d.sample((n,))._value
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
            else:
                draws[dev] = d.sample((n,))._value
        TP.set_device("gpu")
        got = draws["gpu"][:draws["cpu"].shape[0]].cpu()
        want = draws["cpu"]
        if discrete:
            flips = int((got != want).sum())
        else:
            rtol, atol = DRAW_TOL[kind]
            flips = int((~torch.isclose(got, want, rtol=rtol,
                                        atol=atol)).sum())
        if not bool(torch.isfinite(draws["gpu"]).all()):
            raise AssertionError(f"{name}: non-finite draws")
        _held(f"{name}_flips", flips,
              DRAW_CARD_FLIPS * want.numel(), out)
        out[f"{name}_compared"] = int(want.numel())
        out[f"{name}_draws_per_s"] = P40_DRAWS / sec
    return _check_held(out)


#: ogbn-arxiv's size (the OGB node-property benchmark's citation graph)
ARXIV_NODES, ARXIV_EDGES, ARXIV_FEATURES = 169343, 1166243, 128


def graph_card_phase(torch, TP):
    """(b) ``sparse.matmul`` and ``geometric.send_u_recv`` (sum, mean,
    max) on a seeded graph of ogbn-arxiv's size (169,343 nodes,
    1,166,243 edges, 128 features), card against CPU, device ms; and
    ``viterbi_decode`` at (64, 256) with 50 tags, paths card == CPU
    (``testing.GRAPH_CARD_TOL``)."""
    from paddle_tpu_torch.testing import GRAPH_CARD_TOL as T
    rng = np.random.RandomState(SEED)
    src = rng.randint(0, ARXIV_NODES, ARXIV_EDGES).astype(np.int32)
    dst = rng.randint(0, ARXIV_NODES, ARXIV_EDGES).astype(np.int32)
    x = rng.randn(ARXIV_NODES, ARXIV_FEATURES).astype(np.float32)
    w = rng.rand(ARXIV_EDGES).astype(np.float32)
    emis = rng.randn(64, 256, 50).astype(np.float32)
    trans = rng.randn(50, 50).astype(np.float32)
    lens = rng.randint(1, 257, 64).astype(np.int32)
    out, ms, res = {}, {}, {}
    for dev in ("gpu", "cpu"):
        TP.set_device(dev)
        xt, st, dt = (TP.to_tensor(a) for a in (x, src, dst))
        adj = TP.sparse.sparse_coo_tensor(np.stack([dst, src]),
                                          TP.to_tensor(w),
                                          shape=(ARXIV_NODES, ARXIV_NODES))
        fns = {f"send_u_recv_{op}": (lambda op=op: TP.geometric.send_u_recv(
            xt, st, dt, op, out_size=ARXIV_NODES)) for op in
            ("sum", "mean", "max")}
        fns["sparse_matmul"] = lambda: TP.sparse.matmul(adj, xt)
        fns["viterbi"] = lambda: TP.text.viterbi_decode(
            TP.to_tensor(emis), TP.to_tensor(trans), TP.to_tensor(lens))
        if dev == "gpu":
            got = {k: _cuda_ms(torch, f) for k, f in fns.items()}
            ms.update({k: t for k, (_, t) in got.items()})
            res[dev] = {k: r for k, (r, _) in got.items()}
        else:
            res[dev] = {k: f() for k, f in fns.items()}
    TP.set_device("gpu")
    for k in fns:
        if k == "viterbi":
            (gs, gp), (cs, cp) = res["gpu"][k], res["cpu"][k]
            if not torch.equal(gp._value.cpu(), cp._value):
                raise AssertionError("viterbi paths card != cpu")
            _held("viterbi_scores_card_cpu", _host_rel_l2(gs._value, cs._value),
                  T["sum"], out)
            continue
        got, want = res["gpu"][k]._value, res["cpu"][k]._value
        if k.endswith("max"):
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"{k}: card != cpu")
            out[f"{k}_equal"] = True
        else:
            _held(f"{k}_card_cpu", _host_rel_l2(got, want), T["sum"], out)
    return _check_held(dict(out, device_ms=ms))


def long_tail_phase(torch):
    """(b) the slice's modules on the card against the port's CPU path,
    TF32 off (each part switches the current place between the card and
    the host; the place it found is restored)."""
    import paddle_tpu_torch as TP
    from paddle_tpu_torch.core import place as tplace
    saved = tplace._current_place[0]
    try:
        return _long_tail(torch, TP)
    finally:
        tplace._current_place[0] = saved


def _long_tail(torch, TP):
    t0 = time.perf_counter()
    rep = dict(linalg=linalg_card_phase(torch, TP))
    rep["linalg_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    rep["signal_audio"] = signal_card_phase(torch, TP)
    rep["signal_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    rep["distribution"] = distribution_card_phase(torch, TP)
    rep["distribution_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    rep["graph_text"] = graph_card_phase(torch, TP)
    rep["graph_s"] = time.perf_counter() - t1
    _free_card(torch)
    return rep


def main() -> int:
    t_run = time.perf_counter()
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
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.ops import _common
    from paddle_tpu_torch.ops import fused_transformer_block as ftb
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
        # the run's seconds so far: the smoke must stay inside its limit
        print(f"[{n}/{N_PHASES}] (at {time.perf_counter() - t_run:.1f} s) "
              f"{what}:", json.dumps(report), flush=True)

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
    allocated0 = torch.cuda.memory_allocated()
    fleet = fleet_7b_phase(torch, L, D, rn, pa, cfg7b, params7b, serve,
                           greedy_tokens)
    bundles = fleet.pop("_bundles")
    fleet_released(torch, allocated0, fleet)
    done(24, f"Llama-2-7B bf16 serving fleet (router, chaos, roles, "
         f"sensors) on {card}", fleet)
    hosts = multihost_7b_phase(torch, L, D, pa, cfg7b, params7b, fleet)
    done(30, f"two Llama-2-7B bf16 engine processes (HostFleetRouter: "
         f"storm, federation, migrate_host, host_die) on {card}", hosts)
    legacy = legacy_7b_phase(torch, L, D, rn, pa, fa, cfg7b, params7b, serve)
    done(8, f"Llama-2-7B bf16 legacy serve and prefix-cache wave on {card}",
         legacy)
    done(20, "tiny sampled / constrained / speculative / do_sample engines, "
         "card == cpu tokens", sampling_parity_phase(torch, L, D))
    options = sampling_7b_phase(torch, L, D, C, rn, pa, cfg7b, params7b,
                                serve, greedy_tokens)
    done(21, f"Llama-2-7B bf16 sampled, constrained and speculative serves "
         f"on {card}", options)
    fused7 = fused_tail_7b_phase(torch, D, rn, pa, cfg7b, params7b, serve,
                                 greedy_tokens)
    done(34, f"(d) Llama-2-7B bf16 unified and speculative serves with "
         f"fused_tail=True on {card}", fused7)
    t38 = time.perf_counter()
    done(38, "(a) tiny fp32 engines (greedy and seeded sampled, prefix "
         "cache and speculation on and off) over serving meshes of 1, 2 "
         "and 4 logical chips on cuda:0, card == cpu tokens",
         tp_tiny_phase(torch, L, D))
    slabs = head_slab_phase(torch, pa)
    done(38, "(b) row 3 on the head slabs of serving meshes at the 7B "
         "serve's packed shapes vs the whole call and vs plain", slabs)
    allocated38 = torch.cuda.memory_allocated()
    tp7 = tp_7b_phase(torch, L, D, rn, pa, cfg7b, params7b, greedy_tokens)
    done(38, f"(c) Llama-2-7B bf16 over serving_mesh({TP_CHIPS}, [cuda:0] "
         f"* {TP_CHIPS}) against phase 7 on {card}", tp7)
    storm = elastic_storm_phase(torch, L, D)
    done(38, "(d) the seeded chip-loss storm of two 2-chip replicas, tiny "
         "fp32, byte-identical to the fault-free storm and the CPU's",
         storm)
    el7 = elastic_7b_phase(torch, D, rn, pa, cfg7b, params7b)
    fleet_released(torch, allocated38, el7)
    done(38, f"(d) lose_chip on a 2-replica Llama-2-7B bf16 fleet (mp 2 -> "
         f"1), the resize arc timed, on {card}", el7)
    done(38, "(e) auto_parallel (shard_tensor, reshard, shard_layer, "
         "Engine.fit) over a one-rank NCCL group == the CPU",
         auto_parallel_phase(torch))
    done(38, f"(f) a serving mesh over two cards (NCCL all-reduce) (phase "
         f"38 in {time.perf_counter() - t38:.1f} s)",
         tp_two_cards_phase(torch, L, D))
    _free_card(torch)
    t39 = time.perf_counter()
    i8_tiny = int8_tiny_phase(torch, L, D, rn, pa, fa, ln, ftb)
    done(39, "(a) int8 Llama on both pipelines with A8W8 on and off, "
         "_int8_mm, FusedMultiTransformerInt8, a ResNet-18 step and two ViT "
         "steps, card == cpu", i8_tiny)
    i8_7b = int8_7b_phase(torch, L, D, rn, pa, cfg7b, params7b,
                          greedy_tokens)
    done(39, f"(b) Llama-2-7B weight-only int8 (A8W8 prefill) served with "
         f"phase 7's load on {card}", i8_7b)
    t39 = time.perf_counter() - t39
    t40 = time.perf_counter()
    p40 = profiler_7b_phase(torch, D, rn, pa, cfg7b, params7b, greedy_tokens)
    done(40, f"(a) Llama-2-7B bf16 serve under Profiler(targets=[CPU, GPU], "
         f"scheduler={PROFILE_WINDOW}) against the same serve unprofiled "
         f"on {card}", p40)
    tail = long_tail_phase(torch)
    done(40, f"(b) linalg, signal and audio features, distribution draws, "
         f"sparse, geometric and text on the card against the CPU on "
         f"{card} (phase 40 in {time.perf_counter() - t40:.1f} s)", tail)
    gens = generate_7b_phase(torch, L, D, rn, pa, fa, cfg7b, params7b)
    done(22, f"Llama-2-7B bf16 generate engines on {card}", gens)
    del params7b             # the training phases need the memory
    gc.collect()
    torch.cuda.empty_cache()
    # the replay rebuilds its own 7B weights: it runs once phase 7's are
    # gone (13.5 GB of weights and two 4.3 GB pools a replay)
    replay = replay_7b_phase(torch, rn, pa, bundles,
                             fleet["b_chaos"]["serve_s"])
    done(29, f"postmortem replay of phase 24 (b)'s 7B bundles on {card}",
         replay)

    rms_bwd = rms_norm_bwd_phase(torch, rn)
    done(9, "rms_norm backward kernel vs plain", rms_bwd)
    flash = flash_phase(torch, fa)
    done(10, "flash attention kernels vs plain", flash)
    done(11, "tiny training, card == cpu", train_parity_phase(torch, L))
    train = train_7b_phase(torch, L, rn, fa)
    done(12, f"Llama-2-7B widths, 8 layers, bf16 training on {card}", train)
    gc.collect()
    torch.cuda.empty_cache()
    done(31, "tiny eager Tensor path (fp32 and auto_cast O1), training "
         "dropout, nan/inf checkers, card == cpu",
         eager_parity_phase(torch, L, ln))
    eager = eager_7b_phase(torch, L, rn, fa, train)
    done(31, f"Llama-2-7B widths, 8 layers, eager Tensor-path training "
         f"under auto_cast O1 on {card}", eager)
    el = eager["launches"]

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
    gc.collect()
    torch.cuda.empty_cache()

    done(25, "tiny GPT, card == cpu; LayerNorm at h 1600 and flash at d 64 "
         "x 25 heads vs plain", gpt_parity_phase(torch, G, ftb, ln, fa))
    gpt_xl = gpt2_xl_phase(torch, G, ftb, ln, fa)
    done(26, f"GPT-2 XL bf16 generate and training on {card}", gpt_xl)
    gl = gpt_xl["launches"]
    recipe = recipe_parity_phase(torch, G, L, D, rn, pa, fa)
    done(27, "every optimizer family, the clip, the scheduler and the loss "
         "scaler card == cpu; legacy bf16 continuations", recipe)
    xl_recipe = gpt2_xl_recipe_phase(torch, G, ln, fa, gpt_xl["train"])
    done(28, f"GPT-2 XL training with the reference's recipe on {card}",
         xl_recipe)
    resilient = gpt2_xl_resilience_phase(torch, G, ln, fa)
    done(32, f"GPT-2 XL's recipe through ResilientTrainer (preemption, "
         f"corrupt shard, NaN rollback) on {card}", resilient)
    xs = resilient["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    done(33, "tiny Transformer MT through Model.fit, greedy and beam "
         "search, and each new nn family, card == cpu",
         mt_parity_phase(torch, ln))
    t33 = time.perf_counter()
    beam = seq2seq_beam_phase(torch)
    done(33, f"LSTM seq2seq beam search (batch 128, beam 10, 50 steps) on "
         f"{card}", beam)
    mt = mt_base_phase(torch, ln, fa)
    done(33, f"Transformer-base fp32 through Model.fit, evaluate, save / "
         f"load, predict and greedy decoding on {card} ((b) and (c) in "
         f"{time.perf_counter() - t33:.1f} s)", mt)
    ml = mt["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    done(34, "(a) to_static, TrainStep, multi_step, dy2static, jit.save / "
         "Predictor, fused tail and fused Adam: card == cpu, graphs == "
         "graphs off bitwise", jit_parity_phase(torch, L, D, ln, rn, fa))
    jmt = jit_mt_base_phase(torch, ln)
    done(34, f"(b) Transformer-base through Model.prepare(jit_compile=True) "
         f"against the eager Model.fit on the same padded batches, (e) the "
         f"fused Adam, on {card}", jmt)
    jpred = jit_predictor_phase(torch, ln)
    done(34, f"(c) jit.save of Transformer-base's forward through the "
         f"Predictor on {card}", jpred)
    done(34, f"(f) the custom-op dispatch of rows 1, 8 and 5 against the "
         f"direct call, a call and in Transformer-base's greedy decoding, "
         f"on {card}", dispatch_cost_phase(torch, ln, rn, fa))
    gc.collect()
    torch.cuda.empty_cache()
    t35 = time.perf_counter()
    done(35, "(a) the collective API over a one-rank NCCL group == gloo on "
         "the CPU bitwise, the native TCPStore, the RNG tracker card == cpu",
         distributed_phase(torch))
    remat = remat_7b_phase(torch, L, rn, fa)
    done(35, f"(b) Llama-2-7B widths, 8 layers, bf16 training under the "
         f"full, dots, attn and offload remat policies on {card}", remat)
    rcmt = recompute_mt_phase(torch, ln)
    done(35, f"(c) Transformer-base with every layer under fleet.recompute "
         f"and AMPOptimizer against the plain steps, bitwise, on {card} "
         f"(phase 35 in {time.perf_counter() - t35:.1f} s)", rcmt)
    rml, rcl = remat["launches"], rcmt["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    t36 = time.perf_counter()
    hyb, saved_env = hybrid_7b_phase(torch, L, rn, fa)
    try:
        done(36, f"(a) build_hybrid_train_step over a one-rank NCCL mesh at "
             f"Llama-2-7B widths, 8 layers, bf16, against phase 12's step "
             f"on {card}", hyb)
        fh = fleet_hybrid_phase(torch, L, rn, fa)
    finally:
        from paddle_tpu_torch import distributed as _D
        from paddle_tpu_torch.distributed.topology import \
            set_hybrid_communicate_group
        set_hybrid_communicate_group(None)
        _D.destroy_process_group()
        _restore_env(saved_env)
    done(36, f"(b) fleet.init / distributed_model / distributed_optimizer, "
         f"group_sharded_parallel('os_g') and PipelineParallel at degree 1 "
         f"against the plain steps, bitwise, on {card} (phase 36 in "
         f"{time.perf_counter() - t36:.1f} s)", fh)
    hl = {k: hyb["launches"][k] + fh["launches"][k] for k in hyb["launches"]}
    gc.collect()
    torch.cuda.empty_cache()
    t37 = time.perf_counter()
    ring = ring_attention_phase(torch, fa)
    done(37, f"(a) ring attention at Llama-2-7B widths (S 8192, 4 ranks' "
         f"hops in one process, MHA and 8 KV heads) against rows 5 and 6 "
         f"over the whole sequence and the plain version on {card}", ring)
    from paddle_tpu_torch import distributed as _D
    saved_env = _one_rank_nccl(_D)
    try:
        rf = ring_flash_one_rank(torch, fa)
    finally:
        _D.destroy_process_group()
        _restore_env(saved_env)
    done(37, "(a) ring_flash_attention over a one-rank NCCL group: rows 5 "
         "and 6 over the whole sequence", rf)
    moe = gpt_moe_phase(torch, ln, fa)
    done(37, f"(b) GPT-MoE (workload #4 widths, 8 experts top-2, GShard, "
         f"fp32) through jit.TrainStep, against the eager steps, and a "
         f"skewed step, on {card}", moe)
    cli = launch_cli_phase(torch)
    done(37, f"(c) python -m paddle_tpu_torch.distributed.launch on {card} "
         f"(phase 37 in {time.perf_counter() - t37:.1f} s)", cli)
    gc.collect()
    torch.cuda.empty_cache()
    t39c = time.perf_counter()
    i8_fused = int8_fused_phase(torch, ftb, fa, ln)
    done(39, f"(c) FusedMultiTransformerInt8 at BERT-large geometry against "
         f"the bf16 stack on {card}", i8_fused)
    r50 = resnet50_phase(torch)
    done(39, f"(d) ResNet-50 (B 128, 224², AMP O2 bf16, Momentum) through "
         f"jit.TrainStep on {card}", r50)
    vitl = vit_l_phase(torch, fa, ln)
    done(39, f"(e) ViT-L/16 (B 32, 224², bf16) through build_vit_train_step "
         f"on {card}", vitl)
    pp = ppyoloe_phase(torch)
    done(39, f"(f) PP-YOLOE-s (B 16, 320²) through jit.TrainStep, then "
         f"predict_with_nms, on {card} (phase 39 in "
         f"{t39 + time.perf_counter() - t39c:.1f} s)", pp)
    p39 = {}
    for r in (i8_tiny, i8_7b, i8_fused, vitl):
        _add(p39, r["launches"])
    p39 = {k: p39.get(k, 0) for k in P39_KERNELS}
    d3 = {k: ring["launches"][k] + rf["launches"][k] + moe["launches"][k]
          for k in ring["launches"]}
    d3.update({k: moe["launches"][k] for k in ("layer_norm_fwd",
                                                "layer_norm_bwd")})
    rl, xr, pl = recipe["launches"], xl_recipe["launches"], replay["launches"]

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
             + fleet["launches"]["rms_norm_fwd"]
             + leg["rms_norm_fwd"] + warm["launches"]["rms_norm_fwd"]
             + cold["launches"]["rms_norm_fwd"] + mixed["rms_norm_fwd"]
             + specl["rms_norm_fwd"] + glaunch + plaunch["rms_norm_fwd"]
             + train["launches"]["rms_norm_fwd"] + mg["rms_norm_fwd"]
             + rl["rms_norm_fwd"] + pl["rms_norm_fwd"]
             + hosts["launches"]["rms_norm_fwd"] + el["rms_norm_fwd"]
             + fused7["launches"]["rms_norm_fwd"] + rml["rms_norm_fwd"]
             + hl["rms_norm_fwd"] + tp7["launches"]["rms_norm_fwd"]
             + el7["launches"]["rms_norm_fwd"] + p39["rms_norm_fwd"]
             + p40["launches"]["rms_norm_fwd"],
             max_abs_err=rb["max_abs_err"], ms=rb["ms"],
             plain_ms=rb["plain_ms"], bound_ms=rb["bound_ms"],
             bound_by=rb["bound_by"], library_ms=rb["library_ms"]),
        dict(name="ragged_paged_attention", route="cuda",
             source="paddle_tpu_torch/csrc/ragged_paged_attention.cu",
             replaces="paddle_tpu/ops/paged_attention.py:215",
             launches=serve["launches"]["ragged_paged_attention"]
             + sched["launches"]["ragged_paged_attention"]
             + fleet["launches"]["ragged_paged_attention"]
             + warm["launches"]["ragged_paged_attention"]
             + cold["launches"]["ragged_paged_attention"]
             + mixed["ragged_paged_attention"]
             + specl["ragged_paged_attention"]
             + pl["ragged_paged_attention"]
             + hosts["launches"]["ragged_paged_attention"]
             + fused7["launches"]["ragged_paged_attention"]
             + tp7["launches"]["ragged_paged_attention"]
             + el7["launches"]["ragged_paged_attention"]
             + p39["ragged_paged_attention"]
             + p40["launches"]["ragged_paged_attention"],
             max_abs_err=ab["max_abs_err"], ms=ab["ms"],
             plain_ms=ab["plain_ms"], bound_ms=ab["bound_ms"],
             bound_by=ab["bound_by"], library_ms=ab["library_ms"]),
        # numbers at the 7B MHA decode batch; the error the largest over
        # every case of phase 4
        _kernel_entry("paged_decode_attention", "cuda",
                      "paddle_tpu_torch/csrc/paged_decode_attention.cu",
                      "paddle_tpu/ops/paged_attention.py:650",
                      leg["paged_decode_attention"]
                      + plaunch["paged_decode_attention"]
                      + rl["paged_decode_attention"]
                      + p39["paged_decode_attention"],
                      dict(decode["nkv32_d128_bf16"], max_abs_err=max(
                          r["max_abs_err"] for k, r in decode.items()
                          if k != "resources"))),
        _kernel_entry("rms_norm_bwd", "triton",
                      "paddle_tpu_torch/ops/rms_norm.py",
                      "paddle_tpu/ops/rms_norm.py:55",
                      train["launches"]["rms_norm_bwd"] + mg["rms_norm_bwd"]
                      + el["rms_norm_bwd"] + rml["rms_norm_bwd"]
                      + hl["rms_norm_bwd"],
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
            + mg[name] + leg.get(name, 0) + plaunch.get(name, 0)
            + gl[name] + rl.get(name, 0) + xr[name] + xs[name] + el[name]
            + ml[name] + mt["greedy"]["launches"][name] + rml[name]
            + hl[name] + d3[name] + p39[name], r))
    for name, key, line in (("layer_norm_fwd", "fwd", 45),
                            ("layer_norm_bwd", "bwd", 54)):
        kernels.append(_kernel_entry(
            name, "triton", "paddle_tpu_torch/ops/layer_norm_fused.py",
            f"paddle_tpu/ops/layer_norm_fused.py:{line}",
            bert["launches"][name] + gl[name] + xr[name] + xs[name]
            + ml[name] + mt["greedy"]["launches"][name]
            + jmt["compiled"]["layer_norm_launches"][key == "bwd"]
            + (jpred["layer_norm_launches"] if key == "fwd" else 0)
            + rcl[name] + d3[name] + p39[name],
            lnr[key]["bf16"]))
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
