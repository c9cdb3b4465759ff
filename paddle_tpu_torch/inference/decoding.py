"""Generation and serving engines — counterpart of
``paddle_tpu/inference/decoding.py``.

``GenerationEngine`` (``llama_engine`` wires it to the Llama family)
generates a batch of prompts of one length over a contiguous KV cache:
one program per ``(bucket, max_new, batch)`` holding the prefill and the
whole decode loop. ``PagedGenerationEngine`` generates a ragged batch
over the paged cache, one program per ``(t_bucket, max_new, batch,
table width)``.

``ContinuousBatchingEngine`` keeps ``num_slots`` sequences decoding
together over the paged KV cache. Two pipelines, which emit identical
greedy tokens (in fp32; the two sum attention in different orders):

* unified (default): each ``step()`` is one round of ``chunk``
  micro-rounds of ``models.llama.ragged_step`` — prefill chunks of newly
  admitted prompts and every decoding row ride the same packed token
  axis, so a prompt submitted mid-decode joins the current step;
* legacy (``unified=False``), kept for A/B runs as the JAX package keeps
  it: admissions run as bucketed prefill waves (``models.llama.
  prefill_paged``, or ``prefill_paged_suffix`` for prefix-cache hits),
  then every slot decodes ``chunk`` steps of ``models.llama.
  decode_step_paged`` over the paged decode kernel.

The token carry stays on the device between rounds, and a step's
emitted tokens are its ONE device→host copy.

Decoding options (the JAX engine's, with its token streams):

* ``GenerationConfig(do_sample=True)``: the legacy programs and
  ``PagedGenerationEngine`` draw with the engine-wide temperature /
  top-k / top-p from the JAX engines' key chain (``jax.random.split``
  of ``key(seed)``, reproduced by ``inference.prng``); the unified
  engine turns it into a per-request sampler;
* ``submit(sampler=SamplerConfig(...))``: per-request sampling on the
  unified step, keyed by (seed, position) (``inference.sampling``);
* ``submit(grammar=TokenDFA, grammar_prefix=...)``: grammar-constrained
  decoding over one device arena of transition tables
  (``inference.constrain``, ``grammar_states=`` at construction);
* ``speculative=True``: each decoding row's round is ``[carry] + up to
  spec_k`` drafted tokens (``inference.speculative``), verified by one
  ragged step with logits at every candidate, with lossless rejection
  sampling for sampled rows and the paged pool rolled back per row on
  rejection (``mgr.truncate_pages``). Its greedy streams equal a plain
  engine's bit for bit when both pack one token axis (``step_tokens >=
  num_slots·(spec_k+1)``): the attention kernels route each token alike
  in both steps, but the projections' GEMMs may round a row differently
  at another row count, so the engine warns when the axes differ.
* ``submit(..., decoded=n)``: the last ``n`` prompt tokens were generated
  elsewhere (a failover or handoff continuation). The unified and
  speculative steps flag them ``decoding`` as the carry tokens they
  were, so each takes the attention kernels' route it took when it was
  decoded, and the continuation's bits are the uninterrupted stream's.
  The legacy pipeline prefills only the given prompt and feeds the
  streamed tokens through its decode chunk as forced tokens, one a step
  as they were decoded (paged decode attention, not the prefill's flash
  forward); forced steps deliver nothing.

The sampling epilogue is built lazily: until the first sampled or
constrained request the programs end in the argmax; that request
rebuilds them once with the full epilogue (a counted miss), and it stays
on.

Each pipeline runs its steps as the JAX engine's compiled programs, one
per fixed shape (``inference.graphs.Program``): the unified step
(``cbe.unified_step``), the speculative step (``cbe.spec_step``), the
legacy decode chunk (``cbe.decode_chunk``) and the legacy prefill waves
(``cbe.prefill``, one per ``(bucket, b_pad)`` or ``("sfx", bucket,
b_pad)``), keyed as the JAX engine keys them. On the card each is a CUDA
graph captured at its first use and replayed after; on the CPU its body
runs eagerly over the same buffers. Every build is a counted miss
(``compile_misses``), as ``recompiles.record_miss`` counts the JAX
engine's.

``prefix_cache=True`` (both pipelines) shares the resident pages of
earlier prompts through ``paddle_tpu_torch.kvcache`` and prefills only
each request's uncached suffix; the page books are audited after every
step.

Serving hooks and telemetry (the JAX engine's): ``token_callback(rid,
token)`` fires for every kept token as a step unpacks, and
``finish_callback(rid, tokens)`` at retirement (the serving scheduler,
``paddle_tpu_torch.serving``, routes both into its token streams);
``submit(trace_id=)`` tags a request's spans and events. When
``profiler.record.spans_armed()``, each step emits ``engine.prefill`` /
``engine.decode_chunk`` spans (coalesced per slot window) and the
speculative step ``engine.spec_draft`` / ``engine.spec_round``; every
span closes after the step's device->host copy, so it covers the
device work, and none is inside a captured program. Program builds are
counted in ``observability.runtime.recompiles`` under the names and
keys of ``compile_misses``; the sampling, speculation and cache counts
feed the process registry's ``paddle_sampling_*``, ``paddle_spec_*``
and ``paddle_kvcache_*`` families beside their plain mirrors
(``sampling_counts``, ``spec.stats``, ``cache.stats``); with the memory
ledger armed (``observability.memory``) each step feeds it the pool's
byte split, read off host metadata only.

Not in this slice (each raises ``NotImplementedError``): the fused
decode tail and multi-chip meshes.
"""

from __future__ import annotations

import functools
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kvcache import PrefixCache, RefcountedKVCacheManager
from ..models import llama as L
from ..observability.events import emit_event
from ..observability.journal import token_checksum
from ..observability.memory import memory_armed, memory_ledger
from ..observability.profiling import chain_armed as _chain_armed
from ..observability.profiling import note_chain as _note_chain
from ..observability.runtime import recompiles
from ..ops._common import not_ported as _later, resolve_device
from ..ops.paged_attention import PagedKVCacheManager
from ..profiler.record import emit_span, emit_spans, make_span, spans_armed
from . import constrain as _constrain
from . import prng
from . import sampling as _sampling
from .graphs import GraphPool, Program, params_key
from .sampling import SamplerConfig
from .speculative import NgramDrafter, SpeculationTelemetry


@dataclass
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 1.0
    top_k: int = 0            # 0 = off
    top_p: float = 1.0        # 1.0 = off
    do_sample: bool = False   # False = greedy
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    seed: int = 0


def _bucket(n: int, minimum: int = 16) -> int:
    """Prompt-length bucket of the legacy prefill: the next power of two
    from ``minimum`` up."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _sample(logits, key, cfg: GenerationConfig):
    """The engine-wide epilogue of the legacy programs and
    ``PagedGenerationEngine`` (the JAX package's ``_sample``): greedy
    argmax, or temperature -> top-k -> top-p and one categorical draw
    over the whole (B, V) batch with the single key ``key``."""
    logits = logits.float()
    if not cfg.do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    # a tensor divisor: a true division, never the reciprocal product
    # CUDA takes for a host scalar
    logits = logits / torch.full_like(logits[..., :1],
                                      max(cfg.temperature, 1e-6))
    if cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -cfg.top_k][..., None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if cfg.top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(_sampling._softmax(sorted_l), dim=-1)
        # keep the smallest set with cumulative prob >= top_p
        cutoff_idx = (cum < cfg.top_p).sum(dim=-1, keepdim=True)
        cutoff = sorted_l.gather(-1, cutoff_idx.clamp(
            max=logits.shape[-1] - 1))
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return prng.categorical(key, logits).to(torch.int32)


def _split(key):
    """``key, sub = jax.random.split(key)``."""
    ks = prng.split(key)
    return ks[0], ks[1]


def _last_logits(logits, seq_len):
    """(B, T, V) prefill logits -> (B, V) at each row's last real token."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, seq_len.long() - 1]


class _Programs:
    """The compiled programs of one engine (``inference.graphs``) and
    their books: each build is a counted miss ``(name, key)``, kept in
    ``compile_misses`` and passed to ``recompiles.record_miss`` as the
    JAX engines pass theirs; a program is rebuilt
    for params that are not the tensors it was built over (a CUDA graph
    reads its weights at the addresses it captured). Card runs capture
    CUDA graphs; ``_graphs = False`` (private) runs every program's body
    eagerly, the eager card run the tests compare against."""

    def _init_programs(self, device: torch.device) -> None:
        self.device = device
        #: program builds, in order: (name, key)
        self.compile_misses: List[Tuple[str, tuple]] = []
        #: seconds of each program's first call (eager run and capture,
        #: to completion), summed by name (``recompiles.observe_compile``)
        self.compile_seconds: Dict[str, float] = {}
        #: of those, the CUDA graph captures alone
        self.capture_seconds: Dict[str, float] = {}
        #: bytes the captures reserved in the engine's graph pool, by name
        self.graph_pool_bytes: Dict[str, int] = {}
        self._graphs = True
        self._graph_pool: Optional[GraphPool] = None

    def _program(self, body: Callable[..., torch.Tensor], inputs: dict,
                 params) -> Program:
        graphs = None
        if self.device.type == "cuda" and self._graphs:
            if self._graph_pool is None:
                self._graph_pool = GraphPool(self.device)
            graphs = self._graph_pool
        return Program(body, inputs, self.device, graphs, params_key(params))

    def _fetch(self, prog: Optional[Program], name: str, key: tuple,
               build: Callable[..., Program], params) -> Program:
        """``prog`` if it was built over ``params``, else a new build:
        one counted miss ``(name, key)``."""
        if prog is not None and prog.params_id == params_key(params):
            return prog
        self.compile_misses.append((name, key))
        recompiles.record_miss(name, key)
        return build(params)

    def _run(self, name: str, prog: Program) -> torch.Tensor:
        """Call ``prog``; its first call is timed to completion into
        ``compile_seconds`` (and ``recompiles.observe_compile``) and
        ``capture_seconds``, and its capture's memory booked in
        ``graph_pool_bytes``."""
        if prog.calls:
            return prog()
        t0 = time.perf_counter()
        out = prog()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        recompiles.observe_compile(name, seconds)
        for book, n in ((self.compile_seconds, seconds),
                        (self.capture_seconds, prog.capture_seconds),
                        (self.graph_pool_bytes, prog.pool_bytes)):
            book[name] = book.get(name, 0) + n
        return out


def _leaves(tree) -> list:
    """The tensors of a cache pytree (dicts by sorted key, as
    ``jax.tree_util.tree_leaves`` orders them)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [] if tree is None else [tree]


class KVCache:
    """Thin named wrapper over a model's cache pytree (the reference's
    CacheKV tensors)."""

    def __init__(self, tree):
        self.tree = tree

    @property
    def seq_capacity(self) -> int:
        leaves = _leaves(self.tree)
        return leaves[0].shape[2] if leaves else 0


class GenerationEngine(_Programs):
    """Compiled generation over a model's (prefill, decode_step,
    init_cache) triple, for a batch of prompts of ONE length over a
    contiguous cache:

    ``prefill(params, ids, cache) -> (logits (B, T, V), cache)``
    ``decode_step(params, tok, pos, cache) -> (logits (B, V), cache)``
    ``init_cache(batch, max_len) -> cache pytree (or a KVCache)``

    ``generate`` pads the prompts to their length's bucket and runs ONE
    program per ``(bucket, max_new, batch)`` (the JAX engine's jitted
    ``lax.scan``; miss name ``generation_engine.run``): the prefill,
    then ``max_new - 1`` decode steps, unrolled. ``pos`` is a 0-d device
    tensor, so on the card the whole program is one CUDA graph that
    replays at any prompt length of the bucket (written into the
    program's ``prompt_len`` input before each call). On the card the
    cache is the program's own buffer, zeroed inside the graph as
    ``init_cache`` gives zeros, and the engine holds one key's graph and
    cache at a time: a new key drops the last (so a return to an earlier
    key is a new build, a miss the JAX engine's jit cache would not
    count). On the CPU every call gets a new cache and every key's
    program stays, as the JAX engine keeps its jits. Greedy argmax, or
    with ``do_sample`` the JAX engine's draws: ``key(seed)``, one split
    for the prefill's token, then one a step. ``device=None`` means the
    card."""

    def __init__(self, prefill: Callable, decode_step: Callable,
                 init_cache: Callable,
                 config: Optional[GenerationConfig] = None, *,
                 device=None):
        self._prefill = prefill
        self._decode = decode_step
        self._init_cache = init_cache
        self.config = config or GenerationConfig()
        self._compiled: Dict[tuple, Program] = {}
        self._init_programs(resolve_device(device))

    def _new_cache(self, b: int, max_len: int):
        cache = self._init_cache(b, max_len)
        return cache.tree if isinstance(cache, KVCache) else cache

    def _build(self, bucket: int, max_new: int, b: int, params) -> Program:
        cfg, prefill, decode = self.config, self._prefill, self._decode
        # the card: one buffer the graph reads and zeroes; the CPU: none
        static = (self._new_cache(b, bucket + max_new)
                  if self.device.type == "cuda" else None)
        inputs = dict(ids=((b, bucket), torch.int32),
                      prompt_len=((1,), torch.int32))
        if cfg.do_sample:
            inputs["key"] = ((2,), torch.int64)

        def run(ids, prompt_len, key=None):
            if static is None:
                cache = self._new_cache(b, bucket + max_new)
            else:
                cache = static
                for leaf in _leaves(cache):
                    leaf.zero_()
            logits, _ = prefill(params, ids, cache)          # (B, T, V)
            last = logits.index_select(1, prompt_len.long() - 1)[:, 0]
            sub = None
            if key is not None:
                key, sub = _split(key)
            tok = _sample(last, sub, cfg)
            toks = []
            for i in range(max_new - 1):
                lg, _ = decode(params, tok, prompt_len[0] + i, cache)
                toks.append(tok)
                if key is not None:
                    key, sub = _split(key)
                tok = _sample(lg, sub, cfg)
            toks.append(tok)
            return torch.stack(toks, dim=1)                 # (B, max_new)

        return self._program(run, inputs, params)

    @torch.no_grad()
    def generate(self, params, input_ids,
                 generation_config: Optional[GenerationConfig] = None
                 ) -> np.ndarray:
        """input_ids: (B, T) int array -> (B, max_new_tokens) int32.
        ``generation_config`` replaces the engine's and drops its
        programs."""
        if generation_config is not None:
            self.config = generation_config
            self._compiled.clear()
        cfg = self.config
        ids = np.asarray(input_ids)
        b, t = ids.shape
        bucket = _bucket(t)
        key = (bucket, cfg.max_new_tokens, b)
        prog = self._compiled.get(key)
        if prog is None and self.device.type == "cuda":
            self._compiled.clear()     # one key's graph and cache a time
        self._compiled[key] = prog = self._fetch(
            prog, "generation_engine.run", key,
            lambda p: self._build(bucket, cfg.max_new_tokens, b, p), params)
        # right-padding is safe: the pads' cache slots lie past kv_len
        # until decode overwrites each before first attending to it
        prog.host["ids"].fill(cfg.pad_token_id)
        prog.host["ids"][:, :t] = ids
        prog.host["prompt_len"][0] = t
        if cfg.do_sample:
            prog.host["key"][:] = prng.prng_key(cfg.seed).numpy()
        return self._run("generation_engine.run", prog).cpu().numpy()


def llama_engine(config: L.LlamaConfig,
                 generation_config: Optional[GenerationConfig] = None,
                 *, device=None) -> GenerationEngine:
    """``GenerationEngine`` over the stacked-param Llama family
    (``models.llama.prefill_stacked``, ``decode_step_stacked``,
    ``init_kv_cache``)."""
    dev = resolve_device(device)
    return GenerationEngine(
        prefill=functools.partial(L.prefill_stacked, config=config),
        decode_step=functools.partial(L.decode_step_stacked, config=config),
        init_cache=functools.partial(L.init_kv_cache, config, device=dev),
        config=generation_config, device=dev)


class PagedGenerationEngine(_Programs):
    """Ragged-batch generation over the paged KV cache: prompts of
    different lengths each own pages through a block table, decode
    positions advance per row, and generation starts from each row's own
    last prompt token. ``generate`` runs one prefill, then
    ``max_new_tokens - 1`` decode steps; with ``do_sample`` each draws
    with the next key of the JAX engine's chain from ``key(seed)``.

    One program per ``(t_bucket, max_new, batch, table width)`` (miss
    name ``paged_engine.run``): on the card one CUDA graph of the
    prefill and the whole decode loop, with the prompts, ``seq_lens``
    and the block tables as its inputs, over a pool (sized for the key's
    widest tables, or ``num_pages``) kept across the key's calls, with
    the page books new each call; the engine holds one key's graph and
    pool at a time (a new key drops the last, as
    :class:`GenerationEngine` does). The CPU runs the program eagerly
    over a new pool each call, and keeps every key's program."""

    def __init__(self, model_config: L.LlamaConfig,
                 generation_config: Optional[GenerationConfig] = None,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 *, device=None):
        self.model_config = model_config
        self.config = generation_config or GenerationConfig()
        self.page_size = page_size
        self._num_pages = num_pages
        self._compiled: Dict[tuple, Program] = {}
        #: the pool the programs run over: the current key's on the card,
        #: the call's on the CPU
        self._mgr: Optional[PagedKVCacheManager] = None
        self._init_programs(resolve_device(device))

    def _build(self, b: int, t_bucket: int, width: int,
               params) -> Program:
        cfg, mcfg, max_new = (self.config, self.model_config,
                              self.config.max_new_tokens)
        i32 = torch.int32
        inputs = dict(ids=((b, t_bucket), i32), seq_lens=((b,), i32),
                      bt=((b, width), i32))
        if cfg.do_sample:
            inputs["key"] = ((2,), torch.int64)

        def run(ids, seq_lens, bt, key=None):
            mgr = self._mgr
            logits, _, _ = L.prefill_paged(params, ids, seq_lens,
                                           mgr.k_pages, mgr.v_pages, bt,
                                           mcfg)
            sub = None
            if key is not None:
                key, sub = _split(key)
            tok = _sample(_last_logits(logits, seq_lens), sub, cfg)
            toks = []
            for i in range(max_new - 1):
                lg, _, _ = L.decode_step_paged(params, tok, seq_lens + i,
                                               mgr.k_pages, mgr.v_pages, bt,
                                               mcfg)
                toks.append(tok)
                if key is not None:
                    key, sub = _split(key)
                tok = _sample(lg, sub, cfg)
            toks.append(tok)
            return torch.stack(toks, dim=1)

        return self._program(run, inputs, params)

    @torch.no_grad()
    def generate(self, params, prompts) -> np.ndarray:
        """prompts: list of 1-D int arrays (ragged) -> (B, max_new_tokens)
        int32 tokens."""
        cfg, mcfg, page = self.config, self.model_config, self.page_size
        lens = [len(p) for p in prompts]
        b = len(prompts)
        t_bucket = _bucket(max(lens))
        total = [n + cfg.max_new_tokens for n in lens]
        width = max(PagedKVCacheManager.pages_needed(n, page)
                    for n in total)
        key = (t_bucket, cfg.max_new_tokens, b, width)
        prog = self._compiled.get(key)
        if prog is None or self.device.type != "cuda":
            if self.device.type == "cuda":
                self._compiled.clear()     # their graphs read the old pool
            self._mgr = PagedKVCacheManager(
                mcfg.num_hidden_layers, self._num_pages or b * width + 1,
                page, mcfg.num_key_value_heads, mcfg.head_dim,
                dtype=mcfg.dtype, device=self.device)
        mgr = self._mgr
        self._compiled[key] = prog = self._fetch(
            prog, "paged_engine.run", key,
            lambda p: self._build(b, t_bucket, width, p), params)
        held = []
        try:
            for i in range(b):
                mgr.allocate(i, total[i])
                held.append(i)
                mgr._lens[i] = lens[i]   # the prompt is the live length
            bt, seq_lens = mgr.block_tables(held)
            host = prog.host
            host["ids"].fill(cfg.pad_token_id)
            for i, p in enumerate(prompts):
                host["ids"][i, :len(p)] = np.asarray(p, np.int32)
            host["seq_lens"][:] = seq_lens
            host["bt"][:] = bt
            if cfg.do_sample:
                host["key"][:] = prng.prng_key(cfg.seed).numpy()
            return self._run("paged_engine.run", prog).cpu().numpy()
        finally:
            for i in held:
                mgr.free(i)


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    tokens: list = field(default_factory=list)
    max_new_tokens: Optional[int] = None  # None -> engine config default
    trace_id: str = ""                    # serving-layer trace correlation
    sampler: Optional[SamplerConfig] = None   # None -> greedy row
    grammar: Optional[_constrain.TokenDFA] = None  # None -> unconstrained
    gstart: int = -1                      # arena GLOBAL start state
    gstate_host: int = -1                 # host DFA mirror (LOCAL ids)
    decoded: int = 0                      # trailing prompt tokens that
    #                                     # were generated, not given


class ContinuousBatchingEngine(_Programs):
    """Fixed-slot continuous batching over the paged KV cache (module
    docstring for the pipelines and the decoding options).

    Service API: ``submit(prompt, max_new_tokens=, trace_id=, sampler=,
    grammar=, grammar_prefix=) -> rid``; ``step(params)`` runs one admit
    + ``chunk`` rounds (or one speculative round); ``collect()`` drains
    finished requests; ``cancel(rid)``; ``serve(params, prompts)``
    streams a whole list through. The serving layer's hooks:
    ``token_callback``, ``finish_callback``, ``num_free_slots``,
    ``num_queued``, ``num_chips`` (1) and ``mesh`` (None).
    The parameters are the reference's, in its order; ``mesh`` other
    than None (multi-chip serving) raises. ``fused_tail=True`` (or
    :meth:`enable_fused_tail`, the fusion pass's ``decode_tail`` region)
    feeds the unified and speculative programs from a packed plan: two
    uploads a step instead of one per plan array, and a vectorized plan
    for steady all-decode rounds; the emitted tokens are byte-identical.
    ``device`` is the port's, keyword-only: ``None`` means the card
    (raises without one); the CPU runs only when asked for with
    ``device="cpu"``.

    Compiled programs (module docstring): the JAX engine's jit takes the
    params as an argument and never rebuilds for new weights; a CUDA
    graph reads its weights at the addresses it captured, so here a
    program is rebuilt (a counted miss) when ``step()`` is given params
    that are not the tensors it was built over. The sampler rows, the
    grammar states and the grammar arena are engine tensors the programs
    read in place: admission writes them on the current stream before
    the next replay.
    """

    def __init__(self, model_config: L.LlamaConfig,
                 generation_config: Optional[GenerationConfig] = None,
                 num_slots: int = 8, page_size: int = 16,
                 max_seq_len: int = 2048, num_pages: Optional[int] = None,
                 chunk: int = 16, prefix_cache: bool = False,
                 check_invariants: bool = True, unified: bool = True,
                 step_tokens: Optional[int] = None,
                 speculative: bool = False, spec_k: int = 4,
                 drafter=None, fused_tail: bool = False,
                 mesh=None, mp_axis: str = "mp",
                 grammar_states: int = 0, *, device=None):
        if fused_tail and not unified:
            raise ValueError(
                "fused_tail packs the unified ragged step's plan; "
                "construct with unified=True")
        if mesh is not None:
            raise _later("mesh= (multi-chip serving)", "multi-chip")
        if speculative and not unified:
            raise ValueError(
                "speculative decoding rides the unified ragged step; "
                "construct with unified=True")
        self.config = generation_config or GenerationConfig()
        self._init_programs(resolve_device(device))
        self.model_config = model_config
        self.num_slots = num_slots
        self.page_size = page_size
        self.chunk = chunk
        self.max_seq_len = max_seq_len
        self._unified = unified
        self._fused_tail = bool(fused_tail)
        self._table_width = PagedKVCacheManager.pages_needed(max_seq_len,
                                                             page_size)
        # pool sized for every slot at max length unless told otherwise
        pool = num_pages or (num_slots * self._table_width + 1)
        mcfg = model_config
        geo = (mcfg.num_hidden_layers, pool, page_size,
               mcfg.num_key_value_heads, mcfg.head_dim)
        self.cache = None
        if prefix_cache:
            # shared-ownership pool + radix prefix index: retired prompts
            # stay resident and later requests prefill only their suffix
            self.mgr = RefcountedKVCacheManager(*geo, dtype=mcfg.dtype,
                                                device=self.device)
            self.cache = PrefixCache(self.mgr)
        else:
            self.mgr = PagedKVCacheManager(*geo, dtype=mcfg.dtype,
                                           device=self.device)
        # the page books are audited after every step that can move them:
        # with the cache, and with speculation (growth and rollback). The
        # audit is O(pool) host work a step; ``check_invariants=False``
        # opts out, as in the reference (l.453)
        self._check_invariants = check_invariants and (prefix_cache
                                                       or speculative)
        # packed token budget per micro-round (unified pipeline)
        self._step_tokens = max(step_tokens or
                                max(num_slots, chunk, page_size), num_slots)
        # host slot state
        self._slot_rid: List[Optional[int]] = [None] * num_slots
        self._queue: list = []                    # pending _Request
        self._live: Dict[int, _Request] = {}      # rid -> request (slotted)
        self._finished: Dict[int, list] = {}
        self._finished_crc: Dict[int, int] = {}   # rid -> crc32 of output
        self._next_rid = 0
        # the slot token carry stays ON DEVICE; positions and block
        # tables are host-mirrored and uploaded once per step
        self._tok_dev = torch.zeros((num_slots,), dtype=torch.int32,
                                    device=self.device)
        self._pos = np.zeros((num_slots,), np.int32)
        self._bt = np.zeros((num_slots, self._table_width), np.int32)
        self._pend: List[Optional[np.ndarray]] = [None] * num_slots
        # first prompt position of each slot that was decoded elsewhere
        # (``submit(decoded=)``): its prefill flags ``decoding`` from it
        self._dec_from = np.zeros((num_slots,), np.int64)
        # legacy: each slot's streamed tokens still to force through the
        # decode chunk (``submit(decoded=)``), None when there are none
        self._forced: List[Optional[np.ndarray]] = [None] * num_slots
        # the legacy programs' engine-wide key chain (``jax.random.key(
        # seed)``, split on the host per prefill wave and decode chunk)
        self._rng = prng.prng_key(self.config.seed)
        # per-row sampling state (inference/sampling.py): (seeds, temps,
        # top_k, top_p), written in place at admission; greedy defaults
        self._samp_dev = _sampling.init_row_state(num_slots, device=self.device)
        # per-row grammar DFA state; -1 = unconstrained (mask is a no-op)
        self._gstate_dev = torch.full((num_slots,), -1, dtype=torch.int32,
                                      device=self.device)
        # the grammar arena has its one fixed shape from construction:
        # the programs read it by address. grammar_states=0 keeps a
        # 1-row placeholder (a constrained submit raises with the hint)
        self._arena = _constrain.GrammarArena(
            mcfg.vocab_size, capacity_states=max(1, int(grammar_states)),
            device=self.device)
        # lazy epilogue: argmax-only programs until the first sampled or
        # constrained submit, which rebuilds them once (sticky)
        self._epilogue_on = False
        #: the JAX package's sampling registry families, as plain counts
        self.sampling_counts = {
            "paddle_sampling_requests_total": {"sampled": 0,
                                               "constrained": 0},
            "paddle_sampling_tokens_total": {"sampled": 0,
                                             "constrained": 0},
            "paddle_sampling_violations_total": 0,
            "paddle_sampling_grammar_states": 0}
        # speculative decoding (inference/speculative.py)
        self._speculative = bool(speculative)
        self.spec_k = int(spec_k)
        self.spec: Optional[SpeculationTelemetry] = None
        self.drafter = drafter
        self._spec_step: Optional[Program] = None
        if speculative:
            self.drafter = drafter or NgramDrafter()
            self.spec = SpeculationTelemetry()
            # packed axis: every slot may speculate (1 carry + spec_k
            # drafts) in the same round; prefill shares what is left
            self._spec_tokens = max(self._step_tokens,
                                    num_slots * (self.spec_k + 1))
            if self._spec_tokens != self._step_tokens:
                warnings.warn(
                    f"the speculative step packs {self._spec_tokens} "
                    f"tokens (num_slots·(spec_k+1)) and the plain step "
                    f"{self._step_tokens}: greedy streams are not bound "
                    f"to equal a plain engine's bit for bit (a GEMM may "
                    f"round a row differently at another row count); pass "
                    f"step_tokens >= {self._spec_tokens} to both engines "
                    f"for that", stacklevel=2)
            # admission's page reservation per slot: rollback never
            # truncates below it
            self._reserved = np.zeros((num_slots,), np.int64)
        #: prompt tokens actually run through prefill (cache hits skip
        #: their cached prefix)
        self._prefill_tokens = 0
        #: unified micro-rounds dispatched (each runs every kernel of the
        #: ragged step)
        self.micro_rounds = 0
        #: speculative rounds dispatched (one ragged step each)
        self.spec_rounds = 0
        #: legacy prefill waves and decode steps run
        self.prefill_calls = 0
        self.decode_steps = 0
        # compiled programs, cached as the JAX engine caches its jits
        self._unified_step: Optional[Program] = None
        self._decode_chunk: Optional[Program] = None
        self._compiled_prefill: Dict[tuple, Program] = {}
        # per-slot coalesced span window [kind, t0_ns, t1_ns, units] of
        # an armed unified step: spans materialise at a phase change or
        # at retirement, not every step
        self._win: List[Optional[list]] = [None] * num_slots
        # memory ledger feed decimation (engines without per-step audits)
        self._mem_tick = 0
        # serving-layer hooks (paddle_tpu_torch.serving), None by default:
        # token_callback(rid, token) fires for every KEPT token as step()
        # unpacks; finish_callback(rid, tokens) fires at _retire
        self.token_callback: Optional[Callable[[int, int], None]] = None
        self.finish_callback: Optional[Callable[[int, list], None]] = None

    # -- compiled programs --------------------------------------------------

    def _next_key(self) -> np.ndarray:
        """``self._rng, sub = jax.random.split(self._rng)``: the key of
        the next legacy program call."""
        self._rng, sub = _split(self._rng)
        return sub.numpy()

    def enable_fused_tail(self) -> "ContinuousBatchingEngine":
        """Install the fusion pass's decode-tail region (idempotent).
        Enabled before the first step it adds no build; enabled
        mid-serve it drops the unified and speculative programs, and the
        next step rebuilds them — one counted miss, like a flag flip."""
        if not self._unified:
            raise ValueError(
                "fused_tail packs the unified ragged step's plan; "
                "construct with unified=True")
        if not self._fused_tail:
            self._fused_tail = True
            self._unified_step = None
            self._spec_step = None
        return self

    def _unified_inputs(self) -> dict:
        K, tb, n_rows = self.chunk, self._step_tokens, self.num_slots
        i32, b8 = torch.int32, torch.bool
        return dict(ids=((K, tb), i32), use_carry=((K, tb), b8),
                    decoding=((K, tb), b8),
                    token_row=((K, tb), i32), positions=((K, tb), i32),
                    kv_lens=((K, n_rows), i32), last_idx=((K, n_rows), i32),
                    sample_mask=((K, n_rows), b8))

    def _build_unified_step(self, params) -> Program:
        """ONE program for every unified step: ``chunk`` micro-rounds of
        ``models.llama.ragged_step`` (the JAX engine's one ``lax.scan``).
        Decode slots take their row's carry token, prefill slots the
        host-fed prompt tokens; ``decoding`` flags the carry tokens and
        the prompt tokens that were decoded elsewhere (the attention
        kernels' route of a token decoded alone, ``ragged_step(
        decoding=)``); each round emits its INPUT carry, then
        updates the carry (and grammar state) of the rows that sampled.
        With the epilogue on, the grammar mask rides the model's logits
        hook and ``sampling.sample_rows`` draws each row's token keyed
        by the position it will occupy (this round's ``kv_lens``);
        before, the tail is the argmax. Shapes depend only on (slots,
        chunk, step_tokens, table width). Returns the (K, R) emitted
        tokens; the carry ``_tok_dev`` and ``_gstate_dev`` are updated
        in place."""
        K, tb, n_rows = self.chunk, self._step_tokens, self.num_slots
        mgr, mcfg, carry = self.mgr, self.model_config, self._tok_dev
        gcarry, samp, gtable = (self._gstate_dev, self._samp_dev,
                                self._arena.table)
        epilogue = self._epilogue_on
        tail = _sampling.sample_rows if epilogue else _sampling.greedy_rows
        i32 = torch.int32
        inputs = self._unified_inputs()
        inputs["bt"] = ((n_rows, self._table_width), i32)

        def run(ids, use_carry, decoding, token_row, positions, kv_lens,
                last_idx, sample_mask, bt):
            tok, gst = carry, gcarry
            emitted = []
            for k in range(K):
                row_c = token_row[k].long().clamp(0, n_rows - 1)
                ids_eff = torch.where(use_carry[k], tok[row_c], ids[k])
                hook = ((lambda lg, g=gst: _constrain.mask_logits(
                    lg.float(), g, gtable)) if epilogue else None)
                # the attention route follows the token: decoded tokens
                # (the carry's, a continuation's) take a lone token's
                logits, _, _ = L.ragged_step(
                    params, ids_eff, token_row[k], positions[k], kv_lens[k],
                    last_idx[k], mgr.k_pages, mgr.v_pages, bt, mcfg,
                    logits_epilogue=hook, decoding=decoding[k])
                nxt, ngst = tail(logits, kv_lens[k], samp, gst, gtable)
                emitted.append(tok)
                tok = torch.where(sample_mask[k], nxt, tok)
                if epilogue:
                    gst = torch.where(sample_mask[k], ngst, gst)
            out = torch.stack(emitted)
            carry.copy_(tok)
            if epilogue:
                gcarry.copy_(gst)
            return out

        if self._fused_tail:
            # the decode-tail twin: the same ops over the packed plan
            from ..jit.fusion import build_fused_unified_step

            def model_step(ids_eff, token_row, positions, kv_lens,
                           last_idx, bt, gst, decoding):
                hook = ((lambda lg, g=gst: _constrain.mask_logits(
                    lg.float(), g, gtable)) if epilogue else None)
                return L.ragged_step(
                    params, ids_eff, token_row, positions, kv_lens,
                    last_idx, mgr.k_pages, mgr.v_pages, bt, mcfg,
                    logits_epilogue=hook, decoding=decoding)[0]

            fused = build_fused_unified_step(
                model_step,
                lambda logits, kv_lens, gst: tail(logits, kv_lens, samp,
                                                  gst, gtable),
                n_rows, epilogue=epilogue)
            packed = dict(plan_tt=((5, K, tb), i32),
                          plan_tr=((3, K, n_rows), i32), bt=inputs["bt"])
            return self._program(
                lambda plan_tt, plan_tr, bt: fused(plan_tt, plan_tr, bt,
                                                   carry, gcarry),
                packed, params)
        return self._program(run, inputs, params)

    def _key_input(self, inputs: dict) -> dict:
        """The legacy programs' draw key, a (2,) input, with do_sample."""
        if self.config.do_sample:
            inputs["key"] = ((2,), torch.int64)
        return inputs

    def _build_prefill(self, bucket: int, b_pad: int, params) -> Program:
        """A legacy prefill wave of ``b_pad`` rows padded to ``bucket``
        tokens (``models.llama.prefill_paged``). Returns each row's first
        token (``_sample`` of its last logits)."""
        mgr, mcfg, i32, cfg = self.mgr, self.model_config, torch.int32, \
            self.config
        inputs = self._key_input(dict(
            ids=((b_pad, bucket), i32), lens=((b_pad,), i32),
            rows=((b_pad, self._table_width), i32)))

        def run(ids, lens, rows, key=None):
            logits, _, _ = L.prefill_paged(params, ids, lens, mgr.k_pages,
                                           mgr.v_pages, rows, mcfg)
            return _sample(_last_logits(logits, lens), key, cfg)

        return self._program(run, inputs, params)

    def _build_prefill_suffix(self, bucket: int, b_pad: int,
                              params) -> Program:
        """The prefill of prefix-cache hits' UNCACHED SUFFIX only
        (``models.llama.prefill_paged_suffix``): each row's leading
        ``starts`` tokens are already resident in shared pages."""
        mgr, mcfg, i32, cfg = self.mgr, self.model_config, torch.int32, \
            self.config
        inputs = self._key_input(dict(
            ids=((b_pad, bucket), i32), lens=((b_pad,), i32),
            starts=((b_pad,), i32),
            rows=((b_pad, self._table_width), i32)))

        def run(ids, lens, starts, rows, key=None):
            logits, _, _ = L.prefill_paged_suffix(
                params, ids, lens, starts, mgr.k_pages, mgr.v_pages, rows,
                mcfg)
            return _sample(_last_logits(logits, lens), key, cfg)

        return self._program(run, inputs, params)

    def _build_decode_chunk(self, params) -> Program:
        """``chunk`` decode steps over every slot (idle slots decode at
        position 0 into page 0; finished rows run to the chunk's end and
        their extra tokens are dropped). Each step emits its INPUT token,
        so a chunk's output chains to the next and delivers each
        admission's prefill token first; with do_sample each step splits
        the chunk's key for its draw, on the device. ``forced[s, k]``,
        where it is not -1, replaces row s's input token at step k (a
        continuation's streamed tokens, ``submit(decoded=)``). Returns
        (slots, chunk) tokens; the carry ``_tok_dev`` is updated in
        place."""
        K, n_rows, cfg = self.chunk, self.num_slots, self.config
        mgr, mcfg, carry = self.mgr, self.model_config, self._tok_dev
        inputs = self._key_input(dict(
            pos=((n_rows,), torch.int32),
            bt=((n_rows, self._table_width), torch.int32),
            forced=((n_rows, K), torch.int32)))

        def run(pos, bt, forced, key=None):
            tok = carry
            emitted = []
            for k in range(K):
                f = forced[:, k]
                tok = torch.where(f >= 0, f, tok)
                logits, _, _ = L.decode_step_paged(
                    params, tok, pos, mgr.k_pages, mgr.v_pages, bt, mcfg)
                emitted.append(tok)
                sub = None
                if key is not None:
                    key, sub = _split(key)
                tok = _sample(logits, sub, cfg)
                pos = pos + 1
            out = torch.stack(emitted, dim=1)
            carry.copy_(tok)
            return out

        return self._program(run, inputs, params)

    def _build_spec_step(self, params) -> Program:
        """ONE program for every speculative round: a single ragged step
        whose logits are taken at EVERY packed candidate index
        (``cand_idx``, the generalized ``last_idx``), then the verify
        epilogue (``sampling.spec_sample_rows``, or its argmax-only twin
        until the epilogue is on). A row's span ``[carry, d1..dk]`` is a
        short prefill at consecutive positions under the kernel's
        ``key_pos <= position`` rule, so candidate ``j``'s logits follow
        the row's history plus ``span[0..j]``. The span's tokens are
        flagged ``decoding``: each takes the attention kernels' route of
        a token the unified step decodes alone, so (on the unified
        step's packed axis, ``step_tokens`` >= slots·(k+1), where the
        projections' GEMMs have one row count in both steps) a greedy
        speculative stream is the plain greedy stream bit for bit, as
        the reference promises. Shapes depend only on
        (spec tokens, slots·(k+1), table width). Returns (slots, k+2)
        int32: each row's k+1 candidate tokens, then its accepted
        count; only rows that commit a token (``sampled``) advance their
        grammar state in place."""
        T, n_rows, k1 = self._spec_tokens, self.num_slots, self.spec_k + 1
        mgr, mcfg = self.mgr, self.model_config
        gcarry, samp, gtable = (self._gstate_dev, self._samp_dev,
                                self._arena.table)
        tail = (_sampling.spec_sample_rows if self._epilogue_on
                else _sampling.spec_greedy_rows)
        i32 = torch.int32
        inputs = dict(ids=((T,), i32), token_row=((T,), i32),
                      positions=((T,), i32), decoding=((T,), torch.bool),
                      kv_lens=((n_rows,), i32),
                      cand_idx=((n_rows * k1,), i32),
                      drafts=((n_rows, max(self.spec_k, 1)), i32),
                      draft_len=((n_rows,), i32),
                      sampled=((n_rows,), torch.bool),
                      bt=((n_rows, self._table_width), i32))

        def run(ids, token_row, positions, decoding, kv_lens, cand_idx,
                drafts, draft_len, sampled, bt):
            logits, _, _ = L.ragged_step(
                params, ids, token_row, positions, kv_lens, cand_idx,
                mgr.k_pages, mgr.v_pages, bt, mcfg, decoding=decoding)
            lg = logits.reshape(n_rows, k1, -1)
            pos_base = positions[cand_idx.reshape(n_rows, k1)[:, 0].long()]
            toks, accepted, ngst = tail(lg, drafts, draft_len, pos_base,
                                        samp, gcarry, gtable)
            gcarry.copy_(torch.where(sampled, ngst, gcarry))
            return torch.cat([toks, accepted[:, None]], dim=1)

        if self._fused_tail:
            from ..jit.fusion import build_fused_spec_step
            fused = build_fused_spec_step(
                lambda ids, token_row, positions, kv_lens, cand_idx, bt,
                decoding: L.ragged_step(
                    params, ids, token_row, positions, kv_lens, cand_idx,
                    mgr.k_pages, mgr.v_pages, bt, mcfg,
                    decoding=decoding)[0],
                lambda lg, drafts, draft_len, pos_base, gst: tail(
                    lg, drafts, draft_len, pos_base, samp, gst, gtable),
                self.spec_k, n_rows)
            kd = max(self.spec_k, 1)
            packed = dict(plan_tt=((4, T), i32),
                          plan_tr=((3 + k1 + kd, n_rows), i32),
                          bt=inputs["bt"])
            return self._program(
                lambda plan_tt, plan_tr, bt: fused(plan_tt, plan_tr, bt,
                                                   gcarry),
                packed, params)
        return self._program(run, inputs, params)

    # -- service API --------------------------------------------------------

    def _budget(self, req: _Request) -> int:
        """Per-request new-token budget (submit() override or config)."""
        return (req.max_new_tokens if req.max_new_tokens is not None
                else self.config.max_new_tokens)

    @property
    def num_chips(self) -> int:
        """Chips the engine is sharded over (1: the port serves on one
        card)."""
        return self.mgr.mesh_chips

    @property
    def mesh(self):
        """The serving mesh (None: single card)."""
        return None

    @property
    def num_free_slots(self) -> int:
        """Slots not occupied by a live sequence (the queue not
        counted)."""
        return self._slot_rid.count(None)

    @property
    def num_queued(self) -> int:
        """Submitted requests waiting in the engine's own FIFO (not yet
        holding a slot); the scheduler's admission headroom reads it."""
        return len(self._queue)

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               trace_id: str = "", sampler: Optional[SamplerConfig] = None,
               grammar=None, grammar_prefix=None, *,
               decoded: int = 0) -> int:
        """Queue a request; returns its id. ``trace_id`` tags its spans
        and events (the serving scheduler's trace). ``sampler`` carries the
        per-request temperature/top-k/top-p/seed (None: a sampler from the
        engine's ``GenerationConfig`` when ``do_sample``, else greedy);
        ``grammar`` is a ``constrain.TokenDFA`` constraining every
        generated token; ``grammar_prefix`` advances its automaton through
        tokens the request already generated elsewhere. Both ride the
        unified step's epilogue. ``decoded`` says that the last
        ``decoded`` prompt tokens were generated (a continuation of a
        stream that moved): the unified and speculative steps prefill
        them flagged ``decoding``, each over exactly the keys it saw when
        it was decoded, so the continuation equals the uninterrupted
        stream at every dtype. The legacy pipeline prefills the given
        prompt only and forces the decoded tokens through its decode
        chunk, one a step, as the uninterrupted run decoded them. 0 (a
        fresh prompt) changes nothing."""
        budget = (max_new_tokens if max_new_tokens is not None
                  else self.config.max_new_tokens)
        prompt = np.asarray(prompt, np.int32)
        if not 0 <= decoded <= len(prompt):
            raise ValueError(f"decoded={decoded} is not within the prompt's "
                             f"{len(prompt)} tokens")
        if len(prompt) + budget > self.max_seq_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens + max_new_tokens="
                f"{budget} exceeds the engine's "
                f"max_seq_len={self.max_seq_len}; raise max_seq_len or "
                "truncate the prompt (silent page clamping would corrupt "
                "the sequence's KV)")
        if (sampler is not None or grammar is not None) \
                and not self._unified:
            raise ValueError(
                "per-request sampling / constrained decoding ride the "
                "unified ragged step's in-program epilogue; construct "
                "the engine with unified=True (legacy unified=False "
                "supports only the engine-wide GenerationConfig sampler)")
        if sampler is None and self.config.do_sample and self._unified:
            # engine-wide do_sample maps onto the per-request epilogue
            sampler = SamplerConfig(temperature=self.config.temperature,
                                    top_k=self.config.top_k,
                                    top_p=self.config.top_p)
        rid = self._next_rid
        self._next_rid += 1
        if sampler is not None:
            sampler = sampler.resolved(
                self.config.seed * 1000003 + 7919 * rid)
        if (sampler is not None or grammar is not None) \
                and not self._epilogue_on:
            # the first sampled/constrained request: the programs are
            # rebuilt once with the full epilogue (a counted miss)
            self._epilogue_on = True
            self._unified_step = None
            self._spec_step = None
        gstart, ghost = -1, -1
        if grammar is not None:
            # ValueError on vocab mismatch / arena overflow, at submit
            gstart = self._arena.register(grammar)
            _sampling.set_grammar_states(self._arena.used)
            ghost = grammar.start
            for t in (grammar_prefix if grammar_prefix is not None
                      else ()):
                ghost = grammar.advance(ghost, int(t))
                if ghost == _constrain.ILLEGAL:
                    raise ValueError(
                        f"grammar_prefix token {int(t)} is illegal in "
                        f"grammar {grammar.pattern!r} — the resumed "
                        "stream cannot have produced it")
        counts = self.sampling_counts
        counts["paddle_sampling_grammar_states"] = self._arena.used
        mode = ("constrained" if grammar is not None else "sampled"
                if sampler is not None and sampler.temperature > 0 else None)
        if mode is not None:
            counts["paddle_sampling_requests_total"][mode] += 1
            _sampling.note_request(mode)
        self._queue.append(_Request(rid, prompt,
                                    max_new_tokens=max_new_tokens,
                                    trace_id=trace_id, sampler=sampler,
                                    grammar=grammar, gstart=gstart,
                                    gstate_host=ghost, decoded=int(decoded)))
        return rid

    def cancel(self, rid: int) -> bool:
        """Abort a request. Queued: dropped. Live: the slot retires now,
        its pages return to the pool and nothing lands in the finished
        map. Returns False for unknown/done rids."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                self._queue.pop(i)
                return True
        if rid in self._live:
            self._retire(self._slot_rid.index(rid), cancelled=True)
            return True
        return False

    def _admit_pick(self):
        """Pop queued requests into free slots, resolve the prefix cache
        (shared pages, COW copy) and allocate their pages. Returns the
        picked ``(slot, req, pages_row, prompt_len, n_cached)`` list.
        Admission is atomic over the window: if anything raises, every
        picked allocation is freed and the requests go back to the head
        of the queue in order. Cache hits are counted only once the
        whole window lands."""
        picked: list = []
        recorded: list = []
        try:
            self._admit_window(picked, recorded)
        except BaseException:
            for _, req, _, _, _ in reversed(picked):
                self.mgr.free(req.rid)
                self._queue.insert(0, req)
            raise
        for req, lp, n_cached, n_shared, cow_src in recorded:
            self.cache.record(req.rid, lp, n_cached, n_shared,
                              cow_src is not None, trace_id=req.trace_id)
        return picked

    def _admit_window(self, picked, recorded):
        for s in range(self.num_slots):
            if self._slot_rid[s] is not None or not self._queue:
                continue
            req = self._queue[0]
            lp = len(req.prompt)
            total = lp + self._budget(req)       # submit() bounds this
            shared: list = []
            n_cached = 0
            cow_src = None
            if self.cache is not None:
                shared, n_cached, cow_src = self.cache.lookup(req.prompt)
            need_fresh = self.mgr.pages_for(total) - len(shared)
            if self.mgr.num_free_pages < need_fresh and self.cache is not None:
                # reclaim cold cached pages before deferring admission;
                # protect the pages THIS lookup is about to share
                self.cache.evict(need_fresh - self.mgr.num_free_pages,
                                 protect=shared + [cow_src])
                if (self.mgr.num_free_pages < need_fresh
                        and cow_src is not None):
                    # still short: give up the COW page (one more
                    # evictable) and recompute its block instead
                    cow_src, n_cached = None, len(shared) * self.page_size
                    self.cache.evict(
                        need_fresh - self.mgr.num_free_pages,
                        protect=shared)
            if self.mgr.num_free_pages < need_fresh:
                # infeasibility is judged against WHOLE-pool capacity
                if not self._live and not picked \
                        and self.mgr.pages_for(total) > self.mgr.usable_pages:
                    memory_ledger.note_oom(
                        "infeasible", self.mgr,
                        need_pages=self.mgr.pages_for(total),
                        free_pages=self.mgr.num_free_pages,
                        request_id=req.rid, trace_id=req.trace_id)
                    raise MemoryError(
                        f"request {req.rid} needs "
                        f"{self.mgr.pages_for(total)} pages but the pool "
                        f"only holds {self.mgr.usable_pages}; enlarge "
                        "num_pages")
                break                    # pool full: wait for a completion
            if self.cache is not None:
                pages = self.mgr.allocate(req.rid, total, shared=shared)
            else:
                pages = self.mgr.allocate(req.rid, total)
            # ownership moves into ``picked`` at once (the rollback in
            # _admit_pick owns the pages from here)
            picked.append((s, req, pages, lp, n_cached))
            self._queue.pop(0)
            if cow_src is not None:
                # the suffix's first write lands mid-page: append into a
                # private device-side copy, never the shared page
                self.mgr.copy_page(cow_src, pages[len(shared)])
            self.mgr._lens[req.rid] = lp
            if memory_armed[0]:
                # per-request attribution: cached-vs-fresh page split
                memory_ledger.note_request(
                    self.mgr, req.rid, prompt_len=lp,
                    cached_pages=len(shared), trace_id=req.trace_id)
            if self.cache is not None:
                recorded.append((req, lp, n_cached, len(shared), cow_src))

    def _complete(self, req: _Request) -> bool:
        if len(req.tokens) >= self._budget(req):
            return True
        eos = self.config.eos_token_id
        return eos is not None and bool(req.tokens) \
            and req.tokens[-1] == eos

    def _note_win(self, s: int, kind: str, t0_ns: int, t1_ns: int,
                  units: int, batch: list) -> None:
        """Merge one armed step's activity into the slot's pending span
        window (same kind: extend and accumulate; a phase change flushes
        the old window into ``batch`` and starts a new one)."""
        w = self._win[s]
        if w is not None:
            if w[0] == kind:
                w[2] = t1_ns
                w[3] += units
                return
            self._flush_win(s, batch)
        self._win[s] = [kind, t0_ns, t1_ns, units]

    def _flush_win(self, s: int, batch: Optional[list] = None) -> None:
        """Emit the slot's pending coalesced span (no-op when none); a
        cancel flushes too, so a request's trace keeps its last
        segment."""
        w = self._win[s]
        if w is None:
            return
        self._win[s] = None
        rid = self._slot_rid[s]
        req = self._live.get(rid)
        if req is None:
            return
        kind, t0_ns, t1_ns, units = w
        if kind == "prefill":
            sp = make_span("engine.prefill", t0_ns, t1_ns, "Operator",
                           req.trace_id,
                           args={"request_id": rid, "slot": s,
                                 "prefill_tokens": units})
        else:
            sp = make_span("engine.decode_chunk", t0_ns, t1_ns,
                           "Operator", req.trace_id,
                           args={"request_id": rid, "slot": s,
                                 "chunk": units})
        if batch is None:
            emit_spans([sp])
        else:
            batch.append(sp)

    def _retire(self, s: int, cancelled: bool = False) -> None:
        """Free a finished (or cancelled) slot: with the cache, index the
        finished prefix first (pages backing its full token blocks stay
        resident); then pages back to the pool, output to the finished
        map, the slot's table back to page 0. A cancelled slot produces
        no finished entry and no ``finish_callback``. Host books only:
        the slot's device rows (carry, sampler, grammar state) are
        rewritten when the next request is admitted into it, before any
        program reads them."""
        self._flush_win(s)
        rid = self._slot_rid[s]
        req = self._live.pop(rid)
        if not cancelled:
            out = req.tokens[:self._budget(req)]
            self._finished[rid] = out
            self._finished_crc[rid] = token_checksum(out)
            if self.cache is not None:
                # positions past the kept output may hold over-decoded
                # garbage, but those never complete a block (full blocks
                # end <= kept length)
                toks = ([int(t) for t in req.prompt]
                        + [int(t) for t in out])
                if self._speculative and out:
                    # the last delivered token may be the verify bonus,
                    # committed but never fed back (its K/V slot never
                    # written): index one token short
                    toks = toks[:-1]
                self.cache.insert(toks, self.mgr.sequence_pages(rid))
            if self.finish_callback is not None:
                self.finish_callback(rid, out)
        self.mgr.free(rid)
        self._slot_rid[s] = None
        self._bt[s] = 0
        self._pos[s] = 0
        self._pend[s] = None
        self._forced[s] = None

    def _deliver_tokens(self, s: int, tokens) -> bool:
        """Append one slot's emitted tokens to its request (up to its
        budget or EOS), fire ``token_callback`` per token, and retire the
        slot when the request completes. The callback may cancel its own
        request (or another) in place: the unpack stops for a slot whose
        request is gone. A constrained request's host mirror walks its
        automaton per token (an illegal token is counted in
        ``paddle_sampling_violations_total`` and emits a
        ``constraint_violation`` event; the device mask makes it never
        expected). Returns True while the slot keeps decoding."""
        rid = self._slot_rid[s]
        req = self._live[rid]
        counts = self.sampling_counts
        mode = ("constrained" if req.grammar is not None else
                "sampled" if (req.sampler is not None
                              and req.sampler.temperature > 0) else None)
        for t in tokens:
            t = int(t)
            if req.grammar is not None:
                if req.grammar.legal(req.gstate_host, t):
                    req.gstate_host = req.grammar.advance(
                        req.gstate_host, t)
                else:
                    counts["paddle_sampling_violations_total"] += 1
                    _sampling.note_violation()
                    emit_event("constraint_violation", request_id=rid,
                               trace_id=req.trace_id, token=t,
                               state=int(req.gstate_host),
                               pattern=req.grammar.pattern)
            if mode is not None:
                counts["paddle_sampling_tokens_total"][mode] += 1
                _sampling.note_tokens(mode, 1)
            req.tokens.append(t)
            if self.token_callback is not None:
                self.token_callback(rid, t)
                if self._slot_rid[s] != rid:
                    return False   # the callback cancelled this request
            if self._complete(req):
                break
        if self._slot_rid[s] != rid:
            return False           # retired by a reentrant cancel
        if self._complete(req):
            self._retire(s)
            return False
        return True

    def step(self, params) -> int:
        """One admit + decode round (ONE device->host copy: the step's
        emitted tokens). Returns the live count after the round. With
        the prefix cache or speculation, the page books are audited
        after every round (every page is free, live or cached: the
        anchor of the shared-ownership model)."""
        if self._speculative:
            n = self._step_spec(params)
        elif self._unified:
            n = self._step_unified(params)
        else:
            n = self._step_legacy(params)
        if self._check_invariants:
            self.mgr.check_conservation()
        if self.cache is not None:
            self.cache.update_gauges()
        if memory_armed[0]:
            # the memory half of the per-step audit (one list index when
            # disarmed)
            self._note_memory(params)
        return n

    def _note_memory(self, params) -> None:
        """Feed the memory ledger one accounting round (armed only): the
        weights (once per params object), the pool's page split with the
        speculative tails, and the prefix-cache stats; host metadata
        only (tensor ``.nbytes`` and the page books), never a device
        sync. An engine without per-step page audits feeds every 16th
        step."""
        if not self._check_invariants:
            self._mem_tick += 1
            if self._mem_tick & 15:
                return
        memory_ledger.note_weights(params)
        reserved = None
        if self._speculative:
            reserved = {self._slot_rid[s]: int(self._reserved[s])
                        for s in range(self.num_slots)
                        if self._slot_rid[s] is not None}
        memory_ledger.observe(
            self.mgr, reserved=reserved,
            cache_stats=self.cache.stats if self.cache is not None
            else None,
            audit=self._check_invariants)

    def _set_row_sampler(self, s: int, req: _Request) -> None:
        """Write an admitted request's sampler and grammar state into the
        slot's device rows, in place. Always runs: a greedy request
        resets the slot, so reuse never inherits a retired row's
        temperature or grammar state."""
        _sampling.set_row(self._samp_dev, s, req.sampler)
        g = -1
        if req.grammar is not None:
            # arena rows are the grammar's block rebased by its offset
            g = req.gstart - req.grammar.start + req.gstate_host
        self._gstate_dev[s] = g

    def _admit_rows(self):
        """Unified/speculative admission: host bookkeeping only (a warm or
        COW row is a row whose first position is its cached length)."""
        for s, req, pages, lp, n_cached in self._admit_pick():
            self._slot_rid[s] = req.rid
            self._live[req.rid] = req
            self._pos[s] = n_cached           # next position to write
            self._bt[s] = 0
            self._bt[s, :len(pages)] = pages
            self._pend[s] = np.asarray(req.prompt[n_cached:], np.int32)
            self._dec_from[s] = lp - req.decoded
            if self._speculative:
                self._reserved[s] = len(pages)
            self._set_row_sampler(s, req)

    # -- the unified ragged step ---------------------------------------------

    def _plan_step(self, plan: Dict[str, np.ndarray]):
        """Host-side layout of one step: simulate ``chunk`` micro-rounds
        over the live slots, packing each round's tokens into the fixed
        ``step_tokens`` axis. Decode rows claim one slot each; prefill
        rows share the rest of the budget in slot order and turn into
        decode rows the round after their prompt completes. Advances
        the slot mirrors (positions, pending prompt suffixes). Writes
        the plan arrays into ``plan`` (the unified program's host
        inputs); returns the emit mask and the prefill tokens fed per
        slot."""
        K, tb, n_rows = self.chunk, self._step_tokens, self.num_slots
        for name, fill in (("ids", 0), ("use_carry", False),
                           ("decoding", False),
                           ("token_row", -1), ("positions", 0),
                           ("kv_lens", 0), ("last_idx", 0),
                           ("sample_mask", False)):
            plan[name].fill(fill)
        ids, use_carry, decoding, token_row, positions = (
            plan[n] for n in ("ids", "use_carry", "decoding", "token_row",
                              "positions"))
        kv_lens, last_idx, sample_mask = (
            plan[n] for n in ("kv_lens", "last_idx", "sample_mask"))
        emit = np.zeros((K, n_rows), bool)
        fed = [0] * n_rows                    # prefill tokens consumed
        pos = self._pos.astype(np.int64).copy()
        rem = {s: len(self._pend[s]) for s in range(n_rows)
               if self._slot_rid[s] is not None and self._pend[s] is not None}
        live = [s for s in range(n_rows) if self._slot_rid[s] is not None]
        for k in range(K):
            budget = tb - sum(1 for s in live if rem.get(s, 0) == 0)
            cursor = 0
            for s in live:
                if rem.get(s, 0) > 0:          # prefilling
                    n = min(rem[s], budget)
                    budget -= n
                    if n == 0:
                        continue               # starved this round
                    sl = slice(cursor, cursor + n)
                    ids[k, sl] = self._pend[s][fed[s]:fed[s] + n]
                    token_row[k, sl] = s
                    positions[k, sl] = pos[s] + np.arange(n)
                    # prompt tokens decoded elsewhere: a carry's route
                    decoding[k, sl] = positions[k, sl] >= self._dec_from[s]
                    pos[s] += n
                    fed[s] += n
                    rem[s] -= n
                    last_idx[k, s] = cursor + n - 1
                    if rem[s] == 0:
                        # prompt complete: this round's last logits are
                        # the row's first sample (kept in the carry)
                        sample_mask[k, s] = True
                    cursor += n
                else:                          # decoding
                    use_carry[k, cursor] = True
                    decoding[k, cursor] = True
                    token_row[k, cursor] = s
                    positions[k, cursor] = pos[s]
                    pos[s] += 1
                    last_idx[k, s] = cursor
                    sample_mask[k, s] = True
                    emit[k, s] = True
                    cursor += 1
                kv_lens[k, s] = pos[s]
        self._pos = pos.astype(np.int32)
        for s in list(rem):
            self._pend[s] = (None if rem[s] == 0
                             else self._pend[s][fed[s]:])
        return emit, fed

    def _plan_step_packed(self, host: Dict[str, np.ndarray]):
        """Fused-tail planning: the plan arrays of :meth:`_plan_step`
        packed into the two uploads ``plan_tt`` / ``plan_tr``
        (``jit.fusion.pack_plan``), with a vectorized path for the steady
        round where every live slot decodes (the K x slots simulation
        collapses to numpy broadcasts; the arrays are the generic
        planner's, byte for byte)."""
        from ..jit.fusion import pack_plan
        K, tb, n_rows = self.chunk, self._step_tokens, self.num_slots
        live = [s for s in range(n_rows) if self._slot_rid[s] is not None]
        if live and all(self._pend[s] is None for s in live):
            nl = len(live)
            lv = np.asarray(live, np.int64)
            ids = np.zeros((K, tb), np.int32)
            use_carry = np.zeros((K, tb), bool)
            use_carry[:, :nl] = True
            decoding = use_carry.copy()
            token_row = np.full((K, tb), -1, np.int32)
            token_row[:, :nl] = lv
            positions = np.zeros((K, tb), np.int32)
            base = self._pos[lv].astype(np.int64)
            k_col = np.arange(K, dtype=np.int64)[:, None]
            positions[:, :nl] = base[None, :] + k_col
            kv_lens = np.zeros((K, n_rows), np.int32)
            kv_lens[:, lv] = base[None, :] + k_col + 1
            last_idx = np.zeros((K, n_rows), np.int32)
            last_idx[:, lv] = np.arange(nl, dtype=np.int64)[None, :]
            sample_mask = np.zeros((K, n_rows), bool)
            sample_mask[:, lv] = True
            emit = sample_mask.copy()
            self._pos[lv] = (base + K).astype(np.int32)
            fed = [0] * n_rows
        else:
            plan = {n: np.zeros(shape, np.int32 if dt == torch.int32
                                else bool)
                    for n, (shape, dt) in self._unified_inputs().items()}
            emit, fed = self._plan_step(plan)
            ids, use_carry, decoding, token_row, positions = (
                plan[n] for n in ("ids", "use_carry", "decoding",
                                  "token_row", "positions"))
            kv_lens, last_idx, sample_mask = (
                plan[n] for n in ("kv_lens", "last_idx", "sample_mask"))
        host["plan_tt"][:], host["plan_tr"][:] = pack_plan(
            ids, use_carry, token_row, positions, kv_lens, last_idx,
            sample_mask, decoding=decoding)
        return emit, fed

    def _epilogue_active(self) -> bool:
        """Any live request exercising the sampling epilogue (sampled or
        constrained rows): gates the armed ``cbe.sample_epilogue`` tap."""
        return any(r.sampler is not None or r.grammar is not None
                   for r in self._live.values())

    def _step_unified(self, params) -> int:
        """One admit + ragged round. Admission is host bookkeeping (a
        warm/COW row is just a row whose first position is its cached
        length); the round uploads its plan once, runs the unified
        program's ``chunk`` micro-rounds on the device, and copies the
        emitted tokens back once."""
        self._admit_rows()
        if not self._live:
            return 0
        self._unified_step = prog = self._fetch(
            self._unified_step, "cbe.unified_step",
            (self.num_slots, self.chunk, self._step_tokens,
             self._table_width, self._fused_tail, 1, self._epilogue_on),
            self._build_unified_step, params)
        # armed-only chain taps (observability.profiling): the plan ->
        # dispatch -> unpack phases; one list index per step disarmed
        armed_chain = _chain_armed[0]
        tc0 = time.perf_counter_ns() if armed_chain else 0
        if self._fused_tail:
            emit, fed = self._plan_step_packed(prog.host)
        else:
            emit, fed = self._plan_step(prog.host)
        if armed_chain:
            tc1 = time.perf_counter_ns()
            _note_chain(op_name="cbe.plan_step", dur_ns=tc1 - tc0)
            tc0 = tc1
        prog.host["bt"][:] = self._bt
        self._prefill_tokens += sum(fed)
        t0_ns = time.perf_counter_ns() if spans_armed() else 0
        toks = self._run("cbe.unified_step", prog).cpu().numpy()  # the fence
        if armed_chain:
            tc1 = time.perf_counter_ns()
            _note_chain(op_name="cbe.unified_step", dur_ns=tc1 - tc0)
            if self._epilogue_active():
                # the sampling epilogue runs inside the step's program
                _note_chain(op_name="cbe.sample_epilogue", dur_ns=0)
            tc0 = tc1
        self.micro_rounds += self.chunk
        if t0_ns:
            self._note_step_windows(t0_ns, emit.sum(axis=0), fed)
        for s in range(self.num_slots):
            if self._slot_rid[s] is None:
                continue
            self._deliver_tokens(
                s, (toks[k, s] for k in range(self.chunk) if emit[k, s]))
        if armed_chain:
            # the unpack phase: the fusion pass's decode_tail signature
            _note_chain(op_name="cbe.decode_tail",
                        dur_ns=time.perf_counter_ns() - tc0)
        return len(self._live)

    def _note_step_windows(self, t0_ns: int, emit_counts, fed) -> None:
        """Per-request phase bookkeeping over an armed step's window
        (dispatch to the fence): each live slot's prefill and decode
        activity extends its coalesced window; spans materialise at a
        phase change (here) or at retirement."""
        t1_ns = time.perf_counter_ns()
        batch: list = []
        win = self._win
        for s in range(self.num_slots):
            if self._slot_rid[s] is None:
                continue
            c, f = int(emit_counts[s]), fed[s]
            if (c == 0) != (f == 0):
                # steady single-phase round: extend the window inline
                w = win[s]
                kind = "decode" if c else "prefill"
                if w is not None and w[0] == kind:
                    w[2] = t1_ns
                    w[3] += c or f
                    continue
            if f > 0:
                self._note_win(s, "prefill", t0_ns, t1_ns, f, batch)
            if c:
                self._note_win(s, "decode", t0_ns, t1_ns, c, batch)
        if batch:
            emit_spans(batch)

    # -- the legacy pipeline (unified=False) ---------------------------------

    def _admit(self, params) -> None:
        """Legacy admission: allocate pages, prefill into the slots, keep
        the first generated tokens in the device carry.

        Admissions are batched: every request admitted this round goes
        through ONE prefill call per (suffix bucket, warm) group, B padded
        to the next power of two (clamped to ``num_slots``); pad rows
        prefill one pad token into the reserved page 0 and their tokens
        are dropped. Cold rows never share a call with warm rows, so
        cold traffic runs the full prefill whether the cache is on or
        off. Each group's call is the prefill program of its key; its
        first tokens go into the carry in place.

        A continuation (``submit(decoded=n)``) prefills only its given
        prompt, the first ``lp - n`` tokens; its streamed tokens past the
        cached prefix wait in ``_forced`` for the decode chunk, which runs
        them one a step as the uninterrupted run decoded them. A row whose
        given prompt is all cached (a handoff's imported pages) skips the
        prefill. One the cache covers only in part is prefilled whole, in
        a cold wave, as the uninterrupted run prefilled a prompt it had
        no cached prefix for: the suffix prefill attends through a page
        gather, the full one through the flash kernel, and at bf16 the
        two round differently. Its shared pages stay shared: the wave's
        writes for their positions go to the reserved page 0."""
        cfg = self.config
        groups: Dict[tuple, list] = {}
        for s, req, pages, lp, n_cached in self._admit_pick():
            given = lp - req.decoded
            self._forced[s] = (np.asarray(req.prompt[max(given, n_cached):],
                                          np.int32)
                               if req.decoded else None)
            if given <= n_cached:
                self._seat(s, req, pages, n_cached)
                continue
            start = 0 if req.decoded else n_cached
            # pages shared with the cache (no copy-on-write here: that
            # needs the whole prompt cached)
            shared = n_cached // self.page_size
            groups.setdefault((_bucket(given - start), start > 0),
                              []).append((s, req, pages, given, start,
                                          shared))
        for (bucket, warm), items in groups.items():
            real = len(items)
            b_pad = 1
            while b_pad < real:
                b_pad *= 2
            b_pad = min(b_pad, self.num_slots)
            key = ("sfx", bucket, b_pad) if warm else (bucket, b_pad)
            build = (self._build_prefill_suffix if warm
                     else self._build_prefill)
            self._compiled_prefill[key] = prog = self._fetch(
                self._compiled_prefill.get(key), "cbe.prefill", key,
                lambda p: build(bucket, b_pad, p), params)
            host = prog.host
            host["ids"].fill(cfg.pad_token_id)
            host["rows"].fill(0)
            host["lens"].fill(1)                 # pad rows: 1 garbage tok
            if warm:
                host["starts"].fill(0)
            if cfg.do_sample:
                host["key"][:] = self._next_key()
            for i, (s, req, pages, given, start, shared) in enumerate(items):
                host["ids"][i, :given - start] = req.prompt[start:given]
                host["rows"][i, :len(pages)] = pages
                host["lens"][i] = given - start
                if warm:
                    host["starts"][i] = start
                else:
                    # a continuation's shared pages: its writes there go
                    # to the reserved page 0 (0 pages for a fresh prompt)
                    host["rows"][i, :shared] = 0
            t0_ns = time.perf_counter_ns() if spans_armed() else 0
            tok = self._run("cbe.prefill", prog)
            self.prefill_calls += 1
            self._prefill_tokens += int(sum(it[3] - it[4] for it in items))
            if t0_ns:
                # the wave has no fence of its own (its first tokens stay
                # in the device carry): its device time lands inside the
                # next decode chunk's span, which closes after the fence
                t1_ns = time.perf_counter_ns()
                for s, req, pages, given, start, _ in items:
                    emit_span("engine.prefill", t0_ns, t1_ns,
                              event_type="Operator", trace_id=req.trace_id,
                              args={"request_id": req.rid, "bucket": bucket,
                                    "prompt_len": len(req.prompt),
                                    "cached_tokens": start})
            slots = torch.as_tensor([it[0] for it in items],
                                    device=self.device)
            self._tok_dev[slots] = tok[:real]
            for s, req, pages, given, _, _ in items:
                self._seat(s, req, pages, given)

    def _seat(self, s: int, req: _Request, row, pos: int) -> None:
        """Seat an admitted legacy row: its slot, its next position and
        its block table."""
        self._slot_rid[s] = req.rid
        self._live[req.rid] = req
        self._pos[s] = pos
        self._bt[s] = 0
        self._bt[s, :len(row)] = row

    def _step_legacy(self, params) -> int:
        self._admit(params)
        if not self._live:
            return 0
        self._decode_chunk = prog = self._fetch(
            self._decode_chunk, "cbe.decode_chunk",
            (self.num_slots, self.chunk), self._build_decode_chunk, params)
        prog.host["pos"][:] = self._pos
        prog.host["bt"][:] = self._bt
        forced = prog.host["forced"]
        forced.fill(-1)
        n_forced = [0] * self.num_slots
        for s, f in enumerate(self._forced):
            if f is not None and len(f):
                n_forced[s] = n = min(len(f), self.chunk)
                forced[s, :n] = f[:n]
                self._forced[s] = f[n:]
        if self.config.do_sample:
            prog.host["key"][:] = self._next_key()
        t0_ns = time.perf_counter_ns() if spans_armed() else 0
        toks = self._run("cbe.decode_chunk", prog).cpu().numpy()  # the fence
        self.decode_steps += self.chunk
        if t0_ns:
            t1_ns = time.perf_counter_ns()
            for s in range(self.num_slots):
                rid = self._slot_rid[s]
                if rid is None:
                    continue
                emit_span("engine.decode_chunk", t0_ns, t1_ns,
                          event_type="Operator",
                          trace_id=self._live[rid].trace_id,
                          args={"request_id": rid, "slot": s,
                                "chunk": self.chunk})
        for s in range(self.num_slots):
            if self._slot_rid[s] is None:
                continue
            # forced tokens are already in the stream: never delivered
            if self._deliver_tokens(s, toks[s][n_forced[s]:]):
                self._pos[s] += self.chunk
        return len(self._live)


    # -- speculative decoding (draft + verify in ONE ragged dispatch) --------

    def _plan_spec(self, plan: Dict[str, np.ndarray]):
        """Host layout of one speculative round, written into ``plan``
        (the spec program's host inputs). Every decoding row claims a
        span ``[carry] + up to spec_k drafted tokens``; its page table
        grows to cover the span (``mgr.grow_to``), and pool pressure or
        the block-table span shrink the draft, never fail the round.
        Constrained rows never draft. Prefill rows share the rest of the
        packed budget as in one micro-round of ``_plan_step``. Returns
        the per-slot verify plan and the prefill tokens fed per slot."""
        n_rows, k1 = self.num_slots, self.spec_k + 1
        cap_tokens = self._table_width * self.page_size
        for name, fill in (("ids", 0), ("token_row", -1), ("positions", 0),
                           ("decoding", False), ("kv_lens", 0),
                           ("cand_idx", 0), ("drafts", 0), ("draft_len", 0),
                           ("sampled", False)):
            plan[name].fill(fill)
        ids, token_row, positions, decoding, kv_lens, cand_idx = (
            plan[n] for n in ("ids", "token_row", "positions", "decoding",
                              "kv_lens", "cand_idx"))
        drafts, draft_len, sampled = (plan[n] for n in ("drafts",
                                                        "draft_len",
                                                        "sampled"))
        info: Dict[int, tuple] = {}
        fed = [0] * n_rows
        live = [s for s in range(n_rows) if self._slot_rid[s] is not None]
        spans: Dict[int, tuple] = {}
        armed = spans_armed()
        draft_spans: list = []
        for s in live:
            if self._pend[s] is not None:
                continue                      # prefilling: planned below
            rid = self._slot_rid[s]
            req = self._live[rid]
            d0_ns = time.perf_counter_ns() if armed else 0
            # committed history (prompt + delivered tokens; the last
            # delivered token IS the carry whose K/V this round writes)
            history = [int(t) for t in req.prompt] + req.tokens
            if req.grammar is not None:
                # candidates past the carry would be checked against
                # un-advanced grammar states: one candidate a round
                draft = []
            else:
                draft = [int(t) for t in
                         self.drafter.draft(history, self.spec_k)]
            pos0 = int(self._pos[s])
            # clamp to the remaining budget (a round commits at most
            # len(draft) + 1 tokens) and to the row's block-table span
            rem = self._budget(req) - len(req.tokens)
            draft = draft[:max(0, min(self.spec_k, rem - 1,
                                      cap_tokens - 1 - pos0))]
            while True:
                try:
                    self.mgr.grow_to(rid, pos0 + len(draft) + 1)
                    break
                except MemoryError:
                    draft.pop()
            tbl = self.mgr.sequence_pages(rid)
            self._bt[s] = 0
            self._bt[s, :len(tbl)] = tbl
            if d0_ns:
                # host drafting and page growth: a segment of its own,
                # apart from the verify dispatch (engine.spec_round)
                draft_spans.append(make_span(
                    "engine.spec_draft", d0_ns, time.perf_counter_ns(),
                    "Operator", req.trace_id,
                    args={"request_id": rid, "slot": s,
                          "drafted": len(draft)}))
            spans[s] = (pos0, [history[-1]] + draft, draft)
            drafts[s, :len(draft)] = draft
            draft_len[s] = len(draft)
        emit_spans(draft_spans)
        budget = len(ids) - sum(1 + len(d) for _, _, d in spans.values())
        cursor = 0
        for s in live:
            if s in spans:                    # decode: speculative span
                pos0, span, draft = spans[s]
                n = len(span)
                ids[cursor:cursor + n] = span
                token_row[cursor:cursor + n] = s
                positions[cursor:cursor + n] = pos0 + np.arange(n)
                decoding[cursor:cursor + n] = True
                kv_lens[s] = pos0 + n
                cand_idx[s * k1:s * k1 + n] = cursor + np.arange(n)
                info[s] = ("spec", pos0, draft)
                sampled[s] = True
                cursor += n
            else:                             # prefilling
                rem = len(self._pend[s])
                n = min(rem, budget)
                if n == 0:
                    continue                  # starved this round
                pos0 = int(self._pos[s])
                ids[cursor:cursor + n] = self._pend[s][:n]
                token_row[cursor:cursor + n] = s
                positions[cursor:cursor + n] = pos0 + np.arange(n)
                decoding[cursor:cursor + n] = (positions[cursor:cursor + n]
                                               >= self._dec_from[s])
                kv_lens[s] = pos0 + n
                budget -= n
                fed[s] = n
                self._pos[s] = pos0 + n
                if n == rem:
                    # prompt complete: this round's last logits are the
                    # row's first sample
                    cand_idx[s * k1] = cursor + n - 1
                    info[s] = ("first_sample",)
                    sampled[s] = True
                    self._pend[s] = None
                else:
                    self._pend[s] = self._pend[s][n:]
                cursor += n
        return info, fed

    def _verify_spec(self, toks, info, accepted) -> None:
        """Host commit of one round: deliver each row's accepted drafted
        prefix plus the epilogue's token at the first rejected lane (the
        argmax, or the residual / bonus draw), roll the paged KV back on
        a rejection (never below the admission reservation), and deliver
        through ``_deliver_tokens`` (budget, EOS, retire)."""
        for s in sorted(info):
            rid = self._slot_rid[s]
            if rid is None:
                continue
            entry = info[s]
            if entry[0] == "first_sample":
                self._deliver_tokens(s, [int(toks[s, 0])])
                continue
            _, pos0, draft = entry
            a = min(int(accepted[s]), len(draft))
            committed = pos0 + a + 1        # carry + accepted drafts
            self.spec.note_verify(len(draft), a)
            if a < len(draft):
                # a page that exists only for rejected positions is
                # stranded: free it now
                keep = max(self.mgr.pages_for(committed),
                           int(self._reserved[s]))
                freed = self.mgr.truncate_pages(rid, keep)
                tbl = self.mgr.sequence_pages(rid)
                self._bt[s] = 0
                self._bt[s, :len(tbl)] = tbl
                self.spec.note_rollback(len(freed))
                emit_event("spec_rollback", request_id=rid,
                           trace_id=self._live[rid].trace_id,
                           drafted=len(draft), accepted=a,
                           freed_pages=len(freed))
            self._pos[s] = committed
            self.mgr._lens[rid] = committed
            self._deliver_tokens(
                s, [int(t) for t in draft[:a]] + [int(toks[s, a])])

    def _step_spec(self, params) -> int:
        """One speculative round: host admission, drafting and page
        growth, ONE dispatch whose epilogue verifies every row's draft,
        host commit and rollback. The one device->host copy is the
        (slots, k+2) candidate tokens and accepted counts."""
        self._admit_rows()
        if not self._live:
            return 0
        self._spec_step = prog = self._fetch(
            self._spec_step, "cbe.spec_step",
            (self.num_slots, self._spec_tokens, self.spec_k,
             self._table_width, self._fused_tail, 1, self._epilogue_on),
            self._build_spec_step, params)
        armed_chain = _chain_armed[0]
        tc0 = time.perf_counter_ns() if armed_chain else 0
        if self._fused_tail:
            from ..jit.fusion import pack_spec_plan
            T, n_rows, k1 = (self._spec_tokens, self.num_slots,
                             self.spec_k + 1)
            kd = max(self.spec_k, 1)
            plan = dict(ids=np.zeros((T,), np.int32),
                        token_row=np.zeros((T,), np.int32),
                        positions=np.zeros((T,), np.int32),
                        decoding=np.zeros((T,), bool),
                        kv_lens=np.zeros((n_rows,), np.int32),
                        cand_idx=np.zeros((n_rows * k1,), np.int32),
                        drafts=np.zeros((n_rows, kd), np.int32),
                        draft_len=np.zeros((n_rows,), np.int32),
                        sampled=np.zeros((n_rows,), bool))
            info, fed = self._plan_spec(plan)
            prog.host["plan_tt"][:], prog.host["plan_tr"][:] = \
                pack_spec_plan(spec_k=self.spec_k, **plan)
        else:
            info, fed = self._plan_spec(prog.host)
        if armed_chain:
            tc1 = time.perf_counter_ns()
            _note_chain(op_name="cbe.plan_step", dur_ns=tc1 - tc0)
            tc0 = tc1
        prog.host["bt"][:] = self._bt
        self._prefill_tokens += sum(fed)
        t0_ns = time.perf_counter_ns() if spans_armed() else 0
        out = self._run("cbe.spec_step", prog).cpu().numpy()   # the fence
        if armed_chain:
            tc1 = time.perf_counter_ns()
            _note_chain(op_name="cbe.spec_step", dur_ns=tc1 - tc0)
            if self._epilogue_active():
                _note_chain(op_name="cbe.sample_epilogue", dur_ns=0)
            tc0 = tc1
        self.spec_rounds += 1
        if t0_ns:
            t1_ns = time.perf_counter_ns()
            batch = []
            for s in range(self.num_slots):
                rid = self._slot_rid[s]
                if rid is None:
                    continue
                req = self._live[rid]
                if fed[s] > 0:
                    batch.append(make_span(
                        "engine.prefill", t0_ns, t1_ns, "Operator",
                        req.trace_id,
                        args={"request_id": rid, "slot": s,
                              "prefill_tokens": int(fed[s])}))
                if info.get(s, ("",))[0] == "spec":
                    batch.append(make_span(
                        "engine.spec_round", t0_ns, t1_ns, "Operator",
                        req.trace_id,
                        args={"request_id": rid, "slot": s,
                              "drafted": len(info[s][2])}))
            emit_spans(batch)
        self._verify_spec(out[:, :-1], info, out[:, -1])
        if armed_chain:
            _note_chain(op_name="cbe.decode_tail",
                        dur_ns=time.perf_counter_ns() - tc0)
        return len(self._live)

    # -- results -------------------------------------------------------------

    def collect(self) -> Dict[int, list]:
        out = self._finished
        self._finished = {}
        return out

    def finished_checksum(self, rid: int) -> Optional[int]:
        """crc32 of the tokens ``_retire`` produced for ``rid`` (None if
        the request never finished, e.g. cancelled). Survives
        ``collect()``."""
        return self._finished_crc.get(rid)

    def serve(self, params, prompts) -> list:
        """Stream a list of prompts through the fixed slots; returns the
        generated token lists in submission order."""
        rids = [self.submit(p) for p in prompts]
        results: Dict[int, list] = {}
        while len(results) < len(rids):
            self.step(params)
            results.update(self.collect())
            if not self._live and not self._queue and \
                    len(results) < len(rids):
                raise RuntimeError("serve stalled with pending requests")
        return [results[r] for r in rids]
