"""Serving engines over the paged KV cache — counterpart of
``paddle_tpu/inference/decoding.py`` (the greedy paths).

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

The greedy token carry stays on the device between rounds, and a
step's emitted tokens are its ONE device→host copy.

Each pipeline runs its steps as the JAX engine's compiled programs, one
per fixed shape (``inference.graphs.Program``): the unified step
(``cbe.unified_step``, keyed by slots, chunk, step tokens and table
width), the legacy decode chunk (``cbe.decode_chunk``, slots and chunk)
and the legacy prefill waves (``cbe.prefill``, one per ``(bucket,
b_pad)`` or ``("sfx", bucket, b_pad)``). On the card each is a CUDA
graph captured at its first use and replayed after; on the CPU its body
runs eagerly over the same buffers. Every build is a counted miss
(``compile_misses``), as ``recompiles.record_miss`` counts the JAX
engine's.

``prefix_cache=True`` (both pipelines) shares the resident pages of
earlier prompts through ``paddle_tpu_torch.kvcache`` and prefills only
each request's uncached suffix; the page books are audited after every
step. ``PagedGenerationEngine`` generates a ragged batch in one call
(prefill, then decode steps) over the same model functions.

Not in this slice (each raises ``NotImplementedError``): speculative
decoding, the fused decode tail, multi-chip meshes, per-request
sampling and grammar-constrained decoding. The observability taps
(spans, memory ledger, recompile counter) come with the observability
slice.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kvcache import PrefixCache, RefcountedKVCacheManager
from ..models import llama as L
from ..ops._common import not_ported as _later, resolve_device
from ..ops.paged_attention import PagedKVCacheManager
from .graphs import GraphPool, Program, params_key
from .sampling import greedy_rows


def token_checksum(tokens) -> int:
    """crc32 over the int32 little-endian bytes of a token sequence (the
    JAX package's ``observability.journal.token_checksum``)."""
    a = np.asarray(list(tokens), np.int32)
    return zlib.crc32(a.astype("<i4").tobytes()) & 0xFFFFFFFF


@dataclass
class GenerationConfig:
    """Greedy generation settings; ``do_sample=True`` (and the sampling
    knobs that go with it) comes with the sampling slice."""
    max_new_tokens: int = 32
    do_sample: bool = False   # False = greedy
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0


def _bucket(n: int, minimum: int = 16) -> int:
    """Prompt-length bucket of the legacy prefill: the next power of two
    from ``minimum`` up."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _last_logits(logits, seq_len):
    """(B, T, V) prefill logits -> (B, V) at each row's last real token."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, seq_len.long() - 1]


class PagedGenerationEngine:
    """Ragged-batch generation over the paged KV cache (greedy): prompts
    of different lengths each own pages through a block table, decode
    positions advance per row, and generation starts from each row's own
    last prompt token. ``generate`` runs one prefill, then
    ``max_new_tokens - 1`` decode steps."""

    def __init__(self, model_config: L.LlamaConfig,
                 generation_config: Optional[GenerationConfig] = None,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 device=None):
        self.model_config = model_config
        self.config = generation_config or GenerationConfig()
        if self.config.do_sample:
            raise _later("do_sample=True", "sampling")
        self.page_size = page_size
        self._num_pages = num_pages
        self.device = resolve_device(device)

    @torch.no_grad()
    def generate(self, params, prompts) -> np.ndarray:
        """prompts: list of 1-D int arrays (ragged) -> (B, max_new_tokens)
        int32 tokens."""
        cfg, mcfg = self.config, self.model_config
        lens = [len(p) for p in prompts]
        b = len(prompts)
        ids = np.full((b, _bucket(max(lens))), cfg.pad_token_id, np.int32)
        for i, p in enumerate(prompts):
            ids[i, :len(p)] = np.asarray(p, np.int32)
        total = [n + cfg.max_new_tokens for n in lens]
        num_pages = self._num_pages or (sum(
            PagedKVCacheManager.pages_needed(n, self.page_size)
            for n in total) + 1)
        mgr = PagedKVCacheManager(
            mcfg.num_hidden_layers, num_pages, self.page_size,
            mcfg.num_key_value_heads, mcfg.head_dim, dtype=mcfg.dtype,
            device=self.device)
        for i in range(b):
            mgr.allocate(i, total[i])
            mgr._lens[i] = lens[i]   # the prompt is the live length
        bt, seq_lens = (torch.from_numpy(a).to(self.device)
                        for a in mgr.block_tables(list(range(b))))
        logits, _, _ = L.prefill_paged(
            params, torch.from_numpy(ids).to(self.device), seq_lens,
            mgr.k_pages, mgr.v_pages, bt, mcfg)
        tok = greedy_rows(_last_logits(logits, seq_lens))
        toks = []
        for i in range(cfg.max_new_tokens - 1):
            lg, _, _ = L.decode_step_paged(params, tok, seq_lens + i,
                                           mgr.k_pages, mgr.v_pages, bt,
                                           mcfg)
            toks.append(tok)
            tok = greedy_rows(lg)
        toks.append(tok)
        return torch.stack(toks, dim=1).cpu().numpy()


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    tokens: list = field(default_factory=list)
    max_new_tokens: Optional[int] = None  # None -> engine config default


class ContinuousBatchingEngine:
    """Fixed-slot continuous batching over the paged KV cache (module
    docstring for the two pipelines).

    Service API: ``submit(prompt) -> rid``; ``step(params)`` runs one
    admit + ``chunk`` rounds; ``collect()`` drains finished requests;
    ``serve(params, prompts)`` streams a whole list through.
    ``device=None`` means the card (raises without one); the CPU runs
    only when asked for with ``device="cpu"``.

    Compiled programs (module docstring): the JAX engine's jit takes the
    params as an argument and never rebuilds for new weights; a CUDA
    graph reads its weights at the addresses it captured, so here a
    program is rebuilt (a counted miss) when ``step()`` is given params
    that are not the tensors it was built over.
    """

    def __init__(self, model_config: L.LlamaConfig,
                 generation_config: Optional[GenerationConfig] = None,
                 num_slots: int = 8, page_size: int = 16,
                 max_seq_len: int = 2048, num_pages: Optional[int] = None,
                 chunk: int = 16, step_tokens: Optional[int] = None,
                 device=None, *, prefix_cache: bool = False,
                 unified: bool = True, speculative: bool = False,
                 fused_tail: bool = False, mesh=None):
        if speculative:
            raise _later("speculative=True", "speculative-decoding")
        if fused_tail:
            raise _later("fused_tail=True", "fusion")
        if mesh is not None:
            raise _later("mesh= (multi-chip serving)", "multi-chip")
        self.config = generation_config or GenerationConfig()
        if self.config.do_sample:
            raise _later("do_sample=True", "sampling")
        self.device = resolve_device(device)
        self.model_config = model_config
        self.num_slots = num_slots
        self.page_size = page_size
        self.chunk = chunk
        self.max_seq_len = max_seq_len
        self._unified = unified
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
        #: prompt tokens actually run through prefill (cache hits skip
        #: their cached prefix)
        self._prefill_tokens = 0
        #: unified micro-rounds dispatched (each runs every kernel of the
        #: ragged step)
        self.micro_rounds = 0
        #: legacy prefill waves and decode steps run
        self.prefill_calls = 0
        self.decode_steps = 0
        # compiled programs, cached as the JAX engine caches its jits
        self._unified_step: Optional[Program] = None
        self._decode_chunk: Optional[Program] = None
        self._compiled_prefill: Dict[tuple, Program] = {}
        #: program builds, in order: (name, key), as the JAX engine
        #: passes them to ``recompiles.record_miss``
        self.compile_misses: List[Tuple[str, tuple]] = []
        #: seconds of each program's first call (eager run and capture,
        #: to completion), summed by name (``recompiles.observe_compile``)
        self.compile_seconds: Dict[str, float] = {}
        #: of those, the CUDA graph captures alone
        self.capture_seconds: Dict[str, float] = {}
        # card runs capture CUDA graphs; False runs every program's body
        # eagerly (the eager card run the tests compare against)
        self._graphs = True
        self._graph_pool: Optional[GraphPool] = None

    # -- compiled programs --------------------------------------------------

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
        return build(params)

    def _run(self, name: str, prog: Program) -> torch.Tensor:
        """Call ``prog``; its first call is timed to completion into
        ``compile_seconds`` and ``capture_seconds``."""
        if prog.calls:
            return prog()
        t0 = time.perf_counter()
        out = prog()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for book, sec in ((self.compile_seconds, time.perf_counter() - t0),
                          (self.capture_seconds, prog.capture_seconds)):
            book[name] = book.get(name, 0.0) + sec
        return out

    def _build_unified_step(self, params) -> Program:
        """ONE program for every unified step: ``chunk`` micro-rounds of
        ``models.llama.ragged_step`` (the JAX engine's one ``lax.scan``).
        Decode slots take their row's carry token, prefill slots the
        host-fed prompt tokens; each round emits its INPUT carry, then
        updates the carry of the rows that sampled. Shapes depend only on
        (slots, chunk, step_tokens, table width). Returns the (K, R)
        emitted tokens; the carry ``_tok_dev`` is updated in place."""
        K, tb, n_rows = self.chunk, self._step_tokens, self.num_slots
        mgr, mcfg, carry = self.mgr, self.model_config, self._tok_dev
        i32, b8 = torch.int32, torch.bool
        inputs = dict(ids=((K, tb), i32), use_carry=((K, tb), b8),
                      token_row=((K, tb), i32), positions=((K, tb), i32),
                      kv_lens=((K, n_rows), i32), last_idx=((K, n_rows), i32),
                      sample_mask=((K, n_rows), b8),
                      bt=((n_rows, self._table_width), i32))

        def run(ids, use_carry, token_row, positions, kv_lens, last_idx,
                sample_mask, bt):
            tok = carry
            emitted = []
            for k in range(K):
                row_c = token_row[k].long().clamp(0, n_rows - 1)
                ids_eff = torch.where(use_carry[k], tok[row_c], ids[k])
                logits, _, _ = L.ragged_step(
                    params, ids_eff, token_row[k], positions[k], kv_lens[k],
                    last_idx[k], mgr.k_pages, mgr.v_pages, bt, mcfg)
                emitted.append(tok)
                tok = torch.where(sample_mask[k], greedy_rows(logits), tok)
            out = torch.stack(emitted)
            carry.copy_(tok)
            return out

        return self._program(run, inputs, params)

    def _build_prefill(self, bucket: int, b_pad: int, params) -> Program:
        """A legacy prefill wave of ``b_pad`` rows padded to ``bucket``
        tokens (``models.llama.prefill_paged``). Returns each row's greedy
        first token."""
        mgr, mcfg, i32 = self.mgr, self.model_config, torch.int32
        inputs = dict(ids=((b_pad, bucket), i32), lens=((b_pad,), i32),
                      rows=((b_pad, self._table_width), i32))

        def run(ids, lens, rows):
            logits, _, _ = L.prefill_paged(params, ids, lens, mgr.k_pages,
                                           mgr.v_pages, rows, mcfg)
            return greedy_rows(_last_logits(logits, lens))

        return self._program(run, inputs, params)

    def _build_prefill_suffix(self, bucket: int, b_pad: int,
                              params) -> Program:
        """The prefill of prefix-cache hits' UNCACHED SUFFIX only
        (``models.llama.prefill_paged_suffix``): each row's leading
        ``starts`` tokens are already resident in shared pages."""
        mgr, mcfg, i32 = self.mgr, self.model_config, torch.int32
        inputs = dict(ids=((b_pad, bucket), i32), lens=((b_pad,), i32),
                      starts=((b_pad,), i32),
                      rows=((b_pad, self._table_width), i32))

        def run(ids, lens, starts, rows):
            logits, _, _ = L.prefill_paged_suffix(
                params, ids, lens, starts, mgr.k_pages, mgr.v_pages, rows,
                mcfg)
            return greedy_rows(_last_logits(logits, lens))

        return self._program(run, inputs, params)

    def _build_decode_chunk(self, params) -> Program:
        """``chunk`` decode steps over every slot (idle slots decode at
        position 0 into page 0; finished rows run to the chunk's end and
        their extra tokens are dropped). Each step emits its INPUT token,
        so a chunk's output chains to the next and delivers each
        admission's prefill token first. Returns (slots, chunk) tokens;
        the carry ``_tok_dev`` is updated in place."""
        K, n_rows = self.chunk, self.num_slots
        mgr, mcfg, carry = self.mgr, self.model_config, self._tok_dev
        inputs = dict(pos=((n_rows,), torch.int32),
                      bt=((n_rows, self._table_width), torch.int32))

        def run(pos, bt):
            tok = carry
            emitted = []
            for _ in range(K):
                logits, _, _ = L.decode_step_paged(
                    params, tok, pos, mgr.k_pages, mgr.v_pages, bt, mcfg)
                emitted.append(tok)
                tok = greedy_rows(logits)
                pos = pos + 1
            out = torch.stack(emitted, dim=1)
            carry.copy_(tok)
            return out

        return self._program(run, inputs, params)

    # -- service API --------------------------------------------------------

    def _budget(self, req: _Request) -> int:
        """Per-request new-token budget (submit() override or config)."""
        return (req.max_new_tokens if req.max_new_tokens is not None
                else self.config.max_new_tokens)

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               sampler=None, grammar=None, grammar_prefix=None) -> int:
        """Queue a greedy request; returns its id."""
        if sampler is not None:
            raise _later("sampler= (per-request sampling)", "sampling")
        if grammar is not None or grammar_prefix is not None:
            raise _later("grammar= (constrained decoding)", "sampling")
        budget = (max_new_tokens if max_new_tokens is not None
                  else self.config.max_new_tokens)
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) + budget > self.max_seq_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens + max_new_tokens="
                f"{budget} exceeds the engine's "
                f"max_seq_len={self.max_seq_len}; raise max_seq_len or "
                "truncate the prompt (silent page clamping would corrupt "
                "the sequence's KV)")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Request(rid, prompt,
                                    max_new_tokens=max_new_tokens))
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
        for n_cached, cow_src in recorded:
            self.cache.record(n_cached, cow=cow_src is not None)
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
            if self.cache is not None:
                recorded.append((n_cached, cow_src))

    def _complete(self, req: _Request) -> bool:
        if len(req.tokens) >= self._budget(req):
            return True
        eos = self.config.eos_token_id
        return eos is not None and bool(req.tokens) \
            and req.tokens[-1] == eos

    def _retire(self, s: int, cancelled: bool = False) -> None:
        """Free a finished (or cancelled) slot: with the cache, index the
        finished prefix first (pages backing its full token blocks stay
        resident); then pages back to the pool, output to the finished
        map, the slot's table back to page 0."""
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
                self.cache.insert(toks, self.mgr.sequence_pages(rid))
        self.mgr.free(rid)
        self._slot_rid[s] = None
        self._bt[s] = 0
        self._pos[s] = 0
        self._pend[s] = None

    def _deliver_tokens(self, s: int, tokens) -> bool:
        """Append one slot's emitted tokens to its request (up to its
        budget or EOS) and retire the slot when the request completes.
        Returns True while the slot keeps decoding."""
        req = self._live[self._slot_rid[s]]
        for t in tokens:
            req.tokens.append(int(t))
            if self._complete(req):
                self._retire(s)
                return False
        return True

    def step(self, params) -> int:
        """One admit + decode round (ONE device->host copy: the step's
        emitted tokens). Returns the live count after the round. With
        the prefix cache, the page books are audited after every round
        (every page is free, live or cached: the anchor of the
        shared-ownership model)."""
        if self._unified:
            n = self._step_unified(params)
        else:
            n = self._step_legacy(params)
        if self.cache is not None:
            self.mgr.check_conservation()
            self.cache.update_gauges()
        return n

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
                           ("token_row", -1), ("positions", 0),
                           ("kv_lens", 0), ("last_idx", 0),
                           ("sample_mask", False)):
            plan[name].fill(fill)
        ids, use_carry, token_row, positions = (
            plan[n] for n in ("ids", "use_carry", "token_row", "positions"))
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

    def _step_unified(self, params) -> int:
        """One admit + ragged round. Admission is host bookkeeping (a
        warm/COW row is just a row whose first position is its cached
        length); the round uploads its plan once, runs the unified
        program's ``chunk`` micro-rounds on the device, and copies the
        emitted tokens back once."""
        for s, req, pages, lp, n_cached in self._admit_pick():
            self._slot_rid[s] = req.rid
            self._live[req.rid] = req
            self._pos[s] = n_cached           # next position to write
            self._bt[s] = 0
            self._bt[s, :len(pages)] = pages
            self._pend[s] = np.asarray(req.prompt[n_cached:], np.int32)
        if not self._live:
            return 0
        self._unified_step = prog = self._fetch(
            self._unified_step, "cbe.unified_step",
            (self.num_slots, self.chunk, self._step_tokens,
             self._table_width), self._build_unified_step, params)
        emit, fed = self._plan_step(prog.host)
        prog.host["bt"][:] = self._bt
        self._prefill_tokens += sum(fed)
        toks = self._run("cbe.unified_step", prog).cpu().numpy()  # the fence
        self.micro_rounds += self.chunk
        for s in range(self.num_slots):
            if self._slot_rid[s] is None:
                continue
            self._deliver_tokens(
                s, (toks[k, s] for k in range(self.chunk) if emit[k, s]))
        return len(self._live)

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
        first tokens go into the carry in place."""
        cfg = self.config
        groups: Dict[tuple, list] = {}
        for item in self._admit_pick():
            lp, n_cached = item[3], item[4]
            groups.setdefault((_bucket(lp - n_cached), n_cached > 0),
                              []).append(item)
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
            for i, (s, req, pages, lp, nc) in enumerate(items):
                host["ids"][i, :lp - nc] = req.prompt[nc:]
                host["rows"][i, :len(pages)] = pages
                host["lens"][i] = lp - nc
                if warm:
                    host["starts"][i] = nc
            tok = self._run("cbe.prefill", prog)
            self.prefill_calls += 1
            self._prefill_tokens += int(sum(it[3] - it[4] for it in items))
            slots = torch.as_tensor([it[0] for it in items],
                                    device=self.device)
            self._tok_dev[slots] = tok[:real]
            for i, (s, req, pages, lp, nc) in enumerate(items):
                self._slot_rid[s] = req.rid
                self._live[req.rid] = req
                self._pos[s] = lp
                self._bt[s] = host["rows"][i]

    def _step_legacy(self, params) -> int:
        self._admit(params)
        if not self._live:
            return 0
        self._decode_chunk = prog = self._fetch(
            self._decode_chunk, "cbe.decode_chunk",
            (self.num_slots, self.chunk), self._build_decode_chunk, params)
        prog.host["pos"][:] = self._pos
        prog.host["bt"][:] = self._bt
        toks = self._run("cbe.decode_chunk", prog).cpu().numpy()  # the fence
        self.decode_steps += self.chunk
        for s in range(self.num_slots):
            if self._slot_rid[s] is None:
                continue
            if self._deliver_tokens(s, toks[s]):
                self._pos[s] += self.chunk
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
