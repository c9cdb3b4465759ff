"""Continuous-batching serving engine — counterpart of
``paddle_tpu/inference/decoding.py`` (the unified greedy path).

``ContinuousBatchingEngine`` keeps ``num_slots`` sequences decoding
together over the paged KV cache. Each ``step()`` is one round of
``chunk`` micro-rounds of ``models.llama.ragged_step``: prefill chunks
of newly admitted prompts and every decoding row ride the same packed
token axis, so a prompt submitted mid-decode joins the current step.
The greedy token carry stays on the device between micro-rounds, and
the step's emitted ``(chunk, slots)`` tokens are its ONE device→host
copy.

Not in this slice (each raises ``NotImplementedError``): the prefix
cache, speculative decoding, the legacy bucketed pipeline
(``unified=False``), the fused decode tail, multi-chip meshes,
per-request sampling and grammar-constrained decoding. The
observability taps (spans, memory ledger, recompile counter) come with
the observability slice.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import llama as L
from ..ops._common import resolve_device
from ..ops.paged_attention import PagedKVCacheManager
from .sampling import greedy_rows


def token_checksum(tokens) -> int:
    """crc32 over the int32 little-endian bytes of a token sequence (the
    JAX package's ``observability.journal.token_checksum``)."""
    a = np.asarray(list(tokens), np.int32)
    return zlib.crc32(a.astype("<i4").tobytes()) & 0xFFFFFFFF


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the {slice_name} slice "
        "of the PyTorch/CUDA port")


@dataclass
class GenerationConfig:
    """Greedy generation settings; ``do_sample=True`` (and the sampling
    knobs that go with it) comes with the sampling slice."""
    max_new_tokens: int = 32
    do_sample: bool = False   # False = greedy
    eos_token_id: Optional[int] = None


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    tokens: list = field(default_factory=list)
    max_new_tokens: Optional[int] = None  # None -> engine config default


class ContinuousBatchingEngine:
    """Fixed-slot continuous batching over the paged KV cache, one
    ragged dispatch per micro-round.

    Service API: ``submit(prompt) -> rid``; ``step(params)`` runs one
    admit + ``chunk`` micro-rounds; ``collect()`` drains finished
    requests; ``serve(params, prompts)`` streams a whole list through.
    ``device=None`` means the card (raises without one); the CPU runs
    only when asked for with ``device="cpu"``.
    """

    def __init__(self, model_config: L.LlamaConfig,
                 generation_config: Optional[GenerationConfig] = None,
                 num_slots: int = 8, page_size: int = 16,
                 max_seq_len: int = 2048, num_pages: Optional[int] = None,
                 chunk: int = 16, step_tokens: Optional[int] = None,
                 device=None, *, prefix_cache: bool = False,
                 unified: bool = True, speculative: bool = False,
                 fused_tail: bool = False, mesh=None):
        if prefix_cache:
            raise _later("prefix_cache=True", "prefix-cache")
        if speculative:
            raise _later("speculative=True", "speculative-decoding")
        if not unified:
            raise _later("unified=False (the legacy bucketed pipeline)",
                         "legacy-engine")
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
        self._table_width = PagedKVCacheManager.pages_needed(max_seq_len,
                                                             page_size)
        # pool sized for every slot at max length unless told otherwise
        pool = num_pages or (num_slots * self._table_width + 1)
        mcfg = model_config
        self.mgr = PagedKVCacheManager(
            mcfg.num_hidden_layers, pool, page_size,
            mcfg.num_key_value_heads, mcfg.head_dim, dtype=mcfg.dtype,
            device=self.device)
        # packed token budget per micro-round
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
        #: micro-rounds dispatched (each runs every kernel of the step)
        self.micro_rounds = 0

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
        """Pop queued requests into free slots and allocate their pages.
        Admission is atomic over the window: if anything raises, every
        picked allocation is freed and the requests go back to the head
        of the queue in order."""
        picked = []                # (slot, req, pages_row, prompt_len)
        try:
            self._admit_window(picked)
        except BaseException:
            for _, req, _, _ in reversed(picked):
                self.mgr.free(req.rid)
                self._queue.insert(0, req)
            raise
        return picked

    def _admit_window(self, picked):
        for s in range(self.num_slots):
            if self._slot_rid[s] is not None or not self._queue:
                continue
            req = self._queue[0]
            lp = len(req.prompt)
            total = lp + self._budget(req)       # submit() bounds this
            need = self.mgr.pages_for(total)
            if self.mgr.num_free_pages < need:
                if not self._live and not picked \
                        and need > self.mgr.usable_pages:
                    raise MemoryError(
                        f"request {req.rid} needs {need} pages but the "
                        f"pool only holds {self.mgr.usable_pages}; "
                        "enlarge num_pages")
                break                    # pool full: wait for a completion
            pages = self.mgr.allocate(req.rid, total)
            picked.append((s, req, pages, lp))
            self._queue.pop(0)
            self.mgr._lens[req.rid] = lp

    def _complete(self, req: _Request) -> bool:
        if len(req.tokens) >= self._budget(req):
            return True
        eos = self.config.eos_token_id
        return eos is not None and bool(req.tokens) \
            and req.tokens[-1] == eos

    def _retire(self, s: int, cancelled: bool = False) -> None:
        """Free a finished (or cancelled) slot: pages back to the pool,
        output to the finished map, the slot's table back to page 0."""
        rid = self._slot_rid[s]
        req = self._live.pop(rid)
        if not cancelled:
            out = req.tokens[:self._budget(req)]
            self._finished[rid] = out
            self._finished_crc[rid] = token_checksum(out)
        self.mgr.free(rid)
        self._slot_rid[s] = None
        self._bt[s] = 0
        self._pos[s] = 0
        self._pend[s] = None

    def _deliver_tokens(self, s: int, tokens) -> None:
        """Append one slot's emitted tokens to its request (up to its
        budget or EOS) and retire the slot when the request completes."""
        req = self._live[self._slot_rid[s]]
        for t in tokens:
            req.tokens.append(int(t))
            if self._complete(req):
                self._retire(s)
                return

    # -- the unified ragged step ---------------------------------------------

    def _plan_step(self):
        """Host-side layout of one step: simulate ``chunk`` micro-rounds
        over the live slots, packing each round's tokens into the fixed
        ``step_tokens`` axis. Decode rows claim one slot each; prefill
        rows share the rest of the budget in slot order and turn into
        decode rows the round after their prompt completes. Advances
        the slot mirrors (positions, pending prompt suffixes)."""
        K, tb, n_rows = self.chunk, self._step_tokens, self.num_slots
        ids = np.zeros((K, tb), np.int32)
        use_carry = np.zeros((K, tb), bool)
        token_row = np.full((K, tb), -1, np.int32)
        positions = np.zeros((K, tb), np.int32)
        kv_lens = np.zeros((K, n_rows), np.int32)
        last_idx = np.zeros((K, n_rows), np.int32)
        sample_mask = np.zeros((K, n_rows), bool)
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
        return (ids, use_carry, token_row, positions, kv_lens, last_idx,
                sample_mask), emit

    @torch.no_grad()
    def _run_micro_rounds(self, params, ids, use_carry, token_row,
                          positions, kv_lens, last_idx, sample_mask, bt):
        """The step's ``chunk`` micro-rounds (the JAX package's one
        compiled ``lax.scan``). Decode slots take their row's carry
        token, prefill slots the host-fed prompt tokens; each round
        emits its INPUT carry, then updates the carry of the rows that
        sampled. Returns the (K, R) emitted tokens, still on device."""
        n_rows = self.num_slots
        tok = self._tok_dev
        emitted = []
        for k in range(self.chunk):
            row_c = token_row[k].long().clamp(0, n_rows - 1)
            ids_eff = torch.where(use_carry[k], tok[row_c], ids[k])
            logits, _, _ = L.ragged_step(
                params, ids_eff, token_row[k], positions[k], kv_lens[k],
                last_idx[k], self.mgr.k_pages, self.mgr.v_pages, bt,
                self.model_config)
            nxt = greedy_rows(logits)
            emitted.append(tok)
            tok = torch.where(sample_mask[k], nxt, tok)
            self.micro_rounds += 1
        self._tok_dev = tok
        return torch.stack(emitted)

    def step(self, params) -> int:
        """One admit + ragged round. Admission is host bookkeeping; the
        round uploads its plan once, runs ``chunk`` micro-rounds on the
        device, and copies the emitted tokens back once. Returns the
        live count after the round."""
        for s, req, pages, lp in self._admit_pick():
            self._slot_rid[s] = req.rid
            self._live[req.rid] = req
            self._pos[s] = 0                  # next position to write
            self._bt[s] = 0
            self._bt[s, :len(pages)] = pages
            self._pend[s] = np.asarray(req.prompt, np.int32)
        if not self._live:
            return 0
        plan, emit = self._plan_step()
        dev = [torch.from_numpy(a).to(self.device)
               for a in (*plan, self._bt)]
        toks = self._run_micro_rounds(params, *dev).cpu().numpy()  # the fence
        for s in range(self.num_slots):
            if self._slot_rid[s] is None:
                continue
            self._deliver_tokens(
                s, (toks[k, s] for k in range(self.chunk) if emit[k, s]))
        return len(self._live)

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
