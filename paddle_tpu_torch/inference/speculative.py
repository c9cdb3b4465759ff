"""Speculative decoding: drafters and verification bookkeeping for the
unified ragged step — counterpart of
``paddle_tpu/inference/speculative.py``.

The engine side lives in ``decoding.ContinuousBatchingEngine``
(``speculative=True``); this module holds the policy:

* **Drafters**, where candidate tokens come from. The default is
  :class:`NgramDrafter`, prompt-lookup self-drafting (no second model):
  propose the tokens that followed the most recent earlier occurrence of
  the history's trailing n-gram. :class:`DraftModel` drafts with a small
  Llama; anything with ``draft(history, k) -> tokens`` plugs in.
* **Telemetry**: :class:`SpeculationTelemetry` declares the JAX
  package's ``paddle_spec_*`` registry families (with their ``replica``
  label) and keeps the plain mirror the engine reports.

Verifying k drafted tokens is a short prefill of k+1 tokens at
consecutive positions: the ragged kernel's mask rule
``key_pos <= position`` covers it, and taking the logits at every
candidate index turns the one dispatch into the verifier.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..observability.registry import get_registry


class Drafter:
    """Pluggable draft-token source for the speculative engine.

    ``draft(history, k)`` proposes up to ``k`` continuation tokens for a
    row whose committed tokens (prompt + generated, most recent last)
    are ``history``. Fewer than ``k`` (or none) is always legal. Drafters
    are pure host-side functions of the history, so a rejected draft
    leaves nothing to roll back outside the KV pool."""

    def draft(self, history: Sequence[int], k: int) -> List[int]:
        raise NotImplementedError


class NgramDrafter(Drafter):
    """Prompt-lookup self-drafting: the longest trailing n-gram of the
    history (``max_ngram`` down to ``min_ngram``) that also occurs
    earlier, its MOST RECENT earlier occurrence, and the ``k`` tokens that
    followed it."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"[{min_ngram}, {max_ngram}]")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def draft(self, history: Sequence[int], k: int) -> List[int]:
        h = np.asarray(history, np.int64)
        n_hist = len(h)
        if k <= 0 or n_hist < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, n_hist - 1),
                       self.min_ngram - 1, -1):
            pat = h[n_hist - n:]
            # every window of length n but the trailing pattern itself; a
            # match must leave >= 1 continuation token
            wins = np.lib.stride_tricks.sliding_window_view(h, n)[:-1]
            hits = np.nonzero((wins == pat).all(axis=1))[0]
            if len(hits):
                start = int(hits[-1]) + n          # most recent match
                return [int(t) for t in h[start:start + k]]
        return []


class DraftModel(Drafter):
    """Greedy-draft ``k`` tokens with a (small) stacked-param Llama of
    ``paddle_tpu_torch.models.llama``, cache-less over a right-padded
    ``window`` of the history: k forwards per draft, on the device of
    ``params``."""

    def __init__(self, params, config, window: int = 128):
        self.params = params
        self.config = config
        self.window = int(window)
        self._device = next(iter(params.values())).device

    @torch.no_grad()
    def draft(self, history: Sequence[int], k: int) -> List[int]:
        from ..models import llama as L
        out: List[int] = []
        for _ in range(max(0, k)):
            tail = [int(t) for t in history][-self.window:]
            tail = (tail + out)[-self.window:]
            ids = np.zeros((1, self.window), np.int64)
            ids[0, :len(tail)] = tail
            logits = L.forward_stacked(
                self.params, torch.from_numpy(ids).to(self._device),
                self.config)
            out.append(int(torch.argmax(logits[0, len(tail) - 1].float())))
        return out


class SpeculationTelemetry:
    """Registry families and host mirror of one engine's speculation
    (``stats``: rounds, drafted, accepted, rejected, rollbacks, rollback
    pages). The families' ``replica`` label is ``"0"``: the port serves
    one engine (the fleet tier that stamps replica ids is not ported)."""

    replica = "0"

    def __init__(self):
        self.stats: Dict[str, int] = {
            "rounds": 0, "drafted": 0, "accepted": 0, "rejected": 0,
            "rollbacks": 0, "rollback_pages": 0,
        }
        reg = get_registry()
        self._c_drafted = reg.counter(
            "paddle_spec_drafted_tokens_total",
            "draft tokens fed into speculative verification",
            labels=("replica",))
        self._c_accepted = reg.counter(
            "paddle_spec_accepted_tokens_total",
            "draft tokens verified equal to the greedy continuation",
            labels=("replica",))
        self._c_rejected = reg.counter(
            "paddle_spec_rejected_tokens_total",
            "draft tokens rejected (KV rolled back per row)",
            labels=("replica",))
        self._g_ratio = reg.gauge(
            "paddle_spec_acceptance_ratio",
            "cumulative accepted/drafted draft-token ratio",
            labels=("replica",))

    def note_verify(self, drafted: int, accepted: int) -> None:
        """Account one row's verify outcome (``accepted <= drafted``)."""
        self.stats["rounds"] += 1
        self.stats["drafted"] += drafted
        self.stats["accepted"] += accepted
        self.stats["rejected"] += drafted - accepted
        if drafted:
            self._c_drafted.inc(drafted, replica=self.replica)
            if accepted:
                self._c_accepted.inc(accepted, replica=self.replica)
            if drafted - accepted:
                self._c_rejected.inc(drafted - accepted,
                                     replica=self.replica)
            self._g_ratio.set(self.acceptance_ratio, replica=self.replica)

    def note_rollback(self, pages_freed: int) -> None:
        self.stats["rollbacks"] += 1
        self.stats["rollback_pages"] += pages_freed

    @property
    def acceptance_ratio(self) -> float:
        d = self.stats["drafted"]
        return self.stats["accepted"] / d if d else 0.0

    def snapshot(self) -> Dict[str, object]:
        out: Dict[str, object] = dict(self.stats)
        out["acceptance_ratio"] = round(self.acceptance_ratio, 4)
        return out
