"""Beam-search decoding — counterpart of ``paddle_tpu/nn/decode.py``:
``BeamSearchDecoder``, ``dynamic_decode`` and ``gather_tree``.

The reference's ``lax.scan`` over ``max_step_num`` is a loop of that
fixed trip count here: there is no early exit, so the outputs have the
reference's shapes, and finished beams are masked (they may only extend
with ``end_token``, at zero cost). Beams ride the batch axis as
``batch*beam``. The beam choice is the reference's ``lax.top_k``: the
best ``beam_size`` candidates, the lower flat index first among equal
scores (a stable sort). The cell sees ``core.tensor.Tensor``s, as the
reference's does; the decoder keeps its state as torch tensors.

Decoder protocol (paddle's): ``initialize(inits) -> (inputs, states,
finished)``; ``step(time, inputs, states) -> (outputs, next_states,
next_inputs, finished)``; ``finalize(outputs, final_states, lengths) ->
(final_outputs, final_states)``.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Callable, Optional

import torch

from ..core.tensor import Tensor

__all__ = ["BeamSearchDecoder", "dynamic_decode", "gather_tree"]

_NEG_INF = -1e9

BeamSearchOutput = namedtuple("BeamSearchOutput",
                              ["scores", "predicted_ids", "parent_ids"])
BeamSearchState = namedtuple("BeamSearchState",
                             ["cell_states", "log_probs", "finished",
                              "lengths"])


def _v(x):
    return x._value if isinstance(x, Tensor) else x


def _tree_map(fn, tree):
    """``fn`` over the leaves of nested tuples, lists, namedtuples and
    dicts (None stays None)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, t) for k, t in tree.items()}
    return None if tree is None else fn(tree)


def _unwrap(tree):
    return _tree_map(_v, tree)


def _wrap(tree):
    """Torch leaves as Tensors that stop gradients, as the reference's
    ``Tensor(v)`` wraps its arrays."""
    return _tree_map(lambda v: Tensor(v) if isinstance(v, torch.Tensor)
                     else v, tree)


def _leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def gather_tree(ids, parents):
    """Backtrack beam-search histories: ``ids``/``parents`` are
    time-major ``(T, batch, beam)``; output ``[:, b, k]`` is the tokens
    of the beam that ends at slot ``k``."""
    ids_v, par_v = _v(ids), _v(parents)
    t, b, k = ids_v.shape
    beam = torch.arange(k, dtype=par_v.dtype,
                        device=par_v.device).expand(b, k)
    outs = [None] * t
    for i in range(t - 1, -1, -1):
        outs[i] = torch.gather(ids_v[i], -1, beam.long())
        beam = torch.gather(par_v[i], -1, beam.long())
    res = torch.stack(outs)
    return Tensor(res) if isinstance(ids, Tensor) else res


def _top_k(flat, k):
    """``lax.top_k``: the ``k`` largest per row, the lower index first
    among equal values."""
    vals, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class BeamSearchDecoder:
    """Beam-search stepper over an RNN-style ``cell``: ``cell(inputs,
    states) -> (outputs, next_states)`` with inputs ``(batch*beam, ...)``;
    ``embedding_fn`` maps token ids to the next step's inputs;
    ``output_fn`` (optional) maps cell outputs to vocabulary logits."""

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn: Optional[Callable] = None,
                 output_fn: Optional[Callable] = None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    # -- helpers -------------------------------------------------------------
    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size: int):
        """(batch, ...) -> (batch*beam, ...) by repeating each row."""
        out = torch.repeat_interleave(_v(x), beam_size, dim=0)
        return Tensor(out) if isinstance(x, Tensor) else out

    def _merge(self, v):                       # (batch, beam, ...) -> (B*K,)
        return v.reshape((-1,) + tuple(v.shape[2:]))

    def _split(self, v):                       # (B*K, ...) -> (batch, beam)
        return v.reshape((-1, self.beam_size) + tuple(v.shape[1:]))

    def _gather_beams(self, tree, parent):
        """Reorder (batch*beam, ...) leaves by the (batch, beam) parent."""
        def one(v):
            s = self._split(v)
            idx = parent.reshape(tuple(parent.shape) + (1,) * (s.dim() - 2))
            idx = idx.expand(tuple(parent.shape) + tuple(s.shape[2:]))
            return self._merge(torch.gather(s, 1, idx))
        return _tree_map(one, tree)

    def _embed(self, ids):
        t = Tensor(ids)
        return self.embedding_fn(t) if self.embedding_fn else t

    # -- protocol ------------------------------------------------------------
    def initialize(self, initial_cell_states):
        """Tile cell states across beams; beam 0 starts live (log-prob 0),
        the rest at −1e9 so the first step picks no duplicate beams."""
        cell_states = _tree_map(
            lambda v: torch.repeat_interleave(v, self.beam_size, dim=0),
            _unwrap(initial_cell_states))
        first = _leaves(cell_states)[0]
        batch, dev = first.shape[0] // self.beam_size, first.device
        log_probs = torch.full((batch, self.beam_size), _NEG_INF,
                               dtype=torch.float32, device=dev)
        log_probs[:, 0] = 0.0
        finished = torch.zeros((batch, self.beam_size), dtype=torch.bool,
                               device=dev)
        lengths = torch.zeros((batch, self.beam_size), dtype=torch.int32,
                              device=dev)
        start = torch.full((batch * self.beam_size,), self.start_token,
                           dtype=torch.int32, device=dev)
        state = BeamSearchState(cell_states, log_probs, finished, lengths)
        return self._embed(start), state, Tensor(finished)

    def step(self, time, inputs, states: BeamSearchState):
        cell_out, next_cell = self.cell(inputs, _wrap(states.cell_states))
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        logits = _v(cell_out)                              # (B*K, V)
        vocab = logits.shape[-1]
        step_lp = self._split(torch.log_softmax(logits.float(), dim=-1))
        # finished beams may only extend with end_token, at zero cost
        frozen = torch.full((vocab,), _NEG_INF, dtype=step_lp.dtype,
                            device=step_lp.device)
        frozen[self.end_token] = 0.0
        step_lp = torch.where(states.finished[..., None], frozen, step_lp)
        total = states.log_probs[..., None] + step_lp      # (batch, K, V)
        scores, top = _top_k(total.reshape(total.shape[0], -1),
                             self.beam_size)
        parent = top // vocab
        token = (top % vocab).to(torch.int32)
        next_cell_u = self._gather_beams(_unwrap(next_cell), parent)
        fin_parent = torch.gather(states.finished, 1, parent)
        len_parent = torch.gather(states.lengths, 1, parent)
        next_finished = fin_parent | (token == self.end_token)
        next_lengths = len_parent + (~fin_parent).to(torch.int32)
        next_state = BeamSearchState(next_cell_u, scores, next_finished,
                                     next_lengths)
        outputs = BeamSearchOutput(Tensor(scores), Tensor(token),
                                   Tensor(parent.to(torch.int32)))
        return (outputs, next_state, self._embed(self._merge(token)),
                Tensor(next_finished))

    def finalize(self, outputs: BeamSearchOutput, final_states,
                 sequence_lengths):
        """Backtrack the parent pointers into whole sequences (time-major
        in, (T, batch, beam) out)."""
        seqs = gather_tree(outputs.predicted_ids, outputs.parent_ids)
        return seqs, final_states


def dynamic_decode(decoder, inits=None, max_step_num: int = 100,
                   output_time_major: bool = False, impute_finished=False,
                   is_test: bool = False, return_length: bool = False,
                   **kwargs):
    """Run ``decoder`` for exactly ``max_step_num`` steps. Returns
    ``(outputs, final_states[, sequence_lengths])``, the outputs
    batch-major ``(batch, T, beam)`` unless ``output_time_major``."""
    inputs, state, _ = decoder.initialize(inits)
    steps = []
    for t in range(max_step_num):
        outputs, state, inputs, _ = decoder.step(Tensor(t), inputs, state)
        steps.append(_unwrap(outputs))
    outs = _tree_map(Tensor, _tree_map_stack(steps))
    lengths = getattr(state, "lengths", None)
    final_outputs, state = decoder.finalize(outs, state, lengths)
    if not output_time_major:
        final_outputs = _tree_map(
            lambda v: Tensor(torch.movedim(_v(v), 0, 1)), final_outputs)
    if return_length:
        return (final_outputs, _wrap(state),
                Tensor(lengths) if lengths is not None else None)
    return final_outputs, _wrap(state)


def _tree_map_stack(steps):
    """Stack a list of equally shaped trees leaf by leaf (time-major)."""
    first = steps[0]
    flat = [_leaves(s) for s in steps]
    stacked = iter([torch.stack([f[i] for f in flat])
                    for i in range(len(flat[0]))])
    return _tree_map(lambda _: next(stacked), first)
