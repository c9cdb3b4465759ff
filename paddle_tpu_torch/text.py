"""``paddle_tpu_torch.text`` — Viterbi decoding, counterpart of
``paddle_tpu/text.py`` (``viterbi_decode``, ``ViterbiDecoder``).

The forward pass keeps the best score of each tag and a back-pointer
per step, a loop over time with a sequence frozen past its length; the
backtrack walks the pointers from the best last tag. With
``include_bos_eos_tag`` the tags C-2 and C-1 are BOS and EOS: step 0
adds ``transitions[BOS, :]`` and the last step ``transitions[:, EOS]``.
Ties go to the lowest tag, as ``argmax`` breaks them in both packages.
"""

from __future__ import annotations

import torch

from .core.tensor import Tensor
from .nn import Layer

__all__ = ["viterbi_decode", "ViterbiDecoder"]


def _v(x):
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, torch.Tensor):
        return x
    return Tensor(x)._value


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag: bool = True, name=None):
    """Max-sum decode of tag sequences.

    Args:
        potentials: (B, T, C) emission scores.
        transition_params: (C, C) transition scores [from, to].
        lengths: (B,) sequence lengths.
        include_bos_eos_tag: tags C-2 and C-1 are BOS and EOS.

    Returns:
        (scores (B,), paths (B, T) int32): T is the potentials' time
        axis; positions at or past a sequence's length hold 0.
    """
    emis = _v(potentials).float()
    trans = _v(transition_params).float().to(emis.device)
    lens = _v(lengths).to(device=emis.device, dtype=torch.int32)
    B, T, C = emis.shape
    tags_c = torch.arange(C, device=emis.device)[None, :].expand(B, C)
    alpha = emis[:, 0, :]
    if include_bos_eos_tag:
        alpha = alpha + trans[C - 2, :][None, :]
    bps = []
    for t in range(1, T):
        scores = alpha[:, :, None] + trans[None, :, :]
        best_score, best_prev = torch.max(scores, dim=1)
        active = (t < lens)[:, None]
        alpha = torch.where(active, best_score + emis[:, t, :], alpha)
        bps.append(torch.where(active, best_prev, tags_c))
    final = alpha
    if include_bos_eos_tag:
        final = final + trans[:, C - 1][None, :]
    scores, last_tag = torch.max(final, dim=-1)
    tag = last_tag
    rev = []
    for t in range(T - 2, -1, -1):
        prev = torch.gather(bps[t], 1, tag[:, None])[:, 0]
        tag = torch.where((t + 1) < lens, prev, tag)
        rev.append(tag)
    tags = torch.stack(rev[::-1] + [last_tag], dim=1).to(torch.int32)
    pos = torch.arange(T, device=emis.device, dtype=torch.int32)[None, :]
    last = last_tag.to(torch.int32)[:, None]
    tags = torch.where(pos == lens[:, None] - 1, last, tags)
    tags = torch.where(pos < lens[:, None], tags, torch.zeros_like(tags))
    return Tensor(scores), Tensor(tags)


class ViterbiDecoder(Layer):
    """Layer form (paddle.text.ViterbiDecoder): holds the transition
    matrix; ``forward(potentials, lengths) -> (scores, paths)``."""

    def __init__(self, transitions, include_bos_eos_tag: bool = True,
                 name=None):
        super().__init__()
        self.transitions = transitions if isinstance(transitions, Tensor) \
            else Tensor(transitions)
        self.include_bos_eos_tag = include_bos_eos_tag

    def forward(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)
