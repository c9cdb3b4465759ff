"""Ring attention — counterpart of ``paddle_tpu/ops/ring_attention.py``:
blockwise flash attention whose KV chunks travel around a context
(``sep``) group.

A rank is a process. Rank ``my`` of a ring of ``P`` ranks holds chunk
``my`` of the sequence (its queries, keys and values). Each hop it
attends its queries to the KV chunk it holds, merges the block's
normalized output into its running result by the log-sum-exp
(:func:`_merge`), and hands the chunk to rank ``my + 1``
(``collective._raw_ppermute``). At hop ``r`` the chunk it holds is the
one that started at rank ``src = (my − r) mod P``. Causality uses
global positions (l.167-170): a block whose chunk starts later than the
queries' (``src > my``) is skipped, the own chunk is causal on its
diagonal, an earlier one is attended in full.

Each block runs the port's flash kernels for CUDA tensors (rows 5 and 6,
``ops/flash_attention.py``: the forward with its LSE, dQ, dK/dV) and
their plain versions for CPU tensors. GQA shares each KV head across
its ``kv_rep`` query heads inside the kernels: K/V are never repeated.
The backward recomputes each block's probabilities from the *global*
LSE and ``delta = rowsum(dO·O)`` of the *merged* output, so a block's
dQ/dK/dV are its share of the whole softmax's gradient; the dK/dV
partials travel in fp32 with their KV chunk and are home after the full
cycle (l.215-246).

The per-hop work is factored out (:func:`hop_case`, :func:`hop_forward`,
:func:`hop_backward`) from the exchange: :func:`ring_forward` and
:func:`ring_backward` take the exchange as a function, so the same hops
run over a process group (:func:`ring_attention_array`) or, with each
hop's chunk read from whole-sequence tensors, every rank's hops of one
ring in one process (the card's checks).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from . import flash_attention as fa

_NEG_INF = -1e30

SKIP, DIAG, FULL = "skip", "diag", "full"


# ---------------------------------------------------------------------------
# Inner block: (BHq, S, D) x (BHk, S, D) -> normalized out + lse
# ---------------------------------------------------------------------------
def _block_fwd(q3, k3, v3, scale, causal_blk, kv_rep):
    """One block's ``(out fp32, lse)``: row 5 for CUDA tensors, its plain
    version for CPU ones."""
    fn = fa.flash_fwd_kernel if q3.is_cuda else fa.flash_fwd_plain
    out, lse = fn(q3, k3, v3, scale, causal_blk, kv_rep=kv_rep)
    return out.float(), lse


def _block_bwd(q3, k3, v3, out, lse, g, scale, causal_blk, kv_rep):
    """One block's ``(dq, dk, dv)`` of the *global* softmax: ``p = exp(s −
    lse)`` with the merged output's ``lse``, and ``delta`` from the merged
    ``out`` (both in ``q3.dtype``). Row 6 (dQ, then dK/dV reduced to the
    KV heads) for CUDA tensors, its plain version for CPU ones."""
    return fa.flash_attention_bwd(q3, k3, v3, out, lse, g, scale, causal_blk,
                                  kv_rep=kv_rep)


def _merge(out1, lse1, out2, lse2):
    """Online-softmax merge of two normalized partial results (l.116). A
    skipped side carries lse ``-1e30`` (finite), so its weight underflows
    to exactly 0 and the other side's is 1."""
    lse_new = torch.logaddexp(lse1, lse2)
    w1 = torch.exp(lse1 - lse_new)
    w2 = torch.exp(lse2 - lse_new)
    return out1 * w1[..., None] + out2 * w2[..., None], lse_new


# ---------------------------------------------------------------------------
# One hop, and the ring over a caller's exchange
# ---------------------------------------------------------------------------
def hop_case(my: int, src: int, causal: bool) -> str:
    """Which block rank ``my``'s queries see in chunk ``src``."""
    if not causal or src < my:
        return FULL
    return DIAG if src == my else SKIP


def hop_forward(q3, kr, vr, acc, lse, case, scale, kv_rep):
    """Fold the block of the chunk held (``kr``, ``vr``) into the running
    ``(acc, lse)``; a skipped block leaves them as they are."""
    if case == SKIP:
        return acc, lse
    out_r, lse_r = _block_fwd(q3, kr, vr, scale, case == DIAG, kv_rep)
    return _merge(acc, lse, out_r, lse_r)


def hop_backward(q3, kr, vr, out, lse, g, case, scale, kv_rep):
    """The block's ``(dq, dk, dv)``, or None for a skipped block."""
    if case == SKIP:
        return None
    return _block_bwd(q3, kr, vr, out, lse, g, scale, case == DIAG, kv_rep)


def ring_forward(q3, k3, v3, my: int, p: int, exchange: Callable, scale,
                 causal: bool, kv_rep: int):
    """Rank ``my``'s forward over ``p`` ranks: ``p − 1`` hops with an
    exchange after each, then the last block, folded with no trailing
    exchange (l.205-212). ``exchange(kr, vr)`` returns the chunk pair
    the rank holds next. Returns ``(out in q3.dtype, lse fp32)``."""
    bhq, s, d = q3.shape
    acc = torch.zeros(bhq, s, d, dtype=torch.float32, device=q3.device)
    lse = torch.full((bhq, s), _NEG_INF, dtype=torch.float32,
                     device=q3.device)
    kr, vr = k3, v3
    for r in range(p):
        case = hop_case(my, (my - r) % p, causal)
        acc, lse = hop_forward(q3, kr, vr, acc, lse, case, scale, kv_rep)
        if r < p - 1:
            kr, vr = exchange(kr, vr)
    return acc.to(q3.dtype), lse


def ring_backward(q3, k3, v3, out, lse, g, my: int, p: int,
                  exchange: Callable, scale, causal: bool, kv_rep: int):
    """Rank ``my``'s backward: the full cycle of ``p`` hops. ``exchange``
    moves ``(kr, vr)`` and the fp32 ``(dkr, dvr)`` partials together, so
    each chunk's dK/dV come home with every rank's share. Returns
    ``(dq, dk, dv)`` in the inputs' dtypes."""
    dq = torch.zeros(q3.shape, dtype=torch.float32, device=q3.device)
    dkr = torch.zeros(k3.shape, dtype=torch.float32, device=k3.device)
    dvr = torch.zeros_like(dkr)
    kr, vr = k3, v3
    for r in range(p):
        case = hop_case(my, (my - r) % p, causal)
        grads = hop_backward(q3, kr, vr, out, lse, g, case, scale, kv_rep)
        if grads is not None:
            dq_r, dk_r, dv_r = grads
            dq = dq + dq_r.float()
            dkr = dkr + dk_r.float()
            dvr = dvr + dv_r.float()
        if r < p - 1:
            kr, vr, dkr, dvr = exchange(kr, vr, dkr, dvr)
        else:       # the last hop: only the partials still travel home
            dkr, dvr = exchange(dkr, dvr)
    return dq.to(q3.dtype), dkr.to(k3.dtype), dvr.to(v3.dtype)


def _ring_exchange(group):
    """Hand every tensor to the next rank of ``group`` (the ring permute
    ``i → i + 1``), tensors of one dtype stacked into one exchange."""
    from ..distributed import collective as C
    n = group.nranks
    perm = [(i, (i + 1) % n) for i in range(n)]

    def exchange(*ts):
        out = []
        for a, b in zip(ts[::2], ts[1::2]):
            moved = C._raw_ppermute(torch.stack((a, b)), group, perm)
            out += [moved[0], moved[1]]
        return tuple(out)
    return exchange


class _RingAttention(torch.autograd.Function):
    """The ring's custom VJP (l.183-246) over a process group."""

    @staticmethod
    def forward(ctx, q3, k3, v3, group, my, p, scale, causal, kv_rep):
        ex = _ring_exchange(group) if p > 1 else None
        out, lse = ring_forward(q3, k3, v3, my, p, ex, scale, causal, kv_rep)
        ctx.save_for_backward(q3, k3, v3, out, lse)
        ctx.args = (group, my, p, scale, causal, kv_rep)
        return out

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, out, lse = ctx.saved_tensors
        group, my, p, scale, causal, kv_rep = ctx.args
        ex = _ring_exchange(group) if p > 1 else (lambda *ts: ts)
        dq, dk, dv = ring_backward(q3, k3, v3, out, lse,
                                   g.to(q3.dtype).contiguous(), my, p, ex,
                                   scale, causal, kv_rep)
        return dq, dk, dv, None, None, None, None, None, None


def _sep_group(axis):
    """The communicating group ``axis`` names (None over one rank)."""
    from ..distributed import collective as C
    groups = C._live(C.axis_groups(axis))
    if len(groups) > 1:
        raise ValueError("ring attention runs over one mesh axis")
    return groups[0] if groups else None


def _ring_torch(q, k, v, group, causal, scale):
    b, s_loc, hq, d = q.shape
    hk = k.shape[2]
    if hq % hk:
        raise ValueError(f"{hq} query heads do not group over {hk} KV heads")
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    # the flattened layout the kernels take: (B·H, S, D), contiguous
    q3 = q.transpose(1, 2).contiguous().reshape(b * hq, s_loc, d)
    k3 = k.transpose(1, 2).contiguous().reshape(b * hk, s_loc, d)
    v3 = v.transpose(1, 2).contiguous().reshape(b * hk, s_loc, d)
    my, p = (group.rank, group.nranks) if group is not None else (0, 1)
    out = _RingAttention.apply(q3, k3, v3, group, my, p, sc, causal,
                               hq // hk)
    return out.reshape(b, hq, s_loc, d).transpose(1, 2).to(q.dtype)


def ring_attention_array(q, k, v, axis_name, causal: bool = True,
                         scale: Optional[float] = None):
    """This rank's blockwise ring attention (l.129) over the group
    ``axis_name`` names (a mesh axis name or a ``Group``).

    q, k, v: this rank's chunk, (B, S_local, H, D) in the paddle layout
    (GQA: H_kv may divide H). Returns (B, S_local, H, D), differentiable
    (the ring-replay backward). Over one rank it is one block: rows 5
    and 6 over the chunk."""
    from ..core.dispatch import any_tensor, apply
    group = _sep_group(axis_name)
    if any_tensor(q, k, v):
        return apply(lambda a, b_, c: _ring_torch(a, b_, c, group, causal,
                                                  scale),
                     q, k, v, op_name="ring_attention")
    return _ring_torch(q, k, v, group, causal, scale)


def ring_flash_attention(query, key, value, group=None, causal: bool = True,
                         scale: Optional[float] = None, axis: str = "sep"):
    """The eager global-array entry (l.246): every rank passes the whole
    sequence, (B, S, H, D), and gets the whole result. Each rank runs
    the ring on its chunk of the ``sep`` group (``group``, else the
    global mesh's ``axis``): its slice of the sequence in, the chunks
    all-gathered out (backward: the slice of the cotangent in, the
    chunk gradients all-gathered). Over a degree of 1 it is rows 5 and
    6 over the whole sequence (``flash_attention.sdpa_array``)."""
    from ..core.dispatch import any_tensor, apply
    from ..distributed import collective as C
    if group is not None and getattr(group, "mesh", None) is not None:
        group = group.mesh.group(getattr(group, "axis", axis))
    g = _sep_group(group if group is not None else axis)
    sc = scale if scale is not None else \
        1.0 / math.sqrt(query.shape[-1])

    def fn(qv, kv, vv):
        if g is None:
            return fa.sdpa_array(qv, kv, vv, scale=sc, causal=causal)
        qs, ks, vs = (C._ScatterToGroup.apply(t, g, 1) for t in (qv, kv, vv))
        out = _ring_torch(qs, ks, vs, g, causal, sc)
        return C._GatherFromGroup.apply(out, g, 1)

    if any_tensor(query, key, value):
        return apply(fn, query, key, value, op_name="ring_flash_attention")
    return fn(query, key, value)
