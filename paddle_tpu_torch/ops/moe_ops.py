"""MoE dispatch and capacity ops — counterpart of
``paddle_tpu/ops/moe_ops.py``.

The capacity ops (``number_count``, ``limit_by_capacity``,
``prune_gate_by_capacity``, ``random_routing``), the dense GShard masks
(``dispatch_combine_masks``, ``dispatch_masks_topk``,
``dispatch_combine_topk``, ``moe_dispatch``, ``moe_combine``), their
index form (``dispatch_indices_topk``, ``moe_dispatch_indices``,
``moe_combine_indices``) and the gather form the MoE layer runs
(``dispatch_plan``, ``moe_dispatch_gather``, ``moe_combine_gather``, each
of the last two an ``autograd.Function`` whose backward is gathers
only, as the reference's custom VJPs are). None of this is a Pallas
kernel in the reference: here it is plain torch indexing on whatever
device the tensors are on, with no host read, so a compiled step can
capture it.

Joint top-K capacity order (GShard): choice ``k``'s tokens queue in an
expert after the tokens of choices ``< k`` that it admitted, so no two
(token, choice) pairs share a slot.

:func:`expert_parallel_apply` and :func:`expert_parallel_ffn` are the
reference's ``shard_map`` bodies over an expert group, one rank a
process: this rank's tokens dispatch locally, an all-to-all over the
group (``collective.all_to_all_grad``) brings each rank the slots of its
own experts, and the inverse all-to-all takes the outputs back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF


def _t(x, dtype=None):
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return x if dtype is None else x.to(dtype)


def _one_hot(idx, n: int, dtype=torch.int32):
    """``jax.nn.one_hot``: a row of zeros for an index outside [0, n).
    A comparison, not ``F.one_hot``, whose range check reads the card."""
    return (idx.long()[..., None]
            == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(x, k: int):
    """``lax.top_k`` over the last axis: the ``k`` largest values and
    their indices, ties to the lower index (``torch.topk`` does not
    promise an order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def number_count(gate_idx, upper_range: int):
    """Histogram of expert assignments: ``out[e]`` = the tokens routed to
    ``e`` (the reference's ``number_count`` op). As ``jnp.bincount``
    does, a negative index counts in bin 0 and one past the range
    nowhere."""
    idx = _t(gate_idx).reshape(-1).long().clamp_min(0)
    return _one_hot(idx, upper_range).sum(dim=0).to(torch.int32)


def position_in_expert(gate_idx, num_experts: int):
    """Each token's arrival position in its expert's queue (the count of
    earlier tokens with the same expert)."""
    oh = _one_hot(_t(gate_idx), num_experts)
    pos = torch.cumsum(oh, dim=0) * oh
    return (pos.sum(dim=-1) - 1).to(torch.int32)


def limit_by_capacity(expert_count, capacity, n_worker: int = 1):
    """The admitted counts: each expert's count clamped at capacity."""
    count = _t(expert_count)
    cap = _t(capacity).to(count.device)
    if cap.dim() == 0:
        cap = cap.expand(count.shape)
    return torch.minimum(count, cap.to(count.dtype))


def prune_gate_by_capacity(gate_idx, expert_count, n_expert: int,
                           n_worker: int = 1):
    """``gate_idx`` with -1 for each token past its expert's capacity
    (``expert_count`` holds the capacities)."""
    idx = _t(gate_idx)
    pos = position_in_expert(idx, n_expert)
    cap = _t(expert_count).to(idx.device)[idx.long()]
    return torch.where(pos < cap, idx, torch.full_like(idx, -1))


def random_routing(topk_idx, topk_value, prob, topk: int = 2):
    """GShard's random drop of the second expert: it is kept only where
    ``2·value > prob`` (``prob`` ~ U[0, 1) a token)."""
    if topk != 2:
        raise ValueError("random_routing supports topk=2 only")
    idx = _t(topk_idx)
    keep = (2.0 * _t(topk_value)[:, 1]) > _t(prob)
    second = torch.where(keep, idx[:, 1], torch.full_like(idx[:, 1], -1))
    return torch.stack([idx[:, 0], second], dim=1)


def dispatch_combine_masks(gate_idx, gate_prob, num_experts: int,
                           capacity: int):
    """Dense GShard dispatch: ``dispatch`` (N, E, C) fp32 (token n goes
    to slot c of expert e) and ``combine``, the same scaled by the gate
    probability. Tokens with index -1 or past capacity drop out."""
    idx = _t(gate_idx)
    valid = idx >= 0
    oh_e = _one_hot(torch.where(valid, idx, 0), num_experts) \
        * valid[:, None].to(torch.int32)
    pos = (torch.cumsum(oh_e, dim=0) * oh_e).sum(dim=-1) - 1
    in_cap = (pos >= 0) & (pos < capacity)
    keep = (valid & in_cap).float()
    oh_c = _one_hot(torch.where(in_cap, pos, 0), capacity, torch.float32)
    disp = torch.einsum("ne,nc->nec", oh_e.float(), oh_c)
    disp = disp * keep[:, None, None]
    return disp, disp * _t(gate_prob)[:, None, None]


def _choice_routes(gate_idx, num_experts: int, capacity: int):
    """Each choice's ``(one-hot (N, E), slot position (N,), admitted
    (N,))`` in the joint top-K order."""
    idx = _t(gate_idx)
    n, K = idx.shape
    admitted = torch.zeros(num_experts, dtype=torch.int32,
                           device=idx.device)
    out = []
    for k in range(K):
        col = idx[:, k]
        valid = col >= 0
        safe = torch.where(valid, col, 0).long()
        oh = _one_hot(safe, num_experts) * valid[:, None].to(torch.int32)
        pos = (torch.cumsum(oh, dim=0) * oh).sum(dim=-1) - 1 \
            + admitted[safe]
        in_cap = valid & (pos >= 0) & (pos < capacity)
        out.append((oh, safe, pos, in_cap))
        admitted = admitted + (oh * in_cap[:, None].to(torch.int32)).sum(
            dim=0).to(torch.int32)
    return out


def dispatch_masks_topk(gate_idx, num_experts: int, capacity: int):
    """Per-choice (N, E, C) fp32 dispatch masks in the joint top-K order,
    index-only (no gradient path)."""
    masks = []
    for oh, _, pos, in_cap in _choice_routes(gate_idx, num_experts,
                                             capacity):
        oh_c = _one_hot(torch.where(in_cap, pos, 0), capacity,
                        torch.float32)
        masks.append(torch.einsum("ne,nc->nec", oh.float(), oh_c)
                     * in_cap.float()[:, None, None])
    return masks


def dispatch_combine_topk(gate_idx, gate_prob, num_experts: int,
                          capacity: int):
    """The joint top-K dispatch and combine masks, summed over choices."""
    masks = dispatch_masks_topk(gate_idx, num_experts, capacity)
    prob = _t(gate_prob)
    return (sum(masks),
            sum(m * prob[:, k][:, None, None] for k, m in enumerate(masks)))


def moe_dispatch(x, dispatch_mask):
    """(N, d), (N, E, C) -> (E, C, d): the ``global_scatter`` equivalent."""
    return torch.einsum("nec,nd->ecd", dispatch_mask, x)


def moe_combine(expert_out, combine_mask):
    """(E, C, d), (N, E, C) -> (N, d): the ``global_gather`` equivalent."""
    return torch.einsum("nec,ecd->nd", combine_mask, expert_out)


# ---------------------------------------------------------------------------
# Index-based dispatch: the slot of each (token, choice)
# ---------------------------------------------------------------------------
def dispatch_indices_topk(gate_idx, num_experts: int, capacity: int):
    """Index form of :func:`dispatch_masks_topk`, in the same joint
    order: a list of K routes ``(flat_slot (N,) int32, admitted (N,)
    bool)``, ``flat_slot`` indexing the flattened (E·C) slots."""
    return [((safe * capacity + torch.where(in_cap, pos, 0)).to(torch.int32),
             in_cap)
            for _, safe, pos, in_cap in _choice_routes(gate_idx, num_experts,
                                                       capacity)]


def moe_dispatch_indices(x, routes, num_experts: int, capacity: int):
    """(N, d) + routes -> (E, C, d) by scatter-add (slots never collide,
    so the add is a set with exact gradients)."""
    out = x.new_zeros(num_experts * capacity, x.shape[-1])
    for flat, ok in routes:
        out = out.index_add(0, torch.where(ok, flat, 0).long(),
                            torch.where(ok[:, None], x, torch.zeros_like(x)))
    return out.reshape(num_experts, capacity, x.shape[-1])


def moe_combine_indices(expert_out, routes, gate_prob):
    """(E, C, d) + routes + (N, K) probs -> (N, d) by gather."""
    e, c, d = expert_out.shape
    flat = expert_out.reshape(e * c, d)
    out = None
    for k, (fs, ok) in enumerate(routes):
        vals = flat[torch.where(ok, fs, 0).long()]
        w = (gate_prob[:, k] * ok.to(gate_prob.dtype))[:, None]
        term = vals * w.to(vals.dtype)
        out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# Gather-based dispatch: every float movement, forward and backward, a
# gather over the inverse slot -> token map
# ---------------------------------------------------------------------------
def dispatch_plan(routes, num_experts: int, capacity: int, n_tokens: int):
    """The routes inverted into the gather plan: ``token_for_slot``
    (E·C,) int32 (-1 for an empty slot), ``choice_for_slot`` (E·C,)
    int32, and ``flats``/``oks`` (N, K), the routes stacked."""
    ec = num_experts * capacity
    dev = routes[0][0].device
    tfs = torch.full((ec + 1,), -1, dtype=torch.int32, device=dev)
    cfs = torch.zeros(ec + 1, dtype=torch.int32, device=dev)
    tok = torch.arange(n_tokens, dtype=torch.int32, device=dev)
    for k, (flat, ok) in enumerate(routes):
        idx = torch.where(ok, flat, ec).long()     # ec: the dump slot
        tfs = tfs.index_put((idx,), torch.where(ok, tok, -1))
        cfs = cfs.index_put((idx,), torch.full_like(tok, k))
    flats = torch.stack([f for f, _ in routes], dim=1)
    oks = torch.stack([o for _, o in routes], dim=1)
    return tfs[:ec], cfs[:ec], flats, oks


class _DispatchGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tfs, flats, oks, num_experts, capacity):
        ctx.save_for_backward(flats, oks)
        valid = (tfs >= 0)[:, None]
        slots = x[tfs.clamp_min(0).long()]
        slots = torch.where(valid, slots, torch.zeros_like(slots))
        return slots.reshape(num_experts, capacity, x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        flats, oks = ctx.saved_tensors
        gf = g.reshape(-1, g.shape[-1])
        dx = None
        for k in range(flats.shape[1]):
            rows = gf[flats[:, k].long()]
            term = torch.where(oks[:, k][:, None], rows,
                               torch.zeros_like(rows))
            dx = term if dx is None else dx + term
        return dx, None, None, None, None, None


def moe_dispatch_gather(x, token_for_slot, flats, oks, num_experts: int,
                        capacity: int):
    """(N, d) -> (E, C, d), slot s holding ``x[token_for_slot[s]]`` (0 for
    an empty slot). Backward: a gather of each (token, choice)'s slot
    (``flats``/``oks``)."""
    return _DispatchGather.apply(x, token_for_slot, flats, oks, num_experts,
                                 capacity)


class _CombineGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eo, pv, fl, ok, tfs, cfs):
        ctx.save_for_backward(eo, pv, fl, ok, tfs, cfs)
        e, c, d = eo.shape
        flat = eo.reshape(e * c, d)
        out = None
        for k in range(fl.shape[1]):
            vals = flat[fl[:, k].long()]
            w = pv[:, k] * ok[:, k].to(pv.dtype)
            term = vals * w[:, None].to(vals.dtype)
            out = term if out is None else out + term
        return out

    @staticmethod
    def backward(ctx, g):
        eo, pv, fl, ok, tfs, cfs = ctx.saved_tensors
        e, c, d = eo.shape
        flat = eo.reshape(e * c, d)
        valid = tfs >= 0
        tok = tfs.clamp_min(0).long()
        # d_eo[s] = valid · g[token(s)] · p[token(s), choice(s)]
        g_rows = g[tok]
        cl = cfs.long()[:, None]
        p_slot = pv[tok].gather(1, cl)[:, 0]
        ok_slot = ok[tok].gather(1, cl)[:, 0]
        w = p_slot * ok_slot.to(p_slot.dtype)
        d_eo = torch.where(valid[:, None], g_rows * w[:, None].to(g.dtype),
                           torch.zeros_like(g_rows))
        # d_p[n, k] = ok · <g[n], eo[slot(n, k)]>
        dps = []
        for k in range(fl.shape[1]):
            vals = flat[fl[:, k].long()]
            dps.append((g.float() * vals.float()).sum(dim=-1)
                       * ok[:, k].float())
        d_pv = torch.stack(dps, dim=1).to(pv.dtype)
        return (d_eo.reshape(e, c, d).to(eo.dtype), d_pv, None, None, None,
                None)


def moe_combine_gather(expert_out, probs, flats, oks, token_for_slot,
                       choice_for_slot):
    """(E, C, d) + (N, K) probs -> (N, d): ``out[n] = Σ_k ok·p_k·
    eo[slot(n, k)]``. Backward (``expert_out`` and ``probs``): gathers
    over the slot -> token maps."""
    return _CombineGather.apply(expert_out, probs, flats, oks,
                                token_for_slot, choice_for_slot)


# ---------------------------------------------------------------------------
# Expert-parallel execution over an expert group (one rank a process)
# ---------------------------------------------------------------------------
def _gelu_tanh(x):
    """``jax.nn.gelu``'s default (the tanh approximation), the reference's
    activation when none is given."""
    return TF.gelu(x, approximate="tanh")


def expert_parallel_apply(x_local, gate_idx_local, gate_prob_local,
                          w1_local, w2_local, axis_name, num_experts: int,
                          capacity: int, act=None, b1_local=None,
                          b2_local=None):
    """The expert-parallel MoE FFN with gating done (l.144): this rank's
    tokens ``x_local`` (T, d) with their indices and probabilities (T, K;
    -1 = dropped), and this rank's ``num_experts / n`` experts'
    ``w1_local`` (E_local, d, ff), ``w2_local`` (E_local, ff, d) and
    optional biases. ``axis_name`` names the expert group (a mesh axis
    or a ``Group``); ``capacity`` is this rank's slots an expert.

    Dispatch is local (the gather plan), then an all-to-all gives each
    rank the slots every rank filled for its experts, the experts run on
    them, and the inverse all-to-all brings the outputs home to be
    combined. Over one rank it is the local gather path."""
    from ..distributed import collective as C
    groups = C._live(C.axis_groups(axis_name))
    n = groups[0].nranks if groups else 1
    if num_experts % n:
        raise ValueError(f"num_experts {num_experts} must be divisible by "
                         f"the expert group's {n} ranks")
    e_local = num_experts // n
    act = act or _gelu_tanh
    routes = dispatch_indices_topk(gate_idx_local, num_experts, capacity)
    in_dtype = x_local.dtype
    tfs, cfs, flats, oks = dispatch_plan(routes, num_experts, capacity,
                                         x_local.shape[0])
    slots = moe_dispatch_gather(x_local.float(), tfs, flats, oks,
                                num_experts, capacity)          # (E, C, d)
    d_model = x_local.shape[-1]
    # chunk i (this rank's slots for expert group i) goes to rank i; the
    # received leading dim then indexes the source rank
    z = slots.reshape(n, e_local, capacity, d_model)
    z = C.all_to_all_grad(z, groups, 0, 0) if groups else z
    z = z.transpose(0, 1).reshape(e_local, n * capacity, d_model)
    h = torch.einsum("ecd,edf->ecf", z.to(in_dtype), w1_local)
    if b1_local is not None:
        h = h + b1_local[:, None, :]
    h = act(h)
    y = torch.einsum("ecf,efd->ecd", h, w2_local)          # (E_local, nC, d)
    if b2_local is not None:
        y = y + b2_local[:, None, :]
    y = y.reshape(e_local, n, capacity, d_model).transpose(0, 1)
    y = C.all_to_all_grad(y.contiguous(), groups, 0, 0) if groups else y
    y = y.reshape(num_experts, capacity, d_model)
    return moe_combine_gather(y.float(), gate_prob_local, flats, oks, tfs,
                              cfs).to(in_dtype)


def expert_parallel_ffn(x_local, gate_logits_local, w1_local, w2_local,
                        axis_name, num_experts: int, capacity: int,
                        topk: int = 1, act=None):
    """The MoE FFN with experts split over ``axis_name`` (l.201): fp32
    softmax gating over all experts (the gate replicated, so
    ``gate_logits_local`` is (T_local, E)), top-``topk``, then
    :func:`expert_parallel_apply`."""
    probs = torch.softmax(gate_logits_local.float(), dim=-1)
    if topk == 1:
        gate_idx = probs.argmax(dim=-1)[:, None]
        gate_prob = probs.gather(1, gate_idx)
    else:
        gate_prob, gate_idx = _top_k(probs, topk)
    return expert_parallel_apply(x_local, gate_idx.to(torch.int32),
                                 gate_prob, w1_local, w2_local, axis_name,
                                 num_experts, capacity, act=act)
