"""Pipeline-parallel schedules over a mesh axis — counterpart of
``paddle_tpu/parallel/pipeline.py``.

The reference compiles a pipeline into one ``shard_map`` program: every
device runs the same scan, one (masked) stage step a tick, and the
activations rotate with ``lax.ppermute``. Here each pp stage is a
process: every rank runs the same per-device body, tick by tick, and
the rotation is ``collective.ppermute`` over the ``pp`` group.

* :func:`pipeline_spmd` / :func:`pipeline_spmd_interleaved` (fill-drain
  and the virtual pipeline) build one autograd graph over every tick.
  As in the reference, every rank computes a stage step at every tick
  and keeps it or drops it with ``torch.where``: the graph then has the
  same structure on every rank, so one ``backward`` runs the ring's
  backward exchanges in the same order everywhere (different graphs
  could order them differently and deadlock).
* :func:`pipeline_1f1b` drives the backward itself, one
  ``torch.autograd.grad`` a tick (the reference's ``jax.vjp`` a tick),
  with the rings exchanged outside autograd; invalid ticks are skipped
  (the ranks of one mp or data group share a stage and so a schedule).

Gradients follow Megatron (``distributed/collective.py``): a loss that
every stage computes from :func:`last_stage_broadcast` is one
objective, and the stages' parameters get its gradient once, where the
reference's ``shard_map`` transposes sum the copies (its tests divide
by the stage count).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils._pytree import tree_map

from ..distributed import collective as C


def _group(axis_name):
    groups = C.axis_groups(axis_name)
    if len(groups) != 1:
        raise ValueError("a pipeline runs over one mesh axis")
    return groups[0]


def _flag(b: bool, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(bool(b), device=like.device)


def pipeline_spmd(stage_fn: Callable, stage_params: Any, microbatches,
                  axis_name: str = "pp"):
    """The fill-drain schedule: ``stage_fn(params, x) -> y`` is one
    stage (this rank's ``stage_params``, leaves with their local leading
    dim); ``microbatches`` (M, ...) is the same on every stage (stage 0
    reads it). Returns (M, ...) outputs, valid on the last stage and
    zeros elsewhere. The one-chunk case of the interleaved schedule."""
    lifted = tree_map(lambda a: a[None], stage_params)
    return pipeline_spmd_interleaved(stage_fn, lifted, microbatches,
                                     num_chunks=1, axis_name=axis_name)


def last_stage_broadcast(x, axis_name: str = "pp"):
    """The last stage's value on every stage (the reference's psum of a
    mask); its gradient reaches the last stage's ``x`` from the rank's
    own copy (``collective.psum``)."""
    g = _group(axis_name)
    if g.nranks == 1:
        return x
    keep = torch.where(_flag(g.rank == g.nranks - 1, x), x,
                       torch.zeros_like(x))
    return C.psum(keep, g)


def stage_slice_info(axis_name: str = "pp"):
    """``(stage_id, num_stages)`` of this rank."""
    g = _group(axis_name)
    return g.rank, g.nranks


def interleave_chunk_order(num_stages: int, num_chunks: int):
    """Storage order of the stacked chunk params: stage ``d``'s block
    ``[d*v:(d+1)*v]`` holds model chunks ``d, d+S, d+2S, ...``
    (Megatron's interleaved assignment): ``order[d*v + i] = d + i*S``."""
    return [d + i * num_stages
            for d in range(num_stages) for i in range(num_chunks)]


def pipeline_spmd_interleaved(chunk_fn, chunk_params, microbatches,
                              num_chunks: int, axis_name: str = "pp"):
    """The interleaved virtual pipeline as one systolic loop (the
    reference's l.74): this stage holds ``v = num_chunks`` model chunks
    (``chunk_params`` leaves with leading dim v, arranged by
    :func:`interleave_chunk_order`); at tick ``t`` stage ``d`` runs work
    item ``w = t - d``: local chunk ``(w % (S*v)) // S`` on microbatch
    ``(w // (S*v)) * S + w % S``, and the ring hands each stage its
    next input one tick ahead. ``M*v + S - 1`` ticks; ``M`` must divide
    by ``S`` when ``v > 1``. Returns (M, ...) outputs, valid on the last
    stage and zeros elsewhere."""
    g = _group(axis_name)
    S, d, v = g.nranks, g.rank, int(num_chunks)
    M = microbatches.shape[0]
    if v > 1 and M % S != 0:
        raise ValueError(f"microbatch count {M} must divide by stages {S}")
    bad = [a.shape[0] for a in torch.utils._pytree.tree_leaves(chunk_params)
           if a.shape[0] != v]
    if bad:
        raise ValueError(
            f"chunk_params leaves must have leading dim {v}, got {bad}")
    total = M * v
    perm = [(i, (i + 1) % S) for i in range(S)]
    state = torch.zeros(microbatches.shape[1:], dtype=microbatches.dtype,
                        device=microbatches.device)
    outs = torch.zeros_like(microbatches)
    for t in range(total + S - 1):
        w = t - d
        wc = min(max(w, 0), total - 1)
        slot = (wc % (S * v)) // S
        m = (wc // (S * v)) * S + (wc % S)
        x = torch.where(_flag(d == 0 and slot == 0, state),
                        microbatches[m], state)
        y = chunk_fn(tree_map(lambda a: a[slot], chunk_params), x)
        emit = 0 <= w < total and d == S - 1 and slot == v - 1
        idx = torch.tensor([m], device=outs.device)
        outs = torch.where(_flag(emit, outs),
                           outs.index_copy(0, idx, y.unsqueeze(0).to(
                               outs.dtype)), outs)
        state = C.ppermute(y, g, perm)
    return outs


def pipeline_1f1b(stage_fn: Callable, stage_params: Any, microbatches,
                  labels, loss_fn: Callable, axis_name: str = "pp",
                  head_params: Any = None, strip_stage_dim: bool = True,
                  input_grad_reducer: Callable = None,
                  input_grad_init: Any = None):
    """One-forward-one-backward (the reference's l.145): F(m, d) at tick
    ``d + m`` and B(m, d) at tick ``2S - 2 - d + m``, ``M + 2S - 2``
    ticks; a stage keeps its boundary inputs in a ring of ``2S`` slots
    and recomputes its forward at B time (one ``torch.autograd.grad``
    a tick, seeded by the loss gradient on the last stage and by the
    received gradient elsewhere).

    ``stage_fn(p, x) -> y``; ``loss_fn(y, label)`` (or ``loss_fn(head,
    y, label)`` with ``head_params``) on the last stage. Returns
    ``(loss, grads[, head_grads][, input_grad_acc])``, every entry the
    mean over microbatches: the loss and ``head_grads`` valid on the
    last stage (zeros elsewhere), ``grads`` this stage's (fp32; with
    ``strip_stage_dim`` the leaves arrive with a leading dim of 1, which
    the grads keep), the accumulator valid on stage 0.
    ``input_grad_reducer(acc, gx, m) -> acc`` folds each microbatch's
    input gradient into ``input_grad_init`` on stage 0 as it is made.
    The tensors given are not modified; the rings exchange detached
    values."""
    g = _group(axis_name)
    S, d = g.nranks, g.rank
    M = microbatches.shape[0]
    depth = 2 * S
    fwd_perm = [(i, (i + 1) % S) for i in range(S)]
    bwd_perm = [(i, (i - 1) % S) for i in range(S)]
    if strip_stage_dim:
        bad = [a.shape[0] for a in torch.utils._pytree.tree_leaves(
            stage_params) if a.shape[0] != 1]
        if bad:
            raise ValueError(
                f"stage_params leaves must arrive stage-sliced (leading dim "
                f"1), got leading dims {bad}")
        stage_params = tree_map(lambda a: a[0], stage_params)
    leaves, spec = torch.utils._pytree.tree_flatten(stage_params)
    p_in = [a.detach().requires_grad_(True) for a in leaves]
    params = torch.utils._pytree.tree_unflatten(p_in, spec)
    h_leaves, h_spec = torch.utils._pytree.tree_flatten(head_params) \
        if head_params is not None else ([], None)
    h_in = [a.detach().requires_grad_(True) for a in h_leaves]
    hp = torch.utils._pytree.tree_unflatten(h_in, h_spec) \
        if head_params is not None else None
    gacc = [torch.zeros(a.shape, dtype=torch.float32, device=a.device)
            for a in leaves]
    hacc = [torch.zeros(a.shape, dtype=torch.float32, device=a.device)
            for a in h_leaves]
    dev, dt = microbatches.device, microbatches.dtype
    x_shape = microbatches.shape[1:]
    zeros = lambda: torch.zeros(x_shape, dtype=dt, device=dev)  # noqa: E731
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    gin = input_grad_init
    act_buf = [None] * depth
    fwd_state, grad_state = zeros(), zeros()
    last = d == S - 1
    mbs = microbatches.detach()
    for t in range(M + 2 * S - 2):
        # forward tick: F(m_f, d) at t = d + m_f
        m_f = t - d
        y = zeros()
        if 0 <= m_f < M:
            x_in = mbs[m_f] if d == 0 else fwd_state
            with torch.no_grad():
                y = stage_fn(params, x_in).to(dt)
            act_buf[m_f % depth] = x_in
        # backward tick: B(m_b, d) at t = 2S - 2 - d + m_b
        m_b = t - (2 * S - 2 - d)
        gx = zeros()
        if 0 <= m_b < M:
            xs = act_buf[m_b % depth].detach().requires_grad_(True)
            with torch.enable_grad():
                y_b = stage_fn(params, xs)
                if last:
                    lab = labels[m_b]
                    loss_m = (loss_fn(hp, y_b, lab) if hp is not None
                              else loss_fn(y_b, lab))
                    outs, seeds = [loss_m], [torch.ones_like(loss_m)]
                else:
                    outs, seeds = [y_b], [grad_state.to(y_b.dtype)]
                wrt = p_in + [xs] + (h_in if last else [])
                grads = torch.autograd.grad(outs, wrt, seeds,
                                            allow_unused=True)
            for acc, gp in zip(gacc, grads[:len(p_in)]):
                if gp is not None:
                    acc.add_(gp.float())
            if grads[len(p_in)] is not None:
                gx = grads[len(p_in)].to(dt)
            if last:
                loss_acc = loss_acc + loss_m.detach().float()
                for acc, gh in zip(hacc, grads[len(p_in) + 1:]):
                    if gh is not None:
                        acc.add_(gh.float())
            if input_grad_reducer is not None and d == 0:
                gin = input_grad_reducer(gin, gx, m_b)
        # rings
        fwd_state = C.ppermute(y, g, fwd_perm)
        grad_state = C.ppermute(gx, g, bwd_perm)
    grads_out = [a / M for a in gacc]
    if strip_stage_dim:
        grads_out = [a[None] for a in grads_out]
    res = (loss_acc / M, torch.utils._pytree.tree_unflatten(grads_out, spec))
    if head_params is not None:
        res = res + (torch.utils._pytree.tree_unflatten(
            [a / M for a in hacc], h_spec),)
    if input_grad_reducer is not None:
        res = res + (tree_map(lambda a: a / M, gin),)
    return res
