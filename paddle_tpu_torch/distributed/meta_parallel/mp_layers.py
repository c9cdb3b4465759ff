"""Tensor-parallel (Megatron) layers — counterpart of
``paddle_tpu/distributed/meta_parallel/mp_layers.py``:
``ColumnParallelLinear``, ``RowParallelLinear``,
``VocabParallelEmbedding``, ``ParallelCrossEntropy``, the array-level
``vocab_parallel_ce_array`` and the mp helpers.

The reference keeps one global weight per layer and either lets GSPMD
partition it or, inside ``shard_map``, hands each device its shard
(its manual-mode branches). Here a rank is a process, so with an mp
group of more than one rank (``mp_group``, else the hybrid topology's
or the global mesh's ``mp`` group) each rank holds its slab of the
reference's global weight: ``(in, out/mp)`` for a column layer,
``(in/mp, out)`` for a row layer, ``(vocab/mp, emb)`` for the
embedding, ``_sharding_spec`` saying which (as the reference's). The
forwards are the reference's manual branches with Megatron's gradient
pair (``distributed/collective.py``): a column layer copies its input
into the region (all-reduce backward) and gathers its output when
``gather_output`` (backward: this rank's slice, since what follows is
the same on every mp rank); a row layer slices its input unless
``input_is_parallel`` and all-reduces its output; the embedding looks
up its vocabulary slab, zeroes out-of-slab ids and all-reduces. At mp
degree 1 every layer is the plain one.

Weights are drawn when a layer is built, at the global shape (torch's
default generator, or the ``weight_attr``'s initializer; ``nn.
common_layers.init_layers`` redraws a model seeded) and cut to this
rank's slab, so every rank draws the whole tensor: fine at test widths
and at one rank. ``device``: ``None`` means the card and raises
without one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer import Layer, ParamAttr, make_parameter
from ...ops._common import resolve_device
from ...parallel import mesh as _mesh
from .. import collective as C


def mp_group_of(mp_group=None):
    """The mp group a tensor-parallel layer splits over: ``mp_group``,
    else the hybrid topology's, else the global mesh's; None when that
    group has one rank (the plain layers)."""
    g = mp_group
    if g is None:
        from ..topology import get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
        if hcg is not None and hcg.get_model_parallel_world_size() > 1:
            g = hcg.get_model_parallel_group()
        else:
            m = _mesh.get_global_mesh()
            if m is not None and m.degree("mp") > 1:
                g = m.group("mp")
    return g if g is not None and g.nranks > 1 else None


def _parameter(value: torch.Tensor, attr, spec, distributed: bool):
    p = make_parameter(value, attr) if attr else nn.Parameter(value)
    p._sharding_spec = spec
    p.is_distributed = p.is_distributed_param = distributed
    return p


def _tag(p, full_shape, dim: int, group) -> None:
    """Tag ``p`` (this rank's slab) for sharded checkpoints: its piece of
    the global weight, written by the ranks at 0 on every other mesh
    axis."""
    if group is None:
        return
    off = [0] * len(full_shape)
    off[dim] = group.rank * p.shape[dim]
    writes = True
    if group.mesh is not None:
        writes = all(v == 0 for a, v in group.mesh.coords().items()
                     if a != group.axis)
    _mesh.mark_slab(p, _mesh.SlabInfo(
        full_shape, [(tuple(slice(0, n) for n in p.shape), off,
                      tuple(p.shape))], writes, (group.axis,)))


def _slab(full: torch.Tensor, group, dim: Optional[int]) -> torch.Tensor:
    if group is None or dim is None:
        return full
    n = full.shape[dim] // group.nranks
    return full.narrow(dim, group.rank * n, n).contiguous()


class _SlabbedLayer:
    """Draws a weight at its global shape and keeps this rank's slab."""

    def _draw(self, param, full_shape, dim, attr, default, gen):
        init = attr.initializer if attr else None
        with torch.no_grad():
            if isinstance(init, I.Initializer):
                full = init(full_shape, param.dtype, device=param.device)
            else:
                full = torch.empty(full_shape, dtype=param.dtype,
                                   device=param.device)
                default(full, gen)
            param.copy_(_slab(full, self._group, dim))


class _ParallelLinear(_SlabbedLayer, Layer):
    _W_DIM = None       # the weight dim split over mp
    _B_SPLIT = False    # whether the bias is split over mp too

    def __init__(self, in_features, out_features, weight_attr, has_bias,
                 mp_group, dtype, device):
        super().__init__()
        self._group = mp_group_of(mp_group)
        n = self._group.nranks if self._group is not None else 1
        self.world_size = n
        split = (in_features, out_features)[self._W_DIM]
        if split % n:
            raise ValueError(f"{type(self).__name__}: dim {split} not "
                             f"divisible by mp degree {n}")
        self._in_features, self._out_features = in_features, out_features
        self._attr = ParamAttr._to_attr(weight_attr)
        kw = dict(dtype=dtype, device=resolve_device(device))
        shape = [in_features, out_features]
        shape[self._W_DIM] //= n
        wspec = _mesh.PartitionSpec(*(["mp" if d == self._W_DIM else None
                           for d in range(2)]))
        self.weight = _parameter(torch.empty(*shape, **kw), self._attr,
                                 wspec, True)
        _tag(self.weight, (in_features, out_features), self._W_DIM,
             self._group)
        if has_bias:
            bshape = out_features // n if self._B_SPLIT else out_features
            self.bias = _parameter(
                torch.empty(bshape, **kw), None,
                _mesh.PartitionSpec("mp") if self._B_SPLIT else _mesh.PartitionSpec(),
                self._B_SPLIT)
            if self._B_SPLIT:
                _tag(self.bias, (out_features,), 0, self._group)
        else:
            self.bias = None
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        self._draw(self.weight, (self._in_features, self._out_features),
                   self._W_DIM, self._attr, I.xavier_uniform_, gen)
        if self.bias is not None:
            I.constant_(self.bias, 0.0)


class ColumnParallelLinear(_ParallelLinear):
    """Weight (in, out), split on out over the mp group."""
    _W_DIM = 1
    _B_SPLIT = True

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, dtype=torch.float32,
                 device=None):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         mp_group, dtype, device)
        self.gather_output = gather_output

    def forward(self, x):
        g = self._group
        if g is None:
            return F.linear(x, self.weight, self.bias)
        y = F.linear(C.copy_to_group(x, g), self.weight, self.bias)
        if self.gather_output:
            y = C.gather_from_group(y, g, dim=len(y.shape) - 1)
        return y


class RowParallelLinear(_ParallelLinear):
    """Weight (in, out), split on in over the mp group; the bias is
    whole and added after the all-reduce."""
    _W_DIM = 0

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         mp_group, dtype, device)
        self.input_is_parallel = input_is_parallel

    def forward(self, x):
        g = self._group
        if g is None:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = C.scatter_to_group(x, g, dim=len(x.shape) - 1)
        y = C.reduce_from_group(F.linear(x, self.weight), g)
        return y if self.bias is None else y + self.bias


class VocabParallelEmbedding(_SlabbedLayer, Layer):
    """Weight (vocab, emb), split on vocab over the mp group."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self._group = mp_group_of(mp_group)
        n = self._group.nranks if self._group is not None else 1
        self.world_size = n
        if num_embeddings % n:
            raise ValueError(f"vocab {num_embeddings} not divisible by mp "
                             f"degree {n}")
        self._num_embeddings, self._embedding_dim = (num_embeddings,
                                                     embedding_dim)
        self._attr = ParamAttr._to_attr(weight_attr)
        self.weight = _parameter(torch.empty(
            num_embeddings // n, embedding_dim, dtype=dtype,
            device=resolve_device(device)), self._attr, _mesh.PartitionSpec("mp", None),
            True)
        _tag(self.weight, (num_embeddings, embedding_dim), 0, self._group)
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        self._draw(self.weight, (self._num_embeddings, self._embedding_dim),
                   0, self._attr,
                   lambda t, g: I.normal_(t, g, 0.0, 0.02), gen)

    def forward(self, x):
        g = self._group
        if g is None:
            return F.embedding(x, self.weight)
        return C._keep(x, vocab_parallel_embedding_array(self.weight,
                                                         C._unwrap(x), g))


def vocab_parallel_embedding_array(w, ids, group):
    """The embeddings of global ``ids`` from this rank's vocabulary slab
    ``w`` of ``group``: an id outside the slab gives zeros before the
    sum over the group (the reference's l.146)."""
    per = w.shape[0]
    local = ids.long() - group.rank * per
    ok = (local >= 0) & (local < per)
    e = w[torch.where(ok, local, torch.zeros_like(local))]
    return C.psum(torch.where(ok[..., None], e, torch.zeros_like(e)), group)


def vocab_parallel_ce_array(lg, lab, axis, ignore_index: Optional[int] = None):
    """Per-token cross-entropy over vocabulary-split logits (the
    reference's l.164): ``lg`` (..., V_local) on each rank of ``axis``
    (its group, or a mesh axis name), ``lab`` (...) global ids. The
    global max (no gradient), the softmax denominator and the target
    logit are all-reduced; an id outside this rank's slab picks 0 before
    the sum. Ignored positions give 0."""
    g = C.axis_groups(axis)
    g = g[0] if g else None
    lg = lg.float()
    per = lg.shape[-1]
    start = (g.rank if g is not None else 0) * per
    gmax = C.pmax(lg.detach().amax(-1), g)
    ex = torch.exp(lg - gmax[..., None])
    denom = C.psum(ex.sum(-1), g)
    li = lab.long()
    local = li - start
    ok = (local >= 0) & (local < per)
    picked = torch.gather(lg, -1, torch.where(ok, local, torch.zeros_like(
        local))[..., None])[..., 0]
    target = C.psum(torch.where(ok, picked, torch.zeros_like(picked)), g)
    loss = torch.log(denom) + gmax - target
    if ignore_index is not None:
        loss = torch.where(li != ignore_index, loss, torch.zeros_like(loss))
    return loss


class ParallelCrossEntropy(Layer):
    """Cross-entropy over vocabulary-split logits (per token, no
    reduction), as the reference's ``c_softmax_with_cross_entropy``:
    no all-gather of the logits. At mp degree 1 the plain
    cross-entropy."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self._group = mp_group_of(mp_group)

    def forward(self, input, label):
        g = self._group
        if g is None:
            return F.cross_entropy(input, label, reduction="none",
                                   ignore_index=self.ignore_index)
        lg, li = C._unwrap(input), C._unwrap(label)
        if li.dim() == lg.dim():
            li = li[..., 0]
        out = vocab_parallel_ce_array(lg, li, g,
                                      ignore_index=self.ignore_index)
        return C._keep(input, out)


def mark_as_sequence_parallel_parameter(param):
    param.is_sequence_parallel = True


def _mp_apply(x, fn):
    g = mp_group_of(None)
    if g is None:
        return x
    return fn(x, g)


def mp_all_gather_last_dim(x):
    """All-gather on the last dim over the mp group (identity at
    degree 1); backward: this rank's slice (Megatron's gather: what
    follows is the same on every mp rank)."""
    return _mp_apply(x, lambda v, g: C.gather_from_group(
        v, g, dim=len(v.shape) - 1))


def mp_all_reduce(x):
    """Sum over the mp group (identity at degree 1); backward:
    identity."""
    return _mp_apply(x, lambda v, g: C.reduce_from_group(v, g))
