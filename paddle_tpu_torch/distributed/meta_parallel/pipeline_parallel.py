"""Pipeline-parallel training wrapper — counterpart of
``paddle_tpu/distributed/meta_parallel/pipeline_parallel.py``
(``PipelineParallel.train_batch`` / ``eval_batch``,
``PipelineParallelWithInterleave``).

The reference runs every stage in one process (its microbatch loop of
gradient accumulation, and raises under a multi-process launcher).
Here a stage is a pp rank: ``train_batch`` splits the batch into
``accumulate_steps`` microbatches and, for each, runs this stage's
segment of the ``PipelineLayer`` on the activation received from the
previous stage (stage 0: the inputs), sends its output on, and the
last stage computes the loss (scaled by 1/microbatches) and starts the
backward, whose input gradients travel back stage by stage
(``send``/``recv`` over the pp group, a shape header first). Weights
shared between stages (``SharedLayerDesc``) have their gradients summed
over the pp group; then the optimizer steps (each stage its own
parameters). The loss, accumulated on the last stage, is broadcast to
every stage. With one stage it is the reference's loop. The gradients
are those of fill-drain (1F1B only reorders the same work).
"""

from __future__ import annotations

import torch

from ...nn.layer import Layer
from .. import collective as C
from .pp_layers import PipelineLayer

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32]


class PipelineParallel(Layer):
    def __init__(self, layers: PipelineLayer, hcg, strategy):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        h = strategy.hybrid_configs if strategy is not None else {}
        self.micro_batch_size = int(h.get("micro_batch_size", 1))
        self.accumulate_steps = int(h.get("accumulate_steps", 1))
        self.total_loss = None
        self._group = hcg.get_pipe_parallel_group() if hcg is not None \
            else None

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    @property
    def inner_model(self):
        return self._layers

    def _split_micro(self, data):
        """(inputs, labels) cut into ``accumulate_steps`` microbatches."""
        inputs, labels = data
        n = self.accumulate_steps

        def split(t):
            if isinstance(t, (list, tuple)):
                return [split(e) for e in t]
            b = t.shape[0]
            if b % n != 0:
                raise ValueError(
                    f"batch size {b} is not divisible by accumulate_steps {n}")
            mb = b // n
            return [t[i * mb:(i + 1) * mb] for i in range(n)]
        ins = split(inputs)
        labs = split(labels)
        if isinstance(inputs, (list, tuple)):
            ins = list(zip(*ins))
        if isinstance(labels, (list, tuple)):
            labs = list(zip(*labs))
        return list(zip(ins, labs))

    # -- the stages ---------------------------------------------------------
    def _stages(self):
        g = self._group
        if g is None or g.nranks <= 1 or not C._communicates(g):
            return None
        return g

    def _send(self, t, peer: int) -> None:
        from ..communication import p2p
        v = C._unwrap(t).detach().contiguous()
        head = torch.zeros(8, dtype=torch.int64)
        head[0], head[1] = v.dim(), _DTYPES.index(v.dtype)
        head[2:2 + v.dim()] = torch.tensor(v.shape, dtype=torch.int64)
        p2p.send(head.to(v.device), dst=self._group.ranks[peer],
                 group=self._group)
        p2p.send(v, dst=self._group.ranks[peer], group=self._group)

    def _recv(self, peer: int, device):
        from ..communication import p2p
        head = torch.zeros(8, dtype=torch.int64, device=device)
        p2p.recv(head, src=self._group.ranks[peer], group=self._group)
        head = head.cpu()
        nd = int(head[0])
        buf = torch.empty(tuple(int(n) for n in head[2:2 + nd]),
                          dtype=_DTYPES[int(head[1])], device=device)
        p2p.recv(buf, src=self._group.ranks[peer], group=self._group)
        return buf

    def _device(self):
        for p in self._layers.parameters():
            return p.device
        return torch.device("cpu")

    def _run_micro(self, mb_in, mb_lab, n_micro: int, backward: bool):
        """One microbatch through this stage; the loss on the last."""
        g = self._group
        s, S = g.rank, g.nranks
        dev = self._device()
        layers = self._layers
        if s == 0:
            x = mb_in
        else:
            x = self._recv(s - 1, dev)
            if backward and x.is_floating_point():
                x.requires_grad_(True)
        with torch.set_grad_enabled(backward):
            out = layers.forward_stage(s, x)
            loss = None
            if s == S - 1:
                loss = layers._loss_fn(out, mb_lab) / n_micro
        if s < S - 1:
            self._send(out, s + 1)
        if not backward:
            return loss
        raw = C._unwrap(loss if s == S - 1 else out)
        if s == S - 1:
            raw.backward()
        else:
            gy = self._recv(s + 1, dev)
            torch.autograd.backward(raw, gy)
        if s > 0:
            gx = x.grad if x.grad is not None else torch.zeros_like(x)
            self._send(gx, s - 1)
        return loss

    def _sync_shared(self) -> None:
        for p in self._layers._shared_params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            C.all_reduce(p.grad, group=self._group)

    def _total(self, total):
        """The last stage's loss on every stage."""
        g = self._group
        dev = self._device()
        t = torch.zeros((), dtype=torch.float32, device=dev) if total is None \
            else C._unwrap(total).detach().float().reshape(())
        C.broadcast(t, src=g.ranks[-1], group=g)
        from ...core.tensor import Tensor
        return Tensor._wrap(t, True)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """Gradient accumulation over ``accumulate_steps`` microbatches
        through the stages, then one optimizer step."""
        assert self._layers._loss_fn is not None, "PipelineLayer needs loss_fn"
        micro = self._split_micro(data)
        if self._stages() is None:
            total = None
            for mb_in, mb_lab in micro:
                out = self._layers(mb_in)
                loss = self._layers._loss_fn(out, mb_lab)
                scaled = loss / len(micro)
                if scaler is not None:
                    scaler.scale(scaled).backward()
                else:
                    scaled.backward()
                total = scaled.detach() if total is None \
                    else total + scaled.detach()
        else:
            if scaler is not None:
                raise NotImplementedError(
                    "a loss scaler across pipeline stages: train in bf16")
            total = None
            for mb_in, mb_lab in micro:
                loss = self._run_micro(mb_in, mb_lab, len(micro), True)
                if loss is not None:
                    total = loss.detach() if total is None \
                        else total + loss.detach()
            self._sync_shared()
            total = self._total(total)
        if scaler is not None:
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        self.total_loss = total
        return total

    def eval_batch(self, data, compute_loss=True):
        micro = self._split_micro(data)
        total = None
        with torch.no_grad():
            if self._stages() is None:
                for mb_in, mb_lab in micro:
                    out = self._layers(mb_in)
                    if compute_loss:
                        loss = self._layers._loss_fn(out, mb_lab) / len(micro)
                        total = loss if total is None else total + loss
                return total
            for mb_in, mb_lab in micro:
                loss = self._run_micro(mb_in, mb_lab, len(micro), False)
                if loss is not None and compute_loss:
                    total = loss if total is None else total + loss
        return self._total(total) if compute_loss else None


class PipelineParallelWithInterleave(PipelineParallel):
    """The interleaved virtual-pipeline schedule (the reference's class
    of the same name): the same gradients as the base schedule
    (accumulation commutes), so ``train_batch`` is inherited; the
    compiled interleave of a homogeneous decoder stack is
    ``parallel.pipeline.pipeline_spmd_interleaved``."""
    pass
