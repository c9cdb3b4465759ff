"""Model wrappers of ``fleet.distributed_model`` — counterpart of
``paddle_tpu/distributed/meta_parallel/parallel_wrapper.py``. The
forward stays the wrapped layer's; ``compile_train_step`` gives the
compiled hybrid step (``fleet.hybrid_engine.HybridTrainStep``) over the
fleet mesh, at the strategy's ZeRO stage."""

from __future__ import annotations

from typing import Callable

from ...nn.layer import Layer


class HybridParallelModel(Layer):
    def __init__(self, model: Layer, hcg, strategy):
        super().__init__()
        self._layers = model
        self._hcg = hcg
        self._strategy = strategy
        self._train_step = None

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.set_state_dict(sd, *a, **k)

    @property
    def inner_model(self):
        return self._layers

    def compile_train_step(self, loss_fn: Callable, optimizer):
        """``loss_fn(model, *batch) -> scalar``. The compiled hybrid
        step (cached); the strategy's amp wraps the loss in
        ``auto_cast`` inside the program."""
        from ..fleet.hybrid_engine import HybridTrainStep
        from ..fleet.meta_optimizers import unwrap_optimizer
        if self._train_step is None:
            s = self._strategy
            if s is not None and (getattr(s, "gradient_merge", False)
                                  or getattr(s, "localsgd", False)):
                raise ValueError(
                    "strategy.gradient_merge / strategy.localsgd are eager "
                    "step-loop transforms and are not applied inside the "
                    "compiled hybrid step — drive training through "
                    "opt.step()/clear_grad() (or use micro-batching via the "
                    "pipeline engine's accumulate_steps) instead")
            inner_opt = unwrap_optimizer(optimizer)
            stage = 1
            if s is not None and s.sharding:
                stage = int(s.sharding_configs.get("stage", 1))
            if s is not None and s.amp:
                from ... import amp as _amp
                c = s.amp_configs
                if c.get("dtype", "bfloat16") == "float16":
                    raise ValueError(
                        "strategy.amp with dtype float16 is not supported "
                        "in the compiled hybrid step (loss scaling state "
                        "machine is eager-only) — use dtype bfloat16, or "
                        "drive fp16 training eagerly with the scaler from "
                        "distributed_optimizer().get_loss_scaler()")
                base_loss = loss_fn

                def loss_fn(model, *batch, _base=base_loss, _c=c):
                    with _amp.auto_cast(
                            enable=True, level=_c.get("level", "O1"),
                            dtype=_c.get("dtype", "bfloat16"),
                            custom_white_list=_c.get("custom_white_list"),
                            custom_black_list=_c.get("custom_black_list")):
                        return _base(model, *batch)
            self._train_step = HybridTrainStep(
                self._layers, loss_fn, inner_opt,
                mesh=self._hcg.mesh if self._hcg else None,
                zero_stage=stage)
        return self._train_step

    def train_batch(self, batch, optimizer, lr_scheduler=None, loss_fn=None):
        if self._train_step is None:
            if loss_fn is None:
                raise ValueError("first train_batch call needs loss_fn")
            self.compile_train_step(loss_fn, optimizer)
        loss = self._train_step(*batch)
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss
