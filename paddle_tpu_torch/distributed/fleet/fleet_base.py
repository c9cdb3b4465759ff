"""The Fleet facade — counterpart of
``paddle_tpu/distributed/fleet/fleet_base.py``: ``fleet.init`` joins
the process group (``init_parallel_env``), builds the hybrid mesh and
topology from the strategy's ``hybrid_configs`` (the leftover ranks
folded into dp), and ``distributed_model`` / ``distributed_optimizer``
pick the wrappers: ``PipelineParallel`` over a ``PipelineLayer`` when
pp > 1, else ``HybridParallelModel``; ``HybridParallelOptimizer``
(stage-1 sharding when the sharding degree is above 1, the hybrid
clip) under the strategy's meta-optimizers. The worker queries answer
for this process.
"""

from __future__ import annotations

from typing import Optional

from .. import env as _env
from ..topology import (CommunicateTopology, HybridCommunicateGroup,
                        set_hybrid_communicate_group,
                        get_hybrid_communicate_group)
from .distributed_strategy import DistributedStrategy
from ...parallel import mesh as _mesh

_state = {"strategy": None, "initialized": False}


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, log_level=None, *,
         device=None):
    """``fleet.init``: parse the strategy, join the process group, build
    the mesh and the topology. ``device`` goes to ``init_parallel_env``
    (``None``: NCCL on the card; ``"cpu"``: gloo)."""
    strategy = strategy or DistributedStrategy()
    _state["strategy"] = strategy
    _env.init_parallel_env(device=device)
    degrees = strategy.degrees()
    order = strategy.hybrid_configs.get("order", list(_mesh.HYBRID_ORDER))
    mesh = _mesh.build_mesh(degrees, order=order)
    _mesh.set_global_mesh(mesh)
    actual = {ax: mesh.shape[ax] for ax in mesh.axis_names}
    dims = [actual.get(ax, 1) for ax in _mesh.HYBRID_ORDER]
    topo = CommunicateTopology(list(_mesh.HYBRID_ORDER), dims)
    set_hybrid_communicate_group(HybridCommunicateGroup(topo))
    _state["initialized"] = True
    return None


def fleet_initialized() -> bool:
    return _state["initialized"]


def get_strategy() -> Optional[DistributedStrategy]:
    return _state["strategy"]


def _apply_recompute(model, checkpoints) -> None:
    """Wrap the named sublayers' forward in ``fleet.recompute`` (dotted
    paths such as ``"llama.layers.0"``)."""
    from .recompute import recompute as _rc
    for path in checkpoints:
        sub = model
        for part in str(path).split("."):
            sub = sub[int(part)] if part.isdigit() else getattr(sub, part)
        if getattr(sub, "_fleet_recompute_wrapped", False):
            continue
        orig = sub.forward

        def wrapped(*args, _orig=orig, **kwargs):
            return _rc(_orig, *args, **kwargs)

        sub.forward = wrapped
        sub._fleet_recompute_wrapped = True


def distributed_model(model):
    """The model wrapped for the active parallelism, after the
    strategy's model-side transforms (amp O2 cast, recompute)."""
    from ..meta_parallel.pipeline_parallel import PipelineParallel
    from ..meta_parallel.pp_layers import PipelineLayer
    from ..meta_parallel.parallel_wrapper import HybridParallelModel

    hcg = get_hybrid_communicate_group()
    strategy = _state["strategy"] or DistributedStrategy()
    if strategy.amp and strategy.amp_configs.get("level") == "O2":
        from ... import amp as _amp
        _amp.decorate(models=model, level="O2",
                      dtype=strategy.amp_configs.get("dtype", "bfloat16"))
    if strategy.recompute:
        ckpts = strategy.recompute_configs.get("checkpoints", [])
        if ckpts:
            _apply_recompute(model, ckpts)
    if hcg is not None and hcg.get_pipe_parallel_world_size() > 1:
        if not isinstance(model, PipelineLayer):
            raise TypeError(
                "pp_degree > 1 requires the model to be a PipelineLayer "
                "(parity with the reference)")
        return PipelineParallel(model, hcg, strategy)
    return HybridParallelModel(model, hcg, strategy)


def distributed_optimizer(optimizer, strategy=None):
    """The strategy's meta-optimizers around the hybrid wrapper."""
    from .hybrid_optimizer import HybridParallelOptimizer
    from . import meta_optimizers as MO

    hcg = get_hybrid_communicate_group()
    strategy = strategy or _state["strategy"] or DistributedStrategy()
    opt = optimizer
    if getattr(strategy, "lamb", False):
        opt = MO.LambOptimizer(opt, getattr(strategy, "lamb_configs", None))
    opt = HybridParallelOptimizer(opt, hcg, strategy)
    if strategy.amp:
        opt = MO.AMPOptimizer(opt, strategy.amp_configs)
    if strategy.recompute:
        opt = MO.RecomputeOptimizer(opt, strategy.recompute_configs)
    if getattr(strategy, "gradient_merge", False):
        c = getattr(strategy, "gradient_merge_configs", {})
        opt = MO.GradientMergeOptimizer(opt, k_steps=c.get("k_steps", 1),
                                        avg=c.get("avg", True))
    if getattr(strategy, "localsgd", False):
        c = getattr(strategy, "localsgd_configs", {})
        opt = MO.LocalSGDOptimizer(opt, k_steps=c.get("k_steps", 1),
                                   begin_step=c.get("begin_step", 1))
    return opt


def get_hybrid_communicate_group_():
    return get_hybrid_communicate_group()


def worker_index() -> int:
    return _mesh.world_rank()


def worker_num() -> int:
    return _mesh.world_size()


def is_first_worker() -> bool:
    return worker_index() == 0


def barrier_worker():
    from ..collective import barrier
    barrier()
