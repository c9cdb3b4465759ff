"""Pipeline-layer description and partitioning — counterpart of
``paddle_tpu/distributed/meta_parallel/pp_layers.py``.

``PipelineLayer`` builds every entry of its layer list in order (so a
seeded model draws the same weights whatever the stage count) and
splits the list into ``num_stages`` contiguous segments
(``seg_method`` ``"uniform"``); a pipeline stage (a pp rank of
``PipelineParallel``) runs only its segment, :meth:`get_stage_layers`.
``SharedLayerDesc`` entries with one key share the first one's weight.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

from ...nn.layer import Layer, LayerList
from ..topology import get_hybrid_communicate_group


class LayerDesc:
    def __init__(self, layer_cls, *inputs, **kwargs):
        self.layer_cls = layer_cls
        self.inputs = inputs
        self.kwargs = kwargs
        if not issubclass(layer_cls, Layer):
            raise TypeError("LayerDesc expects an nn.Layer subclass")

    def build_layer(self) -> Layer:
        return self.layer_cls(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """A weight-tied layer that appears in several stages (an embedding
    and the output head): every instance shares the first one's
    ``shared_weight_attr`` parameter."""

    def __init__(self, key, layer_cls, *inputs, forward_func=None,
                 shared_weight_attr="weight", **kwargs):
        super().__init__(layer_cls, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(Layer):
    """The whole layer list and its stage partition."""

    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 topology=None, loss_fn=None, seg_method="uniform",
                 recompute_interval=0, **kwargs):
        super().__init__()
        self._loss_fn = loss_fn
        self._recompute_interval = recompute_interval
        hcg = get_hybrid_communicate_group()
        if num_stages is None and hcg is not None:
            num_stages = hcg.get_pipe_parallel_world_size()
        self._num_stages = max(int(num_stages or 1), 1)
        self._descs = list(layers)
        self._shared_instances = {}
        self._shared_params = {}
        built: List[Any] = []
        for d in self._descs:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name in self._shared_instances:
                    src = self._shared_instances[d.layer_name]
                    inst = d.build_layer()
                    setattr(inst, d.shared_weight_attr,
                            getattr(src, d.shared_weight_attr))
                else:
                    inst = d.build_layer()
                    self._shared_instances[d.layer_name] = inst
                    self._shared_params[d.layer_name] = getattr(
                        inst, d.shared_weight_attr)
                inst._pp_forward_func = d.forward_func
                built.append(inst)
            elif isinstance(d, LayerDesc):
                built.append(d.build_layer())
            elif isinstance(d, Layer) or callable(d):
                built.append(d)
            else:
                raise TypeError(f"invalid pipeline entry {d!r}")
        self.run_function = built
        self._layers_holder = LayerList([l for l in built
                                         if isinstance(l, Layer)])
        self._stage_bounds = self._partition(len(built), self._num_stages,
                                             seg_method)

    @staticmethod
    def _partition(n_layers: int, n_stages: int, seg_method: str) -> List[int]:
        """Uniform split bounds (``n_stages + 1`` of them)."""
        base = n_layers // n_stages
        extra = n_layers % n_stages
        bounds = [0]
        for s in range(n_stages):
            bounds.append(bounds[-1] + base + (1 if s < extra else 0))
        return bounds

    def get_stage_layers(self, stage_id: int) -> List[Any]:
        lo, hi = self._stage_bounds[stage_id], self._stage_bounds[stage_id + 1]
        return self.run_function[lo:hi]

    @property
    def num_stages(self) -> int:
        return self._num_stages

    @staticmethod
    def _run(fns, x):
        for fn in fns:
            x = fn(x) if not isinstance(x, tuple) else fn(*x)
        return x

    def forward_stage(self, stage_id: int, x):
        """Segment ``stage_id``'s layers on ``x``."""
        return self._run(self.get_stage_layers(stage_id), x)

    def forward(self, x):
        return self._run(self.run_function, x)
