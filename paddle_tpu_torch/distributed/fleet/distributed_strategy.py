"""DistributedStrategy — counterpart of
``paddle_tpu/distributed/fleet/distributed_strategy.py``: a plain config
with the reference's key names — ``hybrid_configs`` (dp/mp/pp/sharding/
sep degrees, micro-batch settings and the validated ``pp_configs``),
``amp_configs``, ``recompute_configs``, ``sharding_configs`` and
``tensor_parallel_configs``, with ``degrees()``.
"""

from __future__ import annotations

from typing import Any, Dict


_HYBRID_DEFAULTS = {
    "dp_degree": 1,
    "mp_degree": 1,
    "pp_degree": 1,
    "sharding_degree": 1,
    "sep_degree": 1,
    "ep_degree": 1,
    "micro_batch_size": 1,
    "accumulate_steps": 1,
    "order": ["dp", "pp", "sharding", "sep", "mp"],
    # reference pp_configs carries schedule options (schedule_mode in the
    # reference proto); here it selects the compiled pipeline program:
    # "fill_drain" (interleaved when virtual_pp > 1) or "1f1b"
    "pp_configs": {"schedule": "fill_drain", "virtual_pp": 1},
}

_AMP_DEFAULTS = {
    "init_loss_scaling": 2.0 ** 15,
    "incr_every_n_steps": 1000,
    "decr_every_n_nan_or_inf": 2,
    "incr_ratio": 2.0,
    "decr_ratio": 0.5,
    "use_dynamic_loss_scaling": True,
    "custom_white_list": [],
    "custom_black_list": [],
    "level": "O1",
    "dtype": "bfloat16",
    "use_fp16_guard": False,
}

_RECOMPUTE_DEFAULTS = {
    "checkpoints": [],
    "enable_offload": False,
    "checkpoint_shape": [],
}

_SHARDING_DEFAULTS = {
    "sharding_degree": 1,
    "stage": 1,
    "split_param": False,
    "comm_overlap": True,
    "offload": False,
}

_TP_DEFAULTS = {
    "tensor_parallel_degree": 1,
    "tensor_init_seed": -1,
    "sequence_parallel": False,
}


class DistributedStrategy:
    def __init__(self):
        self._hybrid_configs = dict(_HYBRID_DEFAULTS)
        self._hybrid_configs["pp_configs"] = dict(
            _HYBRID_DEFAULTS["pp_configs"])
        self._amp = False
        self._amp_configs = dict(_AMP_DEFAULTS)
        self._recompute = False
        self._recompute_configs = dict(_RECOMPUTE_DEFAULTS)
        self._sharding = False
        self._sharding_configs = dict(_SHARDING_DEFAULTS)
        self._tensor_parallel_configs = dict(_TP_DEFAULTS)
        self.find_unused_parameters = False
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.lamb_configs = {"lamb_weight_decay": 0.01,
                             "exclude_from_weight_decay": []}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1, "begin_step": 1}
        self.heter_ccl_mode = False
        self.without_graph_optimization = True

    # hybrid ---------------------------------------------------------------
    @property
    def hybrid_configs(self) -> Dict[str, Any]:
        return self._hybrid_configs

    @hybrid_configs.setter
    def hybrid_configs(self, configs: Dict[str, Any]):
        for k, v in configs.items():
            if k not in _HYBRID_DEFAULTS:
                raise ValueError(f"unknown hybrid config key {k!r}")
            if k == "pp_configs":
                unknown = set(v) - set(_HYBRID_DEFAULTS["pp_configs"])
                if unknown:
                    raise ValueError(
                        f"unknown pp_configs key(s) {sorted(unknown)}")
                # partial update against the INSTANCE's current value
                merged = dict(self._hybrid_configs["pp_configs"])
                merged.update(v)
                if merged["schedule"] not in ("fill_drain", "1f1b"):
                    raise ValueError(
                        f"pp_configs.schedule must be 'fill_drain' or "
                        f"'1f1b', got {merged['schedule']!r}")
                v = merged
            self._hybrid_configs[k] = v

    def pipeline_schedule(self) -> str:
        """Compiled pipeline schedule for the hybrid train step; consumed by
        model builders as build_hybrid_train_step(pipeline_schedule=...)."""
        return self._hybrid_configs["pp_configs"]["schedule"]

    def virtual_pp_degree(self) -> int:
        return int(self._hybrid_configs["pp_configs"]["virtual_pp"])

    def degrees(self) -> Dict[str, int]:
        h = self._hybrid_configs
        return {
            "dp": int(h["dp_degree"]),
            "pp": int(h["pp_degree"]),
            "sharding": int(h["sharding_degree"]),
            "sep": int(h["sep_degree"]),
            "mp": int(h["mp_degree"]),
        }

    # amp ------------------------------------------------------------------
    @property
    def amp(self) -> bool:
        return self._amp

    @amp.setter
    def amp(self, flag: bool):
        self._amp = bool(flag)

    @property
    def amp_configs(self):
        return self._amp_configs

    @amp_configs.setter
    def amp_configs(self, configs):
        self._amp_configs.update(configs)

    # recompute ------------------------------------------------------------
    @property
    def recompute(self) -> bool:
        return self._recompute

    @recompute.setter
    def recompute(self, flag: bool):
        self._recompute = bool(flag)

    @property
    def recompute_configs(self):
        return self._recompute_configs

    @recompute_configs.setter
    def recompute_configs(self, configs):
        self._recompute_configs.update(configs)

    # sharding -------------------------------------------------------------
    @property
    def sharding(self) -> bool:
        return self._sharding

    @sharding.setter
    def sharding(self, flag: bool):
        self._sharding = bool(flag)

    @property
    def sharding_configs(self):
        return self._sharding_configs

    @sharding_configs.setter
    def sharding_configs(self, configs):
        self._sharding_configs.update(configs)

    # tp -------------------------------------------------------------------
    @property
    def tensor_parallel_configs(self):
        return self._tensor_parallel_configs

    @tensor_parallel_configs.setter
    def tensor_parallel_configs(self, configs):
        self._tensor_parallel_configs.update(configs)

    def __repr__(self):
        return (f"DistributedStrategy(hybrid={self._hybrid_configs}, "
                f"amp={self._amp}, recompute={self._recompute}, "
                f"sharding={self._sharding})")
