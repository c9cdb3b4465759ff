"""Counterpart of ``paddle_tpu/distributed/launch``: the helpers
``spawn`` uses (``context.free_port``/``free_ports``/``node_ip``/
``detect_devices``, ``job.build_trainer_env``). The launch CLI
(``launch``, ``python -m ...launch``), its controller and its master
come with the context-parallelism, MoE and launch slice and raise."""

from . import context, job  # noqa: F401


def launch(argv=None) -> int:
    from ...ops._common import not_ported
    raise not_ported("the launch CLI", "Distributed III")
