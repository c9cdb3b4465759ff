"""The distributed launcher — counterpart of
``paddle_tpu/distributed/launch``: ``python -m
paddle_tpu_torch.distributed.launch [options] train.py [args]``.

One trainer process per local card by default (``detect_devices``: the
CUDA device count), each given the reference's ``PADDLE_*`` contract
(``job.build_trainer_env``) and its card (``FLAGS_selected_devices``);
``init_parallel_env`` then joins NCCL. ``--devices cpu`` (or a node
without a card) runs ``--nproc_per_node`` ranks on the CPU, which join
gloo. Across nodes the rendezvous is the native ``TCPStore``
(``master.StoreMaster``); elastic recovery restarts dead trainers in
place, or the whole pod at a new generation, up to ``--max_restart``
times (``controller.CollectiveController``).
"""

from . import context, job  # noqa: F401
from .main import launch  # noqa: F401
