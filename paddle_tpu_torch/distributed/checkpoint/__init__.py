"""``paddle_tpu_torch.distributed.checkpoint`` — counterpart of
``paddle_tpu/distributed/checkpoint``: save and load in the reference's
layout (one process here; a sharded checkpoint of the reference loads
whole), async saves and the train state."""

from .save_state_dict import save_state_dict  # noqa: F401
from .load_state_dict import load_state_dict, read_metadata  # noqa: F401
from .metadata import LocalTensorIndex, LocalTensorMetadata, Metadata  # noqa: F401
from .utils import (flatten_state_dict, unflatten_state_dict,  # noqa: F401
                    CheckpointCorruptError)
from .async_save import async_save_state_dict, AsyncSaveFuture, TrainState  # noqa: F401
