"""Checkpoint metadata schema — the dataclasses of
``paddle_tpu/distributed/checkpoint/metadata.py``: a global ``Metadata``
maps every tensor key to its saved shards (offset + shape + dtype) and
each shard to the data file holding it. A checkpoint the reference wrote
unpickles into these classes (``load_state_dict._Unpickler``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class LocalTensorMetadata:
    """One saved shard of a tensor: where it sits in the global tensor."""
    global_offset: Tuple[int, ...]
    local_shape: Tuple[int, ...]
    dtype: str


@dataclass(frozen=True)
class LocalTensorIndex:
    """Key of a saved shard (tensor name + its offset)."""
    tensor_key: str
    global_offset: Tuple[int, ...]


@dataclass
class Metadata:
    # tensor key -> all shards saved for it
    state_dict_metadata: Dict[str, List[LocalTensorMetadata]] = field(
        default_factory=dict)
    # shard -> "<data file>::<array name>" (relative to the checkpoint dir)
    storage_metadata: Dict[LocalTensorIndex, str] = field(default_factory=dict)
    # flat key -> the original (possibly nested) key path
    flat_mapping: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    # non-tensor state (ints, floats, strings), stored in the pickle itself
    aux: Dict[str, object] = field(default_factory=dict)
    # data-file name -> CRC32 of its bytes, verified before a shard is
    # trusted; absent on pre-checksum checkpoints (read with getattr)
    checksums: Dict[str, int] = field(default_factory=dict)
