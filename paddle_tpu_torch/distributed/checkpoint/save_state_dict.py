"""Checkpoint save — counterpart of
``paddle_tpu/distributed/checkpoint/save_state_dict.py``, in the
reference's layout so that either package reads the data files:

* ``<rank>_<uid>.distcp.npz``: one array a tensor, named
  ``<key>|<offsets>`` (``"0_0"``, or ``"scalar"`` for 0-d), a bfloat16
  one as its ``uint16`` bits;
* ``<rank>_<uid>.distcp.dtypes``: a pickled ``{array name: dtype name}``
  (``"bfloat16"`` marks the bit views);
* ``<rank>_<uid>.metadata``: the pickled :class:`.metadata.Metadata`,
  written last: its presence is the rank's commit point, and it holds
  the CRC32 of the two data files.

Every file goes through :func:`.utils.atomic_write`. In one process
every tensor is whole, so each is one shard at offset 0 (the reference's
unsharded branch, l.82-91); the sharded form comes with the distributed
slice. A card tensor is copied to the host once.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np

from ...core.tensor import Tensor
from .. import env as _env
from .metadata import LocalTensorIndex, LocalTensorMetadata, Metadata
from .utils import (atomic_write, flatten_state_dict, fsync_dir, is_tensor,
                    to_array)


def save_state_dict(state_dict: Dict, path: str,
                    process_group=None, coordinator_rank: int = 0,
                    unique_id: Optional[int] = None) -> None:
    """Write ``state_dict`` (possibly nested; values Tensors, torch
    tensors or arrays; other values ride in the metadata) as a
    checkpoint directory."""
    os.makedirs(path, exist_ok=True)
    rank = _env.get_rank()
    uid = 0 if unique_id is None else int(unique_id)

    flat, mapping = flatten_state_dict(state_dict)
    meta = Metadata(flat_mapping=mapping)
    data_file = f"{rank}_{uid}.distcp"
    payload: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}

    for key, value in flat.items():
        v = value._value if isinstance(value, Tensor) else value
        if not is_tensor(v):
            meta.aux[key] = v
            continue
        arr, dt = to_array(v)
        off = tuple([0] * arr.ndim)
        name = f"{key}|{'_'.join(map(str, off)) or 'scalar'}"
        payload[name] = arr
        dtypes[name] = dt
        meta.state_dict_metadata[key] = [
            LocalTensorMetadata(off, tuple(arr.shape), dt)]
        meta.storage_metadata[LocalTensorIndex(key, off)] = \
            f"{data_file}::{name}"

    # data files first, metadata last (the commit point); the CRC32s let
    # load verify each data file before trusting a shard
    npz_name = data_file + ".npz"
    meta.checksums[npz_name] = atomic_write(
        os.path.join(path, npz_name), lambda f: np.savez(f, **payload))
    meta.checksums[f"{data_file}.dtypes"] = atomic_write(
        os.path.join(path, f"{data_file}.dtypes"),
        lambda f: pickle.dump(dtypes, f))
    atomic_write(os.path.join(path, f"{rank}_{uid}.metadata"),
                 lambda f: pickle.dump(meta, f))
    fsync_dir(path)
