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

Every file goes through :func:`.utils.atomic_write`. A whole tensor
is one shard at offset 0 (the reference's unsharded branch, l.82-91).
A rank's slab of a sharded tensor (tagged by ``parallel.mesh.
mark_slab``, as the hybrid step's params and moments are) is written
as its pieces at their global offsets, by the first replica only (the
reference's ``replica_id == 0``), so the checkpoint is one global
layout whatever the mesh: a load in one process assembles the global
tensors, and a load into another rank's slabs reads its pieces. A card
tensor is copied to the host once.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np

from ...core.tensor import Tensor
from ...parallel.mesh import slab_info
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
        info = slab_info(v)
        if info is None:
            pieces = [(tuple(slice(0, n) for n in arr.shape),
                       tuple([0] * arr.ndim), tuple(arr.shape))]
        elif info.writes:
            pieces = info.pieces
        else:
            continue                 # another rank writes this slab
        shards = meta.state_dict_metadata.setdefault(key, [])
        for local, off, shape in pieces:
            name = f"{key}|{'_'.join(map(str, off)) or 'scalar'}"
            payload[name] = np.ascontiguousarray(arr[local])
            dtypes[name] = dt
            shards.append(LocalTensorMetadata(off, tuple(shape), dt))
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
