"""Checkpoint load — counterpart of
``paddle_tpu/distributed/checkpoint/load_state_dict.py``.

The metadata of every rank is merged (:func:`read_metadata`), each data
file's CRC32 is verified once, on first use (:class:`_DataFiles`), and
every target tensor is assembled from its saved pieces by offset into
its global shape (l.156-175), so a checkpoint the reference wrote
sharded (say over an mp 4 mesh) loads here whole. Results are copied
into the targets in place, on their device and in their dtype.

The reference pickles its metadata under
``paddle_tpu.distributed.checkpoint.metadata``: :class:`_Unpickler` maps
those three classes to this package's and never imports the JAX
package; any other class of it is a :class:`CheckpointCorruptError`.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from ...core.tensor import Tensor
from . import metadata as _metadata
from ...parallel.mesh import slab_info
from .metadata import Metadata
from .utils import (CheckpointCorruptError, flatten_state_dict, is_tensor,
                    to_torch, verify_crc32)

_REFERENCE = "paddle_tpu.distributed.checkpoint.metadata"


class _Unpickler(pickle.Unpickler):
    """Unpickles the reference's metadata classes as this package's;
    refuses any other class of the JAX package."""

    def find_class(self, module, name):
        if module == _REFERENCE and name in (
                "Metadata", "LocalTensorMetadata", "LocalTensorIndex"):
            return getattr(_metadata, name)
        if module == "paddle_tpu" or module.startswith("paddle_tpu."):
            raise CheckpointCorruptError(
                f"checkpoint pickle names {module}.{name}, a class of the "
                "JAX package this package does not read")
        return super().find_class(module, name)


def unpickle(f):
    """``pickle.load`` through :class:`_Unpickler`."""
    return _Unpickler(f).load()


def _read_metadata(path: str, unique_id=None) -> Metadata:
    files = sorted(glob.glob(os.path.join(path, "*.metadata")))
    if not files:
        raise FileNotFoundError(f"no .metadata file under {path!r}")

    def uid_of(f):
        stem = os.path.basename(f)[: -len(".metadata")]
        # "{rank}_{uid}" (current) or bare "{uid}" (coordinator-style)
        return int(stem.rsplit("_", 1)[-1])

    if unique_id is None:
        unique_id = max(uid_of(f) for f in files)  # latest checkpoint wins
    files = [f for f in files if uid_of(f) == unique_id]
    if not files:
        raise FileNotFoundError(
            f"no .metadata for unique_id={unique_id} under {path!r}")
    merged = Metadata()
    for f in files:
        try:
            with open(f, "rb") as fh:
                m = unpickle(fh)
        except CheckpointCorruptError:
            raise
        except Exception as e:  # truncated/torn metadata = corrupt checkpoint
            raise CheckpointCorruptError(
                f"unreadable checkpoint metadata {f!r}: {e}") from e
        if not isinstance(m, Metadata):
            raise CheckpointCorruptError(
                f"{f!r} does not contain checkpoint Metadata "
                f"(got {type(m).__name__})")
        # each rank records only the shards it owns: the lists extend,
        # deduplicated by offset
        for key, shards in m.state_dict_metadata.items():
            have = merged.state_dict_metadata.setdefault(key, [])
            seen = {s.global_offset for s in have}
            have.extend(s for s in shards if s.global_offset not in seen)
        merged.storage_metadata.update(m.storage_metadata)
        merged.flat_mapping.update(m.flat_mapping)
        merged.aux.update(getattr(m, "aux", {}))
        merged.checksums.update(getattr(m, "checksums", {}))
    return merged


def read_metadata(path: str, unique_id=None) -> Metadata:
    """The merged metadata of every rank (the resilience layer builds a
    full-coverage load target from it)."""
    return _read_metadata(path, unique_id)


class _DataFiles:
    """Lazy npz readers, one per data file; each file's recorded CRC32 is
    verified once, on first open, before any shard from it is trusted."""

    def __init__(self, path: str, checksums: Optional[Dict[str, int]] = None):
        self.path = path
        self.checksums = checksums or {}
        self._files: Dict[str, "np.lib.npyio.NpzFile"] = {}
        self._dtypes: Dict[str, Dict[str, str]] = {}

    def _verify(self, name: str) -> None:
        if name in self.checksums:  # pre-checksum checkpoints: nothing to check
            verify_crc32(os.path.join(self.path, name), self.checksums[name])

    def read(self, ref: str) -> torch.Tensor:
        """The saved piece ``<file>::<array name>`` as a host tensor."""
        fname, name = ref.split("::", 1)
        if fname not in self._files:
            self._verify(fname + ".npz")
            self._verify(fname + ".dtypes")
            try:
                self._files[fname] = np.load(
                    os.path.join(self.path, fname + ".npz"))
                dt_path = os.path.join(self.path, fname + ".dtypes")
                with open(dt_path, "rb") as f:
                    self._dtypes[fname] = unpickle(f)
            except (CheckpointCorruptError, FileNotFoundError):
                raise
            except Exception as e:  # undecodable zip/pickle = corrupt shard
                raise CheckpointCorruptError(
                    f"unreadable shard file {fname!r} under "
                    f"{self.path!r}: {e}") from e
        try:
            arr = self._files[fname][name]
        except Exception as e:
            raise CheckpointCorruptError(
                f"shard {name!r} missing/undecodable in {fname!r}: {e}") from e
        return to_torch(arr, self._dtypes[fname].get(name, str(arr.dtype)))

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


def _assemble(data, storage, key, shards, gshape):
    """The global tensor ``key`` from its saved pieces (any layout)."""
    if len(shards) == 1 and tuple(shards[0].local_shape) == gshape:
        return data.read(storage[(key, shards[0].global_offset)])
    out = None
    for s in shards:
        piece = data.read(storage[(key, s.global_offset)])
        if out is None:
            out = torch.empty(gshape, dtype=piece.dtype)
        idx = tuple(slice(o, o + n) for o, n in
                    zip(s.global_offset, s.local_shape))
        out[idx] = piece.reshape(s.local_shape)
    return out


def load_state_dict(state_dict: Dict, path: str, process_group=None,
                    coordinator_rank: int = 0, unique_id=None,
                    offload: bool = False) -> None:
    """Fill ``state_dict``'s tensors (Tensors or torch tensors) in place
    from the checkpoint at ``path``, assembling saved pieces into each
    target's global shape; non-tensor values come from the metadata."""
    meta = _read_metadata(path, unique_id)
    data = _DataFiles(path, getattr(meta, "checksums", {}))
    flat, mapping = flatten_state_dict(state_dict)
    storage = {(i.tensor_key, i.global_offset): ref
               for i, ref in meta.storage_metadata.items()}

    def _assign_nested(key, value):
        path_keys = mapping.get(key, (key,))
        d = state_dict
        for p in path_keys[:-1]:
            d = d[p]
        d[path_keys[-1]] = value

    try:
        for key, target in flat.items():
            if not is_tensor(target):
                # non-tensor state rides in metadata aux
                if key in meta.aux:
                    _assign_nested(key, meta.aux[key])
                    continue
                raise KeyError(f"non-tensor key {key!r} not in checkpoint aux")
            shards = meta.state_dict_metadata.get(key)
            if shards is None:
                raise KeyError(
                    f"{key!r} not found in checkpoint {path!r} "
                    f"(available: {sorted(meta.state_dict_metadata)[:8]}...)")
            tv = target._value if isinstance(target, Tensor) else target
            if not isinstance(tv, torch.Tensor):
                # fail before any shard IO: an in-place fill needs a tensor
                raise TypeError(
                    f"load_state_dict target {key!r} must be a Tensor or a "
                    f"torch tensor (got {type(target).__name__})")
            ndim = len(shards[0].local_shape)
            gshape = [0] * ndim
            for s in shards:
                for d in range(ndim):
                    gshape[d] = max(gshape[d],
                                    s.global_offset[d] + s.local_shape[d])
            gshape = tuple(gshape)
            info = slab_info(tv)
            if info is not None:
                # a rank's slab: its pieces of the assembled tensor
                if info.global_shape != gshape:
                    raise ValueError(
                        f"shape mismatch for {key!r}: checkpoint {gshape}, "
                        f"target's global {info.global_shape}")
                full = _assemble(data, storage, key, shards, gshape)
                with torch.no_grad():
                    for local, off, shape in info.pieces:
                        tv[local].copy_(full[tuple(
                            slice(o, o + n) for o, n in zip(off, shape))])
                continue
            if tuple(tv.shape) != gshape:
                raise ValueError(
                    f"shape mismatch for {key!r}: checkpoint {gshape}, "
                    f"target {tuple(tv.shape)}")
            out = _assemble(data, storage, key, shards, gshape)
            with torch.no_grad():
                tv.copy_(out.reshape(gshape))
    finally:
        data.close()
