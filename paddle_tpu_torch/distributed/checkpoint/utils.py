"""Checkpoint helpers — counterpart of
``paddle_tpu/distributed/checkpoint/utils.py``.

Also the single place checkpoint files are written: :func:`atomic_write`
stages to ``<path>.tmp``, fsyncs, CRC32s the bytes from disk and renames
into place, so a crash at any point leaves the old file or nothing,
never a torn write (``tests/test_torch_checkpoint.py`` checks that no
other write-mode ``open`` exists under this package).

Values are Tensors, torch tensors (on the card or the host) or numpy
arrays. numpy has no bfloat16, so :func:`to_array` gives a bfloat16
tensor as its raw ``uint16`` bits and says so; checkpoints store it so,
under the dtype name ``"bfloat16"``, as the reference's do.
"""

from __future__ import annotations

import os
import zlib
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ...core.tensor import Tensor

BF16 = "bfloat16"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed checksum verification or cannot be decoded
    (truncated shard, torn metadata, bad pickle)."""


def file_crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename into it is durable (POSIX; no-op where
    directories cannot be opened)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, writer: Callable, do_fsync: bool = True) -> int:
    """Durably write ``path`` via stage-then-rename; returns the CRC32.

    ``writer(fileobj)`` produces the bytes into a ``<path>.tmp`` handle;
    the data is fsynced, checksummed from disk, then renamed over ``path``
    (atomic on POSIX): readers never observe a partial file.
    """
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        writer(f)
        f.flush()
        if do_fsync:
            os.fsync(f.fileno())
    crc = file_crc32(tmp)
    os.replace(tmp, path)
    return crc


def verify_crc32(path: str, expected: int) -> None:
    actual = file_crc32(path)
    if actual != int(expected):
        raise CheckpointCorruptError(
            f"checksum mismatch for {path!r}: recorded {int(expected)}, "
            f"on-disk {actual} (truncated or corrupted shard)")


def flatten_state_dict(state_dict: Dict) -> Tuple[Dict[str, Any],
                                                   Dict[str, Tuple[str, ...]]]:
    """Flatten a nested state dict into {joined_key: value}; returns the flat
    dict and the mapping flat_key -> original key path."""
    flat: Dict[str, Any] = {}
    mapping: Dict[str, Tuple[str, ...]] = {}

    def rec(prefix: Tuple[str, ...], d):
        if isinstance(d, dict):
            for k, v in d.items():
                rec(prefix + (str(k),), v)
        else:
            key = ".".join(prefix)
            if key in flat:
                raise ValueError(f"duplicate flat key {key!r}")
            flat[key] = d
            mapping[key] = prefix
    rec((), state_dict)
    return flat, mapping


def unflatten_state_dict(flat: Dict[str, Any],
                         mapping: Dict[str, Tuple[str, ...]]) -> Dict:
    out: Dict = {}
    for key, value in flat.items():
        path = mapping.get(key, (key,))
        d = out
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = value
    return out


def is_tensor(value) -> bool:
    """Whether a state-dict leaf is array data (a Tensor, torch tensor or
    anything with a ``shape``), not a scalar riding in the metadata."""
    return isinstance(value, (Tensor, torch.Tensor)) or hasattr(value,
                                                                "shape")


def to_array(value) -> Tuple[np.ndarray, str]:
    """``(host array, dtype name)`` of a Tensor / torch tensor / numpy
    array / scalar: a card tensor is copied to the host once, a host one
    is viewed; a bfloat16 value comes back as its ``uint16`` bits named
    ``"bfloat16"``."""
    if isinstance(value, Tensor):
        value = value._value
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(
                np.uint16), BF16
        return t.numpy(), str(t.numpy().dtype)
    a = np.asarray(value)
    if a.dtype.name == BF16:                 # ml_dtypes, from the reference
        return a.view(np.uint16), BF16
    return a, str(a.dtype)


def to_torch(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """The torch tensor of a stored array of dtype name ``dtype`` (a
    view where numpy and torch share the type; ``"bfloat16"`` from its
    ``uint16`` bits)."""
    if dtype == BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def offsets_from_index(index, shape) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """``(global_offset, local_shape)`` of a shard ``index`` (a tuple of
    slices over the global ``shape``, as ``SlabSharding.index`` gives
    a rank's slab)."""
    if not shape:
        return (), ()
    offs, lshape = [], []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        offs.append(start)
        lshape.append(stop - start)
    return tuple(offs), tuple(lshape)
