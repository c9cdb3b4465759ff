"""Versioned, checksummed wire format for cross-host serving traffic —
counterpart of ``paddle_tpu/serving/wire.py``; a frame either package
encodes, the other decodes, and the same content frames to the same
bytes.

Everything that crosses a host boundary — RPC commands, flight
snapshots, page-granular KV payloads, compiled grammars — rides ONE
self-describing frame so a single decoder guards every entry point:

.. code-block:: text

    offset  size  field
    0       4     magic  b"PDLW"
    4       2     version (u16 LE)   — WIRE_VERSION; skew is refused
    6       2     reserved (u16 LE)  — zero; room for flags
    8       4     header_len (u32 LE) — JSON header byte length
    12      4     crc32 (u32 LE)     — over header + payload
    16      H     header: UTF-8 JSON {kind, meta, arrays}
    16+H    *     payload: the arrays' raw bytes, concatenated in order

The header's ``arrays`` entry is a list of ``{name, dtype, shape,
nbytes}`` records; the payload is each array's C-contiguous bytes in
listed order. Integrity first: :func:`decode_message` verifies magic,
version and CRC32 *before* any JSON is parsed or any bytes reach a KV
pool, so a truncated or corrupted transfer dies at the boundary with a
structured :class:`WireError` and the destination stays byte-conserved
by construction.

Only stdlib + numpy. bfloat16 travels as its raw 16-bit patterns under
the JAX package's dtype tag ``"bfloat16"``; the port's host carrier is
:data:`~paddle_tpu_torch.core.host_arrays.BFLOAT16` (no ``ml_dtypes``).
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.host_arrays import BFLOAT16

MAGIC = b"PDLW"
WIRE_VERSION = 1

_PREAMBLE = struct.Struct("<4sHHII")   # magic, version, reserved, hlen, crc
PREAMBLE_NBYTES = _PREAMBLE.size

#: WireError codes, in the order the decoder checks them
WIRE_ERROR_CODES = ("truncated", "bad_magic", "version_skew",
                    "checksum_mismatch", "schema")


class WireError(Exception):
    """Structured decode failure. ``code`` is one of
    :data:`WIRE_ERROR_CODES`; ``detail`` is the human-readable half."""

    def __init__(self, code: str, detail: str = ""):
        if code not in WIRE_ERROR_CODES:
            raise ValueError(f"unknown wire error code {code!r}")
        self.code = code
        self.detail = detail
        super().__init__(f"{code}: {detail}" if detail else code)

    def as_dict(self) -> Dict[str, str]:
        return {"error": "wire", "code": self.code, "detail": self.detail}


# -- encode -----------------------------------------------------------------

def encode_message(kind: str, meta: Optional[dict] = None,
                   arrays: Optional[Dict[str, np.ndarray]] = None) -> bytes:
    """Frame ``kind`` + JSON-safe ``meta`` + named numpy ``arrays`` into
    one wire message (layout in the module docstring)."""
    meta = meta or {}
    arrays = arrays or {}
    specs: List[dict] = []
    chunks: List[bytes] = []
    for name, arr in arrays.items():
        a = np.ascontiguousarray(arr)
        # bfloat16 carriers (the port's record, or an ml_dtypes array)
        # stringify as opaque void ('|V2'); the tag "bfloat16" names them
        if a.dtype == BFLOAT16:
            dstr = "bfloat16"
        else:
            dstr = a.dtype.str if a.dtype.kind != "V" else a.dtype.name
        specs.append({"name": str(name), "dtype": dstr,
                      "shape": list(a.shape), "nbytes": int(a.nbytes)})
        chunks.append(a.tobytes())
    header = json.dumps({"kind": kind, "meta": meta, "arrays": specs},
                        separators=(",", ":")).encode("utf-8")
    payload = b"".join(chunks)
    crc = zlib.crc32(header + payload) & 0xFFFFFFFF
    # lazy: this module is importable with nothing but stdlib + numpy
    # (cross-host receivers), so the journal tap must not promote
    # observability into a hard import-time dependency
    from ..observability.journal import journal as _journal
    from ..observability.journal import journal_armed as _armed
    if _armed[0]:
        _journal.note_wire(kind=kind, crc=int(crc),
                           nbytes=len(header) + len(payload))
    return (_PREAMBLE.pack(MAGIC, WIRE_VERSION, 0, len(header), crc)
            + header + payload)


def _dtype(dstr: str) -> np.dtype:
    """Resolve a wire dtype string; ``bfloat16`` resolves to the host
    carrier :data:`~paddle_tpu_torch.core.host_arrays.BFLOAT16`."""
    if dstr == "bfloat16":
        return BFLOAT16
    return np.dtype(dstr)


# -- decode -----------------------------------------------------------------

def decode_message(buf: bytes) -> Tuple[str, dict, Dict[str, np.ndarray]]:
    """Verify and unpack one frame -> ``(kind, meta, arrays)``. Raises
    :class:`WireError` (never a bare struct/json/numpy error); integrity
    checks run before any content is interpreted."""
    if len(buf) < PREAMBLE_NBYTES:
        raise WireError("truncated",
                        f"{len(buf)} bytes < {PREAMBLE_NBYTES} preamble")
    magic, version, _reserved, hlen, crc = _PREAMBLE.unpack_from(buf)
    if magic != MAGIC:
        raise WireError("bad_magic", repr(magic))
    if version != WIRE_VERSION:
        raise WireError(
            "version_skew",
            f"peer speaks wire v{version}, this host v{WIRE_VERSION}")
    body = buf[PREAMBLE_NBYTES:]
    if len(body) < hlen:
        raise WireError("truncated",
                        f"header needs {hlen} bytes, {len(body)} left")
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise WireError("checksum_mismatch",
                        f"crc32 over {len(body)} body bytes")
    try:
        header = json.loads(body[:hlen].decode("utf-8"))
        kind = header["kind"]
        meta = header["meta"]
        specs = header["arrays"]
    except (ValueError, KeyError, UnicodeDecodeError) as e:
        raise WireError("schema", f"bad header: {e}")
    arrays: Dict[str, np.ndarray] = {}
    off = hlen
    for spec in specs:
        try:
            name, dstr = spec["name"], spec["dtype"]
            shape, nbytes = tuple(spec["shape"]), int(spec["nbytes"])
        except (TypeError, KeyError, ValueError) as e:
            raise WireError("schema", f"bad array spec: {e}")
        raw = body[off:off + nbytes]
        if len(raw) < nbytes:
            raise WireError("truncated",
                            f"array {name!r} needs {nbytes} bytes, "
                            f"{len(raw)} left")
        try:
            arrays[name] = np.frombuffer(raw, dtype=_dtype(dstr)
                                         ).reshape(shape).copy()
        except (TypeError, ValueError) as e:
            raise WireError("schema", f"array {name!r}: {e}")
        off += nbytes
    return kind, meta, arrays


# -- KV page payloads -------------------------------------------------------

def encode_pages(kind: str, meta: dict,
                 k_slabs: Sequence[np.ndarray],
                 v_slabs: Sequence[np.ndarray]) -> bytes:
    """Frame per-page K/V slab pairs (``pool.export_page`` output) as
    ``k_slabs``/``v_slabs`` stacked arrays (bfloat16 travels by dtype
    tag — see :func:`encode_message`); ``meta['kv_dtype']`` records the
    pool dtype so the importer can refuse a mismatched pool early."""
    meta = dict(meta)
    meta["n_pages"] = len(k_slabs)
    arrays: Dict[str, np.ndarray] = {}
    if k_slabs:
        ks, vs = np.stack(k_slabs), np.stack(v_slabs)
        # ml_dtypes' bfloat16 renders as '<V2': the carrier says the same
        meta.setdefault("kv_dtype",
                        "<V2" if ks.dtype == BFLOAT16 else ks.dtype.str)
        arrays = {"k_slabs": ks, "v_slabs": vs}
    return encode_message(kind, meta, arrays)


def decode_pages(meta: dict, arrays: Dict[str, np.ndarray]
                 ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Unstack a pages frame back into per-page slab lists."""
    n = int(meta.get("n_pages", 0))
    if n == 0:
        return [], []
    try:
        ks, vs = arrays["k_slabs"], arrays["v_slabs"]
    except KeyError as e:
        raise WireError("schema", f"pages frame missing {e}")
    if ks.shape[0] != n or vs.shape[0] != n:
        raise WireError("schema",
                        f"n_pages={n} but slab stacks are "
                        f"{ks.shape[0]}/{vs.shape[0]} deep")
    return list(ks), list(vs)


# -- telemetry frames -------------------------------------------------------

#: telemetry frame schema version — independent of WIRE_VERSION so the
#: envelope and the observability payload can evolve separately; skew is
#: refused at :func:`telemetry_from_wire` with the same structured error
TELEMETRY_VERSION = 1


def telemetry_to_wire(frame: dict) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Split a telemetry frame (``observability.federation.
    collect_telemetry`` output) into JSON meta + arrays: span timestamps
    travel as int64 arrays, everything else rides the JSON header."""
    spans = frame.get("spans") or []
    meta = {
        "telemetry_version": TELEMETRY_VERSION,
        "telemetry": {k: v for k, v in frame.items() if k != "spans"},
        "span_names": [s["name"] for s in spans],
        "span_types": [s.get("event_type", "UserDefined") for s in spans],
        "span_traces": [s.get("trace_id", "") for s in spans],
        "span_args": [s.get("args") for s in spans],
    }
    arrays: Dict[str, np.ndarray] = {}
    if spans:
        arrays["span_start_ns"] = np.asarray(
            [s["start_ns"] for s in spans], np.int64)
        arrays["span_end_ns"] = np.asarray(
            [s["end_ns"] for s in spans], np.int64)
    return meta, arrays


def telemetry_from_wire(meta: dict, arrays: Dict[str, np.ndarray]) -> dict:
    """Rebuild and validate a telemetry frame. Version skew and missing
    or inconsistent columns die here with a structured
    :class:`WireError` — a malformed frame never reaches a mirror."""
    version = meta.get("telemetry_version")
    if version != TELEMETRY_VERSION:
        raise WireError(
            "version_skew",
            f"peer telemetry v{version}, this host v{TELEMETRY_VERSION}")
    try:
        base = dict(meta["telemetry"])
        names = list(meta["span_names"])
        types = list(meta["span_types"])
        traces = list(meta["span_traces"])
        argss = list(meta["span_args"])
    except (KeyError, TypeError) as e:
        raise WireError("schema", f"telemetry frame missing {e}")
    for key in ("host_id", "pid", "seq", "t_ns"):
        if key not in base:
            raise WireError("schema", f"telemetry frame missing {key!r}")
    n = len(names)
    if not (len(types) == len(traces) == len(argss) == n):
        raise WireError("schema",
                        "telemetry span columns disagree on length")
    spans = []
    if n:
        try:
            starts, ends = arrays["span_start_ns"], arrays["span_end_ns"]
        except KeyError as e:
            raise WireError("schema", f"telemetry frame missing {e}")
        if starts.shape[0] != n or ends.shape[0] != n:
            raise WireError(
                "schema", f"{n} spans but timestamp arrays are "
                f"{starts.shape[0]}/{ends.shape[0]} deep")
        for i in range(n):
            spans.append({"name": names[i], "event_type": types[i],
                          "start_ns": int(starts[i]),
                          "end_ns": int(ends[i]),
                          "trace_id": traces[i], "args": argss[i]})
    base["spans"] = spans
    return base


def encode_telemetry(frame: dict) -> bytes:
    """One standalone ``telemetry`` wire frame (the command reply embeds
    the same meta/arrays inside its reply envelope instead)."""
    meta, arrays = telemetry_to_wire(frame)
    return encode_message("telemetry", meta, arrays)


def decode_telemetry(buf: bytes) -> dict:
    kind, meta, arrays = decode_message(buf)
    if kind != "telemetry":
        raise WireError("schema",
                        f"expected a telemetry frame, got {kind!r}")
    return telemetry_from_wire(meta, arrays)


# -- compiled grammars ------------------------------------------------------

def grammar_to_wire(dfa) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Split a ``TokenDFA`` into JSON meta + arrays for a frame."""
    meta = {"start": int(dfa.start), "eos_token_id": int(dfa.eos_token_id),
            "pattern": dfa.pattern, "fingerprint": dfa.fingerprint}
    return meta, {"grammar_trans": np.asarray(dfa.trans, np.int32),
                  "grammar_accepting": np.asarray(dfa.accepting, bool)}


def grammar_from_wire(meta: dict, arrays: Dict[str, np.ndarray]):
    """Rebuild the ``TokenDFA`` a peer framed with
    :func:`grammar_to_wire` (lazy import: wire needs numpy alone)."""
    from ..inference.constrain import TokenDFA
    try:
        return TokenDFA(trans=arrays["grammar_trans"],
                        accepting=arrays["grammar_accepting"],
                        start=int(meta["start"]),
                        eos_token_id=int(meta["eos_token_id"]),
                        pattern=meta.get("pattern", ""),
                        fingerprint=meta.get("fingerprint", ""))
    except KeyError as e:
        raise WireError("schema", f"grammar frame missing {e}")
