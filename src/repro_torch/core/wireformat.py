"""Bytes-level wire container for protocol objects (DESIGN.md §9).

One format for everything that crosses a process boundary — keys,
queries, results, encrypted corpora, persisted collections: an npz
archive whose `__wire__` entry is a JSON header `{kind, version, meta}`.
numpy arrays ride as native npz members (dtype- and bit-exact, so a
float32 ciphertext round-trips to the identical bits), scalars and
strings ride in the JSON meta.  `unpack` refuses a payload whose kind or
version does not match what the caller expects — a v2 reader never
silently misparses a v1 payload, it gets a `WireFormatError` naming both
versions.

Lives in `core` (not `api`) because `core.ppanns.Keys` serializes itself
with it and core must never import the api layer.
"""

from __future__ import annotations

import io
import json

import numpy as np

__all__ = ["WireFormatError", "pack", "unpack"]

_HEADER = "__wire__"


class WireFormatError(ValueError):
    """Malformed, wrong-kind, or wrong-version wire payload."""


def pack(kind: str, version: int, arrays: dict, meta: dict | None = None
         ) -> bytes:
    """Serialize arrays + JSON-able meta into a self-describing byte
    string.  Array names must not collide with the header entry."""
    if _HEADER in arrays:
        raise WireFormatError(f"array name {_HEADER!r} is reserved")
    header = json.dumps(
        {"kind": kind, "version": int(version), "meta": meta or {}})
    buf = io.BytesIO()
    np.savez(buf, **{_HEADER: np.frombuffer(header.encode(), np.uint8)},
             **{k: np.asarray(v) for k, v in arrays.items()})
    return buf.getvalue()


def unpack(data: bytes, kind: str, version: int) -> tuple[dict, dict]:
    """-> (arrays, meta); refuses payloads of another kind or version."""
    try:
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            if _HEADER not in z.files:
                raise WireFormatError("not a repro wire payload "
                                      f"(missing {_HEADER} header)")
            header = json.loads(bytes(z[_HEADER].tobytes()).decode())
            arrays = {k: z[k] for k in z.files if k != _HEADER}
    except (OSError, ValueError, KeyError) as e:
        if isinstance(e, WireFormatError):
            raise
        raise WireFormatError(f"malformed wire payload: {e}") from e
    if header.get("kind") != kind:
        raise WireFormatError(
            f"expected kind {kind!r}, payload is {header.get('kind')!r}")
    if header.get("version") != int(version):
        raise WireFormatError(
            f"{kind}: expected wire version {version}, payload is "
            f"version {header.get('version')} — refusing to deserialize")
    return arrays, header.get("meta", {})
