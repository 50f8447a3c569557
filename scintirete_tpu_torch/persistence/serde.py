"""Binary serialization for persistence records. Port of
`scintirete_tpu/persistence/serde.py`: the same msgpack calls, so a record
or a snapshot is the same bytes whichever package writes it, and loads in
either.

The reference serializes with FlatBuffers (schemas/flatbuffers/{aof,rdb}.fbs).
This engine uses msgpack with a compact ndarray extension — same logical
schema and durability semantics, a format better suited to snapshotting the
flat device arrays directly (zero-copy bytes for the vector matrix and
neighbor tables). Documented format deviation; the record framing (4-byte
little-endian length prefix, reference: aof/aof.go:115-124) is preserved.

An ndarray is written as the map {"__nd__": True, "d": dtype.str,
"s": shape list, "b": the C-order bytes}.
"""

from __future__ import annotations

from typing import Any

import msgpack
import numpy as np

_ND_KEY = "__nd__"


def _default(obj: Any):
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        return {
            _ND_KEY: True,
            "d": arr.dtype.str,
            "s": list(arr.shape),
            "b": arr.tobytes(),
        }
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    raise TypeError(f"unserializable type: {type(obj)!r}")


def _object_hook(obj: dict) -> Any:
    # strict sentinel check: user metadata is arbitrary (proto Struct), so
    # a map containing a "__nd__" key must NOT be treated as an ndarray
    # unless the full encoding contract holds — a loose check turned such
    # metadata into a KeyError at load time, which replay/load classified
    # as corruption (silent AOF tail truncation / RDB set-aside)
    if (
        obj.get(_ND_KEY) is True
        and isinstance(obj.get("d"), str)
        and isinstance(obj.get("s"), list)
        and isinstance(obj.get("b"), (bytes, bytearray))
    ):
        try:
            return (
                np.frombuffer(obj["b"], dtype=np.dtype(obj["d"]))
                .reshape(obj["s"])
                .copy()
            )
        except (ValueError, TypeError):
            return obj  # not a real encoded array after all
    return obj


def dumps(obj: Any) -> bytes:
    return msgpack.packb(obj, default=_default, use_bin_type=True)


def loads(data: bytes) -> Any:
    return msgpack.unpackb(
        data, object_hook=_object_hook, raw=False, strict_map_key=False
    )
