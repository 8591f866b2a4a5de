"""Pure-Python proto3 codec for ``model.proto``'s three messages.

Byte-compatible with protoc-generated bindings (fields written in field
number order, repeated scalars packed, default scalars and empty repeated
fields omitted), so models saved by the reference load here and models
saved here load there.  The decoder also accepts unpacked repeated scalars
and skips unknown fields, as any proto3 parser must.  Malformed input
raises ``ValueError``.

The message classes expose the subset of the generated-message API the
package uses: attribute fields, ``extend``/``append`` on repeated scalars,
``add()`` on repeated messages, ``Clear()``, ``SerializeToString()`` and
``ParseFromString()``.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

__all__ = ["Model", "ChannelOpts", "DTree"]

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _put_varint(out: bytearray, v: int) -> None:
    v &= (1 << 64) - 1  # negative int32 -> 10-byte two's complement
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _get_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    v = shift = 0
    while True:
        if pos >= len(buf) or shift > 63:
            raise ValueError("truncated or overlong varint")
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def _int32(v: int) -> int:
    v &= (1 << 32) - 1
    return v - (1 << 32) if v >= 1 << 31 else v


class _Repeated(list):
    """Repeated message field: a list with ``add()``."""

    def __init__(self, cls):
        super().__init__()
        self._cls = cls

    def add(self):
        m = self._cls()
        self.append(m)
        return m


class _Message:
    #: (field number, name, kind, repeated); kind is "int32", "float",
    #: "string" or a _Message subclass
    FIELDS: Tuple = ()

    def __init__(self):
        self.Clear()

    def Clear(self) -> None:
        object.__setattr__(self, "_touched", False)
        for _, name, kind, rep in self.FIELDS:
            if rep:
                val = _Repeated(kind) if isinstance(kind, type) else []
            elif isinstance(kind, type):
                val = kind()
            else:
                val = {"int32": 0, "float": 0.0, "string": ""}[kind]
            object.__setattr__(self, name, val)

    def __eq__(self, other):
        return type(self) is type(other) and all(
            getattr(self, f[1]) == getattr(other, f[1]) for f in self.FIELDS)

    # -- encoding -------------------------------------------------------
    def SerializeToString(self) -> bytes:
        out = bytearray()
        for num, name, kind, rep in self.FIELDS:
            val = getattr(self, name)
            if isinstance(kind, type):
                for sub in (val if rep else [val]):
                    body = sub.SerializeToString()
                    if not rep and not body and not sub._present():
                        continue
                    _put_varint(out, num << 3 | _LEN)
                    _put_varint(out, len(body))
                    out += body
            elif rep:
                if not val:
                    continue
                if kind == "float":
                    body = struct.pack(f"<{len(val)}f", *val)
                else:
                    body = bytearray()
                    for v in val:
                        _put_varint(body, int(v))
                _put_varint(out, num << 3 | _LEN)
                _put_varint(out, len(body))
                out += body
            elif kind == "string":
                if val:
                    data = val.encode("utf-8")
                    _put_varint(out, num << 3 | _LEN)
                    _put_varint(out, len(data))
                    out += data
            elif kind == "float":
                if val != 0.0 or struct.pack("<f", val)[3] & 0x80:
                    _put_varint(out, num << 3 | _I32)
                    out += struct.pack("<f", val)
            elif val:
                _put_varint(out, num << 3 | _VARINT)
                _put_varint(out, int(val))
        return bytes(out)

    def _present(self) -> bool:
        # a singular sub-message counts as set once any field was written
        # (the generated bindings mark it on assignment, even to defaults)
        return self._touched

    def __setattr__(self, name, value):
        object.__setattr__(self, "_touched", True)
        object.__setattr__(self, name, value)

    # -- decoding -------------------------------------------------------
    def ParseFromString(self, data: bytes) -> None:
        self.Clear()
        self._merge(bytes(data), 0, len(data))

    def _merge(self, buf: bytes, pos: int, end: int) -> None:
        by_num: Dict[int, Tuple] = {f[0]: f for f in self.FIELDS}
        while pos < end:
            key, pos = _get_varint(buf, pos)
            num, wt = key >> 3, key & 7
            if num == 0:
                raise ValueError("invalid field number 0")
            if wt == _VARINT:
                v, pos = _get_varint(buf, pos)
                payload = None
            elif wt == _I64:
                payload, pos = (pos, pos + 8), pos + 8
            elif wt == _LEN:
                n, pos = _get_varint(buf, pos)
                payload, pos = (pos, pos + n), pos + n
            elif wt == _I32:
                payload, pos = (pos, pos + 4), pos + 4
            else:
                raise ValueError(f"unsupported wire type {wt}")
            if pos > end:
                raise ValueError("truncated message")
            field = by_num.get(num)
            if field is None:
                continue  # unknown field: skipped, as proto3 requires
            _, name, kind, rep = field
            if isinstance(kind, type):
                if wt != _LEN:
                    raise ValueError(f"field {name}: bad wire type {wt}")
                sub = getattr(self, name).add() if rep else getattr(self, name)
                sub._merge(buf, *payload)
                object.__setattr__(sub, "_touched", True)
            elif kind == "string":
                if wt != _LEN:
                    raise ValueError(f"field {name}: bad wire type {wt}")
                try:
                    s = buf[payload[0]:payload[1]].decode("utf-8")
                except UnicodeDecodeError as e:
                    raise ValueError(f"field {name}: {e}") from None
                object.__setattr__(self, name, s)
            else:
                vals = self._scalars(buf, kind, wt, v if wt == _VARINT
                                     else payload, name)
                if rep:
                    getattr(self, name).extend(vals)
                elif vals:
                    object.__setattr__(self, name, vals[-1])

    @staticmethod
    def _scalars(buf, kind, wt, payload, name) -> List:
        if kind == "float":
            if wt == _I32:
                return list(struct.unpack("<f", buf[payload[0]:payload[1]]))
            if wt == _LEN and (payload[1] - payload[0]) % 4 == 0:
                n = (payload[1] - payload[0]) // 4
                return list(struct.unpack(f"<{n}f",
                                          buf[payload[0]:payload[1]]))
        else:
            if wt == _VARINT:
                return [_int32(payload)]
            if wt == _LEN:
                out, p = [], payload[0]
                while p < payload[1]:
                    v, p = _get_varint(buf, p)
                    out.append(_int32(v))
                if p != payload[1]:
                    raise ValueError(f"field {name}: packed overrun")
                return out
        raise ValueError(f"field {name}: bad wire type {wt}")


class ChannelOpts(_Message):
    FIELDS = ((1, "shrink", "int32", False),
              (2, "n_per_oct", "int32", False),
              (3, "smooth", "int32", False),
              (5, "func", "string", False))


class DTree(_Message):
    FIELDS = ((1, "feature", "int32", True),
              (2, "threshold", "float", True),
              (3, "left", "int32", True),
              (4, "right", "int32", True),
              (5, "prediction", "float", True))


class Model(_Message):
    FIELDS = ((1, "shape", "int32", True),
              (2, "channel_opts", ChannelOpts, False),
              (3, "classifier", DTree, True),
              (4, "theta", "float", True))
