"""Model serialization: a pure-Python proto3 codec for ``model.proto``.

:mod:`.codec` reads and writes the same bytes as protoc-generated bindings
of ``model.proto`` (and of the reference's schema, which has the same
messages and field numbers), without a protobuf runtime.
"""

from . import codec

__all__ = ["codec"]
