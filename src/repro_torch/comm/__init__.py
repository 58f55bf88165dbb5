"""repro_torch.comm — the wire-codec API of the port (see codec.py).

    from repro_torch.comm import get_codec, level_codecs

    codec = get_codec("compact+q4")
    reduced, st = codec.group_reduce(tree, g, weights)
    payload_b = codec.wire_bytes(leaf.shape, "float32")
"""
from .codec import (INDEX_BYTES, CompactMarker, CompositeCodec, DenseCodec,
                    Q4Codec, Q8Codec, WireCodec, collective_wire_bytes,
                    compose, get_codec, group_sum, leaf_bytes, level_codecs,
                    list_codecs, register_codec)

__all__ = [
    "INDEX_BYTES", "CompactMarker", "CompositeCodec", "DenseCodec",
    "Q4Codec", "Q8Codec", "WireCodec", "collective_wire_bytes", "compose",
    "get_codec", "group_sum", "leaf_bytes", "level_codecs", "list_codecs",
    "register_codec",
]
