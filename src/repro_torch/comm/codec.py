"""Pluggable wire codecs — one interface for every synchronization path.

Port of ``repro/comm/codec.py``.  A :class:`WireCodec` owns, for one
fabric boundary:

  * ``group_reduce`` — the weighted group-sum over the leading consensus
    dim, exchanging leaves in the codec's wire format;
  * ``encode``/``decode`` and the fused compact pair
    ``encode_compact``/``decode_expand`` — the wire representation of one
    payload leaf;
  * ``wire_bytes``   — the single source of truth for analytic byte
    accounting (``plan_bytes``, ``round_comm_bytes``).

Registered codecs: ``dense`` (param-dtype payloads, the paper), ``q8``
(per-row symmetric int8 through the hand-written quantize kernel, ring
exchange, f32 accumulation), ``q4`` (packed 4-bit, two channels per
byte, through the hand-written q4 kernels; nibble-plane ring) and the
``compact`` marker, which composes with one element codec
(``compact+q8``, ``compact+q4``).  The encode/decode pairs run on the
hand-written gather kernels: ``dense`` gathers and zero-fills
(``gather_groups``), ``q8`` fuses the gather with its quantizer and
dequantizer (``gather_quantize``/``gather_dequantize``).  ``topk:<rate>``
waits for a later slice and raises ``NotImplementedError``.
"""
from __future__ import annotations


import torch

INDEX_BYTES = 4   # int32 index metadata per top-k entry (paper Table 1)


def _dtype_size(dtype) -> int:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype).element_size()


def _leaf_elems(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _leaf_rows(shape) -> int:
    """Rows of the (R, C) 2-D wire view of one leaf — the number of
    quantization scales it ships (0-D/1-D leaves are one row)."""
    return _leaf_elems(shape[:-1]) if len(shape) >= 2 else 1


def leaf_bytes(shape, dtype) -> int:
    """Dense bytes of one ``shape`` leaf at ``dtype`` (shared helper)."""
    return _leaf_elems(shape) * _dtype_size(dtype)


def collective_wire_bytes(kind: str, g: int, operand_b: int) -> float:
    """Per-device fabric traffic of one collective under the standard
    ring model."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * operand_b
    if kind == "all-gather":
        return float((g - 1) * operand_b)
    if kind in ("reduce-scatter", "all-to-all", "ragged-all-to-all"):
        return (g - 1) / g * operand_b
    return float(operand_b)   # permute / broadcast: one shard on the wire


def _wbcast(w, x):
    return w.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)


def group_sum(x, g: int, w=None):
    """(G*g, *p) -> (G, *p) sum over contiguous groups of g (optionally
    weighted by w: (G*g,) broadcast over param dims) — the reference
    reduction every codec's group exchange must agree with."""
    if w is not None:
        x = x * _wbcast(w, x)
    return x.reshape((-1, g) + tuple(x.shape[1:])).sum(dim=1)


# ---------------------------------------------------------------------------
# the protocol
# ---------------------------------------------------------------------------


class WireCodec:
    """Base class/protocol of one wire format; the base behaviour is the
    dense one."""

    name = "dense"
    #: True when ``group_reduce`` threads an error-feedback state
    stateful = False
    #: True when the spec requests structural compaction at this boundary
    compact = False
    #: True when the exchange is an AllGather instead of a reduce
    gather = False

    def encode(self, leaf):
        """Leaf -> wire payload (anything ``decode`` can invert)."""
        return leaf

    def decode(self, payload, like=None):
        return payload

    def encode_compact(self, leaf2d, idx):
        """Kept-column gather along the minor axis of an (R, C) leaf fused
        with this codec's encode (the §4.4 packing).  Quantizing codecs
        override it with one fused kernel; the base gathers (one launch of
        the gather kernel) and encodes the result."""
        from ..kernels import ops
        return self.encode(ops.gather_rows(leaf2d, idx))

    def decode_expand(self, payload, idx, full: int, like=None):
        """Inverse of :meth:`encode_compact`: decode + zero-fill of the
        dropped channels -> (R, full), a gather by the inverse index from
        the decoded buffer padded by one zero column (no scatter)."""
        from ..kernels import ops, ref
        dec = self.decode(payload, like=like)
        out = ops.gather_rows(*ref.expand_operands(dec, idx, full))
        return out.to(like.dtype) if like is not None else out

    def init_state(self, tree):
        """Zero error-feedback state for one boundary payload (None for
        stateless codecs)."""
        return None

    def group_reduce(self, tree: dict, g: int, w=None, state=None):
        """Weighted group-sum of every leaf of the flat dict ``tree`` over
        contiguous groups of ``g`` along the leading consensus dim.
        Returns ``(reduced_tree, new_state)``."""
        return {k: group_sum(x, g, w) for k, x in tree.items()}, state

    def wire_bytes(self, leaf_shape, dtype) -> int:
        """Bytes ONE group member puts on the wire for one payload leaf."""
        return leaf_bytes(leaf_shape, dtype)


class DenseCodec(WireCodec):
    """Param-dtype payloads, plain weighted group-sum (the paper)."""


def _member_rows(x):
    """(lead, *p) -> (lead, rows_p, C) view: members never share a row, so
    per-row wire scales never mix group members."""
    if x.ndim >= 2:
        return x.reshape((x.shape[0], -1, x.shape[-1]))
    return x.reshape((x.shape[0], 1, 1))


class Q8Codec(WireCodec):
    """Per-row symmetric int8 quantization (beyond-paper §Perf): each
    member's leaf is quantized per row of its (R, C) view (the
    hand-written ``quantize_rows`` kernel, one launch per leaf), exchanged
    around a ring of shifts over the leading dim, and dequant-accumulated
    in f32 in ring order — own buffer first, then each shift by one.  The
    encode/decode pairs are single fused passes: ``gather_quantize`` for
    the compact encode, ``gather_dequantize`` for the decode (identity
    index) and the decode with zero-fill (inverse index)."""

    name = "q8"
    levels = 127

    def encode(self, leaf):
        from ..kernels import ops
        return ops.quantize_rows(leaf, levels=self.levels)

    def decode(self, payload, like=None):
        from ..kernels import ops
        q, scale = payload
        out = ops.dequantize_rows(q, scale)
        return out.to(like.dtype) if like is not None else out

    def encode_compact(self, leaf2d, idx):
        from ..kernels import ops
        return ops.gather_quantize(leaf2d, idx, levels=self.levels)

    def decode_expand(self, payload, idx, full, like=None):
        from ..kernels import ops
        q, scale = payload
        out = ops.scatter_dequantize(q, scale, idx, full)
        return out.to(like.dtype) if like is not None else out

    def group_reduce(self, tree, g, w=None, state=None):
        from ..kernels import ops

        def one(x):
            xw = x * _wbcast(w, x) if w is not None else x
            v = _member_rows(xw)
            q, scale = ops.quantize_rows(v, levels=self.levels)
            G = x.shape[0] // g
            acc = q.to(torch.float32) * scale
            qr, sr = q, scale
            for _ in range(g - 1):
                # ring shift WITHIN each contiguous group of g
                qr = torch.roll(qr.reshape((G, g) + tuple(q.shape[1:])), 1,
                                dims=1).reshape(q.shape)
                sr = torch.roll(sr.reshape((G, g) + tuple(scale.shape[1:])),
                                1, dims=1).reshape(scale.shape)
                acc = acc + qr.to(torch.float32) * sr
            # every member of a group now holds the group sum
            out = acc.reshape((G, g) + tuple(acc.shape[1:]))[:, 0]
            return out.reshape((G,) + tuple(x.shape[1:])).to(x.dtype)
        return {k: one(x) for k, x in tree.items()}, state

    def wire_bytes(self, leaf_shape, dtype) -> int:
        # s8 payload + one f32 scale per (R, C)-view row
        return _leaf_elems(leaf_shape) * 1 + 4 * _leaf_rows(leaf_shape)


class Q4Codec(WireCodec):
    """Packed 4-bit symmetric quantization: two channels per byte.

    Rows of the (R, C) leaf view quantize to [-7, 7] (two's-complement
    nibbles, one f32 scale per row) and pack pairwise into uint8 — one
    launch of the hand-written ``quantize_pack_q4`` kernel for every leaf
    of a ``group_reduce`` call; the
    fused gather+pack and unpack+dequantize(+zero-fill) kernels serve the
    compact encode/decode pair.  The ring exchange rolls the PACKED
    buffer, so the bytes that cross the fabric are exactly ``wire_bytes``
    = rows * (ceil(C/2) + 4).  Odd minor dims carry one zero pad nibble
    (trimmed on decode via the dense template)."""

    name = "q4"

    def encode(self, leaf):
        from ..kernels import ops
        return ops.quantize_pack_q4(leaf)

    def decode(self, payload, like=None):
        from ..kernels import ops
        if like is None:
            raise ValueError("q4 decode needs the dense template (the packed "
                             "minor dim is ambiguous by one pad nibble)")
        p, scale = payload
        n = like.shape[-1] if like.ndim else 1
        out = ops.unpack_dequantize_q4(p, scale, n)
        return out.reshape(like.shape).to(like.dtype)

    def encode_compact(self, leaf2d, idx):
        from ..kernels import ops
        return ops.gather_quantize_q4(leaf2d, idx)

    def decode_expand(self, payload, idx, full, like=None):
        from ..kernels import ops
        p, scale = payload
        out = ops.scatter_dequantize_q4(p, scale, idx, full)
        return out.to(like.dtype) if like is not None else out

    def group_reduce(self, tree, g, w=None, state=None):
        from ..kernels import ops

        def planes(pp, ss):
            # sign-extend the low/high nibbles with int8 arithmetic shifts
            # (the reference's order of operations), scale in f32
            s8 = pp.view(torch.int8)
            lo = ((s8 << 4) >> 4).to(torch.float32) * ss
            hi = (s8 >> 4).to(torch.float32) * ss
            return lo, hi

        def one(x, C, p, scale):
            G = x.shape[0] // g
            # accumulate the nibble PLANES in ring order (own buffer first,
            # then each shift by one); interleave once at the end
            acc_lo, acc_hi = planes(p, scale)
            pr, sr = p, scale
            for _ in range(g - 1):
                # the ring rolls the PACKED uint8 buffer + its scales
                pr = torch.roll(pr.reshape((G, g) + tuple(p.shape[1:])), 1,
                                dims=1).reshape(p.shape)
                sr = torch.roll(sr.reshape((G, g) + tuple(scale.shape[1:])),
                                1, dims=1).reshape(scale.shape)
                lo, hi = planes(pr, sr)
                acc_lo = acc_lo + lo
                acc_hi = acc_hi + hi
            acc = torch.stack([acc_lo, acc_hi], dim=-1)
            acc = acc.reshape(tuple(acc_lo.shape[:-1]) + (-1,))[..., :C]
            out = acc.reshape((G, g) + tuple(acc.shape[1:]))[:, 0]
            return out.reshape((G,) + tuple(x.shape[1:])).to(x.dtype)

        # every member's weighted leaf, then one launch encodes them all
        views = [_member_rows(x * _wbcast(w, x) if w is not None else x)
                 for x in tree.values()]
        enc = ops.quantize_pack_q4_leaves(views)
        return {k: one(x, v.shape[-1], p, s) for (k, x), v, (p, s)
                in zip(tree.items(), views, enc)}, state

    def wire_bytes(self, leaf_shape, dtype) -> int:
        C = leaf_shape[-1] if len(leaf_shape) else 1
        rows = _leaf_rows(leaf_shape)
        return rows * ((C + 1) // 2) + 4 * rows   # packed u8 + f32 scales


class CompactMarker(WireCodec):
    """Structural-compaction marker: composes with an element codec;
    standalone it is ``compact+dense``."""

    name = "compact"
    compact = True


class CompositeCodec(WireCodec):
    """``compose(compact, q8)``: markers set the ``compact`` flag, the
    single element codec provides the reduce and the bytes."""

    def __init__(self, *parts: WireCodec):
        elems = [p for p in parts if not isinstance(p, CompactMarker)]
        if len(elems) > 1:
            raise ValueError(
                "compose() takes at most one element codec (got "
                f"{[p.name for p in elems]}); only the 'compact' marker "
                "stacks — two wire formats cannot both perform the "
                "group exchange")
        self._elem = elems[0] if elems else DenseCodec()
        self.compact = any(p.compact for p in parts)
        self.stateful = self._elem.stateful
        self.gather = self._elem.gather
        self.name = "+".join(
            (["compact"] if self.compact else []) + [self._elem.name])

    @property
    def element(self) -> WireCodec:
        return self._elem

    def encode(self, leaf):
        return self._elem.encode(leaf)

    def decode(self, payload, like=None):
        return self._elem.decode(payload, like)

    def encode_compact(self, leaf2d, idx):
        return self._elem.encode_compact(leaf2d, idx)

    def decode_expand(self, payload, idx, full, like=None):
        return self._elem.decode_expand(payload, idx, full, like)

    def init_state(self, tree):
        return self._elem.init_state(tree)

    def group_reduce(self, tree, g, w=None, state=None):
        return self._elem.group_reduce(tree, g, w, state)

    def wire_bytes(self, leaf_shape, dtype) -> int:
        return self._elem.wire_bytes(leaf_shape, dtype)


def compose(*codecs: "WireCodec | str") -> CompositeCodec:
    """Stack wire-format stages: structural ``compact`` + one element
    codec, so H-SADMM shrinkage selects together with quantization."""
    return CompositeCodec(*[get_codec(c) if isinstance(c, str) else c
                            for c in codecs])


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register_codec(name: str, factory) -> None:
    """``factory(arg: str | None) -> WireCodec``; ``name:arg`` specs pass
    the text after the colon."""
    _REGISTRY[name] = factory


def _topk_later(arg=None):
    raise NotImplementedError(
        "wire codec 'topk' is not ported yet: top-k with error feedback "
        "comes in a later slice of the PyTorch port")


register_codec("dense", lambda arg=None: DenseCodec())
register_codec("q8", lambda arg=None: Q8Codec())
register_codec("q4", lambda arg=None: Q4Codec())
register_codec("compact", lambda arg=None: CompactMarker())
register_codec("topk", _topk_later)


def list_codecs() -> list[str]:
    return sorted(_REGISTRY)


def get_codec(spec: "str | WireCodec") -> WireCodec:
    """Resolve a codec spec string: ``dense`` | ``q8`` | ``q4`` |
    ``compact+q4`` (markers and one element codec joined by ``+``)."""
    if isinstance(spec, WireCodec):
        return spec
    parts = [p.strip() for p in spec.split("+") if p.strip()]
    if not parts:
        raise ValueError(f"empty codec spec {spec!r}")
    built = []
    for part in parts:
        name, _, arg = part.partition(":")
        if name not in _REGISTRY:
            raise KeyError(
                f"unknown wire codec {name!r}; known: {list_codecs()}")
        built.append(_REGISTRY[name](arg or None))
    return built[0] if len(built) == 1 else CompositeCodec(*built)


# ---------------------------------------------------------------------------
# per-fabric-level selection (the paper's leader-follower split)
# ---------------------------------------------------------------------------

def level_codecs(hp, levels: tuple, compact_from_level: int
                 ) -> list[WireCodec]:
    """One codec per level boundary k=1..K: ``hp.wire_map`` verbatim when
    set; otherwise the top boundary takes the inter codec and the lower
    ones the intra codec — except the flat K==1 ablation with
    ``compact_from_level >= 1``, whose one boundary is the intra one."""
    K = len(levels)
    wm = hp.wire_map
    if wm:
        if len(wm) != K:
            raise ValueError(
                f"wire_map has {len(wm)} entries but the hierarchy has "
                f"{K} level boundaries: {wm!r} vs levels={levels!r}")
        return [get_codec(s) for s in wm]
    intra_s, inter_s = hp.wire_intra or "dense", hp.wire_inter or "dense"
    kc = compact_from_level
    return [get_codec(inter_s) if (k == K and (K > 1 or kc == 0))
            else get_codec(intra_s) for k in range(1, K + 1)]
