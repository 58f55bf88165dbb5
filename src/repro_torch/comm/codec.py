"""Pluggable wire codecs — one interface for every synchronization path.

Port of ``repro/comm/codec.py``.  A :class:`WireCodec` owns, for one
fabric boundary:

  * ``group_reduce`` — the weighted group-sum over the leading consensus
    dim, exchanging leaves in the codec's wire format;
  * ``wire_bytes``   — the single source of truth for analytic byte
    accounting (``plan_bytes``, ``round_comm_bytes``).

Registered codecs: ``dense`` (param-dtype payloads, the paper), ``q8``
(per-row symmetric int8 through the hand-written quantize kernel, ring
exchange, f32 accumulation) and the ``compact`` marker, which composes
with one element codec (``compact+q8``).  ``q4`` and ``topk:<rate>``, and
the encode/decode pairs the reference keeps for tests and benchmarks,
wait for a later slice of the port: their specs raise
``NotImplementedError``.
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
    in f32 in ring order — own buffer first, then each shift by one."""

    name = "q8"
    levels = 127

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


def _later_slice(name: str):
    def factory(arg=None):
        raise NotImplementedError(
            f"wire codec {name!r} is not ported yet: q4 and top-k (and "
            "their kernels) come in a later slice of the PyTorch port")
    return factory


register_codec("dense", lambda arg=None: DenseCodec())
register_codec("q8", lambda arg=None: Q8Codec())
register_codec("compact", lambda arg=None: CompactMarker())
register_codec("q4", _later_slice("q4"))
register_codec("topk", _later_slice("topk"))


def list_codecs() -> list[str]:
    return sorted(_REGISTRY)


def get_codec(spec: "str | WireCodec") -> WireCodec:
    """Resolve a codec spec string: ``dense`` | ``q8`` | ``compact+q8``
    (markers and one element codec joined by ``+``)."""
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
