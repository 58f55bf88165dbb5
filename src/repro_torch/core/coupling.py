"""Cross-layer pruning coupling graph (PruneTrain-style mask propagation).

Port of ``repro/core/coupling.py``: pure Python over leaf keys and axes,
so it is the reference's code unchanged apart from this note.

Structured pruning decisions are not per-tensor: removing filter g from
conv_l also removes the matching input channel of every consumer of
conv_l's activation (the next conv, the residual-connected convs, the
classifier rows behind global pooling) and the g-th normalization
scale/bias.  PruneX's compaction machinery (``core.shrinkage``) already
slices *multi-leaf* rules consistently — what was missing is the object
that derives those multi-leaf rules from the model's wiring.

:class:`CouplingGraph` is that object.  Nodes are ``(leaf key, axis)``
pairs; an edge ("tie") means the two axes index the SAME channel set and
therefore share one mask.  Connected components become *coupling
classes*; each class emits exactly one :class:`core.sparsity.GroupRule`
whose scored ``leaves`` are the class members that vote on group
magnitude (producer C_out axes and consumer C_in axes — PruneTrain's
group lasso spans both sides) and whose ``followers`` are the coupled
non-voting parameters (GroupNorm scale/bias).  Residual (skip-addition)
streams are expressed by tying every branch that writes into the stream
to every reader of the stream — the channel-union class of PruneTrain —
so skip additions stay shape-consistent under physical reconfiguration.

The transformer families' existing rules (FFN hidden units spanning
wg/wu/wd, GQA head groups spanning wq/wk/wv/wo) are the degenerate
self-coupled case: one producer with its consumers inside a single
block.  They re-derive through the same graph, so there is ONE alignment
mechanism instead of per-family special cases.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional

from .sparsity import GroupRule, LeafAxis, SparsityPlan

NodeId = int


@dataclass(frozen=True)
class _Node:
    key: str
    axis: Any               # int or tuple (composite axes)
    scored: bool


@dataclass(frozen=True)
class CouplingClass:
    """One resolved mask class: every (leaf, axis) sharing one mask."""

    name: str
    members: tuple[LeafAxis, ...]     # scored (vote on group magnitude)
    followers: tuple[LeafAxis, ...]   # masked/sliced, never vote
    groups: int                       # group units (channels // group_size)
    keep: int                         # group units
    stack_ndims: int = 0
    shards: int = 1
    group_size: int = 1

    def rule(self) -> GroupRule:
        return GroupRule(self.name, self.members, groups=self.groups,
                         keep=self.keep, stack_ndims=self.stack_ndims,
                         shards=self.shards, followers=self.followers,
                         group_size=self.group_size)


class CouplingGraph:
    """Union-find over (leaf, axis) nodes; components are mask classes.

    Build protocol::

        g = CouplingGraph()
        co = g.producer("ffn", "mlp/wg", 2, keep=K)    # C_out rule anchor
        g.consumer(co, "mlp/wu", 2)                    # tied producer
        g.consumer(co, "mlp/wd", 1)                    # C_in of the consumer
        g.follower(co, "ln/scale", 0)                  # non-voting follower
        g.merge(a, b)                                  # residual union

    ``producer`` declares the class label and its rule attributes
    (``keep`` in group units, plus stack_ndims/shards/group_size);
    ``consumer``/``follower`` attach further nodes to the same class;
    ``merge`` unions two classes (skip addition: the branch output and
    the stream it adds into are one channel set).  When classes with two
    labels merge, the earliest-declared label wins.  ``plan`` emits one
    GroupRule per class, in label-declaration order.
    """

    def __init__(self):
        self._nodes: list[_Node] = []
        self._parent: list[NodeId] = []
        self._labels: dict[NodeId, tuple[int, str, dict]] = {}
        self._n_labels = 0

    # -- union-find -----------------------------------------------------

    def _find(self, n: NodeId) -> NodeId:
        while self._parent[n] != n:
            self._parent[n] = self._parent[self._parent[n]]
            n = self._parent[n]
        return n

    def _union(self, a: NodeId, b: NodeId) -> NodeId:
        ra, rb = self._find(a), self._find(b)
        if ra == rb:
            return ra
        lo, hi = (ra, rb) if ra < rb else (rb, ra)   # earliest node is root
        self._parent[hi] = lo
        la, lb = self._labels.pop(lo, None), self._labels.pop(hi, None)
        if la is not None and lb is not None and la[2] != lb[2]:
            # merging two declared classes must not silently drop one
            # side's rule attributes (keep/group_size/shards/...)
            raise ValueError(
                f"cannot merge coupling classes {la[1]!r} and {lb[1]!r}: "
                f"their rule attributes differ ({la[2]} vs {lb[2]})")
        lab = min((l for l in (la, lb) if l is not None),
                  default=None)                      # earliest label wins
        if lab is not None:
            self._labels[lo] = lab
        return lo

    # -- construction ---------------------------------------------------

    def add(self, key: str, axis, *, scored: bool = True) -> NodeId:
        self._nodes.append(_Node(key, axis, scored))
        self._parent.append(len(self._nodes) - 1)
        return len(self._nodes) - 1

    def tie(self, a: NodeId, b: NodeId) -> NodeId:
        """Edge: the two nodes' axes index the same channel set."""
        return self._union(a, b)

    merge = tie   # residual union reads better at call sites

    def label(self, n: NodeId, name: str, **rule_kw) -> NodeId:
        root = self._find(n)
        if root not in self._labels:
            self._labels[root] = (self._n_labels, name, rule_kw)
            self._n_labels += 1
        return n

    def producer(self, name: str, key: str, axis, **rule_kw) -> NodeId:
        """Declare a class via its C_out anchor node."""
        return self.label(self.add(key, axis), name, **rule_kw)

    def consumer(self, anchor: NodeId, key: str, axis,
                 scored: bool = True) -> NodeId:
        """Attach a consumer's C_in axis (or a tied producer) to a class."""
        n = self.add(key, axis, scored=scored)
        self.tie(anchor, n)
        return n

    def follower(self, anchor: NodeId, key: str, axis) -> NodeId:
        """Attach a non-voting coupled leaf (GN scale/bias, biases)."""
        return self.consumer(anchor, key, axis, scored=False)

    # -- resolution -----------------------------------------------------

    def classes(self, shapes: Optional[Mapping[str, tuple]] = None
                ) -> tuple[CouplingClass, ...]:
        """Resolve components into coupling classes, label-declaration
        ordered.  ``shapes`` (flat ``{leaf key: shape}``, channel units)
        derives and cross-checks each class's width; a class whose
        members disagree on channel extent is a wiring bug and raises."""
        comp: dict[NodeId, list[NodeId]] = {}
        for i in range(len(self._nodes)):
            comp.setdefault(self._find(i), []).append(i)
        out = []
        for root, nodes in comp.items():
            if root not in self._labels:
                locs = [(self._nodes[i].key, self._nodes[i].axis)
                        for i in nodes]
                raise ValueError(f"unlabelled coupling class: {locs}")
            order, name, kw = self._labels[root]
            members = tuple(LeafAxis(self._nodes[i].key, self._nodes[i].axis)
                            for i in nodes if self._nodes[i].scored)
            followers = tuple(
                LeafAxis(self._nodes[i].key, self._nodes[i].axis)
                for i in nodes if not self._nodes[i].scored)
            gs = kw.get("group_size", 1)
            width = kw.get("groups", 0) * gs
            if shapes is not None:
                for la in members + followers:
                    w = 1
                    for a in la.axes:
                        w *= shapes[la.key][a]
                    if width == 0:
                        width = w
                    elif w != width:
                        raise ValueError(
                            f"coupling class {name!r}: leaf {la.key!r} axis "
                            f"{la.axis} has extent {w}, class width {width}")
            if width == 0:
                raise ValueError(
                    f"coupling class {name!r} needs groups= or shapes")
            if width % gs:
                raise ValueError(
                    f"coupling class {name!r}: width {width} not divisible "
                    f"by group_size {gs}")
            out.append((order, CouplingClass(
                name=name, members=members, followers=followers,
                groups=width // gs, keep=kw["keep"],
                stack_ndims=kw.get("stack_ndims", 0),
                shards=kw.get("shards", 1), group_size=gs)))
        return tuple(c for _, c in sorted(out, key=lambda t: t[0]))

    def plan(self, shapes: Optional[Mapping[str, tuple]] = None,
             extra_rules: tuple = (), min_groups: int = 1) -> SparsityPlan:
        """One GroupRule per class (+ ``extra_rules``, e.g. projection-only
        shape rules).  Classes with fewer than ``min_groups`` groups stay
        dense (no rule — too narrow to prune structurally)."""
        rules = []
        for c in self.classes(shapes):
            if c.groups < min_groups:
                continue
            rules.append(c.rule())
        return validate_compaction_order(
            SparsityPlan(tuple(rules) + tuple(extra_rules)))


def validate_compaction_order(plan: SparsityPlan) -> SparsityPlan:
    """Enforce the stack-compaction ordering contract and return ``plan``.

    Rules may nest: one rule's STACK axis can be the group axis another
    (compactable) rule slices — the MoE family's ``moe_ffn`` masks are
    stacked per (layer, expert) while the ``experts`` rule compacts the
    expert axis itself.  ``compact_params`` applies rules in plan order
    and ``expand_params`` in reverse, so sequential slicing is only
    consistent when the stacked rule comes FIRST: its (*stack, B) index
    tensors must be built (and consumed) against the still-full stack
    extent before the compacting rule shrinks it.  A plan that orders
    them the other way round would gather with stale stack shapes —
    refuse at construction time instead of failing inside a trace."""
    pos = {r.name: i for i, r in enumerate(plan.rules)}
    for i, r in enumerate(plan.rules):
        for la in r.all_leaves:
            for ax in range(r.stack_ndims):
                for r2 in plan.rules:
                    if r2 is r or not r2.compactable:
                        continue
                    hit = any(la2.key == la.key and la2.axes[0] == ax
                              for la2 in r2.all_leaves)
                    if hit and pos[r2.name] < i:
                        raise ValueError(
                            f"rule {r.name!r} stacks over axis {ax} of "
                            f"{la.key!r}, which rule {r2.name!r} compacts "
                            f"— the stacked rule must precede the "
                            f"compacting rule in the plan")
    return plan
