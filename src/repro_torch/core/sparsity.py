"""Structured sparsity sets and Euclidean projections (paper §2.1, §3.2).

A :class:`GroupRule` names a *structured group dimension* shared by one or
more parameter leaves (conv filters, conv input channels, kernel spatial
positions...).  The sparsity set is the group-l0 ball; its Euclidean
projection keeps the ``keep`` groups of largest aggregated norm.

Port of ``repro/core/sparsity.py``.  Parameters are FLAT dicts
``{"/"-joined leaf key: tensor}`` with the reference's keys and shapes;
``axis`` indices refer to the *param* shape (no leading consensus dims).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping

import torch

from ..kernels import ops

Params = dict


@dataclass(frozen=True)
class LeafAxis:
    """A leaf's participation in a rule: ``axis`` is the group axis within
    the leaf; a tuple expresses a composite (projection-only) group."""

    key: str
    axis: "int | tuple[int, ...]"

    @property
    def axes(self) -> tuple[int, ...]:
        axes = (self.axis,) if isinstance(self.axis, int) else tuple(self.axis)
        return tuple(sorted(axes))


@dataclass(frozen=True)
class GroupRule:
    """One structured-sparsity constraint S^l (possibly spanning several
    leaves).  Fields and invariants as in the reference: ``stack_ndims``
    leading axes index independent instances, ``followers`` are masked and
    sliced but never vote, ``group_size > 1`` prunes contiguous channel
    blocks, ``shards > 1`` is balanced pruning per shard block."""

    name: str
    leaves: tuple[LeafAxis, ...]
    groups: int          # C, number of structured groups (block units)
    keep: int            # alpha, static keep budget (block units)
    stack_ndims: int = 1
    shards: int = 1
    followers: tuple[LeafAxis, ...] = ()
    group_size: int = 1

    def __post_init__(self):
        if not 0 < self.keep <= self.groups:
            raise ValueError(f"rule {self.name!r}: keep {self.keep} outside "
                             f"(0, {self.groups}]")
        if self.groups % self.shards or self.keep % self.shards:
            raise ValueError(f"rule {self.name!r}: groups {self.groups} and "
                             f"keep {self.keep} must divide by shards "
                             f"{self.shards}")
        for la in self.leaves + self.followers:
            if min(la.axes) < self.stack_ndims:
                raise ValueError(f"rule {self.name!r}: leaf {la} groups "
                                 "along a stack axis")
        if (self.shards > 1 or self.group_size > 1) and not self.compactable:
            raise ValueError(f"rule {self.name!r}: balanced or block-granular "
                             "rules must be single-axis")
        if self.shards > 1 and self.group_size > 1:
            raise ValueError(f"rule {self.name!r}: balanced (sharded) rules "
                             "use unit group_size")

    @property
    def compactable(self) -> bool:
        """Shrinkable rules slice one axis per leaf; composite-axis rules
        only mask."""
        return all(len(la.axes) == 1 for la in self.leaves + self.followers)

    @property
    def width(self) -> int:
        """Channel-unit extent of the group axis (= groups * group_size)."""
        return self.groups * self.group_size

    @property
    def all_leaves(self) -> tuple[LeafAxis, ...]:
        """Scored members first, then followers — the masking/slicing set."""
        return self.leaves + self.followers


@dataclass(frozen=True)
class SparsityPlan:
    rules: tuple[GroupRule, ...]

    def rule(self, name: str) -> GroupRule:
        for r in self.rules:
            if r.name == name:
                return r
        raise KeyError(name)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(r.name for r in self.rules)


# ---------------------------------------------------------------------------
# scores / masks / projection
# ---------------------------------------------------------------------------


def group_scores(params: Mapping, rule: GroupRule, offset: int = 0):
    """Aggregated squared-Frobenius group magnitudes, shape
    (*lead, *stack, groups).  ``offset`` leading consensus dims are kept
    (scores stay per-worker); only scored ``leaves`` vote; ``group_size >
    1`` pools each contiguous channel block into one score.  Each leaf's
    sums of squares are one launch of the group-norm kernel on the card
    (``kernels.ops.group_norms_sq``), read through the moved view."""
    total = None
    dst = offset + rule.stack_ndims
    for la in rule.leaves:
        x = params[la.key]
        axes = tuple(a + offset for a in la.axes)
        x = torch.movedim(x, axes, tuple(range(dst, dst + len(axes))))
        lead = tuple(x.shape[:dst])
        v = x.reshape((math.prod(lead),
                       math.prod(x.shape[dst:dst + len(axes)]))
                      + tuple(x.shape[dst + len(axes):]))
        s = ops.group_norms_sq(v).reshape(lead + (-1,))  # (*lead, *stack, C)
        if rule.group_size > 1:                    # pool channel blocks
            s = s.reshape(s.shape[:-1] + (rule.groups, rule.group_size))
            s = torch.sum(s, dim=-1)
        total = s if total is None else total + s
    return total


def channel_mask(rule: GroupRule, mask):
    """Block-unit mask (*batch, groups) -> channel units."""
    if rule.group_size == 1:
        return mask
    return torch.repeat_interleave(mask, rule.group_size, dim=-1)


def channel_idx(rule: GroupRule, idx):
    """Block-unit kept indices (*batch, B) -> channel-unit kept indices
    (*batch, B*group_size)."""
    if rule.group_size == 1:
        return idx
    s = rule.group_size
    ch = idx[..., :, None] * s + torch.arange(s, dtype=idx.dtype,
                                              device=idx.device)
    return ch.reshape(idx.shape[:-1] + (idx.shape[-1] * s,))


def top_k_indices(scores, k: int):
    """Indices of the ``k`` largest entries along the last axis, largest
    first, ties to the LOWER index — ``jax.lax.top_k``'s order, which a
    stable descending sort reproduces (``torch.topk`` promises none)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[..., :k]


def topk_mask(scores, keep: int, shards: int = 1):
    """Top-``keep`` mask along the last axis. Returns (mask, idx).

    mask: float32 {0,1} of scores.shape.
    idx (shards == 1): int64 (*batch, keep), global indices, sorted.
    idx (shards  > 1): int64 (*batch, shards, keep/shards), block-local
        indices into each C/shards block (balanced pruning).
    """
    if shards > 1:
        C = scores.shape[-1]
        scores = scores.reshape(scores.shape[:-1] + (shards, C // shards))
        keep = keep // shards
    idx = torch.sort(top_k_indices(scores, keep), dim=-1).values
    mask = torch.zeros(scores.shape, dtype=torch.float32,
                       device=scores.device)
    mask = mask.scatter(-1, idx, 1.0)
    if shards > 1:
        mask = mask.reshape(mask.shape[:-2] + (-1,))
    return mask, idx


def apply_mask_rule(params: dict, rule: GroupRule, mask,
                    offset: int = 0) -> dict:
    """Zero out non-kept groups of every leaf in the rule (projection step).

    ``mask`` has shape (*stack, C) or (*lead, *stack, C) in the rule's
    group units; it is expanded to channel units and broadcast over the
    leaf's remaining axes.  Followers are masked alongside.  Returns a new
    flat dict."""
    mask = channel_mask(rule, mask)
    params = dict(params)
    for la in rule.all_leaves:
        x = params[la.key]
        axes = tuple(a + offset for a in la.axes)
        shape = [1] * x.ndim
        m_nd = mask.ndim
        for i in range(rule.stack_ndims):
            shape[offset + i] = mask.shape[m_nd - 1 - rule.stack_ndims + i]
        for ax in axes:
            shape[ax] = x.shape[ax]
        lead_extra = m_nd - rule.stack_ndims - 1
        for i in range(lead_extra):
            shape[i] = mask.shape[i]
        params[la.key] = x * mask.reshape(shape).to(x.dtype)
    return params


def keep_count(dim: int, keep_rate: float, multiple: int = 8) -> int:
    """Static keep budget: round keep_rate*dim down to a hardware multiple."""
    k = int(dim * keep_rate)
    k = max(multiple, (k // multiple) * multiple)
    return min(k, dim)
