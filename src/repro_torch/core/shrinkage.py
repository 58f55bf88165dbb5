"""Physical shrinkage & recovery of communication buffers (paper §4.4).

Port of ``repro/core/shrinkage.py``.  ``compact_leaf``/``expand_leaf``
implement Eq. 15 and the zero-fill recovery with static buffer shapes:
the kept-index set has a fixed size B per rule, so the inter-node payload
is a dense contiguous (B, ...) tensor with no index metadata on the wire.
``compact_params``/``expand_params`` apply every rule of a plan in plan
order and in reverse; ``plan_bytes`` is the exact byte accounting.

The whole-state migration of physical reconfiguration (``compact_state``
and friends) waits for a later slice of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .coupling import validate_compaction_order
from .sparsity import SparsityPlan, channel_idx


def _bcast_idx(idx, x_ndim: int, ax: int, stack_ndims: int, offset: int):
    """Reshape (*stack, B) idx to broadcast along axis ``ax`` of x."""
    shape = [1] * x_ndim
    for i in range(stack_ndims):
        shape[offset + i] = idx.shape[i]
    shape[ax] = idx.shape[-1]
    return idx.reshape(shape)


def compact_leaf(x, idx, ax: int, stack_ndims: int, offset: int = 0,
                 shards: int = 1):
    """Gather kept groups along ``ax``: (..., C, ...) -> (..., B, ...).

    shards > 1 (balanced rules): ``idx`` is (*stack, shards, B/shards) with
    block-local indices into the (shards, C/shards) split of the axis.
    """
    if shards == 1:
        return torch.take_along_dim(
            x, _bcast_idx(idx, x.ndim, ax, stack_ndims, offset), dim=ax)
    C = x.shape[ax]
    xb = x.reshape(x.shape[:ax] + (shards, C // shards) + x.shape[ax + 1:])
    shape = [1] * xb.ndim
    for i in range(stack_ndims):
        shape[offset + i] = idx.shape[i]
    shape[ax] = shards
    shape[ax + 1] = idx.shape[-1]
    c = torch.take_along_dim(xb, idx.reshape(shape), dim=ax + 1)
    return c.reshape(x.shape[:ax] + (-1,) + x.shape[ax + 1:])


def _inverse_idx(idx, full: int):
    """(..., B) kept indices -> (..., full) positions into the compact
    buffer, with ``B`` marking dropped groups (points at the zero pad)."""
    B = idx.shape[-1]
    inv = torch.full(idx.shape[:-1] + (full,), B, dtype=idx.dtype,
                     device=idx.device)
    src = torch.arange(B, dtype=idx.dtype, device=idx.device).expand(idx.shape)
    return inv.scatter(-1, idx, src)


def _pad_one(c, ax: int):
    """Append one zero slot along axis ``ax``."""
    return F.pad(c, [0, 0] * (c.ndim - 1 - ax) + [0, 1])


def expand_leaf(c, idx, ax: int, full: int, stack_ndims: int,
                offset: int = 0, shards: int = 1):
    """Zero-fill recovery: (..., B, ...) -> (..., C, ...) (paper §4.4.3),
    as an inverse-permutation gather from a zero-padded compact buffer: a
    scatter into the big tensor would need a full-size index tensor; the
    inverse map is built by a scatter on the tiny (stack, C) index array."""
    if shards == 1:
        inv = _inverse_idx(idx, full)
        return torch.take_along_dim(
            _pad_one(c, ax), _bcast_idx(inv, c.ndim, ax, stack_ndims, offset),
            dim=ax)
    B = c.shape[ax]
    cb = c.reshape(c.shape[:ax] + (shards, B // shards) + c.shape[ax + 1:])
    cp = _pad_one(cb, ax + 1)
    inv = _inverse_idx(idx, full // shards)          # (*stack, sh, C/s)
    shape = [1] * cb.ndim
    for i in range(stack_ndims):
        shape[offset + i] = inv.shape[i]
    shape[ax] = shards
    shape[ax + 1] = inv.shape[-1]
    out = torch.take_along_dim(cp, inv.reshape(shape), dim=ax + 1)
    return out.reshape(c.shape[:ax] + (full,) + c.shape[ax + 1:])


def compact_params(params: dict, plan: SparsityPlan, idxs: dict,
                   offset: int = 0) -> dict:
    """Slice every compactable rule's kept groups out of every
    participating leaf (scored members AND followers), in plan order."""
    validate_compaction_order(plan)
    params = dict(params)
    for rule in plan.rules:
        if not rule.compactable:
            continue  # projection-only rule (paper slices filter/channel only)
        idx = channel_idx(rule, idxs[rule.name])
        for la in rule.all_leaves:
            params[la.key] = compact_leaf(params[la.key], idx,
                                          la.axes[0] + offset,
                                          rule.stack_ndims, offset,
                                          rule.shards)
    return params


def expand_params(params: dict, plan: SparsityPlan, idxs: dict,
                  fulls: dict, offset: int = 0) -> dict:
    """Inverse of :func:`compact_params` (rules applied in reverse order).
    ``fulls`` is in the rule's group (block) units, like the budgets."""
    validate_compaction_order(plan)
    params = dict(params)
    for rule in reversed(plan.rules):
        if not rule.compactable:
            continue
        idx = channel_idx(rule, idxs[rule.name])
        full = fulls[rule.name] * rule.group_size
        for la in reversed(rule.all_leaves):
            params[la.key] = expand_leaf(params[la.key], idx,
                                         la.axes[0] + offset, full,
                                         rule.stack_ndims, offset,
                                         rule.shards)
    return params


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------


def plan_payload_shapes(param_shapes: dict, plan: SparsityPlan,
                        budgets: dict) -> dict:
    """Shapes of the compacted inter-node payload for every leaf
    (followers shrink with their mask class; budgets are group units)."""
    shapes = dict(param_shapes)
    for rule in plan.rules:
        if not rule.compactable:
            continue
        B = budgets[rule.name] * rule.group_size
        for la in rule.all_leaves:
            s = list(shapes[la.key])
            s[la.axes[0]] = B
            shapes[la.key] = tuple(s)
    return shapes


def plan_bytes(param_shapes: dict, plan: SparsityPlan, budgets: dict, dtype,
               codec=None) -> tuple[int, int]:
    """(dense_bytes, compact_bytes) of the inter-node payload over all
    leaves, through ``codec``'s ``wire_bytes`` (a WireCodec or spec
    string; None = dense).  Leaves in no rule count at full size in both."""
    from ..comm import get_codec
    codec = get_codec(codec if codec is not None else "dense")
    compact_shapes = plan_payload_shapes(param_shapes, plan, budgets)
    dense = sum(codec.wire_bytes(s, dtype) for s in param_shapes.values())
    compact = sum(codec.wire_bytes(s, dtype)
                  for s in compact_shapes.values())
    return dense, compact


def mask_sync_bytes(param_shapes: dict, plan: SparsityPlan,
                    mode: str = "score_consensus") -> int:
    """Wire bytes of the Phase-3 mask agreement a DYNAMIC round adds on
    top of the payload exchange: per rule, the (stack, groups) f32 score
    tensor (score-consensus) or the mask bitmap (bitwise-or, Eq. 14)."""
    total = 0
    for rule in plan.rules:
        stack = param_shapes[rule.leaves[0].key][:rule.stack_ndims]
        n = rule.groups
        for s in stack:
            n *= s
        total += n * 4 if mode == "score_consensus" else (n + 7) // 8
    return total
