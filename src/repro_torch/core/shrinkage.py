"""Physical shrinkage & recovery of communication buffers (paper §4.4).

Port of ``repro/core/shrinkage.py``.  ``compact_leaf``/``expand_leaf``
implement Eq. 15 and the zero-fill recovery with static buffer shapes:
the kept-index set has a fixed size B per rule, so the inter-node payload
is a dense contiguous (B, ...) tensor with no index metadata on the wire.
``compact_params``/``expand_params`` apply every rule of a plan in plan
order and in reverse; ``plan_bytes`` is the exact byte accounting.

``compact_state``/``expand_state`` lift the migration to the WHOLE
H-SADMM state (theta/mom/u, every z/v level) — the physical
reconfiguration path: once masks freeze, the training state moves onto
budget-B shapes and the round runs over the smaller dense model.
``shrunk_plan`` builds the matching all-kept plan.  The port has no
stateful wire codec yet, so there is no error-feedback state to migrate.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .coupling import validate_compaction_order
from .sparsity import GroupRule, SparsityPlan, channel_idx, top_k_indices


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
# whole-state migration (physical reconfiguration)
# ---------------------------------------------------------------------------


_LEAD_GROUPS = ("theta", "mom", "u")   # (W, *param) per-worker trees


def compacting_rule(plan: SparsityPlan, key: str, axis: int):
    """The compactable rule (if any) that slices ``axis`` of leaf ``key``."""
    for r in plan.rules:
        if not r.compactable:
            continue
        for la in r.all_leaves:
            if la.key == key and la.axes[0] == axis:
                return r
    return None


def _composite_dims(rule: GroupRule, param_shapes) -> tuple[int, ...]:
    """Per-axis dims of a (single-leaf) composite rule's group axes."""
    if len(rule.leaves) != 1 or rule.followers:
        raise NotImplementedError(
            f"projection-only rule {rule.name!r} spans several leaves; "
            "physical reconfiguration handles single-leaf composite rules")
    la = rule.leaves[0]
    return tuple(param_shapes[la.key][a] for a in la.axes)


def shrunk_plan(plan: SparsityPlan, budgets: dict,
                param_shapes: "dict | None" = None) -> SparsityPlan:
    """The reconfigured engine's plan: every compactable rule's group axis
    IS its static budget B (all groups kept, so projection and compaction
    are identities and the consensus keeps its structure).  A
    projection-only (composite-axis) rule keeps its masks; when another
    rule compacts one of its group axes (the CNN S_s ∩ S_c case) its
    composite group count shrinks by the same factor, which needs
    ``param_shapes`` (full leaf shapes, channel units)."""
    rules = []
    for r in plan.rules:
        if r.compactable:
            B = int(budgets[r.name])
            rules.append(dataclasses.replace(r, groups=B, keep=B))
            continue
        overlap = [(la.key, a) for la in r.all_leaves for a in la.axes
                   if compacting_rule(plan, la.key, a) is not None]
        if not overlap:
            rules.append(r)
            continue
        if param_shapes is None:
            raise ValueError(
                f"projection-only rule {r.name!r} shares compacted axes "
                f"{overlap}; shrunk_plan needs param_shapes to resolve "
                "the composite group dims")
        dims = _composite_dims(r, param_shapes)
        la = r.leaves[0]
        new_groups = 1
        for a, d in zip(la.axes, dims):
            cr = compacting_rule(plan, la.key, a)
            new_groups *= d if cr is None \
                else int(budgets[cr.name]) * cr.group_size
        rules.append(dataclasses.replace(
            r, groups=new_groups, keep=min(r.keep, new_groups)))
    return SparsityPlan(tuple(rules))


def shrunk_projection_mask_state(rule: GroupRule, new_rule: GroupRule,
                                 mstate: dict, plan: SparsityPlan,
                                 idxs: dict, param_shapes: dict) -> dict:
    """Migrate a projection-only composite rule's frozen mask state onto
    the reconfigured shapes: gather the mask along every group axis that
    another rule compacts, and rebuild idx/valid at the shrunk keep
    budget (kept groups first, ties to the lower index as
    ``jax.lax.top_k`` breaks them, then sorted).  Only stack-free
    composite rules occur (the CNN S_s rules); stacked ones raise."""
    if rule.stack_ndims != 0:
        raise NotImplementedError(
            f"composite-rule mask migration with stack_ndims="
            f"{rule.stack_ndims} ({rule.name!r})")
    la = rule.leaves[0]
    dims = _composite_dims(rule, param_shapes)
    m = mstate["mask"].reshape(dims)
    for i, a in enumerate(la.axes):
        cr = compacting_rule(plan, la.key, a)
        if cr is None:
            continue
        m = torch.index_select(m, i, channel_idx(cr, idxs[cr.name]))
    m = m.reshape(-1)
    idx = torch.sort(top_k_indices(m, new_rule.keep), dim=-1).values
    return {"idx": idx, "valid": m[idx], "mask": m,
            "drift": torch.zeros((), dtype=torch.float32, device=m.device)}


def compact_state(state: dict, plan: SparsityPlan, idxs: dict,
                  new_masks: dict) -> dict:
    """Migrate a frozen full-shape H-SADMM state onto budget-B shapes.

    Every per-worker tree (theta/mom/u) and every consensus level (z[k],
    v[k]) is sliced through ``compact_params`` with the frozen kept-index
    set; rho, weights and the counter are shape-invariant.  Dropping the
    discarded coordinates IS the reconfiguration's projection:
    ``expand_state(compact_state(s))`` equals ``s`` with the dropped
    groups zeroed."""
    out = dict(state)
    for g in _LEAD_GROUPS:
        if g in state:
            out[g] = compact_params(state[g], plan, idxs, offset=1)
    out["z"] = [compact_params(z, plan, idxs, offset=1) for z in state["z"]]
    out["v"] = [compact_params(v, plan, idxs, offset=1) for v in state["v"]]
    out["masks"] = new_masks
    return out


def expand_state(state: dict, plan: SparsityPlan, idxs: dict, fulls: dict,
                 masks_full: dict) -> dict:
    """Inverse of :func:`compact_state`: zero-fill every migrated tree back
    onto the full-architecture shapes.  ``masks_full`` is the frozen
    full-shape mask state the reconfiguration was derived from; it is
    reinstated with zero drift, so the result is a valid frozen
    full-shape state."""
    out = dict(state)

    def exp(tree):
        return expand_params(tree, plan, idxs, fulls, offset=1)

    for g in _LEAD_GROUPS:
        if g in state:
            out[g] = exp(state[g])
    out["z"] = [exp(z) for z in state["z"]]
    out["v"] = [exp(v) for v in state["v"]]
    out["masks"] = {name: dict(m, drift=torch.zeros_like(m["drift"]))
                    for name, m in masks_full.items()}
    return out


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
