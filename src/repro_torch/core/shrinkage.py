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
``shrunk_plan`` builds the matching all-kept plan.  A stateful wire
codec's error feedback (``state["wire"]``) migrates with it: a dense
boundary's residuals are sliced like the params, a compact boundary's are
already at budget-B shapes and pass through.

Every rule's compaction or expansion of a payload or state tree is one
launch of the hand-written gather kernel on the card, for all the leaves
it slices, in runs of whole kept groups (``kernels.ops.gather_leaves``;
the plain ``take_along_dim`` on the CPU): the kept groups are copied
exactly, so the result is the same either way.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops, ref
from .coupling import validate_compaction_order
from .sparsity import GroupRule, SparsityPlan, channel_idx, top_k_indices


def _global_idx(idx, C: int, shards: int):
    """Kept indices of a balanced rule, (*stack, shards, B/shards) local to
    each of the ``shards`` blocks of a C-wide axis -> (*stack, B) indices
    into the whole axis (unchanged for ``shards == 1``)."""
    if shards == 1:
        return idx
    off = torch.arange(shards, dtype=idx.dtype, device=idx.device) \
        * (C // shards)
    return (idx + off[:, None]).reshape(idx.shape[:-2] + (-1,))


def compact_leaf(x, idx, ax: int, stack_ndims: int, offset: int = 0,
                 shards: int = 1):
    """Gather kept groups along ``ax``: (..., C, ...) -> (..., B, ...),
    one launch of the gather kernel (``kernels.ops.gather_leaves``); the
    ``stack_ndims`` dims of ``idx`` before B are x's axes from
    ``offset`` on.

    shards > 1 (balanced rules): ``idx`` is (*stack, shards, B/shards) with
    block-local indices into the (shards, C/shards) split of the axis.
    """
    gidx = _global_idx(idx, x.shape[ax], shards)
    if gidx.ndim - 1 != stack_ndims:
        raise ValueError(f"compact_leaf: index of shape {tuple(idx.shape)} "
                         f"for {stack_ndims} stack dims and {shards} shards")
    return ops.gather_leaves([x], gidx, [ax], offset)[0]


def _inverse(idx, full: int, shards: int):
    return ref.inverse_index(_global_idx(idx, full, shards), full)


def expand_leaf(c, idx, ax: int, full: int, stack_ndims: int,
                offset: int = 0, shards: int = 1):
    """Zero-fill recovery: (..., B, ...) -> (..., C, ...) (paper §4.4.3),
    as an inverse-permutation gather of the compact buffer whose dropped
    positions (index B) the kernel writes as zeros: a scatter into the big
    tensor would need a full-size index tensor; the inverse map is built
    by a scatter on the tiny (stack, C) index array."""
    return ops.gather_leaves([c], _inverse(idx, full, shards), [ax],
                             offset)[0]


def leaf_parts(leaves) -> list[list]:
    """``leaves`` in order, cut where a key repeats: each part is one
    launch of the gather kernel, and a leaf sliced twice by one rule (a
    bottleneck conv2 on its input and output axes) is cut by the second
    after the first."""
    parts, keys = [[]], set()
    for la in leaves:
        if la.key in keys:
            parts.append([])
            keys = set()
        parts[-1].append(la)
        keys.add(la.key)
    return parts


def _gather_rule(params: dict, rule: GroupRule, idx, leaves,
                 offset: int) -> None:
    """Gather every leaf of ``leaves`` along its rule axis by the kept
    groups ``idx`` (group units, every shard's block global), in place of
    ``params``: one launch a part of :func:`leaf_parts`."""
    for part in leaf_parts(leaves):
        outs = ops.gather_leaves(
            [params[la.key] for la in part], idx,
            [la.axes[0] + offset for la in part], offset, rule.group_size)
        params.update((la.key, o) for la, o in zip(part, outs))


def compact_params(params: dict, plan: SparsityPlan, idxs: dict,
                   offset: int = 0) -> dict:
    """Slice every compactable rule's kept groups out of every
    participating leaf (scored members AND followers), in plan order: one
    launch of the gather kernel a rule, in runs of whole groups."""
    validate_compaction_order(plan)
    params = dict(params)
    for rule in plan.rules:
        if not rule.compactable:
            continue  # projection-only rule (paper slices filter/channel only)
        gidx = _global_idx(idxs[rule.name], rule.groups, rule.shards)
        _gather_rule(params, rule, gidx, rule.all_leaves, offset)
    return params


def expand_params(params: dict, plan: SparsityPlan, idxs: dict,
                  fulls: dict, offset: int = 0) -> dict:
    """Inverse of :func:`compact_params` (rules applied in reverse order,
    one launch a rule).  ``fulls`` is in the rule's group (block) units,
    like the budgets."""
    validate_compaction_order(plan)
    params = dict(params)
    for rule in reversed(plan.rules):
        if not rule.compactable:
            continue
        inv = _inverse(idxs[rule.name], fulls[rule.name], rule.shards)
        _gather_rule(params, rule, inv, tuple(reversed(rule.all_leaves)),
                     offset)
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


def _migrate_wire(wire: list, wire_compact: tuple, fn) -> list:
    """``fn`` on every dense boundary's error-feedback tree; empty
    (stateless) boundaries and those that shipped the compact buffer
    (``wire_compact[k]``) pass through."""
    return [w if (not w or (k < len(wire_compact) and wire_compact[k]))
            else fn(w) for k, w in enumerate(wire)]


def compact_state(state: dict, plan: SparsityPlan, idxs: dict,
                  new_masks: dict, wire_compact: tuple = ()) -> dict:
    """Migrate a frozen full-shape H-SADMM state onto budget-B shapes.

    Every per-worker tree (theta/mom/u), every consensus level (z[k],
    v[k]) and every dense-boundary wire error-feedback tree is sliced
    through ``compact_params`` with the frozen kept-index set; the wire
    state of boundaries that shipped the compact buffer
    (``wire_compact[k]``) is already at budget B and passes through.
    rho, weights and the counter are shape-invariant.  Dropping the
    discarded coordinates IS the reconfiguration's projection:
    ``expand_state(compact_state(s))`` equals ``s`` with the dropped
    groups zeroed."""
    out = dict(state)
    for g in _LEAD_GROUPS:
        if g in state:
            out[g] = compact_params(state[g], plan, idxs, offset=1)
    if "z" in state:   # a solo state has no consensus variables
        out["z"] = [compact_params(z, plan, idxs, offset=1)
                    for z in state["z"]]
        out["v"] = [compact_params(v, plan, idxs, offset=1)
                    for v in state["v"]]
    if "wire" in state:
        out["wire"] = _migrate_wire(
            state["wire"], wire_compact,
            lambda w: compact_params(w, plan, idxs, offset=1))
    out["masks"] = new_masks
    return out


def expand_state(state: dict, plan: SparsityPlan, idxs: dict, fulls: dict,
                 masks_full: dict, wire_compact: tuple = ()) -> dict:
    """Inverse of :func:`compact_state`: zero-fill every migrated tree back
    onto the full-architecture shapes (compact-boundary wire state passes
    through).  ``masks_full`` is the frozen full-shape mask state the
    reconfiguration was derived from; it is reinstated with zero drift,
    so the result is a valid frozen full-shape state."""
    out = dict(state)

    def exp(tree):
        return expand_params(tree, plan, idxs, fulls, offset=1)

    for g in _LEAD_GROUPS:
        if g in state:
            out[g] = exp(state[g])
    if "z" in state:
        out["z"] = [exp(z) for z in state["z"]]
        out["v"] = [exp(v) for v in state["v"]]
    if "wire" in state:
        out["wire"] = _migrate_wire(state["wire"], wire_compact, exp)
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


def compact_encode_views(param_shapes: dict, plan: SparsityPlan,
                         budgets: dict, lead: int) -> list:
    """[(key, R, C, B, rule)]: every leaf whose minor axis a compactable
    rule slices, as the codec API's ``encode_compact`` takes it from a tree
    of ``lead`` members: R rows of C full-width columns, of which the
    payload keeps B, and the rule."""
    out = []
    for key, shape in param_shapes.items():
        rule = compacting_rule(plan, key, len(shape) - 1) if shape else None
        if rule is None:
            continue
        rows = lead
        for s in shape[:-1]:
            rows *= s
        out.append((key, rows, shape[-1],
                    budgets[rule.name] * rule.group_size, rule))
    return out


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
