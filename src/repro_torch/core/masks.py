"""Global mask synchronization and the freezing protocol (paper §4.3, §4.5).

Port of ``repro/core/masks.py``.  Node-level projections may disagree, so
local masks are reconciled into one global mask per rule before the
inter-node exchange:

``score_consensus`` (default): average the per-group scores over nodes
    and take a global top-alpha; the compact payload is exactly ``alpha``
    groups.
``bitwise_or`` (paper Eq. 14): OR the per-node top-alpha masks; the
    static budget is ``B = min(C, ceil(slack*alpha))``, ranked by summed
    scores, slots beyond the true union carry validity 0.

Both return, per rule: ``idx (*stack, B)``, ``valid (*stack, B) f32``,
``mask (*stack, C) f32`` — with B == keep for score_consensus.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .sparsity import GroupRule, top_k_indices, topk_mask


@dataclass(frozen=True)
class MaskSyncConfig:
    mode: str = "score_consensus"   # | "bitwise_or"
    slack: float = 1.5              # bitwise_or static budget multiplier


def budget(rule: GroupRule, cfg: MaskSyncConfig) -> int:
    """Static compact-buffer group budget B for a rule."""
    if cfg.mode == "score_consensus":
        return rule.keep
    b = int(rule.keep * cfg.slack + 0.999)
    return min(rule.groups, max(b, rule.keep))


def sync_masks(node_scores, rule: GroupRule, cfg: MaskSyncConfig):
    """Build the global mask from per-node squared group scores
    ``(M, *stack, C)``.  Returns (idx, valid, mask)."""
    if cfg.mode == "score_consensus":
        g = torch.mean(node_scores, dim=0)
        mask, idx = topk_mask(g, rule.keep, rule.shards)
        valid = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
        return idx, valid, mask

    if cfg.mode == "bitwise_or":
        if rule.shards != 1:
            raise ValueError(
                f"mask mode 'bitwise_or' requires unsharded group axes, but "
                f"rule {rule.name!r} is balanced over shards={rule.shards}; "
                "use mask_mode='score_consensus' for balanced rules")
        B = budget(rule, cfg)
        local_mask, _ = topk_mask(node_scores, rule.keep)  # (M, *stack, C)
        union = torch.amax(local_mask, dim=0)              # OR
        mean_scores = torch.mean(node_scores, dim=0)       # ranking tie-break
        ranked = union * (1.0 + mean_scores)               # union first
        idx = torch.sort(top_k_indices(ranked, B), dim=-1).values
        valid = torch.take_along_dim(union, idx, dim=-1)
        return idx, valid, union

    raise ValueError(f"unknown mask mode {cfg.mode!r}")


def mask_drift(prev_mask, mask):
    """Number of groups whose membership changed since last iteration."""
    return torch.sum(torch.abs(mask - prev_mask))
