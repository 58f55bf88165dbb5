"""Convergence monitoring (paper §3.4, Boyd §3.3.1) — port of
``repro/core/residuals.py``.  The paper's stopping rule with absolute +
relative feasibility thresholds:

    eps_pri  = sqrt(n) * eps_abs + eps_rel * max(||theta||, ||z||)
    eps_dual = sqrt(n) * eps_abs + eps_rel * ||rho . u||
"""
from __future__ import annotations

import math

import torch

from ..configs.base import HsadmmConfig


def tree_norm(tree: dict):
    sq = sum(torch.sum(torch.square(x.to(torch.float32)))
             for x in tree.values())
    return torch.sqrt(sq)


def tree_size(tree: dict) -> int:
    return sum(x.numel() for x in tree.values())


def converged(state: dict, info: dict, hp: HsadmmConfig):
    """Global convergence test (Alg. 1 line 29-30), a device bool."""
    n = tree_size(state["theta"])
    th_n = tree_norm(state["theta"])
    z_n = tree_norm(state["z"][0])
    u_n = tree_norm(state["u"])
    eps_pri = math.sqrt(float(n)) * hp.eps_abs \
        + hp.eps_rel * torch.maximum(th_n, z_n)
    eps_dual = math.sqrt(float(n)) * hp.eps_abs + hp.eps_rel * u_n
    return torch.logical_and(info["r_primal"] < eps_pri,
                             info["s_dual"] < eps_dual)
