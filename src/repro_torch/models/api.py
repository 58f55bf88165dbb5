"""Model protocol of the port: every architecture exposes one functional
bundle (port of ``repro/models/api.py`` without sharding specs).

  * ``init(generator, device)`` flat params ``{leaf key: tensor}`` (NO
    leading consensus dims), drawn from a CPU ``torch.Generator``;
  * ``train_loss(p, batch)``    scalar, per-worker;
  * ``plan``                    structured-sparsity plan (paper S^l sets);
  * ``stack_map``               (prefix, ndims) scan-stack metadata for
                                layer-wise penalties;
  * ``shapes``                  ``{leaf key: shape}`` without allocating.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..configs.base import ArchConfig
from ..core.sparsity import SparsityPlan


@dataclass
class ModelBundle:
    cfg: ArchConfig
    init: Callable
    train_loss: Callable
    plan: SparsityPlan
    shapes: dict
    stack_map: tuple = (("blocks", 1),)
