"""Architecture / shape / run configuration dataclasses (the port's own
copy of ``repro.configs.base``).

Only the ResNet family is registered in this package so far
(``repro_torch.configs.resnet``), so only the fields the ResNet path reads
are copied; each keeps the reference's name and default, so a config
means the same run in both packages.  A later slice that ports another
family copies its fields with it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


# ---------------------------------------------------------------------------
# H-SADMM / consensus configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HsadmmConfig:
    """Hyper-parameters of the H-SADMM algorithm (paper §3, §5.1.5)."""

    rho1: float = 1.5e-3          # intra-node penalty (paper init)
    rho2: float = 1.5e-4          # inter-node penalty (paper init)
    rho_max: float = 10.0         # cap (paper)
    adapt_mu: float = 10.0        # residual-ratio threshold (Boyd §3.4.1)
    adapt_tau: float = 2.0        # multiplicative update
    local_steps: int = 8          # E, minibatch steps per outer iteration
    t_freeze: int = 15            # outer iteration after which masks freeze
    keep_rate: float = 0.5        # structured keep fraction (paper primary: 0.5)
    mask_mode: str = "score_consensus"  # or "bitwise_or" (paper-faithful union)
    bitwise_or_slack: float = 1.5  # static budget multiplier for bitwise_or mode
    weight_decay: float = 1e-4    # lambda, applied on consensus z
    eps_abs: float = 1e-4
    eps_rel: float = 1e-3
    # Per-fabric-level wire-codec specs (repro.comm registry: "dense",
    # "q8", "topk:<rate>", "compact+q8", ...), matching the paper's
    # leader-follower split: ``wire_intra`` covers the fast intra-node
    # boundaries, ``wire_inter`` the top (inter-node / slow fabric)
    # boundary.  None = "dense" (the paper's param-dtype exchange).
    wire_intra: Optional[str] = None
    wire_inter: Optional[str] = None
    # Explicit per-boundary codec map (one spec per level boundary
    # k=1..K, innermost first) — overrides wire_intra/wire_inter
    # verbatim when set.  Emitted by repro.comm.select
    # AdaptiveWireSelector (--wire-auto) and honored by level_codecs.
    wire_map: Optional[tuple] = None
    # Overlapped-round depth (paper's leader-follower motivation, async
    # ADMM relaxation):
    #   0 = sequential round: E prox-SGD steps, then the hierarchical
    #       reduce over the fresh iterates (bit-identical to the
    #       pre-overlap code path);
    #   1 = round r's consensus reduce is issued over round r-1's
    #       iterates while round r's local scan runs on one-round-stale
    #       z/u — both read the same input state, so XLA overlaps the
    #       inter-node collectives with the local compute.
    staleness: int = 0


@dataclass(frozen=True)
class ConsensusSpec:
    """Hierarchy of the consensus reduction over the flat ADMM-worker dim.

    ``levels`` factorizes the worker count W innermost-first:
    ``(workers_per_node, nodes_per_pod, pods)``; trailing 1s may be omitted.
    Level boundaries >= ``compact_from_level`` exchange *compacted* payloads
    (the paper compacts at the node->global boundary, i.e. level 1).
    """

    levels: tuple[int, ...] = (4, 4)
    compact_from_level: int = 1
    granularity: str = "chip"  # "chip" | "pod" | "flat" (DESIGN.md §3.2)

    @property
    def num_workers(self) -> int:
        out = 1
        for l in self.levels:
            out *= l
        return out


# ---------------------------------------------------------------------------
# Architecture configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # "cnn" (the reference also has dense | moe | ssm | ...)

    # cnn (ResNet family).  cnn_widths is the per-stage BASE width; the
    # derived per-stage widths can be overridden explicitly — the handles
    # models.shrink_config uses for physical reconfiguration:
    #   cnn_outs : residual-stream width per stage
    #              (default: width*4 bottleneck, width basic)
    #   cnn_cmid : block-internal conv width per stage
    #              (default: width*cnn_width_mult bottleneck, width basic)
    #   cnn_stem : stem conv output width (default: cnn_widths[0])
    cnn_blocks: tuple[int, ...] = ()
    cnn_widths: tuple[int, ...] = ()
    cnn_bottleneck: bool = False
    cnn_width_mult: int = 1
    cnn_outs: tuple[int, ...] = ()
    cnn_cmid: tuple[int, ...] = ()
    cnn_stem: int = 0
    # GroupNorm channels-per-group (group COUNT is derived as C // size, a
    # deterministic function of the config — never a silent fallback).  It
    # is also the pruning block size of every CNN coupling class, so the
    # kept channel set is a union of whole normalization groups and
    # reconfigured GN statistics match the full-shape masked model exactly.
    cnn_gn_size: int = 8
    img_size: int = 32
    n_classes: int = 10

    # numerics / distribution policy
    param_dtype: str = "float32"
    grad_accum: int = 1
    consensus: ConsensusSpec = field(default_factory=ConsensusSpec)
    hsadmm: HsadmmConfig = field(default_factory=HsadmmConfig)

    # which structured groups are pruned (model-dependent, see models/*)
    prune_targets: tuple[str, ...] = ()

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# Registry ------------------------------------------------------------------

_REGISTRY: dict[str, "tuple"] = {}


def register(name: str, full_fn, smoke_fn) -> None:
    _REGISTRY[name] = (full_fn, smoke_fn)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    full_fn, smoke_fn = _REGISTRY[name]
    return smoke_fn() if smoke else full_fn()
