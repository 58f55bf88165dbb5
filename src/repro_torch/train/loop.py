"""Orchestration control loop — paper Algorithm 1 / §4.1.4 (port of
``repro/train/loop.py``).

Each outer round runs E local prox-SGD steps over a prefetched
``(E, W, ...)`` superbatch and the hierarchical consensus, with dynamic or
frozen masks.  The loop never reads the device on the hot path: per-round
telemetry comes back as :class:`RoundMetrics` device tensors, drained in
blocks every ``RunConfig.metrics_every`` rounds (and once at the end), so
drift freezing takes effect at the next drain while ``t_freeze`` freezing
is host-known and exact.

Communication accounting is derived from which round (dynamic, frozen or
reconfigured) ran: the top boundary's wire codec ``wire_bytes`` over the
compacted or full payload shapes, plus the Phase-3 mask-agreement bytes in
dynamic rounds.

With ``RunConfig.reconfig``, once masks have stayed frozen for
``HsadmmConfig.reconfig_patience`` rounds the loop drains, migrates the whole state
onto the budget-B model (``Engine.reconfigure``) and runs the frozen
round of the reconfigured engine from then on.

Options that later slices of the port bring (checkpoints, fault-tolerance
policies, automatic wire selection, compiled-HLO statistics, overlapped
rounds, the per-step dispatch path) raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..configs.base import ShapeConfig
from ..core.shrinkage import mask_sync_bytes, plan_bytes
from ..data.pipeline import batches, prefetch, superbatches
from ..data.synthetic import make_stream
from .engine import Engine


@dataclass(frozen=True)
class RunConfig:
    """Everything one training run needs beyond the engine itself (the
    reference's fields, see ``repro.train.loop.RunConfig``, less its
    ``reconfig_patience`` override: the patience is
    ``HsadmmConfig.reconfig_patience``)."""

    outer_iters: int
    shape: ShapeConfig
    eta: float = 1e-3
    seed: int = 0
    fused_rounds: bool = True
    metrics_every: int = 5
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 10
    ckpt_keep: Optional[int] = None
    resume: bool = True
    ft_policy: Optional[Callable] = None
    eval_fn: Optional[Callable] = None
    hlo_stats: bool = False
    wire_intra: Optional[str] = None
    wire_inter: Optional[str] = None
    wire_map: Optional[tuple] = None
    wire_auto: bool = False
    staleness: Optional[int] = None
    reconfig: bool = False
    log: Optional[Callable] = print


@dataclass
class TrainReport:
    losses: list = field(default_factory=list)
    drifts: list = field(default_factory=list)
    r_primal: list = field(default_factory=list)
    s_dual: list = field(default_factory=list)
    comm_bytes_internode: list = field(default_factory=list)
    comm_bytes_dense_equiv: list = field(default_factory=list)
    wall_times: list = field(default_factory=list)
    evals: list = field(default_factory=list)
    # which round ran: "dynamic" | "frozen" | "reconfigured" (the frozen
    # round of the reconfigured engine, on shrunk shapes)
    executables: list = field(default_factory=list)
    frozen_at: Optional[int] = None
    # first round run on the reconfigured engine (None if the run never
    # physically reconfigured)
    reconfigured_at: Optional[int] = None
    # host seconds of the state migration, device work included (it ends
    # in a synchronize); excluded from wall_times
    reconfig_seconds: Optional[float] = None
    outer_iters: int = 0
    # codec spec per level boundary the consensus routed through, before
    # and after a physical reconfiguration
    wire_map: Optional[list] = None
    wire_map_reconfigured: Optional[list] = None
    # the engine that ran the LAST round (the reconfigured one after a
    # reconfiguration)
    final_engine: Optional[object] = field(default=None, repr=False)


def _plan_volume(engine: Engine, codec) -> tuple[int, int]:
    return plan_bytes(engine.bundle.shapes, engine.bundle.plan,
                      engine.spec.budgets, engine.bundle.cfg.param_dtype,
                      codec=codec)


def comm_volume(engine: Engine, wire: bool = True) -> tuple[int, int]:
    """(dense, compact) inter-node payload bytes per consensus round, per
    node, through the engine's top-boundary codec (``wire=True``) or at
    param-dtype equivalents (``wire=False``)."""
    return _plan_volume(engine, engine.spec.codecs[-1] if wire else "dense")


def round_comm_bytes(engine: Engine) -> tuple[int, int, int]:
    """(dense_equiv, dynamic_bytes, frozen_bytes) per round: the top
    boundary ships the compact buffer iff ``compact_from_level`` covers it
    or its codec carries the ``compact`` marker; bytes come from that
    codec's ``wire_bytes``; dynamic rounds add the Phase-3 mask-agreement
    bytes."""
    dense_eq, _ = _plan_volume(engine, "dense")
    codecs = engine.spec.codecs
    dense_w, compact_w = _plan_volume(engine, codecs[-1])
    base = compact_w if engine.spec.boundary_compact(len(codecs), codecs) \
        else dense_w
    mask_b = mask_sync_bytes(engine.bundle.shapes, engine.bundle.plan,
                             engine.cfg.hsadmm.mask_mode)
    return dense_eq, base + mask_b, base


_LATER = {
    "ckpt_dir": "checkpointing",
    "ft_policy": "fault-tolerance policies",
    "wire_auto": "automatic wire selection",
    "hlo_stats": "collective statistics",
}


def _refuse_unported(run: RunConfig) -> None:
    for name, what in _LATER.items():
        if getattr(run, name):
            raise NotImplementedError(
                f"RunConfig.{name}: {what} comes in a later slice of the "
                "PyTorch port")
    if run.staleness not in (None, 0):
        raise NotImplementedError(
            f"RunConfig.staleness={run.staleness}: overlapped rounds come in "
            "a later slice of the PyTorch port")
    if not run.fused_rounds:
        raise NotImplementedError(
            "RunConfig.fused_rounds=False: the per-step dispatch path comes "
            "in a later slice of the PyTorch port")


def train(engine: Engine, run: RunConfig) -> tuple[dict, TrainReport]:
    """Run the H-SADMM training loop of ``run`` on the engine's device."""
    _refuse_unported(run)
    return _train(engine, run)


def _train(engine: Engine, run: RunConfig) -> tuple[dict, TrainReport]:
    log = run.log
    if run.wire_intra or run.wire_inter or run.wire_map:
        engine = engine.with_wire(run.wire_intra, run.wire_inter,
                                  run.wire_map)
    hp = engine.cfg.hsadmm
    E = max(hp.local_steps, 1)
    stream = make_stream(engine.cfg, run.shape, engine.workers,
                         device=engine.device)
    it = prefetch(superbatches(batches(stream), E))
    round_dyn = engine.round_step_fn(frozen=False)
    round_frz = engine.round_step_fn(frozen=True)
    rc_engine = None   # the reconfigured engine once the migration ran

    state = engine.init_state_fn()(run.seed)
    dense_eq_b, dyn_b, frz_b = round_comm_bytes(engine)
    report = TrainReport(wire_map=[c.name for c in engine.spec.codecs])

    frozen = False
    stop = False
    eta = torch.tensor(run.eta, dtype=torch.float32, device=engine.device)
    metrics_every = max(run.metrics_every, 1)
    pending: list = []   # [(k, was_frozen, RoundMetrics-on-device)]
    t_block = time.perf_counter()
    host_overhead = 0.0  # eval host time, excluded from round walls

    def drain():
        """Read all pending RoundMetrics in one host sync; update the
        report and the drift-freeze / convergence decisions.  The sync
        waits for every pending round, so the elapsed time since the last
        drain (minus eval time) is spread evenly over the drained rounds."""
        nonlocal frozen, stop, t_block, host_overhead
        if not pending:
            return
        vals = [(m.losses.reshape(-1)[-1].item(), m.drift.item(),
                 m.r_primal.item(), m.s_dual.item(), bool(m.converged))
                for (_, _, m) in pending]
        per_round = max(time.perf_counter() - t_block - host_overhead, 0.0) \
            / len(pending)
        report.wall_times.extend([per_round] * len(pending))
        for (k, was_frozen, _), (loss, drift, r_p, s_d, conv) in zip(pending,
                                                                     vals):
            drift = 0.0 if was_frozen else drift
            report.losses.append(loss)
            report.drifts.append(drift)
            report.r_primal.append(r_p)
            report.s_dual.append(s_d)
            if not frozen and k > 2 and drift == 0.0:
                frozen = True                       # §4.5 drift stability
                if report.frozen_at is None:
                    # first round the FROZEN step actually runs
                    report.frozen_at = report.outer_iters
                if log:
                    log(f"[loop] masks frozen at outer iter "
                        f"{report.frozen_at}")
            if conv:
                stop = True
                if log:
                    log(f"[loop] converged at outer iter {k + 1}")
            if log and (k % 5 == 0 or k == run.outer_iters - 1):
                log(f"[loop] k={k:3d} loss={loss:.4f} "
                    f"r={report.r_primal[-1]:.3e} drift={drift:.0f}")
        pending.clear()
        host_overhead = 0.0
        t_block = time.perf_counter()

    for k in range(run.outer_iters):
        if run.reconfig and frozen and rc_engine is None \
                and report.frozen_at is not None \
                and k - report.frozen_at >= hp.reconfig_patience:
            # masks stable for `patience` frozen rounds: drain, then move
            # the whole state onto budget-B shapes (the full-shape state
            # is freed when `state` is rebound)
            drain()
            if stop:
                break   # converged in the drained block
            t_r = time.perf_counter()
            rc_engine, state = engine.reconfigure(state)
            if engine.device.type == "cuda":
                torch.cuda.synchronize(engine.device)
            report.wire_map_reconfigured = \
                [c.name for c in rc_engine.spec.codecs]
            round_frz = rc_engine.round_step_fn(frozen=True)
            _, _, frz_b = round_comm_bytes(rc_engine)
            report.reconfigured_at = k
            report.reconfig_seconds = time.perf_counter() - t_r
            # the migration is host-timed and kept out of the round walls
            host_overhead += report.reconfig_seconds
            if log:
                log(f"[loop] physically reconfigured at outer iter {k}: "
                    f"frozen-round payload {frz_b / 1e6:.2f}MB/round")
        was_frozen = frozen
        state, m = (round_frz if frozen else round_dyn)(state, next(it), eta)
        pending.append((k, was_frozen, m))
        report.executables.append(
            "reconfigured" if (was_frozen and rc_engine is not None)
            else ("frozen" if was_frozen else "dynamic"))
        report.comm_bytes_internode.append(frz_b if was_frozen else dyn_b)
        report.comm_bytes_dense_equiv.append(dense_eq_b)
        report.outer_iters = k + 1
        if run.eval_fn is not None:
            t_e = time.perf_counter()
            report.evals.append(run.eval_fn(k, state))
            host_overhead += time.perf_counter() - t_e

        if not frozen and k + 1 >= hp.t_freeze:
            frozen = True                           # §4.5 schedule freezing
            report.frozen_at = k + 1
            if log:
                log(f"[loop] masks frozen at outer iter {k + 1}")

        if (k + 1) % metrics_every == 0 or k == run.outer_iters - 1:
            drain()
        if stop:
            break
    drain()
    it.close()   # stops the prefetch thread and frees the batches it holds
    report.final_engine = rc_engine if rc_engine is not None else engine
    return state, report
