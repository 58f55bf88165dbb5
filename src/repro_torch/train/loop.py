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
``RunConfig.reconfig_patience`` rounds (None: ``HsadmmConfig.
reconfig_patience``) the loop drains, migrates the whole state onto the
budget-B model (``Engine.reconfigure``) and runs the frozen round of the
reconfigured engine from then on.  A model family without a width mapping
(the SSM) refuses ``reconfig`` before the first round.

Checkpoints (``repro_torch.dist.checkpoint``, the reference's on-disk
layout): with ``RunConfig.ckpt_dir`` the loop saves the state after a
drain every ``ckpt_every`` rounds, in the background, with the run's meta
and, after a reconfiguration, the frozen full-shape masks as aux arrays;
``train`` returns once every save is on disk.  With ``resume`` it
restores the newest checkpoint first, elastically (the worker count may
differ), and a reconfigured save straight into the reconfigured engine
rebuilt from its aux masks.  As in the reference, a resumed run restarts
the synthetic stream from its first batch.  Save host time is kept out of
the round walls.

Fault tolerance (``repro_torch.dist.ft``): ``RunConfig.ft_policy`` writes
``state["weights"]`` before every round, and a class-scoped policy also
``state["class_weights"]`` (switching the engine to per-class weights).

``RunConfig.staleness=1`` runs overlapped rounds (``Engine.with_staleness``);
before a reconfiguration the loop drains the pipeline
(``Engine.flush_pipeline_fn``), and its checkpoints hold the state as it
is, one theta pending.  ``fused_rounds=False`` is the per-step dispatch
path: E calls of ``local_step_fn`` on single batches, then
``consensus_step_fn``, with the metrics drained every round; it neither
overlaps nor reconfigures.  A solo engine (one worker) ships nothing
between nodes.

Options that later slices of the port bring (automatic wire selection,
compiled-HLO statistics) raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..configs.base import ShapeConfig
from ..core.hsadmm import round_metrics
from ..core.shrinkage import mask_sync_bytes, plan_bytes
from ..data.pipeline import batches, prefetch, superbatches
from ..data.synthetic import make_stream
from ..dist import checkpoint as ckpt
from ..models import can_shrink
from .engine import Engine


@dataclass(frozen=True)
class RunConfig:
    """Everything one training run needs beyond the engine itself (the
    reference's fields, see ``repro.train.loop.RunConfig``)."""

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
    # physical reconfiguration: once masks have been frozen for
    # `reconfig_patience` rounds (None = HsadmmConfig.reconfig_patience),
    # migrate the whole state onto budget-B shapes
    reconfig: bool = False
    reconfig_patience: Optional[int] = None
    log: Optional[Callable] = print

    # JSON: process-local callables (eval_fn, log) are not serialized;
    # ft_policy serializes by its canonical dist.ft spec string
    _JSON_SKIP = ("eval_fn", "log")

    def to_json(self) -> dict:
        """Plain-JSON dict of this run (the reference's), bit-stable
        through :meth:`from_json`."""
        out = {}
        for f in dataclasses.fields(self):
            if f.name in self._JSON_SKIP:
                continue
            v = getattr(self, f.name)
            if f.name == "shape":
                v = dataclasses.asdict(v)
            elif f.name == "ft_policy" and v is not None:
                spec = getattr(v, "spec", None)
                if spec is None:
                    raise ValueError(
                        "RunConfig.ft_policy is not serializable: build "
                        "it through the repro_torch.dist.ft factories (they "
                        "attach a canonical .spec) or ft.from_spec")
                v = spec
            elif f.name == "wire_map" and v is not None:
                v = list(v)
            out[f.name] = v
        return out

    @staticmethod
    def from_json(d: dict) -> "RunConfig":
        """Inverse of :meth:`to_json` (eval_fn/log take their defaults).
        Unknown keys raise."""
        from ..dist import ft
        d = dict(d)
        shape = ShapeConfig(**d.pop("shape"))
        ft_spec = d.pop("ft_policy", None)
        wm = d.pop("wire_map", None)
        known = {f.name for f in dataclasses.fields(RunConfig)
                 if f.name not in RunConfig._JSON_SKIP + ("shape",
                                                          "ft_policy",
                                                          "wire_map")}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown RunConfig JSON keys: "
                             f"{sorted(unknown)}")
        return RunConfig(
            shape=shape,
            ft_policy=ft.from_spec(ft_spec) if ft_spec else None,
            wire_map=tuple(wm) if wm is not None else None, **d)


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
    bytes.  A solo engine exchanges nothing."""
    dense_eq, _ = _plan_volume(engine, "dense")
    if engine.spec.solo:
        return dense_eq, 0, 0
    codecs = engine.spec.codecs
    dense_w, compact_w = _plan_volume(engine, codecs[-1])
    base = compact_w if engine.spec.boundary_compact(len(codecs), codecs) \
        else dense_w
    mask_b = mask_sync_bytes(engine.bundle.shapes, engine.bundle.plan,
                             engine.cfg.hsadmm.mask_mode)
    return dense_eq, base + mask_b, base


def _masks_aux(masks: dict, plan) -> dict:
    """Frozen full-shape mask state as flat checkpoint aux arrays."""
    return {f"masks/{r.name}/{f}": v for r in plan.rules
            for f, v in masks[r.name].items()}


def _masks_from_aux(aux: dict, plan, device) -> dict:
    """Inverse of :func:`_masks_aux` on ``device`` (int64 indices)."""
    out = {}
    for r in plan.rules:
        m = {f: torch.from_numpy(aux[f"masks/{r.name}/{f}"]).to(device)
             for f in ("idx", "valid", "mask", "drift")}
        m["idx"] = m["idx"].long()
        out[r.name] = m
    return out


_LATER = {
    "wire_auto": "automatic wire selection",
    "hlo_stats": "collective statistics",
}


def _refuse_unported(run: RunConfig) -> None:
    for name, what in _LATER.items():
        if getattr(run, name):
            raise NotImplementedError(
                f"RunConfig.{name}: {what} comes in a later slice of the "
                "PyTorch port")


def train(engine: Engine, run: RunConfig) -> tuple[dict, TrainReport]:
    """Run the H-SADMM training loop of ``run`` on the engine's device."""
    _refuse_unported(run)
    if run.reconfig and not can_shrink(engine.cfg):
        raise NotImplementedError(
            f"RunConfig.reconfig: model family {engine.cfg.family!r} has no "
            "width mapping for physical reconfiguration (as in the "
            "reference)")
    return _train(engine, run)


def _train(engine: Engine, run: RunConfig) -> tuple[dict, TrainReport]:
    log = run.log
    if run.wire_intra or run.wire_inter or run.wire_map:
        engine = engine.with_wire(run.wire_intra, run.wire_inter,
                                  run.wire_map)
    if run.staleness is not None \
            and run.staleness != engine.cfg.hsadmm.staleness:
        engine = engine.with_staleness(run.staleness)
    staleness = engine.cfg.hsadmm.staleness
    if staleness and not run.fused_rounds:
        raise ValueError(
            "staleness >= 1 requires fused_rounds=True: the overlap lives "
            "inside the round function (the per-step path has no pipeline "
            "to overlap)")
    if run.reconfig and not run.fused_rounds:
        raise ValueError("RunConfig.reconfig requires fused_rounds=True "
                         "(the reconfigured engine runs fused rounds)")
    per_class = run.ft_policy is not None \
        and getattr(run.ft_policy, "per_class", False)
    if per_class and not engine.class_weights:
        engine = engine.with_class_weights(True)
        if log:
            log("[loop] class-scoped ft policy: enabled per-class "
                "consensus weights")
    if per_class:
        rule_names = {r.name for r in engine.bundle.plan.rules}
        unknown = set(run.ft_policy.class_weights(0, engine.workers)) \
            - rule_names
        if unknown:
            raise ValueError(
                f"class-scoped ft policy names unknown coupling classes "
                f"{sorted(unknown)}; plan has {sorted(rule_names)}")
    hp = engine.cfg.hsadmm
    E = max(hp.local_steps, 1)
    stream = make_stream(engine.cfg, run.shape, engine.workers,
                         device=engine.device)
    if run.fused_rounds:
        it = prefetch(superbatches(batches(stream), E))
        round_dyn = engine.round_step_fn(frozen=False)
        round_frz = engine.round_step_fn(frozen=True)
    else:
        it = prefetch(batches(stream))
        local_fn = engine.local_step_fn()
        cons_dyn = engine.consensus_step_fn(frozen=False)
        cons_frz = engine.consensus_step_fn(frozen=True)
    patience = run.reconfig_patience if run.reconfig_patience is not None \
        else hp.reconfig_patience
    rc_engine = None   # the reconfigured engine once the migration ran

    state = None
    start_k = 0
    if run.ckpt_dir and run.resume:
        last = ckpt.latest(run.ckpt_dir)
        if last is not None:
            restore_eng = engine
            if ckpt.read_meta(last).get("reconfigured"):
                # the save is at shrunk shapes: rebuild the reconfigured
                # engine from the aux masks and restore straight into it
                if not run.fused_rounds:
                    raise ValueError(
                        f"checkpoint {last} was saved by a reconfigured "
                        "run; resuming it needs fused_rounds=True")
                masks_full = _masks_from_aux(ckpt.load_aux(last),
                                             engine.bundle.plan,
                                             engine.device)
                rc_engine, _ = engine.reconfigure(masks=masks_full)
                restore_eng = rc_engine
                round_frz = rc_engine.round_step_fn(frozen=True)
            state, meta = ckpt.restore_elastic(
                last, restore_eng.init_state_fn()(run.seed), engine.workers)
            start_k = int(meta["step"])
            if log:
                log(f"[loop] resumed from {last} at outer iter {start_k}"
                    + (" (reconfigured)" if rc_engine is not None else ""))
    if state is None:
        state = engine.init_state_fn()(run.seed)
    dense_eq_b, dyn_b, frz_b = round_comm_bytes(engine)
    report = TrainReport(wire_map=_wire_map(engine))
    if rc_engine is not None:
        _, _, frz_b = round_comm_bytes(rc_engine)
        report.wire_map_reconfigured = _wire_map(rc_engine)

    frozen = rc_engine is not None   # a reconfigured resume is frozen
    if frozen:
        report.frozen_at = start_k
        report.reconfigured_at = start_k
    stop = False
    eta = torch.tensor(run.eta, dtype=torch.float32, device=engine.device)
    metrics_every = max(run.metrics_every, 1) if run.fused_rounds else 1
    pending: list = []   # [(k, was_frozen, RoundMetrics-on-device)]
    t_block = time.perf_counter()
    host_overhead = 0.0  # save/eval host time, excluded from round walls

    def drain():
        """Read all pending RoundMetrics in one host sync; update the
        report and the drift-freeze / convergence decisions.  The sync
        waits for every pending round, so the elapsed time since the last
        drain (minus save and eval time) is spread evenly over the drained
        rounds."""
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

    for k in range(start_k, run.outer_iters):
        if run.reconfig and frozen and rc_engine is None \
                and report.frozen_at is not None \
                and k - report.frozen_at >= patience:
            # masks stable for `patience` frozen rounds: drain, then move
            # the whole state onto budget-B shapes (the full-shape state
            # is freed when `state` is rebound)
            drain()
            if stop:
                break   # converged in the drained block
            t_r = time.perf_counter()
            if staleness:
                # the overlapped state still carries one un-reduced theta:
                # reduce it, so that the migration moves a buffer the
                # frozen masks describe
                state, _ = engine.flush_pipeline_fn(frozen=True)(state)
            rc_engine, state = engine.reconfigure(state)
            if engine.device.type == "cuda":
                torch.cuda.synchronize(engine.device)
            report.wire_map_reconfigured = _wire_map(rc_engine)
            round_frz = rc_engine.round_step_fn(frozen=True)
            _, _, frz_b = round_comm_bytes(rc_engine)
            report.reconfigured_at = k
            report.reconfig_seconds = time.perf_counter() - t_r
            # the migration is host-timed and kept out of the round walls
            host_overhead += report.reconfig_seconds
            if log:
                log(f"[loop] physically reconfigured at outer iter {k}: "
                    f"frozen-round payload {frz_b / 1e6:.2f}MB/round")
        if run.ft_policy is not None:
            state = dict(state, weights=_weights(
                run.ft_policy(k, engine.workers), engine.device))
            if per_class:
                cw = dict(state["class_weights"])
                for name, v in run.ft_policy.class_weights(
                        k, engine.workers).items():
                    cw[name] = _weights(v, engine.device)
                state["class_weights"] = cw
        was_frozen = frozen
        if run.fused_rounds:
            state, m = (round_frz if frozen else round_dyn)(state, next(it),
                                                            eta)
        else:
            for _ in range(E):   # the per-step dispatch path
                state, loss = local_fn(state, next(it), eta)
            state, info = (cons_frz if frozen else cons_dyn)(state)
            m = round_metrics(state, info, loss, engine.spec)
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
        if run.ckpt_dir and run.ckpt_every > 0 \
                and (k + 1) % run.ckpt_every == 0:
            drain()   # attribute pending compute before the host copy
            t_c = time.perf_counter()
            ckpt.save(run.ckpt_dir, state,
                      {"step": k + 1, "arch": engine.cfg.name,
                       "workers": engine.workers,
                       "levels": list(engine.consensus.levels),
                       "reconfigured": rc_engine is not None},
                      keep=run.ckpt_keep, background=True,
                      aux=_masks_aux(rc_engine.frozen_masks,
                                     engine.bundle.plan)
                      if rc_engine is not None else None)
            host_overhead += time.perf_counter() - t_c
        if stop:
            break
    drain()
    it.close()   # stops the prefetch thread and frees the batches it holds
    report.final_engine = rc_engine if rc_engine is not None else engine
    if run.ckpt_dir:
        ckpt.flush()   # background saves are on disk once train() returns
    return state, report


def _wire_map(engine: Engine) -> Optional[list]:
    """Codec spec per level boundary (None for a solo engine, which has
    no exchange)."""
    return None if engine.spec.solo else [c.name for c in engine.spec.codecs]


def _weights(v, device) -> torch.Tensor:
    """A policy's (W,) weight vector as an f32 tensor on ``device``."""
    return torch.as_tensor(v, dtype=torch.float32).to(device)
