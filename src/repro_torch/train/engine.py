"""Engine: binds a ModelBundle + the H-SADMM core to one device — port of
``repro/train/engine.py`` for a single card.

All W ADMM workers live stacked on the leading dim of every state tensor
on one device, so the hierarchy's "collectives" are reductions over that
dim; there are no shardings.  The device defaults to ``"cuda"``: an
Engine never falls back to the CPU on its own (pass ``device="cpu"`` to
ask for it).  On the card, convolutions and matmuls run in full f32, as
the reference does: TF32 is switched off for both.

Physical reconfiguration (:meth:`Engine.reconfigure`) builds the engine
of the budget-B model and migrates the whole state onto it on the same
device.  :meth:`Engine.with_class_weights` gives an engine whose
consensus carries per-coupling-class weights (``dist.ft.class_scoped``
policies), :meth:`Engine.with_staleness` one whose rounds run overlapped
(``HsadmmConfig.staleness=1``: ``round_step_fn`` hands out
``round_step_overlapped``, and ``flush_pipeline_fn`` drains it).
``local_step_fn`` and ``consensus_step_fn`` are the per-step dispatch
path's functions.  The compiled-HLO introspection waits for a later slice
of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import ConsensusSpec, ShapeConfig
from ..core.consensus import consensus_step
from ..core.hsadmm import (EngineSpec, flush_pipeline, identity_mask_state,
                           init_state, local_step, round_step,
                           round_step_overlapped)
from ..core.shrinkage import (compact_state, compacting_rule, expand_state,
                              shrunk_plan, shrunk_projection_mask_state)
from ..device import bind_card_settings, resolve_device
from ..models import build, shrink_config
from ..models.api import ModelBundle


class Engine:
    def __init__(self, bundle: ModelBundle,
                 shape: Optional[ShapeConfig] = None,
                 consensus: Optional[ConsensusSpec] = None,
                 device=None, class_weights: bool = False):
        self.device = bind_card_settings(resolve_device(device))
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.shape = shape
        self.consensus = consensus or self.cfg.consensus
        self.class_weights = class_weights
        if self.cfg.hsadmm.staleness not in (0, 1):
            raise ValueError(
                f"staleness={self.cfg.hsadmm.staleness} is not supported: "
                "0 (sequential round) and 1 (one-round-stale overlapped "
                "round) are the implemented depths")
        self.spec = EngineSpec(
            plan=bundle.plan, consensus=self.consensus, hp=self.cfg.hsadmm,
            stack_map=tuple(bundle.stack_map), class_weights=class_weights)
        # set by reconfigure(): the full-shape parent engine and the frozen
        # full-shape mask state the reconfiguration was derived from
        self.parent: Optional["Engine"] = None
        self.frozen_masks: Optional[dict] = None

    @property
    def workers(self) -> int:
        return self.consensus.num_workers

    def with_wire(self, intra: Optional[str] = None,
                  inter: Optional[str] = None, wire_map=None) -> "Engine":
        """A new Engine whose consensus exchanges run through the given
        ``repro_torch.comm`` codec specs (None keeps the config's choice);
        ``wire_map`` (one spec per level boundary) overrides both."""
        hp = self.cfg.hsadmm
        hp = dataclasses.replace(
            hp, wire_intra=intra if intra is not None else hp.wire_intra,
            wire_inter=inter if inter is not None else hp.wire_inter,
            wire_map=tuple(wire_map) if wire_map is not None
            else hp.wire_map)
        bundle = dataclasses.replace(self.bundle,
                                     cfg=self.cfg.replace(hsadmm=hp))
        return self._derive(bundle)

    def with_staleness(self, staleness: int) -> "Engine":
        """A new Engine running its rounds at the given overlap depth
        (``HsadmmConfig.staleness``: 0 sequential, 1 overlapped)."""
        hp = dataclasses.replace(self.cfg.hsadmm, staleness=staleness)
        bundle = dataclasses.replace(self.bundle,
                                     cfg=self.cfg.replace(hsadmm=hp))
        return self._derive(bundle)

    def with_class_weights(self, enabled: bool = True) -> "Engine":
        """A new Engine whose consensus carries per-coupling-class
        straggler weights (``dist.ft.class_scoped`` policies).  This
        changes the STATE STRUCTURE (adds a ``class_weights`` tree): init
        the state through the new engine."""
        return self._derive(self.bundle, class_weights=enabled)

    def _derive(self, bundle: ModelBundle, *,
                class_weights: Optional[bool] = None) -> "Engine":
        """A sibling Engine over ``bundle`` (same shape, hierarchy and
        device) that keeps the reconfiguration lineage (parent and frozen
        masks)."""
        eng = Engine(bundle, self.shape, consensus=self.consensus,
                     device=self.device,
                     class_weights=self.class_weights
                     if class_weights is None else class_weights)
        eng.parent, eng.frozen_masks = self.parent, self.frozen_masks
        return eng

    def init_state_fn(self):
        """``fn(seed) -> state``: the bundle's init drawn from a CPU
        ``torch.Generator`` seeded with ``seed``, replicated onto the
        engine's device."""
        def fn(seed: int):
            gen = torch.Generator().manual_seed(seed)
            return init_state(self.bundle.init(gen, self.device), self.spec)
        return fn

    def local_step_fn(self):
        """``fn(state, batch, eta) -> (state, mean loss)``: one local
        prox-SGD step on every worker (the per-step dispatch path)."""
        ga = max(self.cfg.grad_accum, 1)

        def fn(state, batch, eta):
            return local_step(state, batch, self.bundle.train_loss,
                              self.spec, eta, grad_accum=ga)
        return fn

    def consensus_step_fn(self, frozen: bool):
        """``fn(state) -> (state, info)``: one hierarchical consensus
        (dynamic or frozen masks) of the per-step dispatch path."""
        def fn(state):
            return consensus_step(state, self.spec, frozen=frozen)
        return fn

    def round_step_fn(self, frozen: bool):
        """``fn(state, superbatch, eta) -> (state, RoundMetrics)``: E local
        prox-SGD steps + one hierarchical consensus (dynamic or frozen
        masks); at staleness 1 the overlapped round."""
        ga = max(self.cfg.grad_accum, 1)
        step = round_step if self.cfg.hsadmm.staleness == 0 \
            else round_step_overlapped

        def fn(state, superbatch, eta):
            return step(state, superbatch, self.bundle.train_loss,
                        self.spec, eta, grad_accum=ga, frozen=frozen)
        return fn

    def flush_pipeline_fn(self, frozen: bool):
        """``fn(state) -> (state, RoundMetrics)``: the consensus-only drain
        of an overlapped round sequence (``core.hsadmm.flush_pipeline``).
        After it the state is what a sequential round would have left."""
        def fn(state):
            return flush_pipeline(state, self.spec, frozen=frozen)
        return fn

    # ------------------------------------------------------------------ #
    # physical reconfiguration (paper §4.4 applied to the whole run)
    # ------------------------------------------------------------------ #

    def _boundary_compact_flags(self) -> tuple:
        """Per level boundary: does it ship the physically-shrunk buffer
        (so its wire error feedback is already at budget-B shapes)?  A
        solo engine has no boundary."""
        if self.spec.solo:
            return ()
        return tuple(self.spec.boundary_compact(k)
                     for k in range(1, self.spec.num_levels + 1))

    @property
    def reconfigured(self) -> bool:
        return self.parent is not None

    def reconfigure(self, state: Optional[dict] = None,
                    masks: Optional[dict] = None):
        """Move onto the physically-shrunk architecture once masks are
        frozen.

        Builds a new Engine over the budget-B model (``shrink_config``
        widths and the all-kept ``shrunk_plan``; same hierarchy, codecs
        and device, TF32 off) and migrates the ENTIRE H-SADMM state
        through ``compact_state`` on the device.  Returns ``(new_engine,
        migrated_state)``; ``migrated_state`` is None when only ``masks``
        (a frozen full-shape mask state) is given.  The caller drops its
        reference to the full-shape state, which frees it."""
        if self.reconfigured:
            raise ValueError("engine is already reconfigured")
        if masks is None:
            if state is None:
                raise ValueError("reconfigure() needs state= or masks=")
            masks = state["masks"]
        plan, budgets = self.spec.plan, self.spec.budgets
        param_shapes = self.bundle.shapes
        new_cfg = shrink_config(self.cfg, plan, budgets)
        new_plan = shrunk_plan(plan, budgets, param_shapes)
        bundle2 = dataclasses.replace(build(new_cfg), cfg=new_cfg,
                                      plan=new_plan)
        eng2 = Engine(bundle2, self.shape, consensus=self.consensus,
                      device=self.device, class_weights=self.class_weights)
        eng2.parent = self
        eng2.frozen_masks = {
            name: {f: t.to(self.device) for f, t in m.items()}
            for name, m in masks.items()}
        if state is None:
            return eng2, None

        idxs = {r.name: state["masks"][r.name]["idx"] for r in plan.rules}
        new_masks = {}
        for r2 in new_plan.rules:
            old = state["masks"][r2.name]
            r1 = plan.rule(r2.name)
            if r1.compactable:
                stack = bundle2.shapes[r2.leaves[0].key][:r2.stack_ndims]
                new_masks[r2.name] = identity_mask_state(
                    r2, tuple(stack), budgets[r2.name], self.device)
            elif any(compacting_rule(plan, la.key, a) is not None
                     for la in r1.all_leaves for a in la.axes):
                # projection-only composite rule riding a compacted
                # sub-axis (S_s over a shrunk C_in): gather the frozen
                # mask onto the kept channels
                new_masks[r2.name] = shrunk_projection_mask_state(
                    r1, r2, old, plan, idxs, param_shapes)
            else:
                new_masks[r2.name] = dict(
                    old, drift=torch.zeros_like(old["drift"]))
        return eng2, compact_state(state, plan, idxs, new_masks,
                                   self._boundary_compact_flags())

    def expand_reconfigured(self, state: dict) -> dict:
        """Inverse migration (on a RECONFIGURED engine): zero-fill the
        compact state back onto the parent's full-architecture shapes —
        the full-shape reference state of the conformance tests."""
        if not self.reconfigured:
            raise ValueError("expand_reconfigured() needs a reconfigured "
                             "engine (see Engine.reconfigure)")
        plan = self.parent.spec.plan
        masks_full = self.frozen_masks
        idxs = {r.name: masks_full[r.name]["idx"] for r in plan.rules}
        fulls = {r.name: r.groups for r in plan.rules}
        return expand_state(state, plan, idxs, fulls, masks_full,
                            self.parent._boundary_compact_flags())
