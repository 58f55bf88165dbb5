"""Engine: binds a ModelBundle + the H-SADMM core to one device — port of
``repro/train/engine.py`` for a single card.

All W ADMM workers live stacked on the leading dim of every state tensor
on one device, so the hierarchy's "collectives" are reductions over that
dim; there are no shardings.  The device defaults to ``"cuda"``: an
Engine never falls back to the CPU on its own (pass ``device="cpu"`` to
ask for it).  On the card, convolutions and matmuls run in full f32, as
the reference does: TF32 is switched off for both.

Physical reconfiguration, overlapped rounds, class-scoped weights and the
compiled-HLO introspection wait for later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import ConsensusSpec, ShapeConfig
from ..core.hsadmm import EngineSpec, init_state, round_step
from ..models.api import ModelBundle


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a missing card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card unless "
            "the caller asks for the CPU (device='cpu')")
    return dev


class Engine:
    def __init__(self, bundle: ModelBundle,
                 shape: Optional[ShapeConfig] = None,
                 consensus: Optional[ConsensusSpec] = None,
                 device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.shape = shape
        self.consensus = consensus or self.cfg.consensus
        if self.cfg.hsadmm.staleness != 0:
            raise NotImplementedError(
                f"staleness={self.cfg.hsadmm.staleness}: overlapped rounds "
                "come in a later slice of the PyTorch port")
        self.spec = EngineSpec(
            plan=bundle.plan, consensus=self.consensus, hp=self.cfg.hsadmm,
            stack_map=tuple(bundle.stack_map))

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
        return Engine(bundle, self.shape, consensus=self.consensus,
                      device=self.device)

    def init_state_fn(self):
        """``fn(seed) -> state``: the bundle's init drawn from a CPU
        ``torch.Generator`` seeded with ``seed``, replicated onto the
        engine's device."""
        def fn(seed: int):
            gen = torch.Generator().manual_seed(seed)
            return init_state(self.bundle.init(gen, self.device), self.spec)
        return fn

    def round_step_fn(self, frozen: bool):
        """``fn(state, superbatch, eta) -> (state, RoundMetrics)``: E local
        prox-SGD steps + one hierarchical consensus (dynamic or frozen
        masks)."""
        def fn(state, superbatch, eta):
            return round_step(state, superbatch, self.bundle.train_loss,
                              self.spec, eta, grad_accum=self.cfg.grad_accum,
                              frozen=frozen)
        return fn
