"""H-SADMM state and the Phase-1 local update (paper §3.1, Alg. 1 line 4)
— port of ``repro/core/hsadmm.py``.

State layout (the reference's, with FLAT ``{leaf key: tensor}`` trees):

    theta, mom, u  : (W, *param)        per ADMM worker
    z[k], v[k]     : (M_k, *param)      per level-k consensus group, k=1..K
                     (M_k = W / prod(levels[:k]); M_K == 1 == global z)
    rho[k]         : per-leaf tensors of shape leaf.shape[:stack_ndims]
    weights        : (W,) f32           straggler/failure contribution weights
    class_weights  : per-rule (W,) f32  per-coupling-class weights (only
                     with ``EngineSpec.class_weights``)
    masks          : per-rule {idx (int64), valid, mask, drift}
    wire           : one flat tree per level boundary k, the stateful
                     codec's error feedback (top-k), (M_{k-1}, *payload)
                     with the payload compacted where that boundary ships
                     the shrunk buffer; ``{}`` at a stateless boundary
                     (only when some boundary's codec is stateful)
    k              : outer iteration counter

The worker dim W is flat, outer-major over (pod, node, worker).  The
single-worker solo mode (one worker at pod granularity) keeps only theta,
k, weights, mom and masks: it has no consensus variables, and its
"consensus" projects theta onto the masks (``consensus._solo_prune_step``).
Without momentum (``EngineSpec.use_momentum=False``) the state has no
``mom``.  ``grad_accum > 1`` splits each worker's batch into contiguous
microbatches and sums their gradients.  :func:`round_step_overlapped` is
the one-round-stale pipeline of ``HsadmmConfig.staleness=1``, and
:func:`flush_pipeline` drains it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
from torch.func import vjp, vmap

from ..configs.base import ConsensusSpec, HsadmmConfig
from ..kernels.ops import prox_sgd_update
from .masks import MaskSyncConfig, budget as rule_budget
from .sparsity import SparsityPlan

Params = dict


@dataclass(frozen=True)
class EngineSpec:
    """Everything static the H-SADMM engine needs."""

    plan: SparsityPlan
    consensus: ConsensusSpec
    hp: HsadmmConfig
    # (prefix, ndims) pairs; longest matching prefix wins, default 0.  A
    # leaf's first `ndims` axes are stack axes with independent layer-wise
    # penalties/residuals (paper §3.4).
    stack_map: tuple[tuple[str, int], ...] = (("blocks", 1),)
    use_momentum: bool = True
    momentum: float = 0.9
    # per-coupling-class straggler weights (``dist.ft.class_scoped``):
    # adds a ``{rule: (W,)}`` weight tree to the state and partitions the
    # wire reduce by each leaf's lead coupling class
    class_weights: bool = False

    @property
    def sync_cfg(self) -> MaskSyncConfig:
        return MaskSyncConfig(self.hp.mask_mode, self.hp.bitwise_or_slack)

    @property
    def budgets(self) -> dict:
        return {r.name: rule_budget(r, self.sync_cfg) for r in self.plan.rules}

    @property
    def num_levels(self) -> int:
        return len(self.consensus.levels)

    @property
    def solo(self) -> bool:
        return (self.consensus.num_workers == 1
                and self.consensus.granularity == "pod")

    @property
    def codecs(self) -> list:
        """One :class:`repro_torch.comm.WireCodec` per level boundary."""
        from ..comm import level_codecs
        return level_codecs(self.hp, self.consensus.levels,
                            self.consensus.compact_from_level)

    def boundary_compact(self, k: int, codecs: list = None) -> bool:
        """Does boundary k (1..K) ship the physically-shrunk buffer?"""
        codecs = codecs if codecs is not None else self.codecs
        return (k - 1) >= self.consensus.compact_from_level \
            or codecs[k - 1].compact

    def stack_ndims(self, key: str) -> int:
        best, best_len = 0, -1
        for prefix, nd in self.stack_map:
            if (key.startswith(prefix + "/") or key == prefix) \
                    and len(prefix) > best_len:
                best, best_len = nd, len(prefix)
        return best


# ---------------------------------------------------------------------------
# grouping helpers over the leading consensus dim
# ---------------------------------------------------------------------------


def ungroup(x, g: int):
    """(G, *p) -> (G*g, *p) broadcast children from their group value
    (a contiguous copy)."""
    return x[:, None].expand((x.shape[0], g) + tuple(x.shape[1:])) \
        .reshape((x.shape[0] * g,) + tuple(x.shape[1:]))


def bcast_rho(rho, leaf, stack_ndims: int, offset: int):
    """Broadcast a (stack,) penalty to a (lead..., stack, ...) leaf."""
    shape = [1] * leaf.ndim
    for i in range(stack_ndims):
        shape[offset + i] = rho.shape[i]
    return rho.reshape(shape).to(leaf.dtype)


def _rep(x, n: int):
    return x[None].expand((n,) + tuple(x.shape)).clone()


# ---------------------------------------------------------------------------
# state init
# ---------------------------------------------------------------------------


def identity_mask_state(rule, stack_shape: tuple, B: int, device) -> dict:
    """All-kept mask state for one rule: idx = arange(B) (block-local for
    balanced rules), valid/mask all-ones, drift zero (group units)."""
    if rule.shards == 1:
        idx = torch.arange(B, device=device).expand(stack_shape + (B,))
    else:
        idx = torch.arange(B // rule.shards, device=device).expand(
            stack_shape + (rule.shards, B // rule.shards))
    return {
        "idx": idx.clone(),
        "valid": torch.ones(idx.shape, dtype=torch.float32, device=device),
        "mask": torch.ones(stack_shape + (rule.groups,), dtype=torch.float32,
                           device=device),
        "drift": torch.zeros((), dtype=torch.float32, device=device),
    }


def init_state(params0: Params, spec: EngineSpec) -> dict:
    """Replicate initial params to every worker/node and zero the duals;
    masks start all-ones (paper Alg. 1 line 1).  ``params0`` has no
    leading dims; the state lives on its device."""
    W = spec.consensus.num_workers
    levels = spec.consensus.levels
    device = next(iter(params0.values())).device

    theta = {k: _rep(x, W) for k, x in params0.items()}
    state = {"theta": theta,
             "k": torch.zeros((), dtype=torch.int32, device=device),
             "weights": torch.ones((W,), dtype=torch.float32, device=device)}
    if spec.use_momentum:
        state["mom"] = {k: torch.zeros_like(x) for k, x in theta.items()}
    if spec.solo:
        # one worker: no consensus variables; its consensus step projects
        # theta onto the masks directly
        state["masks"] = _init_masks(params0, spec, device)
        return state
    state["u"] = {k: torch.zeros_like(x) for k, x in theta.items()}
    if spec.class_weights:
        # multiplied into the global weights inside consensus_step; all
        # ones gives the unscoped round's bits until a policy writes them
        state["class_weights"] = {
            r.name: torch.ones((W,), dtype=torch.float32, device=device)
            for r in spec.plan.rules}
    m = W
    zs = []
    for g in levels:
        m //= g
        zs.append({k: _rep(x, m) for k, x in params0.items()})
    state["z"] = zs
    # duals exist between consecutive levels only: v[k] couples z[k]<->z[k+1]
    state["v"] = [{k: torch.zeros_like(x) for k, x in zk.items()}
                  for zk in zs[:-1]]

    def rho_tree(val):
        return {k: torch.full(tuple(x.shape[:spec.stack_ndims(k)]), val,
                              dtype=torch.float32, device=device)
                for k, x in params0.items()}
    state["rho"] = [rho_tree(spec.hp.rho1)] + [
        rho_tree(spec.hp.rho2) for _ in range(len(levels) - 1)]
    state["masks"] = _init_masks(params0, spec, device)
    codecs = spec.codecs
    if any(c.stateful for c in codecs):
        state["wire"] = _init_wire_states(params0, spec, codecs)
    return state


def _init_masks(params0: Params, spec: EngineSpec, device) -> dict:
    """All-ones masks of every rule (paper Alg. 1 line 1)."""
    return {r.name: identity_mask_state(
                r, tuple(params0[r.leaves[0].key].shape[:r.stack_ndims]),
                spec.budgets[r.name], device)
            for r in spec.plan.rules}


def _init_wire_states(params0: Params, spec: EngineSpec, codecs: list
                      ) -> list:
    """Per-boundary error-feedback state of the stateful wire codecs: one
    zero tree shaped like the boundary-k payload, leading dim M_{k-1} and
    leaf shapes compacted where that boundary ships the shrunk buffer
    (``plan_payload_shapes``).  A stateless boundary holds ``{}``, so the
    state's structure stays the same across rounds."""
    from .shrinkage import plan_payload_shapes
    levels = spec.consensus.levels
    full_shapes = {k: tuple(x.shape) for k, x in params0.items()}
    compact_shapes = plan_payload_shapes(full_shapes, spec.plan,
                                         spec.budgets)
    out: list = []
    m = spec.consensus.num_workers
    for k in range(1, len(levels) + 1):
        lead, m = m, m // levels[k - 1]
        codec = codecs[k - 1]
        if not codec.stateful:
            out.append({})
            continue
        shapes = compact_shapes if spec.boundary_compact(k, codecs) \
            else full_shapes
        out.append(codec.init_state({
            key: torch.zeros((lead,) + shapes[key], dtype=x.dtype,
                             device=x.device)
            for key, x in params0.items()}))
    return out


# ---------------------------------------------------------------------------
# Phase 1: local prox-SGD step (Eq. 8)
# ---------------------------------------------------------------------------


def grad_and_value(loss_fn: Callable) -> Callable:
    """``fn(params, batch) -> (grads, loss)``: ``torch.func.grad_and_value``
    of ``loss_fn`` in ``params``, with the backward pass not recorded.
    torch.func's own records it (``create_graph=True``, so that transforms
    can nest), which keeps every forward activation and every
    intermediate of the backward alive until it returns; here the
    backward runs as ``loss.backward()`` would, freeing each saved tensor
    once it is used.  Same gradients, up to the rounding of the backward
    formulas PyTorch picks when it does not record.  A loss that brings
    its own ``grad_and_value`` (an LM's with ``ArchConfig.remat``, which
    recomputes each block in the backward: ``models.api.Staged``) is
    differentiated by it instead."""
    own = getattr(loss_fn, "grad_and_value", None)
    if own is not None:
        return own

    def fn(params, batch):
        loss, pullback = vjp(lambda p: loss_fn(p, batch), params)
        with torch.no_grad():
            (g,) = pullback(torch.ones_like(loss), retain_graph=False)
        return g, loss
    return fn


def accumulated(loss_fn: Callable, grad_accum: int) -> Callable:
    """:func:`grad_and_value` of ``loss_fn`` over ``grad_accum``
    contiguous microbatches of one worker's batch (the reference's
    ``x.reshape((ga, B // ga) + x.shape[1:])``), in order: losses and
    gradients summed from zeros, then divided by ``grad_accum``.  Each
    microbatch's backward runs before the next forward, so one
    microbatch's activations are alive at a time."""
    vg = grad_and_value(loss_fn)

    def fn(params, batch):
        mbs = {k: x.reshape((grad_accum, x.shape[0] // grad_accum)
                            + tuple(x.shape[1:])) for k, x in batch.items()}
        loss = torch.zeros((), dtype=torch.float32,
                           device=next(iter(params.values())).device)
        g = {k: torch.zeros_like(x) for k, x in params.items()}
        for i in range(grad_accum):
            gi, li = vg(params, {k: x[i] for k, x in mbs.items()})
            loss = loss + li
            g = {k: g[k] + gi[k] for k in g}
        ga = float(grad_accum)
        return {k: x / ga for k, x in g.items()}, loss / ga
    return fn


def local_step(state: dict, batch: dict, loss_fn: Callable, spec: EngineSpec,
               eta, grad_accum: int = 1) -> tuple[dict, torch.Tensor]:
    """One minibatch prox-SGD step on every worker.

    ``loss_fn(params_one_worker, batch_one_worker) -> scalar``; batch
    leaves have leading dim W.  Per-worker gradients come from ``vmap`` of
    :func:`grad_and_value` (of :func:`accumulated` with ``grad_accum >
    1``) over the stacked parameters; the prox gradient rho1 * (theta - z1
    + u) is added analytically inside the fused update
    (``ops.prox_sgd_update``, the hand-written kernel on the card).  In
    solo mode there is no prox term, and without momentum no momentum
    buffer: the shim then takes the reference's plain update.
    Returns (new_state, mean loss)."""
    levels = spec.consensus.levels
    theta = state["theta"]
    vg = accumulated(loss_fn, grad_accum) if grad_accum > 1 \
        else grad_and_value(loss_fn)
    g, losses = vmap(vg)(theta, batch)

    device = next(iter(theta.values())).device
    e = torch.as_tensor(eta, dtype=torch.float32, device=device)
    mom = state["mom"] if spec.use_momentum else {}
    new_theta, new_mom = {}, {}
    for key, th in theta.items():
        if spec.solo:
            z = u = r = None
        else:
            z = ungroup(state["z"][0][key], levels[0])
            u = state["u"][key]
            r = bcast_rho(state["rho"][0][key], th, spec.stack_ndims(key),
                          offset=1)
        new_theta[key], new_mom[key] = prox_sgd_update(
            th, g[key], z, u, mom.get(key), r, e, momentum=spec.momentum)
    out = dict(state)
    out["theta"] = new_theta
    if spec.use_momentum:
        out["mom"] = new_mom
    return out, torch.mean(losses)


# ---------------------------------------------------------------------------
# one outer round: E local steps + consensus (paper §4.1.4)
# ---------------------------------------------------------------------------


class RoundMetrics(NamedTuple):
    """Per-round telemetry as device tensors — the training loop drains
    these asynchronously (no host sync on the hot path)."""

    losses: torch.Tensor       # (E,) mean-over-workers loss per local step
    r_primal: torch.Tensor     # scalar primal residual (Alg. 1 l.29)
    s_dual: torch.Tensor       # scalar dual residual
    drift: torch.Tensor        # total mask drift (0 once frozen)
    converged: torch.Tensor    # bool, paper stopping rule
    drift_by_rule: dict        # {rule name: scalar drift}


def round_metrics(state: dict, info: dict, losses, spec: EngineSpec
                  ) -> RoundMetrics:
    """Assemble RoundMetrics from a post-consensus state + info dict."""
    from .residuals import converged as _converged
    drifts = {r.name: state["masks"][r.name]["drift"]
              for r in spec.plan.rules}
    device = info["r_primal"].device
    total = sum(drifts.values()) if drifts \
        else torch.zeros((), dtype=torch.float32, device=device)
    conv = torch.zeros((), dtype=torch.bool, device=device) if spec.solo \
        else _converged(state, info, spec.hp)
    return RoundMetrics(losses=torch.atleast_1d(losses),
                        r_primal=info["r_primal"], s_dual=info["s_dual"],
                        drift=torch.as_tensor(total, dtype=torch.float32),
                        converged=conv, drift_by_rule=drifts)


def _local_scan(state: dict, superbatch: dict, loss_fn: Callable,
                spec: EngineSpec, eta, grad_accum: int
                ) -> tuple[dict, torch.Tensor]:
    """E local prox-SGD steps over a stacked ``(E, W, ...)`` superbatch (a
    Python loop in place of ``lax.scan``) -> (state, (E,) losses)."""
    E = next(iter(superbatch.values())).shape[0]
    losses = []
    for e in range(E):
        state, loss = local_step(state, {k: v[e] for k, v in
                                         superbatch.items()},
                                 loss_fn, spec, eta, grad_accum=grad_accum)
        losses.append(loss)
    return state, torch.stack(losses)


def round_step(state: dict, superbatch: dict, loss_fn: Callable,
               spec: EngineSpec, eta, grad_accum: int = 1,
               frozen: bool = False) -> tuple[dict, RoundMetrics]:
    """One full H-SADMM outer round: E local prox-SGD steps over a stacked
    ``(E, W, ...)`` superbatch, then the hierarchical consensus (Phases
    2-5).  Nothing is read back to the host: telemetry stays on the
    device in :class:`RoundMetrics`."""
    from .consensus import consensus_step
    state, losses = _local_scan(state, superbatch, loss_fn, spec, eta,
                                grad_accum)
    state, info = consensus_step(state, spec, frozen=frozen, detail=False)
    return state, round_metrics(state, info, losses, spec)


def round_step_overlapped(state: dict, superbatch: dict, loss_fn: Callable,
                          spec: EngineSpec, eta, grad_accum: int = 1,
                          frozen: bool = False) -> tuple[dict, RoundMetrics]:
    """One overlapped round (``HsadmmConfig.staleness=1``): the consensus
    runs over the state as it comes in (the theta of the previous round's
    local steps), and this round's E local steps start from that same
    input state, anchored to the one-round-stale z and u.  The output is
    the consensus's state (z, v, u, rho, masks, wire error feedback, k)
    with theta and mom from the local steps.

    Both halves only read the input state: every op on either path
    allocates its outputs.  They are launched one after the other on the
    current stream (consensus first); on one card there is no fabric to
    overlap.  The returned state carries one pending, un-reduced theta:
    :func:`flush_pipeline` drains it.  In solo mode there is no consensus
    to overlap, and this is :func:`round_step`."""
    from .consensus import consensus_step
    if spec.solo:
        return round_step(state, superbatch, loss_fn, spec, eta,
                          grad_accum=grad_accum, frozen=frozen)
    cstate, info = consensus_step(state, spec, frozen=frozen, detail=False)
    scanned, losses = _local_scan(state, superbatch, loss_fn, spec, eta,
                                  grad_accum)
    out = dict(cstate)
    out["theta"] = scanned["theta"]
    if spec.use_momentum:
        out["mom"] = scanned["mom"]
    return out, round_metrics(out, info, losses, spec)


def flush_pipeline(state: dict, spec: EngineSpec, frozen: bool = False
                   ) -> tuple[dict, RoundMetrics]:
    """Drain an overlapped pipeline: one consensus-only step over the state
    as it is (no local steps, empty losses).  The state is then what a
    sequential round would have left, ready for ``Engine.reconfigure``."""
    from .consensus import consensus_step
    state, info = consensus_step(state, spec, frozen=frozen, detail=False)
    device = info["r_primal"].device
    return state, round_metrics(
        state, info, torch.zeros((0,), dtype=torch.float32, device=device),
        spec)
