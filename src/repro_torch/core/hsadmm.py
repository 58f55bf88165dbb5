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
    k              : outer iteration counter

The worker dim W is flat, outer-major over (pod, node, worker).  The
single-worker solo mode, microbatch accumulation and the overlapped round
wait for later slices of the port and raise ``NotImplementedError``;
momentum-free updates are not in its ``EngineSpec`` yet.
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
    momentum: float = 0.9
    # per-coupling-class straggler weights (``dist.ft.class_scoped``):
    # adds a ``{rule: (W,)}`` weight tree to the state and partitions the
    # wire reduce by each leaf's lead coupling class
    class_weights: bool = False

    def __post_init__(self):
        if self.solo:
            raise NotImplementedError(
                "the single-worker solo mode (pod granularity, one worker) "
                "comes in a later slice of the PyTorch port")

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
             "weights": torch.ones((W,), dtype=torch.float32, device=device),
             "mom": {k: torch.zeros_like(x) for k, x in theta.items()},
             "u": {k: torch.zeros_like(x) for k, x in theta.items()}}
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
    state["masks"] = {
        r.name: identity_mask_state(
            r, tuple(params0[r.leaves[0].key].shape[:r.stack_ndims]),
            spec.budgets[r.name], device)
        for r in spec.plan.rules}
    return state


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
    formulas PyTorch picks when it does not record."""
    def fn(params, batch):
        loss, pullback = vjp(lambda p: loss_fn(p, batch), params)
        with torch.no_grad():
            (g,) = pullback(torch.ones_like(loss), retain_graph=False)
        return g, loss
    return fn


def local_step(state: dict, batch: dict, loss_fn: Callable, spec: EngineSpec,
               eta, grad_accum: int = 1) -> tuple[dict, torch.Tensor]:
    """One minibatch prox-SGD step on every worker.

    ``loss_fn(params_one_worker, batch_one_worker) -> scalar``; batch
    leaves have leading dim W.  Per-worker gradients come from ``vmap`` of
    :func:`grad_and_value` over the stacked parameters; the prox gradient
    rho1 * (theta - z1 + u) is added analytically inside the fused update
    (``ops.prox_sgd_update``, the hand-written kernel on the card).
    Returns (new_state, mean loss)."""
    if grad_accum != 1:
        raise NotImplementedError(
            "microbatch gradient accumulation comes in a later slice of the "
            "port")
    levels = spec.consensus.levels
    theta = state["theta"]
    g, losses = vmap(grad_and_value(loss_fn))(theta, batch)

    device = next(iter(theta.values())).device
    e = torch.as_tensor(eta, dtype=torch.float32, device=device)
    z1, u, mom, rho1 = state["z"][0], state["u"], state["mom"], \
        state["rho"][0]
    new_theta, new_mom = {}, {}
    for key, th in theta.items():
        r = bcast_rho(rho1[key], th, spec.stack_ndims(key), offset=1)
        new_theta[key], new_mom[key] = prox_sgd_update(
            th, g[key], ungroup(z1[key], levels[0]), u[key], mom[key], r, e,
            momentum=spec.momentum)
    out = dict(state)
    out["theta"] = new_theta
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
    return RoundMetrics(losses=torch.atleast_1d(losses),
                        r_primal=info["r_primal"], s_dual=info["s_dual"],
                        drift=torch.as_tensor(total, dtype=torch.float32),
                        converged=_converged(state, info, spec.hp),
                        drift_by_rule=drifts)


def round_step(state: dict, superbatch: dict, loss_fn: Callable,
               spec: EngineSpec, eta, grad_accum: int = 1,
               frozen: bool = False) -> tuple[dict, RoundMetrics]:
    """One full H-SADMM outer round: E local prox-SGD steps over a stacked
    ``(E, W, ...)`` superbatch (a Python loop in place of ``lax.scan``),
    then the hierarchical consensus (Phases 2-5).  Nothing is read back
    to the host: telemetry stays on the device in :class:`RoundMetrics`."""
    from .consensus import consensus_step
    E = next(iter(superbatch.values())).shape[0]
    losses = []
    for e in range(E):
        state, loss = local_step(state, {k: v[e] for k, v in
                                         superbatch.items()},
                                 loss_fn, spec, eta, grad_accum=grad_accum)
        losses.append(loss)
    state, info = consensus_step(state, spec, frozen=frozen, detail=False)
    return state, round_metrics(state, info, torch.stack(losses), spec)


def round_step_overlapped(*args, **kw):
    raise NotImplementedError(
        "overlapped rounds (staleness=1) come in a later slice of the "
        "PyTorch port")


def flush_pipeline(*args, **kw):
    raise NotImplementedError(
        "flush_pipeline (overlapped rounds) comes in a later slice of the "
        "PyTorch port")
