"""Hierarchical consensus step — Phases 2-5 of Algorithm 1, K-level general
(port of ``repro/core/consensus.py``).

  Phase 2  intra-node reduce of (theta + u)               [dense boundary]
  Phase 3  node-level candidate z~_1 (Eq. 9), projection (Eq. 10),
           mask generation + global mask sync (Eq. 14 / score-consensus)
  Phase 4  per-level consensus reductions; boundaries at/above
           ``compact_from_level`` (or with a ``compact`` codec) move
           physically shrunk payloads (paper §4.4), zero-filled after
  Phase 5  dual updates (Eq. 12-13), residuals, layer-wise adaptive
           penalties (with scaled-dual rescaling), mask drift

``state["weights"]`` scales each worker's contribution; all means are
weight-normalized.  A Python number that meets a leaf is first rounded to
the leaf's dtype (``kernels.ref.weak``), as JAX's weak typing rounds it
against a bf16 leaf.  Every group exchange routes through the boundary's
wire codec (``repro_torch.comm``).  On one card the "collectives" are
reductions over the stacked worker dim.

With ``EngineSpec.class_weights`` the exchange is partitioned by coupling
class (``state["class_weights"]``, per rule): every leaf has a lead class,
the first rule that touches it (:func:`lead_classes`), and is weighted by
``weights * class_weights[lead]``; unruled leaves keep the global
weights.  Each class is one ``group_reduce`` call, in the reference's
sorted order (unruled leaves last), so a q4 boundary makes one
``quantize_pack_q4`` table launch per class and ring instead of one per
ring; q8 stays one ``quantize_rows`` launch per leaf.  All-ones class
weights give the unscoped round's bits.

A stateful boundary codec (``topk:<rate>``) threads its error feedback
through ``state["wire"]`` (one tree per boundary, see ``core.hsadmm``):
each exchange reads its boundary's residuals and the new state carries
the updated ones.
"""
from __future__ import annotations

import torch

from ..comm import group_sum
from ..kernels.ref import weak
from .hsadmm import EngineSpec, bcast_rho, ungroup
from .masks import mask_drift, sync_masks
from .shrinkage import compact_params, expand_params
from .sparsity import apply_mask_rule, group_scores


def _norm_sq_per_stack(x, stack_ndims: int, offset: int):
    """Sum of squares over all axes except the stack axes -> (stack,)."""
    axes = tuple(i for i in range(x.ndim)
                 if not (offset <= i < offset + stack_ndims))
    return torch.sum(torch.square(x.to(torch.float32)), dim=axes)


def _make_masks(state, spec, mask_src, frozen):
    """Phase-3 mask generation + global synchronization."""
    new_masks, idxs, info = {}, {}, {}
    for rule in spec.plan.rules:
        mstate = state["masks"][rule.name]
        if frozen:
            new_masks[rule.name] = dict(mstate,
                                        drift=torch.zeros_like(mstate["drift"]))
        else:
            scores = group_scores(mask_src, rule, offset=1)  # (Msrc,*stack,C)
            idx, valid, mask = sync_masks(scores, rule, spec.sync_cfg)
            drift = mask_drift(mstate["mask"], mask)
            new_masks[rule.name] = {"idx": idx, "valid": valid, "mask": mask,
                                    "drift": drift}
            info[f"drift/{rule.name}"] = drift
        idxs[rule.name] = new_masks[rule.name]["idx"]
    return new_masks, idxs, info


def lead_classes(plan) -> dict:
    """{leaf key: name of the first rule that touches it}: the coupling
    class a leaf's consensus exchange is weighted by (leaves coupled to
    several classes ride their lead class)."""
    out: dict = {}
    for rule in plan.rules:
        for la in rule.all_leaves:
            out.setdefault(la.key, rule.name)
    return out


def _col(w, b):
    """(M,) weights as a column broadcasting against a (M, ...) leaf."""
    return w.reshape((-1,) + (1,) * (b.ndim - 1)).to(b.dtype)


def _solo_prune_step(state: dict, spec: EngineSpec, frozen: bool
                     ) -> tuple[dict, dict]:
    """Single-worker solo mode: no consensus runs on one worker, so theta
    is projected onto masks built from theta itself; zero residuals."""
    theta = state["theta"]
    new_masks, _, info = _make_masks(state, spec, theta, frozen)
    for rule in spec.plan.rules:
        theta = apply_mask_rule(theta, rule,
                                new_masks[rule.name]["mask"][None], offset=1)
    new_state = dict(state)
    new_state.update(theta=theta, masks=new_masks, k=state["k"] + 1)
    zero = torch.zeros((), dtype=torch.float32, device=state["k"].device)
    info["r_primal"] = info["s_dual"] = zero
    return new_state, info


def consensus_step(state: dict, spec: EngineSpec, frozen: bool = False,
                   detail: bool = True) -> tuple[dict, dict]:
    """Run Phases 2-5.  ``frozen`` selects the cached-mask path (paper
    §4.5).  ``detail=False`` drops the per-leaf residual maps
    (``r_intra``/``r_inter*``) from the info dict.  In solo mode this is
    :func:`_solo_prune_step`."""
    if spec.solo:
        return _solo_prune_step(state, spec, frozen)
    levels = spec.consensus.levels
    K = len(levels)
    hp = spec.hp
    plan = spec.plan
    fulls = {r.name: r.groups for r in plan.rules}
    # per-boundary wire codecs and their error-feedback state
    codecs = spec.codecs
    need_wire = any(c.stateful for c in codecs)
    wire_old = state.get("wire") if need_wire else None
    wire_new = list(wire_old) if wire_old is not None \
        else [{} for _ in codecs]

    theta, u = state["theta"], state["u"]
    rho = state["rho"]
    zs_old = state["z"]
    vs_old = state["v"]

    def wk_chain(wvec) -> list:
        """Cumulative weights per level: chain[k] has shape (M_k,)."""
        out = [wvec]
        for g in levels:
            out.append(group_sum(out[-1], g))
        return out

    w = state["weights"]
    wk = wk_chain(w)
    M1 = spec.consensus.num_workers // levels[0]

    # per-coupling-class weights (module doc): {class: chain of w * cw}
    cw = state.get("class_weights") if spec.class_weights else None
    key_class = lead_classes(plan) if cw is not None else {}
    wk_by_class = {name: wk_chain(w * v) for name, v in cw.items()} \
        if cw is not None else {}

    def wk_for(key: str) -> list:
        return wk_by_class.get(key_class.get(key), wk)

    def wire_reduce(tree: dict, k: int, g: int, lvl: int) -> dict:
        """Boundary-k weighted group exchange in that codec's format,
        weighted by the level-``lvl`` cumulative weights: one call, or
        one call per lead coupling class.  A stateful codec's error
        feedback is split by the same keys and merged back, so every
        leaf's residual threads as in the joint call."""
        codec = codecs[k - 1]
        cst = wire_old[k - 1] if codec.stateful and wire_old is not None \
            else None
        if cw is None:
            red, cst = codec.group_reduce(tree, g, wk[lvl], cst)
            if codec.stateful:
                wire_new[k - 1] = cst
            return red
        parts: dict = {}
        for key in tree:
            parts.setdefault(key_class.get(key), []).append(key)
        out, new_cst = {}, {}
        for cls in sorted(parts, key=lambda c: (c is None, c or "")):
            keys = parts[cls]
            red, sc = codec.group_reduce(
                {key: tree[key] for key in keys}, g,
                wk_by_class.get(cls, wk)[lvl],
                {key: cst[key] for key in keys} if cst is not None
                else None)
            out.update(red)
            if codec.stateful:
                new_cst.update(sc)
        if codec.stateful:
            wire_new[k - 1] = {key: new_cst[key] for key in tree}
        return {key: out[key] for key in tree}

    payload0 = {key: theta[key] + u[key] for key in theta}

    def cand1(buf, z2v):
        """z~_1 = (rho1*sum_j w_j(theta+u) + rho2*(z2 - v1)) / gamma (Eq. 9)."""
        out = {}
        for key, b in buf.items():
            sn = spec.stack_ndims(key)
            r1 = bcast_rho(rho[0][key], b, sn, 1)
            num = r1 * b
            den = r1 * _col(wk_for(key)[1], b) \
                + weak(hp.weight_decay / max(M1, 1), b.dtype)
            if K > 1:
                r2 = bcast_rho(rho[1][key], b, sn, 1)
                num = num + r2 * z2v[key]
                den = den + r2
            out[key] = (num / den).to(b.dtype)
        return out

    z2v = None
    if K > 1:
        z2v = {key: ungroup(z2, levels[1]) - vs_old[0][key]
               for key, z2 in zs_old[1].items()}

    info: dict = {}
    if spec.boundary_compact(1, codecs):
        # masks from per-worker payloads; level-1 reduce is already compact
        new_masks, idxs, minfo = _make_masks(state, spec, payload0, frozen)
        info.update(minfo)
        pc = compact_params(payload0, plan, idxs, offset=1)
        buf = wire_reduce(pc, 1, levels[0], 0)
        z2v_c = compact_params(z2v, plan, idxs, offset=1) if K > 1 else None
        z1 = expand_params(cand1(buf, z2v_c), plan, idxs, fulls, offset=1)
    else:
        buf = wire_reduce(payload0, 1, levels[0], 0)   # dense intra reduce
        z1 = cand1(buf, z2v)
        new_masks, idxs, minfo = _make_masks(state, spec, z1, frozen)
        info.update(minfo)
        for rule in plan.rules:                  # projection Pi_S (Eq. 10)
            z1 = apply_mask_rule(z1, rule, new_masks[rule.name]["mask"][None],
                                 offset=1)

    # ---- Phase 4: levels 2..K ----------------------------------------------
    zs_new = [z1]
    for k in range(2, K + 1):
        g = levels[k - 1]
        payload = {key: zk + vs_old[k - 2][key]
                   for key, zk in zs_new[-1].items()}
        zkv = None
        if k < K:
            zkv = {key: ungroup(zn, levels[k]) - vs_old[k - 1][key]
                   for key, zn in zs_old[k].items()}
        do_compact = spec.boundary_compact(k, codecs)
        if do_compact:
            payload = compact_params(payload, plan, idxs, offset=1)
            if zkv is not None:
                zkv = compact_params(zkv, plan, idxs, offset=1)
        red = wire_reduce(payload, k, g, k - 1)   # level-k exchange

        out = {}
        for key, b in red.items():
            sn = spec.stack_ndims(key)
            wsum = _col(wk_for(key)[k], b)
            if k == K:                            # Eq. 11: weighted mean
                out[key] = (b / torch.clamp_min(
                    wsum, weak(1e-12, b.dtype))).to(b.dtype)
            else:
                rk = bcast_rho(rho[k - 1][key], b, sn, 1)
                rk1 = bcast_rho(rho[k][key], b, sn, 1)
                out[key] = ((rk * b + rk1 * zkv[key])
                            / (rk * wsum + rk1)).to(b.dtype)
        if do_compact:
            out = expand_params(out, plan, idxs, fulls, offset=1)  # zero-fill
        zs_new.append(out)

    # ---- Phase 5: duals (Eq. 12-13) -----------------------------------------
    u_new = {key: uu + (theta[key] - ungroup(zs_new[0][key],
                                             levels[0]).to(uu.dtype))
             for key, uu in u.items()}
    vs_new = []
    for k in range(1, K):
        vs_new.append({key: vv + (zs_new[k - 1][key]
                                  - ungroup(zs_new[k][key], levels[k]))
                       for key, vv in vs_old[k - 1].items()})

    # ---- residuals + layer-wise adaptive penalties (paper §3.4) -------------
    device = state["weights"].device
    rho_new = []
    u_scaled, vs_scaled = u_new, list(vs_new)
    r_tot = torch.zeros((), dtype=torch.float32, device=device)
    s_tot = torch.zeros((), dtype=torch.float32, device=device)
    for b in range(K):  # boundary b: level-b <-> level-(b+1)
        if b == 0:
            lhs, rhs_new, rhs_old = theta, zs_new[0], zs_old[0]
        else:
            lhs, rhs_new, rhs_old = zs_new[b - 1], zs_new[b], zs_old[b]
        gb = levels[b]
        rho_b_new, factors = {}, {}
        for key, rho_b in rho[b].items():
            sn = spec.stack_ndims(key)
            x = lhs[key]
            zn = ungroup(rhs_new[key], gb)
            r2 = _norm_sq_per_stack(x - zn.to(x.dtype), sn, 1)
            s2 = _norm_sq_per_stack(rhs_new[key] - rhs_old[key], sn, 1)
            r_n = torch.sqrt(r2)
            s_n = rho_b * torch.sqrt(s2)
            f = torch.where(r_n > hp.adapt_mu * s_n, hp.adapt_tau,
                            torch.where(s_n > hp.adapt_mu * r_n,
                                        1.0 / hp.adapt_tau, 1.0))
            new_rho = torch.clamp(rho_b * f, 1e-8, hp.rho_max)
            rho_b_new[key] = new_rho
            factors[key] = rho_b / new_rho  # scaled-dual rescale (Boyd §3.4.1)
            r_tot = r_tot + torch.sum(r2)
            s_tot = s_tot + torch.sum(s2)
            if detail:
                tag = "r_intra" if b == 0 else f"r_inter{b}"
                info.setdefault(tag, {})[key] = r_n
        rho_new.append(rho_b_new)

        def _rescale(tree):
            return {key: x * bcast_rho(factors[key].to(torch.float32), x,
                                       spec.stack_ndims(key), 1).to(x.dtype)
                    for key, x in tree.items()}
        if b == 0:
            u_scaled = _rescale(u_new)
        else:
            vs_scaled[b - 1] = _rescale(vs_new[b - 1])

    info["r_primal"] = torch.sqrt(r_tot)
    info["s_dual"] = torch.sqrt(s_tot)

    new_state = dict(state)
    new_state.update(theta=theta, u=u_scaled, z=zs_new, v=vs_scaled,
                     rho=rho_new, masks=new_masks, k=state["k"] + 1)
    if need_wire:
        new_state["wire"] = wire_new
    return new_state, info
