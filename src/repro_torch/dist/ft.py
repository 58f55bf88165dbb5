"""Failure / straggler mitigation policies (DESIGN.md §6, paper §4.6) —
the port's own copy of ``repro/dist/ft.py`` (pure numpy, unchanged).

H-SADMM tolerates worker loss through the consensus weight vector: every
weighted group-sum in ``core.consensus`` normalizes by the summed weights,
so a worker with weight 0 simply stops contributing — consensus neither
stalls nor skews, and the worker's stale theta is overwritten from z when
it rejoins (weight back to 1).

A *policy* is a callable ``policy(k, W) -> np.ndarray`` mapping the outer
iteration ``k`` and worker count ``W`` to a ``(W,)`` float32 weight vector.
The training loop applies it at the top of every outer iteration (before
the local steps), so a policy is pure state-free scheduling — all the
fault-tolerance state lives in the weights themselves.

Policies compose multiplicatively with :func:`compose`, e.g. a planned
maintenance window on worker 0 plus a permanent straggler discount on
worker 3::

    policy = ft.compose(ft.fail_window({0: (10, 20)}),
                        ft.straggler_decay({3: 0.25}, halflife=8))

Policies built through these factories carry a canonical ``.spec``
string (``policy.spec``), and :func:`from_spec` reconstructs the policy
from it — this is what makes ``RunConfig.to_json`` round-trippable: a
serialized run records the policy *name + arguments*, not a pickled
callable.  Grammar (composition joins parts with ``"|"``)::

    healthy
    constant:[1.0, 0.5]
    fail_window:{"0": [10, 20]}
    straggler_decay:{"halflife": 8, "stragglers": {"3": 0.25}}
    fail_window:{"0": [10, 20]}|straggler_decay:{...}
    class_scoped:{"ffn": "straggler_decay:{...}"}

``class_scoped`` scopes an atomic inner policy to one coupling class's
consensus exchanges (engines with per-class weights); its inner specs
may not themselves be ``"|"``-composed.
"""
from __future__ import annotations

import json
from typing import Callable, Mapping, Sequence

import numpy as np

Policy = Callable[[int, int], np.ndarray]


def _ones(W: int) -> np.ndarray:
    return np.ones((W,), np.float32)


def healthy() -> Policy:
    """All workers contribute fully (the identity policy)."""
    def policy(k: int, W: int) -> np.ndarray:
        return _ones(W)
    policy.spec = "healthy"
    return policy


def fail_window(windows: Mapping[int, tuple[int, int]]) -> Policy:
    """Workers die for half-open outer-iteration windows.

    ``windows[j] = (k0, k1)`` takes worker ``j`` out for ``k0 <= k < k1``
    (weight 0); outside the window it contributes normally.  Workers whose
    index falls outside the current worker count are ignored, so the same
    policy object survives an elastic resize.
    """
    windows = {int(j): (int(k0), int(k1)) for j, (k0, k1) in windows.items()}

    def policy(k: int, W: int) -> np.ndarray:
        w = _ones(W)
        for j, (k0, k1) in windows.items():
            if 0 <= j < W and k0 <= k < k1:
                w[j] = 0.0
        return w
    policy.spec = "fail_window:" + json.dumps(
        {str(j): list(win) for j, win in windows.items()}, sort_keys=True)
    return policy


def straggler_decay(stragglers: Mapping[int, float],
                    halflife: int = 0) -> Policy:
    """Down-weight persistently slow workers, optionally recovering.

    ``stragglers[j] = f`` gives worker ``j`` initial weight ``f`` (its
    contribution is scaled by how much useful work it delivers per round,
    paper §4.6's proportional weighting).  With ``halflife > 0`` the
    discount decays geometrically back toward full weight —
    ``w_j(k) = 1 - (1 - f) * 0.5**(k / halflife)`` — modelling a transient
    slowdown (thermal throttle, network congestion) that clears over time.
    ``halflife == 0`` keeps the discount constant.
    """
    stragglers = {int(j): float(f) for j, f in stragglers.items()}

    def policy(k: int, W: int) -> np.ndarray:
        w = _ones(W)
        for j, f in stragglers.items():
            if not 0 <= j < W:
                continue
            if halflife > 0:
                w[j] = 1.0 - (1.0 - f) * 0.5 ** (k / halflife)
            else:
                w[j] = f
        return w
    policy.spec = "straggler_decay:" + json.dumps(
        {"halflife": int(halflife),
         "stragglers": {str(j): f for j, f in stragglers.items()}},
        sort_keys=True)
    return policy


def constant(weights: Sequence[float]) -> Policy:
    """A fixed weight vector (truncated / padded-with-1 to the live W)."""
    base = np.asarray(weights, np.float32)

    def policy(k: int, W: int) -> np.ndarray:
        w = _ones(W)
        n = min(W, base.shape[0])
        w[:n] = base[:n]
        return w
    policy.spec = "constant:" + json.dumps([float(x) for x in base])
    return policy


def class_scoped(scopes: Mapping[str, Policy]) -> Policy:
    """Scope straggler policies to the coupling classes a worker leads.

    ``scopes[class_name] = inner_policy`` applies ``inner_policy``'s
    weight vector ONLY to that coupling class's consensus exchanges
    (requires an engine with per-class weights,
    ``Engine.with_class_weights``); every other class — and the global
    ``state["weights"]`` — stays at full weight, so a slow worker delays
    and discounts only the payloads it is actually late for.

    The returned policy is the identity on the global weights (calling
    it yields all-ones); the per-class vectors come from
    ``policy.class_weights(k, W) -> {class: (W,) float32}``, which the
    training loop writes into ``state["class_weights"]``.  Marked with
    ``policy.per_class = True`` so the loop can tell the two kinds
    apart.  Inner policies must be atomic (no ``"|"`` composition) so
    the spec grammar stays unambiguous.
    """
    scopes = dict(scopes)
    for cls, inner in scopes.items():
        ispec = getattr(inner, "spec", None)
        if ispec is None:
            raise ValueError(f"class_scoped inner policy for {cls!r} "
                             "carries no .spec")
        if "|" in ispec:
            raise ValueError(
                f"class_scoped inner policy for {cls!r} is composed "
                f"({ispec!r}); compose class_scoped policies at the top "
                "level instead")

    def policy(k: int, W: int) -> np.ndarray:
        return _ones(W)

    def class_weights(k: int, W: int) -> dict:
        return {cls: np.asarray(inner(k, W), np.float32)
                for cls, inner in scopes.items()}

    policy.class_weights = class_weights
    policy.per_class = True
    policy.spec = "class_scoped:" + json.dumps(
        {cls: inner.spec for cls, inner in scopes.items()}, sort_keys=True)
    return policy


def compose(*policies: Policy) -> Policy:
    """Elementwise product of policies — failures and discounts stack.
    The composite carries a ``.spec`` only when every part does."""
    def policy(k: int, W: int) -> np.ndarray:
        w = _ones(W)
        for p in policies:
            w = w * np.asarray(p(k, W), np.float32)
        return w.astype(np.float32)
    specs = [getattr(p, "spec", None) for p in policies]
    if specs and all(s is not None for s in specs):
        policy.spec = "|".join(specs)
    scoped = [p for p in policies if getattr(p, "per_class", False)]
    if scoped:
        def class_weights(k: int, W: int) -> dict:
            out: dict = {}
            for p in scoped:
                for cls, v in p.class_weights(k, W).items():
                    out[cls] = out.get(cls, _ones(W)) \
                        * np.asarray(v, np.float32)
            return out
        policy.class_weights = class_weights
        policy.per_class = True
    return policy


def from_spec(spec: str) -> Policy:
    """Rebuild a policy from its canonical ``.spec`` string (see module
    docstring for the grammar).  Round-trip stable: the returned policy
    carries a ``.spec`` equal to re-canonicalizing the input."""
    parts = [p for p in spec.split("|") if p]
    if not parts:
        raise ValueError(f"empty ft policy spec {spec!r}")
    built = []
    for part in parts:
        name, _, args = part.partition(":")
        if name == "healthy":
            built.append(healthy())
        elif name == "constant":
            built.append(constant(json.loads(args)))
        elif name == "fail_window":
            wins = json.loads(args)
            built.append(fail_window(
                {int(j): tuple(win) for j, win in wins.items()}))
        elif name == "straggler_decay":
            d = json.loads(args)
            built.append(straggler_decay(
                {int(j): f for j, f in d["stragglers"].items()},
                halflife=d.get("halflife", 0)))
        elif name == "class_scoped":
            scopes = json.loads(args)
            built.append(class_scoped(
                {cls: from_spec(inner) for cls, inner in scopes.items()}))
        else:
            raise ValueError(f"unknown ft policy {name!r} in spec {spec!r}")
    return built[0] if len(built) == 1 else compose(*built)
