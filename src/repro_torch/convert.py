"""Carry weights and H-SADMM state across from the JAX package.

The inputs are the JAX package's trees AFTER ``jax.device_get``: nested
dicts (and lists) of numpy arrays, so this module imports nothing of JAX.
Leaves map one to one onto the port's flat ``{"/"-joined key: tensor}``
dicts with the same keys, shapes and dtypes, except mask indices, which
become int64 (PyTorch's index type).  Both packages then compute on the
same numbers.

A RECONFIGURED JAX state (budget-B shapes, its migrated masks) converts
the same way; :func:`masks_from_jax` carries the frozen full-shape masks
it was derived from (``Engine.frozen_masks``), so the port can rebuild
the matching engine with ``Engine.reconfigure(masks=...)``.
"""
from __future__ import annotations

import numpy as np
import torch


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def params_from_jax(tree: dict, device="cpu") -> dict:
    """Nested JAX parameter tree (numpy leaves) -> port flat params."""
    return {k: _tensor(v, device) for k, v in _flat(tree).items()}


def masks_from_jax(masks: dict, device="cpu") -> dict:
    """JAX per-rule mask state ``{rule: {idx, valid, mask, drift}}`` (numpy
    leaves) -> the port's, with int64 indices."""
    return {rule: {f: _tensor(a, device).long() if f == "idx"
                   else _tensor(a, device) for f, a in m.items()}
            for rule, m in masks.items()}


def state_from_jax(state: dict, device="cpu") -> dict:
    """JAX H-SADMM state (numpy leaves), full-shape or reconfigured ->
    port state: theta/mom/u, the z/v/rho lists, per-rule masks, weights
    and the round counter k."""
    out = {}
    for name, v in state.items():
        if name in ("theta", "mom", "u"):
            out[name] = params_from_jax(v, device)
        elif name in ("z", "v", "rho"):
            out[name] = [params_from_jax(t, device) for t in v]
        elif name == "masks":
            out[name] = masks_from_jax(v, device)
        elif name in ("weights", "k"):
            out[name] = _tensor(v, device)
        else:
            raise NotImplementedError(
                f"state entry {name!r} has no counterpart in the port yet")
    return out
