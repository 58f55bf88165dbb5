"""Carry weights and H-SADMM state across between the two packages.

The JAX package's side is its trees as numpy: ``jax.device_get`` of
nested dicts (and lists) of arrays, so this module imports nothing of
JAX.  Leaves map one to one onto the port's flat ``{"/"-joined key:
tensor}`` dicts with the same keys, shapes and dtypes (an LM's
``blocks/mixer/wz`` is ``tree["blocks"]["mixer"]["wz"]``, layers stacked
on its leading axis), except mask indices, which are int64 in the port
(PyTorch's index type) and int32 in the JAX package.  Both packages then
compute on the same numbers.  Like every entry point of the port, the
``*_from_jax`` functions put their tensors on the card unless the caller
asks for the CPU (``device="cpu"``); the ``*_to_jax`` ones return numpy
trees that ``jax.numpy.asarray`` takes as they are.

A RECONFIGURED JAX state (budget-B shapes, its migrated masks) converts
the same way; :func:`masks_from_jax` carries the frozen full-shape masks
it was derived from (``Engine.frozen_masks``), so the port can rebuild
the matching engine with ``Engine.reconfigure(masks=...)``.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


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


def params_from_jax(tree: dict, device=None) -> dict:
    """Nested JAX parameter tree (numpy leaves) -> port flat params."""
    device = resolve_device(device)
    return {k: _tensor(v, device) for k, v in _flat(tree).items()}


def masks_from_jax(masks: dict, device=None) -> dict:
    """JAX per-rule mask state ``{rule: {idx, valid, mask, drift}}`` (numpy
    leaves) -> the port's, with int64 indices."""
    device = resolve_device(device)
    return {rule: {f: _tensor(a, device).long() if f == "idx"
                   else _tensor(a, device) for f, a in m.items()}
            for rule, m in masks.items()}


def state_from_jax(state: dict, device=None) -> dict:
    """JAX H-SADMM state (numpy leaves), full-shape or reconfigured ->
    port state: theta/mom/u, the z/v/rho lists, per-rule masks, weights,
    per-class weights, the round counter k and the wire codecs'
    error-feedback list ``wire`` (one flat tree per boundary, ``{}`` at a
    stateless one).  Entries the state lacks stay absent: a momentum-free
    state has no ``mom``, a solo one no ``u``, ``z``, ``v`` or ``rho``."""
    device = resolve_device(device)
    out = {}
    for name, v in state.items():
        if name in ("theta", "mom", "u"):
            out[name] = params_from_jax(v, device)
        elif name in ("z", "v", "rho", "wire"):
            out[name] = [params_from_jax(t, device) for t in v]
        elif name == "masks":
            out[name] = masks_from_jax(v, device)
        elif name in ("weights", "k"):
            out[name] = _tensor(v, device)
        elif name == "class_weights":
            out[name] = {rule: _tensor(a, device) for rule, a in v.items()}
        else:
            raise NotImplementedError(
                f"state entry {name!r} has no counterpart in the port yet")
    return out


# ---------------------------------------------------------------------------
# the other way: port -> JAX trees of numpy arrays
# ---------------------------------------------------------------------------


def _nested(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().cpu().numpy()
    return out


def params_to_jax(params: dict) -> dict:
    """Port flat params -> the JAX package's nested tree (numpy leaves)."""
    return _nested(params)


def state_to_jax(state: dict) -> dict:
    """Port H-SADMM state -> the JAX package's state tree (numpy leaves,
    int32 mask indices)."""
    out = {}
    for name, v in state.items():
        if name in ("theta", "mom", "u"):
            out[name] = params_to_jax(v)
        elif name in ("z", "v", "rho", "wire"):
            out[name] = [params_to_jax(t) for t in v]
        elif name == "masks":
            out[name] = {rule: {f: a.detach().cpu().numpy().astype(np.int32)
                                if f == "idx" else a.detach().cpu().numpy()
                                for f, a in m.items()}
                         for rule, m in v.items()}
        elif name in ("weights", "k"):
            out[name] = v.detach().cpu().numpy()
        elif name == "class_weights":
            out[name] = {rule: a.detach().cpu().numpy()
                         for rule, a in v.items()}
        else:
            raise NotImplementedError(
                f"state entry {name!r} has no counterpart in the JAX package")
    return out
