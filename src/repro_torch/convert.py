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

bfloat16 crosses numpy as its 2-byte words (:func:`to_numpy`,
:func:`from_numpy`): numpy has no bf16 of its own, and this package does
not import ``ml_dtypes`` (the JAX package's bf16 arrays are of its type);
a bf16 leaf converts bit for bit both ways.  The ``*_to_jax`` trees
type those words as numpy's ``bfloat16`` where a module has registered
it (``ml_dtypes``, which JAX imports), so that JAX takes them; a
checkpoint writes its own fixed header (``dist.checkpoint``).

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


def _bf16_dtype() -> np.dtype:
    """numpy's ``bfloat16`` where a module has registered it (``ml_dtypes``,
    which JAX imports), else the 2-byte void type that a bf16 array of an
    ``np.savez`` loads as."""
    try:
        return np.dtype("bfloat16")
    except TypeError:
        return np.dtype("V2")


def is_bf16(a: np.ndarray) -> bool:
    """Does ``a`` hold bf16 words: numpy's ``bfloat16`` (by its name), or
    the 2-byte void type a saved one loads as?"""
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                          and a.dtype.itemsize == 2
                                          and a.dtype.names is None)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; a bf16 one as its 2-byte
    words, typed :func:`_bf16_dtype` (what JAX would give where numpy
    knows bf16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_bf16_dtype())
    return t.numpy()


def from_numpy(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor sharing its memory; bf16 words
    (:func:`is_bf16`) as ``torch.bfloat16``."""
    if is_bf16(a):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tensor(x, device) -> torch.Tensor:
    return from_numpy(np.array(x, copy=True)).to(device)


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
        node[leaf] = to_numpy(v)
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
