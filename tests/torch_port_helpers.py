"""Shared helpers of the PyTorch port's differential tests (tests/test_torch_*.py).

Two known facts about the JAX reference on the CPU shape these helpers:

* The interpreted Pallas prox-SGD kernel fails under this JAX version
  (``ShardingTypeError`` inside ``kernels/fused_prox_sgd.py``), so a JAX
  round runs with ``repro.kernels.ops._fused_dyn`` replaced by the plain
  jnp update — the same math as the shim's own fallback.
* The jitted ``ops.quantize_rows`` computes its scale as ``max * (1/127)``
  while the eager reference divides; the two can differ by one ulp, and
  a q value can then flip by one step.  The fused q8 encode
  (``ops.gather_quantize``) does the same, and the q4 quantizers
  (``ops.quantize_pack_q4``, ``ops.gather_quantize_q4``) do it with
  ``max / 7``.  The port divides, so its comparisons patch in quantizers
  with the eager reference's division that ``jit`` cannot rewrite.
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref


def plain_fused_dyn(theta, g, z, u, mom, rho_col, eta, *, momentum, **_):
    gtot = g + rho_col * (theta - z + u)
    m = momentum * mom + gtot
    return theta - eta[0, 0] * m, m


def ieee_quantize_rows(x, levels=127):
    """``ops.quantize_rows`` with the eager reference's arithmetic
    (``ref.quantize_rows_ref``) that survives ``jit``: ``levels`` passes
    through an optimization barrier, so XLA cannot fold ``max / 127`` into
    ``max * (1/127)``."""
    shape = x.shape
    R, C = jops._rc(shape)
    x2 = x.reshape(R, C).astype(jnp.float32)
    lv = jax.lax.optimization_barrier(jnp.float32(levels))
    s = jnp.max(jnp.abs(x2), axis=1, keepdims=True) / lv + 1e-30
    q = jnp.clip(jnp.round(x2 / s), -levels, levels).astype(jnp.int8)
    return q.reshape(shape), s.reshape(jops._scale_shape(shape))


def ieee_gather_quantize(x, idx, levels=127):
    """``ops.gather_quantize`` with the eager reference's division."""
    return ieee_quantize_rows(jnp.take(x, idx.astype(jnp.int32), axis=1),
                              levels)


def _ieee_q4(x2):
    """(R, C) -> the q4 encode of ``ref.quantize_pack_q4_ref`` with its
    ``/ 7`` behind an optimization barrier."""
    x2 = x2.astype(jnp.float32)
    lv = jax.lax.optimization_barrier(jnp.float32(7.0))
    s = jnp.max(jnp.abs(x2), axis=1, keepdims=True) / lv + 1e-30
    q = jnp.clip(jnp.round(x2 / s), -7, 7).astype(jnp.int32)
    return jref.pack_q4_ref(q), s


def ieee_quantize_pack_q4(x):
    """``ops.quantize_pack_q4`` with the eager reference's division."""
    shape = x.shape
    R, C = jops._rc(shape)
    p, s = _ieee_q4(x.reshape(R, C))
    p_shape = (shape[:-1] if len(shape) >= 1 else ()) + ((C + 1) // 2,)
    return p.reshape(p_shape), s.reshape(jops._scale_shape(shape))


def ieee_gather_quantize_q4(x, idx):
    """``ops.gather_quantize_q4`` with the eager reference's division."""
    return _ieee_q4(jnp.take(x, idx.astype(jnp.int32), axis=1))


@contextlib.contextmanager
def jax_reference(ieee_quantize: bool = False):
    """Patch the JAX package for CPU reference runs (see module doc)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "_fused_dyn", plain_fused_dyn)
        if ieee_quantize:
            mp.setattr(jops, "quantize_rows", ieee_quantize_rows)
            mp.setattr(jops, "gather_quantize", ieee_gather_quantize)
            mp.setattr(jops, "quantize_pack_q4", ieee_quantize_pack_q4)
            mp.setattr(jops, "gather_quantize_q4", ieee_gather_quantize_q4)
        yield


def np_flat(tree, prefix: str = "") -> dict:
    """Nested JAX dict -> {"/"-joined key: numpy array}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(np_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def to_np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def assert_tree_close(port: dict, ref: dict, rtol, atol=0.0):
    """Port flat dict of tensors vs JAX nested tree, leaf for leaf."""
    ref = np_flat(ref)
    assert set(port) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(to_np(port[k]), v, rtol=rtol, atol=atol,
                                   err_msg=k)


def perturbed(tree, seed: int, scale: float = 0.01):
    """A numpy copy of a JAX tree with seeded Gaussian noise added to
    every float leaf."""
    rng = np.random.default_rng(seed)

    def one(x):
        x = np.asarray(x)
        if x.dtype.kind != "f":
            return x.copy()
        return (x + scale * rng.standard_normal(x.shape)).astype(x.dtype)
    return jax.tree.map(one, tree)
