"""Dispatch shims over the hand-written kernels, shaped like
``repro/kernels/ops.py``: any-rank operands are viewed as (R, C) with the
minor axis contiguous (0-D/1-D leaves pad to one row), and the kernel
wrappers choose the CUDA kernel or, for CPU tensors, the plain version.
"""
from __future__ import annotations

import math

import torch

from . import fused_prox_sgd as _prox
from . import wire as _wire


def _rc(shape: tuple) -> tuple[int, int]:
    """(R, C) 2D view of any-rank operand: minor axis stays contiguous;
    0-D/1-D leaves (biases, scalars) pad to one row."""
    if len(shape) >= 2:
        return math.prod(shape[:-1]), shape[-1]
    return 1, max(math.prod(shape), 1)


def _view2d(x, R: int, C: int):
    return x.contiguous().view(R, C)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {**_prox.launches, **_wire.launches}


def reset_launch_counts() -> None:
    for d in (_prox.launches, _wire.launches):
        for k in d:
            d[k] = 0


def fused_prox_sgd(theta, g, z, u, mom, *, eta: float, rho: float,
                   momentum: float = 0.9):
    """Prox-SGD update with scalar ``eta``/``rho`` (the test and
    benchmark entry point)."""
    shape = theta.shape
    R, C = _rc(shape)
    t, m = _prox.fused_prox_sgd(*(_view2d(x, R, C)
                                  for x in (theta, g, z, u, mom)),
                                eta=eta, rho=rho, momentum=momentum)
    return t.view(shape), m.view(shape)


def prox_sgd_update(theta, g, z, u, mom, rho, eta, *, momentum=0.9):
    """Dispatch shim for the Phase-1 update (paper Eq. 8).

        g_tot = g + rho * (theta - z + u)     (analytic prox gradient)
        mom'  = momentum * mom + g_tot
        theta'= theta - eta * mom'

    ``rho`` is the bcast_rho-shaped layer-wise penalty (or None with z/u
    None in solo mode), ``eta`` a number or one-element tensor.  The fused
    kernel streams rho as one value per (R, C)-view row; when an operand
    is missing (no momentum / no consensus) or rho varies along the minor
    axis, the update is the reference's plain one — its semantics for
    those layouts, as in ``repro/kernels/ops.py``.  Returns
    (theta', mom' or None)."""
    e = torch.as_tensor(eta, dtype=theta.dtype, device=theta.device)
    has_prox = z is not None
    rho_t = None
    if has_prox:
        rho_t = torch.as_tensor(rho, device=theta.device).to(theta.dtype)
    minor_const = has_prox and theta.ndim >= 1 and (
        rho_t.ndim == 0 or rho_t.numel() == 1
        or (theta.ndim >= 2 and rho_t.shape[-1] == 1))
    if has_prox and mom is not None and minor_const and theta.numel():
        shape = theta.shape
        R, C = _rc(shape)
        if rho_t.numel() == 1:   # one penalty per leaf: a stride-0 column
            rho_col = rho_t.reshape(1, 1).expand(R, 1)
        else:
            rho_col = rho_t.expand(shape[:-1] + (1,)).reshape(R, 1)
        t, m = _prox.fused_prox_sgd_dyn(
            *(_view2d(x.to(theta.dtype), R, C) for x in (theta, g, z, u, mom)),
            rho_col, e.reshape(1, 1), momentum=momentum)
        return t.view(shape), m.view(shape)
    gtot = g
    if has_prox:
        gtot = g + rho_t * (theta - z.to(theta.dtype) + u)
    if mom is not None:
        m = momentum * mom + gtot
        return theta - e * m, m
    return theta - e * gtot, None


def _scale_shape(shape: tuple) -> tuple:
    """Broadcast shape of the per-row scales for an any-rank leaf."""
    return shape[:-1] + (1,) if len(shape) >= 2 else ((1,) if shape else ())


def quantize_rows(x, levels: int = 127):
    """Symmetric per-row quantize of any-rank ``x`` in one pass ->
    (q int8 like x, scale f32 broadcastable against x)."""
    shape = tuple(x.shape)
    R, C = _rc(shape)
    q, s = _wire.quantize_rows(_view2d(x.to(torch.float32), R, C),
                               levels=levels)
    return q.view(shape), s.view(_scale_shape(shape))
