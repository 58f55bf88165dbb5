"""Dispatch shims over the hand-written kernels, shaped like
``repro/kernels/ops.py``: any-rank operands are viewed as (R, C) with the
minor axis contiguous (0-D/1-D leaves pad to one row), and the kernel
wrappers choose the CUDA kernel or, for CPU tensors, the plain version.
Gathers take indices of any integer dtype and hand the kernels int32.
"""
from __future__ import annotations

import math

import torch

from . import compact as _compact
from . import fused_prox_sgd as _prox
from . import group_norms as _gnorms
from . import ref as _ref
from . import ssd_scan as _ssd
from . import wire as _wire

_COUNTERS = (_prox.launches, _compact.launches, _wire.launches,
             _gnorms.launches, _ssd.launches)


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
    return {k: v for d in _COUNTERS for k, v in d.items()}


def reset_launch_counts() -> None:
    for d in _COUNTERS:
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
    those layouts, as in ``repro/kernels/ops.py``.  ``rho``, ``eta`` and
    ``momentum`` take theta's dtype, and on both routes every operation
    rounds to it (a bf16 update is JAX's, ``ref.weak``).  Returns
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
        m = _ref.weak(momentum, theta.dtype) * mom + gtot
        return theta - e * m, m
    return theta - e * gtot, None


def _scale_shape(shape: tuple) -> tuple:
    """Broadcast shape of the per-row scales for an any-rank leaf."""
    return shape[:-1] + (1,) if len(shape) >= 2 else ((1,) if shape else ())


def quantize_rows(x, levels: int = 127):
    """Symmetric per-row quantize of any-rank ``x`` in one pass ->
    (q int8 like x, scale f32 broadcastable against x).  The kernel reads
    f32 and bf16 rows as they are (bf16 to f32 is exact, as the TPU
    kernel's ``astype`` is); other dtypes go to f32 first."""
    shape = tuple(x.shape)
    R, C = _rc(shape)
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    q, s = _wire.quantize_rows(_view2d(x, R, C), levels=levels)
    return q.view(shape), s.view(_scale_shape(shape))


def _q4_shapes(shape: tuple) -> tuple[tuple, tuple]:
    """(packed, scale) shapes of the q4 encode of an any-rank leaf."""
    R, C = _rc(shape)
    return (shape[:-1] if shape else ()) + ((C + 1) // 2,), \
        _scale_shape(shape)


def quantize_pack_q4(x):
    """q4 encode of any-rank ``x``: per-row quantize to [-7, 7] + pack two
    channels per byte -> (packed uint8 shape[:-1] + (ceil(C/2),), scale
    f32).  Odd minor dims carry one zero pad nibble."""
    return quantize_pack_q4_leaves([x])[0]


def quantize_pack_q4_leaves(xs):
    """:func:`quantize_pack_q4` of every leaf of ``xs`` in one launch of
    the q4 kernel (``wire.quantize_pack_q4_table``) -> [(packed, scale)]."""
    shapes = [tuple(x.shape) for x in xs]
    views = [_view2d(x.to(torch.float32), *_rc(shape))
             for x, shape in zip(xs, shapes)]
    out = []
    for (p, s), shape in zip(_wire.quantize_pack_q4_table(views), shapes):
        p_shape, s_shape = _q4_shapes(shape)
        out.append((p.view(p_shape), s.view(s_shape)))
    return out


def unpack_dequantize_q4(p, scale, n: int):
    """Inverse of :func:`quantize_pack_q4`: packed (..., Cp) -> f32
    (..., n), trimming the pad nibble (``n`` = true minor dim): the unpack
    kernel without an index."""
    shape = tuple(p.shape)
    Cp = shape[-1] if shape else 1
    R = math.prod(shape[:-1]) if len(shape) >= 2 else 1
    out = _wire.unpack_dequantize_q4(_view2d(p, R, Cp),
                                     _view2d(scale, R, 1), n)
    return out.view((shape[:-1] if len(shape) >= 2 else ()) + (n,))


def gather_quantize_q4(x, idx):
    """x (R, C), idx (B,): gather + q4 quantize + nibble pack, one pass
    -> (packed uint8 (R, ceil(B/2)), scale (R, 1))."""
    return _wire.gather_quantize_q4(
        x.to(torch.float32).contiguous(), idx.to(torch.int64).contiguous())


def scatter_dequantize_q4(p, scale, idx, full: int):
    """Fused q4 unpack + dequantize + zero-fill expansion -> (R, full):
    the unpack kernel on p itself by :func:`ref.inverse_index_q4`, whose
    dropped channels read nibble 2*Cp as zeros (no padded copy)."""
    return _wire.unpack_gather_dequantize_q4(
        p.contiguous(), _view2d(scale, p.shape[0], 1),
        _ref.inverse_index_q4(p, idx, full))


# ------------------------------------------------------------------ #
# kept-group gathers (kernels/compact.py) and the q8 codec API's
# fused passes (kernels/wire.py)
# ------------------------------------------------------------------ #


def _idx32(idx):
    return idx.to(torch.int32).contiguous()


def gather_leaves(xs, idx, axes, lead: int = 0, group: int = 1):
    """Gather each leaf ``xs[i]`` along its axis ``axes[i]`` by the kept
    groups ``idx`` (*stack, B) of ``group`` channels each, in [0, C/group]
    where the index C/group writes zeros: the stack dims of ``idx`` are
    each leaf's axes ``lead .. lead + len(stack) - 1``, all before its
    axis, and each stack slice keeps its own index row.  Every leaf is a
    contiguous (R, C, Q) view around its axis (no axis is moved), and all
    of them go to the gather kernel in one launch (``compact.gather_table``;
    one more for every CAPACITY leaves).  The leaves must be distinct
    tensors.  Returns the gathered leaves, B * group wide on their axes."""
    sn = idx.ndim - 1
    B = idx.shape[-1]
    i32 = _idx32(idx).reshape(-1, B)
    jobs, shapes = [], []
    for x, ax in zip(xs, axes):
        shape = tuple(x.shape)
        if ax < lead + sn or shape[lead:lead + sn] != tuple(idx.shape[:-1]):
            raise ValueError(
                f"gather_leaves: index of shape {tuple(idx.shape)} does not "
                f"stack over axes {lead}..{lead + sn - 1} before axis {ax} "
                f"of {shape}")
        jobs.append((x.contiguous().view(math.prod(shape[:ax]), shape[ax],
                                         math.prod(shape[ax + 1:])),
                     i32, math.prod(shape[lead + sn:ax]), group))
        shapes.append(shape[:ax] + (B * group,) + shape[ax + 1:])
    outs = _compact.gather_table(jobs)
    return [o.view(shape) for o, shape in zip(outs, shapes)]


def gather_axis(x, idx, ax: int, lead: int = 0):
    """Gather ``x`` along axis ``ax`` by ``idx`` (*stack, B) in [0, C], C
    writing zeros: :func:`gather_leaves` of one leaf in channel units."""
    return gather_leaves([x], idx, [ax], lead)[0]


def gather_rows(x, idx):
    """Plain 2-D kept-gather: x (R, C), idx (B,) -> (R, B)."""
    return gather_axis(x, idx, 1)


def compact_groups(x, idx):
    """Pack kept groups: x (..., C, K) gathered along axis -2 by idx
    (B,)."""
    return gather_axis(x, idx, x.ndim - 2)


def expand_groups(c, idx, full: int):
    """Zero-fill recovery (paper §4.4.3): (..., B, K) -> (..., full, K), a
    gather of the compact buffer itself by the inverse index, whose
    dropped positions (B) write zeros."""
    return gather_axis(c, _ref.inverse_index(idx, full), c.ndim - 2)


def dequantize_rows(q, scale):
    """Inverse of :func:`quantize_rows` (f32 out, caller casts): the
    gather+dequantize kernel without an index."""
    shape = tuple(q.shape)
    R, C = _rc(shape)
    out = _wire.dequantize_rows(_view2d(q, R, C),
                                _view2d(scale.to(torch.float32), R, 1))
    return out.view(shape)


def gather_quantize(x, idx, levels: int = 127):
    """x (R, C), idx (B,): fused kept-group gather + per-row quantize —
    the compact+q8 encode in one pass -> (q int8 (R, B), scale (R, 1))."""
    return _wire.gather_quantize(x.to(torch.float32).contiguous(),
                                 _idx32(idx), levels=levels)


def scatter_dequantize(q, scale, idx, full: int):
    """Fused dequantize + zero-fill expansion: q (R, B) int8 of the kept
    channels ``idx`` -> f32 (R, full), zeros on the dropped channels: the
    kernel on q itself by :func:`ref.inverse_index`, whose dropped
    channels read column B as zeros (no padded copy)."""
    return _wire.gather_dequantize(
        q.contiguous(), scale.to(torch.float32).reshape(-1, 1).contiguous(),
        _ref.inverse_index(idx, full))


# ------------------------------------------------------------------ #
# squared group norms (kernels/group_norms.py)
# ------------------------------------------------------------------ #


def _coalesce(sizes, strides) -> list[tuple[int, int]]:
    """(size, stride) dims with the size-1 dims dropped and each dim
    merged into the next where the two walk memory as one."""
    dims: list[tuple[int, int]] = []
    for n, st in zip(sizes, strides):
        if n == 1:
            continue
        if dims and dims[-1][1] == n * st:
            dims[-1] = (dims[-1][0] * n, st)
        else:
            dims.append((n, st))
    return dims


def group_norms_sq(x):
    """(G, C, *K) of any strides -> (G, C) f32 sums of squares over K.
    The fan-in dims are merged where memory allows; the kernel reads up to
    two of them in place (a weight moved to (G, C, K) by a view needs no
    copy), and a view that keeps more is copied contiguous first."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    G, C = x.shape[:2]
    dims = _coalesce(x.shape[2:], x.stride()[2:]) or [(1, 1)]
    if len(dims) > 2:
        x = x.reshape(G, C, -1).contiguous()
        dims = [(x.shape[2], 1)]
    sizes, strides = zip(*dims)
    v = x.as_strided((G, C) + sizes, (x.stride(0), x.stride(1)) + strides)
    return _gnorms.group_norms_sq(v)


# ------------------------------------------------------------------ #
# Mamba2 SSD chunk scan (kernels/ssd_scan.py)
# ------------------------------------------------------------------ #


def ssd_chunk_scan(x, dt, A, Bm, Cm, chunk: int = 128):
    """x (Bt, T, H, P), dt (Bt, T, H), A (H,) or (Bt, H), Bm/Cm (Bt, T, N)
    -> (y (Bt, T, H, P) in x's dtype, h (Bt, H, N, P) f32).  dt and A go
    to f32, B and C to x's dtype, and a per-head A is broadcast to one
    row per batch row."""
    Bt, _, H, _ = x.shape
    f32 = torch.float32
    return _ssd.ssd_chunk_scan(
        x.contiguous(), dt.to(f32).contiguous(),
        A.to(f32).expand(Bt, H).contiguous(), Bm.to(x.dtype).contiguous(),
        Cm.to(x.dtype).contiguous(), chunk=chunk)
