"""Wrappers of the fused proximal-SGD kernel (``csrc/fused_prox_sgd.cu``).

Two entries share one CUDA source, as the two TPU kernels of
``repro/kernels/fused_prox_sgd.py`` share one body:

  * :func:`fused_prox_sgd_dyn` — the training hot path: ``rho`` a per-row
    (R, 1) column (it may be a stride-0 expansion of one value) and
    ``eta`` a one-element tensor, both changing every round;
  * :func:`fused_prox_sgd` — ``rho`` and ``eta`` as numbers.

Operands are f32 (R, C) tensors.  A tensor on the CPU takes the plain
version (``ref.fused_prox_sgd_ref``); a CUDA tensor launches the kernel
or raises.  ``launches`` counts kernel launches per entry.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

launches = {"fused_prox_sgd": 0, "fused_prox_sgd_dyn": 0}

_P, _I64, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float


def _lib():
    lib = _build.library("fused_prox_sgd")
    if lib.prox_sgd_dyn_f32.argtypes is None:
        lib.prox_sgd_dyn_f32.argtypes = [_P] * 6 + [_I64, _P, _F, _P, _P,
                                                     _I64, _I64, _P]
        lib.prox_sgd_dyn_f32.restype = ctypes.c_int
        lib.prox_sgd_f32.argtypes = [_P] * 5 + [_F, _F, _F, _P, _P, _I64,
                                                 _I64, _P]
        lib.prox_sgd_f32.restype = ctypes.c_int
    return lib


def _check_operands(xs, device):
    shape = xs[0].shape
    if len(shape) != 2:
        raise ValueError(f"fused_prox_sgd: expected (R, C) operands, got "
                         f"{tuple(shape)}")
    for x in xs:
        if x.device != device:
            raise ValueError(f"fused_prox_sgd: operand on {x.device}, "
                             f"expected {device}")
        if x.dtype != torch.float32:
            raise TypeError(f"fused_prox_sgd: the CUDA kernel takes float32, "
                            f"got {x.dtype}")
        if x.shape != shape or not x.is_contiguous():
            raise ValueError("fused_prox_sgd: operands must be contiguous and "
                             f"of one shape {tuple(shape)}")


def _on_cpu(theta) -> bool:
    if theta.device.type == "cpu":
        return True
    if theta.device.type != "cuda":
        raise ValueError(f"fused_prox_sgd: unsupported device {theta.device}")
    return False


def fused_prox_sgd_dyn(theta, g, z, u, mom, rho_col, eta, *, momentum):
    """(R, C) operands, ``rho_col`` (R, 1), ``eta`` one element ->
    (theta', mom')."""
    if _on_cpu(theta):
        return ref.fused_prox_sgd_ref(theta, g, z, u, mom, eta=eta,
                                      rho=rho_col, momentum=momentum)
    xs = (theta, g, z, u, mom)
    _check_operands(xs, theta.device)
    R, C = theta.shape
    if rho_col.shape != (R, 1) or rho_col.dtype != torch.float32 \
            or rho_col.device != theta.device \
            or (R > 1 and rho_col.stride(0) not in (0, 1)):
        raise ValueError(f"fused_prox_sgd_dyn: rho must be a float32 (R, 1) "
                         f"column with row stride 0 or 1 on {theta.device}")
    if eta.numel() != 1 or eta.dtype != torch.float32 \
            or eta.device != theta.device:
        raise ValueError("fused_prox_sgd_dyn: eta must be one float32 "
                         f"element on {theta.device}")
    t_out, m_out = torch.empty_like(theta), torch.empty_like(mom)
    stride = rho_col.stride(0) if R > 1 else 0
    err = _lib().prox_sgd_dyn_f32(
        *(x.data_ptr() for x in xs), rho_col.data_ptr(), stride,
        eta.data_ptr(), momentum, t_out.data_ptr(), m_out.data_ptr(),
        R * C, C, torch.cuda.current_stream(theta.device).cuda_stream)
    _build.check(err, "fused_prox_sgd_dyn")
    launches["fused_prox_sgd_dyn"] += 1
    return t_out, m_out


def fused_prox_sgd(theta, g, z, u, mom, *, eta: float, rho: float,
                   momentum: float):
    """(R, C) operands, numbers ``eta``/``rho`` -> (theta', mom')."""
    if _on_cpu(theta):
        return ref.fused_prox_sgd_ref(theta, g, z, u, mom, eta=eta, rho=rho,
                                      momentum=momentum)
    xs = (theta, g, z, u, mom)
    _check_operands(xs, theta.device)
    R, C = theta.shape
    t_out, m_out = torch.empty_like(theta), torch.empty_like(mom)
    err = _lib().prox_sgd_f32(
        *(x.data_ptr() for x in xs), rho, eta, momentum, t_out.data_ptr(),
        m_out.data_ptr(), R * C, C,
        torch.cuda.current_stream(theta.device).cuda_stream)
    _build.check(err, "fused_prox_sgd")
    launches["fused_prox_sgd"] += 1
    return t_out, m_out
