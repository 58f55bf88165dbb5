"""Plain PyTorch twins of ``repro/kernels/ref.py`` for the kernels this
port has written by hand.  Each kernel wrapper takes its twin for a
tensor on the CPU, and the card checks compare each kernel with its twin
on the same inputs.  The operation order is the reference's, so the CUDA
kernels (which round every operation the same way) match them bit for
bit."""
from __future__ import annotations

import torch


def fused_prox_sgd_ref(theta, g, z, u, mom, *, eta, rho, momentum):
    """Paper Eq. 8 + momentum, one fused memory pass:
    g_tot = g + rho*(theta - z + u);  m' = mu*m + g_tot;  th' = th - eta*m'.
    ``eta``/``rho`` are numbers or tensors broadcastable against theta."""
    gtot = g + rho * (theta - z + u)
    mom_new = momentum * mom + gtot
    return theta - eta * mom_new, mom_new


def quantize_rows_ref(x, levels=127):
    """x: (R, C) -> (q int8, scale f32 (R, 1)) per-row symmetric
    quantization.  The scale divides by a TENSOR holding ``levels``: on the
    card PyTorch turns division by a Python number into multiplication by
    its reciprocal, which can differ by one ulp (the jitted JAX shim's
    ``max * (1/127)``); the reference's eager ``max / 127`` is IEEE
    division."""
    x = x.to(torch.float32)
    amax = torch.amax(torch.abs(x), dim=1, keepdim=True)
    s = amax / torch.full_like(amax, float(levels)) + 1e-30
    q = torch.clamp(torch.round(x / s), -levels, levels)
    # a NaN quotient (NaN in the row, or inf / inf) stores 0, as XLA's
    # float-to-int8 convert does; PyTorch's own cast leaves it undefined
    q = torch.nan_to_num(q, nan=0.0).to(torch.int8)
    return q, s
