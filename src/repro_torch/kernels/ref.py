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


def pack_q4_ref(q):
    """(R, n) int nibble values in [-8, 7] -> (R, ceil(n/2)) uint8, two
    two's-complement nibbles per byte (even column = low nibble); an odd
    n gets one zero pad nibble."""
    q = q.to(torch.int32) & 0xF
    if q.shape[1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    q = q.reshape(q.shape[0], -1, 2)
    return (q[..., 0] | (q[..., 1] << 4)).to(torch.uint8)


def unpack_q4_ref(p, n):
    """(R, Cp) uint8 -> (R, n) int32, sign-extended from 4 bits."""
    p = p.to(torch.int32)
    q = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).reshape(p.shape[0], -1)
    return ((q ^ 8) - 8)[:, :n]


def quantize_pack_q4_ref(x):
    """x: (R, C) -> (packed uint8 (R, ceil(C/2)), scale f32 (R, 1)):
    per-row abs-max / 7 (IEEE division by a tensor, as in
    :func:`quantize_rows_ref`), round half to even, clip to [-7, 7].  A
    NaN quotient packs the nibble 0, as XLA's float-to-int32 convert
    gives before the reference's ``& 0xF``."""
    x = x.to(torch.float32)
    amax = torch.amax(torch.abs(x), dim=1, keepdim=True)
    s = amax / torch.full_like(amax, 7.0) + 1e-30
    q = torch.clamp(torch.round(x / s), -7, 7)
    return pack_q4_ref(torch.nan_to_num(q, nan=0.0).to(torch.int32)), s


def gather_quantize_q4_ref(x, idx):
    """x: (R, C), idx: (B,) -> the q4 encode of ``x[:, idx]``."""
    return quantize_pack_q4_ref(torch.index_select(x, 1, idx))


def unpack_gather_dequantize_q4_ref(p, s, idx):
    """p: (R, Cp) packed uint8, s: (R, 1), idx: (Cout,) into the UNPACKED
    channel space [0, 2*Cp) -> f32 (R, Cout) = nibble[:, idx] * s."""
    q = unpack_q4_ref(p, 2 * p.shape[1])
    return torch.index_select(q, 1, idx).to(torch.float32) * s


def expand_operands_q4(p, idx, full):
    """The operands that make ``unpack_gather_dequantize`` the zero-fill
    expansion of a compact q4 payload p (R, Cp) with kept channels idx
    (B,): p gains one zero byte column, and the inverse index (full,)
    points channel ``idx[b]`` at nibble b and every dropped channel at
    nibble 2*Cp of the pad byte, which decodes to 0 without a scatter."""
    Cp = p.shape[1]
    idx = idx.to(torch.int64)
    inv = torch.full((full,), 2 * Cp, dtype=torch.int64, device=p.device)
    inv = inv.scatter(0, idx, torch.arange(idx.shape[0], dtype=torch.int64,
                                           device=p.device))
    return torch.nn.functional.pad(p, (0, 1)), inv


def scatter_dequantize_q4_ref(p, s, idx, full):
    """Inverse of :func:`gather_quantize_q4_ref`: p (R, Cp), s (R, 1), idx
    (B,) -> f32 (R, full), channel ``idx[b]`` = nibble b * s, the dropped
    channels 0."""
    pp, inv = expand_operands_q4(p, idx, full)
    return unpack_gather_dequantize_q4_ref(pp, s, inv)
