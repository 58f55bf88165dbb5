"""Plain PyTorch twins of ``repro/kernels/ref.py`` for the kernels this
port has written by hand.  Each kernel wrapper takes its twin for a
tensor on the CPU, and the card checks compare each kernel with its twin
on the same inputs.  The operation order is the reference's, so the CUDA
kernels (which round every operation the same way) match them bit for
bit."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def weak(x: float, dtype) -> float:
    """A Python number as JAX's weak typing uses it against a tensor of
    ``dtype``: rounded to that dtype (0.9 against bf16 is 0.8984375).
    PyTorch keeps a Python number in f32 against a bf16 tensor, so the
    port rounds it first wherever one meets a tensor."""
    return float(torch.tensor(x, dtype=dtype))


def fused_prox_sgd_ref(theta, g, z, u, mom, *, eta, rho, momentum):
    """Paper Eq. 8 + momentum, one fused memory pass:
    g_tot = g + rho*(theta - z + u);  m' = mu*m + g_tot;  th' = th - eta*m'.
    ``eta``/``rho`` are numbers or tensors (in theta's dtype)
    broadcastable against theta.  Every operation rounds to theta's dtype
    and the numbers are rounded to it first, as JAX computes a bf16
    update (:func:`weak`)."""
    dt = theta.dtype
    eta, rho = (x if torch.is_tensor(x) else weak(x, dt) for x in (eta, rho))
    gtot = g + rho * (theta - z + u)
    mom_new = weak(momentum, dt) * mom + gtot
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


def gather_groups_ref(x, idx, slice_rows: int = 1, group: int = 1):
    """x: (R, C) or (R, C, Q), idx: (B,) or (S, B) kept groups of
    ``group`` channels in [0, C/group] -> (R, B*group) or (R, B*group,
    Q), ``out[r, j*g + k, q] = x[r, idx[s, j]*g + k, q]`` with ``s = (r //
    slice_rows) % S`` and zeros where the index is C/g: the §4.4 packing
    gather (compaction along the group axis) and, with the inverse index
    of a compaction (:func:`inverse_index`) applied to the compact buffer,
    the zero-fill expansion.  It reads x padded by one zero group."""
    x3 = x if x.ndim == 3 else x[..., None]
    R, C, Q = x3.shape
    g = group
    idx2 = idx.reshape(-1, idx.shape[-1]).long()
    S, B = idx2.shape
    xg = F.pad(x3.reshape(R, C // g, g * Q), (0, 0, 0, 1))
    x5 = xg.reshape(R // (S * slice_rows), S, slice_rows, C // g + 1, g * Q)
    out = torch.take_along_dim(x5, idx2.reshape(1, S, 1, B, 1), dim=3)
    out = out.reshape(R, B * g, Q)
    return out if x.ndim == 3 else out[..., 0]


def gather_quantize_ref(x, idx, levels=127):
    """x: (R, C), idx: (B,) -> the q8 encode of ``x[:, idx]`` (gather, then
    :func:`quantize_rows_ref`)."""
    return quantize_rows_ref(torch.index_select(x, 1, idx.long()), levels)


def gather_dequantize_ref(q, s, idx):
    """q: (R, Cq) int8, s: (R, 1), idx: (Cout,) in [0, Cq] -> f32 (R,
    Cout) = ``q[:, idx] * s``, index Cq reading a zero column (``0 * s``:
    NaN on a row whose scale is NaN or inf), so q needs no padded copy
    for the zero-fill expansion; it reads q padded by that column."""
    qp = F.pad(q, (0, 1))
    return torch.index_select(qp, 1, idx.long()).to(torch.float32) * s


def dequantize_rows_ref(q, s):
    """q: (R, C) int8, s: (R, 1) -> f32 ``q * s``: the decode with the
    identity index."""
    return q.to(torch.float32) * s


def inverse_index(idx, full, fill=None, dtype=torch.int32):
    """(..., B) kept indices -> (..., full) positions into the compact
    buffer: position ``idx[b]`` holds b, every dropped position ``fill``
    (default B: the zero slot past the compact buffer)."""
    B = idx.shape[-1]
    inv = torch.full(idx.shape[:-1] + (full,), B if fill is None else fill,
                     dtype=dtype, device=idx.device)
    src = torch.arange(B, dtype=dtype, device=idx.device)
    return inv.scatter_(-1, idx.long(), src.expand(idx.shape))


def expand_operands(c, idx, full):
    """The operands that make a gather the zero-fill expansion of a
    compact (R, B) buffer with kept channels idx (B,): c padded by one
    zero column, and :func:`inverse_index`, which points every dropped
    channel at the pad."""
    return F.pad(c, (0, 1)), inverse_index(idx, full)


def scatter_dequantize_ref(q, s, idx, full):
    """Inverse of :func:`gather_quantize_ref`: q (R, B), s (R, 1), idx
    (B,) -> f32 (R, full), channel ``idx[b]`` = q[:, b] * s, the dropped
    channels 0 (NaN on a row whose scale is NaN or inf)."""
    return gather_dequantize_ref(q, s, inverse_index(idx, full))


def group_norms_sq_ref(x):
    """x: (G, C, *K) -> f32 (G, C), the sum of squares over the trailing
    fan-in dims (mask scores, paper §2.1)."""
    sq = torch.square(x.to(torch.float32))
    return torch.sum(sq, dim=tuple(range(2, x.ndim))) if x.ndim > 2 else sq


def pack_q4_ref(q):
    """(R, n) int nibble values in [-8, 7] -> (R, ceil(n/2)) uint8, two
    two's-complement nibbles per byte (even column = low nibble); an odd
    n gets one zero pad nibble."""
    q = q.to(torch.int32) & 0xF
    if q.shape[1] % 2:
        q = F.pad(q, (0, 1))
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
    channel space [0, 2*Cp] -> f32 (R, Cout) = nibble[:, idx] * s, index
    2*Cp reading a zero nibble (the first of a zero pad byte)."""
    q = F.pad(unpack_q4_ref(p, 2 * p.shape[1]), (0, 1))
    return torch.index_select(q, 1, idx).to(torch.float32) * s


def unpack_dequantize_q4_ref(p, s, n):
    """p: (R, Cp) packed uint8, s: (R, 1) -> f32 (R, n): the first n
    nibbles of each row times its scale (the decode with the identity
    index)."""
    return unpack_q4_ref(p, n).to(torch.float32) * s


def inverse_index_q4(p, idx, full):
    """The inverse index (full,) int64 of a compact q4 payload p (R, Cp)
    with kept channels idx (B,): channel ``idx[b]`` reads nibble b, every
    dropped channel nibble 2*Cp, which decodes to 0 (the zero nibble past
    p, or the pad byte's of :func:`expand_operands_q4`)."""
    return inverse_index(idx, full, 2 * p.shape[1], torch.int64)


def expand_operands_q4(p, idx, full):
    """The operands that make ``unpack_gather_dequantize`` the zero-fill
    expansion of a compact q4 payload p (R, Cp) with kept channels idx
    (B,) within [0, 2*Cp), the TPU kernel's domain: p gains one zero byte
    column, and :func:`inverse_index_q4` points every dropped channel at
    nibble 2*Cp of the pad byte."""
    return F.pad(p, (0, 1)), inverse_index_q4(p, idx, full)


def scatter_dequantize_q4_ref(p, s, idx, full):
    """Inverse of :func:`gather_quantize_q4_ref`: p (R, Cp), s (R, 1), idx
    (B,) -> f32 (R, full), channel ``idx[b]`` = nibble b * s, the dropped
    channels 0 * s."""
    return unpack_gather_dequantize_q4_ref(p, s,
                                           inverse_index_q4(p, idx, full))


def chunk_len(T: int, chunk: int) -> int:
    """``min(chunk, T)``, lowered to a divisor of T: the SSD scan's chunk
    length (as ``repro.models.ssm.ssd_scan`` picks it) and the loss's
    (``repro.models.layers._pick_chunk``)."""
    Q = min(chunk, T)
    while T % Q:
        Q -= 1
    return Q


def ssd_chunk_scan_ref(x, dt, A, Bm, Cm, chunk):
    """Mamba2 SSD chunked scan, the plain twin of ``csrc/ssd_scan.cu`` and
    of ``repro.models.ssm.ssd_scan``.  x (Bt, T, H, P), dt (Bt, T, H), A
    (H,) or (Bt, H), Bm/Cm (Bt, T, N) -> (y (Bt, T, H, P) in x's dtype,
    h (Bt, H, N, P) f32); all arithmetic in f32.

    The intra-chunk terms of all chunks are computed at once, then the
    state runs through the chunks in order.  Two choices keep it usable
    under autograd and ``torch.use_deterministic_algorithms`` on the card:
    the decay's exponent is set to -inf above the diagonal BEFORE the
    exp, so neither the forward nor the gradient meets inf * 0 (NaN), and
    the within-chunk cumulative sum of dt*A is a product with a triangle of
    ones, since ``torch.cumsum`` has no deterministic CUDA version."""
    Bt, T, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk_len(T, chunk)
    nc = T // Q
    f32 = torch.float32
    A = A.to(f32).expand(Bt, H)
    xh = x.to(f32).reshape(Bt, nc, Q, H, P).transpose(2, 3)  # (b,c,h,s,p)
    dth = dt.to(f32).reshape(Bt, nc, Q, H).transpose(2, 3)   # (b,c,h,s)
    Bc = Bm.to(f32).reshape(Bt, nc, Q, N)
    Cc = Cm.to(f32).reshape(Bt, nc, Q, N)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    cum = (dth * A[:, None, :, None]) @ causal.T.to(f32)       # inclusive
    seg = cum[..., :, None] - cum[..., None, :]                 # (q, s)
    decay = torch.exp(torch.where(causal, seg, float("-inf")))
    cb = Cc @ Bc.transpose(-1, -2)                              # (b,c,q,s)
    w = cb[:, :, None] * decay * dth[..., None, :]
    y1 = w @ xh                                                 # (b,c,h,q,p)
    dec_end = torch.exp(cum[..., -1:] - cum)                    # (b,c,h,s)
    S = Bc.transpose(-1, -2)[:, :, None] @ ((dec_end * dth)[..., None] * xh)
    d_chunk = torch.exp(cum[..., -1])                           # (b,c,h)
    h = torch.zeros((Bt, H, N, P), dtype=f32, device=x.device)
    entering = []
    for c in range(nc):                                         # in order
        entering.append(h)
        h = h * d_chunk[:, c, :, None, None] + S[:, c]
    y2 = (Cc[:, :, None] @ torch.stack(entering, dim=1)) \
        * torch.exp(cum)[..., None]
    y = (y1 + y2).transpose(2, 3).reshape(Bt, T, H, P)
    return y.to(x.dtype), h
