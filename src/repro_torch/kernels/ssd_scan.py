"""Wrapper of the SSD chunk-scan kernel (``csrc/ssd_scan.cu``), the port of
``repro/kernels/ssd_scan.py``: x (Bt, T, H, P), dt (Bt, T, H), A (Bt, H),
B/C (Bt, T, N) -> y (Bt, T, H, P) in x's dtype and the final state h
(Bt, H, N, P) f32, in chunks of ``ref.chunk_len(T, chunk)`` steps.

A carries one row per batch row: under ``vmap`` over ADMM workers each
worker's A differs, and the vmap rule folds the workers into Bt.  x, B and
C are f32 or bf16; dt and A f32.  A tensor on the CPU takes the plain
version (``ref.ssd_chunk_scan_ref``); a CUDA tensor launches the kernel or
raises.  The wrapper allocates the kernel's f32 workspace, of the size the
library asks for (the chunk sums of dt*A and the chunks' decays, B and C
transposed per chunk, the chunks' C.B^T and their states, and for bf16
the operands widened to f32), on the caller's stream.  ``launches`` counts
launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from .wire import _on_cpu, _stream

launches = {"ssd_chunk_scan": 0}

_P, _I64 = ctypes.c_void_p, ctypes.c_int64


def _lib():
    lib = _build.library("ssd_scan")
    if lib.ssd_chunk_scan.argtypes is None:
        lib.ssd_chunk_scan_workspace.argtypes = [_I64] * 6 + [ctypes.c_int]
        lib.ssd_chunk_scan_workspace.restype = _I64
        lib.ssd_chunk_scan.argtypes = [_P] * 8 + [_I64] * 6 + [ctypes.c_int,
                                                              _P]
        lib.ssd_chunk_scan.restype = ctypes.c_int
    return lib


def ssd_chunk_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """x (Bt, T, H, P), dt (Bt, T, H) f32, A (Bt, H) f32, Bm/Cm (Bt, T, N)
    of x's dtype -> (y, h)."""
    if _on_cpu("ssd_chunk_scan", x):
        return ref.ssd_chunk_scan_ref(x, dt, A, Bm, Cm, chunk)
    what = "ssd_chunk_scan"
    if x.ndim != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: x must be (Bt, T, H, P) f32 or bf16, got "
                         f"{x.dtype} {tuple(x.shape)}")
    Bt, T, H, P = x.shape
    N = Bm.shape[-1]
    for name, t, dtype, shape in (
            ("x", x, x.dtype, (Bt, T, H, P)),
            ("dt", dt, torch.float32, (Bt, T, H)),
            ("A", A, torch.float32, (Bt, H)),
            ("Bm", Bm, x.dtype, (Bt, T, N)),
            ("Cm", Cm, x.dtype, (Bt, T, N))):
        if t.device != x.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device} (contiguous: "
                f"{t.is_contiguous()})")
    if min(Bt, T, H, P, N) <= 0:
        raise ValueError(f"{what}: empty operand {tuple(x.shape)}, N={N}")
    Q = ref.chunk_len(T, chunk)
    bf16 = int(x.dtype == torch.bfloat16)
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    h = torch.empty((Bt, H, N, P), **f32)
    work = torch.empty(
        (lib.ssd_chunk_scan_workspace(Bt, T, H, P, N, Q, bf16),), **f32)
    err = lib.ssd_chunk_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), h.data_ptr(), work.data_ptr(), Bt, T,
        H, P, N, Q, bf16, _stream(x))
    _build.check(err, what)
    launches[what] += 1
    return y, h
