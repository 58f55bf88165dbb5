"""Wrapper of the kept-group gather kernel (``csrc/compact.cu``), the port
of ``repro/kernels/compact.py``'s ``gather_groups``.

``out[r, j, q] = x[r, idx[s, j], q]`` on a contiguous (R, C, Q) view (or
(R, C), Q = 1) with an int32 index table (S, B), slice ``s = (r //
slice_rows) % S``: the payload compaction of the consensus round and of
the reconfiguration's migration, and with an inverse index into a
zero-padded buffer the zero-fill expansion.  A tensor on the CPU takes
the plain version (``ref.gather_groups_ref``); a CUDA tensor launches the
kernel or raises.  ``launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from .wire import _on_cpu, _stream

launches = {"gather_groups": 0}

# element types the kernel moves (as unsigned integers of their size)
DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.uint8)

_P, _I64 = ctypes.c_void_p, ctypes.c_int64


def _lib():
    lib = _build.library("compact")
    if lib.gather_groups.argtypes is None:
        lib.gather_groups.argtypes = [_P] * 3 + [_I64] * 6 + [ctypes.c_int,
                                                             _P]
        lib.gather_groups.restype = ctypes.c_int
    return lib


def gather_groups(x, idx, *, slice_rows: int = 1):
    """x: (R, C) or (R, C, Q), idx: (B,) or (S, B) int32 in [0, C) ->
    (R, B) or (R, B, Q); R must be a multiple of S * slice_rows."""
    if _on_cpu("gather_groups", x):
        return ref.gather_groups_ref(x, idx, slice_rows)
    what = "gather_groups"
    if x.dtype not in DTYPES or x.ndim not in (2, 3) \
            or not x.is_contiguous():
        raise ValueError(f"{what}: the CUDA kernel takes a contiguous (R, C) "
                         f"or (R, C, Q) tensor of {DTYPES}, got {x.dtype} "
                         f"{tuple(x.shape)} (contiguous: "
                         f"{x.is_contiguous()})")
    if idx.dtype != torch.int32 or idx.ndim not in (1, 2) \
            or idx.device != x.device or not idx.is_contiguous():
        raise ValueError(f"{what}: the index must be a contiguous int32 (B,) "
                         f"or (S, B) tensor on {x.device}, got {idx.dtype} "
                         f"{tuple(idx.shape)} on {idx.device}")
    R, C = x.shape[:2]
    Q = x.shape[2] if x.ndim == 3 else 1
    S, B = (1, idx.shape[0]) if idx.ndim == 1 else tuple(idx.shape)
    if slice_rows < 1 or R % (S * slice_rows):
        raise ValueError(f"{what}: {R} rows are not whole slices of "
                         f"{slice_rows} rows times {S} index rows")
    out = torch.empty((R, B) + x.shape[2:], dtype=x.dtype, device=x.device)
    err = _lib().gather_groups(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                               R, C, B, Q, S, slice_rows, x.element_size(),
                               _stream(x))
    _build.check(err, what)
    launches[what] += 1
    return out
