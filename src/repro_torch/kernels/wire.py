"""Wrapper of the per-row quantize kernel of the q8 wire format
(``csrc/wire.cu``), the port of ``repro/kernels/wire.py::quantize_rows``.

Scale granularity is one f32 scale per ROW of the (R, C) view — a
function of the leaf shape, so ``wire_bytes`` stays analytic.  A tensor
on the CPU takes the plain version (``ref.quantize_rows_ref``); a CUDA
tensor launches the kernel or raises.  ``launches`` counts launches.
The other wire kernels (gather+quantize, dequantize, q4) wait for a
later slice of the port.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

launches = {"quantize_rows": 0}


def _lib():
    lib = _build.library("wire")
    if lib.quantize_rows_f32.argtypes is None:
        P, I64 = ctypes.c_void_p, ctypes.c_int64
        lib.quantize_rows_f32.argtypes = [P, P, P, I64, I64, ctypes.c_int, P]
        lib.quantize_rows_f32.restype = ctypes.c_int
    return lib


def quantize_rows(x, *, levels: int = 127):
    """x: (R, C) float32 -> (q int8 (R, C), scale f32 (R, 1))."""
    if x.device.type == "cpu":
        return ref.quantize_rows_ref(x, levels)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows: unsupported device {x.device}")
    if x.ndim != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("quantize_rows: the CUDA kernel takes a contiguous "
                         f"float32 (R, C) tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not 0 < levels <= 127:
        raise ValueError(f"quantize_rows: levels {levels} outside (0, 127]")
    R, C = x.shape
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    s = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    err = _lib().quantize_rows_f32(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), R, C, levels,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "quantize_rows")
    launches["quantize_rows"] += 1
    return q, s
