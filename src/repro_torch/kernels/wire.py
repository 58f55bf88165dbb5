"""Wrappers of the wire-format kernels (``csrc/wire.cu``), the port of
``repro/kernels/wire.py``'s q8 quantizer and its three q4 kernels:

  * :func:`quantize_rows` — per-row symmetric int8 (the q8 ring);
  * :func:`quantize_pack_q4` — per-row q4 quantize + nibble pack (the q4
    ring and ``Q4Codec.encode``);
  * :func:`gather_quantize_q4` — kept-column gather fused with it
    (``Q4Codec.encode_compact``);
  * :func:`unpack_gather_dequantize_q4` — nibble unpack + gather in the
    unpacked space + dequantize (``Q4Codec.decode``/``decode_expand``).

Scale granularity is one f32 scale per ROW of the (R, C) view — a
function of the leaf shape, so ``wire_bytes`` stays analytic.  A tensor
on the CPU takes the plain version (``kernels/ref.py``); a CUDA tensor
launches the kernel or raises.  ``launches`` counts launches.  The q8
gather+quantize and dequantize kernels wait for a later slice.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

launches = {"quantize_rows": 0, "quantize_pack_q4": 0,
            "gather_quantize_q4": 0, "unpack_gather_dequantize_q4": 0}

_P, _I64 = ctypes.c_void_p, ctypes.c_int64


def _lib():
    lib = _build.library("wire")
    if lib.quantize_rows_f32.argtypes is None:
        for name, args in (
                ("quantize_rows_f32", [_P, _P, _P, _I64, _I64, ctypes.c_int,
                                       _P]),
                ("quantize_pack_q4_f32", [_P, _P, _P, _I64, _I64, _P]),
                ("gather_quantize_q4_f32", [_P] * 4 + [_I64] * 3 + [_P]),
                ("unpack_gather_dequantize_q4_f32",
                 [_P] * 4 + [_I64] * 3 + [_P])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def _on_cpu(what: str, x) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return False


def _check(what: str, x, dtype, device, ndim: int):
    if x.device != device or x.dtype != dtype or x.ndim != ndim \
            or not x.is_contiguous():
        raise ValueError(
            f"{what}: the CUDA kernel takes a contiguous {dtype} tensor of "
            f"rank {ndim} on {device}, got {x.dtype} {tuple(x.shape)} on "
            f"{x.device}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def quantize_rows(x, *, levels: int = 127):
    """x: (R, C) float32 -> (q int8 (R, C), scale f32 (R, 1))."""
    if _on_cpu("quantize_rows", x):
        return ref.quantize_rows_ref(x, levels)
    _check("quantize_rows", x, torch.float32, x.device, 2)
    if not 0 < levels <= 127:
        raise ValueError(f"quantize_rows: levels {levels} outside (0, 127]")
    R, C = x.shape
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    s = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    err = _lib().quantize_rows_f32(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                   R, C, levels, _stream(x))
    _build.check(err, "quantize_rows")
    launches["quantize_rows"] += 1
    return q, s


def quantize_pack_q4(x):
    """x: (R, C) float32 -> (packed uint8 (R, ceil(C/2)), scale f32
    (R, 1)); an odd C carries one zero pad nibble."""
    if _on_cpu("quantize_pack_q4", x):
        return ref.quantize_pack_q4_ref(x)
    _check("quantize_pack_q4", x, torch.float32, x.device, 2)
    R, C = x.shape
    p = torch.empty((R, (C + 1) // 2), dtype=torch.uint8, device=x.device)
    s = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    err = _lib().quantize_pack_q4_f32(x.data_ptr(), p.data_ptr(),
                                      s.data_ptr(), R, C, _stream(x))
    _build.check(err, "quantize_pack_q4")
    launches["quantize_pack_q4"] += 1
    return p, s


def gather_quantize_q4(x, idx):
    """x: (R, C) float32, idx: (B,) int64 in [0, C) -> the q4 encode of
    ``x[:, idx]``: (packed uint8 (R, ceil(B/2)), scale f32 (R, 1))."""
    if _on_cpu("gather_quantize_q4", x):
        return ref.gather_quantize_q4_ref(x, idx)
    _check("gather_quantize_q4", x, torch.float32, x.device, 2)
    _check("gather_quantize_q4 (idx)", idx, torch.int64, x.device, 1)
    R, C = x.shape
    B = idx.shape[0]
    p = torch.empty((R, (B + 1) // 2), dtype=torch.uint8, device=x.device)
    s = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    err = _lib().gather_quantize_q4_f32(x.data_ptr(), idx.data_ptr(),
                                        p.data_ptr(), s.data_ptr(), R, C, B,
                                        _stream(x))
    _build.check(err, "gather_quantize_q4")
    launches["gather_quantize_q4"] += 1
    return p, s


def unpack_gather_dequantize_q4(p, s, idx):
    """p: (R, Cp) uint8, s: (R, 1) float32, idx: (Cout,) int64 into the
    unpacked channel space [0, 2*Cp) -> float32 (R, Cout)."""
    if _on_cpu("unpack_gather_dequantize_q4", p):
        return ref.unpack_gather_dequantize_q4_ref(p, s, idx)
    what = "unpack_gather_dequantize_q4"
    _check(what, p, torch.uint8, p.device, 2)
    _check(f"{what} (scale)", s, torch.float32, p.device, 2)
    _check(f"{what} (idx)", idx, torch.int64, p.device, 1)
    R, Cp = p.shape
    if s.shape != (R, 1):
        raise ValueError(f"{what}: scale of shape {tuple(s.shape)}, "
                         f"expected ({R}, 1)")
    Cout = idx.shape[0]
    out = torch.empty((R, Cout), dtype=torch.float32, device=p.device)
    err = _lib().unpack_gather_dequantize_q4_f32(
        p.data_ptr(), s.data_ptr(), idx.data_ptr(), out.data_ptr(), R, Cp,
        Cout, _stream(p))
    _build.check(err, what)
    launches[what] += 1
    return out
