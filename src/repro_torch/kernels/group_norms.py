"""Wrapper of the squared group-norm kernel (``csrc/group_norms.cu``), the
port of ``repro/kernels/group_norms.py``: x (G, C, K) -> (G, C) f32 sums
of squares over K, the dynamic round's mask scores.

The kernel reads the operand's own strides, with the fan-in as one or two
dims (K1, K2): :func:`group_norms_sq` takes a (G, C, K) or (G, C, K1, K2)
view of f32 or bf16.  A tensor on the CPU takes the plain version
(``ref.group_norms_sq_ref``); a CUDA tensor launches the kernel or raises.
``launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from .wire import _on_cpu, _stream

launches = {"group_norms_sq": 0}

_P, _I64 = ctypes.c_void_p, ctypes.c_int64


def _lib():
    lib = _build.library("group_norms")
    if lib.group_norms_sq.argtypes is None:
        lib.group_norms_sq.argtypes = [_P, _P] + [_I64] * 8 + [ctypes.c_int,
                                                               _P]
        lib.group_norms_sq.restype = ctypes.c_int
    return lib


def group_norms_sq(x):
    """x: (G, C, K) or (G, C, K1, K2), any strides, f32 or bf16 -> f32
    (G, C)."""
    if _on_cpu("group_norms_sq", x):
        return ref.group_norms_sq_ref(x)
    what = "group_norms_sq"
    if x.dtype not in (torch.float32, torch.bfloat16) or x.ndim not in (3, 4):
        raise ValueError(f"{what}: the CUDA kernel takes a float32 or "
                         f"bfloat16 (G, C, K) or (G, C, K1, K2) view, got "
                         f"{x.dtype} {tuple(x.shape)}")
    G, C = x.shape[:2]
    sg, sc = x.stride(0), x.stride(1)
    if x.ndim == 3:
        K1, K2, sk1, sk2 = 1, x.shape[2], 0, x.stride(2)
    else:
        K1, K2 = x.shape[2:]
        sk1, sk2 = x.stride(2), x.stride(3)
    if K1 * K2 == 0:
        K1, K2 = 0, 1        # an empty fan-in: every norm is 0
    out = torch.empty((G, C), dtype=torch.float32, device=x.device)
    err = _lib().group_norms_sq(x.data_ptr(), out.data_ptr(), G, C, K1, K2,
                                sg, sc, sk1, sk2,
                                int(x.dtype == torch.bfloat16), _stream(x))
    _build.check(err, what)
    launches[what] += 1
    return out
