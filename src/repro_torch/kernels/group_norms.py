"""Wrapper of the squared group-norm kernel (``csrc/group_norms.cu``), the
port of ``repro/kernels/group_norms.py``: x (G, C, K) -> (G, C) f32 sums
of squares over K, the dynamic round's mask scores.

The kernel reads the operand's own strides, with the fan-in as one or two
dims (K1, K2): :func:`group_norms_sq` takes a (G, C, K) or (G, C, K1, K2)
view of f32 or bf16.  :func:`plan` chooses the launch from the view (a
plain function, so the CPU tests check it); :func:`slice_reads` lists the
fan-in positions each slice of a plan reads, as the kernel walks them.  A
tensor on the CPU takes the plain version (``ref.group_norms_sq_ref``); a
CUDA tensor launches the kernel or raises.  ``launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, ref
from .wire import _on_cpu, _stream

launches = {"group_norms_sq": 0}

THREADS = 256            # threads a block
# grid size worth slicing up to: two waves of 8 resident blocks of 256
# threads on the H100's 132 SMs
TARGET_BLOCKS = 2 * 8 * 132
MIN_LOADS = 4            # loads a thread keeps per slice (its unroll)
MAX_SLICES = 16          # partials the finishing block adds per output


class Plan(NamedTuple):
    """One launch of the kernel; the fields are the C side's ``Plan`` in
    order.  K layout (``layout`` 0): the fan-in as ``rows`` (stride
    ``rs``) of ``cols`` vectors of ``vec`` elements (stride ``cs``),
    ``group`` threads an output shaped ``tx`` x ``ty``; a row walk
    (``walk_rows``) gives each thread one column and slices the rows, a
    column walk slices the columns.  C layout (1): a block holds ``group``
    = ``tx`` * ``vec`` neighbouring channels, ``ty`` threads deep over the
    fan-in rows, with ``cols`` inner fan-in positions (stride ``cs``) per
    row.  ``slices`` slices of ``span`` rows (or columns), ``blocks``
    blocks of outputs."""
    layout: int
    vec: int
    walk_rows: int
    G: int
    C: int
    sg: int
    sc: int
    rows: int
    rs: int
    cols: int
    cs: int
    tx: int
    ty: int
    group: int
    slices: int
    span: int
    blocks: int

    def describe(self) -> str:
        what = (f"C layout, {self.group} channels a block" if self.layout
                else f"K layout, {'row' if self.walk_rows else 'column'} "
                f"walk, {self.group} threads an output")
        return (f"{what}, threads {self.tx}x{self.ty}, vec {self.vec}, "
                f"{self.slices} slice(s) of {self.span}, "
                f"{self.blocks}x{self.slices} blocks, "
                f"{1 if self.slices == 1 else 2} pass(es)")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _slices(n: int, step: int, extra: int, blocks: int) -> tuple[int, int]:
    """(slices, span) of a walked dim of ``n`` that ``step`` threads take
    in turn, ``extra`` loads a position: slice only while the grid is
    smaller than TARGET_BLOCKS, each slice keeping MIN_LOADS loads a
    thread; the span is a multiple of ``step``."""
    steps = _cdiv(n, step)
    want = min(_cdiv(TARGET_BLOCKS, max(blocks, 1)),
               steps * extra // MIN_LOADS, steps, MAX_SLICES)
    if want < 2:
        return 1, n
    span = _cdiv(_cdiv(n, want), step) * step
    return _cdiv(n, span), span


def plan(shape, strides, elem: int, ptr: int) -> Plan:
    """The launch for a (G, C, K1, K2) view at element ``strides`` of
    ``elem``-byte values starting at address ``ptr``.

    The channel axis decides the layout: contiguous channels (stride 1,
    C > 1) take the C layout, vectors along C; anything else the K
    layout, vectors along the fan-in dim of the smallest stride.  Vectors
    of 16 bytes only where the base is 16-byte aligned, the vector axis is
    contiguous and holds whole vectors, and every other stride is a
    multiple of the vector.  Only a grid of fewer than TARGET_BLOCKS
    blocks is sliced (the kernel keeps a counter for each of its
    blocks)."""
    G, C = int(shape[0]), int(shape[1])
    sg, sc = int(strides[0]), int(strides[1])
    V = 16 // elem
    empty = 0 in tuple(shape[2:])
    dims = [] if empty else [(int(n), int(s)) for n, s in
                             zip(shape[2:], strides[2:]) if n != 1]
    dims += [(1, 0)] * (2 - len(dims))

    def aligned(pairs):
        return ptr % 16 == 0 and all(n == 1 or s % V == 0 for n, s in pairs)

    if sc == 1 and C > 1:
        (rows, rs), (inner, si) = sorted(dims, key=lambda d: -d[0])
        vec = V if C % V == 0 and aligned([(G, sg)] + dims) else 1
        tx = min(_cdiv(C, vec), 32)
        ty = THREADS // tx
        blocks = G * _cdiv(_cdiv(C, vec), tx)
        rows = 0 if empty else rows
        slices, span = _slices(rows, ty, inner, blocks)
        return Plan(1, vec, 1, G, C, sg, sc, rows, rs, inner, si, tx, ty,
                    tx * vec, slices, span, blocks)
    (ncol, cs), (rows, rs) = sorted(dims, key=lambda d: (d[0] == 1,
                                                         abs(d[1])))
    vec = V if (cs == 1 and ncol % V == 0
                and aligned([(G, sg), (C, sc), (rows, rs)])) else 1
    cols = ncol // vec
    rows = 0 if empty else rows
    group = min(THREADS, max(32, 1 << (max(rows * cols // MIN_LOADS, 1)
                                       .bit_length() - 1)))
    walk_rows = cols <= group
    tx, ty = (cols, group // cols) if walk_rows else (group, 1)
    blocks = _cdiv(G * C, THREADS // group)
    slices, span = (_slices(rows, ty, 1, blocks) if walk_rows
                    else _slices(cols, tx, rows, blocks))
    return Plan(0, vec, int(walk_rows), G, C, sg, sc, rows, rs, cols, cs, tx,
                ty, group, slices, span, blocks)


def slice_reads(p: Plan) -> list[list[tuple[int, int]]]:
    """For each slice of ``p``, the (walked index, element offset) of every
    fan-in position one output (K layout) or one channel (C layout) reads,
    in the order the kernel's threads walk them: what the CPU tests check
    a plan against."""
    out = []
    for s in range(p.slices):
        lo, reads = s * p.span, []
        if p.layout == 1:
            hi = min(lo + p.span, p.rows)
            for ty in range(p.ty):
                for r in range(lo + ty, hi, p.ty):
                    reads += [(r, r * p.rs + i * p.cs) for i in range(p.cols)]
        elif p.walk_rows:
            hi = min(lo + p.span, p.rows)
            for ty in range(p.ty):
                for tx in range(min(p.tx, p.cols)):
                    for r in range(lo + ty, hi, p.ty):
                        base = r * p.rs + tx * p.vec * p.cs
                        reads += [(r, base + i) for i in range(p.vec)]
        else:
            hi = min(lo + p.span, p.cols)
            for ty in range(p.ty):
                for r in range(ty, p.rows, p.ty):
                    for tx in range(p.tx):
                        for v in range(lo + tx, hi, p.tx):
                            base = r * p.rs + v * p.vec * p.cs
                            reads += [(v, base + i) for i in range(p.vec)]
        out.append(reads)
    return out


_P = ctypes.c_void_p


@functools.lru_cache(maxsize=4096)
def _launch_plan(shape, strides, elem: int, misalign: int):
    """The plan of a view and its C array, cached: a round scores the same
    views every time (``misalign`` is the base address modulo 16)."""
    p = plan(shape, strides, elem, misalign)
    return p, (ctypes.c_int64 * len(p))(*p)


def _lib():
    lib = _build.library("group_norms")
    if lib.group_norms_sq.argtypes is None:
        lib.group_norms_sq.argtypes = [_P] * 4 + [ctypes.c_int, _P]
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
    shape, strides = tuple(x.shape), tuple(x.stride())
    if x.ndim == 3:
        shape, strides = shape[:2] + (1,) + shape[2:], \
            strides[:2] + (0,) + strides[2:]
    p, fields = _launch_plan(shape, strides, x.element_size(),
                             x.data_ptr() % 16)
    G, C = shape[:2]
    out = torch.empty((G, C), dtype=torch.float32, device=x.device)
    part = None
    if p.slices > 1:
        part = torch.empty(p.slices * G * C, dtype=torch.float32,
                           device=x.device)
    err = _lib().group_norms_sq(
        x.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None,
        fields, int(x.dtype == torch.bfloat16), _stream(x))
    _build.check(err, what)
    launches[what] += 1
    return out
