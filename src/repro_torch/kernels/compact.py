"""Wrapper of the kept-group gather kernel (``csrc/compact.cu``), the port
of ``repro/kernels/compact.py``'s ``gather_groups``.

``out[r, j*g + k, q] = x[r, idx[s, j]*g + k, q]`` (k < g) on a
contiguous (R, C, Q) view (or (R, C), Q = 1) with an int32 table (S, B/g)
of kept groups of ``g`` channels, slice ``s = (r // slice_rows) % S``:
the payload compaction of the consensus round and of the
reconfiguration's migration.  An index equal to C/g writes zeros, so the
inverse index of a compaction (``ref.inverse_index``) applied to the
compact buffer is the zero-fill expansion, with no padded copy.

:func:`gather_table` gathers many leaves in one launch (a table of up to
CAPACITY leaves, more launches beyond); :func:`gather_groups` is a table
of one.  :func:`plan` chooses each leaf's unit and tiles from its shape,
group size and base addresses alone (a plain function, so the CPU tests
check it), :func:`walk` lists what the kernel's threads copy.  A tensor on
the CPU takes the plain version (``ref.gather_groups_ref``); a CUDA tensor
launches the kernel or raises.  ``launches`` counts launches.
"""
from __future__ import annotations

import array
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build, ref
from .wire import _on_cpu, _stream

launches = {"gather_groups": 0}

# element types the kernel moves (as unsigned integers of their size)
DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.uint8)

CAPACITY = 32      # leaves a launch (csrc kCap)
THREADS = 256      # threads a block
UNITS = 4          # units a thread: a tile is THREADS * UNITS units
TILE = THREADS * UNITS


def fastdiv(d: int) -> tuple[int, int]:
    """(m, s) with ``n // d == ((n * m >> 32) + n) >> s`` for every
    0 <= n < 2**31: the kernel's division by a constant."""
    s = (d - 1).bit_length()
    return ((1 << 32) * ((1 << s) - d)) // d + 1, s


def fdiv(n, ms):
    """The kernel's ``fdiv`` on numpy integers (or a Python int)."""
    m, s = ms
    n = np.asarray(n, np.uint64)
    return ((((n * np.uint64(m)) >> np.uint64(32)) + n) >> np.uint64(s)
            ).astype(np.int64)


class Plan(NamedTuple):
    """One leaf of a launch's table, without its addresses: runs of ``L``
    units of ``unit`` bytes (one run a kept group: g * Q elements), ``R``
    rows of ``Cg`` input and ``Bg`` output groups, an (S, Bg) index table
    read at slice ``(r // P) % S``; ``units`` output units in ``tiles``
    tiles of TILE units."""
    R: int
    Cg: int
    Bg: int
    L: int
    S: int
    P: int
    unit: int
    units: int
    tiles: int


def _widest(nbytes: int, *ptrs: int) -> int:
    """The widest of 16, 8, 4, 2, 1 bytes that divides ``nbytes`` and
    every address."""
    for u in (16, 8, 4, 2):
        if nbytes % u == 0 and all(p % u == 0 for p in ptrs):
            return u
    return 1


def plan(R: int, C: int, Q: int, S: int, B: int, P: int, g: int, elem: int,
         ptrs: tuple[int, int]) -> Plan:
    """The table entry of a gather of (R, C, Q) ``elem``-byte elements
    into (R, B, Q) by an (S, B/g) table of kept groups of ``g`` channels,
    P rows a slice, from ``ptrs`` = (x, out) addresses (modulo 16 is
    enough): the unit is the widest that the run of g·Q·elem bytes and
    both bases allow."""
    if C % g or B % g:
        raise ValueError(f"gather plan: {C} and {B} channels are not whole "
                         f"groups of {g}")
    run = g * Q * elem
    unit = _widest(run, *ptrs)
    L = run // unit
    units = R * (B // g) * L
    if units + TILE >= 1 << 31:
        raise ValueError(f"gather plan: {units} units exceed the kernel's "
                         "32-bit unit arithmetic")
    return Plan(R, C // g, B // g, L, S, P, unit, units, -(-units // TILE))


def tables(plans) -> list[list[tuple[int, int]]]:
    """The launches of ``plans``: [[(plan number, first block)]], at most
    CAPACITY leaves a launch, empty leaves left out."""
    out, cur, first = [], [], 0
    for i, p in enumerate(plans):
        if not p.tiles:
            continue
        if len(cur) == CAPACITY:
            out.append(cur)
            cur, first = [], 0
        cur.append((i, first))
        first += p.tiles
    return out + ([cur] if cur else [])


def leaf_of(block: int, firsts) -> int:
    """The kernel's binary search: the last leaf whose first block is at
    most ``block``."""
    lo, hi = 0, len(firsts) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if firsts[mid] <= block:
            lo = mid
        else:
            hi = mid - 1
    return lo


def walk(p: Plan, tiles, idx) -> tuple[np.ndarray, np.ndarray]:
    """What the threads of ``tiles`` (tile numbers) of leaf ``p`` copy with
    the (S, Bg) table ``idx`` (numpy), as the kernel computes it (its
    fastdiv included): (output units, input units with -1 for a zero).
    What the CPU tests check a plan against."""
    tiles = np.asarray(tiles, np.int64)
    u = (tiles[:, None] * TILE + np.arange(TILE)[None]).reshape(-1)
    u = u[u < p.units]
    q = fdiv(u, fastdiv(p.L))
    l = u - q * p.L
    r = fdiv(q, fastdiv(p.Bg))
    j = q - r * p.Bg
    s = np.zeros_like(r)
    if p.S != 1:
        rp = fdiv(r, fastdiv(p.P))
        s = rp - fdiv(rp, fastdiv(p.S)) * p.S
    c = np.asarray(idx, np.int64).reshape(p.S, p.Bg)[s, j]
    return u, np.where(c < p.Cg, (r * p.Cg + c) * p.L + l, -1)


@functools.lru_cache(maxsize=8192)
def _cached_plan(R, C, Q, S, B, P, g, elem, ptrs):
    """A leaf's plan and its int64 fields after the addresses (its first
    block excepted), cached: a round gathers the same shapes every time
    (``ptrs``: the base addresses modulo 16)."""
    p = plan(R, C, Q, S, B, P, g, elem, ptrs)
    div = [v for d in (p.L, p.Bg, p.P, p.S) for v in fastdiv(d)]
    return p, (p.R, p.Cg, p.Bg, p.L, p.S, p.P, p.unit, p.units), tuple(div)


@functools.lru_cache(maxsize=8192)
def _job(shape, dtype, ishape, slice_rows: int, g: int):
    """(R, C, Q, S, B, element bytes, output shape) of a job, checked once
    for each signature: the dtype, ranks, whole groups and whole
    slices."""
    what = "gather_groups"
    if dtype not in DTYPES or len(shape) not in (2, 3):
        raise ValueError(f"{what}: the CUDA kernel takes an (R, C) or (R, C, "
                         f"Q) tensor of {DTYPES}, got {dtype} {shape}")
    if len(ishape) not in (1, 2):
        raise ValueError(f"{what}: the index must be (B,) or (S, B), got "
                         f"{ishape}")
    R, C = shape[:2]
    Q = shape[2] if len(shape) == 3 else 1
    S, B = (1, ishape[0]) if len(ishape) == 1 else ishape
    if g < 1 or C % g or slice_rows < 1 or R % (S * slice_rows):
        raise ValueError(f"{what}: {shape} is not whole groups of {g} "
                         f"channels, or its rows are not whole slices of "
                         f"{slice_rows} rows times {S} index rows")
    elem = torch.empty((), dtype=dtype).element_size()
    return R, C, Q, S, B * g, elem, (R, B * g) + tuple(shape[2:])


_P = ctypes.c_void_p


def _lib():
    lib = _build.library("compact")
    if lib.gather_table.argtypes is None:
        lib.gather_table.argtypes = [_P, ctypes.c_int, ctypes.c_int64, _P]
        lib.gather_table.restype = ctypes.c_int
    return lib


def gather_table(jobs):
    """jobs: [(x (R, C) or (R, C, Q), idx (B,) or (S, B) int32 kept groups
    in [0, C/g], slice_rows, g)] -> [(R, B*g) or (R, B*g, Q)], zeros where
    the index is C/g; one launch of the kernel for every CAPACITY leaves.
    Every job reads its input as the caller passed it: a gather that
    needs another's output (a leaf sliced twice by one rule) goes to a
    later call."""
    jobs = list(jobs)
    if not jobs:
        return []
    if _on_cpu("gather_groups", jobs[0][0]):
        return [ref.gather_groups_ref(x, i, p, g) for x, i, p, g in jobs]
    dev = jobs[0][0].device
    outs, plans, rows = [], [], []
    for x, idx, p, g in jobs:
        R, C, Q, S, B, elem, oshape = _job(x.shape, x.dtype, idx.shape, p, g)
        if not (x.is_contiguous() and idx.is_contiguous()) \
                or idx.dtype != torch.int32 or x.device != dev \
                or idx.device != dev:
            raise ValueError(
                f"gather_groups: the CUDA kernel takes contiguous operands "
                f"on {dev} and an int32 index, got {tuple(x.shape)} on "
                f"{x.device} (contiguous: {x.is_contiguous()}) and "
                f"{idx.dtype} {tuple(idx.shape)} on {idx.device}")
        out = torch.empty(oshape, dtype=x.dtype, device=dev)
        xp, op = x.data_ptr(), out.data_ptr()
        pl, head, div = _cached_plan(R, C, Q, S, B, p, g, elem,
                                     (xp % 16, op % 16))
        outs.append(out)
        plans.append(pl)
        rows.append(((xp, op, idx.data_ptr()) + head, div))
    lib, stream = _lib(), _stream(jobs[0][0])
    for table in tables(plans):
        fields = []
        for i, first in table:
            head, div = rows[i]
            fields += head + (first,) + div
        blocks = table[-1][1] + plans[table[-1][0]].tiles
        arr = array.array("q", fields)   # 5x faster to build than ctypes'
        err = lib.gather_table(arr.buffer_info()[0], len(table), blocks,
                               stream)
        _build.check(err, "gather_groups")
        launches["gather_groups"] += 1
    return outs


def gather_groups(x, idx, *, slice_rows: int = 1):
    """x: (R, C) or (R, C, Q), idx: (B,) or (S, B) int32 in [0, C] ->
    (R, B) or (R, B, Q), zeros where the index is C; R must be a multiple
    of S * slice_rows.  A table of one."""
    return gather_table([(x, idx, slice_rows, 1)])[0]
