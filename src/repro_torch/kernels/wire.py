"""Wrappers of the wire-format kernels (``csrc/wire.cu``), the port of
``repro/kernels/wire.py``'s three q8 kernels and its three q4 kernels:

  * :func:`quantize_rows` — per-row symmetric int8 (the q8 ring);
  * :func:`gather_quantize` — kept-column gather fused with it
    (``Q8Codec.encode_compact``);
  * :func:`gather_dequantize` — gather + dequantize (``Q8Codec.decode``
    through :func:`dequantize_rows`, its identity, and ``decode_expand``
    with an inverse index whose dropped columns read as zeros);
  * :func:`quantize_pack_q4_table` — per-row q4 quantize + nibble pack of
    many leaves in one launch (the q4 ring); :func:`quantize_pack_q4` is a
    table of one (``Q4Codec.encode``);
  * :func:`gather_quantize_q4` — kept-column gather fused with it
    (``Q4Codec.encode_compact``);
  * :func:`unpack_gather_dequantize_q4` — nibble unpack + gather in the
    unpacked space + dequantize (``Q4Codec.decode`` through
    :func:`unpack_dequantize_q4`, its identity, and ``decode_expand``).

Scale granularity is one f32 scale per ROW of the (R, C) view — a
function of the leaf shape, so ``wire_bytes`` stays analytic.
:func:`quantize_plan` chooses ``quantize_rows``'s launch from the row
width and the base address, :func:`q4_plan` each leaf's of
``quantize_pack_q4``, which encodes many leaves in one launch
(:func:`quantize_pack_q4_table`); the fused gather encodes run the same
row engines over their kept columns, with the plans
:func:`gather_quantize_plan` and :func:`gather_quantize_q4_plan`, and the
decodes take the same row plan over their output columns
(:func:`gather_dequantize_plan`, :func:`unpack_gather_dequantize_q4_plan`).
All are plain functions, so the CPU tests check them.  A tensor on the CPU
takes the plain version (``kernels/ref.py``); a CUDA tensor launches the
kernel or raises.
``launches`` counts launches.  The q8 gather kernels take int32
indices, as the TPU kernels do; the q4 ones int64.  The decodes take one
index value more than the TPU kernels: Cq (q8) or 2 Cp (q4) writes
``0 * s``, so the zero-fill expansion needs no padded copy of the payload.
"""
from __future__ import annotations

import array
import ctypes
import functools

import torch

from . import _build, ref

launches = {"quantize_rows": 0, "gather_quantize": 0, "gather_dequantize": 0,
            "quantize_pack_q4": 0, "gather_quantize_q4": 0,
            "unpack_gather_dequantize_q4": 0}

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _lib():
    lib = _build.library("wire")
    if lib.quantize_rows_f32.argtypes is None:
        for name, args in (
                ("quantize_rows_f32",
                 [_P, _P, _P, _I64, _I64] + [_INT] * 4 + [_P]),
                ("quantize_rows_bf16",
                 [_P, _P, _P, _I64, _I64] + [_INT] * 4 + [_P]),
                ("gather_quantize_f32", [_P] * 4 + [_I64] * 3 + [_INT] * 5
                 + [_P]),
                ("gather_dequantize_f32", [_P] * 4 + [_I64] * 3
                 + [_INT] * 5 + [_P]),
                ("quantize_pack_q4_table", [_P, _INT, _I64, _P]),
                ("gather_quantize_q4_f32", [_P] * 4 + [_I64] * 3
                 + [_INT] * 4 + [_P]),
                ("unpack_gather_dequantize_q4_f32",
                 [_P] * 4 + [_I64] * 3 + [_INT] * 5 + [_P])):
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


def _levels(what: str, levels: int) -> None:
    if not 0 < levels <= 127:
        raise ValueError(f"{what}: levels {levels} outside (0, 127]")


QUANT_NV = (1, 2, 3, 4, 6)   # vectors a lane holds: the kernel's set
# a view of fewer vectors than this (one per thread the H100's 132 SMs
# hold at once) is latency-bound: it takes one vector a lane; a larger
# one keeps up to QUANT_NV[-1] a lane in flight
QUANT_SMALL = 132 * 2048


def _lanes(R: int, nvec: int) -> tuple[int, int]:
    """(lanes, nv) for ``R`` rows of ``nvec`` vectors: the fewest lanes a
    row (a power of two up to 256) that leave each at most one vector (a
    view under QUANT_SMALL vectors) or QUANT_NV[-1] (a larger one), and
    the least count of QUANT_NV that covers a lane's share; rows that need
    more than QUANT_NV[-1] vectors a lane at 256 lanes stream (32, 0)."""
    per_max = 1 if R * nvec < QUANT_SMALL else QUANT_NV[-1]
    lanes = min(256, 1 << (max(-(-nvec // per_max), 1) - 1).bit_length())
    per = -(-nvec // lanes)
    if per > QUANT_NV[-1]:
        return 32, 0
    return lanes, min(n for n in QUANT_NV if n >= per)


def quantize_plan(R: int, C: int, ptr: int,
                  elem: int = 4) -> tuple[int, int, int]:
    """(lanes, nv, vec) of ``quantize_rows`` on ``R`` rows of ``C``
    elements of ``elem`` bytes (4: f32, 2: bf16) from address ``ptr``:
    vectors of four (vec 4: one 16- or 8-byte load) where C % 4 == 0 and
    the base is aligned to a vector, else single elements; lanes and
    vectors a lane as :func:`_lanes` chooses them (nv 0 streams, with
    lanes 32)."""
    vec = 4 if C % 4 == 0 and ptr % (4 * elem) == 0 else 1
    return _lanes(R, C // vec) + (vec,)


Q4_CAPACITY = 64   # leaves a launch of the q4 table kernel (csrc kQ4Cap)


def q4_plan(R: int, C: int, xptr: int, pptr: int) -> tuple[int, int, int]:
    """(lanes, nv, vec) of one leaf of ``quantize_pack_q4``: vectors of
    four floats (16-byte loads, two packed bytes stored) where C % 4 == 0,
    x is 16-byte and p 2-byte aligned, else pairs of columns (one packed
    byte; an odd C's last pair holds one column); lanes and vectors a
    lane as quantize_rows takes them (:func:`_lanes`)."""
    vec = 4 if C % 4 == 0 and xptr % 16 == 0 and pptr % 2 == 0 else 2
    return _lanes(R, -(-C // vec)) + (vec,)


def q4_blocks(R: int, lanes: int, nv: int) -> int:
    """Blocks of 256 threads one leaf takes: 256 / lanes rows a block, or
    eight (one warp a row) where it streams."""
    return -(-R // 8) if nv == 0 else -(-R * lanes // 256)


@functools.lru_cache(maxsize=4096)
def _q4_leaf(R: int, C: int, xmis: int, pmis: int) -> tuple[int, ...]:
    """(lanes, nv, vec, blocks) of one leaf, cached: a round encodes the
    same shapes every time (``xmis``, ``pmis``: the addresses modulo
    16)."""
    plan = q4_plan(R, C, xmis, pmis)
    return plan + (q4_blocks(R, *plan[:2]),)


def _runs(vec: int, C: int, xptr: int) -> int:
    """1 where a vector of four kept columns that are one run from a
    multiple of 4 may be read with one 16-byte load: vectors of four, C %
    4 == 0 and x 16-byte aligned (then every row is)."""
    return int(vec == 4 and C % 4 == 0 and xptr % 16 == 0)


def gather_quantize_plan(R: int, B: int, C: int,
                         xptr: int) -> tuple[int, int, int, int]:
    """(lanes, nv, vec, runs) of ``gather_quantize`` on ``R`` rows of
    ``B`` kept columns of an (R, C) x at address ``xptr``: vectors of
    four output columns (vec 4: their kept columns read with one 16-byte
    load where they are one run from a multiple of 4 and ``runs`` is 1,
    as the kernel decides on the device, else one load each; a char4
    stored) where B % 4 == 0, else single columns; lanes and vectors a
    lane over the B columns as quantize_rows takes them (:func:`_lanes`;
    nv 0 streams, with lanes 32)."""
    vec = 4 if B % 4 == 0 else 1
    return _lanes(R, B // vec) + (vec, _runs(vec, C, xptr))


def gather_quantize_q4_plan(R: int, B: int, C: int,
                            xptr: int) -> tuple[int, int, int, int]:
    """(lanes, nv, vec, runs) of ``gather_quantize_q4``, as
    :func:`gather_quantize_plan` chooses them, with pairs of columns (vec
    2, one packed byte; an odd B's last pair holds one column) where B %
    4 != 0; vectors of four store two packed bytes."""
    vec = 4 if B % 4 == 0 else 2
    return _lanes(R, -(-B // vec)) + (vec, _runs(vec, C, xptr))


@functools.lru_cache(maxsize=4096)
def _encode_plan(q4: bool, R: int, B: int, C: int,
                 xmis: int) -> tuple[int, int, int, int]:
    """A fused encode's plan, cached (``xmis``: x's address modulo 16)."""
    return (gather_quantize_q4_plan if q4 else gather_quantize_plan)(
        R, B, C, xmis)


def _stage_unit(row_bytes: int, ptr: int) -> int:
    """The widest load (16 or 4 bytes) that copies payload rows of
    ``row_bytes`` from address ``ptr`` aligned (then every row is), or 0:
    rows that only byte loads copy are read in place."""
    return next((u for u in (16, 4) if row_bytes % u == 0 and ptr % u == 0),
                0)


def _decode_plan_of(R: int, Cout: int, row_bytes: int, run_bytes: int,
                    ptr: int, outptr: int,
                    index: bool) -> tuple[int, int, int, int, int]:
    """(lanes, nv, vec, runs, unit) of a decode whose payload rows are
    ``row_bytes`` wide from ``ptr`` and take ``run_bytes`` a run of four
    columns: see :func:`gather_dequantize_plan`."""
    vec = 4 if Cout % 4 == 0 and outptr % 16 == 0 else 1
    lanes, nv = _lanes(R, Cout // vec)
    unit = _stage_unit(row_bytes, ptr) if index and nv and \
        row_bytes <= Cout else 0
    runs = int(vec == 4 and row_bytes % run_bytes == 0
               and (unit > 0 or ptr % run_bytes == 0))
    return lanes, nv, vec, runs, unit


def gather_dequantize_plan(R: int, Cout: int, Cq: int, qptr: int,
                           outptr: int, index: bool = True
                           ) -> tuple[int, int, int, int, int]:
    """(lanes, nv, vec, runs, unit) of ``gather_dequantize`` on ``R``
    rows of an (R, Cq) q at address ``qptr`` into ``Cout`` output columns
    at ``outptr`` (``index`` False: the identity, no index): vectors of
    four output columns (vec 4: one float4 stored) where Cout % 4 == 0 and
    out is 16-byte aligned, else single columns; lanes and vectors a lane
    over the Cout columns as quantize_rows takes them (:func:`_lanes`; nv
    0 streams, lanes 32); with an index and rows no wider than Cout bytes
    (an expansion), a block's q rows staged in shared memory with loads of
    ``unit`` bytes (16 or 4, as the row width and base allow; 0: read in
    place); ``runs`` 1 where four q columns that are one run from a
    multiple of 4 may be read with one 4-byte load (vec 4, Cq % 4 == 0, and
    q 4-byte aligned or staged), as the kernel decides on the device."""
    return _decode_plan_of(R, Cout, Cq, 4, qptr, outptr, index)


def unpack_gather_dequantize_q4_plan(R: int, Cout: int, Cp: int, pptr: int,
                                     outptr: int, index: bool = True
                                     ) -> tuple[int, int, int, int, int]:
    """(lanes, nv, vec, runs, unit) of ``unpack_gather_dequantize_q4`` on
    ``R`` rows of an (R, Cp) packed p at ``pptr``, as
    :func:`gather_dequantize_plan` chooses them, the rows Cp bytes wide; a
    run of four nibbles from a multiple of 4 is one 2-byte load of p,
    which needs Cp % 2 == 0 and p 2-byte aligned or staged."""
    return _decode_plan_of(R, Cout, Cp, 2, pptr, outptr, index)


@functools.lru_cache(maxsize=4096)
def _decode_plan(q4: bool, R: int, Cout: int, Cq: int, qmis: int,
                 omis: int, index: bool) -> tuple[int, int, int, int, int]:
    """A decode's plan, cached (``qmis``, ``omis``: the payload's and the
    output's addresses modulo 16)."""
    return (unpack_gather_dequantize_q4_plan if q4 else
            gather_dequantize_plan)(R, Cout, Cq, qmis, omis, index)


def quantize_rows(x, *, levels: int = 127):
    """x: (R, C) float32 or bfloat16 -> (q int8 (R, C), scale f32 (R,
    1)); bf16 rows are read as f32 (exactly), so both give the same
    result."""
    if _on_cpu("quantize_rows", x):
        return ref.quantize_rows_ref(x, levels)
    bf16 = x.dtype == torch.bfloat16
    _check("quantize_rows", x, torch.bfloat16 if bf16 else torch.float32,
           x.device, 2)
    _levels("quantize_rows", levels)
    R, C = x.shape
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    s = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    lanes, nv, vec = quantize_plan(R, C, x.data_ptr(), x.element_size())
    fn = _lib().quantize_rows_bf16 if bf16 else _lib().quantize_rows_f32
    err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), R, C, levels, lanes,
             nv, vec, _stream(x))
    _build.check(err, "quantize_rows")
    launches["quantize_rows"] += 1
    return q, s


def gather_quantize(x, idx, *, levels: int = 127):
    """x: (R, C) float32, idx: (B,) int32 in [0, C) -> the q8 encode of
    ``x[:, idx]``: (q int8 (R, B), scale f32 (R, 1))."""
    if _on_cpu("gather_quantize", x):
        return ref.gather_quantize_ref(x, idx, levels)
    _check("gather_quantize", x, torch.float32, x.device, 2)
    _check("gather_quantize (idx)", idx, torch.int32, x.device, 1)
    _levels("gather_quantize", levels)
    R, C = x.shape
    B = idx.shape[0]
    q = torch.empty((R, B), dtype=torch.int8, device=x.device)
    s = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    plan = _encode_plan(False, R, B, C, x.data_ptr() % 16)
    err = _lib().gather_quantize_f32(x.data_ptr(), idx.data_ptr(),
                                     q.data_ptr(), s.data_ptr(), R, C, B,
                                     levels, *plan, _stream(x))
    _build.check(err, "gather_quantize")
    launches["gather_quantize"] += 1
    return q, s


def _decode(what: str, q4: bool, pay, s, idx, Cout: int):
    """One launch of a decode kernel: ``pay`` (R, Cq) int8 or (R, Cp)
    uint8 packed, ``s`` (R, 1) f32, ``idx`` (Cout,) int32 (q8) or int64
    (q4), or None for the identity over the first Cout columns -> f32 (R,
    Cout)."""
    dev = pay.device
    _check(what, pay, torch.uint8 if q4 else torch.int8, dev, 2)
    _check(f"{what} (scale)", s, torch.float32, dev, 2)
    if idx is not None:
        _check(f"{what} (idx)", idx, torch.int64 if q4 else torch.int32, dev,
               1)
    R, Cq = pay.shape
    if s.shape != (R, 1):
        raise ValueError(f"{what}: scale of shape {tuple(s.shape)}, "
                         f"expected ({R}, 1)")
    if idx is None and Cout > (2 * Cq if q4 else Cq):
        raise ValueError(f"{what}: {Cout} columns from a payload of {Cq}")
    out = torch.empty((R, Cout), dtype=torch.float32, device=dev)
    plan = _decode_plan(q4, R, Cout, Cq, pay.data_ptr() % 16,
                        out.data_ptr() % 16, idx is not None)
    lib = _lib()
    fn = lib.unpack_gather_dequantize_q4_f32 if q4 else \
        lib.gather_dequantize_f32
    err = fn(pay.data_ptr(), s.data_ptr(),
             None if idx is None else idx.data_ptr(), out.data_ptr(), R, Cq,
             Cout, *plan, _stream(pay))
    _build.check(err, what)
    launches[what] += 1
    return out


def gather_dequantize(q, s, idx):
    """q: (R, Cq) int8, s: (R, 1) float32, idx: (Cout,) int32 in [0, Cq]
    -> float32 (R, Cout) = ``q[:, idx] * s``, where index Cq reads as a
    zero column (``0 * s``)."""
    if _on_cpu("gather_dequantize", q):
        return ref.gather_dequantize_ref(q, s, idx)
    return _decode("gather_dequantize", False, q, s, idx, idx.shape[0])


def dequantize_rows(q, s):
    """q: (R, C) int8, s: (R, 1) float32 -> float32 (R, C) = ``q * s``:
    the ``gather_dequantize`` kernel without an index."""
    if _on_cpu("gather_dequantize", q):
        return ref.dequantize_rows_ref(q, s)
    return _decode("gather_dequantize", False, q, s, None, q.shape[1])


def quantize_pack_q4_table(xs):
    """xs: [(R, C) float32] -> [(packed uint8 (R, ceil(C/2)), scale f32
    (R, 1))], every leaf in one launch (one more for every Q4_CAPACITY
    leaves).  The packed bytes and the scales of all leaves lie in one
    flat buffer each (every leaf's bytes 16-byte aligned), viewed per
    leaf; an odd C carries one zero pad nibble."""
    xs = list(xs)
    if not xs:
        return []
    if _on_cpu("quantize_pack_q4", xs[0]):
        return [ref.quantize_pack_q4_ref(x) for x in xs]
    dev = xs[0].device
    offs, p_end, s_end = [], 0, 0
    for x in xs:
        _check("quantize_pack_q4", x, torch.float32, dev, 2)
        R, C = x.shape
        offs.append((p_end, s_end))
        p_end += -(-R * ((C + 1) // 2) // 16) * 16
        s_end += R
    p_all = torch.empty(p_end, dtype=torch.uint8, device=dev)
    s_all = torch.empty(s_end, dtype=torch.float32, device=dev)
    outs, rows = [], []
    for x, (po, so) in zip(xs, offs):
        R, C = x.shape
        p = p_all[po:po + R * ((C + 1) // 2)].view(R, (C + 1) // 2)
        s = s_all[so:so + R].view(R, 1)
        outs.append((p, s))
        if R and C:
            *plan, blocks = _q4_leaf(R, C, x.data_ptr() % 16,
                                     p.data_ptr() % 16)
            rows.append(([x.data_ptr(), p.data_ptr(), s.data_ptr(), R, C]
                         + plan, blocks))
    lib, stream = _lib(), _stream(xs[0])
    for k in range(0, len(rows), Q4_CAPACITY):
        fields, first = [], 0
        for head, blocks in rows[k:k + Q4_CAPACITY]:
            fields += head + [first]
            first += blocks
        arr = array.array("q", fields)   # 5x faster to build than ctypes'
        err = lib.quantize_pack_q4_table(arr.buffer_info()[0],
                                         len(fields) // 9, first, stream)
        _build.check(err, "quantize_pack_q4")
        launches["quantize_pack_q4"] += 1
    return outs


def quantize_pack_q4(x):
    """x: (R, C) float32 -> (packed uint8 (R, ceil(C/2)), scale f32
    (R, 1)); an odd C carries one zero pad nibble.  A table of one."""
    return quantize_pack_q4_table([x])[0]


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
    plan = _encode_plan(True, R, B, C, x.data_ptr() % 16)
    err = _lib().gather_quantize_q4_f32(x.data_ptr(), idx.data_ptr(),
                                        p.data_ptr(), s.data_ptr(), R, C, B,
                                        *plan, _stream(x))
    _build.check(err, "gather_quantize_q4")
    launches["gather_quantize_q4"] += 1
    return p, s


def unpack_gather_dequantize_q4(p, s, idx):
    """p: (R, Cp) uint8, s: (R, 1) float32, idx: (Cout,) int64 into the
    unpacked channel space [0, 2*Cp], where 2*Cp reads as a zero nibble
    -> float32 (R, Cout)."""
    if _on_cpu("unpack_gather_dequantize_q4", p):
        return ref.unpack_gather_dequantize_q4_ref(p, s, idx)
    return _decode("unpack_gather_dequantize_q4", True, p, s, idx,
                   idx.shape[0])


def unpack_dequantize_q4(p, s, n: int):
    """p: (R, Cp) uint8, s: (R, 1) float32 -> float32 (R, n), the first n
    nibbles of each row times its scale: the
    ``unpack_gather_dequantize_q4`` kernel without an index."""
    if _on_cpu("unpack_gather_dequantize_q4", p):
        return ref.unpack_dequantize_q4_ref(p, s, n)
    return _decode("unpack_gather_dequantize_q4", True, p, s, None, n)
