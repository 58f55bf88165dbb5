"""The fused compact encodes' operands, kept sets and launch plans,
shared by the port's CPU tests and its card tests (no JAX here: the
card's machine has none)."""
from __future__ import annotations

import numpy as np

from repro_torch.kernels import wire


def codec_views(arch: str = "resnet18", lead: int = 4) -> list:
    """``shrinkage.compact_encode_views`` of the arch's full-width model at
    the default mask budgets: [(key, R, C, B, rule)] of every
    encode_compact call on a tree of ``lead`` members (shapes only)."""
    from repro_torch.configs import get_config
    from repro_torch.core.masks import MaskSyncConfig, budget
    from repro_torch.core.shrinkage import compact_encode_views
    from repro_torch.models import build
    b = build(get_config(arch))
    budgets = {r.name: budget(r, MaskSyncConfig()) for r in b.plan.rules}
    return compact_encode_views(b.shapes, b.plan, budgets, lead)


def kept_index(kind: str, C: int, B: int, seed: int, g: int = 8):
    """B kept columns (int64) of C: "groups", random whole groups of g as
    the rules keep them, sorted; "broken", the same with one vector's run
    broken inside (two columns swapped); "off4", runs of g from 2 past a
    multiple of 4; "cols", sorted single columns; "unsorted", single
    columns in random order."""
    rng = np.random.default_rng(seed)
    if kind == "cols":
        return np.sort(rng.choice(C, B, replace=False)).astype(np.int64)
    if kind == "unsorted":
        return rng.permutation(C)[:B].astype(np.int64)
    shift = 2 if kind == "off4" else 0
    k = np.sort(rng.choice((C - shift) // g, B // g, replace=False))
    idx = (k[:, None] * g + np.arange(g)).reshape(-1) + shift
    if kind == "broken":
        idx[[1, 2]] = idx[[2, 1]]
    return idx.astype(np.int64)


def check_encode_plan(plan, R, B, C, ptr, q4):
    """A fused encode's plan: vectors of four output columns where B % 4
    == 0 (else single columns, or pairs for q4); 16-byte runs only with
    vectors of four, C % 4 == 0 and an aligned base; lanes and vectors a
    lane as the quantizer takes them over the B columns; the registers
    cover the row, or it streams past 6 vectors a lane at 256 lanes.
    Returns (lanes, nv, vec, runs)."""
    lanes, nv, vec, runs = plan(R, B, C, ptr)
    assert vec == (4 if B % 4 == 0 else 2 if q4 else 1)
    assert runs == int(vec == 4 and C % 4 == 0 and ptr % 16 == 0)
    nvec = -(-B // vec)
    assert (lanes, nv) == wire._lanes(R, nvec)
    assert lanes in (1, 2, 4, 8, 16, 32, 64, 128, 256)
    if nv:
        assert nv in wire.QUANT_NV and lanes * nv * vec >= B
        assert B <= 256 * 6 * 4     # the columns a block stages (24 KB)
    else:
        assert lanes == 32 and nvec > 256 * wire.QUANT_NV[-1]
    return lanes, nv, vec, runs


def check_decode_plan(plan, R, Cout, Cq, ptr, optr, q4, index=True):
    """A decode's plan over ``Cout`` output columns of an (R, Cq) payload
    at ``ptr`` (Cq bytes a row; q4: Cp packed bytes) into an output at
    ``optr`` (``index`` False: the identity): vectors of four columns
    where Cout % 4 == 0 and the output is 16-byte aligned, else single
    columns; lanes and vectors a lane as the quantizer takes them over
    the output columns, the registers covering the row, or it streams
    past 6 vectors a lane at 256 lanes; with an index, rows held in
    registers and payload rows no wider than Cout bytes, the block's rows
    staged with the widest aligned load, 16 or 4 bytes (else unit 0);
    one-load runs (4 bytes of q, 2 of p) only with vectors of four and
    payload rows that keep each run aligned where the kernel reads them.
    Returns (lanes, nv, vec, runs, unit)."""
    lanes, nv, vec, runs, unit = plan(R, Cout, Cq, ptr, optr, index)
    assert vec == (4 if Cout % 4 == 0 and optr % 16 == 0 else 1)
    nvec = Cout // vec
    assert (lanes, nv) == wire._lanes(R, nvec)
    assert lanes in (1, 2, 4, 8, 16, 32, 64, 128, 256)
    if nv:
        assert nv in wire.QUANT_NV and lanes * nv * vec >= Cout
        assert Cout <= 256 * 6 * 4     # the index a block stages (24 KB)
    else:
        assert lanes == 32 and nvec > 256 * wire.QUANT_NV[-1]
    if index and nv and Cq <= Cout and Cq % 4 == 0 == ptr % 4:
        assert unit in (16, 4) and Cq % unit == 0 and ptr % unit == 0
        assert unit == 16 or Cq % 16 or ptr % 16
        assert 256 // lanes * Cq <= 6 * 1024    # the rows a block stages
    else:
        assert unit == 0
    run = 2 if q4 else 4
    assert runs == int(vec == 4 and Cq % run == 0
                       and (unit > 0 or ptr % run == 0))
    return lanes, nv, vec, runs, unit
