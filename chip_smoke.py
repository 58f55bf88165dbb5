#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (into ``build/kernels/``), one nvcc per source,
   all at once;
2. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes (prox-SGD: every resnet18 leaf at W=16, relative
   error <= 1e-6; quantize_rows and the three q4 kernels: every compact
   inter-node payload leaf, plus odd-C, 1-D and NaN/inf rows, bit-equal),
   and time kernel, plain version and the bytes bound;
3. train full-width ResNet-18 with H-SADMM through the port's ``train``:
   16 workers stacked on the card, levels (4, 4), compact+q8 inter-node
   wire, 32 images per worker, 6 rounds of 8 local steps, masks frozen at
   round 3; the kernel launch counts are zeroed just before and read just
   after, and must be 62 x 8 prox and 62 quantize launches per round;
3c. the q4 codec API (``get_codec("compact+q4")``: encode/decode and
   encode_compact/decode_expand) on every leaf of phase 3's consensus z
   with its frozen masks, counts zeroed before and read after, each
   result against the plain versions and within half a quantum;
5. one more round of phase 3's path under ``torch.profiler``: device time
   by kernel and the device's busy share;
3b. the same model trained with physical reconfiguration over the
   compact+q4 inter-node wire: 8 rounds, masks frozen at round 3, the
   whole state migrated onto the budget-B ResNet (stem 32, stages
   32/64/128/256) before round 4; 62 x 8 prox and 62 q4 quantize launches
   and no q8 launch per round; per-round walls, bytes and peak memory
   before and after the reconfiguration;
5b. one more reconfigured round under the profiler;
4. one resnet-smoke round on the card and on the CPU from the same state
   (the kernels in context against the plain versions);
4b. the same for one reconfigured resnet-smoke round over compact+q4.

It prints one fact per line, then the card's name and power limit, a
``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
PROX_SRC = "src/repro_torch/kernels/csrc/fused_prox_sgd.cu"
WIRE_SRC = "src/repro_torch/kernels/csrc/wire.cu"


def say(*parts):
    print(*parts, flush=True)


def fail(msg: str) -> int:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up,
    from CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_events(fn, reps: int):
    """Device-side (kernel) events of ``reps`` runs of ``fn()`` after one
    warm-up, from ``torch.profiler``; [] when it records none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def kernel_ms(fn, reps: int) -> tuple[float, float]:
    """(device ms, stream ms) per run of ``fn()``: the summed duration of
    the kernels it launches (profiler), and the CUDA-event time of the
    whole sequence, host gaps between launches included.  Raises when the
    profiler records no device events: the stream time is no device
    time."""
    stream = cuda_ms(fn, reps)
    evs = device_events(fn, reps)
    if not evs:
        raise RuntimeError("the profiler recorded no device events")
    return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / reps, stream


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = nops / F32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check_prox(torch, shapes, W, dev):
    """Both prox-SGD entries vs the plain version on every leaf shape at
    W workers; returns the kernels-line entries."""
    from repro_torch.kernels import fused_prox_sgd as fp
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(1)
    leaves = []
    for shape in shapes.values():
        full = (W,) + tuple(shape)
        R, C = ops._rc(full)
        xs = [torch.randn((R, C), generator=gen, device=dev)
              for _ in range(5)]
        rho = torch.full((1, 1), 1e-3, device=dev).expand(R, 1)
        leaves.append((xs, rho))
    eta = torch.full((1, 1), 1e-2, device=dev)
    err_dyn = err_sc = rel = 0.0
    for xs, rho in leaves:
        t, m = fp.fused_prox_sgd_dyn(*xs, rho, eta, momentum=0.9)
        tp, mp = ref.fused_prox_sgd_ref(*xs, eta=eta, rho=rho, momentum=0.9)
        t2, m2 = fp.fused_prox_sgd(*xs, eta=1e-2, rho=1e-3, momentum=0.9)
        tq, mq = ref.fused_prox_sgd_ref(*xs, eta=1e-2, rho=1e-3,
                                        momentum=0.9)
        for k, p in ((t, tp), (m, mp)):
            d = (k - p).abs().max().item()
            err_dyn = max(err_dyn, d)
            rel = max(rel, d / max(p.abs().max().item(), 1e-30))
        for k, p in ((t2, tq), (m2, mq)):
            d = (k - p).abs().max().item()
            err_sc = max(err_sc, d)
            rel = max(rel, d / max(p.abs().max().item(), 1e-30))
    torch.cuda.synchronize()
    say(f"prox check: {len(leaves)} leaves at W={W}, max abs err "
        f"dyn={err_dyn} scalar={err_sc}, max rel err {rel}")
    if rel > 1e-6:
        raise AssertionError(f"prox kernel vs plain: rel err {rel} > 1e-6")

    n = sum(xs[0].numel() for xs, _ in leaves)
    rows = sum(xs[0].shape[0] for xs, _ in leaves)
    nbytes = 28.0 * n + 4.0 * rows + 4.0     # 5 reads + 2 writes, rho, eta
    b_ms, b_by = bound(nbytes, 8.0 * n)
    out = []
    for name, kern, plain, err in (
            ("fused_prox_sgd_dyn",
             lambda: [fp.fused_prox_sgd_dyn(*xs, r, eta, momentum=0.9)
                      for xs, r in leaves],
             lambda: [ref.fused_prox_sgd_ref(*xs, eta=eta, rho=r,
                                             momentum=0.9)
                      for xs, r in leaves], err_dyn),
            ("fused_prox_sgd",
             lambda: [fp.fused_prox_sgd(*xs, eta=1e-2, rho=1e-3,
                                        momentum=0.9) for xs, _ in leaves],
             lambda: [ref.fused_prox_sgd_ref(*xs, eta=1e-2, rho=1e-3,
                                             momentum=0.9)
                      for xs, _ in leaves], err_sc)):
        (ms, stream), (plain_ms, _) = kernel_ms(kern, 20), kernel_ms(plain, 5)
        say(f"{name}: {len(leaves)} leaves, {n} elements: kernel {ms:.4f} "
            f"ms on the device ({stream:.4f} ms on the stream), plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
        out.append({"name": name, "route": "cuda", "source": PROX_SRC,
                    "replaces": "src/repro/kernels/fused_prox_sgd.py:"
                    + ("72" if name.endswith("dyn") else "40"),
                    "max_abs_err": err, "ms": ms, "stream_ms": stream,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None})
    return out


def check_quantize(torch, payload_shapes, lead, dev):
    """quantize_rows vs the plain version on every compact payload leaf
    as the q8 ring views it: (lead, rows, C)."""
    from repro_torch.kernels import ref, wire
    gen = torch.Generator(device=dev).manual_seed(2)
    xs = []
    for shape in payload_shapes.values():
        v = (lead, math.prod(shape[:-1]) if len(shape) >= 2 else 1,
             shape[-1] if len(shape) >= 1 else 1)
        xs.append(torch.randn((v[0] * v[1], v[2]), generator=gen,
                              device=dev) * 0.05)
    err = 0.0
    for x in xs:
        q, s = wire.quantize_rows(x)
        qp, sp = ref.quantize_rows_ref(x)
        if not (torch.equal(q, qp) and torch.equal(s, sp)):
            raise AssertionError(f"quantize_rows vs plain differ at "
                                 f"{tuple(x.shape)}")
        err = max(err, (q.int() - qp.int()).abs().max().item(),
                  (s - sp).abs().max().item())
    # a payload row holding NaN or inf keeps the plain version's values
    bad = xs[0].clone()
    bad[0, 0], bad[-1, -1] = float("nan"), float("inf")
    q, s = wire.quantize_rows(bad)
    qp, sp = ref.quantize_rows_ref(bad)
    if not torch.equal(q, qp):
        raise AssertionError("quantize_rows vs plain differ on a NaN/inf row")
    torch.testing.assert_close(s, sp, rtol=0, atol=0, equal_nan=True)
    torch.cuda.synchronize()
    say(f"quantize_rows check: {len(xs)} payload leaves bit-equal (max abs "
        f"err {err}), NaN and inf rows equal")
    n = sum(x.numel() for x in xs)
    rows = sum(x.shape[0] for x in xs)
    nbytes = 5.0 * n + 4.0 * rows
    b_ms, b_by = bound(nbytes, 7.0 * n)
    ms, stream = kernel_ms(lambda: [wire.quantize_rows(x) for x in xs], 20)
    plain_ms, _ = kernel_ms(lambda: [ref.quantize_rows_ref(x) for x in xs], 5)
    say(f"quantize_rows: {len(xs)} leaves, {n} elements: kernel {ms:.4f} ms "
        f"on the device ({stream:.4f} ms on the stream), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return [{"name": "quantize_rows", "route": "cuda", "source": WIRE_SRC,
             "replaces": "src/repro/kernels/wire.py:53", "max_abs_err": err,
             "ms": ms, "stream_ms": stream, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}]


def _q4_views(shape, lead):
    """(R, C) view of one payload leaf at ``lead`` members, as the q4 ring
    quantizes it (0-D/1-D leaves are one row per member)."""
    rows = math.prod(shape[:-1]) if len(shape) >= 2 else 1
    return lead * rows, (shape[-1] if len(shape) >= 1 else 1)


def _same(torch, a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _abs_err(torch, a, b) -> float:
    """max |a - b| over the entries finite in both (packed bytes compare
    as integers); 0.0 where there is none."""
    d = (a.double() - b.double()).abs()[torch.isfinite(a) & torch.isfinite(b)]
    return d.max().item() if d.numel() else 0.0


def _equal_q4(torch, a, b, what) -> float:
    """Packed bytes equal, scales equal (NaN where the plain one is);
    returns the max abs difference of bytes and scales."""
    if not _same(torch, a[0], b[0]):
        raise AssertionError(f"{what}: packed bytes differ from the plain "
                             "version")
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=0, equal_nan=True)
    return max(_abs_err(torch, a[0], b[0]), _abs_err(torch, a[1], b[1]))


def check_q4(torch, full_shapes, payload_shapes, lead, dev):
    """The three q4 kernels vs their plain versions, bit for bit, at the
    main paths' shapes, plus odd-C, 1-D and NaN/inf rows; timed.

    quantize_pack_q4: every compact payload leaf at ``lead`` members, as
    the ring views it.  gather_quantize_q4 / unpack_gather_dequantize_q4:
    the codec API's encode_compact / decode_expand of every full-width
    leaf whose minor axis is compacted, at a random kept set of the
    payload's width."""
    from repro_torch.kernels import ops, ref, wire
    gen = torch.Generator(device=dev).manual_seed(3)
    xs = []
    for shape in payload_shapes.values():
        R, C = _q4_views(shape, lead)
        xs.append(torch.randn((R, C), generator=gen, device=dev) * 0.05)
    enc = []     # (x full (R, C), kept idx (B,))
    for key, shape in full_shapes.items():
        cshape = payload_shapes[key]
        if not shape or shape[-1] == cshape[-1]:
            continue
        R, C = _q4_views(shape, lead)
        B = cshape[-1]
        x = torch.randn((R, C), generator=gen, device=dev) * 0.05
        idx = torch.sort(torch.randperm(C, generator=gen, device=dev)[:B]
                         ).values
        enc.append((x, idx))
    # each kernel's max abs difference from its plain version over every
    # comparison below (bytes as integers, scales, decoded values; the
    # entries that are not finite in both are held equal, not measured)
    err = {"quantize_pack_q4": 0.0, "gather_quantize_q4": 0.0,
           "unpack_gather_dequantize_q4": 0.0}

    def note(name, e):
        err[name] = max(err[name], e)

    for x in xs:
        note("quantize_pack_q4",
             _equal_q4(torch, wire.quantize_pack_q4(x),
                       ref.quantize_pack_q4_ref(x),
                       f"quantize_pack_q4 {tuple(x.shape)}"))
    dec = []
    for x, idx in enc:
        p, sc = wire.gather_quantize_q4(x, idx)
        note("gather_quantize_q4",
             _equal_q4(torch, (p, sc), ref.gather_quantize_q4_ref(x, idx),
                       f"gather_quantize_q4 {tuple(x.shape)}"))
        C = x.shape[1]
        pp, inv = ref.expand_operands_q4(p, idx, C)
        out = wire.unpack_gather_dequantize_q4(pp, sc, inv)
        plain = ref.scatter_dequantize_q4_ref(p, sc, idx, C)
        if not _same(torch, out, plain):
            raise AssertionError(f"unpack_gather_dequantize_q4 "
                                 f"{tuple(x.shape)} differs from the plain "
                                 "version")
        note("unpack_gather_dequantize_q4", _abs_err(torch, out, plain))
        if not _same(torch, out, ops.scatter_dequantize_q4(p, sc, idx, C)):
            raise AssertionError("scatter_dequantize_q4 shim differs")
        kept = torch.abs(out[:, idx] - x[:, idx]).max().item()
        if kept > 0.5001 * sc.max().item() or out.abs().sum().item() == 0:
            raise AssertionError(f"q4 round trip error {kept} on "
                                 f"{tuple(x.shape)}")
        dec.append((pp, sc, inv))
    # odd C, 1-D leaves (one row), R not a multiple of the 8-row block,
    # and rows holding NaN or inf
    extra = [torch.randn(shp, generator=gen, device=dev)
             for shp in ((13, 33), (4, 1), (1, 9), (7, 257))]
    bad = torch.randn((13, 10), generator=gen, device=dev)
    bad[1, 3], bad[5, 0], bad[12, 9] = float("nan"), float("inf"), \
        -float("inf")
    for x in extra + [bad]:
        C = x.shape[1]
        p, sc = wire.quantize_pack_q4(x)
        note("quantize_pack_q4",
             _equal_q4(torch, (p, sc), ref.quantize_pack_q4_ref(x),
                       f"quantize_pack_q4 {tuple(x.shape)}"))
        idx = torch.arange(0, C, 2, device=dev)
        note("gather_quantize_q4",
             _equal_q4(torch, wire.gather_quantize_q4(x, idx),
                       ref.gather_quantize_q4_ref(x, idx),
                       f"gather_quantize_q4 {tuple(x.shape)}"))
        ar = torch.arange(C, device=dev)
        out = wire.unpack_gather_dequantize_q4(p, sc, ar)
        plain = ref.unpack_gather_dequantize_q4_ref(p, sc, ar)
        torch.testing.assert_close(out, plain, rtol=0, atol=0,
                                   equal_nan=True)
        note("unpack_gather_dequantize_q4", _abs_err(torch, out, plain))
    torch.cuda.synchronize()
    say(f"q4 check: quantize_pack_q4 on {len(xs)} payload leaves, "
        f"gather_quantize_q4 and unpack_gather_dequantize_q4 on {len(enc)} "
        "compacted leaves, bit-equal to the plain versions; odd-C, 1-D, "
        f"ragged-R and NaN/inf rows equal; max abs err {err}")

    def time_one(name, kern, plain, nbytes, nops, what):
        b_ms, b_by = bound(nbytes, nops)
        ms, stream = kernel_ms(kern, 20)
        plain_ms, _ = kernel_ms(plain, 5)
        say(f"{name}: {what}: kernel {ms:.4f} ms on the device "
            f"({stream:.4f} ms on the stream), plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        return {"name": name, "route": "cuda", "source": WIRE_SRC,
                "replaces": "src/repro/kernels/wire.py:" + {
                    "quantize_pack_q4": "153", "gather_quantize_q4": "179",
                    "unpack_gather_dequantize_q4": "205"}[name],
                "max_abs_err": err[name], "ms": ms, "stream_ms": stream,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}

    n7 = sum(x.numel() for x in xs)
    r7 = sum(x.shape[0] for x in xs)
    p7 = sum(x.shape[0] * ((x.shape[1] + 1) // 2) for x in xs)
    nb = sum(x.shape[0] * idx.shape[0] for x, idx in enc)
    r8 = sum(x.shape[0] for x, _ in enc)
    p8 = sum(x.shape[0] * ((idx.shape[0] + 1) // 2) for x, idx in enc)
    i8 = sum(idx.shape[0] for _, idx in enc)
    n9 = sum(pp.shape[0] * inv.shape[0] for pp, _, inv in dec)
    i9 = sum(inv.shape[0] for _, _, inv in dec)
    return [
        time_one("quantize_pack_q4",
                 lambda: [wire.quantize_pack_q4(x) for x in xs],
                 lambda: [ref.quantize_pack_q4_ref(x) for x in xs],
                 4.0 * n7 + p7 + 4.0 * r7, 7.0 * n7,
                 f"{len(xs)} payload leaves, {n7} elements"),
        time_one("gather_quantize_q4",
                 lambda: [wire.gather_quantize_q4(x, i) for x, i in enc],
                 lambda: [ref.gather_quantize_q4_ref(x, i) for x, i in enc],
                 4.0 * nb + 8.0 * i8 + p8 + 4.0 * r8, 7.0 * nb,
                 f"{len(enc)} leaves, {nb} kept elements"),
        time_one("unpack_gather_dequantize_q4",
                 lambda: [wire.unpack_gather_dequantize_q4(pp, sc, inv)
                          for pp, sc, inv in dec],
                 lambda: [ref.unpack_gather_dequantize_q4_ref(pp, sc, inv)
                          for pp, sc, inv in dec],
                 float(p8) + 4.0 * r8 + 8.0 * i9 + 4.0 * n9, 3.0 * n9,
                 f"{len(dec)} leaves expanded to {n9} elements"),
    ]


def train_full(torch, dev):
    """Phase 3: the main path.  Returns (launch totals, engine, final
    state, shape, report, peak device bytes)."""
    from repro_torch.configs import (ConsensusSpec, HsadmmConfig,
                                     ShapeConfig, get_config)
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.train.engine import Engine
    from repro_torch.train.loop import RunConfig, train

    hp = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=8, t_freeze=3,
                      wire_inter="compact+q8")
    cfg = get_config("resnet18").replace(hsadmm=hp)
    shape = ShapeConfig("chip_smoke", "train", 32, 512)
    eng = Engine(build(cfg), shape,
                 consensus=ConsensusSpec(levels=(4, 4), compact_from_level=1),
                 device=dev)
    say(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    per_round = []

    def snapshot(k, state):   # runs after each round's dispatch
        per_round.append(ops.launch_counts())

    run = RunConfig(outer_iters=6, shape=shape, eta=1e-2, seed=0,
                    metrics_every=1, eval_fn=snapshot, log=None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, rep = train(eng, run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = ops.launch_counts()
    launches = [{k: c[k] - (per_round[i - 1][k] if i else 0) for k in c}
                for i, c in enumerate(per_round)]
    say(f"train: resnet18 full, W=16 levels (4, 4), compact+q8, 32 images "
        f"per worker, {rep.outer_iters} rounds in {wall:.2f} s")
    for k in range(rep.outer_iters):
        say(f"round {k}: {rep.executables[k]} loss={rep.losses[k]:.6f} "
            f"wall_ms={rep.wall_times[k] * 1e3:.1f} "
            f"internode_bytes={rep.comm_bytes_internode[k]} "
            f"launches={launches[k]}")
    say(f"frozen_at: {rep.frozen_at}")
    peak = torch.cuda.max_memory_allocated()
    say(f"max_memory_allocated: {peak} bytes")
    losses = rep.losses
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if not sum(losses[-2:]) < sum(losses[:2]):
        raise AssertionError(f"loss did not fall: {losses}")
    if rep.frozen_at != 3:
        raise AssertionError(f"frozen_at {rep.frozen_at} != 3")
    want_b = [2_861_818] * 3 + [2_860_858] * 3
    if rep.comm_bytes_internode != want_b:
        raise AssertionError(f"bytes {rep.comm_bytes_internode}")
    for k, c in enumerate(launches):
        if c["fused_prox_sgd_dyn"] != 62 * 8 or c["quantize_rows"] != 62:
            raise AssertionError(f"round {k} launches {c}")
    return totals, eng, state, shape, rep, peak


def profile_round(torch, eng, state, shape, label="frozen"):
    """Phases 5 and 5b: one more frozen round of a trained main path under
    the profiler: device time by kernel, and the device's busy share of
    the round's device-side span.  Returns the busy share in percent."""
    from collections import defaultdict
    from repro_torch.data.pipeline import batches, superbatches
    from repro_torch.data.synthetic import make_stream
    sb = next(superbatches(batches(make_stream(
        eng.cfg, shape, eng.workers, device=eng.device)), 8))
    step = eng.round_step_fn(frozen=True)
    eta = torch.tensor(1e-2, device=eng.device)
    t0 = time.perf_counter()
    evs = device_events(lambda: step(state, sb, eta), 1)
    wall = (time.perf_counter() - t0) / 2      # warm-up + profiled run
    if not evs:
        raise RuntimeError("profile: the profiler recorded no device events")
    by_name = defaultdict(lambda: [0.0, 0])
    for e in evs:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    total = sum(v[0] for v in by_name.values())
    # busy = union of the device intervals: events can overlap (kernels on
    # library-internal streams), so their sum can exceed the span
    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in evs):
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    busy /= 1e3
    span = (max(e.time_range.end for e in evs)
            - min(e.time_range.start for e in evs)) / 1e3
    say(f"profile: one {label} round, host wall ~{wall * 1e3:.1f} ms "
        f"(profiler on), device span {span:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / span:.1f}% of the span, idle "
        f"{100 * (1 - busy / span):.1f}%), kernel time summed "
        f"{total:.1f} ms over {len(evs)} device events")
    cats = defaultdict(float)
    for name, (ms, _) in by_name.items():
        low = name.lower()
        if "prox_sgd" in low:
            cats["prox_sgd kernel"] += ms
        elif "quantize_rows" in low:
            cats["quantize_rows kernel"] += ms
        elif "q4" in low:
            cats["q4 wire kernels"] += ms
        elif any(t in low for t in ("conv", "xmma", "gemm", "wgrad",
                                    "dgrad", "cudnn", "sm90", "cutlass")):
            cats["convolution / matmul"] += ms
        elif "reduce" in low:
            cats["reductions"] += ms
        else:
            cats["other elementwise / copies"] += ms
    for cat, ms in sorted(cats.items(), key=lambda t: -t[1]):
        say(f"profile category ({label}): {cat}: {ms:.2f} ms "
            f"({100 * ms / total:.1f}% of summed kernel time)")
    top = sorted(by_name.items(), key=lambda t: -t[1][0])[:12]
    for name, (ms, cnt) in top:
        say(f"profile kernel ({label}): {ms:8.2f} ms x{cnt:5d} "
            f"{name[:100]}")
    return 100 * busy / span


def smoke_round_cpu_vs_card(torch, dev):
    """Phase 4: one resnet-smoke round from one state on the card and on
    the CPU (plain versions); theta and z agree to rtol 1e-4."""
    import numpy as np
    from repro_torch.configs import (ConsensusSpec, HsadmmConfig,
                                     ShapeConfig, get_config)
    from repro_torch.core.hsadmm import EngineSpec, init_state, round_step
    from repro_torch.data.synthetic import make_stream
    from repro_torch.models import build

    hp = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=8,
                      wire_inter="compact+q8")
    cfg = get_config("resnet18", smoke=True).replace(hsadmm=hp)
    b = build(cfg)
    spec = EngineSpec(plan=b.plan, consensus=ConsensusSpec((2, 2), 1),
                      hp=hp, stack_map=tuple(b.stack_map))
    stream = make_stream(cfg, ShapeConfig("s", "train", 16, 16), 4)
    sb = {k: torch.stack([stream.batch_at(s)[k] for s in range(8)])
          for k in ("images", "labels")}
    out = {}
    for d in ("cpu", dev):
        st0 = init_state(b.init(torch.Generator().manual_seed(0), d), spec)
        st, _ = round_step(st0, {k: v.to(d) for k, v in sb.items()},
                           b.train_loss, spec, 1e-2)
        out[str(d)] = st
    cpu, gpu = out["cpu"], out[str(dev)]
    worst = 0.0
    for name, a, g in ([("theta", cpu["theta"], gpu["theta"])]
                       + [(f"z{i}", cpu["z"][i], gpu["z"][i])
                          for i in range(2)]):
        for key in a:
            x, y = a[key].numpy(), g[key].cpu().numpy()
            np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name}/{key}")
            worst = max(worst, float(np.max(np.abs(y - x))))
    for rule in cpu["masks"]:
        if not torch.equal(cpu["masks"][rule]["idx"],
                           gpu["masks"][rule]["idx"].cpu()):
            raise AssertionError(f"mask idx differ for {rule}")
    say(f"smoke round card vs CPU: theta/z within rtol 1e-4 (max abs diff "
        f"{worst}), mask idx equal")


def train_reconfig(torch, dev):
    """Phase 3b: the main path of physical reconfiguration over the
    compact+q4 inter-node wire.  Returns (launch totals, reconfigured
    engine, final state, shape, report, memory facts)."""
    from repro_torch.configs import (ConsensusSpec, HsadmmConfig,
                                     ShapeConfig, get_config)
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.train.engine import Engine
    from repro_torch.train.loop import RunConfig, train

    hp = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=8, t_freeze=3,
                      reconfig_patience=1, wire_inter="compact+q4")
    cfg = get_config("resnet18").replace(hsadmm=hp)
    shape = ShapeConfig("chip_smoke", "train", 32, 512)
    eng = Engine(build(cfg), shape,
                 consensus=ConsensusSpec(levels=(4, 4), compact_from_level=1),
                 device=dev)
    per_round, peaks, held = [], [], []

    def snapshot(k, state):   # runs after each round's dispatch
        per_round.append(ops.launch_counts())
        peaks.append(torch.cuda.max_memory_allocated())
        held.append(torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    run = RunConfig(outer_iters=8, shape=shape, eta=1e-2, seed=0,
                    metrics_every=1, reconfig=True, eval_fn=snapshot,
                    log=None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, rep = train(eng, run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = ops.launch_counts()
    launches = [{k: c[k] - (per_round[i - 1][k] if i else 0) for k in c}
                for i, c in enumerate(per_round)]
    rc = rep.final_engine
    say(f"train reconfig: resnet18 full, W=16 levels (4, 4), compact+q4, "
        f"reconfig patience 1, {rep.outer_iters} rounds in {wall:.2f} s; "
        f"reconfigured widths stem {rc.cfg.cnn_stem} stages "
        f"{rc.cfg.cnn_outs}, "
        f"{sum(math.prod(v) for v in rc.bundle.shapes.values())} parameters")
    for k in range(rep.outer_iters):
        say(f"round {k}: {rep.executables[k]} loss={rep.losses[k]:.6f} "
            f"wall_ms={rep.wall_times[k] * 1e3:.1f} "
            f"internode_bytes={rep.comm_bytes_internode[k]} "
            f"peak_bytes={peaks[k]} held_bytes={held[k]} "
            f"launches={launches[k]}")
    say(f"frozen_at: {rep.frozen_at} reconfigured_at: {rep.reconfigured_at}"
        f" migration {rep.reconfig_seconds * 1e3:.1f} ms (synchronized, "
        f"kept out of the round walls); wire maps {rep.wire_map} -> "
        f"{rep.wire_map_reconfigured}")
    r = rep.reconfigured_at
    mem = {"peak_full": max(peaks[:r]), "peak_migration_round": peaks[r],
           "peak_reconfigured": max(peaks[r + 1:]),
           "held_full": held[r - 1], "held_reconfigured": held[-1]}
    say(f"memory: peak over the full-width rounds {mem['peak_full']} bytes, "
        f"over the migration and the first reconfigured round "
        f"{mem['peak_migration_round']}, over the later reconfigured rounds "
        f"{mem['peak_reconfigured']}; allocated after the last full-width "
        f"round {mem['held_full']}, after the last round "
        f"{mem['held_reconfigured']}")
    losses = rep.losses
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if not sum(losses[-2:]) < sum(losses[:2]):
        raise AssertionError(f"loss did not fall: {losses}")
    want_x = ["dynamic"] * 3 + ["frozen"] + ["reconfigured"] * 4
    if rep.executables != want_x or rep.frozen_at != 3 or r != 4:
        raise AssertionError(f"executables {rep.executables}, frozen_at "
                             f"{rep.frozen_at}, reconfigured_at {r}")
    want_b = [1_463_013] * 3 + [1_462_053] * 5
    if rep.comm_bytes_internode != want_b:
        raise AssertionError(f"bytes {rep.comm_bytes_internode}")
    for k, c in enumerate(launches):
        if c["fused_prox_sgd_dyn"] != 62 * 8 or c["quantize_pack_q4"] != 62 \
                or c["quantize_rows"] != 0:
            raise AssertionError(f"round {k} launches {c}")
    if tuple(state["theta"]["stem"].shape) != (16, 3, 3, 3, 32) \
            or tuple(state["theta"]["fc_w"].shape) != (16, 256, 10):
        raise AssertionError("reconfigured theta shapes "
                             f"{tuple(state['theta']['stem'].shape)} "
                             f"{tuple(state['theta']['fc_w'].shape)}")
    return totals, rc, state, shape, rep, mem


def codec_api(torch, state, plan):
    """Phase 3c: the q4 codec API of ``get_codec("compact+q4")`` on every
    leaf of the trained consensus z[0] (4 node groups): encode_compact /
    decode_expand along the frozen kept channels where a rule compacts
    the leaf's minor axis, encode / decode elsewhere.  Each result equals
    the plain versions' and stays within half a quantum of its input on
    the kept channels, zero on the dropped ones.  Returns the launch
    counts of the run."""
    from repro_torch.comm import get_codec
    from repro_torch.core.shrinkage import compacting_rule
    from repro_torch.core.sparsity import channel_idx
    from repro_torch.kernels import ops, ref
    codec = get_codec("compact+q4")
    z = state["z"][0]
    jobs = []
    for key, x in z.items():
        rule = compacting_rule(plan, key, x.ndim - 2)
        idx = None if rule is None else channel_idx(
            rule, state["masks"][rule.name]["idx"])
        jobs.append((key, x, idx))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs = []
    for key, x, idx in jobs:
        if idx is None:
            pay = codec.encode(x)
            outs.append((pay, codec.decode(pay, like=x)))
        else:
            x2 = x.reshape(-1, x.shape[-1])
            pay = codec.encode_compact(x2, idx)
            outs.append((pay, codec.decode_expand(pay, idx, x.shape[-1],
                                                  like=x2)))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    worst = 0.0
    for (key, x, idx), ((p, sc), out) in zip(jobs, outs):
        R, C = ops._rc(tuple(x.shape))
        x2 = x.reshape(R, C)
        if idx is None:
            pp, sp = ref.quantize_pack_q4_ref(x2)
            plain = ref.unpack_gather_dequantize_q4_ref(
                pp, sp, torch.arange(C, device=x.device))
            kept = torch.ones(C, dtype=torch.bool, device=x.device)
        else:
            pp, sp = ref.gather_quantize_q4_ref(x2, idx)
            plain = ref.scatter_dequantize_q4_ref(pp, sp, idx, C)
            kept = torch.zeros(C, dtype=torch.bool, device=x.device)
            kept[idx] = True
        out2 = out.reshape(R, C)
        if not (_same(torch, p.reshape(pp.shape), pp)
                and torch.equal(sc.reshape(R, 1), sp)
                and torch.equal(out2, plain)):
            raise AssertionError(f"codec API on {key}: differs from the "
                                 "plain versions")
        err = (torch.abs(out2 - x2)[:, kept] / sp).max().item()
        worst = max(worst, err)
        if err > 0.5001 or torch.any(out2[:, ~kept] != 0):
            raise AssertionError(f"codec API on {key}: {err} quanta off, or "
                                 "a dropped channel not zero")
    say(f"codec API: compact+q4 on {len(jobs)} leaves of z[0] "
        f"({sum(i is not None for _, _, i in jobs)} compacted), equal to "
        f"the plain versions, at most {worst:.4f} quanta off on kept "
        f"channels, dropped channels zero; launches {counts}")
    for name in ("gather_quantize_q4", "unpack_gather_dequantize_q4"):
        if counts[name] == 0:
            raise AssertionError(f"the codec API launched no {name}")
    return counts


def _to(tree, dev):
    """A state (dicts and lists of tensors) copied onto ``dev``."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def smoke_reconfig_cpu_vs_card(torch, dev):
    """Phase 4b: one reconfigured resnet-smoke round over compact+q4 from
    one migrated state on the card and on the CPU (plain versions); theta
    and z agree to rtol 1e-4, the mask idx are equal."""
    import numpy as np
    from repro_torch.configs import (ConsensusSpec, HsadmmConfig,
                                     ShapeConfig, get_config)
    from repro_torch.data.pipeline import batches, superbatches
    from repro_torch.data.synthetic import make_stream
    from repro_torch.models import build
    from repro_torch.train.engine import Engine

    hp = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=8,
                      wire_inter="compact+q4")
    cfg = get_config("resnet18", smoke=True).replace(hsadmm=hp)
    shape = ShapeConfig("s", "train", 16, 16)
    levels = ConsensusSpec((2, 2), 1)
    it = superbatches(batches(make_stream(cfg, shape, 4)), 8)
    eng = Engine(build(cfg), shape, consensus=levels, device="cpu")
    eta = torch.tensor(1e-2)
    st = eng.init_state_fn()(0)
    for frozen in (False, False, True):       # masks settle, then freeze
        st, _ = eng.round_step_fn(frozen)(st, next(it), eta)
    sb = next(it)
    out = {}
    for d in ("cpu", dev):
        e = Engine(build(cfg), shape, consensus=levels, device=d)
        e2, st_c = e.reconfigure(_to(st, d))
        out[str(d)], _ = e2.round_step_fn(frozen=True)(
            st_c, _to(sb, d), eta.to(d))
    cpu, gpu = out["cpu"], out[str(dev)]
    worst = 0.0
    for name, a, g in ([("theta", cpu["theta"], gpu["theta"])]
                       + [(f"z{i}", cpu["z"][i], gpu["z"][i])
                          for i in range(2)]):
        for key in a:
            x, y = a[key].numpy(), g[key].cpu().numpy()
            np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name}/{key}")
            worst = max(worst, float(np.max(np.abs(y - x))))
    for rule in cpu["masks"]:
        if not torch.equal(cpu["masks"][rule]["idx"],
                           gpu["masks"][rule]["idx"].cpu()):
            raise AssertionError(f"mask idx differ for {rule}")
    say(f"smoke reconfigured round card vs CPU: stem "
        f"{tuple(cpu['theta']['stem'].shape)}, theta/z within rtol 1e-4 "
        f"(max abs diff {worst}), mask idx equal")


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA card: torch.cuda.is_available() is False")
    try:
        from repro_torch.kernels import _build, ops
        from repro_torch.models import build
        from repro_torch.configs import get_config
        from repro_torch.core.shrinkage import plan_payload_shapes
        from repro_torch.core.masks import MaskSyncConfig, budget
    except ImportError as e:
        return fail(f"the port is not importable next to this script: {e}")
    dev = torch.device("cuda")
    say(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    try:
        t0 = time.perf_counter()
        logs = _build.build_all()
        say(f"phase 1 build: {time.perf_counter() - t0:.2f} s "
            f"({', '.join(sorted(logs))})")
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    say(f"  {name}: {line.strip()}")

        bundle = build(get_config("resnet18"))
        budgets = {r.name: budget(r, MaskSyncConfig()) for r in
                   bundle.plan.rules}
        payload = plan_payload_shapes(bundle.shapes, bundle.plan, budgets)
        kernels = check_prox(torch, bundle.shapes, 16, dev)
        kernels += check_quantize(torch, payload, 4, dev)
        kernels += check_q4(torch, bundle.shapes, payload, 4, dev)
        say("phase 2 kernels vs plain: ok")

        totals, eng, state, shape, rep, peak = train_full(torch, dev)
        say(f"phase 3 train: ok, launches {totals}")

        api = codec_api(torch, state, eng.bundle.plan)
        say("phase 3c q4 codec API: ok")

        busy = profile_round(torch, eng, state, shape)
        del state, eng
        say("phase 5 profile: ok")

        rc_totals, rc_eng, rc_state, _, rc_rep, mem = train_reconfig(torch,
                                                                     dev)
        say(f"phase 3b train with reconfiguration: ok, launches {rc_totals}")

        rc_busy = profile_round(torch, rc_eng, rc_state, shape,
                                label="reconfigured")
        del rc_state, rc_eng
        say("phase 5b profile: ok")

        smoke_round_cpu_vs_card(torch, dev)
        say("phase 4 smoke round card vs CPU: ok")

        smoke_reconfig_cpu_vs_card(torch, dev)
        say("phase 4b smoke reconfigured round card vs CPU: ok")

        # the main paths' end-to-end numbers again, next to the result
        say("summary: round wall_ms "
            f"{[round(w * 1e3, 1) for w in rep.wall_times]}, losses "
            f"{[round(x, 4) for x in rep.losses]}, frozen_at "
            f"{rep.frozen_at}, peak {peak} bytes, device busy {busy:.1f}% "
            "of a frozen round's span")
        say("summary reconfig: round wall_ms "
            f"{[round(w * 1e3, 1) for w in rc_rep.wall_times]}, losses "
            f"{[round(x, 4) for x in rc_rep.losses]}, executables "
            f"{rc_rep.executables}, migration "
            f"{rc_rep.reconfig_seconds * 1e3:.1f} ms, peak full-width "
            f"{mem['peak_full']} / reconfigured {mem['peak_reconfigured']} "
            f"bytes, device busy {rc_busy:.1f}% of a reconfigured round's "
            "span")
    except Exception as e:   # any phase failing fails the run, loudly
        import traceback
        traceback.print_exc()
        return fail(f"{type(e).__name__}: {e}")

    # launches: each kernel's count on the path that runs it (phase 3 for
    # prox-SGD and quantize_rows, 3b for the q4 quantizer, 3c for the
    # codec API's gather and unpack kernels)
    paths = {"quantize_pack_q4": ("3b", rc_totals),
             "gather_quantize_q4": ("3c", api),
             "unpack_gather_dequantize_q4": ("3c", api)}
    for k in kernels:
        path, counts = paths.get(k["name"], ("3", totals))
        k["launches"], k["launches_path"] = counts[k["name"]], path
    for line in smi:
        say(line)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
