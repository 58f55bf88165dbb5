#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py           # every phase
    python3 chip_smoke.py --ssd     # phases 1 and 6 alone (no result line)
    python3 chip_smoke.py --wire    # phase 1 and the quantize_rows,
                                    # quantize_pack_q4, gather_groups and
                                    # group_norms_sq checks at the ResNet
                                    # and Mamba2 operands, the fused
                                    # encodes' at ResNet's (no result line)
    python3 chip_smoke.py --rounds  # phase 1, then phases 3b and 3's
                                    # runs alone, timed (no result line)
    python3 chip_smoke.py --baselines  # phases 1 and 8 alone (no result
                                       # line)

Phases (any failure exits non-zero and prints no result line):

1. build the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (into ``build/kernels/``), one nvcc per source,
   all at once;
2. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes (prox-SGD: every resnet18 leaf at W=16, relative
   error <= 1e-6; quantize_rows and the three q4 kernels: every compact
   inter-node payload leaf, plus odd-C, 1-D and NaN/inf rows (for
   quantize_rows: on each of its paths, and a base 4 bytes off
   alignment; quantize_pack_q4: the 62 leaves in one call, as the q4
   ring encodes them, and each path of its plan), bit-equal;
   gather_groups: one dynamic round's compactions and expansions (one
   launch a rule and direction, the expansions reading index C/g as
   zeros), prime R, B = 1, odd C and int8/uint8/bf16, groups of 8 with
   Q > 1 and S > 1, a base 4 bytes off, a table over one launch's
   capacity, bit-equal; gather_quantize(_q4) and their decodes: the
   codec API's compacted leaves at kept sets of whole groups (the rules')
   and of single columns, odd-C, one-row and NaN/inf rows, the decodes on
   the padded operands (the TPU kernels'), the unpadded ones with the
   zero index (the shims'), without an index and by an arange,
   bit-equal;
   group_norms_sq: one dynamic round's score views, K = 1, K minor, C
   minor, a Mamba2-like view, fan-ins its slices do not divide, an
   unaligned base and bf16, rtol 1e-5 and the same bits twice), and time
   kernel, plain version, library call and bound (for quantize_rows and
   quantize_pack_q4 also per row width beside the plan, for gather_groups
   per run width and per launch, for group_norms_sq per view beside its
   launch plan; the gather's library call is take_along_dim on its
   (R/(S P), S, P, C/g, g Q) view; the decodes' zero-fill shims' whole
   route, every launch it makes summed by kernel);
3. train full-width ResNet-18 with H-SADMM through the port's ``train``:
   16 workers stacked on the card, levels (4, 4), compact+q8 inter-node
   wire, 32 images per worker, 6 rounds of 8 local steps, masks frozen at
   round 3; the kernel launch counts are zeroed just before and read
   after every round: 62 x 8 prox, 62 quantize and 16 gather launches
   (one a rule and direction) per round, and 40 group-norm launches per
   dynamic round;
3a. determinism: phase 3 once more with cuDNN's deterministic switch off
   (timed only: what the switch costs), then once more as the program
   runs it, bit-equal to phase 3 in losses, mask indices after every
   round and the final theta/z;
3c. the q4 codec API (``get_codec("compact+q4")``: encode/decode and
   encode_compact/decode_expand) on every leaf of phase 3's consensus z
   with its frozen masks, counts zeroed before and read after (one
   decode launch a leaf), each result against the plain versions and
   within half a quantum;
3d. the same for the dense and q8 codec API (``compact``,
   ``compact+q8``): dense exact, q8 within half a quantum;
3e. kernel route against plain route: phase 3's first three (dynamic)
   rounds under ``torch.use_deterministic_algorithms``, and again with the
   gather, q8 gather and group-norm wrappers replaced by their plain
   twins: mask indices and theta/z bit-equal, group scores within rtol
   1e-5;
5. one more round of phase 3's path under ``torch.profiler``: device time
   by kernel and the device's busy share;
7a. checkpoints on phase 3's path: 4 rounds with background saves every 2
   rounds (keep 1) into a fresh temporary directory (removed after 7b):
   only step 4 is left, its arrays file holds the state's bytes, and
   ``restore`` of it is bit-equal to the state ``train`` returned in every
   leaf; the save alone (snapshot, write) and the restore are timed on the
   host; then ``train`` to 6 rounds resumes from it twice, bit-equal, with
   phase 3's bytes and launches in each round;
7b. ``restore_elastic`` of that checkpoint into W = 8 at levels (2, 4):
   every leaf equals the saved one or its first rows; one round resumed
   from it, loss finite;
3b. the same model trained with physical reconfiguration over the
   compact+q4 inter-node wire: 8 rounds, masks frozen at round 3, the
   whole state migrated onto the budget-B ResNet (stem 32, stages
   32/64/128/256) before round 4; 62 x 8 prox and one q4 quantize launch
   (all 62 leaves) and no q8 launch per round; per-round walls, bytes and peak memory
   before and after the reconfiguration; then trained again saving every 2
   rounds (keep 1), bit-equal: saving perturbs nothing;
7c. ``train`` to 10 rounds resumes from that run's step-8 checkpoint
   (reconfigured) twice, straight into the budget-B engine (2,797,610
   parameters): reconfigured_at 8, 1,462,053 bytes and one q4 table launch
   a round, bit-equal runs;
5b. one more reconfigured round under the profiler;
4. one resnet-smoke round on the card and on the CPU from the same state
   (the kernels in context against the plain versions);
4b. the same for one reconfigured resnet-smoke round over compact+q4;
7d. phase 3's configuration for 4 rounds without a policy (the walls'
   baseline), under a failure window (worker 3,
   rounds 1-2) times a recovering straggler, then under a straggler scoped
   to coupling class cnn:mid1: every round's weights and class weights
   equal the policy's, losses finite, phase 3's launches; no kernel build
   and one round-function call a round in phase 3 and in these runs
   (``dist.monitor``); one resnet-smoke round with class-scoped weights on
   the card and on the CPU from one state (rtol 1e-4);
6. ssd_chunk_scan against its plain version in f32 and bf16 at phase 6a's
   shape and edge shapes (Q not dividing T, H = 5 with Bt = 1, Q = 64,
   chunks past exp's range): bit-equal (hence within rtol = atol = 2e-4)
   and the same bits on a second launch; timed against the plain version
   and the bound, with the device time of each of its kernels (phase 1
   printed their registers, shared memory and spills);
6a. H-SADMM training of mamba2-780m at full width with 4 of its 48
   layers (213,049,408 parameters, f32) through the port's ``train``: W=4
   at levels (2, 2), compact+q8 inter-node wire, one 4096-token sequence
   per worker, eta 1e-3, 5 rounds of 8 local steps, masks frozen after
   round 2; finite losses, the reference's bytes, per round 32 scan, 136
   prox, 17 quantize and 2 gather launches and 9 group-norm launches in
   a dynamic round; peak memory under 60 GB;
6d. one more frozen round of 6a's path under the profiler, with the
   device time, launches and bytes bound of the hand kernels at its
   operands (group_norms_sq on one dynamic round's score views), and the
   library calls beside group_norms_sq (einsum) and gather_groups
   (take_along_dim, expansions from a padded copy) on one dynamic
   round's operands;
6b. phase 6a again, bit-equal; its first two rounds under
   ``torch.use_deterministic_algorithms``, kernel route against plain
   route, bit-equal as well;
6c. one mamba2 smoke round on the card and on the CPU from one state;
8a. the paper's baselines at full width through
   ``repro_torch.train.baselines``: ``ddp_train``, ``topk_train(rate=0.01)``
   and ``codec_train(codec="q8")``, resnet18, W = 16, 32 images a worker,
   rounds of E = 8 steps, eta 1e-2, seed 0, 3 rounds each, run twice:
   bytes a step 44,695,848 / 14,300,544 / 11,300,186, no hand-written
   kernel launched by the dense and Top-K trainers and one quantize_rows
   launch a leaf and step by the q8 one (counts zeroed just before each
   run), the two runs' losses and final params bit-equal; the median
   steady round (rounds 2-3), images per second, peak memory, and the
   Top-K sparsify's device time (its calls bracketed by CUDA events) as a
   share of a steady Top-K step;
8b. H-SADMM over a compact+topk:0.01 inter-node wire (phase 3's
   configuration otherwise) for 4 rounds, saving at round 4: 224,720
   bytes a dynamic and 223,760 a frozen round, phase 3's prox, gather and
   group-norm launches and no quantize launch; the restore bit-equal in
   every leaf, the 62 wire residuals among them; ``train`` to 5 rounds
   resumed twice, bit-equal, residuals too; the restored state migrated
   onto the budget-B ResNet and one frozen round there, loss finite;
8c. one resnet-smoke DDP round on the card and on the CPU (rtol 1e-4),
   and ``TopKCodec.group_reduce`` on identical inputs: selection and
   residuals bit-equal.

``--wire`` runs phase 1, then phase 2's quantize_rows, quantize_pack_q4
(ResNet only), gather_groups and group_norms_sq checks and times at the
ResNet-18 operands and at Mamba2's (phase 6a's configuration, seeded
synthetic data of the shapes phase 6d records), and phase 2's checks and
times of the codec API's fused encodes and decodes at ResNet's operands;
then the encodes and the decodes (on the zero-fill shims' operands) per
class of leaf size beside their plans, the encodes' four
large leaves at kept sets laid out in other ways (runs of 2 and 4 groups,
the first B columns, all columns), and the q8 encode's two parts alone
on those leaves (quantize_rows without the gather, gather_groups without
the quantizer).

It prints one fact per line, then the card's name and power limit, a
``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
PROX_SRC = "src/repro_torch/kernels/csrc/fused_prox_sgd.cu"
WIRE_SRC = "src/repro_torch/kernels/csrc/wire.cu"
GATHER_SRC = "src/repro_torch/kernels/csrc/compact.cu"
NORMS_SRC = "src/repro_torch/kernels/csrc/group_norms.cu"
SSD_SRC = "src/repro_torch/kernels/csrc/ssd_scan.cu"


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
    warm-up, from ``torch.profiler``; [] when it records none.  The
    profiler keeps only device events that fall inside its host-clock
    window, and the device's clock can sit a little off the host's: a
    window of a few microseconds of kernels then keeps none.  So the
    window is padded on both sides with an idle device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.005)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.005)
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def kernel_ms(fn, reps: int) -> tuple[float, float]:
    """(device ms, stream ms) per run of ``fn()``: the summed duration of
    the kernels it launches (profiler, ``kernel_split``), and the
    CUDA-event time of the whole sequence, host gaps between launches
    included."""
    stream = cuda_ms(fn, reps)
    return sum(v[0] for v in kernel_split(fn, reps).values()), stream


def kernel_split(fn, reps: int) -> dict:
    """{kernel: (device ms, launches) per run of ``fn()``} from one profiler
    window over ``reps`` runs, by kernel name (template arguments kept,
    parameter lists and namespaces dropped): each kernel's mean duration
    times its launches per run.  The profiler can drop an event of a long
    window, so the launches per run are its recorded ones over ``reps``,
    rounded.  A window that records no device events is tried again,
    longer; when four record none, the result is the CUDA-event time of
    the whole sequence under one name that says so (host gaps included,
    so it can only overstate the device time)."""
    for n in range(4):
        evs = device_events(fn, reps << n)
        if evs:
            reps <<= n
            break
    else:
        ms = cuda_ms(fn, reps)
        say(f"profiler: no device events in four windows; timed with CUDA "
            f"events instead ({ms:.4f} ms a run, host gaps included)")
        return {"all kernels (CUDA events, no profiler events)": (ms, 1)}
    out = {}
    for e in evs:
        name = e.name.replace("(anonymous namespace)::", "") \
            .removeprefix("void ").split("(")[0].split("::")[-1]
        ms, n = out.get(name, (0.0, 0))
        out[name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    split = {}
    for k, (ms, n) in out.items():
        per_run = max(1, round(n / reps))
        split[k] = (ms / n * per_run, per_run)
    return split


def ptxas_lines(log: str) -> list[str]:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its registers,
    static shared memory and spill bytes (stores/loads)."""
    import re
    out, name, spill = [], "?", "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), "?"
            g = re.match(r"_ZN(\d+)_GLOBAL__N_", name)
            if g:   # a kernel of the anonymous namespace: its own name
                rest = name[g.end(1) + int(g.group(1)):]
                n = re.match(r"\d+", rest)
                i = n.end() + int(n.group())
                args = rest[i:].split("EE")[0].lstrip("I")
                name = rest[n.end():i] + (
                    "<" + args.replace("13__nv_bfloat16", "bf16").replace(
                        "Lb1", "1").replace("Lb0", "0") + ">"
                    if rest[i:i + 1] == "I" else "")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {m.group(1)} registers, "
                       f"{smem.group(1) if smem else 0} bytes static smem, "
                       f"spill {spill} bytes")
    return out


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


def check_quantize(torch, payload_shapes, lead, dev, label="resnet18"):
    """quantize_rows vs the plain version, bit for bit, on every compact
    payload leaf as the q8 ring views it, (lead * rows, C), and on edge
    cases of each path of ``wire.quantize_plan`` (rows held in registers
    and streamed, 16-byte and scalar loads, a base 4 bytes off alignment)
    with NaN and inf rows; timed over all leaves and per width class."""
    from repro_torch.kernels import ref, wire
    gen = torch.Generator(device=dev).manual_seed(2)
    xs = []
    for shape in payload_shapes.values():
        v = (lead, math.prod(shape[:-1]) if len(shape) >= 2 else 1,
             shape[-1] if len(shape) >= 1 else 1)
        xs.append(torch.randn((v[0] * v[1], v[2]), generator=gen,
                              device=dev) * 0.05)
    edges = []
    for C in (10, 64, 1536, 1537, 4096):
        x = torch.randn((37, C), generator=gen, device=dev)
        x[3, 1], x[5, -1], x[7, 0] = float("nan"), float("inf"), \
            -float("inf")
        edges.append(x)
    buf = torch.randn((37 * 1536 + 1,), generator=gen, device=dev)
    edges.append(buf[1:].view(37, 1536))
    err = 0.0
    for x in xs + edges:
        q, s = wire.quantize_rows(x)
        qp, sp = ref.quantize_rows_ref(x)
        if not torch.equal(q, qp):
            raise AssertionError(f"quantize_rows vs plain differ at "
                                 f"{tuple(x.shape)}")
        torch.testing.assert_close(s, sp, rtol=0, atol=0, equal_nan=True)
        err = max(err, (q.int() - qp.int()).abs().max().item())
    torch.cuda.synchronize()
    say(f"quantize_rows check ({label}): {len(xs)} payload leaves and "
        f"{len(edges)} edge cases (C = 10, 64, 1536, 1537, 4096 with NaN "
        "and inf rows, a base 4 bytes off alignment) bit-equal to the "
        f"plain version (max abs err {err})")
    rows = sum(x.shape[0] for x in xs)
    n = sum(x.numel() for x in xs)
    b_ms, b_by = bound(5.0 * n + 4.0 * rows, 7.0 * n)
    ms, stream = kernel_ms(lambda: [wire.quantize_rows(x) for x in xs], 20)
    plain_ms, _ = kernel_ms(lambda: [ref.quantize_rows_ref(x) for x in xs], 5)
    say(f"quantize_rows ({label}): {len(xs)} leaves, {n} elements: kernel "
        f"{ms:.4f} ms on the device ({stream:.4f} ms on the stream), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{100 * b_ms / ms:.1f}% of it reached)")
    for C in sorted({x.shape[1] for x in xs}):
        cls = [x for x in xs if x.shape[1] == C]
        R = sum(x.shape[0] for x in cls)
        c_ms = sum(v[0] for v in kernel_split(
            lambda: [wire.quantize_rows(x) for x in cls], 20).values())
        c_b, _ = bound(5.0 * R * C + 4.0 * R, 7.0 * R * C)
        how = sorted({wire.quantize_plan(x.shape[0], C, x.data_ptr())
                      for x in cls})
        say(f"quantize_rows ({label}) C = {C}: {len(cls)} leaves, {R} rows, "
            f"plan (lanes, nv, vec) {how}: kernel "
            f"{c_ms:.4f} ms, bound {c_b:.4f} ms ({100 * c_b / c_ms:.1f}% "
            "of it reached)")
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


def _compact_operands(torch, views, gen, dev):
    """[(x (R, C), kept idx (B,) int64, column idx (B,) int64)] of the
    codec API's encode_compact operands ``views``
    (``shrinkage.compact_encode_views``).  The kept idx is what the
    program passes: random whole groups of the compacting rule's group
    size, sorted (as ``topk_mask`` keeps them), in channel units
    (``channel_idx``); the column idx holds as many single random
    columns, which no rule keeps (the kernels' scalar path)."""
    from repro_torch.core.sparsity import channel_idx
    enc = []
    for _, R, C, B, rule in views:
        g = rule.group_size
        x = torch.randn((R, C), generator=gen, device=dev) * 0.05
        kept = torch.sort(torch.randperm(C // g, generator=gen, device=dev)
                          [:B // g]).values
        cols = torch.sort(torch.randperm(C, generator=gen, device=dev)[:B]
                          ).values
        enc.append((x, channel_idx(rule, kept), cols))
    return enc


def _leaf_class(n: int) -> str:
    """A codec leaf's class by its ``n`` kept elements: large (at least
    2^21: ResNet's four leaves of 3.5 us of q8 encode bound or more),
    middle (2^16 to 2^21) or small (fewer: the launch alone sets the
    time)."""
    return "large" if n >= 1 << 21 else "middle" if n >= 1 << 16 \
        else "small"


def _q8_enc_bytes(x, idx) -> float:
    """Bytes of the fused q8 encode of ``x[:, idx]``: the kept floats and
    the int32 index read, q and the scales written."""
    R, B = x.shape[0], idx.shape[0]
    return 5.0 * R * B + 4.0 * B + 4.0 * R


def _q4_enc_bytes(x, idx) -> float:
    """Bytes of the fused q4 encode of ``x[:, idx]``: the kept floats and
    the int64 index read, the packed bytes and the scales written."""
    R, B = x.shape[0], idx.shape[0]
    return 4.0 * R * B + 8.0 * B + R * ((B + 1) // 2) + 4.0 * R


def _q4_bytes(xs) -> float:
    """Bytes of the q4 encode of ``xs``: each float read once, each packed
    byte and f32 scale written once."""
    return sum(4.0 * x.numel() + x.shape[0] * ((x.shape[1] + 1) // 2)
               + 4.0 * x.shape[0] for x in xs)


def _q8_decode_operands(q, s, idx, full):
    """(q, s, index) that ``ops.scatter_dequantize`` hands the q8 decode
    kernel for the zero-fill expansion of q (R, B) with kept columns idx
    into ``full`` columns: q itself, dropped columns at index B."""
    from repro_torch.kernels import ref
    return q, s, ref.inverse_index(idx, full)


def _q4_decode_operands(p, s, idx, full):
    """(p, s, index) that ``ops.scatter_dequantize_q4`` hands the q4
    decode kernel for the zero-fill expansion of p (R, ceil(B/2)): p
    itself, dropped columns at nibble 2 Cp."""
    from repro_torch.kernels import ref
    return p, s, ref.inverse_index_q4(p, idx, full)


def _q8_dec_bytes(R, B, Cout) -> float:
    """Bytes of the q8 zero-fill decode of R rows of B kept columns into
    Cout: the kept q bytes and the scales read once, the int32 index
    read, the f32 output written."""
    return float(R * B) + 4.0 * R + 4.0 * Cout + 4.0 * R * Cout


def _q4_dec_bytes(R, B, Cout) -> float:
    """Bytes of the q4 zero-fill decode: the packed kept bytes and the
    scales read once, the int64 index read, the f32 output written."""
    return float(R * ((B + 1) // 2)) + 4.0 * R + 8.0 * Cout \
        + 4.0 * R * Cout


def codec_study(torch, views, dev):
    """``--wire``: the fused encodes and the decodes over the codec API's
    compacted leaves ``views`` by class of leaf (``kernel_classes``), the
    decodes on the operands their zero-fill shims pass; the encodes' large
    leaves at kept sets laid out in other ways (``kept_layouts``); and the
    q8 encode's two parts alone on them (``encode_parts``)."""
    from repro_torch.kernels import wire
    gen = torch.Generator(device=dev).manual_seed(6)
    ops3 = _compact_operands(torch, views, gen, dev)
    enc = [(x, kept) for x, kept, _ in ops3]
    enc8 = [(x, i.to(torch.int32)) for x, i in enc]
    kernel_classes(torch, "gather_quantize",
                   [((x, i), x.shape[0] * i.shape[0], _q8_enc_bytes(x, i))
                    for x, i in enc8], wire.gather_quantize,
                   lambda x, i: wire.gather_quantize_plan(
                       x.shape[0], i.shape[0], x.shape[1], x.data_ptr()))
    kernel_classes(torch, "gather_quantize_q4",
                   [((x, i), x.shape[0] * i.shape[0], _q4_enc_bytes(x, i))
                    for x, i in enc], wire.gather_quantize_q4,
                   lambda x, i: wire.gather_quantize_q4_plan(
                       x.shape[0], i.shape[0], x.shape[1], x.data_ptr()))
    R_B_C = [(x.shape[0], i.shape[0], x.shape[1]) for x, i in enc]
    kernel_classes(torch, "gather_dequantize", [
        (_q8_decode_operands(*wire.gather_quantize(x, i), i, C), R * B,
         _q8_dec_bytes(R, B, C)) for (x, i), (R, B, C) in zip(enc8, R_B_C)],
        wire.gather_dequantize,
        lambda q, s, i: wire.gather_dequantize_plan(
            q.shape[0], i.shape[0], q.shape[1], q.data_ptr(), 0))
    kernel_classes(torch, "unpack_gather_dequantize_q4", [
        (_q4_decode_operands(*wire.gather_quantize_q4(x, i), i, C), R * B,
         _q4_dec_bytes(R, B, C)) for (x, i), (R, B, C) in zip(enc, R_B_C)],
        wire.unpack_gather_dequantize_q4,
        lambda p, s, i: wire.unpack_gather_dequantize_q4_plan(
            p.shape[0], i.shape[0], p.shape[1], p.data_ptr(), 0))
    large = [(x, kept, rule.group_size)
             for (*_, rule), (x, kept, _) in zip(views, ops3)
             if _leaf_class(x.shape[0] * kept.shape[0]) == "large"]
    decode_yardsticks(torch, [x.shape for x, _, _ in large], gen, dev)
    kept_layouts(torch, large, gen, dev)
    encode_parts(torch, large)


def decode_yardsticks(torch, shapes, gen, dev):
    """What one launch a leaf moves at the decodes' large shapes [(R, C)]:
    the identity decodes of whole (R, C) rows (``wire.dequantize_rows``:
    1 B read and 4 B written an element; ``wire.unpack_dequantize_q4``:
    half a byte read), beside PyTorch's own cast of the int8 rows to f32
    (the same bytes without the scale) and its zero fill of the f32
    output (4 B written an element), each against its bytes' bound."""
    from repro_torch.kernels import wire
    qs = [torch.randint(-127, 128, shp, generator=gen, device=dev,
                        dtype=torch.int8) for shp in shapes]
    ps = [torch.randint(0, 256, (R, C // 2), generator=gen, device=dev,
                        dtype=torch.uint8) for R, C in shapes]
    ss = [torch.rand((R, 1), generator=gen, device=dev) for R, _ in shapes]
    outs = [torch.empty(shp, device=dev) for shp in shapes]
    n = sum(R * C for R, C in shapes)
    rows = sum(R for R, _ in shapes)
    parts = []
    for what, fn, nbytes in (
            ("dequantize_rows", lambda: [wire.dequantize_rows(q, s)
                                         for q, s in zip(qs, ss)],
             5.0 * n + 4.0 * rows),
            ("unpack_dequantize_q4",
             lambda: [wire.unpack_dequantize_q4(p, s, 2 * p.shape[1])
                      for p, s in zip(ps, ss)], 4.5 * n + 4.0 * rows),
            ("torch cast int8 -> f32", lambda: [q.to(torch.float32)
                                                for q in qs], 5.0 * n),
            ("torch zero fill f32", lambda: [o.zero_() for o in outs],
             4.0 * n)):
        ms, _ = kernel_ms(fn, 20)
        b_ms = bound(nbytes, 0.0)[0]
        parts.append(f"{what} {ms:.4f} ms, bound {b_ms:.4f} "
                     f"({100 * b_ms / ms:.1f}%)")
    say(f"decodes' large shapes {shapes}, one launch a leaf: "
        + "; ".join(parts))


def kernel_classes(torch, name, jobs, call, plan):
    """Time the kernel wrapper ``call(*args)`` over the leaves ``jobs``
    [(args, kept elements, bytes)] by class of leaf (``_leaf_class``), one
    launch a leaf, one line a class with its leaves' rows, output columns
    (the last operand's length: the kept or the expanded columns) and
    launch plans (``plan(*args)``), against the bound of its bytes."""
    classes = {}
    for args, n, nb in jobs:
        classes.setdefault(_leaf_class(n), []).append((args, nb))
    for cls in ("large", "middle", "small"):
        leaves = classes.get(cls, [])
        if not leaves:
            continue
        ms, stream = kernel_ms(lambda: [call(*a) for a, _ in leaves], 20)
        b_ms = bound(sum(nb for _, nb in leaves), 0.0)[0]
        how = sorted({plan(*a) for a, _ in leaves})
        say(f"{name} {cls} leaves: {len(leaves)}, rows "
            f"{sorted({a[0].shape[0] for a, _ in leaves})}, out columns "
            f"{sorted({a[-1].shape[0] for a, _ in leaves})}, plan (lanes, "
            f"nv, vec, runs) {how}: kernel {ms:.4f} ms on the device "
            f"({stream:.4f} ms on the stream), bound {b_ms:.4f} ms "
            f"({100 * b_ms / ms:.1f}% of it reached)")


def kept_layouts(torch, large, gen, dev):
    """Both fused encodes on the large leaves ``large`` [(x, kept, g)] at
    kept sets of the same width B that differ only in where the kept
    columns lie: the program's random whole groups of g; random runs of 2
    and of 4 groups from multiples of their width (64 and 128 bytes of
    f32 at g = 8); the first B columns; all B columns of the kept
    columns' contiguous copy (``quantize_rows``'s operand in
    ``encode_parts``); and all C columns (B = C, twice the work).  Each
    is checked bit-equal to the plain versions, then timed against the
    bytes it must move: one line a layout."""
    from repro_torch.kernels import ref, wire

    def runs(C, B, w):
        k = torch.sort(torch.randperm(C // w, generator=gen, device=dev)
                       [:B // w]).values
        return (k[:, None] * w + torch.arange(w, device=dev)).reshape(-1)

    layouts = {"random whole groups (the program's)":
               [(x, i) for x, i, _ in large]}
    for m in (2, 4):
        if all(i.shape[0] % (m * g) == 0 == x.shape[1] % (m * g)
               for x, i, g in large):
            layouts[f"random runs of {m} groups"] = [
                (x, runs(x.shape[1], i.shape[0], m * g)) for x, i, g in large]
        else:
            say(f"kept layout: runs of {m} groups do not divide B and C")
    layouts["the first B columns"] = [
        (x, torch.arange(i.shape[0], device=dev)) for x, i, _ in large]
    layouts["all columns of their contiguous copy"] = [
        (x[:, i].contiguous(), torch.arange(i.shape[0], device=dev))
        for x, i, _ in large]
    layouts["all C columns"] = [
        (x, torch.arange(x.shape[1], device=dev)) for x, _, _ in large]
    for what, jobs in layouts.items():
        j8 = [(x, i.to(torch.int32)) for x, i in jobs]
        for x, i in j8:
            q, sc = wire.gather_quantize(x, i)
            if not (_same(torch, q, ref.gather_quantize_ref(x, i)[0])
                    and _same(torch, sc, ref.gather_quantize_ref(x, i)[1])):
                raise AssertionError(f"gather_quantize, kept {what}: "
                                     "differs from the plain version")
        for x, i in jobs:
            _equal_q4(torch, wire.gather_quantize_q4(x, i),
                      ref.gather_quantize_q4_ref(x, i),
                      f"gather_quantize_q4, kept {what}")
        parts = []
        for name, encode, nbytes, js in (
                ("gather_quantize", wire.gather_quantize, _q8_enc_bytes, j8),
                ("gather_quantize_q4", wire.gather_quantize_q4,
                 _q4_enc_bytes, jobs)):
            ms, _ = kernel_ms(lambda: [encode(x, i) for x, i in js], 20)
            b_ms = bound(sum(nbytes(x, i) for x, i in js), 0.0)[0]
            parts.append(f"{name} {ms:.4f} ms, bound {b_ms:.4f} "
                         f"({100 * b_ms / ms:.1f}%)")
        say(f"encodes' large leaves ({len(jobs)}), kept {what}, bit-equal: "
            + "; ".join(parts))


def encode_parts(torch, large):
    """The fused q8 encode's two parts alone on its large leaves ``large``
    [(x, kept, g)], one launch a leaf, each against its own bound: the
    same row engine without the gather (``quantize_rows`` on the kept
    columns stored contiguous) and the gather without the quantizer
    (``gather_groups`` of the kept groups of g)."""
    from repro_torch.kernels import compact, wire
    dense = [x[:, i].contiguous() for x, i, _ in large]
    q_ms, _ = kernel_ms(lambda: [wire.quantize_rows(d) for d in dense], 20)
    q_b = bound(sum(5.0 * d.numel() + 4.0 * d.shape[0] for d in dense),
                0.0)[0]
    say(f"gather_quantize large leaves, parts alone: quantize_rows on the "
        f"kept columns stored contiguous {q_ms:.4f} ms, bound {q_b:.4f} "
        f"({100 * q_b / q_ms:.1f}%)")
    groups = []
    for x, i, g in large:
        k = i.view(-1, g)
        if not torch.equal(k, k[:, :1] + torch.arange(g, device=k.device)) \
                or bool((k[:, 0] % g).any()):
            say("gather_quantize large leaves: kept columns are not whole "
                f"groups of {g}; gather_groups not timed")
            return
        groups.append((x, (k[:, 0] // g).to(torch.int32).contiguous(), g))
    g_ms, _ = kernel_ms(lambda: [compact.gather_table([(x, k, 1, g)])
                                 for x, k, g in groups], 20)
    g_b = bound(sum(8.0 * d.numel() + 4.0 * k.numel()
                    for d, (_, k, _) in zip(dense, groups)), 0.0)[0]
    say(f"gather_quantize large leaves, parts alone: gather_groups of the "
        f"kept groups {g_ms:.4f} ms, bound {g_b:.4f} "
        f"({100 * g_b / g_ms:.1f}%)")


def decode_route(torch, name, shim, jobs) -> float:
    """Time the zero-fill shim ``shim(payload, s, idx, full)`` (the codec
    API's decode_expand route) over the leaves ``jobs`` once: the device
    time of every launch it makes, summed, one item a kernel."""
    def run():
        return [shim(*j) for j in jobs]
    split = kernel_split(run, 20)
    ms = sum(v[0] for v in split.values())
    say(f"{name} route, {len(jobs)} leaves: {ms:.4f} ms on the device in "
        f"{sum(v[1] for v in split.values())} launches ({cuda_ms(run, 20):.4f}"
        " ms on the stream): " + ", ".join(
            f"{k} {v[0]:.4f} ms x {v[1]}"
            for k, v in sorted(split.items(), key=lambda kv: -kv[1][0])))
    return ms


def check_q4_pack(torch, payload_shapes, lead, dev, label="resnet18"):
    """quantize_pack_q4 vs the plain version, bit for bit, on every
    compact payload leaf as the q4 ring views it, (lead * rows, C), in one
    call as the ring makes it (``wire.quantize_pack_q4_table``), and on
    edge cases of each path of the plan (rows in registers and streamed,
    vectors of four floats and pairs, odd C, C = 1, NaN and inf rows, a
    base 4 bytes off alignment), alone and all in one call; timed over
    all leaves, per
    width class beside the plan, with the launches a call takes."""
    from repro_torch.kernels import ops, ref, wire
    gen = torch.Generator(device=dev).manual_seed(8)
    xs = []
    for shape in payload_shapes.values():
        R, C = _q4_views(shape, lead)
        xs.append(torch.randn((R, C), generator=gen, device=dev) * 0.05)
    edges = []
    for R, C in ((1, 1), (97, 3), (37, 10), (20011, 33), (37, 64),
                 (37, 1536), (37, 1537), (5, 4096), (5, 6145), (3, 12288)):
        x = torch.randn((R, C), generator=gen, device=dev)
        x[R // 2, C // 2] = float("nan")
        x[-1, -1], x[0, 0] = float("inf"), -float("inf")
        edges.append(x)
    buf = torch.randn((37 * 1536 + 1,), generator=gen, device=dev)
    edges += [buf[1:].view(37, 1536), buf[1:1 + 37 * 33].view(37, 33)]
    err = 0.0
    for group in [xs, edges] + [[x] for x in edges]:
        for x, got in zip(group, wire.quantize_pack_q4_table(group)):
            err = max(err, _equal_q4(torch, got, ref.quantize_pack_q4_ref(x),
                                     f"quantize_pack_q4 {tuple(x.shape)}"))
    torch.cuda.synchronize()
    say(f"quantize_pack_q4 check ({label}): {len(xs)} payload leaves in "
        f"one call and {len(edges)} edge cases (C = 1 to 12288 on each path "
        "of the plan, NaN and inf rows, bases 4 bytes off alignment), "
        "alone and in one call, bit-equal to the plain version (max abs "
        f"err {err})")
    ops.reset_launch_counts()
    wire.quantize_pack_q4_table(xs)
    calls = ops.launch_counts()["quantize_pack_q4"]
    n = sum(x.numel() for x in xs)
    b_ms, b_by = bound(_q4_bytes(xs), 7.0 * n)
    ms, stream = kernel_ms(lambda: wire.quantize_pack_q4_table(xs), 20)
    plain_ms, _ = kernel_ms(lambda: [ref.quantize_pack_q4_ref(x)
                                     for x in xs], 5)
    say(f"quantize_pack_q4 ({label}): {len(xs)} leaves in {calls} "
        f"launch(es), {n} elements: kernel {ms:.4f} ms on the device "
        f"({stream:.4f} ms on the stream), plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.1f}% of it reached)")
    for C in sorted({x.shape[1] for x in xs}):
        cls = [x for x in xs if x.shape[1] == C]
        c_ms, c_st = kernel_ms(
            lambda: wire.quantize_pack_q4_table(cls), 20)
        c_b, _ = bound(_q4_bytes(cls), 7.0 * sum(x.numel() for x in cls))
        how = sorted({wire.q4_plan(x.shape[0], C, x.data_ptr(), 0)
                      for x in cls})
        say(f"quantize_pack_q4 ({label}) C = {C}: {len(cls)} leaves, "
            f"{sum(x.shape[0] for x in cls)} rows, plan (lanes, nv, vec) "
            f"{how}: kernel {c_ms:.4f} ms on the device ({c_st:.4f} ms on "
            f"the stream), bound {c_b:.4f} ms ({100 * c_b / c_ms:.1f}% of "
            "it reached)")
    return [{"name": "quantize_pack_q4", "route": "cuda", "source": WIRE_SRC,
             "replaces": "src/repro/kernels/wire.py:153", "max_abs_err": err,
             "ms": ms, "stream_ms": stream, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}]


def check_q4(torch, views, dev):
    """The q4 gather and unpack kernels vs their plain versions, bit for
    bit, at the main paths' shapes, plus odd-C, 1-D and NaN/inf rows;
    timed (quantize_pack_q4: ``check_q4_pack``).

    gather_quantize_q4 / unpack_gather_dequantize_q4: the codec API's
    encode_compact / decode_expand of ``views``
    (``shrinkage.compact_encode_views``), at a random kept set of whole
    groups (timed) and of single columns; the decode on the four forms of
    operand ``check_q8_gather`` names (p padded by a zero byte column, p
    itself with index 2 Cp reading a zero nibble, no index, an arange),
    timed on the shim's, and the shim's whole route once."""
    from repro_torch.kernels import ops, ref, wire
    gen = torch.Generator(device=dev).manual_seed(3)
    ops3 = _compact_operands(torch, views, gen, dev)
    enc = [(x, kept) for x, kept, _ in ops3]
    # each kernel's max abs difference from its plain version over every
    # comparison below (bytes as integers, scales, decoded values; the
    # entries that are not finite in both are held equal, not measured)
    err = {"gather_quantize_q4": 0.0, "unpack_gather_dequantize_q4": 0.0}

    def note(name, e):
        err[name] = max(err[name], e)

    def same(out, plain, what):
        torch.testing.assert_close(out, plain, rtol=0, atol=0,
                                   equal_nan=True)
        if out.dtype != plain.dtype:
            raise AssertionError(f"unpack_gather_dequantize_q4 {what}: "
                                 f"dtype {out.dtype} != {plain.dtype}")
        note("unpack_gather_dequantize_q4", _abs_err(torch, out, plain))

    def decodes(p, sc, idx, C):
        """The decode of p on its four forms of operand, each bit-equal to
        the plain version and the unpadded one to the padded one; returns
        the unpadded form's operands and output."""
        pp, inv = ref.expand_operands_q4(p, idx, C)
        out = wire.unpack_gather_dequantize_q4(pp, sc, inv)
        same(out, ref.unpack_gather_dequantize_q4_ref(pp, sc, inv), "padded")
        inv0 = ref.inverse_index_q4(p, idx, C)
        out0 = wire.unpack_gather_dequantize_q4(p, sc, inv0)
        same(out0, ref.unpack_gather_dequantize_q4_ref(p, sc, inv0),
             "unpadded")
        same(out0, out, "unpadded vs padded")
        same(ops.scatter_dequantize_q4(p, sc, idx, C), out, "shim")
        n = idx.shape[0]
        same(wire.unpack_dequantize_q4(p, sc, n),
             ref.unpack_dequantize_q4_ref(p, sc, n), "identity")
        ar = torch.arange(2 * p.shape[1], device=dev)
        same(wire.unpack_gather_dequantize_q4(p, sc, ar),
             ref.unpack_gather_dequantize_q4_ref(p, sc, ar), "arange")
        return (pp, sc, inv), (p, sc, inv0), out0

    dec, padded, route = [], [], []
    for k, (x, idx) in enumerate(enc + [(x, c) for x, _, c in ops3]):
        p, sc = wire.gather_quantize_q4(x, idx)
        note("gather_quantize_q4",
             _equal_q4(torch, (p, sc), ref.gather_quantize_q4_ref(x, idx),
                       f"gather_quantize_q4 {tuple(x.shape)}"))
        C = x.shape[1]
        pad_ops, ops0, out = decodes(p, sc, idx, C)
        kept = torch.abs(out[:, idx] - x[:, idx]).max().item()
        if kept > 0.5001 * sc.max().item() or out.abs().sum().item() == 0:
            raise AssertionError(f"q4 round trip error {kept} on "
                                 f"{tuple(x.shape)}")
        if k < len(enc):
            dec.append(ops0)
            padded.append(pad_ops)
            route.append((p, sc, idx, C))
    # odd C, 1-D leaves (one row), R not a multiple of the 8-row block,
    # and rows holding NaN or inf
    extra = [torch.randn(shp, generator=gen, device=dev)
             for shp in ((13, 33), (4, 1), (1, 9), (7, 257))]
    bad = torch.randn((13, 10), generator=gen, device=dev)
    bad[1, 3], bad[5, 0], bad[12, 9] = float("nan"), float("inf"), \
        -float("inf")
    for x in extra + [bad]:
        C = x.shape[1]
        p, sc = ref.quantize_pack_q4_ref(x)
        idx = torch.arange(0, C, 2, device=dev)
        note("gather_quantize_q4",
             _equal_q4(torch, wire.gather_quantize_q4(x, idx),
                       ref.gather_quantize_q4_ref(x, idx),
                       f"gather_quantize_q4 {tuple(x.shape)}"))
        same(wire.unpack_dequantize_q4(p, sc, C),
             ref.unpack_dequantize_q4_ref(p, sc, C), "identity")
        decodes(*ref.gather_quantize_q4_ref(x, idx), idx, C)
    torch.cuda.synchronize()
    say(f"q4 check: gather_quantize_q4 and unpack_gather_dequantize_q4 on "
        f"{len(enc)} compacted leaves, kept sets of whole groups and of "
        "single columns, bit-equal to the plain versions; the decode "
        "padded (the TPU kernel's operands), unpadded with the zero index "
        "(the shim's), by no index and by an arange equal; odd-C, 1-D, "
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
                    "gather_quantize_q4": "179",
                    "unpack_gather_dequantize_q4": "205"}[name],
                "max_abs_err": err[name], "ms": ms, "stream_ms": stream,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}

    nb = sum(x.shape[0] * idx.shape[0] for x, idx in enc)
    p8 = sum(x.shape[0] * ((idx.shape[0] + 1) // 2) for x, idx in enc)
    r8 = sum(x.shape[0] for x, _ in enc)
    n9 = sum(pp.shape[0] * inv.shape[0] for pp, _, inv in dec)
    i9 = sum(inv.shape[0] for _, _, inv in dec)
    out = [
        time_one("gather_quantize_q4",
                 lambda: [wire.gather_quantize_q4(x, i) for x, i in enc],
                 lambda: [ref.gather_quantize_q4_ref(x, i) for x, i in enc],
                 sum(_q4_enc_bytes(x, i) for x, i in enc), 7.0 * nb,
                 f"{len(enc)} leaves, {nb} kept elements in whole groups"),
        time_one("unpack_gather_dequantize_q4",
                 lambda: [wire.unpack_gather_dequantize_q4(*a) for a in dec],
                 lambda: [ref.unpack_gather_dequantize_q4_ref(*a)
                          for a in dec],
                 float(p8) + 4.0 * r8 + 8.0 * i9 + 4.0 * n9, 3.0 * n9,
                 f"{len(dec)} leaves expanded to {n9} elements, the "
                 "shim's operands"),
    ]
    p_ms, _ = kernel_ms(lambda: [wire.unpack_gather_dequantize_q4(*a)
                                 for a in padded], 20)
    say(f"unpack_gather_dequantize_q4: the same on p padded by a zero byte "
        f"column (the TPU kernel's operands): kernel {p_ms:.4f} ms on the "
        "device")
    out[1]["route_ms"] = decode_route(torch, "scatter_dequantize_q4",
                                      ops.scatter_dequantize_q4, route)
    return out


@contextlib.contextmanager
def patched(module, name, fn):
    """``module.name`` replaced by ``fn`` inside the block."""
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield real
    finally:
        setattr(module, name, real)


def recorded(module, name, calls, keep=lambda *a, **k: (a, k)):
    """``module.name`` wrapped so that ``keep`` of every call's arguments
    (the arguments themselves by default) is appended to ``calls`` before
    the real function runs."""
    real = getattr(module, name)

    def rec(*args, **kwargs):
        calls.append(keep(*args, **kwargs))
        return real(*args, **kwargs)
    return patched(module, name, rec)


@contextlib.contextmanager
def plain_twins():
    """The wrappers of the kernels that the training paths launch inside a
    round's compaction, scoring and scan (gather, group norms, the q8
    gather codec, the SSD scan) replaced by their plain twins."""
    from repro_torch.kernels import compact, group_norms, ref, ssd_scan, wire
    with contextlib.ExitStack() as st:
        st.enter_context(patched(
            compact, "gather_table",
            lambda jobs: [ref.gather_groups_ref(x, i, p, g)
                          for x, i, p, g in jobs]))
        st.enter_context(patched(group_norms, "group_norms_sq",
                                 ref.group_norms_sq_ref))
        st.enter_context(patched(
            wire, "gather_quantize",
            lambda x, idx, levels=127: ref.gather_quantize_ref(
                x, idx, levels)))
        st.enter_context(patched(wire, "gather_dequantize",
                                 ref.gather_dequantize_ref))
        st.enter_context(patched(
            ssd_scan, "ssd_chunk_scan",
            lambda x, dt, A, Bm, Cm, chunk: ref.ssd_chunk_scan_ref(
                x, dt, A, Bm, Cm, chunk)))
        yield


def round_operands(torch, bundle, lead, dev, idxs=None):
    """The gather and group-norm operands of one dynamic round of phase
    3's path, exactly as the round hands them to the kernel wrappers: the
    inter-node boundary's compaction of a (lead, ...) payload by every
    rule (by ``idxs``, {rule: kept groups}, or a random sorted choice) and
    its zero-fill expansion, and every scored leaf's view for the mask
    scores.  Returns (the job lists of the round's ``compact.gather_table``
    launches, group-norm views)."""
    from repro_torch.core.shrinkage import compact_params, expand_params
    from repro_torch.core.sparsity import group_scores
    from repro_torch.kernels import compact, group_norms
    plan = bundle.plan
    gen = torch.Generator(device=dev).manual_seed(4)
    payload = {k: torch.randn((lead,) + tuple(s), generator=gen, device=dev)
               for k, s in bundle.shapes.items()}
    def random_idx(r):   # the shape of the rule's mask indices
        stack = tuple(bundle.shapes[r.leaves[0].key][:r.stack_ndims])
        k = r.keep // r.shards
        idx = torch.stack([torch.sort(torch.randperm(
            r.groups // r.shards, generator=gen, device=dev)[:k]).values
            for _ in range(math.prod(stack) * r.shards)])
        return idx.reshape(stack + ((r.shards, k) if r.shards > 1 else (k,)))
    if idxs is None:
        idxs = {r.name: random_idx(r) for r in plan.rules}
    fulls = {r.name: r.groups for r in plan.rules}
    gathers, norms = [], []
    with recorded(compact, "gather_table", gathers, lambda jobs: list(jobs)):
        pc = compact_params(payload, plan, idxs, offset=1)
        expand_params(pc, plan, idxs, fulls, offset=1)
    with recorded(group_norms, "group_norms_sq", norms):
        for rule in plan.rules:
            group_scores(payload, rule, offset=1)
    torch.cuda.synchronize()
    return gathers, [a[0] for a, _ in norms]


def run_gathers(compact, calls):
    """Launch every recorded job list (x, idx, slice_rows, g) as the path
    does: one ``compact.gather_table`` call each."""
    return [compact.gather_table(jobs) for jobs in calls]


def _gather_dims(x, idx, g):
    """(R, C, Q, S, B) of a job, B in channels."""
    R, C = x.shape[:2]
    Q = x.shape[2] if x.ndim == 3 else 1
    S = idx.shape[0] if idx.ndim == 2 else 1
    return R, C, Q, S, idx.shape[-1] * g


def _gather_out(x, idx, g) -> int:
    """Elements a job writes."""
    R, C, Q, S, B = _gather_dims(x, idx, g)
    return R * B * Q


def _gather_bytes(x, idx, g) -> tuple[float, float]:
    """(the bytes the gather must move: each output element written once,
    each kept input element read once (an expansion reads its compact
    input, not the zeros), the index once; the older formula of this
    bound: each output element read and written)."""
    R, C, Q, S, B = _gather_dims(x, idx, g)
    e = x.element_size()
    out = R * B * Q * e
    return (out + min(out, R * C * Q * e) + 4.0 * idx.numel(),
            2.0 * out + 4.0 * idx.numel())


def _gather_library(torch, jobs):
    """The operands of one PyTorch call computing each gather,
    ``torch.take_along_dim`` on the (R / (S P), S, P, C/g + pad, g Q)
    view with the index broadcast over it: int64 indices, and an
    expansion's input padded by one zero group beforehand (no PyTorch
    gather writes zeros for an index past the end)."""
    out = []
    for x, idx, p, g in jobs:
        R, C, Q, S, B = _gather_dims(x, idx, g)
        i2 = idx.reshape(S, -1).long()
        xv = x.reshape(R, C // g, g * Q)
        if C < B:
            xv = torch.nn.functional.pad(xv, (0, 0, 0, 1))
        out.append((xv.reshape(R // (S * p), S, p, xv.shape[1], g * Q),
                    i2.view(1, S, 1, -1, 1)))
    return out


def _gather_plan(compact, x, idx, p, g):
    """The kernel's plan of one job (an output of aligned base)."""
    R, C, Q, S, B = _gather_dims(x, idx, g)
    return compact.plan(R, C, Q, S, B, p, g, x.element_size(),
                        (x.data_ptr() % 16, 0))


def _gather_edges(torch, compact, gen, dev):
    """[(jobs, what)]: gathers off the main paths' shapes, each one
    launch: prime R, B = 1, odd C, f32/bf16/int8/uint8, kept groups of
    g > 1 with Q > 1 and S > 1, expansions that read the index C/g as
    zeros, a base 4 bytes off alignment, and a table over one launch's
    capacity."""
    from repro_torch.kernels import ref

    def idx(C, B, S=1):
        return torch.stack([torch.sort(torch.randperm(
            C, generator=gen, device=dev)[:B]).values for _ in range(S)]
            ).to(torch.int32)

    def rnd(*shape, dt=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * 40).to(dt)
    out = []
    for dt in (torch.float32, torch.bfloat16, torch.int8, torch.uint8):
        for R, C, B in ((13, 33, 1), (7, 10, 5), (1, 1, 1), (31, 257, 128)):
            out.append(([(rnd(R, C, dt=dt), idx(C, B)[0], 1, 1)],
                        f"{dt} ({R}, {C}) -> {B}"))
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        kept = idx(6, 3, 3)
        x = rnd(2 * 3 * 5, 6 * 8, 5, dt=dt)
        c = ref.gather_groups_ref(x, kept, 5, 8)
        out.append(([(x, kept, 5, 8), (c, ref.inverse_index(kept, 6), 5, 8)],
                    f"{dt} g = 8, Q = 5, S = 3, and its expansion"))
    buf = rnd(37 * 48 * 64 + 1)
    out.append(([(buf[1:].view(37, 48, 64), idx(48, 24)[0], 1, 1),
                 (buf[1:].view(37, 48 * 64), idx(384, 192)[0], 1, 8)],
                "a base 4 bytes off, Q = 64 and g = 8"))
    out.append(([(rnd(3 + i % 4, 16, 1 + i % 3), idx(2, 1)[0], 1, 8)
                 for i in range(compact.CAPACITY + 3)],
                f"{compact.CAPACITY + 3} leaves (two launches)"))
    return out


def check_gather(torch, calls, dev, label="resnet18"):
    """gather_groups vs the plain version, bit for bit, on one dynamic
    round's compactions and expansions (``round_operands``: one launch a
    rule and direction) and on edge cases
    (``_gather_edges``); timed against the plain version, the library
    call (``_gather_library``) and the bound, over the round, per run
    width (g·Q·elem bytes) and per launch beside its plan."""
    from repro_torch.kernels import compact, ops, ref
    gen = torch.Generator(device=dev).manual_seed(5)
    jobs = [j for c in calls for j in c]
    err = 0.0
    for c, outs in zip(calls, run_gathers(compact, calls)):
        for (x, i, p, g), out in zip(c, outs):
            plain = ref.gather_groups_ref(x, i, p, g)
            if not _same(torch, out, plain):
                raise AssertionError(f"gather_groups {tuple(x.shape)} g {g} "
                                     "differs from the plain version")
            err = max(err, _abs_err(torch, out.float(), plain.float()))
    edges = _gather_edges(torch, compact, gen, dev)
    for ejobs, what in edges:
        ops.reset_launch_counts()
        outs = run_gathers(compact, [ejobs])[0]
        want = -(-len(ejobs) // compact.CAPACITY)
        if ops.launch_counts()["gather_groups"] != want:
            raise AssertionError(f"gather_groups {what}: "
                                 f"{ops.launch_counts()['gather_groups']} "
                                 f"launches, not {want}")
        for (x, i, p, g), out in zip(ejobs, outs):
            plain = ref.gather_groups_ref(x, i, p, g)
            if not _same(torch, out, plain):
                raise AssertionError(f"gather_groups {what} differs from "
                                     "the plain version")
            err = max(err, _abs_err(torch, out.float(), plain.float()))
    torch.cuda.synchronize()
    n = sum(_gather_out(x, i, g) for x, i, _, g in jobs)
    zeros = sum(x.shape[1] < i.shape[-1] * g for x, i, _, g in jobs)
    say(f"gather_groups check ({label}): one dynamic round's {len(jobs)} "
        f"compactions and expansions in {len(calls)} launches ({zeros} "
        f"expansions; {n} elements out) and {len(edges)} edge launches "
        "(prime R, B = 1, odd C in f32/bf16/int8/uint8"
        + "".join(f"; {w}" for _, w in edges if "->" not in w)
        + f") bit-equal to the plain version; max abs err {err}")
    nbytes = sum(_gather_bytes(x, i, g)[0] for x, i, _, g in jobs)
    old = sum(_gather_bytes(x, i, g)[1] for x, i, _, g in jobs)
    b_ms, b_by = bound(nbytes, 0.0)
    ms, stream = kernel_ms(lambda: run_gathers(compact, calls), 20)
    plain_ms, _ = kernel_ms(lambda: [ref.gather_groups_ref(*j)
                                     for j in jobs], 5)
    lib = _gather_library(torch, jobs)
    lib_ms, _ = kernel_ms(lambda: [torch.take_along_dim(x, i, dim=3)
                                   for x, i in lib], 20)
    say(f"gather_groups ({label}): one dynamic round's {len(jobs)} gathers "
        f"in {len(calls)} launches, {n} elements: kernel {ms:.4f} ms on "
        f"the device ({stream:.4f} ms on the stream), plain {plain_ms:.4f} "
        f"ms, library (take_along_dim, expansions from a padded copy) "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{100 * b_ms / ms:.1f}% of it reached; older formula "
        f"{bound(old, 0.0)[0]:.4f} ms)")
    widths = {}
    for j in jobs:
        R, C, Q, S, B = _gather_dims(j[0], j[1], j[3])
        widths.setdefault(j[3] * Q * j[0].element_size(), []).append(j)
    for w, cls in sorted(widths.items()):
        c_ms, c_st = kernel_ms(lambda: compact.gather_table(cls), 10)
        c_b, _ = bound(sum(_gather_bytes(x, i, g)[0]
                           for x, i, _, g in cls), 0.0)
        units = sorted({_gather_plan(compact, *j).unit for j in cls})
        small = sum(_gather_bytes(x, i, g)[0] < 1e6 for x, i, _, g in cls)
        say(f"gather_groups ({label}) runs of {w} B: {len(cls)} gathers "
            f"({small} under 1 MB) in {-(-len(cls) // compact.CAPACITY)} "
            "launch(es), "
            f"{c_b * HBM_BYTES_PER_S / 1e9:.3f} MB, units {units} "
            f"B: kernel {c_ms:.4f} ms on the device ({c_st:.4f} ms on the "
            f"stream), bound {c_b:.4f} ms ({100 * c_b / c_ms:.1f}% of it "
            "reached)")
    for k, c in enumerate(calls):
        c_ms, c_st = kernel_ms(lambda: compact.gather_table(c), 10)
        c_b, _ = bound(sum(_gather_bytes(x, i, g)[0] for x, i, _, g in c),
                       0.0)
        plans = [_gather_plan(compact, *j) for j in c]
        runs = sorted({p.L * p.unit for p in plans})
        say(f"gather_groups ({label}) launch {k}: {len(c)} leaves, runs "
            f"{runs} B, units {sorted({p.unit for p in plans})} B, "
            f"{sum(p.tiles for p in plans)} blocks: kernel {c_ms:.4f} ms on "
            f"the device ({c_st:.4f} ms on the stream), bound {c_b:.4f} ms "
            f"({100 * c_b / c_ms:.1f}% of it reached)")
    return [{"name": "gather_groups", "route": "cuda", "source": GATHER_SRC,
             "replaces": "src/repro/kernels/compact.py:23",
             "max_abs_err": err, "ms": ms, "stream_ms": stream,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": lib_ms}]


def check_q8_gather(torch, views, dev):
    """gather_quantize and gather_dequantize vs their plain versions, bit
    for bit, at the codec API's shapes (encode_compact / decode_expand of
    ``views``, ``shrinkage.compact_encode_views``, at kept sets of whole
    groups and of single columns), plus odd-C, one-row, ragged-R and
    NaN/inf rows; the decode on four forms of operand: q padded by a zero
    column with its inverse index (the TPU kernel's contract), q itself
    with the inverse index whose dropped columns read column B as zeros
    (the zero-fill shim's), the identity (no index) and an arange; timed
    at the whole groups on the shim's form (the padded form's time
    printed beside it), and the shim's whole route once."""
    from repro_torch.kernels import ops, ref, wire
    gen = torch.Generator(device=dev).manual_seed(6)
    ops3 = [(x, kept.to(torch.int32), cols.to(torch.int32))
            for x, kept, cols in _compact_operands(torch, views, gen, dev)]
    enc = [(x, kept) for x, kept, _ in ops3]
    err = {"gather_quantize": 0.0, "gather_dequantize": 0.0}

    def note(name, a, b):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        if a.dtype != b.dtype:
            raise AssertionError(f"{name}: dtype {a.dtype} != {b.dtype}")
        err[name] = max(err[name], _abs_err(torch, a, b))

    def decodes(q, sc, idx, C):
        """The decode of q (R, B) on its four forms of operand, each
        bit-equal to the plain version and the unpadded one to the padded
        one; returns the unpadded form's operands and output."""
        pq, inv = ref.expand_operands(q, idx, C)
        out = wire.gather_dequantize(pq, sc, inv)
        note("gather_dequantize", out, ref.gather_dequantize_ref(pq, sc, inv))
        inv0 = ref.inverse_index(idx, C)
        out0 = wire.gather_dequantize(q, sc, inv0)
        note("gather_dequantize", out0, ref.gather_dequantize_ref(q, sc, inv0))
        note("gather_dequantize", out0, out)
        note("gather_dequantize", ops.scatter_dequantize(q, sc, idx, C), out)
        note("gather_dequantize", wire.dequantize_rows(q, sc),
             ref.dequantize_rows_ref(q, sc))
        ar = torch.arange(q.shape[1], device=dev, dtype=torch.int32)
        note("gather_dequantize", wire.gather_dequantize(q, sc, ar),
             ref.gather_dequantize_ref(q, sc, ar))
        return (pq, sc, inv), (q, sc, inv0), out0

    dec, padded, route = [], [], []
    for k, (x, idx) in enumerate(enc + [(x, c) for x, _, c in ops3]):
        q, sc = wire.gather_quantize(x, idx)
        qp, sp = ref.gather_quantize_ref(x, idx)
        note("gather_quantize", q, qp)
        note("gather_quantize", sc, sp)
        C = x.shape[1]
        pad_ops, ops0, out = decodes(q, sc, idx, C)
        kept = (torch.abs(out[:, idx.long()] - x[:, idx.long()])
                / sc).max().item()
        if kept > 0.5001 or out.abs().sum().item() == 0:
            raise AssertionError(f"q8 round trip {kept} quanta off on "
                                 f"{tuple(x.shape)}")
        if k < len(enc):
            dec.append(ops0)
            padded.append(pad_ops)
            route.append((q, sc, idx.long(), C))   # the codec API's dtype
    # odd C, one row, C = 1, ragged R, NaN/inf rows
    extra = [torch.randn(shp, generator=gen, device=dev)
             for shp in ((13, 33), (1, 9), (4, 1), (7, 257))]
    bad = torch.randn((13, 10), generator=gen, device=dev)
    bad[1, 3], bad[5, 0], bad[12, 9] = float("nan"), float("inf"), \
        -float("inf")
    for x in extra + [bad]:
        C = x.shape[1]
        idx = torch.arange(0, C, 2, device=dev, dtype=torch.int32)
        q, sc = wire.gather_quantize(x, idx)
        qp, sp = ref.gather_quantize_ref(x, idx)
        note("gather_quantize", q, qp)
        note("gather_quantize", sc, sp)
        decodes(q, sc, idx, C)
    torch.cuda.synchronize()
    say(f"q8 gather check: gather_quantize and gather_dequantize on "
        f"{len(enc)} compacted leaves, kept sets of whole groups and of "
        "single columns, bit-equal to the plain versions; the decode "
        "padded (the TPU kernel's operands), unpadded with the zero index "
        "(the shim's), by no index and by an arange equal; odd-C, one-row, "
        f"C = 1, ragged-R and NaN/inf rows equal; max abs err {err}")

    def time_one(name, kern, plain, nbytes, nops, what):
        b_ms, b_by = bound(nbytes, nops)
        ms, stream = kernel_ms(kern, 20)
        plain_ms, _ = kernel_ms(plain, 5)
        say(f"{name}: {what}: kernel {ms:.4f} ms on the device "
            f"({stream:.4f} ms on the stream), plain {plain_ms:.4f} ms, no "
            f"library call, bound {b_ms:.4f} ms ({b_by})")
        return {"name": name, "route": "cuda", "source": WIRE_SRC,
                "replaces": "src/repro/kernels/wire.py:" + {
                    "gather_quantize": "77", "gather_dequantize": "102"}[name],
                "max_abs_err": err[name], "ms": ms, "stream_ms": stream,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}

    nb = sum(x.shape[0] * idx.shape[0] for x, idx in enc)
    rows = sum(x.shape[0] for x, _ in enc)
    n9 = sum(pq.shape[0] * inv.shape[0] for pq, _, inv in dec)
    i9 = sum(inv.shape[0] for _, _, inv in dec)
    out = [
        time_one("gather_quantize",
                 lambda: [wire.gather_quantize(x, i) for x, i in enc],
                 lambda: [ref.gather_quantize_ref(x, i) for x, i in enc],
                 sum(_q8_enc_bytes(x, i) for x, i in enc), 7.0 * nb,
                 f"{len(enc)} leaves, {nb} kept elements in whole groups"),
        time_one("gather_dequantize",
                 lambda: [wire.gather_dequantize(*a) for a in dec],
                 lambda: [ref.gather_dequantize_ref(*a) for a in dec],
                 float(nb) + 4.0 * rows + 4.0 * i9 + 4.0 * n9, 2.0 * n9,
                 f"{len(dec)} leaves expanded to {n9} elements, the "
                 "shim's operands"),
    ]
    p_ms, _ = kernel_ms(lambda: [wire.gather_dequantize(*a)
                                 for a in padded], 20)
    say(f"gather_dequantize: the same on q padded by a zero column (the TPU "
        f"kernel's operands): kernel {p_ms:.4f} ms on the device")
    out[1]["route_ms"] = decode_route(torch, "scatter_dequantize",
                                      ops.scatter_dequantize, route)
    return out


def _einsum(torch, v):
    """One PyTorch call computing the squared group norms of a view."""
    return torch.einsum("gck,gck->gc" if v.ndim == 3 else
                        "gcab,gcab->gc", v, v)


def _norms_bound(torch, views):
    """(ms, "bytes" | "operations") of the squared group norms of
    ``views``: each input element read once, each f32 output written
    once; one multiply-add an element."""
    n = sum(v.numel() for v in views)
    nbytes = sum(v.numel() * v.element_size() + 4.0 * v.shape[0]
                 * v.shape[1] for v in views)
    return bound(nbytes, 2.0 * n)


def check_group_norms(torch, norms, dev, label="resnet18"):
    """group_norms_sq vs the plain version within rtol 1e-5, and the same
    bits on a second run, on one dynamic round's score views
    (``round_operands``), K = 1, a one-channel view, K minor, C minor,
    a Mamba2-like two-dim fan-in and fan-ins the slices do not divide, a
    base 4 bytes off alignment, f32 and bf16; timed over all views
    against the plain version and ``torch.einsum``, and per view beside
    its plan."""
    from repro_torch.kernels import group_norms, ref
    gen = torch.Generator(device=dev).manual_seed(7)
    views = norms

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    t = rnd(4, 300, 64)
    extra = [rnd(4, 8, 1), rnd(4, 1, 100), rnd(4, 512, 10), t.transpose(1, 2),
             rnd(3, 16, 9).to(torch.bfloat16),
             rnd(2, 1536, 6, 64).permute(0, 2, 1, 3),      # Mamba2-like
             rnd(2, 5, 98301), rnd(2, 3001, 30).transpose(1, 2),
             rnd(2 * 5 * 4097 + 1)[1:].view(2, 5, 4097),   # 4 bytes off
             rnd(2, 1536, 6, 64).permute(0, 2, 1, 3).to(torch.bfloat16),
             rnd(4, 4608, 64).transpose(1, 2).to(torch.bfloat16)]
    err = 0.0
    for v in views + extra:
        out = group_norms.group_norms_sq(v)
        plain = ref.group_norms_sq_ref(v)
        torch.testing.assert_close(out, plain, rtol=1e-5, atol=0)
        if not torch.equal(out, group_norms.group_norms_sq(v)):
            raise AssertionError(f"group_norms_sq {tuple(v.shape)} gave "
                                 "other bits on a second run")
        err = max(err, _abs_err(torch, out, plain))
    torch.cuda.synchronize()
    minor = sum(v.stride(1) == 1 for v in views)
    say(f"group_norms_sq check ({label}): one dynamic round's {len(views)} "
        f"score views ({minor} channel-minor, "
        f"{sum(v.ndim == 4 for v in views)} with a two-dim fan-in) and "
        f"{len(extra)} edge cases (K = 1, one channel, K minor, C minor, a "
        "Mamba2-like two-dim fan-in, fan-ins the slices do not divide, a "
        "base 4 bytes off alignment, bf16) within rtol 1e-5 of the plain "
        f"version and the same bits on a second run; max abs err {err}")
    n = sum(v.numel() for v in views)
    b_ms, b_by = _norms_bound(torch, views)
    ms, stream = kernel_ms(lambda: [group_norms.group_norms_sq(v)
                                    for v in views], 20)
    plain_ms, _ = kernel_ms(lambda: [ref.group_norms_sq_ref(v)
                                     for v in views], 5)
    lib_ms, _ = kernel_ms(lambda: [_einsum(torch, v) for v in views], 20)
    say(f"group_norms_sq ({label}): one dynamic round's {len(views)} views, "
        f"{n} elements: kernel {ms:.4f} ms on the device ({stream:.4f} ms "
        f"on the stream), plain {plain_ms:.4f} ms, library (einsum) "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{100 * b_ms / ms:.1f}% of it reached)")
    for i, v in enumerate(views):
        shape = v.shape if v.ndim == 4 else v.shape[:2] + (1,) + v.shape[2:]
        st = v.stride() if v.ndim == 4 else v.stride()[:2] + (0,) \
            + v.stride()[2:]
        how = group_norms.plan(shape, st, v.element_size(),
                               v.data_ptr()).describe()
        k_ms = sum(x[0] for x in kernel_split(
            lambda: group_norms.group_norms_sq(v), 10).values())
        e_ms = sum(x[0] for x in kernel_split(
            lambda: _einsum(torch, v), 10).values())
        v_b, _ = _norms_bound(torch, [v])
        say(f"group_norms_sq ({label}) view {i}: {tuple(v.shape)} strides "
            f"{tuple(v.stride())} plan [{how}]: kernel {k_ms:.4f} ms, "
            f"einsum {e_ms:.4f} ms, bound {v_b:.4f} ms "
            f"({100 * v_b / k_ms:.1f}% of it reached)")
    return [{"name": "group_norms_sq", "route": "cuda", "source": NORMS_SRC,
             "replaces": "src/repro/kernels/group_norms.py:28",
             "max_abs_err": err, "ms": ms, "stream_ms": stream,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": lib_ms}]


def _snapshot_masks(state) -> dict:
    return {name: m["idx"].clone() for name, m in state["masks"].items()}


def q8_engine(torch, dev, levels=(4, 4)):
    """Phase 3's engine: resnet18 full width, 16 workers at levels (4, 4)
    (or ``levels``), compact+q8, masks frozen at round 3; 32 images per
    worker."""
    from repro_torch.configs import (ConsensusSpec, HsadmmConfig,
                                     ShapeConfig, get_config)
    from repro_torch.models import build
    from repro_torch.train.engine import Engine
    hp = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=8, t_freeze=3,
                      wire_inter="compact+q8")
    cfg = get_config("resnet18").replace(hsadmm=hp)
    consensus = ConsensusSpec(levels=levels, compact_from_level=1)
    shape = ShapeConfig("chip_smoke", "train", 32,
                        32 * consensus.num_workers)
    return Engine(build(cfg), shape, consensus=consensus, device=dev), shape


def counted_rounds():
    """``(context, CallCounter)``: inside the context every round function
    an ``Engine`` hands out (``round_step_fn``) counts its calls."""
    from repro_torch.dist import monitor
    from repro_torch.train.engine import Engine
    counter = monitor.CallCounter()
    real = Engine.round_step_fn

    def counted(self, frozen):
        return counter.wrap(real(self, frozen),
                            "frozen" if frozen else "dynamic")
    return patched(Engine, "round_step_fn", counted), counter


def run_path(torch, engine, rounds: int, eta: float,
             deterministic: bool = True, **run_kw):
    """``engine`` = (Engine, ShapeConfig) trained ``rounds`` rounds through
    the port's ``train`` (seed 0; ``run_kw`` are more ``RunConfig``
    fields).  ``deterministic=False`` turns cuDNN's deterministic switch
    back off after the Engine set it (only to time what the switch
    costs).  Launch counts are zeroed just before the run and read after
    each round's dispatch; the mask indices and the weights the round ran
    with are kept after every round (device copies, no sync); the peak is
    ``max_memory_allocated`` over the run; ``builds`` counts the kernel
    builds during the run (``dist.monitor.compile_count``) and ``calls``
    the calls of the round functions."""
    from repro_torch.dist import monitor
    from repro_torch.kernels import ops
    from repro_torch.train.loop import RunConfig, train
    eng, shape = engine
    torch.backends.cudnn.deterministic = deterministic
    per_round, masks, weights = [], [], []

    def snapshot(k, state):   # runs after each round's dispatch
        per_round.append(ops.launch_counts())
        masks.append(_snapshot_masks(state))
        weights.append((state["weights"].clone(),
                        {c: v.clone() for c, v in
                         state.get("class_weights", {}).items()}))

    run = RunConfig(outer_iters=rounds, shape=shape, eta=eta, seed=0,
                    metrics_every=1, eval_fn=snapshot, log=None, **run_kw)
    rounds_counted, counter = counted_rounds()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with rounds_counted, monitor.compile_count() as builds:
            state, rep = train(eng, run)
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = True
    wall = time.perf_counter() - t0
    totals = ops.launch_counts()
    launches = [{k: c[k] - (per_round[i - 1][k] if i else 0) for k in c}
                for i, c in enumerate(per_round)]
    return {"eng": eng, "state": state, "rep": rep, "shape": shape,
            "totals": totals, "launches": launches, "masks": masks,
            "weights": weights, "wall": wall,
            "peak": torch.cuda.max_memory_allocated(),
            "builds": builds.compiles, "calls": counter.calls}


def run_q8(torch, dev, rounds: int = 6, deterministic: bool = True):
    """Phase 3's configuration trained through ``run_path`` (eta 1e-2)."""
    return run_path(torch, q8_engine(torch, dev), rounds, 1e-2,
                    deterministic)


def round_launches(plan) -> tuple[int, int]:
    """(gather launches, group-norm views) of one dynamic round of phase
    3's path: each compactable rule compacts and expands all the leaves
    it slices at the one compacting boundary, one launch each way (one
    more for each leaf the rule slices twice: ``leaf_parts``), and scores
    its scored leaves."""
    from repro_torch.core.shrinkage import leaf_parts
    n = sum(len(leaf_parts(r.all_leaves)) for r in plan.rules
            if r.compactable)
    return 2 * n, sum(len(r.leaves) for r in plan.rules)


def train_full(torch, dev):
    """Phase 3: the main path, checked.  Returns ``run_q8``'s result."""
    r = run_q8(torch, dev)
    rep, launches = r["rep"], r["launches"]
    say(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}; "
        f"cudnn.deterministic={torch.backends.cudnn.deterministic} "
        f"cudnn.benchmark={torch.backends.cudnn.benchmark}")
    say(f"train: resnet18 full, W=16 levels (4, 4), compact+q8, 32 images "
        f"per worker, {rep.outer_iters} rounds in {r['wall']:.2f} s")
    for k in range(rep.outer_iters):
        say(f"round {k}: {rep.executables[k]} loss={rep.losses[k]:.6f} "
            f"wall_ms={rep.wall_times[k] * 1e3:.1f} "
            f"internode_bytes={rep.comm_bytes_internode[k]} "
            f"launches={launches[k]}")
    say(f"frozen_at: {rep.frozen_at}")
    say(f"max_memory_allocated: {r['peak']} bytes")
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
    check_q8_rounds(r)
    return r


def check_q8_rounds(r):
    """Every round of a run of phase 3's configuration (``run_path``'s
    result): the inter-node bytes of its kind (dynamic 2,861,818, frozen
    2,860,858) and phase 3's launches: 62 x 8 prox, 62 quantize (one a
    leaf, whatever the class partition) and 16 gather launches, and 40
    group-norm launches in a dynamic round."""
    rep, launches = r["rep"], r["launches"]
    gathers, views = round_launches(r["eng"].bundle.plan)
    for k, c in enumerate(launches):
        dyn = rep.executables[k] == "dynamic"
        if rep.comm_bytes_internode[k] != (2_861_818 if dyn else 2_860_858):
            raise AssertionError(f"round {k} bytes "
                                 f"{rep.comm_bytes_internode[k]}")
        if c["fused_prox_sgd_dyn"] != 62 * 8 or c["quantize_rows"] != 62 \
                or c["gather_groups"] != gathers \
                or c["group_norms_sq"] != (views if dyn else 0):
            raise AssertionError(f"round {k} launches {c}; expected "
                                 f"{gathers} gathers and {views} group-norm "
                                 "launches in a dynamic round")


def _first_diff(torch, a: dict, b: dict):
    """The first key whose tensors differ, with their max abs gap."""
    for key in a:
        if not torch.equal(a[key], b[key]):
            return key, (a[key].double() - b[key].double()).abs().max().item()
    return None


def compare_runs(torch, a, b, label):
    """Two runs of one configuration must agree bit for bit: per-round
    losses and executables, the mask indices after every round, and the
    final theta and every consensus level z."""
    ra, rb = a["rep"], b["rep"]
    if ra.losses != rb.losses or ra.executables != rb.executables:
        raise AssertionError(f"{label}: losses {ra.losses} vs {rb.losses}")
    for k, (ma, mb) in enumerate(zip(a["masks"], b["masks"])):
        d = _first_diff(torch, ma, mb)
        if d:
            raise AssertionError(f"{label}: round {k} mask idx of {d[0]} "
                                 "differ")
    sa, sb = a["state"], b["state"]
    pairs = [("theta", sa["theta"], sb["theta"])] + [
        (f"z{i}", za, zb) for i, (za, zb) in enumerate(zip(sa["z"], sb["z"]))]
    for name, ta, tb in pairs:
        d = _first_diff(torch, ta, tb)
        if d:
            raise AssertionError(f"{label}: final {name}/{d[0]} differs by "
                                 f"up to {d[1]}")
    say(f"determinism ({label}): {len(ra.losses)} rounds twice from seed 0, "
        f"losses {ra.losses} equal, mask indices after every round and the "
        f"final theta and z (levels {len(sa['z'])}) bit-equal")


def _steady(rep) -> list:
    """Round walls (ms) of the full-width steady rounds: all but the
    first, up to the reconfiguration."""
    return [w * 1e3 for w, x in zip(rep.wall_times[1:], rep.executables[1:])
            if x != "reconfigured"]


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def determinism_q8(torch, dev, first):
    """Phase 3a: phase 3 again with cuDNN's deterministic switch off (to
    time what the switch costs), then again as the program runs it, which
    must give phase 3's bits.  Returns the steady-round medians (ms) with
    the switch on (phase 3 and this run) and off."""
    off = run_q8(torch, dev, deterministic=False)
    off_walls = _steady(off["rep"])
    say(f"cudnn.deterministic off (timing only): losses "
        f"{off['rep'].losses}, round wall_ms "
        f"{[round(w * 1e3, 1) for w in off['rep'].wall_times]}")
    del off
    again = run_q8(torch, dev)
    compare_runs(torch, first, again, "q8 full width")
    on_walls = _steady(first["rep"]) + _steady(again["rep"])
    say(f"cudnn.deterministic on: round wall_ms "
        f"{[round(w * 1e3, 1) for w in again['rep'].wall_times]} (this run), "
        f"steady median {_median(on_walls):.1f} ms over {len(on_walls)} "
        f"rounds of phases 3 and 3a; off: steady median "
        f"{_median(off_walls):.1f} ms over {len(off_walls)} rounds")
    return _median(on_walls), _median(off_walls)


def route_vs_plain(torch, dev):
    """Phase 3e: the first three (dynamic) rounds of phase 3's
    configuration as the program runs them, under
    ``torch.use_deterministic_algorithms`` (which raises on any operation
    without a deterministic implementation), and again under
    ``plain_twins``.  Mask indices and the final theta/z must be
    bit-equal, the per-round group scores within rtol 1e-5; a flipped mask
    index fails with the two scores and their gap."""
    from repro_torch.core import consensus
    scores = []
    real_scores = consensus.group_scores

    def rec_scores(*args, **kwargs):
        s = real_scores(*args, **kwargs)
        scores.append(s.clone())
        return s

    with patched(consensus, "group_scores", rec_scores):
        torch.use_deterministic_algorithms(True)
        try:
            kern = run_q8(torch, dev, rounds=3)
        finally:
            torch.use_deterministic_algorithms(False)
        k_scores = list(scores)
        scores.clear()
        with plain_twins():
            plain = run_q8(torch, dev, rounds=3)
        p_scores = list(scores)
    kt, pt = kern["totals"], plain["totals"]
    if kt["gather_groups"] == 0 or kt["group_norms_sq"] == 0 \
            or pt["gather_groups"] or pt["group_norms_sq"]:
        raise AssertionError(f"route launches: kernel {kt}, plain {pt}")
    rules = kern["eng"].bundle.plan.rules
    worst = 0.0
    for i, (sk, sp) in enumerate(zip(k_scores, p_scores)):
        rnd, rule = divmod(i, len(rules))
        name = rules[rule].name
        mk, mp = kern["masks"][rnd][name], plain["masks"][rnd][name]
        if not torch.equal(mk, mp):
            gk, gp = sk.mean(dim=0), sp.mean(dim=0)
            a = sorted(set(mk.reshape(-1).tolist())
                       ^ set(mp.reshape(-1).tolist()))
            raise AssertionError(
                f"route vs plain: round {rnd} rule {name} keeps other "
                f"groups {a}: kernel-route scores {gk[a].tolist()}, "
                f"plain-route scores {gp[a].tolist()}, gap "
                f"{(gk[a] - gp[a]).tolist()}")
        torch.testing.assert_close(sk, sp, rtol=1e-5, atol=0)
        worst = max(worst, ((sk - sp).abs() / sp.abs().clamp_min(1e-30))
                    .max().item())
    compare_runs(torch, kern, plain, "kernel route vs plain route")
    say(f"route vs plain: {len(k_scores)} group-score tensors over 3 "
        f"dynamic rounds within rtol 1e-5 (max rel gap {worst}), the mask "
        "indices and final theta/z bit-equal; kernel route launches "
        f"{kt}, plain route gather_groups {pt['gather_groups']} and "
        f"group_norms_sq {pt['group_norms_sq']}; the kernel route ran under "
        "torch.use_deterministic_algorithms(True)")


def profile_round(torch, eng, state, shape, label="frozen", eta=1e-2):
    """Phases 5, 5b and 6d: one more frozen round of a trained main path
    under the profiler: device time by kernel, and the device's busy
    share of the round's device-side span.  Returns the busy share in
    percent and {kernel name: [ms, launches]} of the round."""
    from collections import defaultdict
    from repro_torch.data.pipeline import batches, superbatches
    from repro_torch.data.synthetic import make_stream
    sb = next(superbatches(batches(make_stream(
        eng.cfg, shape, eng.workers, device=eng.device)), 8))
    step = eng.round_step_fn(frozen=True)
    eta = torch.tensor(eta, device=eng.device)
    t0 = time.perf_counter()
    evs = device_events(lambda: step(state, sb, eta), 1)
    wall = (time.perf_counter() - t0 - 0.01) / 2   # warm-up + profiled run
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
        elif any(t in low for t in ("chunk_cumsum", "transpose_chunks",
                                    "chunk_cb", "chunk_state", "state_pass",
                                    "chunk_inter", "chunk_intra")):
            cats["ssd_chunk_scan kernels"] += ms
        elif "quantize_rows" in low:
            cats["quantize_rows kernel"] += ms
        elif "q4" in low:
            cats["q4 wire kernels"] += ms
        elif "gather_table_kernel" in low or "norms_" in low \
                or "gather_quantize" in low or "gather_dequantize" in low:
            cats["gather / group-norm kernels"] += ms
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
    return 100 * busy / span, dict(by_name)


def smoke_round_cpu_vs_card(torch, dev, bundle, spec, shape, keys, eta,
                            label, prepare=lambda st: st):
    """One round of ``bundle`` under ``spec`` from one state (the init,
    through ``prepare``) on the card and on the CPU (plain versions), on
    the first 8 batches (``keys``) of ``shape``'s stream for 4 workers:
    theta and z agree to rtol 1e-4 (atol 1e-6), the mask indices are
    equal."""
    import numpy as np
    from repro_torch.core.hsadmm import init_state, round_step
    from repro_torch.data.synthetic import make_stream
    stream = make_stream(bundle.cfg, shape, 4, device="cpu")
    sb = {k: torch.stack([stream.batch_at(s)[k] for s in range(8)])
          for k in keys}
    out = {}
    for d in ("cpu", dev):
        st0 = prepare(init_state(
            bundle.init(torch.Generator().manual_seed(0), d), spec))
        st, _ = round_step(st0, {k: v.to(d) for k, v in sb.items()},
                           bundle.train_loss, spec, eta)
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
    say(f"{label} card vs CPU: theta/z within rtol 1e-4 (max abs diff "
        f"{worst}), mask idx equal")


def smoke_resnet_cpu_vs_card(torch, dev):
    """Phase 4: one resnet-smoke round (W = 4 at levels (2, 2),
    compact+q8, E = 8, eta 1e-2) through ``smoke_round_cpu_vs_card``."""
    from repro_torch.configs import (ConsensusSpec, HsadmmConfig,
                                     ShapeConfig, get_config)
    from repro_torch.core.hsadmm import EngineSpec
    from repro_torch.models import build
    hp = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=8,
                      wire_inter="compact+q8")
    b = build(get_config("resnet18", smoke=True).replace(hsadmm=hp))
    spec = EngineSpec(plan=b.plan, consensus=ConsensusSpec((2, 2), 1),
                      hp=hp, stack_map=tuple(b.stack_map))
    smoke_round_cpu_vs_card(torch, dev, b, spec,
                            ShapeConfig("s", "train", 16, 16),
                            ("images", "labels"), 1e-2, "smoke round")


def run_reconfig(torch, dev, rounds: int = 8, **run_kw):
    """Phase 3b's configuration trained ``rounds`` rounds through the
    port's ``train`` (``run_kw``: more ``RunConfig`` fields), with the
    launch counts, mask indices, peak and held memory of every round.
    Returns a dict of them, the engine, shape, final state, report,
    launch totals and wall time."""
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
    per_round, peaks, held, masks = [], [], [], []

    def snapshot(k, state):   # runs after each round's dispatch
        per_round.append(ops.launch_counts())
        masks.append(_snapshot_masks(state))
        peaks.append(torch.cuda.max_memory_allocated())
        held.append(torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    run = RunConfig(outer_iters=rounds, shape=shape, eta=1e-2, seed=0,
                    metrics_every=1, reconfig=True, eval_fn=snapshot,
                    log=None, **run_kw)
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
    return {"eng": eng, "shape": shape, "state": state, "rep": rep,
            "totals": totals, "launches": launches, "masks": masks,
            "peaks": peaks, "held": held, "wall": wall}


def train_reconfig(torch, dev, **run_kw):
    """Phase 3b: the main path of physical reconfiguration over the
    compact+q4 inter-node wire (``run_reconfig``; ``run_kw``: more
    ``RunConfig`` fields, such as checkpoints), checked.  Returns a dict
    of the launch totals, the reconfigured engine, final state, shape,
    report, the mask indices after every round and memory facts."""
    r = run_reconfig(torch, dev, **run_kw)
    eng, shape, state, rep = r["eng"], r["shape"], r["state"], r["rep"]
    totals, launches, masks = r["totals"], r["launches"], r["masks"]
    peaks, held, wall = r["peaks"], r["held"], r["wall"]
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
    # every round compacts and expands at the inter-node boundary (the
    # reconfigured round with its all-kept plan too); the migration before
    # round r compacts the six state trees theta, mom, u, z[0], z[1], v[0]
    gathers, views = round_launches(eng.bundle.plan)
    for k, c in enumerate(launches):
        want_g = gathers + (6 * gathers // 2 if k == r else 0)
        if c["fused_prox_sgd_dyn"] != 62 * 8 or c["quantize_pack_q4"] != 1 \
                or c["quantize_rows"] != 0 or c["gather_groups"] != want_g \
                or c["group_norms_sq"] != (
                    views if rep.executables[k] == "dynamic" else 0):
            raise AssertionError(f"round {k} launches {c}")
    if tuple(state["theta"]["stem"].shape) != (16, 3, 3, 3, 32) \
            or tuple(state["theta"]["fc_w"].shape) != (16, 256, 10):
        raise AssertionError("reconfigured theta shapes "
                             f"{tuple(state['theta']['stem'].shape)} "
                             f"{tuple(state['theta']['fc_w'].shape)}")
    return {"totals": totals, "eng": rc, "state": state, "shape": shape,
            "rep": rep, "masks": masks, "mem": mem}


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
    if counts["unpack_gather_dequantize_q4"] != len(jobs):
        raise AssertionError(f"{len(jobs)} decoded leaves took "
                             f"{counts['unpack_gather_dequantize_q4']} "
                             "unpack launches, not one each")
    return counts


def codec_api_dense_q8(torch, state, plan):
    """Phase 3d: the dense and q8 codec API (``get_codec("compact")`` and
    ``get_codec("compact+q8")``) on every leaf of the trained consensus
    z[0], as phase 3c runs the q4 one: encode_compact / decode_expand
    along the frozen kept channels where a rule compacts the leaf's minor
    axis, encode / decode elsewhere.  Each result equals the plain
    versions'; dense round-trips exactly, q8 within half a quantum on the
    kept channels; dropped channels are exactly zero.  Returns the launch
    counts of the run."""
    from repro_torch.comm import get_codec
    from repro_torch.core.shrinkage import compacting_rule
    from repro_torch.core.sparsity import channel_idx
    from repro_torch.kernels import ops, ref
    z = state["z"][0]
    jobs = []
    for key, x in z.items():
        rule = compacting_rule(plan, key, x.ndim - 2)
        idx = None if rule is None else channel_idx(
            rule, state["masks"][rule.name]["idx"])
        jobs.append((key, x, idx))
    outs = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for spec in ("compact", "compact+q8"):
        codec = get_codec(spec)
        for key, x, idx in jobs:
            if idx is None:
                pay = codec.encode(x)
                outs[spec, key] = (pay, codec.decode(pay, like=x))
            else:
                x2 = x.reshape(-1, x.shape[-1])
                pay = codec.encode_compact(x2, idx)
                outs[spec, key] = (pay, codec.decode_expand(
                    pay, idx, x.shape[-1], like=x2))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    worst = 0.0
    for key, x, idx in jobs:
        R, C = ops._rc(tuple(x.shape))
        x2 = x.reshape(R, C)
        kept = torch.ones(C, dtype=torch.bool, device=x.device)
        if idx is not None:
            kept = torch.zeros_like(kept)
            kept[idx] = True
        pay, out = outs["compact", key]
        out = out.reshape(R, C)
        if idx is not None and not _same(
                torch, pay, ref.gather_groups_ref(x2, idx.to(torch.int32))):
            raise AssertionError(f"dense encode_compact of {key} differs "
                                 "from the plain gather")
        if not (torch.equal(out[:, kept], x2[:, kept])
                and torch.all(out[:, ~kept] == 0)):
            raise AssertionError(f"dense codec API on {key} does not "
                                 "round-trip exactly")
        (q, sc), out = outs["compact+q8", key]
        out = out.reshape(R, C)
        if idx is None:
            qp, sp = ref.quantize_rows_ref(x2)
            plain = ref.gather_dequantize_ref(qp, sp, torch.arange(
                C, device=x.device))
        else:
            qp, sp = ref.gather_quantize_ref(x2, idx)
            plain = ref.scatter_dequantize_ref(qp, sp, idx, C)
        if not (torch.equal(q.reshape(qp.shape), qp)
                and torch.equal(sc.reshape(R, 1), sp)
                and torch.equal(out, plain)):
            raise AssertionError(f"q8 codec API on {key}: differs from the "
                                 "plain versions")
        err = (torch.abs(out - x2)[:, kept] / sp).max().item()
        worst = max(worst, err)
        if err > 0.5001 or torch.any(out[:, ~kept] != 0):
            raise AssertionError(f"q8 codec API on {key}: {err} quanta off, "
                                 "or a dropped channel not zero")
    say(f"codec API: compact (dense) and compact+q8 on {len(jobs)} leaves "
        f"of z[0] ({sum(i is not None for _, _, i in jobs)} compacted), "
        "equal to the plain versions; dense exact, q8 at most "
        f"{worst:.4f} quanta off on kept channels; dropped channels zero; "
        f"launches {counts}")
    for name in ("gather_groups", "gather_quantize", "gather_dequantize"):
        if counts[name] == 0:
            raise AssertionError(f"the codec API launched no {name}")
    if counts["gather_dequantize"] != len(jobs):
        raise AssertionError(f"{len(jobs)} q8-decoded leaves took "
                             f"{counts['gather_dequantize']} decode "
                             "launches, not one each")
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
    it = superbatches(batches(make_stream(cfg, shape, 4, device="cpu")), 8)
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


# ---------------------------------------------------------------------------
# checkpoints, fault tolerance and the monitor on full-width ResNet-18
# (phases 7a-7d)
# ---------------------------------------------------------------------------

# parameters of the budget-B ResNet-18 that phase 3b reconfigures onto,
# and its inter-node bytes a round (compact+q4)
RECONFIGURED_PARAMS = 2_797_610
RECONFIGURED_BYTES = 1_462_053


def _leaves(state) -> dict:
    """{"/"-joined path: tensor} of a state: the checkpoint's keys."""
    from repro_torch.dist.checkpoint import _flatten
    return _flatten(state)


def _nz(counts: dict) -> dict:
    """The launch counts that are not zero."""
    return {k: v for k, v in counts.items() if v}


def _ckpt_bytes(torch, state) -> int:
    """Array bytes of ``state`` as a checkpoint stores it (int64 as
    int32, the JAX package's dtypes)."""
    return sum(t.numel() * (4 if t.dtype == torch.int64 else t.element_size())
               for t in _leaves(state).values())


def _assert_states_equal(torch, a, b, label) -> int:
    """Every leaf of two states bit-equal, dtypes too; returns the leaf
    count."""
    la, lb = _leaves(a), _leaves(b)
    if set(la) != set(lb):
        raise AssertionError(f"{label}: leaves {sorted(set(la) ^ set(lb))} "
                             "are in one state only")
    for p, x in la.items():
        if x.dtype != lb[p].dtype or not torch.equal(x, lb[p]):
            raise AssertionError(f"{label}: leaf {p} differs")
    return len(la)


def ckpt_q8(torch, dev, d):
    """Phase 7a: phase 3's configuration for 4 rounds with background
    saves every 2 rounds into ``d`` (keep 1): only ``ckpt_00000004``
    remains, its arrays file holds the state's bytes, and ``restore`` of
    it is bit-equal to the state ``train`` returned in every leaf; the
    save alone (snapshot on this thread, write on the writer's) and the
    restore are timed on the host.  Then ``train`` to 6 rounds resumes
    from it twice: bit-equal runs (losses, mask indices after every
    round, final theta/z) with phase 3's bytes and launches in each round
    of their kind.  Returns the saved state."""
    import os
    from repro_torch.dist import checkpoint as ckpt
    r = run_path(torch, q8_engine(torch, dev), 4, 1e-2, ckpt_dir=d,
                 ckpt_every=2, ckpt_keep=1)
    rep = r["rep"]
    if sorted(os.listdir(d)) != ["ckpt_00000004"]:
        raise AssertionError(f"checkpoints left: {sorted(os.listdir(d))}")
    check_q8_rounds(r)
    last = ckpt.latest(d)
    meta = ckpt.read_meta(last)
    if meta != {"step": 4, "arch": r["eng"].cfg.name, "workers": 16,
                "levels": [4, 4], "reconfigured": False}:
        raise AssertionError(f"meta {meta}")
    size = os.path.getsize(os.path.join(last, "arrays.npz"))
    want = _ckpt_bytes(torch, r["state"])
    if not want <= size < want + (1 << 20):
        raise AssertionError(f"arrays.npz holds {size} bytes, the state "
                             f"{want}")
    t0 = time.perf_counter()
    back, _ = ckpt.restore(last, r["state"])
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    n = _assert_states_equal(torch, back, r["state"], "7a restore")
    del back
    timed = os.path.join(d, "timed")
    t0 = time.perf_counter()
    ckpt.save(timed, r["state"], meta, background=True)
    t_snap = time.perf_counter() - t0
    ckpt.flush()
    t_write = time.perf_counter() - t0 - t_snap
    shutil.rmtree(timed)
    free = shutil.disk_usage(d).free
    say(f"checkpoint: {last}, arrays.npz {size} bytes ({n} leaves, state "
        f"{want} bytes); rounds {rep.executables}, losses {rep.losses}; "
        f"save alone: snapshot {t_snap:.3f} s on the caller's thread, "
        f"write {t_write:.3f} s on the writer thread; restore "
        f"{t_restore:.3f} s (load and copy to the card); free disk {free} "
        "bytes")
    runs = [run_path(torch, q8_engine(torch, dev), 6, 1e-2, ckpt_dir=d,
                     ckpt_every=0) for _ in range(2)]
    for x in runs:
        xr = x["rep"]
        if xr.outer_iters != 6 or xr.executables != ["dynamic", "frozen"] \
                or xr.frozen_at != 5:
            raise AssertionError(f"resumed run: {xr.outer_iters} rounds, "
                                 f"{xr.executables}, frozen_at "
                                 f"{xr.frozen_at}")
        if not all(math.isfinite(v) for v in xr.losses):
            raise AssertionError(f"non-finite losses {xr.losses}")
        check_q8_rounds(x)
    compare_runs(torch, runs[0], runs[1], "q8 resumed from step 4")
    walls = [[round(w * 1e3, 1) for w in x["rep"].wall_times] for x in runs]
    first = runs[0]["rep"]
    say(f"resumed from step 4 twice: rounds 4-5 {first.executables}, "
        f"losses {first.losses}, bytes {first.comm_bytes_internode}, "
        f"launches {[_nz(c) for c in runs[0]['launches']]}, round wall_ms "
        f"{walls}, whole runs {runs[0]['wall']:.2f} / "
        f"{runs[1]['wall']:.2f} s (restore included)")
    return r["state"]


def elastic_q8(torch, dev, d, saved):
    """Phase 7b: ``restore_elastic`` of phase 7a's checkpoint into W = 8 at
    levels (2, 4): every leaf equals the saved one, or its first rows
    where the worker dim shrank; then one round of ``train`` resumed from
    it, with a finite loss."""
    from repro_torch.dist import checkpoint as ckpt
    eng, shape = q8_engine(torch, dev, levels=(2, 4))
    t0 = time.perf_counter()
    st, meta = ckpt.restore_elastic(ckpt.latest(d), eng.init_state_fn()(0),
                                    8)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    rows, saved = 0, _leaves(saved)
    for p, x in _leaves(st).items():
        y = saved[p]
        if x.shape != y.shape:
            if x.shape[1:] != y.shape[1:] or x.shape[0] > y.shape[0]:
                raise AssertionError(f"7b: leaf {p} {tuple(x.shape)} from "
                                     f"{tuple(y.shape)}")
            y, rows = y[:x.shape[0]], rows + 1
        if not torch.equal(x, y):
            raise AssertionError(f"7b: leaf {p} differs from the save")
    del st
    r = run_path(torch, (eng, shape), 5, 1e-2, ckpt_dir=d, ckpt_every=0)
    rep = r["rep"]
    if rep.executables != ["dynamic"] or not math.isfinite(rep.losses[0]):
        raise AssertionError(f"7b round: {rep.executables} {rep.losses}")
    say(f"elastic: W 16 -> 8 at levels (2, 4), restored in {t_restore:.3f} s"
        f" ({rows} leaves cut to their first 8 rows, the rest equal); one "
        f"round: loss {rep.losses[0]}, bytes {rep.comm_bytes_internode[0]}, "
        f"launches {_nz(r['launches'][0])}, wall_ms "
        f"{rep.wall_times[0] * 1e3:.1f}, peak {r['peak']} bytes")


def reconfig_resume(torch, dev, d):
    """Phase 7c: phase 3b's run with saves every 2 rounds has left its
    step-8 checkpoint in ``d`` (its meta says reconfigured); ``train`` to
    10 rounds resumes from it twice, straight into the budget-B engine
    (2,797,610 parameters): reconfigured_at 8, 1,462,053 bytes and one q4
    table launch a round (one ring), bit-equal runs."""
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.models import build
    last = ckpt.latest(d)
    meta = ckpt.read_meta(last)
    aux = {f"masks/{r.name}/{f}" for r in build(get_config("resnet18"))
           .plan.rules for f in ("idx", "valid", "mask", "drift")}
    if meta["step"] != 8 or not meta["reconfigured"] \
            or set(ckpt.load_aux(last)) != aux:
        raise AssertionError(f"7c: checkpoint {last} meta {meta}")
    runs = [run_reconfig(torch, dev, rounds=10, ckpt_dir=d, ckpt_every=0)
            for _ in range(2)]
    for x in runs:
        rep, rc = x["rep"], x["rep"].final_engine
        params = sum(math.prod(v) for v in rc.bundle.shapes.values())
        if rep.executables != ["reconfigured"] * 2 \
                or rep.reconfigured_at != 8 or rep.frozen_at != 8 \
                or params != RECONFIGURED_PARAMS \
                or rep.comm_bytes_internode != [RECONFIGURED_BYTES] * 2:
            raise AssertionError(
                f"7c: {rep.executables}, reconfigured_at "
                f"{rep.reconfigured_at}, {params} parameters, bytes "
                f"{rep.comm_bytes_internode}")
        gathers, _ = round_launches(x["eng"].bundle.plan)
        for k, c in enumerate(x["launches"]):
            if c["fused_prox_sgd_dyn"] != 62 * 8 \
                    or c["quantize_pack_q4"] != 1 or c["quantize_rows"] \
                    or c["gather_groups"] != gathers or c["group_norms_sq"]:
                raise AssertionError(f"7c round {k} launches {c}")
        if not all(math.isfinite(v) for v in rep.losses):
            raise AssertionError(f"non-finite losses {rep.losses}")
    compare_runs(torch, runs[0], runs[1], "q4 reconfigured, resumed")
    rep = runs[0]["rep"]
    say(f"reconfigured resume from step 8 twice: stem "
        f"{rep.final_engine.cfg.cnn_stem} stages "
        f"{rep.final_engine.cfg.cnn_outs}, {RECONFIGURED_PARAMS} parameters"
        f", losses {rep.losses}, bytes {rep.comm_bytes_internode}, "
        f"launches {[_nz(c) for c in runs[0]['launches']]}, round wall_ms "
        f"{[[round(w * 1e3, 1) for w in x['rep'].wall_times] for x in runs]}"
        f", whole runs {runs[0]['wall']:.2f} / {runs[1]['wall']:.2f} s")


def ft_policies():
    """Phase 7d's two policies over W = 16: a failure window (worker 3
    out in rounds 1-2) times a recovering straggler, and a straggler
    scoped to one coupling class."""
    from repro_torch.dist import ft
    return {
        "fail_window x straggler_decay": ft.compose(
            ft.fail_window({3: (1, 3)}),
            ft.straggler_decay({5: 0.25}, halflife=2)),
        "class_scoped cnn:mid1": ft.class_scoped(
            {"cnn:mid1": ft.straggler_decay({7: 0.25}, halflife=2)}),
    }


def ft_monitor(torch, dev, phase3):
    """Phase 7d: phase 3's configuration for 4 rounds under each of
    ``ft_policies``: the weights (and class weights) every round ran with
    equal the policy's vectors, losses finite, phase 3's launches (q8:
    one quantize launch a leaf, whatever the class partition).  The
    monitor: no kernel build and one call of the round function a round,
    in phase 3 and in these runs.  Then one resnet-smoke round with
    class-scoped weights on the card and on the CPU from one state."""
    from repro_torch.configs import (ConsensusSpec, HsadmmConfig,
                                     ShapeConfig, get_config)
    from repro_torch.core.consensus import lead_classes
    from repro_torch.core.hsadmm import EngineSpec
    from repro_torch.models import build
    if phase3["builds"] or phase3["calls"] != len(phase3["rep"].losses):
        raise AssertionError(f"monitor, phase 3: {phase3['builds']} builds, "
                             f"{phase3['calls']} round calls for "
                             f"{len(phase3['rep'].losses)} rounds")
    say(f"monitor: phase 3 built {phase3['builds']} kernels and called its "
        f"round functions {phase3['calls']} times in "
        f"{len(phase3['rep'].losses)} rounds")
    # the same 4 rounds without a policy, just before, for the walls
    base = run_path(torch, q8_engine(torch, dev), 4, 1e-2)["rep"]
    say(f"ft baseline (no policy): losses {base.losses}, round wall_ms "
        f"{[round(w * 1e3, 1) for w in base.wall_times]}")
    for label, pol in ft_policies().items():
        r = run_path(torch, q8_engine(torch, dev), 4, 1e-2, ft_policy=pol)
        rep = r["rep"]
        if r["builds"] or r["calls"] != 4:
            raise AssertionError(f"monitor, {label}: {r['builds']} builds, "
                                 f"{r['calls']} round calls")
        rules = {x.name for x in r["eng"].bundle.plan.rules}
        for k, (w, cw) in enumerate(r["weights"]):
            if not torch.equal(w.cpu(), torch.from_numpy(pol(k, 16))):
                raise AssertionError(f"{label}: round {k} weights "
                                     f"{w.tolist()}")
            want = pol.class_weights(k, 16) \
                if getattr(pol, "per_class", False) else None
            if want is None:
                if cw:
                    raise AssertionError(f"{label}: class weights {cw}")
                continue
            if set(cw) != rules:
                raise AssertionError(f"{label}: class weights of {set(cw)}")
            for name, v in cw.items():
                ref = torch.from_numpy(want[name]) if name in want \
                    else torch.ones(16)
                if not torch.equal(v.cpu(), ref):
                    raise AssertionError(f"{label}: round {k} class {name} "
                                         f"weights {v.tolist()}")
        if not all(math.isfinite(v) for v in rep.losses):
            raise AssertionError(f"{label}: losses {rep.losses}")
        check_q8_rounds(r)
        lead = lead_classes(r["eng"].bundle.plan)
        classes = len({lead.get(key) for key in r["eng"].bundle.shapes})
        cw7 = r["weights"]
        w357 = [[round(float(w[i]), 4) for i in (3, 5, 7)] for w, _ in cw7]
        say(f"ft {label}: losses {rep.losses}, weights of worker 3 / 5 / 7 "
            f"by round {w357}"
            + (f", class cnn:mid1 worker 7 "
               f"{[round(float(c['cnn:mid1'][7]), 4) for _, c in cw7]}"
               f" ({classes} lead classes, one group_reduce each)"
               if getattr(pol, "per_class", False) else "")
            + f", launches {_nz(r['launches'][1])} (round 1), round wall_ms "
            f"{[round(w * 1e3, 1) for w in rep.wall_times]}, rounds 1-3 "
            f"{_median(_steady(rep)):.1f} ms median against the baseline's "
            f"{_median(_steady(base)):.1f}")
        del r
    hp = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=8,
                      wire_inter="compact+q8")
    b = build(get_config("resnet18", smoke=True).replace(hsadmm=hp))
    spec = EngineSpec(plan=b.plan, consensus=ConsensusSpec((2, 2), 1),
                      hp=hp, stack_map=tuple(b.stack_map),
                      class_weights=True)

    def scoped(st):
        d = st["weights"].device
        cw = dict(st["class_weights"])
        cw["cnn:mid0"] = torch.tensor([1.0, 0.25, 1.0, 0.5], device=d)
        cw["cnn:stem"] = torch.tensor([0.0, 1.0, 1.0, 1.0], device=d)
        return dict(st, weights=torch.tensor([1.0, 1.0, 0.75, 1.0],
                                             device=d),
                    class_weights=cw)
    smoke_round_cpu_vs_card(torch, dev, b, spec,
                            ShapeConfig("s", "train", 16, 16),
                            ("images", "labels"), 1e-2,
                            "smoke round with class-scoped weights",
                            prepare=scoped)


# ---------------------------------------------------------------------------
# Mamba2-780M: the SSD chunk-scan kernel and H-SADMM training (phases 6-6d)
# ---------------------------------------------------------------------------

MAMBA_LAYERS = 4      # of the config's 48: W copies of the state fit one card
MAMBA_ROUNDS = 5
# inter-node bytes per dynamic / frozen round of phase 6a's configuration,
# the reference's analytic count (tests/test_torch_ssm_train.py BYTES)
MAMBA_BYTES = (186_242_532, 186_241_764)
SSD_TOL = 2e-4        # rtol = atol, tests/test_kernels.py's SSD tolerance


def _ssd_inputs(torch, Bt, T, H, P, N, dtype, gen, dev, dt_shift=-3.0):
    """Scan operands like the mixer's: dt = softplus(~N(-3, 1)) (the
    init's bias), A = -exp(~N(0, 0.09)) per batch row."""
    F = torch.nn.functional
    x = torch.randn((Bt, T, H, P), generator=gen, device=dev) * 0.5
    dt = F.softplus(torch.randn((Bt, T, H), generator=gen, device=dev)
                    + dt_shift)
    A = -torch.exp(torch.randn((Bt, H), generator=gen, device=dev) * 0.3)
    Bm = torch.randn((Bt, T, N), generator=gen, device=dev)
    Cm = torch.randn((Bt, T, N), generator=gen, device=dev)
    return [x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)]


def ssd_bound(Bt, T, H, P, N, Q, elem):
    """(ms, "bytes" | "operations") of one scan: x, B, C, dt, A read and
    y, h written once; the products the causal scan needs: C.B^T and the
    intra-chunk product over the lower triangle (s <= q) of each chunk,
    the entering-state term and the chunk states (Q x N x P per step and
    head each)."""
    nc = T // Q
    tri = Q * (Q + 1) // 2
    ops = (2.0 * Bt * nc * tri * N + 2.0 * Bt * nc * H * tri * P
           + 4.0 * Bt * T * H * N * P)
    nbytes = (elem * (2.0 * Bt * T * H * P + 2.0 * Bt * T * N)
              + 4.0 * (Bt * T * H + Bt * H + Bt * H * N * P))
    return bound(nbytes, ops)


def check_ssd(torch, dev):
    """Phase 6: ssd_chunk_scan against its plain version on the card, in
    f32 and bf16, at phase 6a's shape (Bt 4 = W x 1 sequence, T 4096, H
    48, P 64, N 128, Q 256) and at edge shapes: Q not dividing T (T 1000:
    Q 250, not a multiple of the kernel's 64-row tile), H 5 (not a
    multiple of the kernel's head pair nor of the TPU kernel's head block
    of 8) with Bt 1, a short T with Q 64, and chunks whose sum of dt*|A|
    passes 88 (the decay's exponent above the diagonal overflows there).
    y and h bit-equal to the plain version, hence within rtol = atol =
    2e-4, and the same bits on a second launch; any failure fails the
    phase, after every case has been reported.  Then timed at the path
    shape against the plain version and the bound, with the device time
    of each of its kernels from one profiler window over the timed
    launches."""
    from repro_torch.kernels import ref, ssd_scan
    gen = torch.Generator(device=dev).manual_seed(11)
    path = (4, 4096, 48, 64, 128, 256)
    cases = [(path, -3.0), ((1, 1000, 5, 64, 128, 256), -3.0),
             ((2, 200, 48, 64, 128, 64), -3.0),
             ((2, 512, 4, 64, 128, 256), 3.0)]
    err, bad = 0.0, []
    for dtype in (torch.float32, torch.bfloat16):
        for (Bt, T, H, P, N, chunk), shift in cases:
            a = _ssd_inputs(torch, Bt, T, H, P, N, dtype, gen, dev, shift)
            y, h = ssd_scan.ssd_chunk_scan(*a, chunk=chunk)
            y2, h2 = ssd_scan.ssd_chunk_scan(*a, chunk=chunk)
            yr, hr = ref.ssd_chunk_scan_ref(*a, chunk)
            torch.cuda.synchronize()
            what = f"{(Bt, T, H, P, N, chunk)} {str(dtype)[6:]}"
            e = max(_abs_err(torch, y.float(), yr.float()),
                    _abs_err(torch, h, hr))
            err = max(err, e)
            checks = {
                "finite": bool(torch.isfinite(y.float()).all()
                               and torch.isfinite(h).all()),
                "within 2e-4": bool(torch.allclose(
                    y.float(), yr.float(), rtol=SSD_TOL, atol=SSD_TOL)
                    and torch.allclose(h, hr, rtol=SSD_TOL, atol=SSD_TOL)),
                "same bits twice": torch.equal(y, y2) and torch.equal(h, h2),
                "bit-equal to plain": torch.equal(y, yr)
                and torch.equal(h, hr)}
            failed = [k for k, ok in checks.items() if not ok]
            say(f"ssd_chunk_scan {what}: max abs err {e}"
                + (f"; FAILED: {', '.join(failed)}" if failed else ", ok"))
            if failed:
                bad.append(f"{what}: {', '.join(failed)}")
            del a, y, h, y2, h2, yr, hr
    if bad:
        raise AssertionError("ssd_chunk_scan vs plain: " + "; ".join(bad))
    say(f"ssd_chunk_scan check: {len(cases)} shapes (phase 6a's, Q not "
        "dividing T, H = 5 with Bt = 1, Q = 64, chunks past exp's range) "
        "in f32 and bf16 bit-equal to the plain version (so within rtol = "
        f"atol = {SSD_TOL}), the same bits on a second launch; max abs err "
        f"{err}")
    Bt, T, H, P, N, chunk = path
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        a = _ssd_inputs(torch, Bt, T, H, P, N, dtype, gen, dev)
        fn = lambda: ssd_scan.ssd_chunk_scan(*a, chunk=chunk)  # noqa: E731
        stream = cuda_ms(fn, 20)
        split = kernel_split(fn, 20)
        ms = sum(v[0] for v in split.values())
        plain_ms, _ = kernel_ms(lambda: ref.ssd_chunk_scan_ref(*a, chunk), 5)
        b_ms, b_by = ssd_bound(Bt, T, H, P, N, chunk, a[0].element_size())
        out[dtype] = (ms, stream, plain_ms, b_ms, b_by)
        dn = str(dtype)[6:]
        say(f"ssd_chunk_scan {dn}: Bt {Bt} T {T} H {H} P {P} N {N} Q "
            f"{chunk}: kernel {ms:.4f} ms on the device ({stream:.4f} ms on "
            f"the stream), plain {plain_ms:.4f} ms, no library call, bound "
            f"{b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.1f}% of it reached)")
        for name, (k_ms, n) in sorted(split.items(), key=lambda t: -t[1][0]):
            say(f"ssd_chunk_scan {dn} kernel {name}: {k_ms:.4f} ms "
                f"({100 * k_ms / ms:.1f}%), {n} launch(es) per call")
        del a
    ms, stream, plain_ms, b_ms, b_by = out[torch.float32]
    return [{"name": "ssd_chunk_scan", "route": "cuda", "source": SSD_SRC,
             "replaces": "src/repro/kernels/ssd_scan.py:57",
             "max_abs_err": err, "ms": ms, "stream_ms": stream,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": None, "bf16_ms": out[torch.bfloat16][0]}]


def mamba_engine(torch, dev, layers=MAMBA_LAYERS, smoke=False):
    """Phase 6a's engine: mamba2-780m at full width (or its smoke config),
    ``layers`` layers, f32, W = 4 at levels (2, 2), compact+q8 from level
    1, masks frozen after round 2, the config's other H-SADMM settings;
    one 4096-token sequence per worker."""
    import dataclasses
    from repro_torch.configs import ConsensusSpec, ShapeConfig, get_config
    from repro_torch.models import build
    from repro_torch.train.engine import Engine
    cfg = get_config("mamba2-780m", smoke=smoke)
    hp = dataclasses.replace(cfg.hsadmm, t_freeze=2, wire_inter="compact+q8")
    cfg = cfg.replace(hsadmm=hp, param_dtype="float32")
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    shape = ShapeConfig("train_4k", "train", 32 if smoke else 4096, 4)
    return Engine(build(cfg), shape,
                  consensus=ConsensusSpec(levels=(2, 2), compact_from_level=1),
                  device=dev), shape


def run_mamba(torch, dev, rounds=MAMBA_ROUNDS):
    """Phase 6a's configuration trained through ``run_path`` (eta 1e-3)."""
    return run_path(torch, mamba_engine(torch, dev), rounds, 1e-3)


def mamba_round_launches(plan, leaves: int, E: int = 8) -> dict:
    """The launches one round of phase 6a makes: one scan per layer per
    local step, prox per leaf per step, one q8 quantize per payload leaf,
    the gathers and group norms of the ssm_heads rule (the latter in
    dynamic rounds)."""
    gathers, views = round_launches(plan)
    return {"ssd_chunk_scan": MAMBA_LAYERS * E,
            "fused_prox_sgd_dyn": leaves * E, "quantize_rows": leaves,
            "gather_groups": gathers, "group_norms_sq": views}


def train_mamba(torch, dev):
    """Phase 6a: the Mamba2 path, checked.  Returns ``run_mamba``'s
    result."""
    r = run_mamba(torch, dev)
    rep, launches, eng = r["rep"], r["launches"], r["eng"]
    n = sum(math.prod(s) for s in eng.bundle.shapes.values())
    say(f"train mamba2: mamba2-780m full width, {eng.cfg.n_layers} of 48 "
        f"layers ({n} parameters, {len(eng.bundle.shapes)} leaves, f32), "
        "W=4 levels (2, 2), compact+q8, one 4096-token sequence per worker, "
        f"eta 1e-3, {rep.outer_iters} rounds in {r['wall']:.2f} s")
    for k in range(rep.outer_iters):
        say(f"round {k}: {rep.executables[k]} loss={rep.losses[k]:.6f} "
            f"wall_ms={rep.wall_times[k] * 1e3:.1f} "
            f"internode_bytes={rep.comm_bytes_internode[k]} "
            f"launches={launches[k]}")
    walls = [w * 1e3 for w in rep.wall_times[1:]]
    say(f"frozen_at: {rep.frozen_at}; steady median {_median(walls):.1f} ms "
        f"over rounds 1-{rep.outer_iters - 1}; max_memory_allocated: "
        f"{r['peak']} bytes")
    if not all(math.isfinite(x) for x in rep.losses):
        raise AssertionError(f"non-finite losses {rep.losses}")
    if rep.frozen_at != 2:
        raise AssertionError(f"frozen_at {rep.frozen_at} != 2")
    want_b = [MAMBA_BYTES[0]] * 2 + [MAMBA_BYTES[1]] * (rep.outer_iters - 2)
    if rep.comm_bytes_internode != want_b:
        raise AssertionError(f"bytes {rep.comm_bytes_internode}")
    want = mamba_round_launches(eng.bundle.plan, len(eng.bundle.shapes))
    for k, c in enumerate(launches):
        w = dict(want, group_norms_sq=want["group_norms_sq"]
                 if rep.executables[k] == "dynamic" else 0)
        if any(c[name] != v for name, v in w.items()):
            raise AssertionError(f"round {k} launches {c}; expected {w}")
    if r["peak"] >= 60e9:
        raise AssertionError(f"peak {r['peak']} bytes >= 60 GB")
    return r


def profile_mamba(torch, mamba, dev):
    """Phase 6d: one more frozen round of phase 6a's path under the
    profiler (``profile_round``), with the hand kernels' operands recorded:
    each hand kernel's device time and launches in the round beside its
    bytes bound at those operands (the formulas of phase 2), and
    group_norms_sq, which a frozen round does not run, timed on one
    dynamic round's score views (``round_operands``, 2 nodes).  Returns
    the busy share."""
    from repro_torch.kernels import compact, group_norms, wire
    from repro_torch.kernels import fused_prox_sgd as fp
    eng = mamba["eng"]
    # (elements, bytes at the phase 2 formula) of each call, not the
    # operands themselves: holding those would keep the round's gradients
    sized = {
        "fused_prox_sgd_dyn": lambda x, *a, **k: (
            x.numel(), 28.0 * x.numel() + 4.0 * x.shape[0]),
        "quantize_rows": lambda x, *a, **k: (
            x.numel(), 5.0 * x.numel() + 4.0 * x.shape[0]),
        "gather_groups": lambda jobs: (
            sum(_gather_out(x, i, g) for x, i, _, g in jobs),
            sum(_gather_bytes(x, i, g)[0] for x, i, _, g in jobs))}
    calls = {name: [] for name in sized}
    with contextlib.ExitStack() as st:
        for mod, name, entry in ((fp, "fused_prox_sgd_dyn", None),
                                 (wire, "quantize_rows", None),
                                 (compact, "gather_groups", "gather_table")):
            st.enter_context(recorded(mod, entry or name, calls[name],
                                      sized[name]))
        busy, by_name = profile_round(torch, eng, mamba["state"],
                                      mamba["shape"], label="mamba2 frozen",
                                      eta=1e-3)
    rows = {}
    for name, cs in calls.items():   # the warm-up round and the profiled one
        cs = cs[:len(cs) // 2]
        n, nbytes = sum(c[0] for c in cs), sum(c[1] for c in cs)
        ops, tag = {"fused_prox_sgd_dyn": (8.0 * n, "prox_sgd"),
                    "quantize_rows": (7.0 * n, "quantize_rows_kernel"),
                    "gather_groups": (0.0, "gather_table_kernel")}[name]
        ms = sum(v[0] for k, v in by_name.items() if tag in k)
        cnt = sum(v[1] for k, v in by_name.items() if tag in k)
        rows[name] = (ms, cnt, len(cs), n, *bound(nbytes, ops))
    gathers, norms = round_operands(
        torch, eng.bundle, 2, dev,
        {k: m["idx"] for k, m in mamba["state"]["masks"].items()})
    lib_ops = _gather_library(torch, [j for c in gathers for j in c])
    n = sum(v.numel() for v in norms)
    ms, _ = kernel_ms(lambda: [group_norms.group_norms_sq(v)
                               for v in norms], 5)
    lib = {"group_norms_sq": kernel_ms(
        lambda: [_einsum(torch, v) for v in norms], 5)[0],
        "gather_groups": kernel_ms(
        lambda: [torch.take_along_dim(x, i, dim=3) for x, i in lib_ops],
        5)[0]}
    rows["group_norms_sq"] = (ms, len(norms), len(norms), n,
                              *_norms_bound(torch, norms))
    del norms, gathers, lib_ops
    for name, (ms, cnt, ncalls, n, b_ms, b_by) in rows.items():
        say(f"mamba2 kernel {name}: {ms:.4f} ms on the device in "
            f"{cnt} launches ({ncalls} wrapper calls) per "
            + ("dynamic round (timed on its score views)"
               if name == "group_norms_sq" else "frozen round")
            + f", {n} elements; bound {b_ms:.4f} ms ({b_by}), "
            f"{100 * b_ms / ms:.1f}% of it reached; library "
            + (f"{lib[name]:.4f} ms ("
               + ("einsum" if name == "group_norms_sq"
                  else "take_along_dim, expansions from a padded copy")
               + " on one dynamic round's operands)" if name in lib
               else "none"))
    return busy


def wire_phase(torch, dev):
    """``--wire``: quantize_rows, quantize_pack_q4, gather_groups and
    group_norms_sq at phase 2's ResNet-18 operands and at Mamba2's (phase
    6a's configuration: the 17 compact payload leaves of a round at 2
    nodes, one dynamic round's gathers and 9 score views), from seeded
    synthetic data; the checks and times of phase 2, per width class, per
    run width, per launch and per view (quantize_pack_q4 at ResNet's 62
    payload views only: Mamba2 runs no q4 wire); and the codec API's
    fused encodes and decodes (gather_quantize_q4, gather_quantize and
    their decodes) at ResNet's 60 compacted leaves, then the encodes alone
    (``codec_study``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.masks import MaskSyncConfig, budget
    from repro_torch.core.shrinkage import (compact_encode_views,
                                            plan_payload_shapes)
    from repro_torch.models import build
    kernels = []
    for label, cfg, lead in (
            ("resnet18", get_config("resnet18"), 4),
            ("mamba2", get_config("mamba2-780m").replace(
                n_layers=MAMBA_LAYERS, param_dtype="float32"), 2)):
        bundle = build(cfg)
        budgets = {r.name: budget(r, MaskSyncConfig())
                   for r in bundle.plan.rules}
        payload = plan_payload_shapes(bundle.shapes, bundle.plan, budgets)
        for k in check_quantize(torch, payload, lead, dev, label):
            kernels.append(dict(k, operands=label))
        if label == "resnet18":
            views = compact_encode_views(bundle.shapes, bundle.plan,
                                         budgets, lead)
            for k in check_q4_pack(torch, payload, lead, dev, label) \
                    + check_q4(torch, views, dev) \
                    + check_q8_gather(torch, views, dev):
                kernels.append(dict(k, operands=label))
            codec_study(torch, views, dev)
        gathers, norms = round_operands(torch, bundle, lead, dev)
        for k in check_gather(torch, gathers, dev, label):
            kernels.append(dict(k, operands=label))
        del gathers
        for k in check_group_norms(torch, norms, dev, label):
            kernels.append(dict(k, operands=label))
        del norms, bundle
        torch.cuda.empty_cache()
    return kernels


def rounds_phase(torch, dev):
    """``--rounds``: phase 3b's reconfigured run and phase 3's q8 run
    alone, unchecked, printing each round's wall, the steady medians and
    the peak of the full-width rounds: run it in turns with a copy in a
    ``git archive`` of another tree, in one call, to compare the round
    times of two trees (it drives only the port's public entry points)."""
    rc = run_reconfig(torch, dev)
    rep = rc["rep"]
    r = rep.reconfigured_at
    walls = [w * 1e3 for w in rep.wall_times]
    q8 = run_q8(torch, dev)
    w8 = [w * 1e3 for w in q8["rep"].wall_times]
    out = {"reconfigured_walls": walls[r + 1:],
           "reconfigured_median": _median(walls[r + 1:]),
           "full_walls": walls[1:r], "q8_walls": w8[1:],
           "q8_median": _median(w8[1:]),
           "peak_full": max(rc["peaks"][:r])}
    say(f"rounds: {json.dumps(out)}")
    return []


def _slim(r):
    """Keep what a later comparison reads: the final theta and z."""
    r["state"] = {"theta": r["state"]["theta"], "z": r["state"]["z"]}
    return r


def determinism_mamba(torch, dev, first):
    """Phase 6b: phase 6a again, bit-equal; then its first two rounds
    under ``torch.use_deterministic_algorithms`` twice, the kernel route
    against the plain route (``plain_twins``), bit-equal as well."""
    again = _slim(run_mamba(torch, dev))
    compare_runs(torch, first, again, "mamba2")
    del again
    torch.use_deterministic_algorithms(True)
    try:
        kern = _slim(run_mamba(torch, dev, rounds=2))
        with plain_twins():
            plain = _slim(run_mamba(torch, dev, rounds=2))
    finally:
        torch.use_deterministic_algorithms(False)
    kt, pt = kern["totals"], plain["totals"]
    if kt["ssd_chunk_scan"] != 2 * MAMBA_LAYERS * 8 or pt["ssd_chunk_scan"]:
        raise AssertionError(f"route launches: kernel {kt}, plain {pt}")
    compare_runs(torch, kern, plain, "mamba2 kernel route vs plain route")
    say("mamba2 route vs plain: 2 rounds under "
        "torch.use_deterministic_algorithms(True); kernel route "
        f"ssd_chunk_scan launches {kt['ssd_chunk_scan']}, plain route "
        f"{pt['ssd_chunk_scan']}")


def smoke_mamba_cpu_vs_card(torch, dev):
    """Phase 6c: one mamba2-780m smoke round (2 layers, W = 4 at levels
    (2, 2), compact+q8, E = 8, eta 1e-3) through
    ``smoke_round_cpu_vs_card``."""
    eng, shape = mamba_engine(torch, dev, layers=None, smoke=True)
    smoke_round_cpu_vs_card(torch, dev, eng.bundle, eng.spec, shape,
                            ("tokens",), 1e-3, "mamba2 smoke round")


# ---------------------------------------------------------------------------
# phase 8: the paper's baselines and the top-k wire through H-SADMM
# ---------------------------------------------------------------------------

BASELINE_ROUNDS = 3
BASELINE_BYTES = {"ddp": 44_695_848, "topk": 14_300_544, "q8": 11_300_186}
TOPK_ROUND_BYTES = (224_720, 223_760)   # compact+topk:0.01, dynamic/frozen


def baseline_trainer(name):
    """(trainer, keywords) of a phase 8a trainer."""
    from repro_torch.train import baselines
    return {"ddp": (baselines.ddp_train, {}),
            "topk": (baselines.topk_train, {"rate": 0.01}),
            "q8": (baselines.codec_train, {"codec": "q8"})}[name]


def run_baseline(torch, dev, name, rounds=BASELINE_ROUNDS, timed=False):
    """One phase 8a trainer on full-width resnet18 (W = 16, 32 images a
    worker, rounds of E = 8 steps, eta 1e-2, seed 0) through the port's
    entry point, launch counts zeroed just before and read after, the
    peak over the run.  ``timed`` brackets every ``TopKCodec._sparsify``
    call (one a leaf and step) with CUDA events on the stream: their
    device time is the top-k selection's and error feedback's."""
    from repro_torch.comm import TopKCodec
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build
    fn, kw = baseline_trainer(name)
    bundle = build(get_config("resnet18"))
    shape = ShapeConfig("chip_smoke", "train", 32, 32 * 16)
    events = []
    real = TopKCodec._sparsify

    def sparsify(self, x, e):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(self, x, e)
        b.record()
        events.append((a, b))
        return out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with (patched(TopKCodec, "_sparsify", sparsify) if timed
          else contextlib.nullcontext()):
        params, rep = fn(bundle, 16, shape, steps=8 * rounds, eta=1e-2,
                         seed=0, round_steps=8, device=dev, **kw)
    torch.cuda.synchronize()
    return {"params": params, "rep": rep, "wall": time.perf_counter() - t0,
            "peak": torch.cuda.max_memory_allocated(),
            "launches": ops.launch_counts(), "events": events,
            "leaves": len(params)}


def baselines_full(torch, dev) -> dict:
    """Phase 8a: ``ddp_train``, ``topk_train(rate=0.01)`` and
    ``codec_train(codec="q8")`` for 3 rounds each, twice: bytes a step
    44,695,848 / 14,300,544 / 11,300,186, finite losses, no hand-written
    kernel launched by the dense and top-k trainers and one
    ``quantize_rows`` launch a leaf and step by the q8 one; the two runs'
    losses and final params bit-equal.  Prints each trainer's median
    steady round (rounds 2-3), images per second and peak memory, and the
    top-k sparsify's share of a steady Top-K step.  Returns {trainer:
    numbers}."""
    out = {}
    for name in ("ddp", "topk", "q8"):
        a = run_baseline(torch, dev, name, timed=name == "topk")
        b = run_baseline(torch, dev, name)
        for r in (a, b):
            rep = r["rep"]
            steps = 8 * BASELINE_ROUNDS
            got = sorted(set(rep.comm_bytes_internode))
            if len(rep.comm_bytes_internode) != steps \
                    or got != [BASELINE_BYTES[name]]:
                raise AssertionError(f"8a {name}: bytes a step {got}")
            if len(rep.losses) != steps \
                    or not all(math.isfinite(x) for x in rep.losses):
                raise AssertionError(f"8a {name}: losses {rep.losses}")
            want = {"quantize_rows": r["leaves"] * steps} if name == "q8" \
                else {}
            if _nz(r["launches"]) != want:
                raise AssertionError(f"8a {name}: launches "
                                     f"{_nz(r['launches'])}, expected {want}")
        if a["rep"].losses != b["rep"].losses:
            raise AssertionError(f"8a {name}: losses differ between runs: "
                                 f"{a['rep'].losses} vs {b['rep'].losses}")
        d = _first_diff(torch, a["params"], b["params"])
        if d:
            raise AssertionError(f"8a {name}: final {d[0]} differs by up to "
                                 f"{d[1]}")
        rounds = [[w * 8e3 for w in r["rep"].wall_times[::8]]
                  for r in (a, b)]
        med = _median(rounds[0][1:] + rounds[1][1:])
        row = {"bytes_per_step": BASELINE_BYTES[name],
               "round_ms": rounds, "steady_median_ms": med,
               "images_per_s": 16 * 32 * 8 / (med / 1e3),
               "peak_bytes": [a["peak"], b["peak"]],
               "losses": a["rep"].losses[::8] + a["rep"].losses[-1:]}
        if name == "topk":
            steady = a["events"][a["leaves"] * 8:]
            per_step = sum(x.elapsed_time(y) for x, y in steady) \
                / (8 * (BASELINE_ROUNDS - 1))
            step_ms = _median(rounds[0][1:]) / 8
            row.update(sparsify_ms_per_step=per_step,
                       sparsify_launch_pairs=len(a["events"]),
                       sparsify_share=per_step / step_ms)
        say(f"8a {name}: {json.dumps(row)}")
        say(f"8a {name}: two runs from seed 0 bit-equal in losses and final "
            f"params ({a['leaves']} leaves); launches {_nz(a['launches'])}")
        out[name] = row
        del a, b
    return out


def topk_engine(torch, dev, levels=(4, 4)):
    """Phase 8b's engine: phase 3's with a compact+topk:0.01 inter-node
    wire."""
    eng, shape = q8_engine(torch, dev, levels)
    return eng.with_wire(inter="compact+topk:0.01"), shape


def check_topk_rounds(r):
    """Every round of a phase 8b run: bytes of its kind, phase 3's prox,
    gather and group-norm launches, and no quantize launch."""
    rep, launches = r["rep"], r["launches"]
    gathers, views = round_launches(r["eng"].bundle.plan)
    leaves = len(r["state"]["theta"])
    for k, c in enumerate(launches):
        dyn = rep.executables[k] == "dynamic"
        if rep.comm_bytes_internode[k] != TOPK_ROUND_BYTES[0 if dyn else 1]:
            raise AssertionError(f"8b round {k} bytes "
                                 f"{rep.comm_bytes_internode[k]}")
        want = {"fused_prox_sgd_dyn": leaves * 8, "gather_groups": gathers}
        if dyn:
            want["group_norms_sq"] = views
        if _nz(c) != want:
            raise AssertionError(f"8b round {k} launches {_nz(c)}, "
                                 f"expected {want}")


def _wire_leaves(state) -> dict:
    return _leaves({"wire": state["wire"]})


def topk_hsadmm(torch, dev, d):
    """Phase 8b: H-SADMM over a compact+topk:0.01 inter-node wire at
    levels (4, 4), 4 rounds (masks frozen at round 3) saving at round 4;
    the restore is bit-equal in every leaf, the wire residuals among
    them; ``train`` to 5 rounds resumes from it twice, bit-equal (wire
    residuals too); then the restored state is migrated onto the budget-B
    ResNet and one frozen round runs there, its loss finite."""
    from repro_torch.data.pipeline import batches, superbatches
    from repro_torch.data.synthetic import make_stream
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.train.loop import round_comm_bytes
    r = run_path(torch, topk_engine(torch, dev), 4, 1e-2, ckpt_dir=d,
                 ckpt_every=4, ckpt_keep=1)
    rep = r["rep"]
    if rep.frozen_at != 3 or rep.wire_map != ["dense", "compact+topk:0.01"] \
            or not all(math.isfinite(x) for x in rep.losses):
        raise AssertionError(f"8b: frozen_at {rep.frozen_at}, wire "
                             f"{rep.wire_map}, losses {rep.losses}")
    if round_comm_bytes(r["eng"]) != (44_695_848,) + TOPK_ROUND_BYTES:
        raise AssertionError(f"8b bytes {round_comm_bytes(r['eng'])}")
    check_topk_rounds(r)
    wire = _wire_leaves(r["state"])
    if len(wire) != len(r["state"]["theta"]) \
            or not all(k.startswith("wire/1/") for k in wire) \
            or not any(bool(t.any()) for t in wire.values()):
        raise AssertionError(f"8b: wire residuals {sorted(wire)[:3]}...")
    say(f"8b train: rounds {rep.executables}, losses {rep.losses}, bytes "
        f"{rep.comm_bytes_internode}, round wall_ms "
        f"{[round(w * 1e3, 1) for w in rep.wall_times]}, launches "
        f"{[_nz(c) for c in r['launches']]}, peak {r['peak']} bytes, "
        f"{len(wire)} residual leaves "
        f"({sum(t.numel() for t in wire.values())} values)")
    t0 = time.perf_counter()
    back, _ = ckpt.restore(ckpt.latest(d), r["state"])
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    n = _assert_states_equal(torch, back, r["state"], "8b restore")
    say(f"8b checkpoint: restore bit-equal in {n} leaves ({len(wire)} wire "
        f"residuals) in {t_restore:.3f} s")
    del r
    runs = [run_path(torch, topk_engine(torch, dev), 5, 1e-2, ckpt_dir=d,
                     ckpt_every=0) for _ in range(2)]
    for x in runs:
        if x["rep"].outer_iters != 5 or x["rep"].executables != ["dynamic"] \
                or not all(math.isfinite(v) for v in x["rep"].losses):
            raise AssertionError(f"8b resumed: {x['rep'].executables}, "
                                 f"losses {x['rep'].losses}")
        check_topk_rounds(x)
    compare_runs(torch, runs[0], runs[1], "compact+topk:0.01 resumed from "
                 "step 4")
    d8 = _first_diff(torch, _wire_leaves(runs[0]["state"]),
                     _wire_leaves(runs[1]["state"]))
    if d8:
        raise AssertionError(f"8b resumed: residual {d8[0]} differs")
    say(f"8b resumed twice: losses {runs[0]['rep'].losses}, wire residuals "
        "bit-equal, round wall_ms "
        f"{[round(x['rep'].wall_times[0] * 1e3, 1) for x in runs]}")
    del runs
    eng, shape = topk_engine(torch, dev)
    t0 = time.perf_counter()
    eng2, st2 = eng.reconfigure(back)
    torch.cuda.synchronize()
    t_mig = time.perf_counter() - t0
    del back
    sb = next(superbatches(batches(make_stream(eng2.cfg, shape, 16,
                                               device=dev)), 8))
    st2, m = eng2.round_step_fn(frozen=True)(
        st2, sb, torch.tensor(1e-2, device=dev))
    loss = m.losses[-1].item()
    b2 = round_comm_bytes(eng2)
    if not math.isfinite(loss) or b2[2] != TOPK_ROUND_BYTES[1]:
        raise AssertionError(f"8b reconfigured round: loss {loss}, bytes "
                             f"{b2}")
    say(f"8b reconfigured: {sum(t.numel() for t in st2['z'][-1].values())} "
        f"parameters, migration {t_mig:.3f} s, one frozen round loss "
        f"{loss:.6f}, bytes {b2[2]}, residual leaves "
        f"{len(_wire_leaves(st2))}")


def baselines_cpu_vs_card(torch, dev):
    """Phase 8c: one resnet-smoke DDP round (W = 4, E = 8, eta 1e-2) on the
    card and on the CPU: losses and params within rtol 1e-4; and
    ``TopKCodec.group_reduce`` (rate 0.01, weighted, from a nonzero
    residual) on identical inputs at full-width leaf shapes, Gaussian and
    tied: the selection and the residuals bit-equal, the sums within rtol
    1e-6."""
    import numpy as np
    from repro_torch.comm import TopKCodec, topk_mask
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.models import build
    from repro_torch.train.baselines import ddp_train
    bundle = build(get_config("resnet18", smoke=True))
    shape = ShapeConfig("s", "train", 16, 16)
    out = {str(x): ddp_train(bundle, 4, shape, steps=8, eta=1e-2,
                             round_steps=8, device=x)
           for x in ("cpu", dev)}
    (pc, rc), (pg, rg) = out["cpu"], out[str(dev)]
    np.testing.assert_allclose(rg.losses, rc.losses, rtol=1e-4)
    worst = 0.0
    for k in pc:
        x, y = pc[k].numpy(), pg[k].cpu().numpy()
        np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-6, err_msg=k)
        worst = max(worst, float(np.max(np.abs(y - x))))
    gen = torch.Generator().manual_seed(0)
    shapes = {"conv": (4, 3, 3, 256, 256), "fc_w": (4, 512, 10),
              "gn": (4, 512)}
    tree = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    tree["tied"] = torch.randint(-3, 4, (4, 64, 64), generator=gen).float()
    state = {k: 0.1 * torch.randn(x.shape, generator=gen)
             for k, x in tree.items()}
    w = torch.linspace(0.5, 1.5, 4)
    codec = TopKCodec(0.01)
    red_c, st_c = codec.group_reduce(tree, 2, w, state)
    red_g, st_g = codec.group_reduce(
        {k: x.to(dev) for k, x in tree.items()}, 2, w.to(dev),
        {k: x.to(dev) for k, x in state.items()})
    for k in tree:
        flat = (tree[k] * w.reshape((-1,) + (1,) * (tree[k].ndim - 1))
                + state[k]).reshape(4, -1).abs()
        kk = codec.k_of(flat.shape[-1])
        if not torch.equal(topk_mask(flat, kk),
                           topk_mask(flat.to(dev), kk).cpu()):
            raise AssertionError(f"8c top-k selection of {k} differs")
        if not torch.equal(st_c[k], st_g[k].cpu()):
            raise AssertionError(f"8c top-k residual of {k} differs")
        np.testing.assert_allclose(red_g[k].cpu().numpy(),
                                   red_c[k].numpy(), rtol=1e-6, err_msg=k)
    say(f"8c DDP smoke round card vs CPU: losses and params within rtol 1e-4 "
        f"(max abs diff {worst}); top-k selection and residuals bit-equal "
        f"on {sorted(tree)}")


def baselines_phase(torch, dev):
    """Phase 8 (``--baselines`` runs it alone after phase 1)."""
    out = baselines_full(torch, dev)
    say("phase 8a baselines at full width: ok")
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        topk_hsadmm(torch, dev, d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    say("phase 8b H-SADMM over compact+topk:0.01: ok")
    baselines_cpu_vs_card(torch, dev)
    say("phase 8c baselines card vs CPU: ok")
    return out


def main(argv) -> int:
    if argv not in ([], ["--ssd"], ["--wire"], ["--rounds"],
                    ["--baselines"]):
        return fail("usage: chip_smoke.py [--ssd | --wire | --rounds | "
                    f"--baselines] (got {argv})")
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA card: torch.cuda.is_available() is False")
    try:
        from repro_torch.kernels import _build
        from repro_torch.models import build
        from repro_torch.configs import get_config
        from repro_torch.core.shrinkage import (compact_encode_views,
                                                plan_payload_shapes)
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
            for line in ptxas_lines(log):
                say(f"  ptxas {name}: {line}")
        if argv:   # --ssd: phase 6; --wire: the wire kernels; --rounds;
            # --baselines: phase 8
            if argv[0] == "--baselines":
                baselines_phase(torch, dev)
                kernels = []
            else:
                kernels = {"--ssd": check_ssd, "--wire": wire_phase,
                           "--rounds": rounds_phase}[argv[0]](torch, dev)
            for line in smi:
                say(line)
            say(json.dumps({"kernels": kernels}))
            return 0

        bundle = build(get_config("resnet18"))
        budgets = {r.name: budget(r, MaskSyncConfig()) for r in
                   bundle.plan.rules}
        payload = plan_payload_shapes(bundle.shapes, bundle.plan, budgets)
        views = compact_encode_views(bundle.shapes, bundle.plan, budgets, 4)
        kernels = check_prox(torch, bundle.shapes, 16, dev)
        kernels += check_quantize(torch, payload, 4, dev)
        kernels += check_q4_pack(torch, payload, 4, dev)
        kernels += check_q4(torch, views, dev)
        gathers, norms = round_operands(torch, bundle, 4, dev)
        kernels += check_gather(torch, gathers, dev)
        kernels += check_q8_gather(torch, views, dev)
        kernels += check_group_norms(torch, norms, dev)
        del gathers, norms
        say("phase 2 kernels vs plain: ok")

        full = train_full(torch, dev)
        totals = full["totals"]
        phase3 = {k: full[k] for k in ("builds", "calls", "rep")}
        say(f"phase 3 train: ok, launches {totals}")

        det_on, det_off = determinism_q8(torch, dev, full)
        say("phase 3a determinism: ok")

        api = codec_api(torch, full["state"], full["eng"].bundle.plan)
        say("phase 3c q4 codec API: ok")

        api8 = codec_api_dense_q8(torch, full["state"],
                                  full["eng"].bundle.plan)
        say("phase 3d dense and q8 codec API: ok")

        route_vs_plain(torch, dev)
        say("phase 3e kernel route vs plain route: ok")

        busy, _ = profile_round(torch, full["eng"], full["state"],
                                full["shape"])
        rep, peak = full["rep"], full["peak"]
        del full
        say("phase 5 profile: ok")

        d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            saved = ckpt_q8(torch, dev, d)
            say("phase 7a checkpoint and resume, q8: ok")
            elastic_q8(torch, dev, d, saved)
            del saved
            say("phase 7b elastic restore: ok")
        finally:
            shutil.rmtree(d, ignore_errors=True)

        rc = train_reconfig(torch, dev)
        say(f"phase 3b train with reconfiguration: ok, launches "
            f"{rc['totals']}")
        rc_rep, mem = rc["rep"], rc["mem"]
        d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            # the second run saves every 2 rounds: saving perturbs nothing
            rc2 = train_reconfig(torch, dev, ckpt_dir=d, ckpt_every=2,
                                 ckpt_keep=1)
            compare_runs(torch, rc, rc2, "q4 with reconfiguration, the "
                         "second run saving every 2 rounds")
            del rc2
            say("phase 3b determinism: ok")
            reconfig_resume(torch, dev, d)
            say("phase 7c reconfigured resume, q4: ok")
        finally:
            shutil.rmtree(d, ignore_errors=True)

        rc_busy, _ = profile_round(torch, rc["eng"], rc["state"],
                                   rc["shape"], label="reconfigured")
        rc_totals = rc["totals"]
        del rc
        say("phase 5b profile: ok")

        smoke_resnet_cpu_vs_card(torch, dev)
        say("phase 4 smoke round card vs CPU: ok")

        smoke_reconfig_cpu_vs_card(torch, dev)
        say("phase 4b smoke reconfigured round card vs CPU: ok")

        ft_monitor(torch, dev, phase3)
        say("phase 7d fault tolerance and the monitor: ok")

        kernels += check_ssd(torch, dev)
        say("phase 6 ssd_chunk_scan vs plain: ok")

        mamba = train_mamba(torch, dev)
        m_rep, m_peak, m_totals = mamba["rep"], mamba["peak"], \
            mamba["totals"]
        say(f"phase 6a train mamba2: ok, launches {m_totals}")

        m_busy = profile_mamba(torch, mamba, dev)
        say("phase 6d profile: ok")

        determinism_mamba(torch, dev, _slim(mamba))
        del mamba
        say("phase 6b determinism: ok")

        smoke_mamba_cpu_vs_card(torch, dev)
        say("phase 6c mamba2 smoke round card vs CPU: ok")

        base = baselines_phase(torch, dev)

        # the main paths' end-to-end numbers again, next to the result
        say("summary: round wall_ms "
            f"{[round(w * 1e3, 1) for w in rep.wall_times]}, losses "
            f"{[round(x, 4) for x in rep.losses]}, frozen_at "
            f"{rep.frozen_at}, peak {peak} bytes, device busy {busy:.1f}% "
            "of a frozen round's span; steady median with "
            f"cudnn.deterministic on {det_on:.1f} ms, off {det_off:.1f} ms")
        say("summary reconfig: round wall_ms "
            f"{[round(w * 1e3, 1) for w in rc_rep.wall_times]}, losses "
            f"{[round(x, 4) for x in rc_rep.losses]}, executables "
            f"{rc_rep.executables}, migration "
            f"{rc_rep.reconfig_seconds * 1e3:.1f} ms, peak full-width "
            f"{mem['peak_full']} / reconfigured {mem['peak_reconfigured']} "
            f"bytes, device busy {rc_busy:.1f}% of a reconfigured round's "
            "span")
        say("summary mamba2: round wall_ms "
            f"{[round(w * 1e3, 1) for w in m_rep.wall_times]}, losses "
            f"{[round(x, 4) for x in m_rep.losses]}, frozen_at "
            f"{m_rep.frozen_at}, peak {m_peak} bytes, device busy "
            f"{m_busy:.1f}% of a frozen round's span")
        say("summary baselines: " + ", ".join(
            f"{n} steady median {b['steady_median_ms']:.1f} ms, "
            f"{b['images_per_s']:.0f} images/s, peak {max(b['peak_bytes'])} "
            f"bytes, {b['bytes_per_step']} bytes a step" for n, b in
            base.items()) + f"; top-k sparsify "
            f"{base['topk']['sparsify_ms_per_step']:.2f} ms a step, "
            f"{100 * base['topk']['sparsify_share']:.1f}% of a Top-K step")
    except Exception as e:   # any phase failing fails the run, loudly
        import traceback
        traceback.print_exc()
        return fail(f"{type(e).__name__}: {e}")

    # launches: each kernel's count on the path that runs it (phase 3 for
    # prox-SGD, quantize_rows, the gather and the group norms, 3b for the
    # q4 quantizer, 3c for the q4 codec API's gather and unpack kernels,
    # 3d for the q8 codec API's gather kernels, 6a for the SSD scan)
    paths = {"quantize_pack_q4": ("3b", rc_totals),
             "ssd_chunk_scan": ("6a", m_totals),
             "gather_quantize_q4": ("3c", api),
             "unpack_gather_dequantize_q4": ("3c", api),
             "gather_quantize": ("3d", api8),
             "gather_dequantize": ("3d", api8)}
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
    sys.exit(main(sys.argv[1:]))
