"""Baseline trainers (paper §5.1.4): dense synchronous DDP and Top-K
gradient compression — port of ``repro/train/baselines.py``, in the same
leading-worker-dim layout as H-SADMM so that the byte accounting compares
directly.

Both are the SAME trainer (:func:`codec_train`) with a different
:class:`repro_torch.comm.WireCodec`: the per-step gradient exchange and
the byte accounting route through the codec, as the H-SADMM consensus
boundaries do; ``ddp_train``/``topk_train`` keep the reference's keyword
surfaces.

They run the H-SADMM loop's round shape: a round of ``round_steps`` SGD
steps over a stacked ``(E, W, ...)`` superbatch (assembled in a prefetch
thread), per-step losses kept on the device and drained once a round.
The W workers' gradients come from ``vmap`` of the H-SADMM local step's
:func:`~repro_torch.core.hsadmm.grad_and_value`, and the trainer binds the
card settings the ``Engine`` binds (``device.bind_card_settings``), so a
DDP step and an H-SADMM step run the same convolutions.  Like every entry
point of the port they run on the card unless the caller asks for the CPU
(``device="cpu"``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch
from torch.func import vmap

from ..comm import WireCodec, get_codec
from ..configs.base import ShapeConfig
from ..core.hsadmm import grad_and_value
from ..data.pipeline import batches, prefetch, superbatch_chunks
from ..data.synthetic import make_stream
from ..device import bind_card_settings, resolve_device


@dataclass
class BaselineReport:
    losses: list = field(default_factory=list)
    comm_bytes_internode: list = field(default_factory=list)
    wall_times: list = field(default_factory=list)


def step_wire_bytes(codec: WireCodec, params: dict, workers: int) -> int:
    """Inter-node bytes one SGD step moves under ``codec``: per-leaf
    ``wire_bytes`` (value width from the leaf's dtype), times the worker
    count for AllGather codecs (per-member supports differ, so every
    worker's payload crosses the fabric: the paper's Table 1 criticism)."""
    per = sum(codec.wire_bytes(tuple(x.shape), x.dtype)
              for x in params.values())
    return per * (workers if codec.gather else 1)


def codec_train(bundle, workers: int, shape: ShapeConfig, *, steps: int,
                codec: "WireCodec | str" = "dense", eta=1e-3, momentum=0.9,
                seed=0, round_steps: int = 8, log=None, tag: str = None,
                device=None):
    """Synchronous data-parallel SGD whose per-step gradient mean is
    exchanged through a :class:`repro_torch.comm.WireCodec` (dense
    AllReduce, q8 ring, top-k + error feedback, ...).  Stateful codecs
    thread their error-feedback state through the steps and across
    rounds.  Returns (one worker's final params, :class:`BaselineReport`);
    ``wall_times`` holds each step's share of its round, on the host clock
    around the round's synchronizing drain."""
    codec = get_codec(codec)
    tag = tag or codec.name
    device = bind_card_settings(resolve_device(device))
    W = workers
    p0 = bundle.init(torch.Generator().manual_seed(seed), device)
    params = {k: x[None].expand((W,) + tuple(x.shape)).clone()
              for k, x in p0.items()}
    mom = {k: torch.zeros_like(x) for k, x in params.items()}
    wire = codec.init_state(params) if codec.stateful else {}
    stream = make_stream(bundle.cfg, shape, W, device=device)
    chunks = prefetch(superbatch_chunks(batches(stream), max(round_steps, 1),
                                        steps))
    inv_w = torch.tensor(1.0 / W, dtype=torch.float32, device=device)
    eta_t = torch.tensor(eta, dtype=torch.float32, device=device)
    grads = vmap(grad_and_value(bundle.train_loss))

    def step(params, mom, wire, batch):
        g, losses = grads(params, batch)
        red, wire = codec.group_reduce(g, W, None, wire)
        mom = {k: momentum * m + (red[k] * inv_w.to(red[k].dtype))
               .expand(m.shape) for k, m in mom.items()}
        params = {k: p - eta_t.to(p.dtype) * mom[k]
                  for k, p in params.items()}
        return params, mom, wire, losses.mean()

    rep = BaselineReport()
    pbytes = step_wire_bytes(codec, p0, W)
    s = 0
    try:
        for n, sb in chunks:
            t0 = time.perf_counter()
            losses = []
            for e in range(n):
                params, mom, wire, loss = step(
                    params, mom, wire, {k: v[e] for k, v in sb.items()})
                losses.append(loss)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            losses = torch.stack(losses).tolist()   # the round's one drain
            dt = (time.perf_counter() - t0) / n
            rep.losses.extend(losses)
            rep.comm_bytes_internode.extend([pbytes] * n)
            rep.wall_times.extend([dt] * n)
            if log and (s // 20) != ((s + n) // 20):
                log(f"[{tag}] step={s + n - 1} loss={rep.losses[-1]:.4f}")
            s += n
    finally:
        chunks.close()   # stops the prefetch thread and frees its batches
    return {k: x[0] for k, x in params.items()}, rep


def ddp_train(bundle, workers: int, shape: ShapeConfig, *, steps: int,
              eta=1e-3, momentum=0.9, seed=0, round_steps: int = 8,
              log=None, codec: "WireCodec | str" = "dense", device=None):
    """Dense synchronous DDP: per-step gradient mean over all workers
    (ring AllReduce semantics); inter-node bytes a step = the full param
    size.  ``codec`` swaps the wire format (kept "dense" for the paper
    row)."""
    return codec_train(bundle, workers, shape, steps=steps, codec=codec,
                       eta=eta, momentum=momentum, seed=seed,
                       round_steps=round_steps, log=log, tag="ddp",
                       device=device)


def topk_train(bundle, workers: int, shape: ShapeConfig, *, steps: int,
               rate=0.01, eta=1e-3, momentum=0.9, seed=0,
               round_steps: int = 8, log=None,
               codec: "WireCodec | str" = None, device=None):
    """Top-K (rate=0.01 = top 1%, the paper's setting) with error feedback
    — the ``topk:<rate>`` codec: values + int32 indices, AllGather
    semantics, residual accumulated locally.  An explicit ``codec``
    overrides the rate-derived one."""
    return codec_train(bundle, workers, shape, steps=steps,
                       codec=codec or f"topk:{rate}", eta=eta,
                       momentum=momentum, seed=seed,
                       round_steps=round_steps, log=log, tag="topk",
                       device=device)
