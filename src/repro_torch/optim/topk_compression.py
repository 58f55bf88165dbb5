"""Top-K gradient compression with error feedback — the paper's baseline
(§5.1.4, Lin et al. DGC), per worker.  Each worker transmits only the top
``rate`` fraction of gradient entries by magnitude per leaf; the residual
accumulates locally (error feedback).  The exchanged representation is
values + int32 indices with AllGather semantics; its bytes come from the
``topk:<rate>`` codec's ``wire_bytes`` (4 bytes of index plus the value
dtype's width per entry), so there is one formula.

The system-level exchange is :class:`repro_torch.comm.TopKCodec`, which
the baselines and the consensus boundaries route through; this module
keeps the per-worker functional form on the codec's sparsify (one leaf is
one member).
"""
from __future__ import annotations

import torch

from ..comm import TopKCodec


def topk_compress_state(params: dict) -> dict:
    """Error-feedback residual, one per leaf (worker-local)."""
    return {k: torch.zeros_like(x) for k, x in params.items()}


def topk_grad_exchange(grads: dict, err: dict, rate=0.01, axis_sum=None
                       ) -> tuple[dict, dict, int]:
    """Per-worker top-k sparsify + error feedback.  Returns (dense-restored
    gradient, new error state, bytes-per-worker payload).

    ``axis_sum(x)`` performs the cross-worker mean of the sparsified dense
    tensors (the simulation of the AllGather-and-sum exchange)."""
    codec = TopKCodec(rate)
    sparse, new_err, payload = {}, {}, 0
    for k, g in grads.items():
        # the codec's per-member sparsify, the whole leaf one member
        s, e = codec._sparsify(g[None], err[k][None])
        sparse[k], new_err[k] = s[0], e[0]
        payload += codec.wire_bytes(tuple(g.shape), g.dtype)
    if axis_sum is not None:
        sparse = {k: axis_sum(x) for k, x in sparse.items()}
    return sparse, new_err, payload
