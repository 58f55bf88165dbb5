"""Shared LM layers — the part of ``repro/models/layers.py`` that the SSM
family calls: the dense initializer, RMSNorm, the embedding lookup and
the next-token cross-entropy over chunks of the sequence.

Norms and the loss compute in f32 whatever the parameter dtype.  The
reference's sharding hints (``constrain_seq``, ``set_batch_axis``) have
no counterpart on one card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ref


def dense_init(generator: torch.Generator, shape, in_axis_size=None):
    """N(0, 1/fan_in) f32 draw from a CPU ``generator`` (fan_in =
    ``in_axis_size`` or ``shape[0]``)."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    return torch.randn(tuple(shape), generator=generator) \
        / math.sqrt(max(fan_in, 1))


def rms_norm(x, w, eps=1e-5):
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def embed_lookup(emb, tokens):
    """Rows of ``emb`` (V, d) at ``tokens``.  ``F.embedding``'s backward
    sums the rows of repeated tokens by a sort and segment sums, in a
    fixed order on the card (an index's backward would scatter-add)."""
    return F.embedding(tokens.long(), emb)


def chunked_xent(h, emb_out, targets, valid=None, chunk=512):
    """Next-token cross-entropy, the logits computed ``chunk`` tokens at a
    time.  h: (B, T, d) hidden states, emb_out: (V, d) output embedding,
    targets: (B, T) int; ``valid`` (B, T) f32 weights the tokens.

    The true logit is a masked sum, not a gather: the gather's backward is
    a scatter-add, which accumulates in no fixed order on the card; a sum
    of one logit and zeros is the logit, bit for bit.  Autograd keeps each
    chunk's logits for the backward (nothing is recomputed under
    ``torch.func`` transforms), so the chunking bounds the forward's
    transient memory, not the saved logits."""
    B, T, d = h.shape
    c = ref.chunk_len(T, chunk)
    V = emb_out.shape[0]
    vocab = torch.arange(V, device=h.device)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, T, c):
        hc, tc = h[:, i:i + c], targets[:, i:i + c].long()
        logits = torch.einsum("btd,vd->btv", hc, emb_out).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        tl = torch.sum(torch.where(vocab == tc[..., None], logits, 0.0),
                       dim=-1)
        loss = lse - tl
        if valid is not None:
            loss = loss * valid[:, i:i + c]
        tot = tot + torch.sum(loss)
    cnt = torch.as_tensor(float(B * T), device=h.device) if valid is None \
        else torch.sum(valid)
    return tot / torch.clamp_min(cnt, 1.0)


def causal_targets(tokens):
    """(tokens[:, :-1] predicts tokens[:, 1:]) folded to the same length:
    the last position's target wraps to the first token, with weight 0."""
    tgt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    valid = torch.cat(
        [torch.ones(tokens[:, 1:].shape, dtype=torch.float32,
                    device=tokens.device),
         torch.zeros(tokens[:, :1].shape, dtype=torch.float32,
                     device=tokens.device)], dim=1)
    return tgt, valid
