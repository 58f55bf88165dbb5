"""Shared LM layers — the part of ``repro/models/layers.py`` that the SSM
and dense families train with: the dense initializer, RMSNorm, the
embedding lookup, the next-token cross-entropy over chunks of the
sequence, rotary position embedding, GQA attention over chunks
(:class:`ChunkedAttention`) and the SwiGLU MLP.

Norms, softmax and the loss compute in f32 whatever the parameter dtype.
The reference's sharding hints (``constrain_seq``, ``set_batch_axis``)
have no counterpart on one card.  Attention here is the training path:
the KV cache, ``kv_len``/``q_offset`` and cross-attention wait for
serving and the VLM.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ref

NEG_INF = -1e30


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


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope(x, positions, theta=10000.0):
    """RoPE on (..., T, H*, hd) at ``positions`` (..., T).  The pairing is
    interleaved (GPT-J style, the reference's): pairs (2i, 2i+1) rotate
    together, not the two halves of hd."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    nhead = x.ndim - positions.ndim - 1   # broadcast dims for head axes
    ang = positions[..., None].to(torch.float32) * freqs   # (..., T, half)
    ang = ang.reshape(tuple(ang.shape[:-1]) + (1,) * nhead + (half,))
    sin, cos = torch.sin(ang), torch.cos(ang)
    xp = x.reshape(tuple(x.shape[:-1]) + (half, 2))
    x1, x2 = xp[..., 0], xp[..., 1]
    y = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# chunked two-pass attention
# ---------------------------------------------------------------------------


def _scores(qblk, kblk, qpos, kpos, scale, causal):
    """(B, KV, G, qc, kc) f32 scores of one (q chunk, k chunk) block, the
    masked ones set to NEG_INF."""
    s = torch.einsum("bqkgh,bskh->bkgqs", qblk.to(torch.float32),
                     kblk.to(torch.float32)) * scale
    if not causal:
        return s
    keep = qpos[:, None] >= kpos[None, :]
    return torch.where(keep, s, NEG_INF)


def attention_chunk(qblk, k, v, q0: int, *, causal: bool, k_chunk: int):
    """One q chunk of the reference's ``chunked_attention`` (no cache):
    qblk (B, qc, KV, G, hd) holding the queries at positions q0.. (a query
    at position i sees the keys at positions <= i), k/v (B, S, KV, hd) ->
    (B, qc, KV, G, hd) in q's dtype.

    Pass 1 takes the exact row max over the k chunks from detached
    operands (the reference's stop-gradient softmax stabilizer), clamped
    at -1e28 for fully masked rows; pass 2 sums ``p = exp(s - m)`` and
    ``p @ v`` over the k chunks in f32.  Under plain autograd every
    (q chunk, k chunk) block's intermediates are kept for the backward.

    A causal block whose keys all lie past the chunk's last query is
    skipped: the reference computes it, but its scores are all NEG_INF,
    so it leaves the row max as it is, its ``p`` is exactly 0 and its
    terms are exact zeros, in the forward and in the VJP.  Skipping it
    changes no bit of the output and no value of a gradient, and halves
    the blocks (and the launches) of a causal sequence."""
    B, qc, KV, G, hd = qblk.shape
    S = k.shape[1]
    kc = ref.chunk_len(S, k_chunk)
    scale = 1.0 / math.sqrt(hd)
    qpos = torch.arange(q0, q0 + qc, device=qblk.device)
    js = [j for j in range(0, S, kc) if not causal or j < q0 + qc]
    kpos = [torch.arange(j, j + kc, device=k.device) for j in js]
    m = torch.full((B, KV, G, qc), NEG_INF, dtype=torch.float32,
                   device=qblk.device)
    qd = qblk.detach()
    for i, j in enumerate(js):
        s = _scores(qd, k[:, j:j + kc].detach(), qpos, kpos[i], scale,
                    causal)
        m = torch.maximum(m, s.amax(dim=-1))
    m = torch.clamp_min(m, -1e28)[..., None]
    A = torch.zeros((B, KV, G, qc, hd), dtype=torch.float32,
                    device=qblk.device)
    l = torch.zeros((B, KV, G, qc), dtype=torch.float32, device=qblk.device)
    for i, j in enumerate(js):
        s = _scores(qblk, k[:, j:j + kc], qpos, kpos[i], scale, causal)
        p = torch.exp(s - m)
        vblk = v[:, j:j + kc]
        A = A + torch.einsum("bkgqs,bskh->bkgqh",
                             p.to(vblk.dtype).to(torch.float32),
                             vblk.to(torch.float32))
        l = l + p.sum(dim=-1)
    out = A / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 3, 1, 2, 4).to(qblk.dtype)


def chunked_attention_ref(q, k, v, *, causal=True, q_chunk=512,
                          k_chunk=512):
    """The reference's ``chunked_attention`` (no cache) as one plain
    function: q (B, T, KV, G, hd), k/v (B, S, KV, hd) -> (B, T, KV, G,
    hd), the q chunks (``ref.chunk_len``) one after another.  Plain
    autograd through it keeps every score block; :class:`ChunkedAttention`
    is the same forward with a backward that recomputes them."""
    T = q.shape[1]
    qc = ref.chunk_len(T, q_chunk)
    off = k.shape[1] - T   # the reference's suffix alignment
    return torch.cat([attention_chunk(q[:, i:i + qc], k, v, off + i,
                                      causal=causal, k_chunk=k_chunk)
                      for i in range(0, T, qc)], dim=1)


class ChunkedAttention(torch.autograd.Function):
    """:func:`chunked_attention_ref` with bounded memory.

    Forward: the plain function, nothing recorded.  Backward: the VJP of
    :func:`attention_chunk` recomputed one q chunk at a time from the
    saved q, k and v, so at most one q chunk's score blocks are alive (the
    reference's ``jax.checkpoint`` of both passes).  ``vmap`` (the worker
    axis of ``local_step``) folds the vmapped dim into the batch rows."""

    @staticmethod
    def forward(q, k, v, causal, q_chunk, k_chunk):
        return chunked_attention_ref(q, k, v, causal=causal,
                                     q_chunk=q_chunk, k_chunk=k_chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, q_chunk, k_chunk = inputs
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.q_chunk, ctx.k_chunk = causal, q_chunk, k_chunk

    @staticmethod
    def backward(ctx, gout):
        q, k, v = ctx.saved_tensors
        T = q.shape[1]
        qc = ref.chunk_len(T, ctx.q_chunk)
        off = k.shape[1] - T
        dq, dk, dv = [], torch.zeros_like(k), torch.zeros_like(v)
        for i in range(0, T, qc):
            def chunk(qb, kk, vv, q0=off + i):
                return attention_chunk(qb, kk, vv, q0, causal=ctx.causal,
                                       k_chunk=ctx.k_chunk)
            _, vjp = torch.func.vjp(chunk, q[:, i:i + qc], k, v)
            gq, gk, gv = vjp(gout[:, i:i + qc])
            dq.append(gq)
            dk, dv = dk + gk, dv + gv
        return torch.cat(dq, dim=1), dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, q_chunk, k_chunk):
        n = info.batch_size
        q, k, v = (fold_vmapped(t, d, n)
                   for t, d in zip((q, k, v), in_dims[:3]))
        out = ChunkedAttention.apply(q, k, v, causal, q_chunk, k_chunk)
        return out.reshape((n, -1) + tuple(out.shape[1:])), 0


def fold_vmapped(t, bdim, n: int):
    """A vmapped operand with its vmap dim (or None) -> the logical batch
    rows of all ``n`` vmapped instances as one leading dim."""
    t = t[None].expand((n,) + tuple(t.shape)) if bdim is None \
        else t.movedim(bdim, 0)
    return t.reshape((n * t.shape[1],) + tuple(t.shape[2:]))


def chunked_attention(q, k, v, *, causal=True, q_chunk=512, k_chunk=512):
    """q: (B, T, KV, G, hd), k/v: (B, S, KV, hd) -> (B, T, KV, G, hd)
    through :class:`ChunkedAttention`."""
    return ChunkedAttention.apply(q, k, v, causal, q_chunk, k_chunk)


# ---------------------------------------------------------------------------
# GQA attention block and SwiGLU
# ---------------------------------------------------------------------------


def init_attention(generator: torch.Generator, d, n_heads, n_kv, hd,
                   qkv_bias=False) -> dict:
    """GQA attention leaves with an explicit group axis, f32 on the CPU:
    wq (d, KV, G, hd) and wo (KV, G, hd, d) with G = n_heads // n_kv, so
    head pruning removes whole GQA groups along one axis."""
    G = n_heads // n_kv
    p = {"wq": dense_init(generator, (d, n_kv, G, hd), d),
         "wk": dense_init(generator, (d, n_kv, hd), d),
         "wv": dense_init(generator, (d, n_kv, hd), d),
         "wo": dense_init(generator, (n_kv, G, hd, d), n_heads * hd)}
    if qkv_bias:
        p["bq"] = torch.zeros((n_kv, G, hd))
        p["bk"] = torch.zeros((n_kv, hd))
        p["bv"] = torch.zeros((n_kv, hd))
    return p


def qkv_proj(p, x):
    q = torch.einsum("btd,dkgh->btkgh", x, p["wq"])
    k = torch.einsum("bsd,dkh->bskh", x, p["wk"])
    v = torch.einsum("bsd,dkh->bskh", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def attention(p, x, *, positions, causal=True, rope_theta=None,
              q_chunk=512, k_chunk=512):
    """GQA self-attention of a (B, T, d) sequence (the reference's
    ``attention`` without a cache): projections, RoPE on q and k,
    :func:`chunked_attention`, out-projection -> (B, T, d)."""
    q, k, v = qkv_proj(p, x)   # q: (B, T, KV, G, hd), k/v: (B, T, KV, hd)
    if rope_theta is not None:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    out = chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                            k_chunk=k_chunk)
    return torch.einsum("btkgh,kghd->btd", out, p["wo"])


def init_swiglu(generator: torch.Generator, d, f) -> dict:
    return {"wg": dense_init(generator, (d, f), d),
            "wu": dense_init(generator, (d, f), d),
            "wd": dense_init(generator, (f, d), f)}


def swiglu(p, x):
    g = torch.einsum("btd,df->btf", x, p["wg"])
    u = torch.einsum("btd,df->btf", x, p["wu"])
    return torch.einsum("btf,fd->btd", F.silu(g) * u, p["wd"])
