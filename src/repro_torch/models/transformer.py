"""Decoder-only GQA transformer LM (the tinyllama family) — port of
``repro/models/transformer.py``'s training path.

Block: RMSNorm -> GQA self-attention (interleaved RoPE, causal
:class:`~repro_torch.models.layers.ChunkedAttention`) -> residual ->
RMSNorm -> SwiGLU -> residual.  Leaf keys and shapes are the reference's,
the layers stacked on the leading axis of every ``blocks/...`` leaf; the
vocabulary is padded to a multiple of 16.

Structured-sparsity targets:
  * ``ffn``   — FFN hidden units (columns of wg/wu, rows of wd), balanced
                over 16 shards of the hidden axis, as the reference's TP
                layout asks;
  * ``heads`` — whole GQA groups (a kv head with its G query heads).

``shrink_config`` maps both onto widths (``d_ff``; ``n_kv_heads`` with
``n_heads`` at the same group size), so the family reconfigures
physically.  With ``ArchConfig.remat`` the backward recomputes each
block (:func:`staged`, ``core.hsadmm.grad_and_value``), as the
reference's per-layer ``jax.checkpoint`` does.  The serving path (``init_cache``/``step``) waits for a later
slice; ``param_specs`` and ``constrain_seq`` have no counterpart on one
card.
"""
from __future__ import annotations

import functools

import torch

from ..configs.base import ArchConfig
from ..core.coupling import CouplingGraph
from ..core.sparsity import SparsityPlan, keep_count
from ..device import resolve_device
from . import layers as L
from .api import ModelBundle, Staged, lm_staged, pad_to

MODEL_AXIS_SIZE = 16   # the reference's TP width: the ffn rule's shards

_STACK = "blocks/"


def block_shapes(cfg: ArchConfig) -> dict:
    """One block's leaves by name (``ln1``, ``attn/...``, ``ln2``,
    ``mlp/...``) and their shapes."""
    d, KV, hd = cfg.d_model, cfg.n_kv_heads, cfg.kv_head_dim
    G = cfg.n_heads // KV
    shapes = {"ln1": (d,), "attn/wq": (d, KV, G, hd), "attn/wk": (d, KV, hd),
              "attn/wv": (d, KV, hd), "attn/wo": (KV, G, hd, d)}
    if cfg.qkv_bias:
        shapes.update({"attn/bq": (KV, G, hd), "attn/bk": (KV, hd),
                       "attn/bv": (KV, hd)})
    shapes.update({"ln2": (d,), "mlp/wg": (d, cfg.d_ff),
                   "mlp/wu": (d, cfg.d_ff), "mlp/wd": (cfg.d_ff, d)})
    return shapes


def param_shapes(cfg: ArchConfig) -> dict:
    """``{leaf key: shape}`` of the whole model, without allocating."""
    vp = pad_to(cfg.vocab, MODEL_AXIS_SIZE)
    shapes = {"emb": (vp, cfg.d_model)}
    for name, shape in block_shapes(cfg).items():
        shapes[_STACK + name] = (cfg.n_layers,) + shape
    shapes["ln_f"] = (cfg.d_model,)
    shapes["head"] = (vp, cfg.d_model)
    return shapes


def init_block(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """One block's leaves by name, f32 on the CPU: the attention's drawn
    before the MLP's."""
    attn = L.init_attention(generator, cfg.d_model, cfg.n_heads,
                            cfg.n_kv_heads, cfg.kv_head_dim, cfg.qkv_bias)
    mlp = L.init_swiglu(generator, cfg.d_model, cfg.d_ff)
    return {"ln1": torch.ones((cfg.d_model,)),
            **{f"attn/{k}": v for k, v in attn.items()},
            "ln2": torch.ones((cfg.d_model,)),
            **{f"mlp/{k}": v for k, v in mlp.items()}}


def init(cfg: ArchConfig, generator: torch.Generator, device=None) -> dict:
    """Random init drawn from a CPU ``generator`` (so a seed gives the same
    weights on every device): the blocks layer by layer, then the
    embedding and the head; moved to ``device`` (the card unless the
    caller asks for the CPU) in ``cfg.param_dtype``."""
    device = resolve_device(device)
    vp = pad_to(cfg.vocab, MODEL_AXIS_SIZE)
    d = cfg.d_model
    blocks = [init_block(cfg, generator) for _ in range(cfg.n_layers)]
    params = {"emb": L.dense_init(generator, (vp, d), d)}
    for key in blocks[0]:
        params[_STACK + key] = torch.stack([b[key] for b in blocks])
    params["ln_f"] = torch.ones((d,))
    params["head"] = L.dense_init(generator, (vp, d), d)
    dtype = getattr(torch, cfg.param_dtype)
    return {k: v.to(device=device, dtype=dtype) for k, v in params.items()}


def _part(lp: dict, part: str) -> dict:
    """One layer's ``part`` leaves (``attn`` or ``mlp``) by name."""
    pre = f"{part}/"
    return {k[len(pre):]: v for k, v in lp.items() if k.startswith(pre)}


def block_apply(cfg: ArchConfig, lp: dict, h, batch: dict):
    """One block over (B, T, d) ``h``; ``lp`` holds the layer's leaves by
    name (``ln1``, ``attn/...``, ``ln2``, ``mlp/...``)."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device) \
        .expand(tokens.shape)
    a = L.attention(_part(lp, "attn"), L.rms_norm(h, lp["ln1"], cfg.norm_eps),
                    positions=positions, causal=True,
                    rope_theta=cfg.rope_theta)
    h = h + a
    return h + L.swiglu(_part(lp, "mlp"),
                        L.rms_norm(h, lp["ln2"], cfg.norm_eps))


def staged(cfg: ArchConfig) -> Staged:
    """The loss as embedding, blocks and head (:class:`~.api.Staged`)."""
    return lm_staged(cfg, block_apply)


def train_loss(cfg: ArchConfig, params: dict, batch: dict):
    return staged(cfg)(params, batch)


def sparsity_plan(cfg: ArchConfig) -> SparsityPlan:
    """Through the port's :class:`CouplingGraph`, as the reference derives
    it: each class's producer and consumers sit inside one stacked
    block."""
    hp = cfg.hsadmm
    g = CouplingGraph()
    if "ffn" in cfg.prune_targets:
        keep = keep_count(cfg.d_ff, hp.keep_rate, MODEL_AXIS_SIZE)
        ffn = g.producer("ffn", _STACK + "mlp/wg", 2, groups=cfg.d_ff,
                         keep=keep, stack_ndims=1, shards=MODEL_AXIS_SIZE)
        g.consumer(ffn, _STACK + "mlp/wu", 2)     # tied gate/up producers
        g.consumer(ffn, _STACK + "mlp/wd", 1)     # down-proj C_in
    if "heads" in cfg.prune_targets:
        keep = keep_count(cfg.n_kv_heads, hp.keep_rate, 2)
        h = g.producer("heads", _STACK + "attn/wq", 2,
                       groups=cfg.n_kv_heads, keep=keep, stack_ndims=1)
        g.consumer(h, _STACK + "attn/wk", 2)
        g.consumer(h, _STACK + "attn/wv", 2)
        g.consumer(h, _STACK + "attn/wo", 1)      # out-proj C_in
        if cfg.qkv_bias:
            for name in ("bq", "bk", "bv"):
                g.consumer(h, _STACK + "attn/" + name, 1)
    return g.plan()


def shrink_config(cfg: ArchConfig, plan: SparsityPlan,
                  budgets: dict) -> ArchConfig:
    """ArchConfig of the physically-shrunk model: ``ffn*`` rules set
    ``d_ff`` to their budget B, ``heads`` sets ``n_kv_heads`` to B with
    the query heads per kv head kept.  A compactable rule without a width
    mapping raises."""
    new = cfg
    for r in plan.rules:
        if not r.compactable:
            continue
        B = int(budgets[r.name])
        if r.name.startswith("ffn"):
            new = new.replace(d_ff=B)
        elif r.name == "heads":
            g = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
            new = new.replace(n_kv_heads=B, n_heads=B * g)
        else:
            raise NotImplementedError(
                f"rule {r.name!r} has no width mapping for physical "
                "reconfiguration of the dense-transformer family")
    return new


def build(cfg: ArchConfig) -> ModelBundle:
    """The family's bundle; with ``cfg.remat`` its ``train_loss`` is the
    :class:`~.api.Staged` loss, whose blocks the backward recomputes."""
    return ModelBundle(
        cfg=cfg,
        init=functools.partial(init, cfg),
        train_loss=staged(cfg) if cfg.remat
        else functools.partial(train_loss, cfg),
        plan=sparsity_plan(cfg),
        shapes=param_shapes(cfg),
        stack_map=((_STACK[:-1], 1),),
    )
