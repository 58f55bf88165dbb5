"""Model protocol of the port: every architecture exposes one functional
bundle (port of ``repro/models/api.py`` without sharding specs).

  * ``init(generator, device)`` flat params ``{leaf key: tensor}`` (NO
    leading consensus dims), drawn from a CPU ``torch.Generator``;
  * ``train_loss(p, batch)``    scalar, per-worker;
  * ``plan``                    structured-sparsity plan (paper S^l sets);
  * ``stack_map``               (prefix, ndims) scan-stack metadata for
                                layer-wise penalties;
  * ``shapes``                  ``{leaf key: shape}`` without allocating.

An LM family's loss is a :class:`Staged`: the embedding, the stacked
blocks and the head as three functions.  With ``ArchConfig.remat`` its
bundle hands that object out as ``train_loss``; its own
:meth:`Staged.grad_and_value`, which ``core.hsadmm.grad_and_value``
takes, recomputes each block in the backward, as the reference's
per-layer ``jax.checkpoint`` does.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import torch
from torch.func import vjp

from ..configs.base import ArchConfig
from ..core.sparsity import SparsityPlan
from . import layers as L


@dataclass
class ModelBundle:
    cfg: ArchConfig
    init: Callable
    train_loss: Callable
    plan: SparsityPlan
    shapes: dict
    stack_map: tuple = (("blocks", 1),)


def pad_to(v: int, m: int) -> int:
    """``v`` rounded up to a multiple of ``m`` (the padded vocabulary)."""
    return ((v + m - 1) // m) * m


@dataclass(frozen=True)
class Staged:
    """A loss split at its stacked blocks: ``embed(p, batch) -> h``,
    ``block(lp, h, batch) -> h`` for each of ``n_layers`` layers (``lp``:
    that layer's slice of every ``prefix`` leaf, by the name after the
    prefix), ``head(p, h, batch) -> loss``; ``p`` holds the ``embed_keys``
    or ``head_keys`` leaves.  Calling it computes the loss plainly;
    ``core.hsadmm.grad_and_value`` differentiates it with
    :meth:`grad_and_value`, which recomputes every block in the backward
    (``remat``)."""

    embed: Callable
    block: Callable
    head: Callable
    n_layers: int
    prefix: str
    embed_keys: tuple
    head_keys: tuple

    def layer(self, params: dict, layer: int) -> dict:
        """Layer ``layer``'s slice of the stacked leaves, by name."""
        n = len(self.prefix)
        return {k[n:]: v[layer] for k, v in params.items()
                if k.startswith(self.prefix)}

    def __call__(self, params: dict, batch: dict):
        h = self.embed({k: params[k] for k in self.embed_keys}, batch)
        for layer in range(self.n_layers):
            h = self.block(self.layer(params, layer), h, batch)
        return self.head({k: params[k] for k in self.head_keys}, h, batch)

    def grad_and_value(self, params: dict, batch: dict):
        """(grads, loss), recomputing each block: the forward runs
        without a graph and keeps only each block's input; the backward
        takes the head's VJP, then each block's from the last, recomputing
        that block's forward from its saved input, then the embedding's.
        ``torch.utils.checkpoint`` does not run under the workers' ``vmap``
        of ``torch.func`` transforms; this pullback does, and gives the
        plain route's gradients and loss bit for bit: each VJP is the one
        the whole graph would take at that block.  A stacked leaf's
        gradient is its layers' gradients stacked."""
        sub = lambda keys: {k: params[k] for k in keys}  # noqa: E731
        inputs = []
        with torch.no_grad():
            h = self.embed(sub(self.embed_keys), batch)
            for layer in range(self.n_layers):
                inputs.append(h)
                h = self.block(self.layer(params, layer), h, batch)
        loss, (g_head, gh) = _pull(lambda p, x: self.head(p, x, batch),
                                   (sub(self.head_keys), h))
        del h
        per_layer = []
        for layer in reversed(range(self.n_layers)):
            _, (g_l, gh) = _pull(lambda lp, x: self.block(lp, x, batch),
                                 (self.layer(params, layer), inputs.pop()),
                                 gh)
            per_layer.append(g_l)
        _, (grads,) = _pull(lambda p: self.embed(p, batch),
                            (sub(self.embed_keys),), gh)
        for k, v in g_head.items():
            grads[k] = grads[k] + v if k in grads else v
        n = len(self.prefix)
        for k in params:
            if k.startswith(self.prefix):
                grads[k] = torch.stack([g[k[n:]]
                                        for g in reversed(per_layer)])
        return {k: grads[k] for k in params}, loss


def _pull(fn, primals: tuple, cotangent=None) -> tuple:
    """The VJP of ``fn`` at ``primals`` applied to ``cotangent`` (ones
    like the output when None), the backward not recorded -> (output,
    cotangents of the primals)."""
    out, pullback = vjp(fn, *primals)
    with torch.no_grad():
        return out, pullback(torch.ones_like(out) if cotangent is None
                             else cotangent, retain_graph=False)


def _embed(p: dict, batch: dict):
    return L.embed_lookup(p["emb"], batch["tokens"])


def _head(eps: float, p: dict, h, batch: dict):
    """Final RMSNorm and the chunked cross-entropy of the next tokens."""
    h = L.rms_norm(h, p["ln_f"], eps)
    tgt, valid = L.causal_targets(batch["tokens"])
    return L.chunked_xent(h, p["head"], tgt, valid)


def lm_staged(cfg: ArchConfig, block: Callable) -> Staged:
    """An LM's loss as a :class:`Staged`: the token embedding (``emb``),
    ``block(cfg, lp, h, batch)`` over the stacked ``blocks/`` leaves, and
    the head (``ln_f``, ``head``)."""
    return Staged(embed=_embed, block=functools.partial(block, cfg),
                  head=functools.partial(_head, cfg.norm_eps),
                  n_layers=cfg.n_layers, prefix="blocks/",
                  embed_keys=("emb",), head_keys=("ln_f", "head"))
