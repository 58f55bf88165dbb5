"""Mamba2 (SSD — state-space duality) LM, arXiv:2405.21060 — port of
``repro/models/ssm.py`` (its training path).

Block: in-projections (z, x, B, C, dt) -> causal depthwise conv on
(x, B, C) -> chunked SSD scan -> gated RMSNorm -> out-projection.  Leaf
keys and shapes are the reference's, with the layers stacked on the
leading axis of every ``blocks/...`` leaf.

The scan runs through :class:`SSDScan`: its forward is the hand-written
kernel on the card (``kernels.ops.ssd_chunk_scan``), its backward the VJP
of the plain chunked scan (``kernels/ref.py``), recomputed from the saved
inputs, since the TPU kernel has no backward kernel either.  That plain
scan (``ref.ssd_chunk_scan_ref``) has the role the reference's
``ssd_scan`` has: the kernel's oracle.

Sparsity target ``ssm_heads``: whole SSD heads (x/dt/A/D/conv/out-proj
slices), one rule stacked over the layers.  With ``ArchConfig.remat`` the
backward recomputes each block (:func:`staged`,
``core.hsadmm.grad_and_value``), as the reference's per-layer
``jax.checkpoint`` does.  The recurrent serving path
(``init_cache``/``step``) waits for a later slice; the family has no
``shrink_config``, as in the reference, so it cannot physically
reconfigure.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.sparsity import GroupRule, LeafAxis, SparsityPlan, keep_count
from ..device import resolve_device
from ..kernels import ops, ref
from . import layers as L
from .api import ModelBundle, Staged, lm_staged, pad_to

MODEL_AXIS_SIZE = 16

_STACK = "blocks/"


def dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    return d_in, H, cfg.ssm_head_dim, cfg.ssm_state


def mixer_layout(cfg: ArchConfig) -> list[tuple[str, tuple, object]]:
    """One mixer's leaves as (name, shape, init): an int is the fan-in of
    an N(0, 1/fan_in) draw, a float a constant fill."""
    d = cfg.d_model
    _, H, hd, N = dims(cfg)
    K = cfg.ssm_conv
    return [("wz", (d, H, hd), d), ("wx", (d, H, hd), d), ("wB", (d, N), d),
            ("wC", (d, N), d), ("wdt", (d, H), d),
            ("bdt", (H,), -3.0),       # softplus(-3) ~ small init dt
            ("A_log", (H,), 0.0),      # A = -exp(A_log) = -1
            ("D", (H,), 1.0),
            ("conv_x", (K, H, hd), K), ("conv_B", (K, N), K),
            ("conv_C", (K, N), K), ("norm", (H, hd), 1.0),
            ("wo", (H, hd, d), H * hd)]


def param_shapes(cfg: ArchConfig) -> dict:
    """``{leaf key: shape}`` of the whole model, without allocating."""
    vp = pad_to(cfg.vocab, MODEL_AXIS_SIZE)
    Lr, d = cfg.n_layers, cfg.d_model
    shapes = {"emb": (vp, d), f"{_STACK}ln": (Lr, d)}
    for name, shape, _ in mixer_layout(cfg):
        shapes[f"{_STACK}mixer/{name}"] = (Lr,) + shape
    shapes["ln_f"] = (d,)
    shapes["head"] = (vp, d)
    return shapes


def init_mixer(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """One mixer's leaves by name, f32 on the CPU, drawn in layout order
    from ``generator``."""
    return {name: torch.full(shape, how) if isinstance(how, float)
            else L.dense_init(generator, shape, how)
            for name, shape, how in mixer_layout(cfg)}


def init_block(cfg: ArchConfig, generator: torch.Generator) -> dict:
    return {"ln": torch.ones((cfg.d_model,)),
            **{f"mixer/{k}": v for k, v in init_mixer(cfg, generator).items()}}


def init(cfg: ArchConfig, generator: torch.Generator, device=None) -> dict:
    """Random init drawn from a CPU ``generator`` (so a seed gives the same
    weights on every device): the blocks layer by layer, then the
    embedding and the head; moved to ``device`` (the card unless the
    caller asks for the CPU)."""
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


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------


class SSDScan(torch.autograd.Function):
    """``(y, h) = scan(x, dt, A, B, C, chunk)`` with A of shape (Bt, H).

    Forward: the dispatch shim (the hand kernel on the card).  Backward:
    the VJP of the plain scan at the saved inputs, so only the inputs are
    kept between the two passes.  ``vmap`` (``local_step``'s vmap over ADMM
    workers) folds the vmapped dim into the batch rows, A included, and
    launches the kernel once for all workers."""

    @staticmethod
    def forward(x, dt, A, Bm, Cm, chunk):
        return ops.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, A, Bm, Cm, chunk = inputs
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx, gy, gh):
        _, vjp = torch.func.vjp(
            functools.partial(ref.ssd_chunk_scan_ref, chunk=ctx.chunk),
            *ctx.saved_tensors)
        return (*vjp((gy, gh)), None)

    @staticmethod
    def vmap(info, in_dims, x, dt, A, Bm, Cm, chunk):
        n = info.batch_size
        folded = [L.fold_vmapped(t, d, n)
                  for t, d in zip((x, dt, A, Bm, Cm), in_dims)]
        y, h = SSDScan.apply(*folded, chunk)
        return ((y.reshape((n, -1) + tuple(y.shape[1:])),
                 h.reshape((n, -1) + tuple(h.shape[1:]))), (0, 0))


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------


def _causal_conv(x, w):
    """Depthwise causal conv over time from a zero history.  x: (B, T,
    C...), w: (K, C...) -> silu(conv)."""
    K, T = w.shape[0], x.shape[1]
    tail = torch.zeros((x.shape[0], K - 1) + tuple(x.shape[2:]),
                       dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)
    y = sum(xp[:, i:i + T] * w[i] for i in range(K))
    return F.silu(y)


def mixer_apply(cfg: ArchConfig, p: dict, h):
    """One Mamba2 mixer over a (B, T, d) sequence from a zero state (the
    reference's training branch, ``state=None``).  ``p`` holds the
    mixer's leaves by name."""
    Bsz = h.shape[0]
    z = torch.einsum("btd,dhp->bthp", h, p["wz"])
    x = torch.einsum("btd,dhp->bthp", h, p["wx"])
    Bm = torch.einsum("btd,dn->btn", h, p["wB"])
    Cm = torch.einsum("btd,dn->btn", h, p["wC"])
    dtv = torch.einsum("btd,dh->bth", h, p["wdt"])

    x = _causal_conv(x, p["conv_x"])
    Bm = _causal_conv(Bm, p["conv_B"])
    Cm = _causal_conv(Cm, p["conv_C"])
    dtv = F.softplus(dtv.to(torch.float32) + p["bdt"].to(torch.float32))
    A = -torch.exp(p["A_log"].to(torch.float32))

    y, _ = SSDScan.apply(x, dtv, A.expand(Bsz, A.shape[0]), Bm, Cm,
                         cfg.ssm_chunk)
    y = y + x * p["D"].to(x.dtype)[:, None]
    y = L.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return torch.einsum("bthp,hpd->btd", y, p["wo"])


def block_apply(cfg: ArchConfig, lp: dict, h, batch: dict):
    """One residual block over (B, T, d) ``h``; ``lp`` holds the layer's
    leaves by name (``ln``, ``mixer/...``)."""
    mixer = {k[len("mixer/"):]: v for k, v in lp.items()
             if k.startswith("mixer/")}
    return h + mixer_apply(cfg, mixer, L.rms_norm(h, lp["ln"], cfg.norm_eps))


def staged(cfg: ArchConfig) -> Staged:
    """The loss as embedding, blocks and head (:class:`~.api.Staged`)."""
    return lm_staged(cfg, block_apply)


def train_loss(cfg: ArchConfig, params: dict, batch: dict):
    return staged(cfg)(params, batch)


def sparsity_plan(cfg: ArchConfig) -> SparsityPlan:
    _, H, _, _ = dims(cfg)
    rules = []
    if "ssm_heads" in cfg.prune_targets:
        keep = keep_count(H, cfg.hsadmm.keep_rate, 4)
        mixer = _STACK + "mixer/"
        rules.append(GroupRule(
            "ssm_heads",
            tuple(LeafAxis(mixer + name, ax) for name, ax in (
                ("wz", 2), ("wx", 2), ("wdt", 2), ("bdt", 1), ("A_log", 1),
                ("D", 1), ("conv_x", 2), ("norm", 1), ("wo", 1))),
            groups=H, keep=keep, stack_ndims=1))
    return SparsityPlan(tuple(rules))


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
        stack_map=(("blocks", 1),),
    )
