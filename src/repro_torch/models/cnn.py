"""ResNet family (paper §5.1.3) on CIFAR-style inputs — port of
``repro/models/cnn.py``.

Layouts are the reference's at every function here: NHWC images and
activations, HWIO conv weights, the same leaf keys and shapes.  The conv
call alone permutes to PyTorch's NCHW/OIHW views, and pads like JAX's
``"SAME"``: for a stride-2 3x3 conv on an even input that is (0, 1),
asymmetric, which ``F.conv2d(padding=1)`` would get wrong.

GroupNorm (in f32, ``C // cnn_gn_size`` groups) replaces BatchNorm, and
structured sparsity comes from the cross-layer :class:`CouplingGraph`:
one mask class per stage-internal width and one per residual stream,
pruned in whole GroupNorm groups.  The optional shape rules (S_s) stay
per-conv and projection-only.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.coupling import CouplingGraph
from ..core.shrinkage import compacting_rule
from ..core.sparsity import GroupRule, LeafAxis, SparsityPlan, keep_count
from .api import ModelBundle


def _widths(cfg: ArchConfig) -> tuple[int, tuple[int, ...], tuple[int, ...]]:
    """(stem, per-stage stream widths, per-stage internal widths)."""
    bb = cfg.cnn_bottleneck
    outs = cfg.cnn_outs or tuple((w * 4 if bb else w) for w in cfg.cnn_widths)
    cmids = cfg.cnn_cmid or tuple(
        (w * cfg.cnn_width_mult if bb else w) for w in cfg.cnn_widths)
    stem = cfg.cnn_stem or cfg.cnn_widths[0]
    return stem, outs, cmids


def _block_stride(si, bi):
    return 2 if (bi == 0 and si > 0) else 1


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def param_layout(cfg: ArchConfig) -> list[tuple[str, tuple, int]]:
    """Every leaf as (key, shape, fan_in), in the reference's init order.
    fan_in > 0 marks a weight drawn as N(0, 1/fan_in); 0 a GroupNorm scale
    (ones); -1 a bias (zeros)."""
    stem_w, outs, cmids = _widths(cfg)
    out = []

    def conv(key, kh, kw, cin, cout):
        out.append((key, (kh, kw, cin, cout), kh * kw * cin))

    def gn(key, c):
        out.append((f"{key}/scale", (c,), 0))
        out.append((f"{key}/bias", (c,), -1))

    conv("stem", 3, 3, 3, stem_w)
    gn("gn0", stem_w)
    cin = stem_w
    for si, blocks in enumerate(cfg.cnn_blocks):
        cmid, cout = cmids[si], outs[si]
        for bi in range(blocks):
            p = f"layer{si}/b{bi}"
            stride = _block_stride(si, bi)
            if cfg.cnn_bottleneck:
                conv(f"{p}/conv1", 1, 1, cin, cmid)
                gn(f"{p}/gn1", cmid)
                conv(f"{p}/conv2", 3, 3, cmid, cmid)
                gn(f"{p}/gn2", cmid)
                conv(f"{p}/conv3", 1, 1, cmid, cout)
                gn(f"{p}/gn3", cout)
            else:
                conv(f"{p}/conv1", 3, 3, cin, cmid)
                gn(f"{p}/gn1", cmid)
                conv(f"{p}/conv2", 3, 3, cmid, cout)
                gn(f"{p}/gn2", cout)
            if stride != 1 or cin != cout:
                conv(f"{p}/down", 1, 1, cin, cout)
                gn(f"{p}/gnd", cout)
            cin = cout
    out.append(("fc_w", (cin, cfg.n_classes), cin))
    out.append(("fc_b", (cfg.n_classes,), -1))
    return out


def init(cfg: ArchConfig, generator: torch.Generator, device="cpu") -> dict:
    """Random init drawn from a CPU ``generator`` (so a seed gives the same
    weights on every device), then moved to ``device``."""
    dtype = getattr(torch, cfg.param_dtype)
    params = {}
    for key, shape, fan_in in param_layout(cfg):
        if fan_in > 0:
            x = torch.randn(shape, generator=generator) / math.sqrt(fan_in)
        else:
            x = torch.full(shape, 1.0 if fan_in == 0 else 0.0)
        params[key] = x.to(device=device, dtype=dtype)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of JAX's "SAME" along one spatial axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x, w, stride=1):
    """NHWC x, HWIO w -> NHWC, "SAME" padding as in ``jax.lax.conv``."""
    ph = _same_pads(x.shape[1], w.shape[0], stride)
    pw = _same_pads(x.shape[2], w.shape[1], stride)
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        y = F.conv2d(xc, wc, stride=stride, padding=(ph[0], pw[0]))
    else:
        y = F.conv2d(F.pad(xc, (pw[0], pw[1], ph[0], ph[1])), wc,
                     stride=stride)
    return y.permute(0, 2, 3, 1)


def group_norm(x, scale, bias, group_size, eps=1e-5):
    """GroupNorm with a FIXED channels-per-group size, computed in f32."""
    B, H, W, C = x.shape
    if C % group_size:
        raise ValueError(
            f"GroupNorm: {C} channels not divisible by group size "
            f"{group_size} (cnn widths must be multiples of cnn_gn_size)")
    xg = x.reshape(B, H, W, C // group_size, group_size).to(torch.float32)
    mu = torch.mean(xg, dim=(1, 2, 4), keepdim=True)
    var = torch.var(xg, dim=(1, 2, 4), keepdim=True, correction=0)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(B, H, W, C).to(x.dtype) * scale + bias


def _gn(p, name, x, gsz):
    return group_norm(x, p[f"{name}/scale"], p[f"{name}/bias"], gsz)


def basic_block(p, x, stride, gsz):
    """``p`` is the block's own flat dict ("conv1", "gn1/scale", ...)."""
    y = F.relu(_gn(p, "gn1", conv(x, p["conv1"], stride), gsz))
    y = _gn(p, "gn2", conv(y, p["conv2"]), gsz)
    sc = x
    if "down" in p:
        sc = _gn(p, "gnd", conv(x, p["down"], stride), gsz)
    return F.relu(y + sc)


def bottleneck(p, x, stride, gsz):
    y = F.relu(_gn(p, "gn1", conv(x, p["conv1"]), gsz))
    y = F.relu(_gn(p, "gn2", conv(y, p["conv2"], stride), gsz))
    y = _gn(p, "gn3", conv(y, p["conv3"]), gsz)
    sc = x
    if "down" in p:
        sc = _gn(p, "gnd", conv(x, p["down"], stride), gsz)
    return F.relu(y + sc)


def forward(cfg: ArchConfig, params: dict, images):
    gsz = cfg.cnn_gn_size
    x = F.relu(_gn(params, "gn0", conv(images, params["stem"]), gsz))
    fn = bottleneck if cfg.cnn_bottleneck else basic_block
    for si, blocks in enumerate(cfg.cnn_blocks):
        for bi in range(blocks):
            pre = f"layer{si}/b{bi}/"
            p = {k[len(pre):]: v for k, v in params.items()
                 if k.startswith(pre)}
            x = fn(p, x, _block_stride(si, bi), gsz)
    x = torch.mean(x, dim=(1, 2))
    return x @ params["fc_w"] + params["fc_b"]


def train_loss(cfg: ArchConfig, params, batch):
    logits = forward(cfg, params, batch["images"]).to(torch.float32)
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    tl = torch.gather(logits, -1, labels[:, None])[..., 0]
    # paper Eq. 1: CE; the L2 weight decay is folded into the consensus
    # z-update, so the bare loss here is plain CE.
    return torch.mean(lse - tl)


def accuracy(cfg: ArchConfig, params, batch):
    logits = forward(cfg, params, batch["images"])
    return torch.mean((torch.argmax(logits, -1) == batch["labels"].long())
                      .to(torch.float32))


def conv_leaf_keys(keys) -> list[str]:
    return [k for k in keys
            if k.split("/")[-1].startswith(("conv", "stem", "down"))]


# ---------------------------------------------------------------------------
# cross-layer coupling graph (mask classes spanning the model's wiring)
# ---------------------------------------------------------------------------


def coupling_graph(cfg: ArchConfig) -> CouplingGraph:
    """The ResNet family's pruning coupling graph: one class per
    stage-internal width (``cnn:mid{si}``) and one per residual stream
    (``cnn:out{si}``, or ``cnn:stem`` when stage 0 opens with an identity
    skip).  Keep budgets are in GroupNorm-group units."""
    gs = cfg.cnn_gn_size
    rate = cfg.hsadmm.keep_rate
    stem_w, outs, cmids = _widths(cfg)

    def kg(channels):
        return keep_count(max(channels // gs, 1), rate, 1)

    g = CouplingGraph()
    cur = g.producer("cnn:stem", "stem", 3, keep=kg(stem_w),
                     stack_ndims=0, group_size=gs)
    g.follower(cur, "gn0/scale", 0)
    g.follower(cur, "gn0/bias", 0)
    cin = stem_w
    for si, blocks in enumerate(cfg.cnn_blocks):
        mid = None
        cmid, cout = cmids[si], outs[si]
        for bi in range(blocks):
            p = f"layer{si}/b{bi}"
            stride = _block_stride(si, bi)
            g.consumer(cur, f"{p}/conv1", 2)     # block input: stream C_in
            if mid is None:
                mid = g.producer(f"cnn:mid{si}", f"{p}/conv1", 3,
                                 keep=kg(cmid), stack_ndims=0, group_size=gs)
            else:
                g.consumer(mid, f"{p}/conv1", 3)
            g.follower(mid, f"{p}/gn1/scale", 0)
            g.follower(mid, f"{p}/gn1/bias", 0)
            if cfg.cnn_bottleneck:
                g.consumer(mid, f"{p}/conv2", 2)
                g.consumer(mid, f"{p}/conv2", 3)  # cmid -> cmid: same class
                g.follower(mid, f"{p}/gn2/scale", 0)
                g.follower(mid, f"{p}/gn2/bias", 0)
                g.consumer(mid, f"{p}/conv3", 2)
                out_key, out_gn = f"{p}/conv3", f"{p}/gn3"
            else:
                g.consumer(mid, f"{p}/conv2", 2)
                out_key, out_gn = f"{p}/conv2", f"{p}/gn2"
            if stride != 1 or cin != cout:
                # downsample branch opens a NEW stream class
                g.consumer(cur, f"{p}/down", 2)
                cur = g.producer(f"cnn:out{si}", f"{p}/down", 3,
                                 keep=kg(cout), stack_ndims=0, group_size=gs)
                g.follower(cur, f"{p}/gnd/scale", 0)
                g.follower(cur, f"{p}/gnd/bias", 0)
            # the block output adds into the stream: identity skips union
            # the whole stage into one shared mask class
            g.consumer(cur, out_key, 3)
            g.follower(cur, f"{out_gn}/scale", 0)
            g.follower(cur, f"{out_gn}/bias", 0)
            cin = cout
    g.consumer(cur, "fc_w", 0)   # conv -> fc boundary (global-pool flatten)
    return g


def sparsity_plan(cfg: ArchConfig, shapes: dict) -> SparsityPlan:
    """Coupled filter/channel classes from the graph ("channel" and
    "filter" are aliases) + the paper's projection-only shape rules (S_s,
    per conv leaf) when "shape" is a prune target."""
    hp = cfg.hsadmm
    rules: tuple = ()
    if "channel" in cfg.prune_targets or "filter" in cfg.prune_targets:
        rules = coupling_graph(cfg).plan(shapes, min_groups=2).rules
    s_rules = []
    if "shape" in cfg.prune_targets:
        for key in conv_leaf_keys(shapes):
            kh, kw, cin, cout = shapes[key]
            if kh * kw > 1 and cin >= 16:
                s_rules.append(GroupRule(
                    f"s:{key}", (LeafAxis(key, (0, 1, 2)),),
                    groups=kh * kw * cin,
                    keep=keep_count(kh * kw * cin, hp.keep_rate, 8),
                    stack_ndims=0))
    return SparsityPlan(rules + tuple(s_rules))


def shrink_config(cfg: ArchConfig, plan: SparsityPlan,
                  budgets: dict) -> ArchConfig:
    """ArchConfig of the physically-shrunk ResNet: per-stage stream and
    internal widths (and the stem) are read off the coupling classes that
    slice the corresponding conv axes — name-agnostic, so merged classes
    (identity-skip unions, the stem joining stage 0) resolve correctly.
    Channel sets not covered by any rule keep their full width."""
    stem_w, outs, cmids = _widths(cfg)

    def width(key, axis, default):
        r = compacting_rule(plan, key, axis)
        return int(budgets[r.name]) * r.group_size if r is not None \
            else default

    new_stem = width("stem", 3, stem_w)
    new_outs, new_cmids = [], []
    last_conv = "conv3" if cfg.cnn_bottleneck else "conv2"
    for si, blocks in enumerate(cfg.cnn_blocks):
        new_cmids.append(width(f"layer{si}/b0/conv1", 3, cmids[si]))
        new_outs.append(width(f"layer{si}/b{blocks - 1}/{last_conv}", 3,
                              outs[si]))
    return cfg.replace(cnn_stem=new_stem, cnn_outs=tuple(new_outs),
                       cnn_cmid=tuple(new_cmids))


def build(cfg: ArchConfig) -> ModelBundle:
    shapes = {k: s for k, s, _ in param_layout(cfg)}
    return ModelBundle(
        cfg=cfg,
        init=functools.partial(init, cfg),
        train_loss=functools.partial(train_loss, cfg),
        plan=sparsity_plan(cfg, shapes),
        shapes=shapes,
        stack_map=(),   # no scan stacks: every conv leaf is its own "layer"
    )
