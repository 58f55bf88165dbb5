"""The port's dense transformer pieces against the JAX package: RoPE (its
interleaved pairing), the chunked attention (the plain function and
:class:`ChunkedAttention`, values and gradients, causal and not, T not a
multiple of the chunk target, the worker ``vmap``), SwiGLU, the GQA
attention block with and without ``qkv_bias``, the tinyllama smoke
model's loss and gradients with parameters carried by ``convert``, the
sparsity plan rule for rule, ``shrink_config``, and the parameter counts
of the full-width configurations with 4 and 3 layers (the card trains
3), from shapes alone.

Tolerances: rtol 1e-5, atol 1e-6 throughout, the port's ResNet and
round tests' (two frameworks' f32 products and transcendental functions
round differently in the last place).
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import grad_and_value, vmap  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import shrink_config as j_shrink_config  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.masks import MaskSyncConfig, budget  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.models import can_shrink  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import shrink_config as t_shrink_config  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402

from torch_port_helpers import np_flat, perturbed, to_np  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
ARCH = "tinyllama-1.1b"


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


_jit_rope = jax.jit(jL.rope, static_argnums=2)


@pytest.mark.parametrize("shape,theta,max_pos", [
    ((2, 12, 3, 2, 16), 10000.0, 64),     # q: (B, T, KV, G, hd)
    ((2, 12, 3, 8), 10000.0, 64),         # k: (B, T, KV, hd)
    ((1, 40, 2, 4, 64), 500000.0, 64),
    ((1, 40, 2, 4, 64), 10000.0, 4096)])  # tinyllama's hd, the card's T
def test_rope_matches_reference(shape, theta, max_pos):
    """Against the jitted JAX function (as the training rounds run it),
    at positions in [0, max_pos).  Up to position 64, rtol 1e-5 and atol
    1e-6.  At 4096 the two frameworks' ``exp`` may round a frequency one
    ulp apart (as JAX's eager and jitted ``exp`` do), which turns the
    angle by up to ``pos * ulp(freq) <= 4096 * 2**-24``: atol is that
    times max |x|.  A rotate-half RoPE (pairs i and i + hd/2) gives other
    numbers."""
    rng = np.random.default_rng(1)
    x = _rand(rng, *shape)
    pos = rng.integers(0, max_pos, size=shape[:2]).astype(np.int32)
    want = np.asarray(_jit_rope(*_j(x, pos), theta))
    got = to_np(tL.rope(*_t(x, pos), theta))
    tol = TOL if max_pos <= 64 else dict(
        rtol=1e-5, atol=max_pos * 2.0 ** -24 * float(np.abs(x).max()))
    np.testing.assert_allclose(got, want, **tol)
    # rotate-half pairs i with i + hd/2: other numbers, the same ones
    # only once the input's even and odd features are split into halves
    xt, pt = _t(x, pos)
    perm = torch.cat([torch.arange(0, shape[-1], 2),
                      torch.arange(1, shape[-1], 2)])
    assert not np.allclose(to_np(_rope_rotate_half(xt, pt, theta)), want,
                           **tol)
    back = torch.empty_like(xt)
    back[..., perm] = _rope_rotate_half(xt[..., perm], pt, theta)
    np.testing.assert_allclose(to_np(back), want, **tol)


def _rope_rotate_half(x, positions, theta):
    """The Hugging Face layout of RoPE: features i and i + hd/2 rotate
    together."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32)
                      * (math.log(theta) / half))
    ang = positions[..., None].float() * freqs
    ang = ang.reshape(tuple(ang.shape[:-1])
                      + (1,) * (x.ndim - positions.ndim - 1) + (half,))
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * torch.cos(ang) - x2 * torch.sin(ang),
                      x2 * torch.cos(ang) + x1 * torch.sin(ang)], dim=-1)


# (B, T, S, KV, G, hd, causal, chunk target): T = 20 with chunk 8 runs
# chunks of 5; S > T aligns the queries to the suffix, as the reference
ATTN_CASES = [(2, 20, 20, 2, 3, 8, True, 8), (1, 16, 16, 2, 2, 16, True, 4),
              (2, 12, 12, 1, 4, 8, False, 8), (1, 6, 10, 2, 2, 8, True, 4)]


def _attn_inputs(B, T, S, KV, G, hd, seed=3):
    rng = np.random.default_rng(seed)
    return (_rand(rng, B, T, KV, G, hd), _rand(rng, B, S, KV, hd),
            _rand(rng, B, S, KV, hd), _rand(rng, B, T, KV, G, hd))


@pytest.mark.parametrize("B,T,S,KV,G,hd,causal,chunk", ATTN_CASES)
def test_chunked_attention_matches_reference(B, T, S, KV, G, hd, causal,
                                             chunk):
    """Plain function and Function against ``repro.models.layers.
    chunked_attention``: the outputs, and the gradients of <out, w> in q,
    k and v (the JAX VJP; the Function's recomputing backward and plain
    autograd through the plain function)."""
    q, k, v, w = _attn_inputs(B, T, S, KV, G, hd)
    kw = dict(causal=causal, q_chunk=chunk, k_chunk=chunk)

    def jloss(q, k, v):
        return jnp.sum(jL.chunked_attention(q, k, v, **kw) * jnp.asarray(w))
    jout = np.asarray(jL.chunked_attention(*_j(q, k, v), **kw))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*_j(q, k, v))

    for fn in (tL.chunked_attention_ref, tL.chunked_attention):
        tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
        out = fn(tq, tk, tv, **kw)
        np.testing.assert_allclose(to_np(out), jout, **TOL)
        (out * torch.from_numpy(w)).sum().backward()
        for t, jg, name in zip((tq, tk, tv), jgrads, "qkv"):
            np.testing.assert_allclose(to_np(t.grad), np.asarray(jg),
                                       err_msg=f"{fn.__name__} d{name}",
                                       **TOL)


def test_function_forward_is_the_plain_function_and_saves_only_inputs():
    """The Function's output is the plain function's, bit for bit; its
    graph keeps q, k and v and no score block."""
    q, k, v, _ = _attn_inputs(2, 20, 20, 2, 3, 8)
    tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
    out = tL.chunked_attention(tq, tk, tv, q_chunk=8, k_chunk=8)
    assert torch.equal(out, tL.chunked_attention_ref(tq, tk, tv, q_chunk=8,
                                                     k_chunk=8))
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 and all(
        s.shape == t.shape for s, t in zip(saved, (tq, tk, tv)))


def test_function_vmap_rule_folds_workers():
    """``vmap(grad_and_value)`` over a worker axis (as ``local_step``
    runs the loss) equals each worker's own loss and gradients."""
    rng = np.random.default_rng(5)
    W, B, T, KV, G, hd = 3, 2, 12, 2, 2, 8
    q, k, v = _t(_rand(rng, W, B, T, KV, G, hd), _rand(rng, W, B, T, KV, hd),
                 _rand(rng, W, B, T, KV, hd))

    def loss(p):
        out = tL.chunked_attention(p["q"], p["k"], p["v"], q_chunk=4,
                                   k_chunk=4)
        return torch.sum(out * out)
    g, lv = vmap(grad_and_value(loss))({"q": q, "k": k, "v": v})
    for i in range(W):
        gi, li = grad_and_value(loss)({"q": q[i], "k": k[i], "v": v[i]})
        np.testing.assert_allclose(to_np(lv[i]), to_np(li), **TOL)
        for name in "qkv":
            np.testing.assert_allclose(to_np(g[name][i]), to_np(gi[name]),
                                       **TOL)


def test_swiglu_matches_reference():
    rng = np.random.default_rng(7)
    p = {"wg": _rand(rng, 16, 40, scale=0.3),
         "wu": _rand(rng, 16, 40, scale=0.3),
         "wd": _rand(rng, 40, 16, scale=0.3)}
    x = _rand(rng, 2, 9, 16)
    want = np.asarray(jL.swiglu({k: jnp.asarray(a) for k, a in p.items()},
                                jnp.asarray(x)))
    got = tL.swiglu({k: torch.from_numpy(a) for k, a in p.items()},
                    torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), want, **TOL)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attention_block_matches_reference(qkv_bias):
    """The GQA block (projections, RoPE, causal chunked attention,
    out-projection) from JAX-drawn weights, the biases perturbed off
    their zero init; the port's init has the reference's leaf shapes."""
    d, H, KV, hd, T = 32, 8, 4, 8, 20
    jp = perturbed(jax.device_get(jL.init_attention(
        jax.random.PRNGKey(2), d, H, KV, hd, qkv_bias)), seed=4, scale=0.1)
    tp = tL.init_attention(torch.Generator().manual_seed(0), d, H, KV, hd,
                           qkv_bias)
    assert {k: tuple(v.shape) for k, v in tp.items()} \
        == {k: v.shape for k, v in jp.items()}
    rng = np.random.default_rng(8)
    x = _rand(rng, 2, T, d)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T))
    want, _ = jL.attention({k: jnp.asarray(a) for k, a in jp.items()},
                           jnp.asarray(x), positions=jnp.asarray(pos),
                           causal=True, rope_theta=10000.0, q_chunk=8,
                           k_chunk=8)
    got = tL.attention({k: torch.from_numpy(a) for k, a in jp.items()},
                       torch.from_numpy(x),
                       positions=torch.from_numpy(pos.copy()), causal=True,
                       rope_theta=10000.0, q_chunk=8, k_chunk=8)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_train_loss_and_gradients_match_reference(qkv_bias):
    """tinyllama smoke (2 layers; with ``qkv_bias`` the biases perturbed
    off zero) from JAX-drawn weights: the loss and every leaf's
    gradient."""
    cfg = get_config(ARCH, smoke=True).replace(qkv_bias=qkv_bias)
    jb = j_build(cfg)
    p = perturbed(jax.device_get(jb.init(jax.random.PRNGKey(0))), seed=2)
    tb = t_build(t_get_config(ARCH, smoke=True).replace(qkv_bias=qkv_bias))
    tp = convert.params_from_jax(p, device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == tb.shapes
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab, size=(2, 24)).astype(np.int32)
    jl, jg = jax.value_and_grad(jb.train_loss)(
        jax.tree.map(jnp.asarray, p), {"tokens": jnp.asarray(toks)})
    tg, tl = grad_and_value(tb.train_loss)(
        tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jg = np_flat(jg)
    assert set(tg) == set(jg)
    for k, g in jg.items():
        np.testing.assert_allclose(to_np(tg[k]), g, err_msg=k, **TOL)


def _flat_shapes(tree, prefix=""):
    """Nested tree of ``jax.eval_shape`` leaves -> {key: shape}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat_shapes(v, path) if isinstance(v, dict)
                   else {path: tuple(v.shape)})
    return out


def _rules(plan):
    return [(r.name, tuple((la.key, la.axes) for la in r.leaves),
             tuple((la.key, la.axes) for la in r.followers), r.groups,
             r.keep, r.stack_ndims, r.shards, r.group_size, r.compactable)
            for r in plan.rules]


@pytest.mark.parametrize("smoke,kw", [
    (True, {}), (True, dict(n_heads=8, n_kv_heads=4)),
    (True, dict(qkv_bias=True, n_heads=8, n_kv_heads=4)), (False, {}),
    (False, dict(prune_targets=("ffn",)))])
def test_sparsity_plan_matches_reference(smoke, kw):
    """Rule for rule: leaves and axes, groups, keep, stack dims, shards
    (``ffn`` balanced over 16), group size; then ``shrink_config`` at
    the plan's budgets, and the port's leaf shapes against the
    reference's init."""
    jcfg = get_config(ARCH, smoke=smoke).replace(**kw)
    tcfg = t_get_config(ARCH, smoke=smoke).replace(**kw)
    jb, tb = j_build(jcfg), t_build(tcfg)
    assert _rules(tb.plan) == _rules(jb.plan)
    ffn = tb.plan.rule("ffn")
    assert ffn.shards == 16 and ffn.keep == jcfg.d_ff // 2
    budgets = {r.name: budget(r, MaskSyncConfig()) for r in tb.plan.rules}
    assert can_shrink(tcfg)
    got = t_shrink_config(tcfg, tb.plan, budgets)
    want = j_shrink_config(jcfg, jb.plan, budgets)
    for f in ("d_ff", "n_heads", "n_kv_heads", "head_dim", "d_model",
              "n_layers", "vocab", "qkv_bias"):
        assert getattr(got, f) == getattr(want, f), f
    if smoke:
        shapes = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
        assert tb.shapes == _flat_shapes(shapes)


@pytest.mark.parametrize("layers,full,small", [
    (4, 307_251_200, 219_170_816), (3, 263_206_912, 197_146_624)])
def test_full_width_counts(layers, full, small):
    """The card's configurations from shapes alone: tinyllama at full
    width with 4 of its 22 layers has 307,251,200 parameters in 12
    leaves, its budget-B model (d_ff 2816, 2 GQA groups of 8 query heads)
    219,170,816; with 3 layers (what the card holds) 263,206,912 and
    197,146,624; the reference's shapes are the same."""
    cfg = t_get_config(ARCH).replace(n_layers=layers, param_dtype="float32")
    b = t_build(cfg)
    assert len(b.shapes) == 12
    assert sum(math.prod(s) for s in b.shapes.values()) == full
    jshapes = jax.eval_shape(j_build(get_config(ARCH).replace(
        n_layers=layers, param_dtype="float32")).init, jax.random.PRNGKey(0))
    assert b.shapes == _flat_shapes(jshapes)
    budgets = {r.name: r.keep for r in b.plan.rules}
    assert budgets == {"ffn": 2816, "heads": 2}
    cfg2 = t_shrink_config(cfg, b.plan, budgets)
    assert (cfg2.d_ff, cfg2.n_kv_heads, cfg2.n_heads) == (2816, 2, 16)
    shapes = t_build(cfg2).shapes
    assert sum(math.prod(s) for s in shapes.values()) == small
    assert shapes["blocks/attn/wq"] == (layers, 2048, 2, 8, 64)
    assert shapes["blocks/mlp/wd"] == (layers, 2816, 2048)


def test_init_draws_the_config_dtype_and_device():
    cfg = t_get_config(ARCH, smoke=True)
    p = ttr.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    q = ttr.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert list(p) == list(ttr.param_shapes(cfg))
    assert all(torch.equal(p[k], q[k]) and p[k].dtype == torch.float32
               for k in p)
    assert torch.equal(p["blocks/ln1"], torch.ones((2, 64)))
    bf = ttr.init(cfg.replace(param_dtype="bfloat16"),
                  torch.Generator().manual_seed(0), device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in bf.values())
