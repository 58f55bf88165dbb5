"""The port's Mamba2 pieces against the JAX package: the SSD scan (plain
version and :class:`SSDScan`, values and gradients), the model's conv,
mixer, loss and gradients on the ``mamba2-780m`` smoke config with
parameters carried by ``convert``, the synthetic token stream, and the
Function's ``vmap``/backward plumbing under ``vmap(grad_and_value)``.

Tolerances: the scan at ``tests/test_kernels.py``'s rtol = atol = 2e-4
(the chunked products sum in another order than the JAX oracle's); the
model at rtol 1e-5 (values) and 1e-4 (gradients), the f32 rounding of
two frameworks' matrix products over a 2-layer model."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import grad_and_value, vmap  # noqa: E402

from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.data.synthetic import make_stream as j_make_stream  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.data.synthetic import make_stream as t_make_stream  # noqa: E402
from repro_torch.core import hsadmm as ths  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

from torch_port_helpers import jax_reference, np_flat, to_np  # noqa: E402

SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
# test_kernels.py's three shapes, and a T that the chunk does not divide
SCAN_SHAPES = [(64, 16, 8, 16, 16), (48, 8, 4, 8, 8), (32, 32, 8, 16, 16),
               (50, 16, 3, 8, 8)]


def _scan_inputs(T, H, P, N, seed=3, B=2):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, H, P)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, T, H)), 0).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _function(x, dt, A, Bm, Cm, chunk):
    return tssm.SSDScan.apply(x, dt, A.expand(x.shape[0], A.shape[0]), Bm,
                              Cm, chunk)


@pytest.mark.parametrize("T,chunk,H,P,N", SCAN_SHAPES)
def test_ssd_scan_matches_reference(T, chunk, H, P, N):
    """Plain version, shim and Function against the JAX oracle
    (``models.ssm.ssd_scan``) and the Pallas kernel (interpreted)."""
    a = _scan_inputs(T, H, P, N)
    yr, hr = jssm.ssd_scan(*map(jnp.asarray, a), chunk)
    with jax_reference():
        yk, hk = jops.ssd_chunk_scan(*map(jnp.asarray, a), chunk=chunk,
                                     block_h=4)
    t = [torch.from_numpy(v) for v in a]
    for y, h in (ref.ssd_chunk_scan_ref(*t, chunk),
                 ops.ssd_chunk_scan(*t, chunk=chunk),
                 _function(*t, chunk)):
        for want_y, want_h in ((yr, hr), (yk, hk)):
            np.testing.assert_allclose(to_np(y), np.asarray(want_y),
                                       **SCAN_TOL)
            np.testing.assert_allclose(to_np(h), np.asarray(want_h),
                                       **SCAN_TOL)


@pytest.mark.parametrize("T,chunk,H,P,N", SCAN_SHAPES)
def test_ssd_scan_gradients_match_jax_vjp(T, chunk, H, P, N):
    """The Function's backward (the plain version's VJP) against
    ``jax.vjp`` of the oracle, for cotangents on both y and h."""
    a = _scan_inputs(T, H, P, N, seed=4)
    rng = np.random.default_rng(9)
    gy = rng.standard_normal(a[0].shape).astype(np.float32)
    gh = rng.standard_normal((a[0].shape[0], H, N, P)).astype(np.float32)
    _, vjp = jax.vjp(lambda *v: jssm.ssd_scan(*v, chunk),
                     *map(jnp.asarray, a))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    t = [torch.from_numpy(v).requires_grad_() for v in a]
    y, h = _function(*t, chunk)
    torch.autograd.backward((y, h), (torch.from_numpy(gy),
                                     torch.from_numpy(gh)))
    for name, tt, w in zip(("x", "dt", "A", "B", "C"), t, want):
        np.testing.assert_allclose(to_np(tt.grad), np.asarray(w),
                                   err_msg=name, **SCAN_TOL)


def test_ssd_scan_large_decay_stays_finite():
    """Chunks whose sum of dt*|A| passes ~88: above the diagonal the
    decay's exponent exceeds what exp can hold.  The port masks the
    exponent before the exp, so its forward equals the reference's and
    its gradient is finite.  The reference masks AFTER the exp: its
    forward is finite, but its VJP multiplies a zero cotangent by an
    infinite derivative, and dt and A get NaN (a fault of the reference,
    recorded here; ROADMAP §3)."""
    rng = np.random.default_rng(5)
    B, T, H, P, N, Q = 2, 32, 4, 8, 8, 16
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = (5 + rng.random((B, T, H))).astype(np.float32)
    A = np.full((H,), -2.0, np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    gy = rng.standard_normal((B, T, H, P)).astype(np.float32)
    gh = rng.standard_normal((B, H, N, P)).astype(np.float32)
    (yr, hr), vjp = jax.vjp(lambda *v: jssm.ssd_scan(*v, Q),
                            *map(jnp.asarray, (x, dt, A, Bm, Cm)))
    jg = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    assert np.isfinite(np.asarray(yr)).all()
    assert [bool(np.isnan(np.asarray(g)).any()) for g in jg] == \
        [False, True, True, False, False]

    t = [torch.from_numpy(v).requires_grad_() for v in (x, dt, A, Bm, Cm)]
    y, h = _function(*t, Q)
    np.testing.assert_allclose(to_np(y), np.asarray(yr), **SCAN_TOL)
    np.testing.assert_allclose(to_np(h), np.asarray(hr), **SCAN_TOL)
    torch.autograd.backward((y, h), (torch.from_numpy(gy),
                                     torch.from_numpy(gh)))
    for name, tt, w in zip(("x", "dt", "A", "B", "C"), t, jg):
        assert torch.isfinite(tt.grad).all(), name
        w = np.asarray(w)
        if np.isfinite(w).all():
            np.testing.assert_allclose(to_np(tt.grad), w, err_msg=name,
                                       **SCAN_TOL)


def test_ssd_function_vmap_rule_folds_workers():
    """Under ``vmap`` the Function folds the vmapped dim into the batch
    rows (A per row), launching one scan for all instances; values and
    gradients equal a loop over the instances, a vmapped and an
    unbatched operand mixed."""
    W, T, H, P, N, Q = 3, 24, 4, 8, 8, 8
    x, dt, _, Bm, Cm = _scan_inputs(T, H, P, N, seed=6)
    xs = torch.from_numpy(np.stack([x * (1 + 0.1 * i) for i in range(W)]))
    A = -torch.exp(torch.from_numpy(
        np.random.default_rng(7).standard_normal((W, H)).astype(np.float32)))
    t = [torch.from_numpy(v) for v in (dt, Bm, Cm)]

    def loss(xw, aw):
        y, h = tssm.SSDScan.apply(xw, t[0], aw.expand(xw.shape[0], H),
                                  t[1], t[2], Q)
        return torch.sum(y * y) + torch.sum(torch.sin(h))

    g, v = vmap(grad_and_value(loss, argnums=(0, 1)))(xs, A)
    for i in range(W):
        gi, vi = grad_and_value(loss, argnums=(0, 1))(xs[i], A[i])
        torch.testing.assert_close(v[i], vi, rtol=1e-6, atol=0)
        torch.testing.assert_close(g[0][i], gi[0], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(g[1][i], gi[1], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the model on the smoke config
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    """Both bundles, the JAX-drawn params (numpy) and a token batch."""
    jb = j_build(get_config("mamba2-780m", smoke=True))
    tb = t_build(t_get_config("mamba2-780m", smoke=True))
    p = jax.device_get(jb.init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(
        0, jb.cfg.vocab, size=(2, 32)).astype(np.int32)
    return jb, tb, p, toks


def test_shapes_plan_and_init_match_reference(smoke):
    jb, tb, p, _ = smoke
    assert {k: v.shape for k, v in np_flat(p).items()} == tb.shapes
    mine = tb.init(torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == tb.shapes
    assert all(v.dtype == torch.float32 for v in mine.values())
    (jr,), (tr,) = jb.plan.rules, tb.plan.rules
    assert (tr.name, tr.groups, tr.keep, tr.stack_ndims) == \
        (jr.name, jr.groups, jr.keep, jr.stack_ndims)
    assert [(la.key, la.axis) for la in tr.leaves] == \
        [(la.key, la.axis) for la in jr.leaves]
    assert tuple(tb.stack_map) == tuple(jb.stack_map)


def test_full_width_four_layers_has_the_expected_size():
    """mamba2-780m at full width with 4 of its 48 layers: 17 leaves,
    213,049,408 parameters, as the JAX init's shapes give."""
    cfg = get_config("mamba2-780m").replace(n_layers=4,
                                            param_dtype="float32")
    shapes = jax.eval_shape(j_build(cfg).init, jax.random.PRNGKey(0))
    want = {"/".join(str(k.key) for k in path): tuple(v.shape) for path, v
            in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    tb = t_build(t_get_config("mamba2-780m").replace(
        n_layers=4, param_dtype="float32"))
    assert tb.shapes == want
    assert len(want) == 17
    assert sum(int(np.prod(s)) for s in want.values()) == 213_049_408


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(1)
    for xs, ws in (((2, 12, 3, 5), (4, 3, 5)), ((1, 7, 6), (4, 6))):
        x = rng.standard_normal(xs).astype(np.float32)
        w = rng.standard_normal(ws).astype(np.float32)
        want, _ = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w))
        got = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w))
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_mixer_apply_matches_reference(smoke):
    jb, tb, p, _ = smoke
    cfg = jb.cfg
    mixer = jax.tree.map(lambda a: a[0], p["blocks"]["mixer"])
    h = np.random.default_rng(2).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    want, _ = jssm.mixer_apply(cfg, jax.tree.map(jnp.asarray, mixer),
                               jnp.asarray(h))
    got = tssm.mixer_apply(
        tb.cfg, {k: torch.from_numpy(np.array(v)) for k, v in mixer.items()},
        torch.from_numpy(h))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_train_loss_and_gradients_match_reference(smoke):
    jb, tb, p, toks = smoke
    jl, jg = jax.value_and_grad(jb.train_loss)(
        jax.tree.map(jnp.asarray, p), {"tokens": jnp.asarray(toks)})
    tp = {k: v.requires_grad_()
          for k, v in convert.params_from_jax(p, device="cpu").items()}
    tl = tb.train_loss(tp, {"tokens": torch.from_numpy(toks)})
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k, g in np_flat(jax.device_get(jg)).items():
        np.testing.assert_allclose(to_np(tp[k].grad), g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max(), err_msg=k)


@pytest.mark.parametrize("transform", ["torch.func", "local_step"])
def test_function_plumbing_under_vmap_grad_and_value(smoke, transform):
    """``local_step``'s transform stack over 3 workers (``vmap`` of
    ``hsadmm.grad_and_value``, and of torch.func's own): the loss with
    the scan through :class:`SSDScan` (its ``setup_context``, ``vmap``
    rule and backward) against the same loss with the plain scan traced
    by the transforms directly.  On the CPU both forwards are the plain
    version, so losses and gradients agree bit for bit."""
    _, tb, p, _ = smoke
    gv = grad_and_value if transform == "torch.func" else ths.grad_and_value
    base = convert.params_from_jax(p, device="cpu")
    theta = {k: torch.stack([v * (1 + 0.01 * i) for i in range(3)])
             for k, v in base.items()}
    toks = np.random.default_rng(3).integers(0, tb.cfg.vocab,
                                             size=(3, 2, 32))
    batch = {"tokens": torch.from_numpy(toks.astype(np.int32))}
    g_fn, l_fn = vmap(gv(tb.train_loss))(theta, batch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tssm.SSDScan, "apply", staticmethod(
            lambda x, dt, A, Bm, Cm, chunk: ref.ssd_chunk_scan_ref(
                x, dt, A, Bm, Cm, chunk)))
        g_pl, l_pl = vmap(gv(tb.train_loss))(theta, batch)
    assert torch.equal(l_fn, l_pl)
    for k in g_pl:
        assert torch.equal(g_fn[k], g_pl[k]), k


def test_local_step_gradients_equal_torch_func(smoke):
    """``hsadmm.grad_and_value`` (the backward not recorded) gives
    torch.func's losses bit for bit and its gradients up to the rounding
    of the backward formulas."""
    _, tb, p, _ = smoke
    theta = {k: torch.stack([v * (1 + 0.01 * i) for i in range(2)])
             for k, v in convert.params_from_jax(p, device="cpu").items()}
    toks = np.random.default_rng(4).integers(0, tb.cfg.vocab, size=(2, 2, 32))
    batch = {"tokens": torch.from_numpy(toks.astype(np.int32))}
    g1, l1 = vmap(grad_and_value(tb.train_loss))(theta, batch)
    g2, l2 = vmap(ths.grad_and_value(tb.train_loss))(theta, batch)
    assert torch.equal(l1, l2)
    for k in g1:
        torch.testing.assert_close(g2[k], g1[k], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke_cfg,seq,batch,workers", [
    (True, 32, 8, 4), (False, 256, 2, 2)])
def test_token_superbatches_equal_reference(smoke_cfg, seq, batch, workers):
    """``SyntheticLM`` makes the reference's numpy draws in its order: the
    token superbatches are equal, dtype and all (the full vocabulary of
    50,280 included)."""
    shape = ShapeConfig("t", "train", seq, batch)
    js = j_make_stream(get_config("mamba2-780m", smoke=smoke_cfg), shape,
                       workers)
    ts = t_make_stream(t_get_config("mamba2-780m", smoke=smoke_cfg), shape,
                       workers, device="cpu")
    jit = jpipe.superbatches(jpipe.batches(js), 2)
    tit = tpipe.prefetch(tpipe.superbatches(tpipe.batches(ts), 2))
    for _ in range(2):
        j, t = next(jit), next(tit)
        assert set(t) == set(j) == {"tokens"}
        a, b = np.asarray(j["tokens"]), to_np(t["tokens"])
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)
    tit.close()
