"""The port's top-k wire against the JAX package: ``TopKCodec`` (selection
and order with ties, decode, the weighted group exchange with error
feedback), the ``optim`` package, and the error-feedback state
``state["wire"]`` through H-SADMM: init, consensus (joint and
class-partitioned), training through mask freeze, reconfiguration,
``convert`` and checkpoints (resnet-smoke, levels (2, 2))."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import comm as jcomm  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import ConsensusSpec, HsadmmConfig, ShapeConfig, get_config  # noqa: E402
from repro.core import consensus as jcons  # noqa: E402
from repro.core import hsadmm as jhs  # noqa: E402
from repro.core import sparsity as jsp  # noqa: E402
from repro.dist import checkpoint as jckpt  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.train.engine import Engine as JEngine  # noqa: E402
from repro.train.loop import train as j_train  # noqa: E402

from repro_torch import comm as tcomm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.core import hsadmm as ths  # noqa: E402
from repro_torch.dist import checkpoint as ckpt  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.train.engine import Engine  # noqa: E402
from repro_torch.train.loop import RunConfig, train  # noqa: E402

from torch_port_helpers import (assert_tree_close, jax_reference, np_flat,  # noqa: E402
                                perturbed, to_np)

# ---------------------------------------------------------------------------
# TopKCodec
# ---------------------------------------------------------------------------

SPECS = ["topk:0.01", "topk:0.1", "topk:0.5", "topk:1", "compact+topk:0.05"]
SHAPES = [(3, 3, 8, 16), (100,), (7,), (6, 5)]


def _values(kind, shape, seed):
    """Gaussian values; small integers (the k-th value tied, many times
    over); or +-x pairs (every magnitude twice)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if kind == "gauss":
        x = rng.standard_normal(n)
    elif kind == "tied":
        x = rng.integers(-3, 4, n)
    else:
        v = rng.standard_normal((n + 1) // 2)
        x = rng.permutation(np.concatenate([v, -v]))[:n]
    return x.astype(np.float32).reshape(shape)


@pytest.mark.parametrize("kind", ["gauss", "tied", "pm"])
@pytest.mark.parametrize("spec", SPECS)
def test_encode_decode_equal_reference(spec, kind):
    """Selection AND order (largest magnitude first, ties to the lower
    index) equal ``jax.lax.top_k``'s; decode equal."""
    t, j = tcomm.get_codec(spec), jcomm.get_codec(spec)
    for i, shape in enumerate(SHAPES):
        x = _values(kind, shape, i)
        jv, ji = j.encode(jnp.asarray(x))
        tv, ti = t.encode(torch.from_numpy(x))
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
        np.testing.assert_array_equal(to_np(tv), np.asarray(jv))
        jd = j.decode((jv, ji), like=jnp.asarray(x))
        td = t.decode((tv, ti), like=torch.from_numpy(x))
        assert td.shape == x.shape
        np.testing.assert_array_equal(to_np(td), np.asarray(jd))


def test_topk_mask_takes_ties_in_index_order():
    """Rows whose k-th magnitude is tied: the mask holds exactly k entries,
    those ``jax.lax.top_k`` picks."""
    rng = np.random.default_rng(3)
    a = np.abs(rng.integers(-3, 4, (5, 64))).astype(np.float32)
    for k in (1, 7, 20, 63, 64):
        m = to_np(tcomm.topk_mask(torch.from_numpy(a), k))
        _, idx = jax.lax.top_k(jnp.asarray(a), k)
        ref = np.zeros_like(m)
        np.put_along_axis(ref, np.asarray(idx), True, axis=-1)
        np.testing.assert_array_equal(m, ref)
        assert np.all(m.sum(-1) == k)


def _tree(lead, seed, kind="gauss"):
    shapes = {"w": (3, 3, 8, 16), "b": (16,), "fc": (16, 10)}
    return {k: _values(kind, (lead,) + s, seed + i)
            for i, (k, s) in enumerate(shapes.items())}


@pytest.mark.parametrize("kind", ["gauss", "tied"])
@pytest.mark.parametrize("g,lead", [(2, 4), (4, 4), (4, 8)])
def test_topk_group_reduce_matches_reference(g, lead, kind):
    """Three chained weighted exchanges from a nonzero residual: the
    residuals equal the reference's, the group sums within rtol 1e-6 (the
    tolerance of ``test_dense_group_reduce_matches_reference``)."""
    w = np.linspace(0.5, 1.5, lead).astype(np.float32)
    codec_j, codec_t = jcomm.get_codec("topk:0.05"), \
        tcomm.get_codec("compact+topk:0.05")
    e0 = {k: 0.1 * v for k, v in _tree(lead, 50).items()}
    js = {k: jnp.asarray(v) for k, v in e0.items()}
    ts = {k: torch.from_numpy(v) for k, v in e0.items()}
    for r in range(3):
        tree = _tree(lead, 10 * r, kind)
        jout, js = codec_j.group_reduce(
            {k: jnp.asarray(v) for k, v in tree.items()}, g, jnp.asarray(w),
            js)
        tout, ts = codec_t.group_reduce(
            {k: torch.from_numpy(v) for k, v in tree.items()}, g,
            torch.from_numpy(w), ts)
        for k in tree:
            np.testing.assert_array_equal(to_np(ts[k]), np.asarray(js[k]),
                                          err_msg=k)
            np.testing.assert_allclose(to_np(tout[k]), np.asarray(jout[k]),
                                       rtol=1e-6, err_msg=k)


def test_group_reduce_without_state_starts_from_zero():
    tree = {k: torch.from_numpy(v) for k, v in _tree(4, 1).items()}
    codec = tcomm.get_codec("topk:0.1")
    a, sa = codec.group_reduce(tree, 2, None, None)
    b, sb = codec.group_reduce(tree, 2, None, codec.init_state(tree))
    for k in tree:
        assert torch.equal(a[k], b[k]) and torch.equal(sa[k], sb[k])


def test_error_feedback_is_lossless():
    """Over 5 rounds, the reduced sums plus the pending residuals equal the
    dense reduction (the reference's ``test_codecs`` invariant), and each
    member's kept entries plus its new residual are its input plus its old
    residual, bit for bit."""
    codec = tcomm.get_codec("topk:0.2")
    t0 = {k: torch.from_numpy(v) for k, v in _tree(4, 2).items()}
    w = torch.ones(4)
    st, acc, dense_acc = None, None, None
    for r in range(5):
        t = {k: x * (1.0 + 0.3 * r) for k, x in t0.items()}
        e = st if st is not None else codec.init_state(t)
        for k, x in t.items():
            sparse, new_e = codec._sparsify(x, e[k])
            assert torch.equal(sparse + new_e, x + e[k])
            assert int((sparse != 0).sum()) <= 4 * codec.k_of(x[0].numel())
        red, st = codec.group_reduce(t, 4, w, st)
        d, _ = tcomm.get_codec("dense").group_reduce(t, 4, w)
        acc = red if acc is None else {k: acc[k] + red[k] for k in red}
        dense_acc = d if dense_acc is None else \
            {k: dense_acc[k] + d[k] for k in d}
    for k in t0:
        total = acc[k] + st[k].sum(dim=0, keepdim=True)
        np.testing.assert_allclose(to_np(total), to_np(dense_acc[k]),
                                   rtol=1e-4, atol=1e-4)


def test_topk_rate_is_checked():
    with pytest.raises(ValueError):
        tcomm.get_codec("topk:0")
    with pytest.raises(ValueError):
        tcomm.get_codec("topk:1.5")
    assert tcomm.get_codec("topk").rate == jcomm.get_codec("topk").rate


# ---------------------------------------------------------------------------
# optim (tests/test_optim.py, and against repro.optim)
# ---------------------------------------------------------------------------


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 3)).astype(np.float32),
            "b": rng.standard_normal((4,)).astype(np.float32)}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _close(t: dict, j: dict, rtol):
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_allclose(to_np(t[k]), np.asarray(j[k]), rtol=rtol,
                                   err_msg=k)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_sgd_update_equals_reference(weight_decay):
    p = _params(0)
    jp, tp = _j(p), _t(p)
    js, ts = joptim.sgd_init(jp), toptim.sgd_init(tp)
    for i in range(5):
        g = _params(10 + i)
        jp, js = joptim.sgd_update(jp, _j(g), js, lr=0.05,
                                   weight_decay=weight_decay)
        tp, ts = toptim.sgd_update(tp, _t(g), ts, lr=0.05,
                                   weight_decay=weight_decay)
        _close(tp, jp, 1e-6)
        _close(ts["mom"], js["mom"], 1e-6)


def test_adamw_update_equals_reference():
    p = _params(1)
    jp, tp = _j(p), _t(p)
    js, ts = joptim.adamw_init(jp), toptim.adamw_init(tp)
    for i in range(5):
        g = _params(20 + i)
        jp, js = joptim.adamw_update(jp, _j(g), js, lr=3e-2)
        tp, ts = toptim.adamw_update(tp, _t(g), ts, lr=3e-2)
        _close(tp, jp, 1e-5)
        _close(ts["m"], js["m"], 1e-6)
        _close(ts["v"], js["v"], 1e-6)
        assert int(ts["t"]) == int(js["t"]) == i + 1
        assert ts["t"].dtype == torch.int32


def test_schedules_equal_reference():
    jc, tc = joptim.constant_schedule(0.1), toptim.constant_schedule(0.1)
    assert float(tc(3)) == float(jc(3))
    for kw in ({"warmup": 10}, {"warmup": 0, "floor": 0.01},
               {"warmup": 5, "floor": 0.1}):
        jf = joptim.cosine_schedule(1.0, 100, **kw)
        tf = toptim.cosine_schedule(1.0, 100, **kw)
        for s in (0, 1, 5, 10, 11, 50, 99, 100, 120):
            np.testing.assert_allclose(float(tf(s)), float(jf(s)),
                                       rtol=1e-6, atol=1e-7, err_msg=str(s))


@pytest.mark.parametrize("rate", [0.01, 0.1, 0.5])
def test_topk_grad_exchange_equals_reference(rate):
    g = {"w": _values("tied", (64,), 0), "v": _values("pm", (5, 7), 1)}
    e = {"w": _values("gauss", (64,), 2) * 0.1,
         "v": np.zeros((5, 7), np.float32)}
    js, je, jpay = joptim.topk_grad_exchange(_j(g), _j(e), rate=rate,
                                             axis_sum=lambda x: 2 * x)
    ts, te, tpay = toptim.topk_grad_exchange(_t(g), _t(e), rate=rate,
                                             axis_sum=lambda x: 2 * x)
    assert tpay == jpay
    for k in g:
        np.testing.assert_array_equal(to_np(ts[k]), np.asarray(js[k]))
        np.testing.assert_array_equal(to_np(te[k]), np.asarray(je[k]))


def _quad(params):
    return 0.5 * sum(torch.sum(x ** 2) for x in params.values())


def test_sgd_descends():
    p = {"w": torch.ones(8), "b": torch.full((4,), 2.0)}
    st = toptim.sgd_init(p)
    for _ in range(150):
        p, st = toptim.sgd_update(p, dict(p), st, lr=0.05)   # grad = p
    assert float(_quad(p)) < 1e-2


def test_adamw_descends():
    p = {"w": torch.full((8,), 3.0)}
    st = toptim.adamw_init(p)
    for _ in range(200):
        p, st = toptim.adamw_update(p, dict(p), st, lr=3e-2,
                                    weight_decay=0.0)
    assert float(_quad(p)) < 1e-2


def test_cosine_schedule_shape():
    f = toptim.cosine_schedule(1.0, 100, warmup=10)
    assert float(f(0)) == 0.0
    assert abs(float(f(10)) - 1.0) < 1e-6
    assert float(f(100)) < 1e-3


def test_topk_error_feedback_preserves_sum():
    g = {"w": torch.from_numpy(_values("gauss", (64,), 5))}
    err = toptim.topk_compress_state(g)
    sparse, err2, payload = toptim.topk_grad_exchange(g, err, rate=0.1)
    assert torch.equal(sparse["w"] + err2["w"], g["w"])
    assert int((sparse["w"] != 0).sum()) <= 7
    assert payload == 6 * 8   # k=6 values * (4B value + 4B index)


# ---------------------------------------------------------------------------
# the error-feedback state through H-SADMM
# ---------------------------------------------------------------------------

LEVELS = ConsensusSpec(levels=(2, 2), compact_from_level=1)
HP = HsadmmConfig(rho1=1e-3, rho2=1e-4, local_steps=2, t_freeze=2)
RTOL, ATOL = 1e-5, 1e-6
WIRE_MAPS = {
    # boundary 1 dense (stateless), boundary 2 compacted top-k
    "inter": dict(wire_inter="topk:0.05"),
    # both boundaries top-k: boundary 1 ships the full payload, so its
    # residuals are sliced by a reconfiguration
    "both": dict(wire_map=("topk:0.05", "compact+topk:0.05")),
}


def _hp(wires, **kw):
    return dataclasses.replace(HP, **WIRE_MAPS[wires], **kw)


def _specs(wires, class_weights=False, hp=None):
    hp = hp or _hp(wires)
    jb = j_build(get_config("resnet18", smoke=True).replace(hsadmm=hp))
    tb = t_build(t_get_config("resnet18", smoke=True).replace(hsadmm=hp))
    jspec = jhs.EngineSpec(plan=jb.plan, consensus=LEVELS, hp=hp,
                           stack_map=tuple(jb.stack_map),
                           class_weights=class_weights)
    tspec = ths.EngineSpec(plan=tb.plan, consensus=LEVELS, hp=hp,
                           stack_map=tuple(tb.stack_map),
                           class_weights=class_weights)
    return jb, tb, jspec, tspec


def _rich_state(wires, class_weights=False, masks=False):
    """JAX init state with seeded noise on every iterate, dual and wire
    residual (numpy); ``masks`` draws a random mask per rule."""
    jb, _, jspec, _ = _specs(wires, class_weights)
    st = jax.device_get(jhs.init_state(jb.init(jax.random.PRNGKey(0)),
                                       jspec))
    for i, name in enumerate(("theta", "u", "mom")):
        st[name] = perturbed(st[name], seed=i)
    st["z"] = [perturbed(z, seed=10 + i) for i, z in enumerate(st["z"])]
    st["v"] = [perturbed(v, seed=20 + i, scale=1e-3)
               for i, v in enumerate(st["v"])]
    st["wire"] = [perturbed(w, seed=30 + i, scale=1e-3)
                  for i, w in enumerate(st["wire"])]
    if class_weights:
        rng = np.random.default_rng(5)
        st["class_weights"] = {
            r: rng.uniform(0.2, 1.0, v.shape).astype(np.float32)
            for r, v in st["class_weights"].items()}
    if masks:
        rng = np.random.default_rng(7)
        for r in jb.plan.rules:
            scores = rng.random((r.groups,)).astype(np.float32)
            mask, idx = jsp.topk_mask(jnp.asarray(scores), r.keep)
            st["masks"][r.name] = {
                "idx": np.asarray(idx),
                "valid": np.ones(idx.shape, np.float32),
                "mask": np.asarray(mask),
                "drift": np.zeros((), np.float32)}
    return st


def _shapes(tree):
    return {k: (tuple(v.shape), np.asarray(v).dtype)
            for k, v in np_flat(tree).items()}


@pytest.mark.parametrize("wires", sorted(WIRE_MAPS))
def test_init_state_wire_equals_reference(wires):
    """One zero tree per boundary, compacted where the boundary ships the
    shrunk buffer, ``{}`` at a stateless one; no ``wire`` without a
    stateful codec."""
    jb, tb, jspec, tspec = _specs(wires)
    jst = jax.device_get(jhs.init_state(jb.init(jax.random.PRNGKey(0)),
                                        jspec))
    tst = ths.init_state(convert.params_from_jax(
        jax.device_get(jb.init(jax.random.PRNGKey(0))), device="cpu"), tspec)
    assert len(tst["wire"]) == len(jst["wire"]) == 2
    for tw, jw in zip(tst["wire"], jst["wire"]):
        assert {k: (tuple(v.shape), to_np(v).dtype)
                for k, v in tw.items()} == _shapes(jw)
        assert all(not torch.any(v) for v in tw.values())
    assert (tst["wire"][0] == {}) == (wires == "inter")
    dense = ths.init_state(convert.params_from_jax(
        jax.device_get(jb.init(jax.random.PRNGKey(0))), device="cpu"),
        _specs(wires, hp=HP)[3])
    assert "wire" not in dense


def _assert_state(tst, jst, rtol=RTOL, atol=ATOL):
    for name in ("theta", "u"):
        assert_tree_close(tst[name], jst[name], rtol, atol)
    for name in ("z", "v", "wire"):
        assert len(tst[name]) == len(jst[name])
        for t, j in zip(tst[name], jst[name]):
            assert_tree_close(t, j, rtol, atol)
    for rule, m in jst["masks"].items():
        np.testing.assert_array_equal(to_np(tst["masks"][rule]["idx"]),
                                      np.asarray(m["idx"]), err_msg=rule)


@pytest.mark.parametrize("class_weights", [False, True])
@pytest.mark.parametrize("wires", sorted(WIRE_MAPS))
def test_consensus_steps_thread_residuals_as_reference(wires, class_weights):
    """A dynamic consensus step, then a frozen one from its result, from a
    state with residuals at both boundaries; with per-class weights the
    exchange is partitioned by lead class and the residuals are split and
    merged back."""
    st = _rich_state(wires, class_weights)
    _, _, jspec, tspec = _specs(wires, class_weights)
    step = jax.jit(lambda s, f: jcons.consensus_step(s, jspec, frozen=f),
                   static_argnums=1)
    with jax_reference():
        jdyn = jax.device_get(step(jax.tree.map(jnp.asarray, st), False)[0])
        jfrz = jax.device_get(step(jax.tree.map(jnp.asarray, jdyn),
                                   True)[0])
    tdyn, _ = tcons.consensus_step(convert.state_from_jax(st, device="cpu"),
                                   tspec, frozen=False)
    _assert_state(tdyn, jdyn)
    tfrz, _ = tcons.consensus_step(convert.state_from_jax(jdyn,
                                                          device="cpu"),
                                   tspec, frozen=True)
    _assert_state(tfrz, jfrz)


def test_all_ones_class_weights_thread_the_same_residuals():
    """Class-partitioned exchanges with all-ones class weights give the
    joint call's bits, residuals included."""
    st = _rich_state("both", class_weights=True)
    st["class_weights"] = {r: np.ones_like(v)
                           for r, v in st["class_weights"].items()}
    _, _, _, scoped = _specs("both", class_weights=True)
    _, _, _, joint = _specs("both")
    a, _ = tcons.consensus_step(convert.state_from_jax(st, device="cpu"),
                                scoped)
    plain = dict(st)
    plain.pop("class_weights")
    b, _ = tcons.consensus_step(convert.state_from_jax(plain, device="cpu"),
                                joint)
    for name in ("z", "wire"):
        for ta, tb_ in zip(a[name], b[name]):
            assert ta.keys() == tb_.keys()
            for k in ta:
                assert torch.equal(ta[k], tb_[k]), (name, k)


SHAPE = ShapeConfig("tiny", "train", 32, 16)


@pytest.fixture(scope="module")
def topk_runs():
    """4 rounds of both packages over a topk:0.05 inter-node wire, through
    mask freeze, from the same (JAX-drawn) init."""
    hp = dataclasses.replace(HP, local_steps=4, wire_inter="topk:0.05")
    jb = j_build(get_config("resnet18", smoke=True).replace(hsadmm=hp))
    p0 = jax.device_get(jb.init(jax.random.PRNGKey(0)))
    with jax_reference():
        jst, jrep = j_train(JEngine(jb, make_host_mesh(), SHAPE,
                                    consensus=LEVELS),
                            outer_iters=4, shape=SHAPE, eta=1e-2, log=None)
    tb = t_build(t_get_config("resnet18", smoke=True).replace(hsadmm=hp))
    tb = dataclasses.replace(
        tb, init=lambda gen, device: convert.params_from_jax(p0, device))
    tst, trep = train(Engine(tb, SHAPE, consensus=LEVELS, device="cpu"),
                      RunConfig(outer_iters=4, shape=SHAPE, eta=1e-2,
                                log=None))
    return jax.device_get(jst), jrep, tst, trep


def test_topk_train_matches_reference(topk_runs):
    jst, jrep, tst, trep = topk_runs
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-3)
    assert trep.frozen_at == jrep.frozen_at == 2
    assert trep.executables == jrep.executables
    assert trep.comm_bytes_internode == jrep.comm_bytes_internode
    assert trep.comm_bytes_dense_equiv == jrep.comm_bytes_dense_equiv
    assert trep.wire_map == jrep.wire_map == ["dense", "topk:0.05"]
    for rule, m in jst["masks"].items():
        np.testing.assert_array_equal(to_np(tst["masks"][rule]["idx"]),
                                      np.asarray(m["idx"]), err_msg=rule)
    assert tst["wire"][0] == {} and np_flat(jst["wire"][0]) == {}
    assert_tree_close(tst["wire"][1], jst["wire"][1], rtol=1e-3, atol=1e-5)
    assert any(torch.any(v != 0) for v in tst["wire"][1].values())


def test_convert_carries_residuals_both_ways():
    st = _rich_state("both", class_weights=True)
    tst = convert.state_from_jax(st, device="cpu")
    assert [set(w) for w in tst["wire"]] == \
        [set(np_flat(w)) for w in st["wire"]]
    back = convert.state_to_jax(tst)
    for b in range(2):
        ref, got = np_flat(st["wire"][b]), np_flat(back["wire"][b])
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    # a stateless boundary converts to an empty tree both ways
    inter = convert.state_from_jax(_rich_state("inter"), device="cpu")
    assert inter["wire"][0] == {} and convert.state_to_jax(
        inter)["wire"][0] == {}


@pytest.mark.parametrize("wires", sorted(WIRE_MAPS))
def test_engine_reconfigure_migrates_residuals_as_reference(wires):
    """A dense boundary's residuals are sliced with the kept set, a
    compact boundary's pass through; ``expand_reconfigured`` zero-fills
    the sliced ones back, as the reference's engine does."""
    st = _rich_state(wires, masks=True)
    hp = _hp(wires)
    jeng = JEngine(j_build(get_config("resnet18", smoke=True)
                           .replace(hsadmm=hp)), make_host_mesh(), SHAPE,
                   consensus=LEVELS)
    teng = Engine(t_build(t_get_config("resnet18", smoke=True)
                          .replace(hsadmm=hp)), SHAPE, consensus=LEVELS,
                  device="cpu")
    jeng2, jc = jeng.reconfigure(jax.tree.map(jnp.asarray, st))
    teng2, tc = teng.reconfigure(convert.state_from_jax(st, device="cpu"))
    jc = jax.device_get(jc)
    for b in range(2):
        ref = np_flat(jc["wire"][b])
        assert set(tc["wire"][b]) == set(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(to_np(tc["wire"][b][k]), v,
                                          err_msg=f"{b}/{k}")
    if wires == "both":   # boundary 1 shipped full payloads: it was sliced
        assert tc["wire"][0]["stem"].shape[-1] < st["wire"][0]["stem"] \
            .shape[-1]
    # the reconfigured engine's own init has the migrated structure
    fresh = teng2.init_state_fn()(0)
    for b in range(2):
        assert {k: tuple(v.shape) for k, v in fresh["wire"][b].items()} \
            == {k: tuple(v.shape) for k, v in tc["wire"][b].items()}
    je = jax.device_get(jeng2.expand_reconfigured(
        jax.tree.map(jnp.asarray, jc)))
    te = teng2.expand_reconfigured(tc)
    for b in range(2):
        for k, v in np_flat(je["wire"][b]).items():
            np.testing.assert_array_equal(to_np(te["wire"][b][k]), v,
                                          err_msg=f"{b}/{k}")


def _t_template(wires="both", consensus=LEVELS):
    eng = Engine(t_build(t_get_config("resnet18", smoke=True)
                         .replace(hsadmm=_hp(wires))),
                 consensus=consensus, device="cpu")
    return eng.init_state_fn()(1)


def _j_template(wires="both", consensus=LEVELS):
    hp = _hp(wires)
    jb = j_build(get_config("resnet18", smoke=True).replace(hsadmm=hp))
    spec = jhs.EngineSpec(plan=jb.plan, consensus=consensus, hp=hp)
    shapes = jax.eval_shape(
        lambda: jhs.init_state(jb.init(jax.random.PRNGKey(0)), spec))
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


def _assert_np_trees_equal(a, b):
    fa, fb = jckpt._flatten(a), jckpt._flatten(b)
    assert set(fa) == set(fb)
    for p in fa:
        x, y = np.asarray(fa[p]), np.asarray(fb[p])
        assert x.dtype == y.dtype and x.shape == y.shape, p
        np.testing.assert_array_equal(x, y, err_msg=p)


def test_checkpoint_residuals_load_in_both_packages(tmp_path):
    """JAX save -> port restore, and port save -> JAX restore: the
    residuals under ``wire/<boundary>/<leaf>``, bit-equal; an empty
    boundary writes nothing."""
    st = _rich_state("inter")
    jp = jckpt.save(str(tmp_path / "jax"), jax.tree.map(jnp.asarray, st),
                    {"step": 3})
    with np.load(f"{jp}/arrays.npz") as z:
        keys = set(z.files)
    assert any(k.startswith("wire/1/") for k in keys)
    assert not any(k.startswith("wire/0") for k in keys)
    tst, _ = ckpt.restore(jp, _t_template("inter"))
    ref = convert.state_from_jax(st, device="cpu")
    assert tst["wire"][0] == {}
    for k, v in ref["wire"][1].items():
        assert torch.equal(tst["wire"][1][k], v), k
    tp = ckpt.save(str(tmp_path / "port"), tst, {"step": 3})
    ckpt.flush()
    with np.load(f"{tp}/arrays.npz") as z:
        assert set(z.files) == keys
    jst, _ = jckpt.restore(tp, _j_template("inter"))
    _assert_np_trees_equal(jax.device_get(jst), convert.state_to_jax(tst))


@pytest.mark.parametrize("with_wire", [True, False])
def test_restore_elastic_residuals_equal_reference(tmp_path, with_wire):
    """A W = 4 save restored into W = 8: surviving residual rows copied,
    new rows zero; a save without residuals (before the codec) zero-seeds
    them all, in both packages alike."""
    st = _rich_state("both")
    if not with_wire:
        st.pop("wire")
    jckpt.save(str(tmp_path), jax.tree.map(jnp.asarray, st), {"step": 2})
    path = jckpt.latest(str(tmp_path))
    consensus = ConsensusSpec(levels=(2, 4), compact_from_level=1)
    jr, _ = jckpt.restore_elastic(path, _j_template("both", consensus), 8)
    tr, _ = ckpt.restore_elastic(path, _t_template("both", consensus), 8)
    _assert_np_trees_equal(convert.state_to_jax(tr), jax.device_get(jr))
    w0 = tr["wire"][0]["stem"]
    assert w0.shape[0] == 8 and torch.all(w0[4:] == 0)
    if with_wire:
        np.testing.assert_array_equal(
            to_np(w0[:4]), np_flat(st["wire"][0])["stem"])
    else:
        assert not torch.any(w0)
